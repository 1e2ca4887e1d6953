"""The gather engine's dp/dt: event tables -> tree or chain products ->
sorted signed scatter.

Counterpart of the JAX package's `engine/rhs.py`. From a
`compile.CompiledProblem`:

    pyr = the marginal pyramid of p (K3, `dense.pyramids`, once a tape)
    s   = signature weights: world chain products summed per signature
          (K4's rule)
    v   = each event's chain product of guarded ratios, over the shared
          prefix tree of chains (`tree.py`, kernel K7) or chain by chain
          (kernel K8, the structure-independent cross-check)
    dy  = for each window rank t, the sum over its entries of the
          compile-time sorted signed scatter of +-(v[event] * s[sig])

On a card K7 (`tree_rhs`) and K8 (`chain_rhs`) are hand-written CUDA
(`csrc/gather_rhs.cu`, rules in `csrc/gather_rule.cuh`); on the CPU the
same wrappers run their plain versions (`signature_weights_plain`,
`tree_values_plain` or `chain_values_plain`, `scatter_plain`), which add
every sum in the kernels' order, so the kernels equal them bit for bit.

The tables are built on the host once (`device_tables`,
`chain_tables`): the tree's levels, and the scatter as a CSR of targets
whose entries each name a value and its signature, the sign folded into
the signature (``~sig`` for a minus). Pyramid indices are mapped to the
kernels' two-piece read (`compile.two_pointer_index`), so a dual
problem's tables need no kernel of their own: its pyramid is K3 on each
tape (the JAX package's `_build_pyramid`). `make_batched_dy_dt` (vmap)
is not ported (ROADMAP).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import cuda
from ..markov import guarded_ratio
from ..utils import config
from . import dense, tree as tree_mod
from .compile import CompiledProblem, two_pointer_index

LANES = 32  # a warp sums a target's entries (`csrc/gather_rule.cuh`)


@dataclasses.dataclass
class GatherTables:
    """A compiled problem's tables on one device, for the tree engine
    (``kind`` "tree": the nodes of every level, ``level_ptr`` on the
    host) or the chain engine ("chains": each event's padded chain).
    The world fields are `dense.world_tables`'."""

    compiled: CompiledProblem
    kind: str
    device: torch.device
    w_num: torch.Tensor
    w_den: torch.Tensor
    w_const: torch.Tensor
    csr_ptr: torch.Tensor
    pair_num: torch.Tensor
    pair_den: torch.Tensor
    pair_const: torch.Tensor
    sig_pairs: torch.Tensor
    num: torch.Tensor  # tree: [nodes]; chains: [events, chain]
    den: torch.Tensor
    parent: torch.Tensor | None  # tree: index in the level before
    level_ptr: np.ndarray | None  # tree: [levels + 1] int64, host
    ent_val: torch.Tensor  # [entries] index of the entry's value
    ent_sig: torch.Tensor  # [entries] signature, ~signature for a minus
    tgt_ptr: torch.Tensor  # [state_size + 1] each target's entries

    @property
    def state_size(self) -> int:
        return self.compiled.state_size

    @property
    def num_values(self) -> int:
        """Values the kernel forms: nodes (tree) or events (chains)."""
        return self.num.shape[0]

    @property
    def num_levels(self) -> int:
        return len(self.level_ptr) - 1 if self.kind == "tree" else 0

    @property
    def launches(self) -> int:
        """K7's or K8's launches an RHS: the weights, a launch a level or
        one for the chains, the scatter."""
        return 2 + (self.num_levels if self.kind == "tree" else 1)


def _entries(ev_idx, ev_sign, ev_tgt, val_of_event, sig_of_event,
             state_size: int):
    """The scatter's entries as the kernels read them: (ent_val,
    ent_sig, tgt_ptr) from the sorted signed scatter (``ev_idx``,
    ``ev_sign``, ``ev_tgt``), ``val_of_event`` the index of each event's
    value, ``sig_of_event`` its signature."""
    if len(ev_idx) >= 2**31 or state_size >= 2**31:
        raise ValueError("the scatter outgrows int32 indices")
    ev_idx = np.asarray(ev_idx, dtype=np.int64)
    sig = np.asarray(sig_of_event, dtype=np.int64)[ev_idx]
    ent_sig = np.where(np.asarray(ev_sign) > 0, sig, ~sig)
    counts = np.bincount(np.asarray(ev_tgt, dtype=np.int64),
                         minlength=state_size)
    tgt_ptr = np.concatenate([[0], np.cumsum(counts)])
    return (np.asarray(val_of_event, dtype=np.int64)[ev_idx], ent_sig,
            tgt_ptr)


def _tables(compiled, kind, device, num, den, parent, level_ptr, ent):
    device = config.get_device(device)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32,
                               device=device)

    worlds = dense.world_tables(compiled, device)
    remap = (lambda x: two_pointer_index(x, compiled.size_a, compiled.cl_k,
                                         compiled.dual))
    return GatherTables(
        compiled=compiled, kind=kind, device=worlds["w_const"].device,
        num=dev(remap(num)), den=dev(remap(den)),
        parent=None if parent is None else dev(parent),
        level_ptr=level_ptr, ent_val=dev(ent[0]), ent_sig=dev(ent[1]),
        tgt_ptr=dev(ent[2]), **worlds)


def device_tables(compiled: CompiledProblem, device=None) -> GatherTables:
    """The tree engine's tables on ``device`` (``cuda`` unless named):
    the prefix tree of the event chains (`tree.build_tree`), events in
    the tree's order, and the scatter re-sorted for that order."""
    one_slot = compiled.pyramid_size - 1
    tr = tree_mod.build_tree(compiled.e_num, compiled.e_den, one_slot,
                             compiled.pyramid_size)
    tgt_orig, tgt_adj = tree_mod.recover_targets(
        compiled.num_events, compiled.ev_idx, compiled.ev_sign,
        compiled.ev_tgt)
    order = tr.event_order
    ev_idx, ev_sign, ev_tgt = tree_mod.sorted_scatter(tgt_orig[order],
                                                      tgt_adj[order])
    sizes = [len(lv.num) for lv in tr.levels]
    level_ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    node_of_event = np.concatenate(
        [lv.ev_node.astype(np.int64) + level_ptr[i]
         for i, lv in enumerate(tr.levels)])
    ent = _entries(ev_idx, ev_sign, ev_tgt, node_of_event,
                   np.asarray(compiled.e_sig)[order], compiled.state_size)
    cat = np.concatenate
    return _tables(compiled, "tree", device, cat([lv.num for lv in tr.levels]),
                   cat([lv.den for lv in tr.levels]),
                   cat([lv.parent for lv in tr.levels]), level_ptr, ent)


def chain_tables(compiled: CompiledProblem, device=None) -> GatherTables:
    """The chain engine's tables on ``device``: each event's padded chain
    as compiled, and the compiled scatter."""
    ent = _entries(compiled.ev_idx, compiled.ev_sign, compiled.ev_tgt,
                   np.arange(compiled.num_events), compiled.e_sig,
                   compiled.state_size)
    return _tables(compiled, "chains", device, compiled.e_num,
                   compiled.e_den, None, None, ent)


# --- Plain versions ----------------------------------------------------------


def tree_values_plain(t: GatherTables, p: torch.Tensor,
                      low: torch.Tensor) -> torch.Tensor:
    """Plain version of K7's levels: every node's value, level by level,
    ``g(pyr[num], pyr[den]) * value[parent]`` (the ratio alone at level
    0), pyr = [p, low]."""
    tree_values_plain.calls += 1
    pyr = torch.cat([p, low])
    out, prev = [], None
    for lo, hi in zip(t.level_ptr[:-1], t.level_ptr[1:]):
        r = guarded_ratio(pyr[t.num[lo:hi].long()], pyr[t.den[lo:hi].long()])
        prev = r if prev is None else r * prev[t.parent[lo:hi].long()]
        out.append(prev)
    return torch.cat(out)


tree_values_plain.calls = 0


def chain_values_plain(t: GatherTables, p: torch.Tensor,
                       low: torch.Tensor) -> torch.Tensor:
    """Plain version of K8's chains: each event's guarded ratios
    multiplied in chain order."""
    chain_values_plain.calls += 1
    pyr = torch.cat([p, low])
    g = guarded_ratio(pyr[t.num.long()], pyr[t.den.long()])
    prod = g[:, 0].clone()
    for c in range(1, g.shape[1]):
        prod = prod * g[:, c]
    return prod


chain_values_plain.calls = 0


def scatter_plain(t: GatherTables, vals: torch.Tensor, s: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K7's and K8's scatter, in the kernels' order: for
    each target, lane l (of 32) adds the terms +-(vals[val] * s[sig]) of
    its entries l, l + 32, ... from 0.0, then the partials are folded in
    halves (lane l + 16 onto l, then 8, 4, 2, 1), as the warp's xor
    butterfly gives lane 0."""
    scatter_plain.calls += 1
    n_tgt = t.state_size
    if out is not None:
        dense._checked_out(out, n_tgt, vals.device)
    ptr = t.tgt_ptr.long()
    g = t.ent_sig.long()
    neg = g < 0
    v = vals[t.ent_val.long()] * s[torch.where(neg, ~g, g)]
    term = torch.where(neg, -v, v)
    counts = ptr[1:] - ptr[:-1]
    tgt = torch.repeat_interleave(torch.arange(n_tgt, device=ptr.device),
                                  counts)
    rank = torch.arange(term.numel(), device=ptr.device) - ptr[tgt]
    slot = tgt * LANES + rank % LANES
    row = rank // LANES
    order = torch.argsort(row, stable=True)
    bounds = torch.bincount(row, minlength=1).cumsum(0).tolist()
    part = torch.zeros(n_tgt * LANES, dtype=vals.dtype, device=vals.device)
    start = 0
    for stop in bounds:  # one row of every target's lanes at a time
        sel = order[start:stop]
        part.index_add_(0, slot[sel], term[sel])
        start = stop
    x = part.view(n_tgt, LANES)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    dy = x[:, 0]
    return dy if out is None else out.copy_(dy)


scatter_plain.calls = 0


# --- K7, K8 ------------------------------------------------------------------


def _check(t: GatherTables, p, low, out):
    n, m = t.state_size, dense.low_size(t.compiled)
    if (p.dtype != torch.float64 or low.dtype != torch.float64
            or p.shape != (n,) or low.shape != (m,)):
        raise TypeError(f"p must be a float64 [{n}] tensor and low K3's "
                        f"float64 [{m}] output")
    if p.device != t.device or low.device != t.device:
        raise ValueError(f"p on {p.device}, low on {low.device}, the "
                         f"tables on {t.device}")
    dy = (torch.empty(n, dtype=torch.float64, device=p.device) if out is None
          else dense._checked_out(out, n, p.device))
    return p.contiguous(), low.contiguous(), dy


def _head(t: GatherTables, p, low, s):
    c = t.compiled
    return (p.data_ptr(), low.data_ptr(), t.state_size, c.size_a, c.cl_k,
            t.pair_num.data_ptr(), t.pair_den.data_ptr(),
            t.pair_const.data_ptr(), t.pair_num.shape[1],
            t.csr_ptr.data_ptr(), c.num_signatures, s.data_ptr())


def _tail(t: GatherTables, vals, dy, p):
    return (vals.data_ptr(), t.ent_val.data_ptr(), t.ent_sig.data_ptr(),
            t.tgt_ptr.data_ptr(), t.state_size, dy.data_ptr(),
            cuda.stream(p))


def tree_rhs(t: GatherTables, p: torch.Tensor, low: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """K7: dp/dt from the state ``p`` and the levels below it (``low``,
    `dense.pyramids`) over the tree's tables, into ``out`` (a new tensor
    when None): on a card the signature weights, a launch a level and the
    scatter from one C call, on the CPU the plain versions."""
    if t.kind != "tree":
        raise ValueError("tree_rhs needs the tree's tables (device_tables)")
    if not cuda.on_card(p, "tree_rhs"):
        s = dense.signature_weights_plain(t, p, low)
        return scatter_plain(t, tree_values_plain(t, p, low), s, out)
    p, low, dy = _check(t, p, low, out)
    s = torch.empty(t.compiled.num_signatures, dtype=torch.float64,
                    device=p.device)
    vals = torch.empty(t.num_values, dtype=torch.float64, device=p.device)
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_tree_rhs(
            *_head(t, p, low, s), t.num.data_ptr(), t.den.data_ptr(),
            t.parent.data_ptr(), t.level_ptr.ctypes.data, t.num_levels,
            *_tail(t, vals, dy, p))
    cuda.check(rc, "tree_rhs", lib)
    tree_rhs.launches += t.launches
    return dy


tree_rhs.launches = 0


def chain_rhs(t: GatherTables, p: torch.Tensor, low: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """K8: as `tree_rhs` over the padded chains (`chain_tables`): the
    signature weights, every event's chain product and the scatter, 3
    launches from one C call on a card."""
    if t.kind != "chains":
        raise ValueError("chain_rhs needs the chain tables (chain_tables)")
    if not cuda.on_card(p, "chain_rhs"):
        s = dense.signature_weights_plain(t, p, low)
        return scatter_plain(t, chain_values_plain(t, p, low), s, out)
    p, low, dy = _check(t, p, low, out)
    s = torch.empty(t.compiled.num_signatures, dtype=torch.float64,
                    device=p.device)
    vals = torch.empty(t.num_values, dtype=torch.float64, device=p.device)
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_chain_rhs(
            *_head(t, p, low, s), t.num.data_ptr(), t.den.data_ptr(),
            t.num.shape[1], t.num_values, *_tail(t, vals, dy, p))
    cuda.check(rc, "chain_rhs", lib)
    chain_rhs.launches += t.launches
    return dy


chain_rhs.launches = 0


def scatter(t: GatherTables, vals: torch.Tensor, s: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """K7's and K8's scatter stage alone, one launch on a card (the
    plain version on the CPU): dp/dt from the values ``vals`` (nodes or
    events) and the signature weights ``s``. The RHS runs it inside
    `tree_rhs` and `chain_rhs`; this times it apart."""
    if not cuda.on_card(vals, "scatter"):
        return scatter_plain(t, vals, s, out)
    n = t.state_size
    n_sig = t.compiled.num_signatures
    if (vals.shape != (t.num_values,) or s.shape != (n_sig,)
            or vals.dtype != torch.float64 or s.dtype != torch.float64):
        raise TypeError("vals and s must be the tables' float64 values and "
                        "signature weights")
    dy = (torch.empty(n, dtype=torch.float64, device=vals.device)
          if out is None else dense._checked_out(out, n, vals.device))
    lib = cuda.load()
    with torch.cuda.device(vals.device):
        rc = lib.ckpe_gather_scatter(s.contiguous().data_ptr(),
                                     *_tail(t, vals.contiguous(), dy, vals))
    cuda.check(rc, "scatter", lib)
    scatter.launches += 1
    return dy


scatter.launches = 0


# --- dp/dt -------------------------------------------------------------------


def gather_plain(t: GatherTables, p: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain dp/dt over ``t`` on ``p``'s device: K3's and K7's (or
    K8's) plain versions."""
    p = p.reshape(-1)
    low = dense.pyramids(t.compiled, p, plain=True)
    s = dense.signature_weights_plain(t, p, low)
    values = tree_values_plain if t.kind == "tree" else chain_values_plain
    return scatter_plain(t, values(t, p, low), s, out)


def dy_dt_from_tables(t: GatherTables, p: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """dp/dt of the state ``p`` over the tree's tables: K3 on each tape,
    then K7."""
    return tree_rhs(t, p, dense.pyramids(t.compiled, p), out)


def dy_dt_from_chain_tables(t: GatherTables, p: torch.Tensor,
                            out: torch.Tensor | None = None) -> torch.Tensor:
    """dp/dt of the state ``p`` over the chain tables: K3, then K8."""
    return chain_rhs(t, p, dense.pyramids(t.compiled, p), out)


def _closure(compiled, tables, rhs):
    n = compiled.state_size

    def fn(p, out=None):
        p = torch.as_tensor(p, dtype=torch.float64,
                            device=tables.device).reshape(-1)
        if p.numel() != n:
            raise ValueError(f"p has {p.numel()} entries, the program {n}")
        return rhs(tables, p, out)

    fn.tables = tables
    return fn


def make_dy_dt(compiled: CompiledProblem, *, device=None):
    """``fn(p, out=None) -> dp/dt`` (float64) on ``device`` (``cuda``
    unless named) by the tree engine: K3 and K7 on a card, their plain
    versions on the CPU; dp/dt goes into ``out`` where one is given (a
    solver's stage row)."""
    return _closure(compiled, device_tables(compiled, device),
                    dy_dt_from_tables)


def make_chain_dy_dt(compiled: CompiledProblem, *, device=None):
    """As `make_dy_dt` by the chain engine (K3 and K8)."""
    return _closure(compiled, chain_tables(compiled, device),
                    dy_dt_from_chain_tables)


def make_dual_dy_dt(compiled: CompiledProblem, *, device=None):
    """``fn(p_prog, p_data) -> (dy_prog, dy_data)`` for a
    `compile.CompiledDualProblem` by the tree engine; ``fn.state_fn`` is
    its dp/dt of the whole state ``[p_prog | p_data]``."""
    state_fn = make_dy_dt(compiled, device=device)
    half = compiled.size_a**compiled.cl_k

    def fn(p_prog, p_data):
        dev = state_fn.tables.device
        dy = state_fn(torch.cat([
            torch.as_tensor(x, dtype=torch.float64, device=dev).reshape(-1)
            for x in (p_prog, p_data)]))
        return dy[:half], dy[half:]

    fn.state_fn = state_fn
    return fn
