"""The gather engine's dp/dt: event tables -> tree or chain products ->
sorted signed scatter.

Counterpart of the JAX package's `engine/rhs.py`. From a
`compile.CompiledProblem`:

    pyr = the marginal pyramid of p (K3, `dense.pyramids`, once a tape)
    s   = signature weights: world chain products summed per signature
          (K4's rule)
    R   = the guarded ratio of every distinct (num, den) pair of each
          tree level or chain column (its dictionary)
    ev  = each event's chain product of ratios times its signature's
          weight, over the shared prefix tree of chains (`tree.py`,
          kernel K7) or chain by chain (kernel K8, the structure-
          independent cross-check)
    dy  = for each window rank t, the sum of +ev over the events whose
          adjusted window is t less the sum of ev over those whose
          original window is t

On a card K7 (`tree_rhs`) and K8 (`chain_rhs`) are hand-written CUDA
(`csrc/gather_rhs.cu`, rules in `csrc/gather_rule.cuh`); on the CPU the
same wrappers run their plain versions (`ratios_plain`,
`signature_weights_plain`, `tree_values_plain` or `chain_values_plain`,
`scatter_plain`), which take every product and sum in the kernels'
order, so the kernels equal them bit for bit.

The tables are built on the host once (`device_tables`,
`chain_tables`) and are compact: a node, a leaf (an event of the tree)
or a chain factor holds the id of its pair in its level's (column's)
dictionary, a tree node or leaf its parent as an offset from its tile's
first parent (children lie sorted under their parents), a leaf or an
event its signature; each of these is 16 bits where a level's (column's)
all fit, else 32 (``wide`` forces 32 everywhere, for tests). The tree's
levels above the last are kept as built (`tree.build_tree`); its leaves
are the events, each at the level where its chain ends, sorted by node,
and their values are the event values in that order. The scatter's
entries, an event value's index with a minus in the top bit, are
sorted by target: a target's entries are a run.
Pyramid indices are mapped to the kernels' two-piece read
(`compile.two_pointer_index`), so a dual problem's tables need no
kernel of their own: its pyramid is K3 on each tape (the JAX package's
`_build_pyramid`). `make_batched_dy_dt` (vmap) is not ported (ROADMAP).
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
TILE = 256  # nodes or leaves that share a parent base (`kTileShift`)
_NARROW = 1 << 16  # ids, offsets and signatures below this: 16 bits
_MINUS = 1 << 31  # an entry's sign bit
# A tree level's row and a chain column's row as the C entry points read
# them (int64 each; the arrays' device pointers last).
LEVEL_FIELDS = ("n_node", "n_leaf", "wide", "first", "node_first",
                "leaf_first", "node_id", "node_off", "node_base", "leaf_id",
                "leaf_off", "leaf_base", "leaf_sig")
COLUMN_FIELDS = ("wide", "first", "id")


@dataclasses.dataclass
class Slab:
    """A tree level's nodes or leaves, or a chain column: ``id`` each
    one's pair in its dictionary; below the root of a tree each one's
    parent in the level before, ``base[i // TILE] + off[i]``; a leaf's
    signature ``sig``. The narrow arrays are int16 holding uint16, or
    int32 (`ids`)."""

    id: torch.Tensor
    off: torch.Tensor | None = None
    base: torch.Tensor | None = None
    sig: torch.Tensor | None = None


@dataclasses.dataclass
class Level:
    """One tree level, or one chain column (``leaf`` its ids): where its
    dictionary starts in the ratios (``first``), whether its arrays are
    32-bit, its nodes (None at the last level and for a column) and
    leaves, and where their values start (node values, event values)."""

    first: int
    wide: bool
    node: Slab | None
    leaf: Slab
    node_first: int = 0
    leaf_first: int = 0


@dataclasses.dataclass
class GatherTables:
    """A compiled problem's tables on one device, for the tree engine
    (``kind`` "tree": ``levels``) or the chain engine ("chains": a
    level a column, ``sig`` each event's signature). The world fields are
    `dense.world_tables`'."""

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
    dict_num: torch.Tensor  # [n_dict] every dictionary's pairs, int32
    dict_den: torch.Tensor
    levels: list  # of Level
    sig: torch.Tensor | None  # chains: [events]
    ent: torch.Tensor  # [entries] value index, minus in the sign bit
    tgt_ptr: torch.Tensor  # [state_size + 1] each target's run
    event_order: np.ndarray  # the compiled event of each event value
    num_nodes: int  # the tree's nodes as built (all levels)
    desc: np.ndarray  # the levels' rows for the C entry points

    @property
    def state_size(self) -> int:
        return self.compiled.state_size

    @property
    def num_values(self) -> int:
        """Event values the kernel forms and the scatter reads."""
        return len(self.event_order)

    @property
    def num_node_values(self) -> int:
        """Node values of the tree's levels above the last."""
        return sum(lv.node.id.numel() for lv in self.levels if lv.node)

    @property
    def num_levels(self) -> int:
        return len(self.levels) if self.kind == "tree" else 0

    @property
    def launches(self) -> int:
        """K7's or K8's launches an RHS: the values (phase 0, the
        levels, the leaves or chains), the scatter."""
        return 2

    def sig_wide(self) -> bool:
        return self.sig is not None and self.sig.dtype == torch.int32


def ids(x: torch.Tensor) -> torch.Tensor:
    """A narrow array's values as int64: int16 holds uint16."""
    return x.long() & 0xFFFF if x.dtype == torch.int16 else x.long()


def _parent_tiles(parent: np.ndarray):
    """``parent`` (sorted) as each tile's first parent and offsets."""
    parent = np.asarray(parent, dtype=np.int64)
    base = parent[::TILE]
    return base, parent - np.repeat(base, TILE)[:len(parent)]


def _dictionary(num: np.ndarray, den: np.ndarray, pyramid_size: int):
    """The distinct (num, den) pairs in sorted order and each pair's id."""
    key = torch.as_tensor(np.asarray(num, dtype=np.int64) * pyramid_size
                          + np.asarray(den, dtype=np.int64))
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    uniq = uniq.numpy()
    return uniq // pyramid_size, uniq % pyramid_size, inv.numpy()


class _TableParts:
    """Collects the dictionaries and puts the narrow arrays on the
    device."""

    def __init__(self, compiled, device, wide):
        self.compiled = compiled
        self.device = config.get_device(device)
        self.wide = wide
        self.nums, self.dens, self.size = [], [], 0

    def dictionary(self, num, den):
        """Adds a level's (column's) dictionary; (its first entry, each
        pair's id)."""
        dn, dd, pid = _dictionary(num, den, self.compiled.pyramid_size)
        first = self.size
        self.nums.append(dn)
        self.dens.append(dd)
        self.size += len(dn)
        return first, pid

    def narrow(self, *arrays) -> bool:
        """Whether these arrays (and every signature) fit 16 bits."""
        return not self.wide and self.compiled.num_signatures <= _NARROW \
            and all(len(x) == 0 or int(np.max(x)) < _NARROW for x in arrays)

    def put(self, x, wide):
        """``x`` on the device as int32 (``wide``) or as int16 holding
        uint16."""
        x = np.asarray(x)
        x = x.astype(np.int32) if wide else x.astype(np.uint16).view(np.int16)
        return torch.as_tensor(np.ascontiguousarray(x), device=self.device)

    def slab(self, pair_id, tiles, sig, wide):
        return Slab(id=self.put(pair_id, wide),
                    off=None if tiles is None else self.put(tiles[1], wide),
                    base=None if tiles is None else self.put(tiles[0], True),
                    sig=None if sig is None else self.put(sig, wide))

    def remapped(self, x):
        c = self.compiled
        return two_pointer_index(np.concatenate(x) if x else
                                 np.zeros(0, np.int64), c.size_a, c.cl_k,
                                 c.dual)


def _scatter_entries(compiled, event_order):
    """The scatter's entries for event values in ``event_order``: (ent
    int32, tgt_ptr int32). Event value i is +-counted at its event's
    adjusted (+) and original (-) windows; the entries sorted by target,
    + entries before - ones, each in value order."""
    n, n_tgt = len(event_order), compiled.state_size
    if 2 * n >= 2**31 or n_tgt >= 2**31:
        raise ValueError("the scatter outgrows int32 indices")
    tgt_orig, tgt_adj = tree_mod.recover_targets(
        compiled.num_events, compiled.ev_idx, compiled.ev_sign,
        compiled.ev_tgt)
    key = torch.as_tensor(np.concatenate(
        [tgt_adj[event_order], tgt_orig[event_order]]).astype(np.int32))
    order = torch.sort(key, stable=True).indices.numpy()
    pos = np.arange(n, dtype=np.int64)
    ent = np.concatenate([pos, pos | _MINUS])[order]
    counts = np.bincount(key.numpy(), minlength=n_tgt)
    tgt_ptr = np.concatenate([[0], np.cumsum(counts)])
    return ent.astype(np.uint32).view(np.int32), tgt_ptr


def _tables(b, kind, levels, sig, event_order, num_nodes):
    ent, tgt_ptr = _scatter_entries(b.compiled, event_order)
    worlds = dense.world_tables(b.compiled, b.device)
    t = GatherTables(
        compiled=b.compiled, kind=kind, device=worlds["w_const"].device,
        dict_num=b.put(b.remapped(b.nums), True),
        dict_den=b.put(b.remapped(b.dens), True), levels=levels, sig=sig,
        ent=b.put(ent, True), tgt_ptr=b.put(tgt_ptr, True),
        event_order=event_order, num_nodes=num_nodes,
        desc=np.zeros(0, np.int64), **worlds)
    t.desc = _descriptors(t)
    return t


def _descriptors(t: GatherTables) -> np.ndarray:
    """The rows `ckpe_tree_rhs` (LEVEL_FIELDS) or `ckpe_chain_rhs`
    (COLUMN_FIELDS) read, with the arrays' device pointers."""
    def ptr(x):
        return 0 if x is None else x.data_ptr()

    rows = []
    for lv in t.levels:
        if t.kind == "chains":
            row = dict(wide=lv.wide, first=lv.first, id=ptr(lv.leaf.id))
            rows.append([int(row[f]) for f in COLUMN_FIELDS])
            continue
        node = lv.node or Slab(id=None)
        row = dict(n_node=0 if lv.node is None else lv.node.id.numel(),
                   n_leaf=lv.leaf.id.numel(), wide=lv.wide, first=lv.first,
                   node_first=lv.node_first, leaf_first=lv.leaf_first,
                   node_id=ptr(node.id), node_off=ptr(node.off),
                   node_base=ptr(node.base), leaf_id=ptr(lv.leaf.id),
                   leaf_off=ptr(lv.leaf.off), leaf_base=ptr(lv.leaf.base),
                   leaf_sig=ptr(lv.leaf.sig))
        rows.append([int(row[f]) for f in LEVEL_FIELDS])
    return np.ascontiguousarray(rows, dtype=np.int64)


def device_tables(compiled: CompiledProblem, device=None, *,
                  wide: bool = False) -> GatherTables:
    """The tree engine's tables on ``device`` (``cuda`` unless named):
    the prefix tree of the event chains (`tree.build_tree`), its levels
    above the last as built, every event a leaf at the level where its
    chain ends (sorted by node), and the scatter over the leaves' values.
    ``wide`` makes every id, offset and signature 32 bits (tests)."""
    tr = tree_mod.build_tree(compiled.e_num, compiled.e_den,
                             compiled.pyramid_size - 1,
                             compiled.pyramid_size)
    b = _TableParts(compiled, device, wide)
    e_sig = np.asarray(compiled.e_sig)
    levels, orders = [], []
    node_first = leaf_first = ended = 0
    for l, lv in enumerate(tr.levels):
        first, pid = b.dictionary(lv.num, lv.den)
        o = np.argsort(lv.ev_node, kind="stable")
        leaf_node = lv.ev_node[o]
        events = tr.event_order[ended:ended + len(o)][o]
        ended += len(o)
        last = l == len(tr.levels) - 1
        node_tiles = None if last or not l else _parent_tiles(lv.parent)
        leaf_tiles = _parent_tiles(lv.parent[leaf_node]) if l else None
        w = not b.narrow(pid, *(x[1] for x in (node_tiles, leaf_tiles)
                                if x is not None))
        node = None if last else b.slab(pid, node_tiles, None, w)
        levels.append(Level(
            first=first, wide=w, node=node,
            leaf=b.slab(pid[leaf_node], leaf_tiles, e_sig[events], w),
            node_first=node_first, leaf_first=leaf_first))
        orders.append(events)
        node_first += 0 if last else len(pid)
        leaf_first += len(o)
    return _tables(b, "tree", levels, None, np.concatenate(orders).astype(
        np.int64), tr.num_nodes)


def chain_tables(compiled: CompiledProblem, device=None, *,
                 wide: bool = False) -> GatherTables:
    """The chain engine's tables on ``device``: each event's padded chain
    as compiled, a column at a time (column-major: a column's ids lie
    together), each event's signature, and the scatter over the events
    in compiled order. ``wide`` as in `device_tables`."""
    b = _TableParts(compiled, device, wide)
    levels = []
    for c in range(compiled.e_num.shape[1]):
        first, pid = b.dictionary(compiled.e_num[:, c],
                                     compiled.e_den[:, c])
        w = not b.narrow(pid)
        levels.append(Level(first=first, wide=w, node=None,
                            leaf=Slab(id=b.put(pid, w))))
    e_sig = np.asarray(compiled.e_sig)
    sig = b.put(e_sig, not b.narrow(e_sig))
    return _tables(b, "chains", levels, sig,
                   np.arange(compiled.num_events, dtype=np.int64), 0)


# --- Plain versions ----------------------------------------------------------


def ratios_plain(t: GatherTables, p: torch.Tensor,
                 low: torch.Tensor) -> torch.Tensor:
    """Plain version of K7's and K8's phase 0 ratios: every dictionary
    entry's ``g(pyr[num], pyr[den])``, pyr = [p, low]."""
    pyr = torch.cat([p, low])
    return guarded_ratio(pyr[t.dict_num.long()], pyr[t.dict_den.long()])


def _slab_values(ratio, lv: Level, sl: Slab, prev):
    """A level's node or leaf values, `gather_rule.cuh:k7_value`."""
    r = ratio[lv.first + ids(sl.id)]
    if prev is None:
        return r
    i = torch.arange(sl.id.numel(), device=r.device)
    return r * prev[sl.base.long()[i // TILE] + ids(sl.off)]


def tree_values_plain(t: GatherTables, p: torch.Tensor, low: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """Plain version of K7's values launch: the event (leaf) values,
    level by level ``R[id] * value[parent]`` (the ratio alone at level
    0), each leaf's times its signature's weight ``s``."""
    tree_values_plain.calls += 1
    ratio = ratios_plain(t, p, low)
    ev = torch.empty(t.num_values, dtype=p.dtype, device=p.device)
    prev = None
    for lv in t.levels:
        v = _slab_values(ratio, lv, lv.leaf, prev)
        ev[lv.leaf_first:lv.leaf_first + v.numel()] = v * s[ids(lv.leaf.sig)]
        if lv.node is not None:
            prev = _slab_values(ratio, lv, lv.node, prev)
    return ev


tree_values_plain.calls = 0


def chain_values_plain(t: GatherTables, p: torch.Tensor, low: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """Plain version of K8's values launch: each event's ratios
    multiplied in chain order, times its signature's weight ``s``."""
    chain_values_plain.calls += 1
    ratio = ratios_plain(t, p, low)
    prod = None
    for col in t.levels:
        r = ratio[col.first + ids(col.leaf.id)]
        prod = r if prod is None else prod * r
    return prod * s[ids(t.sig)]


chain_values_plain.calls = 0


def entry_terms(t: GatherTables, ev: torch.Tensor) -> torch.Tensor:
    """Each scatter entry's term: +-ev[index], the minus where the
    entry's sign bit is set."""
    e = t.ent.long()
    v = ev[e & (_MINUS - 1)]
    return torch.where(e < 0, -v, v)


def entry_targets(t: GatherTables) -> torch.Tensor:
    """Each scatter entry's target window, int64 on ``t``'s device."""
    ptr = t.tgt_ptr.long()
    return torch.repeat_interleave(
        torch.arange(t.state_size, device=ptr.device), ptr[1:] - ptr[:-1])


def scatter_plain(t: GatherTables, ev: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K7's and K8's scatter, in the kernels' order: for
    each target, lane l (of 32) adds the terms of its entries l, l + 32,
    ... from 0.0, then the partials are folded in halves (lane l + 16
    onto l, then 8, 4, 2, 1), as the warp's xor butterfly gives lane
    0."""
    scatter_plain.calls += 1
    n_tgt = t.state_size
    if out is not None:
        dense._checked_out(out, n_tgt, ev.device)
    ptr = t.tgt_ptr.long()
    term = entry_terms(t, ev)
    tgt = entry_targets(t)
    rank = torch.arange(term.numel(), device=ptr.device) - ptr[tgt]
    slot = tgt * LANES + rank % LANES
    row = rank // LANES
    order = torch.argsort(row, stable=True)
    bounds = torch.bincount(row, minlength=1).cumsum(0).tolist()
    part = torch.zeros(n_tgt * LANES, dtype=ev.dtype, device=ev.device)
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


def _empty(n, device):
    return torch.empty(max(n, 1), dtype=torch.float64, device=device)


def _head(t: GatherTables, p, low):
    """`ckpe_tree_rhs`'s and `ckpe_chain_rhs`'s first arguments (phase
    0's), with the signature weights and ratios they write."""
    c = t.compiled
    s = _empty(c.num_signatures, p.device)
    ratio = _empty(t.dict_num.numel(), p.device)
    return (p.data_ptr(), low.data_ptr(), t.state_size, c.size_a, c.cl_k,
            t.pair_num.data_ptr(), t.pair_den.data_ptr(),
            t.pair_const.data_ptr(), t.pair_num.shape[1],
            t.csr_ptr.data_ptr(), c.num_signatures, s.data_ptr(),
            t.dict_num.data_ptr(), t.dict_den.data_ptr(),
            t.dict_num.numel(), ratio.data_ptr()), (s, ratio)


def _tail(t: GatherTables, ev, dy, stream_of):
    """The scatter's arguments."""
    return (ev.data_ptr(), t.ent.data_ptr(), t.tgt_ptr.data_ptr(),
            t.state_size, dy.data_ptr(), cuda.stream(stream_of))


def tree_rhs(t: GatherTables, p: torch.Tensor, low: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """K7: dp/dt from the state ``p`` and the levels below it (``low``,
    `dense.pyramids`) over the tree's tables, into ``out`` (a new tensor
    when None): on a card two launches from one C call (the values, the
    scatter), on the CPU the plain versions."""
    if t.kind != "tree":
        raise ValueError("tree_rhs needs the tree's tables (device_tables)")
    if not cuda.on_card(p, "tree_rhs"):
        s = dense.signature_weights_plain(t, p, low)
        return scatter_plain(t, tree_values_plain(t, p, low, s), out)
    p, low, dy = _check(t, p, low, out)
    nv = _empty(t.num_node_values, p.device)
    ev = _empty(t.num_values, p.device)
    head, buffers = _head(t, p, low)  # s, the ratios: the launch's
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_tree_rhs(*head, t.desc.ctypes.data, len(t.levels),
                               nv.data_ptr(), *_tail(t, ev, dy, p))
    cuda.check(rc, "tree_rhs", lib)
    tree_rhs.launches += t.launches
    return dy


tree_rhs.launches = 0


def chain_rhs(t: GatherTables, p: torch.Tensor, low: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """K8: as `tree_rhs` over the chain tables (`chain_tables`): phase 0
    and every event's chain product, then the scatter, two launches from
    one C call on a card."""
    if t.kind != "chains":
        raise ValueError("chain_rhs needs the chain tables (chain_tables)")
    if not cuda.on_card(p, "chain_rhs"):
        s = dense.signature_weights_plain(t, p, low)
        return scatter_plain(t, chain_values_plain(t, p, low, s), out)
    p, low, dy = _check(t, p, low, out)
    ev = _empty(t.num_values, p.device)
    head, buffers = _head(t, p, low)  # s, the ratios: the launch's
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_chain_rhs(*head, t.desc.ctypes.data, len(t.levels),
                                t.sig.data_ptr(), int(t.sig_wide()),
                                t.num_values, *_tail(t, ev, dy, p))
    cuda.check(rc, "chain_rhs", lib)
    chain_rhs.launches += t.launches
    return dy


chain_rhs.launches = 0


def scatter(t: GatherTables, ev: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """K7's and K8's scatter alone, one launch on a card (the plain
    version on the CPU): dp/dt from the event values ``ev`` (each
    already times its signature's weight). The RHS runs it inside
    `tree_rhs` and `chain_rhs`; this times it apart."""
    if not cuda.on_card(ev, "scatter"):
        return scatter_plain(t, ev, out)
    n = t.state_size
    if ev.shape != (t.num_values,) or ev.dtype != torch.float64:
        raise TypeError("ev must be the tables' float64 event values")
    if ev.device != t.device:
        raise ValueError(f"ev on {ev.device}, the tables on {t.device}")
    dy = (torch.empty(n, dtype=torch.float64, device=ev.device)
          if out is None else dense._checked_out(out, n, ev.device))
    ev = ev.contiguous()
    lib = cuda.load()
    with torch.cuda.device(ev.device):
        rc = lib.ckpe_gather_scatter(*_tail(t, ev, dy, ev))
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
    return scatter_plain(t, values(t, p, low, s), out)


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
    """``fn(p, out=None)``; under a transform `dense.RHSFunction` with no
    J.v and no v^T J: the tree and chain engines' are slice (b) of the
    reverse-mode item, and both raise NotImplementedError naming it
    (`dense.REVERSE_MODE`)."""
    n = compiled.state_size

    def fn(p, out=None):
        p = torch.as_tensor(p, dtype=torch.float64,
                            device=tables.device).reshape(-1)
        if p.numel() != n:
            raise ValueError(f"p has {p.numel()} entries, the program {n}")
        if dense.transformed(p):
            return dense.RHSFunction.apply(
                p, None, lambda q, _w: (rhs(tables, q, None),
                                        q.new_zeros(0)), None, None)[0]
        return rhs(tables, p, out)

    fn.tables = tables
    return fn


def make_dy_dt(compiled: CompiledProblem, dtype=None, jit: bool = True, *,
               device=None):
    """``fn(p, out=None) -> dp/dt`` (float64) on ``device`` (``cuda``
    unless named) by the tree engine: K3 and K7 on a card, their plain
    versions on the CPU; dp/dt goes into ``out`` where one is given (a
    solver's stage row). ``dtype`` (None or float64) and ``jit`` (no
    effect) are the reference's parameters, as in
    `dense.make_dense_dy_dt`."""
    config.check_float64(dtype)
    return _closure(compiled, device_tables(compiled, device),
                    dy_dt_from_tables)


def make_chain_dy_dt(compiled: CompiledProblem, dtype=None,
                     jit: bool = True, *, device=None):
    """As `make_dy_dt` by the chain engine (K3 and K8)."""
    config.check_float64(dtype)
    return _closure(compiled, chain_tables(compiled, device),
                    dy_dt_from_chain_tables)


def make_dual_dy_dt(compiled: CompiledProblem, dtype=None, jit: bool = True,
                    *, device=None):
    """``fn(p_prog, p_data) -> (dy_prog, dy_data)`` for a
    `compile.CompiledDualProblem` by the tree engine; ``fn.state_fn`` is
    its dp/dt of the whole state ``[p_prog | p_data]``. ``dtype`` and
    ``jit`` as in `make_dy_dt`."""
    state_fn = make_dy_dt(compiled, dtype, jit, device=device)
    half = compiled.size_a**compiled.cl_k

    def fn(p_prog, p_data):
        dev = state_fn.tables.device
        dy = state_fn(torch.cat([
            torch.as_tensor(x, dtype=torch.float64, device=dev).reshape(-1)
            for x in (p_prog, p_data)]))
        return dy[:half], dy[half:]

    fn.state_fn = state_fn
    return fn
