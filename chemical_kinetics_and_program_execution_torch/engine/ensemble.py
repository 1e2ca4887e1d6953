"""Ensemble mode: step a batch of concrete tapes in lockstep.

Counterpart of the JAX package's `engine/ensemble.py`,
first slice: the decision-machine compiler, the stacked-plane FSM round
behind `run_ensemble`, and the observables `window_counts` and
`sample_tapes_from_spd`.

Two kernels carry the device work (sources in `csrc/`, built by
`cuda.py`):

- **K1** `plane_round` — one stratified round on the stacked int8 planes,
  in place, compiled for each decision machine (`k1_source.py` writes
  the machine's unit, `csrc/plane_round.cuh` is the kernel). It replaces
  the reference's `_apply_plane_round_fsm_stacked`,
  `_machine_specs_planes_leveled` and `_machine_writes_planes` (and the
  Pallas probes `probes/pallas_plane_round.py:fsm_kernel` and
  `probes/pallas_packed32.py:fsm_kernel_packed`, which compute the same
  round).
- **K2** `window_counts` — the circular window histogram.

Each wrapper runs its plain PyTorch version (``*_plain``, beside it) for
CPU tensors only; for a CUDA tensor it launches the kernel or raises.
Each counts its launches in ``<wrapper>.launches``.

Time normalisation matches the exact engine's semantics: the rule fires
once per site per unit time, so one round of E events on a length-L tape
advances time by ``-log1p(-E/L)``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import cuda
from ..utils import config
from . import dsl, enumerate as enum_mod

# Not ported yet; each raising path names the ROADMAP item that ports it.
_TODO_TABLE = ("transition-table rounds (DeviceTable) are not ported yet: "
               "ROADMAP.md Queue 1 item 'Ensemble, part 2' / Queue 2 item 8")
_TODO_BITSLICE = ("the bit-sliced round is not ported yet: ROADMAP.md "
                  "Queue 1 item 'Bit-sliced rounds' / Queue 2 items 10-11")
_TODO_LATTICE = ("the rolled lattice round (independent_sites, or stride "
                 "> 64) is not ported yet: ROADMAP.md Queue 1 item "
                 "'Ensemble, part 2'")
_TODO_TAU = ("tempered choose sampling (tau != 1) belongs to the weighted "
             "frontier, not ported yet: ROADMAP.md Queue 1 item "
             "'Weighted frontier'")


def _window_bounds(worlds):
    """Inclusive read-window extents (p_lo, p_hi, d_lo, d_hi) over all
    execution paths' revealed cells."""
    p_lo = min(min((-w.tape_cells[0][0] for w in worlds), default=0), 0)
    p_hi = max(max((len(w.tape_cells[0][1]) - w.tape_cells[0][0] - 1
                    for w in worlds), default=-1), 0)
    d_lo = min(min((-w.tape_cells[1][0] for w in worlds), default=0), 0)
    d_hi = max(max((len(w.tape_cells[1][1]) - w.tape_cells[1][0] - 1
                    for w in worlds), default=-1), 0)
    return p_lo, p_hi, d_lo, d_hi


def _world_window_info(w, n_cells, n_p, p_lo, d_lo):
    """One world's revealed cells and write set over the combined window.

    Returns (fixed_cells, fixed_vals, write_mask, write_vals): the cells
    the path revealed with their original symbols, and the cells it
    changed with the adjusted symbols.
    """
    fixed_cells, fixed_vals = [], []
    mask = np.zeros(n_cells, bool)
    val = np.zeros(n_cells, np.int32)
    for t, (lo, base) in enumerate(((p_lo, 0), (d_lo, n_p))):
        l_len, orig, adj = w.tape_cells[t]
        for i, (o, adj_v) in enumerate(zip(orig, adj)):
            cell = base + (i - l_len) - lo
            fixed_cells.append(cell)
            fixed_vals.append(o)
            if o != adj_v:
                mask[cell] = True
                val[cell] = adj_v
    return fixed_cells, fixed_vals, mask, val


# --- Decision machine: the rule's decision DAG as packed int32 words ----------
#
# Every internal node of the rule's decision tree is a reveal (branch =
# one window cell's symbol) or a choose (branch = inverse-CDF of one
# uniform, renormalised into the chosen branch). Identical subtrees are
# hash-consed into a DAG; per-branch child ids and leaf write-spec ids
# ride little-endian fields of int32 words.


@dataclasses.dataclass(frozen=True)
class _Reveal:
    node_id: int
    cell: int  # column in the combined window-cell list
    child_words: tuple[int, ...]  # per-branch child ids (0 = leaf)
    spec_words: tuple[int, ...]   # per-branch leaf spec ids


@dataclasses.dataclass(frozen=True)
class _Choose:
    node_id: int
    probs: tuple[float, ...]
    child_words: tuple[int, ...]
    spec_words: tuple[int, ...]


_SPEC_BITS = 6


@dataclasses.dataclass(frozen=True)
class DeviceMachine:
    """Compiled decision DAG of one rule (host-side, hashable)."""

    tag: str
    size_a: int
    p_lo: int
    d_lo: int
    n_p: int
    n_d: int
    span: int
    nodes: tuple  # _Reveal/_Choose in topological order (parents first)
    root: int     # initial FSM state
    n_states: int
    bits: int     # field width of child/spec words
    # Per-cell write words: wr_bits-wide field s =
    # (writes?<<(wr_bits-1) | symbol) for write-spec s, 31//wr_bits
    # fields per int32 word.
    wr_words: tuple[tuple[int, ...], ...]
    num_specs: int
    wr_bits: int = 5

    @property
    def n_cells(self) -> int:
        return self.n_p + self.n_d

    @property
    def has_choose(self) -> bool:
        """Whether a round consumes uniforms."""
        return any(isinstance(n, _Choose) for n in self.nodes)


_FIELD_NAMES = ("tag", "size_a", "p_lo", "d_lo", "n_p", "n_d", "span",
                "nodes", "root", "n_states", "bits", "wr_words",
                "num_specs", "wr_bits")


def machine_fields(dm: DeviceMachine) -> dict:
    """The machine as plain ints and tuples; nodes become
    ``("reveal", node_id, cell, child_words, spec_words)`` or
    ``("choose", node_id, probs, child_words, spec_words)``."""
    out = {name: getattr(dm, name) for name in _FIELD_NAMES}
    out["nodes"] = tuple(
        ("reveal", n.node_id, n.cell, n.child_words, n.spec_words)
        if isinstance(n, _Reveal)
        else ("choose", n.node_id, n.probs, n.child_words, n.spec_words)
        for n in dm.nodes)
    return out


def device_machine_from_fields(fields: dict) -> DeviceMachine:
    """Builds a :class:`DeviceMachine` from :func:`machine_fields`' form,
    which is also how a machine compiled by the JAX package crosses
    over (its fields as plain ints and tuples)."""
    nodes = []
    for kind, node_id, arg, child_words, spec_words in fields["nodes"]:
        cw = tuple(int(x) for x in child_words)
        sw = tuple(int(x) for x in spec_words)
        if kind == "reveal":
            nodes.append(_Reveal(int(node_id), int(arg), cw, sw))
        elif kind == "choose":
            nodes.append(_Choose(int(node_id),
                                 tuple(float(p) for p in arg), cw, sw))
        else:
            raise ValueError(f"unknown node kind {kind!r}")
    kw = {name: fields[name] for name in _FIELD_NAMES if name != "nodes"}
    kw["wr_words"] = tuple(tuple(int(x) for x in w)
                           for w in kw["wr_words"])
    for name in _FIELD_NAMES:
        if name not in ("tag", "nodes", "wr_words"):
            kw[name] = int(kw[name])
    return DeviceMachine(nodes=tuple(nodes), **kw)


def _pack_fields(vals, bits):
    """Packs ints little-endian into int32 words, 31//bits per word."""
    per = 31 // bits
    words = []
    for w in range((len(vals) + per - 1) // per):
        word = 0
        for f in range(per):
            i = w * per + f
            if i < len(vals):
                word |= int(vals[i]) << (bits * f)
        words.append(word)
    return tuple(words)


def compile_decision_machine(tag: str, *, max_worlds: int | None = None
                             ) -> DeviceMachine:
    """Compiles a rule's decision tree to the gather-free FSM DAG."""
    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    worlds = enum_mod.enumerate_worlds(problem, 2, max_worlds=max_worlds)

    p_lo, p_hi, d_lo, d_hi = _window_bounds(worlds)
    n_p = p_hi - p_lo + 1
    n_d = d_hi - d_lo + 1
    n_cells = n_p + n_d

    # Deduplicated write specs.
    wr_specs: dict[tuple, int] = {}
    wr_mask_list: list[np.ndarray] = []
    wr_val_list: list[np.ndarray] = []
    leaf_spec: dict[tuple[int, ...], int] = {}
    for w in worlds:
        _, _, mask, val = _world_window_info(w, n_cells, n_p, p_lo, d_lo)
        key = (tuple(np.flatnonzero(mask)), tuple(val[mask]))
        if key not in wr_specs:
            wr_specs[key] = len(wr_mask_list)
            wr_mask_list.append(mask)
            wr_val_list.append(val)
        leaf_spec[w.decisions] = wr_specs[key]
    num_specs = len(wr_mask_list)

    # Trie over decision sequences (meta consistent across shared
    # prefixes because replay is deterministic).
    trie: dict = {"children": {}, "meta": None}
    for w in worlds:
        cur = trie
        for depth, v in enumerate(w.decisions):
            cur["meta"] = w.decision_meta[depth]
            cur = cur["children"].setdefault(
                v, {"children": {}, "meta": None})
        cur["spec"] = leaf_spec[w.decisions]

    # Hash-cons identical subtrees into a DAG.
    canon: dict = {}

    def intern(node):
        if node["meta"] is None:
            return ("leaf", node.get("spec", 0))
        meta = node["meta"]
        arity = size_a if meta[0] == "reveal" else len(meta[1])
        kids = tuple(intern(node["children"][b]) for b in range(arity))
        sig = (repr(meta), kids)
        if sig not in canon:
            canon[sig] = (meta, kids)
        return ("node", sig)

    root_ref = intern(trie)
    if root_ref[0] == "leaf":
        raise ValueError(f"{tag!r}: rule has no decision points.")

    # Topological order, parents before children.
    order: list = []
    seen: set = set()

    def topo(ref):
        kind, payload = ref
        if kind != "node" or payload in seen:
            return
        seen.add(payload)
        for k in canon[payload][1]:
            topo(k)
        order.append(payload)

    topo(root_ref)
    order.reverse()
    ids = {sig: i + 1 for i, sig in enumerate(order)}  # 0 = terminal
    n_states = len(order) + 1
    bits = max(_SPEC_BITS, num_specs.bit_length(),
               (n_states - 1).bit_length())
    if bits > 30:
        raise ValueError(
            f"{tag!r}: {n_states} FSM states / {num_specs} specs "
            "exceed the int32 field packing.")

    nodes: list = []
    for sig in order:
        meta, kids = canon[sig]
        child_ids = [0 if k[0] == "leaf" else ids[k[1]] for k in kids]
        kid_specs = [k[1] if k[0] == "leaf" else 0 for k in kids]
        child_words = _pack_fields(child_ids, bits)
        spec_words = _pack_fields(kid_specs, bits)
        if meta[0] == "reveal":
            _, data_tape, index = meta
            cell = (n_p + index - d_lo) if data_tape else (index - p_lo)
            nodes.append(_Reveal(ids[sig], cell, child_words, spec_words))
        else:
            nodes.append(_Choose(ids[sig], tuple(meta[1]), child_words,
                                 spec_words))

    sym_bits = max(4, (size_a - 1).bit_length())
    wr_bits = sym_bits + 1
    wr_words = tuple(
        _pack_fields(
            [int(wr_mask_list[s][c]) << sym_bits
             | int(wr_val_list[s][c])
             for s in range(num_specs)], wr_bits)
        for c in range(n_cells)
    )

    return DeviceMachine(
        tag=tag, size_a=size_a, p_lo=p_lo, d_lo=d_lo, n_p=n_p, n_d=n_d,
        span=max(p_hi - p_lo, d_hi - d_lo) + 1, nodes=tuple(nodes),
        root=ids[order[0]], n_states=n_states, bits=bits,
        wr_words=wr_words, num_specs=num_specs, wr_bits=wr_bits,
    )


def _choose_sampling_dist(probs, tau: float = 1.0):
    """Per-node sampling distribution and per-branch log-weight
    increments. At ``tau = 1`` the distribution is ``probs`` exactly (no
    renormalisation) and the increments are zero."""
    if tau != 1.0:
        raise NotImplementedError(_TODO_TAU)
    p = np.asarray(probs, dtype=np.float64)
    return p, np.zeros_like(p)


@dataclasses.dataclass(frozen=True)
class _Level:
    """One depth of the leveled FSM (host-side static plan).

    Live states at this level carry value ``num_specs + local_id``;
    values below ``num_specs`` are terminal and ARE the write spec.
    """

    cell_groups: tuple  # ((cell, lo), ...) ascending contiguous local-id
    #                     ranges of reveal nodes reading `cell`
    chooses: tuple      # ((local_id, probs), ...)
    max_deg: int
    bits: int           # field width of trans_words entries
    trans_words: tuple  # packed: idx = local_id * max_deg + branch
    n_nodes: int        # live nodes at this level


def _level_plan(dm: DeviceMachine):
    return _build_level_plan(dm.nodes, dm.root, dm.num_specs, dm.size_a,
                             dm.bits)


@functools.lru_cache(maxsize=None)
def _build_level_plan(nodes, root, num_specs, size_a, bits):
    """Levels the decision DAG for the level-synchronous walk.

    BFS from the root with STRICT leveling: a node reachable at several
    depths is duplicated per depth, so after ℓ steps every site's state
    lives in level ℓ's table or is terminal. Within a level, reveal nodes
    are grouped contiguously by read cell and choose nodes go last,
    grouped by distribution.
    """
    by_id = {n.node_id: n for n in nodes}
    fields = 31 // bits

    def branches(n):
        deg = len(n.probs) if isinstance(n, _Choose) else size_a
        out = []
        for b in range(deg):
            child = (int(n.child_words[b // fields])
                     >> (bits * (b % fields))) & ((1 << bits) - 1)
            spec = (int(n.spec_words[b // fields])
                    >> (bits * (b % fields))) & ((1 << bits) - 1)
            out.append((child, spec))
        return out

    levels = [[root]]
    while True:
        nxt: list = []
        seen: set = set()
        for nid in levels[-1]:
            for child, _ in branches(by_id[nid]):
                if child and child not in seen:
                    seen.add(child)
                    nxt.append(child)
        if not nxt:
            break
        nxt.sort(key=lambda i: (
            (0, by_id[i].cell, ()) if isinstance(by_id[i], _Reveal)
            else (1, 0, tuple(by_id[i].probs)), i))
        levels.append(nxt)

    plan = []
    for d, lvl in enumerate(levels):
        loc_next = ({nid: j for j, nid in enumerate(levels[d + 1])}
                    if d + 1 < len(levels) else {})
        max_deg = max(len(by_id[i].probs) if isinstance(by_id[i], _Choose)
                      else size_a for i in lvl)
        vals = []
        cell_groups: list = []
        chooses: list = []
        for j, nid in enumerate(lvl):
            n = by_id[nid]
            if isinstance(n, _Reveal):
                if not cell_groups or cell_groups[-1][0] != n.cell:
                    cell_groups.append((n.cell, j))
            else:
                chooses.append((j, n.probs))
            row = [spec if child == 0 else num_specs + loc_next[child]
                   for child, spec in branches(n)]
            vals.extend(row + [0] * (max_deg - len(row)))
        lbits = max(1, (num_specs + len(loc_next) - 1).bit_length())
        plan.append(_Level(
            cell_groups=tuple(cell_groups),
            chooses=tuple(chooses),
            max_deg=max_deg,
            bits=lbits,
            trans_words=_pack_fields(vals, lbits),
            n_nodes=len(lvl),
        ))
    return tuple(plan)


@dataclasses.dataclass(frozen=True)
class _ChooseGroup:
    """Contiguous same-distribution choose nodes of one level, with the
    exact branch constants the reference's walk computes with.

    The reference runs its walk on a float32 uniform and lets numpy
    float64 constants promote it: the first group with two or more
    branches compares ``u >= cum[j-1]`` in float64 and leaves ``u``
    float64 from then on. Before that promotion the widths that come
    from ``full_like(u, ·)`` (and any weakly typed ``1e-30`` floor) are
    float32; those values are stored here already rounded, so the walk
    itself runs in float64 throughout. A group with a single branch
    while ``u`` is still float32 divides in float32 (``f32_div``).
    """

    id_lo: int
    id_hi: int
    cum: tuple      # cum[0..n-2], float64 thresholds
    widths: tuple   # per-branch widths as the reference rounds them
    f32_div: bool


@functools.lru_cache(maxsize=None)
def _choose_plan(dm: DeviceMachine):
    """Per level, the :class:`_ChooseGroup` list in walk order."""
    u_f32 = True  # the round's uniforms are float32
    out = []
    for lv in _level_plan(dm):
        groups = []
        g = 0
        while g < len(lv.chooses):
            id_lo, probs = lv.chooses[g]
            h = g + 1
            while (h < len(lv.chooses)
                   and lv.chooses[h][1] == probs
                   and lv.chooses[h][0] == lv.chooses[h - 1][0] + 1):
                h += 1
            id_hi = lv.chooses[h - 1][0]
            g = h
            q, _ = _choose_sampling_dist(probs)
            cum = np.cumsum(q)
            width_f32 = u_f32
            widths = [float(np.float32(max(q[0], 1e-30))) if width_f32
                      else float(max(q[0], 1e-30))]
            for j in range(1, len(q)):
                if q[j] >= 1e-30:  # a numpy float64: promotes the width
                    width_f32 = False
                    widths.append(float(q[j]))
                else:  # the weakly typed 1e-30 keeps the width's dtype
                    widths.append(float(np.float32(1e-30)) if width_f32
                                  else 1e-30)
            f32_div = u_f32 and len(q) == 1
            if len(q) > 1:
                u_f32 = False
            groups.append(_ChooseGroup(
                id_lo, id_hi, tuple(float(c) for c in cum[:-1]),
                tuple(widths), f32_div))
        out.append(tuple(groups))
    return tuple(out)


# --- K1: the stacked-plane round ---------------------------------------------
#
# The tape is stored as `stride` planes (plane c = columns c::stride, each
# [B, E]) stacked into one [stride, B, E] int8 tensor. Site k of a round
# with phase s in [0, stride) sits at flat column s + k*stride; its window
# cell at offset `off` lives in plane (s+off) mod stride at element
# k + floor((s+off)/stride), the floor being -1, 0 or +1.


def _unpack_field(words, widx, shift_amt, bits):
    """Selects words[widx] >> shift_amt & mask (words[0] when widx is out
    of range, as the reference's select chain does)."""
    v = torch.full_like(shift_amt, words[0]) >> shift_amt
    for wi in range(1, len(words)):
        v = torch.where(widx == wi,
                        torch.full_like(shift_amt, words[wi]) >> shift_amt,
                        v)
    return v & ((1 << bits) - 1)


def _walk_plain(dm: DeviceMachine, cells, uniforms):
    """Level-synchronous FSM walk over per-cell planes -> write spec
    (int32). The plain counterpart of the reference's
    `_machine_specs_planes_leveled` at tau = 1."""
    S = dm.num_specs
    shape = cells[0].shape
    device = cells[0].device
    state = torch.full(shape, S, dtype=torch.int32, device=device)
    u = None if uniforms is None else uniforms.to(torch.float64)
    for lv, groups in zip(_level_plan(dm), _choose_plan(dm)):
        if lv.cell_groups:
            b = cells[lv.cell_groups[0][0]].to(torch.int32)
            for cell, lo in lv.cell_groups[1:]:
                b = torch.where(state >= S + lo,
                                cells[cell].to(torch.int32), b)
        else:
            b = torch.zeros(shape, dtype=torch.int32, device=device)
        for g in groups:
            mask = (state >= S + g.id_lo) & (state <= S + g.id_hi)
            bb = torch.zeros(shape, dtype=torch.int32, device=device)
            lo_ = torch.zeros(shape, dtype=torch.float64, device=device)
            width = torch.full(shape, g.widths[0], dtype=torch.float64,
                               device=device)
            for j in range(1, len(g.widths)):
                sel = u >= g.cum[j - 1]
                bb = torch.where(sel, j, bb)
                lo_ = torch.where(sel, g.cum[j - 1], lo_)
                width = torch.where(sel, g.widths[j], width)
            b = torch.where(mask, bb, b)
            if g.f32_div:
                nu = (u.to(torch.float32)
                      / torch.tensor(g.widths[0], dtype=torch.float32))
                u = torch.where(mask, nu.to(torch.float64), u)
            else:
                u = torch.where(mask, (u - lo_) / width, u)
        idx = torch.clamp(state - S, min=0) * lv.max_deg + b
        fields = 31 // lv.bits
        nxt = _unpack_field(lv.trans_words, idx // fields,
                            lv.bits * (idx % fields), lv.bits)
        state = torch.where(state >= S, nxt, state)
    return state


def _writes_plain(dm: DeviceMachine, spec, cells):
    """Applies write specs to per-cell planes (the plain counterpart of
    the reference's `_machine_writes_planes`)."""
    wb = dm.wr_bits
    per = 31 // wb
    shift_amt = wb * (spec % per)
    widx = spec // per
    outs = []
    for c in range(dm.n_cells):
        f = _unpack_field(dm.wr_words[c], widx, shift_amt, wb)
        writes = (f >> (wb - 1)) == 1
        val = (f & ((1 << (wb - 1)) - 1)).to(cells[c].dtype)
        outs.append(torch.where(writes, val, cells[c]))
    return outs


def _round_cells(dm: DeviceMachine, shift: int, stride: int):
    """(tape, plane, spill) of every window cell at phase ``shift``, in
    cell order (program cells, then data cells). Floored division, as
    the reference's `jnp.mod` / `jnp.floor_divide`."""
    out = []
    for tape, lo, n in ((0, dm.p_lo, dm.n_p), (1, dm.d_lo, dm.n_d)):
        for j in range(n):
            a = shift + lo + j
            out.append((tape, a % stride, a // stride))
    return out


def plane_round_plain(dm: DeviceMachine, p_st, d_st, shifts, k,
                      uniforms=None):
    """K1's plain version: round ``k`` (phase ``shifts[k]``) on the
    stacked planes ``p_st``, ``d_st`` ([stride, B, E] int8), in place.

    All window cells are read before any is written back; each cell sits
    in its own plane, so the writes do not overlap.
    """
    plane_round_plain.calls += 1
    stride = p_st.shape[0]
    sts = (p_st, d_st)
    locs = _round_cells(dm, int(shifts[k]), stride)
    # Read: x[i] = plane[(i + e) mod E], i.e. roll by -e.
    cells = [torch.roll(sts[t][c], -e, dims=1) if e else sts[t][c]
             for t, c, e in locs]
    spec = _walk_plain(dm, cells, uniforms if dm.has_choose else None)
    new = _writes_plain(dm, spec, cells)
    for (t, c, e), v in zip(locs, new):
        sts[t][c] = torch.roll(v, e, dims=1) if e else v


plane_round_plain.calls = 0


def _check_planes(dm, p_st, d_st, shifts, k0, n, uniforms):
    """Checks the planes, ``shifts`` and the uniforms of rounds
    [k0, k0+n) (``uniforms`` [n, B, E], read only by choose machines)."""
    if p_st.dtype != torch.int8 or d_st.dtype != torch.int8:
        raise TypeError("planes must be int8")
    if p_st.dim() != 3 or p_st.shape != d_st.shape:
        raise ValueError(
            f"planes must be two equal [stride, B, E] tensors, got "
            f"{tuple(p_st.shape)} and {tuple(d_st.shape)}")
    if not (p_st.is_contiguous() and d_st.is_contiguous()):
        raise ValueError("planes must be contiguous")
    if shifts.dtype != torch.int32 or shifts.dim() != 1:
        raise TypeError("shifts must be a 1-D int32 tensor")
    if not (0 <= k0 and k0 + n <= shifts.shape[0]):
        raise IndexError(f"rounds [{k0}, {k0 + n}) outside "
                         f"shifts[0:{shifts.shape[0]}]")
    dev = p_st.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {dev}")
    for name, t in (("d_st", d_st), ("shifts", shifts)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, planes on {dev}")
    if dm.has_choose:
        _, B, E = p_st.shape
        if (uniforms is None or uniforms.dtype != torch.float32
                or tuple(uniforms.shape) != (n, B, E)
                or not uniforms.is_contiguous()):
            raise ValueError(
                f"{dm.tag} has choose nodes: uniforms must be a "
                f"contiguous float32 [{n}, {B}, {E}] tensor")
        if uniforms.device != dev:
            raise ValueError(f"uniforms on {uniforms.device}, planes on {dev}")
    if p_st.numel() >= 2**31:
        raise ValueError("K1 takes planes of fewer than 2**31 symbols")


def _rounds(dm, p_st, d_st, shifts, k0, n, uniforms):
    """Rounds [k0, k0+n), checked by the caller: the plain version a
    round on the CPU; on the card one C call that launches K1 once a
    round on the current stream."""
    if p_st.device.type == "cpu":
        for j in range(n):
            plane_round_plain(dm, p_st, d_st, shifts, k0 + j,
                              None if uniforms is None else uniforms[j])
        return
    from .k1_source import k1_library  # k1_source imports this module

    lib = k1_library(dm)
    stride, B, E = p_st.shape
    u_ptr = uniforms.data_ptr() if dm.has_choose else None
    with torch.cuda.device(p_st.device):
        stream = torch.cuda.current_stream(p_st.device).cuda_stream
        rc = lib.ckpe_k1_rounds(p_st.data_ptr(), d_st.data_ptr(), u_ptr,
                                shifts.data_ptr(), int(k0), int(n), int(B),
                                int(E), int(stride), stream)
    cuda.check(rc, "plane_round", lib)
    plane_round.launches += n


def plane_round(dm: DeviceMachine, p_st, d_st, shifts, k, uniforms=None):
    """Round ``k`` of a run on the stacked planes, in place (K1).

    ``shifts`` is the run's int32 phase array on the planes' device; the
    kernel reads ``shifts[k]`` there, so no round waits on the host.
    ``uniforms`` ([B, E] float32) is read only by machines with choose
    nodes.

    CPU tensors take :func:`plane_round_plain`; CUDA tensors launch the
    machine's K1 (`k1_source.k1_library`).
    """
    if uniforms is not None:
        uniforms = uniforms[None]
    _check_planes(dm, p_st, d_st, shifts, k, 1, uniforms)
    _rounds(dm, p_st, d_st, shifts, k, 1, uniforms)


plane_round.launches = 0


# --- Plane storage and runs ---------------------------------------------------

_MAX_PLANE_STRIDE = 64  # the reference's plane-path limit


def _tape_to_planes(tape, stride):
    """[B, L] -> stacked planes [stride, B, L // stride]; plane c holds
    columns c::stride."""
    B, L = tape.shape
    return tape.reshape(B, L // stride, stride).permute(2, 0, 1).contiguous()


def _planes_to_tape(planes):
    """Stacked planes [stride, B, E] -> [B, E * stride]."""
    stride, B, E = planes.shape
    return planes.permute(1, 2, 0).reshape(B, E * stride)


class PlaneState:
    """Plane-resident ensemble state, kind ``"fsm"`` (stacked int8
    symbol planes ``pbp``, ``dbp``, each [stride, B, E]).

    `run_ensemble(..., keep_planes=True)` returns one and accepts one in
    place of the ``(ptape, dtape)`` pair, so snapshot-style callers skip
    the per-call tape<->plane conversion. A state passed in is left as
    it was: the run advances a copy.
    """

    kind = "fsm"

    def __init__(self, pbp, dbp, *, batch, length):
        self.pbp = pbp
        self.dbp = dbp
        self.batch = batch
        self.length = length

    @property
    def stride(self):
        return self.pbp.shape[0]

    def tapes(self):
        """Decodes back to (ptape, dtape) int32 [B, L] tensors."""
        return (_planes_to_tape(self.pbp).to(torch.int32),
                _planes_to_tape(self.dbp).to(torch.int32))


def _check_round_geometry(L: int, events: int, span: int) -> None:
    """Round-lattice geometry gate. ``events`` must divide L. At E=1 a
    round fires a single site per member, so only the rule's window has
    to fit the ring. At E>1 the lattice sites must sit > 2·span apart so
    no event can see another's writes within a round (which is also
    what makes K1's in-place update safe)."""
    if L % events:
        raise ValueError(f"events_per_step={events} must divide L={L}")
    if events == 1:
        if span > L:
            raise ValueError(
                f"window span {span} exceeds tape length {L}")
    elif L // events <= 2 * span:
        raise ValueError(
            f"stride {L // events} too small for window span {span}; "
            "lower events_per_step")


def run_rounds(dm: DeviceMachine, p_st, d_st, shifts, uniforms=None):
    """Applies ``len(shifts)`` rounds to stacked planes, in place, with
    explicit draws: ``shifts`` int32 [num_steps] in [0, stride) on the
    planes' device, ``uniforms`` float32 [num_steps, B, E] (read only by
    machines with choose nodes; None otherwise). Returns the planes.

    This is `run_ensemble`'s round loop without the random draws, so a
    caller can feed it draws made elsewhere (the tests feed it the JAX
    package's own). On the card every round is launched from one C call.
    """
    if dm.has_choose and uniforms is None:
        raise ValueError(f"{dm.tag} has choose nodes: pass uniforms")
    n = shifts.shape[0]
    _check_planes(dm, p_st, d_st, shifts, 0, n, uniforms)
    _rounds(dm, p_st, d_st, shifts, 0, n, uniforms)
    return p_st, d_st


# Uniforms drawn ahead of the launches, at most this many a chunk.
_UNIFORM_CHUNK = 2**25


def run_ensemble(generator, tapes, dm, steps_events, *,
                 independent_sites: bool = False,
                 bitslice: bool | None = None,
                 keep_planes: bool = False, device=None):
    """Advances a batch of tape pairs with stratified lattice rounds.

    Each round fires the rule at E sites per replica arranged as a
    randomly shifted lattice (shared by the batch): no conflicts, every
    event applies. The tapes are stored as `stride` int8 planes and
    stepped by K1 (:func:`plane_round`), the counterpart of the
    reference's stacked-plane FSM round; the phase is drawn over
    [0, stride), which fires the same site set as a full-tape shift.

    Draws come from ``generator`` (a `torch.Generator` on the run's
    device, or an int seed): first all ``num_steps`` shifts at once, as
    one int32 tensor on the device, then each round's [B, E] float32
    uniforms, round by round into a buffer of a chunk of rounds, which
    one call then runs. Machines without choose nodes read no uniforms,
    so none are drawn for them (the reference draws and discards them),
    and one call runs every round. The stream is not the JAX package's;
    :func:`run_rounds` takes explicit draws.

    Args:
      generator: `torch.Generator` on the run's device, or an int seed.
      tapes: (ptape [B, L], dtape [B, L]) integer tensors or arrays, or a
        :class:`PlaneState` from an earlier call.
      dm: compiled :class:`DeviceMachine`.
      steps_events: (num_steps, events_per_step). events_per_step must
        divide L, L/E must exceed 2·span (for E > 1) and be <= 64.
      bitslice: None or False run the FSM plane round (the reference
        gates the two rounds bit-identical); True is not ported yet.
      keep_planes: return a :class:`PlaneState` instead of tapes.
      device: where the run goes; ``cuda`` unless named.

    Returns:
      ((ptape, dtape) int32 [B, L], or a PlaneState under keep_planes),
      (applied int64 [num_steps] summed over replicas,
       times float64 [num_steps] cumulative).
    """
    if not isinstance(dm, DeviceMachine):
        raise NotImplementedError(_TODO_TABLE)
    if bitslice:
        raise NotImplementedError(_TODO_BITSLICE)
    if independent_sites:
        raise NotImplementedError(_TODO_LATTICE)
    num_steps, events = steps_events
    device = config.get_device(device)
    if isinstance(tapes, PlaneState):
        B, L = tapes.batch, tapes.length
    else:
        ptape, dtape = (torch.as_tensor(t, device=device) for t in tapes)
        B, L = ptape.shape
    _check_round_geometry(L, events, dm.span)
    stride = L // events
    if stride > _MAX_PLANE_STRIDE:
        raise NotImplementedError(_TODO_LATTICE)
    if isinstance(tapes, PlaneState):
        if tapes.stride != stride:
            raise ValueError(
                f"PlaneState stride {tapes.stride} != L//events = "
                f"{stride}: pack and continuation calls must use the "
                "same events_per_step")
        p_st = tapes.pbp.to(device=device, copy=True)
        d_st = tapes.dbp.to(device=device, copy=True)
    else:
        p_st = _tape_to_planes(ptape.to(torch.int8), stride)
        d_st = _tape_to_planes(dtape.to(torch.int8), stride)
    gen = config.make_generator(generator, device)
    shifts = torch.randint(0, stride, (num_steps,), generator=gen,
                           device=device, dtype=torch.int32)
    if num_steps:
        chunk, buf = num_steps, None
        if dm.has_choose:
            chunk = max(1, min(num_steps, _UNIFORM_CHUNK // (B * events)))
            buf = torch.empty((chunk, B, events), dtype=torch.float32,
                              device=device)
        _check_planes(dm, p_st, d_st, shifts, 0, chunk, buf)
        for k0 in range(0, num_steps, chunk):
            n = min(chunk, num_steps - k0)
            uniforms = None if buf is None else buf[:n]
            for j in range(n if dm.has_choose else 0):
                torch.rand((B, events), generator=gen, device=device,
                           dtype=torch.float32, out=uniforms[j])
            _rounds(dm, p_st, d_st, shifts, k0, n, uniforms)
    applied = torch.full((num_steps,), B * events, dtype=torch.int64,
                         device=device)
    f64 = config.DEFAULT_FLOAT
    # A Python float, not a tensor copied to the card: that copy would
    # make the host wait for every queued round before it queues the rest.
    dt_round = float(-torch.log1p(torch.tensor(-events / L, dtype=f64)))
    times = torch.arange(1, num_steps + 1, dtype=f64, device=device) * dt_round
    if keep_planes:
        out = PlaneState(p_st, d_st, batch=B, length=L)
    else:
        out = (_planes_to_tape(p_st).to(torch.int32),
               _planes_to_tape(d_st).to(torch.int32))
    return out, (applied, times)


# --- K2: window histogram -----------------------------------------------------


def window_bins(tape, size_a: int, cl_k: int):
    """The bin of every circular length-cl_k window of the [B, L] int32
    ``tape`` that the reference counts, as a flat int64 tensor.

    The reference's rank is an int32 Horner sum, which wraps; its
    scatter then reads a rank in [-n, 0) as bin rank + n (numpy's rule
    for negative indices) and drops any other rank outside [0, n), with
    n = size_a**cl_k. The sum is taken here in int64 and kept to its low
    32 bits at every step, which is the int32 sum modulo 2**32."""
    rank = torch.zeros(tape.shape, dtype=torch.int64, device=tape.device)
    for j in range(cl_k):
        rank = (rank * size_a + torch.roll(tape, -j, dims=1)) & 0xFFFFFFFF
    rank = rank.reshape(-1)
    rank = torch.where(rank >= 2**31, rank - 2**32, rank)
    n_bins = size_a**cl_k
    rank = torch.where(rank < 0, rank + n_bins, rank)
    return rank[(rank >= 0) & (rank < n_bins)]


def window_counts_plain(tape, size_a: int, cl_k: int):
    """K2's plain version: int64 counts of every circular length-cl_k
    window of the [B, L] int32 ``tape`` by the bin `window_bins` gives
    it."""
    bins = window_bins(tape, size_a, cl_k)
    counts = torch.zeros(size_a**cl_k, dtype=torch.int64, device=tape.device)
    counts.index_add_(0, bins, torch.ones_like(bins))
    return counts


def _window_counts_int(tape, size_a: int, cl_k: int):
    """int64 window counts: K2 for a CUDA tape, the plain version for a
    CPU tape."""
    dev = tape.device
    if dev.type == "cpu":
        return window_counts_plain(tape, size_a, cl_k)
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {dev}")
    if tape.dtype != torch.int32 or tape.dim() != 2:
        raise TypeError("tape must be a [B, L] int32 tensor")
    tape = tape.contiguous()
    B, L = tape.shape
    counts = torch.zeros(size_a**cl_k, dtype=torch.int64, device=dev)
    lib = cuda.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ckpe_window_counts(tape.data_ptr(), int(B), int(L),
                                    int(size_a), int(cl_k),
                                    counts.data_ptr(), stream)
    cuda.check(rc, "window_counts", lib)
    window_counts.launches += 1
    return counts


def window_counts(tape, size_a: int, cl_k: int, *, device=None):
    """Empirical SPD estimate from a batch of tapes: normalised counts of
    every length-cl_k window (circular), float64 [size_a**cl_k] (K2).

    ``tape`` is [B, L] or [L]; it is moved to ``device`` (``cuda``
    unless named)."""
    if size_a**cl_k >= 2**31:
        raise ValueError(f"size_a**cl_k = {size_a**cl_k} bins exceed int32")
    tape = torch.as_tensor(tape, device=config.get_device(device))
    tape = tape.to(torch.int32)
    if tape.dim() == 1:
        tape = tape[None]
    B, L = tape.shape
    counts = _window_counts_int(tape, size_a, cl_k)
    return counts.to(config.DEFAULT_FLOAT) / (B * L)


window_counts.launches = 0


# --- Initial tapes from an SPD -------------------------------------------------


def sample_tapes_from_spd(generator, spd, size_a: int, cl_k: int,
                          batch: int, length: int, *, device=None):
    """Draws int32 [batch, length] tape rings whose window statistics
    follow an SPD: symbols come from the SPD's order-(cl_k-1) Markov
    chain (`markov.mpp_from_spd`), sampled as a circular Markov BRIDGE.

    Each step's distribution is reweighted by the bridge factor
    ``T^(r-1)[next_ctx, ctx0]`` (r symbols remaining), so the sequence
    closes its own starting context and the ``cl_k-1`` windows crossing
    the seam read Markov-consistent statistics. Only the columns of the
    context transfer matrix at the sampled start contexts are kept, and
    only until they flatten (the chain has mixed): a flat bridge cancels
    in the per-step normalisation. If a start context cannot close its
    cycle at all, the whole batch is drawn as a linear chain instead.

    Host numpy builds the bridge table; the draws run in torch on
    ``device`` from ``generator`` (a `torch.Generator` there, or a seed).
    """
    from ..markov import mpp_from_spd

    device = config.get_device(device)
    gen = config.make_generator(generator, device)
    f64 = config.DEFAULT_FLOAT
    n_ctx = size_a ** (cl_k - 1)
    mpp_np = np.asarray(
        mpp_from_spd(np.asarray(spd).reshape([size_a] * cl_k)),
        dtype=np.float64,
    ).reshape(n_ctx, size_a)
    marg_np = np.asarray(spd, dtype=np.float64).reshape(
        n_ctx, size_a).sum(axis=1)
    nctx_np = (np.arange(n_ctx)[:, None] * size_a
               + np.arange(size_a)[None, :]) % n_ctx
    mpp = torch.as_tensor(mpp_np, device=device)
    nctx = torch.as_tensor(nctx_np, device=device)
    ctx = torch.multinomial(
        torch.as_tensor(marg_np / marg_np.sum(), device=device), batch,
        replacement=True, generator=gen)

    # cols[r][c, j] = T^r[c, u_j] for the unique start contexts u_j.
    u_starts, inv = np.unique(ctx.cpu().numpy(), return_inverse=True)
    n_u = len(u_starts)
    v = np.zeros((n_ctx, n_u))
    v[u_starts, np.arange(n_u)] = 1.0
    cols = []
    flat_tol = 1e-13
    for _ in range(length):
        cols.append(v)
        v = np.einsum("cs,csj->cj", mpp_np, v[nctx_np])
        vmax = v.max(axis=0)
        if np.all(vmax - v.min(axis=0) <= flat_tol * vmax):
            break  # columns mixed: flat bridge from here on
    n_kept = len(cols)
    ring = True
    if n_kept == length:
        # Never mixed within the horizon: every sampled start must be
        # able to close its cycle (T^length[u_j, u_j] > 0).
        feas = np.array([float(mpp_np[u] @ cols[-1][nctx_np[u], j])
                         for j, u in enumerate(u_starts)])
        ring = not np.any(feas <= 0)
    V = torch.as_tensor(np.stack(cols), device=device)
    inv_t = torch.as_tensor(inv, device=device)[:, None]

    syms = torch.empty((length, batch), dtype=torch.int32, device=device)
    for step in range(length):
        probs = mpp[ctx]
        rr = length - step - 1
        if ring and rr < n_kept:
            probs = probs * V[rr][nctx[ctx], inv_t]
        cdf = torch.cumsum(probs / probs.sum(dim=1, keepdim=True), dim=1)
        u = torch.rand((batch, 1), generator=gen, device=device, dtype=f64)
        sym = torch.clamp((u >= cdf).sum(dim=1), max=size_a - 1)
        syms[step] = sym.to(torch.int32)
        ctx = nctx[ctx, sym]
    return syms.T.contiguous()
