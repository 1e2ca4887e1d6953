"""Ensemble mode: step a batch of concrete tapes in lockstep.

Counterpart of the JAX package's `engine/ensemble.py`: the transition
table and the decision-machine compilers, `run_ensemble` on the
bit-sliced round (`bitslice.py`: K14 and K15), on the stacked-plane FSM
round and on the rolled lattice rounds (transition tables, per-member
sites, strides above 64), first passage, and the
observables `window_counts`, `weighted_window_counts`,
`contains_pattern`, `pattern_progress` and `sample_tapes_from_spd`. The
weighted frontier (`frontier.py`: K19-K22, tempered rounds) is
re-exported under the reference's names.

Kernels carry the device work (sources in `csrc/`, built by `cuda.py`):

- **K1** `plane_round` — one stratified round on the stacked int8 planes,
  in place, compiled for each decision machine (`k1_source.py` writes
  the machine's unit, `csrc/plane_round.cuh` is the kernel). It replaces
  the reference's `_apply_plane_round_fsm_stacked`,
  `_machine_specs_planes_leveled` and `_machine_writes_planes` (and the
  Pallas probes `probes/pallas_plane_round.py:fsm_kernel` and
  `probes/pallas_packed32.py:fsm_kernel_packed`, which compute the same
  round).
- **K2** `window_counts` — the circular window histogram.
- **K10** `table_round` — the transition-table rounds on [B, L] int32
  tapes at any shift (`csrc/table_round.cu`), the reference's
  `_apply_lattice_round`: all rounds of a call in one launch on members
  held in shared memory (`k10_tile`, `csrc/table_resident.cuh`), a
  launch a round for calls of fewer than `K11_RESIDENT_MIN_ROUNDS`
  rounds and rows too long to keep; `run_ensemble` draws a table's
  uniforms `_TABLE_CHUNK` at a time.
- **K11** `lattice_round` — the FSM rounds on [B, L] int8 tapes at a
  shared or a per-member shift, in each machine's K1 unit
  (`csrc/lattice_round.cuh`), the reference's `_apply_lattice_round_fsm`
  with `_roll_cols` and `_roll_rows`: all rounds of a call in one launch
  on members held in shared memory (`k11_tile`), first passage's update
  applied there after each round (calls of fewer than
  `K11_RESIDENT_MIN_ROUNDS` rounds, and rows too long to keep, take a
  launch a round).
- **K12** `pattern_scan` — `contains_pattern`, `pattern_progress` and
  the first-passage update at t = 0 (`csrc/pattern_scan.cu`, a warp a
  member on rows staged in shared memory: `k12_members`).
- **K13** `weighted_window_counts` — K2's windows weighted by member,
  summed in a fixed order (`csrc/weighted_counts.cu`).

Each wrapper runs its plain PyTorch version (``*_plain``, beside it) for
CPU tensors only; for a CUDA tensor it launches the kernel or raises.
Each counts its launches in ``<wrapper>.launches``.

Time normalisation matches the exact engine's semantics: the rule fires
once per site per unit time, so one round of E events on a length-L tape
advances time by ``-log1p(-E/L)``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from .. import cuda
from ..utils import config
from . import dsl, enumerate as enum_mod

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


# --- Transition table: one outcome distribution per window content ------------


@dataclasses.dataclass(frozen=True)
class TransitionTable:
    """Dense per-window-content outcome table for one reaction rule
    (host numpy, as the reference's)."""

    tag: str
    size_a: int
    # Read-window offsets, inclusive: program cells site+p_lo..site+p_hi,
    # data cells site+d_lo..site+d_hi.
    p_lo: int
    p_hi: int
    d_lo: int
    d_hi: int
    out_cum: np.ndarray    # [rows, M] float64, cumulative outcome probs
    out_world: np.ndarray  # [rows, M] int32, write spec of each slot
    wr_mask: np.ndarray    # [W, n_cells] bool, does spec write this cell
    wr_val: np.ndarray     # [W, n_cells] int32, written symbol

    @property
    def n_p(self) -> int:
        return self.p_hi - self.p_lo + 1

    @property
    def n_d(self) -> int:
        return self.d_hi - self.d_lo + 1

    @property
    def n_cells(self) -> int:
        return self.n_p + self.n_d

    @property
    def num_rows(self) -> int:
        return self.size_a**self.n_cells

    @property
    def span(self) -> int:
        """Conservative conflict radius: events at site distance > span
        touch disjoint cells on both tapes."""
        return max(self.p_hi - self.p_lo, self.d_hi - self.d_lo) + 1

    def summary(self) -> str:
        return (
            f"{self.tag}: window P[{self.p_lo}..{self.p_hi}] "
            f"D[{self.d_lo}..{self.d_hi}] -> {self.num_rows} rows x "
            f"{self.out_cum.shape[1]} outcomes, "
            f"{len(self.wr_mask)} distinct writes"
        )


# The table's fields, as `transition_table_from_fields` takes them.
_TABLE_FIELDS = ("tag", "size_a", "p_lo", "p_hi", "d_lo", "d_hi",
                 "out_cum", "out_world", "wr_mask", "wr_val")


def transition_table_from_fields(fields) -> TransitionTable:
    """Builds a :class:`TransitionTable` from a mapping of its field
    names to values, which is how a table compiled by the JAX package
    crosses over (its ints and numpy arrays)."""
    return TransitionTable(
        tag=str(fields["tag"]),
        **{k: int(fields[k]) for k in ("size_a", "p_lo", "p_hi", "d_lo",
                                       "d_hi")},
        out_cum=np.asarray(fields["out_cum"], np.float64),
        out_world=np.asarray(fields["out_world"], np.int32),
        wr_mask=np.asarray(fields["wr_mask"], bool),
        wr_val=np.asarray(fields["wr_val"], np.int32))


def compile_transition_table(tag: str, *, max_rows: int = 5_000_000,
                             max_worlds: int | None = None
                             ) -> TransitionTable:
    """Builds the dense transition table for a registered problem: for
    each content of the combined read window (one row, its radix rank),
    the compatible execution paths' write specs in decision-tree order
    with their cumulative probabilities."""
    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    # Branch structure is cl_k-independent; cl_k=2 keeps the reveal
    # bookkeeping minimal.
    worlds = [w for w in enum_mod.enumerate_worlds(
        problem, 2, max_worlds=max_worlds) if w.const > 0.0]

    p_lo, p_hi, d_lo, d_hi = _window_bounds(worlds)
    n_p = p_hi - p_lo + 1
    n_cells = n_p + (d_hi - d_lo + 1)
    num_rows = size_a**n_cells
    if num_rows > max_rows:
        raise ValueError(
            f"Problem {tag!r} reads a {n_cells}-cell window -> "
            f"{num_rows} table rows > max_rows={max_rows}.")
    pv = size_a ** np.arange(n_cells - 1, -1, -1)  # radix place values

    wr_specs: dict[tuple, int] = {}
    wr_mask_list: list[np.ndarray] = []
    wr_val_list: list[np.ndarray] = []
    row_chunks, spec_chunks, const_chunks, order_chunks = [], [], [], []
    for n_world, w in enumerate(worlds):
        fixed_cells, fixed_vals, mask, val = _world_window_info(
            w, n_cells, n_p, p_lo, d_lo)
        key = (tuple(np.flatnonzero(mask)), tuple(val[mask]))
        if key not in wr_specs:
            wr_specs[key] = len(wr_mask_list)
            wr_mask_list.append(mask)
            wr_val_list.append(val)
        spec = wr_specs[key]

        free = np.setdiff1d(np.arange(n_cells), np.asarray(fixed_cells))
        base_rank = int(np.asarray(fixed_vals) @ pv[np.asarray(
            fixed_cells, dtype=np.int64)]) if fixed_cells else 0
        if free.size:
            grids = np.meshgrid(*([np.arange(size_a)] * free.size),
                                indexing="ij")
            combos = np.stack([g.ravel() for g in grids], axis=1)
            rows = base_rank + combos @ pv[free]
        else:
            rows = np.array([base_rank], dtype=np.int64)
        row_chunks.append(rows)
        spec_chunks.append(np.full(rows.shape, spec, np.int32))
        const_chunks.append(np.full(rows.shape, w.const))
        order_chunks.append(np.full(rows.shape, n_world, np.int64))

    all_rows = np.concatenate(row_chunks)
    all_specs = np.concatenate(spec_chunks)
    all_consts = np.concatenate(const_chunks)
    all_order = np.concatenate(order_chunks)

    totals = np.zeros(num_rows)
    np.add.at(totals, all_rows, all_consts)
    if not np.allclose(totals, 1.0, atol=1e-9):
        bad = int(np.argmax(np.abs(totals - 1.0)))
        raise AssertionError(
            f"Outcome probabilities for {tag!r} row {bad} sum to "
            f"{totals[bad]}, not 1 — enumeration is inconsistent.")

    # Group by row, in decision-tree order within a row.
    perm = np.lexsort((all_order, all_rows))
    all_rows, all_specs, all_consts = (
        all_rows[perm], all_specs[perm], all_consts[perm])
    counts = np.bincount(all_rows, minlength=num_rows)
    m = int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(all_rows)) - starts[all_rows]

    out_world = np.zeros((num_rows, m), np.int32)
    prob = np.zeros((num_rows, m), np.float64)
    prob[all_rows, slot] = all_consts
    out_world[all_rows, slot] = all_specs
    cum = np.cumsum(prob, axis=1)
    # Trailing slots repeat the last outcome with cum 1, so a uniform
    # always lands on a valid slot; the last slot's cum is exactly 1.
    filled = np.arange(m)[None, :] < counts[:, None]
    out_cum = np.where(filled, cum, 1.0)
    last = np.maximum(counts - 1, 0)
    out_world = np.where(
        filled, out_world, out_world[np.arange(num_rows), last][:, None])
    out_cum[np.arange(num_rows), last] = 1.0

    if config.IS_DEBUG:
        print(f"[ckpe] transition table {tag}: rows={num_rows} m={m} "
              f"writes={len(wr_mask_list)}")

    return TransitionTable(
        tag=tag, size_a=size_a, p_lo=p_lo, p_hi=p_hi, d_lo=d_lo, d_hi=d_hi,
        out_cum=out_cum, out_world=out_world,
        wr_mask=np.stack(wr_mask_list), wr_val=np.stack(wr_val_list))


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


def wr_field_host(words, s, wr_bits: int = 5):
    """Host-side decode of one cell's packed write field(s): ``words`` a
    `DeviceMachine.wr_words[c]` tuple, ``s`` a spec index or a numpy
    array of them. Returns ``(writes?, symbol)`` numpy arrays."""
    per = 31 // wr_bits
    w = np.asarray(words, np.int64)
    f = (w[np.asarray(s) // per] >> (wr_bits * (np.asarray(s) % per))
         ) & ((1 << wr_bits) - 1)
    return (f >> (wr_bits - 1)) == 1, f & ((1 << (wr_bits - 1)) - 1)


def circuit_from_jax(circ):
    """The port's form of a bit-sliced circuit tuple ``(ops, outputs, nb,
    n_rand)`` compiled by the JAX package (`engine/bitslice.py`): the
    same tuple with plain ints and strings."""
    ops, outputs, nb, n_rand = circ
    return (tuple((str(k), int(a), int(b)) for k, a, b in ops),
            tuple(int(o) for o in outputs), int(nb), int(n_rand))


def plane_state_from_jax(state, device=None):
    """A :class:`PlaneState` on ``device`` (``cuda`` unless named) from
    one of the JAX package: kind ``"bits"`` (uint32 words, read as the
    int32 words of the same bits, in the reference's shape) or ``"fsm"``
    (int8 stacked planes [stride, B, E])."""
    device = config.get_device(device)

    def words(x):
        x = np.array(x)  # a writable copy
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.as_tensor(x, device=device)

    return PlaneState(words(state.pbp), words(state.dbp),
                      batch=int(state.batch), length=int(state.length),
                      kind=str(state.kind), nb=int(state.nb),
                      transpose=bool(state.transpose))


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


def _choose_sampling_dist(probs, tau: float):
    """Static per-node sampling distribution q ∝ p^tau (on the support of
    p) and per-branch importance increments log p − log q.

    ``tau = 1`` gives q = p EXACTLY (no renormalisation) and increments
    that are identically zero, so the walk is the tau-free one bit for
    bit; ``tau -> 0`` explores every branch of nonzero probability
    uniformly. The weighted frontier samples its chooses from q and
    carries the increments in its log-weights.
    """
    p = np.asarray(probs, dtype=np.float64)
    if tau == 1.0:
        return p, np.zeros_like(p)
    q = np.where(p > 0, np.power(np.maximum(p, 1e-300), tau), 0.0)
    q = q / q.sum()
    delta = np.where(
        p > 0,
        np.log(np.maximum(p, 1e-300)) - np.log(np.maximum(q, 1e-300)),
        0.0,
    )
    return q, delta


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
    deltas: tuple   # per-branch importance increments, float32 values


@functools.lru_cache(maxsize=None)
def _choose_plan(dm: DeviceMachine, tau: float = 1.0):
    """Per level, the :class:`_ChooseGroup` list in walk order, for
    chooses sampled from q ∝ p^tau (`_choose_sampling_dist`)."""
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
            q, delta = _choose_sampling_dist(probs, tau)
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
                tuple(widths), f32_div,
                tuple(float(np.float32(d)) for d in delta)))
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


def _walk_plain(dm: DeviceMachine, cells, uniforms, *, tau: float = 1.0,
                want_logp: bool = False):
    """Level-synchronous FSM walk over per-cell planes -> write spec
    (int32). The plain counterpart of the reference's
    `_machine_specs_planes_leveled`: chooses sampled from q ∝ p^tau, and
    with ``want_logp`` also the float32 importance increment of each
    site's path, summed level by level in float32 as the reference does
    (returns ``(spec, logp)``)."""
    S = dm.num_specs
    shape = cells[0].shape
    device = cells[0].device
    state = torch.full(shape, S, dtype=torch.int32, device=device)
    u = None if uniforms is None else uniforms.to(torch.float64)
    logp = (torch.zeros(shape, dtype=torch.float32, device=device)
            if want_logp else None)
    for lv, groups in zip(_level_plan(dm), _choose_plan(dm, tau)):
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
            dsel = (torch.full(shape, g.deltas[0], dtype=torch.float32,
                               device=device) if want_logp else None)
            for j in range(1, len(g.widths)):
                sel = u >= g.cum[j - 1]
                bb = torch.where(sel, j, bb)
                lo_ = torch.where(sel, g.cum[j - 1], lo_)
                width = torch.where(sel, g.widths[j], width)
                if want_logp:
                    dsel = torch.where(sel, g.deltas[j], dsel)
            b = torch.where(mask, bb, b)
            if want_logp:
                logp = torch.where(mask, logp + dsel, logp)
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
    return (state, logp) if want_logp else state


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
    """Plane-resident ensemble state of kind ``"fsm"`` (stacked int8
    symbol planes ``pbp``, ``dbp``, each [stride, B, E], for K1) or
    ``"bits"`` (the bit-sliced round's int32 words, each [stride, nb,
    B//32, E], or with ``transpose`` [stride, nb,
    *bitslice.transposed_word_shape(E, B//32)], for K14).

    `run_ensemble(..., keep_planes=True)` returns one and accepts one in
    place of the ``(ptape, dtape)`` pair, so snapshot-style callers skip
    the per-call tape<->plane conversion. A state passed in is left as
    it was: the run advances a copy. A state pins the path it was packed
    for.
    """

    def __init__(self, pbp, dbp, *, batch, length, kind="fsm", nb=0,
                 transpose=False):
        if kind not in ("fsm", "bits"):
            raise ValueError(f"unknown PlaneState kind {kind!r}")
        self.kind = kind
        self.pbp = pbp
        self.dbp = dbp
        self.nb = nb
        self.transpose = transpose
        self.batch = batch
        self.length = length

    @property
    def stride(self):
        return self.pbp.shape[0]

    def tapes(self):
        """Decodes back to (ptape, dtape) int32 [B, L] tensors (kind
        ``"bits"`` through K15)."""
        if self.kind == "bits":
            from . import bitslice as bs

            return (bs.bitplanes_to_tapes(self.pbp, transpose=self.transpose),
                    bs.bitplanes_to_tapes(self.dbp, transpose=self.transpose))
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


# --- Device tables and the rolled lattice rounds (K10, K11) -------------------
#
# The rolled rounds fire E sites a member at columns
# (shift + e*stride) mod L, e in [0, E), at any shift in [0, L): one
# shift shared by the batch, or one a member (independent sites). Site
# e's window cell j on a tape with read offset lo sits at column
# (shift + lo + e*stride + j) mod L. The reference rolls each tape so
# that these cells land at fixed columns (`_roll_cols`, `_roll_rows`);
# K10 and K11 index them in place instead.


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceTable:
    """A :class:`TransitionTable` on a device (:func:`device_table`)."""

    size_a: int
    p_lo: int
    d_lo: int
    p_offs: torch.Tensor     # [n_p] int32 window offsets
    d_offs: torch.Tensor     # [n_d]
    pv: torch.Tensor         # [n_cells] int32 radix place values
    out_cum: torch.Tensor    # [rows, M] float64 (or float32)
    out_world: torch.Tensor  # [rows, M] int32
    wr_mask: torch.Tensor    # [W, n_cells] bool
    wr_val: torch.Tensor     # [W, n_cells] int32
    span: int

    @property
    def n_p(self) -> int:
        return self.p_offs.shape[0]

    @property
    def n_d(self) -> int:
        return self.d_offs.shape[0]

    @property
    def n_cells(self) -> int:
        return self.n_p + self.n_d

    @property
    def num_rows(self) -> int:
        return self.out_cum.shape[0]


def _float_dtype(dtype) -> torch.dtype:
    """torch.float32 or torch.float64 from a torch, numpy or JAX float
    type (or its name)."""
    if isinstance(dtype, torch.dtype):
        found = dtype
    else:
        found = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
    if found not in (torch.float32, torch.float64):
        raise TypeError(f"table dtype must be float32 or float64, not "
                        f"{dtype!r}")
    return found


def device_table(table: TransitionTable, dtype=None, *,
                 device=None) -> DeviceTable:
    """Moves a transition table to ``device`` (``cuda`` unless named).

    ``dtype`` sets the precision of the cumulative probabilities, and so
    of the uniforms a run draws for them: float64 by default, float32
    when asked (outcome probabilities below ~1e-7 then lose resolution).
    """
    device = config.get_device(device)
    pv = table.size_a ** np.arange(table.n_cells - 1, -1, -1)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return DeviceTable(
        size_a=table.size_a, p_lo=table.p_lo, d_lo=table.d_lo,
        p_offs=i32(np.arange(table.p_lo, table.p_hi + 1)),
        d_offs=i32(np.arange(table.d_lo, table.d_hi + 1)),
        pv=i32(pv),
        out_cum=torch.as_tensor(np.asarray(table.out_cum), device=device,
                                dtype=(torch.float64 if dtype is None
                                       else _float_dtype(dtype))),
        out_world=i32(table.out_world),
        wr_mask=torch.as_tensor(np.asarray(table.wr_mask, bool),
                                device=device),
        wr_val=i32(table.wr_val),
        span=table.span)


def _site_cols(L: int, E: int, lo: int, n: int, shift):
    """Columns (shift + lo + e*stride + j) mod L, int64 [S, E, n], of
    window cells j of sites e at each of the S shifts (S = 1 for a shared
    shift, B for one a member)."""
    dev = shift.device
    base = (shift.to(torch.int64)[:, None] + lo
            + torch.arange(E, device=dev) * (L // E))
    return torch.remainder(base[..., None] + torch.arange(n, device=dev), L)


def _gather_cells(tape, cols):
    """tape[b, cols[b or 0, e, j]] as [B, E, n]."""
    B = tape.shape[0]
    cols = cols.expand(B, -1, -1)
    return tape.gather(1, cols.reshape(B, -1)).reshape(cols.shape)


def _scatter_cells(tape, cols, vals):
    """tape[b, cols[b or 0, e, j]] = vals[b, e, j], in place."""
    B = tape.shape[0]
    tape.scatter_(1, cols.expand(B, -1, -1).reshape(B, -1),
                  vals.reshape(B, -1).to(tape.dtype))


def _shift_tensor(shift, device):
    """A shared shift (int) or per-member shifts as a 1-D tensor."""
    return torch.as_tensor(shift, device=device).reshape(-1)


def table_rows(dt: DeviceTable, cells):
    """Table row of each window (cells int32 [..., n_cells]) by the
    reference's rule: the int32 radix sum sum_j cells[j] * pv[j], which
    wraps, then the gather's index rule (a negative row plus the row
    count, then clamped into [0, rows))."""
    terms = (cells.to(torch.int64) * dt.pv.to(torch.int64)) & 0xFFFFFFFF
    rank = terms.sum(-1) & 0xFFFFFFFF
    rank = torch.where(rank >= 2**31, rank - 2**32, rank)
    n = dt.num_rows
    return torch.where(rank < 0, rank + n, rank).clamp(0, n - 1)


def _table_specs(dt: DeviceTable, cells, uniforms):
    """The write spec of each window: the slot count k = #(u > cum[row])
    capped at M - 1, and out_world[row, k]."""
    rows = table_rows(dt, cells)
    cum = dt.out_cum[rows]
    k = (uniforms[..., None] > cum).sum(-1).clamp(max=cum.shape[-1] - 1)
    return dt.out_world[rows, k].to(torch.int64)


def table_round_plain(dt: DeviceTable, ptape, dtape, shift, uniforms):
    """K10's plain version: one transition-table round on int32 [B, L]
    tapes at ``shift`` (an int, or a [1] or [B] tensor), in place;
    ``uniforms`` [B, E] of the table's dtype."""
    table_round_plain.calls += 1
    B, L = ptape.shape
    E = uniforms.shape[1]
    shift = _shift_tensor(shift, ptape.device)
    cp = _site_cols(L, E, dt.p_lo, dt.n_p, shift)
    cd = _site_cols(L, E, dt.d_lo, dt.n_d, shift)
    cells = torch.cat([_gather_cells(ptape, cp), _gather_cells(dtape, cd)],
                      dim=-1)
    spec = _table_specs(dt, cells, uniforms)
    new = torch.where(dt.wr_mask[spec], dt.wr_val[spec], cells)
    _scatter_cells(ptape, cp, new[..., :dt.n_p])
    _scatter_cells(dtape, cd, new[..., dt.n_p:])


table_round_plain.calls = 0


def _apply_events_plain(dt: DeviceTable, ptape, dtape, sites, uniforms):
    """The reference's scatter formulation of a round on ONE replica
    ([L] tapes, [E] sites and uniforms): events whose windows could
    overlap an earlier event's are dropped. Returns the new tapes and
    the number of events applied. For tests: the cross-check of the
    lattice round."""
    n = ptape.shape[0]
    p_idx = torch.remainder(sites[:, None].to(torch.int64)
                            + dt.p_offs.to(torch.int64), n)
    d_idx = torch.remainder(sites[:, None].to(torch.int64)
                            + dt.d_offs.to(torch.int64), n)
    cells_p, cells_d = ptape[p_idx], dtape[d_idx]
    cells = torch.cat([cells_p, cells_d], dim=1)
    spec = _table_specs(dt, cells, uniforms)
    mask, vals = dt.wr_mask[spec], dt.wr_val[spec]
    d = (sites[:, None] - sites[None, :]).abs()
    d = torch.minimum(d, n - d)
    apply = ~torch.tril(d <= 2 * dt.span, diagonal=-1).any(dim=1)
    n_p = dt.n_p
    delta_p = torch.where(mask[:, :n_p] & apply[:, None],
                          vals[:, :n_p] - cells_p, 0)
    delta_d = torch.where(mask[:, n_p:] & apply[:, None],
                          vals[:, n_p:] - cells_d, 0)
    ptape = ptape.clone().index_put_((p_idx,), delta_p, accumulate=True)
    dtape = dtape.clone().index_put_((d_idx,), delta_d, accumulate=True)
    return ptape, dtape, int(apply.sum())


def lattice_round_plain(dm: DeviceMachine, ptape, dtape, shift, events,
                        uniforms=None, *, tau: float = 1.0, lw=None):
    """K11's plain version: one FSM round on int8 [B, L] tapes at
    ``shift`` (an int, or a [1] or [B] tensor), ``events`` sites a
    member, in place; ``uniforms`` [B, E] float32 (read only by machines
    with choose nodes). The walk and writes are K1's plain ones.

    A tempered round (the weighted frontier's, `tempered_round`) samples
    the chooses from q ∝ p^tau and, given ``lw`` (float64 [B]), adds to
    it in place each member's importance increment: the sites' float32
    increments summed in float32 in site order, as the reference sums
    them over its site axis.

    Returns what the thermodynamic sums read (`ops/thermo.py`): the
    sites' cells before the writes and after them, [B, E, n_cells] in the
    tapes' dtype, and the fired specs [B, E]."""
    lattice_round_plain.calls += 1
    B, L = ptape.shape
    shift = _shift_tensor(shift, ptape.device)
    cp = _site_cols(L, events, dm.p_lo, dm.n_p, shift)
    cd = _site_cols(L, events, dm.d_lo, dm.n_d, shift)
    cells = torch.cat([_gather_cells(ptape, cp), _gather_cells(dtape, cd)],
                      dim=-1)
    planes = [cells[..., c] for c in range(dm.n_cells)]
    u = uniforms if dm.has_choose else None
    if lw is not None and dm.has_choose:
        spec, logp = _walk_plain(dm, planes, u, tau=tau, want_logp=True)
        s = torch.zeros(B, dtype=torch.float32, device=ptape.device)
        for e in range(events):
            s = s + logp[:, e]
        lw += s.to(torch.float64)
    else:
        spec = _walk_plain(dm, planes, u, tau=tau)
    new = torch.stack(_writes_plain(dm, spec, planes), dim=-1)
    _scatter_cells(ptape, cp, new[..., :dm.n_p])
    _scatter_cells(dtape, cd, new[..., dm.n_p:])
    return cells, new, spec


lattice_round_plain.calls = 0


def _roll_cols_plain(x, shift: int):
    """The reference's `_roll_cols`: out[:, i] = x[:, (i + shift) mod L]."""
    return torch.roll(x, -(shift % x.shape[1]), dims=1)


def _roll_rows_plain(tape, shifts):
    """The reference's `_roll_rows`: out[b, i] = tape[b, (i + shifts[b])
    mod L]."""
    L = tape.shape[1]
    idx = torch.remainder(torch.arange(L, device=tape.device)[None, :]
                          + shifts.to(torch.int64)[:, None], L)
    return tape.gather(1, idx)


def rolled_round_plain(rule, ptape, dtape, shift: int, events,
                       uniforms=None):
    """The reference's rolled round as it is written
    (`_apply_lattice_round` for a table, `_apply_lattice_round_fsm` for
    a machine): roll each tape by shift + lo, reshape to [B, E, stride],
    resolve the first cells of each block, write them, roll back.
    Returns new tapes. For tests: the literal twin of K10's and K11's
    plain versions."""
    B, L = ptape.shape
    stride = L // events
    rp = _roll_cols_plain(ptape, shift + rule.p_lo).reshape(B, events, stride)
    rd = _roll_cols_plain(dtape, shift + rule.d_lo).reshape(B, events, stride)
    n_p, n_d = rule.n_p, rule.n_d
    cells = torch.cat([rp[:, :, :n_p], rd[:, :, :n_d]], dim=-1)
    if isinstance(rule, DeviceTable):
        spec = _table_specs(rule, cells, uniforms)
        new = torch.where(rule.wr_mask[spec], rule.wr_val[spec], cells)
    else:
        planes = [cells[..., c] for c in range(rule.n_cells)]
        spec = _walk_plain(rule, planes,
                           uniforms if rule.has_choose else None)
        new = torch.stack(_writes_plain(rule, spec, planes), dim=-1)
    rp = rp.clone()
    rd = rd.clone()
    rp[:, :, :n_p] = new[..., :n_p]
    rd[:, :, :n_d] = new[..., n_p:]
    return (_roll_cols_plain(rp.reshape(B, L), -(shift + rule.p_lo)),
            _roll_cols_plain(rd.reshape(B, L), -(shift + rule.d_lo)))


def independent_rounds_rolled_plain(rule, ptape, dtape, shifts, events,
                                    uniforms=None):
    """The reference's independent-sites loop as it is written
    (`run_ensemble`, JAX `engine/ensemble.py:1491-1523`): each member is
    kept rolled by its phase, rolled by the change of phase each round
    (``shifts`` [n, B]), stepped by the rolled round at shift 0, and
    unrolled once at the end. Returns new tapes. For tests: the literal
    twin of K10 and K11 at per-member shifts."""
    B = ptape.shape[0]
    L = ptape.shape[1]
    phase = torch.zeros(B, dtype=torch.int64, device=ptape.device)
    for j in range(shifts.shape[0]):
        s = shifts[j].to(torch.int64)
        delta = torch.remainder(s - phase, L)
        ptape = _roll_rows_plain(ptape, delta)
        dtape = _roll_rows_plain(dtape, delta)
        ptape, dtape = rolled_round_plain(
            rule, ptape, dtape, 0, events,
            None if uniforms is None else uniforms[j])
        phase = s
    return _roll_rows_plain(ptape, -phase), _roll_rows_plain(dtape, -phase)


def _reads_uniforms(rule) -> bool:
    return isinstance(rule, DeviceTable) or rule.has_choose


def _uniform_dtype(rule) -> torch.dtype:
    return (rule.out_cum.dtype if isinstance(rule, DeviceTable)
            else torch.float32)


def _check_lattice(rule, ptape, dtape, shifts, k0, n, events, uniforms):
    """Checks tapes, shifts ([rounds] shared or [rounds, B] a member) and
    the uniforms of rounds [k0, k0+n) (``uniforms`` [n, B, E]) of a
    rolled run."""
    is_table = isinstance(rule, DeviceTable)
    want = torch.int32 if is_table else torch.int8
    if ptape.dtype != want or dtape.dtype != want:
        raise TypeError(f"{'table' if is_table else 'machine'} rounds take "
                        f"{want} tapes, got {ptape.dtype} and {dtape.dtype}")
    if ptape.dim() != 2 or ptape.shape != dtape.shape:
        raise ValueError(f"tapes must be two equal [B, L] tensors, got "
                         f"{tuple(ptape.shape)} and {tuple(dtape.shape)}")
    if not (ptape.is_contiguous() and dtape.is_contiguous()):
        raise ValueError("tapes must be contiguous")
    B, L = ptape.shape
    _check_round_geometry(L, events, rule.span)
    if shifts.dtype != torch.int32 or shifts.dim() not in (1, 2) or (
            shifts.dim() == 2 and shifts.shape[1] != B):
        raise TypeError("shifts must be int32 [rounds] (shared) or "
                        f"[rounds, {B}] (one a member)")
    if not shifts.is_contiguous():
        raise ValueError("shifts must be contiguous")
    if not (0 <= k0 and k0 + n <= shifts.shape[0]):
        raise IndexError(f"rounds [{k0}, {k0 + n}) outside "
                         f"shifts[0:{shifts.shape[0]}]")
    dev = ptape.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rolled rounds run on cuda or cpu tensors, not "
                         f"{dev}")
    named = [("dtape", dtape), ("shifts", shifts)]
    if is_table:
        named.append(("table", rule.out_cum))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, tapes on {dev}")
    if _reads_uniforms(rule):
        dt_u = _uniform_dtype(rule)
        if (uniforms is None or uniforms.dtype != dt_u
                or tuple(uniforms.shape) != (n, B, events)
                or not uniforms.is_contiguous()):
            raise ValueError(f"uniforms must be a contiguous {dt_u} "
                             f"[{n}, {B}, {events}] tensor")
        if uniforms.device != dev:
            raise ValueError(f"uniforms on {uniforms.device}, tapes on {dev}")
    if ptape.numel() >= 2**31:
        raise ValueError("rolled rounds take tapes of fewer than 2**31 "
                         "symbols")
    if is_table and rule.n_cells > _K10_MAX_CELLS:
        raise ValueError(f"K10 takes tables of at most {_K10_MAX_CELLS} "
                         f"window cells, not {rule.n_cells}")


_K10_MAX_CELLS = 24  # csrc/table_rule.cuh: K10_MAX_CELLS

# Shared memory on the H100: the most a block may have, and the most each
# of two blocks an SM may have (228 KB an SM, 1 KB of it kept a block).
SMEM_BLOCK, SMEM_PAIR = 232_448, 115_712
_SMS = 132  # the H100's streaming multiprocessors


# Calls of fewer rounds than this take K11's kernel of one launch a round:
# loading and storing whole rows costs about what three rounds do at the
# full width (on an H100, B=16384, L=4096, E=256: a one-round resident
# call 153 µs, against 64 µs a round of that kernel and 42 µs a
# resident round).
K11_RESIDENT_MIN_ROUNDS = 4


def k11_tile(B: int, L: int, events: int, pattern_len: int | None = None):
    """K11's resident tile for a call at [B, L] with ``events`` sites a
    member (`csrc/lattice_round.cuh`), for first passage when
    ``pattern_len`` is given: (members a block, threads a block, bytes of
    shared memory), or None where one member's rows do not fit a block
    (2L past 227 KB), which takes the kernel of one launch a round.

    A member holds both rows (each L rounded up to 4 bytes, then to 4
    more than a multiple of 128: `csrc/lattice_round.cuh:k11_row_stride`),
    and for first passage its hit time and a flag (12 bytes); the
    pattern is stored once. The tile is as many members as two blocks an SM leave
    room for (one block's worth where a member needs more), and no more
    than spreads B over two blocks for each of the card's SMs; 512
    threads where a round has 1,024 sites or more, else 256."""
    Ls = -(-L // 4) * 4
    Ls += (132 - Ls % 128) % 128
    fp = pattern_len is not None
    per = 2 * Ls + (12 if fp else 0)
    fixed = 4 * pattern_len if fp else 0
    if per + fixed > SMEM_BLOCK:
        return None
    cap = (SMEM_PAIR - fixed) // per
    if cap < 1:
        cap = (SMEM_BLOCK - fixed) // per
    tile = max(1, min(cap, -(-B // (2 * _SMS))))
    threads = 512 if tile * events >= 1024 else 256
    return tile, threads, tile * per + fixed


def k10_row_words(L: int) -> int:
    """int32 words of a row resident in K10's shared memory: column c at
    c + c // 32, a word of padding after every 32 columns
    (`csrc/table_resident.cuh:k10_row_words`)."""
    return L + (L + 31) // 32


def k10_tile(B: int, L: int, events: int):
    """K10's resident tile for a call at [B, L] with ``events`` sites a
    member (`csrc/table_resident.cuh`): (members a block, threads a
    block, bytes of shared memory), or None where one member's rows do
    not fit a block (8 bytes a word of `k10_row_words`, past 227 KB: L
    above about 28,000), which takes the kernel of one launch a round.

    A member holds both int32 rows. The tile is as many members as two
    blocks an SM leave room for (one block's worth where a member needs
    more), and no more than spreads B over two blocks for each of the
    card's SMs: at B=16384, L=4096 three members a block (two measure
    the same; six at one block an SM measured slower). The threads (at
    most 512, two blocks an SM) take the tile's sites in as few passes
    as they allow, evenly, rounded up to a warp: at that width 384
    threads of two sites each, which a thread takes together
    (`k10_tile_sites`); 768 threads of one site measured slower."""
    per = 8 * k10_row_words(L)
    if per > SMEM_BLOCK:
        return None
    cap = SMEM_PAIR // per or SMEM_BLOCK // per
    tile = max(1, min(cap, -(-B // (2 * _SMS))))
    items = tile * events
    passes = -(-items // 512)
    threads = -(-(-(-items // passes)) // 32) * 32
    return tile, threads, tile * per


def k11_odd_stride(L: int) -> int:
    """Bytes a row in the resident tempered rounds and K24's: an odd
    count of 4-byte words (`csrc/lattice_round.cuh:k11_odd_stride`), so
    that one column of 32 neighbouring members lies in 32 banks."""
    return 4 * ((-(-L // 4)) | 1)


def k11_tempered_tile(B: int, L: int):
    """The resident tile of K11's tempered entry for a call at [B, L]
    (`csrc/lattice_round.cuh:k11t_tile_rounds`): (members a block, threads
    a block, bytes of shared memory), or None where one member's rows do
    not fit a block, which takes the launch a round.

    A thread walks a member for every round of the call and keeps its
    log-weight in a register, so a member costs shared memory only for
    both rows (`k11_odd_stride`). The tile is as many members as two
    blocks an SM leave room for (one block's worth where a member needs
    more), at most 512 (a thread a member, two blocks an SM), and no more
    than spreads B over two blocks for each of the card's SMs; the
    threads are the tile rounded up to a warp."""
    per = 2 * k11_odd_stride(L)
    if per > SMEM_BLOCK:
        return None
    cap = SMEM_PAIR // per or SMEM_BLOCK // per
    tile = max(1, min(cap, 512, -(-B // (2 * _SMS))))
    return tile, -(-tile // 32) * 32, tile * per


def _lattice_rounds(rule, ptape, dtape, shifts, k0, n, events, uniforms):
    """Rounds [k0, k0+n) of a rolled run, checked by the caller: the
    plain version a round on the CPU; on the card one C call that
    launches K10 (a table) or K11 (a machine) once for all n rounds on
    members held in shared memory (`k10_tile`, `k11_tile`; once a round
    where the rows are too long for it or n is below
    `K11_RESIDENT_MIN_ROUNDS`)."""
    per_member = shifts.dim() == 2
    if ptape.device.type == "cpu":
        plain = (table_round_plain if isinstance(rule, DeviceTable)
                 else lattice_round_plain)
        for j in range(n):
            u = None if uniforms is None else uniforms[j]
            if isinstance(rule, DeviceTable):
                plain(rule, ptape, dtape, shifts[k0 + j], u)
            else:
                plain(rule, ptape, dtape, shifts[k0 + j], events, u)
        return
    B, L = ptape.shape
    u_ptr = None if uniforms is None else uniforms.data_ptr()
    with torch.cuda.device(ptape.device):
        stream = cuda.stream(ptape)
        if isinstance(rule, DeviceTable):
            lib = cuda.load()
            tile = (k10_tile(B, L, events) if n >= K11_RESIDENT_MIN_ROUNDS
                    else None)
            rc = lib.ckpe_table_rounds(
                ptape.data_ptr(), dtape.data_ptr(), u_ptr,
                int(rule.out_cum.dtype == torch.float64), shifts.data_ptr(),
                int(per_member), int(k0), int(n), int(B), int(L),
                int(events), int(rule.p_lo), int(rule.n_p), int(rule.d_lo),
                int(rule.n_d), rule.pv.data_ptr(), rule.out_cum.data_ptr(),
                rule.out_world.data_ptr(), int(rule.num_rows),
                int(rule.out_cum.shape[1]), rule.wr_mask.data_ptr(),
                rule.wr_val.data_ptr(), *(tile[:2] if tile else (0, 0)),
                stream)
            cuda.check(rc, "table_round", lib)
            table_round.launches += 1 if tile else n
        else:
            from .k1_source import k1_library  # k1_source imports this

            lib = k1_library(rule)
            tile = (k11_tile(B, L, events) if n >= K11_RESIDENT_MIN_ROUNDS
                    else None)
            rc = lib.ckpe_k11_rounds(ptape.data_ptr(), dtape.data_ptr(),
                                     u_ptr, shifts.data_ptr(),
                                     int(per_member), int(k0), int(n),
                                     int(B), int(L), int(events),
                                     *(tile[:2] if tile else (0, 0)), stream)
            cuda.check(rc, "lattice_round", lib)
            lattice_round.launches += 1 if tile else n


def _one_round(rule, ptape, dtape, shift, events, uniforms):
    shifts = _shift_tensor(shift, ptape.device).to(torch.int32)
    if shifts.numel() > 1:
        shifts = shifts[None]
    shifts = shifts.contiguous()
    if uniforms is not None:
        uniforms = uniforms[None]
    _check_lattice(rule, ptape, dtape, shifts, 0, 1, events, uniforms)
    _lattice_rounds(rule, ptape, dtape, shifts, 0, 1, events, uniforms)


def table_round(dt: DeviceTable, ptape, dtape, shift, uniforms):
    """One transition-table round on int32 [B, L] tapes, in place (K10):
    ``shift`` an int or a [1] or [B] int32 tensor on the tapes' device,
    ``uniforms`` [B, E] of the table's dtype. CPU tensors take
    :func:`table_round_plain`."""
    _one_round(dt, ptape, dtape, shift, uniforms.shape[1], uniforms)


table_round.launches = 0


def lattice_round(dm: DeviceMachine, ptape, dtape, shift, events,
                  uniforms=None):
    """One FSM round on int8 [B, L] tapes, in place (K11): ``shift`` an
    int or a [1] or [B] int32 tensor on the tapes' device, ``events``
    sites a member, ``uniforms`` [B, E] float32 (read only by machines
    with choose nodes). CPU tensors take :func:`lattice_round_plain`."""
    _one_round(dm, ptape, dtape, shift, events,
               uniforms if dm.has_choose else None)


lattice_round.launches = 0


def run_lattice_rounds(rule, ptape, dtape, shifts, events, uniforms=None):
    """Applies ``len(shifts)`` rolled rounds in place with explicit
    draws: ``shifts`` int32 [n] (one a round, shared by the batch) or
    [n, B] (one a member: independent sites), any values (taken mod L),
    on the tapes' device; ``uniforms`` [n, B, E] (the table's dtype for
    a :class:`DeviceTable`; float32 for a machine, read only when it has
    choose nodes). Tapes are int32 [B, L] for a table, int8 for a
    machine. Returns the tapes.

    This is `run_ensemble`'s rolled loop without the random draws, so a
    caller can feed it draws made elsewhere (the tests feed it the JAX
    package's own). On the card all rounds go out from one C call."""
    if not _reads_uniforms(rule):
        uniforms = None
    n = shifts.shape[0]
    _check_lattice(rule, ptape, dtape, shifts, 0, n, events, uniforms)
    _lattice_rounds(rule, ptape, dtape, shifts, 0, n, events, uniforms)
    return ptape, dtape


# Uniforms drawn ahead of the launches, at most this many a chunk.
_UNIFORM_CHUNK = 2**25
# The same for the callers of the resident tempered rounds, K23's and
# K24's (`frontier._blocked_rounds`, `ops/thermo.py`'s sigma and ledger
# runs): a chunk is one C call, whose rows cross between global and
# shared memory once, so longer calls spread that cost over more rounds
# (67 rounds at K=10^6, E=4, 64 at B=16384, E=256: 1 GiB of float32
# uniforms). The draws are the same whatever the chunk: a round's
# uniforms at a time, in order.
_RESIDENT_CHUNK = 2**28
# The same for `run_ensemble` with a table (K10's resident rounds), whose
# uniforms are the table's float64 by default: 32 rounds at B=16384,
# E=256, 1 GiB.
_TABLE_CHUNK = 2**27


def _chunks(num_steps, shape, dtype, device, draw, limit=_UNIFORM_CHUNK):
    """Yields (k0, n, draws) chunks of a run: ``draw(out)`` fills one
    round's ``shape`` of ``dtype``, round by round, into a buffer of at
    most ``limit`` values (at least one round). A ``shape`` of None draws
    nothing: one chunk of every round, its draws None."""
    if shape is None:
        if num_steps:
            yield 0, num_steps, None
        return
    chunk = max(1, min(num_steps, limit // max(1, math.prod(shape))))
    buf = torch.empty((chunk,) + tuple(shape), dtype=dtype, device=device)
    for k0 in range(0, num_steps, chunk):
        n = min(chunk, num_steps - k0)
        for j in range(n):
            draw(buf[j])
        yield k0, n, buf[:n]


def _draw_chunks(gen, rule, B, events, num_steps, device,
                 limit=_UNIFORM_CHUNK):
    """Chunks of a run's [B, E] uniforms (`_chunks`, at most ``limit``
    values a chunk; none for a rule that reads none)."""
    dtype = _uniform_dtype(rule)
    return _chunks(num_steps, (B, events) if _reads_uniforms(rule) else None,
                   dtype, device,
                   lambda out: torch.rand((B, events), generator=gen,
                                          device=device, dtype=dtype,
                                          out=out), limit)


def _draw_word_chunks(gen, n_rand, wshape, num_steps, device):
    """Chunks of a bit-sliced run's [n_rand, *wshape] random int32 words
    (`_chunks`; none for a circuit that reads none)."""
    from .bitslice import draw_rand_words

    shape = (n_rand,) + tuple(wshape)
    return _chunks(num_steps, shape if n_rand else None, torch.int32,
                   device, lambda out: draw_rand_words(gen, shape, device,
                                                       out=out))


def run_ensemble(generator, tapes, dm, steps_events, *,
                 independent_sites: bool = False,
                 bitslice: bool | None = None,
                 keep_planes: bool = False, device=None):
    """Advances a batch of tape pairs with stratified lattice rounds.

    Each round fires the rule at E sites per replica arranged as a
    randomly shifted lattice: no conflicts, every event applies. With a
    :class:`DeviceMachine` at a stride L/E of at most 64 and shared
    sites, the phase is drawn over [0, stride), which fires the same
    site set as a full-tape shift, and the tapes are stored as bit-plane
    words stepped by the bit-sliced round (K14 on K15's words,
    ``bitslice`` below) where the call is eligible, else as `stride`
    int8 planes stepped by K1 (:func:`plane_round`). Otherwise the rolled
    rounds run on [B, L] tapes with the shift drawn over [0, L): K10
    (:func:`table_round`, int32 tapes) for a :class:`DeviceTable`, K11
    (:func:`lattice_round`, int8 tapes) for a machine with
    ``independent_sites`` or a stride above 64.

    ``independent_sites=True`` draws the shift per member (each member
    its own site history) instead of one a round shared by the batch;
    per-member marginals are the same either way, cross-member
    statistics are not (the reference's docstring explains when it
    matters).

    Draws come from ``generator`` (a `torch.Generator` on the run's
    device, or an int seed): first all shifts at once ([num_steps], or
    [num_steps, B] for independent sites) as one int32 tensor on the
    device, then each round's [B, E] uniforms (float32 for a machine,
    the table's dtype for a table), round by round into a buffer of a
    chunk of rounds, which one call then runs. Machines without choose
    nodes read no uniforms, so none are drawn for them (the reference
    draws and discards them), and one call runs every round. The stream
    is not the JAX package's; :func:`run_rounds` and
    :func:`run_lattice_rounds` take explicit draws.

    The bit-sliced round (``bitslice``) draws the shifts as the plane
    path does, so a choose-free machine gives K1's tapes at the same
    seed. A sampling circuit then draws each round's [n_rand, *word
    shape] random int32 words (all 32 bits uniform) a chunk of rounds at
    a time, as the uniforms are drawn; its stream is another than the
    FSM path's, with the same law.
    `bitslice.run_bitsliced_rounds` takes explicit draws.

    Args:
      generator: `torch.Generator` on the run's device, or an int seed.
      tapes: (ptape [B, L], dtape [B, L]) integer tensors or arrays, or a
        :class:`PlaneState` from an earlier plane-path call.
      dm: compiled :class:`DeviceMachine` or :class:`DeviceTable`.
      steps_events: (num_steps, events_per_step). events_per_step must
        divide L; at E > 1 additionally L/E > 2·span (E = 1 needs only
        span <= L).
      independent_sites: one shift a member and round.
      bitslice: the bit-sliced round (K14 on K15's words,
        `bitslice.py`) where the call is eligible: a machine on the plane
        path (stride <= 64, shared sites), B % 32 == 0, and the machine
        choose-free and tabulable or sampleable. None (the default)
        takes it wherever eligible (on the CPU only for circuits of at
        most `bitslice.CPU_MAX_CIRCUIT_OPS` ops), as the reference does;
        True raises where the call is not eligible; False keeps K1.
      keep_planes: return a :class:`PlaneState` instead of tapes (the
        plane paths only: kind ``"bits"`` on the bit-sliced round,
        ``"fsm"`` on K1's).
      device: where the run goes; ``cuda`` unless named.

    Returns:
      ((ptape, dtape) int32 [B, L], or a PlaneState under keep_planes),
      (applied int64 [num_steps] summed over replicas,
       times float64 [num_steps] cumulative).
    """
    if not isinstance(dm, (DeviceMachine, DeviceTable)):
        raise TypeError(f"run_ensemble takes a DeviceMachine or a "
                        f"DeviceTable, not {type(dm).__name__}")
    num_steps, events = steps_events
    device = config.get_device(device)
    in_state = isinstance(tapes, PlaneState)
    if in_state:
        B, L = tapes.batch, tapes.length
    else:
        ptape, dtape = (torch.as_tensor(t, device=device) for t in tapes)
        B, L = ptape.shape
    _check_round_geometry(L, events, dm.span)
    stride = L // events
    use_planes = (isinstance(dm, DeviceMachine)
                  and stride <= _MAX_PLANE_STRIDE and not independent_sites)
    from . import bitslice as bs  # bitslice imports this module

    # The reference's selection, with the CPU's circuit limit on the CPU.
    eligible = (use_planes and B % 32 == 0
                and (bs.machine_is_bitsliceable(dm)
                     or bs.machine_is_sampleable(dm)))
    use_bitslice = bitslice is not False and eligible and (
        bitslice or bs.circuit_cpu_ok(dm, device))
    if bitslice and not use_bitslice:
        raise ValueError(
            "bitslice=True needs a plane-eligible machine "
            f"and B % 32 == 0 (got B={B}, "
            f"machine={getattr(dm, 'tag', dm)!r})")
    if in_state:
        if tapes.kind == "bits" and not use_bitslice:
            raise ValueError(
                "PlaneState packed for the bit-sliced round, but this "
                "call resolves to a different path (bitslice="
                f"{bitslice}, eligible={eligible})")
        if tapes.kind == "fsm":
            if not use_planes:
                raise ValueError(
                    "PlaneState packed for the FSM plane round needs a "
                    "plane-eligible call (machine, stride <= "
                    f"{_MAX_PLANE_STRIDE}, not independent_sites)")
            use_bitslice = False
        if tapes.stride != stride:
            raise ValueError(
                f"PlaneState stride {tapes.stride} != L//events = "
                f"{stride}: pack and continuation calls must use the "
                "same events_per_step")
    if (keep_planes or in_state) and not (use_planes or use_bitslice):
        raise ValueError(
            "keep_planes/PlaneState need a plane-path call (machine, "
            "stride <= 64, not independent_sites)")
    gen = config.make_generator(generator, device)
    if use_bitslice:
        circ = bs.machine_circuit(dm)
        nb, n_rand = circ[2], circ[3]
        # The larger of (events, packed members) goes minor, as the
        # reference chooses.
        transpose = events < B // 32
        if transpose:
            wshape = bs.transposed_word_shape(events, B // 32)
            site_axis = -len(wshape)
        else:
            wshape = (B // 32, events)
            site_axis = -1
        if in_state:
            if tapes.nb != nb or tapes.transpose != transpose:
                raise ValueError(
                    f"PlaneState layout (nb={tapes.nb}, transpose="
                    f"{tapes.transpose}) does not match this call "
                    f"(nb={nb}, transpose={transpose})")
            p_bp = tapes.pbp.to(device=device, copy=True)
            d_bp = tapes.dbp.to(device=device, copy=True)
        else:
            p_bp = bs.tapes_to_bitplanes(ptape, stride, nb,
                                         transpose=transpose)
            d_bp = bs.tapes_to_bitplanes(dtape, stride, nb,
                                         transpose=transpose)
        shifts = torch.randint(0, stride, (num_steps,), generator=gen,
                               device=device, dtype=torch.int32)
        checked = False
        for k0, n, words in _draw_word_chunks(gen, n_rand, wshape,
                                              num_steps, device):
            if not checked:
                bs._check_words(dm, circ, p_bp, d_bp, shifts, 0, n, words,
                                site_axis)
                checked = True
            bs._bitsliced_rounds(dm, circ, p_bp, d_bp, shifts, k0, n, words,
                                 site_axis)
        if keep_planes:
            out = PlaneState(p_bp, d_bp, batch=B, length=L, kind="bits",
                             nb=nb, transpose=transpose)
        else:
            out = (bs.bitplanes_to_tapes(p_bp, transpose=transpose),
                   bs.bitplanes_to_tapes(d_bp, transpose=transpose))
    elif use_planes:
        if in_state:
            p_st = tapes.pbp.to(device=device, copy=True)
            d_st = tapes.dbp.to(device=device, copy=True)
        else:
            p_st = _tape_to_planes(ptape.to(torch.int8), stride)
            d_st = _tape_to_planes(dtape.to(torch.int8), stride)
        shifts = torch.randint(0, stride, (num_steps,), generator=gen,
                               device=device, dtype=torch.int32)
        checked = False
        for k0, n, uniforms in _draw_chunks(gen, dm, B, events, num_steps,
                                            device):
            if not checked:
                _check_planes(dm, p_st, d_st, shifts, 0, n, uniforms)
                checked = True
            _rounds(dm, p_st, d_st, shifts, k0, n, uniforms)
        if keep_planes:
            out = PlaneState(p_st, d_st, batch=B, length=L)
        else:
            out = (_planes_to_tape(p_st).to(torch.int32),
                   _planes_to_tape(d_st).to(torch.int32))
    else:
        want = torch.int32 if isinstance(dm, DeviceTable) else torch.int8
        pt = ptape.to(want).contiguous()
        dt_ = dtape.to(want).contiguous()
        if pt.data_ptr() == ptape.data_ptr():
            pt = pt.clone()
        if dt_.data_ptr() == dtape.data_ptr():
            dt_ = dt_.clone()
        shape = (num_steps, B) if independent_sites else (num_steps,)
        shifts = torch.randint(0, L, shape, generator=gen, device=device,
                               dtype=torch.int32)
        checked = False
        limit = (_TABLE_CHUNK if isinstance(dm, DeviceTable)
                 else _UNIFORM_CHUNK)
        for k0, n, uniforms in _draw_chunks(gen, dm, B, events, num_steps,
                                            device, limit):
            if not checked:
                _check_lattice(dm, pt, dt_, shifts, 0, n, events, uniforms)
                checked = True
            _lattice_rounds(dm, pt, dt_, shifts, k0, n, events, uniforms)
        out = (pt.to(torch.int32), dt_.to(torch.int32))
    applied = torch.full((num_steps,), B * events, dtype=torch.int64,
                         device=device)
    f64 = config.DEFAULT_FLOAT
    # A Python float, not a tensor copied to the card: that copy would
    # make the host wait for every queued round before it queues the rest.
    dt_round = float(-torch.log1p(torch.tensor(-events / L, dtype=f64)))
    times = torch.arange(1, num_steps + 1, dtype=f64, device=device) * dt_round
    return out, (applied, times)


# --- K12: pattern scans and first passage -------------------------------------

_SCAN_CONTAINS, _SCAN_PROGRESS, _SCAN_FIRST_PASSAGE = 0, 1, 2


def _pattern_tensor(pattern, device):
    return torch.as_tensor([int(s) for s in pattern], dtype=torch.int32,
                           device=device)


def pattern_scan_plain(tape, pattern, mode: int, *, t_hit=None, t_now=None):
    """K12's plain version, as the reference computes `contains_pattern`
    and `pattern_progress` (rolls of the [B, L] ``tape``, int8 or int32,
    compared with each symbol of ``pattern``, an int32 [P] tensor).

    mode 0 returns bool [B], whether the pattern occurs anywhere on the
    ring (cyclically); mode 1 returns int32 [B], the longest prefix of
    it that occurs; mode 2 sets ``t_hit`` (float64 [B], in place) to
    ``t_now`` (a float64 [1] tensor) where the pattern occurs and
    ``t_hit`` is still infinite, and returns it."""
    pattern_scan_plain.calls += 1
    B = tape.shape[0]
    ok = torch.ones(tape.shape, dtype=torch.bool, device=tape.device)
    best = torch.zeros(B, dtype=torch.int32, device=tape.device)
    pat = [int(s) for s in pattern.tolist()]
    for j, s in enumerate(pat):
        ok = ok & (torch.roll(tape, -j, dims=1) == s)
        best = torch.maximum(best, torch.where(
            ok.any(dim=1), j + 1, 0).to(torch.int32))
    if mode == _SCAN_PROGRESS:
        return best
    present = best == len(pat)
    if mode == _SCAN_CONTAINS:
        return present
    t_hit.copy_(torch.where(present & torch.isinf(t_hit), t_now, t_hit))
    return t_hit


pattern_scan_plain.calls = 0


def k12_members(L: int, elem: int, pattern_len: int) -> int:
    """K12's members a block (`csrc/pattern_scan.cu`: a warp a member,
    each staging its row of L symbols of ``elem`` bytes and the
    ``pattern_len`` - 1 wrap cells in shared memory): up to 8, as many as
    two blocks an SM leave room for (one block's worth where a row needs
    more), or 0 where one staged row does not fit a block, which takes
    the kernel of a block a member reading the row where it lies."""
    cells = L + max(pattern_len - 1, 0)
    row = -(-cells * elem // 16) * 16
    fixed = -(-4 * pattern_len // 16) * 16
    for budget in (SMEM_PAIR, SMEM_BLOCK):
        if (budget - fixed) // row >= 1:
            return min(8, (budget - fixed) // row)
    return 0


def _check_scan(tape, pattern, mode, t_hit, t_now):
    if tape.dtype not in (torch.int8, torch.int32) or tape.dim() != 2:
        raise TypeError("tape must be an int8 or int32 [B, L] tensor")
    if not tape.is_contiguous():
        raise ValueError("tape must be contiguous")
    if pattern.dtype != torch.int32 or pattern.dim() != 1:
        raise TypeError("pattern must be an int32 [P] tensor")
    named = [("pattern", pattern)]
    if mode == _SCAN_FIRST_PASSAGE:
        if (t_hit is None or t_hit.dtype != torch.float64
                or tuple(t_hit.shape) != (tape.shape[0],)
                or t_now is None or t_now.dtype != torch.float64):
            raise ValueError("first passage takes t_hit float64 [B] and "
                             "t_now float64 [1]")
        named += [("t_hit", t_hit), ("t_now", t_now)]
    for name, t in named:
        if t.device != tape.device:
            raise ValueError(f"{name} is on {t.device}, tape on "
                             f"{tape.device}")
    if tape.numel() >= 2**31:
        raise ValueError("K12 takes tapes of fewer than 2**31 symbols")


def pattern_scan(tape, pattern, mode: int, *, t_hit=None, t_now=None):
    """K12 on a CUDA ``tape``, the plain version
    (:func:`pattern_scan_plain`, which says what each mode returns) on a
    CPU one. ``pattern`` is an int32 [P] tensor on the tape's device."""
    _check_scan(tape, pattern, mode, t_hit, t_now)
    if not cuda.on_card(tape, "K12"):
        return pattern_scan_plain(tape, pattern, mode, t_hit=t_hit,
                                  t_now=t_now)
    B, L = tape.shape
    if mode == _SCAN_CONTAINS:
        out = torch.empty(B, dtype=torch.bool, device=tape.device)
    elif mode == _SCAN_PROGRESS:
        out = torch.empty(B, dtype=torch.int32, device=tape.device)
    else:
        out = t_hit
    lib = cuda.load()
    with torch.cuda.device(tape.device):
        rc = lib.ckpe_pattern_scan(
            tape.data_ptr(), tape.element_size(), int(B), int(L),
            pattern.data_ptr(), int(pattern.numel()), int(mode),
            None if mode == _SCAN_FIRST_PASSAGE else out.data_ptr(),
            None if t_hit is None else t_hit.data_ptr(),
            None if t_now is None else t_now.data_ptr(),
            k12_members(L, tape.element_size(), pattern.numel()),
            cuda.stream(tape))
    cuda.check(rc, "pattern_scan", lib)
    pattern_scan.launches += 1
    return out


pattern_scan.launches = 0


def _scan_input(tape, device):
    tape = torch.as_tensor(tape, device=config.get_device(device))
    if tape.dtype not in (torch.int8, torch.int32):
        tape = tape.to(torch.int32)
    return tape.contiguous()


def contains_pattern(tape, pattern, *, device=None):
    """[B] bool: does ``pattern`` occur anywhere on each ring tape
    ([B, L], int8 or int32; other integer types are read as int32)?
    K12 on ``device`` (``cuda`` unless named)."""
    tape = _scan_input(tape, device)
    return pattern_scan(tape, _pattern_tensor(pattern, tape.device),
                        _SCAN_CONTAINS)


def pattern_progress(tape, pattern, *, device=None):
    """[B] int32: the longest prefix of ``pattern`` that occurs anywhere
    on each ring (cyclically); ``len(pattern)`` means the whole pattern
    is present. K12 on ``device`` (``cuda`` unless named)."""
    tape = _scan_input(tape, device)
    return pattern_scan(tape, _pattern_tensor(pattern, tape.device),
                        _SCAN_PROGRESS)


def _first_passage_rounds(dm, pt, dt_, pat, shifts, k0, n, events,
                          uniforms, times, t_hit, data_tape):
    """Rounds [k0, k0+n) of a first-passage run, checked by the caller:
    each a K11 round at ``shifts[k]`` and K12's update of ``t_hit`` at
    ``times[k + 1]``. On the card one K11 launch runs them all, K12's
    update applied to the members held in shared memory (`k11_tile`);
    where the rows are too long for that, one C call launches K11 and
    K12 a round each."""
    watch = dt_ if data_tape else pt
    if pt.device.type == "cpu":
        for j in range(n):
            lattice_round_plain(dm, pt, dt_, shifts[k0 + j], events,
                                None if uniforms is None else uniforms[j])
            pattern_scan_plain(watch, pat, _SCAN_FIRST_PASSAGE, t_hit=t_hit,
                               t_now=times[k0 + j + 1:k0 + j + 2])
        return
    from .k1_source import k1_library  # k1_source imports this module

    lib = k1_library(dm)
    B, L = pt.shape
    tile = k11_tile(B, L, events, pat.numel())
    scan_fn = None
    if tile is None:
        scan_fn = ctypes.cast(cuda.load().ckpe_pattern_scan,
                              ctypes.c_void_p).value
    with torch.cuda.device(pt.device):
        rc = lib.ckpe_k11_first_passage(
            pt.data_ptr(), dt_.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            shifts.data_ptr(), int(k0), int(n), int(B), int(L), int(events),
            int(bool(data_tape)), pat.data_ptr(), int(pat.numel()),
            t_hit.data_ptr(), times.data_ptr(), scan_fn,
            *(tile[:2] if tile else (0, 0)), cuda.stream(pt))
    cuda.check(rc, "first_passage (K11, K12)", lib)
    if tile:
        lattice_round.launches += 1
    else:
        lattice_round.launches += n
        pattern_scan.launches += n


def _first_passage(dm, pt, dt_, pattern, shifts, chunks, events, data_tape):
    B, L = pt.shape
    dev = pt.device
    pat = _pattern_tensor(pattern, dev)
    dt_round = -math.log1p(-events / L)
    times = (torch.arange(shifts.shape[0] + 1, dtype=torch.float64,
                          device=dev) * dt_round)
    t_hit = torch.full((B,), math.inf, dtype=torch.float64, device=dev)
    pattern_scan(dt_ if data_tape else pt, pat, _SCAN_FIRST_PASSAGE,
                 t_hit=t_hit, t_now=times[:1])
    checked = False
    for k0, n, uniforms in chunks:
        if not checked:
            _check_lattice(dm, pt, dt_, shifts, 0, n, events, uniforms)
            checked = True
        _first_passage_rounds(dm, pt, dt_, pat, shifts, k0, n, events,
                              uniforms, times, t_hit, data_tape)
    return t_hit, torch.isfinite(t_hit), (pt.to(torch.int32),
                                          dt_.to(torch.int32))


def _int8_copy(tape, device):
    t = torch.as_tensor(tape, device=device)
    out = t.to(torch.int8).contiguous()
    return out.clone() if out.data_ptr() == t.data_ptr() else out


def first_passage_times(generator, tapes, dm, pattern, plan, *,
                        data_tape: bool = True, device=None):
    """Per-member first time ``pattern`` appears anywhere on the tape.

    Evolves the B rings with rolled lattice rounds (K11, a shift shared
    by the batch and drawn over [0, L) each round, as the reference's
    `first_passage_times` does) and records each member's first round
    whose post-state contains the pattern (K12), on the data tape or,
    with ``data_tape=False``, the program tape; a pattern present at
    the start gives t = 0. Resolution is one round; members that never
    hit report ``inf``.

    Draws come from ``generator`` (a `torch.Generator` on ``device`` or
    an int seed): all shifts first, then the uniforms a chunk of rounds
    at a time, as `run_ensemble` draws them; every round of a chunk,
    K11 and K12 both, goes out from one C call.
    :func:`first_passage_from_draws` takes explicit draws.

    Args:
      generator: `torch.Generator` or an int seed.
      tapes: (ptape [B, L], dtape [B, L]) initial rings.
      dm: compiled :class:`DeviceMachine`.
      pattern: symbol-index sequence to detect (circularly).
      plan: (max_rounds, events_per_round); events must divide L; at
        E > 1 additionally L/events > 2·span.
      data_tape: search the data tape (True) or the program tape.
      device: where the run goes; ``cuda`` unless named.

    Returns:
      (t_hit float64 [B], ``inf`` if unhit; hit bool [B];
       (ptape, dtape) int32 final tapes).
    """
    max_rounds, events = plan
    device = config.get_device(device)
    pt, dt_ = (_int8_copy(t, device) for t in tapes)
    B, L = pt.shape
    _check_round_geometry(L, events, dm.span)
    gen = config.make_generator(generator, device)
    shifts = torch.randint(0, L, (max_rounds,), generator=gen,
                           device=device, dtype=torch.int32)
    return _first_passage(dm, pt, dt_, pattern, shifts,
                          _draw_chunks(gen, dm, B, events, max_rounds,
                                       device),
                          events, data_tape)


def first_passage_from_draws(dm, tapes, pattern, shifts, events,
                             uniforms=None, *, data_tape: bool = True,
                             rounds_per_call: int | None = None):
    """:func:`first_passage_times` with explicit draws on the tapes'
    device: ``shifts`` int32 [rounds] (any values, taken mod L),
    ``uniforms`` float32 [rounds, B, E] (read only by machines with
    choose nodes). The tapes are copied, not changed. The rounds go out
    ``rounds_per_call`` a C call (all in one when None), as
    `first_passage_times` sends its chunks."""
    if shifts.dim() != 1:
        raise TypeError("first passage takes one shift a round, int32 "
                        "[rounds]")
    pt, dt_ = (_int8_copy(t, shifts.device) for t in tapes)
    _check_round_geometry(pt.shape[1], events, dm.span)
    n = shifts.shape[0]
    step = n if rounds_per_call is None else int(rounds_per_call)
    if step < 1 and n:
        raise ValueError("rounds_per_call must be at least 1")
    u = uniforms if dm.has_choose else None
    chunks = [(k0, min(step, n - k0), None if u is None else u[k0:k0 + step])
              for k0 in range(0, n, max(step, 1))]
    return _first_passage(dm, pt, dt_, pattern, shifts, chunks, events,
                          data_tape)


# --- K2: window histogram -----------------------------------------------------


def _window_ranks(tape, size_a: int, cl_k: int):
    """The bin of every circular length-cl_k window of the [B, L] int32
    ``tape`` ([B, L] int64) and whether the reference counts it.

    The reference's rank is an int32 Horner sum, which wraps; its
    scatter then reads a rank in [-n, 0) as bin rank + n (numpy's rule
    for negative indices) and drops any other rank outside [0, n), with
    n = size_a**cl_k. The sum is taken here in int64 and kept to its low
    32 bits at every step, which is the int32 sum modulo 2**32."""
    rank = torch.zeros(tape.shape, dtype=torch.int64, device=tape.device)
    for j in range(cl_k):
        rank = (rank * size_a + torch.roll(tape, -j, dims=1)) & 0xFFFFFFFF
    rank = torch.where(rank >= 2**31, rank - 2**32, rank)
    n_bins = size_a**cl_k
    rank = torch.where(rank < 0, rank + n_bins, rank)
    return rank, (rank >= 0) & (rank < n_bins)


def window_bins(tape, size_a: int, cl_k: int):
    """The bin of every circular length-cl_k window of the [B, L] int32
    ``tape`` that the reference counts (`_window_ranks`), as a flat int64
    tensor in row-major order."""
    rank, keep = _window_ranks(tape, size_a, cl_k)
    return rank[keep]


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


# --- K13: weighted window histogram -------------------------------------------

# K13's blocks: at most this many, and fewer where a block's share of the
# partials (n_bins float64 and int32 counts each) would pass
# _K13_SCRATCH_BYTES in all.
_K13_MAX_BLOCKS = 256
_K13_SCRATCH_BYTES = 1 << 26
_K13_SHARED_BINS = 16384  # csrc/weighted_counts.cu: kSharedBins


def k13_members_per_block(B: int, n_bins: int) -> int:
    """Members each of K13's blocks takes, in order: block g takes
    members [g*m, (g+1)*m). This fixes the order of the float64 sum that
    K13 and its plain version both take."""
    blocks = max(1, min(B, _K13_MAX_BLOCKS,
                        _K13_SCRATCH_BYTES // (12 * n_bins)))
    return -(-B // blocks)


def _member_bins(tape, size_a: int, cl_k: int):
    """(member, bin) of every window that the reference counts: the bins
    of `window_bins`, each with the row it lies in."""
    B, L = tape.shape
    rank, keep = _window_ranks(tape, size_a, cl_k)
    member = torch.arange(B, device=tape.device)[:, None].expand(B, L)
    return member[keep], rank[keep]


def weighted_window_counts_plain(tape, w, size_a: int, cl_k: int):
    """K13's plain version: sum_b w[b] * counts_b / L, float64
    [size_a**cl_k], over the int32 [B, L] ``tape`` and the normalised
    float64 weights ``w`` [B], in K13's order: each member's windows
    counted exactly (the bins of `window_bins`); block g of
    `k13_members_per_block` adds w[b] * counts_b for its members b in
    order from 0.0; the blocks' partials are added in block order from
    0.0; the sum is divided by L."""
    weighted_window_counts_plain.calls += 1
    B, L = tape.shape
    n_bins = size_a**cl_k
    per = k13_members_per_block(B, n_bins)
    groups = -(-B // per)
    member, bins = _member_bins(tape, size_a, cl_k)
    counts = torch.zeros(groups * per * n_bins, dtype=torch.int64,
                         device=tape.device)
    counts.index_add_(0, member * n_bins + bins, torch.ones_like(bins))
    counts = counts.view(groups, per, n_bins)
    wp = torch.zeros(groups * per, dtype=torch.float64, device=tape.device)
    wp[:B] = w
    wp = wp.view(groups, per)
    acc = torch.zeros((groups, n_bins), dtype=torch.float64,
                      device=tape.device)
    for j in range(per):
        acc = acc + wp[:, j, None] * counts[:, j].to(torch.float64)
    total = torch.zeros(n_bins, dtype=torch.float64, device=tape.device)
    for g in range(groups):
        total = total + acc[g]
    # A tensor divisor: PyTorch's CUDA division by a Python number
    # multiplies by its reciprocal, which is not K13's quotient.
    return total / torch.tensor(float(L), dtype=torch.float64,
                                device=tape.device)


weighted_window_counts_plain.calls = 0


def weighted_window_counts(tape, weights, size_a: int, cl_k: int, *,
                           device=None):
    """Weighted empirical SPD from a batch of tapes:
    sum_b w_b · counts_b / L with ``w = weights / weights.sum()``,
    float64 [size_a**cl_k] (K13; finite weights).

    ``tape`` [B, L] and ``weights`` [B] are moved to ``device``
    (``cuda`` unless named). The counts are K2's windows by K2's rank
    rule, out-of-range symbols included; the sum over members takes one
    fixed order (:func:`weighted_window_counts_plain`), with no float
    atomics."""
    n_bins = size_a**cl_k
    if n_bins >= 2**31:
        raise ValueError(f"size_a**cl_k = {n_bins} bins exceed int32")
    device = config.get_device(device)
    tape = torch.as_tensor(tape, device=device).to(torch.int32).contiguous()
    if tape.dim() != 2:
        raise ValueError("tape must be [B, L]")
    w = torch.as_tensor(weights, device=device).to(torch.float64)
    if tuple(w.shape) != (tape.shape[0],):
        raise ValueError(f"weights must be [{tape.shape[0]}], got "
                         f"{tuple(w.shape)}")
    w = (w / w.sum()).contiguous()
    if not cuda.on_card(tape, "K13"):
        return weighted_window_counts_plain(tape, w, size_a, cl_k)
    B, L = tape.shape
    per = k13_members_per_block(B, n_bins)
    groups = -(-B // per)
    out = torch.empty(n_bins, dtype=torch.float64, device=device)
    partial = torch.empty(groups * n_bins, dtype=torch.float64,
                          device=device)
    hist = (torch.zeros(groups * n_bins, dtype=torch.int32, device=device)
            if n_bins > _K13_SHARED_BINS else None)
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    lib = cuda.load()
    with torch.cuda.device(device):
        rc = lib.ckpe_weighted_counts(
            tape.data_ptr(), w.data_ptr(), int(B), int(L), int(size_a),
            int(cl_k), int(per), partial.data_ptr(),
            None if hist is None else hist.data_ptr(), ticket.data_ptr(),
            out.data_ptr(), cuda.stream(tape))
    cuda.check(rc, "weighted_window_counts", lib)
    weighted_window_counts.launches += 1
    return out


weighted_window_counts.launches = 0


# --- Initial tapes from an SPD -------------------------------------------------


def sample_tapes_from_spd(generator, spd, size_a: int, cl_k: int,
                          batch: int, length: int, *, ring: bool = True,
                          device=None):
    """Draws int32 [batch, length] tape rings whose window statistics
    follow an SPD: symbols come from the SPD's order-(cl_k-1) Markov
    chain (`markov.mpp_from_spd`).

    With ``ring=True`` (the default) the chain is sampled as a circular
    Markov BRIDGE: each step's distribution is reweighted by the bridge
    factor ``T^(r-1)[next_ctx, ctx0]`` (r symbols remaining), so the
    sequence closes its own starting context and the ``cl_k-1`` windows
    crossing the seam read Markov-consistent statistics. Only the
    columns of the context transfer matrix at the sampled start contexts
    are kept, and only until they flatten (the chain has mixed): a flat
    bridge cancels in the per-step normalisation. If a start context
    cannot close its cycle at all, the whole batch is drawn as a linear
    chain instead. ``ring=False`` draws the linear chain, whose junction
    at the seam reads windows the SPD may not hold.

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

    n_kept = 0
    if ring:
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


# --- The weighted frontier (`frontier.py`) -------------------------------------

_FRONTIER_NAMES = frozenset((
    "run_weighted_frontier", "run_weighted_frontier_from_draws",
    "run_weighted_frontier_blocked", "blocked_rounds_from_draws",
    "weighted_first_passage", "weighted_first_passage_binned"))


def __getattr__(name):
    """The weighted frontier's names, from `frontier.py` (which imports
    this module, so it is loaded on first use)."""
    if name in _FRONTIER_NAMES:
        from . import frontier

        return getattr(frontier, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
