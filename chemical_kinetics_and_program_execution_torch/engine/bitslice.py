"""Bit-sliced rounds: 32 ensemble members a 32-bit word.

Counterpart of the JAX package's `engine/bitslice.py`. A choose-free
machine's round is a pure boolean function of its window's cell bits;
a machine with choose nodes (at tau = 1) becomes one too once each
choose level reads a fresh random word. Host side, the level plan is
replayed over every window content (or every level's selector space)
and synthesised into a hash-consed boolean DAG, the *circuit*:
``(ops, outputs, nb, n_rand)``, op for op the JAX package's. Device
side the circuit runs on bit-plane words: bit ``lane`` of word ``k`` of
a window cell packs member 32·w + lane's symbol bit ``k``, so one gate
on a word steps 32 members.

Words are int32 tensors that hold the uint32 words' bits (the CPU build
of PyTorch lacks shifts and ``~`` on uint32; ``>>`` on int32 is
arithmetic, so every bit taken out is masked with ``& 1``). Layouts,
as the reference's: the straight layout [stride, nb, B//32, E] (the
site axis minor) and the transposed one [stride, nb, E, B//32] (the
member words minor), which the reference splits into [stride, nb, E, S,
P] where a TPU tile fits better (:func:`transposed_word_shape`); the
port keeps the contiguous [E, B//32] words and hands out that shape as
a view, so its kernels always see [E, W].

Kernels (each wrapper runs its plain PyTorch version for CPU tensors
only; for a CUDA tensor it launches the kernel or raises, and counts
its launches in ``<wrapper>.launches``):

- **K14** :func:`bitslice_round` / :func:`run_bitsliced_rounds` — one
  round (or every round of a chunk, one launch a round) of a circuit on
  bit-plane words, in place; `bitslice_source.py` writes the circuit
  into a CUDA unit that includes `csrc/bitslice_round.cuh`. Plain
  version: :func:`apply_round_bitsliced`. It replaces the reference's
  `apply_round_bitsliced` with `_eval_circuit`.
- **K15** :func:`pack_bitwords` / :func:`unpack_bitwords` — the
  symbol <-> bit-plane transposes (`csrc/bitplanes.cu`), over any
  [B, E, stride] strided view of the symbols: [B, L] tapes, the FSM
  planes [stride, B, E] and the frontier's [stride, E, K]. Plain
  versions: :func:`pack_bitwords_plain`, :func:`unpack_bitwords_plain`.
  They replace `tapes_to_bitplanes`, `bitplanes_to_tapes`,
  `stacked_planes_to_bitwords` and `bitwords_to_stacked_planes`, which
  keep their names here.

Bit-exactness: a choose-free machine draws no random words, so the
bit-sliced run reproduces the FSM plane path's tapes bit for bit at the
same seed. A sampling circuit draws its own words, a different stream
from the FSM path's uniforms with the same law.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import cuda
from ..utils import config
from . import ensemble as ens

# --- Circuit IR: a hash-consed boolean DAG over input bit variables -----------

_CONST0 = ("const", 0, 0)
_CONST1 = ("const", 1, 0)


class _Builder:
    """Hash-consing gate builder with constant folding."""

    def __init__(self, n_in: int):
        self.ops: list[tuple] = []
        self._cache: dict[tuple, int] = {}
        self.c0 = self._emit(_CONST0)
        self.c1 = self._emit(_CONST1)
        self.inputs = [self._emit(("in", i, 0)) for i in range(n_in)]

    def _emit(self, op: tuple) -> int:
        got = self._cache.get(op)
        if got is not None:
            return got
        self.ops.append(op)
        idx = len(self.ops) - 1
        self._cache[op] = idx
        return idx

    def gate(self, kind: str, a: int, b: int = 0) -> int:
        if kind == "not":
            if a == self.c0:
                return self.c1
            if a == self.c1:
                return self.c0
            if self.ops[a][0] == "not":
                return self.ops[a][1]
            return self._emit(("not", a, 0))
        if a > b:
            a, b = b, a
        if a == b:
            return a if kind != "xor" else self.c0
        if kind == "and":
            if a == self.c0:
                return self.c0
            if a == self.c1:
                return b
        elif kind == "or":
            if a == self.c0:
                return b
            if a == self.c1:
                return self.c1
        elif kind == "xor":
            if a == self.c0:
                return b
            if a == self.c1:
                return self.gate("not", b)
        return self._emit((kind, a, b))

    def mux(self, s: int, hi: int, lo: int) -> int:
        """s ? hi : lo  (3 gates worst case)."""
        if hi == lo:
            return hi
        if s == self.c1:
            return hi
        if s == self.c0:
            return lo
        if hi == self.c1 and lo == self.c0:
            return s
        if hi == self.c0 and lo == self.c1:
            return self.gate("not", s)
        return self.gate("xor", lo, self.gate("and", s,
                                              self.gate("xor", hi, lo)))


def _dce_compact(ops, outputs, n_win):
    """Drops every gate unreachable from ``outputs`` and renumbers the
    random input variables (ids >= ``n_win``) to a dense range, so a
    round draws only the random words the circuit reads (each is an iid
    uniform word, so which draw feeds which comparator leaves the law as
    it is). Window inputs keep their ids: the round binds them by
    position. Returns (ops, outputs, random inputs used)."""
    reach: set = set()
    stack = list(outputs)
    while stack:
        i = stack.pop()
        if i in reach:
            continue
        reach.add(i)
        kind, a, b = ops[i]
        if kind in ("and", "or", "xor"):
            stack.append(a)
            stack.append(b)
        elif kind == "not":
            stack.append(a)
    used_rand = sorted({ops[i][1] for i in reach
                        if ops[i][0] == "in" and ops[i][1] >= n_win})
    rmap = {a: n_win + r for r, a in enumerate(used_rand)}
    new_ops: list = []
    idx: dict = {}
    for i, (kind, a, b) in enumerate(ops):
        if i not in reach:
            continue
        if kind == "in":
            op = ("in", rmap.get(a, a), 0)
        elif kind == "const":
            op = (kind, a, b)
        elif kind == "not":
            op = ("not", idx[a], 0)
        else:
            op = (kind, idx[a], idx[b])
        idx[i] = len(new_ops)
        new_ops.append(op)
    return (tuple(new_ops), tuple(idx[o] for o in outputs),
            len(used_rand))


def _synth_bit(builder: _Builder, table: np.ndarray, memo: dict) -> int:
    """Synthesises one output bit's truth table (length 2^k, its index's
    low bit the next variable to split on, variable n_in - k) as a mux
    tree, variable 0 (the first-read cell's low bit) first, memoised on
    the subtable's bytes."""
    key = table.tobytes()
    got = memo.get(key)
    if got is not None:
        return got
    if table.all():
        r = builder.c1
    elif not table.any():
        r = builder.c0
    else:
        n_in = len(builder.inputs)
        var = n_in - int(np.log2(len(table)))
        lo = _synth_bit(builder, np.ascontiguousarray(table[::2]), memo)
        hi = _synth_bit(builder, np.ascontiguousarray(table[1::2]), memo)
        r = builder.mux(builder.inputs[var], hi, lo)
    memo[key] = r
    return r


def _synth_over(builder: _Builder, table: np.ndarray, sel_nodes,
                memo: dict) -> int:
    """Synthesises a truth table over an explicit selector-node list
    (index bit d, low bit first, is ``sel_nodes[d]``, any circuit node);
    ``memo`` is scoped to one (table space, selectors) family."""
    def rec(t, d):
        key = (d, t.tobytes())
        got = memo.get(key)
        if got is not None:
            return got
        if t.all():
            r = builder.c1
        elif not t.any():
            r = builder.c0
        else:
            lo = rec(np.ascontiguousarray(t[::2]), d + 1)
            hi = rec(np.ascontiguousarray(t[1::2]), d + 1)
            r = builder.mux(sel_nodes[d], hi, lo)
        memo[key] = r
        return r

    return rec(table, 0)


def _less_than_const(builder: _Builder, r_bits, threshold: int) -> int:
    """Circuit for (r < threshold), r given low bit first, about 2 gates
    a bit."""
    nbits = len(r_bits)
    if threshold <= 0:
        return builder.c0
    if threshold >= (1 << nbits):
        return builder.c1
    lt = builder.c0
    eq = builder.c1
    for i in reversed(range(nbits)):
        t_i = (threshold >> i) & 1
        if t_i:
            lt = builder.gate("or", lt,
                              builder.gate("and", eq,
                                           builder.gate("not", r_bits[i])))
            eq = builder.gate("and", eq, r_bits[i])
        else:
            eq = builder.gate("and", eq,
                              builder.gate("not", r_bits[i]))
    return lt


# --- Eligibility and the round circuit of a choose-free machine ---------------

_MAX_IN_BITS = 22  # a 4M-row truth table; wider machines keep the FSM walk

# Largest circuit the CPU's plain path takes on the default route (the
# reference's limit for its CPU backend, kept so that the same calls take
# the same paths); the card takes any size, and bitslice=True overrides.
CPU_MAX_CIRCUIT_OPS = 2000


def circuit_cpu_ok(dm, device="cpu") -> bool:
    """Default-route gate: is this machine's circuit small enough for
    ``device``? Always true on the card."""
    if torch.device(device).type != "cpu":
        return True
    circ = (compile_round_circuit(dm) if machine_is_bitsliceable(dm)
            else compile_sampling_circuit(dm))
    return len(circ[0]) <= CPU_MAX_CIRCUIT_OPS


def machine_is_bitsliceable(dm) -> bool:
    """Choose-free and small enough to tabulate exhaustively."""
    if any(isinstance(n, ens._Choose) for n in dm.nodes):
        return False
    nb = max(1, (dm.size_a - 1).bit_length())
    return dm.n_cells * nb <= _MAX_IN_BITS


def _event_truth_tables(dm):
    """[n_cells * nb] boolean tables: new window bits over window bits.

    Replays the leveled walk and the write decode over every input bit
    pattern; patterns whose cell bits decode above size_a - 1 are
    clamped (they never occur on real tapes, and the clamp maximises
    subtable sharing).
    """
    nb = max(1, (dm.size_a - 1).bit_length())
    n_in = dm.n_cells * nb
    pats = np.arange(1 << n_in, dtype=np.int64)
    cellv = [np.minimum((pats >> (c * nb)) & ((1 << nb) - 1),
                        dm.size_a - 1)
             for c in range(dm.n_cells)]

    S = dm.num_specs
    state = np.full(pats.shape, S, np.int64)
    for lv in ens._level_plan(dm):
        assert not lv.chooses
        b = cellv[lv.cell_groups[0][0]]
        for cell, lo in lv.cell_groups[1:]:
            b = np.where(state >= S + lo, cellv[cell], b)
        idx = np.maximum(state - S, 0) * lv.max_deg + b
        fields = 31 // lv.bits
        words = np.asarray(lv.trans_words, np.int64)
        nxt = (words[idx // fields] >> (lv.bits * (idx % fields))) \
            & ((1 << lv.bits) - 1)
        state = np.where(state >= S, nxt, state)
    spec = state

    tables = []
    for c in range(dm.n_cells):
        wmask, wval = ens.wr_field_host(dm.wr_words[c], spec, dm.wr_bits)
        new_c = np.where(wmask, wval, cellv[c])
        for k in range(nb):
            tables.append(((new_c >> k) & 1).astype(bool))
    return tables, n_in, nb


def _machine(nodes, root, num_specs, size_a, bits, wr_words, n_p, n_d,
             p_lo, d_lo, span, tag, wr_bits):
    return ens.DeviceMachine(
        tag=tag, size_a=size_a, p_lo=p_lo, d_lo=d_lo, n_p=n_p, n_d=n_d,
        span=span, nodes=nodes, root=root, n_states=0, bits=bits,
        wr_words=wr_words, num_specs=num_specs, wr_bits=wr_bits)


@functools.lru_cache(maxsize=None)
def _compile_circuit(nodes, root, num_specs, size_a, bits, wr_words,
                     n_p, n_d, p_lo, d_lo, span, tag, wr_bits=5):
    """(ops, outputs, nb, 0): the round circuit for a hashable machine
    key."""
    dm = _machine(nodes, root, num_specs, size_a, bits, wr_words, n_p,
                  n_d, p_lo, d_lo, span, tag, wr_bits)
    tables, n_in, nb = _event_truth_tables(dm)
    builder = _Builder(n_in)
    memo: dict = {}
    outputs = tuple(_synth_bit(builder, t, memo) for t in tables)
    ops, outputs, _ = _dce_compact(builder.ops, outputs, n_in)
    if config.IS_DEBUG:
        n_gates = sum(op[0] in ("and", "or", "xor", "not") for op in ops)
        print(f"[bitslice] {tag}: {n_in} in-bits -> "
              f"{len(outputs)} out-bits, {n_gates} gates")
    return ops, outputs, nb, 0


def compile_round_circuit(dm):
    """The round circuit of a choose-free machine, cached per machine."""
    return _compile_circuit(dm.nodes, dm.root, dm.num_specs, dm.size_a,
                            dm.bits, dm.wr_words, dm.n_p, dm.n_d,
                            dm.p_lo, dm.d_lo, dm.span, dm.tag,
                            dm.wr_bits)


# --- Sampling circuits: machines with choose nodes at tau = 1 -----------------

_RAND_BITS = 24  # branch-probability resolution 2^-24

_MAX_SEL_BITS = 20  # per-level truth-table cap (2^20 rows)


def _choose_dist_groups(chooses):
    """Consecutive same-distribution runs of a level's choose nodes:
    ``[(probs, [local ids...]), ...]``. One branch word serves a whole
    run (a member sits at one node)."""
    groups: list = []
    for j, probs in chooses:
        if groups and groups[-1][0] == probs:
            groups[-1][1].append(j)
        else:
            groups.append((probs, [j]))
    return groups


def machine_is_sampleable(dm) -> bool:
    """Can the layered sampling circuit take this machine (tau = 1)?

    Every level's whole table (state bits, distinct read cells, branch
    bits a distinct distribution) must stay within `_MAX_SEL_BITS`; past
    that the split synthesis (one sub-table a cell or distribution group
    of a level) must fit instead.
    """
    nb = max(1, (dm.size_a - 1).bit_length())
    plan = ens._level_plan(dm)
    S = dm.num_specs
    sb = max(S - 1, *(S + lv.n_nodes - 1 for lv in plan)).bit_length()
    whole_ok = all(
        (sb + len(lv.cell_groups) * nb
         + sum(max(1, (len(p) - 1).bit_length())
               for p, _ in _choose_dist_groups(lv.chooses)))
        <= _MAX_SEL_BITS for lv in plan)
    if whole_ok:
        return sb + nb <= _MAX_SEL_BITS
    sizes = [lv.n_nodes for lv in plan] + [0]
    sb_split = max(S - 1, *(S + sizes[i] + sizes[i + 1] - 1
                            for i in range(len(plan)))).bit_length()
    w_max = max((max(1, (len(p) - 1).bit_length())
                 for lv in plan
                 for p, _ in _choose_dist_groups(lv.chooses)),
                default=1)
    return sb_split + max(nb, w_max) <= _MAX_SEL_BITS


def _choose_dist(probs):
    return ens._choose_sampling_dist(probs, 1.0)


@functools.lru_cache(maxsize=None)
def _compile_sampling_circuit(nodes, root, num_specs, size_a, bits,
                              wr_words, n_p, n_d, p_lo, d_lo, span, tag,
                              rand_bits, wr_bits=5, force_split=False):
    """Layered circuit for one event of a machine with choose nodes at
    tau = 1.

    Inputs: the window's cell bits (n_cells * nb), then ``rand_bits``
    random bits a choose level. A choose node samples its branch by
    comparing the level's random word with the integer thresholds
    round(cumsum(p) * 2^rand_bits). The walk's state is carried as
    sb-bit circuit values between levels; each level is one truth table
    over (state bits, the level's distinct read-cell bits, its branch
    bits), or, when any level's table would pass `_MAX_SEL_BITS` (or
    ``force_split``), one sub-table a cell group or distribution group
    (earlier units write next-level ids at ``S + n_this`` on, the last
    folds them back). The final state indexes the per-cell write tables.

    Returns (ops, outputs, nb, n_rand_inputs).
    """
    dm = _machine(nodes, root, num_specs, size_a, bits, wr_words, n_p,
                  n_d, p_lo, d_lo, span, tag, wr_bits)
    plan = ens._level_plan(dm)
    nb = max(1, (size_a - 1).bit_length())
    n_cells = n_p + n_d
    S = num_specs
    sb = max(S - 1, *(S + lv.n_nodes - 1 for lv in plan)).bit_length()

    def _whole_level_sel_bits(lv):
        return (sb + len(lv.cell_groups) * nb
                + sum(max(1, (len(p) - 1).bit_length())
                      for p, _ in _choose_dist_groups(lv.chooses)))

    split_mode = force_split or any(
        _whole_level_sel_bits(lv) > _MAX_SEL_BITS for lv in plan)
    if split_mode:
        sizes = [lv.n_nodes for lv in plan] + [0]
        sb = max(S - 1, *(S + sizes[i] + sizes[i + 1] - 1
                          for i in range(len(plan)))).bit_length()

    n_choose_levels = sum(1 for lv in plan if lv.chooses)
    n_rand = n_choose_levels * rand_bits
    builder = _Builder(n_cells * nb + n_rand)
    win = builder.inputs[:n_cells * nb]
    rnd = builder.inputs[n_cells * nb:]

    def const_bits(v, width):
        return [builder.c1 if (v >> k) & 1 else builder.c0
                for k in range(width)]

    def unpack_vals(lv):
        fields = 31 // lv.bits
        words = np.asarray(lv.trans_words, np.int64)
        i = np.arange(lv.n_nodes * lv.max_deg)
        return (words[i // fields] >> (lv.bits * (i % fields))) \
            & ((1 << lv.bits) - 1)

    state_bits = const_bits(S, sb)  # the root is local id 0
    rand_used = 0
    for lv in plan:
        vals = unpack_vals(lv)
        choose_locals = {j for j, _ in lv.chooses}
        cell_of = {}
        for g, (cell, lo) in enumerate(lv.cell_groups):
            hi = (lv.cell_groups[g + 1][1] if g + 1 < len(lv.cell_groups)
                  else lv.n_nodes)
            for j in range(lo, hi):
                if j not in choose_locals:
                    cell_of[j] = cell

        # Branch bits a distinct distribution, from the level's word.
        dist_groups = _choose_dist_groups(lv.chooses)
        branch_nodes = []
        branch_widths = []
        if lv.chooses:
            r_bits = rnd[rand_used * rand_bits:(rand_used + 1)
                         * rand_bits]
            rand_used += 1
            for probs, _locals in dist_groups:
                q, _ = _choose_dist(probs)
                cum = np.cumsum(q)
                ges = [builder.gate(
                    "not", _less_than_const(
                        builder, r_bits,
                        int(round(float(c) * (1 << rand_bits)))))
                    for c in cum[:-1]]
                w = max(1, (len(q) - 1).bit_length())
                bbits = []
                for k in range(w):
                    # Bit k of the branch index m = sum of the monotone
                    # ge_j: the XOR of ge_j over j = 0 mod 2^k.
                    x = builder.c0
                    for j, ge in enumerate(ges, start=1):
                        if j % (1 << k) == 0:
                            x = builder.gate("xor", x, ge)
                    bbits.append(x)
                branch_nodes.append(bbits)
                branch_widths.append(w)

        if split_mode:
            n_this = lv.n_nodes
            off = S + n_this
            first_choose = (min(choose_locals) if choose_locals
                            else lv.n_nodes)
            units = []
            for g, (cell, lo) in enumerate(lv.cell_groups):
                hi = (lv.cell_groups[g + 1][1]
                      if g + 1 < len(lv.cell_groups) else first_choose)
                if hi > lo:
                    units.append(("cell", cell, range(lo, hi), None))
            for (probs, locs), bbits, w in zip(dist_groups,
                                               branch_nodes,
                                               branch_widths):
                units.append(("dist", probs, locs, bbits))
            for u_i, (kind, a1, js, bbits) in enumerate(units):
                last = u_i == len(units) - 1
                if kind == "cell":
                    ext = win[a1 * nb:(a1 + 1) * nb]
                    clamp = size_a - 1
                else:
                    ext = bbits
                    clamp = len(a1) - 1
                sel = list(state_bits) + list(ext)
                if len(sel) > _MAX_SEL_BITS:
                    raise ValueError(
                        f"{tag!r}: split-unit selector space "
                        f"{len(sel)} bits exceeds {_MAX_SEL_BITS}")
                idx = np.arange(1 << len(sel), dtype=np.int64)
                v = idx & ((1 << sb) - 1)
                bval = np.minimum((idx >> sb) & ((1 << len(ext)) - 1),
                                  clamp)
                nxt = v.copy()
                if last:
                    nxt = np.where(v >= off, v - n_this, nxt)
                for j in js:
                    row = vals[j * lv.max_deg + bval]
                    enc = np.where(row < S, row,
                                   row if last else row + n_this)
                    nxt = np.where(v == S + j, enc, nxt)
                memo: dict = {}
                state_bits = [
                    _synth_over(builder,
                                ((nxt >> k) & 1).astype(bool), sel,
                                memo)
                    for k in range(sb)]
            continue

        # Selector space: state bits, distinct cell bits, branch bits.
        sel = list(state_bits)
        for cell, _ in lv.cell_groups:
            sel += win[cell * nb:(cell + 1) * nb]
        for bbits in branch_nodes:
            sel += bbits
        n_sel = len(sel)
        if n_sel > _MAX_SEL_BITS:
            raise ValueError(
                f"{tag!r}: level selector space {n_sel} bits exceeds "
                f"{_MAX_SEL_BITS}")
        idx = np.arange(1 << n_sel, dtype=np.int64)
        pos = 0
        v = (idx >> pos) & ((1 << sb) - 1)
        pos += sb
        cellval = {}
        for cell, _ in lv.cell_groups:
            cellval[cell] = np.minimum((idx >> pos) & ((1 << nb) - 1),
                                       size_a - 1)
            pos += nb
        branchval = {}
        for (probs, locs), w in zip(dist_groups, branch_widths):
            bv = np.minimum((idx >> pos) & ((1 << w) - 1),
                            len(probs) - 1)
            for j in locs:
                branchval[j] = bv
            pos += w

        nxt = v.copy()
        for j in range(lv.n_nodes):
            b = (branchval[j] if j in choose_locals
                 else cellval[cell_of[j]])
            nxt = np.where(v == S + j, vals[j * lv.max_deg + b], nxt)
        memo: dict = {}
        state_bits = [
            _synth_over(builder, ((nxt >> k) & 1).astype(bool), sel,
                        memo)
            for k in range(sb)]

    # Write decode: spec = the final state (< S by construction).
    outputs = []
    for c in range(n_cells):
        sel = list(state_bits) + list(win[c * nb:(c + 1) * nb])
        idx = np.arange(1 << (sb + nb), dtype=np.int64)
        v = np.minimum(idx & ((1 << sb) - 1), S - 1)
        cv = np.minimum((idx >> sb) & ((1 << nb) - 1), size_a - 1)
        wmask, wval = ens.wr_field_host(wr_words[c], v, wr_bits)
        new_c = np.where(wmask, wval, cv)
        memo = {}
        for k in range(nb):
            outputs.append(_synth_over(
                builder, ((new_c >> k) & 1).astype(bool), sel, memo))

    ops, outputs, n_rand_used = _dce_compact(
        builder.ops, tuple(outputs), n_cells * nb)
    if config.IS_DEBUG:
        n_gates = sum(op[0] in ("and", "or", "xor", "not") for op in ops)
        print(f"[bitslice] {tag} (sampling): {n_cells * nb}+"
              f"{n_rand_used} in-bits (of {n_rand} declared) -> "
              f"{len(outputs)} out-bits, {n_gates} gates")
    return ops, outputs, nb, n_rand_used


def compile_sampling_circuit(dm, *, rand_bits: int = _RAND_BITS,
                             force_split: bool = False):
    """The sampling circuit of a machine at tau = 1, cached per
    machine."""
    return _compile_sampling_circuit(
        dm.nodes, dm.root, dm.num_specs, dm.size_a, dm.bits,
        dm.wr_words, dm.n_p, dm.n_d, dm.p_lo, dm.d_lo, dm.span, dm.tag,
        rand_bits, dm.wr_bits, force_split)


def machine_circuit(dm):
    """The circuit `run_ensemble` runs for ``dm``: the round circuit of a
    bit-sliceable machine, else the sampling circuit."""
    if machine_is_bitsliceable(dm):
        return compile_round_circuit(dm)
    return compile_sampling_circuit(dm)


# --- The circuit on words (K14's plain version) ------------------------------

_ALL_ONES = -1  # the word 0xFFFFFFFF as an int32


def _eval_circuit(ops, outputs, in_words, shape):
    """Evaluates the DAG on int32 words; returns one word tensor a
    output (constants as full tensors of ``shape``)."""
    vals: list = []
    for kind, a, b in ops:
        if kind == "const":
            vals.append(_ALL_ONES if a else 0)  # Python ints broadcast
        elif kind == "in":
            vals.append(in_words[a])
        elif kind == "not":
            vals.append(~vals[a])
        elif kind == "and":
            vals.append(vals[a] & vals[b])
        elif kind == "or":
            vals.append(vals[a] | vals[b])
        else:
            vals.append(vals[a] ^ vals[b])
    device = in_words[0].device if in_words else None
    outs = []
    for o in outputs:
        v = vals[o]
        if isinstance(v, int):
            v = torch.full(shape, v, dtype=torch.int32, device=device)
        outs.append(v)
    return outs


def transposed_word_shape(E: int, W: int) -> tuple[int, ...]:
    """The reference's word shape of the transposed layout: [E, W], or
    [E, S, P] with S·P = W where that fills the TPU's (8, 128) tiles
    better (its choice, by the same cost). The port stores [E, W] and
    this shape is a view of it."""
    def pad(n, t):
        return -(-n // t) * t / n

    best, best_cost = (E, W), pad(E, 8) * pad(W, 128)
    s = 1
    while s * s <= W:
        if W % s == 0:
            for S in (s, W // s):
                cost = pad(S, 8) * pad(W // S, 128)
                if cost < best_cost - 1e-12:
                    best, best_cost = (E, S, W // S), cost
        s += 1
    return best


def site_axis_of(words, transpose: bool) -> int:
    """The site axis of one plane's words (``words`` [stride, nb, ...]):
    -1 for the straight layout, -(ndim - 2) for the transposed one."""
    return -(words.dim() - 2) if transpose else -1


def apply_round_bitsliced(dm, circ, p_bp, d_bp, shift, *,
                          site_axis: int = -1, rand_words=None):
    """K14's plain version: one stratified round on bit-plane words, in
    place, as the reference computes it. Returns ``(p_bp, d_bp)``.

    Window cell ``off`` sits in plane (shift + off) mod stride, rolled
    by floor((shift + off) / stride) along ``site_axis`` (-1 for the
    straight layout, -2 for [E, W], -3 for [E, S, P]; no roll for
    off = 0, as the reference). ``rand_words`` ([n_rand, *word shape]
    int32) feeds a sampling circuit's random inputs; None for a round
    circuit. All new words are made before any is written back.
    """
    apply_round_bitsliced.calls += 1
    ops, outputs, nb, n_rand = circ
    stride = p_bp.shape[0]
    shift = int(shift)
    tapes_meta = ((p_bp, dm.p_lo, dm.n_p), (d_bp, dm.d_lo, dm.n_d))
    in_words: list = []
    locs: list = []
    for bp, lo, n in tapes_meta:
        for j in range(n):
            off = lo + j
            a = shift + off
            c = a % stride
            x = bp[c]
            e = None if off == 0 else a // stride
            if e:
                x = torch.roll(x, -e, dims=site_axis)
            in_words += [x[k] for k in range(nb)]
            locs.append((c, e))
    shape = in_words[0].shape
    if n_rand:
        in_words += [rand_words[i] for i in range(n_rand)]
    new_bits = _eval_circuit(ops, outputs, in_words, shape)
    new = []
    for k, (c, e) in enumerate(locs):
        v = torch.stack(new_bits[k * nb:(k + 1) * nb])
        new.append(torch.roll(v, e, dims=site_axis) if e else v)
    k = 0
    for bp, lo, n in tapes_meta:
        for _ in range(n):
            bp[locs[k][0]] = new[k]
            k += 1
    return p_bp, d_bp


apply_round_bitsliced.calls = 0


def _word_dims(words, site_axis):
    """(E, W, site_minor) of bit-plane words [stride, nb, ...]."""
    if site_axis == -1:
        W, E = words.shape[2], words.shape[3]
        return E, W, True
    E = words.shape[2]
    return E, words[0, 0].numel() // E, False


def _check_words(dm, circ, p_bp, d_bp, shifts, k0, n, rand_words,
                 site_axis):
    """Checks the words, ``shifts`` and the random words of rounds
    [k0, k0+n) (``rand_words`` [n, n_rand, *word shape])."""
    _, _, nb, n_rand = circ
    if p_bp.dtype != torch.int32 or d_bp.dtype != torch.int32:
        raise TypeError("bit-plane words must be int32")
    if p_bp.shape != d_bp.shape or p_bp.dim() < 4 or p_bp.shape[1] != nb:
        raise ValueError(
            f"words must be two equal [stride, {nb}, ...] tensors, got "
            f"{tuple(p_bp.shape)} and {tuple(d_bp.shape)}")
    want_axis = (-1, -(p_bp.dim() - 2))
    if site_axis not in want_axis:
        raise ValueError(f"site_axis {site_axis} is not one of {want_axis}")
    if not (p_bp.is_contiguous() and d_bp.is_contiguous()):
        raise ValueError("words must be contiguous")
    if shifts.dtype != torch.int32 or shifts.dim() != 1:
        raise TypeError("shifts must be a 1-D int32 tensor")
    if not (0 <= k0 and k0 + n <= shifts.shape[0]):
        raise IndexError(f"rounds [{k0}, {k0 + n}) outside "
                         f"shifts[0:{shifts.shape[0]}]")
    dev = p_bp.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"K14 runs on cuda or cpu tensors, not {dev}")
    for name, t in (("d_bp", d_bp), ("shifts", shifts)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, words on {dev}")
    if n_rand:
        want = (n, n_rand) + tuple(p_bp.shape[2:])
        if (rand_words is None or rand_words.dtype != torch.int32
                or tuple(rand_words.shape) != want
                or not rand_words.is_contiguous()):
            raise ValueError(
                f"{dm.tag}'s circuit reads {n_rand} random words a round: "
                f"rand_words must be a contiguous int32 {list(want)} "
                "tensor")
        if rand_words.device != dev:
            raise ValueError(f"rand_words on {rand_words.device}, words "
                             f"on {dev}")
    if p_bp.numel() >= 2**31:
        raise ValueError("K14 takes fewer than 2**31 words a tape")


def _bitsliced_rounds(dm, circ, p_bp, d_bp, shifts, k0, n, rand_words,
                      site_axis):
    """Rounds [k0, k0+n), checked by the caller: the plain version a
    round on the CPU; on the card one C call that launches K14 once a
    round on the current stream."""
    n_rand = circ[3]
    if p_bp.device.type == "cpu":
        for j in range(n):
            apply_round_bitsliced(
                dm, circ, p_bp, d_bp, shifts[k0 + j], site_axis=site_axis,
                rand_words=rand_words[j] if n_rand else None)
        return
    from .bitslice_source import k14_library

    lib = k14_library(dm, circ)
    stride = p_bp.shape[0]
    E, W, site_minor = _word_dims(p_bp, site_axis)
    r_ptr = rand_words.data_ptr() if n_rand else None
    with torch.cuda.device(p_bp.device):
        rc = lib.ckpe_bs_rounds(p_bp.data_ptr(), d_bp.data_ptr(), r_ptr,
                                shifts.data_ptr(), None, int(k0), int(n),
                                int(E), int(W), int(site_minor), int(stride),
                                cuda.stream(p_bp))
    cuda.check(rc, "bitslice_round", lib)
    bitslice_round.launches += n


def bitslice_round(dm, circ, p_bp, d_bp, shifts, k, rand_words=None, *,
                   site_axis: int = -1):
    """Round ``k`` of a run on bit-plane words, in place (K14): phase
    ``shifts[k]`` in [0, stride) (an int32 tensor on the words' device,
    read there), ``rand_words`` [n_rand, *word shape] int32 for a
    sampling circuit. CPU tensors take :func:`apply_round_bitsliced`."""
    if rand_words is not None:
        rand_words = rand_words[None]
    _check_words(dm, circ, p_bp, d_bp, shifts, k, 1, rand_words, site_axis)
    _bitsliced_rounds(dm, circ, p_bp, d_bp, shifts, k, 1, rand_words,
                      site_axis)


bitslice_round.launches = 0


def run_bitsliced_rounds(dm, circ, p_bp, d_bp, shifts, rand_words=None, *,
                         site_axis: int = -1):
    """Applies ``len(shifts)`` rounds to bit-plane words in place with
    explicit draws: ``shifts`` int32 [n] on the words' device,
    ``rand_words`` int32 [n, n_rand, *word shape] for a sampling
    circuit. Returns the words. On the card every round is launched from
    one C call."""
    n = shifts.shape[0]
    _check_words(dm, circ, p_bp, d_bp, shifts, 0, n, rand_words, site_axis)
    _bitsliced_rounds(dm, circ, p_bp, d_bp, shifts, 0, n, rand_words,
                      site_axis)
    return p_bp, d_bp


def draw_rand_words(gen, shape, device, out=None):
    """Random int32 words with all 32 bits uniform (``torch.randint``
    over [-2**31, 2**31): a draw over [0, 2**31) would leave the sign
    bit, member lane 31, always 0)."""
    return torch.randint(-2**31, 2**31, shape, generator=gen,
                         device=device, dtype=torch.int32, out=out)


# --- K15: the symbol <-> bit-plane transposes ---------------------------------


def _packed_shape(B, E, stride, nb, transpose):
    W = B // 32
    return (stride, nb) + ((E, W) if transpose else (W, E))


def pack_bitwords_plain(sym, nb: int, *, transpose: bool = False):
    """K15's plain pack: symbols ``sym`` [B, E, stride] (any strides,
    any integer type; symbol (b, e, c) of a tape is column e·stride + c)
    -> int32 words [stride, nb, B//32, E], or [stride, nb, E, B//32]
    with ``transpose``: bit ``lane`` of word (c, k, w, e) is bit k of
    symbol (32·w + lane, e, c). One plane and bit at a time, so the
    largest intermediate is one plane's."""
    pack_bitwords_plain.calls += 1
    B, E, stride = sym.shape
    W = B // 32
    out = torch.empty(_packed_shape(B, E, stride, nb, transpose),
                      dtype=torch.int32, device=sym.device)
    weight = torch.ones(32, dtype=torch.int64, device=sym.device) \
        << torch.arange(32, device=sym.device)
    for c in range(stride):
        p = sym[:, :, c].to(torch.int32)
        for k in range(nb):
            bits = ((p >> k) & 1).to(torch.int64).reshape(W, 32, E)
            v = (bits * weight[None, :, None]).sum(1)  # [W, E], < 2**32
            v = torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)
            out[c, k] = v.T if transpose else v
    return out


pack_bitwords_plain.calls = 0


def unpack_bitwords_plain(words, out, *, transpose: bool = False):
    """K15's plain unpack: the inverse of :func:`pack_bitwords_plain`,
    written into ``out``, a [B, E, stride] view of the symbols (any
    strides and integer type); each symbol is the OR of its nb bits."""
    unpack_bitwords_plain.calls += 1
    B, E, stride = out.shape
    W = B // 32
    nb = words.shape[1]
    words = words.reshape(stride, nb, *((E, W) if transpose else (W, E)))
    lanes = torch.arange(32, dtype=torch.int32, device=words.device)
    for c in range(stride):
        sym = torch.zeros((W, 32, E), dtype=torch.int32,
                          device=words.device)
        for k in range(nb):
            w = words[c, k].T if transpose else words[c, k]  # [W, E]
            sym |= ((w[:, None, :] >> lanes[None, :, None]) & 1) << k
        out[:, :, c] = sym.reshape(B, E).to(out.dtype)
    return out


unpack_bitwords_plain.calls = 0


def _check_symbols(sym, name):
    if sym.dim() != 3:
        raise ValueError(f"{name} must be a [B, E, stride] view")
    if sym.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"{name} must be int8 or int32 on the card")
    if sym.shape[0] % 32:
        raise ValueError(f"bit-sliced words need B % 32 == 0, got "
                         f"{sym.shape[0]}")
    if sym.device.type == "cuda" and sym.numel() >= 2**31:
        raise ValueError("K15 takes fewer than 2**31 symbols")


def _k15_args(sym):
    sb, se, sc = sym.stride()
    B, E, stride = sym.shape
    # Columns run along whichever of the site and phase axes is denser.
    return (sym.data_ptr(), sym.element_size(), int(sb), int(se), int(sc),
            int(B), int(E), int(stride), int(sc <= se))


def pack_bitwords(sym, nb: int, *, transpose: bool = False):
    """K15's pack on a CUDA ``sym`` ([B, E, stride] int8 or int32 view,
    any strides), the plain version (:func:`pack_bitwords_plain`, which
    says what it computes) on a CPU one. Returns contiguous int32 words
    [stride, nb, B//32, E], or [stride, nb, E, B//32] with
    ``transpose``."""
    if not cuda.on_card(sym, "K15"):
        if sym.dim() != 3 or sym.shape[0] % 32:
            raise ValueError(f"sym must be a [B, E, stride] view with "
                             f"B % 32 == 0, got {tuple(sym.shape)}")
        return pack_bitwords_plain(sym, nb, transpose=transpose)
    _check_symbols(sym, "sym")
    B, E, stride = sym.shape
    out = torch.empty(_packed_shape(B, E, stride, nb, transpose),
                      dtype=torch.int32, device=sym.device)
    lib = cuda.load()
    with torch.cuda.device(sym.device):
        rc = lib.ckpe_bitplanes_pack(*_k15_args(sym), int(nb),
                                     int(transpose), out.data_ptr(),
                                     cuda.stream(sym))
    cuda.check(rc, "bitplanes (pack)", lib)
    pack_bitwords.launches += 1
    return out


pack_bitwords.launches = 0


def unpack_bitwords(words, out, *, transpose: bool = False):
    """K15's unpack on CUDA words, the plain version
    (:func:`unpack_bitwords_plain`) on CPU ones: ``words`` [stride, nb,
    ...] int32 (contiguous) into ``out``, a [B, E, stride] int8 or int32
    view of the symbols (any strides). Returns ``out``."""
    if not cuda.on_card(words, "K15"):
        return unpack_bitwords_plain(words, out, transpose=transpose)
    _check_symbols(out, "out")
    if words.dtype != torch.int32 or not words.is_contiguous():
        raise TypeError("words must be contiguous int32")
    B, E, stride = out.shape
    if words.numel() != stride * words.shape[1] * E * (B // 32):
        raise ValueError(f"words {tuple(words.shape)} do not fit symbols "
                         f"{tuple(out.shape)}")
    if out.device != words.device:
        raise ValueError(f"out is on {out.device}, words on {words.device}")
    lib = cuda.load()
    with torch.cuda.device(words.device):
        rc = lib.ckpe_bitplanes_unpack(*_k15_args(out), int(words.shape[1]),
                                       int(transpose), words.data_ptr(),
                                       cuda.stream(words))
    cuda.check(rc, "bitplanes (unpack)", lib)
    unpack_bitwords.launches += 1
    return out


unpack_bitwords.launches = 0


def tapes_to_bitplanes(tape, stride, nb, *, transpose: bool = False):
    """[B, L] integer tape -> int32 bit-plane words, 32 members a word
    (K15): [stride, nb, B//32, E] straight, or [stride, nb,
    *transposed_word_shape(E, B//32)] (a view of [stride, nb, E, B//32])
    with ``transpose``."""
    B, L = tape.shape
    E = L // stride
    if B % 32:
        raise ValueError(f"bit-sliced path needs B % 32 == 0, got {B}")
    if tape.dtype not in (torch.int8, torch.int32):
        tape = tape.to(torch.int32)
    words = pack_bitwords(tape.reshape(B, E, stride), nb,
                          transpose=transpose)
    if transpose:
        return words.view(stride, nb, *transposed_word_shape(E, B // 32))
    return words


def bitplanes_to_tapes(bp, *, transpose: bool = False):
    """Inverse of :func:`tapes_to_bitplanes` -> [B, L] int32 (K15)."""
    stride = bp.shape[0]
    if transpose:
        E = bp.shape[2]
        B = 32 * (bp[0, 0].numel() // E)
    else:
        B, E = 32 * bp.shape[2], bp.shape[3]
    out = torch.empty((B, E * stride), dtype=torch.int32, device=bp.device)
    unpack_bitwords(bp.contiguous(), out.view(B, E, stride),
                    transpose=transpose)
    return out


def stacked_planes_to_bitwords(st, nb):
    """[stride, E, K] int8 stacked planes -> [stride, nb,
    *transposed_word_shape(E, K//32)] int32 words (members packed 32 a
    word on the minor axis; K15)."""
    stride, E, K = st.shape
    if K % 32:
        raise ValueError(f"bit-sliced planes need K % 32 == 0, got {K}")
    words = pack_bitwords(st.permute(2, 1, 0), nb, transpose=True)
    return words.view(stride, nb, *transposed_word_shape(E, K // 32))


def bitwords_to_stacked_planes(bw):
    """Inverse of :func:`stacked_planes_to_bitwords` -> [stride, E, K]
    int8 (K15)."""
    stride, E = bw.shape[0], bw.shape[2]
    K = 32 * (bw[0, 0].numel() // E)
    out = torch.empty((stride, E, K), dtype=torch.int8, device=bw.device)
    unpack_bitwords(bw.contiguous(), out.permute(2, 1, 0), transpose=True)
    return out

