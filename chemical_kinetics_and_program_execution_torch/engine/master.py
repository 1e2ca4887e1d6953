"""Exact finite-ring master equation: the microscopic oracle.

Counterpart of the JAX package's `engine/master.py`, host numpy and
scipy with no kernel: the oracle the port's ensemble (K10-K13) is held
to, on the CPU and on the card.

The exact engine evolves WINDOW marginals of an infinite tape under a
closure; the ensemble engine samples finite rings. This module closes
the triangle with the third, approximation-free formulation: the full
master equation over every configuration of a length-``L`` ring,

    dP(x)/dt = Σ_sites Σ_outcomes  rate · [P(x') − P(x)] ,

with the per-site outcome distribution enumerated straight from the
DSL rule (each site fires as a rate-1 Poisson process and resolves its
``choose`` branches by their normalised weights, restricted to a
concrete configuration). Nothing is truncated: at ``size_a^L``
affordable (≈ 2^20), the state distribution is exact, so it
simultaneously oracles

- the ENSEMBLE engine's sampling dynamics (distribution over ring
  states at time t, time calibration included), and
- the CLOSURE's finite-size error (ring window marginals vs the
  infinite-chain closure trajectory).

Scope: the single-tape path (`build_ring_generator`) covers rules that
touch one tape (ex1/ex2-class; touching both raises there). TWO-TAPE
rules get the exact treatment at squared cost via
`build_pair_ring_generator` — the full master equation over all
``size_a^(2L)`` states of a tethered (program, data) ring pair, the
microscopic law of CONCRETE tape pairs that the dual-SPD closure's
well-mixed reveal semantics deliberately does not model. That oracles
the ensemble's joint two-tape dynamics — copies, cross-tape branching,
fuel depletion included.
"""

from __future__ import annotations

import itertools

import numpy as np

from . import dsl


class _ConcreteDriver:
    """Runs a rule on a concrete symbol window, DFS-enumerating every
    ``choose`` branch. Reads grow the window lazily so the reach (span)
    is discovered, not declared."""

    def __init__(self, window: dict[int, int]):
        self.window = window
        self.script: list[tuple[int, int, float]] = []  # (pick, n, prob)
        self.cursor = 0
        self.writes: dict[int, int] = {}
        self.tapes_touched: set[bool] = set()
        self.min_idx = 0
        self.max_idx = 0

    def _touch(self, data_tape: bool) -> None:
        # Reads AND writes share one tape: a rule that e.g. reads the
        # data tape but writes the program tape is out of scope, and
        # letting it through would silently apply the write to the
        # data ring (and alias into later reads of the same index).
        self.tapes_touched.add(data_tape)
        if len(self.tapes_touched) > 1:
            raise ValueError(
                "master equation supports single-tape rules only "
                "(the rule touched both tapes; a pair state space "
                "squares)")

    def tape_get(self, data_tape: bool, index: int) -> int:
        self._touch(data_tape)
        self.min_idx = min(self.min_idx, index)
        self.max_idx = max(self.max_idx, index)
        if index in self.writes:
            return self.writes[index]
        # Reads beyond the provided window return symbol 0 and widen
        # the recorded reach; window_outcome_table re-enumerates with
        # the grown window until a full pass stays inside it.
        return self.window.get(index, 0)

    def tape_set(self, data_tape: bool, index: int, value: int) -> None:
        self._touch(data_tape)
        self.min_idx = min(self.min_idx, index)
        self.max_idx = max(self.max_idx, index)
        self.writes[index] = value

    def choose(self, probs: list[float]) -> int:
        if self.cursor < len(self.script):
            k = self.script[self.cursor][0]
        else:
            k = 0
            self.script.append((0, len(probs), probs[0]))
        self.script[self.cursor] = (k, len(probs), probs[k])
        self.cursor += 1
        return k


class _ConcretePairDriver(_ConcreteDriver):
    """Two-tape concrete driver: independent windows, writes, and
    reach per tape (False = program, True = data). Same DFS ``choose``
    machinery as the single-tape driver."""

    def __init__(self, window_p: dict[int, int],
                 window_d: dict[int, int]):
        super().__init__({})
        self.pair_window = {False: window_p, True: window_d}
        self.pair_writes: dict[bool, dict[int, int]] = {
            False: {}, True: {}}
        self.pair_reach = {False: [0, 0], True: [0, 0]}

    def _span(self, data_tape: bool, index: int) -> None:
        r = self.pair_reach[data_tape]
        r[0] = min(r[0], index)
        r[1] = max(r[1], index)

    def tape_get(self, data_tape: bool, index: int) -> int:
        data_tape = bool(data_tape)
        self._span(data_tape, index)
        if index in self.pair_writes[data_tape]:
            return self.pair_writes[data_tape][index]
        return self.pair_window[data_tape].get(index, 0)

    def tape_set(self, data_tape: bool, index: int, value: int) -> None:
        data_tape = bool(data_tape)
        self._span(data_tape, index)
        self.pair_writes[data_tape][index] = value


def _dfs_outcomes(problem: dsl.Problem, make_driver):
    """Runs the rule once per ``choose``-branch combination (odometer
    over the deepest un-exhausted choice) and returns
    ``[(prob, driver)]`` — the shared DFS core of the single-tape and
    pair enumerators."""
    outcomes = []
    script: list[tuple[int, int, float]] = []
    while True:
        drv = make_driver()
        drv.script = list(script)
        drv.cursor = 0
        tape = dsl.Tape(drv, problem.symbols)
        problem.call(tape)
        prob = 1.0
        for _, _, p in drv.script[: drv.cursor]:
            prob *= p
        outcomes.append((prob, drv))
        # Odometer: advance the deepest un-exhausted choice.
        script = list(drv.script[: drv.cursor])
        while script:
            k, n, _ = script[-1]
            if k + 1 < n:
                script[-1] = (k + 1, n, 0.0)
                break
            script.pop()
        if not script:
            break
    return outcomes


def enumerate_window_outcomes(problem: dsl.Problem, window: dict[int, int]):
    """All execution outcomes of the rule fired at offset 0 on a
    concrete window: list of ``(prob, writes)`` with probs summing to 1
    and writes a (possibly empty) {offset: new symbol index} dict.
    Also returns the index reach ``(min_idx, max_idx)`` seen."""
    runs = _dfs_outcomes(problem, lambda: _ConcreteDriver(dict(window)))
    outcomes = [(prob, dict(drv.writes)) for prob, drv in runs]
    reach = [0, 0]
    for _, drv in runs:
        reach[0] = min(reach[0], drv.min_idx)
        reach[1] = max(reach[1], drv.max_idx)
    return outcomes, tuple(reach)


def enumerate_pair_outcomes(problem: dsl.Problem,
                            window_p: dict[int, int],
                            window_d: dict[int, int]):
    """Two-tape analogue of :func:`enumerate_window_outcomes`: all
    outcomes of the rule fired at offset 0 on concrete
    (program, data) windows — ``[(prob, writes_p, writes_d)]`` plus
    the per-tape index reaches."""
    runs = _dfs_outcomes(
        problem,
        lambda: _ConcretePairDriver(dict(window_p), dict(window_d)))
    outcomes = [(prob, dict(drv.pair_writes[False]),
                 dict(drv.pair_writes[True])) for prob, drv in runs]
    reach_p, reach_d = [0, 0], [0, 0]
    for _, drv in runs:
        for acc, seen in ((reach_p, drv.pair_reach[False]),
                          (reach_d, drv.pair_reach[True])):
            acc[0] = min(acc[0], seen[0])
            acc[1] = max(acc[1], seen[1])
    return outcomes, tuple(reach_p), tuple(reach_d)


def window_outcome_table(tag: str):
    """Outcome table over every concrete window of the rule's reach:
    returns ``(span_lo, span_hi, table)`` where ``table[rank]`` (rank =
    base-size_a encoding of the window, offsets span_lo..span_hi) is a
    list of ``(prob, writes)``. Outcomes with prob 0 are dropped and
    no-op writes pruned."""
    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    # Discover the reach on the all-zeros window, then grow until no
    # window extends it (branches may read further than the probe).
    lo, hi = enumerate_window_outcomes(problem, {0: 0})[1]
    while True:
        grew = False
        for syms in itertools.product(range(size_a),
                                      repeat=hi - lo + 1):
            window = dict(zip(range(lo, hi + 1), syms))
            _, (l2, h2) = enumerate_window_outcomes(problem, window)
            if l2 < lo or h2 > hi:
                lo, hi = min(lo, l2), max(hi, h2)
                grew = True
                break
        if not grew:
            break
    table = {}
    for rank, syms in enumerate(itertools.product(
            range(size_a), repeat=hi - lo + 1)):
        window = dict(zip(range(lo, hi + 1), syms))
        outs, _ = enumerate_window_outcomes(problem, window)
        entries = []
        for prob, writes in outs:
            if prob <= 0.0:
                continue
            writes = {k: v for k, v in writes.items()
                      if window[k] != v}
            if writes:
                entries.append((prob, writes))
        table[rank] = entries
    return lo, hi, table


def _ring_digits(L: int, size_a: int) -> np.ndarray:
    """``[size_a**L, L]`` base-``size_a`` digit decode of every ring
    state (digit 0 = leftmost site)."""
    S = size_a ** L
    digits = np.empty((S, L), dtype=np.int64)
    rem = np.arange(S, dtype=np.int64)
    for pos in range(L - 1, -1, -1):
        digits[:, pos] = rem % size_a
        rem //= size_a
    return digits


def _context_mpp(spd):
    """Conditional next-symbol probabilities ``[n_ctx, size_a]`` of an
    SPD's Markov extension (``spd`` in the ``(A,)*k`` layout), with the
    rows of contexts of zero probability zeroed, as the JAX package's
    `ops/correlations.context_arrays` builds them: `markov.mpp_from_spd`
    gives an impossible prefix a uniform row, which the cyclic trace
    would count as spurious cycles."""
    from .. import markov

    spd = np.asarray(spd, dtype=np.float64)
    if spd.ndim == 1:
        raise ValueError(
            "flat SPD is ambiguous: pass size_a= and cl_k= explicitly "
            "(or reshape to (size_a,)*cl_k)")
    size_a = spd.shape[-1]
    n_ctx = spd.size // size_a
    mpp = markov.mpp_from_spd(spd).reshape(n_ctx, size_a).copy()
    mpp[spd.reshape(n_ctx, size_a).sum(axis=-1) <= 1e-300, :] = 0.0
    return mpp


def ring_trace_measure(spd, size_a: int, cl_k: int, L: int):
    """Exact cyclic trace measure over ring states induced by an SPD's
    Markov extension — the law the circular-bridge sampler draws
    (`engine/ensemble.sample_tapes_from_spd(ring=True)`; the JAX
    package's `ops/correlations.pair_prob(ring=L)` normalises the same
    way). Lives here so the master-equation oracles compare against ONE
    construction of the initial law."""
    mpp = _context_mpp(spd)
    digits = _ring_digits(L, size_a)
    S = digits.shape[0]
    m = cl_k - 1
    w = np.ones(S)
    for i in range(L):
        ctx = np.zeros(S, dtype=np.int64)
        for j in range(i - m, i):
            ctx = ctx * size_a + digits[:, j % L]
        w *= mpp[ctx, digits[:, i]]
    return w / w.sum()


def build_ring_generator(tag: str, L: int, *, max_states: int = 2**21):
    """Sparse master-equation generator ``Q [S, S]`` over all
    ``S = size_a^L`` ring configurations (columns = from-state:
    dP/dt = Q @ P). Site ``i`` of state ``x`` fires at rate 1 and maps
    the window around it per the rule's outcome table; identity
    outcomes cancel and never enter Q.
    """
    import scipy.sparse as sp

    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    S = size_a ** L
    if S > max_states:
        raise ValueError(f"size_a^L = {S} exceeds max_states="
                         f"{max_states}")
    lo, hi, table = window_outcome_table(tag)
    if hi - lo >= L:
        raise ValueError(f"rule reach {hi - lo + 1} exceeds ring {L}")

    digits = _ring_digits(L, size_a)
    pow_ = size_a ** np.arange(L - 1, -1, -1).astype(np.int64)

    rows, cols, vals = [], [], []
    diag = np.zeros(S)
    offs = np.arange(lo, hi + 1)
    for i in range(L):
        # window rank at site i for every state
        w_pos = (i + offs) % L
        w_rank = np.zeros(S, dtype=np.int64)
        for p in w_pos:
            w_rank = w_rank * size_a + digits[:, p]
        for rank, entries in table.items():
            if not entries:
                continue
            sel = np.nonzero(w_rank == rank)[0]
            if sel.size == 0:
                continue
            for prob, writes in entries:
                delta = np.zeros(sel.size, dtype=np.int64)
                for off, new in writes.items():
                    p = (i + off) % L
                    delta += (new - digits[sel, p]) * pow_[p]
                rows.append(sel + delta)
                cols.append(sel)
                vals.append(np.full(sel.size, prob))
                diag[sel] -= prob
    rows.append(np.arange(S))
    cols.append(np.arange(S))
    vals.append(diag)
    Q = sp.csr_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(S, S))
    return Q


def pair_outcome_table(tag: str, *, max_windows: int = 2**22):
    """Outcome table over every concrete (program, data) window pair
    of a TWO-TAPE rule: returns ``(span_p, span_d, table)`` where
    ``span_* = (lo, hi)`` and ``table[(rank_p, rank_d)]`` (each rank a
    base-size_a encoding over its tape's offsets lo..hi) is a list of
    ``(prob, writes_p, writes_d)``. Zero-probability outcomes are
    dropped and no-op writes pruned; window pairs whose every outcome
    is a no-op get an empty list.

    ``max_windows`` bounds ``size_a^(width_p + width_d)`` — each window
    pair costs one Python rule enumeration, so a wide-alphabet rule
    (ex4's 7 symbols) must fail fast instead of hanging the growth
    loop."""
    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    _, rp, rd = enumerate_pair_outcomes(problem, {0: 0}, {0: 0})
    lo_p, hi_p = rp
    lo_d, hi_d = rd

    def _check_width():
        n = size_a ** ((hi_p - lo_p + 1) + (hi_d - lo_d + 1))
        if n > max_windows:
            raise ValueError(
                f"{tag!r}: {n} concrete window pairs (size_a={size_a},"
                f" widths {hi_p - lo_p + 1}+{hi_d - lo_d + 1}) exceed"
                f" max_windows={max_windows}")

    _check_width()
    while True:
        grew = False
        for syms_p in itertools.product(range(size_a),
                                        repeat=hi_p - lo_p + 1):
            win_p = dict(zip(range(lo_p, hi_p + 1), syms_p))
            for syms_d in itertools.product(range(size_a),
                                            repeat=hi_d - lo_d + 1):
                win_d = dict(zip(range(lo_d, hi_d + 1), syms_d))
                _, rp, rd = enumerate_pair_outcomes(problem, win_p,
                                                    win_d)
                if (rp[0] < lo_p or rp[1] > hi_p
                        or rd[0] < lo_d or rd[1] > hi_d):
                    lo_p, hi_p = min(lo_p, rp[0]), max(hi_p, rp[1])
                    lo_d, hi_d = min(lo_d, rd[0]), max(hi_d, rd[1])
                    _check_width()
                    grew = True
                    break
            if grew:
                break
        if not grew:
            break
    table = {}
    for rank_p, syms_p in enumerate(itertools.product(
            range(size_a), repeat=hi_p - lo_p + 1)):
        win_p = dict(zip(range(lo_p, hi_p + 1), syms_p))
        for rank_d, syms_d in enumerate(itertools.product(
                range(size_a), repeat=hi_d - lo_d + 1)):
            win_d = dict(zip(range(lo_d, hi_d + 1), syms_d))
            outs, _, _ = enumerate_pair_outcomes(problem, win_p, win_d)
            entries = []
            for prob, wr_p, wr_d in outs:
                if prob <= 0.0:
                    continue
                wr_p = {k: v for k, v in wr_p.items()
                        if win_p[k] != v}
                wr_d = {k: v for k, v in wr_d.items()
                        if win_d[k] != v}
                if wr_p or wr_d:
                    entries.append((prob, wr_p, wr_d))
            if entries:
                table[(rank_p, rank_d)] = entries
    return (lo_p, hi_p), (lo_d, hi_d), table


def build_pair_ring_generator(tag: str, L: int, *,
                              max_states: int = 2**21):
    """Sparse master-equation generator over all
    ``S = size_a^(2L)`` states of a (program ring, data ring) PAIR —
    the exact microscopic law of a two-tape rule on concrete tethered
    tapes (combined state index = rank_p * size_a^L + rank_d). Site
    ``i`` fires at rate 1 and applies the rule's pair outcome table to
    BOTH windows around it (the ensemble's semantics: one site, two
    tapes). Columns = from-state: dP/dt = Q @ P."""
    import scipy.sparse as sp

    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    S = size_a ** (2 * L)
    if S > max_states:
        raise ValueError(f"size_a^(2L) = {S} exceeds max_states="
                         f"{max_states}")
    (lo_p, hi_p), (lo_d, hi_d), table = pair_outcome_table(tag)
    if hi_p - lo_p >= L or hi_d - lo_d >= L:
        raise ValueError(
            f"rule reach p={hi_p - lo_p + 1}/d={hi_d - lo_d + 1} "
            f"exceeds ring {L}")

    # Combined digits: columns 0..L-1 = program ring, L..2L-1 = data.
    digits = _ring_digits(2 * L, size_a)
    pow_ = size_a ** np.arange(2 * L - 1, -1, -1).astype(np.int64)
    n_dwin = size_a ** (hi_d - lo_d + 1)

    rows, cols, vals = [], [], []
    diag = np.zeros(S)
    offs_p = np.arange(lo_p, hi_p + 1)
    offs_d = np.arange(lo_d, hi_d + 1)
    keys = sorted(table)
    for i in range(L):
        w_rank_p = np.zeros(S, dtype=np.int64)
        for off in offs_p:
            w_rank_p = w_rank_p * size_a + digits[:, (i + off) % L]
        w_rank_d = np.zeros(S, dtype=np.int64)
        for off in offs_d:
            w_rank_d = (w_rank_d * size_a
                        + digits[:, L + (i + off) % L])
        # One stable sort groups the states by composite window key;
        # per-key nonzero scans over S would be O(S · n_keys).
        w_key = w_rank_p * n_dwin + w_rank_d
        order = np.argsort(w_key, kind="stable")
        sorted_keys = w_key[order]
        for (rank_p, rank_d) in keys:
            kk = rank_p * n_dwin + rank_d
            a = np.searchsorted(sorted_keys, kk, side="left")
            b = np.searchsorted(sorted_keys, kk, side="right")
            if a == b:
                continue
            sel = order[a:b]
            for prob, wr_p, wr_d in table[(rank_p, rank_d)]:
                delta = np.zeros(sel.size, dtype=np.int64)
                for off, new in wr_p.items():
                    p = (i + off) % L
                    delta += (new - digits[sel, p]) * pow_[p]
                for off, new in wr_d.items():
                    p = L + (i + off) % L
                    delta += (new - digits[sel, p]) * pow_[p]
                rows.append(sel + delta)
                cols.append(sel)
                vals.append(np.full(sel.size, prob))
                diag[sel] -= prob
    rows.append(np.arange(S))
    cols.append(np.arange(S))
    vals.append(diag)
    Q = sp.csr_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(S, S))
    return Q


def build_conditioned_ring_generator(tag: str, program_ring, *,
                                     max_states: int = 2**21):
    """Sparse master-equation generator over the ``S = size_a^L``
    DATA-ring states of a two-tape rule, conditioned on one concrete
    (frozen) PROGRAM ring.

    Exact whenever the rule never writes the program tape (checked per
    outcome): given the program ring, the data ring is then itself a
    Markov jump process and this Q is its full master equation — the
    microscopic oracle for read-only-program machines (the mini-BFF
    family, `engine/bff.py`) whose PAIR state space ``size_a^(2L)``
    is far out of reach at any useful L. Site ``i`` fires at rate 1;
    ``dP/dt = Q @ P`` with columns = from-state, the same conventions
    as :func:`build_ring_generator` (so :func:`solve_master`,
    :func:`discrete_survival`, and :func:`state_window_marginals`
    apply unchanged).

    Windows handed to the rule cover the whole ring with a generous
    aliased offset range (offset ``o`` reads ring cell ``(i+o) % L``),
    so reads can never escape the window and no reach-growth loop is
    needed; write offsets are asserted distinct modulo L.
    """
    import scipy.sparse as sp

    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    pr = [int(s) for s in program_ring]
    L = len(pr)
    S = size_a ** L
    if S > max_states:
        raise ValueError(f"size_a^L = {S} exceeds max_states="
                         f"{max_states}")
    digits = _ring_digits(L, size_a)
    pow_ = size_a ** np.arange(L - 1, -1, -1).astype(np.int64)
    win_offs = range(-4 * L, 4 * L + 1)

    rows, cols, vals = [], [], []
    diag = np.zeros(S)
    for i in range(L):
        window_p = {o: pr[(i + o) % L] for o in win_offs}
        for s in range(S):
            window_d = {o: int(digits[s, (i + o) % L])
                        for o in win_offs}
            outcomes, _, _ = enumerate_pair_outcomes(
                problem, window_p, window_d)
            for prob, wr_p, wr_d in outcomes:
                if prob <= 0.0:
                    continue
                if wr_p:
                    raise ValueError(
                        f"{tag!r} wrote the program tape at site {i}; "
                        "the conditioned-ring generator is only exact "
                        "for read-only-program rules")
                cells = {(i + o) % L for o in wr_d}
                if len(cells) != len(wr_d):
                    raise ValueError(
                        f"{tag!r}: write offsets alias modulo L={L}; "
                        "use a longer ring")
                tgt = s
                for o, new in wr_d.items():
                    p = (i + o) % L
                    tgt += (new - int(digits[s, p])) * int(pow_[p])
                if tgt != s:
                    rows.append(tgt)
                    cols.append(s)
                    vals.append(prob)
                    diag[s] -= prob
    Q = sp.csr_matrix(
        (np.concatenate([np.asarray(vals, dtype=np.float64), diag]),
         (np.concatenate([np.asarray(rows, dtype=np.int64),
                          np.arange(S)]),
          np.concatenate([np.asarray(cols, dtype=np.int64),
                          np.arange(S)]))),
        shape=(S, S))
    return Q


def pair_state_window_marginals(p_states, L: int, size_a: int,
                                cl_k: int):
    """Translation-averaged JOINT window distribution of a pair-ring
    state distribution: per-site combined symbol
    ``c = p_sym * size_a + d_sym`` (alphabet size_a²), window rank
    base-size_a² over ``cl_k`` consecutive sites — directly comparable
    to ``ensemble.weighted_window_counts(ptape * size_a + dtape, ...,
    size_a**2, cl_k)``."""
    digits = _ring_digits(2 * L, size_a)
    comb = digits[:, :L] * size_a + digits[:, L:]
    A = size_a * size_a
    S = comb.shape[0]
    out = np.zeros(A ** cl_k)
    for i in range(L):
        rank = np.zeros(S, dtype=np.int64)
        for j in range(cl_k):
            rank = rank * A + comb[:, (i + j) % L]
        np.add.at(out, rank, p_states)
    return out / L


def ring_contains_pattern(L: int, size_a: int, pattern) -> np.ndarray:
    """[size_a^L] bool: does ``pattern`` occur (circularly) anywhere on
    each ring state? The state-space mirror of
    `ensemble.contains_pattern`."""
    digits = _ring_digits(L, size_a)
    S = digits.shape[0]
    hit = np.zeros(S, dtype=bool)
    for i in range(L):
        m = np.ones(S, dtype=bool)
        for j, s in enumerate(pattern):
            m &= digits[:, (i + j) % L] == int(s)
        hit |= m
    return hit


def pair_ring_contains_pattern(L: int, size_a: int, pattern, *,
                               data_tape: bool = True) -> np.ndarray:
    """[size_a^(2L)] bool: does ``pattern`` occur (circularly) on the
    chosen tape of each (program, data) pair state? The pair-state
    mirror of `ensemble.contains_pattern`, for two-tape first-passage
    oracles via :func:`discrete_survival` with a pair generator.

    The pair index is ``rank_p * size_a**L + rank_d``, so a mask that
    only reads one tape is the single-tape mask tiled (data tape: low
    digits) or repeated (program tape: high digits) across the other
    tape's axis — no size_a^(2L) rescan needed."""
    single = ring_contains_pattern(L, size_a, pattern)
    reps = size_a ** L
    return np.tile(single, reps) if data_tape else np.repeat(single, reps)


def discrete_survival(Q, p0, hit_mask, rounds: int, L: int):
    """EXACT first-passage survival curve under the ensemble's own
    detection semantics: `ensemble.first_passage_times` checks the
    pattern after each E=1 round (kernel K = I + Q/L), so
    ``S[r] = P(pattern-free through round r)`` is the mass that stays
    in pattern-free states under the projected kernel
    ``P_free · K · P_free`` — with ``S[0]`` the initial pattern-free
    mass (the t=0 check). Members hit earlier keep evolving in the
    ensemble; the survival functional only needs the projected flow."""
    keep = ~np.asarray(hit_mask, dtype=bool)  # bool coercion: ~ on an
    # int 0/1 mask would give all-nonzero values and never project
    p = np.where(keep, np.asarray(p0, dtype=np.float64), 0.0)
    out = [p.sum()]
    for _ in range(rounds):
        p = p + (Q @ p) / L
        p = np.where(keep, p, 0.0)
        out.append(p.sum())
    return np.asarray(out)


def ring_gibbs_states(L: int, *, J_eff: float, h: float, beta: float):
    """Exact Gibbs distribution over 2^L ring spin states (symbol 0 =
    spin −1), the detailed-balance stationary law of the ex2 family."""
    S = 2 ** L
    digits = ((np.arange(S)[:, None] >>
               np.arange(L - 1, -1, -1)[None, :]) & 1)
    s = digits * 2.0 - 1.0
    energy = -J_eff * (s * np.roll(s, -1, axis=1)).sum(axis=1) \
        - h * s.sum(axis=1)
    w = np.exp(-beta * (energy - energy.min()))
    return w / w.sum()


def solve_master(Q, p0, ts):
    """Evolves the master equation with scipy's Krylov ``expm_multiply``
    (exact linear propagation, no time-step error at the output times).
    Returns ``[len(ts), S]``."""
    import scipy.sparse.linalg as spla

    ts = np.asarray(ts, dtype=np.float64)
    out = [np.asarray(p0, dtype=np.float64)]
    for dt in np.diff(ts):
        out.append(spla.expm_multiply(Q * dt, out[-1]))
    return np.stack(out)


def state_window_marginals(p_states, L: int, size_a: int, cl_k: int):
    """Translation-averaged length-``cl_k`` window distribution of a
    ring-state distribution — the quantity the closure evolves, here
    exact at finite L."""
    S = p_states.shape[-1]
    digits = _ring_digits(L, size_a)
    out = np.zeros(size_a ** cl_k)
    for i in range(L):
        rank = np.zeros(S, dtype=np.int64)
        for j in range(cl_k):
            rank = rank * size_a + digits[:, (i + j) % L]
        np.add.at(out, rank, p_states)
    return out / L
