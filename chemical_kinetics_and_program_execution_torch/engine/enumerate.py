"""Host-side multiverse enumeration (the compile-time half of the engine).

Counterpart of the JAX package's `engine/enumerate.py`.
The branch *structure* of a rule depends only on revealed symbol values
and choice indices, so the complete multiverse is enumerated once, by
re-executing the (deterministic, replayable) rule with an odometer over
decision sequences. Each completed execution path becomes a
:class:`World` carrying

- ``const``: the product of its choose-weights,
- ``factors``: the chain of conditional-extension probability ratios from
  tape reveals, as (numerator, denominator) index pairs into the flat
  marginal-pyramid buffer,
- per-tape window signatures, revealed cells and per-decision metadata,
  which the decision-machine compiler (`engine/ensemble.py`) reads.

Reveal semantics: one cell per reveal, direction given by the sign of the
requested index, context ranks over the ORIGINAL (pre-write) content at
effective context length ``min(cl_k, visible + 1)``.

Weight-threshold pruning (the reference's ``BeamGuide``) and its native
ex6 enumerator are not ported yet; ROADMAP.md lists them.
"""

from __future__ import annotations

import dataclasses

from ..markov import pyramid_offsets
from . import dsl


@dataclasses.dataclass
class World:
    const: float
    factors: tuple[tuple[int, int], ...]  # (num_idx, den_idx) into pyramid
    # per tape: (i_orig, i_adj, length); program tape first, data tape second
    tape_sigs: tuple[tuple[int, int, int], tuple[int, int, int]]
    decisions: tuple[int, ...] = ()
    # Site-aligned revealed cells per tape: (l_len, orig, adj) where list
    # offset i maps to tape index i - l_len.
    tape_cells: tuple[tuple[int, tuple[int, ...], tuple[int, ...]], ...] = ()
    # Per-decision metadata, aligned with ``decisions``:
    # ("reveal", data_tape?, site-relative cell index) or
    # ("choose", normalised weights tuple).
    decision_meta: tuple = ()
    # Per-factor tape provenance aligned with ``factors`` (True = data).
    factor_tapes: tuple[bool, ...] = ()


class _TapeState:
    """One tape's revealed region: contiguous interval [-l_len, r_len)."""

    __slots__ = ("l_len", "r_len", "orig", "adj")

    def __init__(self):
        self.l_len = 0
        self.r_len = 0
        # Contents in tape order, list offset i maps to tape index i - l_len.
        self.orig: list[int] = []
        self.adj: list[int] = []

    def covers(self, index: int) -> bool:
        return -self.l_len <= index < self.r_len

    def value(self, index: int) -> int:
        return self.adj[index + self.l_len]

    def signature(self, size_a: int) -> tuple[int, int, int]:
        io = ia = 0
        for s in self.orig:
            io = io * size_a + s
        for s in self.adj:
            ia = ia * size_a + s
        return io, ia, self.l_len + self.r_len


class _Replay:
    """Executes a rule once, consuming a decision prefix and extending it.

    Decision points are (in execution order) tape reveals (arity size_a)
    and chooses (arity = number of options). When the provided prefix is
    exhausted the driver takes branch 0 and records the arity, so that the
    caller can run a standard odometer over decision sequences.
    """

    def __init__(self, problem: dsl.Problem, size_a: int, cl_k: int,
                 prefix: list[int]):
        self.problem = problem
        self.size_a = size_a
        self.cl_k = cl_k
        self.offsets, _ = pyramid_offsets(size_a, cl_k)
        self.prefix = prefix
        self.values: list[int] = []
        self.arities: list[int] = []
        self.const = 1.0
        self.factors: list[tuple[int, int]] = []
        self.factor_tapes: list[bool] = []
        self.tapes = (_TapeState(), _TapeState())
        self.meta: list = []  # per-decision metadata (reveal/choose)

    def _decide(self, arity: int) -> int:
        i = len(self.values)
        k = self.prefix[i] if i < len(self.prefix) else 0
        self.values.append(k)
        self.arities.append(arity)
        return k

    def _reveal(self, tape: _TapeState, to_right: bool) -> None:
        a = self.size_a
        self.meta.append((
            "reveal",
            tape is self.tapes[1],
            tape.r_len if to_right else -(tape.l_len + 1),
        ))
        visible = tape.l_len + tape.r_len
        cl_eff = min(self.cl_k, visible + 1)
        ctx_len = cl_eff - 1
        # Context rank over the original content: last ctx_len symbols for
        # a right reveal, first ctx_len symbols for a left reveal.
        ctx = 0
        if ctx_len:
            seg = tape.orig[-ctx_len:] if to_right else tape.orig[:ctx_len]
            for s in seg:
                ctx = ctx * a + s
        k = self._decide(a)
        win = ctx * a + k if to_right else k * a**ctx_len + ctx
        self.factors.append(
            (self.offsets[cl_eff] + win, self.offsets[ctx_len] + ctx))
        self.factor_tapes.append(tape is self.tapes[1])
        if to_right:
            tape.orig.append(k)
            tape.adj.append(k)
            tape.r_len += 1
        else:
            tape.orig.insert(0, k)
            tape.adj.insert(0, k)
            tape.l_len += 1

    # --- driver interface used by dsl.Tape ---
    def tape_get(self, data_tape: bool, index: int) -> int:
        tape = self.tapes[1 if data_tape else 0]
        while not tape.covers(index):
            self._reveal(tape, to_right=index >= 0)
        return tape.value(index)

    def tape_set(self, data_tape: bool, index: int, value: int) -> None:
        self.tape_get(data_tape, index)  # ensure revealed (may branch)
        tape = self.tapes[1 if data_tape else 0]
        tape.adj[index + tape.l_len] = int(value)

    def choose(self, probs: list[float]) -> int:
        self.meta.append(("choose", tuple(float(x) for x in probs)))
        k = self._decide(len(probs))
        # Zero-weight branches are enumerated but contribute exactly zero.
        self.const *= max(0.0, probs[k])
        return k

    def run(self) -> World:
        t = dsl.Tape(self, self.problem.symbols)
        self.problem.call(t)
        return World(
            const=self.const,
            factors=tuple(self.factors),
            tape_sigs=(
                self.tapes[0].signature(self.size_a),
                self.tapes[1].signature(self.size_a),
            ),
            decisions=tuple(self.values),
            factor_tapes=tuple(self.factor_tapes),
            tape_cells=tuple(
                (tp.l_len, tuple(tp.orig), tuple(tp.adj))
                for tp in self.tapes
            ),
            decision_meta=tuple(self.meta),
        )


def enumerate_worlds(problem: dsl.Problem, cl_k: int,
                     max_worlds: int | None = None) -> list[World]:
    """Enumerates every execution path of ``problem`` at context length
    ``cl_k``.

    Cost is one rule re-execution per path (leaves of the decision tree,
    not internal nodes). ``max_worlds`` guards against unbounded problems.
    """
    worlds: list[World] = []
    prefix: list[int] = []
    while True:
        replay = _Replay(problem, problem.size_a, cl_k, prefix)
        worlds.append(replay.run())
        if max_worlds is not None and len(worlds) > max_worlds:
            raise RuntimeError(
                f"Problem {problem.tag!r} exceeds max_worlds={max_worlds} "
                f"execution paths at cl_k={cl_k}."
            )
        # Odometer: advance the deepest branch that still has options.
        values, arities = replay.values, replay.arities
        depth = len(values) - 1
        while depth >= 0 and values[depth] + 1 >= arities[depth]:
            depth -= 1
        if depth < 0:
            return worlds
        prefix = values[:depth] + [values[depth] + 1]
