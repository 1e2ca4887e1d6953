"""Symbolic expansion of the window-sweep accumulator (Python).

Counterpart of the JAX package's `engine/accumulate.py`, the oracle of
the port's C++ expander (`csrc/expander.cc`, `engine/native.py`), which
`compile.compile_problem` runs unless asked for this one.

This is a compile-time port of the reference's fast accumulation recursion
`lr-rec-extend-1` (`tape_multiverse.scm:1249-1401`): given a terminal
world's revealed window pair ``(i_orig, i_adj, length)`` it slides /
extends length-``cl_k`` reading frames over every window overlapping a
changed cell, weighting each probabilistic extension step by the
marginal-ratio ``P(longer) / P(shorter)`` (`:1263-1269`).

Instead of accumulating numbers it emits symbolic :class:`Event` records:
``(target_orig, target_adj, ((num_idx, den_idx), ...))`` — at runtime each
event contributes ``± world_weight · Π ratio_j`` to the dy/dt vector.
Recursion guards of the form ``ratio > 0`` in the reference simply become
zero factors here (a zero factor annihilates the whole event, which is the
same arithmetic the pruned traversal produces).

Expansions depend only on the window signature, so they are memoized and
shared by every world with the same signature (`compile.py` exploits this
by summing world weights per signature *before* applying event factors).
"""

from __future__ import annotations

import dataclasses
import functools

from ..markov import pyramid_offsets


@dataclasses.dataclass(frozen=True)
class Event:
    target_orig: int
    target_adj: int
    factors: tuple[tuple[int, int], ...]  # (num_idx, den_idx) into pyramid


class Expander:
    def __init__(self, size_a: int, cl_k: int):
        self.size_a = size_a
        self.cl_k = cl_k
        self.offsets, _ = pyramid_offsets(size_a, cl_k)
        self.window_mod = size_a**cl_k
        self.prefix_mod = size_a ** (cl_k - 1)

    def _ratio(self, idx_long: int, len_long: int, idx_short: int,
               len_short: int) -> tuple[int, int]:
        return (
            self.offsets[len_long] + idx_long,
            self.offsets[len_short] + idx_short,
        )

    @functools.lru_cache(maxsize=None)
    def expand(self, i_orig: int, i_adj: int,
               length: int) -> tuple[Event, ...]:
        """All accumulation events for one revealed-window signature."""
        events: list[Event] = []
        self._extend_le(
            events, (), i_orig, i_adj, length,
            do_right=length >= self.cl_k - 1,  # `:1398-1401`
        )
        return tuple(events)

    def _emit(self, events, factors, io, ia):
        # `accumulate-dp/dt` (`tape_multiverse.scm:1271-1301`): reduce to
        # the lowest cl_k digits, skip when the windows agree.
        o = io % self.window_mod
        a = ia % self.window_mod
        if o != a:
            events.append(Event(o, a, factors))

    def _extend_le(self, events, factors, io, ia, ln, do_right):
        # `extend-le` (`tape_multiverse.scm:1324-1397`).
        if io == ia:
            return
        A, cl_k = self.size_a, self.cl_k
        if ln < cl_k:
            # Left-extend the reading frame in every possible way.
            for s in range(A):
                sc = s * A**ln
                f = self._ratio(io + sc, ln + 1, io, ln)
                self._extend_le(
                    events, factors + (f,), io + sc, ia + sc, ln + 1,
                    do_right=(ln + 1 == cl_k - 1),
                )
        elif ln == cl_k:
            self._emit(events, factors, io, ia)
            # Left-shift the full frame: drop the rightmost symbol, draw a
            # new leftmost one.
            suf_o, suf_a = io // A, ia // A
            for s in range(A):
                sc = s * A ** (ln - 1)
                f = self._ratio(sc + suf_o, ln, suf_o, ln - 1)
                self._extend_le(
                    events, factors + (f,), sc + suf_o, sc + suf_a, ln,
                    do_right=False,
                )
        else:  # ln > cl_k: extra revealed digits left of the frame.
            self._emit(events, factors, io, ia)
            self._extend_le(
                events, factors, io // A, ia // A, ln - 1, do_right=False
            )
        if do_right:
            self._extend_ri(
                events, factors, io % self.prefix_mod, ia % self.prefix_mod
            )

    def _extend_ri(self, events, factors, po, pa):
        # `extend-ri-from-prefix` (`tape_multiverse.scm:1303-1322`).
        if po == pa:
            return
        A, cl_k = self.size_a, self.cl_k
        for s in range(A):
            io, ia = po * A + s, pa * A + s
            f = self._ratio(io, cl_k, po, cl_k - 1)
            fs = factors + (f,)
            self._emit(events, fs, io, ia)
            self._extend_ri(
                events, fs, io % self.prefix_mod, ia % self.prefix_mod
            )
