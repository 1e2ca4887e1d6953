"""Reaction-rule DSL and the problem registry.

Counterpart of the JAX package's `engine/dsl.py`.
A rule is a plain Python function ``rule(t)`` over a :class:`Tape`
context:

    @register_problem("ex1-radioactive-decay", symbols=("A", "B"))
    def ex1(t):
        if t.get_sym(DATA, 0) == "B":
            t.set_sym(DATA, 0, "A")

Rules must be *replayable*: deterministic given the values returned by
``t.get*`` and ``t.choose`` (no other sources of nondeterminism and no side
effects). The enumerator (`engine/enumerate.py`) re-executes them many
times; they never run on the device.

The reference's rate-parameter hooks (``params``, ``prepare``) serve its
gradient path, which this port has not reached; rules here run at fixed
rates.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

# Tape selectors, mirroring the reference's `data-tape?` boolean.
PROGRAM = False
DATA = True


@dataclasses.dataclass(frozen=True)
class Problem:
    tag: str
    symbols: tuple[str, ...]
    rule: Callable
    doc: str = ""

    @property
    def size_a(self) -> int:
        return len(self.symbols)

    def symbol_index(self, sym: str) -> int:
        return self.symbols.index(sym)

    def call(self, t) -> None:
        """Runs the rule on tape context ``t``."""
        self.rule(t)


_REGISTRY: dict[str, Problem] = {}


def register_problem(tag: str, symbols: Sequence[str], doc: str = ""):
    """Decorator registering a reaction rule under ``tag``."""

    def deco(fn):
        _REGISTRY[tag] = Problem(tag=tag, symbols=tuple(symbols), rule=fn,
                                 doc=doc or (fn.__doc__ or ""))
        return fn

    return deco


def get_problem(tag: str) -> Problem:
    _ensure_builtin_problems()
    if tag not in _REGISTRY:
        raise KeyError(
            f"Unknown problem {tag!r}. Registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[tag]


def registered_problems() -> list[str]:
    _ensure_builtin_problems()
    return sorted(_REGISTRY)


_builtin_loaded = False


def _ensure_builtin_problems() -> None:
    """Loads the built-in problem library on first registry access."""
    global _builtin_loaded
    if not _builtin_loaded:
        _builtin_loaded = True
        from ..models import problems  # noqa: F401  (registers via decorator)


class Tape:
    """Execution context passed to reaction rules.

    Backed by a driver (the enumerator's replay machinery) that supplies
    the outcome of every tape reveal and every ``choose``.
    """

    def __init__(self, driver, symbols: tuple[str, ...]):
        self._driver = driver
        self._symbols = symbols
        self._index = {s: k for k, s in enumerate(symbols)}

    # Raw (alphabet-index) operations.
    def get(self, data_tape: bool, index: int) -> int:
        return self._driver.tape_get(bool(data_tape), int(index))

    def set(self, data_tape: bool, index: int, value: int) -> None:
        self._driver.tape_set(bool(data_tape), int(index), int(value))

    # Symbol-name sugar.
    def get_sym(self, data_tape: bool, index: int) -> str:
        return self._symbols[self.get(data_tape, index)]

    def set_sym(self, data_tape: bool, index: int, sym: str) -> None:
        self.set(data_tape, index, self._index[sym])

    def choose(self, weight_option_pairs):
        """Weighted nondeterministic choice.

        Takes ``[(weight, option), ...]``; weights are normalised by their
        sum in list order.
        """
        pairs = list(weight_option_pairs)
        total = 0.0
        for w, _ in pairs:
            total = total + w
        probs = [w / total for w, _ in pairs]
        options = [o for _, o in pairs]
        k = self._driver.choose(probs)
        return options[k]

    def vector_choose(self, probs, options):
        """Raw choice taking pre-normalised probabilities."""
        k = self._driver.choose([float(p) for p in probs])
        return list(options)[k]
