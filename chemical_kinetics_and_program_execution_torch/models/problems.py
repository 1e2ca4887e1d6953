"""The built-in reaction rules the port's ensemble slice runs.

Numpy-free copies of three registrations of
the JAX package's `models/problems.py`, with
tape-access and ``choose`` ordering kept identical so the enumerated
multiverse matches branch for branch:

- ``ex2-ferromagnetic-chain`` (reference `problems.scm:30-55`),
- ``ex4-chemical-turing`` (`problems.scm:186-244`),
- ``ex5-msrtf-machine`` (`problems.scm:439-527`).

The other rules (and the traced-parameter variants) arrive with the
slices that need them; ROADMAP.md lists them.
"""

from __future__ import annotations

import math

from ..engine.dsl import DATA, PROGRAM, register_problem


# --- Example 2: ferromagnetic chain ------------------------------------------

_EX2_J = 1.0
_EX2_H = -0.25
_EX2_BETA = 1.0


@register_problem("ex2-ferromagnetic-chain", ("D", "U"))
def ex2_ferromagnetic_chain(t):
    mid = t.get_sym(DATA, 0)
    left = t.get_sym(DATA, -1)
    right = t.get_sym(DATA, +1)
    energy_j = (1 if left == mid else -1) + (1 if mid == right else -1)
    factor_a = math.exp(-(_EX2_BETA * _EX2_J * (4 + 2 * energy_j)))
    # Field factor suppresses flips out of the field-favored orientation.
    if (_EX2_H > 0) == (mid == "U"):
        factor_b = math.exp(-(2 * _EX2_BETA * abs(_EX2_H)))
    else:
        factor_b = 1.0
    p_flip = factor_a * factor_b
    if t.choose([(p_flip, True), (1 - p_flip, False)]):
        t.set_sym(DATA, 0, "D" if mid == "U" else "U")


# --- Example 4: chemical Turing machine --------------------------------------

_EX4_SYMBOLS = ("A", "B", "C", "D", "I", "O", "P", "X", "S")


def _is_io(sym: str) -> bool:
    return sym in ("I", "O")


def _ex4_rule(reverse_suppression_choices):
    """The ex4 body; ``reverse_suppression_choices`` is the
    reverse-reaction suppression choice list."""

    def rule(t):
        p0 = t.get_sym(PROGRAM, 0)
        if p0 == "P" and t.choose([(1.0, True), (1.0, False)]):
            # powered -> de-powered: cursor advances, writes a bit.
            d0 = t.get_sym(DATA, 0)
            if (d0 == "A" and _is_io(t.get_sym(DATA, 1))
                    and _is_io(t.get_sym(DATA, 2))):
                t.set_sym(PROGRAM, 0, "X")
                t.set_sym(DATA, 0, "I")
                t.set_sym(DATA, 1, "B")
            elif (d0 == "B" and _is_io(t.get_sym(DATA, 1))
                    and _is_io(t.get_sym(DATA, 2))):
                t.set_sym(PROGRAM, 0, "X")
                t.set_sym(DATA, 0, "O")
                t.set_sym(DATA, 1, "C")
            elif (d0 == "C" and _is_io(t.get_sym(DATA, 1))
                    and _is_io(t.get_sym(DATA, 2))):
                t.set_sym(PROGRAM, 0, "X")
                t.set_sym(DATA, 0, "I")
                t.set_sym(DATA, 1, "D")
        elif p0 == "X":
            # de-powered -> powered: cursor retreats, erases a bit.
            d0 = t.get_sym(DATA, 0)
            if (d0 in ("B", "C", "D")
                    and _is_io(t.get_sym(DATA, -1))
                    and _is_io(t.get_sym(DATA, -2))
                    and ((d0 == "C" and t.get_sym(DATA, -1) == "O")
                         or (d0 != "C" and t.get_sym(DATA, -1) == "I"))
                    and t.choose(reverse_suppression_choices)):
                t.set_sym(PROGRAM, 0, "P")
                t.set_sym(DATA, 0, t.choose([(1.0, "I"), (1.0, "O")]))
                t.set_sym(DATA, -1, {"B": "A", "C": "B", "D": "C"}[d0])

    return rule


_EX4_SUPPRESSION = 0.05
register_problem("ex4-chemical-turing", _EX4_SYMBOLS)(
    _ex4_rule([(1.0 - _EX4_SUPPRESSION, False), (_EX4_SUPPRESSION, True)])
)


# --- Example 5: MSRTF machine ------------------------------------------------

def _ex5_rule(single_r_can_execute: bool):
    """Guaranteed-terminating mini machine language. Budget counter Q runs
    4 → -3; S arms execution; T copies P-tape → D-tape when armed; R
    increments the data cell mod 5; M re-runs the previous R/T op until the
    budget expires."""

    def rule(t):
        def loop(Q, Is, Ip, Id, Op, NT, NR, NF):
            op = t.get_sym(PROGRAM, Ip) if Q > 0 else Op
            if Q == 4:
                if op == "S":
                    loop(Q - 1, Is, Ip + 1, Id, op, 0, 0, 0)
                elif op == "R" and single_r_can_execute:
                    t.set(DATA, Id, (1 + t.get(DATA, Id)) % 5)
            elif op == "T":
                activated = NT > 0 and NF > 0
                if activated:
                    t.set(DATA, Id, t.get(PROGRAM, Is))
                if not (Q == 1 or Q == -3):
                    loop(Q - 1,
                         Is + 1 if activated else Is,
                         Ip + 1 if Q > 0 else Ip,
                         Id + 1 if activated else Id,
                         op, 1, NR, NF)
            elif op == "R":
                if NR > 0:
                    t.set(DATA, Id, (1 + t.get(DATA, Id)) % 5)
                if not (Q == 1 or Q == -3):
                    loop(Q - 1, Is, Ip + 1 if Q > 0 else Ip, Id, op,
                         NT, 1, NF)
            elif op == "F":
                if not (Q == 1 or Q == -3):
                    loop(Q - 1, Is, Ip + 1 if Q > 0 else Ip, Id, op,
                         NT, NR, 1)
            elif op == "M":
                if Op in ("R", "T"):
                    loop(-1, Is, Ip, Id, Op, NT, NR, NF)

        loop(4, 0, 0, 0, None, 0, 0, 0)

    return rule


register_problem("ex5-msrtf-machine", ("M", "S", "R", "T", "F"))(
    _ex5_rule(single_r_can_execute=False)
)
