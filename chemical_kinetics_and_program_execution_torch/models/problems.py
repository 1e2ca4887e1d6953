"""The built-in reaction rules of the port.

Numpy-free copies of the JAX package's `models/problems.py`
registrations, with tape-access and ``choose`` ordering kept identical
so the enumerated multiverse matches branch for branch:

- the import-time canary and ``ex1-radioactive-decay``
  (reference `problems.scm:22-26`),
- ``ex2-ferromagnetic-chain`` (`problems.scm:30-55`),
- ``ex3-copolymerization`` and its variants 1 and 2
  (`problems.scm:59-181`),
- ``ex4-chemical-turing``, ``ex4var1-`` and ``ex4var2-chemical-turing``
  (`problems.scm:186-434`),
- ``ex5-msrtf-machine`` and ``ex5var1-`` (`problems.scm:439-527`),
- the mini-BFF register machine (`problems.scm:531-629`, repaired as in
  the JAX package): ``ex6-mini-bff`` at its faithful parameters (fuel
  10, heads 12 apart; not enumerable: compile it pruned, or with
  ``max_worlds``), ``-lite`` and ``-midi`` at enumerable depths, and the
  single-tape self-modifying ``ex6-mini-bff-self``, ``-self-lite`` and
  ``-self-midi``; each carries ``native_ex6`` or ``native_ex6_self``
  (fuel, d1_start) for the C++ enumerator (`engine/native.py`);
- ``fuzz-wide-specs``, the wide-spec stress rule (beyond the
  reference).

- the rate-parameter (``-p``) variants ``ex2-ferromagnetic-chain-p``,
  ``ex3var1-copolymerization-p``, ``ex3var2-copolymerization-p``,
  ``ex4-chemical-turing-p`` and ``ex4var2-chemical-turing-p`` for
  `engine/parametric.py`: their weights take floats at enumeration and
  float64 tensors at replay (`_exp`, `_max0`, `_min1`).
"""

from __future__ import annotations

import math

from ..engine.dsl import DATA, PROGRAM, register_problem


# --- Example 1: radioactive decay --------------------------------------------

@register_problem("__canary_problem_radioactive_decay", ("A", "B"))
def _canary(t):
    """Import-time smoke-test problem of the reference."""
    if t.get_sym(DATA, 0) == "B":
        t.set_sym(DATA, 0, "A")


@register_problem("ex1-radioactive-decay", ("A", "B"))
def ex1_radioactive_decay(t):
    if t.get_sym(DATA, 0) == "B":
        t.set_sym(DATA, 0, "A")


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


def _exp(x):
    """exp in Python floats for concrete inputs (enumeration speed), in
    torch for a tensor rate parameter (the parametric replay)."""
    if isinstance(x, (int, float)):
        return math.exp(x)
    import torch

    return torch.exp(x)


def _max0(x):
    if isinstance(x, (int, float)):
        return max(0.0, x)
    import torch

    # torch.maximum, not clamp: at x = 0 its derivative splits 0.5/0.5,
    # as jnp.maximum's in the JAX package (clamp passes it all).
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


@register_problem("ex2-ferromagnetic-chain-p", ("D", "U"),
                  params={"J": _EX2_J, "h": _EX2_H, "beta": _EX2_BETA})
def ex2_ferromagnetic_chain_parametric(t, params):
    """Parametric ex2: the physics of ``ex2-ferromagnetic-chain`` with
    (J, h, beta) as run-time rate parameters; the field branch written
    branch-free as exp(-2 beta max(0, +-h)), as in the JAX package."""
    J, h, beta = params["J"], params["h"], params["beta"]
    mid = t.get_sym(DATA, 0)
    left = t.get_sym(DATA, -1)
    right = t.get_sym(DATA, +1)
    energy_j = (1 if left == mid else -1) + (1 if mid == right else -1)
    factor_a = _exp(-(beta * J * (4 + 2 * energy_j)))
    factor_b = _exp(-2.0 * beta * _max0(h if mid == "U" else -h))
    p_flip = factor_a * factor_b
    if t.choose([(p_flip, True), (1.0 - p_flip, False)]):
        t.set_sym(DATA, 0, "D" if mid == "U" else "U")


# --- Example 3: copolymerization ---------------------------------------------

@register_problem("ex3-copolymerization", ("O", "A", "M", "N"))
def ex3_copolymerization(t):
    p0 = t.get_sym(PROGRAM, 0)
    if (p0 != "O" and t.get_sym(PROGRAM, -1) == "O"
            and t.get_sym(PROGRAM, +1) == "O"):
        # Isolated monomer on the P-tape.
        d0 = t.get_sym(DATA, 0)
        if ((p0 == "A" and d0 in ("M", "N"))
                or (d0 == "A" and p0 in ("M", "N"))):
            # Compatible monomers; try a chain end on a random side.
            i = t.choose([(1.0, -1), (1.0, +1)])
            if (t.get_sym(DATA, i) == "O"
                    and t.get_sym(DATA, 2 * i) == "O"):
                t.set_sym(PROGRAM, 0, "O")
                t.set_sym(DATA, i, p0)


@register_problem("ex3var1-copolymerization", ("O", "A", "M", "N"))
def ex3var1_copolymerization(t):
    """Variant 1: same-comonomer addition rejected 75% of the time."""
    p0 = t.get_sym(PROGRAM, 0)
    if (p0 != "O" and t.get_sym(PROGRAM, -1) == "O"
            and t.get_sym(PROGRAM, +1) == "O"):
        d0 = t.get_sym(DATA, 0)
        if ((p0 == "A" and d0 in ("M", "N"))
                or (d0 == "A" and p0 in ("M", "N"))):
            i = t.choose([(1.0, -1), (1.0, +1)])
            if (t.get_sym(DATA, i) == "O"
                    and t.get_sym(DATA, 2 * i) == "O"):
                if (p0 != "A" and t.get_sym(DATA, -i) == p0
                        and t.choose([(75.0, True), (25.0, False)])):
                    pass  # alternation preference: reject
                else:
                    t.set_sym(PROGRAM, 0, "O")
                    t.set_sym(DATA, i, p0)


@register_problem("ex3var2-copolymerization", ("O", "A", "M", "N"))
def ex3var2_copolymerization(t):
    """Variant 2: reversible depolymerization at chain ends at a 1:50
    relative rate."""
    p0 = t.get_sym(PROGRAM, 0)
    if p0 == "O":
        # Empty P-tape cell: try dissociation.
        if (t.get_sym(PROGRAM, -1) == "O"
                and t.get_sym(PROGRAM, +1) == "O"):
            d0 = t.get_sym(DATA, 0)
            if d0 != "O":
                d1_right = t.get_sym(DATA, 1)
                d1_left = t.get_sym(DATA, -1)
                if ((0 if d1_left == "O" else 1)
                        + (0 if d1_right == "O" else 1)) == 1:
                    # At a chain end; depolymerize at reduced rate.
                    if t.choose([(1.0, True), (50.0, False)]):
                        t.set_sym(PROGRAM, 0, d0)
                        t.set_sym(DATA, 0, "O")
    else:
        if (t.get_sym(PROGRAM, -1) == "O"
                and t.get_sym(PROGRAM, +1) == "O"):
            d0 = t.get_sym(DATA, 0)
            if ((p0 == "A" and d0 in ("M", "N"))
                    or (d0 == "A" and p0 in ("M", "N"))):
                i = t.choose([(1.0, -1), (1.0, +1)])
                if (t.get_sym(DATA, i) == "O"
                        and t.get_sym(DATA, 2 * i) == "O"):
                    t.set_sym(PROGRAM, 0, "O")
                    t.set_sym(DATA, i, p0)


@register_problem("ex3var1-copolymerization-p", ("O", "A", "M", "N"),
                  params={"q_reject": 0.75})
def ex3var1_copolymerization_parametric(t, params):
    """Parametric ex3var1: the alternation-preference rejection
    probability ``q_reject`` (default 3/4, the 75:25 weights) as a
    run-time rate parameter."""
    q = params["q_reject"]
    p0 = t.get_sym(PROGRAM, 0)
    if (p0 != "O" and t.get_sym(PROGRAM, -1) == "O"
            and t.get_sym(PROGRAM, +1) == "O"):
        d0 = t.get_sym(DATA, 0)
        if ((p0 == "A" and d0 in ("M", "N"))
                or (d0 == "A" and p0 in ("M", "N"))):
            i = t.choose([(1.0, -1), (1.0, +1)])
            if (t.get_sym(DATA, i) == "O"
                    and t.get_sym(DATA, 2 * i) == "O"):
                if (p0 != "A" and t.get_sym(DATA, -i) == p0
                        and t.choose([(q, True), (1.0 - q, False)])):
                    pass  # alternation preference: reject
                else:
                    t.set_sym(PROGRAM, 0, "O")
                    t.set_sym(DATA, i, p0)


@register_problem("ex3var2-copolymerization-p", ("O", "A", "M", "N"),
                  params={"k_rev": 1.0 / 50.0})
def ex3var2_copolymerization_parametric(t, params):
    """Parametric ex3var2: the chain-end depolymerization rate ``k_rev``
    relative to addition (default 1/50) as a run-time rate parameter."""
    k = params["k_rev"]
    p0 = t.get_sym(PROGRAM, 0)
    if p0 == "O":
        if (t.get_sym(PROGRAM, -1) == "O"
                and t.get_sym(PROGRAM, +1) == "O"):
            d0 = t.get_sym(DATA, 0)
            if d0 != "O":
                d1_right = t.get_sym(DATA, 1)
                d1_left = t.get_sym(DATA, -1)
                if ((0 if d1_left == "O" else 1)
                        + (0 if d1_right == "O" else 1)) == 1:
                    if t.choose([(k, True), (1.0, False)]):
                        t.set_sym(PROGRAM, 0, d0)
                        t.set_sym(DATA, 0, "O")
    else:
        if (t.get_sym(PROGRAM, -1) == "O"
                and t.get_sym(PROGRAM, +1) == "O"):
            d0 = t.get_sym(DATA, 0)
            if ((p0 == "A" and d0 in ("M", "N"))
                    or (d0 == "A" and p0 in ("M", "N"))):
                i = t.choose([(1.0, -1), (1.0, +1)])
                if (t.get_sym(DATA, i) == "O"
                        and t.get_sym(DATA, 2 * i) == "O"):
                    t.set_sym(PROGRAM, 0, "O")
                    t.set_sym(DATA, i, p0)


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
# Variant 1: thermodynamically neutral reverse reaction (note the flipped
# option order).
register_problem("ex4var1-chemical-turing", _EX4_SYMBOLS)(
    _ex4_rule([(1.0, True), (0.0, False)])
)


@register_problem("ex4-chemical-turing-p", _EX4_SYMBOLS,
                  params={"suppression": _EX4_SUPPRESSION})
def ex4_chemical_turing_parametric(t, params):
    """Parametric ex4: the reverse-reaction suppression factor (default
    0.05) as a run-time rate parameter; keep it in (0, 1) so the
    enumerated branch structure holds."""
    s = params["suppression"]
    _ex4_rule([(1.0 - s, False), (s, True)])(t)


# Variant 2: detachable evaluator with free-enthalpy rate bookkeeping. The
# rate tables are built at registration time with the reference's
# setup-error checks, and from tensor rate parameters (the parametric
# replay) without them, as the JAX package builds them from traced ones.

def _min1(x):
    if isinstance(x, (int, float)):
        return min(1.0, x)
    import torch

    # torch.minimum, not clamp: its derivative at x = 1 splits as
    # jnp.minimum's does.
    return torch.minimum(x, torch.ones((), dtype=x.dtype, device=x.device))


def _ex4var2_tables(beta, G_P, G_X, G_E, G_A, G_B, G_C, G_D):
    """The delta-G-derived rate tables; the setup-error checks run for
    concrete (Python number) parameters only."""
    concrete = all(isinstance(v, (int, float))
                   for v in (beta, G_P, G_X, G_E, G_A, G_B, G_C, G_D))
    delta_g_fastest = (G_B + G_X) - (G_A + G_P)

    def rate_factor(g_left, g_right):
        r = _exp(-(beta * (g_right - g_left - delta_g_fastest)))
        if concrete and r > 1.001:
            raise ValueError(
                "Setup error: Delta-G-fastest not actually fastest."
            )
        return _min1(r)

    def rate_choices(g_left, g_right):
        r = rate_factor(g_left, g_right)
        return [(r, True), (1 - r, False)]

    r_a = rate_factor(G_E, G_A)
    r_d = rate_factor(G_E, G_D)
    if concrete and r_a + r_d > 1.0:
        raise ValueError(
            "E->A+D rates too high to merge, given Delta-G-fastest."
        )
    return {
        "A+P->B+X": rate_choices(G_A + G_P, G_B + G_X),
        "B+X->A+P": rate_choices(G_B + G_X, G_A + G_P),
        "B+P->C+X": rate_choices(G_B + G_P, G_C + G_X),
        "C+X->B+P": rate_choices(G_C + G_X, G_B + G_P),
        "C+P->D+X": rate_choices(G_C + G_P, G_D + G_X),
        "D+X->C+P": rate_choices(G_D + G_X, G_C + G_P),
        "A->E": rate_choices(G_A, G_E),
        "D->E": rate_choices(G_D, G_E),
        "E->A+D": [(r_a, "A"), (r_d, "D"), (1.0 - r_a - r_d, False)],
    }


_EX4V2_G = {"beta": 1.0, "G_P": 6.0, "G_X": 0.0, "G_E": 1.0,
            "G_A": -1.0, "G_B": -1.0, "G_C": -1.0, "G_D": 1.5}
_EX4V2_RATES = _ex4var2_tables(**_EX4V2_G)
_CHOICE_IO = [(1.0, "I"), (1.0, "O")]
_CHOICE_11 = [(1.0, True), (1.0, False)]


def _ex4var2_rule(t, r):
    p0 = t.get_sym(PROGRAM, 0)
    if (p0 == "P" and _is_io(t.get_sym(DATA, 1))
            and _is_io(t.get_sym(DATA, 2)) and t.choose(_CHOICE_11)):
        d0 = t.get_sym(DATA, 0)
        if d0 == "A" and t.choose(r["A+P->B+X"]):
            t.set_sym(PROGRAM, 0, "X")
            t.set_sym(DATA, 0, "I")
            t.set_sym(DATA, 1, "B")
        elif d0 == "B" and t.choose(r["B+P->C+X"]):
            t.set_sym(PROGRAM, 0, "X")
            t.set_sym(DATA, 0, "O")
            t.set_sym(DATA, 1, "C")
        elif d0 == "C" and t.choose(r["C+P->D+X"]):
            t.set_sym(PROGRAM, 0, "X")
            t.set_sym(DATA, 0, "I")
            t.set_sym(DATA, 1, "D")
    elif (p0 == "X" and _is_io(t.get_sym(DATA, -1))
            and _is_io(t.get_sym(DATA, -2))):
        d0 = t.get_sym(DATA, 0)
        if d0 == "B" and t.choose(r["B+X->A+P"]):
            t.set_sym(PROGRAM, 0, "P")
            t.set_sym(DATA, 0, t.choose(_CHOICE_IO))
            t.set_sym(DATA, -1, "A")
        elif d0 == "C" and t.choose(r["C+X->B+P"]):
            t.set_sym(PROGRAM, 0, "P")
            t.set_sym(DATA, 0, t.choose(_CHOICE_IO))
            t.set_sym(DATA, -1, "B")
        elif d0 == "D" and t.choose(r["D+X->C+P"]):
            t.set_sym(PROGRAM, 0, "P")
            t.set_sym(DATA, 0, t.choose(_CHOICE_IO))
            t.set_sym(DATA, -1, "C")
    elif (p0 == "E" and _is_io(t.get_sym(DATA, 0))
            and _is_io(t.get_sym(DATA, +1))
            and _is_io(t.get_sym(DATA, -1)) and t.choose(_CHOICE_11)):
        a_d_f = t.choose(r["E->A+D"])
        if a_d_f == "A":
            t.set_sym(PROGRAM, 0, "S")
            t.set_sym(DATA, 0, "A")
        elif a_d_f == "D":
            t.set_sym(PROGRAM, 0, "S")
            t.set_sym(DATA, 0, "D")
    elif (p0 == "S" and _is_io(t.get_sym(DATA, +1))
            and _is_io(t.get_sym(DATA, -1))):
        d0 = t.get_sym(DATA, 0)
        if d0 == "A" and t.choose(r["A->E"]):
            t.set_sym(PROGRAM, 0, "E")
            t.set_sym(DATA, 0, t.choose(_CHOICE_IO))
        elif d0 == "D" and t.choose(r["D->E"]):
            t.set_sym(PROGRAM, 0, "E")
            t.set_sym(DATA, 0, t.choose(_CHOICE_IO))


_EX4V2_SYMBOLS = ("A", "B", "C", "D", "I", "O", "P", "X", "S", "E")


@register_problem("ex4var2-chemical-turing", _EX4V2_SYMBOLS)
def ex4var2_chemical_turing(t):
    _ex4var2_rule(t, _EX4V2_RATES)


@register_problem("ex4var2-chemical-turing-p", _EX4V2_SYMBOLS,
                  params=dict(_EX4V2_G),
                  prepare=lambda prm: _ex4var2_tables(**prm))
def ex4var2_chemical_turing_parametric(t, r):
    """Parametric ex4var2: the free-enthalpy landscape (seven G levels
    and beta) as run-time rate parameters, the rate tables rebuilt from
    them once a replay (the ``prepare`` hook)."""
    _ex4var2_rule(t, r)


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
register_problem("ex5var1-msrtf-machine", ("M", "S", "R", "T", "F"))(
    _ex5_rule(single_r_can_execute=True)
)


# --- Example 6: mini-BFF (repaired as in the JAX package) ---------------------

_EX6_SYMBOLS = ("lt", "gt", "cl", "cr", "minus", "plus", "dot", "comma",
                "bl", "br", "zero", "nop")


def _ex6_rule(fuel: int, d1_start: int = 12, *,
              code_tape: bool = PROGRAM, data_tape: bool = DATA):
    """The mini-BFF register machine as a DSL rule. ``code_tape`` /
    ``data_tape`` select where opcodes are fetched and where the data
    heads read/write."""

    def rule(t):
        def loop(budget, p_off, d0_off, d1_off, scan_mode):
            if budget == 0:
                return
            op = t.get_sym(code_tape, p_off)
            if scan_mode < 0:
                # Looking left for the (-scan_mode)-th '[' bracket.
                if op == "bl":
                    if scan_mode == -1:
                        loop(budget - 1, p_off + 1, d0_off, d1_off, 0)
                    else:
                        loop(budget - 1, p_off - 1, d0_off, d1_off,
                             scan_mode + 1)
                elif op == "br":
                    loop(budget - 1, p_off - 1, d0_off, d1_off,
                         scan_mode - 1)
                else:
                    loop(budget - 1, p_off - 1, d0_off, d1_off, scan_mode)
            elif scan_mode > 0:
                # Looking right for the scan_mode-th ']' bracket.
                if op == "br":
                    if scan_mode == 1:
                        loop(budget - 1, p_off + 1, d0_off, d1_off, 0)
                    else:
                        loop(budget - 1, p_off + 1, d0_off, d1_off,
                             scan_mode - 1)
                elif op == "bl":
                    loop(budget - 1, p_off + 1, d0_off, d1_off,
                         scan_mode + 1)
                else:
                    loop(budget - 1, p_off + 1, d0_off, d1_off, scan_mode)
            else:
                if op in ("lt", "gt"):
                    loop(budget - 1, p_off + 1,
                         d0_off + (-1 if op == "lt" else +1), d1_off, 0)
                elif op in ("cl", "cr"):
                    loop(budget - 1, p_off + 1, d0_off,
                         d1_off + (-1 if op == "cl" else +1), 0)
                elif op in ("plus", "minus"):
                    t.set(data_tape, d0_off,
                          (t.get(data_tape, d0_off)
                           + (1 if op == "plus" else -1))
                          % len(_EX6_SYMBOLS))
                    loop(budget - 1, p_off + 1, d0_off, d1_off, 0)
                elif op == "dot":
                    t.set(data_tape, d1_off, t.get(data_tape, d0_off))
                    loop(budget - 1, p_off + 1, d0_off, d1_off, 0)
                elif op == "comma":
                    t.set(data_tape, d0_off, t.get(data_tape, d1_off))
                    loop(budget - 1, p_off + 1, d0_off, d1_off, 0)
                elif op == "bl":
                    loop(budget - 1, p_off + 1, d0_off, d1_off,
                         +1 if t.get_sym(data_tape, d0_off) == "zero"
                         else 0)
                elif op == "br":
                    if t.get_sym(data_tape, d0_off) == "zero":
                        loop(budget - 1, p_off + 1, d0_off, d1_off, 0)
                    else:
                        loop(budget - 1, p_off - 1, d0_off, d1_off, -1)
                else:
                    loop(budget - 1, p_off + 1, d0_off, d1_off, 0)

        loop(fuel, 0, 0, d1_start, 0)

    return rule


# Faithful parameters (fuel 10, heads 12 apart): every tape reveal is a
# 12-way world split and copy ops reveal all intermediate cells, so the
# full multiverse is astronomically large; compile it pruned or with
# max_worlds set.
_ex6_faithful = _ex6_rule(fuel=10)
_ex6_faithful.native_ex6 = (10, 12)  # (fuel, d1_start) for the C++ twin
register_problem("ex6-mini-bff", _EX6_SYMBOLS)(_ex6_faithful)
# The "lite" variant keeps the full instruction set at an enumerable
# depth: fuel 2 and the second data head next to the first (some 13k
# execution paths).
_ex6_lite = _ex6_rule(fuel=2, d1_start=1)
_ex6_lite.native_ex6 = (2, 1)
register_problem("ex6-mini-bff-lite", _EX6_SYMBOLS)(_ex6_lite)
# The "midi" variant (fuel 4, heads 3 apart) sits between lite and
# faithful.
_ex6_midi = _ex6_rule(fuel=4, d1_start=3)
_ex6_midi.native_ex6 = (4, 3)
register_problem("ex6-mini-bff-midi", _EX6_SYMBOLS)(_ex6_midi)

# Single-tape SELF-MODIFYING variants: opcodes and data live on one ring,
# so plus/minus/comma/dot writes land in the instruction stream.
_ex6_self = _ex6_rule(fuel=10, code_tape=DATA, data_tape=DATA)
_ex6_self.native_ex6_self = (10, 12)
register_problem("ex6-mini-bff-self", _EX6_SYMBOLS)(_ex6_self)
_ex6_self_lite = _ex6_rule(fuel=2, d1_start=1,
                           code_tape=DATA, data_tape=DATA)
_ex6_self_lite.native_ex6_self = (2, 1)
register_problem("ex6-mini-bff-self-lite", _EX6_SYMBOLS)(_ex6_self_lite)
_ex6_self_midi = _ex6_rule(fuel=4, d1_start=3,
                           code_tape=DATA, data_tape=DATA)
_ex6_self_midi.native_ex6_self = (4, 3)
register_problem("ex6-mini-bff-self-midi", _EX6_SYMBOLS)(_ex6_self_midi)


# --- Wide-spec stress rule (beyond the reference) ------------------------------

_FUZZ_A = 12


@register_problem("fuzz-wide-specs", tuple(f"s{i}" for i in range(_FUZZ_A)))
def fuzz_wide_specs(t):
    """Stress rule with more than 63 deduplicated write specs and a
    choose: the arithmetic write values make most (a, b) windows produce
    a distinct (cells, values) spec, while the 3-cell window keeps every
    engine cross-checkable."""
    a = t.get(DATA, 0)
    b = t.get(DATA, 1)
    if t.choose([(0.7, True), (0.3, False)]):
        t.set(DATA, -1, (a + b) % _FUZZ_A)
        t.set(DATA, 0, (a * b + 7 * a + 1) % _FUZZ_A)
        t.set(DATA, 1, (a * a + 5 * b) % _FUZZ_A)
    else:
        t.set(DATA, -1, (a * a + 7 * b) % _FUZZ_A)
