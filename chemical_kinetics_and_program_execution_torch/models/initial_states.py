"""Initial sequence-probability distributions for the example problems.

Counterpart of the JAX package's `models/initial_states.py` (numpy, so
a copy): vectorised classifiers over the sorted symbol multiset of each
window, and `ferromagnet_p0_traced`, a torch function of the pair density
for the solves whose start is a parameter.

All other functions return a float64 array of shape ``[size_a]*cl_k``
summing to 1.
"""

from __future__ import annotations

import numpy as np


def _sorted_windows(size_a: int, cl_k: int) -> np.ndarray:
    """[A**k, k] array: each row the ascending-sorted symbols of window n."""
    idx = np.indices([size_a] * cl_k).reshape(cl_k, -1).T
    return np.sort(idx, axis=1)


def ferromagnet_p0(cl_k: int, p_pair: float = 0.01,
                   corrected: bool = False) -> np.ndarray:
    """Dilute up-pair initial state for the ferromagnetic chain.

    Windows containing one whole UU pair (at any interior offset) or a
    single boundary U get probability ``p_pair``; the all-D window absorbs
    the rest. ``corrected=True`` adds the ``p_pair**2`` cross-term window
    (U at both boundaries) and renormalises through the all-D entry — "the
    essential correction" of `ex2_ferromagnet_tape.py:55-65`; the plain
    variant matches `:43-52`.
    """
    p0 = np.zeros(2**cl_k, dtype=np.float64)
    for k in range(cl_k - 1):
        p0[0b11 << k] = p_pair
    p0[1] = p_pair
    p0[1 << (cl_k - 1)] = p_pair
    if corrected:
        p0[(1 << (cl_k - 1)) | 1] = p_pair**2
        p0[0] = 1.0 - p0.sum()
    else:
        p0[0] = 1.0 - p_pair * (cl_k + 1)
    return p0.reshape([2] * cl_k)


def ferromagnet_p0_traced(cl_k: int, p_pair):
    """`ferromagnet_p0(corrected=True)` as a torch function of ``p_pair``
    (a float or a 0-d float64 tensor, on whose device the result lies):
    the flat ``[2**cl_k]`` float64 tensor, built from torch ops so that
    a derivative in ``p_pair`` can flow through it."""
    import torch

    p_pair = torch.as_tensor(p_pair, dtype=torch.float64)
    idx = [0b11 << k for k in range(cl_k - 1)] + [1, 1 << (cl_k - 1)]
    p0 = torch.zeros(2**cl_k, dtype=torch.float64, device=p_pair.device)
    p0 = p0.index_put((torch.tensor(idx, device=p_pair.device),),
                      p_pair.expand(len(idx)))
    corner = (1 << (cl_k - 1)) | 1
    p0 = p0.index_put((torch.tensor([corner], device=p_pair.device),),
                      (p_pair**2).reshape(1))
    rest = 1.0 - p0.sum()
    return torch.cat([rest.reshape(1), p0[1:]])


def copolymerization_p0(cl_k: int, p_a: float = 0.02) -> np.ndarray:
    """Isolated dilute monomers in solvent (`ex3_copolymerization.py:38-53`).

    Windows with at most one non-O symbol: probability ``p_a`` if it is an
    A, ``p_a/2`` if an M or N; the all-O window absorbs the rest.
    Symbols: O=0, A=1, M=2, N=3.
    """
    size_a = 4
    sg = _sorted_windows(size_a, cl_k)
    p0 = np.zeros(size_a**cl_k, dtype=np.float64)
    at_most_one = (sg[:, :-1] == 0).all(axis=1)
    top = sg[:, -1]
    p0[at_most_one & (top == 1)] = p_a
    p0[at_most_one & (top >= 2)] = 0.5 * p_a
    p0[0] = 1.0 - cl_k * p_a * 2
    return p0.reshape([size_a] * cl_k)


def chemical_turing_p0(cl_k: int = 5, *, tape_fraction: float = 0.25,
                       cursor_fraction: float = 0.01,
                       powered_fraction: float = 0.05,
                       random01: bool = False) -> np.ndarray:
    """Solvent/powered/tape/cursor mixture for ex4 / ex4var1
    (`ex4_chemical_turing.py:44-83`).

    Symbols: A,B,C,D=0..3 (cursor states), I,O=4,5 (tape bits), P=6
    (powered), X=7 (spent), S=8 (solvent). Windows are classified by their
    sorted symbol multiset:

    - all-S, or one P in S: solvent phase, weights ``1-pf*cl_k`` / ``pf``
      (times ``1-tape_fraction``),
    - on-tape (symbols ≤ O): all-O or a single A cursor (``random01=False``),
      or uniform I/O mixtures with/without one A cursor (``random01=True``).
    """
    size_a, SYM_A, SYM_I, SYM_O, SYM_P, SYM_S = 9, 0, 4, 5, 6, 8
    sg = _sorted_windows(size_a, cl_k)
    p0 = np.zeros(size_a**cl_k, dtype=np.float64)
    rest_solvent = (sg[:, 1:] == SYM_S).all(axis=1)
    p0[rest_solvent & (sg[:, 0] == SYM_P)] = (
        (1 - tape_fraction) * powered_fraction
    )
    p0[rest_solvent & (sg[:, 0] == SYM_S)] = (
        (1 - tape_fraction) * (1 - powered_fraction * cl_k)
    )
    on_tape = (sg <= SYM_O).all(axis=1)
    if random01:
        cursor = (on_tape & (sg[:, 0] == SYM_A)
                  & (sg[:, 1:] >= SYM_I).all(axis=1))
        tape = on_tape & (sg >= SYM_I).all(axis=1)
        p0[cursor] = (
            tape_fraction * cursor_fraction * 0.5 ** (cl_k - 1)
        )
        p0[tape] = (
            tape_fraction * (1 - cursor_fraction * cl_k) * 0.5**cl_k
        )
    else:
        cursor = (on_tape & (sg[:, 0] == SYM_A)
                  & (sg[:, 1:] == SYM_O).all(axis=1))
        tape = (sg == SYM_O).all(axis=1)
        p0[cursor] = tape_fraction * cursor_fraction
        p0[tape] = tape_fraction * (1 - cursor_fraction * cl_k)
    return p0.reshape([size_a] * cl_k)


def chemical_turing_v2_p0(cl_k: int = 5, *, tape_fraction: float = 0.25,
                          cursor_fraction: float = 0.04,
                          powered_fraction: float = 0.1,
                          random01: bool = False) -> np.ndarray:
    """Evaluator-in-solution initial state for ex4var2
    (`ex4var2_chemical_turing.py:86-113`). Alphabet adds E=9 (detached
    evaluator); initially evaluators float in the solvent only.
    """
    size_a, SYM_I, SYM_O, SYM_P, SYM_S, SYM_E = 10, 4, 5, 6, 8, 9
    sg = _sorted_windows(size_a, cl_k)
    p0 = np.zeros(size_a**cl_k, dtype=np.float64)
    p0[(sg == SYM_S).all(axis=1)] = (1 - tape_fraction) * (
        1 - powered_fraction * cl_k - cursor_fraction * cl_k
    )
    p0[(sg[:, 1:] == SYM_S).all(axis=1) & (sg[:, 0] == SYM_P)] = (
        (1 - tape_fraction) * powered_fraction
    )
    p0[(sg[:, :-1] == SYM_S).all(axis=1) & (sg[:, -1] == SYM_E)] = (
        (1 - tape_fraction) * cursor_fraction
    )
    on_tape = (sg <= SYM_O).all(axis=1)
    if random01:
        p0[on_tape & (sg >= SYM_I).all(axis=1)] = (
            tape_fraction * 0.5**cl_k
        )
    else:
        p0[(sg == SYM_O).all(axis=1)] = tape_fraction
    return p0.reshape([size_a] * cl_k)


def msrtf_p0(cl_k: int = 5) -> np.ndarray:
    """Uniform distribution over the first three symbols M,S,R
    (`ex5_msrtf_machine.py:45-49`)."""
    size_a = 5
    p0 = np.zeros([size_a] * cl_k, dtype=np.float64)
    p0[(slice(0, 3),) * cl_k] = 3.0 ** (-cl_k)
    return p0
