"""The port's exact master equation (`engine/master.py`) against the JAX
package's, and the port's ensemble against it (CPU).

Every public function of the port's copy gives the JAX package's result:
outcome tables entry for entry, sparse generators entry for entry, ring
measures, marginals and survival curves exactly, `solve_master` to rtol
1e-12. Then the port's own ensemble (K10-K13's plain versions) passes
the master-equation gates of the JAX package's `tests/test_master.py`
at their settings, with the port's master equation as the oracle and the
port's generators for the draws.
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu.engine import dsl as jdsl
from chemical_kinetics_and_program_execution_tpu.engine import (
    master as jmaster,
)
from chemical_kinetics_and_program_execution_torch.engine import dsl as tdsl
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as tens,
)
from chemical_kinetics_and_program_execution_torch.engine import k1_source
from chemical_kinetics_and_program_execution_torch.engine import (
    master as tmaster,
)
from chemical_kinetics_and_program_execution_torch.models.initial_states import (  # noqa: E501
    ferromagnet_p0,
)
from tests.test_fuzz import _gen_program, _run_program

EX2 = "ex2-ferromagnetic-chain"
EX3 = "ex3-copolymerization"


def _register_both(tag, symbols, rule):
    for reg in (jdsl, tdsl):
        if tag not in reg.registered_problems():
            reg.register_problem(tag, symbols)(rule)
    return tag


def _write_only(t):
    t.set(True, 0, 1)


def _cross_tape_write(t):
    v = t.get(True, 0)
    t.set(False, 0, 1 - v)


_WRITE_ONLY = _register_both("torch-port-master-write-only", ("a", "b"),
                             _write_only)
_CROSS = _register_both("torch-port-master-cross-write", ("a", "b"),
                        _cross_tape_write)


def _pin_data(stmts):
    """The JAX package's `tests/test_master.py` transform of a fuzz
    program onto the data tape alone."""
    out = []
    for s in stmts:
        if s[0] == "get_branch":
            out.append((s[0], True, s[2], [_pin_data(b) for b in s[3]]))
        elif s[0] == "choose_branch":
            out.append((s[0], s[1], [_pin_data(b) for b in s[2]]))
        elif s[0] == "set":
            out.append((s[0], True, s[2], s[3]))
        else:
            out.append((s[0], True, s[2], True, s[4]))
    return out


def _port_fuzz(seed, size_a, *, single_tape):
    """The fuzz rule of the JAX package's tests (the same program from the
    same seed): `_fuzz-master-*` for the single-tape gate
    (tests/test_master.py:161), `_fuzz-*` for the two-tape one
    (tests/test_fuzz.py:83), registered in both registries (the port's
    rules stay a subset of the JAX package's)."""
    if single_tape:
        tag = f"_fuzz-master-{size_a}-{seed}"
        prog = _pin_data(_gen_program(np.random.RandomState(7000 + seed),
                                      size_a, depth=2))
    else:
        tag = f"_fuzz-{size_a}-{seed}"
        prog = _gen_program(np.random.RandomState(seed), size_a, depth=2)

    def rule(t, prog=prog, size_a=size_a):
        _run_program(t, prog, size_a)

    return _register_both(tag, tuple(f"S{i}" for i in range(size_a)), rule)


def _sparse_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def _spd(cl_k, p_pair):
    return np.asarray(ferromagnet_p0(cl_k, p_pair=p_pair)).reshape(
        (2,) * cl_k)


# --- Every function equal to the JAX package's ---------------------------------------


@pytest.mark.parametrize("tag", [EX2, "ex1-radioactive-decay", _WRITE_ONLY])
def test_window_outcome_tables_match_jax(tag):
    assert tmaster.window_outcome_table(tag) == jmaster.window_outcome_table(
        tag)
    problem_t, problem_j = tdsl.get_problem(tag), jdsl.get_problem(tag)
    window = {-1: 1, 0: 0, 1: 1}
    got = tmaster.enumerate_window_outcomes(problem_t, window)
    want = jmaster.enumerate_window_outcomes(problem_j, window)
    assert got == want


def test_single_tape_scope_matches_jax():
    for tag in ("ex4-chemical-turing", _CROSS):
        with pytest.raises(ValueError, match="single-tape"):
            tmaster.window_outcome_table(tag)
    lo, hi, table = tmaster.window_outcome_table(_WRITE_ONLY)
    assert (lo, hi) == (0, 0) and table[0] == [(1.0, {0: 1})]


def test_pair_outcome_tables_match_jax():
    assert tmaster.pair_outcome_table(EX3) == jmaster.pair_outcome_table(EX3)
    wp, wd = {-1: 0, 0: 1, 1: 0}, {-2: 0, -1: 0, 0: 2, 1: 0, 2: 0}
    assert tmaster.enumerate_pair_outcomes(
        tdsl.get_problem(EX3), wp, wd) == jmaster.enumerate_pair_outcomes(
        jdsl.get_problem(EX3), wp, wd)


def test_generators_match_jax():
    """Single-ring, pair-ring and conditioned generators, entry for
    entry, and the pair generator on a single-tape rule."""
    _sparse_equal(tmaster.build_ring_generator(EX2, 8),
                  jmaster.build_ring_generator(EX2, 8))
    _sparse_equal(tmaster.build_pair_ring_generator(EX3, 5),
                  jmaster.build_pair_ring_generator(EX3, 5))
    _sparse_equal(tmaster.build_pair_ring_generator(EX2, 5),
                  jmaster.build_pair_ring_generator(EX2, 5))
    pr = np.random.default_rng(1).integers(0, 12, 3)
    _sparse_equal(
        tmaster.build_conditioned_ring_generator("ex6-mini-bff-lite", pr),
        jmaster.build_conditioned_ring_generator("ex6-mini-bff-lite", pr))
    with pytest.raises(ValueError, match="program tape"):
        tmaster.build_conditioned_ring_generator(EX3, [0, 1, 0, 2])


def test_measures_marginals_and_survival_match_jax():
    """The ring measure, window and joint window marginals, the pattern
    masks, the Gibbs states and the discrete survival curve: equal; the
    Krylov solve to rtol 1e-12."""
    spd = _spd(3, 0.1)
    L = 9
    p0 = tmaster.ring_trace_measure(spd, 2, 3, L)
    np.testing.assert_array_equal(
        p0, jmaster.ring_trace_measure(spd, 2, 3, L))
    Q = tmaster.build_ring_generator(EX2, L)
    ts = [0.0, 0.4, 1.5]
    got = tmaster.solve_master(Q, p0, ts)
    want = jmaster.solve_master(Q, p0, ts)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    for k in (2, 3):
        np.testing.assert_array_equal(
            tmaster.state_window_marginals(got[-1], L, 2, k),
            jmaster.state_window_marginals(got[-1], L, 2, k))
    for pattern in ((1, 1, 1), (0, 1), (1,) * 12):
        np.testing.assert_array_equal(
            tmaster.ring_contains_pattern(L, 2, pattern),
            jmaster.ring_contains_pattern(L, 2, pattern))
    hit = tmaster.ring_contains_pattern(L, 2, (1, 1, 1))
    np.testing.assert_array_equal(
        tmaster.discrete_survival(Q, p0, hit, 20, L),
        jmaster.discrete_survival(Q, p0, hit, 20, L))
    np.testing.assert_array_equal(
        tmaster.ring_gibbs_states(L, J_eff=2.0, h=-0.25, beta=1.0),
        jmaster.ring_gibbs_states(L, J_eff=2.0, h=-0.25, beta=1.0))
    Lp = 4
    rng = np.random.RandomState(2)
    pp = rng.rand(4 ** (2 * Lp))
    pp /= pp.sum()
    np.testing.assert_array_equal(
        tmaster.pair_state_window_marginals(pp, Lp, 4, 2),
        jmaster.pair_state_window_marginals(pp, Lp, 4, 2))
    for data_tape in (True, False):
        np.testing.assert_array_equal(
            tmaster.pair_ring_contains_pattern(Lp, 4, (1, 2),
                                               data_tape=data_tape),
            jmaster.pair_ring_contains_pattern(Lp, 4, (1, 2),
                                               data_tape=data_tape))


def test_generator_conserves_and_gibbs_is_stationary():
    L = 8
    Q = tmaster.build_ring_generator(EX2, L)
    assert np.abs(np.asarray(Q.sum(axis=0)).ravel()).max() < 1e-12
    pi = tmaster.ring_gibbs_states(L, J_eff=2.0, h=-0.25, beta=1.0)
    assert np.abs(Q @ pi).max() < 1e-15


def test_master_imports_no_jax():
    """The port's master equation and ensemble import neither jax nor the
    JAX package."""
    code = (
        "import sys\n"
        "from chemical_kinetics_and_program_execution_torch.engine import "
        "master, ensemble\n"
        "master.build_ring_generator('ex2-ferromagnetic-chain', 6)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'chemical_kinetics_and_program_execution_tpu'))]\n"
        "assert not bad, bad\n")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# --- The port's ensemble against the port's master equation ----------------------------


def _z_gate(reps, want, floor=None):
    reps = np.stack(reps)
    got = reps.mean(axis=0)
    sem = reps.std(axis=0, ddof=1) / np.sqrt(len(reps))
    scale = np.maximum(sem, 1e-6 if floor is None else floor)
    return float((np.abs(got - want) / scale).max()), got


def test_ensemble_dynamics_match_master():
    """tests/test_master.py:75 at its settings: ex2 from the ring measure
    of the pair SPD, L=12, E=1, 18 rounds with shared sites, 16 seeds of
    512 members, cl_k 3 marginals by `weighted_window_counts`: z < 6
    on the empirical scatter, and the dynamics moved."""
    size_a, cl_k, L = 2, 3, 12
    spd = _spd(cl_k, 0.1)
    p0 = tmaster.ring_trace_measure(spd, size_a, cl_k, L)
    Q = tmaster.build_ring_generator(EX2, L)
    rounds, E = 18, 1
    t_end = rounds * -math.log1p(-E / L)
    want = tmaster.state_window_marginals(
        tmaster.solve_master(Q, p0, [0.0, t_end])[-1], L, size_a, cl_k)
    dm = tens.compile_decision_machine(EX2)
    reps = []
    for kk in range(16):
        dtape = tens.sample_tapes_from_spd(2 * kk, spd, size_a, cl_k, 512,
                                           L, ring=True, device="cpu")
        (_, dtape), _ = tens.run_ensemble(
            2 * kk + 1, (np.zeros((512, L), np.int32), dtape), dm,
            (rounds, E), device="cpu")
        reps.append(tens.weighted_window_counts(
            dtape, np.full(512, 1 / 512), size_a, cl_k,
            device="cpu").numpy())
    z, _ = _z_gate(reps, want)
    assert z < 6.0, z
    start = tmaster.state_window_marginals(p0, L, size_a, cl_k)
    assert np.abs(want - start).max() > 1e-3


@pytest.mark.parametrize("seed", [0, 2])
def test_fuzz_rule_ensembles_match_master(seed):
    """tests/test_master.py:248 at its settings: a random single-tape
    rule, uniform rings, L=12, E=1, 12 rounds with independent sites
    (K11), 8 seeds of 512 members against the exact round kernel
    I + Q/L, z < 6 with the binomial floor."""
    size_a, L, B_k, cl_k, rounds = 2, 12, 512, 3, 12
    tag = _port_fuzz(seed, size_a, single_tape=True)
    dm = tens.compile_decision_machine(tag)
    assert L > 2 * dm.span
    Q = tmaster.build_ring_generator(tag, L)
    p = np.full(size_a**L, 1.0 / size_a**L)
    for _ in range(rounds):
        p = p + (Q @ p) / L
    want = tmaster.state_window_marginals(p, L, size_a, cl_k)
    reps = []
    for kk in range(8):
        g = torch.Generator().manual_seed(100 + 37 * seed + kk)
        dtape = torch.randint(0, size_a, (B_k, L), generator=g,
                              dtype=torch.int32)
        (_, dtape), _ = tens.run_ensemble(
            g, (np.zeros((B_k, L), np.int32), dtape), dm, (rounds, 1),
            independent_sites=True, device="cpu")
        reps.append(tens.weighted_window_counts(
            dtape, np.full(B_k, 1 / B_k), size_a, cl_k,
            device="cpu").numpy())
    floor = np.sqrt(np.maximum(want, 1e-9) * np.clip(1 - want, 0, 1)
                    / (8 * B_k * L / cl_k))
    z, got = _z_gate(reps, want, floor)
    assert z < 6.0, (seed, z)
    assert got[want > 1e-3].min() > 0.0


@pytest.mark.parametrize("seed,L", [(700, 8), (702, 10)])
def test_fuzz_pair_ensembles_match_master(seed, L):
    """tests/test_master.py:323 at its settings: random two-tape rules
    with independent sites. Seed 700 runs its decision machine (K11).
    Seed 702's machine has 155 write specs, more than K11's unit takes
    (128, `k1_source._check_lanes`), so it runs its transition table
    (K10), the path that test names for it. Joint windows against the
    pair kernel I + Q/L, z < 6 with the binomial floor."""
    size_a, cl_k, rounds, B_k = 2, 3, 12, 512
    tag = _port_fuzz(seed, size_a, single_tape=False)
    if seed == 702:
        rule = tens.device_table(tens.compile_transition_table(tag),
                                 device="cpu")
        with pytest.raises(ValueError, match="at most 128"):
            k1_source.k1_source(tens.compile_decision_machine(tag))
    else:
        rule = tens.compile_decision_machine(tag)
    assert L > 2 * rule.span
    Q = tmaster.build_pair_ring_generator(tag, L)
    S = size_a ** (2 * L)
    p = np.full(S, 1.0 / S)
    for _ in range(rounds):
        p = p + (Q @ p) / L
    want = tmaster.pair_state_window_marginals(p, L, size_a, cl_k)
    reps = []
    for kk in range(8):
        g = torch.Generator().manual_seed(900 + 41 * seed + kk)
        pt = torch.randint(0, size_a, (B_k, L), generator=g,
                           dtype=torch.int32)
        dt = torch.randint(0, size_a, (B_k, L), generator=g,
                           dtype=torch.int32)
        (pt, dt), _ = tens.run_ensemble(g, (pt, dt), rule, (rounds, 1),
                                        independent_sites=True, device="cpu")
        reps.append(tens.weighted_window_counts(
            pt * size_a + dt, np.full(B_k, 1 / B_k), size_a * size_a, cl_k,
            device="cpu").numpy())
    floor = np.sqrt(np.maximum(want, 1e-9) * np.clip(1 - want, 0, 1)
                    / (8 * B_k * L / cl_k))
    z, _ = _z_gate(reps, want, floor)
    assert z < 6.0, (seed, z)
    uni = tmaster.pair_state_window_marginals(np.full(S, 1.0 / S), L,
                                              size_a, cl_k)
    assert np.abs(want - uni).max() > 1e-3


def test_wide_rule_on_master_sized_ring_at_e1():
    """tests/test_master.py:396: ex3's width-5 window on an L=5 ring, one
    round from a concrete pair with independent sites, against the exact
    kernel column I + Q/L: total variation < 0.05."""
    size_a, L, B = 4, 5, 4096
    dm = tens.compile_decision_machine(EX3)
    assert dm.span == 5
    Q = tmaster.build_pair_ring_generator(EX3, L).tocsc()
    xp = np.array([0, 1, 0, 0, 0], np.int32)
    xd = np.array([0, 2, 0, 0, 0], np.int32)
    x = 0
    for v in np.concatenate([xp, xd]):
        x = x * size_a + int(v)
    (pt2, dt2), _ = tens.run_ensemble(
        3, (np.tile(xp, (B, 1)), np.tile(xd, (B, 1))), dm, (1, 1),
        independent_sites=True, device="cpu")
    ranks = np.zeros(B, np.int64)
    for tape in (pt2.numpy(), dt2.numpy()):
        for i in range(L):
            ranks = ranks * size_a + tape[:, i]
    emp = np.bincount(ranks, minlength=size_a ** (2 * L)) / B
    col = np.zeros(size_a ** (2 * L))
    col[x] = 1.0
    col += np.asarray(Q[:, x].todense()).ravel() / L
    assert 0.5 * np.abs(emp - col).sum() < 0.05
    assert col[x] < 1.0


def _survival_gate(curves, S_exact, B_k):
    curves = np.stack(curves)
    sem = curves.std(axis=0, ddof=1) / np.sqrt(len(curves))
    floor = np.sqrt(np.maximum(S_exact * (1 - S_exact), 1e-9)
                    / (len(curves) * B_k))
    return float((np.abs(curves.mean(axis=0) - S_exact)
                  / np.maximum(sem, floor)).max())


def test_first_passage_matches_absorbing_master():
    """tests/test_master.py:441: the survival curve of
    `first_passage_times` (K11 and K12's plain versions) on ex2 at L=12,
    E=1, 60 rounds, 16 seeds of 512, against the projected discrete
    kernel `discrete_survival`: z < 6."""
    size_a, cl_k, L, rounds = 2, 3, 12, 60
    pattern = (1, 1, 1)
    spd = _spd(cl_k, 0.3)
    p0 = tmaster.ring_trace_measure(spd, size_a, cl_k, L)
    hit = tmaster.ring_contains_pattern(L, size_a, pattern)
    Q = tmaster.build_ring_generator(EX2, L)
    S_exact = tmaster.discrete_survival(Q, p0, hit, rounds, L)
    assert S_exact[0] == 1.0 and S_exact[-1] < 0.85
    dm = tens.compile_decision_machine(EX2)
    dt_round = -math.log1p(-1 / L)
    curves = []
    for kk in range(16):
        dtape = tens.sample_tapes_from_spd(40 + 2 * kk, spd, size_a, cl_k,
                                           512, L, ring=True, device="cpu")
        t_hit, _, _ = tens.first_passage_times(
            41 + 2 * kk, (np.zeros((512, L), np.int32), dtape), dm, pattern,
            (rounds, 1), device="cpu")
        t_hit = t_hit.numpy()
        curves.append([float((t_hit >= dt_round * (r + 0.5)).mean())
                       for r in range(rounds + 1)])
    assert _survival_gate(curves, S_exact, 512) < 6.0


def test_two_tape_first_passage_matches_pair_kernel():
    """tests/test_master.py:497: first A-M bond on ex3 at L=5, data-tape
    detection, E=1, 60 rounds, 16 seeds of 512, against the pair
    kernel's discrete survival: z < 6."""
    size_a, L, rounds = 4, 5, 60
    pattern = (1, 2)
    P_PROG = np.array([0.6, 0.4, 0.0, 0.0])
    P_DATA = np.array([0.7, 0.0, 0.3, 0.0])

    def iid_ring(probs):
        d = tmaster._ring_digits(L, size_a)
        w = np.ones(size_a ** L)
        for i in range(L):
            w = w * probs[d[:, i]]
        return w

    p0 = np.kron(iid_ring(P_PROG), iid_ring(P_DATA))
    hit = tmaster.pair_ring_contains_pattern(L, size_a, pattern)
    Q = tmaster.build_pair_ring_generator(EX3, L)
    S_exact = tmaster.discrete_survival(Q, p0, hit, rounds, L)
    assert float(p0[hit].sum()) == 0.0
    assert 0.02 < 1.0 - S_exact[-1] < 0.9
    dm = tens.compile_decision_machine(EX3)
    dt_round = -math.log1p(-1 / L)
    curves = []
    for kk in range(16):
        g = torch.Generator().manual_seed(800 + kk)
        pt = torch.multinomial(torch.as_tensor(P_PROG), 512 * L, True,
                               generator=g).view(512, L).to(torch.int32)
        dt = torch.multinomial(torch.as_tensor(P_DATA), 512 * L, True,
                               generator=g).view(512, L).to(torch.int32)
        t_hit, _, _ = tens.first_passage_times(g, (pt, dt), dm, pattern,
                                               (rounds, 1), device="cpu")
        t_hit = t_hit.numpy()
        curves.append([float((t_hit >= dt_round * (r + 0.5)).mean())
                       for r in range(rounds + 1)])
    assert _survival_gate(curves, S_exact, 512) < 6.0
