"""Parity of the port's host instruments with the JAX package (CPU).

`ops/closure.py` (the Markov extension, the cross-cl_k consistency
oracle, the off-manifold defect, over the port's RHS on the CPU),
`ops/correlations.py` (exact correlators of the Markov extension) and
`engine/reference.py` (the slow reference dp/dt and the world dump,
which `markov_tapes.get_dy_dt(debug=True)` prints where the debug flag
is set). The same inputs go through both packages: the numpy modules
agree exactly, results through the RHS to rtol 1e-12. Then the twins of
`tests/test_closure_error.py` (4 tests), `tests/test_correlations.py`
(11) and `tests/test_engine.py::test_dump_worlds_debug_mode`, with the
port's functions and, for the bridge-sampler twin, the port's
generator; and `examples/ex2_closure_error.py`'s rows recomputed
through the port against the JAX package's (rtol 1e-8, atol 1e-14) and
the committed npz (atol 4e-9: the JAX package's own run stands 1.4e-9
from it).
"""

import itertools
import os

import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu import (
    markov_tapes as j_markov_tapes,
)
from chemical_kinetics_and_program_execution_tpu.engine import (
    reference as jreference,
)
from chemical_kinetics_and_program_execution_tpu.models.ferromagnet import (
    ising_gibbs_windows,
)
from chemical_kinetics_and_program_execution_tpu.ops import closure as jclosure
from chemical_kinetics_and_program_execution_tpu.ops import (
    correlations as jcorr,
)
from chemical_kinetics_and_program_execution_torch import (
    compile_problem,
    make_dy_dt,
    markov,
    markov_tapes,
)
from chemical_kinetics_and_program_execution_torch import engine as tengine
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as tens,
)
from chemical_kinetics_and_program_execution_torch.engine import reference
from chemical_kinetics_and_program_execution_torch.models.initial_states import (  # noqa: E501
    ferromagnet_p0,
)
from chemical_kinetics_and_program_execution_torch.ode.integrate import solve
from chemical_kinetics_and_program_execution_torch.ops import closure
from chemical_kinetics_and_program_execution_torch.ops import (
    correlations as corr,
)

EX2 = "ex2-ferromagnetic-chain"
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _random_markov_spd(size_a, cl_k, seed):
    """A valid SPD: stationary window distribution of a random
    order-(cl_k-1) Markov chain (contexts -> random conditional rows)."""
    rng = np.random.default_rng(seed)
    n_ctx = size_a ** (cl_k - 1)
    mpp = rng.random((n_ctx, size_a)) + 0.05
    mpp /= mpp.sum(axis=1, keepdims=True)
    nctx = (np.arange(n_ctx)[:, None] * size_a
            + np.arange(size_a)[None, :]) % n_ctx
    T = np.zeros((n_ctx, n_ctx))
    np.add.at(T, (np.repeat(np.arange(n_ctx), size_a), nctx.ravel()),
              mpp.ravel())
    lam, vecs = np.linalg.eig(T.T)
    pi = np.real(vecs[:, np.argmax(np.real(lam))])
    pi = np.abs(pi) / np.abs(pi).sum()
    return (pi[:, None] * mpp).reshape((size_a,) * cl_k)


def _lifted_chain(seed, cl_k=14):
    """An order-1 two-symbol chain lifted to cl_k windows (n_ctx 8192,
    above the dense gate) and its |lambda_2|."""
    rng = np.random.default_rng(seed)
    mpp1 = rng.random((2, 2)) + 0.2
    mpp1 /= mpp1.sum(axis=1, keepdims=True)
    ev, vecs = np.linalg.eig(mpp1.T)
    pi1 = np.real(vecs[:, np.argmax(np.real(ev))])
    pi1 = np.abs(pi1) / np.abs(pi1).sum()
    spd = pi1.copy()
    for _ in range(cl_k - 1):
        spd = spd[..., None] * mpp1[(None,) * (spd.ndim - 1) + (Ellipsis,)]
    return spd, float(np.sort(np.abs(np.linalg.eigvals(mpp1)))[0])


def _cpu_pair(tag, cl_k):
    size_a = tengine.dsl.get_problem(tag).size_a
    return (tengine.build_dy_dt(tag, cl_k, device="cpu")[0],
            tengine.build_dy_dt(tag, cl_k + 1, device="cpu")[0], size_a)


# --- ops/closure.py -----------------------------------------------------------------


@pytest.mark.parametrize("size_a,cl_k,seed", [(3, 3, 11), (2, 4, 2)])
def test_markov_extend_matches_jax(size_a, cl_k, seed):
    """The extension, real and complex-stepped, equals the JAX
    package's bit for bit."""
    spd = _random_markov_spd(size_a, cl_k, seed)
    np.testing.assert_array_equal(closure.markov_extend(spd, size_a, cl_k),
                                  jclosure.markov_extend(spd, size_a, cl_k))
    z = spd + 1j * 1e-200 * np.random.RandomState(seed).randn(*spd.shape)
    np.testing.assert_array_equal(closure.markov_extend(z, size_a, cl_k),
                                  jclosure.markov_extend(z, size_a, cl_k))


@pytest.mark.parametrize("tag,size_a,cl_k", [
    ("ex2-ferromagnetic-chain", 2, 3),
    ("ex3-copolymerization", 4, 3),
])
def test_closure_instruments_match_jax(tag, size_a, cl_k):
    """`consistency_residual`, `closure_defect` (three norms) and
    `integrate_defect` through the port's RHS against the JAX
    package's: residuals both at roundoff, defects to rtol 1e-12."""
    spd = _random_markov_spd(size_a, cl_k, seed=21)
    pair = _cpu_pair(tag, cl_k)
    assert closure.consistency_residual(tag, cl_k, spd,
                                        compiled_pair=pair) < 1e-13
    for norm in ("l1", "rms", "max"):
        np.testing.assert_allclose(
            closure.closure_defect(tag, cl_k, spd, compiled_pair=pair,
                                   norm=norm),
            jclosure.closure_defect(tag, cl_k, spd, norm=norm),
            rtol=1e-12, atol=1e-15)
    ys = np.stack([spd.ravel(), _random_markov_spd(size_a, cl_k, 5).ravel()])
    got = closure.integrate_defect(tag, cl_k, [0.0, 0.5], ys,
                                   compiled_pair=pair)
    want = jclosure.integrate_defect(tag, cl_k, [0.0, 0.5], ys)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="unknown norm"):
        closure.closure_defect(tag, cl_k, spd, compiled_pair=pair,
                               norm="l2")
    if not torch.cuda.is_available():  # the RHS goes to cuda unless named
        with pytest.raises(RuntimeError, match="device='cpu'"):
            closure.consistency_residual(tag, cl_k, spd)


def test_markov_extend_marginals_and_seq_prob():
    """Both (k)-marginals of the extension recover p, and extension
    word probabilities equal markov.seq_prob's long-sequence branch."""
    size_a, cl_k = 3, 3
    spd = _random_markov_spd(size_a, cl_k, seed=11)
    q = closure.markov_extend(spd, size_a, cl_k)
    np.testing.assert_allclose(q.sum(axis=-1), spd, rtol=1e-12, atol=1e-16)
    np.testing.assert_allclose(q.sum(axis=0), spd, rtol=1e-12, atol=1e-16)
    for word in [(0, 1, 2, 0), (2, 2, 1, 1), (1, 0, 0, 2)]:
        want = markov.seq_prob(spd, list(word))[0]
        np.testing.assert_allclose(q[word], want, rtol=1e-12, atol=1e-16)


@pytest.mark.parametrize("tag,size_a,cl_k", [
    ("ex1-radioactive-decay", 2, 3),
    ("ex2-ferromagnetic-chain", 2, 3),
    ("ex3-copolymerization", 4, 3),
    ("ex5-msrtf-machine", 5, 3),
])
def test_cross_cl_k_consistency_identity(tag, size_a, cl_k):
    """marg(F_{k+1}(extend(p))) == F_k(p) through the port's RHS at a
    random consistent state."""
    spd = _random_markov_spd(size_a, cl_k, seed=13)
    r = closure.consistency_residual(tag, cl_k, spd, norm="max",
                                     device="cpu")
    assert r < 1e-13, r


def test_defect_vanishes_at_exact_gibbs_root():
    """The Ising Gibbs measure is an order-1 Markov root of ex2: the
    consistency residual and the defect vanish."""
    spd = ising_gibbs_windows(3, J_eff=2.0, h=-0.25, beta=1.0)
    assert closure.consistency_residual(EX2, 3, spd, device="cpu") < 1e-13
    assert closure.closure_defect(EX2, 3, spd, device="cpu") < 1e-6


def _ex2_solve(k, ts, rtol, atol):
    fn = make_dy_dt(compile_problem(EX2, k), device="cpu")
    return fn, solve(lambda y, t: fn(y), ferromagnet_p0(k, p_pair=1 / 250)
                     .ravel(), ts, rtol=rtol, atol=atol, device="cpu")


def test_defect_positive_and_decreasing_in_cl_k_on_ex2():
    """Away from equilibrium the ex2 closure is inexact: the defect is
    positive at cl_k=3 and smaller at cl_k=4."""
    rates = {}
    for k in (3, 4):
        _, ys = _ex2_solve(k, np.array([0.0, 5.0]), 1e-10, 1e-13)
        rates[k] = closure.closure_defect(EX2, k, np.asarray(ys)[-1],
                                          device="cpu")
    assert rates[3] > 1e-6, rates
    assert rates[4] < 0.5 * rates[3], rates


def _closure_error_rows(make_fn, solve_fn, closure_mod, p0_fn):
    """`examples/ex2_closure_error.py`'s `compute` over one package."""
    ts = np.linspace(0.0, 20.0, 41)
    fns, ps = [], []
    for k in (3, 4):
        fn = make_fn(k)
        fns.append(fn)
        ps.append(np.asarray(solve_fn(lambda y, t, fn=fn: fn(y),
                                      p0_fn(k, p_pair=1 / 250).ravel(), ts)))
    nus, integ = closure_mod.integrate_defect(
        EX2, 3, ts, ps[0], compiled_pair=(fns[0], fns[1], 2))
    gaps = np.array([np.abs(ps[1][i].reshape((2,) * 4).sum(axis=-1).ravel()
                            - ps[0][i]).sum() for i in range(len(ts))])
    return ts, np.stack([nus, integ, gaps])


def test_ex2_closure_error_rows_match_artifact():
    """`examples/ex2_closure_error.py`'s computation through the port
    (cl_k 3 and 4 solved by the port's `solve` on the CPU at the
    example's 1e-11 and 1e-14, 41 samples, the defect integrated by the
    port's `closure`): its rows within rtol 1e-8, atol 1e-14 of the same
    computation by the JAX package, and within atol 4e-9 of the
    committed `examples/ex2_closure_error.npz`, from which the JAX
    package's own run on the CPU stands 1.4e-9 apart (3.7e-5 relative:
    the artifact's solve rounded otherwise); the example's gates (the
    integral conservative and within 10x)."""
    from chemical_kinetics_and_program_execution_tpu import (
        compile_problem as j_compile,
        make_dy_dt as j_make,
    )
    from chemical_kinetics_and_program_execution_tpu.models import (
        initial_states as j_init,
    )
    from chemical_kinetics_and_program_execution_tpu.ode import (
        integrate as j_integrate,
    )

    path = os.path.join(EXAMPLES, "ex2_closure_error.npz")
    if not os.path.exists(path):
        pytest.skip("run examples/ex2_closure_error.py first")
    d = np.load(path)
    ts, rows = _closure_error_rows(
        lambda k: make_dy_dt(compile_problem(EX2, k), device="cpu"),
        lambda f, y0, ts: solve(f, y0, ts, rtol=1e-11, atol=1e-14,
                                device="cpu"),
        closure, ferromagnet_p0)
    _, want = _closure_error_rows(
        lambda k: j_make(j_compile(EX2, k)),
        lambda f, y0, ts: j_integrate.solve(f, y0, ts, rtol=1e-11,
                                            atol=1e-14),
        jclosure, j_init.ferromagnet_p0)
    np.testing.assert_array_equal(d["ts"], ts)
    np.testing.assert_allclose(rows, want, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(rows, d["rows"], rtol=0, atol=4e-9)
    nus, integ, gaps = rows
    ratio = integ[1:] / gaps[1:]
    assert np.all(ratio >= 1.0) and np.all(ratio <= 10.0)


# --- ops/correlations.py ---------------------------------------------------------


def test_correlations_match_jax():
    """Context arrays, chain and ring pair probabilities, correlators,
    run lengths and correlation lengths (dense and Arnoldi) equal the
    JAX package's on the same inputs."""
    spd = _random_markov_spd(3, 3, seed=31)
    for got, want in zip(corr.context_arrays(spd), jcorr.context_arrays(spd)):
        np.testing.assert_array_equal(got, want)
    for ring in (None, 9):
        for a, b, d in [((0, (1, 2)), ((0, 1),), 3), ((2,), (1, 0), 1),
                        ((1, 1), (0,), 7)]:
            assert corr.pair_prob(spd, a, b, d, ring=ring) == \
                jcorr.pair_prob(spd, a, b, d, ring=ring)
        f = {(0,): 1.0, (1, 2): -0.5}
        np.testing.assert_array_equal(
            corr.observable_correlation(spd, f, f, [0, 1, 4], ring=ring),
            jcorr.observable_correlation(spd, f, f, [0, 1, 4], ring=ring))
        np.testing.assert_array_equal(
            corr.run_length_distribution(spd, (1, 2), [1, 2, 5], ring=ring),
            jcorr.run_length_distribution(spd, (1, 2), [1, 2, 5],
                                          ring=ring))
    assert corr.correlation_length(spd) == jcorr.correlation_length(spd)
    # Arnoldi starts from a random vector: both packages hold the
    # eigenvalue to its 1e-4 (`test_correlation_length_arnoldi_*`).
    big, _ = _lifted_chain(5)
    np.testing.assert_allclose(corr.correlation_length(big),
                               jcorr.correlation_length(big), rtol=1e-4)


def _brute_chain_pair(spd, seq_a, seq_b, d, size_a):
    n = max(len(seq_a), d + len(seq_b))
    total = 0.0
    for seq in itertools.product(range(size_a), repeat=n):
        if list(seq[:len(seq_a)]) != list(seq_a):
            continue
        if list(seq[d:d + len(seq_b)]) != list(seq_b):
            continue
        total += markov.seq_prob(spd, list(seq))[0]
    return total


def test_chain_pair_prob_matches_brute_force():
    size_a, cl_k = 2, 3
    spd = _random_markov_spd(size_a, cl_k, seed=0)
    for seq_a, seq_b, d in [
        ((0,), (1,), 0), ((0,), (1,), 1), ((0, 1), (1, 0), 1),
        ((0, 1), (1, 1), 3), ((1,), (0, 0), 5), ((0, 1, 0), (0,), 2),
    ]:
        got = corr.pair_prob(spd, seq_a, seq_b, d)
        want = _brute_chain_pair(spd, seq_a, seq_b, d, size_a)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert corr.pair_prob(spd, (0, 1), (0, 0), 1) == 0.0


def test_ring_pair_prob_matches_brute_force():
    size_a, cl_k, L = 2, 3, 8
    spd = _random_markov_spd(size_a, cl_k, seed=1)
    mpp, nctx, _ = corr.context_arrays(spd)
    m = cl_k - 1

    def ring_weight(seq):
        w = 1.0
        for i in range(L):
            ctx = 0
            for j in range(i - m, i):
                ctx = ctx * size_a + seq[j % L]
            w *= mpp[ctx, seq[i]]
        return w

    rings = list(itertools.product(range(size_a), repeat=L))
    weights = np.array([ring_weight(s) for s in rings])
    weights /= weights.sum()

    def brute(seq_a, seq_b, d):
        tot = 0.0
        for seq, w in zip(rings, weights):
            if any(seq[i % L] != s for i, s in enumerate(seq_a)):
                continue
            if any(seq[(d + i) % L] != s for i, s in enumerate(seq_b)):
                continue
            tot += w
        return tot

    for seq_a, seq_b, d in [
        ((0,), (1,), 1), ((0,), (1,), 4), ((0, 1), (1, 0), 3),
        ((0,), (0,), 7), ((0, 1, 0), (0, 1), 6),
    ]:
        got = corr.pair_prob(spd, seq_a, seq_b, d, ring=L)
        np.testing.assert_allclose(got, brute(seq_a, seq_b, d),
                                   rtol=1e-12, atol=1e-15)


def test_chain_correlator_factorises_at_large_d():
    spd = _random_markov_spd(3, 3, seed=2)
    pa = corr.word_prob(spd, (0, 2))
    pb = corr.word_prob(spd, (1,))
    got = corr.pair_prob(spd, (0, 2), (1,), 200)
    np.testing.assert_allclose(got, pa * pb, rtol=1e-12)
    c = corr.observable_correlation(spd, {(0, 2): 1.0}, {(1,): 1.0}, [200])
    assert abs(c[0]) < 1e-13


def test_ising_spin_correlator_and_length_match_closed_form():
    """1D Ising at field 0: <s_0 s_d> = tanh(beta*J_eff)^d and
    xi = -1/ln tanh(beta*J_eff)."""
    beta, j_eff = 0.7, 2.0
    spd = ising_gibbs_windows(3, J_eff=j_eff, h=0.0, beta=beta)
    spin = {(0,): -1.0, (1,): 1.0}
    ds = [1, 2, 3, 5, 10]
    got = corr.observable_correlation(spd, spin, spin, ds, size_a=2, cl_k=3)
    t = np.tanh(beta * j_eff)
    np.testing.assert_allclose(got, t ** np.array(ds, dtype=float),
                               rtol=1e-10, atol=1e-14)
    xi = corr.correlation_length(spd, size_a=2, cl_k=3)
    np.testing.assert_allclose(xi, -1.0 / np.log(t), rtol=1e-10)


def test_observable_correlation_ring_mode_spins():
    beta, j_eff, L = 0.4, 2.0, 10
    spd = ising_gibbs_windows(3, J_eff=j_eff, h=0.0, beta=beta)
    spin = {(0,): -1.0, (1,): 1.0}
    ds = [1, 3, 5, 9]
    got = corr.observable_correlation(spd, spin, spin, ds, ring=L,
                                      size_a=2, cl_k=3)
    mpp, _, _ = corr.context_arrays(spd, size_a=2, cl_k=3)
    rings = list(itertools.product((0, 1), repeat=L))
    w = np.empty(len(rings))
    for i, seq in enumerate(rings):
        acc = 1.0
        for j in range(L):
            ctx = seq[(j - 2) % L] * 2 + seq[(j - 1) % L]
            acc *= mpp[ctx, seq[j]]
        w[i] = acc
    w /= w.sum()
    s = np.array(rings, dtype=float) * 2 - 1
    mean = float(w @ s[:, 0])
    for j, d in enumerate(ds):
        want = float(w @ (s[:, 0] * s[:, d % L])) - mean * mean
        np.testing.assert_allclose(got[j], want, rtol=1e-10, atol=1e-14)


def test_bridge_sampler_matches_ring_correlator():
    """Empirical pair frequencies of the port's bridge-sampled rings
    (`ensemble.sample_tapes_from_spd(ring=True)`, the port's generator)
    agree with the exact cyclic trace formula."""
    size_a, cl_k, L, B = 2, 3, 16, 4096
    spd = _random_markov_spd(size_a, cl_k, seed=3)
    tapes = tens.sample_tapes_from_spd(0, spd, size_a, cl_k, B, L,
                                       ring=True, device="cpu").numpy()
    for seq_a, seq_b, d in [((0,), (1,), 3), ((1, 1), (0,), 6)]:
        ok_a = np.ones(B, bool)
        for i, s in enumerate(seq_a):
            ok_a &= tapes[:, i % L] == s
        ok_b = np.ones(B, bool)
        for i, s in enumerate(seq_b):
            ok_b &= tapes[:, (d + i) % L] == s
        emp = (ok_a & ok_b).mean()
        want = corr.pair_prob(spd, seq_a, seq_b, d, ring=L)
        se = np.sqrt(want * (1 - want) / B)
        assert abs(emp - want) < 5 * se + 1e-3, (seq_a, seq_b, d, emp, want)


def test_correlation_length_arnoldi_branch_matches_chain():
    """n_ctx > 4096 takes the matrix-free scipy-Arnoldi path: the lifted
    order-1 chain's xi is the 2x2 chain's."""
    spd, lam2 = _lifted_chain(5)
    assert spd.shape == (2,) * 14
    np.testing.assert_allclose(spd.sum(), 1.0, rtol=1e-12)
    xi = corr.correlation_length(spd)
    np.testing.assert_allclose(xi, -1.0 / np.log(lam2), rtol=1e-4)


def test_ring_mode_rejects_oversized_contexts():
    spd = _random_markov_spd(2, 3, seed=4)
    with pytest.raises(ValueError, match="d must be >= 0"):
        corr.pair_prob(spd, (0,), (1,), -1)
    np.testing.assert_allclose(
        corr.pair_prob(spd, (0,) * 9, (), 0, ring=8),
        corr.pair_prob(spd, (0,) * 8, (), 0, ring=8), rtol=1e-12)
    assert corr.pair_prob(spd, (0,) * 8 + (1,), (), 0, ring=8) == 0.0
    big, _ = _lifted_chain(6)
    with pytest.raises(ValueError, match="ring mode builds dense"):
        corr.pair_prob(big, (0,), (1,), 3, ring=64)
    with pytest.raises(ValueError, match="ring mode builds dense"):
        corr.observable_correlation(big, {(0,): 1.0}, {(1,): 1.0}, [2],
                                    ring=64)


def test_class_words_match_symbol_sums():
    spd = _random_markov_spd(3, 3, seed=7)
    for ring in (None, 9):
        cls = corr.pair_prob(spd, (0, (1, 2)), ((0, 1),), 3, ring=ring)
        plain = sum(corr.pair_prob(spd, (0, m), (b,), 3, ring=ring)
                    for m in (1, 2) for b in (0, 1))
        np.testing.assert_allclose(cls, plain, rtol=1e-12, atol=1e-16)
    got = corr.pair_prob(spd, (0, (1, 2)), (2,), 1)
    np.testing.assert_allclose(got, corr.pair_prob(spd, (0, 2), (2,), 1),
                               rtol=1e-12)
    assert corr.pair_prob(spd, (0, (0, 1)), (2,), 1) == 0.0


def test_run_length_distribution_mass_identity():
    size_a, cl_k, L = 3, 3, 10
    spd = _random_markov_spd(size_a, cl_k, seed=8)
    inside = (1, 2)
    lens = np.arange(1, L)
    p_run = corr.run_length_distribution(spd, inside, lens, ring=L)
    p_all = corr.pair_prob(spd, (inside,) * L, (), 0, ring=L)
    p_inside = sum(corr.pair_prob(spd, (m,), (), 0, ring=L) for m in inside)
    np.testing.assert_allclose(float((lens * p_run).sum()) + p_all,
                               p_inside, rtol=1e-11, atol=1e-14)


def test_run_length_distribution_matches_brute_force_chain():
    spd = _random_markov_spd(2, 3, seed=9)
    for ell in (1, 2, 4):
        got = corr.run_length_distribution(spd, (1,), [ell])[0]
        want = 0.0
        for word in itertools.product((0,), *[(1,)] * ell, (0,)):
            want += markov.seq_prob(spd, list(word))[0]
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-16)


# --- engine/reference.py and the debug dump ------------------------------------


@pytest.mark.parametrize("tag,cl_k", [("ex1-radioactive-decay", 3),
                                      ("ex2-ferromagnetic-chain", 3),
                                      ("ex3-copolymerization", 3)])
def test_reference_dy_dt_matches_jax_and_engine(tag, cl_k):
    """The port's slow reference dp/dt equals the JAX package's bit for
    bit and the port's compiled RHS (the CPU's plain versions) to rtol
    1e-12."""
    a = tengine.dsl.get_problem(tag).size_a
    p = _random_markov_spd(a, cl_k, seed=41).ravel()
    got = reference.dy_dt_reference(tag, cl_k, p)
    np.testing.assert_array_equal(got, jreference.dy_dt_reference(tag, cl_k,
                                                                  p))
    fn, _ = tengine.build_dy_dt(tag, cl_k, device="cpu")
    np.testing.assert_allclose(got, fn(p).numpy(), rtol=1e-12, atol=1e-15)


def test_dump_worlds_debug_mode(capsys):
    """The world dump prints every execution path with its probability,
    decision program and old->new sequences; with a probability vector
    the worlds carry total probability 1."""
    n = reference.dump_worlds(EX2, 3, np.full(8, 0.125))
    out = capsys.readouterr().out
    lines = [ln for ln in out.strip().split("\n") if ln]
    assert len(lines) == n and n > 4
    assert all("p_world=" in ln and "prog[" in ln for ln in lines)
    tot = sum(float(ln.split("p_world=")[1].split()[0]) for ln in lines)
    np.testing.assert_allclose(tot, 1.0, rtol=1e-6)
    assert any("->" in ln for ln in lines)
    n2 = reference.dump_worlds("ex1-radioactive-decay", 3, None, limit=3)
    assert 0 < n2 <= 3
    # The JAX package prints the same lines.
    capsys.readouterr()
    for tag, p, limit in ((EX2, np.full(8, 0.125), None),
                          ("ex1-radioactive-decay", None, 3)):
        reference.dump_worlds(tag, 3, p, limit=limit)
        t_out = capsys.readouterr().out
        jreference.dump_worlds(tag, 3, p, limit=limit)
        assert t_out == capsys.readouterr().out


@pytest.mark.parametrize("flag", [False, True])
def test_get_dy_dt_debug_prints_dump(monkeypatch, capsys, flag):
    """`markov_tapes.get_dy_dt(debug=True)` with the debug flag set
    prints the time and the world dump (at most 200 worlds) on each
    call, as the JAX package's does, and returns its dp/dt; without the
    flag it prints nothing."""
    monkeypatch.setattr(markov_tapes, "IS_DEBUG", flag)
    monkeypatch.setattr(j_markov_tapes, "IS_DEBUG", flag)
    kw = dict(tag="ex5-msrtf-machine", size_a=5, cl_k=3, debug=True)
    p = np.full(125, 1 / 125)
    capsys.readouterr()
    got = markov_tapes.get_dy_dt(**kw, device="cpu")(p, 1.25)
    t_out = capsys.readouterr().out
    want = j_markov_tapes.get_dy_dt(**kw)(p, 1.25)
    assert t_out == capsys.readouterr().out
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    if flag:
        assert t_out.startswith("[ckpe] dy_dt t=1.25\n")
        assert t_out.count("p_world=") <= 200
        assert "p_world=" in t_out
    else:
        assert t_out == ""
