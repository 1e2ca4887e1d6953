"""The port's steady states (`ode/steady.py`) against the JAX package
(CPU).

- The augmentation: G, L (kernel K26's plain version, `steady_aug_plain`)
  and the conserved targets equal the JAX package's `_build_augmentation`
  within rtol 1e-12 (an absolute floor of 1e-12 of the largest entry) in
  "auto", explicit, None and "support" modes, at random states; the
  conserved projectors W^T W within 1e-10 (an SVD null-space basis may
  come out rotated, and only W^T W enters the augmentation).
- Twins of `tests/test_steady.py` that need no gradient, at its sizes and
  bounds, with the JAX package's `ising_gibbs_windows` as the oracle:
  :40 (ex2's steady state is Ising Gibbs), :57 (stationary under the
  fixed-grid integrator), :70 (ex1's boundary fixed point) and :166
  (relaxation modes against a dense eigendecomposition of J_G, built
  from the port's J_G v on the unit vectors). :135 (support mode) is in
  `tests/test_torch_steady_support.py`.
- K26's fused entry: G, J_G v and L through the `Augmentation` (the
  plain version with the callers' inputs) equal the callers' own
  composition bit for bit; the launch form K26 takes at each size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu.engine import (
    build_dy_dt as j_build,
)
from chemical_kinetics_and_program_execution_tpu.models.ferromagnet import (
    ising_gibbs_windows as j_gibbs,
)
from chemical_kinetics_and_program_execution_tpu.models.initial_states import (  # noqa: E501
    chemical_turing_v2_p0,
)
from chemical_kinetics_and_program_execution_tpu.ode import steady as js
from chemical_kinetics_and_program_execution_torch.engine import (
    build_dy_dt as t_build,
)
from chemical_kinetics_and_program_execution_torch.models import ferromagnet
from chemical_kinetics_and_program_execution_torch.ode import steady as ts
from chemical_kinetics_and_program_execution_torch.ode.fixed import (
    odeint_fixed,
)
from chemical_kinetics_and_program_execution_torch.ode.krylov import jvp

CPU = torch.device("cpu")
CL_K = 3
S = 2**CL_K
# ex4var2's fuel (P + X) and evaluator (S + E) counts, as explicit weights.
_EX4V2_W = np.array([[0, 0, 0, 0, 0, 0, 1, 1, 0, 0],
                     [0, 0, 0, 0, 0, 0, 0, 0, 1, 1.0]])


def _gibbs(cl_k, beta=1.0):
    return j_gibbs(cl_k, J_eff=2.0, h=-0.25, beta=beta)


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("tag,a,conserved", [
    ("ex2-ferromagnetic-chain", 2, "auto"),
    ("ex4var2-chemical-turing", 10, "auto"),
    ("ex4var2-chemical-turing", 10, "explicit"),
    ("ex4var2-chemical-turing", 10, None),
    ("ex4var2-chemical-turing", 10, "support"),
])
def test_augmentation_matches_jax(tag, a, conserved):
    """G(p) at a random p with the targets of a random guess, L(x) at a
    random x, the embedded targets and the projector W^T W, each against
    the JAX package's augmentation of its own RHS."""
    cons = _EX4V2_W if conserved == "explicit" else conserved
    jf, _ = j_build(tag, CL_K)
    tf, _ = t_build(tag, CL_K, device="cpu")
    n = a**CL_K
    rng = np.random.default_rng(17)
    guess = chemical_turing_v2_p0(CL_K).ravel() if conserved == "support" \
        else rng.dirichlet(np.ones(n))
    jaug, jtg, jmask, jhas, jvals, jembed = js._build_augmentation(
        lambda p, _a: jf(p), a, CL_K, cons, None,
        guess if conserved == "support" else None, 1e-20)
    aug = ts.Augmentation(lambda p, _a: tf(p), a, CL_K, cons, None,
                          guess if conserved == "support" else None, 1e-20,
                          CPU)
    assert aug.has_conserved == bool(jhas)
    p, x = rng.dirichlet(np.ones(n)), rng.standard_normal(n)
    if conserved == "support":
        mask = np.asarray(jmask)
        assert np.array_equal(aug.mask.numpy(), mask)
        p, x = np.where(mask, p, 0.0), np.where(mask, x, 0.0)
    tg = jtg(jnp.asarray(guess))
    t_tg = aug.targets(torch.as_tensor(guess))
    if aug.has_conserved:
        _close(aug.cons_embed(t_tg).numpy(), np.asarray(jembed(tg)))
        if conserved == "support":
            W = aug.cons_w.numpy()
            _, jW = js.detect_support_invariants(lambda q, _a: jf(q), a,
                                                 CL_K, guess)
            assert W.shape == jW.shape
            np.testing.assert_allclose(W.T @ W, jW.T @ jW, atol=1e-10)
    const = aug.constant(t_tg)
    got = aug.residual(torch.as_tensor(p), None, const).numpy()
    _close(got, np.asarray(jaug(jnp.asarray(p), None, tg)))
    zero = jnp.zeros_like(tg)
    j_lin = np.asarray(jf(jnp.asarray(x))) - np.asarray(
        jaug(jnp.asarray(x), None, zero))
    if conserved != "support":
        j_lin = j_lin + 1.0 / n
    t_lin = aug.linear(torch.as_tensor(x)).numpy()
    if conserved == "support":
        t_lin, j_lin = t_lin[mask], j_lin[mask]
    _close(t_lin, j_lin)


@pytest.mark.parametrize("conserved", ["auto", "explicit"])
def test_conserved_projectors_equal_jax(conserved):
    """`detect_conserved_marginals` (numpy's default_rng(0) probes) and
    the explicit weights' orthonormalisation give the JAX package's
    projector w^T w on ex4var2 within 1e-10."""
    jf, _ = j_build("ex4var2-chemical-turing", CL_K)
    tf, _ = t_build("ex4var2-chemical-turing", CL_K, device="cpu")
    cons = _EX4V2_W if conserved == "explicit" else conserved
    aug = ts.Augmentation(lambda p, _a: tf(p), 10, CL_K, cons, None, None,
                          1e-20, CPU)
    if conserved == "auto":
        jw = js.detect_conserved_marginals(lambda p, _a: jf(p), 10, CL_K)
    else:
        ones = np.ones(10) / np.sqrt(10)
        w = _EX4V2_W - np.outer(_EX4V2_W @ ones, ones)
        q, r = np.linalg.qr(w.T)
        jw = q.T[np.abs(np.diag(r)) > 1e-8]
    w = aug.cons_w.numpy()
    assert w.shape == jw.shape and w.shape[0] >= 2
    np.testing.assert_allclose(w.T @ w, jw.T @ jw, atol=1e-10)


def test_ex2_steady_state_is_ising_gibbs():
    """Twin of `tests/test_steady.py:40`: Gibbs is an exact root of the
    port's RHS, and PTC from uniform (warm_t 5) lands on it."""
    pg = _gibbs(CL_K)
    np.testing.assert_allclose(ferromagnet.ising_gibbs_windows(
        CL_K, J_eff=2.0, h=-0.25, beta=1.0), pg, rtol=0, atol=0)
    dfn, _ = t_build("ex2-ferromagnetic-chain", CL_K, device="cpu")
    assert float(torch.sqrt(torch.mean(dfn(pg) ** 2))) < 1e-15
    p_inf, info = ts.steady_state("ex2-ferromagnetic-chain", CL_K,
                                  np.full(S, 1.0 / S), warm_t=5.0,
                                  device="cpu")
    assert info.converged
    assert info.residual <= 1e-12
    np.testing.assert_allclose(p_inf.numpy(), pg, rtol=0, atol=1e-9)
    assert abs(float(p_inf.sum()) - 1.0) < 1e-12
    assert info.matvecs > info.iterations


def test_steady_state_is_stationary_under_the_integrator():
    """Twin of `tests/test_steady.py:57`: integrating from the root on
    the fixed grid moves nothing."""
    p_inf, info = ts.steady_state("ex2-ferromagnetic-chain", CL_K,
                                  np.full(S, 1.0 / S), warm_t=5.0,
                                  device="cpu")
    assert info.converged
    dfn, _ = t_build("ex2-ferromagnetic-chain", CL_K, device="cpu")
    ys = odeint_fixed(lambda y, t: dfn(y), p_inf, [0.0, 100.0], n_sub=800)
    np.testing.assert_allclose(ys[-1].numpy(), p_inf.numpy(), rtol=0,
                               atol=1e-11)


def test_steady_state_boundary_fixed_point():
    """Twin of `tests/test_steady.py:70`: ex1's corner fixed point."""
    p_inf, info = ts.steady_state("ex1-radioactive-decay", CL_K,
                                  np.full(S, 1.0 / S), warm_t=10.0,
                                  device="cpu")
    assert info.converged
    np.testing.assert_allclose(float(p_inf[0]), 1.0, rtol=0, atol=1e-10)
    assert float(p_inf[1:].abs().max()) < 1e-10


def test_relaxation_modes_match_dense_eigs():
    """Twin of `tests/test_steady.py:166`: shift-invert Arnoldi at the ex2
    equilibrium against the eigenvalues of J_G, built from the port's
    J_G v on the unit vectors; the slowest mode's relaxation time."""
    dfn, _ = t_build("ex2-ferromagnetic-chain", CL_K, device="cpu")
    pg = torch.as_tensor(_gibbs(CL_K))
    lams, resids = ts.relaxation_modes(lambda p, a: dfn(p), pg, size_a=2,
                                       cl_k=CL_K, n_modes=4, krylov_m=8,
                                       device="cpu")
    assert np.all(resids < 1e-8)
    assert np.all(np.real(lams) < 0)
    aug = ts.Augmentation(lambda p, a: dfn(p), 2, CL_K, "auto", None, None,
                          1e-20, CPU)
    eye = torch.eye(S, dtype=torch.float64)
    J = torch.stack([aug.jvp(pg, eye[j], None) for j in range(S)], dim=1)
    ev = np.linalg.eigvals(J.numpy())
    ev = ev[np.argsort(np.abs(ev))][:4]
    np.testing.assert_allclose(np.sort(np.real(lams)), np.sort(np.real(ev)),
                               rtol=1e-7)
    tau = -1.0 / np.real(lams[0])
    assert 50 < tau < 5000


@pytest.mark.parametrize("which", ["residual", "jvp", "linear"])
@pytest.mark.parametrize("tag,a,conserved", [
    ("ex2-ferromagnetic-chain", 2, "auto"),
    ("ex4var2-chemical-turing", 10, "explicit"),
    ("ex4var2-chemical-turing", 10, "support"),
])
def test_fused_augmentation_equals_composition(which, tag, a, conserved):
    """K26's fused entry (its plain version on the CPU: `steady_aug_plain`
    with the callers' inputs) equals the callers' composition bit for
    bit: G = (F(p) - L(p)) + const, J_G v = J v - L(v), L(x), in mode 0
    and in support mode (L = C^T C x + W^T W x, the mask's where)."""
    cons = _EX4V2_W if conserved == "explicit" else conserved
    tf, _ = t_build(tag, CL_K, device="cpu")
    n = a**CL_K
    rng = np.random.default_rng(23)
    guess = chemical_turing_v2_p0(CL_K).ravel() if conserved == "support" \
        else None
    aug = ts.Augmentation(lambda p, _a: tf(p), a, CL_K, cons, None, guess,
                          1e-20, CPU)
    p = torch.as_tensor(rng.dirichlet(np.ones(n)))
    v = torch.as_tensor(rng.standard_normal(n))
    mask = aug.mask

    def lin(x):
        if aug.support:
            return (ts.steady_aug_plain(x, a, CL_K, aug.cons_w[:0, :a], 1.0,
                                        ts._CTC)
                    + aug.cons_w.T @ (aug.cons_w @ x))
        return ts.steady_aug_plain(x, a, CL_K, aug.cons_w, aug.c_norm)

    def where(out, keep):
        return out if mask is None else torch.where(mask, out, keep)

    pm = p if mask is None else torch.where(mask, p, 0.0)
    vm = v if mask is None else torch.where(mask, v, 0.0)
    if which == "residual":
        const = aug.constant(aug.targets(p))
        got = aug.residual(p, None, const)
        want = where((tf(pm) - lin(pm)) + const, p)
    elif which == "jvp":
        got = aug.jvp(p, v, None)
        want = where(jvp(tf, pm, vm) - lin(vm), v)
    else:
        got, want = aug.linear(vm), lin(vm)
    assert torch.equal(got, want)


@pytest.mark.parametrize("a,k,form", [
    (2, 3, "block"), (2, 6, "block"), (2, 4, "block"), (10, 3, "block"),
    (10, 4, "block"), (2, 13, "block"), (4, 7, "split"), (3, 9, "split"),
    (20, 3, "block"), (10, 5, "split"), (10, 6, "split"), (2, 14, "split")])
def test_k26_launch_form(a, k, form):
    """K26's form by a^k: one block where x, its levels and defects fit
    227 KB and x has at most 10,000 entries (every program of phase 14's
    (d) and (e)), the split form beyond (n = 100,000; 4^7 fits but the
    block measured slower there). `aug_forms` lists the block wherever it
    fits."""
    assert ts.aug_form(a, k) == form
    fits = ts.block_doubles(a, k) <= ts._SMEM_DOUBLES
    assert ts.aug_forms(a, k) == ["split", "block"][:1 + fits]
    assert fits == (form == "block" or (a, k) == (4, 7))
