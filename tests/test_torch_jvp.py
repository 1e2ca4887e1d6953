"""The port's forward-mode derivatives against the JAX package (CPU).

The same inputs, made with numpy from a seed, go through the JAX package
and the port on ``device="cpu"``, where the kernels' wrappers run their
plain versions:

- J.v of the dense RHS (`torch.func.jvp` of the port's closure, and the
  forward-AD dual the solvers pass) against `jax.jvp` of the JAX
  closure on the 13 cases of `tests/test_engine.py:18-32` and a dual
  program, at a positive p, at a p with a third of its windows exactly
  0 (ties g(n, n) in the guarded ratio) and at a p with whole contexts
  dead: within rtol 1e-12 with an absolute floor of 1e-12 max|J v| (the
  guarded ratio's quotient rule is written differently: where n > d the
  port's tangent is exactly 0, JAX's a rounding residue);
- K25's rule (`csrc/sweep_rule.cuh` on pairs) built with the host's C++
  compiler and run over the whole plan equals `dense_jvp_plain` bit for bit, dy
  included;
- the port's GMRES (`ode/krylov.py`) against `jax.scipy.sparse.linalg.
  gmres(solve_method="batched")` at the callers' settings, a happy
  breakdown included (rtol 1e-10);
- K6's third table (Kvaerno 3(2)) and its plain modes;
- what the reverse mode does not cover yet raises NotImplementedError
  naming its ROADMAP Queue 1 item.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu.engine import dense as jdense
from chemical_kinetics_and_program_execution_tpu.ode import (
    kvaerno3 as j_kv,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.engine import (
    compile as tcompile,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    dense as tdense,
)
from chemical_kinetics_and_program_execution_torch.engine import rhs as trhs
from chemical_kinetics_and_program_execution_torch.ode import dop853 as t_dop
from chemical_kinetics_and_program_execution_torch.ode import fixed as tfixed
from chemical_kinetics_and_program_execution_torch.ode import krylov
from chemical_kinetics_and_program_execution_torch.ode import steady as tst

CASES = [
    ("ex1-radioactive-decay", 3),
    ("ex1-radioactive-decay", 5),
    ("ex2-ferromagnetic-chain", 3),
    ("ex2-ferromagnetic-chain", 5),
    ("ex3-copolymerization", 4),
    ("ex3var1-copolymerization", 4),
    ("ex3var2-copolymerization", 4),
    ("ex4-chemical-turing", 3),
    ("ex4var1-chemical-turing", 3),
    ("ex4var2-chemical-turing", 3),
    ("ex5-msrtf-machine", 3),
    ("ex5var1-msrtf-machine", 3),
    ("ex6-mini-bff-lite", 2),
]
IDS = [f"{tag}-{k}" for tag, k in CASES]
SLICE_B = ("Derivative-based solvers and instruments: reverse mode', "
           r"slice \(b\)")
SECOND_ORDER = "Second derivatives and derivatives of the world mass"
RTOL = 1e-12  # and the floor 1e-12 max|J v|


def _states(n, a, k, seed):
    """A positive p, one with a third of its windows exactly 0, and one
    whose contexts starting with symbol 0 are dead (every window of
    them 0)."""
    rng = np.random.default_rng(seed)
    pos = rng.dirichlet(np.ones(n))
    zeros = pos.copy()
    zeros[rng.random(n) < 1.0 / 3.0] = 0.0
    dead = pos.copy()
    dead[: n // a] = 0.0
    return [x / x.sum() for x in (pos, zeros, dead)]


def _close(got, want):
    floor = RTOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=floor)


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_jvp_matches_jax(tag, cl_k):
    """torch.func.jvp of the port's closure and the forward-AD dual path
    (one K25 call giving dp/dt and J v) against jax.jvp, on three states
    and a normal tangent each; the dual's value is the RHS bit for
    bit."""
    jprog = jdense.compile_dense(tag, cl_k)
    tprog = tdense.compile_dense(tag, cl_k)
    jf = jdense.make_dense_dy_dt(jprog)
    tf = tdense.make_dense_dy_dt(tprog, device="cpu")
    n, a = tprog.state_size, tprog.size_a
    rng = np.random.default_rng(7)
    for p in _states(n, a, cl_k, 3):
        v = rng.standard_normal(n)
        want = np.asarray(jax.jvp(jf, (jnp.asarray(p),),
                                  (jnp.asarray(v),))[1])
        pt, vt = torch.as_tensor(p), torch.as_tensor(v)
        dy, got = torch.func.jvp(tf, (pt,), (vt,))
        _close(got.numpy(), want)
        assert torch.equal(dy, tf(pt))
        fwad = torch.autograd.forward_ad
        with fwad.dual_level():
            out = fwad.unpack_dual(tf(fwad.make_dual(pt, vt)))
        assert torch.equal(out.tangent, got)
        assert torch.equal(out.primal, dy)
        assert torch.equal(krylov.jvp(tf, pt, vt), got)


def test_jvp_dual_program_matches_jax():
    """A dual-SPD program (separate program and data tapes), each tape's
    K3 on v into its block: J.v against jax.jvp."""
    tag = "ex3-copolymerization"
    jf = jdense.make_dense_dy_dt(jdense.compile_dense_dual(tag, 3))
    tprog = tdense.compile_dense_dual(tag, 3)
    tf = tdense.make_dense_dy_dt(tprog, device="cpu")
    n = 4**3
    rng = np.random.default_rng(11)
    for zero in (False, True):
        y = np.concatenate([rng.dirichlet(np.ones(n)),
                            rng.dirichlet(np.ones(n))])
        if zero:
            y[rng.random(2 * n) < 1.0 / 3.0] = 0.0
        v = rng.standard_normal(2 * n)
        want = np.asarray(jax.jvp(jf, (jnp.asarray(y),),
                                  (jnp.asarray(v),))[1])
        got = torch.func.jvp(tf, (torch.as_tensor(y),),
                             (torch.as_tensor(v),))[1]
        _close(got.numpy(), want)



@pytest.mark.parametrize("tag,cl_k", [("ex4-chemical-turing", 3),
                                      ("ex2-ferromagnetic-chain", 5)])
def test_dual_routes_agree(monkeypatch, tag, cl_k):
    """`dense.rhs_fn` answers a forward-AD dual with one K25 call (value
    and tangent); routed instead through `RHSFunction` (forward, then its
    jvp rule) the dual gives the same bits, for the dense closure and
    the parametric one at a run-time w_const."""
    tf = tdense.make_dense_dy_dt(tdense.compile_dense(tag, cl_k),
                                 device="cpu")
    n = tf.device_program.prog.state_size
    rng = np.random.default_rng(13)
    p = torch.as_tensor(rng.dirichlet(np.ones(n)))
    v = torch.as_tensor(rng.standard_normal(n))
    w = torch.as_tensor(tf.device_program.prog.w_const
                        * rng.uniform(0.5, 1.5, tf.device_program.prog
                                      .num_worlds))
    fwad = torch.autograd.forward_ad

    def run(fn):
        with fwad.dual_level():
            out = fwad.unpack_dual(fn(fwad.make_dual(p, v)))
        return out.primal, out.tangent

    closures = (tf, lambda y: tdense.rhs_fn(tf.device_program, y,
                                            w_const=w))
    shortcut = [run(fn) for fn in closures]
    monkeypatch.setattr(tdense, "forward_dual", lambda y: None)
    routed = [run(fn) for fn in closures]
    for (dy, jv), (dy2, jv2) in zip(shortcut, routed):
        assert torch.equal(dy, dy2) and torch.equal(jv, jv2)
    assert torch.equal(shortcut[1][1], tdense.dense_jvp_plain(
        tf.device_program, p, v, w_const=w))


def test_guarded_ratio_tangent_at_ties_and_the_guard():
    """The guarded ratio's tangent as K25 forms it: 0.5/0.5 at a tie
    (JAX's 1.6667 at (0.3, 0.3) along dn = 1), exactly 0 where n > d and
    where n <= 0 (one-sided, even with dn > 0)."""
    def g(n, d, dn, dd):
        t = [torch.tensor([x], dtype=torch.float64) for x in (n, d, dn, dd)]
        return tdense.guarded_ratio_dual(*t)[1].item()

    jg = jax.jvp(lambda n: jnp.where(n > 0, n / jnp.maximum(n, 0.3), 0.0),
                 (jnp.asarray(0.3),), (jnp.asarray(1.0),))[1]
    assert g(0.3, 0.3, 1.0, 0.0) == pytest.approx(float(jg), rel=1e-15)
    assert g(0.2, 0.1, 1.0, 0.5) == 0.0
    assert g(0.0, 0.1, 1.0, 0.5) == 0.0
    assert g(-1e-300, 0.1, 1.0, 0.5) == 0.0
    assert g(0.1, 0.2, 1.0, 0.5) == pytest.approx(1 / 0.2 - 0.1 * 0.5 / 0.04)


def test_zero_tangent_gives_zeros_without_a_call():
    """A None tangent reaching `RHSFunction.jvp` gives zeros and calls
    nothing; a function whose output carries no tangent gives zeros
    through `krylov.jvp`."""
    calls = []

    class Ctx:
        saved_tensors = (torch.ones(4, dtype=torch.float64),
                         torch.zeros(2, dtype=torch.float64), None)

        @staticmethod
        def jvp_fn(*args):
            calls.append(args)

    out, _ = tdense.RHSFunction.jvp(Ctx(), None, None)
    assert torch.equal(out, torch.zeros(4, dtype=torch.float64))
    assert not calls
    x = torch.ones(3, dtype=torch.float64)
    assert torch.equal(krylov.jvp(lambda y: torch.zeros(3), x, x),
                       torch.zeros(3, dtype=torch.float64))


# --- K25's rule, built with the host's C++ compiler -----------------------


_K25_HOST = r"""
#include "sweep_rule.cuh"
extern "C" void k25_host_sweep(int a, int k, long long n_state,
                               const double* p, const double* low,
                               const double* v, const double* vlow,
                               const int* pair_num, const int* pair_den,
                               const double* pair_const, int chain,
                               const int* csr_ptr, int n_sig, double* s,
                               const int* table, double* work,
                               const long long* items, int n_items,
                               int dual, double* jdy, double* dy) {
  K5CtxT<K25Dual> c = {};
  c.a = a;
  c.k = k;
  c.p = p;
  c.low = low;
  c.table = table;
  k5_levels(c);
  c.n_state = (unsigned)n_state;
  c.v = v;
  c.vlow = vlow;
  c.s = reinterpret_cast<const K25Dual*>(s);
  c.work = reinterpret_cast<K25Dual*>(work);
  c.jdy = jdy;
  c.dy = dy;
  K4Pairs w;
  w.num = pair_num;
  w.den = pair_den;
  w.w_const = pair_const;
  w.csr_ptr = csr_ptr;
  w.chain = chain;
  K25Dual* s2 = reinterpret_cast<K25Dual*>(s);
  for (int g = 0; g < n_sig; ++g) {  // phase 0, each warp's pair order
    K25Dual acc = K25Dual();
    for (int q = csr_ptr[g]; q < csr_ptr[g + 1]; ++q)
      acc = k5_add(acc, k4_pair_weight(c, w, q));
    s2[g] = acc;
  }
  for (long long q = 0; q < n_state; ++q) k5_dy_set(c, (unsigned)q, K25Dual());
  for (int q = 0; q < n_items; ++q) {  // the plan's order: phase by phase
    const K5Item it = k5_item(items + (long long)q * K5_FIELDS, c);
    for (unsigned e = 0; e < it.n; ++e) {
      if (dual)
        k5_element<true>(c, it, e);
      else
        k5_element<false>(c, it, e);
    }
  }
}
"""


@pytest.fixture(scope="module")
def k25_host(tmp_path_factory):
    """K25's rule (`csrc/sweep_rule.cuh` on K25Dual pairs) built with
    the host's C++ compiler without contraction, run over a whole plan:
    phase 0's weights in pair order, then every item's elements in plan
    order."""
    cxx = next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                      "clang++")) if c), None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k25")
    (out / "k25.cpp").write_text(_K25_HOST)
    lib = out / "libk25.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib),
                    str(out / "k25.cpp")], check=True, capture_output=True,
                   timeout=120)
    fn = ctypes.CDLL(str(lib)).k25_host_sweep
    i, L, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [i, i, L] + [p] * 7 + [i, p, i] + [p] * 4 + [i, i, p, p]
    fn.restype = None
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.mark.parametrize("tag,cl_k,dual", [
    ("ex4-chemical-turing", 3, False), ("ex4var2-chemical-turing", 3, False),
    ("ex2-ferromagnetic-chain", 5, False), ("ex6-mini-bff-lite", 2, False),
    ("ex3-copolymerization", 3, True)])
def test_jvp_rule_matches_plain(k25_host, tag, cl_k, dual):
    """K25's rule over the whole plan equals `dense_jvp_plain` bit for
    bit (J v, and dy with ``value``, which equals the RHS's bits), at a
    positive p, at one with zero windows (ties) and with a run-time
    w_const; the interior ops of a long signature included
    (ex6-mini-bff-lite)."""
    prog = (tdense.compile_dense_dual(tag, cl_k) if dual
            else tdense.compile_dense(tag, cl_k))
    dp = tdense.device_program(prog, "cpu")
    n, a = prog.state_size, prog.size_a
    plan = dp.plan
    rng = np.random.default_rng(5)
    w_alt = torch.as_tensor(prog.w_const * rng.uniform(0.5, 1.5,
                                                       prog.num_worlds))
    for q, (p_np, w_const) in enumerate(zip(_states(n, a, cl_k, 9),
                                            (None, None, w_alt))):
        p = torch.as_tensor(p_np)
        v = torch.as_tensor(rng.standard_normal(n))
        low = tdense.pyramids(prog, p, plain=True)
        vlow = tdense.pyramids(prog, v, plain=True)
        want_dy, want = tdense.dense_jvp_plain(dp, p, v, low, w_const,
                                               value=True)
        jdy = torch.full((n,), np.nan, dtype=torch.float64)
        dy = torch.full((n,), np.nan, dtype=torch.float64)
        s = torch.empty(2 * prog.num_signatures, dtype=torch.float64)
        work = torch.zeros(2 * max(plan.work_size, 1), dtype=torch.float64)
        consts = tdense.pair_consts(dp, w_const)
        items = np.ascontiguousarray(plan.items)
        table = torch.as_tensor(plan.table)
        k25_host(a, cl_k, n, _ptr(p), _ptr(low), _ptr(v), _ptr(vlow),
                 _ptr(dp.pair_num), _ptr(dp.pair_den), _ptr(consts),
                 prog.w_num.shape[1], _ptr(dp.csr_ptr), prog.num_signatures,
                 _ptr(s), _ptr(table), _ptr(work), items.ctypes.data,
                 len(items), int(dual), _ptr(jdy), _ptr(dy))
        assert torch.equal(jdy, want)
        assert torch.equal(dy, want_dy)
        assert torch.equal(want_dy, tdense.dy_dt_dense(dp, p,
                                                       w_const=w_const))
        assert q or bool((want != 0).any())  # dead contexts may stop all


# --- GMRES -----------------------------------------------------------------


def _jax_gmres(M, b, **kw):
    x, _ = jax.scipy.sparse.linalg.gmres(
        lambda v: jnp.asarray(M) @ v, jnp.asarray(b), atol=0.0,
        solve_method="batched", **kw)
    return np.asarray(x)


@pytest.mark.parametrize("tol,restart,maxiter", [
    (1e-8, 50, 8), (1e-4, 20, 1), (1e-11, 60, 8), (1e-13, 60, 8),
    (1e-8, 20, 4)])
def test_gmres_matches_jax(tol, restart, maxiter):
    """The same matvec (a fixed random dense matrix of size 40, below
    and above the restart), the callers' settings: the solution within
    rtol 1e-10 of JAX's, and the matvec count 1 + (restart + 1) per
    restart made."""
    rng = np.random.default_rng(int(-np.log10(tol)) + restart)
    for n in (30, 90):
        M = rng.standard_normal((n, n)) / np.sqrt(n) + 1.5 * np.eye(n)
        b = rng.standard_normal(n)
        want = _jax_gmres(M, b, tol=tol, restart=restart, maxiter=maxiter)
        Mt = torch.as_tensor(M)
        got, count = krylov.gmres(lambda v: Mt @ v, torch.as_tensor(b),
                                  tol=tol, atol=0.0, restart=restart,
                                  maxiter=maxiter)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
        r = min(restart, n)
        assert count >= 1 + r + 1 and (count - 1) % (r + 1) == 0


def test_gmres_happy_breakdown():
    """A matvec of rank below the restart (2 I: the first Arnoldi vector
    is exactly A's image): the restart ends at the breakdown, and the
    solution equals JAX's (b / 2)."""
    b = np.random.default_rng(2).standard_normal(12)
    want = _jax_gmres(2.0 * np.eye(12), b, tol=1e-8, restart=20, maxiter=4)
    got, count = krylov.gmres(lambda v: 2.0 * v, torch.as_tensor(b),
                              tol=1e-8, restart=20, maxiter=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), b / 2, rtol=1e-14)
    assert count == 3  # the residual, one Arnoldi step, the new residual


def test_gmres_on_the_ex2_augmented_jacobian():
    """The same matvec for both: J_G of ex2 at cl_k 4 at its equilibrium
    (the steady state's operator there), formed column by column from the
    port's J v (K25's plain version) and L (K26's), a dense 16 x 16
    matrix; the port's GMRES against JAX's at the PTC's and the
    relaxation modes' settings. Both solve the normal equations
    H^T H y = H^T beta, whose rounding grows with cond(J_G)^2 (8.7e3
    squared here): the tolerance is eps cond^2, 1.7e-8 (measured 7e-10);
    the random matrices above, cond about 10, agree within 1e-10."""
    from chemical_kinetics_and_program_execution_torch.models import (
        ferromagnet,
    )

    tf = tdense.make_dense_dy_dt(
        tdense.compile_dense("ex2-ferromagnetic-chain", 4), device="cpu")
    aug = tst.Augmentation(lambda p, a: tf(p), 2, 4, "auto", None, None,
                           1e-20, torch.device("cpu"))
    p = torch.as_tensor(ferromagnet.ising_gibbs_windows(
        4, J_eff=2.0, h=-0.25, beta=1.0))
    eye = torch.eye(16, dtype=torch.float64)
    M = torch.stack([aug.jvp(p, eye[j], None) for j in range(16)], dim=1)
    b = np.random.default_rng(3).standard_normal(16)
    rtol = np.finfo(np.float64).eps * np.linalg.cond(M.numpy())**2
    assert rtol < 2e-8
    for tol, restart, maxiter in ((1e-8, 50, 8), (1e-11, 60, 8)):
        want = _jax_gmres(M.numpy(), b, tol=tol, restart=restart,
                          maxiter=maxiter)
        got, _ = krylov.gmres(lambda v: M @ v, torch.as_tensor(b), tol=tol,
                              restart=restart, maxiter=maxiter)
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                   atol=rtol * np.abs(want).max())


# --- K6's third table ------------------------------------------------------


def test_kvaerno_rows_and_modes():
    """Rows 26-30 of K6's tableau are Kvaerno 3(2)'s stage bases and
    Newton predictors with the JAX package's coefficients; the Newton
    mode's sum and update, the embedded error's sum and the residual's
    plain versions are the formulas of `ode/kvaerno3.py`, each sum in
    `cuda.block_order_sum`'s order."""
    g, T = j_kv._GAMMA, t_dop.TABLEAU
    assert T[26] == [(0, g)]
    assert T[27] == [(0, j_kv._A31), (1, j_kv._A32)]
    assert T[28] == [(0, j_kv._A41), (1, j_kv._A42), (2, j_kv._A43)]
    assert T[29] == [(1, g)] and T[30] == [(2, g)]
    assert t_dop.KV_C == j_kv._C
    count, _, _ = t_dop.tableau_arrays()
    assert len(count) == len(T) == 38
    rng = np.random.default_rng(8)
    y, dz, z, y_new, f, gg = (torch.as_tensor(rng.standard_normal(300))
                              for _ in range(6))
    rtol, atol = 1e-8, 1e-10
    z0 = z.clone()
    s = t_dop.norms(t_dop._NEWTON, y, rtol, atol, f0=dz, f1=z)
    u = dz / (atol + y.abs() * rtol)
    assert s[0] == cuda.block_order_sum(u * u) and s[1] == 0.0
    assert torch.equal(z, z0 + dz)
    s = t_dop.norms(t_dop._ERR_DIFF, y, rtol, atol, y_new=y_new, f0=z0)
    u = (y_new - z0) / (atol + torch.maximum(y.abs(), y_new.abs()) * rtol)
    assert s[0] == cuda.block_order_sum(u * u)
    np.testing.assert_allclose(
        float(s[0]), float(((y_new - z0) / (atol + np.maximum(
            y.abs(), y_new.abs()) * rtol)).pow(2).sum()), rtol=1e-13)
    out = torch.empty_like(y)
    t_dop.resid(z, gg, f, 0.25, out)
    assert torch.equal(out, z - 0.25 * f - gg)
    ks = t_dop.rows_tensor(4, 300, "cpu")
    ks.copy_(torch.as_tensor(rng.standard_normal((4, 300))))
    for which in (26, 27, 28, 29, 30):
        t_dop.stage(y, ks, 0.1, which, out)
        want = y + 0.1 * sum(c * ks[r] for r, c in T[which])
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-15,
                                   atol=1e-15)


# --- What is not ported raises ----------------------------------------------


def test_reverse_mode_raises():
    """What the reverse mode does not cover yet raises NotImplementedError
    naming its ROADMAP item: backward through the tree and chain closures
    and their J.v (the reverse mode's slice (b)); a second backward
    through the dense closure's K30 backward, through `odeint_fixed`'s
    adjoint in its args and through `make_steady_state`'s implicit
    gradient (a Newton step's grad of grad, as examples/
    ex2_rate_recovery.py:77 takes it), and a derivative through
    `make_dense_dy_dt(with_mass=True)` (the second derivatives and the
    world mass)."""
    p = torch.full((8,), 0.125, dtype=torch.float64, requires_grad=True)
    compiled = tcompile.compile_problem("ex1-radioactive-decay", 3)
    for make in (trhs.make_dy_dt, trhs.make_chain_dy_dt):
        gf = make(compiled, device="cpu")
        with pytest.raises(NotImplementedError, match=SLICE_B):
            gf(p).sum().backward()
        with pytest.raises(NotImplementedError, match=SLICE_B):
            torch.func.jvp(gf, (p.detach(),), (p.detach(),))
    prog = tdense.compile_dense("ex1-radioactive-decay", 3)
    fn = tdense.make_dense_dy_dt(prog, device="cpu")
    (g,) = torch.autograd.grad(fn(p).pow(2).sum(), p, create_graph=True)
    with pytest.raises(NotImplementedError, match=SECOND_ORDER):
        g.sum().backward()
    beta = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    ys = tfixed.odeint_fixed(lambda y, t, b: -b * fn(y), p.detach(),
                             [0.0, 0.5], n_sub=2, args=beta**2,
                             device="cpu")
    (g,) = torch.autograd.grad(ys[-1].pow(2).sum(), beta, create_graph=True)
    with pytest.raises(NotImplementedError, match=SECOND_ORDER):
        g.backward()
    solve = tst.make_steady_state(lambda q, w: w - q, device="cpu")
    p_inf, _ = solve(p.detach(), beta**2 * p.detach())
    (g,) = torch.autograd.grad(p_inf.pow(2).sum(), beta, create_graph=True)
    with pytest.raises(NotImplementedError, match=SECOND_ORDER):
        g.backward()
    pruned = tdense.compile_dense("ex1-radioactive-decay", 3,
                                  prune_threshold=1e-30)
    mass_fn = tdense.make_dense_dy_dt(pruned, device="cpu", with_mass=True)
    with pytest.raises(NotImplementedError, match=SECOND_ORDER):
        mass_fn(p)
