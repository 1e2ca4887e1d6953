"""The port's reverse-mode derivatives against the JAX package (CPU).

The same inputs, made with numpy from a seed, go through the JAX package
and the port on ``device="cpu"``, where the kernels' wrappers run their
plain versions:

- u^T J of the dense RHS (K30's plain version `dense_vjp_plain`)
  against `jax.vjp` of the JAX closure on the 13 cases of
  `tests/test_engine.py:18-32` and a dual program, at a positive p, at
  one with a third of its windows exactly 0 (ties in the guarded ratio)
  and at one with whole contexts dead, drawn as the J v test's
  (`tests/test_torch_jvp.py`): rtol 1e-12 with an absolute floor of
  1e-14 max|p_bar|; autograd through the closures equals the plain
  version bit for bit; at a tie that XLA's fused sums round apart, the
  port's split derivative held to central differences instead;
- w_bar, the cotangent in the worlds' weights, on the `-p` rules
  against `jax.vjp` of the JAX `ParametricDense.dy_dt` in w_const
  (rtol 1e-12, the same floor);
- K30's rules (`csrc/sweep_rule.cuh`, K30 section) built with the host's
  C++ compiler and run phase by phase over the whole plan equal
  `dense_vjp_plain` bit for bit;
- K6's fourth table (DP5's transposed tableau) and the fixed-grid
  adjoint against `jax.vjp` of the JAX `odeint_fixed` (rtol 1e-10);
- the transposed augmented matvec of the steady state (the RHS's v^T J
  less K26's L, which serves unchanged: L is symmetric) against
  `jax.vjp` of the JAX `_aug` (rtol 1e-12);
- twins of the JAX package's gradient tests (`tests/test_steady.py:80,
  :110`, `tests/test_ode.py:386, :418`, `tests/test_parametric.py:74,
  :91, :126, :152, :199, :241`): `grad_observable` and
  `rate_sensitivity` and the parametric gradients within rtol 1e-10 of
  the JAX gradient, the steady state's implicit gradient (whose JAX
  twin costs 45 s) held to central differences and the analytic Ising
  derivative as the JAX test holds it, its forward value to the exact
  Gibbs measure the JAX package's own test pins.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu.engine import (
    build_dy_dt as j_build,
)
from chemical_kinetics_and_program_execution_tpu.engine import dense as jdense
from chemical_kinetics_and_program_execution_tpu.engine import (
    parametric as jparam,
)
from chemical_kinetics_and_program_execution_tpu.models import (
    initial_states as j_init,
)
from chemical_kinetics_and_program_execution_tpu.ode import fixed as jfixed
from chemical_kinetics_and_program_execution_tpu.ode import steady as jst
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.engine import (
    build_dy_dt as t_build,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    dense as tdense,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    parametric as tparam,
)
from chemical_kinetics_and_program_execution_torch.models import (
    ferromagnet,
)
from chemical_kinetics_and_program_execution_torch.models import (
    initial_states as t_init,
)
from chemical_kinetics_and_program_execution_torch.ode import dop853 as t_dop
from chemical_kinetics_and_program_execution_torch.ode import fixed as tfixed
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
RTOL = 1e-12  # with the floor 1e-14 max|p_bar|
GRAD_RTOL = 1e-10  # a whole solve's gradient against JAX's


def _states(n, a, seed):
    """A positive p, one with a third of its windows exactly 0, and one
    whose contexts starting with symbol 0 are dead."""
    rng = np.random.default_rng(seed)
    pos = rng.dirichlet(np.ones(n))
    zeros = pos.copy()
    zeros[rng.random(n) < 1.0 / 3.0] = 0.0
    dead = pos.copy()
    dead[: n // a] = 0.0
    return [x / x.sum() for x in (pos, zeros, dead)]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=1e-14 * np.abs(want).max())


def _jax_vjp(fn, x, u):
    return np.asarray(jax.vjp(fn, jnp.asarray(x))[1](jnp.asarray(u))[0])


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_vjp_matches_jax(tag, cl_k):
    """u^T J of the dense RHS against jax.vjp on three states and a
    normal u each; autograd's backward through the closure (K30's route
    on the CPU) equals `dense_vjp_plain` bit for bit."""
    jf = jdense.make_dense_dy_dt(jdense.compile_dense(tag, cl_k))
    tf = tdense.make_dense_dy_dt(tdense.compile_dense(tag, cl_k),
                                 device="cpu")
    dp = tf.device_program
    n, a = dp.prog.state_size, dp.prog.size_a
    rng = np.random.default_rng(17)
    for p in _states(n, a, 3):
        u = rng.standard_normal(n)
        want = _jax_vjp(jf, p, u)
        pt = torch.tensor(p, requires_grad=True)
        (torch.dot(tf(pt), torch.as_tensor(u))).backward()
        plain, _ = tdense.dense_vjp_plain(dp, torch.as_tensor(p),
                                          torch.as_tensor(u))
        assert torch.equal(pt.grad, plain)
        _close(plain.numpy(), want)


def test_vjp_at_a_tie_xla_rounds_apart():
    """ex1 cl_k 5 at a state whose contexts starting with symbol 0 are
    dead (seed 5's draw): the world's guarded ratio g(P(1), P(.)) is a
    tie, n = d. The port splits the max's derivative 0.5/0.5 there, as
    JAX's rule and K25 do, so its u^T J is the central difference across
    the kink; XLA's fused pyramid sums in the JAX closure round this tie
    apart at this draw (at seed 3's, above, they do not) and give a
    one-sided derivative, twice the port's at the dead windows. So this
    state is held to the transpose of the port's J v (K25's plain
    version, which `tests/test_torch_jvp.py` holds to jax.jvp where the
    ties agree) at every entry to rounding, and at live entries, where a
    step keeps the tie, to central differences of dp/dt (eps 1e-7, rtol
    1e-6). (At a dead window a step off zero can jump a ratio from 0/0
    to 1, so no difference quotient stands there.)"""
    tf = tdense.make_dense_dy_dt(
        tdense.compile_dense("ex1-radioactive-decay", 5), device="cpu")
    dp = tf.device_program
    p = torch.as_tensor(_states(32, 2, 5)[2])
    u = torch.as_tensor(np.random.default_rng(17).standard_normal(32))
    pbar, _ = tdense.dense_vjp_plain(dp, p, u)
    eye = torch.eye(32, dtype=torch.float64)
    jt_u = torch.stack([torch.dot(u, tdense.dense_jvp_plain(dp, p, e))
                        for e in eye])
    np.testing.assert_allclose(pbar.numpy(), jt_u.numpy(), rtol=1e-13,
                               atol=1e-15)
    eps = 1e-7
    for i in (16, 23, 31):
        e = eps * eye[i]
        fd = (torch.dot(u, tf(p + e)) - torch.dot(u, tf(p - e))) / (2 * eps)
        assert float(pbar[i]) == pytest.approx(float(fd), rel=1e-6)


def test_vjp_dual_program_matches_jax():
    """A dual-SPD program (program and data tapes), each tape's
    pyramid transposed into its half of p_bar: against jax.vjp; through
    torch.func.vjp too."""
    tag = "ex3-copolymerization"
    jf = jdense.make_dense_dy_dt(jdense.compile_dense_dual(tag, 3))
    tf = tdense.make_dense_dy_dt(tdense.compile_dense_dual(tag, 3),
                                 device="cpu")
    n = 4**3
    rng = np.random.default_rng(11)
    for zero in (False, True):
        y = np.concatenate([rng.dirichlet(np.ones(n)),
                            rng.dirichlet(np.ones(n))])
        if zero:
            y[rng.random(2 * n) < 1.0 / 3.0] = 0.0
        u = rng.standard_normal(2 * n)
        got = torch.func.vjp(tf, torch.as_tensor(y))[1](torch.as_tensor(u))
        _close(got[0].numpy(), _jax_vjp(jf, y, u))


P_RULES = ["ex2-ferromagnetic-chain-p", "ex3var1-copolymerization-p",
           "ex3var2-copolymerization-p", "ex4-chemical-turing-p",
           "ex4var2-chemical-turing-p"]


@pytest.mark.parametrize("tag", P_RULES)
def test_w_bar_matches_jax(tag):
    """The cotangents in p and in w_const of the parametric RHS at a
    run-time w_const against jax.vjp of the JAX `ParametricDense.dy_dt`
    in (p, w_const); autograd's w.grad equals the plain version's w_bar
    bit for bit."""
    jpd = jparam.ParametricDense(tag, 3)
    tpd = tparam.ParametricDense(tag, 3, device="cpu")
    prog = tpd.prog
    n = prog.state_size
    rng = np.random.default_rng(23)
    p = rng.dirichlet(np.ones(n))
    w = prog.w_const * rng.uniform(0.5, 1.5, prog.num_worlds)
    u = rng.standard_normal(n)
    _, pull = jax.vjp(jax.jit(jpd.dy_dt), jnp.asarray(p), jnp.asarray(w))
    want_p, want_w = (np.asarray(x) for x in pull(jnp.asarray(u)))
    pt = torch.tensor(p, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    torch.dot(tpd.dy_dt(pt, wt), torch.as_tensor(u)).backward()
    plain_p, plain_w = tdense.dense_vjp_plain(
        tpd.dp, torch.as_tensor(p), torch.as_tensor(u),
        w_const=torch.as_tensor(w), want_w=True)
    assert torch.equal(pt.grad, plain_p) and torch.equal(wt.grad, plain_w)
    _close(plain_p.numpy(), want_p)
    _close(plain_w.numpy(), want_w)


def test_guarded_ratio_partials_at_ties_and_the_guard():
    """The guarded ratio's partials as K30 forms them: 0.5/0.5 at a tie
    (JAX's max rule), dg/dn exactly 0 where n > d, both exactly 0 where n
    <= 0 (no NaN at a zero context), n/d's partials where d > n; JAX's
    gradient of the double-where form agrees."""
    def parts(n, d):
        t = [torch.tensor([x], dtype=torch.float64) for x in (n, d)]
        return [x.item() for x in tdense.guarded_ratio_partials(*t)]

    def jax_parts(n, d):
        g = jax.grad(lambda x, y: jnp.where(
            x > 0, x / jnp.where(x > 0, jnp.maximum(x, y), 1.0), 0.0),
            argnums=(0, 1))(jnp.asarray(n), jnp.asarray(d))
        return [float(x) for x in g]

    for n, d in ((0.3, 0.3), (0.2, 0.1), (0.1, 0.2), (0.0, 0.1),
                 (-1e-300, 0.1), (0.0, 0.0)):
        got = parts(n, d)
        np.testing.assert_allclose(got, jax_parts(n, d), rtol=1e-15,
                                   atol=0)
        assert all(np.isfinite(got))
    assert parts(0.2, 0.1)[0] == 0.0
    assert parts(0.0, 0.0) == [0.0, 0.0]
    assert parts(0.3, 0.3) == pytest.approx([0.5 / 0.3, -0.5 / 0.3])


# --- K30's rules, built with the host's C++ compiler ------------------------


_K30_HOST = r"""
#include "sweep_rule.cuh"
extern "C" void k30_host(int tapes, const long long* fwd, int n_fwd,
                         const long long* rv, int n_rv, const int* table,
                         const long long* steps, const int* tab_ptr,
                         const int* tab_steps, const int* sig_ptr,
                         const int* sig_terms, const int* world_ptr,
                         const int* world_sigs, const int* wt_pyr,
                         const int* wt_q, int n_wt, const int* w_num,
                         const int* w_den, const double* w_const, int chain,
                         int n_worlds, const int* pair_num,
                         const int* pair_den, const double* pair_const,
                         const int* csr_ptr, int n_sig, int n_xs,
                         long long n_state, const double* p,
                         const double* low, const double* u,
                         double* scratch, long long work_len, long long n_q,
                         double* pbar, double* wbar, int a, int k) {
  K5Ctx c = {};
  c.a = a;
  c.k = k;
  c.p = p;
  c.low = low;
  c.table = table;
  k5_levels(c);
  c.n_state = (unsigned)n_state;
  const long long w = work_len > 0 ? work_len : 1;
  c.work = scratch;
  K30Ctx v = {};
  v.g = scratch + w;
  v.px = scratch + 2 * w;
  v.xs = scratch + 3 * w;
  v.sbar = v.xs + n_xs;
  double* s = v.sbar + n_sig;
  c.s = s;
  v.q = s + n_sig;
  v.direct = v.q + n_q;
  v.table = table;
  v.steps = steps;
  v.tab_ptr = tab_ptr;
  v.tab_steps = tab_steps;
  v.sig_ptr = sig_ptr;
  v.sig_terms = sig_terms;
  v.world_ptr = world_ptr;
  v.world_sigs = world_sigs;
  v.wt_pyr = wt_pyr;
  v.wt_q = wt_q;
  v.n_wt = n_wt;
  v.w_num = w_num;
  v.w_den = w_den;
  v.w_const = w_const;
  v.chain = chain;
  v.n_worlds = n_worlds;
  v.n_sig = n_sig;
  v.n_xs = n_xs;
  v.tapes = tapes;
  unsigned pos = 0;
  for (int j = 1; j <= k; ++j) {
    v.off_le[j] = pos;
    pos += c.pw[j];
  }
  v.off_re = pos;
  v.rat_len = pos + c.pw[k];
  v.low_block = c.lv_off[0] + 2;
  v.u = u;
  v.pbar = pbar;
  v.wbar = wbar;
  K4Pairs pr;
  pr.num = pair_num;
  pr.den = pair_den;
  pr.w_const = pair_const;
  pr.csr_ptr = csr_ptr;
  pr.chain = chain;
  for (int g = 0; g < n_sig; ++g) {  // phase 0, each warp's pair order
    double acc = 0.0;
    for (int q = csr_ptr[g]; q < csr_ptr[g + 1]; ++q)
      acc = acc + k4_pair_weight(c, pr, q);
    s[g] = acc;
  }
  for (int q = 0; q < n_fwd; ++q) {  // the phases in turn
    const K5Item it = k5_item(fwd + (long long)q * K5_FIELDS, c);
    for (unsigned e = 0; e < it.n; ++e) {
      if (tapes == 2)
        k30_forward<true>(c, v, it, e);
      else
        k30_forward<false>(c, v, it, e);
    }
  }
  for (int q = 0; q < n_rv; ++q) {
    const long long* r = rv + (long long)q * kK30Row;
    for (long long e = 0; e < r[RV_N]; ++e) k30_reverse(c, v, r, (unsigned)e);
  }
  for (unsigned x = 0; x < (unsigned)tapes * v.rat_len; ++x)
    k30_table_entry(c, v, x);
  for (int g = 0; g < n_sig; ++g) k30_signature(c, v, g);
  for (int q = 0; q < n_worlds; ++q) k30_world(c, v, q);
  const unsigned n_pyr = (unsigned)n_state + (unsigned)tapes * v.low_block;
  for (unsigned y = 0; y < n_pyr; ++y) k30_direct(c, v, y);
  for (unsigned y = 0; y < (unsigned)n_state; ++y) k30_pbar(c, v, y);
}
"""


@pytest.fixture(scope="module")
def k30_host(tmp_path_factory):
    """K30's rules built with the host's C++ compiler without
    contraction, run phase by phase as the kernel's phases order them:
    K4's weights in pair order, the forward items, the reverse items,
    the ratio-table entries, the signatures, the worlds, the pyramid's
    entries and p_bar."""
    cxx = next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                      "clang++")) if c), None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k30")
    (out / "k30.cpp").write_text(_K30_HOST)
    lib = out / "libk30.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib),
                    str(out / "k30.cpp")], check=True, capture_output=True,
                   timeout=120)
    fn = ctypes.CDLL(str(lib)).k30_host
    i, L, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = ([i, p, i, p, i] + [p] * 10 + [i, p, p, p, i, i]
                   + [p] * 4 + [i, i, L] + [p] * 4 + [L, L, p, p, i, i])
    fn.restype = None
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.mark.parametrize("tag,cl_k,dual", [
    ("ex4-chemical-turing", 3, False), ("ex4var2-chemical-turing", 3, False),
    ("ex2-ferromagnetic-chain", 5, False), ("ex3var1-copolymerization", 4,
                                            False),
    ("ex6-mini-bff-lite", 2, False), ("ex3-copolymerization", 3, True)])
def test_k30_rule_matches_plain(k30_host, tag, cl_k, dual):
    """K30's rules over the whole plan equal `dense_vjp_plain` bit for
    bit, p_bar and w_bar, at a positive p, at one with zero windows
    (ties) and at one with dead contexts and a run-time w_const; the
    interior ops of a long signature included (ex6-mini-bff-lite)."""
    prog = (tdense.compile_dense_dual(tag, cl_k) if dual
            else tdense.compile_dense(tag, cl_k))
    dp = tdense.device_program(prog, "cpu")
    n, a = prog.state_size, prog.size_a
    vt = tdense.vjp_tables(dp)
    vp = vt["plan"]
    rng = np.random.default_rng(5)
    w_alt = torch.as_tensor(prog.w_const * rng.uniform(0.5, 1.5,
                                                       prog.num_worlds))
    for q, (p_np, w_const) in enumerate(zip(_states(n, a, 9),
                                            (None, None, w_alt))):
        p = torch.as_tensor(p_np)
        u = torch.as_tensor(rng.standard_normal(n))
        low = tdense.pyramids(prog, p, plain=True)
        want_p, want_w = tdense.dense_vjp_plain(dp, p, u, low, w_const, True)
        scratch = torch.full((tdense._k30_scratch(dp, vp),), np.nan,
                             dtype=torch.float64)
        pbar = torch.full((n,), np.nan, dtype=torch.float64)
        wbar = torch.full((prog.num_worlds,), np.nan, dtype=torch.float64)
        wc = dp.w_const if w_const is None else w_const
        k30_host(1 + prog.dual, _ptr(vt["fwd_items"]), len(vp.fwd_items),
                 _ptr(vt["rv_items"]), len(vp.rv_items),
                 *[_ptr(vt[x]) for x in (
                     "table", "steps", "tab_ptr", "tab_steps", "sig_ptr",
                     "sig_terms", "world_ptr", "world_sigs", "wt_pyr",
                     "wt_q")],
                 len(vp.wt_pyr), _ptr(dp.w_num), _ptr(dp.w_den), _ptr(wc),
                 prog.w_num.shape[1], prog.num_worlds, _ptr(dp.pair_num),
                 _ptr(dp.pair_den), _ptr(tdense.pair_consts(dp, w_const)),
                 _ptr(dp.csr_ptr), prog.num_signatures, vp.n_xs, n, _ptr(p),
                 _ptr(low), _ptr(u), _ptr(scratch), dp.plan.work_size,
                 tdense.vjp_partials(prog), _ptr(pbar), _ptr(wbar), a, cl_k)
        assert torch.equal(pbar, want_p)
        assert torch.equal(wbar, want_w)
        assert q or bool((want_p != 0).any())  # dead contexts may stop all


def test_vjp_plan_layout():
    """K30's plan: the forward's items are K5's compute items by level,
    each phase's elements counted from 0; the reverse phases descend
    from the deepest level to 0, then the seeds, whose cotangents fill
    ``n_xs`` slots; every step has at most two readers, and each ratio
    table lists its steps in plan order."""
    dp = tdense.device_program(
        tdense.compile_dense("ex4-chemical-turing", 3), "cpu")
    vp = tdense.vjp_tables(dp)["plan"]
    steps = dp.plan.steps
    compute = [i for i, s in enumerate(steps) if s.kind != tdense.INTERIOR]
    levels = [steps[i].level for i in compute]
    assert len(vp.fwd_items) == len(compute)
    assert len(vp.fwd_ptr) - 1 == max(levels) + 1
    seeds = sum(1 for i in compute if steps[i].src < 0)
    assert len(vp.rv_items) == len(compute) + seeds
    assert len(vp.rv_ptr) - 1 == max(levels) + 2
    last = vp.rv_items[vp.rv_ptr[-2]:vp.rv_ptr[-1]]
    assert (last[:, tdense.RV_FIELDS.index("seed")] == 1).all()
    assert vp.n_xs == int(last[:, 1].sum())
    for ph in range(len(vp.rv_ptr) - 1):
        rows = vp.rv_items[vp.rv_ptr[ph]:vp.rv_ptr[ph + 1]]
        assert (rows[:, 0] == np.concatenate([[0], np.cumsum(rows[:, 1])[
            :-1]])).all()
    assert all(len(r) <= tdense.MAX_READERS for r in vp.readers)
    for s in range(len(vp.tab_ptr) - 1):
        lst = vp.tab_steps[vp.tab_ptr[s]:vp.tab_ptr[s + 1]]
        assert (np.diff(lst) > 0).all()
    assert vp.nbytes > 0


# --- K6's fourth table and the fixed-grid adjoint ----------------------------


def test_adjoint_rows_are_the_transposed_tableau():
    """Rows 31-36 of K6's tableau are DP5's stage cotangents (B5_l on
    y_bar's row 7, A_ml on z_m for l < m < 6, their nonzero terms) and
    row 37 sums z_0 .. z_5; the plain stage on them is the formula."""
    A, B5 = t_dop.DP5_A, t_dop.DP5_B5
    for lo, row in enumerate(t_dop.DP5_ADJ_ROWS):
        want = [(7, B5[lo])] if B5[lo] else []
        want += [(m, A[m][lo]) for m in range(lo + 1, 6) if A[m][lo]]
        assert t_dop.TABLEAU[row] == want
    assert t_dop.TABLEAU[t_dop.DP5_ADJ_SUM] == [(m, 1.0) for m in range(6)]
    rng = np.random.default_rng(4)
    adj = t_dop.rows_tensor(8, 50, "cpu")
    adj.copy_(torch.as_tensor(rng.standard_normal((8, 50))))
    out = torch.empty(50, dtype=torch.float64)
    zero = torch.zeros(50, dtype=torch.float64)
    for lo, row in enumerate(t_dop.DP5_ADJ_ROWS):
        t_dop.stage(zero, adj, 0.1, row, out)
        want = 0.1 * (B5[lo] * adj[7] + sum(A[m][lo] * adj[m]
                                            for m in range(lo + 1, 6)))
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-13,
                                   atol=1e-15)
    t_dop.stage(adj[7], adj, 1.0, t_dop.DP5_ADJ_SUM, out)
    np.testing.assert_allclose(out.numpy(), (adj[7] + adj[:6].sum(0)).numpy(),
                               rtol=1e-14, atol=1e-15)


def test_fixed_adjoint_matches_jax_vjp():
    """The cotangent of every sample (not only the last) through
    `odeint_fixed` on ex2 cl_k 3: the port's adjoint against jax.vjp of
    the JAX `odeint_fixed` (rtol 1e-10), for y0 and for args passed as
    a dict of tensors (a time-scaled RHS)."""
    jd, _ = j_build("ex2-ferromagnetic-chain", 3)
    td, _ = t_build("ex2-ferromagnetic-chain", 3, device="cpu")
    p0 = j_init.ferromagnet_p0(3, p_pair=0.05, corrected=True).ravel()
    ts = np.linspace(0.0, 2.0, 4)
    g = np.random.default_rng(2).standard_normal((4, 8))
    ys_j, pull = jax.vjp(
        lambda y, s: jfixed.odeint_fixed(lambda x, t, a: a["s"] * jd(x), y,
                                         ts, 4, args={"s": s}),
        jnp.asarray(p0), jnp.asarray(1.3))
    want_y, want_s = pull(jnp.asarray(g))
    y0 = torch.tensor(p0, requires_grad=True)
    s = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    ys = tfixed.odeint_fixed(lambda x, t, a: a["s"] * td(x), y0, ts, 4,
                             args={"s": s, "name": "kept"})
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j),
                               rtol=1e-13, atol=1e-16)
    (ys * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(y0.grad.numpy(), np.asarray(want_y),
                               rtol=GRAD_RTOL, atol=1e-14)
    np.testing.assert_allclose(float(s.grad), float(want_s), rtol=GRAD_RTOL)


def test_fixed_grid_gradient_matches_jax():
    """Twin of `tests/test_ode.py:386`: `grad_observable` on ex1 cl_k 3
    (11 samples on [0, 2], n_sub 8, sum y^2) against the JAX package's
    (rtol 1e-10) and against central differences of the port's forward
    solve at two entries (rtol 1e-6, as the JAX test at all eight)."""
    jd, _ = j_build("ex1-radioactive-decay", 3)
    td, _ = t_build("ex1-radioactive-decay", 3, device="cpu")
    p0 = np.full(8, 0.125)
    ts = np.linspace(0.0, 2.0, 11)
    want_v, want = jfixed.grad_observable(
        lambda y, t: jd(y), jnp.asarray(p0), jnp.asarray(ts),
        lambda y: jnp.sum(y**2), 8)
    v, g = tfixed.grad_observable(lambda y, t: td(y), p0, ts,
                                  lambda y: (y**2).sum(), 8, device="cpu")
    assert float(v) == pytest.approx(float(want_v), rel=1e-13)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=GRAD_RTOL)
    eps = 1e-6
    for i in (0, 7):
        ends = []
        for sign in (1.0, -1.0):
            pp = p0.copy()
            pp[i] += sign * eps
            y = tfixed.odeint_fixed(lambda y, t: td(y), pp, ts, 8,
                                    device="cpu")[-1]
            ends.append(float((y**2).sum()))
        np.testing.assert_allclose(float(g[i]), (ends[0] - ends[1])
                                   / (2 * eps), rtol=1e-6, atol=1e-9)


def test_inverse_design_recovers_pair_density():
    """Twin of `tests/test_ode.py:418`: Newton on (p(DUUD)(10) -
    target)^2 through the solve from `ferromagnet_p0_traced` (ex2 cl_k 4,
    6 samples, n_sub 8) recovers p_pair 0.013 within 1e-5; the first
    step's value and gradient equal the JAX package's (rtol 1e-10)."""
    cl_k = 4
    jd, _ = j_build("ex2-ferromagnetic-chain", cl_k)
    td, _ = t_build("ex2-ferromagnetic-chain", cl_k, device="cpu")
    ts = np.linspace(0.0, 10.0, 6)

    def j_final(x):
        ys = jfixed.odeint_fixed(lambda y, t: jd(y),
                                 j_init.ferromagnet_p0_traced(cl_k, x),
                                 jnp.asarray(ts), n_sub=8)
        return ys[-1, 0b0110]

    def t_final(x):
        ys = tfixed.odeint_fixed(lambda y, t: td(y),
                                 t_init.ferromagnet_p0_traced(cl_k, x), ts,
                                 n_sub=8)
        return ys[-1, 0b0110]

    target = float(t_final(torch.tensor(0.013, dtype=torch.float64)))
    assert target == pytest.approx(float(j_final(0.013)), rel=1e-13)
    j_loss = jax.value_and_grad(lambda x: (j_final(x) - target) ** 2)
    x = torch.tensor(0.005, dtype=torch.float64)
    for it in range(40):
        xl = x.clone().requires_grad_(True)
        v = (t_final(xl) - target) ** 2
        (g,) = torch.autograd.grad(v, xl)
        if it == 0:
            jv, jg = j_loss(jnp.asarray(0.005))
            assert float(v) == pytest.approx(float(jv), rel=1e-12)
            assert float(g) == pytest.approx(float(jg), rel=GRAD_RTOL)
        if float(v) < 1e-24:
            break
        x = torch.clamp(x - 2.0 * v.detach() / g, 1e-4, 0.05)
    assert abs(float(x) - 0.013) < 1e-5


# --- The parametric gradients ------------------------------------------------


def _iid(psym, cl_k):
    p = np.asarray(psym)
    for _ in range(cl_k - 1):
        p = np.multiply.outer(p, psym)
    return p.ravel()


PARAM_CASES = [
    # (rule, cl_k, knob, value, state, probe): tests/test_parametric.py
    # :74, :126, :152 and :241's two.
    ("ex2-ferromagnetic-chain-p", 4, "beta", 1.0,
     lambda: j_init.ferromagnet_p0(4, p_pair=0.02, corrected=True).ravel(),
     lambda n: np.linspace(0.5, 1.5, n)),
    ("ex4-chemical-turing-p", 3, "suppression", 0.05,
     lambda: j_init.chemical_turing_p0(3).ravel(),
     lambda n: np.linspace(-1.0, 1.0, n)),
    ("ex4var2-chemical-turing-p", 3, "G_D", 1.5,
     lambda: j_init.chemical_turing_v2_p0(3).ravel(),
     lambda n: np.linspace(-1.0, 1.0, n)),
    ("ex3var1-copolymerization-p", 4, "q_reject", 0.75,
     lambda: _iid([0.7, 0.1, 0.1, 0.1], 4),
     lambda n: np.random.RandomState(0).rand(n)),
    ("ex3var2-copolymerization-p", 4, "k_rev", 1.0 / 50.0,
     lambda: _iid([0.7, 0.1, 0.1, 0.1], 4),
     lambda n: np.random.RandomState(0).rand(n)),
]


@pytest.mark.parametrize("tag,cl_k,knob,value,state,probe", PARAM_CASES,
                         ids=[c[0] for c in PARAM_CASES])
def test_parametric_rhs_gradient_matches_jax(tag, cl_k, knob, value, state,
                                             probe):
    """Twins of `tests/test_parametric.py:74, :126, :152, :241`: d(v .
    dp/dt)/d(knob) by autograd through `traced_consts` and K30's w_bar
    against jax.grad of the same function (rtol 1e-10), and against
    central differences (rtol 1e-6, as the JAX tests)."""
    jpd = jparam.ParametricDense(tag, cl_k)
    tpd = tparam.ParametricDense(tag, cl_k, device="cpu")
    defaults = jpd.problem.param_defaults
    p = state()
    v = probe(p.shape[0])

    def j_scalar(x):
        prm = dict(defaults)
        prm[knob] = x
        return jnp.vdot(jnp.asarray(v), jpd(jnp.asarray(p), prm))

    def t_scalar(x):
        prm = dict(defaults)
        prm[knob] = x
        return torch.dot(torch.as_tensor(v), tpd(torch.as_tensor(p), prm))

    want = float(jax.jit(jax.grad(j_scalar))(jnp.asarray(value,
                                                          jnp.float64)))
    x = torch.tensor(value, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(t_scalar(x), x)
    assert float(g) == pytest.approx(want, rel=GRAD_RTOL)
    eps = 1e-6
    with torch.no_grad():
        fd = (float(t_scalar(torch.tensor(value + eps, dtype=torch.float64)))
              - float(t_scalar(torch.tensor(value - eps,
                                            dtype=torch.float64)))) / (
            2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=1e-5)
    if tag.startswith("ex3"):  # the knob moves the flow (:241 asserts it)
        assert abs(float(g)) > 1e-6


def test_rate_sensitivity_matches_jax():
    """Twin of `tests/test_parametric.py:91`: `rate_sensitivity` on
    ex2-ferromagnetic-chain-p cl_k 3 (6 samples on [0, 5], n_sub 6, the
    window 011): the value and every parameter's gradient against the
    JAX package's (rtol 1e-10)."""
    p0 = j_init.ferromagnet_p0(3, p_pair=0.02, corrected=True).ravel()
    ts = np.linspace(0.0, 5.0, 6)
    value, grads = jparam.rate_sensitivity(
        "ex2-ferromagnetic-chain-p", 3, p0, ts, lambda y: y[0b011], n_sub=6)
    v2, g2 = tparam.rate_sensitivity(
        "ex2-ferromagnetic-chain-p", 3, p0, ts, lambda y: y[0b011], n_sub=6,
        device="cpu")
    assert set(g2) == {"J", "h", "beta"}
    assert float(v2) == pytest.approx(float(value), rel=1e-12)
    for k in grads:
        assert float(g2[k]) == pytest.approx(float(grads[k]),
                                             rel=GRAD_RTOL)


def test_time_dependent_protocol_gradient_matches_jax():
    """Twin of `tests/test_parametric.py:199`: beta(t) by linear
    interpolation of three knots, passed as ``args``, the consts formed
    at each stage; d p(UUU)(5) / d knots against jax.grad (rtol 1e-10),
    through a tensor ``args`` whose graph reaches the knots."""
    cl_k = 3
    jpd = jparam.ParametricDense("ex2-ferromagnetic-chain-p", cl_k)
    tpd = tparam.ParametricDense("ex2-ferromagnetic-chain-p", cl_k,
                                 device="cpu")
    defaults = dict(jpd.problem.param_defaults)
    knots = np.linspace(0.0, 5.0, 3)
    ts = np.linspace(0.0, 5.0, 3)
    p0 = np.full(2**cl_k, 1.0 / 2**cl_k)
    theta0 = np.asarray([0.3, 0.8, 1.2])

    def j_obs(theta):
        def rhs(y, t, th):
            prm = dict(defaults)
            prm["beta"] = jnp.interp(t, jnp.asarray(knots), th)
            return jpd(y, prm)
        return jfixed.odeint_fixed(rhs, jnp.asarray(p0), jnp.asarray(ts),
                                   n_sub=20, args=theta)[-1, -1]

    def t_interp(t, th):
        j = min(int(np.searchsorted(knots, t, side="right")) - 1,
                len(knots) - 2)
        f = (t - knots[j]) / (knots[j + 1] - knots[j])
        return th[j] * (1.0 - f) + th[j + 1] * f

    def t_rhs(y, t, th):
        prm = dict(defaults)
        prm["beta"] = t_interp(t, th)
        return tpd(y, prm)

    want = np.asarray(jax.jit(jax.grad(j_obs))(jnp.asarray(theta0)))
    th = torch.tensor(theta0, requires_grad=True)
    ys = tfixed.odeint_fixed(t_rhs, p0, ts, n_sub=20, args=th,
                             device="cpu")
    (g,) = torch.autograd.grad(ys[-1, -1], th)
    np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_RTOL)


# --- The steady state's implicit gradient ------------------------------------


def test_k26_serves_the_transposed_matvec():
    """L is symmetric, so the transposed augmented matvec is the RHS's
    v^T J less K26's L: `Augmentation.vjp` against jax.vjp of the JAX
    package's `_aug` at the same state, on ex2 cl_k 3 ("auto": the
    magnetisation conserved, L = C^T C + 1 1^T / S + c c^T) and in
    support mode (a third of the windows dead: masked, u kept off the
    support) (rtol 1e-12)."""
    for tag, conserved in (("ex2-ferromagnetic-chain", "auto"),
                           ("ex2-ferromagnetic-chain", "support")):
        jd, _ = j_build(tag, 3)
        td, _ = t_build(tag, 3, device="cpu")
        a = td.device_program.prog.size_a
        n = a**3
        rng = np.random.default_rng(6)
        p = rng.dirichlet(np.ones(n))
        guess = p.copy()
        if conserved == "support":
            guess[rng.random(n) < 0.3] = 0.0
        _aug, _targets, mask, _, vals, _ = jst._build_augmentation(
            lambda q, _a: jd(q), a, 3, conserved, None, guess, 1e-20)
        targets = _targets(jnp.asarray(guess))
        u = rng.standard_normal(n)
        want = _jax_vjp(lambda q: _aug(q, None, targets),
                        np.where(np.asarray(mask), p, 0.0)
                        if mask is not None else p, u)
        # The JAX package's conserved weights (and support), read back
        # through its `_cons_vals`: the probed null spaces agree with the
        # port's only to the probes' rounding.
        eye = np.eye(n)
        if conserved == "support":
            aug = tst.Augmentation(lambda q, _a: td(q), a, 3, conserved,
                                   None, guess, 1e-20, torch.device("cpu"))
            aug.mask = torch.as_tensor(np.asarray(mask))
            aug.cons_w = torch.as_tensor(np.stack(
                [np.asarray(vals(jnp.asarray(e))) for e in eye], axis=1))
        else:
            c_norm = float(a) ** ((3 - 1) / 2.0)
            w = c_norm * np.stack([np.asarray(vals(jnp.asarray(eye[x * a**2])))
                                   for x in range(a)], axis=1)
            aug = tst.Augmentation(lambda q, _a: td(q), a, 3, w, None, None,
                                   1e-20, torch.device("cpu"))
        pt = torch.as_tensor(p)
        if aug.mask is not None:
            pt = torch.where(aug.mask, pt, 0.0)
        got = aug.vjp(pt, torch.as_tensor(u), None)
        _close(got.numpy(), want)


def _steady_solver(cl_k):
    pd = tparam.ParametricDense("ex2-ferromagnetic-chain-p", cl_k,
                                device="cpu")
    defaults = {k: torch.tensor(float(v), dtype=torch.float64)
                for k, v in pd.problem.param_defaults.items()}
    solve = tst.make_steady_state(lambda p, w: pd.dy_dt(p, w), size_a=2,
                                  cl_k=cl_k, tol=1e-14,
                                  probe_args=pd.consts(defaults),
                                  device="cpu")

    def at(beta):
        prm = dict(defaults)
        prm["beta"] = beta
        return solve(torch.as_tensor(_gibbs(cl_k)), pd.consts(prm))

    return at


def _gibbs(cl_k, beta=1.0):
    return ferromagnet.ising_gibbs_windows(cl_k, J_eff=2.0, h=-0.25,
                                           beta=beta)


def test_implicit_gradient_matches_finite_differences():
    """Twin of `tests/test_steady.py:80` (ex2-ferromagnetic-chain-p cl_k
    3, tol 1e-14): d(v . p_inf)/d(beta) by the implicit gradient against
    central differences of two full solves (eps 1e-4, rtol 1e-6, as the
    JAX test; the JAX gradient itself costs 45 s); the forward p_inf at
    the exact Ising Gibbs measure (atol 1e-12), and at beta 1 + eps, a
    solve that moves off its guess, within 1e-12 of the JAX package's."""
    at = _steady_solver(3)
    v = torch.linspace(-1.0, 1.0, 8, dtype=torch.float64)
    beta = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    p_inf, info = at(beta)
    assert info.converged
    np.testing.assert_allclose(p_inf.detach().numpy(), _gibbs(3), rtol=0,
                               atol=1e-12)
    (g,) = torch.autograd.grad(torch.dot(v, p_inf), beta)
    eps = 1e-4
    hi = at(torch.tensor(1.0 + eps, dtype=torch.float64))[0]
    fd = (float(torch.dot(v, hi))
          - float(torch.dot(v, at(torch.tensor(1.0 - eps,
                                                dtype=torch.float64))[0]))
          ) / (2 * eps)
    assert fd != 0.0
    np.testing.assert_allclose(float(g), fd, rtol=1e-6)
    jpd = jparam.ParametricDense("ex2-ferromagnetic-chain-p", 3)
    prm = {x: jnp.asarray(y, jnp.float64)
           for x, y in jpd.problem.param_defaults.items()}
    j_solve = jst.make_steady_state(lambda q, w: jpd.dy_dt(q, w), size_a=2,
                                    cl_k=3, tol=1e-14,
                                    probe_args=jpd.consts(prm))
    prm["beta"] = jnp.asarray(1.0 + eps)
    want, j_info = j_solve(jnp.asarray(_gibbs(3)), jpd.consts(prm))
    assert bool(j_info.converged)
    np.testing.assert_allclose(hi.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_gibbs_sensitivity_cross_check():
    """Twin of `tests/test_steady.py:110`: d p_inf(UUU)/d(beta) by the
    implicit gradient against the derivative of the analytic Ising
    window probability (central differences, eps 1e-5: rtol 1e-5, as
    the JAX test)."""
    at = _steady_solver(3)
    beta = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(at(beta)[0][-1], beta)
    eps = 1e-5
    fd = (_gibbs(3, 1.0 + eps)[-1] - _gibbs(3, 1.0 - eps)[-1]) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-5)
