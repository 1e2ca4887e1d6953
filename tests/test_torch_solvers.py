"""Parity of the port's loose-tolerance steppers with the JAX package (CPU).

dopri5 (`ode/dopri5.py`) and the step-clamped DOP853 (``"dop853-step"``,
`ode/dop853.py:odeint_dop853`) run on ``device="cpu"``, where K6's
wrappers take their plain versions, against the JAX package's
`ode/dopri5.py:odeint_dopri5` and `ode/dop853.py:odeint_dop853` through
both packages' `solve`. Twins of `tests/test_ode.py`'s dopri5 tests, the
routing test and the dense-against-step-clamped test; the steppers
walking the JAX steppers' steps (equal accepted and rejected counts,
samples at rtol 1e-12, atol 1e-14: the same steps, the arithmetic to
rounding); K6's dopri5 rows equal to the JAX tableau; dopri5's error sum
in K6's order.

Where the steps are walked: a stepper's accept and clamp decisions are
taken on error estimates that cancel; a one-ulp change in dp/dt or in
a stage sum can move a step onto or off a sample time. XLA on the CPU
fuses products into sums (an FMA), the port's plain versions and
kernels do not (`-fmad=false`), and their dp/dt agree to rounding, not
to the bit. So the grids below are ones where both packages' steps do
not hang on rounding. One where they do: ex2 at cl_k 3 on the 1,001
samples of `examples/ex2_ferromagnet_tape.py` at 1e-9, where dopri5
takes 1,036 accepted steps in the JAX package and 1,034 in the port,
and the JAX stepper fed the port's dp/dt takes another count again.

The twins of the JAX package's dopri5 tests call `solve` as those do
(their tolerances below 1e-9 route to the dense DOP853): the same steps
and samples as the JAX package. Called again with ``method="dopri5"``,
they hold the closed form as the JAX tests do and the JAX solve to
rtol 1e-9 (`_JAX_DOPRI5`), not the same steps: at rtol 1e-10, atol 1e-12
the error estimate of dopri5's first step is a sum of stage values that
agree to about h^5 (1e-12), so one ulp of a stage moves it in the fourth
digit; even with the exact dp/dt of y' = -y the JAX package's (XLA's
FMAs) and the port's arithmetic give 8.0954e-6 and 8.0957e-6 there, and
277 and 275 accepted steps over the run.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu import (
    markov_tapes as j_markov_tapes,
)
from chemical_kinetics_and_program_execution_tpu.engine import dense as jdense
from chemical_kinetics_and_program_execution_tpu.ode import dopri5 as j_dp5
from chemical_kinetics_and_program_execution_tpu.ode.integrate import (
    solve as j_solve,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch import (
    markov_tapes as t_markov_tapes,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    build_dy_dt as t_build,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    dense as tdense,
)
from chemical_kinetics_and_program_execution_torch.models import (
    initial_states as t_init,
)
from chemical_kinetics_and_program_execution_torch.ode import dop853 as t_dop
from chemical_kinetics_and_program_execution_torch.ode import dopri5 as t_dp5
from chemical_kinetics_and_program_execution_torch.ode.integrate import (
    solve as t_solve,
)

# Samples of the same steps: the arithmetic agrees to rounding.
RTOL, ATOL = 1e-12, 1e-14
# Two dopri5 solves of these tolerances that take different steps.
_JAX_DOPRI5 = 1e-9


def _held_to_jax(got, want, method, info=None, jinfo=None):
    if method is None:  # the dense DOP853: the JAX stepper's steps
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        if info is not None:
            assert info["num_accepted"] == int(jinfo["num_accepted"])
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=_JAX_DOPRI5,
                                   atol=ATOL)
EXAMPLES = __import__("pathlib").Path(__file__).resolve().parents[1] / \
    "examples"


# --- twins of tests/test_ode.py ---------------------------------------------------


@pytest.mark.parametrize("method", [None, "dopri5"])
def test_dopri5_exponential_decay(method):
    ts = np.linspace(0.0, 5.0, 51)
    ys, info = t_solve(lambda y, t: -y, np.array([1.0, 2.0]), ts,
                       rtol=1e-10, atol=1e-12, return_info=True,
                       method=method, device="cpu")
    want = np.exp(-ts)[:, None] * np.array([1.0, 2.0])
    np.testing.assert_allclose(ys, want, rtol=1e-8, atol=1e-10)
    jys, jinfo = j_solve(lambda y, t: -y, jnp.array([1.0, 2.0]), ts,
                         rtol=1e-10, atol=1e-12, return_info=True,
                         method=method)
    _held_to_jax(ys, jys, method, info, jinfo)


@pytest.mark.parametrize("method", [None, "dopri5"])
def test_dopri5_harmonic_oscillator(method):
    ts = np.linspace(0.0, 10.0, 101)
    ys = t_solve(lambda y, t: torch.stack([y[1], -y[0]]),
                 np.array([1.0, 0.0]), ts, rtol=1e-11, atol=1e-12,
                 method=method, device="cpu")
    np.testing.assert_allclose(ys[:, 0], np.cos(ts), atol=1e-8)
    np.testing.assert_allclose(ys[:, 1], -np.sin(ts), atol=1e-8)
    jys = j_solve(lambda y, t: jnp.stack([y[1], -y[0]]),
                  jnp.array([1.0, 0.0]), ts, rtol=1e-11, atol=1e-12,
                  method=method)
    _held_to_jax(ys, jys, method)


@pytest.mark.parametrize("method", [None, "dopri5"])
def test_dopri5_nonautonomous(method):
    ts = np.linspace(0.0, 2.0, 21)
    ys = t_solve(lambda y, t: 2 * t * y, np.array([1.0]), ts, rtol=1e-10,
                 atol=1e-12, method=method, device="cpu")
    np.testing.assert_allclose(ys[:, 0], np.exp(ts**2), rtol=1e-7)
    jys = j_solve(lambda y, t: 2 * t * y, np.array([1.0]), ts, rtol=1e-10,
                  atol=1e-12, method=method)
    _held_to_jax(ys, jys, method)


def test_solve_method_routing():
    """Every method name reaches a stepper (scipy names such as RK45 land
    on DOP853, as in the JAX package); the unnamed method at loose
    tolerances is dopri5, and it takes dopri5's steps."""
    ts = np.linspace(0.0, 1.0, 5)
    for method in (None, "dopri5", "dop853", "DOP853", "dop853-step",
                   "RK45"):
        ys = t_solve(lambda y, t: -y, np.array([1.0]), ts, rtol=1e-12,
                     atol=1e-12, method=method, device="cpu")
        np.testing.assert_allclose(ys[:, 0], np.exp(-ts), rtol=1e-9)
    infos = [t_solve(lambda y, t: -y, np.array([1.0]), ts, rtol=1e-6,
                     atol=1e-6, method=m, return_info=True,
                     device="cpu")[1] for m in (None, "dopri5")]
    assert infos[0] == infos[1]


def test_dense_output_matches_step_clamped_with_fewer_steps():
    """The dense-output stepper reproduces the step-clamped DOP853
    trajectory while taking fewer steps on a dense sample grid."""
    fn, prog = t_build("ex2-ferromagnetic-chain", 4, device="cpu")
    p0 = np.full(prog.state_size, 1.0 / prog.state_size)
    ts = np.linspace(0.0, 20.0, 801)  # dense grid: clamping binds
    kwargs = dict(rtol=1e-12, atol=1e-12, return_info=True, device="cpu")
    ys_dense, info_dense = t_solve(lambda y, t: fn(y), p0, ts,
                                   method="dop853", **kwargs)
    ys_step, info_step = t_solve(lambda y, t: fn(y), p0, ts,
                                 method="dop853-step", **kwargs)
    np.testing.assert_allclose(ys_dense, ys_step, rtol=1e-8, atol=1e-12)
    assert info_dense["num_accepted"] < info_step["num_accepted"] / 2


def test_dop853_step_tight_tolerance_oscillator():
    """The step-clamped DOP853 at 1e-13 over many periods, as the JAX
    package's test: phase error at the 1e-10 level, far fewer steps than
    dopri5 at the same tolerance; the same steps as the JAX stepper."""
    ts = np.linspace(0.0, 20.0, 41)
    y0 = torch.tensor([1.0, 0.0], dtype=torch.float64)

    def rhs(y, t):
        return torch.stack([y[1], -y[0]])

    ys, info = t_dop.odeint_dop853(rhs, y0, ts, (1e-13, 1e-13))
    assert info.completed
    np.testing.assert_allclose(ys[:, 0].numpy(), np.cos(ts), atol=5e-11)
    _, info5 = t_dp5.odeint_dopri5(rhs, y0, ts, (1e-13, 1e-13))
    assert info.num_accepted < info5.num_accepted / 3
    jys, jinfo = j_solve(lambda y, t: jnp.stack([y[1], -y[0]]),
                         np.array([1.0, 0.0]), ts, rtol=1e-13, atol=1e-13,
                         method="dop853-step", return_info=True)
    assert info.num_accepted == int(jinfo["num_accepted"])
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=RTOL,
                               atol=ATOL)


# --- the JAX steppers' steps ------------------------------------------------------


def _p0(tag, cl_k):
    if tag.startswith("ex2"):  # examples/ex2_ferromagnet_tape.py's p0
        return t_init.ferromagnet_p0(cl_k, p_pair=1 / 250).ravel()
    return t_init.copolymerization_p0(cl_k).ravel()


_WALKS = [
    # (rule, cl_k, t_end, samples, tol)
    ("ex2-ferromagnetic-chain", 3, 20.0, 41, 1e-9),
    ("ex2-ferromagnetic-chain", 3, 20.0, 41, 1e-6),
    # examples/ex3_copolymerization.py's var2 grid and tolerance
    ("ex3var2-copolymerization", 4, 200.0, 1001, 1e-9),
    ("ex3var2-copolymerization", 4, 200.0, 21, 1e-6),
]


@pytest.mark.parametrize("method", ["dopri5", "dop853-step"])
@pytest.mark.parametrize("tag,cl_k,t_end,samples,tol", _WALKS,
                         ids=[f"{w[0][:7]}-{w[1]}-{w[3]}-{w[4]:g}"
                              for w in _WALKS])
def test_stepper_walks_jax_steps(method, tag, cl_k, t_end, samples, tol):
    """The port's `solve` (plain K6 on the CPU, the port's dense RHS)
    against the JAX `solve` (its jitted stepper, its dense RHS): equal
    accepted and rejected counts, samples at rtol 1e-12, atol 1e-14."""
    jfn = jdense.make_dense_dy_dt(jdense.compile_dense(tag, cl_k))
    tfn = tdense.make_dense_dy_dt(tdense.compile_dense(tag, cl_k),
                                  device="cpu")
    y0, ts = _p0(tag, cl_k), np.linspace(0.0, t_end, samples)
    want, winfo = j_solve(lambda y, t: jfn(y), y0, ts, rtol=tol, atol=tol,
                          method=method, return_info=True)
    got, info = t_solve(lambda y, t: tfn(y), y0, ts, rtol=tol, atol=tol,
                        method=method, return_info=True, device="cpu")
    assert info["num_accepted"] == int(winfo["num_accepted"])
    assert info["num_rejected"] == int(winfo["num_rejected"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    # Each accepted step that lands on a sample holds one.
    assert info["num_sampled"] == samples - 1
    assert info["num_rhs"] == 2 + (6 if method == "dopri5" else 12) * (
        info["num_accepted"] + info["num_rejected"])


def test_ex3var2_k4_dopri5_matches_artifact():
    """`markov_tapes.ode_integrate(backend="torch")` at the settings of
    `examples/ex3_copolymerization.py` (var2, cl_k 4, 1,001 samples to
    t = 200, rtol = atol = 1e-9, default routing: dopri5) against the
    committed `examples/ex3_var2_k4.npz` (abs 1e-10)."""
    ts = np.linspace(0.0, 200.0, 1001)
    got = t_markov_tapes.ode_integrate(
        tag="ex3var2-copolymerization", size_a=4, cl_k=4,
        p0=_p0("ex3", 4), ts=ts, backend="torch", device="cpu",
        odeint_kwargs=dict(rtol=1e-9, atol=1e-9))
    want = np.load(EXAMPLES / "ex3_var2_k4.npz")["ode_ys"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_ode_integrate_default_kwargs_solve_as_jax():
    """`markov_tapes.ode_integrate(backend="torch")` with its default
    ``odeint_kwargs`` (rtol = atol = 1.49012e-8, dopri5) solves, as the
    JAX ``backend="jax"``: ex1 at uniform p0, as `tests/test_ode.py`'s
    end-to-end test."""
    args = dict(tag="ex1-radioactive-decay", size_a=2, cl_k=3,
                p0=np.full(8, 0.125), ts=np.linspace(0.0, 3.0, 31))
    got = t_markov_tapes.ode_integrate(**args, backend="torch",
                                       device="cpu")
    want = j_markov_tapes.ode_integrate(**args, backend="jax")
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["dopri5", "dop853-step"])
def test_chunked_step_clamped_solve_as_jax(method):
    """A step-clamped stepper in chunks of 7 samples cut as the JAX
    package cuts them ([0, 7), [7, 14), ...; each restarts the stepper),
    equal to the JAX chunked solve: counts and samples."""
    fn, _ = t_build("ex2-ferromagnetic-chain", 3, device="cpu")
    jfn = jdense.make_dense_dy_dt(jdense.compile_dense(
        "ex2-ferromagnetic-chain", 3))
    y0, ts = _p0("ex2", 3), np.linspace(0.0, 6.0, 31)
    kw = dict(rtol=1e-9, atol=1e-9, method=method, chunk_size=7,
              return_info=True)
    got, info = t_solve(lambda y, t: fn(y), y0, ts, **kw, device="cpu")
    want, winfo = j_solve(lambda y, t: jfn(y), y0, ts, **kw)
    assert info["num_accepted"] == int(winfo["num_accepted"])
    assert info["num_rejected"] == int(winfo["num_rejected"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# --- K6's dopri5 rows and error sum ---------------------------------------------


def test_dopri5_tableau_terms_equal_jax():
    """K6's second table: the coefficients equal the JAX package's `_A`,
    `_B5`, `_ERR` (and `_C`) bit for bit; rows 18-23, 24 and 25 of
    `TABLEAU` are their nonzero terms in stage order, and as uploaded
    (`tableau_arrays`); in both states of the swap of stages 0 and 6."""
    assert t_dop.DP5_A == j_dp5._A
    for mine, jax_ in ((t_dop.DP5_B5, j_dp5._B5), (t_dop.DP5_ERR, j_dp5._ERR),
                       (t_dop.DP5_C, j_dp5._C)):
        np.testing.assert_array_equal(mine, np.asarray(jax_))
    count, rows, coefs = t_dop.tableau_arrays()
    r = list(range(7))
    want = [t_dop._terms(t_dop.DP5_A[i], r[:i]) for i in range(1, 7)]
    want += [t_dop._terms(np.asarray(j_dp5._B5), r),
             t_dop._terms(np.asarray(j_dp5._ERR), r)]
    which = list(t_dop.DP5_ROWS[1:]) + [t_dop.DP5_B5_ROW, t_dop.DP5_ERR_ROW]
    assert which == list(range(18, 26))
    for w, terms in zip(which, want):
        assert t_dop.TABLEAU[w] == terms
        k = count[w]
        assert list(zip(rows[w, :k].tolist(), coefs[w, :k].tolist())) == terms
    # The FSAL row (A's row 6) and B5 name the same terms.
    assert t_dop.TABLEAU[23] == t_dop.TABLEAU[24]
    swapped = r.copy()
    swapped[0], swapped[6] = 6, 0
    assert t_dop.stage_rows(1, t_dp5.FSAL, 7) == swapped
    for w, terms in zip(which, want):
        assert t_dop.tableau_terms(w, 1, t_dp5.FSAL) == [
            (swapped[s], c) for s, c in terms]


@pytest.mark.parametrize("n", [1, 257, 256 * 1024 + 3])
def test_dopri5_error_sum_follows_norm_order(n):
    """dopri5's one error sum (`norms` mode `_ERR_H`): (h e / scale)^2
    per element, e the error row's stage sum in stage order, summed in
    K6's order (`cuda.block_order_sum`, the order
    `test_norm_sum_order_follows_the_kernel` reads from the kernel's
    loops); its RMS within rounding of the JAX package's `_rms_norm`."""
    rng = np.random.RandomState(n % 997)
    ks = rng.rand(7, n) - 0.5
    y = rng.rand(n)
    y_new = y + 1e-3 * ks[2]
    h, rtol, atol = 0.37, 1e-9, 1e-9
    kt = torch.as_tensor(ks)
    for swap in (0, 1):
        got = t_dop.norms(t_dop._ERR_H, torch.as_tensor(y), rtol, atol,
                          y_new=torch.as_tensor(y_new), ks=kt, swap=swap,
                          h=h, fsal=t_dp5.FSAL, rows=(t_dop.DP5_ERR_ROW,))
        r = t_dop.stage_rows(swap, t_dp5.FSAL, 7)
        e = None
        for s, c in t_dop.TABLEAU[t_dop.DP5_ERR_ROW]:
            e = c * kt[r[s]] if e is None else e + c * kt[r[s]]
        scale = atol + torch.maximum(torch.as_tensor(y).abs(),
                                     torch.as_tensor(y_new).abs()) * rtol
        u = h * e / scale
        assert got[0].item() == cuda.block_order_sum(u * u).item()
        assert got[1].item() == 0.0
        k_mat = ks[r]  # logical stage order
        err_vec = h * np.tensordot(np.asarray(j_dp5._ERR), k_mat, 1)
        want = float(j_dp5._rms_norm(jnp.asarray(err_vec / scale.numpy())))
        assert math.isclose(math.sqrt(got[0].item() / n), want,
                            rel_tol=1e-12)
