"""Parity of the PyTorch port's exact SPD closure with the JAX package (CPU).

The same inputs, made with numpy from a seed, go through the JAX package
(on the CPU) and through the port on ``device="cpu"``, where the kernels'
wrappers run their plain versions: the compiled dense program must be
equal, dp/dt equal to rounding (rtol 1e-12, atol 1e-14), the canary
exact, and the DOP853 solve must walk the JAX stepper's steps. K5's
per-element rule (`csrc/sweep_rule.cuh`) is built with the host's C++
compiler and held to the plain step for every window rank. The kernels
themselves run only on the card (`tests/test_torch_gpu.py`).
"""

import ctypes
import dataclasses
import math
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu import build_dy_dt as j_build
from chemical_kinetics_and_program_execution_tpu import markov as jmarkov
from chemical_kinetics_and_program_execution_tpu import (
    markov_tapes as j_markov_tapes,
)
from chemical_kinetics_and_program_execution_tpu.engine import dense as jdense
from chemical_kinetics_and_program_execution_tpu.engine import dsl as jdsl
from chemical_kinetics_and_program_execution_tpu.engine.reference import (
    dy_dt_reference,
)
from chemical_kinetics_and_program_execution_tpu.models import (
    initial_states as j_init,
)
from chemical_kinetics_and_program_execution_tpu.ode import (
    streamed_solve as j_streamed,
)
from chemical_kinetics_and_program_execution_tpu.ode.integrate import (
    solve as j_solve,
)
from chemical_kinetics_and_program_execution_tpu.ops import (
    observables as j_obs,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch import markov as tmarkov
from chemical_kinetics_and_program_execution_torch import (
    markov_tapes as t_markov_tapes,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    build_dy_dt as t_build,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    dense as tdense,
)
from chemical_kinetics_and_program_execution_torch.engine import dsl as tdsl
from chemical_kinetics_and_program_execution_torch.models import (
    initial_states as t_init,
)
from chemical_kinetics_and_program_execution_torch.ode import dop853 as t_dop
from chemical_kinetics_and_program_execution_torch.ode.integrate import (
    solve as t_solve,
)
from chemical_kinetics_and_program_execution_torch.ops import (
    observables as t_obs,
)

CPU = torch.device("cpu")
# The cases of `tests/test_engine.py:18-32`.
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
# dp/dt: the same arithmetic, sums in another order (rounding).
RTOL, ATOL = 1e-12, 1e-14
_PROGRAMS = {}


def _programs(tag, cl_k):
    """The JAX package's and the port's dense programs (cached: ex6-lite
    enumerates some 13,000 paths)."""
    if (tag, cl_k) not in _PROGRAMS:
        _PROGRAMS[tag, cl_k] = (jdense.compile_dense(tag, cl_k),
                                tdense.compile_dense(tag, cl_k))
    return _PROGRAMS[tag, cl_k]


def _spd(rng, size, concentrated=False):
    """As `tests/test_engine.py:_random_spd`: asymmetric, and with most
    mass on few windows when concentrated."""
    return rng.dirichlet(np.ones(size) * (0.2 if concentrated else 1.0))


def _jax_plans(jprog):
    return [(p.sid, p.length, p.orig, p.adj) for p in jprog.plans]


def _from_jax(jprog):
    """The JAX program carried over by `program_from_arrays`."""
    return tdense.program_from_arrays(
        jprog.tag, jprog.size_a, jprog.cl_k, jprog.w_num, jprog.w_den,
        jprog.w_const, jprog.pair_world, jprog.pair_sig, _jax_plans(jprog))


# --- (a) the compiled program ------------------------------------------------


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_compile_dense_fields_equal_jax(tag, cl_k):
    jprog, tprog = _programs(tag, cl_k)
    for name in ("w_num", "w_den", "w_const", "pair_world", "pair_sig"):
        want, got = getattr(jprog, name), getattr(tprog, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert [(p.sid, p.length, p.orig, p.adj) for p in tprog.plans] == \
        _jax_plans(jprog)
    assert (tprog.num_signatures, tprog.pyramid_size, tprog.state_size) == (
        jprog.num_signatures, jprog.pyramid_size, jprog.state_size)
    assert len(tdense._group_plans(tprog.plans, tprog.size_a, cl_k)) == len(
        jdense._group_plans(jprog.plans, jprog.size_a, cl_k))


# --- (b), (c) dp/dt ----------------------------------------------------------------


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_dy_dt_matches_jax(tag, cl_k):
    """Through the port's own compile and through the JAX program carried
    over, on random and concentrated SPDs."""
    jfn, jprog = j_build(tag, cl_k, engine="dense")
    own, _ = t_build(tag, cl_k, engine="dense", device="cpu")
    carried = tdense.make_dense_dy_dt(_from_jax(jprog), device="cpu")
    rng = np.random.RandomState(sum(map(ord, tag)) + cl_k)
    for concentrated in (False, True):
        p = _spd(rng, jprog.state_size, concentrated)
        want = np.asarray(jfn(p))
        for fn in (own, carried):
            got = fn(torch.as_tensor(p))
            assert got.dtype == torch.float64 and got.device == CPU
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_dy_dt_conserves_probability(tag, cl_k):
    fn, prog = t_build(tag, cl_k, device="cpu")
    p = _spd(np.random.RandomState(42), prog.state_size)
    assert abs(float(fn(p).sum())) < 1e-13


def test_dy_dt_matches_reference_oracle_with_invalid_entries():
    """A slightly negative entry, as an interpolant gives: finite, and
    the JAX package's host oracle."""
    fn, prog = t_build("ex2-ferromagnetic-chain", 4, device="cpu")
    p = np.random.RandomState(3).dirichlet(np.ones(prog.state_size))
    p[0] = -1e-13
    got = fn(p).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, dy_dt_reference("ex2-ferromagnetic-chain", 4, p), rtol=RTOL,
        atol=ATOL)


# --- (d) the canary ----------------------------------------------------------------


def test_canary_golden_vector_exact():
    assert t_markov_tapes._run_validation(device="cpu") == [
        0.375, 0.125, 0.125, -0.125, 0.125, -0.125, -0.125, -0.375]
    j_markov_tapes._run_validation()


# --- (e) revealed runs longer than the window ------------------------------


_LONG_TAG = "torch-port-test-long-sig"


def _long_sig_rule(t):
    # Reads cells 0..3 (revealed length 4 > cl_k=3), writes two separated
    # cells so orig/adj differ at non-adjacent digits.
    a = t.get(True, 0)
    b = t.get(True, 3)
    if a == 1:
        t.set(True, 0, 0)
    if b == 0:
        t.set(True, 3, 1)


jdsl.register_problem(_LONG_TAG, ("A", "B"))(_long_sig_rule)
tdsl.register_problem(_LONG_TAG, ("A", "B"))(_long_sig_rule)


def test_dense_long_signature_pops():
    """Interior emissions at l0 > k, where members' ranks repeat."""
    cl_k = 3
    tprog = tdense.compile_dense(_LONG_TAG, cl_k)
    assert max(p.length for p in tprog.plans) > cl_k
    plan = tdense.sweep_plan(tprog)
    interior = np.asarray([op for st in plan.steps
                           if st.kind == tdense.INTERIOR
                           for op in st.interior])
    assert len(interior) and len(np.unique(interior[:, 0])) < len(interior)
    fn = tdense.make_dense_dy_dt(tprog, device="cpu")
    jfn = jdense.make_dense_dy_dt(jdense.compile_dense(_LONG_TAG, cl_k))
    p = _spd(np.random.RandomState(11), tprog.state_size)
    got = fn(p).numpy()
    np.testing.assert_allclose(got, np.asarray(jfn(p)), rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(got, dy_dt_reference(_LONG_TAG, cl_k, p),
                               rtol=RTOL, atol=ATOL)


# --- (f), (h) the DOP853 solve ----------------------------------------------------


def _ex4_p0(cl_k, powered):
    return t_init.chemical_turing_p0(cl_k, powered_fraction=powered).ravel()


def test_dop853_solve_walks_jax_steps():
    """ex4 cl_k 3, t 0-50: the port's `solve` against the JAX `solve`
    (its jitted dense-output DOP853): equal step counts, atol 1e-12."""
    y0 = _ex4_p0(3, 0.04)
    ts = np.linspace(0.0, 50.0, 6)
    jfn = jdense.make_dense_dy_dt(jdense.compile_dense(
        "ex4-chemical-turing", 3))
    want, want_info = j_solve(lambda y, t: jfn(y), y0, ts, rtol=1e-10,
                              atol=1e-12, method="dop853", return_info=True)
    tfn, _ = t_build("ex4-chemical-turing", 3, device="cpu")
    got, info = t_solve(lambda y, t: tfn(y), y0, ts, rtol=1e-10, atol=1e-12,
                        method="dop853", return_info=True, device="cpu")
    assert got.shape == (6, 9**3) and got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)
    assert info["num_accepted"] == int(want_info["num_accepted"])
    assert info["num_rejected"] == int(want_info["num_rejected"])
    assert info["num_accepted"] > 3


def test_ode_integrate_ivp_torch_matches_jax_backend():
    """ex4 cl_k 3 through both packages' `markov_tapes.ode_integrate_ivp`:
    the port's ``backend="torch"`` against the JAX ``backend="jax"``,
    full states and with an observables projection."""
    y0 = _ex4_p0(3, 0.01)
    ts = np.linspace(0.0, 40.0, 9)
    kw = dict(rtol=1e-11, atol=1e-11, method="DOP853")
    args = dict(tag="ex4-chemical-turing", size_a=9, cl_k=3, p0=y0, ts=ts)
    want = j_markov_tapes.ode_integrate_ivp(**args, ivp_kwargs=kw,
                                            backend="jax")
    got = t_markov_tapes.ode_integrate_ivp(**args, ivp_kwargs=kw,
                                           backend="torch", device="cpu")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)
    seqs = [[5, 0, 5], [4, 1], [6], [7]]
    obs, info = t_markov_tapes.ode_integrate_ivp(
        **args, backend="torch", device="cpu",
        ivp_kwargs=dict(kw, project=t_obs.seq_prob_projector(seqs, 9, 3),
                        return_info=True))
    want_obs = np.asarray(j_obs.seq_prob_projector(seqs, 9, 3)(
        jnp.asarray(want)))
    np.testing.assert_allclose(obs, want_obs, rtol=0, atol=1e-12)
    np.testing.assert_allclose(info["y_final"], want[-1], rtol=0, atol=1e-12)


@pytest.mark.parametrize("fn,kwarg", [("ode_integrate", "odeint_kwargs"),
                                      ("ode_integrate_ivp", "ivp_kwargs")])
def test_drop_in_jax_backend_solves_as_jax(fn, kwarg):
    """The drop-in functions take the reference's ``backend="jax"`` as the
    port's device solver: ex2 at cl_k 3 against the JAX package's
    ``backend="jax"`` run of the same call (rtol 1e-12)."""
    p0 = np.asarray(j_init.ferromagnet_p0(3, p_pair=0.1)).ravel()
    args = dict(tag="ex2-ferromagnetic-chain", size_a=2, cl_k=3, p0=p0,
                ts=np.linspace(0.0, 5.0, 11),
                **{kwarg: dict(rtol=1e-11, atol=1e-11)})
    want = getattr(j_markov_tapes, fn)(**args, backend="jax")
    got = getattr(t_markov_tapes, fn)(**args, backend="jax", device="cpu")
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=0)


def test_dop853_dense_output_samples_inside_steps():
    """Many samples a step (the dense output, no clamped steps): the
    sample grid does not change the steps, and samples at the times both
    grids share are the same bits."""
    y0 = _ex4_p0(3, 0.04)
    tfn, _ = t_build("ex4-chemical-turing", 3, device="cpu")
    out = []
    for n in (3, 41):
        ts = np.linspace(0.0, 20.0, n)
        out.append(t_solve(lambda y, t: tfn(y), y0, ts, rtol=1e-10,
                           atol=1e-12, return_info=True, device="cpu"))
    (coarse, info3), (fine, info41) = out
    assert info3["num_accepted"] == info41["num_accepted"] > 3
    assert info3["num_rejected"] == info41["num_rejected"]
    assert info41["num_rhs"] > info3["num_rhs"]  # more steps hold samples
    np.testing.assert_array_equal(fine[[0, 20, 40]], coarse)


def test_dense_rhs_writes_into_out():
    """``fn(p, out=buf)`` writes dp/dt into ``buf`` and returns it, the
    same bits as a new tensor; an ``out`` of the wrong shape raises."""
    fn, prog = t_build("ex4-chemical-turing", 3, device="cpu")
    p = torch.as_tensor(_spd(np.random.RandomState(11), prog.state_size))
    buf = torch.full((2, prog.state_size), 7.0, dtype=torch.float64)
    got = fn(p, out=buf[1])
    assert got.data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1], fn(p)) and bool((buf[0] == 7.0).all())
    with pytest.raises(TypeError):
        fn(p, out=buf[:, :5].reshape(-1))


@pytest.mark.parametrize("n", [1, 31, 32, 9**3])
def test_rows_tensor_pads_rows_to_256_bytes(n):
    """The solver's stage and dense-stack layout: [m, n] float64, each
    row contiguous, rows a multiple of 32 doubles apart, at least n."""
    t = t_dop.rows_tensor(3, n, "cpu")
    assert t.shape == (3, n) and t.dtype == torch.float64
    assert t.stride(1) == 1 and t.stride(0) % 32 == 0
    assert n <= t.stride(0) < n + 32 and t[2].is_contiguous()


def test_dop853_stage_row_rhs_walks_the_same_steps():
    """A ``takes_out`` RHS (written into the stage row) and a returning
    one give the same samples, bit for bit, and the same steps."""
    y0 = _ex4_p0(3, 0.04)
    ts = np.linspace(0.0, 30.0, 7)
    tfn, _ = t_build("ex4-chemical-turing", 3, device="cpu")

    def into_row(y, t, out=None):
        return tfn(y, out)

    into_row.takes_out = True
    got = [t_solve(f, y0, ts, rtol=1e-10, atol=1e-12, return_info=True,
                   device="cpu")
           for f in (into_row, lambda y, t: tfn(y))]
    (rows, info), (want, want_info) = got
    np.testing.assert_array_equal(rows, want)
    assert info == want_info and info["num_accepted"] > 3


@pytest.mark.parametrize("fn", ["stage", "norms", "dense"])
def test_dop853_plain_arithmetic_matches_jax_streamed(fn):
    """K6's plain versions against the JAX package's host-stepped twins
    (`ode/streamed_solve.py`) on random stages: the same sums in the
    same order, but XLA may fuse a product into a sum, so to rounding."""
    rng = np.random.RandomState(6)
    n = 257
    ks = rng.rand(16, n) - 0.5
    y = rng.rand(n)
    y_new = y + 1e-3 * ks[2]
    kt, yt, ynt = (torch.as_tensor(x) for x in (ks, y, y_new))
    rows = list(range(16))
    if fn == "stage":
        coefs = t_dop._A[7, :7]
        got = t_dop.stage(yt, kt, 0.3, 7, torch.empty(n, dtype=torch.float64))
        want = j_streamed._lincomb(y, 0.3, tuple(coefs), list(ks[:7]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-15, atol=1e-15)
    elif fn == "norms":
        got = t_dop.norms(t_dop._ERR, yt, 1e-10, 1e-12, y_new=ynt, ks=kt)
        want = j_streamed._error_norms(y, y_new, list(ks[:13]), 1e-10, 1e-12)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)
        got = t_dop.norms(t_dop._RMS, yt, 1e-10, 1e-12, f0=kt[0])
        d0, d1 = j_streamed._rms_scaled(y, ks[0], 1e-10, 1e-12)
        np.testing.assert_allclose(np.sqrt(got.numpy() / n),
                                   [float(d0), float(d1)], rtol=1e-13)
        got = t_dop.norms(t_dop._RMS_DIFF, yt, 1e-10, 1e-12, f0=kt[0],
                          f1=kt[1])
        d2 = j_streamed._rms_diff_scaled(y, ks[1], ks[0], 1e-10, 1e-12)
        np.testing.assert_allclose(np.sqrt(got.numpy()[0] / n), float(d2),
                                   rtol=1e-13)
    else:
        F = t_dop.dense_coeffs(yt, ynt, 0.3, kt[0], kt[12], kt, rows,
                               torch.empty((7, n), dtype=torch.float64))
        want = np.asarray(j_streamed._dense_coeffs(y, y_new, 0.3, ks[0],
                                                   ks[12], list(ks)))
        np.testing.assert_allclose(F.numpy(), want, rtol=RTOL, atol=ATOL)
        got = t_dop.dense_eval(F, yt, torch.tensor([0.0, 0.35], dtype=torch.float64), 1, 1, 0.0,
                               1.0, torch.empty((1, n), dtype=torch.float64))
        np.testing.assert_allclose(
            got[0].numpy(), np.asarray(j_streamed._dense_eval(want, y, 0.35)),
            rtol=RTOL, atol=ATOL)


def _per_fraction_rule(F, y, x):
    """A sample at one fraction as the solver formed each before the
    step's samples became one launch: Horner from the stack's last row,
    times x and 1 - x in turn, then y added."""
    acc = torch.zeros_like(y)
    for i in range(6, -1, -1):
        acc = acc + F[i]
        acc = acc * (x if (6 - i) % 2 == 0 else (1 - x))
    return y + acc


@pytest.mark.parametrize("m", [1, 7, 200])
def test_dense_eval_step_matches_jax_and_per_fraction_rule(m):
    """A step's samples from one `dense_eval` call (its plain version on
    the CPU): each row equals the JAX package's `_dense_eval` at its
    fraction (rtol 1e-12: XLA may fuse a product into a sum) and, bit
    for bit, the per-fraction rule at the fraction the host forms; a
    sample time before the step gives fraction 0 and one past it 1."""
    rng = np.random.RandomState(20 + m)
    n = 257
    F = rng.rand(7, n) - 0.5
    y = rng.rand(n)
    t, h = 3.0, 0.7
    ts = np.concatenate([[0.0, t - 0.1], np.sort(t + h * rng.rand(m)),
                         [t + h + 0.2]])
    i_out, count = 1, m + 2
    Ft, yt = torch.as_tensor(F), torch.as_tensor(y)
    out = t_dop.rows_tensor(count + 3, n, "cpu")
    got = t_dop.dense_eval(Ft, yt, torch.as_tensor(ts), i_out, count, t, h,
                           out)
    assert got.shape == (count, n) and got.data_ptr() == out.data_ptr()
    xs = [min(max((ts[i_out + q] - t) / h, 0.0), 1.0) for q in range(count)]
    assert xs[0] == 0.0 and xs[-1] == 1.0
    for q, x in enumerate(xs):
        assert torch.equal(got[q], _per_fraction_rule(Ft, yt, x)), q
        np.testing.assert_allclose(
            got[q].numpy(), np.asarray(j_streamed._dense_eval(F, y, x)),
            rtol=1e-12, atol=1e-15)


def test_dense_eval_fractions_equal_the_hosts():
    """The fractions `dense_eval` forms from (ts, i_out, t, h), elementwise
    as the kernel does, have the bits of the host's min(max((ts[q] - t) /
    h, 0), 1) in Python floats, for steps and sample times of every
    scale, at the clamp's edges and on ex4's grid of 2,001 samples."""
    rng = np.random.RandomState(21)
    grid = np.linspace(0.0, 2000.0, 2001)
    cases = [(grid, 1, 2000, 0.0, 0.6931), (grid, 700, 60, 699.3, 61.27)]
    for _ in range(200):
        t = rng.rand() * 10.0 ** rng.randint(-6, 4)
        h = rng.rand() * 10.0 ** rng.randint(-9, 3) + 1e-300
        ts = np.sort(t + h * (1.4 * rng.rand(50) - 0.2))
        cases.append((ts, rng.randint(0, 10), rng.randint(1, 40), t, h))
    cases.append((np.asarray([1.0, 1.0, 2.0]), 0, 3, 1.0, 1.0))
    for ts, i_out, m, t, h in cases:
        got = t_dop.fractions(torch.as_tensor(ts), i_out, m, t, h).tolist()
        want = [min(max((float(ts[i_out + q]) - t) / h, 0.0), 1.0)
                for q in range(m)]
        assert got == want and all(
            math.copysign(1.0, a) == math.copysign(1.0, b)
            for a, b in zip(got, want))


@pytest.mark.parametrize("n", [1, 255, 257, 256 * 1024 + 3, 9**6])
def test_norm_sum_order_follows_the_kernel(n):
    """`norms_plain` sums in K6's `norms` order (`cuda.block_order_sum`,
    which K9's plain version takes too): equal
    bit for bit to the kernel's loops read literally, element by element
    in Python floats: block b's thread t from 0 over b*256 + t + q*stride,
    each block's shared-memory tree, the last block's thread t over
    partials t, t + 256, ..., and its tree."""
    v = np.random.RandomState(n % 1000).rand(n) ** 3
    blocks = min(max(-(-n // 256), 1), 1024)
    stride = blocks * 256

    def tree(s):
        s = list(s)
        w = 128
        while w:
            for t in range(w):
                s[t] = s[t] + s[t + w]
            w //= 2
        return s[0]

    partial = []
    for b in range(blocks):
        sums = []
        for t in range(256):
            acc = 0.0
            for i in range(b * 256 + t, n, stride):
                acc = acc + float(v[i])
            sums.append(acc)
        partial.append(tree(sums))
    sums = []
    for t in range(256):
        acc = 0.0
        for b in range(t, blocks, 256):
            acc = acc + partial[b]
        sums.append(acc)
    assert float(cuda.block_order_sum(torch.as_tensor(v))) == tree(sums)


def test_tableau_equals_the_stage_terms():
    """The tableau K6 uploads to the card (`tableau_arrays`) equals, row by
    row, the terms the solver built for each launch before the table:
    `_terms` of the initial step, A's rows 1-11, B, the extra rows and
    E5/E3 over the stage rows in use, in both states of the first-same-
    as-last swap (`tableau_terms`); dopri5's rows 18-25 follow them
    (`tests/test_torch_solvers.py`), Kvaerno 3(2)'s rows 26-30
    (`tests/test_torch_steady.py`) and the fixed grid's adjoint rows
    31-37 (`tests/test_torch_reverse.py`)."""
    count, rows, coefs = t_dop.tableau_arrays()
    assert count.dtype == np.int32 and coefs.dtype == np.float64
    assert rows.shape == coefs.shape == (len(t_dop.TABLEAU), 16) == (38, 16)
    for which, terms in enumerate(t_dop.TABLEAU):
        k = count[which]
        assert list(zip(rows[which, :k].tolist(),
                        coefs[which, :k].tolist())) == terms
        assert not rows[which, k:].any() and not coefs[which, k:].any()
    for swap in (0, 1):
        r = list(range(16))
        if swap:
            r[0], r[12] = r[12], r[0]
        assert t_dop.stage_rows(swap) == r
        want = [[(r[0], 1.0)]]
        want += [t_dop._terms(t_dop._A[i, :i], r[:i]) for i in range(1, 12)]
        want.append(t_dop._terms(t_dop._B, r[:12]))
        want += [t_dop._terms(t_dop._A_EXTRA[j, :13 + j], r[:13 + j])
                 for j in range(3)]
        want += [t_dop._terms(t_dop._E5, r[:13]),
                 t_dop._terms(t_dop._E3, r[:13])]
        assert [t_dop.tableau_terms(w, swap) for w in range(18)] == want
    assert max(count) <= 16 and min(count) >= 1


# --- (g) observables and the markov helpers ----------------------------------


def test_seq_prob_projector_and_seq_prob_equal_jax():
    """The projector against the JAX one, and `seq_prob` (numpy in both)
    bit for bit, short and Markov-extended sequences."""
    rng = np.random.RandomState(8)
    p = rng.dirichlet(np.ones(9**4), size=3)
    seqs = [[5, 0, 5, 5], [4, 1], [6], [7], [0, 1, 2]]
    want = np.asarray(j_obs.seq_prob_projector(seqs, 9, 4)(jnp.asarray(p)))
    got = t_obs.seq_prob_projector(seqs, 9, 4)(torch.as_tensor(p)).numpy()
    # Slice-sums of up to 729 terms, summed in torch's and XLA's orders.
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    for seq in seqs + [[5, 0, 5, 5, 4, 1]]:
        want_p, _ = jmarkov.seq_prob(p[0].reshape([9] * 4), seq)
        got_p, _ = tmarkov.seq_prob(p[0].reshape([9] * 4), seq)
        np.testing.assert_array_equal(got_p, want_p)
    ent = t_obs.stack_projectors(
        t_obs.markov_entropy_projector(9, 4),
        t_obs.seq_prob_projector([[6]], 9, 4))(torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(
        ent[:, 0], [jmarkov.markov_entropy(x.reshape([9] * 4)) for x in p],
        rtol=1e-12)
    with pytest.raises(ValueError, match="longer than cl_k"):
        t_obs.seq_prob_projector([[0] * 5], 9, 4)


def test_markov_helpers_equal_jax():
    rng = np.random.RandomState(9)
    spd = rng.dirichlet(np.ones(27)).reshape(3, 3, 3)
    mpp = tmarkov.mpp_from_spd(spd)
    np.testing.assert_array_equal(tmarkov.ctm_from_mpp(3, 2, mpp),
                                  jmarkov.ctm_from_mpp(3, 2, mpp))
    assert tmarkov.markov_entropy(spd) == jmarkov.markov_entropy(spd)
    idx = rng.randint(0, 40, (5, 3))
    pyr = rng.rand(41)
    np.testing.assert_array_equal(
        tmarkov.guarded_ratio_prod(torch.as_tensor(pyr), torch.as_tensor(idx),
                                   torch.as_tensor(idx[::-1].copy())).numpy(),
        np.asarray(jmarkov.guarded_ratio_prod(jnp.asarray(pyr), idx,
                                              idx[::-1])))
    got = tmarkov.get_ctm_eigenvalue1_eigenspace(spd)[0]
    assert got == jmarkov.get_ctm_eigenvalue1_eigenspace(spd)[0]
    p = spd.ravel()
    np.testing.assert_array_equal(tmarkov.pyramid_np(p, 3, 3),
                                  jmarkov.pyramid_np(p, 3, 3))
    np.testing.assert_allclose(
        tmarkov.pyramid(torch.as_tensor(p), 3, 3).numpy(),
        np.asarray(jmarkov.pyramid(jnp.asarray(p), 3, 3)), rtol=1e-15)
    num = np.array([0.0, 0.2, 0.3, -1e-13, 0.5])
    den = np.array([0.0, 0.4, 0.1, 0.2, 0.0])
    np.testing.assert_array_equal(
        tmarkov.guarded_ratio(torch.as_tensor(num),
                              torch.as_tensor(den)).numpy(),
        np.asarray(jmarkov.guarded_ratio(jnp.asarray(num), jnp.asarray(den))))


@pytest.mark.parametrize("name,kwargs", [
    ("chemical_turing_p0", dict(cl_k=4, powered_fraction=0.01)),
    ("chemical_turing_p0", dict(cl_k=3, random01=True)),
    ("chemical_turing_v2_p0", dict(cl_k=3)),
    ("ferromagnet_p0", dict(cl_k=5, corrected=True)),
    ("copolymerization_p0", dict(cl_k=4)),
    ("msrtf_p0", dict(cl_k=3)),
])
def test_initial_states_equal_jax(name, kwargs):
    np.testing.assert_array_equal(getattr(t_init, name)(**kwargs),
                                  getattr(j_init, name)(**kwargs))


# --- K3 and K4 plain against the JAX stages ------------------------------------


@pytest.mark.parametrize("tag,cl_k", [("ex4-chemical-turing", 4),
                                      ("ex6-mini-bff-lite", 2)])
def test_pyramid_ratios_and_signature_weights_match_jax(tag, cl_k):
    """K3's and K4's plain versions (the CPU path of K3's wrapper and of
    K5's, whose phase 0 is K4) against the JAX package's `_levels`, `pyramid` and the
    world-to-signature stage, and the plain ratio function (the
    yardstick of K5's ratio rule) against `_ratio_tables`."""
    jprog, tprog = _programs(tag, cl_k)
    a = tprog.size_a
    p = _spd(np.random.RandomState(12), tprog.state_size, True)
    pt = torch.as_tensor(p)
    low = tdense.pyramid(pt, a, cl_k)
    jp = jnp.asarray(p)
    np.testing.assert_allclose(torch.cat([pt, low]).numpy(), np.asarray(
        jmarkov.pyramid(jp, a, cl_k)), rtol=1e-14)
    rat = tdense.ratio_tables_plain(pt, low, a, cl_k)
    r_le, r_re = jdense._ratio_tables(jdense._levels(jp, a, cl_k), a, cl_k)
    want = np.concatenate([np.asarray(r) for r in r_le[1:]]
                          + [np.asarray(r_re)])
    np.testing.assert_allclose(rat.numpy(), want, rtol=1e-14)
    s = torch.empty(tprog.num_signatures, dtype=torch.float64)
    tdense.sweep(tdense.device_program(tprog, "cpu"), pt, low, s=s)
    jpyr = jmarkov.pyramid(jp, a, cl_k)
    wv = jprog.w_const * np.asarray(jmarkov.guarded_ratio_prod(
        jpyr, jnp.asarray(jprog.w_num), jnp.asarray(jprog.w_den)))
    want_s = np.zeros(jprog.num_signatures)
    np.add.at(want_s, jprog.pair_sig, wv[jprog.pair_world])
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-13, atol=1e-300)


# --- (i) what is not ported raises --------------------------------------------------


def test_unported_exact_paths_raise(monkeypatch, capsys):
    """The stiff stepper kvaerno3 and the scipy names that map onto it
    (kvaerno3, lsoda, LSODA, radau, bdf), ported since, route to
    `odeint_kvaerno3` as the JAX package's `_STEPPERS` routes them (a spy
    stands in for it here: `tests/test_torch_stiff.py` runs it); pruned
    programs, ``with_mass``, dopri5 (default routing at
    loose tolerances) and dop853-step, ported since, do not raise
    (`tests/test_torch_pruned.py`, `tests/test_torch_solvers.py`), nor
    do the gather engines and chunked or checkpointed solves
    (`tests/test_torch_gather.py`). ``with_mass`` on a program with no
    mass tables raises the JAX package's ValueError. ``debug=True``
    gives the JAX package's dp/dt, and where the reference dumps its
    worlds (`IS_DEBUG`, ported since) the port prints the JAX package's
    dump line for line."""
    pruned = tdense.compile_dense("ex4-chemical-turing", 3,
                                  prune_threshold=1e-3)
    assert pruned.pruned and pruned.m_num is not None
    prog = tdense.compile_dense("ex4-chemical-turing", 3)
    with pytest.raises(ValueError, match="no mass tables"):
        tdense.make_dense_dy_dt(prog, with_mass=True, device="cpu")
    with pytest.raises(ValueError, match="no mass tables"):
        jdense.make_dense_dy_dt(jdense.compile_dense("ex4-chemical-turing",
                                                     3), with_mass=True)
    fn = tdense.make_dense_dy_dt(prog, device="cpu")
    y0 = _ex4_p0(3, 0.04)
    from chemical_kinetics_and_program_execution_torch.ode import (
        integrate as t_integrate,
    )

    routed = []

    def spy(*args, **kwargs):
        routed.append(args[2].tolist())
        return t_dop.odeint_dop853(*args, **kwargs)

    monkeypatch.setattr(t_integrate, "odeint_kvaerno3", spy)
    for method in ("kvaerno3", "lsoda", "LSODA", "radau", "bdf"):
        assert t_integrate._STEPPERS[method.lower()] == "odeint_kvaerno3"
        ys = t_solve(lambda y, t: fn(y), y0, [0.0, 1.0], method=method,
                     device="cpu")
        assert ys.shape == (2, 9**3) and np.isfinite(ys).all()
    assert routed == [[0.0, 1.0]] * 5
    for kw in (dict(method="dopri5"), dict(method="dop853-step"),
               dict(rtol=1e-6, atol=1e-6)):
        ys = t_solve(lambda y, t: fn(y), y0, [0.0, 1.0], **kw, device="cpu")
        assert ys.shape == (2, 9**3) and np.isfinite(ys).all()
    kw = dict(tag="ex4-chemical-turing", size_a=9, cl_k=3, debug=True)
    monkeypatch.setattr(j_markov_tapes, "IS_DEBUG", False)
    monkeypatch.setattr(t_markov_tapes, "IS_DEBUG", False)
    np.testing.assert_allclose(
        t_markov_tapes.get_dy_dt(**kw, device="cpu")(y0, 0.0),
        j_markov_tapes.get_dy_dt(**kw)(y0, 0.0), rtol=1e-12, atol=1e-14)
    monkeypatch.setattr(t_markov_tapes, "IS_DEBUG", True)
    monkeypatch.setattr(j_markov_tapes, "IS_DEBUG", True)
    capsys.readouterr()
    got = t_markov_tapes.get_dy_dt(**kw, device="cpu")(y0, 0.5)
    t_out = capsys.readouterr().out
    want = j_markov_tapes.get_dy_dt(**kw)(y0, 0.5)
    j_out = capsys.readouterr().out
    assert t_out.count("p_world=") > 4
    assert t_out == j_out
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name,value", [
    ("MARKOV_TAPES_DEBUG", "1"), ("MARKOV_TAPES_DEBUG", "0"),
    ("CKPE_DEBUG", "yes"), ("CKPE_DEBUG", "off"), (None, None)])
def test_debug_flag_read_as_jax_reads_it(monkeypatch, name, value):
    """`utils/config.py`'s `_env_flag` reads MARKOV_TAPES_DEBUG, then
    CKPE_DEBUG, as the JAX package's does; its `IS_DEBUG` is the flag
    and `markov_tapes.IS_DEBUG` that value."""
    from chemical_kinetics_and_program_execution_torch.utils import (
        config as t_config,
    )
    from chemical_kinetics_and_program_execution_tpu.utils import (
        config as j_config,
    )

    for var in ("MARKOV_TAPES_DEBUG", "CKPE_DEBUG"):
        monkeypatch.delenv(var, raising=False)
    if name:
        monkeypatch.setenv(name, value)
    names = ("MARKOV_TAPES_DEBUG", "CKPE_DEBUG")
    assert t_config._env_flag(*names) == j_config._env_flag(*names)
    assert t_config._env_flag(*names) == (value in ("1", "yes"))
    assert t_markov_tapes.IS_DEBUG is t_config.IS_DEBUG


def _public_names(module):
    """The public names a module of the JAX package defines or imports at
    its top level (not ``import x`` of a whole package, not __future__),
    read from its source."""
    import ast
    import inspect

    names = set()
    for node in ast.parse(inspect.getsource(module)).body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_drop_in_surface_matches_jax():
    """Every public name of the JAX package's top level and of its
    `markov_tapes` exists in the port, but for `make_batched_dy_dt`
    (ROADMAP Queue 1, "The exact engines' other entry points"); the
    port's `make_dy_dt` is the tree engine's; `init_gambit` is a no-op."""
    import chemical_kinetics_and_program_execution_torch as tpkg
    import chemical_kinetics_and_program_execution_tpu as jpkg
    from chemical_kinetics_and_program_execution_torch.engine import rhs

    missing = {name for module, port in ((jpkg, tpkg),
                                         (j_markov_tapes, t_markov_tapes))
               for name in _public_names(module) if not hasattr(port, name)}
    assert missing == {"make_batched_dy_dt"}
    assert {"build_dy_dt", "compile_dense", "markov",
            "init_gambit"} <= _public_names(jpkg) | _public_names(
                j_markov_tapes)
    assert tpkg.make_dy_dt is rhs.make_dy_dt
    assert tpkg.markov is tmarkov
    assert set(tpkg.registered_problems()) <= set(
        jpkg.registered_problems())
    assert t_markov_tapes.init_gambit() is None


def test_group_limit_raises_where_jax_falls_back(monkeypatch):
    """Above DENSE_GROUP_LIMIT groups ``engine="auto"`` now falls back to
    the tree engine, as the JAX package does (it raised until the tree
    engine was ported); ``engine="dense"`` keeps the dense sweep."""
    from chemical_kinetics_and_program_execution_torch import engine
    from chemical_kinetics_and_program_execution_torch.engine.compile import (
        CompiledProblem,
    )

    monkeypatch.setattr(engine, "DENSE_GROUP_LIMIT", 3)
    auto, compiled = engine.build_dy_dt("ex4-chemical-turing", 3,
                                        device="cpu")
    assert isinstance(compiled, CompiledProblem)
    fn, prog = engine.build_dy_dt("ex4-chemical-turing", 3, engine="dense",
                                  device="cpu")
    assert isinstance(prog, tdense.DenseProgram)
    p0 = _ex4_p0(3, 0.04)
    assert fn(p0).shape == (9**3,)
    np.testing.assert_allclose(auto(p0).numpy(), fn(p0).numpy(), rtol=RTOL,
                               atol=ATOL)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only machine's error")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build("ex1-radioactive-decay", 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_markov_tapes.get_dy_dt(tag="ex1-radioactive-decay", size_a=2,
                                 cl_k=3)


def test_markov_tapes_validation():
    with pytest.raises(ValueError, match="subsequence probability"):
        t_markov_tapes.ode_integrate_ivp(
            tag="ex1-radioactive-decay", size_a=2, cl_k=3,
            p0=np.full(8, 0.2), ts=[0.0, 1.0], device="cpu")
    dy_dt = t_markov_tapes.get_dy_dt(tag="ex1-radioactive-decay", size_a=2,
                                     cl_k=3, device="cpu")
    with pytest.raises(ValueError, match="should have size 8"):
        dy_dt(np.full(4, 0.25))
    with pytest.raises(ValueError, match="alphabet size 2"):
        t_markov_tapes.get_dy_dt(tag="ex1-radioactive-decay", size_a=3,
                                 cl_k=3, device="cpu")


# --- K5's per-element rule, built with the host's C++ compiler ------------


_K5_HOST_ITEM = r"""
#include "sweep_rule.cuh"
extern "C" void k5_host_item(int a, int k, const double* p,
                             const double* low, const double* s,
                             const int* table, double* work, double* dy,
                             const long long* item) {
  K5Ctx c;
  c.a = a;
  c.k = k;
  c.p = p;
  c.low = low;
  c.s = s;
  c.table = table;
  c.work = work;
  c.dy = dy;
  k5_levels(c);
  const K5Item it = k5_item(item, c);
  for (unsigned e = 0; e < it.n; ++e) k5_element<false>(c, it, e);
}
"""


@pytest.fixture(scope="module")
def k5_host_item(tmp_path_factory):
    """K5's rule (`csrc/sweep_rule.cuh`) built with the host's C++
    compiler, without contraction of products into sums, into a loop
    over every element of one item."""
    cxx = next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                      "clang++")) if c), None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k5")
    (out / "k5.cpp").write_text(_K5_HOST_ITEM)
    lib = out / "libk5.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib),
                    str(out / "k5.cpp")], check=True, capture_output=True,
                   timeout=120)
    fn = ctypes.CDLL(str(lib)).k5_host_item
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, p, p, p, p, p, p, p]
    fn.restype = None
    return fn


_K4_HOST_WEIGHTS = r"""
#include "sweep_rule.cuh"
extern "C" void k4_host_weights(int a, int k, const double* p,
                                const double* low, const int* pair_num,
                                const int* pair_den, const double* pair_const,
                                int chain, const int* csr_ptr, int n_sig,
                                double* s) {
  K5Ctx c;
  c.a = a;
  c.k = k;
  c.p = p;
  c.low = low;
  k5_levels(c);
  K4Pairs w;
  w.num = pair_num;
  w.den = pair_den;
  w.w_const = pair_const;
  w.csr_ptr = csr_ptr;
  w.chain = chain;
  for (int g = 0; g < n_sig; ++g) {
    double acc = 0.0;  // the pairs' weights in pair order, as K5's warp
    for (int q = csr_ptr[g]; q < csr_ptr[g + 1]; ++q)
      acc = acc + k4_pair_weight(c, w, q);
    s[g] = acc;
  }
}
"""


@pytest.fixture(scope="module")
def k4_host_weights(tmp_path_factory):
    """K4's rule, K5's phase 0 (`csrc/sweep_rule.cuh:k4_pair_weight`, the
    pairs' weights summed in pair order as K5's warp sums them), built
    with the host's C++ compiler without contraction, for every
    signature."""
    cxx = next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                      "clang++")) if c), None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k4")
    (out / "k4.cpp").write_text(_K4_HOST_WEIGHTS)
    lib = out / "libk4.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib),
                    str(out / "k4.cpp")], check=True, capture_output=True,
                   timeout=120)
    fn = ctypes.CDLL(str(lib)).k4_host_weights
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, p, p, p, p, p, i, p, i, p]
    fn.restype = None
    return fn


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_signature_weight_rule_matches_plain(k4_host_weights, tag, cl_k):
    """K4's rule as K5's phase 0 runs it (each signature's sum forming its
    worlds' chain products anew: ex4's 24 worlds serve two signatures
    each; ex6-mini-bff-lite has 11,520 worlds and 4,536 signatures)
    equals `signature_weights_plain` bit for bit, on a concentrated SPD
    with exact zeros (the guard's 0 branch)."""
    _, prog = _programs(tag, cl_k)
    dp = tdense.device_program(prog, "cpu")
    a, n = prog.size_a, prog.state_size
    rng = np.random.RandomState(17)
    p = _spd(rng, n, True)
    p[rng.rand(n) < 0.2] = 0.0
    p = torch.as_tensor(p / p.sum())
    low = tdense.pyramid(p, a, cl_k)
    got = torch.full((prog.num_signatures,), np.nan, dtype=torch.float64)
    k4_host_weights(a, cl_k, _ptr(p), _ptr(low), _ptr(dp.pair_num),
                    _ptr(dp.pair_den), _ptr(dp.pair_const),
                    prog.w_num.shape[1], _ptr(dp.csr_ptr),
                    prog.num_signatures, _ptr(got))
    want = tdense.signature_weights_plain(dp, p, low)
    assert torch.equal(got, want)
    assert bool((want != 0).any())
    if tag.startswith("ex4-chemical-turing"):
        assert np.bincount(prog.pair_world).min() == 2


def _dense_steps(dp, p, low, s):
    """Every step's dense vector by the plain step, in plan order."""
    a, k = dp.prog.size_a, dp.prog.cl_k
    tables = tdense.named_tables(p, low, a, k)
    vecs = {}
    for i, st in enumerate(dp.plan.steps):
        if st.kind != tdense.INTERIOR:
            src = (vecs[st.src] if st.src >= 0
                   else tdense._seed_dense(st, s))
            vecs[i] = tdense.sweep_step_plain(st, src, tables, a)
    return vecs


@pytest.mark.parametrize("tag,cl_k", [("ex4-chemical-turing", 3),
                                      ("ex6-mini-bff-lite", 2),
                                      (_LONG_TAG, 3)])
def test_sweep_rule_matches_plain_step(k5_host_item, tag, cl_k):
    """Every item of the plan in K5's order, computed for every element
    by the kernel's rule (compact vectors over the live windows, seeds
    read sparsely, ratios from the pyramid, the emission as a gather at
    the target windows) and by the plain step (dense vectors, the
    sub-slice scatter) from the same inputs: the live windows' t equal
    bit for bit, every other window exactly 0 in the plain step, dy bit
    for bit after each emission and at the end equal to `sweep_plain`'s
    (which walks the same items)."""
    prog = tdense.compile_dense(tag, cl_k)
    dp = tdense.device_program(prog, "cpu")
    a, n = prog.size_a, prog.state_size
    plan = dp.plan
    p = torch.as_tensor(_spd(np.random.RandomState(13), n, True))
    low = tdense.pyramid(p, a, cl_k)
    s = tdense.signature_weights_plain(dp, p, low)
    dense = _dense_steps(dp, p, low, s)
    work = torch.zeros(max(plan.work_size, 1), dtype=torch.float64)
    table = torch.as_tensor(plan.table)
    got_dy = torch.zeros(n, dtype=torch.float64)
    want_dy = torch.zeros(n, dtype=torch.float64)
    kinds = set()
    for q, row in enumerate(plan.items):
        row = np.ascontiguousarray(row)
        st = plan.steps[plan.item_step[q]]
        k5_host_item(a, cl_k, _ptr(p), _ptr(low), _ptr(s), _ptr(table),
                     _ptr(work), _ptr(got_dy), row.ctypes.data)
        op = int(row[0])
        kinds.add((op, int(row[4]) < 0))
        if op == tdense.INTERIOR:
            tdense.interior_plain(want_dy, s, st.interior)
        elif op == tdense.EMIT:
            tdense.emit_plain(want_dy, dense[plan.item_step[q]], st.lo,
                              st.span, st.pairs)
        else:
            want = dense[plan.item_step[q]]
            live = torch.as_tensor(st.live())
            got = work[row[3]:row[3] + row[2]]
            assert torch.equal(got, want[live]), row
            dead = torch.ones(want.numel(), dtype=torch.bool)
            dead[live] = False
            assert bool((want[dead] == 0).all()), row
        assert torch.equal(got_dy, want_dy), row
    assert torch.equal(got_dy, tdense.sweep_plain(dp, p, low, s))
    assert {k for k, _ in kinds} >= {tdense.SHIFT, tdense.RIGHT,
                                     tdense.EMIT}
    if tag == "ex4-chemical-turing":  # every kind, from seeds and vectors
        assert kinds == {
            (tdense.IDENT, True), (tdense.EXTEND, True),
            (tdense.EXTEND, False), (tdense.SHIFT, False),
            (tdense.RIGHT, True), (tdense.RIGHT, False),
            (tdense.RSHIFT, False), (tdense.RSHIFT_RUN, False),
            (tdense.EMIT, True)}
    if tag == _LONG_TAG:
        assert (tdense.INTERIOR, True) in kinds


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_sweep_live_set_holds_every_nonzero(tag, cl_k):
    """The guard on K5's zero-skipping: every nonzero of the plain
    sweep's dense vectors lies in its step's live set, on a random SPD
    with no zero entry."""
    _, prog = _programs(tag, cl_k)
    dp = tdense.device_program(prog, "cpu")
    a = prog.size_a
    p = torch.as_tensor(_spd(np.random.RandomState(15), prog.state_size))
    low = tdense.pyramid(p, a, cl_k)
    s = tdense.signature_weights_plain(dp, p, low)
    for i, t in _dense_steps(dp, p, low, s).items():
        st = dp.plan.steps[i]
        nonzero = set(torch.nonzero(t).reshape(-1).tolist())
        assert nonzero <= set(st.live().tolist()), (tag, i)
        assert t.numel() == st.hi * st.span * st.lo
    live, dense = dp.plan.element_steps
    assert live <= dense


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_emission_conflicts_match_their_windows(tag, cl_k):
    """K5's phases rest on `_emissions_meet`, which reads digit patterns:
    for every two emissions it says they meet exactly when their target
    windows, listed in full, share one; and no two emissions of one
    phase share a window."""
    _, prog = _programs(tag, cl_k)
    a, n = prog.size_a, prog.state_size
    plan = tdense.sweep_plan(prog)
    emits = [i for i, st in enumerate(plan.steps) if st.pairs or st.interior]
    pattern = {i: tdense._emission_pattern(plan.steps[i], a) for i in emits}
    windows = {i: plan.steps[i].target_windows() for i in emits}
    phase = {}
    for q, i in enumerate(plan.item_step.tolist()):
        if plan.items[q, 0] in (tdense.EMIT, tdense.INTERIOR):
            phase[i] = int(np.searchsorted(plan.phase_ptr, q, "right"))
    assert set(phase) == set(emits)
    mask = np.zeros(n, dtype=bool)
    for x, i in enumerate(emits):
        mask[:] = False
        mask[windows[i]] = True
        for i2 in emits[:x]:
            shared = bool(mask[windows[i2]].any())
            assert tdense._emissions_meet(pattern[i2], pattern[i],
                                          a) == shared, (i2, i)
            assert not (shared and phase[i] == phase[i2]), (i2, i)


def test_item_divisor_multipliers_are_exact():
    """K5 divides by each item's fixed divisors as (x * m) >> s
    (`csrc/sweep_rule.cuh:K5Div`, m from `dense._magic`): exact for every
    x < 2^31, here at the edges and at random x, for every divisor of
    the ex4 cl_k 8 and ex6-lite plans and for random ones."""
    rng = np.random.RandomState(17)
    plans = [tdense.sweep_plan(tdense.compile_dense(tag, k))
             for tag, k in (("ex4-chemical-turing", 8),
                            ("ex6-mini-bff-lite", 2))]
    m0 = tdense.ITEM_FIELDS.index("m_lo")
    divisors = {1, 2, 3, 2**31 - 1, 2**30 + 3}
    for plan in plans:
        # the plan's multipliers: those of divisors >= 1
        assert plan.items[:, m0:m0 + 8].min() >= 2**31
        for row in plan.items.tolist():
            f = dict(zip(tdense.ITEM_FIELDS, row))
            divisors |= {max(f[x], 1) for x in ("lo", "d", "xn", "xlo")}
            divisors.add(max(f["lev"], 1))
    divisors |= set(rng.randint(1, 2**31, 500).tolist())
    for d in sorted(divisors):
        m, shift = tdense._magic(d), 31 + (d - 1).bit_length()
        assert m < 2**33
        xs = [0, 1, d - 1, d, d + 1, 2**31 - 1, 2**31 - 2]
        xs += rng.randint(0, 2**31, 64).tolist()
        for x in xs:
            if x < 2**31:
                assert (x * m) >> shift == x // d, (x, d)


def test_nan_entry_gives_nonfinite_dy():
    """A p with a NaN entry: dy is not finite, through the wrapper and
    through the plain version (which K5 does not match element for
    element there: the dense step's NaN * 0 lies outside the live
    windows)."""
    fn, prog = t_build("ex4-chemical-turing", 3, device="cpu")
    p = _spd(np.random.RandomState(16), prog.state_size)
    p[prog.state_size // 3] = np.nan
    assert not torch.isfinite(fn(p)).all()
    dp = fn.device_program
    assert not torch.isfinite(tdense.dy_dt_dense(
        dp, torch.as_tensor(p))).all()


# --- K5's and K25's launch forms ------------------------------------------

# The programs phase 14 of `chip_smoke.py` launches K25 on, by path: (c)
# kvaerno3, (d) the steady states of `tests/test_steady.py`, (e)
# `examples/ex2_correlations.py`; ex4 at cl_k 5.
PHASE14_FORMS = {
    ("ex4var2-chemical-turing", 5): "grid",  # (c)
    ("ex2-ferromagnetic-chain", 3): "block",  # (d)
    ("ex1-radioactive-decay", 3): "block",
    ("ex4var2-chemical-turing", 3): "block",
    ("ex2-ferromagnetic-chain", 6): "block",
    ("ex2-ferromagnetic-chain-p", 4): "block",  # (e)
    ("ex4-chemical-turing", 5): "grid",
    ("ex4-chemical-turing", 4): "cluster",
    ("ex6-mini-bff-lite", 2): "cluster",
}


@pytest.mark.parametrize("tag,cl_k", CASES + sorted(set(PHASE14_FORMS)
                                                    - set(CASES)))
def test_launch_form_chooser(tag, cl_k):
    """`dense.launch_form` by a program's largest phase: one block of
    1,024 threads up to `BLOCK_MOST` elements (a warp's lanes for each
    signature counted), a cluster of 2 to 16 blocks of 1,024 (about four
    elements a thread) where the plan's largest phase is up to
    `CLUSTER_MOST`, else the grid; the form `device_program` stores; the
    forms phase 14's programs and the cluster's two take; `forms_for`
    lists the grid and the chosen form; the block and cluster forms need
    no K3 launch an RHS."""
    prog = tdense.compile_dense(tag, cl_k)
    dp = tdense.device_program(prog, "cpu")
    most = tdense.launch_elements(prog, dp.plan)
    assert most == max(dp.plan.max_phase, 32 * prog.num_signatures)
    form = dp.form
    assert form == tdense.launch_form(prog, dp.plan)
    if most <= tdense.BLOCK_MOST:
        assert form == tdense.LaunchForm(1, 1)
    elif dp.plan.max_phase <= tdense.CLUSTER_MOST:
        assert form.kind == 2 and 2 <= form.blocks <= 16
    else:
        assert form == tdense.LaunchForm(0)
    want = PHASE14_FORMS.get((tag, cl_k))
    if want is not None:
        assert tdense.LAUNCH_FORMS[form.kind] == want
    forms = tdense.forms_for(dp)
    assert forms[0] == tdense.LaunchForm(0) and form in forms
    assert tdense.rhs_pyramid_launches(dp) == (
        0 if form.kind else tdense.pyramid_launches(prog.size_a, cl_k))


def test_launch_form_past_the_cluster():
    """A plan past `CLUSTER_MOST` elements (ex4 at cl_k 5-8) takes the
    cooperative grid, with K3 before it."""
    prog = tdense.compile_dense("ex4-chemical-turing", 6)
    plan = tdense.sweep_plan(prog)
    assert plan.max_phase > tdense.CLUSTER_MOST
    assert tdense.launch_form(prog, plan) == tdense.LaunchForm(0)
    big = dataclasses.replace(plan, max_phase=43_046_721)
    assert tdense.launch_form(prog, big).kind == 0


_K5_HOST_LEVELS = r"""
#include "sweep_rule.cuh"
extern "C" void k5_host_levels(int a, int k, int tapes, const double* p,
                               const double* v, double* low, double* vlow) {
  K5CtxT<double> c = {};
  c.a = a;
  c.k = k;
  k5_levels(c);
  c.p = p;
  c.v = v;
  K5LevelOut o;
  o.lv = low;
  o.vlv = vlow;
  o.tapes = tapes;
  o.low_block = c.lv_off[0] + 2;
  for (int j = k - 1; j >= 0; --j) {
    const unsigned n = k5_level_count(c, o, j);
    for (unsigned x = 0; x < n; ++x) k5_level_entry(c, o, j, x);
    if (j == 0)
      for (unsigned y = 0; y < k5_level_ways(o) * (unsigned)tapes; ++y)
        k5_level_one(c, o, y);
  }
}
"""


@pytest.fixture(scope="module")
def k5_host_levels(tmp_path_factory):
    """The block and cluster forms' leading phases (`csrc/sweep_rule.cuh:
    k5_level_entry`, `k5_level_one`), level after level, built with the
    host's C++ compiler without contraction."""
    cxx = next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                      "clang++")) if c), None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k5levels")
    (out / "levels.cpp").write_text(_K5_HOST_LEVELS)
    lib = out / "liblevels.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib),
                    str(out / "levels.cpp")], check=True, capture_output=True,
                   timeout=120)
    fn = ctypes.CDLL(str(lib)).k5_host_levels
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, i, p, p, p, p]
    fn.restype = None
    return fn


@pytest.mark.parametrize("a,k,tapes,with_v", [
    (2, 3, 1, True), (2, 6, 1, False), (10, 3, 1, True), (9, 5, 1, True),
    (2, 13, 1, False), (5, 4, 2, True), (6, 3, 2, False), (3, 1, 1, True)])
def test_in_launch_levels_match_pyramid_plain(k5_host_levels, a, k, tapes,
                                              with_v):
    """The levels a block- or cluster-form launch forms (of p, and of v
    beside it) equal `pyramid_plain`'s bit for bit on every tape, the 1
    above level 0 included: the same children summed in the same order.
    A third of p's entries are exact zeros; v has both signs."""
    rng = np.random.RandomState(a * 100 + k)
    n = a**k
    p = rng.dirichlet(np.ones(n) * 0.3, size=tapes)
    p[rng.rand(tapes, n) < 1 / 3] = 0.0
    v = rng.randn(tapes, n) * p
    size = (n - 1) // (a - 1) + 1  # levels k - 1 .. 0, then the 1
    low = np.full(tapes * size, np.nan)
    vlow = np.full(tapes * size, np.nan)
    k5_host_levels(a, k, tapes, p.ctypes.data,
                   v.ctypes.data if with_v else None, low.ctypes.data,
                   vlow.ctypes.data if with_v else None)
    for t in range(tapes):
        want = tdense.pyramid_plain(torch.as_tensor(p[t]), a, k).numpy()
        assert want.size == size
        np.testing.assert_array_equal(low[t * size:(t + 1) * size], want)
        if with_v:
            want_v = tdense.pyramid_plain(torch.as_tensor(v[t]), a,
                                          k).numpy()
            np.testing.assert_array_equal(vlow[t * size:(t + 1) * size],
                                          want_v)
    if not with_v:
        assert np.isnan(vlow).all()
