"""Parity of the port's autocatalysis kinetics (`models/autocatalysis.py`)
with the JAX package (CPU).

The rate law equals the JAX package's to rounding. The sweep's plain
solver (`_solve_batch_plain`, K29's plain version) takes each member's
steps as the JAX package's vmapped dopri5: on the example's 12 rows at
sample times 0, 1, 2 (and 0, 0.5, 1, 1.5) its samples lie within rtol
1e-10 of the JAX package's `integrate_sweep` and its accepted and
rejected steps equal each member's `odeint_dopri5` run. On the
example's own 0.01 grid the step count hangs on rounding: XLA's CPU
backend contracts products into sums (fused multiply-adds) where the
port rounds each product, and a
one-ulp change of a member's start moves the JAX package's own count
(345 to 354 accepted steps on row 0 at 201 samples), so the counts are
compared on grids where they stand. K29's rule (`csrc/dopri5_rule.cuh`,
built with the host's C++ compiler) takes the plain version's steps to
rtol 1e-12 (the two libraries' ``pow`` round apart). `find_equilibrium`
lands within 1e-8 of the JAX package's. Then the twins of
`tests/test_models.py:75` and `:86`.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu.models import (
    autocatalysis as ja,
)
from chemical_kinetics_and_program_execution_tpu.ode.dopri5 import (
    odeint_dopri5 as j_dopri5,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.models import (
    autocatalysis,
)
from chemical_kinetics_and_program_execution_torch.ode import dop853


def _example_rows():
    """The 12 rows of `examples/autocatalysis.py` (its PARAM_SETS)."""
    src = (Path(__file__).resolve().parent.parent / "examples"
           / "autocatalysis.py").read_text()
    scope = {}
    exec(src[src.index("PARAM_SETS = {"):src.index("STYLES")], scope)
    return np.array(sum(scope["PARAM_SETS"].values(), []))


ROWS = _example_rows()
TOLS = (1.49012e-8, 1.49012e-8)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the steps here are many short ops on
    small tensors, which a full thread pool runs several times slower on
    a host whose cores other test workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@jax.jit
def _jax_member(y0, p, ts):
    _, info = j_dopri5(lambda y, t: ja.dy_dt(y, p), y0, ts, TOLS,
                       max_steps=200_000)
    return info["num_accepted"], info["num_rejected"]


def test_dy_dt_matches_jax():
    rng = np.random.RandomState(0)
    for row in ROWS:
        y = rng.rand(3)
        want = np.asarray(ja.dy_dt(jnp.asarray(y), jnp.asarray(row[3:])))
        got = autocatalysis.dy_dt(torch.as_tensor(y),
                                  torch.as_tensor(row[3:])).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)
    batch = autocatalysis.dy_dt(torch.as_tensor(ROWS[:, :3]),
                                torch.as_tensor(ROWS[:, 3:]))
    assert batch.shape == (12, 3)


def test_tableau_rows_are_k6s():
    """K29's coefficients are K6's second table (`dop853.TABLEAU`):
    A's rows 1-6, B5 and B5 - B4 of the Dormand-Prince 5(4) pair."""
    rows = autocatalysis.tableau_rows()
    for i in range(6):
        want = [(j, c) for j, c in enumerate(dop853.DP5_A[i + 1]) if c != 0]
        assert rows[i] == want
    assert rows[6] == [(j, c) for j, c in enumerate(dop853.DP5_B5) if c != 0]
    assert rows[7] == [(j, c) for j, c in enumerate(dop853.DP5_ERR) if c != 0]
    coef, has = autocatalysis.tableau_arrays()
    assert coef.shape == has.shape == (8, 7) and has.sum() == sum(
        len(r) for r in rows)


@pytest.mark.parametrize("ts", [np.linspace(0.0, 2.0, 3),
                                np.linspace(0.0, 1.5, 4)])
def test_sweep_matches_jax(ts):
    """The 12 example rows: samples within rtol 1e-10 of the JAX
    package's `integrate_sweep`, every member's steps equal its JAX
    `odeint_dopri5` run's."""
    want = ja.integrate_sweep(ROWS, ts)
    ys, info = autocatalysis.integrate_sweep(ROWS, ts, device="cpu")
    assert ys.shape == (12, len(ts), 3) and ys.dtype == torch.float64
    np.testing.assert_allclose(ys.numpy(), want, rtol=1e-10, atol=1e-15)
    for b, row in enumerate(ROWS):
        acc, rej = _jax_member(jnp.asarray(row[:3]), jnp.asarray(row[3:]),
                               jnp.asarray(ts))
        assert int(info["num_accepted"][b]) == int(acc)
        assert int(info["num_rejected"][b]) == int(rej)


def test_max_steps_leaves_zeros_as_jax():
    """Members stop at max_steps; the samples they did not reach stay 0,
    as in the JAX package's vmapped solve."""
    ts = np.linspace(0.0, 2.0, 21)
    want = np.asarray(ja._solve_batch(jnp.asarray(ROWS[:, :3]),
                                      jnp.asarray(ROWS[:, 3:]),
                                      jnp.asarray(ts), 40))
    ys, info = autocatalysis.integrate_sweep(ROWS, ts, max_steps=40,
                                             device="cpu")
    ys = ys.numpy()
    np.testing.assert_array_equal(ys == 0, want == 0)
    np.testing.assert_allclose(ys, want, rtol=1e-10, atol=1e-15)
    assert ((info["num_accepted"] + info["num_rejected"]) == 40).all()
    assert (ys[:, -1] == 0).all() and (ys[:, 1] != 0).any()


_DP5_HOST = '#include "dopri5_rule.cuh"\n'


@pytest.fixture(scope="module")
def dp5_host(tmp_path_factory):
    """K29's rule (`csrc/dopri5_rule.cuh`: a member's whole solve, every
    member in turn) built with the host's C++ compiler without
    contraction of products into sums."""
    cxx = next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                      "clang++")) if c), None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k29")
    (out / "k29.cpp").write_text(_DP5_HOST)
    lib = out / "libk29.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib),
                    str(out / "k29.cpp")], check=True, capture_output=True,
                   timeout=120)
    fn = ctypes.CDLL(str(lib)).dp5_host_run
    i, p, d = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
    fn.argtypes = [p, p, i, p, p, p, i, d, d, ctypes.c_longlong, p, p, p]
    fn.restype = None
    return fn


@pytest.mark.parametrize("ts,max_steps", [
    (np.linspace(0.0, 1.0, 3), 200_000), (np.linspace(0.0, 1.5, 4), 200_000),
    (np.linspace(0.0, 2.0, 21), 40)])
def test_dopri5_rule_matches_plain(dp5_host, ts, max_steps):
    """K29's rule against `_solve_batch_plain` on the 12 rows: equal
    steps a member, samples within rtol 1e-12 (torch's CPU ``pow`` and
    the C library's round apart by an ulp), zeros where neither
    reached (a cap of 40 steps)."""
    want, acc, rej = autocatalysis._solve_batch_plain(
        torch.as_tensor(ROWS[:, :3].copy()), torch.as_tensor(
            ROWS[:, 3:].copy()), torch.as_tensor(ts), max_steps)
    coef, has = autocatalysis.tableau_arrays()
    y0 = np.ascontiguousarray(ROWS[:, :3])
    params = np.ascontiguousarray(ROWS[:, 3:])
    out = np.zeros((12, len(ts), 3))
    n_acc = np.zeros(12, np.int32)
    n_rej = np.zeros(12, np.int32)
    dp5_host(coef.ctypes.data, has.ctypes.data, 12, y0.ctypes.data,
             params.ctypes.data, ts.ctypes.data, len(ts),
             autocatalysis.RTOL, autocatalysis.ATOL, max_steps,
             out.ctypes.data, n_acc.ctypes.data, n_rej.ctypes.data)
    np.testing.assert_array_equal(n_acc, acc.numpy())
    np.testing.assert_array_equal(n_rej, rej.numpy())
    np.testing.assert_array_equal(out == 0, want.numpy() == 0)
    np.testing.assert_allclose(out, want.numpy(), rtol=1e-12, atol=0)


def test_find_equilibrium_matches_jax():
    """From the last row's state at t = 20: within 1e-8 of the JAX
    package's minimiser, residual below 1e-10."""
    row = ROWS[-4]
    ts = np.linspace(0.0, 20.0, 3)
    y_end = ja.integrate_sweep(row[None], ts)[0, -1]
    want, want_res = ja.find_equilibrium(y_end, row[3:])
    got, res = autocatalysis.find_equilibrium(y_end, row[3:], device="cpu")
    assert res < 1e-10 and want_res < 1e-10
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


# --- Twins of tests/test_models.py ------------------------------------------

def test_autocatalysis_conserves_mass_closed_reactor():
    """With c_add = c_remove = 0, 2[A] + 2[B] + [M] is conserved."""
    row = np.array([0.0, 0.0, 1.0,
                    0.001, 20.0, 10.0, 0.001, 50.0, 20.0, 0.0, 0.0])
    ts = np.linspace(0, 50, 501)
    ys = autocatalysis.integrate_sweep(row[None], ts, device="cpu")[0][0]
    ys = ys.numpy()
    total = 2 * ys[:, 0] + 2 * ys[:, 1] + ys[:, 2]
    np.testing.assert_allclose(total, total[0], rtol=1e-7)


def test_autocatalysis_equilibrium_is_stationary():
    row = np.array([0.0, 0.0, 1.0,
                    0.05, 20.0, 10.0, 0.05, 25.0, 10.0, 1.0, 1.0])
    ts = np.linspace(0, 200, 201)
    ys = autocatalysis.integrate_sweep(row[None], ts, device="cpu")[0][0]
    y_eq, residual = autocatalysis.find_equilibrium(ys[-1].numpy(), row[3:],
                                                    device="cpu")
    assert residual < 1e-10
