"""The port's parametric rate constants (`engine/parametric.py`) and rate
parameter hooks against the JAX package (CPU).

- `traced_consts` at the defaults and at perturbed parameters (the
  ``prepare`` hook of ex4var2-p included) equals the JAX package's within
  rtol 1e-13; `ParametricDense.dy_dt` and its J.v in p (K25 with the
  run-time w_const) equal JAX's at the same ``pd.consts(params)``,
  carried across as numpy (rtol 1e-12, the J.v with the floor of
  `tests/test_torch_jvp.py`).
- Twins of `tests/test_parametric.py` that need no gradient, at its sizes
  and bounds: :33 (the defaults equal the baked RHS), :44 (a perturbed
  parameter equals a fresh compile with it baked in), :121 (a rule with
  no parameters raises), :183 (a grid of betas, a loop here where JAX
  vmaps) and :241's baked parity.
- `examples/ex2_correlations.py`'s steady-state continuation through the
  port against its committed `examples/ex2_correlations.npz` (atol 1e-9).
- `ferromagnet_p0_traced` and `ising_gibbs_windows` equal the JAX
  package's.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu.engine import (
    build_dy_dt as j_build,
)
from chemical_kinetics_and_program_execution_tpu.engine import (
    parametric as jparam,
)
from chemical_kinetics_and_program_execution_tpu.models import (
    ferromagnet as j_ferro,
)
from chemical_kinetics_and_program_execution_tpu.models import (
    initial_states as j_init,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    build_dy_dt as t_build,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    parametric as tparam,
)
from chemical_kinetics_and_program_execution_torch.engine.dsl import (
    DATA,
    get_problem,
    register_problem,
)
from chemical_kinetics_and_program_execution_torch.models import (
    ferromagnet as t_ferro,
)
from chemical_kinetics_and_program_execution_torch.models import (
    initial_states as t_init,
)
from chemical_kinetics_and_program_execution_torch.ode.steady import (
    make_steady_state,
)

TAG = "ex2-ferromagnetic-chain-p"
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _valid_p(cl_k):
    return t_init.ferromagnet_p0(cl_k, p_pair=0.02, corrected=True).ravel()


def _iid(cl_k):
    """`tests/test_parametric.py:241`'s iid p0 with mass on adjacent
    same-comonomer windows."""
    psym = np.array([0.7, 0.1, 0.1, 0.1])
    p = psym
    for _ in range(cl_k - 1):
        p = np.multiply.outer(p, psym)
    return p.ravel()


@pytest.mark.parametrize("tag,cl_k,params", [
    (TAG, 4, {"J": 1.3, "h": 0.2, "beta": 0.7}),
    ("ex3var1-copolymerization-p", 4, {"q_reject": 0.6}),
    ("ex3var2-copolymerization-p", 4, {"k_rev": 0.05}),
    ("ex4-chemical-turing-p", 3, {"suppression": 0.1}),
    ("ex4var2-chemical-turing-p", 3, {"beta": 1.1, "G_P": 6.2, "G_X": 0.0,
                                      "G_E": 1.0, "G_A": -1.0, "G_B": -1.0,
                                      "G_C": -1.0, "G_D": 1.5}),
])
def test_parametric_rhs_and_jvp_equal_jax(tag, cl_k, params):
    """The consts at the defaults and at ``params`` equal JAX's; dy_dt and
    its J.v at JAX's consts carried over as numpy equal JAX's."""
    pd = tparam.ParametricDense(tag, cl_k, device="cpu")
    jpd = jparam.ParametricDense(tag, cl_k)
    rng = np.random.default_rng(21)
    n = pd.prog.state_size
    for prm in (get_problem(tag).param_defaults, params):
        w = pd.consts(prm)
        jw = np.asarray(jpd.consts({k: jnp.asarray(v, jnp.float64)
                                    for k, v in prm.items()}))
        np.testing.assert_allclose(w.numpy(), jw, rtol=1e-13, atol=0)
        p = rng.dirichlet(np.ones(n))
        v = rng.standard_normal(n)
        got = pd.dy_dt(torch.as_tensor(p), torch.as_tensor(jw))
        want = np.asarray(jpd.dy_dt(jnp.asarray(p), jnp.asarray(jw)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
        wt = torch.as_tensor(jw)
        jv = torch.func.jvp(lambda q: pd.dy_dt(q, wt), (torch.as_tensor(p),),
                            (torch.as_tensor(v),))[1]
        want = np.asarray(jax.jvp(lambda q: jpd.dy_dt(q, jnp.asarray(jw)),
                                  (jnp.asarray(p),), (jnp.asarray(v),))[1])
        np.testing.assert_allclose(jv.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def test_parametric_matches_baked_at_defaults():
    """Twin of `tests/test_parametric.py:33`."""
    pd, prog = tparam.make_parametric_dense(TAG, 4, device="cpu")
    dfn, _ = t_build("ex2-ferromagnetic-chain", 4, device="cpu")
    p = _valid_p(4)
    got = pd(torch.as_tensor(p), get_problem(TAG).param_defaults).numpy()
    want = dfn(p).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-16)
    assert prog is pd.prog


def test_parametric_matches_fresh_compile_at_perturbed_params():
    """Twin of `tests/test_parametric.py:44`: a run-time beta equals a
    rule compiled with it baked in."""
    beta = 1.37

    @register_problem("_test-ex2-beta-baked", ("D", "U"))
    def _baked(t):
        mid = t.get_sym(DATA, 0)
        left = t.get_sym(DATA, -1)
        right = t.get_sym(DATA, +1)
        energy_j = ((1 if left == mid else -1)
                    + (1 if mid == right else -1))
        factor_a = math.exp(-(beta * 1.0 * (4 + 2 * energy_j)))
        factor_b = (math.exp(-2.0 * beta * 0.25)
                    if mid == "D" else 1.0)  # h = -0.25
        p_flip = factor_a * factor_b
        if t.choose([(p_flip, True), (1.0 - p_flip, False)]):
            t.set_sym(DATA, 0, "D" if mid == "U" else "U")

    pd, _ = tparam.make_parametric_dense(TAG, 3, device="cpu")
    dfn, _ = t_build("_test-ex2-beta-baked", 3, device="cpu")
    p = _valid_p(3)
    got = pd(torch.as_tensor(p), {"J": 1.0, "h": -0.25, "beta": beta})
    np.testing.assert_allclose(got.numpy(), dfn(p).numpy(), rtol=1e-13,
                               atol=1e-16)


def test_parametric_requires_declared_params():
    """Twin of `tests/test_parametric.py:121`."""
    with pytest.raises(ValueError, match="declares no parameters"):
        tparam.make_parametric_dense("ex2-ferromagnetic-chain", 3,
                                     device="cpu")


def test_parametric_over_parameter_grid():
    """Twin of `tests/test_parametric.py:183`: the RHS over a grid of 7
    betas (a loop), each equal to the JAX package's at that beta."""
    pd, _ = tparam.make_parametric_dense(TAG, 3, device="cpu")
    jpd, _ = jparam.make_parametric_dense(TAG, 3)
    p = _valid_p(3)
    for b in np.linspace(0.5, 2.0, 7):
        prm = {"J": 1.0, "h": -0.25, "beta": float(b)}
        got = pd(torch.as_tensor(p), prm).numpy()
        assert got.shape == (8,)
        want = np.asarray(jpd(jnp.asarray(p), {
            k: jnp.asarray(v, jnp.float64) for k, v in prm.items()}))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-16)


@pytest.mark.parametrize("ptag,btag", [
    ("ex3var1-copolymerization-p", "ex3var1-copolymerization"),
    ("ex3var2-copolymerization-p", "ex3var2-copolymerization"),
])
def test_parametric_ex3_matches_baked(ptag, btag):
    """`tests/test_parametric.py:241`'s baked parity: at the declared
    defaults each ex3 parametric RHS equals its baked twin."""
    pd, _ = tparam.make_parametric_dense(ptag, 4, device="cpu")
    dfn, _ = t_build(btag, 4, device="cpu")
    p = torch.as_tensor(_iid(4))
    got = pd(p, get_problem(ptag).param_defaults).numpy()
    np.testing.assert_allclose(got, dfn(p).numpy(), rtol=1e-13, atol=1e-16)


def test_ex2_correlations_continuation_through_the_port():
    """`examples/ex2_correlations.py`'s `compute_steady_spds` through the
    port: `ParametricDense("ex2-ferromagnetic-chain-p", 4)`, the steady
    state's continuation over its 11 betas at tol 1e-13 with the probes
    at the defaults' consts; every solve converges, and the 11 SPDs lie
    within 1e-9 of the committed npz."""
    pd = tparam.ParametricDense(TAG, 4, device="cpu")
    defaults = pd.problem.param_defaults
    solve = make_steady_state(lambda p, w: pd.dy_dt(p, w), size_a=2,
                              cl_k=4, tol=1e-13,
                              probe_args=pd.consts(defaults), device="cpu")
    spds, guess = [], torch.full((16,), 1.0 / 16, dtype=torch.float64)
    for beta in np.linspace(0.2, 1.2, 11):
        prm = dict(defaults)
        prm["beta"] = float(beta)
        p_inf, info = solve(guess, pd.consts(prm))
        assert info.converged, beta
        spds.append(p_inf.numpy())
        guess = p_inf
    want = np.load(os.path.join(EXAMPLES, "ex2_correlations.npz"))["spds"]
    np.testing.assert_allclose(np.stack(spds), want, rtol=0, atol=1e-9)


def test_traced_p0_and_gibbs_equal_jax():
    """`ferromagnet_p0_traced` (a float and a 0-d tensor) equals the JAX
    package's to rounding (1 - the sum, summed in another order), and
    `ising_gibbs_windows` exactly."""
    for k in (3, 4, 6):
        want = np.asarray(j_init.ferromagnet_p0_traced(k, 0.02))
        for pp in (0.02, torch.tensor(0.02, dtype=torch.float64)):
            np.testing.assert_allclose(
                t_init.ferromagnet_p0_traced(k, pp).numpy(), want, rtol=0,
                atol=1e-15)
        for beta in (0.4, 1.0):
            np.testing.assert_array_equal(
                t_ferro.ising_gibbs_windows(k, J_eff=2.0, h=-0.25,
                                            beta=beta),
                j_ferro.ising_gibbs_windows(k, J_eff=2.0, h=-0.25,
                                            beta=beta))
