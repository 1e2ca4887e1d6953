"""The port's stiff stepper and fixed-grid solve against the JAX
package's tests (CPU, the kernels' plain versions).

Twins of `tests/test_ode.py` at its sizes and bounds: :290 (Kvaerno 3(2)
on Robertson against scipy's Radau), :346 (the scipy stiff names route
to the stiff stepper, as the JAX package's `_STEPPERS` routes them) and
:355 (the fixed-grid RK5 against the adaptive DOP853 on ex2 at cl_k 4).
:326 (kvaerno3 against DOP853 on an SPD) is in
`tests/test_torch_stiff_spd.py`.
"""

import numpy as np
import scipy.integrate
import torch

from chemical_kinetics_and_program_execution_tpu.ode import (
    integrate as j_integrate,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    build_dy_dt as t_build,
)
from chemical_kinetics_and_program_execution_torch.models import (
    initial_states,
)
from chemical_kinetics_and_program_execution_torch.ode import integrate
from chemical_kinetics_and_program_execution_torch.ode.dop853 import (
    odeint_dop853,
)
from chemical_kinetics_and_program_execution_torch.ode.fixed import (
    odeint_fixed,
)
from chemical_kinetics_and_program_execution_torch.ode.kvaerno3 import (
    odeint_kvaerno3,
)


def _rob(y, t):
    d1 = -0.04 * y[0] + 1e4 * y[1] * y[2]
    d3 = 3e7 * y[1] * y[1]
    return torch.stack([d1, -d1 - d3, d3])


def test_kvaerno3_robertson_stiff_vs_radau():
    """Robertson (rates over 9 orders of magnitude) to t = 1e4: completed
    in fewer than 10,000 accepted steps, within rtol 1e-6, atol 1e-12 of
    scipy's Radau at rtol 1e-10, atol 1e-12; torch's forward mode takes
    J v of the RHS written in torch ops."""
    ts = np.array([0.0, 1e-2, 1.0, 1e2, 1e4])
    y0 = np.array([1.0, 0.0, 0.0])
    ys, info = odeint_kvaerno3(_rob, torch.as_tensor(y0), ts,
                               (1e-8, 1e-10))
    assert info.completed
    assert info.num_accepted < 10_000
    assert info.num_jvp > info.num_newton > 0
    ref = scipy.integrate.solve_ivp(
        lambda t, y: _rob(torch.as_tensor(y), t).numpy(), (0, 1e4), y0,
        t_eval=ts, rtol=1e-10, atol=1e-12, method="Radau").y.T
    np.testing.assert_allclose(ys.numpy()[1:], ref[1:], rtol=1e-6,
                               atol=1e-12)


def test_stiff_method_name_routing():
    """The scipy stiff names route to the stiff stepper, as in the JAX
    package."""
    for name in ("lsoda", "radau", "bdf", "kvaerno3"):
        assert integrate._STEPPERS[name] == "odeint_kvaerno3"
        assert j_integrate._STEPPERS[name] == "odeint_kvaerno3"
    assert integrate.odeint_kvaerno3 is odeint_kvaerno3


def test_fixed_grid_matches_adaptive_on_spd():
    """The fixed-grid RK5 (K6's dopri5 rows) reproduces the adaptive
    DOP853 on ex2 at cl_k 4 within rtol 1e-8, atol 1e-11, and conserves
    probability within 1e-12."""
    dfn, _ = t_build("ex2-ferromagnetic-chain", 4, device="cpu")
    p0 = initial_states.ferromagnet_p0(4, corrected=True).ravel()
    ts = np.linspace(0.0, 20.0, 11)
    ys_fixed = odeint_fixed(lambda y, t: dfn(y), p0, ts, n_sub=16,
                            device="cpu")
    ys_adapt, _ = odeint_dop853(lambda y, t: dfn(y), torch.as_tensor(p0),
                                ts, (1e-12, 1e-14))
    np.testing.assert_allclose(ys_fixed.numpy(), ys_adapt.numpy(),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(ys_fixed.numpy().sum(axis=1), 1.0,
                               rtol=1e-12)
