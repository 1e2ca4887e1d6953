"""Twin of `tests/test_steady.py:135`: support mode on the free-enthalpy
machine, through the port (CPU, the kernels' plain versions).

ex4var2 at cl_k 3 relaxed on the fixed grid to t = 1000 (200 RK5
substeps), then PTC in support mode (dead windows pinned to 0, every
linear invariant of the support-restricted dynamics: numpy's
default_rng(0) probes), at the JAX test's settings and bounds: residual
below 5e-8 (the reference's t = 10^4 integration endpoint is 4.5e-8 from
stationary), dead windows exactly 0, mass 1 within 1e-6. Its own file:
some 10,000 J.v products of the plain dual sweep take two to three
minutes on one CPU.
"""

import numpy as np
import torch

from chemical_kinetics_and_program_execution_torch.engine import (
    build_dy_dt as t_build,
)
from chemical_kinetics_and_program_execution_torch.models.initial_states import (  # noqa: E501
    chemical_turing_v2_p0,
)
from chemical_kinetics_and_program_execution_torch.ode.fixed import (
    odeint_fixed,
)
from chemical_kinetics_and_program_execution_torch.ode.steady import (
    make_steady_state,
)


def test_support_mode_on_the_free_enthalpy_machine():
    dfn, _ = t_build("ex4var2-chemical-turing", 3, device="cpu")
    p0 = torch.as_tensor(chemical_turing_v2_p0(3).ravel())
    ys = odeint_fixed(lambda y, t: dfn(y), p0, [0.0, 1e3], n_sub=200)
    pw = torch.clamp(ys[-1], min=0.0)
    solve = make_steady_state(
        lambda p, a: dfn(p), size_a=10, cl_k=3, conserved="support",
        support_guess=pw.numpy(), delta0=1e12, max_iter=150,
        gmres_restart=60, gmres_maxiter=4, device="cpu")
    p_inf, info = solve(pw, None)
    assert info.residual < 5e-8
    dead = pw.numpy() <= 1e-20
    assert dead.any()
    assert float(p_inf[torch.as_tensor(dead)].abs().max()) == 0.0
    assert abs(float(p_inf.sum()) - 1.0) < 1e-6
    assert info.matvecs > 0
