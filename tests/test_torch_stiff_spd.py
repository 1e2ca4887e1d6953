"""Twin of `tests/test_ode.py:326`: the port's stiff stepper reproduces
the explicit solver's trajectory on a (non-stiff) SPD, through
`ode/integrate.solve` (CPU, the kernels' plain versions).

ex2 at cl_k 3 from uniform, ts = linspace(0, 3, 7): kvaerno3 at rtol
1e-8, atol 1e-10 within rtol 2e-6, atol 1e-9 of DOP853 at 1e-10, 1e-12,
row sums 1 within 1e-7; and the JAX package's step count (610 accepted,
1 rejected: the port walks its steps). Its own file: some 36,000 J.v
products through the plain dual sweep take most of a minute on one
CPU.
"""

import numpy as np

from chemical_kinetics_and_program_execution_torch.engine import (
    build_dy_dt as t_build,
)
from chemical_kinetics_and_program_execution_torch.ode.integrate import solve


def test_kvaerno3_spd_parity_with_explicit():
    fn, _ = t_build("ex2-ferromagnetic-chain", 3, device="cpu")
    p0 = np.full(8, 1.0 / 8)
    ts = np.linspace(0.0, 3.0, 7)
    ys_exp = solve(lambda y, t: fn(y), p0, ts, rtol=1e-10, atol=1e-12,
                   device="cpu")
    ys_stiff, info = solve(lambda y, t: fn(y), p0, ts, rtol=1e-8,
                           atol=1e-10, method="kvaerno3", device="cpu",
                           return_info=True)
    np.testing.assert_allclose(ys_stiff, ys_exp, rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(ys_stiff.sum(axis=1), 1.0, rtol=1e-7)
    assert (info["num_accepted"], info["num_rejected"]) == (610, 1)
