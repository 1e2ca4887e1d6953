"""Drop-in counterpart of the reference's `markov_tapes` Python API.

Counterpart of the JAX package's `markov_tapes.py`: the analysis helpers,
`get_dy_dt`, `ode_integrate`, `ode_integrate_ivp` and the import-time
canary `_run_validation`. The RHS runs on ``device`` (``cuda`` unless
named: the kernels K3-K5, or K3 and K7 where `build_dy_dt` takes the
tree engine; on the CPU their plain versions).
``backend="torch"`` solves on that device with the host-stepped steppers
of `ode/integrate.py:solve` (dopri5 from tolerances of 1e-9 up, DOP853
below; their arithmetic kernel K6), the counterpart of the JAX
package's ``"jax"``;
``"scipy"`` stays the default, as there. ``debug=True`` computes as
usual; where ``MARKOV_TAPES_DEBUG`` (or ``CKPE_DEBUG``) is set
(`IS_DEBUG`) each RHS call also prints the rule's worlds
(`engine/reference.py:dump_worlds`, at most 200), as the reference's
debug path does. `init_gambit` is the reference's no-op.
"""

from __future__ import annotations

import types

import numpy as np

from .engine import build_dy_dt
from .markov import (  # noqa: F401  (re-exported API surface)
    ctm_from_mpp,
    get_ctm_eigenvalue1_eigenspace,
    markov_entropy,
    mpp_from_spd,
    seq_prob,
    tprint,
)
from .ode.integrate import solve
from .utils import config

IS_DEBUG = config.IS_DEBUG


def init_gambit():
    """No-op, as in the JAX package: there is no Scheme runtime to boot."""


def get_dy_dt(*, tag, size_a, cl_k, debug=False, device=None):
    """Returns the ``(probs_in, t) -> dp/dt`` RHS of a registered problem,
    numpy in and out, with the reference's state-size validation; the
    device function (tensors in and out) rides in ``.device_fn``.
    ``debug=True`` with `IS_DEBUG` set prints the time and the rule's
    worlds at the input SPD (`engine/reference.py:dump_worlds`, at most
    200) on every call, and changes nothing otherwise."""
    fn, compiled = build_dy_dt(tag, cl_k, device=device)
    if compiled.size_a != size_a:
        raise ValueError(
            f"Problem {tag!r} has alphabet size {compiled.size_a}, "
            f"but size_a={size_a} was requested."
        )
    expected_size = size_a**cl_k

    def dy_dt(a_probs_in, t=0.0):
        probs = np.asarray(a_probs_in, dtype=np.float64).ravel()
        if probs.size != expected_size:
            raise ValueError(
                f"probability-array should have size {expected_size}, "
                f"observed: {probs.size}"
            )
        if debug and IS_DEBUG:
            # The reference's per-world dump of (p_world, program, old and
            # new sequences) at each RHS call.
            from .engine.reference import dump_worlds

            print(f"[ckpe] dy_dt t={t:.10g}")
            dump_worlds(tag, cl_k, probs, limit=200)
        return fn(probs).cpu().numpy()

    dy_dt.compiled = compiled
    dy_dt.device_fn = fn
    return dy_dt


def _validate_p0(p0, size_a, cl_k):
    p0 = np.asarray(p0, dtype=np.float64).ravel()
    if not (
        p0.size == size_a**cl_k
        and (0 <= p0).all()
        and (p0 <= 1).all()
        and abs(p0.sum() - 1) < 1e-10
    ):
        raise ValueError(
            "Parameter p0 is not a subsequence probability distribution."
        )
    return p0


# The device solver's names: the port's, and the reference's (its drop-in
# callers pass "jax").
_DEVICE_BACKENDS = ("torch", "jax")


def ode_integrate(*, tag, size_a, cl_k, p0, ts,
                  odeint_kwargs=types.MappingProxyType({}),
                  debug=False, backend="scipy", device=None):
    """`scipy.integrate.odeint`-compatible solve. ``backend="torch"``
    (or ``"jax"``, the reference's name for its device solver) switches
    to `solve` on ``device`` with the rtol/atol taken from
    ``odeint_kwargs`` (by default 1.49012e-8: dopri5)."""
    p0 = _validate_p0(p0, size_a, cl_k)
    dy_dt = get_dy_dt(tag=tag, size_a=size_a, cl_k=cl_k, debug=debug,
                      device=device)
    if backend in _DEVICE_BACKENDS:
        kwargs = dict(odeint_kwargs)
        return solve(
            _device_rhs(dy_dt), p0, ts,
            rtol=kwargs.pop("rtol", 1.49012e-8),
            atol=kwargs.pop("atol", 1.49012e-8),
            chunk_size=kwargs.pop("chunk_size", None),
            progress=kwargs.pop("progress", False),
            device=device,
        )
    if backend != "scipy":
        raise ValueError(f"Unknown backend {backend!r}")
    import scipy.integrate

    return scipy.integrate.odeint(dy_dt, p0, ts, **dict(odeint_kwargs))


def ode_integrate_ivp(*, tag, size_a, cl_k, p0, ts,
                      ivp_kwargs=types.MappingProxyType({}),
                      debug=False, backend="scipy", device=None):
    """`solve_ivp`-compatible solve reshaped to odeint layout;
    ``backend="torch"`` (or ``"jax"``, the reference's name for its
    device solver) takes ``method``, ``chunk_size``, ``progress``,
    ``checkpoint_path``, ``project`` and ``return_info`` from
    ``ivp_kwargs``."""
    p0 = _validate_p0(p0, size_a, cl_k)
    dy_dt = get_dy_dt(tag=tag, size_a=size_a, cl_k=cl_k, debug=debug,
                      device=device)
    kwargs = dict(ivp_kwargs)
    if backend in _DEVICE_BACKENDS:
        return solve(
            _device_rhs(dy_dt), p0, ts,
            rtol=kwargs.pop("rtol", 1e-3),
            atol=kwargs.pop("atol", 1e-6),
            method=kwargs.pop("method", None),
            chunk_size=kwargs.pop("chunk_size", None),
            progress=kwargs.pop("progress", False),
            checkpoint_path=kwargs.pop("checkpoint_path", None),
            project=kwargs.pop("project", None),
            return_info=kwargs.pop("return_info", False),
            device=device,
        )
    if backend != "scipy":
        raise ValueError(f"Unknown backend {backend!r}")
    import scipy.integrate

    return scipy.integrate.solve_ivp(
        lambda t, y: dy_dt(y, t), (ts[0], ts[-1]), p0, t_eval=ts, **kwargs
    ).y.T


def _device_rhs(dy_dt):
    fn = dy_dt.device_fn

    def rhs(y, t, out=None):
        del t
        return fn(y, out)

    rhs.takes_out = True
    return rhs


def _run_validation(device=None):
    """The reference's import-time golden-value smoke test, exposed for
    test suites and `chip_smoke.py`: must match EXACTLY."""
    fn_dy_dt = get_dy_dt(
        tag="__canary_problem_radioactive_decay", size_a=2, cl_k=3,
        device=device,
    )
    observed = fn_dy_dt(np.full([8], 0.125), 0.0).tolist()
    expected = [0.375, 0.125, 0.125, -0.125, 0.125, -0.125, -0.125, -0.375]
    if expected != observed:
        raise RuntimeError(
            "Load-time validation problem failed to produce the expected "
            f"result: {observed}"
        )
    return observed

