"""Host-stepped stiff stepper: Kvaerno 3(2) ESDIRK with Newton-Krylov
stages.

Counterpart of the JAX package's `ode/kvaerno3.py` (`_newton_stage` :54,
`odeint_kvaerno3` :99), built as the port's explicit steppers are
(`ode/dop853.py`): the host drives the steps and the Newton iterations,
the state and the stages ([4, n] float64, one tensor; stage 3, the
stiffly accurate last stage, trades rows with stage 0 after an accepted
step) stay on the device, and the host reads one scalar a Newton
iteration (the step's scaled norm), one a GMRES Arnoldi step and restart
(`ode/krylov.py`) and one a step (the embedded error).

Each implicit stage solves ``z = g + h gamma f(z, t_s)``, ``g = y + h
sum_j a_sj k_j``, by Newton iterations from the predictor ``g + h gamma
k_{s-1}``, whose linear systems ``(I - h gamma J) dz = -phi(z)`` GMRES
solves (tol 1e-4, restart 20, one restart: 22 matvecs) on J.v products
by forward mode (`krylov.jvp`, a dual of z along v): kernel K25 for the
dense RHS (`engine/dense.py:make_dense_dy_dt`), torch's own forward mode
for an RHS written in torch ops. The vector arithmetic is K6's third
table (`ode/dop853.py`, rows 26-30): the stage bases and predictors
(`stage`), the residual phi (`resid`), the Newton update z += dz fused
with its scaled norm and the embedded error (`norms` modes ``_NEWTON``
and ``_ERR_DIFF``); the host takes the square roots of the means, as
`_rms_norm` does.

What it keeps of the JAX stepper: the initial step, steps clamped to the
sample times (reached at 1 - 1e-14 of the way), the Newton tolerance
max(10 eps / rtol, min(0.03, sqrt(rtol))), at most 8 iterations, the
divergence guard (a non-finite step norm, or one above 1 past the third
iteration), err = 2 on a Newton failure, the I controller clip(0.9
err^(-1/3), 0.2, 10), a 4x cut on a Newton failure, dt floored at 1e-14
of the span, FSAL. A stage whose Newton iteration failed ends the step
(the JAX program forms the later stages and throws them away): the same
steps, fewer RHS calls.
"""

from __future__ import annotations

import math

import torch

from . import dop853
from .dop853 import (
    _ERR_DIFF,
    _NEWTON,
    _RMS,
    KV_C,
    KV_G_ROWS,
    KV_GAMMA,
    KV_PRED_ROWS,
    KV_STAGES,
    _Stepper,
)
from .krylov import gmres, jvp

_ORDER = 3.0
FSAL = KV_STAGES - 1  # stage 3 (k4 at t + h), the next step's stage 0
MAX_NEWTON = 8
GMRES_RESTART = 20


def _newton_stage(st, s: int, t_s: float, h: float, rtol: float,
                  atol: float, newton_tol: float, g, z, r):
    """Stage ``s`` (1-3) of the step from ``st.y`` of size ``h``: its base
    into ``g``, the Newton iterate into ``z``, its residual into ``r``,
    f(z) into stage s's row. Returns whether Newton converged (the JAX
    package's `ode/kvaerno3.py:_newton_stage`)."""
    stats, n = st.stats, st.n
    hg = h * KV_GAMMA
    st.stage(h, KV_G_ROWS[s], g)
    dop853.stage(g, st.K, h, KV_PRED_ROWS[s], z, st.swap, st.fsal)
    f, fn = st.K[st.rows[s]], st.fn

    def matvec(v):
        return v - hg * jvp(lambda yy: fn(yy, t_s), z, v)

    done = fail = False
    it = 0
    while not done and not fail and it < MAX_NEWTON:
        st.rhs(z, t_s, s)
        dop853.resid(z, g, f, hg, r)
        dz, matvecs = gmres(matvec, -r, tol=1e-4, atol=0.0,
                            restart=GMRES_RESTART, maxiter=1)
        stats.num_jvp += matvecs
        step = dop853.norms(_NEWTON, st.y, rtol, atol, f0=dz, f1=z,
                            scratch=st.scratch).tolist()[0]
        step_norm = math.sqrt(step / n)
        done = step_norm < newton_tol
        fail = not math.isfinite(step_norm) or (it > 2 and step_norm > 1.0)
        it += 1
    stats.num_newton += it
    st.rhs(z, t_s, s)
    return done and not fail


def odeint_kvaerno3(fn, y0: torch.Tensor, ts, tols,
                    max_steps: int = 1_000_000, *, sample_fn=None):
    """Integrates stiff ``dy/dt = fn(y, t)`` from ``y0`` (a float64 vector
    on its device) sampling at times ``ts`` (``ts[0]`` is the start):
    the contract of `dop853.odeint_dop853_dense` (``takes_out``,
    ``sample_fn``, the returned rows and `SolveStats`, here with the
    Newton iterations and J.v products counted). ``fn`` must take
    torch's forward mode (a forward-AD dual): the port's dense RHS does
    (K25), an RHS in torch ops does natively."""
    rtol, atol = (float(x) for x in tols)
    st = _Stepper(fn, y0, ts, KV_STAGES, FSAL, sample_fn)
    ts, n, stats = st.ts, st.n, st.stats
    n_out = len(ts)
    t0 = float(ts[0])
    span = float(ts[-1]) - t0
    eps = torch.finfo(torch.float64).eps
    newton_tol = max(10 * eps / rtol, min(0.03, rtol**0.5))
    st.rhs(st.y, t0, 0)
    d0, d1 = (math.sqrt(v / n) for v in dop853.norms(
        _RMS, st.y, rtol, atol, f0=st.K[st.rows[0]],
        scratch=st.scratch).tolist())
    h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / d1
    dt = min(max(h0, 1e-14 * span), span)
    g, r = torch.empty_like(st.y), torch.empty_like(st.y)
    z2, z3 = torch.empty_like(st.y), torch.empty_like(st.y)
    t, i_out = t0, 1
    while (i_out < n_out
           and stats.num_accepted + stats.num_rejected < max_steps):
        t_target = float(ts[min(i_out, n_out - 1)])
        dt_eff = min(dt, t_target - t)
        hits_target = dt_eff >= (t_target - t) * (1 - 1e-14)
        newton_ok = True
        for s, z in ((1, z2), (2, z3), (3, st.y_new)):
            newton_ok = _newton_stage(st, s, t + KV_C[s] * dt_eff, dt_eff,
                                      rtol, atol, newton_tol, g, z, r)
            if not newton_ok:
                break
        if newton_ok:
            e = dop853.norms(_ERR_DIFF, st.y, rtol, atol, y_new=st.y_new,
                             f0=z3, scratch=st.scratch).tolist()[0]
            err = max(math.sqrt(e / n), 1e-30)
        else:
            err = 2.0
        accept = newton_ok and err <= 1.0
        factor = min(max(0.9 * err ** (-1.0 / _ORDER), 0.2), 10.0)
        dt_next = dt_eff * factor if newton_ok else dt_eff * 0.25
        dt_next = max(dt_next, 1e-14 * span)
        if accept:
            t = t_target if hits_target else t + dt_eff
            if hits_target:
                st.out_rows.append(st.sample_fn(st.y_new[None]).clone())
                i_out += 1
                stats.num_sampled += 1
            st.accept()
        else:
            stats.num_rejected += 1
        dt = dt_next
    return st.finish(i_out)
