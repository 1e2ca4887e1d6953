"""Host-stepped adaptive Dormand-Prince 5(4) (dopri5).

Counterpart of the JAX package's `ode/dopri5.py:48 odeint_dopri5`, built
as the port's DOP853 is (`ode/dop853.py`): the host drives the steps,
the state and the 7 stages ([7, n] float64, one tensor) stay on the
device, and the host reads one scalar a step (the error sum). Its vector
arithmetic is kernel K6 on its second table (`ode/dop853.py:TABLEAU`
rows 18-25: A's rows 1-6, B5 and the error row B5 - B4; the Euler row 0
for the initial step), with stage 6 the one that trades rows with stage
0 after an accepted step (first same as last).

What it keeps of the JAX stepper, so that it walks the same steps:

- the initial step (error exponent 1/5);
- steps clamped to land on each sample time, reached when the step
  covers 1 - 1e-14 of the way there;
- the FSAL stage: ``fn`` at the stage-6 input ``y + h sum_j A[6][j]
  k_j`` (A's row 6), while ``y_new`` is formed apart from row B5
  (``y + h sum_j B5[j] k_j``), as the JAX package forms both;
- the error ``sqrt(mean((h sum_j E[j] k_j / scale)^2))``, scale = atol
  + rtol max(|y|, |y_new|), floored at 1e-30 (the sum one K6 launch, the
  mean and root on the host, as `_rms_norm`);
- the PI controller: factor = clip(0.9 err^(-0.7/5) err_prev^(0.4/5),
  0.2, 10) on an accept, dt clip(0.9 err^(-1/5), 0.2, 1) on a reject,
  ``err_prev`` (from 1.0) carried only on an accept;
- the ``max_steps`` cap and the counts in ``info``.
"""

from __future__ import annotations

import math

import torch

from . import dop853
from .dop853 import (
    _ERR_H,
    DP5_B5_ROW,
    DP5_C,
    DP5_ERR_ROW,
    DP5_ROWS,
    DP5_STAGES,
    _Stepper,
)

_ORDER = 5.0
FSAL = DP5_STAGES - 1  # stage 6, the next step's stage 0


def odeint_dopri5(fn, y0: torch.Tensor, ts, tols,
                  max_steps: int = 1_000_000, *, sample_fn=None):
    """Integrates ``dy/dt = fn(y, t)`` from ``y0`` (a float64 vector on
    its device) sampling at times ``ts`` (``ts[0]`` is the start); the
    contract of `dop853.odeint_dop853_dense` (``takes_out``,
    ``sample_fn``, the returned rows and `SolveStats`)."""
    rtol, atol = (float(x) for x in tols)
    st = _Stepper(fn, y0, ts, DP5_STAGES, FSAL, sample_fn)
    ts, n, stats = st.ts, st.n, st.stats
    n_out = len(ts)
    dt = st.initial_step(rtol, atol, _ORDER)
    y_stage = torch.empty_like(st.y)
    t, i_out, err_prev = float(ts[0]), 1, 1.0
    while (i_out < n_out
           and stats.num_accepted + stats.num_rejected < max_steps):
        t_target = float(ts[min(i_out, n_out - 1)])
        dt_eff = min(dt, t_target - t)
        hits_target = dt_eff >= (t_target - t) * (1 - 1e-14)
        for i in range(1, DP5_STAGES):
            st.stage(dt_eff, DP5_ROWS[i], y_stage)
            st.rhs(y_stage, t + DP5_C[i] * dt_eff, i)
        st.stage(dt_eff, DP5_B5_ROW, st.y_new)
        s = dop853.norms(_ERR_H, st.y, rtol, atol, y_new=st.y_new, ks=st.K,
                         swap=st.swap, scratch=st.scratch, h=dt_eff,
                         fsal=FSAL, rows=(DP5_ERR_ROW,)).tolist()[0]
        err = max(math.sqrt(s / n), 1e-30)
        accept = err <= 1.0
        factor = 0.9 * err ** (-0.7 / _ORDER) * err_prev ** (0.4 / _ORDER)
        factor = min(max(factor, 0.2), 10.0)
        dt_next = (dt_eff * factor if accept else
                   dt_eff * min(max(0.9 * err ** (-1.0 / _ORDER), 0.2), 1.0))
        if accept:
            t = t_target if hits_target else t + dt_eff
            if hits_target:
                st.out_rows.append(st.sample_fn(st.y_new[None]).clone())
                i_out += 1
                stats.num_sampled += 1
            st.accept()
            err_prev = err
        else:
            stats.num_rejected += 1
        dt = dt_next
    return st.finish(i_out)
