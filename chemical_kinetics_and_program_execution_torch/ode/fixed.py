"""Fixed-grid Runge-Kutta solve, run forward.

Counterpart of the JAX package's `ode/fixed.py` (`odeint_fixed`,
`_odeint_fixed_impl` :74): Dormand-Prince 5's tableau on a fixed grid of
``n_sub`` substeps a sample interval, the host driving the substeps and
the stages ([7, n] float64, one tensor) on the device. Its vector
arithmetic is K6's second table as it stands (`ode/dop853.py:TABLEAU`
rows 18-24: A's rows 1-6 and B5), no new kernel: stage 0 is f(y, t),
stage j the RHS at K6's ``y + h sum_i A[j][i] k_i``, y_new K6's ``y + h
sum_j B5[j] k_j`` (the nonzero terms in stage order, where the JAX
package sums a zero-padded row: the same values to rounding).

What the JAX package does with it besides, reverse-mode gradients of a
whole solve (`grad_observable`, and `jax.grad` through `odeint_fixed`
with checkpointed intervals), is not ported: `grad_observable` and a
backward pass through `odeint_fixed` raise NotImplementedError naming
ROADMAP Queue 1, "Derivative-based solvers and instruments: reverse
mode".
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.dense import REVERSE_MODE
from ..utils import config
from . import dop853
from .dop853 import DP5_B5_ROW, DP5_C, DP5_ROWS, DP5_STAGES, rows_tensor


def _solve(fn, y0: torch.Tensor, ts: np.ndarray, n_sub: int):
    n = y0.numel()
    K = rows_tensor(DP5_STAGES, n, y0.device)
    y = y0.clone()
    y_stage = torch.empty_like(y)
    y_new = torch.empty_like(y)
    out = [y0.clone()]
    for t_lo, t_hi in zip(ts[:-1], ts[1:]):
        h = (float(t_hi) - float(t_lo)) / n_sub
        for i in range(n_sub):
            t = float(t_lo) + i * h
            K[0].copy_(fn(y, t))
            for j in range(1, DP5_STAGES):
                dop853.stage(y, K, h, DP5_ROWS[j], y_stage)
                K[j].copy_(fn(y_stage, t + DP5_C[j] * h))
            dop853.stage(y, K, h, DP5_B5_ROW, y_new)
            y, y_new = y_new, y
        out.append(y.clone())
    return torch.stack(out)


class _FixedSolve(torch.autograd.Function):
    """The forward solve; its backward is the unported reverse mode."""

    @staticmethod
    def forward(y0, fn, ts, n_sub):
        return _solve(fn, y0, ts, n_sub)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"backward through odeint_fixed is not ported yet "
            f"({REVERSE_MODE})")


def odeint_fixed(fn, y0, ts, n_sub: int = 8, args=None, *, device=None):
    """Integrates ``dy/dt = fn(y, t)`` (``fn(y, t, args)`` when ``args``
    is given) on a fixed grid: ``n_sub`` RK5 substeps a sample interval
    of the increasing times ``ts`` [T]. ``y0`` is moved to ``device``
    (``cuda`` unless named; a tensor's own device when it is one) as
    float64. Returns the float64 tensor ``[T, n]`` with ``ys[0] == y0``;
    a backward pass through it raises NotImplementedError."""
    if not isinstance(y0, torch.Tensor):
        y0 = torch.as_tensor(np.asarray(y0, dtype=np.float64),
                             device=config.get_device(device))
    y0 = y0.to(torch.float64).reshape(-1)
    ts = np.asarray(ts.cpu() if isinstance(ts, torch.Tensor) else ts,
                    dtype=np.float64)
    f = fn if args is None else (lambda y, t: fn(y, t, args))
    return _FixedSolve.apply(y0, f, ts, int(n_sub))


def grad_observable(fn, p0, ts, observable, n_sub: int = 8):
    """The JAX package's ``(value, d value / d p0)`` of an observable of
    the final state: reverse mode through a fixed-grid solve, not ported
    yet."""
    raise NotImplementedError(
        f"grad_observable is not ported yet ({REVERSE_MODE})")
