"""Fixed-grid Runge-Kutta solve, forward and reverse.

Counterpart of the JAX package's `ode/fixed.py` (`odeint_fixed`,
`_odeint_fixed_impl` :74, `grad_observable` :121): Dormand-Prince 5's
tableau on a fixed grid of ``n_sub`` substeps a sample interval, the
host driving the substeps and the stages ([7, n] float64, one tensor) on
the device. Its vector arithmetic is K6's second table as it stands
(`ode/dop853.py:TABLEAU` rows 18-24: A's rows 1-6 and B5), no new
kernel: stage 0 is f(y, t), stage j the RHS at K6's ``y + h sum_i
A[j][i] k_i``, y_new K6's ``y + h sum_j B5[j] k_j`` (the nonzero terms
in stage order, where the JAX package sums a zero-padded row: the same
values to rounding).

The backward (autograd through `odeint_fixed`, and `grad_observable`)
is the discrete adjoint of those substeps, as JAX's reverse mode of its
scan forms it, with JAX's `jax.checkpoint` on each interval: walking the
intervals from the last, it recomputes the interval's substeps from the
sample at its start, keeping that interval's stage inputs Y_l and the
graphs of their RHS calls, then walks the substeps back. A substep's
stage cotangents are K6's fourth table (`dop853.DP5_ADJ_ROWS`): from
stage 5 down to 0, ``k_bar_l = h (B5_l y_bar + sum_{m > l} A_ml z_m)``
and z_l = k_bar_l^T J(Y_l) (the RHS's v^T J by `torch.autograd.grad`:
K30 for the port's dense closures), each stage's cotangent in ``args``
summed; then ``y_bar += sum_l z_l`` (`dop853.DP5_ADJ_SUM`). Stage 6's
cotangent is 0 (B5_6 = 0 and no stage reads k_6).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import config
from ..utils.autodiff import first_order_only, flatten_args
from . import dop853
from .dop853 import (
    DP5_ADJ_ROWS,
    DP5_ADJ_SUM,
    DP5_ADJ_YBAR,
    DP5_B5_ROW,
    DP5_C,
    DP5_ROWS,
    DP5_STAGES,
    rows_tensor,
)


def _substep(fn, y, t, h, K, y_stage, y_new, keep=None):
    """One DP5 substep from y into ``y_new``, its stages in ``K``; with
    ``keep`` (a list), each stage l < 6 evaluated at a leaf copy of Y_l
    under autograd, (Y_l, k_l) appended."""
    for j in range(DP5_STAGES):
        if j == 0:
            y_j = y
        else:
            dop853.stage(y, K, h, DP5_ROWS[j], y_stage)
            y_j = y_stage
        t_j = t + DP5_C[j] * h
        if keep is not None and j < DP5_STAGES - 1:
            leaf = y_j.detach().clone().requires_grad_(True)
            k = fn(leaf, t_j)
            keep.append((leaf, k))
            K[j].copy_(k.detach())
        else:
            K[j].copy_(fn(y_j, t_j).detach())
    dop853.stage(y, K, h, DP5_B5_ROW, y_new)
    return y_new


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
            _substep(fn, y, float(t_lo) + i * h, h, K, y_stage, y_new)
            y, y_new = y_new, y
        out.append(y.clone())
    return torch.stack(out)


def _adjoint(fn, ys, g_ys, ts, n_sub, leaves):
    """The cotangents of y0 and of each leaf in ``leaves`` (the args'
    tensors that need one; ``fn`` reads them) from those of the samples
    ``g_ys`` [T, n]."""
    n = ys.shape[1]
    dev = ys.device
    K = rows_tensor(DP5_STAGES, n, dev)
    adj = rows_tensor(DP5_STAGES + 1, n, dev)
    y_stage = torch.empty(n, dtype=torch.float64, device=dev)
    y_new = torch.empty_like(y_stage)
    zero = torch.zeros_like(y_stage)
    k_bar = torch.empty_like(y_stage)
    y_bar = g_ys[-1].clone()
    arg_bar = [torch.zeros_like(x) for x in leaves]
    for iv in range(len(ts) - 2, -1, -1):
        t_lo = float(ts[iv])
        h = (float(ts[iv + 1]) - t_lo) / n_sub
        kept = []
        y = ys[iv].detach().clone()
        with torch.enable_grad():
            for i in range(n_sub):
                keep = []
                y = _substep(fn, y, t_lo + i * h, h, K, y_stage, y_new,
                             keep).clone()
                kept.append(keep)
        for keep in reversed(kept):
            adj[DP5_ADJ_YBAR].copy_(y_bar)
            for lo in range(DP5_STAGES - 2, -1, -1):
                dop853.stage(zero, adj, h, DP5_ADJ_ROWS[lo], k_bar)
                leaf, k = keep[lo]
                grads = (torch.autograd.grad(k, [leaf] + leaves, k_bar,
                                             allow_unused=True)
                         if k.requires_grad else [None] * (1 + len(leaves)))
                adj[lo].copy_(grads[0] if grads[0] is not None else zero)
                for q, g in enumerate(grads[1:]):
                    if g is not None:
                        arg_bar[q] = arg_bar[q] + g
            y_bar = dop853.stage(y_bar, adj, 1.0, DP5_ADJ_SUM,
                                 torch.empty_like(y_bar))
        y_bar = y_bar + g_ys[iv]
    return y_bar, arg_bar


class _FixedSolve(torch.autograd.Function):
    """The solve (``apply(y0, fn, ts, n_sub, rebuild, *arg_tensors)``,
    ``fn(y, t, args)``), and its discrete adjoint as backward."""

    @staticmethod
    def forward(y0, fn, ts, n_sub, rebuild, *arg_tensors):
        args = rebuild([x.detach() for x in arg_tensors])
        return _solve(lambda y, t: fn(y, t, args), y0, ts, n_sub)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, fn, ts, n_sub, rebuild, *arg_tensors = inputs
        ctx.save_for_backward(output, *arg_tensors)
        ctx.fn, ctx.ts, ctx.n_sub, ctx.rebuild = fn, ts, n_sub, rebuild

    @staticmethod
    def backward(ctx, g_ys):
        ys, *arg_tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[5:]
        leaves = [x.detach().requires_grad_(True) if want else x.detach()
                  for x, want in zip(arg_tensors, need)]
        args = ctx.rebuild(leaves)
        fn = ctx.fn
        y_bar, arg_bar = _adjoint(lambda y, t: fn(y, t, args), ys,
                                  g_ys.detach(), ctx.ts, ctx.n_sub,
                                  [x for x, want in zip(leaves, need)
                                   if want])
        # Under create_graph the cotangents carry no graph of their own
        # (K6's rows and graph-free autograd calls formed them): a second
        # derivative through them raises.
        what, anchors = "odeint_fixed", (ys, g_ys, *arg_tensors)
        it = iter(arg_bar)
        return ((first_order_only(y_bar, what, *anchors)
                 if ctx.needs_input_grad[0] else None, None, None, None,
                 None)
                + tuple(first_order_only(next(it), what, *anchors)
                        if want else None for want in need))


def odeint_fixed(fn, y0, ts, n_sub: int = 8, args=None, *, device=None):
    """Integrates ``dy/dt = fn(y, t)`` (``fn(y, t, args)`` when ``args``
    is given) on a fixed grid: ``n_sub`` RK5 substeps a sample interval
    of the increasing times ``ts`` [T]. ``y0`` is moved to ``device``
    (``cuda`` unless named; a tensor's own device when it is one) as
    float64. Returns the float64 tensor ``[T, n]`` with ``ys[0] == y0``.

    Differentiable by autograd in ``y0`` and in ``args`` (a tensor, or a
    tuple, list or dict of tensors: the channel for rate parameters, as
    in the JAX package), by the discrete adjoint of the substeps (module
    docstring), which needs ``fn``'s v^T J by autograd. Tensors that
    ``fn`` captures from its closure receive no gradient: pass them in
    ``args``."""
    if not isinstance(y0, torch.Tensor):
        y0 = torch.as_tensor(np.asarray(y0, dtype=np.float64),
                             device=config.get_device(device))
    y0 = y0.to(torch.float64).reshape(-1)
    ts = np.asarray(ts.detach().cpu() if isinstance(ts, torch.Tensor)
                    else ts, dtype=np.float64)
    tensors, rebuild = flatten_args(args)
    f = (lambda y, t, _a: fn(y, t)) if args is None else fn
    return _FixedSolve.apply(y0, f, ts, int(n_sub), rebuild, *tensors)


def grad_observable(fn, p0, ts, observable, n_sub: int = 8, *,
                    device=None):
    """``(value, d value / d p0)`` of a scalar ``observable`` of the final
    state of `odeint_fixed` (``fn(y, t)``): the solve, then its adjoint,
    as the JAX package's (:121). ``p0`` is moved to ``device`` (``cuda``
    unless named; a tensor's own device when it is one)."""
    if not isinstance(p0, torch.Tensor):
        p0 = torch.as_tensor(np.asarray(p0, dtype=np.float64),
                             device=config.get_device(device))
    p0 = p0.detach().to(torch.float64).reshape(-1).requires_grad_(True)
    with torch.enable_grad():
        value = observable(odeint_fixed(fn, p0, ts, n_sub)[-1])
        (grad,) = torch.autograd.grad(value, p0)
    return value.detach(), grad
