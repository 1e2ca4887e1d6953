"""Mass-action autocatalysis kinetics.

Counterpart of the JAX package's `models/autocatalysis.py`: two
autocatalytic dimer species A and B competing for a monomer M in a flow
reactor. Parameters pack as ``[c_form_a, c_auto_a, c_stab_a, c_form_b,
c_auto_b, c_stab_b, c_add, c_remove]``; rows of a sweep as ``[ca0, cb0,
cm0] ++ params``.

- `dy_dt` is the rate law, plain torch on ``[..., 3]``;
- `integrate_sweep` solves every row at once with adaptive dopri5, each
  member with its own step control, clamped to every sample time: kernel
  K29 (`dopri5_batch`, `csrc/dopri5_batch.cu`, rule
  `csrc/dopri5_rule.cuh`, a member a thread) on the card,
  `_solve_batch_plain` (a batched stepper with per-member masks, the
  vmapped `while_loop` written out) on the CPU; the Dormand-Prince
  coefficients are K6's second table (`ode/dop853.py:TABLEAU`);
- `find_equilibrium` is gradient descent on ||dy/dt||^2 by torch
  autograd, each step's accept test a `torch.where` on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda
from ..ode import dop853
from ..utils.config import get_device

RTOL = ATOL = 1.49012e-8  # the JAX package's `_solve_batch`
_ORDER = 5.0
_STAGES = dop853.DP5_STAGES


def dy_dt(y: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Rate law for [A-dimer, B-dimer, monomer] (``y`` [..., 3],
    ``params`` [..., 8]), in the JAX package's expression order."""
    (c_form_a, c_auto_a, c_stab_a,
     c_form_b, c_auto_b, c_stab_b,
     c_add, c_remove) = params.unbind(-1)
    c_sdiss_a = c_form_a / c_stab_a
    c_adiss_a = c_auto_a / c_stab_a
    c_sdiss_b = c_form_b / c_stab_b
    c_adiss_b = c_auto_b / c_stab_b
    ca, cb, cm = y.unbind(-1)
    form_a = c_form_a * cm * cm
    form_b = c_form_b * cm * cm
    auto_a = c_auto_a * ca * cm * cm
    auto_b = c_auto_b * cb * cm * cm
    sdiss_a = c_sdiss_a * ca
    sdiss_b = c_sdiss_b * cb
    adiss_a = c_adiss_a * ca * ca
    adiss_b = c_adiss_b * cb * cb
    return torch.stack([
        form_a + auto_a - sdiss_a - adiss_a - c_remove * ca,
        form_b + auto_b - sdiss_b - adiss_b - c_remove * cb,
        2 * (sdiss_a + sdiss_b) + 2 * (adiss_a + adiss_b)
        - 2 * (form_a + form_b) - 2 * (auto_a + auto_b)
        - c_remove * cm + c_add,
    ], dim=-1)


def tableau_rows() -> list:
    """The 8 rows K29 sums, as (stage, coefficient) terms in stage order:
    A's rows 1-6, B5 and the error row B5 - B4 of K6's second table
    (`dop853.TABLEAU` rows `DP5_ROWS[1:]`, `DP5_B5_ROW`,
    `DP5_ERR_ROW`)."""
    which = list(dop853.DP5_ROWS[1:]) + [dop853.DP5_B5_ROW,
                                         dop853.DP5_ERR_ROW]
    return [list(dop853.TABLEAU[w]) for w in which]


def tableau_arrays():
    """`tableau_rows` as K29 takes them: float64 coefficients [8, 7] and
    int32 flags [8, 7] (1 where the row has a term)."""
    rows = tableau_rows()
    coef = np.zeros((len(rows), _STAGES))
    has = np.zeros((len(rows), _STAGES), dtype=np.int32)
    for i, terms in enumerate(rows):
        for j, c in terms:
            coef[i, j], has[i, j] = c, 1
    return coef, has


def _comb(k, terms):
    acc = None
    for j, c in terms:
        term = c * k[j]
        acc = term if acc is None else acc + term
    return acc


def _rms3(x):
    """sqrt(mean(x^2)) over the last axis of 3, summed in order. The
    mean divides by a tensor: PyTorch on the card turns a division by a
    Python number into a product with its reciprocal, which rounds
    apart from the quotient."""
    s = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]
    return torch.sqrt(s / s.new_full((), 3.0))


def _solve_batch_plain(y0: torch.Tensor, params: torch.Tensor,
                       ts: torch.Tensor, max_steps: int, rtol: float = RTOL,
                       atol: float = ATOL):
    """Plain version of `dopri5_batch`: every member's dopri5 solve (see
    `csrc/dopri5_rule.cuh`) as one batched stepper, each member's steps
    masked by its own state, until every member has written its samples
    or spent ``max_steps`` steps; a finished member's state stays, as in
    the vmapped `while_loop`. Returns (ys [B, T, 3] float64, zeros where
    no sample was reached; accepted and rejected steps [B] int32)."""
    _solve_batch_plain.calls += 1
    rows = tableau_rows()
    B, n_out = y0.shape[0], ts.shape[0]
    dev = y0.device
    idx = torch.arange(B, device=dev)
    out = torch.zeros((B, n_out, 3), dtype=torch.float64, device=dev)
    out[:, 0] = y0
    y, p = y0.clone(), params
    f = dy_dt(y, p)
    scale = atol + y.abs() * rtol
    d0, d1 = _rms3(y / scale), _rms3(f / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                     torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    f1 = dy_dt(y + h0[:, None] * f, p)
    d2 = _rms3((f1 - f) / scale) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15),
                     torch.clamp_min(h0 * 1e-3, 1e-6),
                     (0.01 / torch.maximum(d1, d2)) ** (1.0 / _ORDER))
    t0 = float(ts[0])
    span = float(ts[-1]) - t0
    dt = torch.clamp(torch.minimum(100 * h0, h1), 1e-14 * span, span)
    t = torch.full_like(dt, t0)
    err_prev = torch.ones_like(dt)
    i_out = torch.ones(B, dtype=torch.int64, device=dev)
    n_acc = torch.zeros(B, dtype=torch.int64, device=dev)
    n_rej = torch.zeros_like(n_acc)
    active = (i_out < n_out) & (n_acc + n_rej < max_steps)
    while bool(active.any()):
        t_target = ts[torch.clamp_max(i_out, n_out - 1)]
        dt_eff = torch.minimum(dt, t_target - t)
        hits = dt_eff >= (t_target - t) * (1 - 1e-14)
        h = dt_eff[:, None]
        k = [f]
        for i in range(1, _STAGES):
            k.append(dy_dt(y + h * _comb(k, rows[i - 1]), p))
        y_new = y + h * _comb(k, rows[6])
        scale = atol + torch.maximum(y.abs(), y_new.abs()) * rtol
        err = torch.clamp_min(_rms3(h * _comb(k, rows[7]) / scale), 1e-30)
        accept = err <= 1.0
        factor = torch.clamp(0.9 * err ** (-0.7 / _ORDER)
                             * err_prev ** (0.4 / _ORDER), 0.2, 10.0)
        dt_next = torch.where(
            accept, dt_eff * factor,
            dt_eff * torch.clamp(0.9 * err ** (-1.0 / _ORDER), 0.2, 1.0))
        acc = active & accept
        wrote = acc & hits
        out[idx[wrote], i_out[wrote]] = y_new[wrote]
        t = torch.where(acc, torch.where(hits, t_target, t + dt_eff), t)
        y = torch.where(acc[:, None], y_new, y)
        f = torch.where(acc[:, None], k[-1], f)
        err_prev = torch.where(acc, err, err_prev)
        i_out = i_out + wrote
        n_acc = n_acc + acc
        n_rej = n_rej + (active & ~accept)
        dt = torch.where(active, dt_next, dt)
        active = (i_out < n_out) & (n_acc + n_rej < max_steps)
    return out, n_acc.to(torch.int32), n_rej.to(torch.int32)


_solve_batch_plain.calls = 0


def dopri5_batch(y0: torch.Tensor, params: torch.Tensor, ts: torch.Tensor,
                 max_steps: int, rtol: float = RTOL, atol: float = ATOL):
    """K29: every member's dopri5 solve of the rate law, ``y0`` [B, 3],
    ``params`` [B, 8], sample times ``ts`` [T] (float64, one device);
    returns as `_solve_batch_plain`. One launch, a member a thread, on
    the card; the plain version on the CPU."""
    if not cuda.on_card(y0, "dopri5_batch"):
        return _solve_batch_plain(y0, params, ts, max_steps, rtol, atol)
    B, n_out = y0.shape[0], ts.shape[0]
    for x, shape in ((y0, (B, 3)), (params, (B, 8)), (ts, (n_out,))):
        if (x.dtype != torch.float64 or tuple(x.shape) != shape
                or not x.is_contiguous() or x.device != y0.device):
            raise TypeError(f"dopri5_batch: expected a contiguous float64 "
                            f"{shape} tensor on {y0.device}")
    ys = torch.zeros((B, n_out, 3), dtype=torch.float64, device=y0.device)
    n_acc = torch.empty(B, dtype=torch.int32, device=y0.device)
    n_rej = torch.empty_like(n_acc)
    coef, has = tableau_arrays()
    lib = cuda.load()
    with torch.cuda.device(y0.device):
        rc = lib.ckpe_dopri5_batch(
            coef.ctypes.data, has.ctypes.data, B, y0.data_ptr(),
            params.data_ptr(), ts.data_ptr(), n_out, float(rtol),
            float(atol), int(max_steps), ys.data_ptr(), n_acc.data_ptr(),
            n_rej.data_ptr(), cuda.stream(y0))
    cuda.check(rc, "dopri5_batch", lib)
    dopri5_batch.launches += 1
    return ys, n_acc, n_rej


dopri5_batch.launches = 0


def integrate_sweep(y0_and_params, ts, max_steps: int = 200_000,
                    device=None):
    """Integrates a batch of ``[ca0, cb0, cm0] ++ params[8]`` rows at
    rtol = atol = 1.49012e-8, sampling at ``ts`` (``ts[0]`` the start).
    Returns (ys [B, T, 3] float64 on the device, {"num_accepted",
    "num_rejected": [B] int32}); a member past ``max_steps`` steps keeps
    zeros at the samples it did not reach, as in the JAX package."""
    dev = get_device(device)
    arr = torch.tensor(np.asarray(y0_and_params, dtype=np.float64),
                       device=dev)
    ts = torch.tensor(np.asarray(ts, dtype=np.float64), device=dev)
    ys, n_acc, n_rej = dopri5_batch(arr[:, :3].contiguous(),
                                    arr[:, 3:].contiguous(), ts, max_steps)
    return ys, {"num_accepted": n_acc, "num_rejected": n_rej}


def find_equilibrium(y0, params, steps: int = 2000, lr: float = 1e-3,
                     device=None):
    """Minimises ||dy/dt||^2 from ``y0`` by ``steps`` steps of gradient
    descent (torch autograd), a step kept only when it lowers the loss,
    the rate times 1.2 after a kept step and 0.5 after a dropped one; the
    test and both updates are `torch.where` on the device, no host read
    a step. Returns (y_eq as a numpy array, residual)."""
    dev = get_device(device)
    p = torch.tensor(np.asarray(params, dtype=np.float64), device=dev)
    y = torch.tensor(np.asarray(y0, dtype=np.float64), device=dev)
    rate = torch.tensor(lr, dtype=torch.float64, device=dev)

    def loss(v):
        d = dy_dt(v, p)
        return (d * d).sum(-1)

    for _ in range(steps):
        v = y.detach().requires_grad_(True)
        cur = loss(v)
        (g,) = torch.autograd.grad(cur, v)
        with torch.no_grad():
            y_new = y - rate * g
            better = loss(y_new) < cur
            y = torch.where(better, y_new, y)
            rate = torch.where(better, rate * 1.2, rate * 0.5)
    with torch.no_grad():
        residual = float(loss(y))
    return y.cpu().numpy(), residual
