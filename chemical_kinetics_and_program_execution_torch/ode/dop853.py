"""Host-stepped adaptive Dormand-Prince 8(5,3) with dense output (DOP853).

Counterpart of the JAX package's `ode/dop853.py:odeint_dop853_dense`,
built the way its `ode/streamed_solve.py:dop853_streamed` is: torch has
no ``while_loop``, so the host drives the steps, the state and the 16
stages ([16, n] float64, one tensor) stay on the device, and the host
reads two scalars a step (the error sums). Same Hairer tableau (taken
from scipy's coefficient table, not retyped), same combined 5th/3rd
order error estimate, same controller (safety 0.9, factors 0.2-10,
exponent -1/8) and the same initial-step rule, so the port walks the
JAX stepper's step sequence; samples come from scipy's 7th-order
continuous output, the steps are not clamped to the sample times.

The vector arithmetic is kernel K6 (`csrc/dop853.cu`): the stage states
(`stage`), the error and initial-step sums (`norms`), the
continuous-output stack (`dense_coeffs`) and its evaluation
(`dense_eval`). Each wrapper runs its plain PyTorch version (``*_plain``)
for a CPU tensor and launches the kernel for a CUDA one.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from scipy.integrate._ivp import dop853_coefficients as _dc

from .. import cuda

_N_STAGES = _dc.N_STAGES  # 12
_N_EXTENDED = _dc.N_STAGES_EXTENDED  # 16 (3 extra dense-output stages)
_A = np.array(_dc.A[:_N_STAGES, :_N_STAGES])
_A_EXTRA = np.array(_dc.A[_N_STAGES + 1:_N_EXTENDED])  # rows 13..15
_B = np.array(_dc.B)  # [12]
_C = np.array(_dc.C[:_N_STAGES])
_C_EXTRA = np.array(_dc.C[_N_STAGES + 1:_N_EXTENDED])
_D = np.array(_dc.D)  # [4, 16] interpolation weights
_E3 = np.array(_dc.E3)  # [13], includes the f(t+h, y_new) stage
_E5 = np.array(_dc.E5)
_ERROR_EXPONENT = -1.0 / 8.0
_SAFETY, _MIN_FACTOR, _MAX_FACTOR = 0.9, 0.2, 10.0
_RMS, _RMS_DIFF, _ERR = 0, 1, 2  # modes of `norms`


def _terms(coefs, rows):
    """The nonzero (row, coefficient) terms of a stage combination, in
    stage order: what the kernel sums and the plain version too."""
    return [(int(r), float(c)) for c, r in zip(coefs, rows) if c != 0.0]


def _lincomb_plain(ks, terms):
    acc = None
    for r, c in terms:
        term = c * ks[r]
        acc = term if acc is None else acc + term
    return acc


def _on_card(t: torch.Tensor, name: str) -> bool:
    if cuda.on_card(t, name) and t.dtype != torch.float64:
        raise TypeError(f"{name} takes float64 tensors")
    return t.device.type == "cuda"


def _ld(rows: torch.Tensor, name: str) -> int:
    """The row stride of a [m, n] tensor of rows for the kernel, whose
    rows must each be contiguous."""
    if rows.dim() != 2 or rows.stride(1) != 1:
        raise ValueError(f"{name}: rows must be a [m, n] tensor of "
                         "contiguous rows")
    return rows.stride(0)


def rows_tensor(m: int, n: int, device) -> torch.Tensor:
    """A float64 [m, n] tensor whose rows start 256 bytes apart at least
    and on 256-byte boundaries (row stride n rounded up to 32), as the
    solver keeps its stages and its dense-output stack: a row at a
    stride of n (odd for n = A^k) starts off a sector boundary every
    other row."""
    ld = -(-n // 32) * 32
    return torch.empty((m, ld), dtype=torch.float64, device=device)[:, :n]


def _arrays(terms):
    rows = np.asarray([r for r, _ in terms], dtype=np.int32)
    coefs = np.asarray([c for _, c in terms], dtype=np.float64)
    return rows, coefs


# --- K6: stage states ----------------------------------------------------------


def stage_plain(y, ks, h: float, terms, out):
    """Plain version of `stage`: ``out = y + h * sum c * ks[row]``."""
    stage_plain.calls += 1
    return torch.add(y, h * _lincomb_plain(ks, terms), out=out)


stage_plain.calls = 0


def stage(y, ks, h: float, terms, out):
    """K6 stage state into ``out``: ``y + h * sum_q c_q * ks[row_q]`` over
    ``terms`` [(row, c), ...] (nonzero coefficients, stage order)."""
    if not _on_card(y, "stage"):
        return stage_plain(y, ks, h, terms, out)
    rows, coefs = _arrays(terms)
    lib = cuda.load()
    with torch.cuda.device(y.device):
        rc = lib.ckpe_k6_stage(y.data_ptr(), ks.data_ptr(), _ld(ks, "stage"),
                               y.numel(), h, rows.ctypes.data,
                               coefs.ctypes.data, len(terms), out.data_ptr(),
                               cuda.stream(y))
    cuda.check(rc, "stage", lib)
    stage.launches += 1
    return out


stage.launches = 0


# --- K6: norms -----------------------------------------------------------------


def norms_plain(mode, y, rtol, atol, *, y_new=None, f0=None, f1=None,
                ks=None, terms5=None, terms3=None):
    """Plain version of `norms`: two sums as a float64 [2] tensor."""
    norms_plain.calls += 1
    if mode == _ERR:
        scale = atol + torch.maximum(y.abs(), y_new.abs()) * rtol
        err5 = _lincomb_plain(ks, terms5) / scale
        err3 = _lincomb_plain(ks, terms3) / scale
        return torch.stack([torch.sum(err5 * err5), torch.sum(err3 * err3)])
    scale = atol + y.abs() * rtol
    if mode == _RMS:
        return torch.stack([torch.sum((y / scale) ** 2),
                            torch.sum((f0 / scale) ** 2)])
    d = torch.sum(((f1 - f0) / scale) ** 2)
    return torch.stack([d, torch.zeros_like(d)])


norms_plain.calls = 0


def norms(mode, y, rtol, atol, *, y_new=None, f0=None, f1=None, ks=None,
          terms5=None, terms3=None):
    """K6 sums, a float64 [2] tensor on ``y``'s device (two launches: a
    block reduction, then one block over the partials):

    - ``_RMS``: sum (y/scale)^2, sum (f0/scale)^2, scale = atol + |y| rtol;
    - ``_RMS_DIFF``: sum ((f1 - f0)/scale)^2, and 0;
    - ``_ERR``: sum (e5/scale)^2, sum (e3/scale)^2, scale = atol +
      max(|y|, |y_new|) rtol, e5/e3 the stage sums over ``terms5/3``.
    """
    if not _on_card(y, "norms"):
        return norms_plain(mode, y, rtol, atol, y_new=y_new, f0=f0, f1=f1,
                           ks=ks, terms5=terms5, terms3=terms3)
    partial = torch.empty(2048, dtype=torch.float64, device=y.device)
    out = torch.empty(2, dtype=torch.float64, device=y.device)
    r5, c5 = _arrays(terms5 or [])
    r3, c3 = _arrays(terms3 or [])

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = cuda.load()
    with torch.cuda.device(y.device):
        rc = lib.ckpe_k6_norms(
            mode, y.numel(), rtol, atol, y.data_ptr(), ptr(y_new), ptr(f0),
            ptr(f1), ptr(ks), 0 if ks is None else _ld(ks, "norms"),
            r5.ctypes.data, c5.ctypes.data, len(r5),
            r3.ctypes.data, c3.ctypes.data, len(r3), partial.data_ptr(),
            out.data_ptr(), cuda.stream(y))
    cuda.check(rc, "norms", lib)
    norms.launches += 2
    return out


norms.launches = 0


# --- K6: continuous output -----------------------------------------------------


def _dense_terms(rows):
    return [_terms(d_row, rows) for d_row in _D]


def dense_coeffs_plain(y, y_new, h, f_old, f_new, ks, rows, out):
    """Plain version of `dense_coeffs`."""
    dense_coeffs_plain.calls += 1
    delta = y_new - y
    stack = [delta, h * f_old - delta, 2 * delta - h * (f_new + f_old)]
    stack += [h * _lincomb_plain(ks, t) for t in _dense_terms(rows)]
    return torch.stack(stack, out=out)


dense_coeffs_plain.calls = 0


def dense_coeffs(y, y_new, h: float, f_old, f_new, ks, rows, out):
    """K6: the 7-row continuous-output stack [7, n] into ``out`` (scipy's
    `Dop853DenseOutput` coefficients) from the 16 stages, stage i in row
    ``rows[i]`` of ``ks``; one launch."""
    if not _on_card(y, "dense_coeffs"):
        return dense_coeffs_plain(y, y_new, h, f_old, f_new, ks, rows, out)
    used = [q for q in range(_N_EXTENDED) if _D[:, q].any()]
    r = np.asarray([rows[q] for q in used], dtype=np.int32)
    c = np.ascontiguousarray(_D[:, used], dtype=np.float64)
    lib = cuda.load()
    with torch.cuda.device(y.device):
        rc = lib.ckpe_k6_dense_coeffs(
            y.data_ptr(), y_new.data_ptr(), f_old.data_ptr(),
            f_new.data_ptr(), ks.data_ptr(), _ld(ks, "dense_coeffs"),
            y.numel(), h, r.ctypes.data, c.ctypes.data, len(used),
            out.data_ptr(), _ld(out, "dense_coeffs"), cuda.stream(y))
    cuda.check(rc, "dense_coeffs", lib)
    dense_coeffs.launches += 1
    return out


dense_coeffs.launches = 0


def dense_eval_plain(F, y, x: float, out):
    """Plain version of `dense_eval`."""
    dense_eval_plain.calls += 1
    acc = torch.zeros_like(y)
    n_rows = F.shape[0]
    for i in range(n_rows - 1, -1, -1):
        acc = acc + F[i]
        acc = acc * (x if (n_rows - 1 - i) % 2 == 0 else (1 - x))
    return torch.add(y, acc, out=out)


dense_eval_plain.calls = 0


def dense_eval(F, y, x: float, out):
    """K6: the continuous output at fraction ``x`` in [0, 1] into
    ``out``, one launch."""
    if not _on_card(y, "dense_eval"):
        return dense_eval_plain(F, y, x, out)
    lib = cuda.load()
    with torch.cuda.device(y.device):
        rc = lib.ckpe_k6_dense_eval(F.data_ptr(), _ld(F, "dense_eval"),
                                    y.data_ptr(), y.numel(), x, 1 - x,
                                    out.data_ptr(), cuda.stream(y))
    cuda.check(rc, "dense_eval", lib)
    dense_eval.launches += 1
    return out


dense_eval.launches = 0

KERNELS = (stage, norms, dense_coeffs, dense_eval)
PLAIN = (stage_plain, norms_plain, dense_coeffs_plain, dense_eval_plain)


# --- The driver ----------------------------------------------------------------


@dataclasses.dataclass
class SolveStats:
    num_accepted: int = 0
    num_rejected: int = 0
    num_rhs: int = 0
    completed: bool = False
    y_final: torch.Tensor | None = None


def odeint_dop853_dense(fn, y0: torch.Tensor, ts, tols,
                        max_steps: int = 1_000_000, *, sample_fn=None):
    """Integrates ``dy/dt = fn(y, t)`` from ``y0`` (a float64 vector on
    its device) sampling at times ``ts`` (``ts[0]`` is the start).

    ``fn(y, t)`` returns dp/dt on ``y``'s device; a ``fn`` marked
    ``takes_out`` (`markov_tapes`' device RHS) is called as
    ``fn(y, t, out=row)`` and writes dp/dt straight into the stage row.
    ``sample_fn`` maps a ``[m, n]`` block of sampled states to rows
    (default: the states).
    Returns ``(rows [len(ts), width] on the device, SolveStats)``; like
    the JAX stepper it stops once every sample is written or after
    ``max_steps`` steps (``completed`` False).
    """
    rtol, atol = (float(x) for x in tols)
    y = y0.reshape(-1).to(torch.float64, copy=True)
    dev, n = y.device, y.numel()
    ts = np.asarray(ts, dtype=np.float64)
    n_out = len(ts)
    sample_fn = sample_fn or (lambda s: s)
    stats = SolveStats()
    K = rows_tensor(_N_EXTENDED, n, dev)
    rows = list(range(_N_EXTENDED))  # logical stage -> row of K

    takes_out = getattr(fn, "takes_out", False)

    def rhs(v, t, i):
        stats.num_rhs += 1
        if takes_out:
            fn(v, t, out=K[rows[i]])
        else:
            K[rows[i]].copy_(fn(v, t))

    out_rows = [sample_fn(y[None]).clone()]
    t0, t_end = float(ts[0]), float(ts[-1])
    rhs(y, t0, 0)

    # Initial step (Hairer/Wanner, scipy's _select_initial_step).
    d0, d1 = (math.sqrt(v / n) for v in
              norms(_RMS, y, rtol, atol, f0=K[rows[0]]).tolist())
    h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / d1
    y_new = torch.empty_like(y)
    stage(y, K, h0, [(rows[0], 1.0)], y_new)
    rhs(y_new, t0 + h0, 1)
    d2 = math.sqrt(norms(_RMS_DIFF, y, rtol, atol, f0=K[rows[0]],
                         f1=K[rows[1]]).tolist()[0] / n) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = max(1e-6, h0 * 1e-3)
    else:
        h1 = (0.01 / max(d1, d2)) ** (1.0 / 8.0)
    span = t_end - t0
    dt = min(max(min(100 * h0, h1), 1e-14 * span), span)

    F = None
    samples = None
    t, i_out = t0, 1
    while (i_out < n_out
           and stats.num_accepted + stats.num_rejected < max_steps):
        h = min(dt, t_end - t)
        for i in range(1, _N_STAGES):
            stage(y, K, h, _terms(_A[i, :i], rows[:i]), y_new)
            rhs(y_new, t + _C[i] * h, i)
        stage(y, K, h, _terms(_B, rows[:_N_STAGES]), y_new)
        rhs(y_new, t + h, _N_STAGES)
        n5, n3 = norms(_ERR, y, rtol, atol, y_new=y_new, ks=K,
                       terms5=_terms(_E5, rows[:_N_STAGES + 1]),
                       terms3=_terms(_E3, rows[:_N_STAGES + 1])).tolist()
        denom = np.sqrt((n5 + 0.01 * n3) * n)
        err = max(abs(h) * n5 / max(denom, 1e-300), 1e-30)
        accept = err <= 1.0
        factor = min(max(_SAFETY * err**_ERROR_EXPONENT, _MIN_FACTOR),
                     _MAX_FACTOR)
        dt_next = h * factor if accept else h * min(factor, 1.0)
        if accept:
            t_new = t + h
            at_end = t_new >= t_end * (1 - 1e-15) + t0 * 1e-15
            m = 0
            while i_out + m < n_out and (ts[i_out + m] <= t_new or at_end):
                m += 1
            if m:
                scratch = torch.empty_like(y)
                for j in range(_N_EXTENDED - _N_STAGES - 1):
                    s = _N_STAGES + 1 + j
                    stage(y, K, h, _terms(_A_EXTRA[j, :s], rows[:s]),
                          scratch)
                    rhs(scratch, t + _C_EXTRA[j] * h, s)
                if F is None:
                    F = rows_tensor(7, n, dev)
                dense_coeffs(y, y_new, h, K[rows[0]], K[rows[_N_STAGES]],
                             K, rows, F)
                if samples is None or samples.shape[0] < m:
                    samples = rows_tensor(m, n, dev)
                for q in range(m):
                    x = min(max((ts[i_out + q] - t) / h, 0.0), 1.0)
                    dense_eval(F, y, x, samples[q])
                out_rows.append(sample_fn(samples[:m]).clone())
                i_out += m
            t = t_new
            y, y_new = y_new, y
            rows[0], rows[_N_STAGES] = rows[_N_STAGES], rows[0]
            stats.num_accepted += 1
        else:
            stats.num_rejected += 1
        dt = dt_next
    stats.completed = i_out >= n_out
    stats.y_final = y
    return torch.cat(out_rows), stats

