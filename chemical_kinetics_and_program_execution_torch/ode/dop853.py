"""Host-stepped adaptive Dormand-Prince 8(5,3) (DOP853), and kernel K6.

`odeint_dop853_dense` is the counterpart of the JAX package's
`ode/dop853.py:odeint_dop853_dense`,
built the way its `ode/streamed_solve.py:dop853_streamed` is: torch has
no ``while_loop``, so the host drives the steps, the state and the 16
stages ([16, n] float64, one tensor) stay on the device, and the host
reads two scalars a step (the error sums). Same Hairer tableau (taken
from scipy's coefficient table, not retyped), same combined 5th/3rd
order error estimate, same controller (safety 0.9, factors 0.2-10,
exponent -1/8) and the same initial-step rule, so the port walks the
JAX stepper's step sequence; samples come from scipy's 7th-order
continuous output, the steps are not clamped to the sample times.
`odeint_dop853` is the step-clamped variant (``"dop853-step"``), and
`ode/dopri5.py` steps Dormand-Prince 5(4) on K6's second table.

The vector arithmetic is kernel K6 (`csrc/dop853.cu`): the stage states
(`stage`), the error and initial-step sums (`norms`), the
continuous-output stack (`dense_coeffs`) and its evaluation
(`dense_eval`). Each wrapper runs its plain PyTorch version (``*_plain``)
for a CPU tensor and launches the kernel for a CUDA one. A step costs
the host little: a stage launch names a row of the fixed tableau
(`TABLEAU`, on the card once) and one flag for the swap of stages 0 and
12; the error sums are one launch into the solve's own scratch; the
sample times go to the card once a solve, and one launch evaluates every
sample a step holds.
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
_RMS, _RMS_DIFF, _ERR, _ERR_H = 0, 1, 2, 3  # modes of `norms`
# Kvaerno 3(2)'s modes: the Newton step's sum (dz / y_scale)^2 with
# z += dz, and the embedded error's sum ((y_new - z3) / scale)^2.
_NEWTON, _ERR_DIFF = 4, 5

# Dormand-Prince 5(4), as the JAX package's `ode/dopri5.py:25-39` writes
# it (Python floats; B5 and B4 as float64 arrays, the error row their
# difference): K6's second table. `ode/dopri5.py` steps with it.
DP5_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
DP5_A = [
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
]
DP5_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                   11 / 84, 0.0])
DP5_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                   -92097 / 339200, 187 / 2100, 1 / 40])
DP5_ERR = DP5_B5 - DP5_B4
DP5_STAGES = 7

# Kvaerno 3(2) (ESDIRK, explicit first stage, stiffly accurate), as the
# JAX package's `ode/kvaerno3.py:40-46` writes it: K6's third table.
KV_GAMMA = 0.435866521508459
KV_A31 = 0.490563388419108
KV_A32 = 0.073570090080892
KV_A41 = 0.308809969973036
KV_A42 = 1.490563388254106
KV_A43 = -1.235239879727145
KV_C = (0.0, 2 * KV_GAMMA, 1.0, 1.0)
KV_STAGES = 4


def _terms(coefs, rows):
    """The nonzero (row, coefficient) terms of a stage combination, in
    stage order: what the kernel sums and the plain version too."""
    return [(int(r), float(c)) for c, r in zip(coefs, rows) if c != 0.0]


# The fixed stage combinations, by row: 0 the initial step's Euler
# state (both methods), 1-11 DOP853's A rows (stage i), 12 B (y_new),
# 13-15 the extra stages, 16 and 17 the error rows E5 and E3; then
# dopri5's A rows 1-6 at 18-23 (`DP5_ROWS[i]`), B5 at 24 and the error
# row B5 - B4 at 25; then Kvaerno 3(2)'s stage bases g2, g3, g4 at 26-28
# (``y + h sum_j a_sj k_j``; g2's row gamma k1) and the Newton
# predictors ``g + h gamma k_{s-1}`` of stages 3 and 4 at 29 and 30
# (stage 2's is row 26 on the base g2), `KV_G_ROWS` and `KV_PRED_ROWS`;
# then the fixed grid's adjoint (`ode/fixed.py`), DP5's transposed
# tableau: at 31-36 stage l's cotangent ``h (B5_l ybar + sum_{m > l}
# A_ml z_m)`` over an [8, n] tensor holding z_m = k_bar_m^T J(Y_m) at
# row m and ybar at row 7, on a zero base (`DP5_ADJ_ROWS[l]`; stage 6's
# cotangent is 0: B5_6 = 0 and no stage follows), and at 37 ``ybar +
# sum_l z_l`` (`DP5_ADJ_SUM`, with h = 1). Each row's terms name
# logical stages; K6 holds the table in constant memory
# (`csrc/dop853.cu`).
_EULER, _B_ROW, _E5_ROW, _E3_ROW = 0, _N_STAGES, 16, 17
_STAGES = range(_N_EXTENDED)
DP5_ROWS = (None,) + tuple(range(18, 18 + DP5_STAGES - 1))
DP5_B5_ROW, DP5_ERR_ROW = 24, 25
KV_G_ROWS = (None, 26, 27, 28)  # stage s's base g_s
KV_PRED_ROWS = (None, 26, 29, 30)  # stage s's predictor on g_s
DP5_ADJ_YBAR = DP5_STAGES  # the adjoint tensor's row of ybar
DP5_ADJ_ROWS = tuple(range(31, 31 + DP5_STAGES - 1))  # stages 0-5
DP5_ADJ_SUM = 31 + DP5_STAGES - 1
TABLEAU = tuple(
    [[(0, 1.0)]]
    + [_terms(_A[i, :i], _STAGES[:i]) for i in range(1, _N_STAGES)]
    + [_terms(_B, _STAGES[:_N_STAGES])]
    + [_terms(_A_EXTRA[j, :_N_STAGES + 1 + j], _STAGES[:_N_STAGES + 1 + j])
       for j in range(_N_EXTENDED - _N_STAGES - 1)]
    + [_terms(_E5, _STAGES[:_N_STAGES + 1]),
       _terms(_E3, _STAGES[:_N_STAGES + 1])]
    + [_terms(DP5_A[i], range(i)) for i in range(1, DP5_STAGES)]
    + [_terms(DP5_B5, range(DP5_STAGES)),
       _terms(DP5_ERR, range(DP5_STAGES))]
    + [[(0, KV_GAMMA)], [(0, KV_A31), (1, KV_A32)],
       [(0, KV_A41), (1, KV_A42), (2, KV_A43)],
       [(1, KV_GAMMA)], [(2, KV_GAMMA)]]
    + [_terms([DP5_B5[lo]] + [DP5_A[m][lo] for m in range(lo + 1,
                                                         DP5_STAGES - 1)],
              [DP5_ADJ_YBAR] + list(range(lo + 1, DP5_STAGES - 1)))
       for lo in range(DP5_STAGES - 1)]
    + [_terms([1.0] * (DP5_STAGES - 1), range(DP5_STAGES - 1))])
_MAX_TERMS = 16


def stage_rows(swap: int, fsal: int = _N_STAGES,
               stages: int = _N_EXTENDED) -> list:
    """Row of the stage tensor that holds each of ``stages`` stages: stage
    0 and stage ``fsal`` (12 for DOP853, 6 for dopri5) swap rows after
    every accepted step (first same as last)."""
    rows = list(range(stages))
    if swap:
        rows[0], rows[fsal] = rows[fsal], rows[0]
    return rows


def tableau_terms(which: int, swap: int = 0, fsal: int = _N_STAGES):
    """Row ``which`` of `TABLEAU` as (row of the stage tensor, c) terms,
    stage 0 and stage ``fsal`` swapped when ``swap``: what the plain
    versions sum."""
    rows = stage_rows(swap, fsal)
    return [(rows[r], c) for r, c in TABLEAU[which]]


def tableau_arrays():
    """`TABLEAU` as K6 uploads it: int32 term counts [38], int32 stages
    [38, 16] and float64 coefficients [38, 16], zero past each count."""
    count = np.asarray([len(t) for t in TABLEAU], dtype=np.int32)
    rows = np.zeros((len(TABLEAU), _MAX_TERMS), dtype=np.int32)
    coefs = np.zeros((len(TABLEAU), _MAX_TERMS), dtype=np.float64)
    for w, terms in enumerate(TABLEAU):
        for q, (r, c) in enumerate(terms):
            rows[w, q], coefs[w, q] = r, c
    return count, rows, coefs


_ON_CARD = set()  # cards that hold the tableau


def _lib(device):
    """The kernel library, with the tableau uploaded to ``device``'s
    constant memory on its first use there."""
    lib = cuda.load()
    if device.index not in _ON_CARD:
        count, rows, coefs = tableau_arrays()
        with torch.cuda.device(device):
            rc = lib.ckpe_k6_tableau(count.ctypes.data, rows.ctypes.data,
                                     coefs.ctypes.data, len(TABLEAU))
        cuda.check(rc, "K6 tableau", lib)
        _ON_CARD.add(device.index)
    return lib


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


# --- K6: stage states ----------------------------------------------------------


def stage_plain(y, ks, h: float, terms, out):
    """Plain version of `stage`: ``out = y + h * sum c * ks[row]`` over
    ``terms`` [(row, c), ...] (nonzero coefficients, stage order)."""
    stage_plain.calls += 1
    return torch.add(y, h * _lincomb_plain(ks, terms), out=out)


stage_plain.calls = 0


def stage(y, ks, h: float, which: int, out, swap: int = 0,
          fsal: int = _N_STAGES):
    """K6 stage state into ``out``: ``y + h * sum_q c_q * ks[row_q]`` over
    `TABLEAU` row ``which``, stages 0 and ``fsal`` in each other's rows
    when ``swap`` (`tableau_terms`); one launch, no host-built terms."""
    if not _on_card(y, "stage"):
        return stage_plain(y, ks, h, tableau_terms(which, swap, fsal), out)
    lib = _lib(y.device)
    with torch.cuda.device(y.device):
        rc = lib.ckpe_k6_stage(y.data_ptr(), ks.data_ptr(), _ld(ks, "stage"),
                               y.numel(), which, swap, fsal, h,
                               out.data_ptr(), cuda.stream(y))
    cuda.check(rc, "stage", lib)
    stage.launches += 1
    if which >= DP5_ADJ_ROWS[0]:
        stage.adjoint_launches += 1
    return out


stage.launches = 0
stage.adjoint_launches = 0  # of `stage.launches`, on the adjoint rows


# --- K6: norms -----------------------------------------------------------------

# Scratch of one `norms` launch, in doubles: 1,024 blocks' two partials,
# the two sums, and the ticket (`csrc/dop853.cu:ckpe_k6_norms`).
_NORM_PARTIALS = 2048
_NORM_SCRATCH = _NORM_PARTIALS + 3


def norm_scratch(device) -> torch.Tensor:
    """Scratch for `norms` on ``device``, its ticket 0: one for a solve,
    reused by each of its calls (calls on two streams need two)."""
    return torch.zeros(_NORM_SCRATCH, dtype=torch.float64, device=device)


def norms_plain(mode, y, rtol, atol, *, y_new=None, f0=None, f1=None,
                ks=None, terms5=None, terms3=None, h=None):
    """Plain version of `norms`: two sums as a float64 [2] tensor, the
    error sums over explicit ``terms5`` and ``terms3`` (``_ERR_H``: the
    one error row ``terms5``, times ``h``), each element's terms formed
    as the kernel forms them and summed in its order
    (`cuda.block_order_sum`)."""
    norms_plain.calls += 1
    if mode == _NEWTON:  # f0 = dz, f1 = z (updated in place)
        u = f0 / (atol + y.abs() * rtol)
        f1.add_(f0)
        return torch.stack([cuda.block_order_sum(u * u),
                            torch.zeros((), dtype=y.dtype, device=y.device)])
    if mode == _ERR_DIFF:  # f0 = z3
        u = (y_new - f0) / (atol + torch.maximum(y.abs(), y_new.abs()) * rtol)
        return torch.stack([cuda.block_order_sum(u * u),
                            torch.zeros((), dtype=y.dtype, device=y.device)])
    if mode in (_ERR, _ERR_H):
        scale = atol + torch.maximum(y.abs(), y_new.abs()) * rtol
        if mode == _ERR:
            err5 = _lincomb_plain(ks, terms5) / scale
            err3 = _lincomb_plain(ks, terms3) / scale
            terms = (err5 * err5, err3 * err3)
        else:
            u = h * _lincomb_plain(ks, terms5) / scale
            terms = (u * u, torch.zeros_like(u))
    else:
        scale = atol + y.abs() * rtol
        if mode == _RMS:
            u, v = y / scale, f0 / scale
            terms = (u * u, v * v)
        else:
            u = (f1 - f0) / scale
            terms = (u * u, torch.zeros_like(u))
    return torch.stack([cuda.block_order_sum(x) for x in terms])


norms_plain.calls = 0


def norms(mode, y, rtol, atol, *, y_new=None, f0=None, f1=None, ks=None,
          swap: int = 0, scratch=None, h: float = 0.0,
          fsal: int = _N_STAGES, rows=(_E5_ROW, _E3_ROW)):
    """K6 sums, a float64 [2] tensor on ``y``'s device, one launch:

    - ``_RMS``: sum (y/scale)^2, sum (f0/scale)^2, scale = atol + |y| rtol;
    - ``_RMS_DIFF``: sum ((f1 - f0)/scale)^2, and 0;
    - ``_ERR``: sum (e5/scale)^2, sum (e3/scale)^2, scale = atol +
      max(|y|, |y_new|) rtol, e5/e3 the stage sums of `TABLEAU`'s rows
      ``rows`` (DOP853's E5 and E3);
    - ``_ERR_H``: sum (h e/scale)^2 with the same scale, e the stage sum
      of the row ``rows[0]`` (dopri5's B5 - B4), and 0;
    - ``_NEWTON``: sum (dz/scale)^2, scale = atol + |y| rtol, with dz =
      ``f0``, fused with ``f1 += f0`` (the Newton iterate z = ``f1``
      updated in place), and 0;
    - ``_ERR_DIFF``: sum ((y_new - z3)/scale)^2, scale as ``_ERR``'s, z3
      = ``f0``, and 0 (Kvaerno 3(2)'s embedded error);

    stages 0 and ``fsal`` swapped when ``swap``. On a card the sums are a
    view of ``scratch`` (`norm_scratch`; a new one when None), which the
    next call with it overwrites."""
    if not _on_card(y, "norms"):
        terms = {}
        if mode in (_ERR, _ERR_H):
            terms = dict(terms5=tableau_terms(rows[0], swap, fsal), h=h)
        if mode == _ERR:
            terms["terms3"] = tableau_terms(rows[1], swap, fsal)
        return norms_plain(mode, y, rtol, atol, y_new=y_new, f0=f0, f1=f1,
                           ks=ks, **terms)
    if scratch is None:
        scratch = norm_scratch(y.device)
    elif (scratch.dtype != torch.float64 or scratch.device != y.device
          or scratch.shape != (_NORM_SCRATCH,)):
        raise TypeError(f"norms: scratch must be a float64 "
                        f"[{_NORM_SCRATCH}] tensor on {y.device}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib(y.device)
    with torch.cuda.device(y.device):
        rc = lib.ckpe_k6_norms(
            mode, y.numel(), rtol, atol, h, y.data_ptr(), ptr(y_new),
            ptr(f0), ptr(f1), ptr(ks), 0 if ks is None else _ld(ks, "norms"),
            swap, fsal, rows[0], rows[-1], scratch.data_ptr(),
            cuda.stream(y))
    cuda.check(rc, "norms", lib)
    norms.launches += 1
    return scratch[_NORM_PARTIALS:_NORM_PARTIALS + 2]


norms.launches = 0


# --- K6: the Newton residual ---------------------------------------------------


def resid_plain(z, g, f, hg: float, out):
    """Plain version of `resid`: ``out = z - hg * f - g``."""
    resid_plain.calls += 1
    return torch.sub(z - hg * f, g, out=out)


resid_plain.calls = 0


def resid(z, g, f, hg: float, out):
    """K6: an implicit stage's Newton residual phi(z) = z - hg f(z) - g
    (the JAX package's `ode/kvaerno3.py:64-65`, in its order) into
    ``out``; one launch."""
    if not _on_card(z, "resid"):
        return resid_plain(z, g, f, hg, out)
    lib = _lib(z.device)
    with torch.cuda.device(z.device):
        rc = lib.ckpe_k6_resid(z.data_ptr(), g.data_ptr(), f.data_ptr(), hg,
                               z.numel(), out.data_ptr(), cuda.stream(z))
    cuda.check(rc, "resid", lib)
    resid.launches += 1
    return out


resid.launches = 0


# --- K6: continuous output -----------------------------------------------------


def _dense_terms(rows):
    return [_terms(d_row, rows) for d_row in _D]


# The stages D weighs and its weights of them, as `dense_coeffs` passes
# them.
_D_USED = np.flatnonzero(_D.any(axis=0))
_D_COEFS = np.ascontiguousarray(_D[:, _D_USED], dtype=np.float64)


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
    r = np.asarray(rows, dtype=np.int32)[_D_USED]
    lib = cuda.load()
    with torch.cuda.device(y.device):
        rc = lib.ckpe_k6_dense_coeffs(
            y.data_ptr(), y_new.data_ptr(), f_old.data_ptr(),
            f_new.data_ptr(), ks.data_ptr(), _ld(ks, "dense_coeffs"),
            y.numel(), h, r.ctypes.data, _D_COEFS.ctypes.data, len(r),
            out.data_ptr(), _ld(out, "dense_coeffs"), cuda.stream(y))
    cuda.check(rc, "dense_coeffs", lib)
    dense_coeffs.launches += 1
    return out


dense_coeffs.launches = 0


def fractions(ts: torch.Tensor, i_out: int, m: int, t: float, h: float):
    """The fractions of the step from ``t`` of size ``h`` at the sample
    times ``ts[i_out:i_out + m]``: min(max((ts - t) / h, 0), 1), as the
    host forms each (a float64 tensor on ``ts``' device)."""
    # A 0-dim divisor on ts' device: PyTorch multiplies a CUDA tensor by
    # the reciprocal of a Python scalar divisor, which is not the host's
    # division.
    v = (ts[i_out:i_out + m] - t) / torch.tensor(h, dtype=ts.dtype,
                                                 device=ts.device)
    v = torch.where(v < 0.0, 0.0, v)
    return torch.where(v > 1.0, 1.0, v)


def dense_eval_at(F, y, x: float, out):
    """The continuous output at one fraction ``x`` into ``out``: y + the
    stack's rows by Horner, from the last, times x and 1 - x in turn."""
    acc = torch.zeros_like(y)
    n_rows = F.shape[0]
    for i in range(n_rows - 1, -1, -1):
        acc = acc + F[i]
        acc = acc * (x if (n_rows - 1 - i) % 2 == 0 else (1 - x))
    return torch.add(y, acc, out=out)


def dense_eval_plain(F, y, ts, i_out: int, m: int, t: float, h: float, out):
    """Plain version of `dense_eval`: `dense_eval_at` at each fraction in
    turn."""
    dense_eval_plain.calls += 1
    for q, x in enumerate(fractions(ts, i_out, m, t, h).tolist()):
        dense_eval_at(F, y, x, out[q])
    return out[:m]


dense_eval_plain.calls = 0

# Rows of one `dense_eval` launch: 65,535 chunks of 8 (`csrc/dop853.cu`).
_EVAL_ROWS = 65535 * 8


def dense_eval(F, y, ts, i_out: int, m: int, t: float, h: float, out):
    """K6: the continuous output of the step from ``t`` of size ``h`` at
    the ``m`` sample times ``ts[i_out:i_out + m]`` (a float64 tensor on
    ``y``'s device) into rows 0..m-1 of ``out`` (a tensor of rows); one
    launch for up to 524,280 samples. Each row has the bits of
    `dense_eval_at` at its fraction (`fractions`)."""
    if (ts.dtype != torch.float64 or ts.get_device() != y.get_device()
            or ts.dim() != 1 or not ts.is_contiguous()):
        raise TypeError(f"dense_eval: ts must be a contiguous float64 "
                        f"vector on {y.device}")
    if m < 1 or i_out < 0 or i_out + m > ts.numel() or out.shape[0] < m:
        raise ValueError(f"dense_eval: {m} samples from {i_out} of "
                         f"{ts.numel()} times into {out.shape[0]} rows")
    if not _on_card(y, "dense_eval"):
        return dense_eval_plain(F, y, ts, i_out, m, t, h, out)
    lib = cuda.load()
    f_ld, out_ld = _ld(F, "dense_eval"), _ld(out, "dense_eval")
    out_ptr = out.data_ptr()
    with torch.cuda.device(y.device):
        for q in range(0, m, _EVAL_ROWS):
            rc = lib.ckpe_k6_dense_eval(
                F.data_ptr(), f_ld, y.data_ptr(), y.numel(), ts.data_ptr(),
                i_out + q, min(_EVAL_ROWS, m - q), t, h,
                out_ptr + 8 * q * out_ld, out_ld, cuda.stream(y))
            cuda.check(rc, "dense_eval", lib)
            dense_eval.launches += 1
    return out[:m]


dense_eval.launches = 0

KERNELS = (stage, norms, dense_coeffs, dense_eval)
PLAIN = (stage_plain, norms_plain, dense_coeffs_plain, dense_eval_plain)


# --- The driver ----------------------------------------------------------------


@dataclasses.dataclass
class SolveStats:
    num_accepted: int = 0
    num_rejected: int = 0
    num_rhs: int = 0
    num_sampled: int = 0  # accepted steps that hold samples
    completed: bool = False
    y_final: torch.Tensor | None = None
    num_newton: int = 0  # Newton iterations (the stiff stepper)
    num_jvp: int = 0  # J.v products in its Krylov solves


class _Stepper:
    """What the host-stepped solvers share: the state ``y`` (a float64
    copy of ``y0``), ``m`` stage rows on the device (`rows_tensor`), the
    stage that trades rows with stage 0 (``fsal``) and the flag of that
    swap, the error-sum scratch, the RHS written into a stage's row, the
    sample rows and the counts."""

    def __init__(self, fn, y0, ts, stages, fsal, sample_fn):
        self.y = y0.reshape(-1).to(torch.float64, copy=True)
        self.dev, self.n = self.y.device, self.y.numel()
        self.ts = np.asarray(ts, dtype=np.float64)
        self.K = rows_tensor(stages, self.n, self.dev)
        self.stages, self.fsal, self.swap = stages, fsal, 0
        self.rows = stage_rows(0, fsal, stages)  # logical stage -> row
        self.scratch = norm_scratch(self.dev)
        self.y_new = torch.empty_like(self.y)
        self.fn, self.takes_out = fn, getattr(fn, "takes_out", False)
        self.sample_fn = sample_fn or (lambda s: s)
        self.stats = SolveStats()
        self.out_rows = [self.sample_fn(self.y[None]).clone()]

    def rhs(self, v, t, i):
        """dp/dt at ``v`` into stage i's row."""
        self.stats.num_rhs += 1
        if self.takes_out:
            self.fn(v, t, out=self.K[self.rows[i]])
        else:
            self.K[self.rows[i]].copy_(self.fn(v, t))

    def stage(self, h, which, out):
        return stage(self.y, self.K, h, which, out, self.swap, self.fsal)

    def initial_step(self, rtol, atol, order):
        """f0 into stage 0's row and the first step size (Hairer/Wanner,
        scipy's `_select_initial_step`; the JAX package's
        `ode/dopri5.py:72-86`, `ode/dop853.py:71-88`), error exponent
        1 / ``order``."""
        y, K, rows, n = self.y, self.K, self.rows, self.n
        t0, t_end = float(self.ts[0]), float(self.ts[-1])
        self.rhs(y, t0, 0)
        d0, d1 = (math.sqrt(v / n) for v in
                  norms(_RMS, y, rtol, atol, f0=K[rows[0]],
                        scratch=self.scratch).tolist())
        h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / d1
        self.stage(h0, _EULER, self.y_new)
        self.rhs(self.y_new, t0 + h0, 1)
        d2 = math.sqrt(norms(_RMS_DIFF, y, rtol, atol, f0=K[rows[0]],
                             f1=K[rows[1]], scratch=self.scratch
                             ).tolist()[0] / n) / h0
        if d1 <= 1e-15 and d2 <= 1e-15:
            h1 = max(1e-6, h0 * 1e-3)
        else:
            h1 = (0.01 / max(d1, d2)) ** (1.0 / order)
        span = t_end - t0
        return min(max(min(100 * h0, h1), 1e-14 * span), span)

    def accept(self):
        """The accepted step's y_new becomes y; stage ``fsal``'s row
        becomes stage 0's."""
        self.y, self.y_new = self.y_new, self.y
        self.swap = 1 - self.swap
        self.rows = stage_rows(self.swap, self.fsal, self.stages)
        self.stats.num_accepted += 1

    def finish(self, i_out):
        self.stats.completed = i_out >= len(self.ts)
        self.stats.y_final = self.y
        return torch.cat(self.out_rows), self.stats


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
    st = _Stepper(fn, y0, ts, _N_EXTENDED, _N_STAGES, sample_fn)
    ts, n, stats = st.ts, st.n, st.stats
    ts_dev = torch.as_tensor(ts, device=st.dev)
    n_out = len(ts)
    t0, t_end = float(ts[0]), float(ts[-1])
    dt = st.initial_step(rtol, atol, 8.0)

    F = None
    samples = None
    t, i_out = t0, 1
    while (i_out < n_out
           and stats.num_accepted + stats.num_rejected < max_steps):
        h = min(dt, t_end - t)
        for i in range(1, _N_STAGES):
            st.stage(h, i, st.y_new)
            st.rhs(st.y_new, t + _C[i] * h, i)
        st.stage(h, _B_ROW, st.y_new)
        st.rhs(st.y_new, t + h, _N_STAGES)
        n5, n3 = norms(_ERR, st.y, rtol, atol, y_new=st.y_new, ks=st.K,
                       swap=st.swap, scratch=st.scratch).tolist()
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
                y, K, rows = st.y, st.K, st.rows
                scratch_y = torch.empty_like(y)
                for s in range(_N_STAGES + 1, _N_EXTENDED):
                    st.stage(h, s, scratch_y)
                    st.rhs(scratch_y, t + _C_EXTRA[s - _N_STAGES - 1] * h, s)
                if F is None:
                    F = rows_tensor(7, n, st.dev)
                dense_coeffs(y, st.y_new, h, K[rows[0]], K[rows[_N_STAGES]],
                             K, rows, F)
                if samples is None or samples.shape[0] < m:
                    samples = rows_tensor(m, n, st.dev)
                dense_eval(F, y, ts_dev, i_out, m, t, h, samples)
                st.out_rows.append(st.sample_fn(samples[:m]).clone())
                i_out += m
                stats.num_sampled += 1
            t = t_new
            st.accept()
        else:
            stats.num_rejected += 1
        dt = dt_next
    return st.finish(i_out)


def odeint_dop853(fn, y0: torch.Tensor, ts, tols,
                  max_steps: int = 1_000_000, *, sample_fn=None):
    """The step-clamped DOP853 (``method="dop853-step"``), counterpart of
    the JAX package's `ode/dop853.py:45 odeint_dop853`: the same 12
    stages, then ``f_new = fn(y_new)`` as the 13th (the next step's
    first), the combined E5/E3 error norm and the controller clip(0.9
    err^(-1/8), 0.2, 10), min(factor, 1) on a reject, no PI term; each
    step clamped to land on the next sample time (reached when the step
    covers 1 - 1e-14 of the way), no dense output. Same contract as
    `odeint_dop853_dense`; the arithmetic is K6's."""
    rtol, atol = (float(x) for x in tols)
    st = _Stepper(fn, y0, ts, _N_STAGES + 1, _N_STAGES, sample_fn)
    ts, n, stats = st.ts, st.n, st.stats
    n_out = len(ts)
    dt = st.initial_step(rtol, atol, 8.0)
    y_stage = torch.empty_like(st.y)
    t, i_out = float(ts[0]), 1
    while (i_out < n_out
           and stats.num_accepted + stats.num_rejected < max_steps):
        t_target = float(ts[min(i_out, n_out - 1)])
        h = min(dt, t_target - t)
        hits_target = h >= (t_target - t) * (1 - 1e-14)
        for i in range(1, _N_STAGES):
            st.stage(h, i, y_stage)
            st.rhs(y_stage, t + _C[i] * h, i)
        st.stage(h, _B_ROW, st.y_new)
        st.rhs(st.y_new, t + h, _N_STAGES)
        n5, n3 = norms(_ERR, st.y, rtol, atol, y_new=st.y_new, ks=st.K,
                       swap=st.swap, scratch=st.scratch).tolist()
        denom = np.sqrt((n5 + 0.01 * n3) * n)
        err = max(abs(h) * n5 / max(denom, 1e-300), 1e-30)
        accept = err <= 1.0
        factor = min(max(_SAFETY * err**_ERROR_EXPONENT, _MIN_FACTOR),
                     _MAX_FACTOR)
        dt_next = h * factor if accept else h * min(factor, 1.0)
        if accept:
            t = t_target if hits_target else t + h
            if hits_target:
                st.out_rows.append(st.sample_fn(st.y_new[None]).clone())
                i_out += 1
                stats.num_sampled += 1
            st.accept()
        else:
            stats.num_rejected += 1
        dt = dt_next
    return st.finish(i_out)
