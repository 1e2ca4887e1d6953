"""Restarted GMRES on a matvec: the port's copy of the batched GMRES the
JAX package calls.

Counterpart of `jax.scipy.sparse.linalg.gmres(..., solve_method=
"batched")` (JAX 0.9.0, `jax/_src/scipy/sparse/linalg.py`: `_safe_normalize`
:291, `_iterative_classical_gram_schmidt` :322, `_kth_arnoldi_iteration`
:391, `_lstsq` :508, `_gmres_batched` :515, `_gmres_solve` :558, `gmres`
:591), the only method the JAX package's solvers use. One restart builds
the Krylov basis V [n, restart + 1] by Arnoldi steps (one classical
Gram-Schmidt pass against every column, as the JAX package's loop runs
at its default of two; a step whose new vector's norm falls to eps
times its first norm is a breakdown and ends the restart), solves the small least-squares
problem by its normal equations and a positive-definite (Cholesky)
solve, H starting as eye(restart, restart + 1), and ends with one more
matvec for the true residual.

The Krylov products are ``torch.mv`` over the basis on the device: plain
library products outside any kernel, as the JAX package leaves them to
XLA. The matvec is the caller's (a J.v: kernel K25 for the dense RHS).
The host reads H's row an Arnoldi step (its last entry is the breakdown
test) and the residual norm a restart, where the JAX package's
`while_loop` reads them on the device, and solves the [restart, restart]
normal equations itself (numpy's Cholesky: microseconds, where a device
factorisation of so small a matrix costs a launch and a read all the
same).
"""

from __future__ import annotations

import math

import numpy as np
import scipy.linalg
import torch


def jvp(fn, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """J v of ``fn`` at ``x`` by forward mode (`torch.autograd.forward_ad`
    duals): the port's dense RHS answers a dual with one K25 launch
    (`engine/dense.py`), an RHS in torch ops differentiates natively. A
    ``fn`` whose output carries no tangent gives zeros. Duals cost the
    host less a product than `torch.func.jvp`'s wrappers, and the host
    paces the Krylov loops."""
    fwad = torch.autograd.forward_ad
    with fwad.dual_level():
        out = fn(fwad.make_dual(x, v))
        tangent = fwad.unpack_dual(out).tangent
        return torch.zeros_like(x) if tangent is None else tangent


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.dot(x, x))


def _safe_normalize(x: torch.Tensor, thresh=None):
    """``(x / |x|, |x|)``, or ``(0, 0)`` where |x| is not above
    ``thresh`` (eps of float64 when None) or is NaN."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return (torch.where(use, x / norm, torch.zeros_like(x)),
            torch.where(use, norm, torch.zeros_like(norm)))


def _classical_gram_schmidt(Q: torch.Tensor, x: torch.Tensor):
    """Orthogonalises x against the columns of Q by one classical pass,
    ``h = Q^T x, x - Q h``: the JAX package's loop ("twice is enough")
    tests for a second pass only while its pass count is below
    max_iterations - 1 = 1, which its first pass already reaches.
    Returns (q, h)."""
    h = torch.mv(Q.T, x)
    return x - torch.mv(Q, h), h


def _arnoldi_step(k: int, A, V: torch.Tensor, H: np.ndarray):
    """Column k + 1 of V and row k of H (on the host) from A(V[:, k]);
    True at a breakdown (the new vector's norm at most eps times
    A(V[:, k])'s)."""
    v = A(V[:, k])
    _, v_norm_0 = _safe_normalize(v)
    v, h = _classical_gram_schmidt(V, v)
    eps = torch.finfo(V.dtype).eps
    unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
    V[:, k + 1] = unit_v
    h[k + 1] = v_norm_1
    H[k, :] = h.cpu().numpy()
    return H[k, k + 1] == 0.0


def _lstsq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The normal equations' positive-definite (Cholesky) solve; NaN where
    the factorisation fails, as the JAX package's gives."""
    a2 = a.T @ a
    b2 = a.T @ b
    try:
        return scipy.linalg.cho_solve(scipy.linalg.cho_factor(a2), b2)
    except (np.linalg.LinAlgError, ValueError):
        return np.full(a2.shape[0], math.nan)


def _gmres_batched(A, b, x0, unit_residual, residual_norm, restart: int,
                   count: list):
    """One restart: returns (x, unit residual, residual norm)."""
    n = b.numel()
    V = torch.zeros((n, restart + 1), dtype=b.dtype, device=b.device)
    V[:, 0] = unit_residual
    H = np.eye(restart, restart + 1)
    for k in range(restart):
        count[0] += 1
        if _arnoldi_step(k, A, V, H):
            break
    beta = np.zeros(restart + 1)
    beta[0] = float(residual_norm)
    y = torch.as_tensor(_lstsq(H.T, beta), device=b.device)
    x = x0 + torch.mv(V[:, :-1], y)
    count[0] += 1
    unit_residual, residual_norm = _safe_normalize(b - A(x))
    return x, unit_residual, residual_norm


def gmres(A, b: torch.Tensor, x0: torch.Tensor | None = None, *,
          tol: float = 1e-5, atol: float = 0.0, restart: int = 20,
          maxiter: int | None = None):
    """Solves ``A(x) = b`` by restarted GMRES (the JAX package's batched
    method): ``restart = min(restart, n)``, the tolerance ``max(tol *
    |b|, atol)`` on the residual norm between restarts, at most
    ``maxiter`` restarts (10 n when None), x0 zeros when None.

    Returns ``(x, matvecs)``: the solution (NaN entries possible, as the
    JAX package's) and the number of times ``A`` was called."""
    n = b.numel()
    if x0 is None:
        x0 = torch.zeros_like(b)
    if maxiter is None:
        maxiter = 10 * n
    restart = min(restart, n)
    atol = torch.clamp(tol * _norm(b), min=atol)
    count = [1]
    unit_residual, residual_norm = _safe_normalize(b - A(x0))
    x = x0
    k = 0
    while k < maxiter and bool(residual_norm > atol):
        x, unit_residual, residual_norm = _gmres_batched(
            A, b, x, unit_residual, residual_norm, restart, count)
        k += 1
    return x, count[0]
