"""Closure truncation-error indicator: can you trust cl_k without
solving at cl_k+1?

Counterpart of the JAX package's `ops/closure.py`: host numpy around the
port's RHS (`engine.build_dy_dt` on ``device``, ``cuda`` unless named:
K3-K5 there, their plain versions on the CPU), whose device results are
read back as numpy.

Two facts about the engine's closure, both computable at any state p
(one compiled RHS call each; compiles are disk-cached):

1. CONSISTENCY IDENTITY. The generators at successive context lengths
   commute through the maximum-entropy (Markov) extension:

       marg( F_{k+1}( extend(p) ) ) == F_k(p)      (exactly)

   because F_k is BY CONSTRUCTION the marginal flow of the extended
   measure (the guarded pyramid ratios ARE the extension conditionals,
   reference `tape_multiverse.scm` accumulate semantics). This is not
   where truncation error lives — but it is a sharp cross-cl_k oracle
   on the compiled engine: any inconsistency between the k and k+1
   compilations shows up here at machine precision
   (`tests/test_closure_error.py`).

2. OFF-MANIFOLD DEFECT. Truncation error enters because the extension
   manifold is NOT invariant: the true (k+1)-flow at extend(p) has a
   component the closure at k cannot represent,

       nu(p) = || F_{k+1}(extend(p)) − D extend(p)[F_k(p)] ||

   (flow minus the manifold tangent motion). nu is the local SOURCE
   rate of closure error: measured on ex2, the time integral of nu
   along the cl_k=3 trajectory tracks the true k-marginal gap to the
   solved cl_k=4 trajectory within a factor ~2–3 (conservative — error
   components also decay), turning "is cl_k enough?" from an
   hours-long re-solve into one RHS call per checkpoint
   (`examples/ex2_closure_error.py` for the measured comparison).
   Caveat: nu > 0 does not ALWAYS imply error in tracked observables
   (a rule whose k-window flow never consults out-of-window context,
   e.g. ex1's single-site rule, is exact at every cl_k regardless of
   manifold invariance; and ex5's machine holds a steady nu ~ 1.6e-4
   while its tracked observables agree k5↔k7 at ~1e-10 — the
   off-manifold components decay without feeding the windows those
   observables weight). nu ≈ 0 does imply local exactness; nu > 0 is
   a conservative flag, sharp on ex2 (factor 2–3) and loose where
   strong contraction eats the injected error.
"""

from __future__ import annotations

import numpy as np
import torch


def markov_extend(p, size_a: int, cl_k: int):
    """Maximum-entropy extension of a length-``cl_k`` window
    distribution to length ``cl_k+1``:

        q(s_1..s_{k+1}) = p(s_1..s_k) · p(s_2..s_{k+1}) / m(s_2..s_k)

    with m the shared inner marginal (guarded 0/0 → 0). This is the
    unique extension with the same order-(cl_k−1) conditional structure
    — the measure the closure semantics already assume
    (`markov.seq_prob`'s long-sequence branch, reference
    `markov_tapes.py:190-233`). ``p`` must be marginal-consistent
    (left marginal == right marginal) for both (k)-marginals of the
    result to recover it.
    """
    p = np.asarray(p)
    if not np.iscomplexobj(p):
        p = p.astype(np.float64)
    p = p.reshape((size_a,) * cl_k)
    left = p.sum(axis=0)                    # m(s_2..s_k)
    # q = p(s1..sk) · cond(s_{k+1} | s2..sk) with
    # cond = p(s2..s_{k+1}) / m(s2..sk) (p reinterpreted one slot up).
    # The guard branches on the REAL part so complex-step directional
    # derivatives (closure_defect) differentiate the branch-fixed
    # rational map — the one-sided tangent at zero-support boundaries.
    live = np.real(left)[..., None] > 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        cond = np.where(live, p / np.where(live, left[..., None], 1.0),
                        0.0)
    return p[..., None] * cond[None, ...]


def _fns(tag, cl_k, compiled_pair, device):
    if compiled_pair is not None:
        return compiled_pair
    from ..engine import build_dy_dt, dsl

    # build_dy_dt auto-selects the dense transfer-matrix engine — the
    # scalable path for the (cl_k+1)-sized flow (the gather-table
    # compile materialises GB-scale event tables at large states).
    size_a = dsl.get_problem(tag).size_a
    fn_k, _ = build_dy_dt(tag, cl_k, device=device)
    fn_k1, _ = build_dy_dt(tag, cl_k + 1, device=device)
    return fn_k, fn_k1, size_a


def _host(x):
    """An RHS result (a tensor on any device, or an array) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _norm(diff, norm):
    if norm == "rms":
        return float(np.sqrt((diff ** 2).mean()))
    if norm == "l1":
        return float(np.abs(diff).sum())
    if norm == "max":
        return float(np.abs(diff).max())
    raise ValueError(f"unknown norm {norm!r}")


def consistency_residual(tag: str, cl_k: int, p, *, compiled_pair=None,
                         norm: str = "max", device=None):
    """Cross-cl_k engine oracle: ``norm`` of
    marg(F_{k+1}(extend(p))) − F_k(p), which is ZERO up to float
    roundoff for a correctly compiled rule (module docstring, fact 1).
    ``compiled_pair`` is ``(fn_k, fn_k1, size_a)``; without it the RHS
    pair is built on ``device``.
    """
    fn_k, fn_k1, size_a = _fns(tag, cl_k, compiled_pair, device)
    p = np.asarray(p, dtype=np.float64).ravel()
    q = markov_extend(p, size_a, cl_k).ravel()
    dq = _host(fn_k1(q)).reshape((size_a,) * (cl_k + 1))
    return _norm(dq.sum(axis=-1).ravel() - _host(fn_k(p)).ravel(), norm)


def closure_defect(tag: str, cl_k: int, p, *, compiled_pair=None,
                   norm: str = "l1", device=None):
    """Local truncation-error source rate ν(p) of the cl_k closure
    (module docstring, fact 2): the component of the (k+1)-flow at
    extend(p) that leaves the extension manifold. The tangent motion
    D extend(p)[F_k(p)] is evaluated by COMPLEX-STEP differentiation
    of the extension (exact to machine precision, no subtractive
    cancellation) with the zero-support guard branches frozen at the
    real state — i.e. the one-sided tangent within the support
    (sparse machine states sit ON the guard boundary, where a real FD
    step could read branch jumps as defect; complex-step agrees with
    central FD away from boundaries and is exact on them).

    Integrate ν along a cl_k solve to estimate the accumulated
    k-marginal gap to the (never solved) cl_k+1 trajectory; measured
    factor ~2–3 conservative on ex2 (`examples/ex2_closure_error.py`).

    ν covers the DYNAMICAL closure error only. A cl_k+1 run may also
    differ because its initial state carries correlations the
    extension of the cl_k initial state cannot represent — measure
    that separately as ||p0_{k+1} − markov_extend(p0_k)||; on ex4 that
    term dominates (`probes/ex4_closure_budget.py`).
    """
    fn_k, fn_k1, size_a = _fns(tag, cl_k, compiled_pair, device)
    p = np.asarray(p, dtype=np.float64).ravel()
    v = _host(fn_k(p))
    eps = 1e-200
    dext = np.imag(
        markov_extend(p + 1j * eps * v, size_a, cl_k)).ravel() / eps
    f_up = _host(fn_k1(markov_extend(p, size_a, cl_k).ravel()))
    return _norm(f_up - dext, norm)


def integrate_defect(tag: str, cl_k: int, ts, ys, *, compiled_pair=None,
                     norm: str = "l1", device=None):
    """Defect meter along a solved trajectory: evaluates ν at each
    ``(ts[i], ys[i])`` sample and returns ``(nus, cumulative)`` with
    ``cumulative[i] = ∫₀^{t_i} ν dt`` (trapezoid) — the running closure
    error budget of the solve. One cl_k+1 RHS call per sample.
    """
    fns = _fns(tag, cl_k, compiled_pair, device)
    ts = np.asarray(ts, dtype=np.float64)
    ys = _host(ys)
    nus = np.array([
        closure_defect(tag, cl_k, ys[i], compiled_pair=fns, norm=norm)
        for i in range(len(ts))
    ])
    cumulative = np.concatenate([[0.0], np.cumsum(
        0.5 * (nus[1:] + nus[:-1]) * np.diff(ts))])
    return nus, cumulative
