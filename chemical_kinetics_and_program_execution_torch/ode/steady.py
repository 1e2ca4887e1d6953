"""Direct steady states: pseudo-transient Newton-Krylov on dp/dt = 0,
and the slowest relaxation modes there.

Counterpart of the JAX package's `ode/steady.py`, forward only. The
augmented system (its module docstring gives the why) is

    G(p) = F(p) - L(p) + 1/S + sum_j c_j (c_j^T p_guess),
    L(x) = C^T(C x) + (sum x)/S + sum_j c_j (c_j^T x),

C the consistency defect, c_j the lifted conserved functionals, so that
J_G v = J v - L(v): the J.v is forward mode through the RHS
(`krylov.jvp`; kernel K25 for the port's dense RHS), L is kernel K26 (`steady_aug`,
`csrc/steady_aug.cu`: one launch that forms x's levels itself in one
block up to 10,000 entries, else two after K3 on x) with
its plain version `steady_aug_plain`; K26 also takes the callers'
arithmetic (F - L + constant, J v - L), so a G or a J_G v is the RHS or
J v and one K26 call. In support mode (``conserved="support"``) dead
windows are pinned to 0, L keeps its C^T C x term and adds W^T W x, a
plain product, and K26 applies the mask.

`make_steady_state`'s solve is the PTC loop of the JAX package's
`:330-402` driven from the host: GMRES (`ode/krylov.py`) on ``(I - delta
J_G) dp = delta G``, a non-finite step made no step, backtracking (at
most 30 halvings) until the residual's rms falls, the switched-evolution
relaxation of delta, and a host read of the residual and the accept
flag each trial. The returned solve is a `torch.autograd.Function` whose
backward is the JAX package's implicit gradient (`:404-448`): u solves
J_G(p_inf)^T u = g by GMRES at ``gmres_tol_bwd``, each matvec the RHS's
v^T J at p_inf by autograd (K30 for the port's dense RHS) less L(u),
K26 unchanged (L is symmetric), masked in support mode with u kept off
the support (`Augmentation.vjp`); then args_bar = -(dF/dargs)^T u and
p_guess_bar = -embed(vals(u)) where there are conserved values.
`relaxation_modes` runs shift-invert
Arnoldi on the host, one GMRES solve a step, the eigenproblem in numpy;
`detect_support_invariants` and `detect_conserved_marginals` probe the
RHS at states drawn from numpy's ``default_rng(0)``, as the JAX package
does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda
from ..engine.dense import (
    _digit_sum_first,
    pyramid,
    pyramid_plain,
)
from ..utils import config
from ..utils.autodiff import first_order_only, flatten_args
from .krylov import gmres, jvp


class SteadyInfo(NamedTuple):
    converged: bool  # residual tolerance met
    iterations: int  # PTC iterations taken
    residual: float  # final rms of the augmented residual
    matvecs: int = 0  # J_G v products in the Krylov solves
    residuals: int = 0  # evaluations of G (the line search's and the first)


def _rms(x: torch.Tensor) -> float:
    return math.sqrt(float(torch.mean(x * x)))


def _probe(fn, p: np.ndarray, args, device) -> np.ndarray:
    return np.asarray(
        fn(torch.as_tensor(p, dtype=torch.float64, device=device),
           args).detach().cpu(), dtype=np.float64)


def detect_support_invariants(fn, size_a: int, cl_k: int, guess,
                              args=None, floor: float = 1e-20,
                              n_extra: int = 40, rel_tol: float = 1e-10,
                              *, device=None):
    """``(mask [S] bool, W [n_c, S])``: the guess's live support and every
    linear functional the dynamics restricted to it conserve: the left
    null space of F probed at ``len(live) + n_extra`` random support
    states (`default_rng(0)`), as the JAX package's."""
    device = config.get_device(device)
    S = size_a ** cl_k
    guess = np.asarray(guess, np.float64).reshape(-1)
    mask = guess > floor
    live = np.flatnonzero(mask)
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(len(live) + n_extra):
        p = np.zeros(S)
        p[live] = rng.random(len(live))
        p /= p.sum()
        rows.append(_probe(fn, p, args, device)[live])
    _, s, Vt = np.linalg.svd(np.asarray(rows))
    null = Vt[np.concatenate([s, np.zeros(max(0, len(live) - len(s)))])
              < rel_tol * max(float(s.max()), 1e-30)]
    W = np.zeros((null.shape[0], S))
    W[:, live] = null
    return mask, W


def detect_conserved_marginals(fn, size_a: int, cl_k: int, args=None,
                               n_probes: int | None = None,
                               rel_tol: float = 1e-10, *, device=None):
    """[n_c, size_a] orthonormal weights w with d/dt (sum_s w(s)
    marginal(s)) = 0: the null space of d(marginal)/dt probed at random
    SPDs (`default_rng(0)`), the total direction projected out, as the
    JAX package's."""
    device = config.get_device(device)
    n_probes = max(n_probes or 0, size_a + 6)
    rng = np.random.default_rng(0)
    S = size_a ** cl_k
    rows = []
    for _ in range(n_probes):
        p = rng.random(S)
        p /= p.sum()
        try:
            f = _probe(fn, p, args, device)
        except Exception as e:
            raise ValueError(
                "conserved-functional probing called the RHS with "
                f"args={args!r} and failed ({e!r}); pass probe_args "
                "(e.g. a ParametricDense consts vector at defaults) "
                "or conserved=None") from e
        rows.append(f.reshape((size_a,) * cl_k)
                    .sum(axis=tuple(range(1, cl_k))))
    R = np.asarray(rows)
    _, s, Vt = np.linalg.svd(R)
    null = Vt[np.concatenate([s, np.zeros(max(0, size_a - len(s)))])
              < rel_tol * max(float(s.max()), 1e-30)]
    if null.size == 0:
        return np.zeros((0, size_a))
    ones = np.ones(size_a) / np.sqrt(size_a)
    null = null - np.outer(null @ ones, ones)
    q, r = np.linalg.qr(null.T)
    keep = np.abs(np.diag(r)) > 1e-8
    return q.T[keep]


# --- K26: the augmentation's linear map -------------------------------------

_FULL, _CTC = 0, 1  # modes of `steady_aug`
_SMEM_DOUBLES = 232_448 // 8  # a block's shared memory (227 KB), doubles
AUG_FORMS = ("split", "block")  # `csrc/steady_aug.cu:kForm*`
# The block form's most entries: `time_beam_aug.py` on an H100 80GB HBM3
# at 700 W timed it faster than the split form at 10^4 (10.1 us against
# 12.8) and slower at 4^7 = 16,384 (15.2 against 13.7).
AUG_BLOCK_MOST = 10_000


def block_doubles(a: int, k: int) -> int:
    """Doubles of shared memory K26's block form takes at x [a^k]
    (`csrc/steady_aug.cu:block_doubles`): x, its levels k-1 .. 0, the
    defects, emb and lv[0] / S."""
    n = a**k
    return n + (n - 1) // (a - 1) + n // a + a + 1


def aug_forms(a: int, k: int) -> list:
    """Every launch form K26 can take at x [a^k]: the split form, and
    the block where x and its levels fit its shared memory."""
    return ["split"] + (["block"] if block_doubles(a, k) <= _SMEM_DOUBLES
                        else [])


def aug_form(a: int, k: int) -> str:
    """K26's form for x [a^k]: one block where it fits and x has at most
    `AUG_BLOCK_MOST` entries, else the split form."""
    return aug_forms(a, k)[-1] if a**k <= AUG_BLOCK_MOST else "split"


def _map_plain(x, a, k, cons_w, c_norm, mode):
    n = a**k
    tail = n // a
    low = pyramid_plain(x, a, k)
    below = low.numel() - 1
    defect = _digit_sum_first(x, a) - low[:tail]
    i = torch.arange(n, device=x.device)
    out = defect[i % tail] - defect[i // a]
    if mode == _CTC:
        return out

    def div(t, d):
        return t / torch.tensor(d, dtype=torch.float64, device=x.device)

    m1 = low[below - 1 - a:below - 1]
    emb = torch.zeros(a, dtype=torch.float64, device=x.device)
    for j in range(cons_w.shape[0]):
        val = torch.zeros((), dtype=torch.float64, device=x.device)
        for q in range(a):
            val = val + cons_w[j, q] * m1[q]
        emb = emb + cons_w[j] * div(val, c_norm)
    emb = div(emb, c_norm)
    return (out + div(low[below - 1], n)) + emb[i // tail]


def steady_aug_plain(x: torch.Tensor, a: int, k: int, cons_w: torch.Tensor,
                     c_norm: float, mode: int = _FULL, *, f=None,
                     const=None, ww=None, mask=None,
                     keep=None) -> torch.Tensor:
    """Plain version of K26: L(x) = C^T C x + (sum x)/S + sum_j c_j (c_j^T
    x) (``mode`` 0), or C^T C x alone (``mode`` 1), each sum in K26's
    order (`csrc/steady_aug.cu`): the levels of x as K3's plain version
    forms them, the leading-digit sums in digit order, the conserved
    values and their embedding summed from 0 in index order, every
    division by a 0-d tensor (a CUDA tensor divided by a Python number
    is multiplied by its reciprocal). Then the callers' arithmetic, as
    they compose it, each step where its input is given: L + ``ww``,
    ``f`` - L, + ``const``, ``torch.where(mask, ., keep)``."""
    steady_aug_plain.calls += 1
    out = _map_plain(x.reshape(-1), a, k, cons_w, c_norm, mode)
    if ww is not None:
        out = out + ww
    if f is not None:
        out = f - out
    if const is not None:
        out = out + const
    if mask is not None:
        out = torch.where(mask, out, keep)
    return out


steady_aug_plain.calls = 0


def _vector(t, n, device, name):
    if t is None:
        return None
    t = t.reshape(-1).to(device=device, dtype=torch.float64).contiguous()
    if t.numel() != n:
        raise TypeError(f"{name} must have {n} entries")
    return t


def steady_aug(x: torch.Tensor, a: int, k: int, cons_w: torch.Tensor,
               c_norm: float, mode: int = _FULL, *, f=None, const=None,
               ww=None, mask=None, keep=None,
               bufs: dict | None = None) -> torch.Tensor:
    """K26: L(x) (see `steady_aug_plain`) for a float64 x [a^k], with
    ``cons_w`` [n_c, a] on x's device, and the callers' arithmetic on it
    where its inputs are given (``mask`` bool [a^k] with ``keep``). On a
    card one C call in the form `aug_form` picks: one launch in the block
    form; K3, then two launches in the split form, whose
    levels and defects go to ``bufs`` (a dict the caller keeps between
    calls; new buffers when None). On the CPU the plain version."""
    if not cuda.on_card(x, "steady_aug"):
        return steady_aug_plain(x, a, k, cons_w, c_norm, mode, f=f,
                                const=const, ww=ww, mask=mask, keep=keep)
    n = a**k
    x = x.reshape(-1)
    if x.dtype != torch.float64 or x.numel() != n:
        raise TypeError(f"x must be a float64 [{n}] tensor")
    if (mask is None) != (keep is None):
        raise TypeError("mask and keep go together")
    dev = x.device
    x = x.contiguous()
    w = cons_w.to(device=dev, dtype=torch.float64).contiguous()
    f, const, ww, keep = (_vector(t, n, dev, name) for t, name in
                          ((f, "f"), (const, "const"), (ww, "ww"),
                           (keep, "keep")))
    if mask is not None:
        mask = mask.reshape(-1).to(device=dev, dtype=torch.bool).contiguous()
        if mask.numel() != n:
            raise TypeError(f"mask must have {n} entries")
    form = aug_form(a, k)
    low = scratch = None
    if form == "split":
        bufs = {} if bufs is None else bufs
        if bufs.get("n") != (n, dev):
            bufs["n"] = (n, dev)
            bufs["low"] = pyramid(x, a, k)
            bufs["scratch"] = torch.empty(n // a + a + 1,
                                          dtype=torch.float64, device=dev)
        else:
            pyramid(x, a, k, out=bufs["low"])
        low, scratch = bufs["low"], bufs["scratch"]
    out = torch.empty_like(x)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = cuda.load()
    with torch.cuda.device(dev):
        rc = lib.ckpe_steady_aug(
            x.data_ptr(), a, k, w.data_ptr(), w.shape[0], float(c_norm),
            mode, ptr(f), ptr(const), ptr(ww), ptr(mask), ptr(keep),
            AUG_FORMS.index(form), ptr(low), ptr(scratch), out.data_ptr(),
            cuda.stream(x))
    cuda.check(rc, "steady_aug", lib)
    steady_aug.launches += 1
    return out


steady_aug.launches = 0


# --- The augmented system -----------------------------------------------------


class Augmentation:
    """The invariant-manifold augmentation of ``fn(p, args)`` (the JAX
    package's `_build_augmentation`): ``residual(p, args, const)`` is
    G(p) with ``const = constant(targets(p_guess))``, ``jvp(p, v, args)``
    J_G v, ``targets(p_guess)`` the conserved values the guess selects;
    ``mask`` the live support in support mode (None otherwise),
    ``cons_w`` the conserved weights [n_c, a] (or support mode's W [n_c,
    S])."""

    def __init__(self, fn, size_a, cl_k, conserved, probe_args,
                 support_guess, support_floor, device):
        self.fn, self.a, self.k = fn, size_a, cl_k
        self.device = device
        self.mask = None
        self._bufs = {}  # K26's split-form buffers, kept between calls
        self.support = isinstance(conserved, str) and conserved == "support"
        f64 = torch.float64
        if size_a is None:
            self.cons_w = torch.zeros((0, 0), dtype=f64, device=device)
            return
        if self.support:
            if support_guess is None:
                raise ValueError(
                    "conserved='support' needs support_guess (a concrete "
                    "state whose live windows define the invariant set)")
            mask, W = detect_support_invariants(
                fn, size_a, cl_k, support_guess, probe_args,
                floor=support_floor, device=device)
            self.mask = torch.as_tensor(mask, device=device)
            self.cons_w = torch.as_tensor(W, dtype=f64, device=device)
            return
        if isinstance(conserved, str) and conserved == "auto":
            w = detect_conserved_marginals(fn, size_a, cl_k, probe_args,
                                           device=device)
        elif conserved is None:
            w = np.zeros((0, size_a))
        else:
            w = np.asarray(conserved, np.float64)
            ones = np.ones(size_a) / np.sqrt(size_a)
            w = w - np.outer(w @ ones, ones)
            q, r = np.linalg.qr(w.T)
            w = q.T[np.abs(np.diag(r)) > 1e-8]
        self.cons_w = torch.as_tensor(w, dtype=f64, device=device)
        self.c_norm = float(size_a) ** ((cl_k - 1) / 2.0)

    @property
    def has_conserved(self) -> bool:
        return self.a is not None and self.cons_w.shape[0] > 0

    def _aug(self, x, f=None, const=None, keep=None):
        """One K26 call: L(x), or ``f`` - L(x) (+ ``const``), and in
        support mode L(x) = C^T C x + W^T W x (a library product first)
        with ``keep`` off the support."""
        if self.support:  # K26's mode 1 reads no weights
            return steady_aug(
                x, self.a, self.k, self.cons_w[:0, :self.a], 1.0, _CTC, f=f,
                const=const, ww=self.cons_w.T @ (self.cons_w @ x),
                mask=None if keep is None else self.mask, keep=keep,
                bufs=self._bufs)
        return steady_aug(x, self.a, self.k, self.cons_w, self.c_norm, f=f,
                          const=const, bufs=self._bufs)

    def linear(self, x: torch.Tensor) -> torch.Tensor:
        """L(x): K26, and in support mode W^T W x besides."""
        return self._aug(x)

    def cons_vals(self, p: torch.Tensor) -> torch.Tensor:
        if self.support:
            return self.cons_w @ p
        m1 = p.reshape((self.a,) * self.k).sum(dim=tuple(range(1, self.k)))
        return (self.cons_w @ m1) / self.c_norm

    def cons_embed(self, vals: torch.Tensor) -> torch.Tensor:
        if self.support:
            return self.cons_w.T @ vals
        w = (self.cons_w.T @ vals) / self.c_norm
        return w.reshape((self.a,) + (1,) * (self.k - 1)).expand(
            (self.a,) * self.k).reshape(-1)

    def targets(self, p_guess: torch.Tensor) -> torch.Tensor:
        if self.a is None:
            return p_guess.new_zeros(0)
        if self.support:
            p_guess = torch.where(self.mask, p_guess, 0.0)
        return self.cons_vals(p_guess)

    def constant(self, targets: torch.Tensor) -> torch.Tensor:
        """G's constant: 1/S (not in support mode) plus the embedded
        targets; None without the augmentation."""
        if self.a is None:
            return None
        c = self.cons_embed(targets)
        if not self.support:
            c = c + 1.0 / self.a**self.k
        return c

    def residual(self, p, args, const):
        """G(p) = F(p) - L(p) + ``const`` (`constant`); in support mode at
        the masked p and p itself off the support."""
        if self.a is None:
            return self.fn(p, args)
        if self.mask is None:
            return self._aug(p, self.fn(p, args), const)
        pm = torch.where(self.mask, p, 0.0)
        return self._aug(pm, self.fn(pm, args), const, keep=p)

    def jvp(self, p, v, args):
        """J_G v = J v - L(v) (masked in support mode)."""
        if self.mask is not None:
            p = torch.where(self.mask, p, 0.0)
            vm = torch.where(self.mask, v, 0.0)
        else:
            vm = v
        jv = jvp(lambda q: self.fn(q, args), p, vm)
        if self.a is None:
            return jv
        return self._aug(vm, jv, keep=None if self.mask is None else v)

    def vjp(self, p, u, args):
        """J_G^T u = J^T u - L(u), L being symmetric (masked in support
        mode: J^T and L at the masked u, u itself off the support), J^T u
        the RHS's v^T J at p by autograd."""
        um = u if self.mask is None else torch.where(self.mask, u, 0.0)
        q = p.detach().requires_grad_(True)
        with torch.enable_grad():
            (ju,) = torch.autograd.grad(self.fn(q, args), q, um)
        if self.a is None:
            return ju
        return self._aug(um, ju, keep=None if self.mask is None else u)


def make_steady_state(fn, *, size_a: int | None = None,
                      cl_k: int | None = None,
                      conserved="auto", probe_args=None,
                      support_guess=None, support_floor: float = 1e-20,
                      tol: float = 1e-12, max_iter: int = 200,
                      delta0: float = 1.0, delta_max: float = 1e14,
                      delta_min: float = 1e-10,
                      gmres_tol: float = 1e-8, gmres_restart: int = 50,
                      gmres_maxiter: int = 8,
                      gmres_tol_bwd: float = 1e-13, device=None):
    """Builds ``solve(p_guess, args) -> (p_inf, SteadyInfo)`` for ``dp/dt
    = fn(p, args)`` on ``device`` (``cuda`` unless named), with the JAX
    package's parameters and semantics (its docstring): ``size_a`` and
    ``cl_k`` enable the augmentation, ``conserved`` is "auto", "support",
    an explicit [n_c, size_a] weight matrix or None, convergence is the
    rms of G at most ``tol``. ``fn`` must take forward-mode duals (the
    port's dense RHS does: K25). ``p_inf`` is a float64 tensor on the
    device; ``info.matvecs`` counts the J_G v products, ``info.residuals``
    the evaluations of G (each an RHS and an L). ``solve`` is
    differentiable by autograd in ``p_guess`` and in ``args`` (a tensor,
    or a tuple, list or dict of tensors) by the implicit gradient (module
    docstring), its transposed system solved to ``gmres_tol_bwd``; ``fn``
    must then take autograd's backward in p and in args (the port's dense
    RHS does: K30)."""
    if (size_a is None) != (cl_k is None):
        raise ValueError("pass size_a and cl_k together (or neither)")
    device = config.get_device(device)
    aug = Augmentation(fn, size_a, cl_k, conserved, probe_args,
                       support_guess, support_floor, device)

    def ptc(p0, args):
        p = p0.to(torch.float64).reshape(-1).clone()
        const = aug.constant(aug.targets(p))
        g = aug.residual(p, args, const)
        gn = _rms(g)
        delta, it, matvecs, residuals = float(delta0), 0, 0, 1
        done = gn <= tol
        while not done and delta >= delta_min and it < max_iter:

            def matvec(v, p=p, delta=delta):
                return v - delta * aug.jvp(p, v, args)

            dp, count = gmres(matvec, delta * g, tol=gmres_tol, atol=0.0,
                              restart=gmres_restart, maxiter=gmres_maxiter)
            matvecs += count
            # A NaN step (GMRES's happy breakdown) is no step: the reject
            # branch cuts delta.
            dp = torch.where(torch.isfinite(dp), dp, 0.0)
            alpha, accept, g_cand, new_n = 1.0, False, g, gn
            for _ in range(30):
                g_cand = aug.residual(p + alpha * dp, args, const)
                residuals += 1
                new_n = _rms(g_cand)
                accept = math.isfinite(new_n) and new_n < gn
                if accept:
                    break
                alpha *= 0.5
            grow = min(max(gn / max(new_n, 1e-300), 1.0), 1e3)
            if accept:
                p = p + alpha * dp
                g, gn = g_cand, new_n
                delta = min(delta * grow, delta_max)
            else:
                delta *= 0.25
            it += 1
            done = gn <= tol
        if aug.mask is not None:
            p = torch.where(aug.mask, p, 0.0)
        return p, SteadyInfo(converged=gn <= tol, iterations=it,
                             residual=gn, matvecs=matvecs,
                             residuals=residuals)

    def implicit_grad(p_inf, g, args, leaf_args, leaves):
        """(p_guess_bar, the cotangents of ``leaves``, which ``leaf_args``
        holds where ``args`` holds their values): the JAX package's
        solve_bwd (`:413-446`)."""
        u, _ = gmres(lambda v: aug.vjp(p_inf, v, args), g,
                     tol=gmres_tol_bwd, atol=0.0, restart=gmres_restart,
                     maxiter=gmres_maxiter)
        u = torch.where(torch.isfinite(u), u, 0.0)
        leaf_bar = []
        if leaves:
            with torch.enable_grad():
                leaf_bar = torch.autograd.grad(fn(p_inf, leaf_args), leaves,
                                               u, allow_unused=True)
            leaf_bar = [None if x is None else -x for x in leaf_bar]
        if aug.has_conserved:
            p_bar = -aug.cons_embed(aug.cons_vals(u))
            if aug.mask is not None:
                p_bar = torch.where(aug.mask, p_bar, 0.0)
        else:
            p_bar = torch.zeros_like(p_inf)
        return p_bar, leaf_bar

    class _Solve(torch.autograd.Function):
        """``apply(p_inf, p_guess, rebuild, *arg_tensors)``: the solve's
        result, found before (the PTC loop takes forward-mode duals, which
        a Function's forward does not carry), as a function of p_guess
        and the args, its backward the implicit gradient."""

        @staticmethod
        def forward(p_inf, p_guess, rebuild, *arg_tensors):
            return p_inf.clone()

        @staticmethod
        def setup_context(ctx, inputs, output):
            _, _, rebuild, *arg_tensors = inputs
            ctx.save_for_backward(output, *arg_tensors)
            ctx.rebuild = rebuild

        @staticmethod
        def backward(ctx, g, _g_info=None):
            p_inf, *arg_tensors = ctx.saved_tensors
            need = ctx.needs_input_grad[3:]
            leaves = [x.detach().requires_grad_(True) if want else x.detach()
                      for x, want in zip(arg_tensors, need)]
            p_bar, leaf_bar = implicit_grad(
                p_inf.detach(), g.detach(),
                ctx.rebuild([x.detach() for x in arg_tensors]),
                ctx.rebuild(leaves),
                [x for x, want in zip(leaves, need) if want])
            # Under create_graph the cotangents carry no graph of their
            # own (GMRES over graph-free v^T J products formed them): a
            # second derivative through them raises.
            what, anchors = "the steady state's solve", (p_inf, g,
                                                          *arg_tensors)
            it = iter(leaf_bar)
            return ((None, first_order_only(p_bar, what, *anchors)
                     if ctx.needs_input_grad[1] else None, None)
                    + tuple(first_order_only(next(it), what, *anchors)
                            if want else None for want in need))

    def solve(p_guess, args=None):
        p_guess = torch.as_tensor(p_guess, dtype=torch.float64,
                                  device=device).reshape(-1)
        tensors, rebuild = flatten_args(args)
        if p_guess.requires_grad or any(x.requires_grad for x in tensors):
            p_inf, info = ptc(p_guess.detach(),
                              rebuild([x.detach() for x in tensors]))
            return _Solve.apply(p_inf, p_guess, rebuild, *tensors), info
        return ptc(p_guess, args)

    solve.augmentation = aug
    return solve


def steady_state(tag: str, cl_k: int, p_guess, *, warm_t: float = 0.0,
                 n_sub: int = 64, device=None, **kwargs):
    """Steady state of a registered problem's exact dense dynamics (the
    JAX package's convenience wrapper): ``warm_t > 0`` first integrates
    the guess forward that long on the fixed grid (`ode/fixed.py`,
    ``n_sub`` RK5 substeps); the warmed guess sets the conserved targets
    and, in support mode, the support. Returns ``(p_inf, info)``."""
    from ..engine import build_dy_dt
    from ..engine.dsl import get_problem
    from .fixed import odeint_fixed

    device = config.get_device(device)
    dfn, _ = build_dy_dt(tag, cl_k, device=device)
    p_guess = torch.as_tensor(np.asarray(p_guess, np.float64).reshape(-1)
                              if not isinstance(p_guess, torch.Tensor)
                              else p_guess, dtype=torch.float64,
                              device=device).reshape(-1)
    if warm_t > 0.0:
        p_guess = odeint_fixed(lambda y, t: dfn(y), p_guess, [0.0, warm_t],
                               n_sub=n_sub)[-1]
    if (kwargs.get("conserved") == "support"
            and "support_guess" not in kwargs):
        kwargs["support_guess"] = np.maximum(p_guess.cpu().numpy(), 0.0)
    solve = make_steady_state(lambda p, _a: dfn(p),
                              size_a=get_problem(tag).size_a, cl_k=cl_k,
                              device=device, **kwargs)
    return solve(p_guess, None)


def relaxation_modes(fn, p_inf, args=None, *, size_a: int, cl_k: int,
                     n_modes: int = 6, krylov_m: int = 40,
                     conserved="auto", probe_args=None,
                     support_guess=None, support_floor: float = 1e-20,
                     gmres_tol: float = 1e-11, gmres_restart: int = 60,
                     gmres_maxiter: int = 8, device=None):
    """Slowest relaxation modes at a steady state (the JAX package's):
    shift-invert Arnoldi on J_G, each step one GMRES solve on J_G v
    products, the m x m Hessenberg eigenproblem in numpy, the start
    vector from `default_rng(0)`. Returns ``(eigenvalues, residuals)``
    sorted slowest first, up to ``n_modes`` entries."""
    device = config.get_device(device)
    p_inf = torch.as_tensor(p_inf, dtype=torch.float64,
                            device=device).reshape(-1)
    aug = Augmentation(fn, size_a, cl_k, conserved, probe_args,
                       support_guess, support_floor, device)

    def matvec(v):
        return aug.jvp(p_inf, v, args)

    def inv_apply(v):
        x, _ = gmres(matvec, v, tol=gmres_tol, atol=0.0,
                     restart=gmres_restart, maxiter=gmres_maxiter)
        return torch.where(torch.isfinite(x), x, 0.0)

    S = p_inf.shape[0]
    rng = np.random.default_rng(0)
    v = rng.standard_normal(S)
    if aug.mask is not None:
        v = np.where(aug.mask.cpu().numpy(), v, 0.0)
    v /= np.linalg.norm(v)
    V = [torch.as_tensor(v, device=device)]
    H = np.zeros((krylov_m + 1, krylov_m))
    for j in range(krylov_m):
        w = inv_apply(V[j])
        for _ in range(2):  # modified Gram-Schmidt, one re-pass
            for i in range(j + 1):
                h = float(torch.dot(V[i], w))
                H[i, j] += h
                w = w - h * V[i]
        nrm = float(torch.linalg.norm(w))
        H[j + 1, j] = nrm
        if nrm < 1e-13:  # invariant subspace found
            H = H[: j + 2, : j + 1]
            break
        V.append(w / nrm)
    m = H.shape[1]
    mu, Y = np.linalg.eig(H[:m, :m])
    order = np.argsort(-np.abs(mu))
    Vh = [x.cpu().numpy() for x in V]
    lams, resids = [], []
    for idx in order[:n_modes]:
        lam = 1.0 / mu[idx]
        vec = sum(complex(c) * Vh[i] for i, c in enumerate(Y[:, idx]))
        vec /= np.linalg.norm(vec)
        jv = (matvec(torch.as_tensor(vec.real, device=device)).cpu().numpy()
              + 1j * matvec(torch.as_tensor(vec.imag,
                                            device=device)).cpu().numpy())
        resids.append(float(np.linalg.norm(jv - lam * vec)
                            / max(abs(lam), 1e-300)))
        lams.append(lam)
    return np.asarray(lams), np.asarray(resids)
