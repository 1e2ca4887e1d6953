"""Parametric rate constants: the dense RHS as a function of a rule's
rate parameters, run forward.

Counterpart of the JAX package's `engine/parametric.py`. The multiverse's
structure (which cells each world reveals, which branch each choose
takes, the signatures and factor chains) does not depend on the
parameters' values, only the choose weights do. So the enumeration at
the defaults fixes each world's decisions, and replaying them with the
parameters as float64 tensors (`_TracedReplay` over the port's
`enumerate._Replay`) rebuilds the program's w_const as torch ops of the
parameters (`traced_consts`), so that the reverse-mode item can
differentiate it. Everything else is the dense program of
`dense.compile_dense`.

:class:`ParametricDense` gives ``dy_dt(p, w_const)``: K3 -> K5 with a
run-time w_const in place of the program's (dp/dt is linear in it, so
the sweep is the same: `dense.dense_rhs`), its J.v in p, K25 with the
same w_const (`dense.dense_jvp`), under `torch.func.jvp`, and its v^T J
in p and in w_const, K30 (`dense.dense_vjp`), under autograd, which
carries w_bar on through `traced_consts` to the parameters.
`rate_sensitivity` is the JAX package's: one ``consts(params)`` a solve,
passed through `ode/fixed.odeint_fixed`'s ``args``, and autograd back
through the solve's adjoint.

Validity domain, as in the JAX package: the parameters must keep every
enumerated branch's weight sign fixed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import config
from . import dense as dense_mod
from . import dsl
from .compile import collect_signatures
from .enumerate import _Replay, enumerate_worlds


class _TracedReplay(_Replay):
    """Replays one world's recorded decisions, the choose-weight product
    in torch ops of the parameters (clipped at 0 as the enumerator
    clips it)."""

    def __init__(self, problem, cl_k, decisions):
        super().__init__(problem, problem.size_a, cl_k, list(decisions))
        self.t_const = 1.0

    def choose(self, probs):
        k = self._decide(len(probs))
        w = probs[k]
        # torch.maximum's derivative at w = 0 splits as jnp.maximum's.
        w = (torch.maximum(w, torch.zeros((), dtype=w.dtype, device=w.device))
             if isinstance(w, torch.Tensor) else max(w, 0.0))
        self.t_const = self.t_const * w
        return k


def traced_consts(problem: dsl.Problem, cl_k: int, worlds, params):
    """[len(worlds)] float64 tensor of the worlds' choose-weight products
    under ``params`` (floats or 0-d float64 tensors), in world order; the
    derived-parameter transform runs once, not once a world."""
    params = {k: torch.as_tensor(v, dtype=torch.float64)
              for k, v in params.items()}
    params = problem.prepare_params(params)
    out = []
    for w in worlds:
        r = _TracedReplay(problem, cl_k, w.decisions)
        problem.call(dsl.Tape(r, problem.symbols), params, prepared=True)
        if r.values != list(w.decisions):
            raise RuntimeError(
                f"decision script mismatch replaying {problem.tag}: "
                "the rule is not replay-deterministic")
        out.append(torch.as_tensor(r.t_const, dtype=torch.float64))
    return torch.stack(out)


class ParametricDense:
    """``pd(p, params) -> dp/dt`` on ``device`` (``cuda`` unless named),
    with the factored form for solves: ``consts(params)`` (one weight
    vector a parameter set, hoisted out of the stages) and ``dy_dt(p,
    w_const)``, whose J.v in p `torch.func.jvp` takes (K25)."""

    def __init__(self, tag: str, cl_k: int, *, device=None):
        problem = dsl.get_problem(tag)
        if problem.params is None:
            raise ValueError(
                f"{tag!r} declares no parameters; register it with "
                "register_problem(..., params={...}) to use the "
                "parametric path")
        prog = dense_mod.compile_dense(tag, cl_k)
        worlds = enumerate_worlds(problem, cl_k)
        live = collect_signatures(worlds)[0]
        if len(live) != len(prog.w_const):
            raise RuntimeError(
                "live-world count mismatch vs compiled program "
                f"({len(live)} != {len(prog.w_const)})")
        base = traced_consts(problem, cl_k, live,
                             problem.param_defaults).numpy()
        if not np.allclose(base, prog.w_const, rtol=1e-12, atol=0):
            raise RuntimeError(
                f"parametric replay of {tag!r} disagrees with the "
                "compiled w_const at default parameters")
        self.problem = problem
        self.prog = prog
        self.cl_k = cl_k
        self.live = live
        self.dp = dense_mod.device_program(prog, device)
        self.device = self.dp.device

    def consts(self, params) -> torch.Tensor:
        """The worlds' weights under ``params`` on the device."""
        return traced_consts(self.problem, self.cl_k, self.live,
                             params).to(self.device)

    def dy_dt(self, p, w_const, out=None) -> torch.Tensor:
        """dp/dt at ``p`` with the worlds' weights ``w_const``: K3 -> K5
        on a card (into ``out`` where given), their plain versions on the
        CPU; under a transform `dense.RHSFunction`, whose J.v is K25
        with the same weights and whose v^T J (in p and in ``w_const``,
        under autograd) is K30."""
        dp = self.dp
        p = torch.as_tensor(p, dtype=torch.float64,
                            device=self.device).reshape(-1)
        if not isinstance(w_const, torch.Tensor):
            w_const = torch.as_tensor(np.asarray(w_const, np.float64))
        w = w_const.to(dtype=torch.float64, device=self.device)
        if not w.requires_grad:
            # Under a transform in p, a conversion wraps the tensor.
            w = dense_mod._unwrapped(w)
        return dense_mod.rhs_fn(dp, p, out, w)

    def __call__(self, p, params):
        return self.dy_dt(p, self.consts(params))


def make_parametric_dense(tag: str, cl_k: int, *, device=None):
    """``(pd, prog)``: a :class:`ParametricDense` and its compiled
    program; at the declared defaults ``pd(p, defaults)`` agrees with
    the baked `dense.make_dense_dy_dt` to float64 round-off."""
    pd = ParametricDense(tag, cl_k, device=config.get_device(device))
    return pd, pd.prog


def rate_sensitivity(tag: str, cl_k: int, p0, ts, observable,
                     params=None, n_sub: int = 8, *, device=None):
    """``(value, grads)`` of a scalar observable of the final state and
    its gradient in every declared rate parameter (a dict by name), as
    the JAX package's (:153): one ``consts(params)`` a solve, passed
    through `odeint_fixed`'s ``args``, and autograd back through the
    solve's adjoint (K30 at each stage) and `traced_consts`. ``params``
    defaults to the rule's declared defaults; ``device`` as
    `ParametricDense`'s."""
    from ..ode.fixed import odeint_fixed

    pd = ParametricDense(tag, cl_k, device=config.get_device(device))
    if params is None:
        params = pd.problem.param_defaults
    prm = {k: torch.tensor(float(v), dtype=torch.float64,
                           requires_grad=True) for k, v in params.items()}
    p0 = torch.as_tensor(np.asarray(p0, np.float64).reshape(-1)
                         if not isinstance(p0, torch.Tensor) else p0,
                         dtype=torch.float64, device=pd.device).reshape(-1)

    def rhs(y, t, w_const):
        return pd.dy_dt(y, w_const)

    with torch.enable_grad():
        ys = odeint_fixed(rhs, p0.detach(), ts, n_sub, args=pd.consts(prm))
        value = observable(ys[-1])
        grads = torch.autograd.grad(value, list(prm.values()),
                                    allow_unused=True)
    return value.detach(), {k: (torch.zeros((), dtype=torch.float64)
                                if g is None else g)
                            for k, g in zip(prm, grads)}
