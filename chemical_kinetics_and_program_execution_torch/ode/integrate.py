"""High-level ODE driver over an RHS on the device.

Counterpart of the JAX package's `ode/integrate.py:solve` with its
on-device ``"jax"`` backend, here ``"torch"``: the host-stepped DOP853
with dense output (`dop853.odeint_dop853_dense`), the state on
``device``. (`markov_tapes` keeps the reference's scipy solvers.)

Not ported yet: the ``dopri5`` stepper and the stiff ``kvaerno3`` (and
the scipy stiff names that map onto it), the step-clamped
``"dop853-step"``, chunked solves (``chunk_size``) and checkpoints
(``checkpoint_path``); they raise NotImplementedError naming ROADMAP
Queue 1 items 3 and 5.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import config
from .dop853 import odeint_dop853_dense

_UNPORTED = ("is not ported yet (ROADMAP Queue 1 items 3 and 5: chunking "
             "and checkpoints, dopri5 and kvaerno3)")
_NOT_PORTED = {"dopri5", "dop853-step", "kvaerno3", "lsoda", "radau",
               "bdf"}


def solve(fn_dy_dt, y0, ts, *, rtol=1e-9, atol=1e-9, method=None,
          max_steps=1_000_000, return_info=False, chunk_size=None,
          checkpoint_path=None, project=None, device=None):
    """Integrates ``dy/dt = fn(y, t)`` sampling at ``ts``.

    Returns a numpy array ``[len(ts), n]`` like ``scipy.integrate.odeint``.
    ``fn(y, t)`` takes and returns float64 tensors on ``device``
    (``cuda`` unless named); a ``fn`` marked ``takes_out`` also takes
    ``out=`` and writes dp/dt into the solver's stage row (see
    `dop853.odeint_dop853_dense`). By default tight tolerances (< 1e-9)
    route to DOP853 (``method`` "dop853" or "DOP853"; other scipy names
    such as "RK45" land there too, as in the JAX package), looser ones to
    dopri5, which is not ported.

    ``project`` maps sampled states ``[m, n]`` (a tensor on the device)
    to observables ``[m, n_obs]``; it is applied on the device as the
    samples are made, so the full state never leaves it, and the result
    is ``[len(ts), n_obs]``; with ``return_info`` the final state rides
    in ``info["y_final"]``. ``info`` also counts accepted and rejected
    steps, RHS calls and the accepted steps that hold samples
    (``num_sampled``: one `dense_eval` launch each on a card).
    """
    if chunk_size is not None:
        raise NotImplementedError(f"chunk_size {_UNPORTED}")
    if checkpoint_path is not None:
        raise NotImplementedError(f"checkpoint_path {_UNPORTED}")
    ts = np.asarray(ts, dtype=np.float64)
    name = (method or "").lower()
    if not name:
        name = "dop853" if min(rtol, atol) < 1e-9 else "dopri5"
    if name in _NOT_PORTED:
        raise NotImplementedError(f"method {name!r} {_UNPORTED}")
    dev = config.get_device(device)
    y0 = torch.as_tensor(np.asarray(y0, dtype=np.float64).ravel(),
                         device=dev)
    sample_fn = project or (lambda s: s)
    if len(ts) < 2:
        out = sample_fn(y0[None])
        info = {"num_accepted": 0, "num_rejected": 0, "num_rhs": 0,
                "num_sampled": 0, "completed": True}
    else:
        out, stats = odeint_dop853_dense(fn_dy_dt, y0, ts, (rtol, atol),
                                         max_steps=max_steps,
                                         sample_fn=sample_fn)
        if not stats.completed:
            raise RuntimeError(
                f"ODE solve did not complete within max_steps={max_steps} "
                f"(accepted={stats.num_accepted}, "
                f"rejected={stats.num_rejected}).")
        info = {"num_accepted": stats.num_accepted,
                "num_rejected": stats.num_rejected,
                "num_rhs": stats.num_rhs, "num_sampled": stats.num_sampled,
                "completed": True}
        y0 = stats.y_final
    ys = out.detach().cpu().numpy()
    if project is not None:
        info["y_final"] = y0.cpu().numpy()
    return (ys, info) if return_info else ys
