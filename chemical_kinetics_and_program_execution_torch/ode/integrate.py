"""High-level ODE driver over an RHS on the device.

Counterpart of the JAX package's `ode/integrate.py:solve` with its
on-device ``"jax"`` backend, here ``"torch"``: the host-stepped steppers
(`dopri5.odeint_dopri5`, `dop853.odeint_dop853_dense`, the step-clamped
`dop853.odeint_dop853`, the stiff `kvaerno3.odeint_kvaerno3`), the state
on ``device``, in one stepper call or in chunks, with checkpoints.
(`markov_tapes` keeps the reference's scipy solvers.)
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

from ..utils import config
from .dop853 import odeint_dop853, odeint_dop853_dense
from .dopri5 import odeint_dopri5
from .kvaerno3 import odeint_kvaerno3

# The JAX package's steppers by name (`ode/integrate.py:30-38`): "dop853"
# is the dense-output stepper, "dop853-step" clamps its steps to the
# sample times, and the scipy stiff names route to the stiff stepper.
# Looked up in globals() at each call, as there, so tests can monkeypatch
# a stepper.
_STEPPERS = {"dopri5": "odeint_dopri5", "dop853": "odeint_dop853_dense",
             "dop853-step": "odeint_dop853",
             "kvaerno3": "odeint_kvaerno3", "lsoda": "odeint_kvaerno3",
             "radau": "odeint_kvaerno3", "bdf": "odeint_kvaerno3"}


class _Checkpoint:
    """A chunked solve's checkpoint: the rows in an ``.npy`` memmap at
    ``path``, a JSON sidecar (``.meta.json``: a key of the solve, the
    next sample, the step counts) and, with a projection, the full state
    at the last finished chunk (``.y.npy``, checked by its sha1). Each
    file is replaced whole, the meta last."""

    def __init__(self, path, key, n_out, width, projected):
        self.path, self.key, self.projected = path, key, projected
        self.meta_path = path + ".meta.json"
        self.y_path = path + ".y.npy"
        self.mm, self.resume = None, None
        if os.path.exists(path) and os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                meta = json.load(f)
            y = None
            if (meta.get("key") == key and projected
                    and os.path.exists(self.y_path)):
                cand = np.load(self.y_path)
                if (meta.get("y_next") == meta.get("next")
                        and hashlib.sha1(cand.tobytes()).hexdigest()
                        == meta.get("y_sha1")):
                    y = cand
            if meta.get("key") == key and (not projected or y is not None):
                self.mm = np.lib.format.open_memmap(path, mode="r+")
                start = int(meta["next"])
                self.resume = (start, int(meta.get("num_accepted", 0)),
                               int(meta.get("num_rejected", 0)),
                               y if projected else np.array(
                                   self.mm[start - 1]))
        if self.mm is None:
            self.mm = np.lib.format.open_memmap(
                path, mode="w+", dtype=np.float64, shape=(n_out, width))

    def write(self, start, stop, rows, acc, rej, y):
        self.mm[start:stop] = rows
        self.mm.flush()
        meta = {"key": self.key, "next": stop, "num_accepted": acc,
                "num_rejected": rej}
        if self.projected:
            y_host = y.cpu().numpy()
            meta["y_next"] = stop
            meta["y_sha1"] = hashlib.sha1(y_host.tobytes()).hexdigest()
            np.save(self.y_path + ".tmp", y_host)
            os.replace(self.y_path + ".tmp.npy", self.y_path)
        with open(self.meta_path + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(self.meta_path + ".tmp", self.meta_path)

    def finish(self):
        ys = np.array(self.mm)
        del self.mm
        for path in (self.path, self.meta_path, self.y_path):
            if os.path.exists(path):
                os.remove(path)
        return ys


def solve(fn_dy_dt, y0, ts, *, rtol=1e-9, atol=1e-9, backend=None,
          method=None, max_steps=1_000_000, return_info=False,
          chunk_size=None, progress=False, checkpoint_path=None,
          project=None, device=None):
    """Integrates ``dy/dt = fn(y, t)`` sampling at ``ts``.

    Returns a numpy array ``[len(ts), n]`` like ``scipy.integrate.odeint``.
    ``fn(y, t)`` takes and returns float64 tensors on ``device``
    (``cuda`` unless named); a ``fn`` marked ``takes_out`` also takes
    ``out=`` and writes dp/dt into the solver's stage row (see
    `dop853.odeint_dop853_dense`). By default tight tolerances (< 1e-9)
    route to DOP853 (``method`` "dop853" or "DOP853"; other scipy names
    such as "RK45" land there too, as in the JAX package), looser ones to
    dopri5 (``method`` "dopri5"); "dop853-step" is the step-clamped
    DOP853; "kvaerno3" and the scipy stiff names "LSODA", "Radau" and
    "BDF" (any case) the stiff Kvaerno 3(2), whose ``fn`` must take
    forward-mode duals (the port's dense RHS does).

    ``chunk_size`` splits the sample grid into stepper calls of at most
    that many samples, each call restarting the stepper from the state
    sampled at its first time, as the JAX package cuts them: for the
    dense stepper sample 0, then samples [1, 1 + c), [1 + c, 1 + 2c),
    ...; for the step-clamped ones samples [0, c), then [c, 2c), ...
    (the JAX package pads the dense stepper's last chunk to one static
    shape for XLA, which the host-stepped solver has no need of). Where
    ``chunk_size`` is None
    it comes from ``CKPE_ODE_CHUNK`` when that is set, as in the JAX
    package. ``progress`` prints a line a chunk.

    ``checkpoint_path`` makes the solve resumable: finished chunks go
    into an ``.npy`` memmap at that path with a JSON sidecar, and the
    same solve called again resumes after the last finished chunk; the
    files are removed when it completes.

    ``project`` maps sampled states ``[m, n]`` (a tensor on the device)
    to observables ``[m, n_obs]``; it is applied on the device as the
    samples are made, so the full state never leaves it, and the result
    is ``[len(ts), n_obs]``; the full state sampled at ``ts[-1]`` rides
    in ``info["y_final"]`` (with a checkpoint also in
    ``<checkpoint_path>.y.npy``, which seeds a resume). ``info`` counts
    accepted and rejected steps, RHS calls and the accepted steps that
    hold samples (``num_sampled``: one `dense_eval` launch each on a
    card), and for the stiff stepper its Newton iterations and J.v
    products (``num_newton``, ``num_jvp``); after a resume, RHS calls and
    sampled steps of this call only.

    ``backend`` is the reference's parameter: ``"jax"`` (its default),
    ``"torch"`` and None all name this solver. ``"scipy"`` raises: its
    host solvers call ``fn`` with numpy arrays, and the port's RHS
    closures live on the device (`markov_tapes.ode_integrate_ivp` keeps
    scipy's solvers).
    """
    if backend == "scipy":
        raise NotImplementedError(
            "solve(backend='scipy') is not ported: the port's RHS closures "
            "take device tensors; use markov_tapes.ode_integrate_ivp for "
            "scipy's solvers")
    if backend not in (None, "jax", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    ts = np.asarray(ts, dtype=np.float64)
    name = (method or "").lower()
    if not name:
        name = "dop853" if min(rtol, atol) < 1e-9 else "dopri5"
    if name not in _STEPPERS:
        name = "dop853"  # scipy method names (DOP853, RK45, ...)
    stepper = globals()[_STEPPERS[name]]
    dev = config.get_device(device)
    y0_host = np.asarray(y0, dtype=np.float64).ravel()
    y = torch.as_tensor(y0_host, device=dev)
    n_out = len(ts)
    last = {}

    def sample_fn(block):
        if project is None:
            return block
        last["y"] = block[-1].clone()  # the full state at the chunk's end
        return project(block)

    row0 = sample_fn(y[None])
    if n_out < 2:
        info = {"num_accepted": 0, "num_rejected": 0, "num_rhs": 0,
                "num_sampled": 0, "completed": True}
        if project is not None:
            info["y_final"] = y0_host
        ys = row0.detach().cpu().numpy()
        return (ys, info) if return_info else ys

    if chunk_size is None:  # as the JAX package's solve reads it
        env = os.environ.get("CKPE_ODE_CHUNK")
        chunk_size = int(env) if env else None
    chunk = n_out if not chunk_size else max(2, int(chunk_size))
    ckpt, start, acc, rej = None, 0, 0, 0
    if checkpoint_path:
        key = hashlib.sha1(
            ts.tobytes() + y0_host.tobytes()
            + f"{rtol}:{atol}:{name}:{row0.shape[-1]}".encode()).hexdigest()
        ckpt = _Checkpoint(checkpoint_path, key, n_out, row0.shape[-1],
                           project is not None)
        if ckpt.resume:
            start, acc, rej, y_host = ckpt.resume
            y = torch.as_tensor(y_host, device=dev)
            if progress:
                print(f"[ckpe.ode] resuming at sample {start}/{n_out} from "
                      f"{checkpoint_path}", flush=True)
    parts = []
    if chunk < n_out and start == 0 and name == "dop853":
        rows = row0.detach().cpu().numpy()
        if ckpt:
            ckpt.mm[0] = rows[0]
        else:
            parts.append(rows)
        start = 1
    rhs = sampled = newton = jvps = 0
    t_begin = time.time()
    while start < n_out:
        stop = min(start + chunk, n_out)
        ts_chunk = ts[start:stop] if start == 0 else ts[start - 1:stop]
        out, stats = stepper(fn_dy_dt, y, ts_chunk, (rtol, atol),
                             max_steps=max_steps, sample_fn=sample_fn)
        if not stats.completed:
            raise RuntimeError(
                f"ODE solve did not complete within max_steps={max_steps} "
                f"(accepted={acc + stats.num_accepted}, "
                f"rejected={rej + stats.num_rejected}).")
        acc += stats.num_accepted
        rej += stats.num_rejected
        rhs += stats.num_rhs
        sampled += stats.num_sampled
        newton += stats.num_newton
        jvps += stats.num_jvp
        y = last["y"] if project is not None else out[-1]
        rows = (out if start == 0 else out[1:]).detach().cpu().numpy()
        if ckpt:
            ckpt.write(start, stop, rows, acc, rej, y)
        else:
            parts.append(rows)
        if progress:
            print(f"[ckpe.ode] t={ts[stop - 1]:g}/{ts[-1]:g} "
                  f"steps={acc}(+{rej} rej) {time.time() - t_begin:.0f}s",
                  flush=True)
        start = stop
    ys = ckpt.finish() if ckpt else np.concatenate(parts)
    info = {"num_accepted": acc, "num_rejected": rej, "num_rhs": rhs,
            "num_sampled": sampled, "completed": True}
    if _STEPPERS[name] == "odeint_kvaerno3":
        info.update(num_newton=newton, num_jvp=jvps)
    if project is not None:
        info["y_final"] = y.cpu().numpy()
    return (ys, info) if return_info else ys
