"""Device and dtype defaults and the debug flag of the PyTorch port.

Counterpart of the JAX package's `utils/config.py`.
There, float64 is switched on in JAX at import time; here every tensor
on a float64 path names its dtype, and `DEFAULT_FLOAT` is that dtype.
`IS_DEBUG` keeps the reference's flag, `MARKOV_TAPES_DEBUG` (or
`CKPE_DEBUG`), read by the same rule.
"""

from __future__ import annotations

import os

import torch


def _env_flag(*names: str, default: bool = False) -> bool:
    """The first of ``names`` that is set: digits as an int's truth,
    else true for "true", "yes" or "on" in any case."""
    for name in names:
        val = os.environ.get(name)
        if val is not None:
            return (bool(int(val)) if val.isdigit()
                    else val.lower() in ("true", "yes", "on"))
    return default


IS_DEBUG = _env_flag("MARKOV_TAPES_DEBUG", "CKPE_DEBUG")

# Host-side probability arithmetic (SPDs, bridge factors, times).
DEFAULT_FLOAT = torch.float64


def get_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another one. A ``cuda`` request on a machine without a card
    raises; nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def check_float64(dtype) -> None:
    """Accepts the reference's ``dtype=`` of an exact-path factory: None
    or float64 (a torch, numpy or JAX float64 type, or its name). The
    exact path is float64 throughout, so any other type raises."""
    if dtype is None or dtype is torch.float64:
        return
    import numpy as np

    try:
        ok = np.dtype(dtype) == np.float64
    except TypeError:
        ok = False
    if not ok:
        raise TypeError(f"the exact path is float64 throughout; dtype="
                        f"{dtype!r} is not supported")


def make_generator(seed_or_generator, device: torch.device) -> torch.Generator:
    """A `torch.Generator` on ``device``: an int seeds a new one, a
    generator is checked to live on ``device`` and returned as is."""
    if isinstance(seed_or_generator, torch.Generator):
        if seed_or_generator.device.type != device.type:
            raise ValueError(
                f"generator lives on {seed_or_generator.device}, the run "
                f"on {device}")
        return seed_or_generator
    return torch.Generator(device=device).manual_seed(int(seed_or_generator))
