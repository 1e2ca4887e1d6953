"""Device and dtype defaults for the PyTorch port.

Counterpart of the JAX package's `utils/config.py`.
There, float64 is switched on in JAX at import time; here every tensor
on a float64 path names its dtype, and `DEFAULT_FLOAT` is that dtype.
"""

from __future__ import annotations

import torch

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
