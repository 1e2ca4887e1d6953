"""PyTorch/CUDA port of the JAX package beside it.

The JAX package beside this one is the reference; this package imports
neither it nor `jax`. It keeps the reference's module layout where that
helps a reader find the counterpart (`utils/config.py`, `markov.py`,
`engine/dsl.py`, `engine/enumerate.py`, `engine/ensemble.py`,
`models/problems.py`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
a ``cuda`` request on a machine without a card raises. On the card the
ensemble round and the window histogram run as hand-written CUDA kernels
(`csrc/`, built by `cuda.py`); on the CPU the same wrappers run their
plain PyTorch versions.

Ported so far: the ensemble engine's plane-stored FSM round
(`engine.ensemble.run_ensemble`), `window_counts` and
`sample_tapes_from_spd`. ROADMAP.md lists what is still to come.
"""

from .engine.dsl import DATA, PROGRAM, register_problem  # noqa: F401

__version__ = "0.1.0"
