"""PyTorch/CUDA port of the JAX package beside it.

The JAX package beside this one is the reference; this package imports
neither it nor `jax`. It keeps the reference's module layout where that
helps a reader find the counterpart (`utils/config.py`, `markov.py`,
`markov_tapes.py`, `engine/dsl.py`, `engine/enumerate.py`,
`engine/compile.py`, `engine/dense.py`, `engine/rhs.py`, `engine/tree.py`,
`engine/accumulate.py`, `engine/ensemble.py`,
`models/problems.py`, `models/initial_states.py`, `ode/dop853.py`,
`ode/integrate.py`, `ops/observables.py`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
a ``cuda`` request on a machine without a card raises. On the card the
ensemble round, the window histogram, the exact RHS and the DOP853
arithmetic run as hand-written CUDA kernels (`csrc/`, built by
`cuda.py`); on the CPU the same wrappers run their plain PyTorch
versions.

Ported so far: the ensemble engine's plane-stored FSM round
(`engine.ensemble.run_ensemble`), `window_counts` and
`sample_tapes_from_spd`; the exact SPD closure (`engine.build_dy_dt`
with the dense, tree and chain engines, dual-SPD programs,
`ode.integrate.solve` with DOP853 in one call or in checkpointed chunks,
`markov_tapes`); thermodynamics (`ops.thermo`) and the host instruments
(`ops.closure`, `ops.correlations`, `engine.reference`).
ROADMAP.md lists what is still to come.

The top level exports the JAX package's names that are ported (all but
`make_batched_dy_dt`); `make_dy_dt` is the tree engine's.
"""

from . import markov  # noqa: F401
from .engine import build_dy_dt  # noqa: F401
from .engine.compile import compile_problem  # noqa: F401
from .engine.dense import compile_dense, make_dense_dy_dt  # noqa: F401
from .engine.dsl import (  # noqa: F401
    DATA,
    PROGRAM,
    register_problem,
    registered_problems,
)
from .engine.rhs import make_dy_dt  # noqa: F401

__version__ = "0.1.0"
