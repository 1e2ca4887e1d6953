"""Engine package of the port: rule DSL, enumeration, the exact RHS
engines, ensemble rounds.

Counterpart of the JAX package's `engine/__init__.py`. Three
interchangeable exact engines compute the same dp/dt:

- ``dense`` (`dense.py`): the transfer-matrix window sweep (K3-K5),
  chosen when the signature groups are few (every reference workload);
- ``tree`` (`rhs.py`): the levelized prefix-tree gather over the
  compiled event tables (K7), for problems with many signatures;
- ``chains`` (`rhs.py`): the padded-chain gather (K8), the
  structure-independent cross-check.
"""

from __future__ import annotations

# Above this many signature *groups* the dense sweep is left for the tree
# engine, as in the JAX package.
DENSE_GROUP_LIMIT = 600


def build_dy_dt(tag: str, cl_k: int, *, dtype=None, jit: bool = True,
                engine: str = "auto", max_worlds: int | None = None,
                device=None):
    """Compiles ``tag`` and returns ``(fn, program)``.

    ``fn(p, out=None)`` maps an SPD vector to dp/dt on ``device``
    (``cuda`` unless named: the kernels there, their plain versions on
    the CPU); ``program`` is the :class:`dense.DenseProgram` or the
    :class:`compile.CompiledProblem`. ``engine`` is ``"auto"`` (dense up
    to `DENSE_GROUP_LIMIT` signature groups, else the tree engine),
    ``"dense"``, ``"tree"`` or ``"chains"``; ``max_worlds`` bounds the
    enumeration. ``dtype`` (None or float64) and ``jit`` (no effect) are
    the reference's parameters, as in `dense.make_dense_dy_dt`.
    """
    from ..utils import config

    config.check_float64(dtype)
    if engine not in ("auto", "dense", "tree", "chains"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine in ("auto", "dense"):
        from . import dense as dense_mod

        prog = dense_mod.compile_dense(tag, cl_k, max_worlds=max_worlds)
        n_groups = len(dense_mod._group_plans(prog.plans, prog.size_a,
                                              prog.cl_k))
        if engine == "dense" or n_groups <= DENSE_GROUP_LIMIT:
            return dense_mod.make_dense_dy_dt(prog, dtype, jit,
                                              device=device), prog
    from . import rhs
    from .compile import compile_problem

    compiled = compile_problem(tag, cl_k, max_worlds=max_worlds)
    if engine == "chains":
        return rhs.make_chain_dy_dt(compiled, dtype, jit,
                                     device=device), compiled
    return rhs.make_dy_dt(compiled, dtype, jit, device=device), compiled
