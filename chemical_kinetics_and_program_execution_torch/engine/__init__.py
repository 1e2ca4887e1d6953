"""Engine package of the port: rule DSL, enumeration, the dense exact RHS,
ensemble rounds.

Counterpart of the JAX package's `engine/__init__.py`. Of its three
exact kernels only ``dense`` (`dense.py`, the transfer-matrix window
sweep) is ported; ``tree`` and ``chains`` (`rhs.py` there) are not yet
(ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

# Above this many signature *groups* the JAX package falls back to the
# tree kernel; the port raises there until that kernel is ported.
DENSE_GROUP_LIMIT = 600

_NO_TREE = ("the {} engine (the JAX package's engine/rhs.py) is not ported "
            "yet (ROADMAP Queue 1 item 4)")


def build_dy_dt(tag: str, cl_k: int, *, engine: str = "auto", device=None):
    """Compiles ``tag`` and returns ``(fn, program)``.

    ``fn(p)`` maps an SPD vector to dp/dt on ``device``
    (``cuda`` unless named; the kernels K3-K5 there, their plain versions
    on the CPU); ``program`` is the :class:`dense.DenseProgram`.
    ``engine`` is ``"auto"`` or ``"dense"``; where the JAX package would
    take the tree kernel (``"auto"`` above `DENSE_GROUP_LIMIT` groups,
    ``"tree"``, ``"chains"``) this raises NotImplementedError.
    """
    from . import dense as dense_mod

    if engine not in ("auto", "dense"):
        if engine in ("tree", "chains"):
            raise NotImplementedError(_NO_TREE.format(repr(engine)))
        raise ValueError(f"unknown engine {engine!r}")
    prog = dense_mod.compile_dense(tag, cl_k)
    n_groups = len(dense_mod._group_plans(prog.plans, prog.size_a,
                                          prog.cl_k))
    if engine == "auto" and n_groups > DENSE_GROUP_LIMIT:
        raise NotImplementedError(
            f"{tag} at cl_k={cl_k} has {n_groups} signature groups, above "
            f"DENSE_GROUP_LIMIT={DENSE_GROUP_LIMIT}: "
            + _NO_TREE.format("'tree'"))
    return dense_mod.make_dense_dy_dt(prog, device=device), prog
