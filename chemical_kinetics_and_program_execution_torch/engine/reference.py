"""Slow host-side reference implementation of dy/dt.

Counterpart of the JAX package's `engine/reference.py` (host numpy, as
there), over the port's `markov.pyramid_np`, `dsl` and `enumerate`.

A direct numeric port of the reference's per-call computation
(`tape_multiverse.scm:1249-1443`): enumerate execution paths, evaluate each
world's probability against the actual marginal pyramid, then run the
window-sweep recursion with plain floats, accumulating into a numpy vector.

This exists purely as an independent test oracle for the compiled dense
kernel (`compile.py` + `rhs.py`): it shares the path enumerator but NOT the
symbolic expansion, so disagreements localize compiler bugs. Never used in
the hot path.
"""

from __future__ import annotations

import numpy as np

from ..markov import pyramid_np, pyramid_offsets
from . import dsl, enumerate as enum_mod


def dy_dt_reference(tag: str, cl_k: int, p: np.ndarray) -> np.ndarray:
    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    offsets, _ = pyramid_offsets(size_a, cl_k)
    pyr = pyramid_np(p, size_a, cl_k)
    accum = np.zeros(size_a**cl_k, dtype=np.float64)

    window_mod = size_a**cl_k
    prefix_mod = size_a ** (cl_k - 1)

    def ratio(idx_long, len_long, idx_short, len_short):
        p_long = pyr[offsets[len_long] + idx_long]
        if p_long == 0.0:
            return 0.0
        return p_long / max(p_long, pyr[offsets[len_short] + idx_short])

    def emit(w, io, ia):
        o, a = io % window_mod, ia % window_mod
        if o != a:
            accum[o] -= w
            accum[a] += w

    def extend_ri(w, po, pa):
        if po == pa:
            return
        for s in range(size_a):
            io, ia = po * size_a + s, pa * size_a + s
            r = ratio(io, cl_k, po, cl_k - 1)
            if r > 0.0:
                wn = w * r
                emit(wn, io, ia)
                extend_ri(wn, io % prefix_mod, ia % prefix_mod)

    def extend_le(w, io, ia, ln, do_right):
        if io == ia:
            return
        if ln < cl_k:
            for s in range(size_a):
                sc = s * size_a**ln
                r = ratio(io + sc, ln + 1, io, ln)
                if r > 0.0:
                    extend_le(w * r, io + sc, ia + sc, ln + 1,
                              ln + 1 == cl_k - 1)
        elif ln == cl_k:
            emit(w, io, ia)
            suf_o, suf_a = io // size_a, ia // size_a
            for s in range(size_a):
                sc = s * size_a ** (ln - 1)
                r = ratio(sc + suf_o, ln, suf_o, ln - 1)
                if r > 0.0:
                    extend_le(w * r, sc + suf_o, sc + suf_a, ln, False)
        else:
            emit(w, io, ia)
            extend_le(w, io // size_a, ia // size_a, ln - 1, False)
        if do_right:
            extend_ri(w, io % prefix_mod, ia % prefix_mod)

    for world in enum_mod.enumerate_worlds(problem, cl_k):
        w = world.const
        for num_idx, den_idx in world.factors:
            p_here = max(0.0, pyr[num_idx])
            w *= 0.0 if p_here == 0.0 else p_here / max(p_here, pyr[den_idx])
            if w == 0.0:
                break
        if w == 0.0:
            continue
        for io, ia, ln in world.tape_sigs:
            if io != ia:
                extend_le(w, io, ia, ln, ln >= cl_k - 1)
    return accum


def format_world(problem, world, p_world=None) -> str:
    """One-line human dump of an execution path: probability, decision
    program, and each tape's old -> new revealed sequence.

    The counterpart of the reference slow path's per-world debug dump
    (`tape_multiverse.scm:1006-1028` prints p-world, the program that
    ran, and original/adjusted sequences).
    """
    syms = [str(s) for s in problem.symbols]

    def seq(cells):
        l_len, orig, adj = cells
        o = " ".join(syms[v] for v in orig)
        a = " ".join(syms[v] for v in adj)
        span = f"[{-l_len}..{len(orig) - l_len - 1}]"
        return f"{span} {o}" + ("" if orig == adj else f" -> {a}")

    prog = []
    for v, meta in zip(world.decisions, world.decision_meta):
        if meta[0] == "reveal":
            _, data_tape, index = meta
            prog.append(
                f"get({'D' if data_tape else 'P'}{index:+d})={syms[v]}")
        else:
            prog.append(f"choose[{v}]@{meta[1][v]:.4g}")
    pw = world.const if p_world is None else p_world
    return (f"p_world={pw:.6g} const={world.const:.6g} "
            f"prog[{' '.join(prog) or '-'}] "
            f"P{seq(world.tape_cells[0])} D{seq(world.tape_cells[1])}")


def dump_worlds(tag: str, cl_k: int, p=None, *, limit: int | None = None,
                file=None) -> int:
    """Prints every execution path of a rule's multiverse.

    With ``p`` given, each world's probability is evaluated against that
    SPD's marginal pyramid (const x conditional reveal ratios — the same
    weighting `dy_dt_reference` applies) and zero-probability worlds are
    annotated; without it, only the compile-time choose-weight product
    is shown. Returns the number of worlds printed. This is the tool for
    inspecting why a new rule's multiverse looks wrong (reference:
    debug dump at `tape_multiverse.scm:1006-1028`).
    """
    import sys

    out = file or sys.stdout
    problem = dsl.get_problem(tag)
    pyr = None
    if p is not None:
        pyr = pyramid_np(np.asarray(p, dtype=np.float64),
                         problem.size_a, cl_k)
    n = 0
    for world in enum_mod.enumerate_worlds(problem, cl_k):
        if limit is not None and n >= limit:
            print(f"... (limit={limit} reached)", file=out)
            break
        p_world = None
        if pyr is not None:
            p_world = world.const
            for num_idx, den_idx in world.factors:
                p_here = max(0.0, pyr[num_idx])
                p_world *= (0.0 if p_here == 0.0
                            else p_here / max(p_here, pyr[den_idx]))
        print(format_world(problem, world, p_world), file=out)
        n += 1
    return n
