"""The bit-sliced kernels' circuit-specific source: a circuit compiled
into code.

:func:`unit_source` writes one CUDA translation unit for a circuit
``(ops, outputs, nb, n_rand)`` and its machine's window offsets: every
gate becomes one ``uint32_t`` statement, so nvcc keeps the DAG in
registers and fuses gates into LOP3s. The unit includes the hand-written
template `csrc/bitslice_round.cuh` (loads, stores, the counter planes'
popcounts, the launch loop), which documents both kernels' design:
:func:`k14_source` is K14's unit (every window cell written back, random
words for a sampling circuit), `bff_bitslice_source.k17_source` K17's.

:func:`unit_library` builds a unit with `cuda.build_unit` (one `nvcc`
call a circuit, cached on disk by a hash of the source, the template and
the flags) and loads it once a process.
"""

from __future__ import annotations

import ctypes
import functools

from .. import cuda

_BINARY = {"and": "&", "or": "|", "xor": "^"}


def _gate(i: int, op) -> str:
    kind, a, b = op
    if kind == "const":
        return f"  const uint32_t v{i} = {'0xffffffffu' if a else '0u'};"
    if kind == "in":
        return f"  const uint32_t v{i} = in[{a}];"
    if kind == "not":
        return f"  const uint32_t v{i} = ~v{a};"
    return f"  const uint32_t v{i} = v{a} {_BINARY[kind]} v{b};"


def unit_source(kernel: str, what: str, circ, *, n_p: int, n_d: int,
                p_lo: int, d_lo: int, write_p: bool, size_a: int,
                threads: int) -> str:
    """The translation unit of ``kernel`` ("K14" or "K17") for circuit
    ``circ`` (``what`` names it in the header): the template's macros,
    then `bs_circuit`. Deterministic: the same arguments give the same
    text."""
    ops, outputs, nb, n_rand = circ
    n_gates = sum(op[0] in _BINARY or op[0] == "not" for op in ops)
    lines = [
        f"// {kernel} for {what}: generated by",
        "// chemical_kinetics_and_program_execution_torch/engine/"
        "bitslice_source.py",
        "// from the circuit; the kernel is csrc/bitslice_round.cuh.",
        f"// {n_p + n_d} window cells of {nb} bits, {n_rand} random words, "
        f"{len(ops)} ops ({n_gates} gates), {len(outputs)} outputs.",
        f"#define BS_N_P {n_p}",
        f"#define BS_N_D {n_d}",
        f"#define BS_P_LO {p_lo}",
        f"#define BS_D_LO {d_lo}",
        f"#define BS_NB {nb}",
        f"#define BS_N_RAND {n_rand}",
        f"#define BS_WRITE_P {int(write_p)}",
        f"#define BS_SIZE_A {size_a}",
        f"#define BS_THREADS {threads}",
        '#include "bitslice_round.cuh"',
        "",
        "BS_FN void bs_circuit(const uint32_t* in, uint32_t* out) {",
    ]
    lines += [_gate(i, op) for i, op in enumerate(ops)]
    lines += [f"  out[{j}] = v{o};" for j, o in enumerate(outputs)]
    lines.append("}")
    return "\n".join(lines) + "\n"


def k14_source(dm, circ) -> str:
    """The CUDA translation unit of K14 for circuit ``circ`` of machine
    ``dm``: every window cell written back, no counters."""
    outputs, nb = circ[1], circ[2]
    if len(outputs) != dm.n_cells * nb:
        raise ValueError(f"{dm.tag}: a circuit of {len(outputs)} outputs "
                         f"for {dm.n_cells} cells of {nb} bits")
    return unit_source("K14", f"the bit-sliced circuit of {dm.tag!r}", circ,
                       n_p=dm.n_p, n_d=dm.n_d, p_lo=dm.p_lo, d_lo=dm.d_lo,
                       write_p=True, size_a=0, threads=256)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def unit_library(stem: str, source: str) -> ctypes.CDLL:
    """The unit ``source`` built as `_build/lib{stem}-{hash}.so` on first
    use and loaded once a process."""
    lib = ctypes.CDLL(str(cuda.build_unit(stem, source)[0]))
    # ckpe_bs_rounds(p, d, rand, shifts, totals, k0, n, E, W, site_minor,
    #                stride, stream)
    lib.ckpe_bs_rounds.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _L, _I,
                                   _I, _P]
    lib.ckpe_bs_rounds.restype = _I
    lib.ckpe_error_string.argtypes = [_I]
    lib.ckpe_error_string.restype = ctypes.c_char_p
    return lib


# Loaded libraries by circuit identity (the circuit and machine are kept
# alive beside the library): the circuits are cached tuples, and hashing
# one walks every op.
_by_circuit: dict[tuple, tuple] = {}


def k14_library(dm, circ) -> ctypes.CDLL:
    """K14 for circuit ``circ`` of ``dm``, built on first use and loaded
    once a process. Libraries are keyed by the generated source."""
    key = (id(dm), id(circ))
    hit = _by_circuit.get(key)
    if hit is None:
        hit = _by_circuit[key] = (dm, circ,
                                  unit_library("k14", k14_source(dm, circ)))
    return hit[2]
