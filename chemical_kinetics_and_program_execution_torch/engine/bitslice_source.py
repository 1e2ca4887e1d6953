"""K14's circuit-specific source: a bit-sliced circuit compiled into code.

:func:`k14_source` writes one CUDA translation unit for a circuit
``(ops, outputs, nb, n_rand)`` of `bitslice.py` and the window offsets of
its machine: every gate becomes one ``uint32_t`` statement, so nvcc keeps
the DAG in registers and fuses gates into LOP3s. The unit includes the
hand-written template `csrc/bitslice_round.cuh` (loads, stores, the
launch loop), which documents the kernel's design.

:func:`k14_library` builds the unit with `cuda.build_unit` (one `nvcc`
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


def k14_source(dm, circ) -> str:
    """The CUDA translation unit of K14 for circuit ``circ`` of machine
    ``dm`` (deterministic: the same circuit and offsets give the same
    text)."""
    ops, outputs, nb, n_rand = circ
    if len(outputs) != dm.n_cells * nb:
        raise ValueError(f"{dm.tag}: a circuit of {len(outputs)} outputs "
                         f"for {dm.n_cells} cells of {nb} bits")
    n_gates = sum(op[0] in _BINARY or op[0] == "not" for op in ops)
    lines = [
        f"// K14 for the bit-sliced circuit of {dm.tag!r}: generated by",
        "// chemical_kinetics_and_program_execution_torch/engine/"
        "bitslice_source.py",
        "// from the circuit; the kernel is csrc/bitslice_round.cuh.",
        f"// {dm.n_cells} window cells of {nb} bits, {n_rand} random words, "
        f"{len(ops)} ops ({n_gates} gates).",
        f"#define K14_N_P {dm.n_p}",
        f"#define K14_N_D {dm.n_d}",
        f"#define K14_P_LO {dm.p_lo}",
        f"#define K14_D_LO {dm.d_lo}",
        f"#define K14_NB {nb}",
        f"#define K14_N_RAND {n_rand}",
        '#include "bitslice_round.cuh"',
        "",
        "K14_FN void k14_circuit(const uint32_t* in, uint32_t* out) {",
    ]
    lines += [_gate(i, op) for i, op in enumerate(ops)]
    lines += [f"  out[{j}] = v{o};" for j, o in enumerate(outputs)]
    lines.append("}")
    return "\n".join(lines) + "\n"


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _load(source: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda.build_unit("k14", source)[0]))
    # ckpe_k14_rounds(p, d, rand, shifts, k0, n, E, W, site_minor, stride,
    #                 stream)
    lib.ckpe_k14_rounds.argtypes = [_P, _P, _P, _P, _I, _I, _I, _L, _I, _I,
                                    _P]
    lib.ckpe_k14_rounds.restype = _I
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
        hit = _by_circuit[key] = (dm, circ, _load(k14_source(dm, circ)))
    return hit[2]
