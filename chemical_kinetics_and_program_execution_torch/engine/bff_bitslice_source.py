"""K17's circuit-specific source: a BFF circuit compiled into code.

:func:`k17_source` writes the translation unit of a circuit of
`bff_bitslice.compile_bff_circuit` with `bitslice_source.unit_source`
(one ``uint32_t`` statement a gate, then the template
`csrc/bitslice_round.cuh` that K14 shares): the data cells written back
only, no random words, ``size_a`` counter planes.

:func:`k17_library` builds a machine's unit with
`bitslice_source.unit_library` and loads it once a process.
"""

from __future__ import annotations

import ctypes
import functools

from .bff_bitslice import compile_bff_circuit
from .bitslice_source import unit_library, unit_source


def k17_source(mach, circ) -> str:
    """The CUDA translation unit of K17 for BFF circuit ``circ`` of
    machine ``mach`` (deterministic: the same circuit and machine give
    the same text)."""
    _, outputs, nb, n_rand = circ
    n_out = mach.n_d * nb + 4 * mach.size_a
    if len(outputs) != n_out or n_rand:
        raise ValueError(f"{mach.tag}: a circuit of {len(outputs)} outputs "
                         f"and {n_rand} random words is not its BFF round "
                         f"({n_out} outputs, none random)")
    return unit_source("K17", f"the BFF circuit of {mach.tag!r}", circ,
                       n_p=0 if mach.self_modifying else mach.n_p,
                       n_d=mach.n_d, p_lo=mach.p_lo, d_lo=mach.d_lo,
                       write_p=False, size_a=mach.size_a, threads=128)


@functools.lru_cache(maxsize=None)
def k17_library(mach) -> ctypes.CDLL:
    """K17 for the circuit of ``mach`` (`compile_bff_circuit`, cached a
    machine), built on first use and loaded once a process."""
    return unit_library("k17", k17_source(mach, compile_bff_circuit(mach)))
