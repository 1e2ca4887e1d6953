"""ctypes bindings of the C++ host libraries: the window-sweep expander
and the guided ex6 enumerator.

Counterpart of the JAX package's `engine/native.py`. `csrc/expander.cc`
and `csrc/enumerate6.cc` (the port's copies of the repository's
`native/expander.cc` and `native/enumerate6.cc`) are host libraries:
`build` compiles one with one `g++` call into
`_build/lib{stem}-{hash}.so`, the hash taken over the source and the
flags, at first use. `compile.compile_problem` calls
`expand_signatures`, `enumerate.enumerate_worlds` calls `enumerate_ex6`;
a build or load that fails raises, and nothing falls back to the Python
expander (`accumulate.Expander`) or odometer on its own.
``CKPE_NO_NATIVE`` set selects the Python paths beforehand
(`compile._expand`, `enumerate.enumerate_worlds`), and then nothing here
is built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

from ..cuda import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "expander.cc"
ENUM6_SOURCE = CSRC_DIR / "enumerate6.cc"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")


def library_path(source: Path = SOURCE) -> Path:
    """Where `build` puts the library of ``source``: named by a hash of
    the source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    stem = "libckpe_expander" if source == SOURCE else "libckpe_enum6"
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> tuple[Path, str, float]:
    """Compiles ``source`` (`csrc/expander.cc` unless named) with one
    `g++` call unless the library is already built; returns (path, the
    compiler's output, seconds spent; 0 when nothing was built). Raises
    when there is no `g++` or it fails."""
    target = library_path(source)
    if target.exists():
        return target, "", 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError(f"g++ not found on PATH: {source.name} "
                                "cannot be built")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target, proc.stdout + proc.stderr, seconds


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The expander library, built on first use and loaded once."""
    lib = ctypes.CDLL(str(build()[0]))
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.ckpe_expand.restype = p
    lib.ckpe_expand.argtypes = [i64, i64, i64, ctypes.POINTER(i64)]
    lib.ckpe_num_events.restype = i64
    lib.ckpe_num_events.argtypes = [p]
    lib.ckpe_max_chain.restype = i64
    lib.ckpe_max_chain.argtypes = [p]
    lib.ckpe_fill.restype = None
    lib.ckpe_fill.argtypes = [
        p, i64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.ckpe_free.restype = None
    lib.ckpe_free.argtypes = [p]
    return lib


@functools.lru_cache(maxsize=1)
def load_enum6() -> ctypes.CDLL:
    """The ex6 enumerator library, built on first use and loaded once."""
    lib = ctypes.CDLL(str(build(ENUM6_SOURCE)[0]))
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.ckpe_abi_version.restype = i64
    lib.ckpe_abi_version.argtypes = []
    if lib.ckpe_abi_version() != 2:
        raise RuntimeError(f"{ENUM6_SOURCE.name}: ABI "
                           f"{lib.ckpe_abi_version()}, 2 expected")
    lib.ckpe_enum6.restype = p
    lib.ckpe_enum6.argtypes = [i64, i64, i64, i64, ctypes.c_double,
                               ctypes.POINTER(ctypes.c_double), i64, i64]
    for name in ("ckpe_enum6_num_worlds", "ckpe_enum6_num_factors",
                 "ckpe_enum6_status"):
        getattr(lib, name).restype = i64
        getattr(lib, name).argtypes = [p]
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.ckpe_enum6_fill.restype = None
    lib.ckpe_enum6_fill.argtypes = [p, i32, i32, i32, ctypes.POINTER(i64)]
    lib.ckpe_enum6_free.restype = None
    lib.ckpe_enum6_free.argtypes = [p]
    return lib


def enumerate_ex6(size_a: int, cl_k: int, fuel: int, d1_start: int,
                  threshold: float, pyramid: np.ndarray,
                  max_worlds: int | None, *, code_tape: int = 0,
                  tag: str = "ex6-mini-bff"):
    """The guided enumeration of the ex6 mini-BFF rule, depth first in the
    Python odometer's order (``code_tape=1``: the single-tape
    self-modifying variants, opcodes fetched from the data ring), pruning
    a path whose weight under ``pyramid`` (the reference SPD's flat
    pyramid) drops below ``threshold``. Returns (chain_len [W] int32, num
    [F] int32, den [F] int32, sigs [W, 10] int64: a tape's io_hi, io_lo,
    ia_hi, ia_lo, length, each signature's 128 bits in two halves), or
    None where a tape's span outgrows 128 bits. Raises RuntimeError past
    ``max_worlds`` (as `enumerate.enumerate_worlds`; ``tag`` names the
    problem there)."""
    lib = load_enum6()
    pyr = np.ascontiguousarray(np.asarray(pyramid, dtype=np.float64))
    handle = lib.ckpe_enum6(
        size_a, cl_k, fuel, d1_start, float(threshold),
        pyr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        -1 if max_worlds is None else int(max_worlds), int(code_tape))
    try:
        status = lib.ckpe_enum6_status(handle)
        if status == 2:
            raise RuntimeError(
                f"Problem {tag!r} exceeds max_worlds={max_worlds} "
                f"execution paths at cl_k={cl_k}.")
        if status == 1:
            return None
        n = lib.ckpe_enum6_num_worlds(handle)
        f = lib.ckpe_enum6_num_factors(handle)
        chain_len = np.empty(n, dtype=np.int32)
        num = np.empty(f, dtype=np.int32)
        den = np.empty(f, dtype=np.int32)
        sigs = np.empty((n, 10), dtype=np.int64)
        i32 = ctypes.POINTER(ctypes.c_int32)
        lib.ckpe_enum6_fill(handle, chain_len.ctypes.data_as(i32),
                            num.ctypes.data_as(i32), den.ctypes.data_as(i32),
                            sigs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    finally:
        lib.ckpe_enum6_free(handle)
    return chain_len, num, den, sigs


def expand_signatures(size_a: int, cl_k: int, sigs: np.ndarray,
                      one_slot: int):
    """Expands signatures [K, 3] (i_orig, i_adj, length) into padded event
    tables: (e_num [E, Le] int32, e_den [E, Le] int32, e_sig [E] int32,
    tgt_orig [E] int64, tgt_adj [E] int64), chains padded with
    ``one_slot``; events in the Python expander's order, signature by
    signature."""
    lib = load()
    sigs = np.ascontiguousarray(np.asarray(sigs, dtype=np.int64)
                                .reshape(-1, 3))
    handle = lib.ckpe_expand(
        size_a, cl_k, len(sigs),
        sigs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    try:
        n = lib.ckpe_num_events(handle)
        le = max(int(lib.ckpe_max_chain(handle)), 1)
        e_num = np.full((n, le), one_slot, dtype=np.int32)
        e_den = np.full((n, le), one_slot, dtype=np.int32)
        e_sig = np.empty(n, dtype=np.int32)
        tgt_orig = np.empty(n, dtype=np.int64)
        tgt_adj = np.empty(n, dtype=np.int64)
        i32 = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.POINTER(ctypes.c_int64)
        lib.ckpe_fill(handle, le, e_num.ctypes.data_as(i32),
                      e_den.ctypes.data_as(i32), e_sig.ctypes.data_as(i32),
                      tgt_orig.ctypes.data_as(i64),
                      tgt_adj.ctypes.data_as(i64))
    finally:
        lib.ckpe_free(handle)
    return e_num, e_den, e_sig, tgt_orig, tgt_adj
