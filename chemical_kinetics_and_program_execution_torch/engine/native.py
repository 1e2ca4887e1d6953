"""ctypes binding of the C++ window-sweep expander.

Counterpart of the expander half of the JAX package's `engine/native.py`.
`csrc/expander.cc` (the port's copy of that package's
`native/expander.cc`) is a host library: `build` compiles it with one
`g++` call into `_build/libckpe_expander-{hash}.so`, the hash taken over
the source and the flags, at first use. `compile.compile_problem` calls
`expand_signatures`; a build or load that fails raises, and nothing
falls back to the Python expander (`accumulate.Expander`) on its own.
``CKPE_NO_NATIVE`` set selects the Python expander beforehand
(`compile._expand`), and then nothing here is built.
The native ex6 enumerator of that module is not ported (ROADMAP).
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
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")


def library_path() -> Path:
    """Where `build` puts the library: named by a hash of the source and
    the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libckpe_expander-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str, float]:
    """Compiles `csrc/expander.cc` with one `g++` call unless the library
    is already built; returns (path, the compiler's output, seconds spent;
    0 when nothing was built). Raises when there is no `g++` or it
    fails."""
    target = library_path()
    if target.exists():
        return target, "", 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found on PATH: the C++ expander "
                                "cannot be built")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
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
