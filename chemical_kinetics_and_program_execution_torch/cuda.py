"""Builds the port's CUDA kernels and binds them with ctypes.

One `nvcc` call compiles every source under `csrc/` into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds). The library lands in `_build/` beside this file, named by a
hash of the sources and flags: a changed source builds anew, an
unchanged one loads the library already there. The new library is
written under a temporary name and renamed into place, so concurrent
builds need no lock file.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises when that is not 0.
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

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_STEM = "libckpe_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"{LIB_STEM}-{_digest()}.so"


def nvcc() -> str:
    """Path of `nvcc`: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise FileNotFoundError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels cannot be built")


def build() -> tuple[Path, str, float]:
    """Compiles `csrc/*.cu` with one `nvcc` call unless the library for
    these sources is already built. Returns (library path, nvcc's
    output with the `-Xptxas -v` resource lines, seconds spent; 0 when
    nothing was built)."""
    target = library_path()
    if target.exists():
        return target, "", 0.0
    compiler = nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target, proc.stdout + proc.stderr, seconds


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    lib = ctypes.CDLL(str(build()[0]))
    # ckpe_plane_round(p_st, d_st, uniforms, shifts, round, plan, n_int,
    #                  fplan, n_float, n_cells, B, E, stride, stream)
    lib.ckpe_plane_round.argtypes = [_P, _P, _P, _P, _I, _P, _I, _P, _I,
                                     _I, _I, _I, _I, _P]
    lib.ckpe_plane_round.restype = _I
    # ckpe_window_counts(tape, B, L, size_a, cl_k, counts, stream)
    lib.ckpe_window_counts.argtypes = [_P, ctypes.c_longlong, _I, _I, _I,
                                       _P, _P]
    lib.ckpe_window_counts.restype = _I
    lib.ckpe_error_string.argtypes = [_I]
    lib.ckpe_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raises when a C entry point reported a CUDA error."""
    if rc:
        msg = load().ckpe_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {msg}")
