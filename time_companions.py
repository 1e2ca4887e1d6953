#!/usr/bin/env python3
"""Times K29 as built against variants that round apart from it.

    python3 time_companions.py

from the root of the repository (one card, `nvcc`; imports no jax).
K29 (`csrc/dopri5_batch.cu`) rounds every operation of its rule on its
own (the round-to-nearest intrinsics of `csrc/dopri5_rule.cuh`) in a
unit compiled with contraction allowed, so that it equals its plain
version bit for bit. The variants, each built apart into the package's
`_build/variants/`, edit the rule's four helpers:

- ``contract``: all four as operators, contraction allowed (``nvcc``
  may fuse products into sums);
- ``no_fmad``: all four as operators under the library's -fmad=false
  (the math library's ``pow`` then rounds apart from PyTorch's on a few
  arguments in a million);
- ``div_operator``: the quotient as the ``/`` operator, the rest as
  built;
- ``rn_add_sub`` and ``rn_mul``: only the sum and difference, or only
  the product, as intrinsics (either keeps a product from being fused
  into a sum), the rest as operators, contraction allowed.

Each runs `examples/autocatalysis.py`'s sweep (12 rows, 10,001 samples)
in turns (as built, the variants, then in reverse) by CUDA events
(`card_timing.cuda_ms`); prints each one's steps a member and whether it
equals the plain version (steps and samples) on the first 1,001
samples. A probe kernel built under -fmad=false and under -fmad=true
counts the arguments (3 x 2^20 a power, over [0, 3), [0, 3e-12) and [0,
3000)) where the math library's ``pow`` differs from ``torch.pow`` at
the rule's four exponents. Prints the card's name and power limit, then
one JSON object.
"""

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke
from card_timing import cuda_ms
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.models import (
    autocatalysis,
)

REPS = 5
HELPERS = """DP5_FN double dp5_add(double a, double b) { return __dadd_rn(a, b); }
DP5_FN double dp5_sub(double a, double b) { return __dsub_rn(a, b); }
DP5_FN double dp5_mul(double a, double b) { return __dmul_rn(a, b); }
DP5_FN double dp5_div(double a, double b) { return __ddiv_rn(a, b); }"""


def _ops(names):
    """The helper lines with ``names`` (of add, sub, mul, div) written as
    operators."""
    sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}
    lines = HELPERS.splitlines()
    for i, name in enumerate(("add", "sub", "mul", "div")):
        if name in names:
            lines[i] = (f"DP5_FN double dp5_{name}(double a, double b) "
                        f"{{ return a {sym[name]} b; }}")
    return "\n".join(lines)


VARIANTS = {"contract": (_ops(("add", "sub", "mul", "div")), "-fmad=true"),
            "no_fmad": (_ops(("add", "sub", "mul", "div")), "-fmad=false"),
            "div_operator": (_ops(("div",)), "-fmad=true"),
            "rn_add_sub": (_ops(("mul", "div")), "-fmad=true"),
            "rn_mul": (_ops(("add", "sub", "div")), "-fmad=true")}


def build_variant(name):
    """K29's unit with the rule's helpers edited as `VARIANTS` says,
    compiled into its own library; returns its C entry."""
    rule = (cuda.CSRC_DIR / "dopri5_rule.cuh").read_text()
    if rule.count(HELPERS) != 1:
        raise RuntimeError("dopri5_rule.cuh's helpers changed")
    helpers, fmad = VARIANTS[name]
    out = cuda.BUILD_DIR / "variants" / f"k29_{name}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "dopri5_rule.cuh").write_text(rule.replace(HELPERS, helpers))
    (out / "dopri5_batch.cu").write_text(
        (cuda.CSRC_DIR / "dopri5_batch.cu").read_text())
    lib = out / f"libk29_{name}.so"
    flags = [f for f in cuda.OBJ_FLAGS if f not in ("-c", "-fmad=true")]
    subprocess.run([cuda.nvcc(), *flags, fmad, "-shared", "-o", str(lib),
                    str(out / "dopri5_batch.cu")], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).ckpe_dopri5_batch
    fn.argtypes = cuda.load().ckpe_dopri5_batch.argtypes
    fn.restype = ctypes.c_int
    return fn


POW_PROBE = r"""
#include <cuda_runtime.h>
__global__ void probe(const double* x, double e, int n, double* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = pow(x[i], e);
}
extern "C" int ckpe_pow_probe(const double* x, double e, int n,
                              double* out) {
  probe<<<(n + 255) / 256, 256>>>(x, e, n, out);
  return (int)cudaGetLastError();
}
"""


def pow_probe(dev):
    """How many of the probe's arguments each build's ``pow`` rounds
    apart from ``torch.pow``, by exponent."""
    out = cuda.BUILD_DIR / "variants" / "pow_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(POW_PROBE)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(1 << 20, generator=g, dtype=torch.float64, device=dev)
    x = torch.cat([x * 3, x * 3e-12, x * 3e3])
    found = {}
    for fmad in ("-fmad=false", "-fmad=true"):
        lib = out / f"libprobe{fmad[6:]}.so"
        flags = [f for f in cuda.OBJ_FLAGS if f not in ("-c", "-fmad=true")]
        subprocess.run([cuda.nvcc(), *flags, fmad, "-shared", "-o",
                        str(lib), str(out / "probe.cu")], check=True,
                       capture_output=True, text=True)
        fn = ctypes.CDLL(str(lib)).ckpe_pow_probe
        fn.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
                       ctypes.c_void_p]
        for e in (-0.7 / 5.0, 0.4 / 5.0, -1.0 / 5.0, 1.0 / 5.0):
            got = torch.empty_like(x)
            if fn(x.data_ptr(), e, x.numel(), got.data_ptr()):
                raise RuntimeError("pow probe launch failed")
            found[f"{fmad} e={e!r}"] = int((got != x**e).sum())
    return {"arguments": x.numel(), "differ": found}


def run_variant(fn, y0, p, ts):
    B, n = y0.shape[0], ts.shape[0]
    ys = torch.zeros((B, n, 3), dtype=torch.float64, device=y0.device)
    acc = torch.empty(B, dtype=torch.int32, device=y0.device)
    rej = torch.empty_like(acc)
    coef, has = autocatalysis.tableau_arrays()
    rc = fn(coef.ctypes.data, has.ctypes.data, B, y0.data_ptr(),
            p.data_ptr(), ts.data_ptr(), n, autocatalysis.RTOL,
            autocatalysis.ATOL, 200_000, ys.data_ptr(), acc.data_ptr(),
            rej.data_ptr(), cuda.stream(y0))
    if rc:
        raise RuntimeError(f"variant launch failed: {rc}")
    return ys, acc, rej


def main():
    if not torch.cuda.is_available():
        print("time_companions: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cuda.load()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    rows = chip_smoke.example_rows()
    y0 = torch.as_tensor(rows[:, :3].copy(), device=dev)
    p = torch.as_tensor(rows[:, 3:].copy(), device=dev)
    ts = torch.as_tensor(chip_smoke.AC_TS, device=dev)
    check = ts[:chip_smoke.AC_CHECK]
    plain = autocatalysis._solve_batch_plain(y0, p, check, 200_000)
    runs = {"built": lambda t: autocatalysis.dopri5_batch(y0, p, t, 200_000)}
    for name, fn in fns.items():
        runs[name] = lambda t, fn=fn: run_variant(fn, y0, p, t)
    result = {"card": smi, "ms": {n: [] for n in runs}}
    for name, run in runs.items():
        ys, acc, rej = run(ts)
        got = run(check)
        torch.cuda.synchronize()
        result[name] = {
            "steps": (acc + rej).tolist(),
            "equals_plain": bool(torch.equal(got[0], plain[0])
                                 and torch.equal(got[1], plain[1])
                                 and torch.equal(got[2], plain[2])),
            "steps_equal_plain": bool(torch.equal(got[1], plain[1]))}
    order = list(runs)
    for name in order + order[::-1]:
        result["ms"][name].append(cuda_ms(lambda: runs[name](ts), REPS,
                                          warmup=1))
    result["pow_probe"] = pow_probe(dev)
    print(smi)
    for name in order:
        print(f"K29 {name}: {np.mean(result['ms'][name]):.4f} ms a sweep, "
              f"equal to plain: {result[name]['equals_plain']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
