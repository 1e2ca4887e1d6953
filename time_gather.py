#!/usr/bin/env python3
"""Times K7's and K8's launches on one NVIDIA card, the values launch
cut into its phases.

    python3 time_gather.py

from the root of the repository (one card, `nvcc`; imports no jax).
ex4-chemical-turing at cl_k 5 (the gather engine's sizing in
`chip_smoke.py` phase 7), on its scenario-a p0. For each of K7
(`tree_rhs`) and K8 (`chain_rhs`): the call (the values launch and the
scatter), the scatter alone, and two variants of `csrc/gather_rhs.cu`
built apart into the package's `_build/variants/` (the other sources as
they are): the values kernel returning after phase 0 (the dictionaries'
ratios and the signature weights), and K7's returning before its leaves
(phase 0 and the upper levels). By difference: phase 0, K7's upper
levels, K7's leaves, K8's chains. Device times by CUDA events
(`card_timing.cuda_ms`), each variant checked to launch; the plain
call checked equal to the plain version. Prints the card's name and
power limit, then one JSON object.
"""

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from card_timing import cuda_ms
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.engine import (
    compile as tcompile,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    dense as tdense,
)
from chemical_kinetics_and_program_execution_torch.engine import rhs as trhs
from chemical_kinetics_and_program_execution_torch.models.initial_states import (  # noqa: E501
    chemical_turing_p0,
)

TAG, CL_K, REPS = "ex4-chemical-turing", 5, 20
PREP = "  gather_prep(L.g, tid, stride);\n"
LEAVES = "    k7_leaves(L, lv,"
# name -> (edit of gather_rhs.cu, what the values launch then does)
VARIANTS = {
    "phase0": (lambda s: s.replace(PREP, PREP + "  if (L.g.n_sig >= 0) "
                                   "return;\n"),
               "phase 0 alone"),
    "upper": (lambda s: s.replace(LEAVES, "    if (L.n_levels < 0) "
                                  + LEAVES.lstrip()),
              "phase 0 and K7's upper levels"),
}


def build_variant(name):
    """All of `csrc/*.cu` with ``gather_rhs.cu`` edited, into one
    library; returns its path."""
    src = (cuda.CSRC_DIR / "gather_rhs.cu").read_text()
    edited = VARIANTS[name][0](src)
    if edited == src:
        raise AssertionError(f"variant {name}: its edit found nothing")
    out = cuda.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    unit = out / f"gather_rhs_{name}.cu"
    unit.write_text(edited)
    lib = out / f"lib{name}.so"
    inputs = [str(x) for x in cuda.sources() if x.name != "gather_rhs.cu"]
    proc = subprocess.run([cuda.nvcc(), *cuda.NVCC_FLAGS, "-I",
                           str(cuda.CSRC_DIR), "-o", str(lib), *inputs,
                           str(unit)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return lib


def use(path):
    """Binds the wrappers to the library at ``path``."""
    cuda.build = lambda: (path, "", 0.0)
    cuda.load.cache_clear()
    cuda.load()


def main():
    if not torch.cuda.is_available():
        print("time_gather: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        default = pool.submit(cuda.build)
        variants = {n: pool.submit(build_variant, n) for n in VARIANTS}
        libs = {"plain": default.result()[0]}
        libs.update({n: f.result() for n, f in variants.items()})
    compiled = tcompile.compile_problem(TAG, CL_K)
    p = torch.as_tensor(chemical_turing_p0(CL_K, powered_fraction=0.04)
                        .ravel(), device=dev)
    use(libs["plain"])
    low = tdense.pyramids(compiled, p)
    engines = {"K7": (trhs.device_tables(compiled, dev), trhs.tree_rhs,
                      trhs.tree_values_plain),
               "K8": (trhs.chain_tables(compiled, dev), trhs.chain_rhs,
                      trhs.chain_values_plain)}
    out = {"card": smi.splitlines()[0], "problem": f"{TAG} cl_k {CL_K}"}
    for key, (t, kern, values) in engines.items():
        use(libs["plain"])
        if not torch.equal(kern(t, p, low), trhs.gather_plain(t, p)):
            raise AssertionError(f"{key} != its plain version")
        ev = values(t, p, low, tdense.signature_weights_plain(t, p, low))
        row = {"call_ms": cuda_ms(lambda: kern(t, p, low), REPS),
               "scatter_ms": cuda_ms(lambda: trhs.scatter(t, ev), REPS)}
        for name in VARIANTS:
            if name == "upper" and key != "K7":
                continue
            use(libs[name])
            before = kern.launches
            kern(t, p, low)
            if kern.launches != before + t.launches:
                raise AssertionError(f"{key} {name}: launches")
            row[f"{name}_call_ms"] = cuda_ms(lambda: kern(t, p, low), REPS)
        row["phase0_ms"] = row["phase0_call_ms"] - row["scatter_ms"]
        if key == "K7":
            row["upper_levels_ms"] = (row["upper_call_ms"]
                                      - row["phase0_call_ms"])
            row["leaves_ms"] = row["call_ms"] - row["upper_call_ms"]
        else:
            row["chains_ms"] = row["call_ms"] - row["phase0_call_ms"]
        out[key] = row
        print(f"{key}: " + ", ".join(f"{k} {v * 1e3:.1f} us"
                                    for k, v in row.items()), flush=True)
    use(libs["plain"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
