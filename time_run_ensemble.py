#!/usr/bin/env python3
"""Times the port's `run_ensemble` on chip_smoke.py's main path: ex5 at
B=16384, L=4096, E=256 for 2,000 rounds on K1's plane path
(``bitslice=False``), the process's first call and then the same call
again, by CUDA events.

    python3 time_run_ensemble.py [--window-counts] [ROOT]

ROOT is the root of a checkout whose port is imported (default: this
script's own), so two commits can be timed alike on one card. The
kernels are built and loaded before the first call; nothing else runs
on the card before it. With ``--window-counts`` it then times K2
(`_window_counts_int`) on each tape of `card_timing.k2_tapes`, the
first call's final tapes among them. Prints the card's name and power
limit, then a line a call (and a tape), then one JSON object. Needs one
CUDA card and `nvcc`.
"""

import argparse
import hashlib
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from card_timing import cuda_ms, k2_tapes

B, L, E, NUM_STEPS = 16384, 4096, 256, 2000
CALLS = 5
TAG = "ex5-msrtf-machine"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(Path(__file__).parent))
    ap.add_argument("--window-counts", action="store_true",
                    help="also time K2 on each tape of k2_tapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_run_ensemble: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    pkg = "chemical_kinetics_and_program_execution_torch"
    cuda = importlib.import_module(f"{pkg}.cuda")
    ens = importlib.import_module(f"{pkg}.engine.ensemble")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    dev = torch.device("cuda")
    dm = ens.compile_decision_machine(TAG)
    cuda.load()  # K2, and K1 where the checkout builds it with K2
    if importlib.util.find_spec(f"{pkg}.engine.k1_source") is not None:
        importlib.import_module(f"{pkg}.engine.k1_source").k1_library(dm)
    gen = torch.Generator(device=dev).manual_seed(0)
    ptape = torch.randint(0, 3, (B, L), generator=gen, device=dev,
                          dtype=torch.int32)
    dtape = torch.zeros((B, L), dtype=torch.int32, device=dev)
    state = gen.get_state()
    us = []
    for call in range(CALLS):
        gen.set_state(state)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ens.run_ensemble(gen, (ptape, dtape), dm, (NUM_STEPS, E),
                               bitslice=False, device=dev)[0]
        end.record()
        torch.cuda.synchronize()
        us.append(start.elapsed_time(end) * 1e3 / NUM_STEPS)
        print(f"call {call}: {us[-1]:.2f} us a round", flush=True)
        if call == 0:
            final = out
    result = {"root": args.root, "us_per_round": us}
    if args.window_counts:
        del ptape, dtape, out
        result["k2_ms"] = {}
        for name, tape, size_a, cl_k in k2_tapes(*final, gen):
            counts = ens._window_counts_int(tape, size_a, cl_k)
            digest = hashlib.sha256(counts.cpu().numpy().tobytes())
            ms = cuda_ms(lambda: ens._window_counts_int(tape, size_a, cl_k),
                         20)
            result["k2_ms"][name] = ms
            print(f"K2 {name} (size_a {size_a}, cl_k {cl_k}): {ms:.4f} ms; "
                  f"counts sha256 {digest.hexdigest()[:16]}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
