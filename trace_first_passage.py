#!/usr/bin/env python3
"""Times and traces the port's first-passage loop at the examples'
geometry (B=4096, L=128, E=4) on one CUDA card.

    python3 trace_first_passage.py [ROOT]

Two runs, as `chip_smoke.py` phase 9 makes them: `ex2_first_passage.py`'s
(ex2's machine, 4,800 rounds, pattern 1111 on the data tape) and
`ex4_ignition.py`'s (ex4's machine, 1,890 rounds, the first X on the
program tape), both drawing a float32 uniform a site round by round.
For each: the host-clock seconds of a warm `first_passage_times`
call (the tapes made beforehand), its rounds a second and the launches
it counted; then a call of 600 rounds under `torch.profiler`, split into
device microseconds a round by kernel (K11, K12, the uniforms' draw,
anything else), the launch gaps (the CUDA-event span less the device's
busy time) and the host's microseconds a round.

ROOT is the root of a checkout whose port is imported (default: this
script's own), so two commits can be traced alike on one card. Prints
the card's name and power limit, a line a run, then one JSON object.
Needs one CUDA card and `nvcc`.
"""

import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

B, L, E, TRACED = 4096, 128, 4, 600
RUNS = {
    "ex2_first_passage": dict(tag="ex2-ferromagnetic-chain", rounds=4800,
                              pattern=(1, 1, 1, 1), data_tape=True),
    "ex4_ignition": dict(tag="ex4-chemical-turing",
                         rounds=int(round(60.0 / -math.log1p(-E / L))),
                         pattern=(7,), data_tape=False),
}


def kind_of(name):
    low = name.lower()
    if "k11" in low:
        return "K11"
    if "k12" in low:
        return "K12"
    if "distribution" in low or "rand" in low or "philox" in low:
        return "draw"
    return "other"


def device_us(avg):
    """A kernel's device microseconds; 0 for a host op (whose self device
    time repeats its kernels')."""
    kind = getattr(avg, "device_type", None)
    if kind is not None and kind != torch.autograd.DeviceType.CUDA:
        return 0.0
    if avg.key.startswith(("aten::", "cuda")):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(avg, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def tapes_for(pkg, run, dev, seed):
    init = importlib.import_module(f"{pkg}.models.initial_states")
    ens = importlib.import_module(f"{pkg}.engine.ensemble")
    g = torch.Generator(device=dev).manual_seed(seed)
    if run["tag"].startswith("ex2"):
        p0 = init.ferromagnet_p0(6, p_pair=0.02, corrected=True).ravel()
        d = ens.sample_tapes_from_spd(g, p0, 2, 6, B, L, device=dev)
        return torch.zeros_like(d), d
    fuel = init.chemical_turing_p0(4, tape_fraction=0.0,
                                   powered_fraction=0.16).reshape((9,) * 4)
    tape = init.chemical_turing_p0(4, tape_fraction=1.0, cursor_fraction=0.02,
                                   random01=True).reshape((9,) * 4)
    return tuple(ens.sample_tapes_from_spd(g, p, 9, 4, B, L, ring=True,
                                           device=dev) for p in (fuel, tape))


def main():
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parent)
    if not torch.cuda.is_available():
        print("trace_first_passage: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve()))
    pkg = "chemical_kinetics_and_program_execution_torch"
    cuda = importlib.import_module(f"{pkg}.cuda")
    ens = importlib.import_module(f"{pkg}.engine.ensemble")
    k1 = importlib.import_module(f"{pkg}.engine.k1_source")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    cuda.load()
    out = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    for label, run in RUNS.items():
        dm = ens.compile_decision_machine(run["tag"])
        k1.k1_library(dm)
        tapes = tapes_for(pkg, run, dev, 4000)

        def call(rounds, seed):
            return ens.first_passage_times(
                seed, tapes, dm, run["pattern"], (rounds, E),
                data_tape=run["data_tape"], device=dev)

        call(run["rounds"], 1)  # first call: PyTorch's own kernels load
        torch.cuda.synchronize()
        ens.lattice_round.launches = ens.pattern_scan.launches = 0
        t0 = time.perf_counter()
        t_hit, hit, _ = call(run["rounds"], 2)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {"K11": ens.lattice_round.launches,
                    "K12": ens.pattern_scan.launches}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            start.record()
            call(TRACED, 3)
            end.record()
            torch.cuda.synchronize()
            host = time.perf_counter() - h0
        split = dict.fromkeys(("K11", "K12", "draw", "other"), 0.0)
        names = {}
        for avg in prof.key_averages():
            us = device_us(avg)
            if us > 0:
                split[kind_of(avg.key)] += us
                names[avg.key] = us
        span_us = start.elapsed_time(end) * 1e3
        busy = sum(split.values())
        rec = {
            "rounds": run["rounds"], "seconds": sec,
            "rounds_per_s": run["rounds"] / sec, "launches": launches,
            "hits": int(hit.sum()),
            "traced_rounds": TRACED,
            "us_a_round": {k: v / TRACED for k, v in split.items()},
            "gaps_us_a_round": (span_us - busy) / TRACED,
            "span_us_a_round": span_us / TRACED,
            "host_us_a_round": host * 1e6 / TRACED,
            "kernels_us": names}
        out[label] = rec
        print(f"{label}: {run['rounds']} rounds in {sec:.4f} s "
              f"({rec['rounds_per_s']:.1f} rounds/s), launches {launches}, "
              f"{rec['hits']} hits; traced {TRACED} rounds, a round: "
              + ", ".join(f"{k} {v:.3f} us"
                          for k, v in rec["us_a_round"].items())
              + f", gaps {rec['gaps_us_a_round']:.3f} us, span "
              f"{rec['span_us_a_round']:.3f} us, host "
              f"{rec['host_us_a_round']:.3f} us", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
