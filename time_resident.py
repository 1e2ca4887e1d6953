#!/usr/bin/env python3
"""Times K11's tempered entry and K24 (`ledger_round`) on one CUDA card,
at the shapes `chip_smoke.py` phases 12 (a) and 13 (a) launch them, and
the two main paths that run them.

    python3 time_resident.py [ROOT] [--reps N] [--k11t-tiles 256,512]
                             [--k24-tiles 8,10]

K11t: ex2 at tau 0.5, K = 10^6, L = 64, E = 4 (phase 12 (a)): device µs
a round by CUDA events of a call of 64 rounds (about a block's chunk of
draws in a port that draws 2^28 uniforms a chunk: 67 rounds), of 8 (the
chunk of 2^25) and of 1. K24: ex4var2 at B = 16384, L = 4096, E = 256
(phase 13 (a), `examples/ex4var2_ledger.py`'s G, beta_eff 2 and tape
mix): the same three calls. The paths, by CUDA events, draws included:
`run_weighted_frontier_blocked` on ex2 at tau 0.5, plan (6, 512, 4), ms
a block, and `run_ensemble_ledger` of 200 rounds, ms a round; each with
the kernel's launches.

With ``--k11t-tiles`` or ``--k24-tiles`` the 64-round call is also timed
at each tile given (members a block; the port's tile function is
replaced for that call, the threads and bytes by its rule), for tuning
the tile functions `ensemble.k11_tempered_tile` and `thermo.k24_tile`.

ROOT is the root of a checkout whose port is imported (default: this
script's own), so two commits can be timed alike on one card: unpack
the other one with `git archive` under the gitignored `.trees/`, and run
parent, change, change, parent. Prints the card's name and power limit,
a line a measurement, then one JSON object last. Needs one CUDA card
and `nvcc`.
"""

import argparse
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from card_timing import cuda_ms

PKG = "chemical_kinetics_and_program_execution_torch"
FR_K, FR_L, FR_E, FR_PLAN = 1_000_000, 64, 4, (6, 512, 4)
TH_B, TH_L, TH_E, TH_ROUNDS = 16384, 4096, 256, 200
CALLS = (64, 8, 1)
# examples/ex4var2_ledger.py: G over symbols A B C D I O P X S E.
TH_G = [-1.0, -1.0, -1.0, 1.5, 0.0, 0.0, 6.0, 0.0, 0.0, 1.0]


def symbols(gen, syms, probs, shape, dev):
    """int8 symbols drawn with the given probabilities on the card."""
    cum = torch.tensor(probs, dtype=torch.float64).cumsum(0)[:-1]
    idx = torch.searchsorted(cum.to(torch.float32).to(dev),
                             torch.rand(shape, generator=gen, device=dev),
                             right=True)
    return torch.tensor(syms, dtype=torch.int8, device=dev)[idx]


def path_ms(fn, counter):
    """Device ms of one call of ``fn`` by CUDA events after a warm call,
    and ``counter``'s launches in it."""
    fn()
    torch.cuda.synchronize()
    before = counter.launches
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), counter.launches - before


def tiled(mod, name, tile, rule):
    """Replaces ``mod.name`` (a tile function) by one that returns
    ``tile`` members and the threads and bytes ``rule(tile, *args)``
    gives; returns a function that restores it."""
    orig = getattr(mod, name)
    setattr(mod, name, lambda *a: (tile,) + rule(tile, *a))
    return lambda: setattr(mod, name, orig)


def tempered_rows(m, dev, reps, tiles=()):
    ens, tfr = m["ensemble"], m["frontier"]
    dm = ens.compile_decision_machine("ex2-ferromagnetic-chain")
    gen = torch.Generator(device=dev).manual_seed(24)
    pt = torch.randint(0, 2, (FR_K, FR_L), generator=gen, device=dev,
                       dtype=torch.int8)
    dt = torch.randint(0, 2, (FR_K, FR_L), generator=gen, device=dev,
                       dtype=torch.int8)
    lw = torch.full((FR_K,), -math.log(FR_K), dtype=torch.float64,
                    device=dev)
    u = torch.rand((max(CALLS), FR_K, FR_E), generator=gen, device=dev)
    shifts = torch.randint(0, FR_L // FR_E, (max(CALLS),), generator=gen,
                           device=dev, dtype=torch.int32)
    out = {}
    for n in CALLS:
        before = tfr.tempered_round.launches
        us = cuda_ms(lambda: tfr.tempered_round(
            dm, pt, dt, shifts[:n], FR_E, u[:n], 0.5, lw),
            reps if n < 8 else max(3, reps // 8), warmup=1) * 1e3 / n
        calls = tfr.tempered_round.launches - before
        out[f"call {n}"] = us
        print(f"K11t ex2 tau 0.5 K={FR_K} L={FR_L} E={FR_E}: a call of {n} "
              f"rounds {us:.3f} µs a round ({calls} launches in all)",
              flush=True)
    n = max(CALLS)
    for tile in tiles:
        restore = tiled(ens, "k11_tempered_tile", tile, lambda t, B, L: (
            -(-t // 32) * 32, 2 * t * ens.k11_odd_stride(L)))
        us = cuda_ms(lambda: tfr.tempered_round(
            dm, pt, dt, shifts[:n], FR_E, u[:n], 0.5, lw), max(3, reps // 8),
            warmup=1) * 1e3 / n
        restore()
        out[f"call {n}, tile {tile}"] = us
        print(f"K11t: a call of {n} rounds at {tile} members a block "
              f"{us:.3f} µs a round", flush=True)
    del u
    start = (torch.randint(0, 2, (FR_K, FR_L), generator=gen, device=dev,
                           dtype=torch.int8),
             torch.zeros((FR_K, FR_L), dtype=torch.int8, device=dev))
    lw0 = torch.full((FR_K,), -math.log(FR_K), dtype=torch.float64,
                     device=dev)
    ms, la = path_ms(lambda: tfr.run_weighted_frontier_blocked(
        gen, start, lw0, dm, FR_PLAN, tau=0.5, device=dev),
        tfr.tempered_round)
    out["path_ms_block"] = ms / FR_PLAN[0]
    out["path_launches"] = la
    print(f"run_weighted_frontier_blocked ex2 tau 0.5 plan {FR_PLAN}: "
          f"{ms / FR_PLAN[0]:.3f} ms a block, K11t launches {la}",
          flush=True)
    return out


def ledger_rows(m, dev, reps, tiles=()):
    ens, th = m["ensemble"], m["thermo"]
    dm = ens.compile_decision_machine("ex4var2-chemical-turing")
    gen = torch.Generator(device=dev).manual_seed(13)
    pt = symbols(gen, [6, 7, 8, 9], [0.45, 0.05, 0.42, 0.08],
                 (TH_B, TH_L), dev)
    dt = symbols(gen, [0, 4, 5], [0.08, 0.46, 0.46], (TH_B, TH_L), dev)
    g = torch.tensor(TH_G, dtype=torch.float64, device=dev)
    ledger = (g, g, 2.0)
    S = dm.num_specs
    accs = (torch.zeros(TH_B, dtype=torch.float64, device=dev),
            torch.zeros((TH_B, S), dtype=torch.int32, device=dev),
            torch.zeros((TH_B, S), dtype=torch.float64, device=dev))
    u = torch.rand((max(CALLS), TH_B, TH_E), generator=gen, device=dev)
    shifts = torch.randint(0, TH_L, (max(CALLS),), generator=gen,
                           device=dev, dtype=torch.int32)
    out = {}
    for n in CALLS:
        before = th.ledger_round.launches
        us = cuda_ms(lambda: th._ledger_rounds(
            dm, pt, dt, shifts, 0, n, TH_E, u[:n], ledger, *accs),
            reps if n < 8 else max(3, reps // 8), warmup=1) * 1e3 / n
        calls = th.ledger_round.launches - before
        out[f"call {n}"] = us
        print(f"K24 ex4var2 B={TH_B} L={TH_L} E={TH_E}: a call of {n} "
              f"rounds {us:.3f} µs a round ({calls} launches in all)",
              flush=True)
    n = max(CALLS)
    for tile in tiles:
        base = th.k24_tile(TH_B, TH_L, TH_E, S)
        per = (base[2] - 4096) // base[0]
        restore = tiled(th, "k24_tile", tile, lambda t, B, L, E, S_: (
            512 if t * E >= 1024 else 256, t * per + 4096))
        us = cuda_ms(lambda: th._ledger_rounds(
            dm, pt, dt, shifts, 0, n, TH_E, u[:n], ledger, *accs),
            max(3, reps // 8), warmup=1) * 1e3 / n
        restore()
        out[f"call {n}, tile {tile}"] = us
        print(f"K24: a call of {n} rounds at {tile} members a block "
              f"{us:.3f} µs a round", flush=True)
    del u
    tapes = (pt.to(torch.int32), dt.to(torch.int32))
    ms, la = path_ms(lambda: th.run_ensemble_ledger(
        gen, tapes, dm, (TH_G, TH_G, 2.0), (TH_ROUNDS, TH_E), device=dev),
        th.ledger_round)
    out["path_ms_round"] = ms / TH_ROUNDS
    out["path_launches"] = la
    print(f"run_ensemble_ledger ex4var2 {TH_ROUNDS} rounds: "
          f"{ms / TH_ROUNDS:.4f} ms a round, K24 launches {la}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(Path(__file__).parent))
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--k11t-tiles", default="")
    ap.add_argument("--k24-tiles", default="")
    args = ap.parse_args()

    def ints(text):
        return [int(x) for x in text.split(",") if x]

    if not torch.cuda.is_available():
        print("time_resident: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    m = {name: importlib.import_module(f"{PKG}.{path}") for name, path in
         (("cuda", "cuda"), ("ensemble", "engine.ensemble"),
          ("frontier", "engine.frontier"), ("thermo", "ops.thermo"))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    m["cuda"].load()
    result = {"root": args.root, "card": smi,
              "k11t": tempered_rows(m, dev, args.reps,
                                    ints(args.k11t_tiles)),
              "k24": ledger_rows(m, dev, args.reps, ints(args.k24_tiles))}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
