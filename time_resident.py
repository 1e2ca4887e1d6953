#!/usr/bin/env python3
"""Times the resident rounds on one CUDA card: K11's tempered entry, K24
(`ledger_round`), K23 (`sigma_round`) and K10 (`table_round`), at the
shapes `chip_smoke.py` phases 12 (a), 13 (a) and 9 (a) launch them, and
the main paths that run them.

    python3 time_resident.py [ROOT] [--reps N]
                             [--only k11t,k24,k23,k10,small]
                             [--k11t-tiles 256,512] [--k24-tiles 8,10]
                             [--k23-tiles 6,8] [--k10-tiles 2,3]
                             [--k10-chunks 26,27,28]

K11t: ex2 at tau 0.5, K = 10^6, L = 64, E = 4 (phase 12 (a)): device µs
a round by CUDA events of a call of 64 rounds (about a block's chunk of
draws in a port that draws 2^28 uniforms a chunk: 67 rounds), of 8 (the
chunk of 2^25) and of 1. K24: ex4var2 at B = 16384, L = 4096, E = 256
(phase 13 (a), `examples/ex4var2_ledger.py`'s G, beta_eff 2 and tape
mix): the same three calls. K23: ex2 at the same geometry (phase 13
(a)'s tapes: an empty program tape, random spins): the same three
calls. K10: ex5's transition table at the same geometry (phase 9 (a):
float64 uniforms, one outcome a row) in calls of 32 rounds (the chunk
of 2^27 float64 uniforms), 8 and 1, and ex4's (three outcomes a row,
uniforms read) in calls of 32 and 1. The paths, by CUDA events, draws
included: `run_weighted_frontier_blocked` on ex2 at tau 0.5, plan (6,
512, 4), ms a block; `run_ensemble_ledger`, `run_ensemble_sigma` and
`run_ensemble` with ex5's table, each of 200 rounds, ms a round; each
with the kernel's launches. ``small``: the paths' short calls at small
geometries, K10 in calls of 12 rounds at phase 9's d:323 geometry (512
members, L = 10, E = 1) and K23 in calls of 6 at phase 13 (b)'s (8,192
members, L = 12, E = 1), resident against a launch a round in the same
tree (where ROOT's port has the resident forms).

With ``--k11t-tiles``, ``--k24-tiles``, ``--k23-tiles`` or
``--k10-tiles`` the 64-round (K10: 32-round) call is also timed at each
tile given (members a block; the port's tile function is replaced for
that call, the threads and bytes by its rule), for tuning
`ensemble.k11_tempered_tile`, `thermo.k24_tile`, `thermo.k23_tile` and
`ensemble.k10_tile`. ``--k10-chunks`` times the table path at each
`ensemble._TABLE_CHUNK` of 2^N uniforms given. K23's and K10's options
only where ROOT's port has the resident forms.

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
TABLE_CALLS = (32, 8, 1)
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


def sigma_rows(m, dev, reps, tiles=()):
    ens, th = m["ensemble"], m["thermo"]
    dm = ens.compile_decision_machine("ex2-ferromagnetic-chain")
    tables = th.sigma_spec_tables(dm)
    tabs = th.device_tables(tables, device=dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    pt = torch.zeros((TH_B, TH_L), dtype=torch.int8, device=dev)
    dt = torch.randint(0, 2, (TH_B, TH_L), generator=gen, device=dev,
                       dtype=torch.int8)
    accs = (torch.zeros(TH_B, dtype=torch.float64, device=dev),
            torch.zeros(TH_B, dtype=torch.int32, device=dev))
    u = torch.rand((max(CALLS), TH_B, TH_E), generator=gen, device=dev)
    shifts = torch.randint(0, TH_L, (max(CALLS),), generator=gen,
                           device=dev, dtype=torch.int32)
    out = {}

    def call(n):
        return cuda_ms(lambda: th._sigma_rounds(
            dm, pt, dt, shifts, 0, n, TH_E, u[:n], tabs, *accs),
            reps if n < 8 else max(3, reps // 8), warmup=1) * 1e3 / n

    for n in CALLS:
        before = th.sigma_round.launches
        us = call(n)
        out[f"call {n}"] = us
        print(f"K23 ex2 B={TH_B} L={TH_L} E={TH_E}: a call of {n} rounds "
              f"{us:.3f} µs a round "
              f"({th.sigma_round.launches - before} launches in all)",
              flush=True)
    n = max(CALLS)
    for tile in tiles:
        base = th.k23_tile(TH_B, TH_L, TH_E, dm.num_specs,
                           tables.num_windows)
        fixed = 9 * tables.sigma.size
        per = (base[2] - fixed) // base[0]
        restore = tiled(th, "k23_tile", tile, lambda t, B, L, E, S, W: (
            512 if t * E >= 1024 else 256, t * per + fixed, True))
        us = call(n)
        restore()
        out[f"call {n}, tile {tile}"] = us
        print(f"K23: a call of {n} rounds at {tile} members a block "
              f"{us:.3f} µs a round", flush=True)
    del u
    tapes = (pt.to(torch.int32), dt.to(torch.int32))
    ms, la = path_ms(lambda: th.run_ensemble_sigma(
        gen, tapes, dm, tabs, (TH_ROUNDS, TH_E), device=dev),
        th.sigma_round)
    out["path_ms_round"] = ms / TH_ROUNDS
    out["path_launches"] = la
    print(f"run_ensemble_sigma ex2 {TH_ROUNDS} rounds: "
          f"{ms / TH_ROUNDS:.4f} ms a round, K23 launches {la}", flush=True)
    return out


def table_rows(m, dev, reps, tiles=(), chunks=()):
    ens = m["ensemble"]
    gen = torch.Generator(device=dev).manual_seed(10)
    out = {}
    for tag, calls in (("ex5-msrtf-machine", TABLE_CALLS),
                       ("ex4-chemical-turing", (max(TABLE_CALLS), 1))):
        tdt = ens.device_table(ens.compile_transition_table(tag),
                               device=dev)
        a = tdt.size_a
        pt = torch.randint(0, a, (TH_B, TH_L), generator=gen, device=dev,
                           dtype=torch.int32)
        dt = torch.randint(0, a, (TH_B, TH_L), generator=gen, device=dev,
                           dtype=torch.int32)
        u = torch.rand((max(calls), TH_B, TH_E), generator=gen, device=dev,
                       dtype=torch.float64)
        shifts = torch.randint(0, TH_L, (max(calls),), generator=gen,
                               device=dev, dtype=torch.int32)

        def call(n):
            return cuda_ms(lambda: ens._lattice_rounds(
                tdt, pt, dt, shifts, 0, n, TH_E, u[:n]),
                reps if n < 8 else max(3, reps // 8), warmup=1) * 1e3 / n

        short = tag.split("-")[0]
        for n in calls:
            before = ens.table_round.launches
            us = call(n)
            out[f"{short} call {n}"] = us
            print(f"K10 {tag} B={TH_B} L={TH_L} E={TH_E}: a call of {n} "
                  f"rounds {us:.3f} µs a round "
                  f"({ens.table_round.launches - before} launches in all)",
                  flush=True)
        if hasattr(ens, "k10_tile") and short == "ex5":
            n = max(calls)
            base = ens.k10_tile(TH_B, TH_L, TH_E)
            for tile in tiles:
                passes = -(-tile * TH_E // 512)
                restore = tiled(ens, "k10_tile", tile, lambda t, B, L, E: (
                    -(-(-(-t * E // passes)) // 32) * 32,
                    t * base[2] // base[0]))
                us = call(n)
                restore()
                out[f"{short} call {n}, tile {tile}"] = us
                print(f"K10: a call of {n} rounds at {tile} members a block "
                      f"{us:.3f} µs a round", flush=True)
        del u
        if short != "ex5":
            continue
        start = (pt.clone(), dt.clone())
        limits = ([2**c for c in chunks] if hasattr(ens, "_TABLE_CHUNK")
                  else []) or [None]
        for limit in limits:
            if limit is not None:
                saved, ens._TABLE_CHUNK = ens._TABLE_CHUNK, limit
            ms, la = path_ms(lambda: ens.run_ensemble(
                gen, start, tdt, (TH_ROUNDS, TH_E), device=dev),
                ens.table_round)
            if limit is not None:
                ens._TABLE_CHUNK = saved
            key = "" if limit is None else f", chunk 2^{limit.bit_length() - 1}"
            out[f"path_ms_round{key}"] = ms / TH_ROUNDS
            out[f"path_launches{key}"] = la
            print(f"run_ensemble ex5 table {TH_ROUNDS} rounds{key}: "
                  f"{ms / TH_ROUNDS:.4f} ms a round, K10 launches {la}",
                  flush=True)
        torch.cuda.empty_cache()
    return out


def small_rows(m, dev, reps):
    """The short calls of the paths' small geometries, resident against
    the launch a round in the same tree (the tile functions replaced by
    None): K10 in calls of 12 rounds at phase 9's d:323 geometry (512
    members, L = 10, E = 1; ex2's table) and K23 in calls of 6 at phase
    13 (b)'s (ex2, 8,192 members, L = 12, E = 1)."""
    ens, th = m["ensemble"], m["thermo"]
    if not hasattr(ens, "k10_tile"):
        return {}
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {}
    tdt = ens.device_table(
        ens.compile_transition_table("ex2-ferromagnetic-chain"), device=dev)
    pt, dt = (torch.randint(0, 2, (512, 10), generator=gen, device=dev,
                            dtype=torch.int32) for _ in range(2))
    u = torch.rand((12, 512, 1), generator=gen, device=dev,
                   dtype=torch.float64)
    sh = torch.randint(0, 10, (12, 512), generator=gen, device=dev,
                       dtype=torch.int32)
    dm = ens.compile_decision_machine("ex2-ferromagnetic-chain")
    tabs = th.device_tables(th.sigma_spec_tables(dm), device=dev)
    p8, d8 = (torch.randint(0, 2, (8192, 12), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    u8 = torch.rand((6, 8192, 1), generator=gen, device=dev)
    sh8 = torch.randint(0, 12, (6, 8192), generator=gen, device=dev,
                        dtype=torch.int32)
    accs = (torch.zeros(8192, dtype=torch.float64, device=dev),
            torch.zeros(8192, dtype=torch.int32, device=dev))
    for form in ("resident", "a launch a round"):
        saved = ens.k10_tile, th.k23_tile
        if form != "resident":
            ens.k10_tile = th.k23_tile = lambda *a, **k: None
        us10 = cuda_ms(lambda: ens._lattice_rounds(tdt, pt, dt, sh, 0, 12, 1,
                                                   u), reps, warmup=2) * 1e3
        us23 = cuda_ms(lambda: th._sigma_rounds(dm, p8, d8, sh8, 0, 6, 1, u8,
                                                tabs, *accs), reps,
                       warmup=2) * 1e3
        ens.k10_tile, th.k23_tile = saved
        out[f"k10 d:323 call of 12, {form}"] = us10
        out[f"k23 (b) call of 6, {form}"] = us23
        print(f"{form}: K10 at d:323's geometry a call of 12 rounds "
              f"{us10:.3f} µs; K23 at 13 (b)'s a call of 6 {us23:.3f} µs",
              flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(Path(__file__).parent))
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--k11t-tiles", default="")
    ap.add_argument("--k24-tiles", default="")
    ap.add_argument("--k23-tiles", default="")
    ap.add_argument("--k10-tiles", default="")
    ap.add_argument("--k10-chunks", default="")
    ap.add_argument("--only", default="k11t,k24,k23,k10,small")
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
    only = args.only.split(",")
    result = {"root": args.root, "card": smi}
    if "k11t" in only:
        result["k11t"] = tempered_rows(m, dev, args.reps,
                                       ints(args.k11t_tiles))
    if "k24" in only:
        result["k24"] = ledger_rows(m, dev, args.reps, ints(args.k24_tiles))
    if "k23" in only:
        result["k23"] = sigma_rows(m, dev, args.reps, ints(args.k23_tiles))
    if "k10" in only:
        result["k10"] = table_rows(m, dev, args.reps, ints(args.k10_tiles),
                                   ints(args.k10_chunks))
    if "small" in only:
        result["small"] = small_rows(m, dev, args.reps)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
