#!/usr/bin/env python3
"""Runs the PyTorch port's main path on one NVIDIA card and checks it.

    python3 chip_smoke.py

from the root of the repository. Needs one CUDA card, `nvcc` and
`nvidia-smi`; imports no jax and nothing of the JAX package. Exits
non-zero, printing no result, without a card or outside the repository.

Phases (each prints its wall time; every check raises on failure):

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit;
2. build: `nvcc` calls started together, one for `csrc/*.cu` (K2) and
   one for K1's generated unit of each machine, each with its seconds
   and its `-Xptxas -v` register, shared-memory and spill lines;
3. main path: `run_ensemble` at B=16384, L=4096, E=256 on
   ex5-msrtf-machine for 2,000 rounds, then `window_counts` at cl_k=3;
   K1 must launch exactly 2,000 times and the plain round never, K2
   once; per-round time and transitions/s of the process's first call
   (cold: PyTorch loads its own kernels on their first launch and the
   allocator takes the buffers from the card) and of the same call
   again (warm), which must give the same tapes; each kernel's time
   (CUDA events) beside its bound, its plain version and the library
   call, K2's on each tape of `card_timing.k2_tapes` (the main
   path's final tapes, uniform, constant, 15,625 and 16,384 bins); the
   host's cost a launch, by one `plane_round` call a round and by
   `run_rounds`' one call for all rounds;
4. kernels against their plain versions on the card, at full width:
   K1 on ex5-msrtf-machine, ex4-chemical-turing and
   ex2-ferromagnetic-chain, one round at every phase in [0, 16), planes
   bit-identical after each, at E=256 (the word path) and at E=255
   (the byte path, an E that is not a multiple of 4); K2 against its
   plain version and `torch.bincount` (on bins found apart from the
   port's), exactly equal, on each of those tapes, on one with symbols
   outside [0, size_a), at 65,536 bins (the histogram in device
   memory) and on rows of 4,095 symbols (loads a symbol a lane), the
   last three also timed;
5. end to end on a small input: explicit draws through the card and
   through the CPU's plain path give the same tapes and window counts.

The line before the last is the `kernels` JSON object; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as ens,
)
from chemical_kinetics_and_program_execution_torch.engine import k1_source
from card_timing import cuda_ms, k2_tapes

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
B, L = 16384, 4096
E = L // 16
STRIDE = L // E
E_TAIL = E - 1  # the byte path: an E that is not a multiple of 4
NUM_STEPS = 2000
CL_K = 3
MAIN_TAG = "ex5-msrtf-machine"
TAGS = ["ex5-msrtf-machine", "ex4-chemical-turing", "ex2-ferromagnetic-chain"]
# Symbols that reach ex4's reverse reaction at a useful rate.
ACTIVE_SYMBOLS = {"ex4-chemical-turing": ((6, 7), (0, 1, 2, 3, 4, 5))}
K1_REPLACES = ("probes/pallas_plane_round.py:41 fsm_kernel; "
               "probes/pallas_packed32.py:126 fsm_kernel_packed; the JAX "
               "package's engine/ensemble.py:1170 "
               "_apply_plane_round_fsm_stacked (XLA)")
K2_REPLACES = ("the JAX package's engine/ensemble.py:2919 window_counts "
               "(XLA)")


def say(*parts):
    print(*parts, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        say(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            say(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s")
        return False


def active_draws(gen, tag, dm, device, events=E):
    """Full-width planes over each tape's active symbols, and uniforms a
    third each near 0, near 1 and anywhere in [0, 1)."""
    p_sym, d_sym = ACTIVE_SYMBOLS.get(tag, (range(dm.size_a),) * 2)
    planes = []
    for sym in (p_sym, d_sym):
        sym = torch.as_tensor(list(sym), dtype=torch.int8, device=device)
        idx = torch.randint(0, len(sym), (STRIDE, B, events), generator=gen,
                            device=device)
        planes.append(sym[idx].contiguous())
    u = torch.rand((STRIDE, B, events), generator=gen, device=device)
    pick = torch.randint(0, 3, (STRIDE, B, events), generator=gen,
                         device=device)
    u = torch.where(pick == 0, u * 1e-3,
                    torch.where(pick == 1, 0.95 + 0.05 * u, u))
    return planes[0], planes[1], u.contiguous()


def k1_against_plain(gen, tag, dm, dev, events):
    """K1 and its plain version, one round at every phase on the same
    planes; raises unless bit-identical after each. Returns K1's planes,
    the uniforms, the largest difference and the cells changed."""
    kp, kd, u = active_draws(gen, tag, dm, dev, events)
    pp, pd = kp.clone(), kd.clone()
    start_p, start_d = kp.clone(), kd.clone()
    shifts = torch.as_tensor(
        np.random.RandomState(len(tag)).permutation(STRIDE),
        dtype=torch.int32, device=dev)
    for k in range(STRIDE):
        uk = u[k] if dm.has_choose else None
        ens.plane_round(dm, kp, kd, shifts, k, uk)
        ens.plane_round_plain(dm, pp, pd, shifts, k, uk)
        torch.cuda.synchronize()
        if not (torch.equal(kp, pp) and torch.equal(kd, pd)):
            raise AssertionError(
                f"K1 != plain on {tag}, E={events}, at round {k} "
                f"(shift {int(shifts[k])})")
    err = max(int((x.to(torch.int32) - y.to(torch.int32)).abs().max())
              for x, y in ((kp, pp), (kd, pd)))
    changed = int((kd != start_d).sum() + (kp != start_p).sum())
    if changed == 0:
        raise AssertionError(f"K1 changed nothing on {tag}, E={events}")
    return kp, kd, u, err, changed


def k1_bytes(dm, events=E):
    """Least bytes a round moves: a byte a site for each window cell the
    round must read and each it must write (`k1_source.cell_traffic`),
    plus one float32 uniform a site for a machine with chooses."""
    read, written = k1_source.cell_traffic(dm)
    return B * events * (len(read) + len(written)
                         + (4 if dm.has_choose else 0))


def yardstick_bins(tape, size_a, cl_k):
    """The bin of every window that the reference counts, found apart
    from the port's `window_bins` for the `torch.bincount` yardstick:
    each rank as sum_j tape[:, (i+j) mod L] * (size_a**(cl_k-1-j) mod
    2**32), taken mod 2**32 by `torch.remainder` and read as an int32;
    a rank in [-n, 0) counts in bin rank + n, any other outside [0, n)
    is dropped."""
    n, L = size_a**cl_k, tape.shape[1]
    cols = torch.arange(L, device=tape.device)
    rank = torch.zeros(tape.shape, dtype=torch.int64, device=tape.device)
    for j in range(cl_k):
        term = tape[:, (cols + j) % L].to(torch.int64) * pow(
            size_a, cl_k - 1 - j, 2**32)
        rank = torch.remainder(rank + torch.remainder(term, 2**32), 2**32)
    rank = torch.where(rank >= 2**31, rank - 2**32, rank)
    rank = torch.where(rank < 0, rank + n, rank)
    return rank[(rank >= 0) & (rank < n)]


def k2_bytes(n_bins):
    """Least bytes K2 moves: the [B, L] int32 tape read once and the
    int64 counts written once."""
    return B * L * 4 + n_bins * 8


def main(dev=None):
    """Runs every phase on ``dev`` (the first CUDA card when None)."""
    if dev is None:
        if not torch.cuda.is_available():
            print("chip_smoke: torch.cuda.is_available() is False; this "
                  "script needs an NVIDIA card", file=sys.stderr)
            return 1
        dev = torch.device("cuda")

    with Phase("1 device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        smi_line = smi.splitlines()[0]
        say(f"device: {kind} (count {count}); torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
        say(smi_line)

    with Phase("2 build"):
        machines = {tag: ens.compile_decision_machine(tag) for tag in TAGS}
        jobs = {"K2 (csrc/*.cu)": cuda.build}
        for tag, dm in machines.items():
            src = k1_source.k1_source(dm)
            jobs[f"K1 {tag}"] = (lambda src=src: cuda.build_unit("k1", src))
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = {name: pool.submit(fn) for name, fn in jobs.items()}
            built = {name: f.result() for name, f in futures.items()}
        for name, (path, log, seconds) in built.items():
            say(f"{name}: nvcc {seconds:.2f} s -> {path.name}"
                if seconds else f"{name}: already built: {path.name}")
            for line in log.splitlines():
                if any(w in line for w in ("Compiling entry", "registers",
                                           "spill", "smem")):
                    say("  " + line.strip())
        cuda.load()
        for dm in machines.values():
            k1_source.k1_library(dm)

    kernels = {}
    max_err = {"K1": 0, "K2": 0}
    with Phase("3 main path"):
        dm = machines[MAIN_TAG]
        say(f"{MAIN_TAG}: {dm.n_cells} window cells, {len(dm.nodes)} "
            f"decision nodes, {dm.num_specs} write specs, "
            f"{len(ens._level_plan(dm))} levels")
        gen = torch.Generator(device=dev).manual_seed(0)
        ptape = torch.randint(0, 3, (B, L), generator=gen, device=dev,
                              dtype=torch.int32)
        dtape = torch.zeros((B, L), dtype=torch.int32, device=dev)
        gen_state = gen.get_state()
        torch.cuda.synchronize()

        def main_path(label):
            """One `run_ensemble` call from ``gen_state`` and one
            `window_counts`, counts set to 0 just before and read just
            after; returns the outputs and the call's device ms."""
            gen.set_state(gen_state)
            ens.plane_round.launches = 0
            ens.plane_round_plain.calls = 0
            ens.window_counts.launches = 0
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = ens.run_ensemble(gen, (ptape, dtape), dm, (NUM_STEPS, E),
                                   device=dev)
            end.record()
            spd = ens.window_counts(out[0][0], dm.size_a, CL_K, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"plane_round": ens.plane_round.launches,
                        "window_counts": ens.window_counts.launches}
            plain_calls = ens.plane_round_plain.calls
            say(f"{label}: launches {launches}, plain round calls "
                f"{plain_calls}; wall {wall:.3f} s")
            if launches["plane_round"] != NUM_STEPS or plain_calls != 0:
                raise AssertionError("main path did not run K1 once a round")
            if launches["window_counts"] != 1:
                raise AssertionError("main path did not run K2")
            return out, spd, launches, start.elapsed_time(end)

        # The process's first call (cold) and the same call again (warm).
        ((pt, dt), (applied, times)), spd, launches, run_ms = main_path(
            "cold call")
        ((pt_w, dt_w), _), spd_w, _, warm_ms = main_path("warm call")
        if not (torch.equal(pt, pt_w) and torch.equal(dt, dt_w)
                and torch.equal(spd, spd_w)):
            raise AssertionError("the warm call differs from the cold one")
        del pt_w, dt_w

        # What came out: valid symbols, the run's bookkeeping, an SPD.
        if pt.shape != (B, L) or pt.dtype != torch.int32:
            raise AssertionError(f"tapes {tuple(pt.shape)} {pt.dtype}")
        for t in (pt, dt):
            if int(t.min()) < 0 or int(t.max()) >= dm.size_a:
                raise AssertionError("symbol out of range")
        if not torch.all(applied == B * E):
            raise AssertionError("applied counts")
        want_t = -math.log1p(-E / L) * NUM_STEPS
        if not (torch.all(torch.isfinite(times))
                and abs(float(times[-1]) - want_t) <= 1e-12 * want_t):
            raise AssertionError("times")
        if not (torch.all(torch.isfinite(spd))
                and abs(float(spd.sum()) - 1.0) < 1e-12
                and spd.shape == (dm.size_a**CL_K,)):
            raise AssertionError("window_counts")
        if int((dt != 0).sum()) == 0:
            raise AssertionError("the data tape never changed")
        ms_round, warm_round = run_ms / NUM_STEPS, warm_ms / NUM_STEPS
        for label, ms in (("cold", run_ms), ("warm", warm_ms)):
            say(f"run_ensemble, {label}: {ms:.3f} ms for {NUM_STEPS} rounds "
                f"(tape<->plane conversion included): "
                f"{ms / NUM_STEPS * 1e3:.2f} us/round, "
                f"{B * E * NUM_STEPS / (ms * 1e-3):.4e} transitions/s")
        say(f"first call's extra cost: {run_ms - warm_ms:.3f} ms")
        say(f"SPD(cl_k={CL_K}) top windows: "
            f"{torch.topk(spd, 3).indices.tolist()}")

        # K1 over the run's own rounds: the same start and shifts (the
        # run's first draw), launched by run_rounds, once behind a
        # sleeping stream (device time) and once as the run launches
        # them (the host's pacing included).
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        replay = torch.Generator(device=dev)
        replay.set_state(gen_state)
        run_shifts = torch.randint(0, STRIDE, (NUM_STEPS,), generator=replay,
                                   device=dev, dtype=torch.int32)
        start_p = ens._tape_to_planes(ptape.to(torch.int8), STRIDE)
        start_d = ens._tape_to_planes(dtape.to(torch.int8), STRIDE)
        p_st, d_st = start_p.clone(), start_d.clone()
        replay_ms = cuda_ms(lambda: ens.run_rounds(dm, p_st, d_st,
                                                   run_shifts),
                            1, warmup=0) / NUM_STEPS
        if not (torch.equal(ens._planes_to_tape(p_st).to(torch.int32), pt)
                and torch.equal(ens._planes_to_tape(d_st).to(torch.int32),
                                dt)):
            raise AssertionError("replayed rounds differ from the run")
        p_st, d_st = start_p.clone(), start_d.clone()
        torch.cuda.synchronize()
        start.record()
        ens.run_rounds(dm, p_st, d_st, run_shifts)
        end.record()
        torch.cuda.synchronize()
        paced_ms = start.elapsed_time(end) / NUM_STEPS
        say(f"K1 over the run's {NUM_STEPS} rounds: {replay_ms * 1e3:.2f} "
            f"us a round device time, {paced_ms * 1e3:.2f} us a round as "
            f"launched; run_ensemble {ms_round * 1e3:.2f} us a round cold, "
            f"{warm_round * 1e3:.2f} warm")
        del start_p, start_d

        # K1 alone, on the run's final planes and a fresh random shift
        # sequence, as the run launches it.
        p_st = ens._tape_to_planes(pt.to(torch.int8), STRIDE)
        d_st = ens._tape_to_planes(dt.to(torch.int8), STRIDE)
        reps = 500
        shifts = torch.randint(0, STRIDE, (reps + 3,), generator=gen,
                               device=dev, dtype=torch.int32)
        it = iter(range(reps + 3))
        host = []
        k1_ms = cuda_ms(lambda: ens.plane_round(dm, p_st, d_st, shifts,
                                                next(it)), reps, host=host)
        host_c = []
        rounds_ms = cuda_ms(lambda: ens.run_rounds(dm, p_st, d_st, shifts),
                            1, warmup=1, host=host_c) / len(shifts)
        it = iter(range(5 + 3))
        k1_plain_ms = cuda_ms(lambda: ens.plane_round_plain(
            dm, p_st, d_st, shifts, next(it)), 5)
        k1_bound = k1_bytes(dm) / HBM_BYTES_PER_S * 1e3
        host_us = host[0] * 1e3
        host_c_us = host_c[0] * 1e3 / len(shifts)
        say(f"K1: {k1_ms * 1e3:.2f} us/round against a bound of "
            f"{k1_bound * 1e3:.2f} us ({k1_bytes(dm) / 1e6:.2f} MB at "
            f"3.35 TB/s): {k1_bound / k1_ms:.3f} of the bound; "
            f"plain {k1_plain_ms:.3f} ms; {rounds_ms * 1e3:.2f} us a round "
            f"by run_rounds")
        say(f"host a launch: {host_us:.2f} us by plane_round (checks + "
            f"one ctypes call a round), {host_c_us:.2f} us by run_rounds "
            f"(one check and one ctypes call for {len(shifts)} rounds)")

        # K2 on the main path's tape and on the tapes that tell skew
        # from index arithmetic, each beside its bound, its plain version
        # and torch.bincount on the same bins.
        k2_inputs = k2_tapes(pt, dt, gen)
        k2_times = {}
        for name, tape, size_a, cl_k in k2_inputs:
            bins = yardstick_bins(tape, size_a, cl_k)
            k2_times[name] = {
                "ms": cuda_ms(lambda: ens._window_counts_int(
                    tape, size_a, cl_k), 20),
                "plain_ms": cuda_ms(lambda: ens.window_counts_plain(
                    tape, size_a, cl_k), 3),
                "library_ms": cuda_ms(lambda: torch.bincount(
                    bins, minlength=size_a**cl_k), 20),
                "bound_ms": k2_bytes(size_a**cl_k) / HBM_BYTES_PER_S * 1e3,
                "bins": size_a**cl_k}
            del bins
            t = k2_times[name]
            say(f"K2 {name} ({t['bins']} bins): {t['ms']:.4f} ms against a "
                f"bound of {t['bound_ms']:.4f} ms "
                f"({t['bound_ms'] / t['ms']:.3f} of it); plain "
                f"{t['plain_ms']:.4f} ms; torch.bincount on the bins "
                f"{t['library_ms']:.4f} ms")
        k2_main = k2_times[k2_inputs[0][0]]

    with Phase("4 kernels against plain versions (full width)"):
        gen = torch.Generator(device=dev).manual_seed(1234)
        for tag, dm in machines.items():
            for events in (E, E_TAIL):
                kp, kd, u, err, changed = k1_against_plain(gen, tag, dm,
                                                           dev, events)
                max_err["K1"] = max(max_err["K1"], err)
                it = iter(range(10 ** 9))
                cycle = torch.arange(STRIDE, dtype=torch.int32, device=dev)
                ms = cuda_ms(lambda: ens.plane_round(
                    dm, kp, kd, cycle, next(it) % STRIDE,
                    u[0] if dm.has_choose else None), 200)
                bound = k1_bytes(dm, events)
                say(f"K1 {tag}, E={events}: {STRIDE} rounds bit-identical "
                    f"to plain; {changed} cells changed; {ms * 1e3:.2f} us "
                    "a round (every phase in turn), bound "
                    f"{bound / HBM_BYTES_PER_S * 1e6:.2f} us")
                del kp, kd, u

        # K2 on every timed tape; on one with symbols outside [0,
        # size_a): negative ones, and ones whose int32 rank wraps; on
        # 65,536 bins (256 KB, above the block's shared memory: the
        # histogram in device memory); and on rows of L - 1 symbols
        # (the symbol-a-lane loads, not the 16-byte ones).
        by_name = {name: t for name, t, _, _ in k2_inputs}
        uniform5 = by_name["uniform 5"]
        uniform2 = by_name["uniform 2, cl_k 14"]
        wrap = 2**32 // 5 ** (CL_K - 1) + 1
        pick = torch.randint(0, 10, (B, L), generator=gen, device=dev)
        negative = -torch.randint(1, 6, (B, L), generator=gen, device=dev,
                                  dtype=torch.int32)
        odd = torch.where(pick == 0, negative, uniform5)
        odd = torch.where(pick == 1, wrap, odd)
        odd = torch.where(pick == 2, -wrap, odd).to(torch.int32)
        del pick, negative
        more = [("out of range", odd, 5, CL_K),
                ("uniform 2, cl_k 16", uniform2, 2, 16),
                (f"uniform 5, L {L - 1}", uniform5[:, :L - 1].contiguous(),
                 5, CL_K)]
        for name, tape, size_a, cl_k in more:
            ms = cuda_ms(lambda: ens._window_counts_int(tape, size_a, cl_k),
                         20)
            say(f"K2 {name} ({size_a**cl_k} bins): {ms:.4f} ms")
        for name, tape, size_a, cl_k in k2_inputs + more:
            got = ens._window_counts_int(tape, size_a, cl_k)
            plain = ens.window_counts_plain(tape, size_a, cl_k)
            lib = torch.bincount(yardstick_bins(tape, size_a, cl_k),
                                 minlength=size_a**cl_k)
            torch.cuda.synchronize()
            max_err["K2"] = max(max_err["K2"], int(torch.maximum(
                (got - plain).abs().max(), (got - lib).abs().max())))
            if not (torch.equal(got, plain) and torch.equal(got, lib)):
                raise AssertionError(f"K2 != plain / bincount on {name}")
            say(f"K2 {name}: {size_a**cl_k} bins over "
                f"{tape.shape[0]}x{tape.shape[1]} sites "
                f"({int(got.sum())} counted) equal to plain and "
                "torch.bincount")
        del k2_inputs, by_name, more, uniform5, uniform2, odd, tape
        torch.cuda.empty_cache()

    kernels["K1"] = {
        "name": "K1 plane_round", "route": "cuda",
        "source": "chemical_kinetics_and_program_execution_torch/csrc/"
                  "plane_round.cuh",
        "replaces": K1_REPLACES, "launches": launches["plane_round"],
        "max_abs_err": max_err["K1"],
        "match": "bit-identical on ex5, ex4, ex2 at E=256 and E=255",
        "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
        "bound_by": "bytes", "library_ms": None,
        "run_ms_per_round": {"cold": ms_round, "warm": warm_round},
        "run_rounds_ms_per_round": {"device": replay_ms,
                                    "as_launched": paced_ms},
        "host_us_per_launch": {"plane_round": host_us,
                               "run_rounds": host_c_us},
    }
    kernels["K2"] = {
        "name": "K2 window_counts", "route": "cuda",
        "source": "chemical_kinetics_and_program_execution_torch/csrc/"
                  "window_counts.cu",
        "replaces": K2_REPLACES, "launches": launches["window_counts"],
        "max_abs_err": max_err["K2"],
        "match": "exact vs plain and torch.bincount on every tape",
        "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"], "bound_by": "bytes",
        "library_ms": k2_main["library_ms"], "tapes": k2_times,
    }


    with Phase("5 end to end against the CPU on a small input"):
        dm = ens.compile_decision_machine("ex4-chemical-turing")
        rng = np.random.RandomState(5)
        b, l, e, n = 64, 256, 16, 50
        tapes = [rng.randint(0, dm.size_a, (b, l)).astype(np.int32)
                 for _ in range(2)]
        shifts = rng.randint(0, l // e, n).astype(np.int32)
        u = rng.rand(n, b, e).astype(np.float32)
        out = []
        for d in (dev, torch.device("cpu")):
            p_st, d_st = (ens._tape_to_planes(
                torch.as_tensor(t, device=d).to(torch.int8), l // e)
                for t in tapes)
            ens.run_rounds(dm, p_st, d_st, torch.as_tensor(shifts, device=d),
                           torch.as_tensor(u, device=d))
            st = ens.PlaneState(p_st, d_st, batch=b, length=l)
            pt_, dt_ = st.tapes()
            out.append((pt_.cpu(), dt_.cpu(),
                        ens.window_counts(dt_, dm.size_a, 2,
                                          device=d).cpu()))
        for x, y in zip(*out):
            if not torch.equal(x, y):
                raise AssertionError("card and CPU runs differ")
        say(f"ex4 {n} rounds at B={b}, L={l}: card == CPU (tapes and "
            "window counts)")

    say(json.dumps({"kernels": list(kernels.values())}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
