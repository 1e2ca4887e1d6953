#!/usr/bin/env python3
"""Runs the PyTorch port's main path on one NVIDIA card and checks it.

    python3 chip_smoke.py

from the root of the repository. Needs one CUDA card, `nvcc` and
`nvidia-smi`; imports no jax and nothing of the JAX package. Exits
non-zero, printing no result, without a card or outside the repository.

Phases (each prints its wall time; every check raises on failure):

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit;
2. build: one `nvcc` call compiles `csrc/*.cu` (K1 and K2), with the
   `-Xptxas -v` register, shared-memory and spill lines;
3. kernels against their plain versions on the card, at full width:
   K1 on ex5-msrtf-machine, ex4-chemical-turing and
   ex2-ferromagnetic-chain, one round at every phase in [0, 16), planes
   bit-identical after each; K2 against its plain version and
   `torch.bincount`, exactly equal;
4. main path: `run_ensemble` at B=16384, L=4096, E=256 on
   ex5-msrtf-machine for 2,000 rounds, then `window_counts` at cl_k=3;
   K1 must launch exactly 2,000 times and the plain round never, K2
   once; per-round time and transitions/s, and each kernel's time
   (CUDA events) beside its bound, its plain version and the library
   call;
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

import numpy as np
import torch

from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as ens,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
B, L = 16384, 4096
E = L // 16
STRIDE = L // E
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


def cuda_ms(fn, reps, warmup=3, host=None):
    """Mean device milliseconds per call of ``fn`` by CUDA events. A
    sleep kernel holds the stream while the host queues the calls, so
    host-side launch cost does not show in the time; the host's own
    milliseconds per call (queueing only) go to ``host[0]`` when a list
    is given."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if host is not None:
        host[:] = [(time.perf_counter() - t0) * 1e3 / reps]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def active_draws(gen, tag, dm, device):
    """Full-width planes over each tape's active symbols, and uniforms a
    third each near 0, near 1 and anywhere in [0, 1)."""
    p_sym, d_sym = ACTIVE_SYMBOLS.get(tag, (range(dm.size_a),) * 2)
    planes = []
    for sym in (p_sym, d_sym):
        sym = torch.as_tensor(list(sym), dtype=torch.int8, device=device)
        idx = torch.randint(0, len(sym), (STRIDE, B, E), generator=gen,
                            device=device)
        planes.append(sym[idx].contiguous())
    u = torch.rand((STRIDE, B, E), generator=gen, device=device)
    pick = torch.randint(0, 3, (STRIDE, B, E), generator=gen, device=device)
    u = torch.where(pick == 0, u * 1e-3,
                    torch.where(pick == 1, 0.95 + 0.05 * u, u))
    return planes[0], planes[1], u.contiguous()


def k1_bytes(dm):
    """Least bytes a round moves: each window cell read and written once
    (int8), plus one float32 uniform a site for a machine with chooses."""
    return B * E * (2 * dm.n_cells + (4 if dm.has_choose else 0))


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
        path, log, seconds = cuda.build()
        say(f"nvcc: {seconds:.2f} s -> {path.name}"
            if seconds else f"library already built: {path.name}")
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                say("  " + line.strip())
        cuda.load()

    kernels = {}
    max_err = {"K1": 0, "K2": 0}
    with Phase("3 kernels against plain versions (full width)"):
        gen = torch.Generator(device=dev).manual_seed(1234)
        for tag in TAGS:
            dm = ens.compile_decision_machine(tag)
            kp, kd, u = active_draws(gen, tag, dm, dev)
            pp, pd = kp.clone(), kd.clone()
            start_p, start_d = kp.clone(), kd.clone()
            shifts = torch.as_tensor(
                np.random.RandomState(len(tag)).permutation(STRIDE),
                dtype=torch.int32, device=dev)
            plan = ens.device_plan(dm, dev)
            for k in range(STRIDE):
                uk = u[k] if dm.has_choose else None
                ens.plane_round(dm, kp, kd, shifts, k, uk, plan=plan)
                ens.plane_round_plain(dm, pp, pd, shifts, k, uk)
                torch.cuda.synchronize()
                if not (torch.equal(kp, pp) and torch.equal(kd, pd)):
                    raise AssertionError(
                        f"K1 != plain on {tag} at round {k} "
                        f"(shift {int(shifts[k])})")
            for x, y in ((kp, pp), (kd, pd)):
                max_err["K1"] = max(max_err["K1"], int(
                    (x.to(torch.int32) - y.to(torch.int32)).abs().max()))
            changed = int((kd != start_d).sum() + (kp != start_p).sum())
            it = iter(range(10 ** 9))
            cycle = torch.arange(STRIDE, dtype=torch.int32, device=dev)
            ms = cuda_ms(lambda: ens.plane_round(
                dm, kp, kd, cycle, next(it) % STRIDE,
                u[0] if dm.has_choose else None, plan=plan), 200)
            say(f"K1 {tag}: {STRIDE} rounds, shifts {shifts.tolist()}, "
                f"bit-identical to plain; {changed} cells changed; "
                f"{ms * 1e3:.2f} us a round (every phase in turn), bound "
                f"{k1_bytes(dm) / HBM_BYTES_PER_S * 1e6:.2f} us")
            if changed == 0:
                raise AssertionError(f"K1 changed nothing on {tag}")

        tape = torch.randint(0, 5, (B, L), generator=gen, device=dev,
                             dtype=torch.int32)
        got = ens._window_counts_int(tape, 5, CL_K)
        plain = ens.window_counts_plain(tape, 5, CL_K)
        rank = torch.zeros_like(tape, dtype=torch.int64)
        for j in range(CL_K):
            rank = rank * 5 + torch.roll(tape, -j, dims=1)
        lib = torch.bincount(rank.reshape(-1), minlength=5**CL_K)
        torch.cuda.synchronize()
        max_err["K2"] = int(torch.maximum((got - plain).abs().max(),
                                          (got - lib).abs().max()))
        if not (torch.equal(got, plain) and torch.equal(got, lib)):
            raise AssertionError("K2 != plain / bincount")
        say(f"K2: {5**CL_K} bins over {B}x{L} sites equal to plain and "
            "torch.bincount")
        del kp, kd, pp, pd, start_p, start_d, u, tape, rank
        torch.cuda.empty_cache()

    with Phase("4 main path"):
        dm = ens.compile_decision_machine(MAIN_TAG)
        say(f"{MAIN_TAG}: {dm.n_cells} window cells, {len(dm.nodes)} "
            f"decision nodes, {dm.num_specs} write specs, "
            f"{len(ens._level_plan(dm))} levels")
        gen = torch.Generator(device=dev).manual_seed(0)
        ptape = torch.randint(0, 3, (B, L), generator=gen, device=dev,
                              dtype=torch.int32)
        dtape = torch.zeros((B, L), dtype=torch.int32, device=dev)
        torch.cuda.synchronize()

        ens.plane_round.launches = 0
        ens.plane_round_plain.calls = 0
        ens.window_counts.launches = 0
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        (pt, dt), (applied, times) = ens.run_ensemble(
            gen, (ptape, dtape), dm, (NUM_STEPS, E), device=dev)
        end.record()
        spd = ens.window_counts(pt, dm.size_a, CL_K, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"plane_round": ens.plane_round.launches,
                    "window_counts": ens.window_counts.launches}
        plain_calls = ens.plane_round_plain.calls
        run_ms = start.elapsed_time(end)
        say(f"launches: {launches}, plain round calls: {plain_calls}")
        if launches["plane_round"] != NUM_STEPS or plain_calls != 0:
            raise AssertionError("main path did not run K1 once a round")
        if launches["window_counts"] != 1:
            raise AssertionError("main path did not run K2")

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
        ms_round = run_ms / NUM_STEPS
        say(f"run_ensemble: {run_ms:.3f} ms for {NUM_STEPS} rounds "
            f"(tape<->plane conversion included): {ms_round * 1e3:.2f} "
            f"us/round, {B * E * NUM_STEPS / (run_ms * 1e-3):.4e} "
            f"transitions/s; main path wall {wall:.3f} s")
        say(f"SPD(cl_k={CL_K}) top windows: "
            f"{torch.topk(spd, 3).indices.tolist()}")

        # K1 alone, on the run's own planes and a fresh random shift
        # sequence, as the run launches it.
        p_st = ens._tape_to_planes(pt.to(torch.int8), STRIDE)
        d_st = ens._tape_to_planes(dt.to(torch.int8), STRIDE)
        reps = 500
        shifts = torch.randint(0, STRIDE, (reps + 3,), generator=gen,
                               device=dev, dtype=torch.int32)
        plan = ens.device_plan(dm, dev)
        it = iter(range(reps + 3))
        host = []
        k1_ms = cuda_ms(lambda: ens.plane_round(dm, p_st, d_st, shifts,
                                                next(it), plan=plan), reps,
                        host=host)
        it = iter(range(5 + 3))
        k1_plain_ms = cuda_ms(lambda: ens.plane_round_plain(
            dm, p_st, d_st, shifts, next(it)), 5)
        k1_bound = k1_bytes(dm) / HBM_BYTES_PER_S * 1e3
        say(f"K1: {k1_ms * 1e3:.2f} us/round against a bound of "
            f"{k1_bound * 1e3:.2f} us ({k1_bytes(dm) / 1e6:.1f} MB at "
            f"3.35 TB/s): {k1_bound / k1_ms:.3f} of the bound; "
            f"plain {k1_plain_ms:.3f} ms; host {host[0] * 1e3:.2f} us a "
            "launch (wrapper checks + ctypes call)")

        k2_ms = cuda_ms(lambda: ens._window_counts_int(pt, dm.size_a, CL_K),
                        20)
        k2_plain_ms = cuda_ms(
            lambda: ens.window_counts_plain(pt, dm.size_a, CL_K), 5)
        rank = torch.zeros_like(pt, dtype=torch.int64)
        for j in range(CL_K):
            rank = rank * dm.size_a + torch.roll(pt, -j, dims=1)
        flat = rank.reshape(-1)
        k2_lib_ms = cuda_ms(
            lambda: torch.bincount(flat, minlength=dm.size_a**CL_K), 20)
        k2_bytes = B * L * 4 + dm.size_a**CL_K * 8
        k2_bound = k2_bytes / HBM_BYTES_PER_S * 1e3
        say(f"K2: {k2_ms:.4f} ms against a bound of {k2_bound:.4f} ms; "
            f"plain {k2_plain_ms:.4f} ms; torch.bincount on the ranks "
            f"{k2_lib_ms:.4f} ms")

        kernels["K1"] = {
            "name": "K1 plane_round", "route": "cuda",
            "source": "chemical_kinetics_and_program_execution_torch/csrc/"
                      "plane_round.cu",
            "replaces": K1_REPLACES, "launches": launches["plane_round"],
            "max_abs_err": max_err["K1"],
            "match": "bit-identical on ex5, ex4, ex2",
            "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
            "bound_by": "bytes", "library_ms": None,
            "run_ms_per_round": ms_round,
        }
        kernels["K2"] = {
            "name": "K2 window_counts", "route": "cuda",
            "source": "chemical_kinetics_and_program_execution_torch/csrc/"
                      "window_counts.cu",
            "replaces": K2_REPLACES, "launches": launches["window_counts"],
            "max_abs_err": max_err["K2"],
            "match": "exact vs plain and torch.bincount",
            "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
            "bound_by": "bytes", "library_ms": k2_lib_ms,
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
