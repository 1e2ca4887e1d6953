#!/usr/bin/env python3
"""Times K26 (`steady_aug`) and K22 (`frontier_step`) on one CUDA card,
at the shapes `chip_smoke.py` phases 12 and 14 launch them.

    python3 time_beam_aug.py [ROOT] [--reps N] [--only k26,k22]

K26: at every program of phase 14's (d) and (e) (ex2 at cl_k 3 and 6,
ex1 at cl_k 3, ex4var2 at cl_k 3 in support mode, ex2's parametric rule
at cl_k 4), at n = 100,000 (a = 10, k = 5, two conserved weights), n =
10^4, 2^13, 4^7 (the block form's largest x) and 2^14: device µs a
`steady_aug` call by CUDA events, the kernels one call launches (by the
profiler's record of the runtime's launch calls and the kernels it saw
run), in a port with launch forms (`ode/steady.py:aug_forms`) µs a call
in every form the size can take,
and at the programs a whole G (`residual`) and a
whole J_G v (`jvp`) of the `Augmentation`, the RHS or J v and the
callers' elementwise arithmetic included, by CUDA events and by the host
clock (the steady-state loops are host-paced).

K22: the per-step beam at phase 12's (c) (K = 10^6, L = 32) on ex2's
table (M = 2) and ex5's (M = 1), after 10 steps of the beam from
chip_smoke's tapes (so the weights are a run's, not uniform): a whole
step, and its split: the device time of each stage's kernels in a
traced step (`k22_split`: rank, select, order, write; a library sort's
kernels and memsets as "other"). A port whose step ranks by a library
sort (the parent's design) is also timed stage by stage by CUDA events:
the rank launch, the sort, the allocations and slices, and the write
launch. `torch.sort` and `torch.topk` of the K*M children are timed as
yardsticks.

ROOT is the root of a checkout whose port is imported (default: this
script's own), so two commits can be timed alike on one card: unpack
the other one with `git archive` under the gitignored `.trees/`. Prints
the card's name and power limit, a line a measurement, then one JSON
object last. Needs one CUDA card and `nvcc`.
"""

import argparse
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from card_timing import cuda_ms

PKG = "chemical_kinetics_and_program_execution_torch"
# (phase 14's path, tag, cl_k, conserved): (d)'s steady states and (e)'s
# parametric continuation.
AUG_SHAPES = [
    ("d", "ex2-ferromagnetic-chain", 3, "auto"),
    ("d", "ex1-radioactive-decay", 3, "auto"),
    ("d", "ex4var2-chemical-turing", 3, "support"),
    ("d", "ex2-ferromagnetic-chain", 6, "auto"),
    ("e", "ex2-ferromagnetic-chain-p", 4, "auto"),
]
BEAM_K, BEAM_L, BEAM_WARM = 10**6, 32, 10
BEAM_TAGS = ("ex2-ferromagnetic-chain", "ex5-msrtf-machine")
# K22's kernels by stage of a step (`csrc/frontier.cu`; the parent
# design's rank and write kernels match too).
K22_STAGES = (("rank", ("k22_rank", "k22_shift")),
              ("select", ("k22_select", "k22_count", "k22_scan",
                          "k22_compact")),
              ("order", ("k22_lsd",)), ("write", ("k22_write",)))


def launches(fn):
    """(runtime launch calls, kernel names) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    calls = [e.name for e in events if e.name.startswith("cudaLaunch")]
    kernels = [e.name for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return calls, kernels


def k22_split(step, reps=5):
    """Device µs a step of each stage of K22 (`K22_STAGES`; other
    kernels and memsets as "other"): the durations of the kernels that
    torch.profiler saw run in ``reps`` traced steps after an untraced
    one, summed by stage and divided by ``reps``. Empty where the
    profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        stage = next((name for name, keys in K22_STAGES
                      if any(key in e.name for key in keys)), "other")
        out[stage] = out.get(stage, 0.0) + e.time_range.elapsed_us() / reps
    return out


def timed(fn, reps):
    """(device µs, host µs) a call: CUDA events with the host hidden
    behind a sleep kernel, and the host clock around ``reps`` calls
    ended by a synchronize (what a host-paced loop sees)."""
    dev_ms = cuda_ms(fn, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return dev_ms * 1e3, (time.perf_counter() - t0) * 1e6 / reps


def aug_rows(mods, dev, reps):
    tsteady, tengine, tparam, init = (mods["steady"], mods["engine"],
                                      mods["parametric"], mods["init"])
    gen = torch.Generator(device=dev).manual_seed(23)
    rows = []
    for path, tag, k, conserved in AUG_SHAPES:
        if tag.endswith("-p"):
            pd = tparam.ParametricDense(tag, k, device=dev)
            args = pd.consts(pd.problem.param_defaults)

            def fn(p, w, pd=pd):
                return pd.dy_dt(p, w)
            a = pd.problem.size_a
        else:
            dfn, _ = tengine.build_dy_dt(tag, k, device=dev)
            args = None

            def fn(p, _a, dfn=dfn):
                return dfn(p)
            a = 10 if tag.startswith("ex4var2") else 2
        n = a**k
        guess = (init.chemical_turing_v2_p0(k).ravel()
                 if conserved == "support" else None)
        aug = tsteady.Augmentation(fn, a, k, conserved, args, guess, 1e-20,
                                   dev)
        p = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        p = p / p.sum()
        if aug.mask is not None:
            p = torch.where(aug.mask, p, 0.0)
        v = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
        const = aug.constant(aug.targets(p))
        w = aug.cons_w if not aug.support else aug.cons_w[:0, :a]
        mode = 1 if aug.support else 0
        c_norm = 1.0 if aug.support else aug.c_norm
        row = {"path": path, "tag": tag, "cl_k": k, "n": n,
               "mode": mode, "n_c": int(aug.cons_w.shape[0])}
        if hasattr(tsteady, "aug_form"):
            row["form"] = tsteady.aug_form(a, k)
        row["call_us"], row["call_host_us"] = timed(
            lambda: tsteady.steady_aug(v, a, k, w, c_norm, mode), reps)
        calls, kernels = launches(
            lambda: tsteady.steady_aug(v, a, k, w, c_norm, mode))
        row["launch_calls"], row["kernels"] = len(calls), kernels
        if hasattr(tsteady, "aug_form"):
            row["forms_us"] = forms_us(tsteady, v, a, k, w, c_norm, mode)
        row["G_us"], row["G_host_us"] = timed(
            lambda: aug.residual(p, args, const), reps)
        row["JGv_us"], row["JGv_host_us"] = timed(
            lambda: aug.jvp(p, v, args), reps)
        calls, kernels = launches(lambda: aug.residual(p, args, const))
        row["G_launch_calls"], row["G_kernels"] = len(calls), kernels
        calls, kernels = launches(lambda: aug.jvp(p, v, args))
        row["JGv_launch_calls"], row["JGv_kernels"] = len(calls), kernels
        rows.append(row)
        print(f"K26 ({path}) {tag} cl_k {k} (n {n}, mode {mode}, "
              f"{row.get('form', 'two launches after K3')}): "
              f"{row['call_us']:.2f} us a call ({row['call_host_us']:.2f} "
              f"host), {row['launch_calls']} launches {row['kernels']}; "
              f"G {row['G_us']:.2f} us ({row['G_host_us']:.2f} host, "
              f"{row['G_launch_calls']} launches), J_G v "
              f"{row['JGv_us']:.2f} ({row['JGv_host_us']:.2f} host, "
              f"{row['JGv_launch_calls']} launches); by form "
              f"{row.get('forms_us')}", flush=True)
    for (a, k), mode in (((10, 5), 0), ((10, 5), 1), ((10, 4), 0),
                         ((2, 13), 0), ((4, 7), 0), ((2, 14), 0)):
        n = a**k
        x = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
        w = torch.linalg.qr(torch.randn(a, 2, generator=gen, device=dev,
                                        dtype=torch.float64))[0].T
        w = w.contiguous()
        c_norm = float(a) ** ((k - 1) / 2.0)
        row = {"path": "alone", "tag": f"a={a}", "cl_k": k, "n": n,
               "mode": mode, "n_c": 2}
        if hasattr(tsteady, "aug_form"):
            row["form"] = tsteady.aug_form(a, k)
        row["call_us"], row["call_host_us"] = timed(
            lambda: tsteady.steady_aug(x, a, k, w, c_norm, mode), 100)
        calls, kernels = launches(
            lambda: tsteady.steady_aug(x, a, k, w, c_norm, mode))
        row["launch_calls"], row["kernels"] = len(calls), kernels
        if hasattr(tsteady, "aug_form"):
            row["forms_us"] = forms_us(tsteady, x, a, k, w, c_norm, mode)
        rows.append(row)
        print(f"K26 n = {n} mode {mode} ({row.get('form', 'after K3')}): "
              f"{row['call_us']:.2f} us a call, {row['launch_calls']} "
              f"launches {row['kernels']}; by form "
              f"{row.get('forms_us')}", flush=True)
    return rows


def forms_us(tsteady, x, a, k, w, c_norm, mode):
    """µs a call of K26 in every launch form it can take at x [a^k]
    (`aug_forms`), the chooser swapped for each."""
    chosen, out = tsteady.aug_form, {}
    try:
        for form in tsteady.aug_forms(a, k):
            tsteady.aug_form = lambda a_, k_, f_=form: f_
            bufs = {}
            out[form] = timed(lambda: tsteady.steady_aug(
                x, a, k, w, c_norm, mode, bufs=bufs), 100)[0]
    finally:
        tsteady.aug_form = chosen
    return out


def beam_rows(mods, dev, reps):
    tfr, ens = mods["frontier"], mods["ensemble"]
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for tag in BEAM_TAGS:
        tab = ens.device_table(ens.compile_transition_table(tag), device=dev)
        hi = 2 if tag.startswith("ex2") else 3
        pt = torch.randint(0, hi, (BEAM_K, BEAM_L), generator=gen,
                           device=dev, dtype=torch.int32)
        dt = torch.zeros_like(pt)
        if tag.startswith("ex2"):
            pt, dt = dt, pt
        lw = torch.full((BEAM_K,), -math.log(BEAM_K), dtype=torch.float64,
                        device=dev)
        (p2, d2), lw2 = tfr.run_weighted_frontier(
            gen, (pt, dt), lw, tab, BEAM_WARM, BEAM_K, device=dev)
        p8, d8 = p2.to(torch.int8), d2.to(torch.int8)
        lw2 = (lw2 - lw2.max()).contiguous()
        out_log = tfr._out_log(tab).contiguous()
        M = out_log.shape[1]
        sites = torch.randint(0, BEAM_L, (1,), generator=gen, device=dev,
                              dtype=torch.int32)
        row = {"tag": tag, "M": M, "K": BEAM_K, "L": BEAM_L}
        # M = 1 steps in place: the timed steps go on from the last ones.
        row["step_us"], row["step_host_us"] = timed(
            lambda: tfr.frontier_step(tab, out_log, p8, d8, lw2, sites, 0),
            reps)
        calls, kernels = launches(
            lambda: tfr.frontier_step(tab, out_log, p8, d8, lw2, sites, 0))
        row["launch_calls"], row["kernels"] = len(calls), kernels
        row["split_us"] = k22_split(
            lambda: tfr.frontier_step(tab, out_log, p8, d8, lw2, sites, 0))
        if not hasattr(tfr, "BeamBuffers"):
            stages = parent_stages(tfr, mods["cuda"], tab, out_log, p8, d8,
                                   lw2, sites)
            row["stages_us"] = {name: timed(fn, reps)[0]
                                for name, fn in stages}
        if M > 1:
            child = stages_child(tfr, tab, out_log, p8, d8, lw2, sites)
            row["torch_sort_us"] = timed(lambda: torch.sort(
                child, descending=True, stable=True), reps)[0]
            row["torch_topk_us"] = timed(
                lambda: torch.topk(child, BEAM_K), reps)[0]
        rows.append(row)
        print(f"K22 {tag} (M={M}) K={BEAM_K} L={BEAM_L}: a step "
              f"{row['step_us']:.2f} us ({row['step_host_us']:.2f} host), "
              f"{row['launch_calls']} launches; split by the profiler "
              + ", ".join(f"{k} {v:.2f}" for k, v in row["split_us"].items())
              + ("; stages alone " + ", ".join(
                  f"{k} {v:.2f}" for k, v in row["stages_us"].items())
                 if "stages_us" in row else "")
              + (f"; torch.sort {row['torch_sort_us']:.2f}, torch.topk "
                 f"{row['torch_topk_us']:.2f}" if M > 1 else ""),
              flush=True)
        print(f"  kernels of a step: {kernels}", flush=True)
        del pt, dt, p2, d2, p8, d8, lw, lw2
        torch.cuda.empty_cache()
    return rows


def stages_child(tfr, tab, out_log, p8, d8, lw, sites):
    """The children of one step, by the plain rank on copies."""
    return tfr.frontier_rank_plain(tab, out_log, p8.clone(), d8.clone(),
                                   lw, sites[0].long())[1].reshape(-1)


def parent_stages(tfr, cuda, tab, out_log, p8, d8, lw, sites):
    """The parent design's step cut into its launches and library calls
    (`engine/frontier.py:frontier_step` before `BeamBuffers`)."""
    K, L = p8.shape
    M = out_log.shape[1]
    dev = p8.device
    lib = cuda.load()
    tab_args = tfr._k22_table_args(tab, out_log)
    rows = torch.empty(K, dtype=torch.int32, device=dev)
    child = torch.empty((K, M), dtype=torch.float64, device=dev)
    site = sites[0:1]
    pr, dr = p8.clone(), d8.clone()

    def rank():
        rc = lib.ckpe_frontier_rank(
            pr.data_ptr(), dr.data_ptr(), lw.data_ptr(), site.data_ptr(),
            K, L, *tab_args, rows.data_ptr(), child.data_ptr(),
            cuda.stream(pr))
        cuda.check(rc, "rank", lib)

    rank()
    if M == 1:
        top = child[:, 0]
        return [("rank", rank), ("max and shift", lambda: top - top.max())]
    vals, idx = torch.sort(child.reshape(-1), descending=True, stable=True)
    vk, ik = vals[:K].contiguous(), idx[:K].contiguous()
    op, od = torch.empty_like(p8), torch.empty_like(d8)
    new_lw = torch.empty(K, dtype=torch.float64, device=dev)

    def alloc():
        v, i = vals[:K].contiguous(), idx[:K].contiguous()
        torch.empty_like(p8), torch.empty_like(d8)
        torch.empty(K, dtype=torch.float64, device=dev)
        return v, i

    def write():
        rc = lib.ckpe_frontier_write(
            p8.data_ptr(), d8.data_ptr(), op.data_ptr(), od.data_ptr(),
            rows.data_ptr(), ik.data_ptr(), vk.data_ptr(), site.data_ptr(),
            K, L, *tab_args, new_lw.data_ptr(), cuda.stream(p8))
        cuda.check(rc, "write", lib)

    return [("rank", rank),
            ("sort", lambda: torch.sort(child.reshape(-1), descending=True,
                                        stable=True)),
            ("allocations and slices", alloc), ("write", write)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(Path(__file__).parent))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--only", default="k26,k22")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_beam_aug: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    mods = {name: importlib.import_module(f"{PKG}.{path}") for name, path in
            (("cuda", "cuda"), ("steady", "ode.steady"),
             ("engine", "engine"), ("parametric", "engine.parametric"),
             ("init", "models.initial_states"),
             ("frontier", "engine.frontier"),
             ("ensemble", "engine.ensemble"))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    mods["cuda"].load()
    want = set(args.only.split(","))
    result = {"root": args.root, "card": smi}
    if "k26" in want:
        result["k26"] = aug_rows(mods, dev, args.reps)
    if "k22" in want:
        result["k22"] = beam_rows(mods, dev, max(5, args.reps // 5))
    print(json.dumps(result, default=float))
    return 0


if __name__ == "__main__":
    np.set_printoptions(linewidth=200)
    sys.exit(main())
