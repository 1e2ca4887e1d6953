#!/usr/bin/env python3
"""Times K25 (`dense_jvp`) and K5 (`sweep`) at every shape that
`chip_smoke.py` phase 14 launches them, on one CUDA card.

    python3 time_jvp.py [ROOT] [--shapes c,d,e,ex4,more] [--reps N]
        [--no-split]

The shapes: ex4var2 at cl_k 5 (phase 14's kvaerno3 solve, "c"); ex2 and
ex1 at cl_k 3, ex4var2 at cl_k 3 and ex2 at cl_k 6 (the steady states of
`tests/test_steady.py`, "d"); ex2's parametric rule at cl_k 4
(`examples/ex2_correlations.py`, "e"); ex4 at cl_k 5 and 8 ("ex4"). For
each it prints the plan (phases, each phase's elements, the largest)
and the launch form, then device microseconds by CUDA events: a J.v as
`dense_jvp` makes it (with the levels of v), K25 alone, K5 alone and an
RHS as `dense_rhs` makes it; then K25 and K5 launched with the kernel's
own ``n_phases`` argument cut to 0, 1, 2, ...: the differences split
each phase's cost between its barrier and its elements. Where the port
has launch forms (`engine/dense.py:LAUNCH_FORMS`), every form a program
can take is timed alike; a J.v's and an RHS's outputs are hashed, so two
runs (two checkouts) can be held to the same bits.

ROOT is the root of a checkout whose port is imported (default: this
script's own), so two commits can be timed alike on one card: unpack
the other one with `git archive` under the gitignored `.trees/`. Prints
the card's name and power limit, a line a measurement, then one JSON
object last. Needs one CUDA card and `nvcc`.
"""

import argparse
import hashlib
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from card_timing import cuda_ms

SHAPES = [  # (phase 14's path, tag, cl_k)
    ("c", "ex4var2-chemical-turing", 5),
    ("d", "ex2-ferromagnetic-chain", 3),
    ("d", "ex1-radioactive-decay", 3),
    ("d", "ex4var2-chemical-turing", 3),
    ("d", "ex2-ferromagnetic-chain", 6),
    ("e", "ex2-ferromagnetic-chain-p", 4),
    ("ex4", "ex4-chemical-turing", 5),
    ("ex4", "ex4-chemical-turing", 8),
]
# Other programs of the port's paths, for the launch forms' limits
# (`--shapes more`): the 13 engine cases' largest, ex4 at cl_k 3-4, ex2
# at cl_k 8, phase 8's dopri5 programs.
SHAPES_MORE = [
    ("more", "ex4-chemical-turing", 3),
    ("more", "ex5-msrtf-machine", 3),
    ("more", "ex6-mini-bff-lite", 2),
    ("more", "ex4-chemical-turing", 4),
    ("more", "ex2-ferromagnetic-chain", 8),
    ("more", "ex3-copolymerization", 6),
    ("more", "ex3var2-copolymerization", 8),
    ("more", "ex4-chemical-turing", 6),
]


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def positive_state(gen, a, k, dev):
    """A positive SPD: the product of k draws of one symbol law."""
    sym = -torch.log1p(-torch.rand(a, generator=gen, device=dev,
                                   dtype=torch.float64))
    sym = sym / sym.sum()
    p = sym
    for _ in range(k - 1):
        p = torch.outer(p, sym).reshape(-1)
    return p


class Launches:
    """K25's and K5's bare launches with a cut ``n_phases``: through the
    port's `bare_jvp` and `bare_sweep` where it has them, else by the
    C entry points of a port that predates them (one cooperative launch
    each, K3's levels made beforehand)."""

    def __init__(self, tdense, cuda, dp, p, low, v, vlow):
        self.tdense, self.cuda, self.dp = tdense, cuda, dp
        self.p, self.low, self.v, self.vlow = p, low, v, vlow
        n = dp.prog.state_size
        self.jdy = torch.empty(n, dtype=torch.float64, device=p.device)
        self.dy = torch.empty_like(self.jdy)
        self.work = torch.empty(2 * max(dp.plan.work_size, 1),
                                dtype=torch.float64, device=p.device)
        self.s = torch.empty(2 * dp.prog.num_signatures,
                             dtype=torch.float64, device=p.device)

    def jvp(self, n_phases):
        t = self.tdense
        if hasattr(t, "bare_jvp"):
            return t.bare_jvp(self.dp, self.p, self.low, self.v, self.vlow,
                              self.jdy, self.work, self.s, n_phases)
        dp, prog, plan = self.dp, self.dp.prog, self.dp.plan
        lib = self.cuda.load()
        rc = lib.ckpe_dense_jvp(
            dp.items.data_ptr(), dp.phase_ptr.data_ptr(), n_phases,
            plan.max_phase, dp.table.data_ptr(), self.work.data_ptr(),
            self.jdy.data_ptr(), None, prog.state_size, self.p.data_ptr(),
            self.low.data_ptr(), self.v.data_ptr(), self.vlow.data_ptr(),
            dp.pair_num.data_ptr(), dp.pair_den.data_ptr(),
            dp.pair_const.data_ptr(), prog.w_num.shape[1],
            dp.csr_ptr.data_ptr(), prog.num_signatures, self.s.data_ptr(),
            prog.size_a, prog.cl_k, self.cuda.stream(self.p))
        self.cuda.check(rc, "K25", lib)

    def sweep(self, n_phases):
        t = self.tdense
        if hasattr(t, "bare_sweep"):
            return t.bare_sweep(self.dp, self.p, self.low, self.dy,
                                self.work, self.s, n_phases)
        dp, prog, plan = self.dp, self.dp.prog, self.dp.plan
        lib = self.cuda.load()
        rc = lib.ckpe_dense_sweep(
            dp.items.data_ptr(), dp.phase_ptr.data_ptr(), n_phases,
            plan.max_phase, dp.table.data_ptr(), self.work.data_ptr(),
            self.dy.data_ptr(), prog.state_size, self.p.data_ptr(),
            self.low.data_ptr(), dp.pair_num.data_ptr(),
            dp.pair_den.data_ptr(), dp.pair_const.data_ptr(),
            prog.w_num.shape[1], dp.csr_ptr.data_ptr(), prog.num_signatures,
            self.s.data_ptr(), prog.size_a, prog.cl_k,
            self.cuda.stream(self.p))
        self.cuda.check(rc, "K5", lib)


def phase_elements(plan):
    """Elements of each of the plan's phases (the first also zeroes dy)."""
    n = plan.items[:, 2]
    ptr = plan.phase_ptr
    return [int(n[ptr[i]:ptr[i + 1]].sum()) for i in range(len(ptr) - 1)]


def time_form(tdense, cuda, dp, p, low, v, vlow, reps, split):
    """The times of one program in its current form (µs)."""
    n_ph = dp.plan.num_phases
    x = Launches(tdense, cuda, dp, p, low, v, vlow)
    out = {
        "jvp_call_us": 1e3 * cuda_ms(
            lambda: tdense.dense_jvp(dp, p, v, low), reps),
        "k25_us": 1e3 * cuda_ms(lambda: x.jvp(n_ph), reps),
        "k5_us": 1e3 * cuda_ms(lambda: x.sweep(n_ph), reps),
        "rhs_call_us": 1e3 * cuda_ms(lambda: tdense.dense_rhs(dp, p), reps),
    }
    jv = tdense.dense_jvp(dp, p, v, low)
    dy2, jv2 = tdense.dense_jvp(dp, p, v, None, value=True)
    rhs = tdense.dense_rhs(dp, p)
    x.jvp(n_ph)
    x.sweep(n_ph)
    torch.cuda.synchronize()
    if not (torch.equal(jv, jv2) and torch.equal(dy2, rhs)
            and torch.equal(x.jdy, jv) and torch.equal(x.dy, rhs)):
        raise AssertionError("the launches of one program disagree")
    out["sha_jvp"], out["sha_rhs"] = digest(jv), digest(rhs)
    if split:
        out["k25_cum_us"] = [1e3 * cuda_ms(lambda: x.jvp(q), reps)
                             for q in range(n_ph + 1)]
        out["k5_cum_us"] = [1e3 * cuda_ms(lambda: x.sweep(q), reps)
                            for q in range(n_ph + 1)]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(Path(__file__).parent))
    ap.add_argument("--shapes", default="c,d,e,ex4")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--no-split", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_jvp: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    pkg = "chemical_kinetics_and_program_execution_torch"
    cuda = importlib.import_module(f"{pkg}.cuda")
    tdense = importlib.import_module(f"{pkg}.engine.dense")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    cuda.load()
    want = set(args.shapes.split(","))
    forms = getattr(tdense, "LAUNCH_FORMS", None)
    gen = torch.Generator(device=dev).manual_seed(22)
    result = {"root": args.root, "card": smi, "shapes": []}
    for path, tag, k in SHAPES + SHAPES_MORE:
        if path not in want:
            continue
        prog = tdense.compile_dense(tag, k)
        dp = tdense.device_program(prog, dev)
        plan, a = dp.plan, prog.size_a
        p = positive_state(gen, a, k, dev)
        v = torch.randn(prog.state_size, generator=gen, device=dev,
                        dtype=torch.float64) * p
        low, vlow = tdense.pyramids(prog, p), tdense.pyramids(prog, v)
        elems = phase_elements(plan)
        most = max(plan.max_phase, 32 * prog.num_signatures)
        row = {"path": path, "tag": tag, "cl_k": k,
               "states": prog.state_size, "signatures": prog.num_signatures,
               "phases": plan.num_phases, "phase_elements": elems,
               "max_phase": plan.max_phase, "most": most}
        reps = args.reps if prog.state_size < 10**6 else 5
        if forms is None:
            row["forms"] = {"grid (parent)": time_form(
                tdense, cuda, dp, p, low, v, vlow, reps, not args.no_split)}
            row["grid_want"] = -(-most // 1024)
        else:
            row["chosen"] = tdense.form_name(dp.form)
            row["forms"] = {}
            for form in tdense.forms_for(dp):
                dp.form = form
                row["forms"][tdense.form_name(form)] = time_form(
                    tdense, cuda, dp, p, low, v, vlow, reps,
                    not args.no_split)
        result["shapes"].append(row)
        print(f"{path} {tag} cl_k {k}: {prog.state_size} states, "
              f"{prog.num_signatures} signatures, {plan.num_phases} phases, "
              f"largest {plan.max_phase} elements (phase elements {elems})",
              flush=True)
        for name, t in row["forms"].items():
            print(f"  {name}: J.v call {t['jvp_call_us']:.2f} us, K25 alone "
                  f"{t['k25_us']:.2f}, K5 alone {t['k5_us']:.2f}, RHS call "
                  f"{t['rhs_call_us']:.2f}; sha J.v {t['sha_jvp']}, RHS "
                  f"{t['sha_rhs']}", flush=True)
            for key in ("k25_cum_us", "k5_cum_us"):
                if key in t:
                    print(f"    {key[:3].upper()} with n_phases 0..: "
                          + ", ".join(f"{x:.2f}" for x in t[key]), flush=True)
        del dp, p, v, low, vlow
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
