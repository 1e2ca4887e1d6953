"""Dense transfer-matrix RHS: the exact SPD closure's dp/dt.

Counterpart of the JAX package's `engine/dense.py`. A rule is compiled
on the host into a :class:`DenseProgram` (`compile_dense`): per-world
factor chains into the flat marginal pyramid, world-to-signature pairs,
and one :class:`SigPlan` per revealed-window signature. Signatures with
the same (revealed length, changed positions) share one window sweep
(`_group_plans`). dp/dt then takes three stages, each a hand-written
CUDA kernel on the card (`csrc/dense_rhs.cu`) with its plain PyTorch
version here, which the wrapper runs for a CPU tensor:

- K3 `pyramid_ratios`: the marginal levels, the flat pyramid and the
  guarded ratio tables (`_levels`, `_ratio_tables` there);
- K4 `signature_weights`: world weights, chain products of guarded
  ratios, summed into signature weights;
- K5 `sweep`: every group's sweep, one kernel launch a step
  (`csrc/sweep_rule.cuh` is the per-element rule), its steps planned
  once a program on the host (`sweep_plan`).

The sweep plan follows `_apply_group` step for step: seed a one-hot
vector, left-extend it to a (k-1)-context (phase A), emit and left-shift
while a changed cell stays in frame (phase C), right-extend while a
changed cell stays in context (phase B). The plain version computes each
step as `_apply_group` does (tile, repeat, reshape-sum, a sub-slice
scatter for the emission) and sums digits in digit order, the kernel's
order. The TPU's emission layout guard (`_ROLL_EMIT_MIN_STATE` there)
has no counterpart: the plain version uses one emission form at every
size.

Not ported yet (ROADMAP Queue 1 item 4): pruned programs with their mass
tables (`BeamGuide`, ``with_mass``), dual-SPD programs and the streamed
RHS.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import cuda
from ..markov import guarded_ratio, pyramid_offsets
from ..utils import config
from . import dsl, enumerate as enum_mod

_UNPORTED = "not ported yet (ROADMAP Queue 1 item 4)"


@dataclasses.dataclass(frozen=True)
class SigPlan:
    """Static sweep metadata for one revealed-window signature."""

    sid: int  # index into the signature-weight vector
    length: int  # revealed length L0
    orig: tuple[int, ...]  # revealed original digits (left->right)
    adj: tuple[int, ...]  # adjusted digits


@dataclasses.dataclass
class DenseProgram:
    tag: str
    size_a: int
    cl_k: int
    pyramid_size: int
    num_signatures: int
    # Stage 1-2: per-world factor chains (tens to thousands of rows).
    w_num: np.ndarray
    w_den: np.ndarray
    w_const: np.ndarray
    pair_world: np.ndarray
    pair_sig: np.ndarray
    plans: tuple[SigPlan, ...]

    @property
    def state_size(self) -> int:
        return self.size_a**self.cl_k

    @property
    def num_worlds(self) -> int:
        return len(self.w_const)


def _digits(x: int, n: int, a: int) -> tuple[int, ...]:
    return tuple((x // a**i) % a for i in range(n - 1, -1, -1))


def _rank(digits, a: int) -> int:
    r = 0
    for d in digits:
        r = r * a + d
    return r


def compile_dense(tag: str, cl_k: int, *,
                  max_worlds: int | None = None,
                  p_ref=None, prune_threshold: float = 0.0) -> DenseProgram:
    """Compiles a problem to its dense transfer-matrix program.

    Pruning (``p_ref``, ``prune_threshold > 0``) needs the reference's
    `BeamGuide`, which is not ported: it raises NotImplementedError.
    """
    if prune_threshold > 0.0 or p_ref is not None:
        raise NotImplementedError(f"pruned dense programs are {_UNPORTED}")
    from .compile import _pad_chains, collect_signatures

    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    _, pyr_total = pyramid_offsets(size_a, cl_k)
    worlds = enum_mod.enumerate_worlds(problem, cl_k, max_worlds=max_worlds)
    live, sig_ids, pair_world, pair_sig = collect_signatures(worlds)
    w_num, w_den = _pad_chains([w.factors for w in live], pyr_total - 1)
    plans = tuple(
        SigPlan(sid=sid, length=length,
                orig=_digits(io, length, size_a),
                adj=_digits(ia, length, size_a))
        for (io, ia, length), sid in sig_ids.items()
    )
    return program_from_arrays(
        tag, size_a, cl_k, w_num, w_den,
        np.array([w.const for w in live], dtype=np.float64),
        pair_world, pair_sig,
        [(p.sid, p.length, p.orig, p.adj) for p in plans])


def program_from_arrays(tag: str, size_a: int, cl_k: int, w_num, w_den,
                        w_const, pair_world, pair_sig, plans) -> DenseProgram:
    """A :class:`DenseProgram` from its fields as numpy arrays and
    ``plans`` as ``(sid, length, orig, adj)`` tuples, one a signature:
    the JAX package's compiled program carried over as it is."""
    plans = tuple(SigPlan(sid=int(sid), length=int(length),
                          orig=tuple(int(x) for x in orig),
                          adj=tuple(int(x) for x in adj))
                  for sid, length, orig, adj in plans)
    _, pyr_total = pyramid_offsets(size_a, cl_k)
    return DenseProgram(
        tag=tag, size_a=int(size_a), cl_k=int(cl_k),
        pyramid_size=pyr_total,
        num_signatures=len(plans),
        w_num=np.asarray(w_num, dtype=np.int32),
        w_den=np.asarray(w_den, dtype=np.int32),
        w_const=np.asarray(w_const, dtype=np.float64),
        pair_world=np.asarray(pair_world, dtype=np.int32),
        pair_sig=np.asarray(pair_sig, dtype=np.int32),
        plans=plans,
    )


def _emit_sub_ranks(plan: SigPlan, s0: int, k: int, a: int
                    ) -> tuple[int, int]:
    """(orig, adj) ranks of the revealed digit run inside the window
    starting at tape cell ``s0``."""
    q_lo = max(0, s0)
    q_hi = min(plan.length - 1, s0 + k - 1)
    return (_rank(plan.orig[q_lo:q_hi + 1], a),
            _rank(plan.adj[q_lo:q_hi + 1], a))


def _sweep_meta(l0: int, changed: tuple[int, ...], k: int
                ) -> tuple[int, int, list[int]]:
    """(m_l, m_r, emission window starts) for one (L0, changed) shape."""
    base = min(l0, k)
    m_l = base - 1 - changed[0]
    m_r = k - l0 + changed[-1]
    s0s = [base - k - m for m in range(0, m_l + 1)]
    s0s += [l0 + m - k for m in range(1, m_r + 1)]
    return m_l, m_r, s0s


def _group_plans(plans, a: int, k: int):
    """Groups signatures that can share one sweep.

    Signatures with the same (revealed length, changed positions) walk
    identical sweep schedules, and their weight tensors can share the
    dense transfer steps because their supports are disjoint slices.
    The one hazard: at an emission step, two members whose *in-window*
    original digits coincide would mix mass in the extraction slice —
    allowed only if their adjusted digits coincide too (then it is one
    merged emission); otherwise they are split into separate groups.
    """
    from collections import defaultdict

    by_key = defaultdict(list)
    for p in plans:
        ch = tuple(q for q in range(p.length) if p.orig[q] != p.adj[q])
        by_key[(p.length, ch)].append(p)

    groups = []
    for (l0, ch), members in by_key.items():
        _, _, s0s = _sweep_meta(l0, ch, k)
        placed: list[dict] = []
        for p in members:
            subs = [_emit_sub_ranks(p, s0, k, a) for s0 in s0s]
            for g in placed:
                if all(g["maps"][i].get(o_s, a_s) == a_s
                       for i, (o_s, a_s) in enumerate(subs)):
                    g["members"].append(p)
                    for i, (o_s, a_s) in enumerate(subs):
                        g["maps"][i][o_s] = a_s
                    break
            else:
                placed.append({
                    "members": [p],
                    "maps": [{o_s: a_s} for (o_s, a_s) in subs],
                })
        for g in placed:
            groups.append((l0, ch, tuple(g["members"])))
    return groups


# --- The sweep plan ------------------------------------------------------------

# Step kinds (`csrc/sweep_rule.cuh`).
IDENT, EXTEND, SHIFT, RIGHT, RSHIFT, INTERIOR = range(6)
# Work buffers: two of A^k doubles, then the (k-1)-context of A^(k-1).
_P0, _P1, _CTX = 0, 1, 2
# Fields of a step row, in order (`csrc/dense_rhs.cu:ckpe_dense_sweep`).
STEP_FIELDS = ("kind", "n_out", "n_src", "src", "dst", "ratio", "emit",
               "lo", "span", "pair_off", "n_pairs", "seed_off", "seed_len")


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Every K5 launch of one RHS, planned once a program.

    ``steps`` is int64 [n_steps, 13] (`STEP_FIELDS`); ``src`` -1 reads
    the sparse seed ``seed_rank/seed_sid[seed_off:seed_off+seed_len]``
    (ranks ascending, equal ranks in member order); ``dst`` -1 keeps
    nothing; an INTERIOR step walks ``interior[seed_off:+seed_len]``
    rows of (rank, signature id, sign)."""

    steps: np.ndarray
    seed_rank: np.ndarray
    seed_sid: np.ndarray
    pairs: np.ndarray
    interior: np.ndarray
    num_groups: int

    @property
    def num_launches(self) -> int:
        return len(self.steps)


def ratio_offsets(a: int, k: int) -> tuple[dict, int]:
    """Layout of K3's ratio buffer: r_le[j] (A^j) at ``offsets[j]`` for
    j = 1..k, then r_re (A^k) at ``offsets["re"]``; and its length."""
    offsets, pos = {}, 0
    for j in range(1, k + 1):
        offsets[j] = pos
        pos += a**j
    offsets["re"] = pos
    return offsets, pos + a**k


def sweep_plan(prog: DenseProgram) -> SweepPlan:
    """The steps of every group's sweep, in `_apply_group`'s order."""
    a, k = prog.size_a, prog.cl_k
    n, n1 = a**k, a ** (k - 1)
    r_off, _ = ratio_offsets(a, k)
    rows, seed_rank, seed_sid, pairs, interior = [], [], [], [], []
    groups = _group_plans(prog.plans, a, k)

    def seed(ranks, sids):
        order = sorted(range(len(ranks)), key=lambda i: ranks[i])
        off = len(seed_rank)
        seed_rank.extend(ranks[i] for i in order)
        seed_sid.extend(sids[i] for i in order)
        return (-1, off, len(ranks))

    def step(kind, n_out, n_src, src, dst, ratio, emit=None):
        buf, s_off, s_len = src if src[0] == -1 else (src[0], 0, 0)
        row = [kind, n_out, n_src, buf, dst, ratio, 0, 1, 1, 0, 0, s_off,
               s_len]
        if emit is not None:
            lo, span, prs = emit
            row[6:11] = [1, lo, span, len(pairs), len(prs)]
            pairs.extend(prs)
        rows.append(row)

    for l0, changed, members in groups:
        m_l, m_r, _ = _sweep_meta(l0, changed, k)
        base = min(l0, k)
        sids = [m.sid for m in members]

        def emission(s0, l0=l0, members=members):
            q_lo = max(0, s0)
            q_hi = min(l0 - 1, s0 + k - 1)
            run = q_hi - q_lo + 1
            lo = a ** (k - (q_lo - s0) - run)
            prs = sorted({_emit_sub_ranks(m, s0, k, a) for m in members})
            return lo, a**run, prs

        if l0 <= k - 1:
            cur = seed([_rank(m.orig, a) for m in members], sids)
            nxt = _P0
            for j in range(l0 + 1, k):
                dst = _CTX if j == k - 1 else nxt
                step(EXTEND, a**j, a ** (j - 1), cur, dst, r_off[j])
                cur, nxt = (dst, 0, 0), _P1 if nxt == _P0 else _P0
            ctx = cur
            first = (EXTEND, n1, ctx, r_off[k])
        else:
            if l0 > k:
                # Interior emissions at fully revealed windows; each
                # member scatters its own weight (duplicate ranks legal).
                off = len(interior)
                for j in range(1, l0 - k + 1):
                    if any(j <= q <= j + k - 1 for q in changed):
                        interior.extend((_rank(m.orig[j:j + k], a), m.sid,
                                         -1) for m in members)
                        interior.extend((_rank(m.adj[j:j + k], a), m.sid,
                                         1) for m in members)
                if len(interior) > off:
                    rows.append([INTERIOR, 0, 0, -1, -1, -1, 0, 1, 1, 0, 0,
                                 off, len(interior) - off])
            first = (IDENT, n, seed([_rank(m.orig[:k], a) for m in members],
                                    sids), -1)
            ctx = seed([_rank(m.orig[l0 - k + 1:], a) for m in members],
                       sids)

        # Phase C: emit the length-k frame, then left-shift while changed.
        prev, buf = None, _P0
        for m in range(0, m_l + 1):
            dst = buf if m < m_l else -1
            if m == 0:
                kind, n_src, src, ratio = first
                step(kind, n, n_src, src, dst, ratio, emission(base - k))
            else:
                step(SHIFT, n, n1, (prev, 0, 0), dst, r_off[k],
                     emission(base - k - m))
            prev, buf = buf, _P1 if buf == _P0 else _P0
        # Phase B: right-extend while a changed cell stays in context.
        for m in range(1, m_r + 1):
            dst = buf if m < m_r else -1
            if m == 1:
                step(RIGHT, n, n1, ctx, dst, r_off["re"],
                     emission(l0 + m - k))
            else:
                step(RSHIFT, n, n1, (prev, 0, 0), dst, r_off["re"],
                     emission(l0 + m - k))
            prev, buf = buf, _P1 if buf == _P0 else _P0

    return SweepPlan(
        steps=np.asarray(rows, dtype=np.int64).reshape(-1, len(STEP_FIELDS)),
        seed_rank=np.asarray(seed_rank, dtype=np.int32),
        seed_sid=np.asarray(seed_sid, dtype=np.int32),
        pairs=np.asarray(pairs, dtype=np.int32).reshape(-1, 2),
        interior=np.asarray(interior, dtype=np.int32).reshape(-1, 3),
        num_groups=len(groups),
    )


@dataclasses.dataclass
class DeviceProgram:
    """A :class:`DenseProgram`, its sweep plan and its tables on one
    device (CSR of each signature's pairs in pair order for K4)."""

    prog: DenseProgram
    plan: SweepPlan
    device: torch.device
    w_num: torch.Tensor
    w_den: torch.Tensor
    w_const: torch.Tensor
    pair_world: torch.Tensor
    pair_sig: torch.Tensor
    csr_ptr: torch.Tensor
    csr_world: torch.Tensor
    seed_rank: torch.Tensor
    seed_sid: torch.Tensor
    pairs: torch.Tensor
    interior: torch.Tensor


def device_program(prog: DenseProgram, device=None) -> DeviceProgram:
    """Plans ``prog``'s sweep and moves its tables to ``device``
    (``cuda`` unless named)."""
    device = config.get_device(device)
    plan = sweep_plan(prog)
    order = np.argsort(prog.pair_sig, kind="stable")
    counts = np.bincount(prog.pair_sig, minlength=prog.num_signatures)
    csr_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    i32, f64 = torch.int32, config.DEFAULT_FLOAT
    w_const = dev(prog.w_const, f64)
    return DeviceProgram(
        prog=prog, plan=plan, device=w_const.device,  # "cuda" -> "cuda:0"
        w_num=dev(prog.w_num, i32), w_den=dev(prog.w_den, i32),
        w_const=w_const,
        pair_world=dev(prog.pair_world, i32),
        pair_sig=dev(prog.pair_sig, i32),
        csr_ptr=dev(csr_ptr, i32),
        csr_world=dev(prog.pair_world[order], i32),
        seed_rank=dev(plan.seed_rank, i32), seed_sid=dev(plan.seed_sid, i32),
        pairs=dev(plan.pairs, i32), interior=dev(plan.interior, i32),
    )


def _digit_sum_last(x: torch.Tensor, a: int) -> torch.Tensor:
    """``x.reshape(-1, a).sum(-1)``, summed in digit order."""
    x2 = x.reshape(-1, a)
    c = x2[:, 0].clone()
    for d in range(1, a):
        c += x2[:, d]
    return c


def _digit_sum_first(x: torch.Tensor, a: int) -> torch.Tensor:
    """``x.reshape(a, -1).sum(0)``, summed in digit order."""
    x2 = x.reshape(a, -1)
    c = x2[0].clone()
    for d in range(1, a):
        c += x2[d]
    return c


# --- K3: pyramid and ratio tables ----------------------------------------------


def pyramid_ratios_plain(p: torch.Tensor, a: int, k: int):
    """Plain version of K3: ``(pyr, rat)``, the flat pyramid
    ``[lv[k], ..., lv[0], 1]`` and the ratio tables in `ratio_offsets`'
    layout, ``r_le[j] = g(lv[j], tile(lv[j-1], A))``,
    ``r_re = g(lv[k], repeat(lv[k-1], A))``."""
    pyramid_ratios_plain.calls += 1
    lv = [None] * (k + 1)
    lv[k] = p
    for j in range(k - 1, -1, -1):
        lv[j] = _digit_sum_last(lv[j + 1], a)
    pyr = torch.cat([lv[j] for j in range(k, -1, -1)]
                    + [torch.ones(1, dtype=p.dtype, device=p.device)])
    tables = [guarded_ratio(lv[j], lv[j - 1].repeat(a))
              for j in range(1, k + 1)]
    tables.append(guarded_ratio(lv[k], torch.repeat_interleave(lv[k - 1], a)))
    return pyr, torch.cat(tables)


pyramid_ratios_plain.calls = 0


def pyramid_ratios(p: torch.Tensor, a: int, k: int):
    """K3: ``(pyr, rat)`` of a float64 SPD vector ``p`` [A^k]; the kernel
    for a CUDA tensor (k + 1 launches), the plain version for a CPU one."""
    if not cuda.on_card(p, "pyramid_ratios"):
        return pyramid_ratios_plain(p, a, k)
    if p.dtype != torch.float64 or p.shape != (a**k,):
        raise TypeError(f"p must be a float64 [{a**k}] tensor")
    p = p.contiguous()
    _, pyr_total = pyramid_offsets(a, k)
    pyr = torch.empty(pyr_total, dtype=p.dtype, device=p.device)
    rat = torch.empty(ratio_offsets(a, k)[1], dtype=p.dtype, device=p.device)
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_pyramid_ratios(p.data_ptr(), a, k, pyr.data_ptr(),
                                     rat.data_ptr(), cuda.stream(p))
    cuda.check(rc, "pyramid_ratios", lib)
    pyramid_ratios.launches += k + 1
    return pyr, rat


pyramid_ratios.launches = 0


# --- K4: signature weights -----------------------------------------------------


def signature_weights_plain(dp: DeviceProgram, pyr: torch.Tensor):
    """Plain version of K4: ``s[sig] = sum over the pairs of sig of
    w_const[w] * prod_c g(pyr[w_num[w, c]], pyr[w_den[w, c]])``, the
    product in chain order."""
    signature_weights_plain.calls += 1
    g = guarded_ratio(pyr[dp.w_num.long()], pyr[dp.w_den.long()])
    prod = g[:, 0].clone()
    for c in range(1, g.shape[1]):
        prod = prod * g[:, c]
    wv = dp.w_const * prod
    s = torch.zeros(dp.prog.num_signatures, dtype=pyr.dtype,
                    device=pyr.device)
    return s.index_add_(0, dp.pair_sig.long(), wv[dp.pair_world.long()])


signature_weights_plain.calls = 0


def signature_weights(dp: DeviceProgram, pyr: torch.Tensor):
    """K4: signature weights [num_signatures] from the flat pyramid; the
    kernel for a CUDA tensor (one launch), the plain version for a CPU
    one."""
    if not cuda.on_card(pyr, "signature_weights"):
        return signature_weights_plain(dp, pyr)
    prog = dp.prog
    if pyr.dtype != torch.float64 or pyr.shape != (prog.pyramid_size,):
        raise TypeError(f"pyr must be a float64 [{prog.pyramid_size}] "
                        "tensor")
    if pyr.device != dp.device:
        raise ValueError(f"pyr on {pyr.device}, the program on {dp.device}")
    pyr = pyr.contiguous()
    wv = torch.empty(prog.num_worlds, dtype=pyr.dtype, device=pyr.device)
    s = torch.empty(prog.num_signatures, dtype=pyr.dtype, device=pyr.device)
    lib = cuda.load()
    with torch.cuda.device(pyr.device):
        rc = lib.ckpe_signature_weights(
            pyr.data_ptr(), dp.w_num.data_ptr(), dp.w_den.data_ptr(),
            dp.w_const.data_ptr(), prog.num_worlds, prog.w_num.shape[1],
            dp.csr_ptr.data_ptr(), dp.csr_world.data_ptr(),
            prog.num_signatures, wv.data_ptr(), s.data_ptr(),
            cuda.stream(pyr))
    cuda.check(rc, "signature_weights", lib)
    signature_weights.launches += 1
    return s


signature_weights.launches = 0


# --- K5: the sweep -------------------------------------------------------------


def _seed_dense(dp: DeviceProgram, s: torch.Tensor, off: int, length: int,
                size: int) -> torch.Tensor:
    """A sparse seed as a dense one-hot sum over ``size`` ranks."""
    out = torch.zeros(size, dtype=s.dtype, device=s.device)
    ranks = dp.seed_rank[off:off + length].long()
    return out.index_add_(0, ranks, s[dp.seed_sid[off:off + length].long()])


def sweep_step_plain(kind: int, src: torch.Tensor, ratio, a: int,
                     n_out: int) -> torch.Tensor:
    """Plain version of one K5 step's value t (`csrc/sweep_rule.cuh`):
    ``src`` is the dense previous vector (a seed made dense), ``ratio``
    the step's table."""
    if kind == IDENT:
        return src
    if kind == EXTEND:
        return ratio * src.repeat(n_out // src.numel())
    if kind == SHIFT:
        return ratio * _digit_sum_last(src, a).repeat(a)
    if kind == RIGHT:
        return torch.repeat_interleave(src, a) * ratio
    if kind == RSHIFT:
        return torch.repeat_interleave(_digit_sum_first(src, a), a) * ratio
    raise ValueError(f"unknown sweep step kind {kind}")


def emit_plain(dy: torch.Tensor, t: torch.Tensor, lo: int, span: int,
               pairs: torch.Tensor) -> None:
    """Plain version of a step's +-emission, in place: ``dy`` loses t at
    every window whose run digits are an orig rank and gains it at the
    adjusted rank, as `_apply_group`'s sub-slice scatter does."""
    o, adj = pairs[:, 0].long(), pairs[:, 1].long()
    d3 = dy.view(-1, span, lo)
    sub = t.view(-1, span, lo)[:, o, :]
    d3.index_add_(1, o, -sub)
    d3.index_add_(1, adj, sub)


def sweep_plain(dp: DeviceProgram, rat: torch.Tensor, s: torch.Tensor,
                out: torch.Tensor | None = None):
    """Plain version of K5: every group's sweep into ``out`` (a new dy
    [A^k] when None)."""
    sweep_plain.calls += 1
    a, k = dp.prog.size_a, dp.prog.cl_k
    n = a**k
    dy = (torch.zeros(n, dtype=s.dtype, device=s.device) if out is None
          else _checked_out(out, n, s.device).zero_())
    bufs = {}
    for row in dp.plan.steps.tolist():
        f = dict(zip(STEP_FIELDS, row))
        if f["kind"] == INTERIOR:
            ops = dp.interior[f["seed_off"]:f["seed_off"] + f["seed_len"]]
            sign = ops[:, 2].tolist()
            start = 0
            for q in range(1, len(sign) + 1):
                if q == len(sign) or sign[q] != sign[start]:
                    w = s[ops[start:q, 1].long()]
                    dy.index_add_(0, ops[start:q, 0].long(),
                                  -w if sign[start] < 0 else w)
                    start = q
            continue
        kind, n_out = f["kind"], f["n_out"]
        if f["src"] >= 0:
            src = bufs[f["src"]]
        else:
            size = {IDENT: n_out, EXTEND: f["n_src"]}.get(kind, n_out // a)
            src = _seed_dense(dp, s, f["seed_off"], f["seed_len"], size)
        ratio = (rat[f["ratio"]:f["ratio"] + n_out] if f["ratio"] >= 0
                 else None)
        t = sweep_step_plain(kind, src, ratio, a, n_out)
        if f["emit"]:
            emit_plain(dy, t, f["lo"], f["span"],
                       dp.pairs[f["pair_off"]:f["pair_off"] + f["n_pairs"]])
        if f["dst"] >= 0:
            bufs[f["dst"]] = t
    return dy


sweep_plain.calls = 0


def _checked_out(out: torch.Tensor, n: int, device) -> torch.Tensor:
    if (out.dtype != torch.float64 or out.shape != (n,)
            or out.device != device or not out.is_contiguous()):
        raise TypeError(f"out must be a contiguous float64 [{n}] tensor "
                        f"on {device}")
    return out


def sweep(dp: DeviceProgram, rat: torch.Tensor, s: torch.Tensor,
          out: torch.Tensor | None = None):
    """K5: dp/dt [A^k] from the ratio tables and signature weights, into
    ``out`` (a new tensor when None); the kernel for CUDA tensors (one
    launch a step of ``dp.plan``, one C call), the plain version for CPU
    ones."""
    if not cuda.on_card(rat, "sweep"):
        return sweep_plain(dp, rat, s, out)
    a, k = dp.prog.size_a, dp.prog.cl_k
    n = a**k
    if rat.device != dp.device or s.device != dp.device:
        raise ValueError("rat, s and the program must share one card")
    if (rat.dtype != torch.float64 or s.dtype != torch.float64
            or rat.shape != (ratio_offsets(a, k)[1],)
            or s.shape != (dp.prog.num_signatures,)):
        raise TypeError("rat and s must be float64 K3 and K4 outputs")
    rat, s = rat.contiguous(), s.contiguous()
    dy = (torch.empty(n, dtype=torch.float64, device=rat.device)
          if out is None else _checked_out(out, n, rat.device))
    work = torch.empty(2 * n + n // a, dtype=torch.float64, device=rat.device)
    steps = np.ascontiguousarray(dp.plan.steps)
    lib = cuda.load()
    with torch.cuda.device(rat.device):
        rc = lib.ckpe_dense_sweep(
            steps.ctypes.data, len(steps), a, n, work.data_ptr(),
            dy.data_ptr(), rat.data_ptr(), s.data_ptr(),
            dp.seed_rank.data_ptr(), dp.seed_sid.data_ptr(),
            dp.pairs.data_ptr(), dp.interior.data_ptr(), cuda.stream(rat))
    cuda.check(rc, "sweep", lib)
    sweep.launches += len(steps)
    return dy


sweep.launches = 0


# --- dp/dt ---------------------------------------------------------------------


def dy_dt_dense(dp: DeviceProgram, p: torch.Tensor) -> torch.Tensor:
    """Plain dp/dt: K3's, K4's and K5's plain versions in turn, on ``p``'s
    device."""
    a, k = dp.prog.size_a, dp.prog.cl_k
    pyr, rat = pyramid_ratios_plain(p.reshape(-1), a, k)
    return sweep_plain(dp, rat, signature_weights_plain(dp, pyr))


def make_dense_dy_dt(prog: DenseProgram, *, with_mass: bool = False,
                     device=None):
    """Builds ``fn(p, out=None) -> dp/dt`` (float64) for a dense program
    on ``device`` (``cuda`` unless named): K3 -> K4 -> K5 on a card, their
    plain versions on the CPU. ``p`` is a tensor or an array of A^k
    values; it is moved to the device as float64. K5 writes dp/dt into
    ``out`` where one is given (a solver's stage row), else into a new
    tensor. ``with_mass`` (pruned programs) raises NotImplementedError."""
    if with_mass:
        raise NotImplementedError(f"with_mass is {_UNPORTED}")
    dp = device_program(prog, device)
    a, k, n = prog.size_a, prog.cl_k, prog.state_size

    def fn(p, out=None):
        p = torch.as_tensor(p, dtype=torch.float64,
                            device=dp.device).reshape(-1)
        if p.numel() != n:
            raise ValueError(f"p has {p.numel()} entries, the program "
                             f"{n}")
        pyr, rat = pyramid_ratios(p, a, k)
        return sweep(dp, rat, signature_weights(dp, pyr), out)

    fn.device_program = dp
    return fn
