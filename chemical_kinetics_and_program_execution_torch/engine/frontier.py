"""The weighted frontier: K weighted tape configurations that branch,
merge by content and are resampled.

Counterpart of the JAX package's `engine/ensemble.py:1600-2902`:
the per-step beam `run_weighted_frontier` (BASELINE config 5), the
blocked frontier `run_weighted_frontier_blocked` with tempered rounds
(chooses sampled from q ∝ p^tau, importance increments in the
log-weights), its merges, and the weighted first-passage harnesses
`weighted_first_passage` and `weighted_first_passage_binned`.
`ensemble.py` re-exports the public names.

The frontier keeps its members as int8 tapes [K, L], member-major (the
reference stores transposed planes [E, K] for its TPU's lanes; here a
parent gather copies contiguous rows). A blocked round fires E sites a
member at a shift shared by the batch, the same site lattice as the
reference's plane round: K11 (`ensemble.lattice_round`) or its tempered
entry (:func:`tempered_round`), or K14 on K15's words where the
reference takes the bit-sliced round.

Kernels (`csrc/frontier.cu`, built by `cuda.py`):

- **K19** `content_hash` — the reference's FNV-1a hash of each member's
  packed cells, bit for bit (int64 holding the uint64 bits).
- **K20** `merge_resample` — after a stable library sort of the hashes:
  group boundaries, the groups' log-sum-exp, systematic resampling into
  K slots (w/m slot weights, or equal ones, or the weight-only merge),
  in fixed-order float64 scans.
- **K21** `gather_pair` — both tapes' rows (and a flag) of each slot's
  parent.
- **K22** `frontier_step` — one step of the per-step beam: each member's
  table row and children's weights (at M = 1 its window written in
  place, the weights shifted by their maximum), then at M > 1 a
  hand-written top K (a radix select and a stable LSD radix sort of the
  kept, `csrc/beam_rule.cuh`) and each slot's parent rows with its
  writes. `BeamBuffers` holds a run's buffers.

Each wrapper runs its plain PyTorch version (``*_plain``) for CPU
tensors only; for a CUDA tensor it launches the kernel or raises. Each
counts its launches in ``<wrapper>.launches``.

The merges have no hash-table election: the reference elects bucket
winners only because its TPU sorts compiled slowly, and documents the
sort-based merge as the statistically equivalent twin with the same
merged weights. So `_merge_resample` and `_merge_resample_sorted` are
one function here, `_merge_stats` groups by sort (equal hashes always
merge: nothing defers), and `_blocked_merge` switches at
`_MERGE_STAGED_MIN_K` members between w/m slot weights and the equal
slot weights of `_merge_resample_positions`, as the reference does
(the two differ in law at tau < 1).

Stochastic entry points take a `torch.Generator` (or an int seed) where
the reference takes a key; the merges take their uniform ``u`` (a float
or a 0-d float64 tensor), and `blocked_rounds_from_draws` and
`run_weighted_frontier_from_draws` take explicit draws, so that tests
can feed the JAX package's own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import cuda
from ..utils import config
from . import ensemble as ens

_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_SIGN = -2**63  # int64 with only the sign bit: flips uint64 order to int64's
_K20_G = 32     # csrc/frontier.cu: K20_G

# Above this member count the blocked merge deals equal slot weights
# (`_merge_resample_positions`) instead of w/m ones, as the reference's
# staged merge does; at tau = 1 (uniform weights) the two allocate alike.
_MERGE_STAGED_MIN_K = 4_000_000

_MODE_GROUPS, _MODE_POSITIONS, _MODE_STATS = 0, 1, 2


def _i32_wrap(x):
    """int64 values taken mod 2**32 as int32 (the reference's wrap)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


# --- K19: the content hash -----------------------------------------------------


def _hash_columns(L: int, stride: int) -> list[int]:
    """The reference's column order: c + e*stride for c in [0, stride),
    then e in [0, L/stride) (stride 1: the natural order)."""
    E = L // stride
    return [c + e * stride for c in range(stride) for e in range(E)]


def content_hash_plain(ptape, dtape, stride: int, bits: int, flag=None):
    """K19's plain version: each member's 64-bit FNV-1a hash over its
    cells (program tape, then data tape, in `_hash_columns` order, then
    ``flag`` as 0/1), packed ``max(1, 28 // bits)`` to an int32 word
    with the first of a word plus 1, folded as h = (h ^ word) * prime.
    int64 [K] holding the uint64 bits (the multiply wraps)."""
    content_hash_plain.calls += 1
    cols = _hash_columns(ptape.shape[1], stride)
    cells = [t[:, cols].to(torch.int64) for t in (ptape, dtape)]
    columns = [c for t in cells for c in t.unbind(1)]
    if flag is not None:
        columns.append(flag.to(torch.int64))
    per = max(1, 28 // bits)
    h = torch.full((ptape.shape[0],), _FNV_OFFSET, dtype=torch.int64,
                   device=ptape.device)
    for w0 in range(0, len(columns), per):
        word = columns[w0] + 1
        for c in columns[w0 + 1:w0 + per]:
            word = _i32_wrap((word << bits) | c)
        h = (h ^ _i32_wrap(word)) * _FNV_PRIME
    return h


content_hash_plain.calls = 0


def content_hash(ptape, dtape, *, stride: int = 1, bits: int = 8,
                 flag=None):
    """K19: the content hash of each member of int8 tapes [K, L] (and a
    bool ``flag`` [K]) in the reference's fold order for planes of
    ``stride`` (see `content_hash_plain`). int64 [K]."""
    K, L = ptape.shape
    if ptape.dtype != torch.int8 or dtape.dtype != torch.int8:
        raise TypeError("content_hash takes int8 tapes")
    if dtape.shape != ptape.shape or L % stride:
        raise ValueError(f"tapes {tuple(ptape.shape)}, "
                         f"{tuple(dtape.shape)} with stride {stride}")
    if not cuda.on_card(ptape, "content_hash"):
        return content_hash_plain(ptape, dtape, stride, bits, flag)
    p, d = ptape.contiguous(), dtape.contiguous()
    f = None if flag is None else flag.to(torch.bool).contiguous()
    out = torch.empty(K, dtype=torch.int64, device=p.device)
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_content_hash(p.data_ptr(), d.data_ptr(),
                                   None if f is None else f.data_ptr(),
                                   int(K), int(L), int(stride), int(bits),
                                   out.data_ptr(), cuda.stream(p))
    cuda.check(rc, "content_hash", lib)
    content_hash.launches += 1
    return out


content_hash.launches = 0


# --- K20: merge and systematic resample ----------------------------------------


def sort_hashes(h):
    """The hashes in the reference's uint64 order (sign bit flipped, so
    int64 order) with the member index, ties in index order: one stable
    library sort, as the reference's `jax.lax.sort`. Returns
    (keys, perm int64)."""
    return torch.sort(h ^ _SIGN, stable=True)


def scan_plain(x):
    """Inclusive scan of a 1-D tensor in K20's fixed order: rows of
    `_K20_G` consecutive elements summed in order, the row totals
    scanned the same way (recursively), each row after the first offset
    by the inclusive total of the rows before it. Elementwise ops only,
    so the bits are the same on any device."""
    n = x.numel()
    if n <= 1:
        return x.clone()
    rows = -(-n // _K20_G)
    pad = torch.zeros(rows * _K20_G, dtype=x.dtype, device=x.device)
    pad[:n] = x
    v = pad.view(rows, _K20_G)
    out = torch.empty_like(v)
    acc = v[:, 0]
    out[:, 0] = acc
    for j in range(1, _K20_G):
        acc = acc + v[:, j]
        out[:, j] = acc
    out = out.reshape(-1)[:n]
    if rows == 1:
        return out
    # A row's total is its last element's prefix (the padded zeros of the
    # last row add nothing: the kernel stops at n).
    tot = scan_plain(out.view(-1)[
        torch.clamp(torch.arange(rows, device=x.device) * _K20_G
                    + _K20_G - 1, max=n - 1)])
    r = torch.arange(n, device=x.device) // _K20_G
    off = tot[torch.clamp(r - 1, min=0)]
    return torch.where(r > 0, off + out, out)


def _finite_max(x):
    """The largest finite entry, 0 when none is (a 0-d tensor)."""
    m = torch.where(torch.isfinite(x), x, -math.inf).max()
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _exp_shift(ws, shift):
    return torch.where(torch.isfinite(ws), torch.exp(ws - shift), 0.0)


def _owners(C, K):
    """Slot s's owner: the number of g < K-1 with C[g] <= s, at most
    K - 1 (the reference's boundary scatter and cumsum)."""
    s = torch.arange(K, device=C.device, dtype=torch.int64)
    g = torch.searchsorted(C[:K - 1].to(torch.int64), s, right=True)
    return torch.clamp(g, max=K - 1)


def _multiplicities(cum, u):
    K = cum.numel()
    u = torch.clamp(torch.as_tensor(u, dtype=torch.float64,
                                    device=cum.device), 1e-12, 1.0 - 1e-12)
    f = torch.floor(float(K) * (cum / cum[K - 1]) - u)
    prev = torch.cat([torch.full((1,), -1.0, dtype=f.dtype,
                                 device=f.device), f[:-1]])
    return (f - prev).to(torch.int32)


def merge_resample_plain(hs, perm, lw, u, mode: int, log_k: float):
    """K20's plain version, in the kernel's order: ``hs`` the sorted keys
    and ``perm`` (int64) the member index of each (`sort_hashes`), ``lw``
    float64 [K], ``u`` the resampling uniform (clipped to [1e-12,
    1 - 1e-12]). Returns (parent or grp int64 [K], new_lw [K], n_groups
    int32 0-d):

    - mode 0, the reference's `_merge_resample_sorted`: groups of equal
      hash merged by log-sum-exp under the global finite max, then
      systematic resampling of the K slots over the groups in hash
      order, a group's m slots carrying its weight over m each;
    - mode 1, `_merge_resample_positions`: systematic resampling over
      the members in hash order, every slot carrying lse - log K
      (``log_k``);
    - mode 2, `_merge_stats`: in member space, each group's merged
      weight at its first member (-inf at the others) and the first
      member of each member's group.
    """
    merge_resample_plain.calls += 1
    K = hs.numel()
    dev = hs.device
    ws = lw[perm]
    start = torch.ones(K, dtype=torch.bool, device=dev)
    start[1:] = hs[1:] != hs[:-1]
    end = torch.ones(K, dtype=torch.bool, device=dev)
    end[:-1] = hs[1:] != hs[:-1]
    cnt = scan_plain(start.to(torch.int32))
    n_groups = cnt[K - 1]
    m = _finite_max(ws)
    ce = scan_plain(_exp_shift(ws, m))
    if mode == _MODE_POSITIONS:
        lse = torch.log(ce[K - 1]) + m
        cum = scan_plain(_exp_shift(ws, lse))
        C = scan_plain(_multiplicities(cum, u))
        parent = perm[_owners(C, K)]
        return parent, (lse - log_k).expand(K).clone(), n_groups
    gid = (cnt - 1).to(torch.int64)
    end_ce = torch.zeros(K, dtype=torch.float64, device=dev)
    end_ce[gid[end]] = ce[end]
    first = torch.zeros(K, dtype=torch.int64, device=dev)
    first[gid[start]] = perm[start]
    prev = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                      end_ce[:-1]])
    g_idx = torch.arange(K, device=dev)
    gsum = torch.where(g_idx < n_groups, end_ce - prev, 0.0)
    if mode == _MODE_STATS:
        merged = torch.where(gsum > 0.0,
                             m + torch.log(torch.clamp(gsum, min=1e-300)),
                             -math.inf)
        out_lw = torch.empty(K, dtype=torch.float64, device=dev)
        out_lw[perm] = torch.where(start, merged[gid], -math.inf)
        grp = torch.empty(K, dtype=torch.int64, device=dev)
        grp[perm] = first[gid]
        return grp, out_lw, n_groups
    mult = _multiplicities(scan_plain(gsum), u)
    g = _owners(scan_plain(mult), K)
    gs = gsum[g]
    new_lw = ((m + torch.log(torch.clamp(gs, min=1e-300)))
              - torch.log(torch.clamp(mult[g], min=1).to(torch.float64)))
    return first[g], torch.where(gs > 0.0, new_lw, -math.inf), n_groups


merge_resample_plain.calls = 0


def merge_resample(h, lw, u, mode: int):
    """K20 after `sort_hashes`: the merge of `merge_resample_plain`'s
    ``mode`` for hashes ``h`` (int64 [K]) and log-weights ``lw``
    (float64 [K]) at uniform ``u`` (modes 0 and 1). Returns (parent or
    grp int64 [K], new_lw float64 [K], n_groups int32 0-d), all on the
    device, with no host sync."""
    K = h.numel()
    if lw.dtype != torch.float64 or lw.shape != (K,) or h.dtype != torch.int64:
        raise TypeError("merge_resample takes int64 hashes and float64 "
                        "log-weights of one length")
    hs, perm = sort_hashes(h)
    log_k = math.log(K)
    uu = torch.as_tensor(0.0 if u is None else u, dtype=torch.float64,
                         device=h.device).reshape(())
    if not cuda.on_card(h, "merge_resample"):
        return merge_resample_plain(hs, perm, lw, uu, mode, log_k)
    dev = h.device
    lw = lw.contiguous()
    uu = uu.contiguous()
    extra = K // 16 + 2048
    fscr = torch.empty(5 * K + extra, dtype=torch.float64, device=dev)
    iscr = torch.empty(3 * K + extra, dtype=torch.int32, device=dev)
    lscr = torch.empty(K, dtype=torch.int64, device=dev)
    parent = torch.empty(K, dtype=torch.int64, device=dev)
    new_lw = torch.empty(K, dtype=torch.float64, device=dev)
    n_groups = torch.empty((), dtype=torch.int32, device=dev)
    lib = cuda.load()
    with torch.cuda.device(dev):
        rc = lib.ckpe_merge_resample(
            int(mode), hs.data_ptr(), perm.data_ptr(), lw.data_ptr(),
            uu.data_ptr(), log_k, int(K), parent.data_ptr(),
            new_lw.data_ptr(), n_groups.data_ptr(), fscr.data_ptr(),
            iscr.data_ptr(), lscr.data_ptr(), cuda.stream(h))
    cuda.check(rc, "merge_resample", lib)
    merge_resample.launches += 1
    return parent, new_lw, n_groups


merge_resample.launches = 0


def _merge_stats(h, lw):
    """Groups members by content hash and log-sum-exp merges their
    weights (the reference's contract; by sort, so equal hashes always
    merge). Returns (grp [K] the first member of each member's group,
    merged_lw [K] the group's weight at that member and -inf elsewhere,
    is_rep [K] bool, n_groups)."""
    grp, merged_lw, n_groups = merge_resample(h, lw, None, _MODE_STATS)
    is_rep = grp == torch.arange(h.numel(), device=h.device)
    return grp, merged_lw, is_rep, n_groups


def _merge_weights_inplace(h, lw):
    """Weight-only merge for the per-step beam: each duplicate group's
    total weight moves to one representative slot, the others drop to
    -inf (no tape moves)."""
    return merge_resample(h, lw, None, _MODE_STATS)[1]


def _merge_resample(u, h, lw):
    """Merge duplicates, then deal all K slots over the unique
    configurations by systematic resampling in proportion to merged
    weight, a configuration's weight split over its m slots (w/m).
    Returns (parent [K] member index per slot, new_lw [K], n_groups).
    The reference's `_merge_resample` and its sort-based twin
    `_merge_resample_sorted` are this one function here (module
    docstring)."""
    return merge_resample(h, lw, u, _MODE_GROUPS)


_merge_resample_sorted = _merge_resample


def _merge_resample_positions(u, h, lw):
    """Systematic resampling over the members in hash order with EQUAL
    slot weights (total/K): totals kept exactly, a group's slot count
    within 1 of K times its share. Returns (parent, new_lw,
    n_unique)."""
    return merge_resample(h, lw, u, _MODE_POSITIONS)


# --- K21: the parent gather -----------------------------------------------------


def gather_pair_plain(ptape, dtape, parent, flag=None):
    """K21's plain version: slot s of the new tapes (and flag) is row
    ``parent[s]`` of the old."""
    gather_pair_plain.calls += 1
    out = (ptape[parent], dtape[parent])
    return out + ((flag[parent],) if flag is not None else ())


gather_pair_plain.calls = 0


def gather_pair(ptape, dtape, parent, flag=None):
    """K21: both int8 tapes' rows (and a bool ``flag``'s entries) of
    each slot's parent (``parent`` int64 [K] in [0, K)). Returns new
    tensors: (ptape, dtape) or (ptape, dtape, flag)."""
    if ptape.dtype != torch.int8 or dtape.shape != ptape.shape:
        raise TypeError("gather_pair takes two equal int8 [K, L] tapes")
    if parent.dtype != torch.int64 or parent.dim() != 1:
        raise TypeError("parent must be a 1-D int64 tensor")
    if not cuda.on_card(ptape, "gather_pair"):
        return gather_pair_plain(ptape, dtape, parent, flag)
    K, L = ptape.shape
    p, d = ptape.contiguous(), dtape.contiguous()
    par = parent.contiguous()
    op, od = torch.empty_like(p), torch.empty_like(d)
    f = None if flag is None else flag.to(torch.bool).contiguous()
    of = None if f is None else torch.empty_like(f)
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_gather_pair(
            p.data_ptr(), d.data_ptr(), par.data_ptr(), int(par.numel()),
            int(L), op.data_ptr(), od.data_ptr(),
            None if f is None else f.data_ptr(),
            None if of is None else of.data_ptr(), cuda.stream(p))
    cuda.check(rc, "gather_pair", lib)
    gather_pair.launches += 1
    return (op, od) + ((of,) if f is not None else ())


gather_pair.launches = 0


# --- The blocked frontier's rounds ---------------------------------------------


def tempered_round(dm, ptape, dtape, shifts, events, uniforms, tau, lw):
    """Tempered FSM rounds, in place: ``len(shifts)`` rounds of K11's
    site lattice at shared shifts (int32 [n]) on int8 tapes [K, L], the
    chooses sampled from q ∝ p^tau with ``uniforms`` float32 [n, K, E],
    each member's importance increments added to ``lw`` (float64 [K]).
    CPU tensors take `ensemble.lattice_round_plain`; CUDA ones K11's
    tempered entry (`csrc/lattice_round.cuh`, a unit a machine and tau):
    one launch for all the rounds on members resident in shared memory
    (`ensemble.k11_tempered_tile`), or a launch a round where the rows
    do not fit a block or the rounds are fewer than
    `ensemble.K11_RESIDENT_MIN_ROUNDS`."""
    n = shifts.shape[0]
    ens._check_lattice(dm, ptape, dtape, shifts, 0, n, events, uniforms)
    if shifts.dim() != 1:
        raise TypeError("tempered rounds take one shift a round")
    if lw.dtype != torch.float64 or lw.shape != (ptape.shape[0],):
        raise TypeError("lw must be float64 [K]")
    if not cuda.on_card(ptape, "tempered_round"):
        for j in range(n):
            ens.lattice_round_plain(dm, ptape, dtape, shifts[j], events,
                                    uniforms[j], tau=tau, lw=lw)
        return
    from .k1_source import k1_library

    lib = k1_library(dm, tau)
    K, L = ptape.shape
    tile = (ens.k11_tempered_tile(K, L)
            if n >= ens.K11_RESIDENT_MIN_ROUNDS else None)
    with torch.cuda.device(ptape.device):
        rc = lib.ckpe_k11_rounds_logp(
            ptape.data_ptr(), dtape.data_ptr(), uniforms.data_ptr(),
            shifts.data_ptr(), 0, int(n), int(K), int(L), int(events),
            lw.data_ptr(), *(tile[:2] if tile else (0, 0)),
            cuda.stream(ptape))
    cuda.check(rc, "tempered_round", lib)
    tempered_round.launches += 1 if tile else n


tempered_round.launches = 0


def _route(dm, K: int, tau: float, bitslice, device) -> bool:
    """The reference's choice of the bit-sliced round for a block
    (`_blocked_rounds`), with the CPU's circuit limit on the CPU."""
    from . import bitslice as bs

    bs_free = bs.machine_is_bitsliceable(dm)
    use_bs = (bitslice is not False and K % 32 == 0
              and (bs_free or (tau == 1.0 and bs.machine_is_sampleable(dm))))
    if bitslice and not use_bs:
        raise ValueError(
            "bitslice=True needs K % 32 == 0 and a choose-free machine "
            "(any tau) or a sampleable machine at tau=1")
    return use_bs and (bool(bitslice) or bs.circuit_cpu_ok(dm, device))


def blocked_rounds_from_draws(dm, ptape, dtape, lw, shifts, events: int,
                              uniforms=None, *, tau: float = 1.0,
                              bitslice=None, rand_words=None):
    """One block of the blocked frontier's rounds with explicit draws,
    in place on int8 tapes [K, L] and ``lw`` (float64 [K]), ``events``
    sites a member: ``shifts`` int32 [n] in [0, L/events) shared by the
    batch; for the FSM walk
    ``uniforms`` float32 [n, K, E] (the reference draws [E, K]: its
    transpose); for a sampling circuit ``rand_words`` [n, n_rand,
    E, K // 32] int32. The route is the reference's (`_route`): the
    bit-sliced round (K14 on K15's words, transposed layout) where
    eligible, else K11, tempered (increments into ``lw``) at tau < 1 for
    a machine with choose nodes. Returns (ptape, dtape, lw)."""
    n = shifts.shape[0]
    return _blocked_rounds_run(dm, ptape, dtape, lw, events, tau, bitslice,
                               [(0, n, uniforms if dm.has_choose else None,
                                 rand_words)], shifts)


def _blocked_rounds_run(dm, ptape, dtape, lw, events, tau, bitslice, chunks,
                        shifts):
    """Runs a block's chunks of draws ((k0, n, uniforms, rand_words)) on
    the route `_route` picks."""
    from . import bitslice as bs

    K, L = ptape.shape
    stride = L // events
    dev = ptape.device
    if _route(dm, K, tau, bitslice, dev):
        circ = bs.machine_circuit(dm)
        nb = circ[2]
        p_bp = bs.tapes_to_bitplanes(ptape, stride, nb, transpose=True)
        d_bp = bs.tapes_to_bitplanes(dtape, stride, nb, transpose=True)
        axis = bs.site_axis_of(p_bp, True)
        for k0, n, _, words in chunks:
            w = None
            if circ[3]:
                w = words.reshape((n, circ[3]) + tuple(p_bp.shape[2:]))
            bs._check_words(dm, circ, p_bp, d_bp, shifts, k0, n, w, axis)
            bs._bitsliced_rounds(dm, circ, p_bp, d_bp, shifts, k0, n, w, axis)
        bs.unpack_bitwords(p_bp.contiguous(),
                           ptape.view(K, events, stride), transpose=True)
        bs.unpack_bitwords(d_bp.contiguous(),
                           dtape.view(K, events, stride), transpose=True)
        return ptape, dtape, lw
    temper = tau != 1.0 and dm.has_choose
    for k0, n, uniforms, _ in chunks:
        if temper:
            tempered_round(dm, ptape, dtape, shifts[k0:k0 + n], events,
                           uniforms, tau, lw)
        else:
            ens._check_lattice(dm, ptape, dtape, shifts, k0, n, events,
                               uniforms)
            ens._lattice_rounds(dm, ptape, dtape, shifts, k0, n, events,
                                uniforms)
    return ptape, dtape, lw


def _blocked_rounds(generator, ptape, dtape, lw, dm, *, rounds: int,
                    tau: float, events: int, bitslice=None):
    """One block of stratified rounds, in place (see
    `blocked_rounds_from_draws`), drawing from ``generator``: the
    block's shifts over [0, stride) first, then each round's uniforms
    (or random words) a chunk of rounds at a time, as `run_ensemble`
    draws them."""
    from . import bitslice as bs

    K, L = ptape.shape
    stride = L // events
    dev = ptape.device
    gen = config.make_generator(generator, dev)
    shifts = torch.randint(0, stride, (rounds,), generator=gen, device=dev,
                           dtype=torch.int32)
    if _route(dm, K, tau, bitslice, dev):
        circ = bs.machine_circuit(dm)
        wshape = (events, K // 32)
        chunks = ((k0, n, None, w) for k0, n, w in ens._draw_word_chunks(
            gen, circ[3], wshape, rounds, dev))
    else:
        limit = (ens._RESIDENT_CHUNK if tau != 1.0 and dm.has_choose
                 else ens._UNIFORM_CHUNK)
        chunks = ((k0, n, u, None) for k0, n, u in ens._draw_chunks(
            gen, dm, K, events, rounds, dev, limit))
    return _blocked_rounds_run(dm, ptape, dtape, lw, events, tau, bitslice,
                               chunks, shifts)


# --- The blocked merges ---------------------------------------------------------


def _blocked_merge(u, ptape, dtape, lw, stride: int):
    """Merge by content (K19 at 4 bits, the reference's plane-column
    order) and systematic slot resampling (K20), then the parent gather
    (K21): w/m slot weights below `_MERGE_STAGED_MIN_K` members, equal
    ones from there on, as the reference. Returns (ptape, dtape,
    lw - max, n_unique)."""
    h = content_hash(ptape, dtape, stride=stride, bits=4)
    if lw.shape[0] >= _MERGE_STAGED_MIN_K:
        parent, new_lw, nu = _merge_resample_positions(u, h, lw)
    else:
        parent, new_lw, nu = _merge_resample(u, h, lw)
    ptape, dtape = gather_pair(ptape, dtape, parent)
    return ptape, dtape, new_lw - new_lw.max(), nu


def _blocked_merge_flagged(u, ptape, dtape, lw, flag, stride: int):
    """`_blocked_merge` with the hit flag in the merge key (members merge
    only within equal hit status) and carried to the slots."""
    h = content_hash(ptape, dtape, stride=stride, bits=4, flag=flag)
    parent, new_lw, nu = _merge_resample(u, h, lw)
    ptape, dtape, flag = gather_pair(ptape, dtape, parent, flag)
    return ptape, dtape, new_lw - new_lw.max(), flag, nu


def _blocked_merge_equal(u, ptape, dtape, lw, stride: int):
    """Content merge and systematic resample with EQUAL slot weights
    (total/K each, on the absolute log scale): the total live weight is
    kept exactly, the unbiased step of the absorbing first-passage
    estimator."""
    h = content_hash(ptape, dtape, stride=stride, bits=4)
    parent, _, nu = _merge_resample(u, h, lw)
    K = lw.shape[0]
    new_lw = torch.full((K,), 0.0, dtype=lw.dtype, device=lw.device)
    new_lw += torch.logsumexp(lw, 0) - math.log(K)
    ptape, dtape = gather_pair(ptape, dtape, parent)
    return ptape, dtape, new_lw, nu


def _validate_blocked_plan(dm, L: int, plan: tuple, tau: float) -> None:
    """Shared gate of the blocked frontier: lattice geometry (disjoint
    read/write windows), plane-stride bound, hash field width, and tau
    range."""
    _, _, events = plan
    if L % events:
        raise ValueError(f"events_per_round={events} must divide L={L}")
    stride = L // events
    if stride <= 2 * dm.span:
        raise ValueError(
            f"stride {stride} too small for window span {dm.span}; "
            "lower events_per_round"
        )
    if stride > ens._MAX_PLANE_STRIDE:
        raise ValueError(
            f"stride {stride} exceeds _MAX_PLANE_STRIDE="
            f"{ens._MAX_PLANE_STRIDE}; raise events_per_round"
        )
    if not (0.0 < tau <= 1.0):
        raise ValueError(f"tau={tau} must be in (0, 1]")
    if dm.size_a > 16:
        raise ValueError(
            f"size_a={dm.size_a} exceeds the blocked frontier's 4-bit "
            "merge-key fields (max 16 symbols); use the per-step "
            "run_weighted_frontier"
        )


def _start(tapes, logw, device):
    """int8 copies of the initial tapes on ``device``, the log-weights
    as float64, and the tapes' dtype."""
    ptape, dtape = tapes
    in_dtype = torch.as_tensor(ptape).dtype
    pt, dt_ = (ens._int8_copy(t, device) for t in tapes)
    lw = torch.as_tensor(logw, dtype=torch.float64, device=device).clone()
    return pt, dt_, lw, in_dtype


def _draw_u(gen, device):
    return torch.rand((), generator=gen, dtype=torch.float64, device=device)


def run_weighted_frontier_blocked(generator, tapes, logw, dm, plan: tuple, *,
                                  tau: float = 1.0, bitslice=None,
                                  device=None):
    """Blocked weighted frontier: stratified multi-site rounds between
    re-ranks, with merge by content and weight-proportional slot
    resampling.

    Each round fires the rule at E lattice sites a member; each choose
    samples one branch from q ∝ p^tau and multiplies the member's
    weight by p/q (tau = 1: the true law, weights untouched). Each block
    of ``rounds`` rounds ends with `_blocked_merge`: duplicate
    configurations merge by log-sum-exp and all K slots are dealt again
    in proportion to merged weight.

    Args:
      generator: `torch.Generator` on ``device``, or an int seed: each
        block draws its shifts, its rounds' uniforms (or random words)
        and its merge's uniform from it in turn.
      tapes: (ptape [K, L], dtape [K, L]) integer tapes.
      logw: [K] log-weights.
      dm: compiled `ensemble.DeviceMachine`.
      plan: (num_blocks, rounds_per_block, events_per_round);
        events_per_round must divide L with L/events > 2·span.
      tau: branch-sampling temperature in (0, 1].
      bitslice: None (the bit-sliced round where eligible; on the CPU
        only for circuits of at most `bitslice.CPU_MAX_CIRCUIT_OPS`
        ops), True (raise where ineligible) or False (the FSM walk).
      device: where the run goes; ``cuda`` unless named.

    Returns:
      ((ptape, dtape) in the input's dtype, logw normalised (exp sums
      to 1), n_unique int32 [num_blocks]).
    """
    num_blocks, rounds, events = plan
    if not isinstance(dm, ens.DeviceMachine):
        raise TypeError(
            "run_weighted_frontier_blocked needs a DeviceMachine "
            "(compile_decision_machine); table-only rules use "
            "run_weighted_frontier")
    device = config.get_device(device)
    pt, dt_, lw, in_dtype = _start(tapes, logw, device)
    L = pt.shape[1]
    _validate_blocked_plan(dm, L, plan, tau)
    stride = L // events
    gen = config.make_generator(generator, device)
    n_unique = []
    for _ in range(num_blocks):
        pt, dt_, lw = _blocked_rounds(gen, pt, dt_, lw, dm, rounds=rounds,
                                      tau=tau, events=events,
                                      bitslice=bitslice)
        pt, dt_, lw, nu = _blocked_merge(_draw_u(gen, device), pt, dt_, lw,
                                         stride)
        n_unique.append(nu)
    lw = lw - torch.logsumexp(lw, 0)
    return (pt.to(in_dtype), dt_.to(in_dtype)), lw, torch.stack(n_unique)


# --- Weighted first passage ----------------------------------------------------


def _lse(x):
    return torch.logsumexp(x, 0)


def _ess(lw, den):
    return torch.exp(2.0 * den - _lse(2.0 * lw))


def _blocked_rounds_ess_adaptive(generator, ptape, dtape, lw, flux_lw, dm,
                                 pattern, *, rounds: int, tau: float,
                                 events: int, data_tape: bool,
                                 check_every: int, ess_frac: float):
    """One block of rounds with ABSORBING hits and ESS-triggered
    intra-block resampling. After each ``check_every``-round sub-block,
    members whose tape holds the pattern (K12) move their weight into
    the log-flux and drop to -inf; when the live ESS falls below
    ``ess_frac * K`` the equal-weight merge (`_blocked_merge_equal`)
    fires at once. The trigger is one host read of a device flag a
    sub-block (the reference's `lax.cond`). Returns (ptape, dtape, lw,
    flux_lw, n_merges)."""
    if rounds % check_every:
        raise ValueError(
            f"rounds={rounds} not divisible by check_every={check_every}")
    K, L = ptape.shape
    stride = L // events
    n_merges = 0
    for _ in range(rounds // check_every):
        ptape, dtape, lw = _blocked_rounds(generator, ptape, dtape, lw, dm,
                                           rounds=check_every, tau=tau,
                                           events=events)
        hit = ens.contains_pattern(dtape if data_tape else ptape, pattern,
                                   device=ptape.device)
        flux_lw = torch.logaddexp(
            flux_lw, _lse(torch.where(hit, lw, -math.inf)))
        lw = torch.where(hit, -math.inf, lw)
        den = _lse(lw)
        trigger = (_ess(lw, den) < ess_frac * K) & torch.isfinite(den)
        u = _draw_u(generator, ptape.device)
        if bool(trigger):
            ptape, dtape, lw, _ = _blocked_merge_equal(u, ptape, dtape, lw,
                                                       stride)
            n_merges += 1
    return ptape, dtape, lw, flux_lw, n_merges


def weighted_first_passage(generator, tapes, logw, dm, pattern, plan: tuple,
                           *, tau: float = 1.0, data_tape: bool = True,
                           ess_frac: float = 0.0, check_every: int = 0,
                           device=None):
    """Weighted-ensemble first-passage estimation on the blocked
    frontier: survival S(t_b) = P(pattern not yet seen) at every block
    boundary, with importance weights (the reference's contract).

    Without ``ess_frac`` the hit flag rides the merge key
    (`_blocked_merge_flagged`): members merge only within equal hit
    status. With ``ess_frac > 0`` (and ``check_every`` dividing the
    block's rounds) hits ABSORB into a flux accumulator on one absolute
    log scale and the equal-weight resample fires whenever the live ESS
    drops below ``ess_frac * K`` (`_blocked_rounds_ess_adaptive`);
    ``hit`` then marks absorbed slots, and ``ess`` and ``n_unique``
    describe the live population (NaN ESS once all are absorbed).

    Returns ``(survival [num_blocks], ess [num_blocks], t_blocks
    [num_blocks] (numpy), (ptape, dtape), logw, hit, n_unique
    [num_blocks])``, tensors on ``device`` (``cuda`` unless named).
    """
    num_blocks, rounds, events = plan
    device = config.get_device(device)
    pt, dt_, lw, in_dtype = _start(tapes, logw, device)
    K, L = pt.shape
    _validate_blocked_plan(dm, L, plan, tau)
    stride = L // events
    hit = ens.contains_pattern(dt_ if data_tape else pt, pattern,
                               device=device)
    if ess_frac > 0.0 and not check_every:
        raise ValueError("ess_frac > 0 needs check_every > 0")
    gen = config.make_generator(generator, device)
    surv, esses, n_unique = [], [], []
    if ess_frac > 0.0:
        lw = lw - _lse(lw)
        flux_lw = _lse(torch.where(hit, lw, -math.inf))
        lw = torch.where(hit, -math.inf, lw)
        for _ in range(num_blocks):
            pt, dt_, lw, flux_lw, _ = _blocked_rounds_ess_adaptive(
                gen, pt, dt_, lw, flux_lw, dm, pattern, rounds=rounds,
                tau=tau, events=events, data_tape=data_tape,
                check_every=check_every, ess_frac=ess_frac)
            den = _lse(lw)
            surv.append(torch.clamp(1.0 - torch.exp(flux_lw), min=0.0))
            esses.append(_ess(lw, den))
            u = _draw_u(gen, device)
            if bool(torch.isfinite(den)):  # all absorbed: nothing to merge
                pt, dt_, lw, nu = _blocked_merge_equal(u, pt, dt_, lw, stride)
            else:
                nu = torch.zeros((), dtype=torch.int32, device=device)
            n_unique.append(nu)
        hit = ~torch.isfinite(lw)
    else:
        for _ in range(num_blocks):
            pt, dt_, lw = _blocked_rounds(gen, pt, dt_, lw, dm, rounds=rounds,
                                          tau=tau, events=events)
            hit = hit | ens.contains_pattern(dt_ if data_tape else pt,
                                             pattern, device=device)
            den = _lse(lw)
            num = _lse(torch.where(hit, -math.inf, lw))
            surv.append(torch.exp(num - den))
            esses.append(_ess(lw, den))
            pt, dt_, lw, hit, nu = _blocked_merge_flagged(
                _draw_u(gen, device), pt, dt_, lw, hit, stride)
            n_unique.append(nu)
    dt_round = -math.log1p(-events / L)
    t_blocks = dt_round * rounds * np.arange(1, num_blocks + 1)
    den = _lse(lw)
    lw = torch.where(torch.isfinite(den), lw - den, lw)
    return (torch.stack(surv), torch.stack(esses), t_blocks,
            (pt.to(in_dtype), dt_.to(in_dtype)), lw, hit,
            torch.stack(n_unique))


def weighted_first_passage_binned(generator, tapes, logw, dm, pattern,
                                  plan: tuple, *, tau: float = 1.0,
                                  data_tape: bool = True, q_fn=None,
                                  q_target: int | None = None,
                                  split: bool = True, seed: int = 0,
                                  rounds_fn=None, device=None):
    """Weighted-ensemble SPLITTING on a progress coordinate for
    state-rare first-passage targets (the reference's contract). After
    each block live walkers are binned by ``q_fn`` (default:
    `ensemble.pattern_progress`, K12), each occupied bin is
    systematically resampled (`soup_we._systematic`, host numpy) to its
    share of the K slots with its total weight kept (extra slots to the
    leading edge) and the slots gathered on the device (K21), and
    walkers that reach ``q_target`` add their weight to the flux and
    freeze out. ``split=False`` is plain Monte Carlo in the same harness.

    ``rounds_fn`` swaps the block dynamics: ``fn(generator, ptape, dtape,
    lw) -> (ptape, dtape, lw)`` on int8 [K, L] tapes (the reference's
    calling convention with a generator for its key).

    Returns ``(survival [num_blocks], t_blocks, occupancy [num_blocks],
    q_max [num_blocks])``, numpy arrays.
    """
    from .soup_we import _systematic

    num_blocks, rounds, events = plan
    device = config.get_device(device)
    pt, dt_, _, _ = _start(tapes, logw, device)
    K, L = pt.shape
    _validate_blocked_plan(dm, L, plan, tau)
    if q_fn is None:
        def q_fn(t):
            return ens.pattern_progress(t, pattern, device=device)
        q_tgt = len(tuple(pattern))
    else:
        if q_target is None:
            raise ValueError("custom q_fn needs an explicit q_target")
        q_tgt = q_target
    rng = np.random.default_rng(seed)
    gen = config.make_generator(generator, device)
    w = np.exp(np.asarray(torch.as_tensor(logw, dtype=torch.float64).cpu()))
    live = np.ones(K, bool)
    dt_round = -math.log1p(-events / L)
    survival = np.zeros(num_blocks)
    occupancy = np.zeros(num_blocks, np.int64)
    q_best = np.zeros(num_blocks, np.int64)
    cum_flux = 0.0

    def q_now():
        return np.asarray(torch.as_tensor(q_fn(dt_ if data_tape else pt))
                          .cpu())

    # Walkers born at the target absorb at t = 0.
    q = q_now()
    born = live & (q >= q_tgt)
    cum_flux += w[born].sum()
    w[born] = 0.0
    live[born] = False
    for b in range(num_blocks):
        lw_dev = torch.as_tensor(np.log(np.maximum(w, 1e-300)),
                                 device=device)
        if rounds_fn is None:
            pt, dt_, lw_dev = _blocked_rounds(gen, pt, dt_, lw_dev, dm,
                                              rounds=rounds, tau=tau,
                                              events=events)
        else:
            pt, dt_, lw_dev = rounds_fn(gen, pt, dt_, lw_dev)
        if tau != 1.0:
            w = np.where(live, np.exp(lw_dev.cpu().numpy()), 0.0)
        q = q_now()
        q_best[b] = int(q[live].max()) if live.any() else 0
        hit = live & (q >= q_tgt)
        cum_flux += w[hit].sum()
        w[hit] = 0.0
        live[hit] = False
        survival[b] = 1.0 - cum_flux
        if split and live.any():
            qb = np.minimum(q, q_tgt - 1)
            vals = np.unique(qb[live])
            n_occ = len(vals)
            base = K // n_occ
            extra = K - base * n_occ
            parent = np.zeros(K, np.int64)
            new_w = np.zeros(K)
            pos = 0
            for vi, v in enumerate(vals):
                n_v = base + (1 if vi >= n_occ - extra else 0)
                sel = np.flatnonzero(live & (qb == v))
                src, sw = _systematic(sel, w[sel], n_v, rng)
                parent[pos:pos + n_v] = src
                new_w[pos:pos + n_v] = sw
                pos += n_v
            pt, dt_ = gather_pair(pt, dt_, torch.as_tensor(parent,
                                                           device=device))
            w = new_w
            live = w > 0.0
            occupancy[b] = n_occ
        else:
            occupancy[b] = (len(np.unique(
                np.minimum(q, q_tgt - 1)[live])) if live.any() else 0)
        if not live.any():
            survival[b + 1:] = survival[b]
            break
    t_blocks = dt_round * rounds * np.arange(1, num_blocks + 1)
    return survival, t_blocks, occupancy, q_best


# --- K22: the per-step beam ----------------------------------------------------


def _out_log(dtable):
    """log p of each (row, outcome) in the table's precision, -inf where
    p = 0, as float64."""
    cum = dtable.out_cum
    probs = torch.diff(cum, dim=1, prepend=torch.zeros_like(cum[:, :1]))
    return torch.where(probs > 0, torch.log(torch.clamp(probs, min=1e-300)),
                       -math.inf).to(torch.float64)


def _window_cols(dtable, L: int, site):
    dev = dtable.pv.device
    s = torch.as_tensor(site, device=dev).to(torch.int64)
    return (torch.remainder(s + dtable.p_lo + torch.arange(dtable.n_p,
                                                           device=dev), L),
            torch.remainder(s + dtable.d_lo + torch.arange(dtable.n_d,
                                                           device=dev), L))


def frontier_rank_plain(dtable, out_log, ptape, dtape, lw, site):
    """K22's first launch, plain: each member's table row at the shared
    ``site`` (the int32 radix sum and the reference's index rule) and
    child_lw = lw + out_log[row] [K, M]; at M = 1 the member's window is
    written in place. Returns (rows int64 [K], child_lw)."""
    frontier_rank_plain.calls += 1
    cp, cd = _window_cols(dtable, ptape.shape[1], site)
    cells = torch.cat([ptape[:, cp], dtape[:, cd]], dim=1).to(torch.int32)
    rows = ens.table_rows(dtable, cells)
    child = lw[:, None] + out_log[rows]
    if out_log.shape[1] == 1:
        spec = dtable.out_world[rows, 0].to(torch.int64)
        _write_plain(dtable, ptape, dtape, ptape, dtape, cp, cd, spec)
    return rows, child


frontier_rank_plain.calls = 0


def _write_plain(dtable, op, od, qp, qd, cp, cd, spec):
    """Writes the window of ``spec``'s outcome into rows of op, od, the
    cells that it leaves alone taken from qp, qd."""
    mask = dtable.wr_mask[spec]
    vals = dtable.wr_val[spec].to(torch.int8)
    n_p = dtable.n_p
    op[:, cp] = torch.where(mask[:, :n_p], vals[:, :n_p], qp[:, cp])
    od[:, cd] = torch.where(mask[:, n_p:], vals[:, n_p:], qd[:, cd])


def frontier_write_plain(dtable, ptape, dtape, rows, idx, vals, site):
    """K22's second launch (M > 1), plain: slot s takes child ``idx[s]``
    (parent idx // M, outcome idx % M): the parent's rows, the outcome's
    writes at ``site``; new_lw[s] = vals[s] - vals[0]. Returns (ptape,
    dtape, new_lw), new tensors."""
    frontier_write_plain.calls += 1
    M = dtable.out_world.shape[1]
    parent, slot = idx // M, idx % M
    spec = dtable.out_world[rows[parent], slot].to(torch.int64)
    cp, cd = _window_cols(dtable, ptape.shape[1], site)
    qp, qd = ptape[parent], dtape[parent]
    op, od = qp.clone(), qd.clone()
    _write_plain(dtable, op, od, qp, qd, cp, cd, spec)
    return op, od, vals - vals[0]


frontier_write_plain.calls = 0


def frontier_step_plain(dtable, out_log, ptape, dtape, lw, site):
    """One step of the per-step beam by K22's plain versions: the rank,
    then (M > 1) the stable descending sort of the K*M children and the
    write of the top K. Returns (ptape, dtape, new_lw); at M = 1 the
    tapes are updated in place."""
    K = ptape.shape[0]
    rows, child = frontier_rank_plain(dtable, out_log, ptape, dtape, lw, site)
    if out_log.shape[1] == 1:
        top = child[:, 0]
        return ptape, dtape, top - top.max()
    vals, idx = torch.sort(child.reshape(-1), descending=True, stable=True)
    return frontier_write_plain(dtable, ptape, dtape, rows, idx[:K],
                                vals[:K], site)


def _k22_table_args(dtable, out_log):
    return (int(dtable.p_lo), int(dtable.n_p), int(dtable.d_lo),
            int(dtable.n_d), int(dtable.num_rows), int(out_log.shape[1]),
            dtable.pv.data_ptr(), out_log.data_ptr(),
            dtable.out_world.data_ptr(), dtable.wr_mask.data_ptr(),
            dtable.wr_val.data_ptr())


class BeamBuffers:
    """K22's buffers for a run of the per-step beam at K members, L
    cells and M outcomes on one card: the rows and children, the
    select's and the sort's workspace (`csrc/frontier.cu:k22_ws`), and
    two pairs of tapes and two weight vectors that the steps take in
    turn, so a step allocates nothing."""

    def __init__(self, K: int, L: int, M: int, device):
        lib = cuda.load()
        i8, f64 = torch.int8, torch.float64
        self.K, self.L, self.M = K, L, M
        self.rows = torch.empty(K, dtype=torch.int32, device=device)
        self.child = torch.empty(K * M, dtype=f64, device=device)
        self.ws = torch.empty(int(lib.ckpe_k22_workspace_bytes(K, M)),
                              dtype=torch.uint8, device=device)
        self.lws = [torch.empty(K, dtype=f64, device=device)
                    for _ in range(2)]
        self.tapes = ([(torch.empty((K, L), dtype=i8, device=device),
                        torch.empty((K, L), dtype=i8, device=device))
                       for _ in range(2)] if M > 1 else [])

    def lw_out(self, lw):
        """The weight buffer that is not ``lw``."""
        return self.lws[1] if lw.data_ptr() == self.lws[0].data_ptr() \
            else self.lws[0]

    def tapes_out(self, ptape):
        """The pair of tapes that is not ``ptape``'s."""
        return self.tapes[1] if ptape.data_ptr() == \
            self.tapes[0][0].data_ptr() else self.tapes[0]


def frontier_step(dtable, out_log, ptape, dtape, lw, sites, k: int,
                  bufs: BeamBuffers | None = None):
    """K22: step ``k`` of the per-step beam at the shared site
    ``sites[k]`` (int32 on the tapes' device, read there). At M = 1 the
    tapes are updated in place; at M > 1 the top K of the K*M children
    (in a stable descending sort's order) are written into new tapes.
    Returns (ptape, dtape, new_lw) with new_lw's largest entry 0. On a
    card the step's outputs lie in ``bufs`` (new buffers when None): two
    C calls at M > 1 (the rank; the select, the order and the write),
    one at M = 1; int8 tapes and float64 weights."""
    K, L = ptape.shape
    M = out_log.shape[1]
    if not cuda.on_card(ptape, "frontier_step"):
        return frontier_step_plain(dtable, out_log, ptape, dtape, lw,
                                   sites[k])
    if ptape.dtype != torch.int8 or dtape.dtype != torch.int8 or \
            lw.dtype != torch.float64:
        raise TypeError("K22 takes int8 tapes and float64 weights")
    if bufs is None:
        bufs = BeamBuffers(K, L, M, ptape.device)
    lib = cuda.load()
    st = cuda.stream(ptape)
    site = sites[k:k + 1]
    tab = _k22_table_args(dtable, out_log)
    new_lw = bufs.lw_out(lw)
    with torch.cuda.device(ptape.device):
        rc = lib.ckpe_k22_rank(
            ptape.data_ptr(), dtape.data_ptr(), lw.data_ptr(),
            site.data_ptr(), K, L, *tab, bufs.rows.data_ptr(),
            bufs.child.data_ptr(), bufs.ws.data_ptr(), new_lw.data_ptr(), st)
    cuda.check(rc, "frontier_step (rank)", lib)
    frontier_step.launches += 1
    if M == 1:
        return ptape, dtape, new_lw
    op, od = bufs.tapes_out(ptape)
    with torch.cuda.device(ptape.device):
        rc = lib.ckpe_k22_keep(
            ptape.data_ptr(), dtape.data_ptr(), op.data_ptr(), od.data_ptr(),
            bufs.rows.data_ptr(), bufs.child.data_ptr(), site.data_ptr(), K,
            L, *tab, bufs.ws.data_ptr(), new_lw.data_ptr(), st)
    cuda.check(rc, "frontier_step (keep)", lib)
    frontier_step.launches += 1
    return op, od, new_lw


frontier_step.launches = 0


def _check_beam(dtable, K: int, L: int, top_k: int) -> None:
    if top_k != K:
        raise ValueError(
            f"top_k={top_k} must equal the frontier width K={K} (the "
            "frontier is fixed-width; children replace parents 1:1)")
    if dtable.size_a > 127:
        raise ValueError(
            f"size_a={dtable.size_a} exceeds the frontier's int8 tape "
            "layout (symbols must fit int8)")
    lo = min(dtable.p_lo, dtable.d_lo)
    if max(dtable.p_lo - lo + dtable.n_p, dtable.d_lo - lo + dtable.n_d) > L:
        raise ValueError(f"window span exceeds tape length {L}")
    if dtable.n_cells > 32:
        raise ValueError(f"K22 takes tables of at most 32 window cells, not "
                         f"{dtable.n_cells}")


def run_weighted_frontier_from_draws(tapes, logw, dtable, sites, top_k: int,
                                     merge_every: int = 0):
    """:func:`run_weighted_frontier` with explicit draws: ``sites``
    int32 [num_steps] in [0, L) on the table's device (the reference
    draws one a step, `randint(k, (), 0, L)`). Returns ((ptape, dtape)
    in the input's dtype, logw normalised)."""
    dev = dtable.pv.device
    pt, dt_, lw, in_dtype = _start(tapes, logw, dev)
    K, L = pt.shape
    _check_beam(dtable, K, L, top_k)
    sites = torch.as_tensor(sites, dtype=torch.int32, device=dev).contiguous()
    out_log = _out_log(dtable).contiguous()
    M = out_log.shape[1]
    bufs = BeamBuffers(K, L, M, dev) if cuda.on_card(
        pt, "run_weighted_frontier") else None
    for k in range(sites.shape[0]):
        pt, dt_, lw = frontier_step(dtable, out_log, pt, dt_, lw, sites, k,
                                    bufs)
        if merge_every and M > 1 and k % merge_every == merge_every - 1:
            h = content_hash(pt, dt_, stride=1, bits=8)
            lw = _merge_weights_inplace(h, lw)
    lw = lw - torch.logsumexp(lw, 0)
    return (pt.to(in_dtype), dt_.to(in_dtype)), lw


def run_weighted_frontier(generator, tapes, logw, dtable, num_steps: int,
                          top_k: int, merge_every: int = 0, *, device=None):
    """Weighted-frontier mode with top-k pruning (BASELINE config 5):
    each step fires the rule at one random site shared by all members,
    branches every configuration into all table outcomes and keeps the
    top k children by weight (K22). A beam-search approximation of the
    distribution's evolution; the exact SPD engine is its unpruned
    reference.

    Args:
      generator: `torch.Generator` on the table's device, or an int
        seed: all sites are drawn at once, over [0, L).
      tapes: (ptape [K, L], dtape [K, L]) initial frontier.
      logw: [K] log-weights.
      dtable: `ensemble.DeviceTable` (its device is the run's; ``device``
        must name it when given).
      num_steps: each step advances time by 1/L.
      top_k: must equal K (the frontier width is fixed).
      merge_every: if > 0, every merge_every steps duplicate
        configurations merge by content (K19 at 8 bits and K20's
        weight-only merge): their weight moves to one slot and the rest
        drop to -inf, so the next ranking backfills them (branching
        tables only).

    Returns:
      ((ptape, dtape), logw) after num_steps; exp(logw) sums to 1.
    """
    dev = dtable.pv.device
    want = None if device is None else torch.device(device)
    if want is not None and (want.type != dev.type or want.index not in (
            None, dev.index)):
        raise ValueError(f"the table lives on {dev}, not {device}")
    config.get_device(dev)
    K, L = torch.as_tensor(tapes[0]).shape
    gen = config.make_generator(generator, dev)
    sites = torch.randint(0, L, (num_steps,), generator=gen, device=dev,
                          dtype=torch.int32)
    return run_weighted_frontier_from_draws(tapes, logw, dtable, sites,
                                            top_k, merge_every)
