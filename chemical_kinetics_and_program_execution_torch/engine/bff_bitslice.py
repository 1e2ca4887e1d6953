"""Bit-sliced rounds of the mini-BFF interpreter: 32 members a word.

Counterpart of the JAX package's `engine/bff_bitslice.py`. The whole
fuel-step program of a BFF machine (opcode fetch, the bracket-scan mode,
head moves, the data write) is synthesised once a machine into a
hash-consed boolean DAG over the window's cell bits, op for op the
reference's (:func:`compile_bff_circuit`): registers one-hot over their
reachable ranges, cell reads as AND/OR reductions, the +-1 mod size_a
arithmetic from truth tables, the write as an XOR delta, and the
executed-opcode counts as 4-bit bit-serial counters (``size_a * 4``
outputs after the data cells). The circuit runs on the bit-plane words
of `bitslice.py` (K15 packs and unpacks them).

Kernel (its wrapper runs the plain version for CPU tensors only,
launches it for CUDA ones or raises, and counts its launches):

- **K17** :func:`bff_bitslice_round` / :func:`run_bff_bitsliced_rounds`
  — one round (or every round of a call, one launch a round) of a BFF
  circuit on bit-plane words, in place, with the round's exact int64
  opcode totals summed from the counter planes on the card;
  `bff_bitslice_source.py` writes the circuit into a CUDA unit that
  includes `csrc/bitslice_round.cuh` (K14's template too). Plain version:
  :func:`apply_bff_round_bitsliced`. It replaces the reference's
  `apply_bff_round_bitsliced` with `_eval_circuit` and the per-round
  popcount.

The round draws its shift over the whole tape [0, L), as the scan does,
so the tapes and totals equal the scan's bit for bit at the same shifts.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import cuda
from ..utils import config
from . import bitslice as bs
from . import ensemble as ens
from .bff import BffMachine
from .bitslice import CPU_MAX_CIRCUIT_OPS  # noqa: F401  (the reference's name)
from .bitslice import _Builder, _dce_compact, _synth_over


def _mod_shift(b: _Builder, valbits, delta: int, size_a: int):
    """Bit nodes of ``(val + delta) % size_a`` over ``valbits`` (LSB
    first); rows above size_a - 1 clamp, as the reference's."""
    nb = len(valbits)
    tab = np.zeros(1 << nb, dtype=np.int64)
    for v in range(1 << nb):
        tab[v] = (min(v, size_a - 1) + delta) % size_a
    memo: dict = {}
    return [_synth_over(b, ((tab >> k) & 1).astype(bool), valbits, memo)
            for k in range(nb)]


@functools.lru_cache(maxsize=None)
def compile_bff_circuit(mach: BffMachine):
    """(ops, outputs, nb, 0): the one-round circuit of a BFF machine, op
    for op the reference's.

    Inputs: the window's cell bits, LSB first a cell, program cells
    p_lo..p_hi then data cells d_lo..d_hi (only the data window for a
    self-modifying machine). Outputs: the data cells' new bits (n_d *
    nb), then ``size_a * 4`` bit-serial counter planes, the 4-bit count
    of fuel steps that fetched each opcode.
    """
    A = mach.size_a
    nb = max(1, (A - 1).bit_length())
    n_p = 0 if mach.self_modifying else mach.n_p
    b = _Builder((n_p + mach.n_d) * nb)

    if mach.self_modifying:
        d_cells = [list(b.inputs[c * nb:(c + 1) * nb])
                   for c in range(mach.n_d)]
        p_cells = d_cells  # the live alias: a write feeds the next fetch
        p_lo = mach.d_lo
    else:
        p_cells = [list(b.inputs[c * nb:(c + 1) * nb])
                   for c in range(n_p)]
        d_cells = [list(b.inputs[(n_p + c) * nb:(n_p + c + 1) * nb])
                   for c in range(mach.n_d)]
        p_lo = mach.p_lo

    def NOT(x):
        return b.gate("not", x)

    def AND(*xs):
        r = b.c1
        for x in xs:
            r = b.gate("and", r, x)
        return r

    def OR(*xs):
        r = b.c0
        for x in xs:
            r = b.gate("or", r, x)
        return r

    def eq_const(bits, v: int):
        return AND(*[bit if (v >> k) & 1 else NOT(bit)
                     for k, bit in enumerate(bits)])

    def eq_value(bits, v: int):
        """``value == v`` on valid cells: the fewest literals that tell v
        from every other symbol."""
        best = None
        for mask in range(1 << nb):
            if all(((u ^ v) & mask) != 0 for u in range(A) if u != v):
                if best is None or bin(mask).count("1") < \
                        bin(best).count("1"):
                    best = mask
        lits = [bits[k] if (v >> k) & 1 else NOT(bits[k])
                for k in range(nb) if (best >> k) & 1]
        return AND(*lits) if lits else b.c1

    def sel_onehot(H: dict, cells, lo: int):
        out = [b.c0] * nb
        for pos in sorted(H):
            cell = cells[pos - lo]
            for k in range(nb):
                out[k] = b.gate("or", out[k],
                                b.gate("and", H[pos], cell[k]))
        return out

    # One-hot register planes; a missing key is the constant 0.
    Hpc = {0: b.c1}
    Hd0 = {0: b.c1}
    Hd1 = {mach.d1_start: b.c1}
    Hm = {0: b.c1}
    if mach.fuel > 15:
        raise ValueError(f"{mach.tag}: 4-bit op counters take fuel <= 15")
    op_hots = [[] for _ in range(A)]

    def popcount4(hots):
        """4 LSB-first bits of sum(hots) by a 3:2 compressor tree."""
        buckets = {0: list(hots)}
        out = []
        for w in range(4):
            cur = buckets.get(w, [])
            while len(cur) >= 3:
                x, y, z2 = cur.pop(), cur.pop(), cur.pop()
                t = b.gate("xor", x, y)
                cur.append(b.gate("xor", t, z2))
                buckets.setdefault(w + 1, []).append(
                    b.gate("or", b.gate("and", x, y),
                           b.gate("and", z2, t)))
            if len(cur) == 2:
                x, y = cur
                cur = [b.gate("xor", x, y)]
                buckets.setdefault(w + 1, []).append(b.gate("and", x, y))
            out.append(cur[0] if cur else b.c0)
        return out

    for step in range(mach.fuel):
        opb = sel_onehot(Hpc, p_cells, p_lo)
        for a in range(A):
            op_hots[a].append(eq_value(opb, a))
        is_lt, is_gt = eq_value(opb, mach.lt), eq_value(opb, mach.gt)
        is_cl, is_cr = eq_value(opb, mach.cl), eq_value(opb, mach.cr)
        is_minus = eq_value(opb, mach.minus)
        is_plus = eq_value(opb, mach.plus)
        is_dot = eq_value(opb, mach.dot)
        is_comma = eq_value(opb, mach.comma)
        is_bl, is_br = eq_value(opb, mach.bl), eq_value(opb, mach.br)

        d0v = sel_onehot(Hd0, d_cells, mach.d_lo)
        d1v = sel_onehot(Hd1, d_cells, mach.d_lo)
        z = eq_const(d0v, mach.zero)
        nz = NOT(z)
        ex = Hm.get(0, b.c0)

        # The write, at the pre-move heads, as an XOR delta.
        w_at_d0 = AND(ex, OR(is_plus, is_minus, is_comma))
        w_at_d1 = AND(ex, is_dot)
        inc = _mod_shift(b, d0v, +1, A)
        dec = _mod_shift(b, d0v, -1, A)
        wv = [b.mux(is_plus, inc[k],
                    b.mux(is_minus, dec[k],
                          b.mux(is_dot, d0v[k], d1v[k])))
              for k in range(nb)]
        oldv = [b.mux(is_dot, d1v[k], d0v[k]) for k in range(nb)]
        delta = [b.gate("xor", wv[k], oldv[k]) for k in range(nb)]
        for pos in sorted(set(Hd0) | set(Hd1)):
            wr = OR(AND(Hd0.get(pos, b.c0), w_at_d0),
                    AND(Hd1.get(pos, b.c0), w_at_d1))
            old = d_cells[pos - mach.d_lo]
            d_cells[pos - mach.d_lo] = [
                b.gate("xor", old[k], b.gate("and", wr, delta[k]))
                for k in range(nb)]

        if step == mach.fuel - 1:
            break  # register updates after the last fetch are dead

        # mode' = mode + is_bl - is_br while scanning; from 0: '[' on zero
        # -> +1, ']' on nonzero -> -1.
        stay = AND(NOT(is_bl), NOT(is_br))
        trig_p = AND(ex, is_bl, z)
        trig_m = AND(ex, is_br, nz)
        newHm = {}
        for m in range(-(step + 1), step + 2):
            acc = []
            if m == 0:
                if -1 in Hm:
                    acc.append(AND(Hm[-1], is_bl))
                if 1 in Hm:
                    acc.append(AND(Hm[1], is_br))
                if 0 in Hm:
                    acc.append(AND(Hm[0], NOT(OR(AND(is_bl, z),
                                                 AND(is_br, nz)))))
            else:
                if m - 1 in Hm and m - 1 != 0:
                    acc.append(AND(Hm[m - 1], is_bl))
                if m + 1 in Hm and m + 1 != 0:
                    acc.append(AND(Hm[m + 1], is_br))
                if m in Hm:
                    acc.append(AND(Hm[m], stay))
                if m == 1:
                    acc.append(trig_p)
                if m == -1:
                    acc.append(trig_m)
            v = OR(*acc)
            if v != b.c0:
                newHm[m] = v

        # pc moves by exactly +-1 a step: back while scanning left (not
        # just done) or on ']' over a nonzero cell.
        in_l = OR(*[Hm[m] for m in Hm if m < 0])
        l_done = AND(Hm.get(-1, b.c0), is_bl)
        back = OR(AND(in_l, NOT(l_done)), AND(ex, is_br, nz))
        newHpc = {}
        for p in range(-(step + 1), step + 2):
            v = b.mux(back, Hpc.get(p + 1, b.c0), Hpc.get(p - 1, b.c0))
            if v != b.c0:
                newHpc[p] = v

        def move(H, mR, mL):
            st = NOT(OR(mR, mL))
            new = {}
            for p in range(min(H) - 1, max(H) + 2):
                acc = []
                if p - 1 in H:
                    acc.append(AND(H[p - 1], mR))
                if p + 1 in H:
                    acc.append(AND(H[p + 1], mL))
                if p in H:
                    acc.append(AND(H[p], st))
                v = OR(*acc)
                if v != b.c0:
                    new[p] = v
            return new

        Hd0 = move(Hd0, AND(ex, is_gt), AND(ex, is_lt))
        Hd1 = move(Hd1, AND(ex, is_cr), AND(ex, is_cl))
        Hm = newHm
        Hpc = newHpc

    outputs = [bit for cell in d_cells for bit in cell]
    for a in range(A):
        outputs.extend(popcount4(op_hots[a]))
    ops, outputs, _ = _dce_compact(b.ops, tuple(outputs),
                                   (n_p + mach.n_d) * nb)
    if config.IS_DEBUG:
        n_gates = sum(op[0] in ("and", "or", "xor", "not") for op in ops)
        print(f"[bff_bitslice] {mach.tag}: {(n_p + mach.n_d) * nb} "
              f"in-bits -> {len(outputs)} out-bits, {n_gates} gates")
    return ops, outputs, nb, 0


def bff_circuit_from_jax(circ):
    """The port's form of a BFF circuit compiled by the JAX package
    (`engine/bff_bitslice.py:compile_bff_circuit`): the same tuple with
    plain ints and strings."""
    return ens.circuit_from_jax(circ)


def bff_bitslice_eligible(mach: BffMachine, B: int, *,
                          independent_sites: bool = False,
                          mutation_rate: float = 0.0,
                          lineage: bool = False) -> bool:
    """Can the bit-sliced round take this call? B % 32 == 0, shared
    sites, no mutation, no lineage ring (the reference's rule)."""
    return (B % 32 == 0 and not independent_sites
            and float(mutation_rate) == 0.0 and not lineage)


# --- K17's plain version --------------------------------------------------------

_M55, _M33, _M0F = 0x55555555, 0x33333333, 0x0F0F0F0F


def popcount_words(words):
    """The set bits of int32 words (their uint32 patterns), summed in
    int64."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & _M55)
    v = (v & _M33) + ((v >> 2) & _M33)
    v = (v + (v >> 4)) & _M0F
    v = ((v * 0x01010101) & 0xFFFFFFFF) >> 24
    return v.sum()


def apply_bff_round_bitsliced(mach: BffMachine, circ, p_bp, d_bp, shift, *,
                              stride: int, site_axis: int = -1):
    """K17's plain version: one round of a BFF circuit on bit-plane words,
    in place on ``d_bp`` (``p_bp`` None for a self-modifying machine), at
    ``shift`` in [0, L). Returns the round's [size_a] int64 opcode
    totals, sum_k 2^k popcount(counter plane k).

    Window cell ``off`` lies in plane (shift + off) mod stride, rolled by
    floor((shift + off) / stride) along ``site_axis`` for every cell (the
    offset-0 cell too, as the reference); the program planes are read
    only. All new words are made before any is written back.
    ``stride`` is the reference's parameter; it must equal the number of
    planes of ``d_bp``."""
    apply_bff_round_bitsliced.calls += 1
    ops, outputs, nb, _ = circ
    if stride != d_bp.shape[0]:
        raise ValueError(f"stride={stride}, but d_bp holds {d_bp.shape[0]} "
                         "planes")
    shift = int(shift)
    metas = [] if mach.self_modifying else [(p_bp, mach.p_lo, mach.n_p)]
    metas.append((d_bp, mach.d_lo, mach.n_d))
    in_words: list = []
    locs_d: list = []
    for bp, lo, n in metas:
        for j in range(n):
            a = shift + lo + j
            c, e = a % stride, a // stride
            x = bp[c]
            if e:
                x = torch.roll(x, -e, dims=site_axis)
            in_words += [x[k] for k in range(nb)]
            if bp is d_bp:
                locs_d.append((c, e))
    new_bits = bs._eval_circuit(ops, outputs, in_words, in_words[0].shape)
    new = []
    for j, (c, e) in enumerate(locs_d):
        v = torch.stack(new_bits[j * nb:(j + 1) * nb])
        new.append(torch.roll(v, e, dims=site_axis) if e else v)
    for (c, _), v in zip(locs_d, new):
        d_bp[c] = v
    cnt = new_bits[mach.n_d * nb:]
    return torch.stack([
        sum(popcount_words(cnt[4 * a + k]) << k for k in range(4))
        for a in range(mach.size_a)]).to(torch.int64)


apply_bff_round_bitsliced.calls = 0


# --- K17 ---------------------------------------------------------------------------


def _check_words(mach, circ, p_bp, d_bp, shifts, k0, n, site_axis):
    nb = circ[2]
    if len(circ[1]) != mach.n_d * nb + 4 * mach.size_a:
        raise ValueError(f"{mach.tag}: not a BFF circuit of this machine")
    if (p_bp is None) != mach.self_modifying:
        raise ValueError("two-tape machines take program words; "
                         "self-modifying ones none")
    words = [w for w in (p_bp, d_bp) if w is not None]
    for w in words:
        if w.dtype != torch.int32:
            raise TypeError("bit-plane words must be int32")
        if w.shape != d_bp.shape or w.dim() < 4 or w.shape[1] != nb:
            raise ValueError(f"words must be [stride, {nb}, ...] tensors of "
                             f"one shape, got {tuple(w.shape)}")
        if not w.is_contiguous():
            raise ValueError("words must be contiguous")
    want_axis = (-1, -(d_bp.dim() - 2))
    if site_axis not in want_axis:
        raise ValueError(f"site_axis {site_axis} is not one of {want_axis}")
    if shifts.dtype != torch.int32 or shifts.dim() != 1:
        raise TypeError("shifts must be a 1-D int32 tensor")
    if not (0 <= k0 and k0 + n <= shifts.shape[0]):
        raise IndexError(f"rounds [{k0}, {k0 + n}) outside "
                         f"shifts[0:{shifts.shape[0]}]")
    dev = d_bp.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"K17 runs on cuda or cpu tensors, not {dev}")
    for name, t in (("p_bp", p_bp), ("shifts", shifts)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, words on {dev}")
    if d_bp.numel() >= 2**31:
        raise ValueError("K17 takes fewer than 2**31 words a tape")


def _bitsliced_rounds(mach, circ, p_bp, d_bp, shifts, k0, n, site_axis,
                      totals):
    """Rounds [k0, k0+n), checked by the caller, their totals into
    ``totals`` [n, size_a] int64: the plain version a round on the CPU
    (shifts taken mod L); on the card one C call that launches K17 once
    a round."""
    stride = d_bp.shape[0]
    E, W, site_minor = bs._word_dims(d_bp, site_axis)
    if d_bp.device.type == "cpu":
        L = E * stride
        for j in range(n):
            totals[j] = apply_bff_round_bitsliced(
                mach, circ, p_bp, d_bp, int(shifts[k0 + j]) % L,
                stride=d_bp.shape[0], site_axis=site_axis)
        return
    from .bff_bitslice_source import k17_library

    if circ is not compile_bff_circuit(mach) and (
            circ != compile_bff_circuit(mach)):
        raise ValueError(f"{mach.tag}: K17 runs the machine's own circuit")
    lib = k17_library(mach)
    with torch.cuda.device(d_bp.device):
        rc = lib.ckpe_bs_rounds(
            None if p_bp is None else p_bp.data_ptr(), d_bp.data_ptr(),
            None, shifts.data_ptr(), totals.data_ptr(), int(k0), int(n),
            int(E), int(W), int(site_minor), int(stride), cuda.stream(d_bp))
    cuda.check(rc, "bff_bitslice_round", lib)
    bff_bitslice_round.launches += n


def bff_bitslice_round(mach: BffMachine, circ, p_bp, d_bp, shifts, k, *,
                       site_axis: int = -1):
    """Round ``k`` of a run on bit-plane words, in place (K17): phase
    ``shifts[k]`` (an int32 tensor on the words' device, read there, in
    [0, L)). Returns the round's [size_a] int64 opcode totals. CPU
    tensors take :func:`apply_bff_round_bitsliced`."""
    _check_words(mach, circ, p_bp, d_bp, shifts, k, 1, site_axis)
    totals = torch.zeros((1, mach.size_a), dtype=torch.int64,
                         device=d_bp.device)
    _bitsliced_rounds(mach, circ, p_bp, d_bp, shifts, k, 1, site_axis,
                      totals)
    return totals[0]


bff_bitslice_round.launches = 0


def run_bff_bitsliced_rounds(mach: BffMachine, circ, p_bp, d_bp, shifts, *,
                             site_axis: int = -1):
    """Applies ``len(shifts)`` rounds to bit-plane words in place with
    explicit shifts (int32 [n] in [0, L), on the words' device). Returns
    the [n, size_a] int64 opcode totals. On the card every round is
    launched from one C call."""
    n = shifts.shape[0]
    _check_words(mach, circ, p_bp, d_bp, shifts, 0, n, site_axis)
    totals = torch.zeros((n, mach.size_a), dtype=torch.int64,
                         device=d_bp.device)
    _bitsliced_rounds(mach, circ, p_bp, d_bp, shifts, 0, n, site_axis,
                      totals)
    return totals


def run_bitsliced_tapes(mach: BffMachine, ptape, dtape, shifts, events: int):
    """The bit-sliced route over [B, L] tapes (``ptape`` None for a
    self-modifying machine) at shared ``shifts`` [n] (int32, any values,
    taken mod L): K15 packs the tapes, K17 runs every round, K15 unpacks
    the data words. The larger of (events, packed members) goes minor,
    as the reference chooses. Returns ((ptape, dtape) int32, or (tape,),
    totals [n, size_a] int64)."""
    B, L = dtape.shape
    ens._check_round_geometry(L, events, mach.span)
    stride = L // events
    circ = compile_bff_circuit(mach)
    nb = circ[2]
    transpose = events < B // 32
    if transpose:
        site_axis = -len(bs.transposed_word_shape(events, B // 32))
    else:
        site_axis = -1
    shifts = torch.remainder(shifts.to(torch.int64), L).to(
        torch.int32).contiguous()
    p_bp = (None if ptape is None
            else bs.tapes_to_bitplanes(ptape, stride, nb, transpose=transpose))
    d_bp = bs.tapes_to_bitplanes(dtape, stride, nb, transpose=transpose)
    totals = run_bff_bitsliced_rounds(mach, circ, p_bp, d_bp, shifts,
                                      site_axis=site_axis)
    d_out = bs.bitplanes_to_tapes(d_bp, transpose=transpose)
    if mach.self_modifying:
        return (d_out,), totals
    return (ptape.to(torch.int32), d_out), totals


def run_ensemble_bff_bitsliced(generator, ts, mach: BffMachine,
                               steps_events, *, device=None):
    """The reference's name for the bit-sliced BFF run (mutation-free,
    shared random sites): `bff.run_ensemble_bff` with
    ``engine="bitslice"`` (raises where the call is not eligible), which
    draws its shifts from ``generator`` and runs
    :func:`run_bitsliced_tapes`. ``ts`` is the tape tuple, (ptape, dtape)
    [B, L] for a two-tape machine or (tape,) for a self-modifying one.
    Returns (the tape tuple, (op_totals int64 [num_steps, size_a], times
    float64 [num_steps])), as the reference does."""
    from .bff import run_ensemble_bff

    ts = tuple(ts)
    out, aux = run_ensemble_bff(
        generator, ts[0] if mach.self_modifying else ts, mach, steps_events,
        engine="bitslice", device=device)
    return ((out,) if mach.self_modifying else tuple(out)), aux
