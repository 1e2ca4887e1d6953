"""The mini-BFF register-machine interpreter on concrete tapes (ex6).

Counterpart of the JAX package's `engine/bff.py`. The faithful ex6 rule
splits the multiverse 12 ways a reveal, so the exact engine runs it only
pruned; on concrete tapes the same rule is deterministic, and firing one
site is ``fuel`` steps of a register machine: program counter ``pc``,
data heads ``d0`` and ``d1``, bracket-scan ``mode`` (< 0 scanning left
for the |mode|-th '[', > 0 scanning right for the mode-th ']', 0
executing). After i steps every register has moved at most i cells, so
a static window of cells covers every read and write. Self-modifying
machines (``ex6-mini-bff-self*``) fetch opcodes from the live data
window, so a write at step i changes what step i+1 decodes.

Host code: :class:`BffMachine` and :func:`compile_bff` (the window
extents and opcode indices of a registered rule). Plain PyTorch
versions: :func:`bff_fire` (with the ``prov_cells`` lineage variant),
:func:`apply_bff_round` and :func:`apply_bff_self_round` (the
reference's rolled rounds). Kernels (`csrc/bff_round.cu`, the rule
`csrc/bff_rule.cuh`; each wrapper runs its plain version for CPU
tensors only, launches its kernel for CUDA ones or raises, and counts
its launches in ``<wrapper>.launches``):

- **K16** :func:`bff_round` — one round of the interpreter on int8
  [B, L] tapes, in place, at a shared or a per-member shift, with the
  int32 lineage ring when given and the round's exact int64
  executed-opcode totals. Plain version: :func:`bff_round_plain`. It
  replaces the scan body of the reference's `_run_ensemble_bff`
  (`bff_fire` under `apply_bff_round` and `apply_bff_self_round`).
- **K18** :func:`bff_mutate` — background mutation: each cell whose
  float64 uniform lies below the rate takes its drawn symbol, and its
  lineage becomes -1. Plain version: :func:`bff_mutate_plain`. It
  replaces the mutation step of the reference's scan body.

Entry points: :func:`run_ensemble_bff` (the reference's contract, a
`torch.Generator` for its key; the bit-sliced route of
`bff_bitslice.py` where eligible) and :func:`run_bff_rounds` (explicit
shifts and mutation draws, which the tests take from the JAX package).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import cuda
from ..utils import config
from . import dsl
from . import ensemble as ens


@dataclasses.dataclass(frozen=True)
class BffMachine:
    """Interpreter metadata of one registered BFF-family rule (the
    reference's fields; hashable)."""

    tag: str
    fuel: int
    d1_start: int
    size_a: int
    # Window extents, inclusive offsets from the firing site.
    p_lo: int
    p_hi: int
    d_lo: int
    d_hi: int
    # Opcode symbol indices.
    lt: int
    gt: int
    cl: int
    cr: int
    minus: int
    plus: int
    dot: int
    comma: int
    bl: int
    br: int
    zero: int
    # One ring carries opcodes and data; p_* equal d_*.
    self_modifying: bool = False

    @property
    def n_p(self) -> int:
        return self.p_hi - self.p_lo + 1

    @property
    def n_d(self) -> int:
        return self.d_hi - self.d_lo + 1

    @property
    def span(self) -> int:
        """Conflict radius, as `DeviceMachine.span`."""
        return max(self.p_hi - self.p_lo, self.d_hi - self.d_lo) + 1

    def summary(self) -> str:
        if self.self_modifying:
            return (f"{self.tag}: fuel {self.fuel}, heads "
                    f"{self.d1_start} apart, SELF-MODIFYING, window "
                    f"[{self.d_lo}..{self.d_hi}]")
        return (f"{self.tag}: fuel {self.fuel}, heads {self.d1_start} "
                f"apart, window P[{self.p_lo}..{self.p_hi}] "
                f"D[{self.d_lo}..{self.d_hi}]")


_OPCODES = ("lt", "gt", "cl", "cr", "minus", "plus", "dot", "comma", "bl",
            "br", "zero")


def compile_bff(tag: str) -> BffMachine:
    """The interpreter metadata of a registered BFF-family rule: one that
    carries ``native_ex6 = (fuel, d1_start)`` (two tapes) or
    ``native_ex6_self`` (one self-modifying ring) on its rule."""
    problem = dsl.get_problem(tag)
    meta = getattr(problem.rule, "native_ex6", None)
    self_meta = getattr(problem.rule, "native_ex6_self", None)
    if meta is None and self_meta is None:
        raise ValueError(
            f"{tag!r} is not a mini-BFF-family rule (no native_ex6 "
            "declaration); use compile_decision_machine / "
            "compile_transition_table for general rules.")
    fuel, d1_start = meta if meta is not None else self_meta
    # Reads and writes reach at most fuel - 1 cells from each head's start.
    r = fuel - 1
    if self_meta is not None:
        lo = min(-r, d1_start - r)
        hi = max(r, d1_start + r)
        p_lo, p_hi, d_lo, d_hi = lo, hi, lo, hi
    else:
        p_lo, p_hi = -r, r
        d_lo, d_hi = min(-r, d1_start - r), max(r, d1_start + r)
    return BffMachine(
        tag=tag, fuel=fuel, d1_start=d1_start, size_a=problem.size_a,
        p_lo=p_lo, p_hi=p_hi, d_lo=d_lo, d_hi=d_hi,
        **{name: problem.symbol_index(name) for name in _OPCODES},
        self_modifying=self_meta is not None)


def bff_machine_from_jax(m) -> BffMachine:
    """The port's :class:`BffMachine` from one compiled by the JAX package
    (`engine/bff.py:compile_bff`): the same fields."""
    return BffMachine(**{f.name: getattr(m, f.name)
                         for f in dataclasses.fields(BffMachine)})


# --- The plain versions --------------------------------------------------------


def _sel(cells, idx):
    """cells[..., idx] by a one-hot mask and a sum in int32 (the
    reference's gather-free pick)."""
    n = cells.shape[-1]
    oh = torch.arange(n, device=cells.device) == idx[..., None]
    return torch.where(oh, cells, 0).sum(-1, dtype=torch.int32)


def bff_fire(mach: BffMachine, p_cells, d_cells, prov_cells=None):
    """Fires the register machine once at offset 0 of every window, as
    the reference computes it.

    ``p_cells`` [..., n_p] is the program window (None for a
    self-modifying machine, which fetches from ``d_cells``), ``d_cells``
    [..., n_d] the data window; the cell dtype is kept (int8 on the
    rounds' path), registers are int32. ``prov_cells`` [..., n_d] int32
    is the lineage window: 'dot' and 'comma' copy the source cell's id
    with its symbol, 'plus' and 'minus' keep the destination's.

    Returns (new_d_cells, op_counts [..., size_a] int32), or (new_d_cells,
    new_prov_cells, op_counts) with ``prov_cells``.
    """
    if mach.self_modifying != (p_cells is None):
        raise ValueError(
            "self-modifying machines take p_cells=None (opcodes fetch "
            "from d_cells); two-tape machines require a program window")
    d_cells = torch.as_tensor(d_cells)
    dev = d_cells.device
    cdt = d_cells.dtype
    if p_cells is not None:
        p_cells = torch.as_tensor(p_cells, device=dev).to(cdt)
    if prov_cells is not None:
        prov_cells = torch.as_tensor(prov_cells, device=dev)
    shape = d_cells.shape[:-1]
    i32 = torch.int32
    A = mach.size_a
    pc = torch.zeros(shape, dtype=i32, device=dev)
    d0 = torch.zeros(shape, dtype=i32, device=dev)
    d1 = torch.full(shape, mach.d1_start, dtype=i32, device=dev)
    mode = torch.zeros(shape, dtype=i32, device=dev)
    op_counts = torch.zeros(shape + (A,), dtype=i32, device=dev)
    sym = torch.arange(A, dtype=i32, device=dev)
    cell_idx = torch.arange(mach.n_d, dtype=i32, device=dev)

    for _ in range(mach.fuel):
        op = (_sel(d_cells, pc - mach.d_lo) if mach.self_modifying
              else _sel(p_cells, pc - mach.p_lo))
        op_counts = op_counts + (sym == op[..., None]).to(i32)
        in_l = mode < 0
        in_r = mode > 0
        ex = mode == 0
        is_bl = op == mach.bl
        is_br = op == mach.br

        l_done = is_bl & (mode == -1)
        mode_l = torch.where(l_done, 0, mode + is_bl.to(i32) - is_br.to(i32))
        pc_l = pc + torch.where(l_done, 1, -1)

        r_done = is_br & (mode == 1)
        mode_r = torch.where(r_done, 0, mode - is_br.to(i32) + is_bl.to(i32))
        pc_r = pc + 1

        d0v = _sel(d_cells, d0 - mach.d_lo)
        d1v = _sel(d_cells, d1 - mach.d_lo)
        z = d0v == mach.zero
        is_plus = op == mach.plus
        is_minus = op == mach.minus
        is_dot = op == mach.dot
        is_comma = op == mach.comma
        mode_e = torch.where(is_bl & z, 1, torch.where(is_br & ~z, -1, 0))
        pc_e = pc + torch.where(is_br & ~z, -1, 1)
        d0_e = d0 + (op == mach.gt).to(i32) - (op == mach.lt).to(i32)
        d1_e = d1 + (op == mach.cr).to(i32) - (op == mach.cl).to(i32)

        # The one write (execute mode): plus, minus, comma at d0, dot at d1.
        w_en = ex & (is_plus | is_minus | is_dot | is_comma)
        w_idx = torch.where(is_dot, d1, d0)
        w_val = torch.where(
            is_plus, torch.remainder(d0v + 1, A),
            torch.where(is_minus, torch.remainder(d0v - 1, A),
                        torch.where(is_dot, d0v, d1v)))
        oh = (cell_idx == (w_idx - mach.d_lo)[..., None]) & w_en[..., None]
        if prov_cells is not None:
            pv = torch.where(is_dot, _sel(prov_cells, d0 - mach.d_lo),
                             _sel(prov_cells, d1 - mach.d_lo))
            ohp = oh & (is_dot | is_comma)[..., None]
            prov_cells = torch.where(ohp, pv[..., None].to(prov_cells.dtype),
                                     prov_cells)
        d_cells = torch.where(oh, w_val.to(cdt)[..., None], d_cells)

        pc = torch.where(in_l, pc_l, torch.where(in_r, pc_r, pc_e))
        mode = torch.where(in_l, mode_l, torch.where(in_r, mode_r, mode_e))
        d0 = torch.where(ex, d0_e, d0)
        d1 = torch.where(ex, d1_e, d1)

    if prov_cells is not None:
        return d_cells, prov_cells, op_counts
    return d_cells, op_counts


def _roll(x, shift: int):
    return ens._roll_cols_plain(x, int(shift))


def apply_bff_round(mach: BffMachine, ptape, dtape, shift, *, events: int,
                    want_op_counts: bool = False):
    """One stratified round of a two-tape machine as the reference writes
    it: roll both tapes by shift + lo, fire the first cells of each of
    the ``events`` blocks, write the data cells back, roll back. Returns
    (ptape, new dtape), plus the round's [size_a] int64 totals with
    ``want_op_counts``."""
    B, L = ptape.shape
    stride = L // events
    shift = int(shift)
    rp = _roll(ptape, shift + mach.p_lo).reshape(B, events, stride)
    rd = _roll(dtape, shift + mach.d_lo).reshape(B, events, stride).clone()
    new_d, ops = bff_fire(mach, rp[:, :, :mach.n_p], rd[:, :, :mach.n_d])
    rd[:, :, :mach.n_d] = new_d
    dtape = _roll(rd.reshape(B, L), -(shift + mach.d_lo))
    if want_op_counts:
        return ptape, dtape, ops.sum(dim=(0, 1), dtype=torch.int64)
    return ptape, dtape


def apply_bff_self_round(mach: BffMachine, tape, shift, *, events: int,
                         want_op_counts: bool = False, prov=None):
    """Single-ring twin of :func:`apply_bff_round` for self-modifying
    machines, with the optional int32 lineage ring ``prov`` [B, L].
    Returns the new tape (with ``prov``: (tape, prov)), plus the totals
    with ``want_op_counts``."""
    B, L = tape.shape
    stride = L // events
    shift = int(shift)
    rd = _roll(tape, shift + mach.d_lo).reshape(B, events, stride).clone()
    if prov is not None:
        rp = _roll(prov, shift + mach.d_lo).reshape(B, events,
                                                    stride).clone()
        new_d, new_p, ops = bff_fire(mach, None, rd[:, :, :mach.n_d],
                                     rp[:, :, :mach.n_d])
        rp[:, :, :mach.n_d] = new_p
        prov = _roll(rp.reshape(B, L), -(shift + mach.d_lo))
    else:
        new_d, ops = bff_fire(mach, None, rd[:, :, :mach.n_d])
    rd[:, :, :mach.n_d] = new_d
    tape = _roll(rd.reshape(B, L), -(shift + mach.d_lo))
    out = (tape,) if prov is None else (tape, prov)
    if want_op_counts:
        return (*out, ops.sum(dim=(0, 1), dtype=torch.int64))
    return out[0] if prov is None else out


def bff_round_plain(mach: BffMachine, ptape, dtape, prov, shift, events: int):
    """K16's plain version: one round on int8 [B, L] tapes, in place
    (``ptape`` None for a self-modifying machine, ``prov`` the int32
    lineage ring or None), at ``shift``: an int or a [1] tensor shared by
    the batch, or a [B] tensor, one a member. Returns the round's
    [size_a] int64 executed-opcode totals.

    A shared shift is the reference's rolled round; per-member shifts
    roll each member to its shift, fire at shift 0 and roll back, as the
    reference's independent-sites loop does across one round."""
    bff_round_plain.calls += 1
    shift = ens._shift_tensor(shift, dtape.device).to(torch.int64)
    per_member = shift.numel() > 1
    if per_member:
        ts = [t for t in (ptape, dtape, prov) if t is not None]
        rolled = [ens._roll_rows_plain(t, shift) for t in ts]
        s = 0
    else:
        rolled = [t for t in (ptape, dtape, prov) if t is not None]
        s = int(shift[0])
    if mach.self_modifying:
        out = apply_bff_self_round(
            mach, rolled[0], s, events=events, want_op_counts=True,
            prov=rolled[1] if prov is not None else None)
        new = list(out[:-1])
        dest = [dtape] + ([prov] if prov is not None else [])
    else:
        _, new_d, tot = apply_bff_round(mach, rolled[0], rolled[1], s,
                                        events=events, want_op_counts=True)
        out = (new_d, tot)
        new = [new_d]
        dest = [dtape]
    for d, x in zip(dest, new):
        d.copy_(ens._roll_rows_plain(x, -shift) if per_member else x)
    return out[-1]


bff_round_plain.calls = 0


def bff_mutate_plain(tape, prov, u, vals, rate: float):
    """K18's plain version, in place: where ``u`` (float64 [B, L]) lies
    below ``rate`` the cell of ``tape`` takes ``vals`` (int32 [B, L]) and
    the lineage ``prov`` (int32 or None) becomes -1."""
    bff_mutate_plain.calls += 1
    hit = u < rate
    tape.copy_(torch.where(hit, vals.to(tape.dtype), tape))
    if prov is not None:
        prov.copy_(torch.where(hit, -1, prov))


bff_mutate_plain.calls = 0


# --- K16 and K18 -----------------------------------------------------------------

# Operation kinds of `csrc/bff_rule.cuh` (BFF_LT ... BFF_BR; 0 is "other").
_KINDS = ("lt", "gt", "cl", "cr", "minus", "plus", "dot", "comma", "bl", "br")
_MAX_A = 16  # csrc/bff_rule.cuh: BFF_MAX_A (4-bit counters in a uint64)
_MAX_CELLS = 64  # BFF_MAX_CELLS (a uint64 mask of written cells)


def rule_params(mach: BffMachine) -> np.ndarray:
    """The machine as `csrc/bff_rule.cuh` reads it (BFF_N_PARAMS int32):
    fuel, d1_start, size_a, p_lo, n_p, d_lo, n_d, self_modifying, zero,
    then each symbol's operation kind."""
    if mach.size_a > _MAX_A or mach.fuel > 15:
        raise ValueError(f"{mach.tag}: K16 counts opcodes in 4 bits for at "
                         f"most {_MAX_A} symbols and fuel 15")
    if max(mach.n_p, mach.n_d) > _MAX_CELLS:
        raise ValueError(f"{mach.tag}: K16 takes windows of at most "
                         f"{_MAX_CELLS} cells")
    kind = [0] * _MAX_A
    for k, name in enumerate(_KINDS, start=1):
        kind[getattr(mach, name)] = k
    return np.array([mach.fuel, mach.d1_start, mach.size_a, mach.p_lo,
                     mach.n_p, mach.d_lo, mach.n_d, int(mach.self_modifying),
                     mach.zero] + kind, dtype=np.int32)


def _params_arg(mach: BffMachine):
    p = rule_params(mach)
    return (ctypes.c_int * len(p))(*p.tolist())


def _check_scan(mach, ptape, dtape, prov, shifts, k0, n, events, draws):
    """Checks K16's tapes, the shifts ([rounds] shared or [rounds, B] a
    member) and the mutation draws of rounds [k0, k0+n) (``draws`` (u
    [n, B, L] float64, vals [n, B, L] int32) or None)."""
    if (ptape is None) != mach.self_modifying:
        raise ValueError("two-tape machines take a program tape; "
                         "self-modifying ones none")
    tapes = [t for t in (ptape, dtape) if t is not None]
    for t in tapes:
        if t.dtype != torch.int8:
            raise TypeError(f"K16 takes int8 tapes, got {t.dtype}")
        if t.dim() != 2 or t.shape != dtape.shape or not t.is_contiguous():
            raise ValueError("tapes must be equal contiguous [B, L] tensors")
    if prov is not None:
        if not mach.self_modifying:
            raise ValueError("a lineage ring is defined for self-modifying "
                             "machines only")
        if (prov.dtype != torch.int32 or prov.shape != dtape.shape
                or not prov.is_contiguous()):
            raise ValueError("prov must be a contiguous int32 [B, L] tensor")
    B, L = dtape.shape
    ens._check_round_geometry(L, events, mach.span)
    if shifts.dtype != torch.int32 or shifts.dim() not in (1, 2) or (
            shifts.dim() == 2 and shifts.shape[1] != B):
        raise TypeError("shifts must be int32 [rounds] (shared) or "
                        f"[rounds, {B}] (one a member)")
    if not shifts.is_contiguous():
        raise ValueError("shifts must be contiguous")
    if not (0 <= k0 and k0 + n <= shifts.shape[0]):
        raise IndexError(f"rounds [{k0}, {k0 + n}) outside "
                         f"shifts[0:{shifts.shape[0]}]")
    dev = dtape.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"K16 runs on cuda or cpu tensors, not {dev}")
    named = [("shifts", shifts)] + [(n_, t) for n_, t in (
        ("ptape", ptape), ("prov", prov)) if t is not None]
    if draws is not None:
        u, vals = draws
        if (u.dtype != torch.float64 or vals.dtype != torch.int32
                or tuple(u.shape) != (n, B, L) or vals.shape != u.shape
                or not (u.is_contiguous() and vals.is_contiguous())):
            raise ValueError(f"mutation draws must be contiguous float64 and "
                             f"int32 [{n}, {B}, {L}] tensors")
        if not mach.self_modifying:
            raise ValueError("mutation is defined for self-modifying "
                             "machines only")
        named += [("u", u), ("vals", vals)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, tapes on {dev}")
    if dtape.numel() >= 2**31:
        raise ValueError("K16 takes tapes of fewer than 2**31 symbols")
    rule_params(mach)


def _scan_rounds(mach, ptape, dtape, prov, shifts, k0, n, events, draws,
                 rate, totals):
    """Rounds [k0, k0+n), checked by the caller: each round's opcode
    totals into ``totals`` [n, size_a] int64, then, with ``draws``, the
    round's mutation. The plain versions a round on the CPU; on the card
    one C call that launches K16 and, with draws, K18 once a round."""
    if dtape.device.type == "cpu":
        for j in range(n):
            totals[j] = bff_round_plain(mach, ptape, dtape, prov,
                                        shifts[k0 + j], events)
            if draws is not None:
                bff_mutate_plain(dtape, prov, draws[0][j], draws[1][j], rate)
        return
    lib = cuda.load()
    B, L = dtape.shape
    per_member = shifts.dim() == 2

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dtape.device):
        rc = lib.ckpe_bff_rounds(
            _params_arg(mach), ptr(ptape), dtape.data_ptr(), ptr(prov),
            shifts.data_ptr(), int(per_member), int(k0), int(n), int(B),
            int(L), int(events), totals.data_ptr(),
            None if draws is None else draws[0].data_ptr(),
            None if draws is None else draws[1].data_ptr(), float(rate),
            cuda.stream(dtape))
    cuda.check(rc, "bff_round", lib)
    bff_round.launches += n
    if draws is not None:
        bff_mutate.launches += n


def bff_round(mach: BffMachine, ptape, dtape, shift, events: int, *,
              prov=None):
    """One interpreter round on int8 [B, L] tapes, in place (K16):
    ``ptape`` None for a self-modifying machine, ``prov`` its int32
    lineage ring or None, ``shift`` an int or a [1] or [B] int32 tensor
    on the tapes' device. Returns the round's [size_a] int64 opcode
    totals. CPU tensors take :func:`bff_round_plain`."""
    shifts = ens._shift_tensor(shift, dtape.device).to(torch.int32)
    shifts = (shifts[None] if shifts.numel() > 1 else shifts).contiguous()
    _check_scan(mach, ptape, dtape, prov, shifts, 0, 1, events, None)
    totals = torch.zeros((1, mach.size_a), dtype=torch.int64,
                         device=dtape.device)
    _scan_rounds(mach, ptape, dtape, prov, shifts, 0, 1, events, None, 0.0,
                 totals)
    return totals[0]


bff_round.launches = 0


def bff_mutate(tape, prov, u, vals, rate: float):
    """Background mutation, in place (K18): where ``u`` (float64 [B, L])
    < ``rate`` the cell of ``tape`` (int8 [B, L]) takes ``vals`` (int32)
    and ``prov`` (int32 or None) becomes -1. CPU tensors take
    :func:`bff_mutate_plain`."""
    for name, t, dt in (("tape", tape, torch.int8), ("u", u, torch.float64),
                        ("vals", vals, torch.int32),
                        ("prov", prov, torch.int32)):
        if t is None:
            continue
        if t.dtype != dt or t.shape != tape.shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor of "
                             f"the tape's shape {tuple(tape.shape)}")
        if t.device != tape.device:
            raise ValueError(f"{name} is on {t.device}, the tape on "
                             f"{tape.device}")
    if not cuda.on_card(tape, "K18"):
        bff_mutate_plain(tape, prov, u, vals, rate)
        return
    lib = cuda.load()
    with torch.cuda.device(tape.device):
        rc = lib.ckpe_bff_mutate(
            tape.data_ptr(), None if prov is None else prov.data_ptr(),
            u.data_ptr(), vals.data_ptr(), float(rate),
            int(tape.numel()), cuda.stream(tape))
    cuda.check(rc, "bff_mutate", lib)
    bff_mutate.launches += 1


bff_mutate.launches = 0


# --- Entry points ------------------------------------------------------------------


def _ring_tapes(mach, tapes, prov, device):
    """(ptape or None, dtape, prov or None) on ``device`` as fresh int8
    (int32 for prov) copies; checks the mode's contract."""
    if mach.self_modifying:
        pt, dt_ = None, tapes
    else:
        if not isinstance(tapes, (tuple, list)) or len(tapes) != 2:
            raise ValueError("two-tape machines take (ptape, dtape)")
        pt, dt_ = tapes

    def fresh(t, dtype):
        src = torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t,
                              device=device)
        out = src.to(dtype).contiguous()
        return out.clone() if out.data_ptr() == src.data_ptr() else out

    if mach.size_a > 127:
        raise ValueError(f"BFF int8 tapes require size_a <= 127 (got "
                         f"{mach.size_a}); symbols would wrap silently")
    return (None if pt is None else fresh(pt, torch.int8),
            fresh(dt_, torch.int8),
            None if prov is None else fresh(prov, torch.int32))


def _check_modes(mach, mutation_rate, prov):
    if (float(mutation_rate) or prov is not None) and not mach.self_modifying:
        raise ValueError(
            "mutation_rate / prov are only defined for self-modifying "
            "machines (the two-tape rule's program ring is read-only "
            "by construction; mutating it would break the "
            "conditioned-on-program oracle semantics)")


def _outputs(mach, pt, dt_, prov):
    if mach.self_modifying:
        tape = dt_.to(torch.int32)
        return tape if prov is None else (tape, prov)
    return (pt.to(torch.int32), dt_.to(torch.int32))


def _pick_engine(mach, engine, B, device, *, independent_sites,
                 mutation_rate, lineage):
    """True for the bit-sliced route, by the reference's rule: `auto`
    takes it where eligible, on the CPU only for circuits of at most
    `bff_bitslice.CPU_MAX_CIRCUIT_OPS` ops; `bitslice` raises where the
    call is not eligible."""
    if engine not in ("auto", "scan", "bitslice"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected 'auto', 'scan' or 'bitslice'")
    if engine == "scan":
        return False
    from . import bff_bitslice as bbs  # bff_bitslice imports this module

    eligible = bbs.bff_bitslice_eligible(
        mach, B, independent_sites=independent_sites,
        mutation_rate=mutation_rate, lineage=lineage)
    if engine == "bitslice" and not eligible:
        raise ValueError(
            "engine='bitslice' needs B % 32 == 0, common random "
            "sites, mutation_rate=0 and no lineage ring "
            f"(got B={B}, independent_sites={independent_sites}, "
            f"mutation_rate={float(mutation_rate)}, lineage={lineage})")
    if eligible and engine == "auto":
        eligible = (torch.device(device).type != "cpu"
                    or len(bbs.compile_bff_circuit(mach)[0])
                    <= bbs.CPU_MAX_CIRCUIT_OPS)
    return eligible


def _times(num_steps, events, L, device):
    f64 = config.DEFAULT_FLOAT
    dt_round = float(-torch.log1p(torch.tensor(-events / L, dtype=f64)))
    return torch.arange(1, num_steps + 1, dtype=f64, device=device) * dt_round


def run_bff_rounds(mach: BffMachine, tapes, shifts, events: int, *,
                   mutation_draws=None, mutation_rate: float = 0.0,
                   prov=None, engine: str = "scan", device=None):
    """Runs ``len(shifts)`` rounds with explicit draws: ``shifts`` int32
    [n] (one a round, shared by the batch) or [n, B] (one a member), any
    values (taken mod L); ``mutation_draws`` (u float64 [n, B, L], vals
    int32 [n, B, L]) with ``mutation_rate`` for a self-modifying machine,
    in the tapes' own frame (the reference draws them in the frame its
    independent-sites loop keeps each member rolled to: roll them back by
    each member's shift to feed them here). ``tapes`` as in
    :func:`run_ensemble_bff`; ``engine`` "scan" (K16, K18) or "bitslice"
    (K17 on K15's words; shared shifts, no mutation, no lineage).

    This is `run_ensemble_bff`'s round loop without the random draws, so
    a caller can feed it draws made elsewhere (the tests feed it the JAX
    package's own). On the card every round goes out from one C call.
    Returns (tapes as `run_ensemble_bff` returns them, op_totals [n,
    size_a] int64)."""
    device = config.get_device(device)
    _check_modes(mach, mutation_rate, prov)
    shifts = torch.as_tensor(shifts, device=device).to(torch.int32)
    pt, dt_, pv = _ring_tapes(mach, tapes, prov, device)
    n = shifts.shape[0]
    if engine not in ("scan", "bitslice"):
        raise ValueError(f"unknown engine {engine!r}; expected 'scan' or "
                         "'bitslice'")
    if engine == "bitslice":
        _pick_engine(mach, engine, dt_.shape[0], device,
                     independent_sites=shifts.dim() == 2,
                     mutation_rate=mutation_rate, lineage=prov is not None)
        from . import bff_bitslice as bbs

        outs, totals = bbs.run_bitsliced_tapes(mach, pt, dt_, shifts,
                                               events)
        return (outs[0] if mach.self_modifying else outs), totals
    draws = None
    if mutation_draws is not None:
        draws = tuple(torch.as_tensor(x, device=device).contiguous()
                      for x in mutation_draws)
    totals = torch.zeros((n, mach.size_a), dtype=torch.int64, device=device)
    _check_scan(mach, pt, dt_, pv, shifts, 0, n, events, draws)
    _scan_rounds(mach, pt, dt_, pv, shifts, 0, n, events, draws,
                 float(mutation_rate), totals)
    return _outputs(mach, pt, dt_, pv), totals


def run_ensemble_bff(generator, tapes, mach: BffMachine, steps_events, *,
                     independent_sites: bool = False,
                     mutation_rate: float = 0.0, prov=None,
                     engine: str = "auto", device=None):
    """Advances a batch of tapes under the BFF interpreter: the
    reference's `run_ensemble_bff` contract (stratified lattice rounds,
    dt = -log1p(-E/L) a round, shared random sites or, with
    ``independent_sites``, one shift a member).

    Draws come from ``generator`` (a `torch.Generator` on the run's
    device, or an int seed): first all shifts at once ([num_steps], or
    [num_steps, B] for independent sites) over [0, L) as int32; then,
    with ``mutation_rate`` > 0, each round's float64 uniforms [B, L] and
    int32 symbols [B, L], round by round into a buffer of a chunk of
    rounds that one call then runs. The stream is not the JAX package's;
    :func:`run_bff_rounds` takes explicit draws.

    Args:
      generator: `torch.Generator` on the run's device, or an int seed.
      tapes: (ptape, dtape) [B, L] integer tensors or arrays, or one
        [B, L] tape for a self-modifying machine.
      mach: a compiled :class:`BffMachine`.
      steps_events: (num_steps, events_per_step); events_per_step must
        divide L, and at E > 1 L/E > 2·span.
      independent_sites: one shift a member and round.
      mutation_rate: self-modifying machines only: after each round
        every cell is resampled uniformly with this probability.
      prov: self-modifying machines only: an int32 [B, L] lineage ring
        (copies carry ids, mutation stamps -1); the tape comes back as
        (tape, prov).
      engine: "auto" (the bit-sliced round of `bff_bitslice.py`, K17 on
        K15's words, where eligible: B % 32 == 0, shared sites, no
        mutation, no lineage, and on the CPU a circuit of at most
        `bff_bitslice.CPU_MAX_CIRCUIT_OPS` ops; else K16), "scan" (K16
        and K18) or "bitslice" (raises where not eligible). Both routes
        give the same tapes and totals at the same shifts.
      device: where the run goes; ``cuda`` unless named.

    Returns:
      (tapes: (ptape, dtape) int32, or the tape, or (tape, prov)),
      (op_totals int64 [num_steps, size_a] executed opcodes a round,
       times float64 [num_steps] cumulative).
    """
    if not isinstance(mach, BffMachine):
        raise TypeError(f"run_ensemble_bff takes a BffMachine, not "
                        f"{type(mach).__name__}")
    num_steps, events = steps_events
    device = config.get_device(device)
    mu = float(mutation_rate)
    _check_modes(mach, mu, prov)
    pt, dt_, pv = _ring_tapes(mach, tapes, prov, device)
    B, L = dt_.shape
    ens._check_round_geometry(L, events, mach.span)
    bitsliced = _pick_engine(mach, engine, B, device,
                             independent_sites=independent_sites,
                             mutation_rate=mu, lineage=prov is not None)
    gen = config.make_generator(generator, device)
    shape = (num_steps, B) if independent_sites else (num_steps,)
    shifts = torch.randint(0, L, shape, generator=gen, device=device,
                           dtype=torch.int32)
    times = _times(num_steps, events, L, device)
    if bitsliced:
        from . import bff_bitslice as bbs

        outs, totals = bbs.run_bitsliced_tapes(mach, pt, dt_, shifts,
                                               events)
        return (outs[0] if mach.self_modifying else outs), (totals, times)
    totals = torch.zeros((num_steps, mach.size_a), dtype=torch.int64,
                         device=device)
    if not mu:
        if num_steps:
            _check_scan(mach, pt, dt_, pv, shifts, 0, num_steps, events, None)
            _scan_rounds(mach, pt, dt_, pv, shifts, 0, num_steps, events,
                         None, 0.0, totals)
        return _outputs(mach, pt, dt_, pv), (totals, times)
    # Mutation draws made ahead of the launches, a chunk of rounds at a time.
    chunk = max(1, min(num_steps, ens._UNIFORM_CHUNK // (B * L)))
    u = torch.empty((chunk, B, L), dtype=torch.float64, device=device)
    vals = torch.empty((chunk, B, L), dtype=torch.int32, device=device)
    for k0 in range(0, num_steps, chunk):
        n = min(chunk, num_steps - k0)
        for j in range(n):
            torch.rand((B, L), generator=gen, device=device,
                       dtype=torch.float64, out=u[j])
            torch.randint(0, mach.size_a, (B, L), generator=gen,
                          device=device, dtype=torch.int32, out=vals[j])
        draws = (u[:n], vals[:n])
        _check_scan(mach, pt, dt_, pv, shifts, k0, n, events, draws)
        _scan_rounds(mach, pt, dt_, pv, shifts, k0, n, events, draws, mu,
                     totals[k0:k0 + n])
    return _outputs(mach, pt, dt_, pv), (totals, times)
