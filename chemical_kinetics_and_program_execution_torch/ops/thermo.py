"""Stochastic thermodynamics of the tape dynamics.

Counterpart of the JAX package's `ops/thermo.py`. The host part is the
reference's numpy and scipy, copied: the rule's exact outcome tables
addressed by (combined window rank, fired write spec)
(`outcome_rate_maps`, `sigma_spec_tables`), the rate functionals on
window marginals and SPDs, and the master equation's exact entropy
production rates and relative entropies.

The device part runs the ensemble with an entropy ledger:

- `run_ensemble_sigma` accumulates each member's medium entropy
  ``sigma = ln R(w -> w') - ln R(w' -> w)`` from the tables and counts
  the absolutely irreversible events (reverse rate exactly 0; sigma
  leaves them out);
- `run_ensemble_ledger` accumulates ``beta_eff * sum_c (G_c[old] -
  G_c[new])`` over a per-symbol free-enthalpy landscape, with each
  member's count of each fired spec and each spec's share of sigma.

Both rounds are K11's rolled round (`csrc/lattice_round.cuh`: the shift
over [0, L), shared by the batch or one a member, windows read where
they lie) with the sums: K23 `sigma_round` and K24 `ledger_round`
(`csrc/thermo_round.cuh`, in each machine's unit, `engine/k1_source.py`).
Each runs all the rounds of a call in one launch on a tile of members
whose rows and accumulators stay in shared memory (`k23_tile`,
`k24_tile`): the walk over many threads stages each site's entry (K23:
its table entry, 0 where irreversible, and flag; K23's tables staged
too where they are small) or increment and spec (K24), then a thread a
member sums sigma (and counts the flags) and, for K24, a thread a
(member, spec) its share and count, each in site order; calls of fewer
than `ensemble.K11_RESIDENT_MIN_ROUNDS` rounds, and rows too long to
keep, take a launch a round, a thread a member. On the CPU the plain
versions `sigma_round_plain` and `ledger_round_plain` run, which sum in
the kernels' order: a member's site increments from 0 in site order,
that sum added once to its float64 accumulator; each site's increment
added to its spec's share in site order.

Draws come from a `torch.Generator` (or an int seed) on the run's
device: the shifts of every round at once, then each round's [B, E]
float32 uniforms for a machine with choose nodes, as
`ensemble.run_ensemble` draws them, into chunks of
`ensemble._RESIDENT_CHUNK` values (a chunk a C call: 64 rounds at
B=16384, E=256). `run_ensemble_sigma_from_draws` and
`run_ensemble_ledger_from_draws` take explicit draws (the tests feed
them the JAX package's own).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import cuda, markov
from ..engine import dsl
from ..engine import ensemble as ens
from ..engine import master
from ..utils import config


# --- Outcome-rate tables over the machine's combined window -----------------


def _machine_write_specs(dm) -> tuple[np.ndarray, np.ndarray]:
    """Host decode of the machine's packed write words.

    Returns ``(mask [num_specs, n_cells] bool, val [num_specs, n_cells]
    int32)``: the write set of each spec over the combined window
    (cells in machine order: program cells then data cells).
    """
    n = dm.n_cells
    mask = np.zeros((dm.num_specs, n), bool)
    val = np.zeros((dm.num_specs, n), np.int32)
    specs = np.arange(dm.num_specs)
    for c in range(n):
        mask[:, c], val[:, c] = ens.wr_field_host(dm.wr_words[c], specs,
                                                  dm.wr_bits)
    return mask, val


def _decode_rank(w: int, n: int, a: int) -> list[int]:
    """Big-endian digits of ``w`` (cell 0 most significant)."""
    digits = [0] * n
    for j in range(n - 1, -1, -1):
        digits[j] = w % a
        w //= a
    return digits


def outcome_rate_maps(dm, *, max_windows: int = 1 << 20):
    """Aggregated jump rates over every combined machine window.

    Returns ``rates`` with ``rates[w] = {w2: R(w -> w2)}`` over combined
    window ranks (program cells then data cells, big-endian), where
    ``R`` sums the rule's outcome probabilities producing the same
    changed window, per site per unit time, identity outcomes dropped.
    Enumerated with the master equation's concrete pair driver
    (`master.enumerate_pair_outcomes`), so two-tape rules carry the
    tethered (concrete-tape) semantics the ensemble implements.
    """
    problem = dsl.get_problem(dm.tag)
    a = dm.size_a
    n = dm.n_cells
    S = a**n
    if S > max_windows:
        raise ValueError(
            f"{dm.tag!r}: combined window space {a}^{n} = {S} exceeds "
            f"max_windows={max_windows}")
    rates: list[dict[int, float]] = []
    pow_ = [a ** (n - 1 - j) for j in range(n)]
    for w in range(S):
        digits = _decode_rank(w, n, a)
        wp = {dm.p_lo + j: digits[j] for j in range(dm.n_p)}
        wd = {dm.d_lo + j: digits[dm.n_p + j] for j in range(dm.n_d)}
        outs, reach_p, reach_d = master.enumerate_pair_outcomes(
            problem, wp, wd)
        if (reach_p[0] < dm.p_lo or reach_p[1] > dm.p_lo + dm.n_p - 1
                or reach_d[0] < dm.d_lo
                or reach_d[1] > dm.d_lo + dm.n_d - 1):
            raise ValueError(
                f"{dm.tag!r}: rule reach exceeds the compiled machine "
                "window — decision machine and outcome table disagree")
        r: dict[int, float] = {}
        for prob, writes_p, writes_d in outs:
            if prob <= 0.0:
                continue
            w2 = w
            for off, v in writes_p.items():
                j = off - dm.p_lo
                w2 += (v - digits[j]) * pow_[j]
            for off, v in writes_d.items():
                j = dm.n_p + off - dm.d_lo
                w2 += (v - digits[j]) * pow_[j]
            if w2 != w:
                r[w2] = r.get(w2, 0.0) + prob
        rates.append(r)
    return rates


@dataclasses.dataclass(frozen=True)
class ThermoTables:
    """Per-(window, spec) medium-entropy payload for the device runner.

    ``sigma[w, s]`` = ln R(w -> w') - ln R(w' -> w) for the jump the
    write spec ``s`` performs on window ``w`` (0 for identity specs and
    for irreversible jumps); ``irrev[w, s]`` marks jumps whose reverse
    rate is exactly zero (sigma = +inf physically). ``rates`` keeps the
    aggregated host-side jump maps for the rate-level functions.
    """

    tag: str
    size_a: int
    n_cells: int
    sigma: np.ndarray  # [S, num_specs] float64
    irrev: np.ndarray  # [S, num_specs] bool
    rates: list

    @property
    def num_windows(self) -> int:
        return self.sigma.shape[0]


def sigma_spec_tables(dm, *, max_windows: int = 1 << 20) -> ThermoTables:
    """Builds the per-(window, write-spec) medium-entropy tables."""
    rates = outcome_rate_maps(dm, max_windows=max_windows)
    a, n = dm.size_a, dm.n_cells
    S = a**n
    mask, val = _machine_write_specs(dm)
    pow_ = np.array([a ** (n - 1 - j) for j in range(n)], np.int64)
    sigma = np.zeros((S, dm.num_specs), np.float64)
    irrev = np.zeros((S, dm.num_specs), bool)
    for w in range(S):
        digits = np.array(_decode_rank(w, n, a), np.int64)
        for s in range(dm.num_specs):
            nd = np.where(mask[s], val[s], digits)
            w2 = int((nd * pow_).sum())
            if w2 == w:
                continue
            fwd = rates[w].get(w2, 0.0)
            if fwd <= 0.0:
                # (w, s) never co-fires: the spec's leaf is inconsistent
                # with this window. Leave 0: the gather never lands here.
                continue
            rev = rates[w2].get(w, 0.0)
            if rev <= 0.0:
                irrev[w, s] = True
            else:
                sigma[w, s] = math.log(fwd) - math.log(rev)
    return ThermoTables(tag=dm.tag, size_a=a, n_cells=n, sigma=sigma,
                        irrev=irrev, rates=rates)


def thermo_tables_from_jax(t) -> ThermoTables:
    """The port's :class:`ThermoTables` from one built by the JAX
    package: its sigma, irrev and rate maps as numpy and plain floats."""
    return ThermoTables(
        tag=str(t.tag), size_a=int(t.size_a), n_cells=int(t.n_cells),
        sigma=np.array(t.sigma, np.float64), irrev=np.array(t.irrev, bool),
        rates=[{int(k): float(v) for k, v in r.items()} for r in t.rates])


# --- Rate-level functionals ---------------------------------------------------


def medium_entropy_rate_from_window_probs(pw, tables: ThermoTables):
    """Per-site medium entropy production rate at combined-window
    marginals ``pw`` ([S], summing to 1): ``sum_w pw[w] sum_w2
    R(w->w2) ln(R(w->w2)/R(w2->w))``.

    Returns ``(rate, irrev_flux)``: the finite part and the probability
    flux through absolutely irreversible jumps (whose entropy rate is
    +inf physically; zero for detailed-balance-consistent rules).
    """
    pw = np.asarray(pw, np.float64)
    rate = 0.0
    irrev_flux = 0.0
    for w, r in enumerate(tables.rates):
        if pw[w] == 0.0 or not r:
            continue
        for w2, fwd in r.items():
            rev = tables.rates[w2].get(w, 0.0)
            if rev <= 0.0:
                irrev_flux += pw[w] * fwd
            else:
                rate += pw[w] * fwd * (math.log(fwd) - math.log(rev))
    return rate, irrev_flux


def window_probs_from_spd(spd, dm, *, spd_prog=None):
    """Combined-window probabilities ``[S]`` under the closure's
    well-mixed reveal semantics: program and data windows are
    independent draws from their tape's SPD (pass ``spd_prog`` for
    dual-SPD problems). Windows beyond the stored ``cl_k`` use the SPD's
    Markov extension (`markov.seq_prob`), as the engines do."""
    spd = np.asarray(spd, np.float64)
    a = dm.size_a
    spd_p = spd if spd_prog is None else np.asarray(spd_prog, np.float64)

    def tape_probs(spd_t, m):
        if m <= 0:
            return np.ones(1)
        cl_k = round(math.log(spd_t.size) / math.log(a))
        arr = spd_t.reshape([a] * cl_k)
        out = np.empty(a**m)
        mpp = None
        for r in range(a**m):
            seq = _decode_rank(r, m, a)
            p, mpp = markov.seq_prob(arr, seq, mpp=mpp)
            out[r] = float(p)
        return out

    pp = tape_probs(spd_p, dm.n_p)
    pd = tape_probs(spd, dm.n_d)
    return (pp[:, None] * pd[None, :]).reshape(-1)


def medium_entropy_rate_spd(spd, dm, tables: ThermoTables, *,
                            spd_prog=None):
    """Closure-side per-site medium entropy production rate at an SPD
    state (see `medium_entropy_rate_from_window_probs`)."""
    pw = window_probs_from_spd(spd, dm, spd_prog=spd_prog)
    return medium_entropy_rate_from_window_probs(pw, tables)


def master_entropy_rates(Q, p):
    """Exact entropy production rates of the master equation at state
    ``p``: returns ``(total, medium)`` with

    ``medium = sum_{x != y} p_x W(x->y) ln[W(x->y)/W(y->x)]``
    ``total  = sum_{x != y} p_x W(x->y) ln[(p_x W(x->y))/(p_y W(y->x))]``

    where ``W(x->y) = Q[y, x]`` (columns are from-states). ``total`` is
    the non-negative Schnakenberg rate, exactly zero iff detailed
    balance holds at ``p``. Raises on absolutely irreversible flux
    (W forward > 0 with W reverse = 0 and p_x > 0).
    """
    import scipy.sparse as sp

    p = np.asarray(p, np.float64)
    C = sp.coo_matrix(Q)
    S = C.shape[0]
    off = (C.row != C.col) & (C.data > 0)
    rows = C.row[off].astype(np.int64)
    cols = C.col[off].astype(np.int64)
    vals = C.data[off]
    # Reverse-entry lookup: match (row, col) with (col, row).
    keys = rows * S + cols
    order = np.argsort(keys)
    rev_keys = cols * S + rows
    pos = np.searchsorted(keys[order], rev_keys)
    pos_c = np.minimum(pos, len(keys) - 1)
    found = keys[order][pos_c] == rev_keys
    w_rev = np.where(found, vals[order][pos_c], 0.0)
    px = p[cols]
    live = (px > 0) & (vals > 0)
    if np.any(live & (w_rev <= 0.0)):
        raise ValueError("absolutely irreversible flux: entropy "
                         "production rate is infinite at this state")
    flux = np.where(live, px * vals, 0.0)
    lr = np.where(live, np.log(vals / np.maximum(w_rev, 1e-300)), 0.0)
    medium = float(np.sum(flux * lr))
    py = np.maximum(p[rows], 1e-300)
    lt = np.where(live, np.log(np.maximum(px, 1e-300) / py), 0.0)
    total = float(np.sum(flux * (lr + lt)))
    return total, medium


def relative_entropy(p, q):
    """D(p || q) = sum p ln(p/q) (nats); entries with p = 0 contribute 0."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    m = p > 0
    return float(np.sum(p[m] * (np.log(p[m])
                                - np.log(np.maximum(q[m], 1e-300)))))


def relative_entropy_rate(Q, p, pi):
    """Exact d/dt D(p || pi) along dp/dt = Q p: ``sum (Qp) ln(p/pi)``
    (the +1 term of the derivative vanishes since columns of Q sum to
    0). For detailed-balanced Q with stationary pi this equals
    ``-sigma_tot(p)`` pointwise."""
    p = np.asarray(p, np.float64)
    pi = np.asarray(pi, np.float64)
    pdot = np.asarray(Q @ p)
    m = np.abs(pdot) > 0
    return float(np.sum(pdot[m] * (np.log(np.maximum(p[m], 1e-300))
                                   - np.log(np.maximum(pi[m], 1e-300)))))


# --- The device rounds: K23 and K24 and their plain versions ----------------


def device_tables(tables: ThermoTables, device=None):
    """``(sigma float64, irrev bool)`` [S, num_specs] on ``device``
    (``cuda`` unless named): the payload of :func:`run_ensemble_sigma`."""
    device = config.get_device(device)
    return (torch.as_tensor(np.asarray(tables.sigma, np.float64),
                            device=device),
            torch.as_tensor(np.asarray(tables.irrev, bool), device=device))


def _gather_index(idx, n: int):
    """The reference's gather index rule for a table of ``n`` rows: a
    negative index plus ``n``, then clamped into [0, n). Symbols outside
    [0, size_a) read the rows the JAX package reads."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _site_sum(x):
    """A member's sum of its sites' increments [B, E]: from 0, in site
    order (the kernels' order)."""
    s = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for e in range(x.shape[1]):
        s = s + x[:, e]
    return s


def sigma_round_plain(dm, ptape, dtape, shift, events, uniforms, tables,
                      sigma, n_irrev):
    """K23's plain version: one FSM round on int8 [B, L] tapes at
    ``shift`` (an int, or a [1] or [B] tensor), ``events`` sites a
    member, in place, as `ensemble.lattice_round_plain`; then each
    site's table entry at (combined window rank, fired spec), 0 where
    the jump is irreversible (the rank by the reference's gather rule,
    `_gather_index`). ``sigma`` (float64 [B]) gains the sum of
    a member's entries from 0 in site order, ``n_irrev`` (int32 [B]) its
    count of irreversible events."""
    sigma_round_plain.calls += 1
    sig_tab, irr_tab = tables
    cells, _, spec = (x.long() for x in ens.lattice_round_plain(
        dm, ptape, dtape, shift, events, uniforms))
    w = torch.zeros(spec.shape, dtype=torch.int64, device=spec.device)
    for c in range(dm.n_cells):
        w = w * dm.size_a + cells[..., c]
    w = _gather_index(w, sig_tab.shape[0])
    irr = irr_tab[w, spec]
    sig = torch.where(irr, 0.0, sig_tab[w, spec])
    sigma += _site_sum(sig)
    n_irrev += irr.sum(dim=1, dtype=torch.int32)


sigma_round_plain.calls = 0


def ledger_round_plain(dm, ptape, dtape, shift, events, uniforms, ledger,
                       sigma, counts, spec_sig):
    """K24's plain version: the round of :func:`sigma_round_plain`, then
    each site's ``beta_eff * dg`` with ``dg`` the cells' ``G[old] -
    G[new]`` added from 0 in cell order (``ledger = (g_prog [a] float64,
    g_data [a] float64, beta_eff)``). ``sigma`` (float64 [B]) gains a
    member's sum from 0 in site order; ``counts`` (int32 [B, num_specs])
    counts each fired spec; ``spec_sig`` (float64 [B, num_specs]) gains
    each site's increment at its spec, in site order."""
    ledger_round_plain.calls += 1
    g_prog, g_data, beta_eff = ledger
    cells, new, spec = (x.long() for x in ens.lattice_round_plain(
        dm, ptape, dtape, shift, events, uniforms))
    dg = torch.zeros(spec.shape, dtype=torch.float64, device=spec.device)
    a = dm.size_a
    for c in range(dm.n_cells):
        g = g_prog if c < dm.n_p else g_data
        dg = dg + (g[_gather_index(cells[..., c], a)]
                   - g[_gather_index(new[..., c], a)])
    sig = float(beta_eff) * dg
    sigma += _site_sum(sig)
    for e in range(spec.shape[1]):
        idx = spec[:, e:e + 1]
        counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
        spec_sig.scatter_add_(1, idx, sig[:, e:e + 1])


ledger_round_plain.calls = 0


def _check_rounds(dm, ptape, dtape, shifts, k0, n, events, uniforms, accs):
    """Checks int8 tapes, shifts and the uniforms of rounds [k0, k0+n)
    (`ensemble`'s checks of the rolled rounds) and that every
    accumulator (name, tensor, dtype, columns: None for [B]) has its
    dtype and shape, lies on the tapes' device and is contiguous."""
    ens._check_lattice(dm, ptape, dtape, shifts, k0, n, events, uniforms)
    B = ptape.shape[0]
    for name, t, dtype, cols in accs:
        shape = (B,) if cols is None else (B, cols)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {dtype} {list(shape)} "
                             f"tensor, got {t.dtype} {list(t.shape)}")
        if t.device != ptape.device:
            raise ValueError(f"{name} is on {t.device}, tapes on "
                             f"{ptape.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _sigma_accs(sigma, n_irrev):
    return (("sigma", sigma, torch.float64, None),
            ("n_irrev", n_irrev, torch.int32, None))


def _ledger_accs(dm, sigma, counts, spec_sig):
    return (("sigma", sigma, torch.float64, None),
            ("counts", counts, torch.int32, dm.num_specs),
            ("spec_sig", spec_sig, torch.float64, dm.num_specs))


# K23 stages its (window rank, spec) tables in shared memory where they
# take at most this many bytes (9 an entry: the entry and its flag):
# ex2's 16 x 3 take 432; ex4-chemical-turing's millions stay in global
# memory, read through L2.
K23_STAGED_TABLE_BYTES = 16384


def k23_tile(B: int, L: int, events: int, num_specs: int, n_windows: int):
    """K23's resident tile for a call at [B, L] with ``events`` sites a
    member and tables of ``n_windows`` x ``num_specs`` entries
    (`csrc/thermo_round.cuh:k23_tile_bytes`): (members a block, threads a
    block, bytes of shared memory, whether the tables are staged), or None
    where one member does not fit a block, which takes the launch a round.

    A member holds both rows (`ensemble.k11_odd_stride`), sigma and
    n_irrev (12 bytes), and the round's staged entries (float64, an odd
    count) and flags (a byte each, an odd count of words); the tables are
    staged once a block where they take at most `K23_STAGED_TABLE_BYTES`.
    The tile follows `k24_tile`'s rule: as many members as two blocks an
    SM leave room for (one block's worth where a member needs more), no
    more than spreads B over two blocks for each of the card's SMs, 512
    threads where a round has 1,024 sites or more, else 256, and cut to
    the walk's whole passes of the threads (at phase 13 (a) 8 members)."""
    n_tab = n_windows * num_specs
    stage = 9 * n_tab <= K23_STAGED_TABLE_BYTES
    fixed = 9 * n_tab if stage else 0
    per = (2 * ens.k11_odd_stride(L) + 8 * (1 + (events | 1)) + 4
           + 4 * ((-(-events // 4)) | 1))
    if per + fixed > ens.SMEM_BLOCK:
        return None
    cap = (ens.SMEM_PAIR - fixed) // per or (ens.SMEM_BLOCK - fixed) // per
    tile = max(1, min(cap, -(-B // (2 * ens._SMS))))
    threads = 512 if tile * events >= 1024 else 256
    items = events // 4 if events % 4 == 0 else events
    per_pass = threads // items
    if per_pass and tile > per_pass:
        tile -= tile % per_pass
    return tile, threads, tile * per + fixed, stage


def _sigma_rounds(dm, ptape, dtape, shifts, k0, n, events, uniforms,
                  tables, sigma, n_irrev):
    """Rounds [k0, k0+n) of a sigma run, checked by the caller: the plain
    version a round on the CPU; on the card one C call that launches K23
    once for the n rounds on members resident in shared memory
    (`k23_tile`), or once a round where a member does not fit a block or
    n is below `ensemble.K11_RESIDENT_MIN_ROUNDS` (``uniforms`` holds
    rounds [k0, k0+n))."""
    if not cuda.on_card(ptape, "sigma_round"):
        for j in range(n):
            sigma_round_plain(dm, ptape, dtape, shifts[k0 + j], events,
                              None if uniforms is None else uniforms[j],
                              tables, sigma, n_irrev)
        return
    from ..engine.k1_source import k1_library

    B, L = ptape.shape
    lib = k1_library(dm)
    tile = (k23_tile(B, L, events, dm.num_specs, tables[0].shape[0])
            if n >= ens.K11_RESIDENT_MIN_ROUNDS else None)
    with torch.cuda.device(ptape.device):
        rc = lib.ckpe_k23_rounds(
            ptape.data_ptr(), dtape.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            shifts.data_ptr(), int(shifts.dim() == 2), int(k0), int(n),
            int(B), int(L), int(events), tables[0].data_ptr(),
            tables[1].data_ptr(), int(dm.num_specs), sigma.data_ptr(),
            n_irrev.data_ptr(),
            *((tile[0], tile[1], int(tile[3])) if tile else (0, 0, 0)),
            cuda.stream(ptape))
    cuda.check(rc, "sigma_round", lib)
    sigma_round.launches += 1 if tile else n


def k24_tile(B: int, L: int, events: int, num_specs: int):
    """K24's resident tile for a call at [B, L] with ``events`` sites a
    member (`csrc/thermo_round.cuh:k24_tile_bytes`): (members a block,
    threads a block, bytes of shared memory), or None where one member
    does not fit a block, which takes the launch a round.

    A member holds both rows (`ensemble.k11_odd_stride`), sigma, its
    counts and shares a spec (12 bytes each), and the round's staged
    increments (float64, an odd count) and specs (a byte each, an odd
    count of words); the two potentials are stored once, by cell byte
    (4,096 bytes). The tile is as many members as two blocks an SM leave
    room for (one block's worth where a member needs more), and no more
    than spreads B over two blocks for each of the card's SMs; 512
    threads where a round has 1,024 sites or more, else 256. Where the
    walk's items (four sites where E % 4 == 0, else one) take more than
    one pass of the threads, the tile is cut to whole passes (at phase
    13 (a) 8 members, not 10: 106.98 µs a round against 119.79 on an
    H100 80GB HBM3 at 700 W, `time_resident.py --k24-tiles`)."""
    S = num_specs
    per = (2 * ens.k11_odd_stride(L) + 8 * (1 + S + (events | 1)) + 4 * S
           + 4 * ((-(-events // 4)) | 1))
    fixed = 4096
    if per + fixed > ens.SMEM_BLOCK:
        return None
    cap = (ens.SMEM_PAIR - fixed) // per or (ens.SMEM_BLOCK - fixed) // per
    tile = max(1, min(cap, -(-B // (2 * ens._SMS))))
    threads = 512 if tile * events >= 1024 else 256
    items = events // 4 if events % 4 == 0 else events
    per_pass = threads // items
    if per_pass and tile > per_pass:
        tile -= tile % per_pass
    return tile, threads, tile * per + fixed


def _ledger_rounds(dm, ptape, dtape, shifts, k0, n, events, uniforms,
                   ledger, sigma, counts, spec_sig):
    """Rounds [k0, k0+n) of a ledger run, checked by the caller: the
    plain version a round on the CPU; on the card one C call that
    launches K24 once for the n rounds on members resident in shared
    memory (`k24_tile`), or once a round where a member does not fit a
    block or n is below `ensemble.K11_RESIDENT_MIN_ROUNDS` (``uniforms``
    holds rounds [k0, k0+n))."""
    if not cuda.on_card(ptape, "ledger_round"):
        for j in range(n):
            ledger_round_plain(dm, ptape, dtape, shifts[k0 + j], events,
                               None if uniforms is None else uniforms[j],
                               ledger, sigma, counts, spec_sig)
        return
    from ..engine.k1_source import k1_library

    B, L = ptape.shape
    lib = k1_library(dm)
    g_prog, g_data, beta_eff = ledger
    tile = (k24_tile(B, L, events, dm.num_specs)
            if n >= ens.K11_RESIDENT_MIN_ROUNDS else None)
    with torch.cuda.device(ptape.device):
        rc = lib.ckpe_k24_rounds(
            ptape.data_ptr(), dtape.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            shifts.data_ptr(), int(shifts.dim() == 2), int(k0), int(n),
            int(B), int(L), int(events), g_prog.data_ptr(),
            g_data.data_ptr(), float(beta_eff), int(dm.num_specs),
            sigma.data_ptr(), counts.data_ptr(), spec_sig.data_ptr(),
            *(tile[:2] if tile else (0, 0)), cuda.stream(ptape))
    cuda.check(rc, "ledger_round", lib)
    ledger_round.launches += 1 if tile else n


def _check_tables(dm, tables, device):
    sig_tab, irr_tab = tables
    want = (dm.size_a**dm.n_cells, dm.num_specs)
    if (sig_tab.dtype != torch.float64 or irr_tab.dtype != torch.bool
            or tuple(sig_tab.shape) != want or tuple(irr_tab.shape) != want
            or not (sig_tab.is_contiguous() and irr_tab.is_contiguous())):
        raise ValueError(f"tables must be contiguous float64 and bool "
                         f"{list(want)} tensors (`device_tables`)")
    for name, t in (("sigma table", sig_tab), ("irrev table", irr_tab)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the run on {device}")


def _ledger_tensors(dm, ledger, device):
    g_prog, g_data, beta_eff = ledger
    out = []
    for name, g in (("g_prog", g_prog), ("g_data", g_data)):
        g = torch.as_tensor(g, dtype=torch.float64, device=device)
        if g.shape != (dm.size_a,):
            raise ValueError(f"{name} must hold {dm.size_a} float64 "
                             f"potentials, got shape {tuple(g.shape)}")
        out.append(g.contiguous())
    return out[0], out[1], float(beta_eff)


def sigma_round(dm, ptape, dtape, shift, events, uniforms, tables, sigma,
                n_irrev):
    """One K23 round on int8 [B, L] tapes, in place (the arguments of
    :func:`sigma_round_plain`; ``shift`` an int or a [1] or [B] int32
    tensor). CPU tensors take the plain version."""
    shifts = ens._shift_tensor(shift, ptape.device).to(torch.int32)
    shifts = (shifts[None] if shifts.numel() > 1 else shifts).contiguous()
    u = uniforms[None].contiguous() if dm.has_choose else None
    _check_tables(dm, tables, ptape.device)
    _check_rounds(dm, ptape, dtape, shifts, 0, 1, events, u,
                  _sigma_accs(sigma, n_irrev))
    _sigma_rounds(dm, ptape, dtape, shifts, 0, 1, events, u, tables, sigma,
                  n_irrev)


sigma_round.launches = 0


def ledger_round(dm, ptape, dtape, shift, events, uniforms, ledger, sigma,
                 counts, spec_sig):
    """One K24 round on int8 [B, L] tapes, in place (the arguments of
    :func:`ledger_round_plain`). CPU tensors take the plain version."""
    shifts = ens._shift_tensor(shift, ptape.device).to(torch.int32)
    shifts = (shifts[None] if shifts.numel() > 1 else shifts).contiguous()
    u = uniforms[None].contiguous() if dm.has_choose else None
    ledger = _ledger_tensors(dm, ledger, ptape.device)
    _check_rounds(dm, ptape, dtape, shifts, 0, 1, events, u,
                  _ledger_accs(dm, sigma, counts, spec_sig))
    _ledger_rounds(dm, ptape, dtape, shifts, 0, 1, events, u, ledger, sigma,
                   counts, spec_sig)


ledger_round.launches = 0


def sigma_rounds(dm, ptape, dtape, shifts, events, uniforms, tables, sigma,
                 n_irrev):
    """``len(shifts)`` K23 rounds on int8 [B, L] tapes in one C call, in
    place: ``shifts`` int32 [n] (shared) or [n, B] (one a member),
    ``uniforms`` float32 [n, B, E] (read only by machines with choose
    nodes), the rest as :func:`sigma_round`. On the card the resident
    form where it applies (`_sigma_rounds`); CPU tensors take the plain
    version a round."""
    shifts = shifts.to(torch.int32).contiguous()
    n = shifts.shape[0]
    u = (uniforms.contiguous() if dm.has_choose and uniforms is not None
         else None)
    _check_tables(dm, tables, ptape.device)
    _check_rounds(dm, ptape, dtape, shifts, 0, n, events, u,
                  _sigma_accs(sigma, n_irrev))
    _sigma_rounds(dm, ptape, dtape, shifts, 0, n, events, u, tables, sigma,
                  n_irrev)


def ledger_rounds(dm, ptape, dtape, shifts, events, uniforms, ledger, sigma,
                  counts, spec_sig):
    """``len(shifts)`` K24 rounds on int8 [B, L] tapes in one C call, in
    place: ``shifts`` int32 [n] (shared) or [n, B] (one a member),
    ``uniforms`` float32 [n, B, E] (read only by machines with choose
    nodes), the rest as :func:`ledger_round`. On the card the resident
    form where it applies (`_ledger_rounds`); CPU tensors take the plain
    version a round."""
    shifts = shifts.to(torch.int32).contiguous()
    n = shifts.shape[0]
    u = (uniforms.contiguous() if dm.has_choose and uniforms is not None
         else None)
    ledger = _ledger_tensors(dm, ledger, ptape.device)
    _check_rounds(dm, ptape, dtape, shifts, 0, n, events, u,
                  _ledger_accs(dm, sigma, counts, spec_sig))
    _ledger_rounds(dm, ptape, dtape, shifts, 0, n, events, u, ledger, sigma,
                   counts, spec_sig)


# --- The runs -----------------------------------------------------------------


def _start(tapes, dm, events, device):
    """int8 contiguous copies of the tapes on ``device``, checked."""
    pt, dt_ = (torch.as_tensor(t if isinstance(t, torch.Tensor)
                               else np.asarray(t), device=device)
               for t in tapes)
    if pt.dim() != 2 or pt.shape != dt_.shape:
        raise ValueError(f"tapes must be two equal [B, L] arrays, got "
                         f"{tuple(pt.shape)} and {tuple(dt_.shape)}")
    ens._check_round_geometry(pt.shape[1], events, dm.span)
    return (pt.to(torch.int8, copy=True).contiguous(),
            dt_.to(torch.int8, copy=True).contiguous())


def _times(num_steps, events, L, device):
    f64 = config.DEFAULT_FLOAT
    dt_round = float(-torch.log1p(torch.tensor(-events / L, dtype=f64)))
    return torch.arange(1, num_steps + 1, dtype=f64,
                        device=device) * dt_round


def _draws(generator, dm, B, L, num_steps, events, independent_sites,
           device, limit=ens._UNIFORM_CHUNK):
    """The run's shifts (int32 [num_steps] or [num_steps, B], over [0,
    L)) and its chunks of uniforms (`ensemble._draw_chunks`, at most
    ``limit`` values a chunk)."""
    gen = config.make_generator(generator, device)
    shape = (num_steps, B) if independent_sites else (num_steps,)
    shifts = torch.randint(0, L, shape, generator=gen, device=device,
                           dtype=torch.int32)
    return shifts, ens._draw_chunks(gen, dm, B, events, num_steps, device,
                                    limit)


def _explicit_draws(dm, shifts, uniforms, B, events, device):
    shifts = torch.as_tensor(shifts, device=device).to(torch.int32)
    shifts = shifts.contiguous()
    n = shifts.shape[0]
    if not dm.has_choose:
        return shifts, [(0, n, None)] if n else []
    u = torch.as_tensor(uniforms, device=device).contiguous()
    if u.dtype != torch.float32 or tuple(u.shape) != (n, B, events):
        raise ValueError(f"uniforms must be float32 [{n}, {B}, {events}]")
    return shifts, [(0, n, u)] if n else []


def _sigma_run(dm, pt, dt_, tables, shifts, chunks, events, device):
    _check_tables(dm, tables, pt.device)
    B, L = pt.shape
    sigma = torch.zeros(B, dtype=torch.float64, device=device)
    n_irrev = torch.zeros(B, dtype=torch.int32, device=device)
    checked = False
    for k0, n, u in chunks:
        if not checked:
            _check_rounds(dm, pt, dt_, shifts, 0, n, events, u,
                          _sigma_accs(sigma, n_irrev))
            checked = True
        _sigma_rounds(dm, pt, dt_, shifts, k0, n, events, u, tables, sigma,
                      n_irrev)
    times = _times(shifts.shape[0], events, L, device)
    return ((pt.to(torch.int32), dt_.to(torch.int32)), sigma, n_irrev,
            times)


def _ledger_run(dm, pt, dt_, ledger, shifts, chunks, events, device):
    ledger = _ledger_tensors(dm, ledger, device)
    B, L = pt.shape
    S = dm.num_specs
    sigma = torch.zeros(B, dtype=torch.float64, device=device)
    counts = torch.zeros((B, S), dtype=torch.int32, device=device)
    spec_sig = torch.zeros((B, S), dtype=torch.float64, device=device)
    checked = False
    for k0, n, u in chunks:
        if not checked:
            _check_rounds(dm, pt, dt_, shifts, 0, n, events, u,
                          _ledger_accs(dm, sigma, counts, spec_sig))
            checked = True
        _ledger_rounds(dm, pt, dt_, shifts, k0, n, events, u, ledger, sigma,
                       counts, spec_sig)
    times = _times(shifts.shape[0], events, L, device)
    return ((pt.to(torch.int32), dt_.to(torch.int32)), sigma,
            (counts, spec_sig), times)


def run_ensemble_sigma(generator, tapes, dm, tables_dev, steps_events, *,
                       independent_sites: bool = False, device=None):
    """`ensemble.run_ensemble`'s rolled rounds with each member's
    cumulative medium entropy production.

    Args:
      generator: `torch.Generator` on the run's device, or an int seed.
      tapes: (ptape [B, L], dtape [B, L]) integer tensors or arrays
        (int8 symbols; the machine and the tables read any of them as
        the reference does).
      dm: compiled :class:`ensemble.DeviceMachine`.
      tables_dev: ``(sigma [S, num_specs] float64, irrev bool)`` on the
        run's device (:func:`device_tables`).
      steps_events: (num_steps, events_per_step); the geometry rules of
        `run_ensemble`.
      independent_sites: one shift a member and round.
      device: where the run goes; ``cuda`` unless named.

    Returns ``((ptape, dtape) int32 [B, L], sigma float64 [B], n_irrev
    int32 [B], times float64 [num_steps])``: the cumulative per-member
    medium entropy, the count of absolutely irreversible events fired
    (sigma leaves them out; nonzero means the rule is not
    thermodynamically consistent), and the cumulative Poisson-calibrated
    time grid. The shift is drawn over [0, L) at any stride, as the
    reference draws it.
    """
    num_steps, events = steps_events
    device = config.get_device(device)
    pt, dt_ = _start(tapes, dm, events, device)
    shifts, chunks = _draws(generator, dm, pt.shape[0], pt.shape[1],
                            num_steps, events, independent_sites, device,
                            ens._RESIDENT_CHUNK)
    return _sigma_run(dm, pt, dt_, tables_dev, shifts, chunks, events,
                      device)


def run_ensemble_sigma_from_draws(tapes, dm, tables_dev, shifts, events,
                                  uniforms=None, *, device=None):
    """:func:`run_ensemble_sigma` with explicit draws: ``shifts`` int32
    [n] (shared) or [n, B] (one a member: independent sites), any values
    (taken mod L); ``uniforms`` float32 [n, B, E] (read only by machines
    with choose nodes). Returns as :func:`run_ensemble_sigma`."""
    device = config.get_device(device)
    pt, dt_ = _start(tapes, dm, events, device)
    shifts, chunks = _explicit_draws(dm, shifts, uniforms, pt.shape[0],
                                     events, device)
    return _sigma_run(dm, pt, dt_, tables_dev, shifts, chunks, events,
                      device)


def run_ensemble_ledger(generator, tapes, dm, ledger, steps_events, *,
                        independent_sites: bool = False, device=None):
    """`ensemble.run_ensemble`'s rolled rounds with each member's
    dissipated free enthalpy through a per-symbol G landscape.

    For rules whose rates derive from per-symbol free enthalpies with
    local detailed balance (ex4var2: ``ln(r_fwd/r_rev) = -2 beta dG``
    per outcome-resolved channel), the per-event entropy production is
    the cell-additive ``sigma = beta_eff * sum_c (G[old] - G[new])``: no
    (window, spec) table, one G gather a cell.

    Args:
      ledger: ``(g_prog [size_a], g_data [size_a], beta_eff)``: the
        per-symbol potentials of each tape and the effective inverse
        temperature (2*beta for the reference's choose-encoded rates).
      the rest: as :func:`run_ensemble_sigma`.

    Returns ``((ptape, dtape) int32 [B, L], sigma float64 [B], (counts
    int32 [B, num_specs], spec_sig float64 [B, num_specs]), times
    float64 [num_steps])``: cumulative entropy production (nats), each
    member's count of each fired write spec, and each spec's share of
    sigma (not constant a spec in general: the machine shares a spec
    between guard paths that overwrite different symbols).
    """
    num_steps, events = steps_events
    device = config.get_device(device)
    pt, dt_ = _start(tapes, dm, events, device)
    shifts, chunks = _draws(generator, dm, pt.shape[0], pt.shape[1],
                            num_steps, events, independent_sites, device,
                            ens._RESIDENT_CHUNK)
    return _ledger_run(dm, pt, dt_, ledger, shifts, chunks, events, device)


def run_ensemble_ledger_from_draws(tapes, dm, ledger, shifts, events,
                                   uniforms=None, *, device=None):
    """:func:`run_ensemble_ledger` with explicit draws (as
    :func:`run_ensemble_sigma_from_draws`)."""
    device = config.get_device(device)
    pt, dt_ = _start(tapes, dm, events, device)
    shifts, chunks = _explicit_draws(dm, shifts, uniforms, pt.shape[0],
                                     events, device)
    return _ledger_run(dm, pt, dt_, ledger, shifts, chunks, events, device)


def tape_potential(ptape, dtape, g_prog, g_data, beta_eff):
    """``beta_eff * (sum G over both tapes)`` a member, float64 [B]: the
    state function whose decrease the ledger accumulates (the
    bookkeeping identity ``sigma == Phi(0) - Phi(T)``). Plain torch on
    the tapes' device: two gathers and a sum, twice a run."""
    ptape = torch.as_tensor(ptape)
    dtape = torch.as_tensor(dtape, device=ptape.device)
    gp = torch.as_tensor(g_prog, dtype=torch.float64, device=ptape.device)
    gd = torch.as_tensor(g_data, dtype=torch.float64, device=ptape.device)
    return float(beta_eff) * (gp[ptape.long()].sum(dim=-1)
                              + gd[dtape.long()].sum(dim=-1))
