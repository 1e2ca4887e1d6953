"""Weighted-ensemble splitting for the BFF soup: rare-event emergence.

Counterpart of the JAX package's `engine/soup_we.py`. The target is the
first appearance of a self-replicator in a self-modifying soup (a long
cyclic run of 'dot', which copies code one head separation
downstream), too rare for brute force near the mutation error
threshold. Classic weighted-ensemble splitting (Huber & Kim 1996),
orchestrated on the host over blocks of `bff.run_ensemble_bff` rounds:

- K walkers (rings) carry weights summing to 1;
- after each block, walkers are binned by a progress coordinate (the
  longest cyclic 'dot' run) and each occupied bin is systematically
  resampled to its share of the K slots, its total weight kept;
- walkers that reach ``q_target`` add their weight to the first-passage
  flux, then re-enter from the initial distribution (``recycle``, the
  steady-flux mode of the Hill relation) or leave (survival mode).

``split=False`` (no resampling) is plain Monte Carlo in the same harness.
The device dynamics draw from a `torch.Generator` that runs on from
block to block, in place of the reference's ``fold_in(key, block)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from ..utils import config
from . import bff as bff_mod


def max_cyclic_run(tapes, sym: int) -> np.ndarray:
    """[B] length of the longest cyclic run of ``sym`` a ring (a full
    ring counts L)."""
    t = np.asarray(tapes)
    B, L = t.shape
    m = (t == sym)
    d = np.concatenate([m, m[:, : L - 1]], axis=1).astype(np.int32)
    acc = np.zeros(B, np.int32)
    best = np.zeros(B, np.int32)
    for j in range(d.shape[1]):
        acc = (acc + 1) * d[:, j]
        best = np.maximum(best, acc)
    return np.minimum(best, L)


class WEResult(NamedTuple):
    times: np.ndarray      # [n_blocks] cumulative soup time
    flux: np.ndarray       # [n_blocks] weight absorbed per block
    survival: np.ndarray   # [n_blocks] 1 - cumulative flux
    occupancy: np.ndarray  # [n_blocks] occupied bins per block
    q_max: np.ndarray      # [n_blocks] best coordinate seen per block


def _systematic(idx, w, n, rng):
    """Systematic resampling of ``n`` slots from walkers ``idx`` with
    weights ``w`` (the bin's total kept, equal output weights)."""
    W = w.sum()
    cum = np.cumsum(w) / W
    pos = (rng.random() + np.arange(n)) / n
    # cum[-1] can sit an ulp below 1: clip the index.
    j = np.minimum(np.searchsorted(cum, pos, side="right"), len(idx) - 1)
    return idx[j], np.full(n, W / n)


def we_emergence(generator, mach, sample_init: Callable[[int], np.ndarray],
                 *, plan: tuple, q_target: int,
                 q_fn: Callable | None = None,
                 mutation_rate: float = 0.0, recycle: bool = False,
                 split: bool = True, seed: int = 0,
                 runner: Callable | None = None,
                 device=None) -> WEResult:
    """Weighted-ensemble first passage of the soup to ``q_target``.

    Args:
      generator: `torch.Generator` on ``device`` (or an int seed) for the
        device dynamics; every block draws from it in turn.
      mach: a self-modifying :class:`bff.BffMachine`.
      sample_init: ``n -> [n, L] int32`` initial-ring sampler (for the
        initial ensemble and for recycling).
      plan: ``(K, n_blocks, rounds_per_block, events_per_round)``.
      q_target: absorbing value of the progress coordinate.
      q_fn: ``[K, L] tapes -> [K]`` progress coordinate (default:
        :func:`max_cyclic_run` of the machine's 'dot').
      mutation_rate: passed to `run_ensemble_bff`.
      recycle: absorbed walkers re-enter from ``sample_init`` keeping
        their weight; otherwise their weight leaves circulation.
      split: False turns resampling off (plain Monte Carlo).
      seed: host RNG seed of the resampler.
      runner: optional ``(generator, tapes) -> (tapes, aux)`` call that
        runs a block in place of the default `run_ensemble_bff` call.
      device: where the blocks run; ``cuda`` unless named.

    Returns a :class:`WEResult`; ``flux`` and ``survival`` are unbiased
    for P(first passage <= t) at block boundaries.
    """
    if not mach.self_modifying:
        raise ValueError("we_emergence drives self-modifying machines"
                         " (single-ring soups)")
    device = config.get_device(device)
    gen = config.make_generator(generator, device)
    K, n_blocks, rounds, events = plan
    if q_fn is None:
        q_fn = lambda t: max_cyclic_run(t, mach.dot)  # noqa: E731
    rng = np.random.default_rng(seed)
    tapes = np.asarray(sample_init(K), np.int32)
    if tapes.shape[0] != K:
        raise ValueError("sample_init(n) must return n rings")
    L = tapes.shape[1]
    w = np.full(K, 1.0 / K)
    live = np.ones(K, bool)
    dt_block = -np.log1p(-events / L) * rounds

    times = np.zeros(n_blocks)
    flux = np.zeros(n_blocks)
    occupancy = np.zeros(n_blocks, np.int64)
    q_best = np.zeros(n_blocks, np.int64)

    def absorb(q):
        """Records and recycles walkers at the target until none remain
        (walkers born at the target count too). Returns the absorbed
        weight and the coordinates brought up to date."""
        nonlocal tapes, w, live
        total = 0.0
        for _ in range(100):
            hit = live & (q >= q_target)
            if not hit.any():
                return total, q
            total += w[hit].sum()
            tapes[hit] = np.asarray(sample_init(int(hit.sum())), np.int32)
            q = q.copy()
            q[hit] = q_fn(tapes[hit])
            if not recycle:
                w[hit] = 0.0
                live[hit] = False
        raise RuntimeError(
            "sample_init keeps drawing rings at q_target; emergence "
            "from such an initial distribution is not a first-passage "
            "problem")

    if runner is None:
        def runner(g, t):
            return bff_mod.run_ensemble_bff(
                g, t, mach, (rounds, events), independent_sites=True,
                mutation_rate=mutation_rate, device=device)

    flux0, q = absorb(q_fn(tapes))
    for b in range(n_blocks):
        out, _ = runner(gen, tapes)
        tapes = np.array(out.cpu() if hasattr(out, "cpu") else out,
                         np.int32)  # a writable host copy
        q = q_fn(tapes)
        q_best[b] = int(q[live].max()) if live.any() else 0
        times[b] = (b + 1) * dt_block
        flux[b], q = absorb(q)
        if b == 0:
            flux[0] += flux0
        if split and live.any():
            # Bin by coordinate (clipped below the target), share the K
            # slots over the occupied bins (the extra ones to the leading
            # edge) and resample each bin systematically.
            qb = np.minimum(q, q_target - 1)
            vals = np.unique(qb[live])
            n_occ = len(vals)
            base = K // n_occ
            extra = K - base * n_occ
            new_tapes = np.empty_like(tapes)
            new_w = np.zeros(K)
            pos = 0
            for vi, v in enumerate(vals):
                n_v = base + (1 if vi >= n_occ - extra else 0)
                sel = np.flatnonzero(live & (qb == v))
                src, sw = _systematic(sel, w[sel], n_v, rng)
                new_tapes[pos:pos + n_v] = tapes[src]
                new_w[pos:pos + n_v] = sw
                pos += n_v
            tapes, w = new_tapes, new_w
            live = w > 0.0
            occupancy[b] = n_occ
        else:
            occupancy[b] = len(np.unique(
                np.minimum(q, q_target - 1)[live])) if live.any() else 0
        if not live.any():
            times[b + 1:] = times[b] + dt_block * np.arange(1, n_blocks - b)
            break
    return WEResult(times=times, flux=flux,
                    survival=1.0 - np.cumsum(flux) if not recycle
                    else np.full(n_blocks, np.nan),
                    occupancy=occupancy, q_max=q_best)
