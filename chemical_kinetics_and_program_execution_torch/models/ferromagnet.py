"""Ferromagnetic spin-chain companion models: the analytic island ODE,
the Metropolis chain and the exact equilibrium.

Counterpart of the JAX package's `models/ferromagnet.py`:

- `island_rate_matrix`, `energy`, `island_length_stats` and
  `ising_gibbs_windows` are numpy, as there (copies);
- `analytic_p_history` solves the island-population ODE ``m @ y +
  source`` with the port's `ode/dopri5.py` (K6's second table on the
  card);
- the Metropolis chain runs every chain of a batch on kernel K28
  (`metropolis`, `csrc/metropolis.cu`, rule `csrc/metropolis_rule.cuh`:
  a block a chain held as bits, the rounds on one warp, the islands
  counted a word at a time while the next step runs;
  `metropolis_plain` on the CPU): random-site flips on a ring of 0/1
  sites, each step's trials in conflict-masked rounds (a trial is tested
  against the round-start chain and dropped when an earlier trial of the
  round lies within distance 1), then the up-island counts of exact
  length 1..5. `simulate_metropolis_batch` takes chains ``[T, N]``
  natively; `simulate_metropolis` is one chain; the draws (a site and a
  float64 uniform a trial) come from the caller's generator in chunks of
  steps, and `simulate_metropolis_from_draws` takes them explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda
from ..ode import dopri5
from ..utils.config import get_device, make_generator

# Draws a chunk of steps: at most this many trials (a site and a uniform
# each) at a time.
DRAW_CHUNK = 1 << 25
COUNT_COLUMNS = 6  # 0 (unused) and island lengths 1..5


# --- Analytic island-population approximation -------------------------------

def island_rate_matrix(param_a, param_b, num_lengths):
    """Melt/grow rate matrix over island lengths 1..num_lengths."""
    m = np.zeros([num_lengths, num_lengths])
    m[0, 0] = -1.0  # a length-1 island can melt away entirely
    for k in range(1, num_lengths):
        m[k - 1, k] += 2 * param_a  # k -> k-1 melting
        m[k, k] -= 2 * param_a
        m[k, k - 1] += 2 * param_a * param_b  # growth
        m[k, k] -= 2 * param_a * param_b
    return m


def analytic_p_history(*, beta=1.0, J=1.0, h=-0.25, num_lengths=20,
                       t_max=40.0, t_steps=1001, p0_pair=1 / 250,
                       rtol=1e-10, atol=1e-10, device=None):
    """Island-length populations p(L, t) [t_steps, num_lengths] under
    melt/grow dynamics with spontaneous pair formation, clipped at 0 (a
    numpy array); dopri5 on ``device``."""
    dev = get_device(device)
    m = torch.as_tensor(
        island_rate_matrix(np.exp(-beta * 4 * J), np.exp(beta * 2 * h),
                           num_lengths), device=dev)
    source = torch.zeros(num_lengths, dtype=torch.float64, device=dev)
    source[0] = float(np.exp(-8 * beta * J + 2 * beta * h))
    y0 = torch.zeros(num_lengths, dtype=torch.float64, device=dev)
    y0[1] = p0_pair
    ts = np.linspace(0.0, t_max, t_steps)
    ys, _ = dopri5.odeint_dopri5(lambda y, t: m @ y + source, y0, ts,
                                 (rtol, atol))
    return np.clip(ys.cpu().numpy(), 0, np.inf)


# --- Metropolis Monte-Carlo chain ------------------------------------------

def acceptance_table(J, h, beta) -> np.ndarray:
    """The six flip thresholds [2 * same + mid] (same: how many of the
    two neighbours equal the site, mid: its value), float64, formed as
    the JAX package's `_flip_acceptance` forms them: exp(-beta J (e +
    4)) with e = 2 (same - (2 - same)), times exp(-2 beta h mid) when h
    > 0, else exp(2 beta h (1 - mid))."""
    beta_j = float(beta) * float(J)
    beta_h = float(beta) * float(h)
    thr = np.empty(6)
    for same in range(3):
        e = 2 * (same - (2 - same))
        rate_j = np.exp(-beta_j * float(e + 4))
        for mid in range(2):
            rate_h = (np.exp(-2 * beta_h * float(mid)) if h > 0
                      else np.exp(2 * beta_h * float(1 - mid)))
            thr[2 * same + mid] = rate_j * rate_h
    return thr


def island_counts_plain(chain: torch.Tensor) -> torch.Tensor:
    """Up-islands of exact length L = 1..5 on each ring of ``chain`` [T,
    N] (0/1), as [T, 6] int32 (column 0 is 0): the JAX package's product
    formula (1 - c[i-1]) c[i] ... c[i+L-1] (1 - c[i+L]) summed over i,
    the run's product carried from one L to the next."""
    run = 1 - torch.roll(chain, 1, dims=1)
    counts = [torch.zeros(chain.shape[0], dtype=torch.int32,
                          device=chain.device)]
    for L in range(1, COUNT_COLUMNS):
        run = run * torch.roll(chain, 1 - L, dims=1)
        end = 1 - torch.roll(chain, -L, dims=1)
        counts.append((run * end).sum(dim=1).to(torch.int32))
    return torch.stack(counts, dim=1)


def metropolis_plain(chains: torch.Tensor, sites: torch.Tensor,
                     u: torch.Tensor, thr: torch.Tensor,
                     count_first: bool) -> torch.Tensor:
    """Plain version of `metropolis`: the steps of ``sites`` and ``u``
    ([T, steps, rounds, rs], int32 and float64) on ``chains`` [T, N]
    int32 (advanced in place), the JAX package's `do_round` and
    `island_counts` over a batch of chains; returns counts [T, steps +
    count_first, 6] int32."""
    metropolis_plain.calls += 1
    T, N = chains.shape
    steps, rounds, rs = sites.shape[1:]
    chain = chains.clone()
    lower = torch.tril(torch.ones(rs, rs, dtype=torch.bool,
                                  device=chain.device), diagonal=-1)
    flips = torch.empty_like(chain)
    out = [island_counts_plain(chain)] if count_first else []
    for st in range(steps):
        for r in range(rounds):
            s = sites[:, st, r].to(torch.int64)  # [T, rs]
            left = chain.gather(1, (s - 1) % N)
            mid = chain.gather(1, s)
            right = chain.gather(1, (s + 1) % N)
            same = (left == mid).to(torch.int64) + (mid == right)
            accept = u[:, st, r] < thr[2 * same + mid]
            d = (s[:, :, None] - s[:, None, :]).abs()
            d = torch.minimum(d, N - d)
            conflicted = ((d <= 1) & lower).any(dim=2)
            apply = (accept & ~conflicted).to(torch.int32)
            flips.zero_().scatter_add_(1, s, apply)
            chain = chain ^ (flips & 1)
        out.append(island_counts_plain(chain))
    chains.copy_(chain)
    return torch.stack(out, dim=1)


metropolis_plain.calls = 0


# The dynamic shared memory K28 may ask for: the H100's 232,448 bytes a
# block less the kernel's static totals, with room to spare.
K28_SMEM_BYTES = 231_424


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def k28_bytes(N: int, rounds: int, rs: int) -> int:
    """K28's dynamic shared memory (`csrc/metropolis.cu:mc_layout`): the
    chain of ``N`` sites as bits and its snapshot, each rounded up to 16
    bytes, two buffers of a step's sites (int32) and uniforms (float64),
    then two buffers of a step's conflict masks (a word a round) up to
    32 trials a round, a flag a trial past it."""
    words = _up16(4 * (-(-N // 32)))
    return (2 * words + _up16(8 * rounds * rs) + 16 * rounds * rs
            + (_up16(rs) if rs > 32 else _up16(8 * rounds)))


def k28_check(N: int, rounds: int, rs: int) -> None:
    """Raises unless K28's layout fits a block's shared memory: chains of
    up to about 900,000 sites at the example's 500 trials a step."""
    if k28_bytes(N, rounds, rs) > K28_SMEM_BYTES:
        draws = k28_bytes(1, rounds, rs) - 32
        raise ValueError(
            f"K28 holds a chain and its snapshot as bits beside a step's "
            f"draws twice ({draws} bytes at {rounds} rounds of {rs}): at "
            f"most {4 * (K28_SMEM_BYTES - draws - 32)} sites, not {N}")


def metropolis(chains: torch.Tensor, sites: torch.Tensor, u: torch.Tensor,
               thr: np.ndarray, count_first: bool) -> torch.Tensor:
    """K28: the steps of ``sites`` [T, steps, rounds, rs] int32 and ``u``
    (float64, alike) on ``chains`` [T, N] int32 (advanced in place);
    counts [T, steps + count_first, 6] int32 (see `metropolis_plain`).
    One launch on the card, a block a chain held as bits, the rounds on
    one warp where rs <= 32 (`k28_check` raises where the layout does not
    fit a block); the plain version on the CPU. ``thr`` is
    `acceptance_table`'s."""
    if not cuda.on_card(chains, "metropolis"):
        return metropolis_plain(
            chains, sites, u,
            torch.as_tensor(thr, dtype=torch.float64, device=chains.device),
            count_first)
    T, N = chains.shape
    steps, rounds, rs = sites.shape[1:]
    for x, dtype in ((chains, torch.int32), (sites, torch.int32),
                     (u, torch.float64)):
        if (x.dtype != dtype or not x.is_contiguous()
                or x.device != chains.device):
            raise TypeError(f"metropolis: expected contiguous {dtype} "
                            f"tensors on {chains.device}")
    if sites.shape[0] != T or tuple(u.shape) != tuple(sites.shape):
        raise ValueError("metropolis: sites and u must be [T, steps, "
                         "rounds, rs] for chains [T, N]")
    k28_check(N, rounds, rs)
    thr = np.ascontiguousarray(thr, dtype=np.float64)
    counts = torch.empty((T, steps + int(bool(count_first)), COUNT_COLUMNS),
                         dtype=torch.int32, device=chains.device)
    lib = cuda.load()
    with torch.cuda.device(chains.device):
        rc = lib.ckpe_metropolis(T, N, rounds, rs, thr.ctypes.data,
                                 chains.data_ptr(), sites.data_ptr(),
                                 u.data_ptr(), steps, int(bool(count_first)),
                                 counts.data_ptr(), cuda.stream(chains))
    cuda.check(rc, "metropolis", lib)
    metropolis.launches += 1
    return counts


metropolis.launches = 0


def _check_chains(chains0, device):
    """A copy of ``chains0`` [T, N] as contiguous int32 on ``device``."""
    chains = torch.as_tensor(chains0).to(device=device, dtype=torch.int32,
                                         copy=True).contiguous()
    if chains.dim() != 2:
        raise ValueError("chains must be [T, N]")
    if bool(((chains != 0) & (chains != 1)).any()):
        raise ValueError("chain sites must be 0 or 1")
    return chains


def simulate_metropolis_from_draws(chains0, sites, uniforms, J, h, beta):
    """The Metropolis chains given their draws: ``chains0`` [T, N] (0/1),
    ``sites`` [T, num_steps - 1, rounds, rs] int in [0, N) and
    ``uniforms`` alike float64 (step t's round r's trials, the JAX
    package's ``randint(k1, (rounds, rs), 0, N)`` and ``uniform(k2,
    (rounds, rs), float64)`` of each step key), on the device the run
    takes. Returns (counts [T, num_steps, 6] int32, final chains [T, N]
    int32)."""
    sites = torch.as_tensor(sites)
    dev = sites.device
    chains = _check_chains(chains0, dev)
    sites = sites.to(torch.int32).contiguous()
    uniforms = torch.as_tensor(uniforms).to(device=dev,
                                            dtype=torch.float64).contiguous()
    thr = acceptance_table(J, h, beta)
    counts = metropolis(chains, sites, uniforms, thr, True)
    return counts, chains


def simulate_metropolis_batch(generator, chains0, num_steps: int,
                              trials_per_step: int, rounds_per_step: int,
                              J, h, beta, device=None):
    """The Metropolis chains ``chains0`` [T, N] (0/1) for ``num_steps``
    observations: the start, then num_steps - 1 steps of
    ``trials_per_step // rounds_per_step`` trials in each of
    ``rounds_per_step`` rounds (the remainder dropped, as in the JAX
    package), every chain on K28 at once. ``generator`` is a seed or a
    `torch.Generator` on the device; each step's sites (uniform over the
    ring) and float64 uniforms are drawn on its stream in chunks of
    steps. Returns counts [T, num_steps, 6] int32 (column L the up-islands
    of exact length L, column 0 zero)."""
    dev = get_device(device)
    gen = make_generator(generator, dev)
    chains = _check_chains(chains0, dev)
    T, N = chains.shape
    rs = trials_per_step // rounds_per_step
    if num_steps < 1 or rs < 1:
        raise ValueError("need num_steps >= 1 and trials_per_step >= "
                         "rounds_per_step >= 1")
    thr = acceptance_table(J, h, beta)
    chunk = max(1, DRAW_CHUNK // (T * rounds_per_step * rs))
    counts = torch.empty((T, num_steps, COUNT_COLUMNS), dtype=torch.int32,
                         device=dev)
    row = 0  # the first launch also counts the start
    for s0 in range(0, max(num_steps - 1, 1), chunk):
        c = min(chunk, num_steps - 1 - s0)
        shape = (T, c, rounds_per_step, rs)
        sites = torch.randint(0, N, shape, generator=gen, dtype=torch.int32,
                              device=dev)
        u = torch.rand(shape, generator=gen, dtype=torch.float64, device=dev)
        got = metropolis(chains, sites, u, thr, row == 0)
        counts[:, row:row + got.shape[1]] = got
        row += got.shape[1]
    return counts


def simulate_metropolis(generator, chain0, num_steps: int,
                        trials_per_step: int, rounds_per_step: int, J, h,
                        beta, observe_lengths=5, device=None):
    """One chain ``chain0`` [N]: counts [num_steps, 6] int32
    (`simulate_metropolis_batch` of a batch of one). ``observe_lengths``
    is the JAX package's argument and, as there, changes nothing: six
    columns always."""
    del observe_lengths
    chain = torch.as_tensor(chain0).reshape(1, -1)
    return simulate_metropolis_batch(
        generator, chain, num_steps, trials_per_step, rounds_per_step, J, h,
        beta, device)[0]


def mc_island_history(*, num_trials=100, chain_length=50_000,
                      num_steps=4000, trials_per_step=500,
                      sites_per_pair=250, J=1.0, h=-0.25, beta=1.0,
                      rounds_per_step=20, seed=1000, generator=None,
                      device=None):
    """The full ensemble: [num_trials, num_steps, 6] island counts (a
    numpy array). Initial chains place up-pairs at density
    1/sites_per_pair: a float64 uniform a site below 1/sites_per_pair
    marks a pair's start, and ``pair | roll(pair, 1)`` sets it and its
    right neighbour. ``generator`` (a `torch.Generator` on the device)
    takes the place of ``seed`` when given."""
    dev = get_device(device)
    gen = make_generator(seed if generator is None else generator, dev)
    pair = torch.rand((num_trials, chain_length), generator=gen,
                      dtype=torch.float64, device=dev) < 1.0 / sites_per_pair
    chains0 = (pair | torch.roll(pair, 1, dims=1)).to(torch.int32)
    counts = simulate_metropolis_batch(
        gen, chains0, num_steps, trials_per_step, rounds_per_step, J, h,
        beta, device=dev)
    return counts.cpu().numpy()


def energy(chains, J, h):
    """Total Ising energy of (batched) chains."""
    pm = np.asarray(chains, dtype=np.float64) * 2 - 1
    e_j = -J * (
        (pm[..., 1:] * pm[..., :-1]).sum(axis=-1)
        + pm[..., 0] * pm[..., -1]
    )
    return e_j - h * pm.sum(axis=-1)


def island_length_stats(chain, is_up=True):
    """Host-side exact island statistics dict (wraparound-aware)."""
    chain = np.asarray(chain).astype(np.int8)
    eff = chain if is_up else 1 - chain
    if eff.min() == 1:  # degenerate all-up chain
        return {chain.size: 1}
    prefix = int(eff.argmin())
    suffix = int(eff[::-1].argmin())
    wrap_len = prefix + suffix
    core = eff[prefix:chain.size - suffix]
    stats = {wrap_len: int(wrap_len > 0)}
    if core.size == 0:
        return stats
    swaps = np.flatnonzero(core[:-1] ^ core[1:])
    assert len(swaps) % 2 == 0
    for lo, hi in swaps.reshape(-1, 2):
        stats[hi - lo] = stats.get(hi - lo, 0) + 1
    return stats


# --- Exact Ising equilibrium (transfer matrix) -------------------------------

def ising_gibbs_windows(cl_k, *, J_eff, h, beta):
    """Exact length-``cl_k`` window probabilities of the infinite-chain
    1D Ising Gibbs measure (transfer matrix; symbol 0 = D = spin -1,
    1 = U = +1): the equilibrium ex2's tape rule relaxes to, at
    ``J_eff = 2J`` (its flip rates are detailed-balanced against
    H = -J_eff sum s s' - h sum s). Order-1 Markov, so an exact root of
    the closure's dp/dt for any cl_k >= 2. A flat float64 ``[2**cl_k]``
    array."""
    sv = np.array([-1.0, 1.0])
    T = np.exp(beta * (J_eff * np.outer(sv, sv)
                       + h * (sv[:, None] + sv[None, :]) / 2))
    w, V = np.linalg.eig(T)
    i = int(np.argmax(w.real))
    lam, r = w.real[i], V[:, i].real
    wl, Vl = np.linalg.eig(T.T)
    left = Vl[:, int(np.argmax(wl.real))].real
    if (left @ r) < 0:
        r = -r

    def window(bits):
        v = left[bits[0]] * r[bits[-1]]
        for a, b in zip(bits[:-1], bits[1:]):
            v *= T[a, b] / lam
        return v / (left @ r)

    p = np.array([window([(idx >> (cl_k - 1 - j)) & 1
                          for j in range(cl_k)])
                  for idx in range(2 ** cl_k)])
    return p / p.sum()
