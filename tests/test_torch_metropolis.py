"""Parity of the port's ferromagnet companions (`models/ferromagnet.py`)
with the JAX package (CPU).

The Metropolis chains are fed the JAX runs' own draws (a key a chain,
``split(key, num_steps - 1)`` a step, ``k1, k2 = split(k)``, the sites
``randint(k1, (rounds, rs), 0, N)`` and the uniforms ``uniform(k2,
(rounds, rs), float64)``, as `simulate_metropolis` draws them): the
island counts of every step equal the JAX package's, and the final
chains equal an independent sequential replay of the round rule
(`_replay`). The six thresholds equal the JAX package's
`_flip_acceptance` on every neighbourhood to an ulp of ``exp``. K28's rule
(`csrc/metropolis_rule.cuh`, built with the host's C++ compiler) gives
the plain version's chains and counts bit for bit, run phase by phase
on bytes and in the card's form (bits, the warp's conflict keys, the
word count); the word count alone equals `island_counts_plain` on rings
of every length class. Then the twins of the ferromagnet tests of
`tests/test_models.py` (`:97`, `:107`, `:129`, `:135`).
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu.models import (
    ferromagnet as jf,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.models import ferromagnet

CASES = {  # J, h, beta, trials_per_step, rounds_per_step
    "ex2": (1.0, -0.25, 1.0, 32, 8),
    "field_up": (0.5, 0.3, 1.0, 32, 8),
    "hot": (0.2, -0.1, 1.0, 40, 8),
    "sequential": (0.3, -0.25, 1.0, 16, 16),
    "remainder": (0.4, -0.25, 1.0, 30, 4),  # 7 a round, 2 dropped
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the steps here are many short ops on
    small tensors, which a full thread pool runs several times slower on
    a host whose cores other test workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(key, steps, rounds, rs, N):
    ks = jax.random.split(key, steps - 1)

    def one(kt):
        k1, k2 = jax.random.split(kt)
        return (jax.random.randint(k1, (rounds, rs), 0, N),
                jax.random.uniform(k2, (rounds, rs), dtype=jnp.float64))

    sites, u = jax.vmap(one)(ks)
    return np.asarray(sites), np.asarray(u)


def _replay(chains0, sites, u, thr):
    """The round rule, one trial at a time in plain Python: the
    reference the final chains are held to."""
    chains = np.array(chains0, dtype=np.int64)
    T, N = chains.shape
    for c in range(T):
        ch = chains[c]
        for st in range(sites.shape[1]):
            for r in range(sites.shape[2]):
                start = ch.copy()
                seen = []
                for s, x in zip(sites[c, st, r], u[c, st, r]):
                    s = int(s)
                    same = int(start[s - 1] == start[s]) + int(
                        start[s] == start[(s + 1) % N])
                    hit = any(min(abs(s - q), N - abs(s - q)) <= 1
                              for q in seen)
                    seen.append(s)
                    if x < thr[2 * same + start[s]] and not hit:
                        ch[s] ^= 1
    return chains


def test_acceptance_table_matches_jax():
    """Every (left, mid, right) neighbourhood's threshold equals the JAX
    package's `_flip_acceptance`, for h < 0, h > 0 and h = 0, to the
    ulp by which numpy's ``exp`` and XLA's differ (a uniform would have
    to land in that ulp to flip a trial: the runs below never do)."""
    chain = np.array([0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 1, 0], np.int32)
    sites = np.arange(12)
    for J, h, beta in ((1.0, -0.25, 1.0), (0.7, 0.3, 1.3), (1.0, 0.0, 2.0)):
        thr = ferromagnet.acceptance_table(J, h, beta)
        want = np.asarray(jf._flip_acceptance(
            jnp.asarray(chain), jnp.asarray(sites), beta * J, beta * h,
            h > 0))
        left, right = np.roll(chain, 1), np.roll(chain, -1)
        same = (left == chain).astype(int) + (chain == right)
        np.testing.assert_allclose(thr[2 * same + chain], want, rtol=3e-16,
                                   atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_metropolis_matches_jax_draws(case):
    """4 chains x 256 sites x 30 steps at the JAX run's draws: counts
    equal the JAX package's every step, chains the sequential replay."""
    J, h, beta, trials, rounds = CASES[case]
    T, N, steps = 4, 256, 30
    rs = trials // rounds
    rng = np.random.RandomState(1)
    chains0 = (rng.rand(T, N) < 0.3).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), T)
    want = np.stack([np.asarray(jf.simulate_metropolis(
        k, c, steps, trials, rounds, J, h, beta))
        for k, c in zip(keys, chains0)])
    draws = [_jax_draws(k, steps, rounds, rs, N) for k in keys]
    sites = np.stack([d[0] for d in draws])
    u = np.stack([d[1] for d in draws])
    counts, chains = ferromagnet.simulate_metropolis_from_draws(
        chains0, torch.as_tensor(sites), torch.as_tensor(u), J, h, beta)
    assert counts.shape == (T, steps, 6) and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), want)
    replay = _replay(chains0, sites, u,
                     ferromagnet.acceptance_table(J, h, beta))
    np.testing.assert_array_equal(chains.numpy(), replay)
    assert (chains.numpy() != chains0).any()


_MC_HOST = ('#include "metropolis_rule.cuh"\n'
            'extern "C" unsigned mc_mask(const int* s, int n, int N, int i) '
            '{ return mc_conflict_mask(s, n, N, i); }\n')


@pytest.fixture(scope="module")
def mc_lib(tmp_path_factory):
    """K28's rule (`csrc/metropolis_rule.cuh`: the rule's phases in turn
    for each chain on a chain of bytes, the card's form on one of bits,
    and the word count alone) built with the host's C++ compiler."""
    cxx = next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                      "clang++")) if c), None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k28")
    (out / "k28.cpp").write_text(_MC_HOST)
    lib = out / "libk28.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib),
                    str(out / "k28.cpp")], check=True, capture_output=True,
                   timeout=120)
    lib = ctypes.CDLL(str(lib))
    i, p = ctypes.c_int, ctypes.c_void_p
    for fn in (lib.mc_host_run, lib.mc_host_run_bits):
        fn.argtypes = [i, i, i, i, p, p, p, p, i, i, i, p]
        fn.restype = i
    lib.mc_host_count_words.argtypes = [i, i, p, p]
    lib.mc_host_count_words.restype = i
    lib.mc_mask.argtypes = [p, i, i, i]
    lib.mc_mask.restype = ctypes.c_uint
    return lib


@pytest.fixture(scope="module")
def mc_host(mc_lib):
    return mc_lib.mc_host_run


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("count_first,threads,N", [
    (True, 512, 256), (False, 7, 301), (True, 32, 5)])
def test_metropolis_rule_matches_plain(mc_host, case, count_first, threads,
                                       N):
    """K28's rule against `metropolis_plain` on the same draws: chains
    and counts bit for bit, with and without the start's counts, at a
    block of 512, 32 and 7 threads, on a ring of 5 (islands that wrap
    onto themselves) too."""
    J, h, beta, trials, rounds = CASES[case]
    rs = trials // rounds
    T, steps = 3, 12
    gen = torch.Generator().manual_seed(9)
    chains = (torch.rand((T, N), generator=gen) < 0.4).to(torch.int32)
    sites = torch.randint(0, N, (T, steps, rounds, rs), generator=gen,
                          dtype=torch.int32)
    u = torch.rand((T, steps, rounds, rs), generator=gen,
                   dtype=torch.float64)
    thr = ferromagnet.acceptance_table(J, h, beta)
    host_chains = chains.numpy().copy()
    plain_chains = chains.clone()
    want = ferromagnet.metropolis(plain_chains, sites, u, thr, count_first)
    got = np.zeros(tuple(want.shape), dtype=np.int32)
    s, uu = sites.numpy(), u.numpy()
    rc = mc_host(T, N, rounds, rs, thr.ctypes.data, host_chains.ctypes.data,
                 s.ctypes.data, uu.ctypes.data, steps, int(count_first),
                 threads, got.ctypes.data)
    assert rc == 0
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(host_chains, plain_chains.numpy())


@pytest.mark.parametrize("N,trials,rounds", [
    pytest.param(5, 32, 8, id="5"), pytest.param(301, 32, 8, id="301"),
    pytest.param(1000, 32, 8, id="1000"),
    pytest.param(1000, 320, 8, id="1000-rs40"),
    pytest.param(333, 16, 16, id="333-rs1"),
    pytest.param(97, 500, 20, id="97-rs25")])
def test_metropolis_bits_rule_matches_plain(mc_lib, N, trials, rounds):
    """K28's rule in the card's form (`mc_host_run_bits`: the chain as
    bits, `McBits`; a trial a lane of one warp with the conflicts by
    `mc_conflict_mask`'s keys where rs <= 32, every earlier trial past
    it; the islands by `mc_count_word` from 64 sites) against
    `metropolis_plain` on the same draws: chains and counts bit for bit,
    on rings that end inside a word, on one of 5 sites, at 40 trials a
    round (two warps' worth), one, and the example's 25."""
    J, h, beta = CASES[sorted(CASES)[0]][:3]
    rs = trials // rounds
    T, steps = 3, 10
    gen = torch.Generator().manual_seed(11)
    chains = (torch.rand((T, N), generator=gen) < 0.4).to(torch.int32)
    sites = torch.randint(0, N, (T, steps, rounds, rs), generator=gen,
                          dtype=torch.int32)
    u = torch.rand((T, steps, rounds, rs), generator=gen,
                   dtype=torch.float64)
    thr = ferromagnet.acceptance_table(J, h, beta)
    host_chains = chains.numpy().copy()
    plain_chains = chains.clone()
    want = ferromagnet.metropolis(plain_chains, sites, u, thr, True)
    got = np.zeros(tuple(want.shape), dtype=np.int32)
    assert mc_lib.mc_host_run_bits(
        T, N, rounds, rs, thr.ctypes.data, host_chains.ctypes.data,
        sites.numpy().ctypes.data, u.numpy().ctypes.data, steps, 1, 32,
        got.ctypes.data) == 0
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(host_chains, plain_chains.numpy())
    assert (host_chains != chains.numpy()).any()


@pytest.mark.parametrize("N", [1, 2, 5, 6, 7, 31, 32, 33, 63, 64, 65, 97,
                               1000, 50_000])
def test_word_count_matches_plain(mc_lib, N):
    """The card's island count (`mc_count_word`: a 32-bit word at a time,
    the starts of exact-length up-runs as masks, the ring's last partial
    word and its wrap; `mc_island_site` below 64 sites) equals
    `island_counts_plain` on all-zero and all-one rings, rings of sparse
    and dense random islands, and rings whose runs cross every word
    boundary (period 33)."""
    rng = np.random.RandomState(N)
    rows = [np.zeros(N), np.ones(N)]
    rows += [rng.rand(N) < q for q in (0.2, 0.5, 0.8, 0.95)]
    rows.append(np.arange(N) % 33 < 5)
    chains = np.stack(rows).astype(np.int32)
    got = np.zeros((len(rows), 6), dtype=np.int32)
    assert mc_lib.mc_host_count_words(len(rows), N, chains.ctypes.data,
                                      got.ctypes.data) == 0
    want = ferromagnet.island_counts_plain(torch.as_tensor(chains)).numpy()
    np.testing.assert_array_equal(got, want)


def test_metropolis_conflict_keys_match_distance(mc_lib):
    """`mc_conflict_mask`'s keys (s >> 1, (s + 1) >> 1, the ring's two
    ends) pick exactly the earlier trials within circular distance 1, on
    rings of 1 to 70 sites, crowded rounds of 32 trials included."""
    rng = np.random.RandomState(3)
    for N in list(range(1, 12)) + [31, 32, 33, 64, 70]:
        for _ in range(20):
            s = rng.randint(0, N, 32).astype(np.int32)
            for i in range(32):
                got = mc_lib.mc_mask(s.ctypes.data, 32, N, i)
                d = np.abs(s[:i].astype(int) - int(s[i]))
                d = np.minimum(d, N - d)
                want = sum(1 << j for j in np.flatnonzero(d <= 1))
                assert got == want, (N, i)


def test_k28_holds_long_chains_as_bits():
    """K28's one form, bits, by the geometry alone: the chain and its
    snapshot as words beside two buffers of a step's draws and conflict
    masks (24,672 bytes at the example's 50,000 sites and 20 rounds of
    25; 87,168 at 300,000 sites), fitting a block up to about 877,000
    sites there, an error past it."""
    assert ferromagnet.k28_bytes(50_000, 20, 25) == 2 * 6_256 + 12_160
    assert ferromagnet.k28_bytes(300_000, 20, 25) == 2 * 37_504 + 12_160
    assert ferromagnet.k28_bytes(1000, 8, 40) == 2 * 128 + 24 * 320 + 48
    for N in (50_000, 300_000, 877_000):
        ferromagnet.k28_check(N, 20, 25)
    with pytest.raises(ValueError, match="at most"):
        ferromagnet.k28_check(2_000_000, 20, 25)


def test_island_counts_match_stats():
    """The counts' columns equal `island_length_stats` on rings whose
    islands do not wrap past length 5, and column 0 stays 0."""
    rng = np.random.RandomState(4)
    chains = (rng.rand(6, 200) < 0.35).astype(np.int32)
    got = ferromagnet.island_counts_plain(torch.as_tensor(chains)).numpy()
    for c, row in zip(chains, got):
        stats = ferromagnet.island_length_stats(c)
        assert row[0] == 0
        for L in range(1, 6):
            assert row[L] == stats.get(L, 0)


def test_mc_island_history_initial_pairs():
    """The start: a float64 uniform a site under 1/sites_per_pair marks a
    pair (it and its right neighbour up), its counts the first row."""
    counts = ferromagnet.mc_island_history(
        num_trials=3, chain_length=600, num_steps=1, trials_per_step=6,
        sites_per_pair=25, rounds_per_step=2, seed=4, device="cpu")
    gen = torch.Generator().manual_seed(4)
    pair = torch.rand((3, 600), generator=gen, dtype=torch.float64) < 1 / 25
    chains = (pair | torch.roll(pair, 1, dims=1)).to(torch.int32)
    np.testing.assert_array_equal(
        counts[:, 0], ferromagnet.island_counts_plain(chains).numpy())
    assert counts[:, 0, 2].sum() > 0


def test_helpers_match_jax():
    rng = np.random.RandomState(2)
    chains = (rng.rand(5, 40) < 0.5).astype(np.int32)
    np.testing.assert_allclose(ferromagnet.energy(chains, 1.0, -0.25),
                               jf.energy(chains, 1.0, -0.25), rtol=0, atol=0)
    for c in chains:
        assert ferromagnet.island_length_stats(c) == jf.island_length_stats(c)
    np.testing.assert_array_equal(ferromagnet.island_rate_matrix(0.3, 0.7, 9),
                                  jf.island_rate_matrix(0.3, 0.7, 9))


def test_analytic_p_history_matches_jax():
    """The port's dopri5 against the JAX package's on the island ODE
    (both at rtol = atol = 1e-10; their steps round apart)."""
    got = ferromagnet.analytic_p_history(t_max=40.0, t_steps=101,
                                         device="cpu")
    want = jf.analytic_p_history(t_max=40.0, t_steps=101)
    assert got.shape == want.shape == (101, 20)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12)


def test_invalid_chain_raises():
    with pytest.raises(ValueError, match="0 or 1"):
        ferromagnet.simulate_metropolis(0, np.array([0, 2, 1]), 3, 2, 1,
                                        1.0, -0.25, 1.0, device="cpu")


# --- Twins of tests/test_models.py ------------------------------------------

def test_analytic_island_populations_nonnegative_and_saturating():
    ys = ferromagnet.analytic_p_history(t_max=40.0, t_steps=101,
                                        device="cpu")
    assert (ys >= 0).all()
    late_delta = np.abs(ys[-1] - ys[-2]).max()
    early_delta = np.abs(ys[1] - ys[0]).max()
    assert late_delta < early_delta


def test_mc_matches_analytic_bands():
    """The JAX test's scaled-down cross-check: the MC p(L=1) averaged
    over the second half lies within 0.3-3x the analytic curve's."""
    num_steps, chain_length = 400, 5000
    counts = ferromagnet.mc_island_history(
        num_trials=8, chain_length=chain_length, num_steps=num_steps,
        trials_per_step=chain_length // 100, sites_per_pair=250,
        rounds_per_step=10, device="cpu",
    )
    assert counts.shape == (8, num_steps, 6)
    p_mc = counts[..., 1] / chain_length
    analytic = ferromagnet.analytic_p_history(
        t_max=num_steps / 100, t_steps=num_steps, p0_pair=1 / 250,
        device="cpu")
    half = num_steps // 2
    mc_mean = p_mc[:, half:].mean()
    an_mean = analytic[half:, 0].mean()
    assert 0.3 * an_mean < mc_mean < 3.0 * an_mean


def test_island_length_stats_wraparound():
    chain = np.array([1, 0, 1, 1, 0, 0, 1])
    assert ferromagnet.island_length_stats(chain) == {2: 2}


def test_simulate_metropolis_shapes_and_cold_freeze():
    """At J = 5 nothing ignites on an all-down chain."""
    chain0 = np.zeros(256, np.int32)
    counts = np.asarray(ferromagnet.simulate_metropolis(
        0, chain0, 50, 32, 8, 5.0, -0.25, 1.0, device="cpu"))
    assert counts.shape == (50, 6)
    assert counts.sum() == 0
