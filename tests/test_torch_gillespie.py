"""Parity of the port's Gillespie SSA (`models/gillespie.py`) with the JAX
package (CPU).

The batch core is fed the JAX runs' own draws (``jax.random.split(key,
E)``, then ``uniform(k, (2, B), dtype)`` a key, as `ssa_batch_tm` draws
them): in float64 the counts are equal and the times within rtol 1e-12
(``log1p`` of two libraries), in float32 the counts are equal and the
times within rtol 1e-6. The sums run in reaction order in both (XLA's
order on its CPU backend, checked below), so a trajectory can only depart
where a draw lands within rounding of a running sum: the autocatalysis
case counts such departures (under 0.1% allowed), the one- and
two-reaction networks allow none. K27's rule (`csrc/ssa_rule.cuh`,
built with the host's C++ compiler) gives the plain version's counts
and its times to the libraries' ``log1p`` difference. Then the twins of
the four SSA tests of `tests/test_models.py` (`:151`, `:167`, `:178`,
`:189`) on the port's generator.
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
    gillespie as jg,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.models import gillespie

BENCH_NET = (1.0, 100.0, 1.0, 1.0, 100.0, 1.0, 10.0, 2.0)  # bench_ssa
DECAY = gillespie.ReactionNetwork(np.array([[1]]), np.array([[0]]),
                                  np.array([1.0]))
# A <-> B, second order forward: two reactions whose draws decide.
TWO = gillespie.ReactionNetwork(np.array([[2, 0], [0, 1]]),
                                np.array([[0, 1], [2, 0]]),
                                np.array([0.013, 0.7]))


def _wide_net(kind):
    """A network past K27's shared-memory limits: 33 reactions
    ("reactions"), 9 species ("species"), a reaction of 9 factors
    ("factors"), or all three ("all"), with its start counts."""
    rng = np.random.RandomState({"reactions": 1, "species": 2, "factors": 3,
                                 "all": 4}[kind])
    R, S = {"reactions": (33, 3), "species": (12, 9), "factors": (5, 2),
            "all": (33, 9)}[kind]
    reactants = rng.randint(0, 2, (R, S))
    if S > 8:
        reactants[:, 8] = 0
        reactants[0] = 0
        reactants[0, 8] = 1
    if kind in ("factors", "all"):
        reactants[1] = 0
        reactants[1, 0] = 9
    products = rng.randint(0, 3, (R, S))
    rates = rng.uniform(0.2, 1.0, R) * 20.0 ** -reactants.sum(axis=1)
    return (gillespie.ReactionNetwork(reactants, products, rates),
            tuple([25] * S))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the steps here are many short ops on
    small tensors, which a full thread pool runs several times slower on
    a host whose cores other test workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(key, E, B, dtype):
    keys = jax.random.split(key, E)
    return np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (2, B), dtype))(keys))


def test_network_matches_jax():
    jnet = jg.autocatalysis_network(*BENCH_NET, volume=100.0)
    net = gillespie.autocatalysis_network(*BENCH_NET, volume=100.0)
    for f in ("reactants", "products", "rates"):
        np.testing.assert_array_equal(getattr(net, f), getattr(jnet, f))
    assert net.static == jnet.static
    assert gillespie.network_from_jax(jnet).static == jnet.static
    np.testing.assert_array_equal(net.stoichiometry, jnet.stoichiometry)


def test_xla_sums_in_reaction_order():
    """The JAX core's ``prop.sum(axis=0)`` and ``cumsum(prop, axis=0)``
    over 12 reactions take reaction order on the CPU backend: the order
    K27 and its plain version take."""
    rng = np.random.RandomState(0)
    x = (rng.rand(12, 4096) * 10.0 ** rng.uniform(-3, 3, (12, 4096))
         ).astype(np.float32)
    tot, cum = jax.jit(lambda x: (x.sum(axis=0), jnp.cumsum(x, axis=0)))(x)
    acc = x[0].copy()
    want = [acc.copy()]
    for r in range(1, 12):
        acc = (acc + x[r]).astype(np.float32)
        want.append(acc.copy())
    np.testing.assert_array_equal(np.asarray(cum), np.stack(want))
    np.testing.assert_array_equal(np.asarray(tot), want[-1])


@pytest.mark.parametrize("name,dtype", [
    ("autocatalysis", "float64"), ("autocatalysis", "float32"),
    ("decay", "float32"), ("two", "float32"), ("two", "float64"),
    ("wide", "float64")])
def test_batch_core_matches_jax_draws(name, dtype):
    """`ssa_batch_tm_from_draws` against the JAX package's `ssa_batch_tm`
    at the same key: the bench network (B=512, E=150), pure decay from
    5 (quiescent after 5 events: inf times), a two-reaction network, and
    a network past K27's shared-memory limits (33 reactions, 9 species,
    9 factors), which the CPU takes as the JAX package does."""
    net, n0, B, E = {
        "autocatalysis": (gillespie.autocatalysis_network(*BENCH_NET),
                          (0, 0, 2000), 512, 150),
        "decay": (DECAY, (5,), 256, 12),
        "two": (TWO, (40, 3), 256, 120),
        "wide": _wide_net("all") + (128, 40)}[name]
    jdt = getattr(jnp, dtype)
    key = jax.random.PRNGKey(7)
    jts, jns = (np.asarray(x) for x in
                jg.ssa_batch_tm(key, n0, net.static, E, B, jdt))
    u = _jax_draws(key, E, B, jdt)
    ts, ns = gillespie.ssa_batch_tm_from_draws(n0, net, torch.tensor(u))
    ts, ns = ts.numpy(), ns.numpy()
    assert ts.shape == (E, B) and ns.shape == (E, len(n0), B)
    assert ts.dtype == np.float64 and ns.dtype == np.int32
    departed = (ns != jns).any(axis=(0, 1))
    print(f"{name} {dtype}: {int(departed.sum())} of {B} trajectories "
          "depart from the JAX run")
    if name == "autocatalysis" and dtype == "float32":
        assert departed.mean() < 1e-3
    else:
        assert not departed.any()
    keep = ~departed
    rtol = 1e-12 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(ts[:, keep], jts[:, keep], rtol=rtol, atol=0)
    if name == "decay":
        assert np.isinf(ts[-1]).all() and (ns[-1] == 0).all()


_SSA_HOST = '#include "ssa_rule.cuh"\n'


@pytest.fixture(scope="module")
def ssa_lib(tmp_path_factory):
    """K27's rule (`csrc/ssa_rule.cuh`: the kernel's per-thread event
    loop, every trajectory in turn, in the shared and the wide form)
    built with the host's C++ compiler without contraction of products
    into sums."""
    cxx = next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                      "clang++")) if c), None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k27")
    (out / "k27.cpp").write_text(_SSA_HOST)
    lib = out / "libk27.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib),
                    str(out / "k27.cpp")], check=True, capture_output=True,
                   timeout=120)
    lib = ctypes.CDLL(str(lib))
    i, p, q = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.ssa_host_run.argtypes = [p, p, p, i, i, i, p, q, i, p, p, p, p]
    lib.ssa_host_run.restype = i
    lib.ssa_host_run_wide.argtypes = [p] * 5 + [i, i, i, p, q, i, p, p, p,
                                                p]
    lib.ssa_host_run_wide.restype = i
    return lib


@pytest.fixture(scope="module")
def ssa_host(ssa_lib):
    return ssa_lib.ssa_host_run


@pytest.mark.parametrize("name", ["autocatalysis", "decay", "two"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ssa_rule_matches_plain(ssa_host, name, dtype):
    """K27's rule against `ssa_round_plain` on the same draws, in two
    calls (the state carried between them): counts equal; times equal
    where both libraries' ``log1p`` agree, within rtol 1e-6 (float32)
    and 1e-13 (float64) elsewhere."""
    net, n0, B, E = {
        "autocatalysis": (gillespie.autocatalysis_network(*BENCH_NET),
                          (0, 0, 2000), 300, 80),
        "decay": (DECAY, (5,), 37, 9),
        "two": (TWO, (40, 3), 100, 60)}[name]
    S = len(n0)
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((E, 2, B), generator=gen, dtype=dtype)
    want_t, want_n = gillespie.ssa_batch_tm_from_draws(n0, net, u)
    order = np.ascontiguousarray(net.reactants, dtype=np.int32)
    stoich = np.ascontiguousarray(net.stoichiometry, dtype=np.int32)
    rates = np.ascontiguousarray(net.rates, dtype=np.float64)
    t = np.zeros(B)
    n = np.ascontiguousarray(np.broadcast_to(
        np.asarray(n0, np.int32)[:, None], (S, B)))
    got_t = np.empty((E, B))
    got_n = np.empty((E, S, B), dtype=np.int32)
    un = np.ascontiguousarray(u.numpy())
    half = E // 2
    for e0, e1 in ((0, half), (half, E)):
        ue = np.ascontiguousarray(un[e0:e1])
        tt = np.empty((e1 - e0, B))
        nn = np.empty((e1 - e0, S, B), dtype=np.int32)
        rc = ssa_host(order.ctypes.data, stoich.ctypes.data,
                      rates.ctypes.data, net.reactants.shape[0], S,
                      int(dtype == torch.float64), ue.ctypes.data, B,
                      e1 - e0, t.ctypes.data, n.ctypes.data, tt.ctypes.data,
                      nn.ctypes.data)
        assert rc == 0
        got_t[e0:e1], got_n[e0:e1] = tt, nn
    np.testing.assert_array_equal(got_n, want_n.numpy())
    rtol = 1e-6 if dtype == torch.float32 else 1e-13
    np.testing.assert_allclose(got_t, want_t.numpy(), rtol=rtol, atol=0)
    assert (np.isinf(got_t) == np.isinf(want_t.numpy())).all()


@pytest.mark.parametrize("kind", ["reactions", "species", "factors",
                                  "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ssa_wide_rule_matches_plain(ssa_lib, kind, dtype):
    """K27's wide form (the factor lists the card reads from global
    memory, `gillespie._wide_tables`) against `ssa_round_plain` on the
    same draws, at a network past each shared-memory limit: counts
    equal, times as in `test_ssa_rule_matches_plain`."""
    net, n0 = _wide_net(kind)
    R, S = net.reactants.shape
    assert not gillespie._fits_shared(net)
    B, E = 64, 40
    gen = torch.Generator().manual_seed(5)
    u = torch.rand((E, 2, B), generator=gen, dtype=dtype)
    want_t, want_n = gillespie.ssa_batch_tm_from_draws(n0, net, u)
    tables = [np.ascontiguousarray(x.numpy())
              for x in gillespie._wide_tables(net, "cpu")]
    t = np.zeros(B)
    n = np.ascontiguousarray(np.broadcast_to(
        np.asarray(n0, np.int32)[:, None], (S, B)))
    got_t = np.empty((E, B))
    got_n = np.empty((E, S, B), dtype=np.int32)
    un = np.ascontiguousarray(u.numpy())
    assert ssa_lib.ssa_host_run_wide(
        *(x.ctypes.data for x in tables), R, S, int(dtype == torch.float64),
        un.ctypes.data, B, E, t.ctypes.data, n.ctypes.data,
        got_t.ctypes.data, got_n.ctypes.data) == 0
    np.testing.assert_array_equal(got_n, want_n.numpy())
    rtol = 1e-6 if dtype == torch.float32 else 1e-13
    np.testing.assert_allclose(got_t, want_t.numpy(), rtol=rtol, atol=0)
    assert (want_n[-1] != want_n[0]).any()


def test_chunked_draws_carry_the_state(monkeypatch):
    """`ssa_batch_tm` in chunks of 7 events equals the core fed the same
    draws (the generator's stream chunk by chunk) in one call."""
    monkeypatch.setattr(gillespie, "DRAW_CHUNK", 7 * 2 * 64)
    net = gillespie.autocatalysis_network(*BENCH_NET)
    ts, ns = gillespie.ssa_batch_tm(11, (0, 0, 2000), net, 30, 64,
                                    device="cpu")
    gen = torch.Generator().manual_seed(11)
    u = torch.cat([torch.rand((min(7, 30 - e0), 2, 64), generator=gen)
                   for e0 in range(0, 30, 7)])
    monkeypatch.setattr(gillespie, "DRAW_CHUNK", 1 << 26)
    ts2, ns2 = gillespie.ssa_batch_tm_from_draws((0, 0, 2000), net, u)
    assert torch.equal(ts, ts2) and torch.equal(ns, ns2)


def test_limits_raise():
    """The propensity type must be float32 or float64; any network runs
    (the card takes K27's wide form past its shared-memory limits)."""
    with pytest.raises(TypeError):
        gillespie.ssa_batch_tm(0, (3,), DECAY, 2, 4, dtype=torch.float16,
                               device="cpu")


# --- Twins of tests/test_models.py ------------------------------------------

def test_ssa_pure_decay_statistics():
    """A -> 0 at rate 1: each event removes one; the extinction time's
    mean is near H_30 (the JAX test's bound)."""
    n0 = np.array([30])
    ts, ns = gillespie.run_ssa_ensemble(DECAY, n0, num_trajectories=200,
                                        num_events=30, seed=2, device="cpu")
    assert (np.diff(ns[..., 0], axis=1) == -1).all()
    t_extinct = ts[:, -1]
    expected = np.sum(1.0 / np.arange(1, 31))  # E[T] = H_30
    assert abs(t_extinct.mean() - expected) < 0.5


def test_ssa_quiescence_padding():
    ts, ns = gillespie.run_ssa_ensemble(DECAY, np.array([3]),
                                        num_trajectories=4, num_events=10,
                                        device="cpu")
    assert (ns[:, -1, 0] == 0).all()
    assert np.isinf(ts[:, -1]).all()  # past extinction: inf-padded


def test_ssa_autocatalysis_network_balances():
    net = gillespie.autocatalysis_network(
        0.001, 20.0, 10.0, 0.001, 50.0, 20.0, 0.0, 0.0, volume=100.0)
    weights = np.array([2, 2, 1])
    active = net.rates > 0
    assert ((net.stoichiometry @ weights)[active] == 0).all()


def test_ssa_f32_batch_statistically_matches_f64():
    """The float32 core agrees moment-wise with the float64 formulations
    (the float64 core and the per-trajectory stepper) on the bench
    network, at the JAX test's sizes and its 5-sigma and 0.7-1.4 bands."""
    net = gillespie.autocatalysis_network(*BENCH_NET)
    n0 = (0, 0, 2000)
    B, E = 2048, 400
    _, ns32 = gillespie.ssa_batch(0, n0, net.static, E, B, device="cpu")
    _, ns64 = gillespie.ssa_batch(1, n0, net.static, E, B, torch.float64,
                                  device="cpu")
    _, ns_ref = gillespie.ssa_trajectories(2, n0, net.static, E, 512,
                                           device="cpu")
    assert ns_ref.dtype == torch.int64 and ns_ref.shape == (512, E, 3)
    final32, final64, final_ref = (x[:, -1, :].numpy().astype(np.float64)
                                   for x in (ns32, ns64, ns_ref))
    for a, b in ((final32, final64), (final32, final_ref)):
        se = np.sqrt(a.var(axis=0) / a.shape[0] + b.var(axis=0) / b.shape[0])
        diff = np.abs(a.mean(axis=0) - b.mean(axis=0))
        assert (diff <= 5 * se + 1e-9).all(), (diff, se)
    v32, v64 = final32.var(axis=0), final64.var(axis=0)
    ok = (v64 < 1e-9) | ((v32 / np.maximum(v64, 1e-9) > 0.7)
                         & (v32 / np.maximum(v64, 1e-9) < 1.4))
    assert ok.all(), (v32, v64)
