"""Parity of the port's thermodynamics (`ops/thermo.py`) with the JAX
package (CPU).

The host tables equal the JAX package's exactly and its rate
functionals to rtol 1e-12. The rounds are fed the JAX runs' own draws
(`jax.random.split(key, num_steps)`, then per key ``k1, k2 = split``,
the shift(s) by ``randint(k1, ...)`` over [0, L) and the uniforms by
``uniform(k2, (B, E), float32)``, as `ops/thermo.py:384-397` draws
them): tapes, ``n_irrev`` and spec counts equal, sigma and spec_sig
bit for bit at E = 1 and to rtol 1e-12, atol 1e-12 at E > 1 (the
reference's `sum` reduces in XLA's order). K23's and K24's per-member
bodies (the generated unit's host entries, built with the host's C++
compiler) equal the plain versions bit for bit; the kernels themselves
run only on the card (`tests/test_torch_gpu.py`). Then the twins of
`tests/test_thermo.py`'s 16 tests, their statistical gates on the
port's own generator at the JAX tests' sizes with the same 6-sigma
bounds, the port's `engine/master.py` the oracle.
"""

import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu.engine import (
    ensemble as jens,
)
from chemical_kinetics_and_program_execution_tpu.engine import (
    master as jmaster,
)
from chemical_kinetics_and_program_execution_tpu.ops import thermo as jth
from chemical_kinetics_and_program_execution_torch import cuda, markov
from chemical_kinetics_and_program_execution_torch.engine import (
    dense as tdense,
)
from chemical_kinetics_and_program_execution_torch.engine import dsl
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as tens,
)
from chemical_kinetics_and_program_execution_torch.engine import k1_source
from chemical_kinetics_and_program_execution_torch.engine import (
    master as tmaster,
)
from chemical_kinetics_and_program_execution_torch.ops import thermo

BETA, J, H = 1.0, 1.0, -0.25  # ex2's baked parameters (problems.scm:30-33)
EX2 = "ex2-ferromagnetic-chain"
EX3 = "ex3-copolymerization"
EX4V2 = "ex4var2-chemical-turing"
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")

_EX4V2_SYMS = ("A", "B", "C", "D", "I", "O", "P", "X", "S", "E")
_EX4V2_G = {"A": -1.0, "B": -1.0, "C": -1.0, "D": 1.5, "I": 0.0,
            "O": 0.0, "P": 6.0, "X": 0.0, "S": 0.0, "E": 1.0}
_EX4V2_BETA = 1.0
G_VEC = np.array([_EX4V2_G[s] for s in _EX4V2_SYMS])


_MACHINES = {}
_TABLES = {}


def _dm(tag):
    if tag not in _MACHINES:
        _MACHINES[tag] = (jens.compile_decision_machine(tag),
                          tens.compile_decision_machine(tag))
    return _MACHINES[tag]


def _tables(tag):
    if tag not in _TABLES:
        jdm, tdm = _dm(tag)
        _TABLES[tag] = (jth.sigma_spec_tables(jdm),
                        thermo.sigma_spec_tables(tdm))
    return _TABLES[tag]


@pytest.fixture(scope="module")
def ex2_dm():
    return _dm(EX2)[1]


@pytest.fixture(scope="module")
def ex2_tables():
    return _tables(EX2)[1]


@pytest.fixture(scope="module")
def ex2_master_L8():
    return tmaster.build_ring_generator(EX2, 8)


def _window_marginals(p, dm, L, a, tables):
    """Site-averaged combined-window marginals of a master state
    (dummy program digits uniform: ex2 never reads its program tape)."""
    digits = tmaster._ring_digits(L, a)
    pw = np.zeros(tables.num_windows)
    for i in range(L):
        wr = np.zeros(a**L, dtype=np.int64)
        for off in range(dm.d_lo, dm.d_lo + dm.n_d):
            wr = wr * a + digits[:, (i + off) % L]
        for pd in range(a**dm.n_p):
            np.add.at(pw, pd * (a**dm.n_d) + wr, p / (a**dm.n_p))
    return pw / L


# --- Host tables and rate functionals --------------------------------------


@pytest.mark.parametrize("tag", [EX2, EX3])
def test_tables_match_jax(tag):
    """`outcome_rate_maps`, `sigma_spec_tables` and the write-spec
    decode equal the JAX package's exactly (every rate map, every
    sigma bit, every irrev flag)."""
    jdm, tdm = _dm(tag)
    jt, tt = _tables(tag)
    assert tt.rates == jt.rates
    assert thermo.outcome_rate_maps(tdm) == jt.rates
    np.testing.assert_array_equal(tt.sigma, jt.sigma)
    np.testing.assert_array_equal(tt.irrev, jt.irrev)
    assert (tt.tag, tt.size_a, tt.n_cells, tt.num_windows) == (
        jt.tag, jt.size_a, jt.n_cells, jt.num_windows)
    for got, want in zip(thermo._machine_write_specs(tdm),
                         jth._machine_write_specs(jdm)):
        np.testing.assert_array_equal(got, want)
    back = thermo.thermo_tables_from_jax(jt)
    assert back.rates == tt.rates
    np.testing.assert_array_equal(back.sigma, tt.sigma)
    np.testing.assert_array_equal(back.irrev, tt.irrev)
    for w in (0, 5, tdm.size_a**tdm.n_cells - 1):
        assert thermo._decode_rank(w, tdm.n_cells, tdm.size_a) == \
            jth._decode_rank(w, tdm.n_cells, tdm.size_a)


def test_max_windows_refused():
    _, tdm = _dm(EX2)
    with pytest.raises(ValueError, match="exceeds max_windows"):
        thermo.outcome_rate_maps(tdm, max_windows=8)


@pytest.mark.parametrize("tag", [EX2, EX3])
def test_rate_functionals_match_jax(tag):
    """The rate functionals on the same inputs: window-marginal and SPD
    rates (single and dual SPDs, cl_k 2 and 4: the Markov extension
    and the marginal branches), rtol 1e-12."""
    jdm, tdm = _dm(tag)
    jt, tt = _tables(tag)
    rng = np.random.RandomState(11)
    pw = rng.dirichlet(np.ones(tt.num_windows))
    got = thermo.medium_entropy_rate_from_window_probs(pw, tt)
    want = jth.medium_entropy_rate_from_window_probs(pw, jt)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    a = tdm.size_a
    for cl_k in (2, 4):
        spd = rng.dirichlet(np.ones(a**cl_k))
        spd_p = rng.dirichlet(np.ones(a**cl_k))
        for kw in ({}, {"spd_prog": spd_p}):
            np.testing.assert_allclose(
                thermo.window_probs_from_spd(spd, tdm, **kw),
                jth.window_probs_from_spd(spd, jdm, **kw),
                rtol=1e-12, atol=1e-300)
            np.testing.assert_allclose(
                thermo.medium_entropy_rate_spd(spd, tdm, tt, **kw),
                jth.medium_entropy_rate_spd(spd, jdm, jt, **kw),
                rtol=1e-12, atol=1e-300)


def test_master_rates_match_jax(ex2_master_L8):
    """`master_entropy_rates`, `relative_entropy` and
    `relative_entropy_rate` on the ring generator at L=8, rtol 1e-12."""
    Q = ex2_master_L8
    Qj = jmaster.build_ring_generator(EX2, 8)
    gibbs = tmaster.ring_gibbs_states(8, J_eff=2 * J, h=H, beta=BETA)
    p = np.random.RandomState(9).dirichlet(np.ones(2**8))
    np.testing.assert_allclose(thermo.master_entropy_rates(Q, p),
                               jth.master_entropy_rates(Qj, p),
                               rtol=1e-12)
    np.testing.assert_allclose(thermo.relative_entropy(p, gibbs),
                               jth.relative_entropy(p, gibbs), rtol=1e-12)
    np.testing.assert_allclose(thermo.relative_entropy_rate(Q, p, gibbs),
                               jth.relative_entropy_rate(Qj, p, gibbs),
                               rtol=1e-12)


# --- Rounds fed the JAX runs' own draws ----------------------------------------


def _jax_draws(key, n, B, L, E, independent):
    """The shifts and uniforms `ops/thermo.py:384-397` draws."""
    shifts, uniforms = [], []
    for k in jax.random.split(key, n):
        k1, k2 = jax.random.split(k)
        uniforms.append(np.asarray(jax.random.uniform(k2, (B, E),
                                                      jnp.float32)))
        shape = (B,) if independent else ()
        shifts.append(np.asarray(jax.random.randint(
            k1, shape, 0, L, dtype=jnp.int32)))
    return np.stack(shifts), np.stack(uniforms)


def _assert_sums(got, want, E):
    """Sigma and spec_sig: bit for bit at E = 1, else rtol and atol
    1e-12 (XLA's reduction order is its own)."""
    got, want = np.asarray(got), np.asarray(want)
    if E == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _start(tag, B, L, seed):
    _, tdm = _dm(tag)
    rng = np.random.RandomState(seed)
    if tag == EX4V2:  # fuel on the program lane, cursors and bits on data
        pt = rng.choice([6, 7, 8, 9], (B, L), p=[0.4, 0.3, 0.2, 0.1])
        dt = rng.choice(6, (B, L), p=[0.1, 0.1, 0.1, 0.1, 0.3, 0.3])
    elif tag == EX3:  # isolated monomers in solvent, as ex3 starts
        pt = rng.choice(4, (B, L), p=[0.7, 0.1, 0.1, 0.1])
        dt = rng.choice(4, (B, L), p=[0.6, 0.2, 0.1, 0.1])
    else:
        pt = rng.randint(0, tdm.size_a, (B, L))
        dt = rng.randint(0, tdm.size_a, (B, L))
    return pt.astype(np.int32), dt.astype(np.int32)


@pytest.mark.parametrize("tag", [EX2, EX3])
@pytest.mark.parametrize("independent", [False, True])
@pytest.mark.parametrize("E", [1, 4])
def test_sigma_run_matches_jax_draws(tag, independent, E):
    """`run_ensemble_sigma_from_draws` fed the draws of JAX
    `run_ensemble_sigma`: the same tapes, n_irrev and times, sigma as
    stated (ex3's channels are irreversible: n_irrev > 0, sigma 0)."""
    jdm, tdm = _dm(tag)
    jt, tt = _tables(tag)
    B, L, n = 64, 64, 12 if tag == EX2 else 40
    pt, dt = _start(tag, B, L, 1)
    key = jax.random.PRNGKey(3 + E)
    (jp, jd), js, jn, jtimes = jth.run_ensemble_sigma(
        key, (jnp.asarray(pt), jnp.asarray(dt)), jdm, jth.device_tables(jt),
        (n, E), independent_sites=independent)
    shifts, u = _jax_draws(key, n, B, L, E, independent)
    tdev = thermo.device_tables(tt, device="cpu")
    (tp, td), ts, tn, ttimes = thermo.run_ensemble_sigma_from_draws(
        (pt, dt), tdm, tdev, shifts, E, u, device="cpu")
    assert tp.dtype == torch.int32 and ts.dtype == torch.float64
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(ttimes.numpy(), np.asarray(jtimes),
                               rtol=1e-15)
    _assert_sums(ts.numpy(), js, E)
    if tag == EX3:
        assert int(tn.sum()) > 0 and not ts.any()
    else:
        assert int(tn.sum()) == 0 and ts.abs().max() > 0


@pytest.mark.parametrize("tag", [EX4V2, EX2])
@pytest.mark.parametrize("independent", [False, True])
@pytest.mark.parametrize("E", [1, 4])
def test_ledger_run_matches_jax_draws(tag, independent, E):
    """`run_ensemble_ledger_from_draws` fed the draws of JAX
    `run_ensemble_ledger` with ex4var2's G at beta_eff 2 (on ex2 a
    landscape that is not a detailed-balance one): the same tapes and
    spec counts, sigma and spec_sig as stated."""
    jdm, tdm = _dm(tag)
    a = tdm.size_a
    g = G_VEC if tag == EX4V2 else np.array([0.3, -0.7])
    gd = g if tag == EX4V2 else np.array([-1.1, 0.45])
    B, L, n = 64, 64, 12
    pt, dt = _start(tag, B, L, 2)
    key = jax.random.PRNGKey(7 + E)
    (jp, jd), js, (jc, jss), jtimes = jth.run_ensemble_ledger(
        key, (jnp.asarray(pt), jnp.asarray(dt)), jdm,
        (jnp.asarray(g), jnp.asarray(gd), 2.0), (n, E),
        independent_sites=independent)
    shifts, u = _jax_draws(key, n, B, L, E, independent)
    (tp, td), ts, (tc, tss), ttimes = thermo.run_ensemble_ledger_from_draws(
        (pt, dt), tdm, (g, gd, 2.0), shifts, E, u, device="cpu")
    assert g.shape == (a,)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int32 and int(tc.sum()) == B * n * E
    np.testing.assert_allclose(ttimes.numpy(), np.asarray(jtimes),
                               rtol=1e-15)
    _assert_sums(ts.numpy(), js, E)
    _assert_sums(tss.numpy(), jss, E)
    assert ts.abs().max() > 0


@pytest.mark.parametrize("kind", ["sigma", "ledger"])
def test_out_of_range_symbols_match_jax(kind):
    """Symbols outside [0, size_a) (negative and too large) walk as the
    reference walks them, and the table and G reads take the
    reference's gather rule (a negative index plus the size, then
    clamped): tapes, sigma, n_irrev, counts and spec_sig equal."""
    tag = EX2 if kind == "sigma" else EX4V2
    jdm, tdm = _dm(tag)
    B, L, n, E = 64, 64, 6, 1
    rng = np.random.RandomState(12)
    pt, dt = _start(tag, B, L, 12)
    a = tdm.size_a
    for t in (pt, dt):
        odd = rng.rand(B, L) < 0.15
        t[odd] = rng.randint(-3, a + 3, int(odd.sum()))
    key = jax.random.PRNGKey(21)
    shifts, u = _jax_draws(key, n, B, L, E, False)
    if kind == "sigma":
        jt, tt = _tables(tag)
        jout = jth.run_ensemble_sigma(
            key, (jnp.asarray(pt), jnp.asarray(dt)), jdm,
            jth.device_tables(jt), (n, E))
        tout = thermo.run_ensemble_sigma_from_draws(
            (pt, dt), tdm, thermo.device_tables(tt, device="cpu"), shifts,
            E, u, device="cpu")
        pairs = [(tout[1], jout[1]), (tout[2], jout[2])]
    else:
        g = (G_VEC, G_VEC[::-1].copy(), 2.0)
        jout = jth.run_ensemble_ledger(
            key, (jnp.asarray(pt), jnp.asarray(dt)), jdm,
            tuple(jnp.asarray(x) for x in g[:2]) + (2.0,), (n, E))
        tout = thermo.run_ensemble_ledger_from_draws(
            (pt, dt), tdm, g, shifts, E, u, device="cpu")
        pairs = [(tout[1], jout[1]), (tout[2][0], jout[2][0]),
                 (tout[2][1], jout[2][1])]
    pairs += [(tout[0][0], jout[0][0]), (tout[0][1], jout[0][1])]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tape_potential_matches_jax():
    rng = np.random.RandomState(4)
    pt = rng.randint(0, 10, (16, 40)).astype(np.int32)
    dt = rng.randint(0, 10, (16, 40)).astype(np.int32)
    got = thermo.tape_potential(torch.as_tensor(pt), torch.as_tensor(dt),
                                G_VEC, G_VEC[::-1].copy(), 2.0)
    want = jth.tape_potential(jnp.asarray(pt), jnp.asarray(dt), G_VEC,
                              G_VEC[::-1].copy(), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=1e-12)


# --- The runs on the port's generator ---------------------------------------


@pytest.mark.parametrize("independent", [False, True])
def test_run_draws_then_replays_from_draws(independent):
    """`run_ensemble_sigma` and `run_ensemble_ledger` draw all shifts at
    once over [0, L) (int32), then each round's float32 [B, E] uniforms:
    the same stream replayed into the from-draws forms gives the same
    results, an int seed the generator's; every round ran the plain
    version on the CPU and no kernel launched."""
    _, tdm = _dm(EX2)
    _, tt = _tables(EX2)
    tdev = thermo.device_tables(tt, device="cpu")
    B, L, n, E = 32, 24, 7, 3
    pt, dt = _start(EX2, B, L, 5)
    calls = thermo.sigma_round_plain.calls
    launches = thermo.sigma_round.launches
    out = thermo.run_ensemble_sigma(11, (pt, dt), tdm, tdev, (n, E),
                                    independent_sites=independent,
                                    device="cpu")
    assert thermo.sigma_round_plain.calls == calls + n
    assert thermo.sigma_round.launches == launches
    gen = torch.Generator().manual_seed(11)
    shape = (n, B) if independent else (n,)
    shifts = torch.randint(0, L, shape, generator=gen, dtype=torch.int32)
    u = torch.stack([torch.rand((B, E), generator=gen, dtype=torch.float32)
                     for _ in range(n)])
    again = thermo.run_ensemble_sigma_from_draws((pt, dt), tdm, tdev, shifts,
                                                 E, u, device="cpu")
    for x, y in zip((*out[0], *out[1:]), (*again[0], *again[1:])):
        assert torch.equal(x, y)
    led = thermo.run_ensemble_ledger(torch.Generator().manual_seed(11),
                                     (pt, dt), tdm, (np.array([0.5, -0.5]),
                                                     np.zeros(2), 2.0),
                                     (n, E), independent_sites=independent,
                                     device="cpu")
    assert torch.equal(led[0][0], out[0][0])
    assert torch.equal(led[0][1], out[0][1])


def test_runs_draw_the_same_whatever_the_chunk(monkeypatch):
    """`run_ensemble` with a table (its draws in chunks of
    `ensemble._TABLE_CHUNK` uniforms, K10's resident calls) and
    `run_ensemble_sigma` (`ensemble._RESIDENT_CHUNK`, K23's) give the same
    tapes, sigma and n_irrev at one seed whatever the chunk: a round a
    chunk, three rounds, and every round in one."""
    _, tdm = _dm(EX2)
    _, tt = _tables(EX2)
    tdev = thermo.device_tables(tt, device="cpu")
    tdt = tens.device_table(tens.compile_transition_table(EX2),
                            device="cpu")
    B, L, n, E = 8, 32, 10, 4
    pt, dt = _start(EX2, B, L, 7)
    runs = []
    for rounds in (1, 3, n):
        monkeypatch.setattr(tens, "_TABLE_CHUNK", rounds * B * E)
        monkeypatch.setattr(tens, "_RESIDENT_CHUNK", rounds * B * E)
        (tp, td), _ = tens.run_ensemble(5, (pt, dt), tdt, (n, E),
                                        independent_sites=True,
                                        device="cpu")
        (sp, sd), sigma, nirr, _ = thermo.run_ensemble_sigma(
            5, (pt, dt), tdm, tdev, (n, E), device="cpu")
        runs.append((tp, td, sp, sd, sigma, nirr))
    for run in runs[1:]:
        for x, y in zip(run, runs[0]):
            assert torch.equal(x, y)
    assert (runs[0][1] != torch.as_tensor(dt)).any()
    assert (runs[0][3] != torch.as_tensor(dt)).any()
    assert runs[0][4].abs().sum() > 0


def test_runs_check_their_inputs():
    """Bad tables, potentials, accumulators and uniforms raise; an entry
    point without ``device`` runs on ``cuda``, which raises without a
    card (nothing falls back to the CPU)."""
    _, tdm = _dm(EX2)
    _, tt = _tables(EX2)
    tdev = thermo.device_tables(tt, device="cpu")
    pt, dt = _start(EX2, 8, 12, 0)
    with pytest.raises(ValueError, match="tables must be"):
        thermo.run_ensemble_sigma(0, (pt, dt), tdm, (tdev[0][:3], tdev[1]),
                                  (2, 1), device="cpu")
    with pytest.raises(ValueError, match="potentials"):
        thermo.run_ensemble_ledger(0, (pt, dt), tdm, (np.zeros(3),
                                                      np.zeros(2), 1.0),
                                   (2, 1), device="cpu")
    with pytest.raises(ValueError, match="n_irrev must be"):
        thermo.sigma_round(tdm, torch.as_tensor(pt).to(torch.int8),
                           torch.as_tensor(dt).to(torch.int8), 0, 1,
                           torch.rand(8, 1), tdev,
                           torch.zeros(8, dtype=torch.float64),
                           torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError, match="counts must be"):
        thermo.ledger_round(tdm, torch.as_tensor(pt).to(torch.int8),
                            torch.as_tensor(dt).to(torch.int8), 0, 1,
                            torch.rand(8, 1), (np.zeros(2), np.zeros(2), 1.0),
                            torch.zeros(8, dtype=torch.float64),
                            torch.zeros((8, 2), dtype=torch.int32),
                            torch.zeros((8, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="uniforms"):
        thermo.run_ensemble_sigma_from_draws(
            (pt, dt), tdm, tdev, np.zeros(2, np.int32), 1,
            np.zeros((2, 8, 1), np.float64), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            thermo.run_ensemble_sigma(0, (pt, dt), tdm, tdev, (2, 1))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            thermo.device_tables(tt)


# --- K23 and K24: the generated unit's host rounds -------------------------------


_UNITS = {}


def _unit(tag, tmp_path_factory):
    cxx = next((c for c in ("g++", "c++", "clang++") if shutil.which(c)),
               None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    if tag not in _UNITS:
        _, tdm = _dm(tag)
        d = tmp_path_factory.mktemp("thermo_unit")
        unit = d / "unit.cpp"
        unit.write_text(k1_source.k1_source(tdm))
        lib = d / "librule.so"
        subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1",
                        "-ffp-contract=off", "-shared", "-fPIC", "-I",
                        str(cuda.CSRC_DIR), "-o", str(lib), str(unit)],
                       check=True, capture_output=True, timeout=300)
        _UNITS[tag] = ctypes.CDLL(str(lib))
    return _UNITS[tag]


_P, _I = ctypes.c_void_p, ctypes.c_int


def _round_inputs(tag, B, L, E, per_member, seed):
    """Tapes with a tenth of their cells outside [0, size_a), shifts past
    L and below 0, uniforms."""
    _, tdm = _dm(tag)
    rng = np.random.RandomState(seed)
    tapes = _start(tag, B, L, seed)
    for t in tapes:
        odd = rng.rand(B, L) < 0.1
        t[odd] = rng.randint(-3, tdm.size_a + 3, int(odd.sum()))
    pt, dt = (torch.as_tensor(x).to(torch.int8) for x in tapes)
    shifts = torch.as_tensor(rng.randint(-2 * L, 3 * L,
                                         B if per_member else 1),
                             dtype=torch.int32)
    u = torch.as_tensor(rng.rand(B, E).astype(np.float32))
    return tdm, pt, dt, shifts, u


@pytest.mark.parametrize("tag", [EX2, EX3])
@pytest.mark.parametrize("per_member", [False, True])
@pytest.mark.parametrize("E", [1, 4])
def test_generated_sigma_round_matches_plain(tag, per_member, E,
                                             tmp_path_factory):
    """K23's per-member body (`ckpe_k23_host_round`, the generated unit
    built with the host's compiler) equals `sigma_round_plain`: tapes,
    sigma and n_irrev bit for bit, over shifts past L and below 0 and
    symbols outside [0, size_a)."""
    lib = _unit(tag, tmp_path_factory)
    _, tt = _tables(tag)
    tdm, pt, dt, shifts, u = _round_inputs(tag, 48, 64, E, per_member, E)
    sig_tab, irr_tab = thermo.device_tables(tt, device="cpu")
    rng = np.random.RandomState(1)
    sigma = torch.as_tensor(rng.randn(48))
    n_irrev = torch.as_tensor(rng.randint(0, 9, 48), dtype=torch.int32)
    want = [x.clone() for x in (pt, dt, sigma, n_irrev)]
    for _ in range(3):
        thermo.sigma_round_plain(tdm, want[0], want[1], shifts, E, u,
                                 (sig_tab, irr_tab), want[2], want[3])
    fn = lib.ckpe_k23_host_round
    fn.argtypes = [_P] * 4 + [_I] * 4 + [_P, _P, _I, _P, _P]
    for _ in range(3):
        assert fn(pt.data_ptr(), dt.data_ptr(), u.data_ptr(),
                  shifts.data_ptr(), int(per_member), 48, 64, E,
                  sig_tab.data_ptr(), irr_tab.data_ptr(), tdm.num_specs,
                  sigma.data_ptr(), n_irrev.data_ptr()) == 0
    for got, w in zip((pt, dt, sigma, n_irrev), want):
        assert torch.equal(got, w)
    if E > 1:  # ex3 fires rarely: at E = 1 three rounds may change nothing
        start = _round_inputs(tag, 48, 64, E, per_member, E)
        assert not (torch.equal(pt, start[1]) and torch.equal(dt, start[2]))


@pytest.mark.parametrize("tag", [EX4V2, EX2])
@pytest.mark.parametrize("per_member", [False, True])
@pytest.mark.parametrize("E", [1, 4])
def test_generated_ledger_round_matches_plain(tag, per_member, E,
                                              tmp_path_factory):
    """K24's per-member body (`ckpe_k24_host_round`) equals
    `ledger_round_plain`: tapes, sigma, counts and spec_sig bit for
    bit."""
    lib = _unit(tag, tmp_path_factory)
    B, L = 48, 64
    tdm, pt, dt, shifts, u = _round_inputs(tag, B, L, E, per_member, 2 + E)
    rng = np.random.RandomState(2)
    gp = torch.as_tensor(rng.randn(tdm.size_a))
    gd = torch.as_tensor(rng.randn(tdm.size_a))
    S = tdm.num_specs
    sigma = torch.as_tensor(rng.randn(B))
    counts = torch.as_tensor(rng.randint(0, 9, (B, S)), dtype=torch.int32)
    spec_sig = torch.as_tensor(rng.randn(B, S))
    want = [x.clone() for x in (pt, dt, sigma, counts, spec_sig)]
    for _ in range(3):
        thermo.ledger_round_plain(tdm, want[0], want[1], shifts, E, u,
                                  (gp, gd, 1.7), *want[2:])
    fn = lib.ckpe_k24_host_round
    fn.argtypes = [_P] * 4 + [_I] * 4 + [_P, _P, ctypes.c_double, _I, _P,
                                         _P, _P]
    for _ in range(3):
        assert fn(pt.data_ptr(), dt.data_ptr(), u.data_ptr(),
                  shifts.data_ptr(), int(per_member), B, L, E,
                  gp.data_ptr(), gd.data_ptr(), 1.7, S, sigma.data_ptr(),
                  counts.data_ptr(), spec_sig.data_ptr()) == 0
    for got, w in zip((pt, dt, sigma, counts, spec_sig), want):
        assert torch.equal(got, w)
    assert int(counts.sum() - want[3].sum()) == 0


@pytest.mark.parametrize("tag,L,E,tile,threads,n,k0,per_member", [
    (EX4V2, 64, 4, 5, 7, 6, 2, False),
    (EX4V2, 64, 4, 3, 64, 4, 0, True),
    (EX4V2, 60, 5, 4, 9, 5, 1, True),
    (EX4V2, 72, 6, 13, 32, 1, 0, False),
    (EX2, 64, 8, 4, 3, 4, 3, False),
    (EX2, 64, 1, 6, 5, 7, 0, True)])
def test_resident_ledger_rounds_match_plain(tag, L, E, tile, threads, n, k0,
                                            per_member, tmp_path_factory):
    """K24's resident rounds as their host twin runs them
    (`csrc/thermo_round.cuh:ckpe_k24_host_resident`: rows and
    accumulators loaded into the tile's buffer, each round's walk staging
    its sites' increments and specs, then the ordered sums, a thread a
    member's sigma and a thread a (member, spec), all written back once,
    tile after tile) equal n rounds of `ledger_round_plain`: tapes,
    sigma, counts and spec_sig bit for bit onto nonzero starting values;
    tiles that split B unevenly, fewer threads than a phase's items, n =
    1 and n >= 4, a call from k0 > 0, shared and per-member shifts past L
    and below 0, four sites a thread by the lane walk (E a multiple of 4)
    and a site a thread (E = 1, 5, 6), a tenth of the cells outside [0,
    size_a)."""
    lib = _unit(tag, tmp_path_factory)
    _, tdm = _dm(tag)
    B, S = 13, tdm.num_specs
    rng = np.random.RandomState(L + E + n)
    pt, dt = _start(tag, B, L, L + E)
    for t in (pt, dt):
        odd = rng.rand(B, L) < 0.1
        t[odd] = rng.randint(-3, tdm.size_a + 3, int(odd.sum()))
    pt, dt = pt.astype(np.int8), dt.astype(np.int8)
    shape = (k0 + n, B) if per_member else (k0 + n,)
    shifts = rng.randint(-2 * L, 3 * L, shape).astype(np.int32)
    u = rng.rand(n, B, E).astype(np.float32)
    gp, gd = rng.randn(tdm.size_a), rng.randn(tdm.size_a)
    accs = [rng.randn(B), rng.randint(0, 9, (B, S)).astype(np.int32),
            rng.randn(B, S)]
    got = [pt.copy(), dt.copy()] + [a.copy() for a in accs]
    fn = lib.ckpe_k24_host_resident
    fn.argtypes = [_P] * 4 + [_I] * 6 + [_P, _P, ctypes.c_double, _I, _P,
                                         _P, _P, _I, _I]
    fn.restype = _I
    assert fn(*(x.ctypes.data for x in (*got[:2], u, shifts)),
              int(per_member), k0, n, B, L, E, gp.ctypes.data, gd.ctypes.data,
              1.7, S, *(x.ctypes.data for x in got[2:]), tile, threads) == 0
    want = [torch.as_tensor(x.copy()) for x in [pt, dt] + accs]
    for j in range(n):
        thermo.ledger_round_plain(tdm, want[0], want[1],
                                  torch.as_tensor(shifts[k0 + j]), E,
                                  torch.as_tensor(u[j]),
                                  (torch.as_tensor(gp), torch.as_tensor(gd),
                                   1.7), *want[2:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert int(got[3].sum() - accs[1].sum()) == B * E * n
    assert (got[2] != accs[0]).any() and (got[4] != accs[2]).any()


@pytest.mark.parametrize("tag,L,E,tile,threads,n,k0,per_member,stage", [
    (EX2, 64, 4, 5, 7, 6, 2, False, True),
    (EX2, 64, 4, 3, 64, 4, 0, True, False),
    (EX2, 60, 5, 4, 9, 5, 1, True, True),
    (EX2, 64, 1, 6, 5, 1, 0, False, True),
    (EX3, 72, 6, 13, 32, 4, 3, False, False),
    (EX3, 64, 8, 4, 3, 7, 0, True, True)])
def test_resident_sigma_rounds_match_plain(tag, L, E, tile, threads, n, k0,
                                           per_member, stage,
                                           tmp_path_factory):
    """K23's resident rounds as their host twin runs them
    (`csrc/thermo_round.cuh:ckpe_k23_host_resident`: rows, sigma and
    n_irrev loaded into the tile's buffer, the tables staged there or
    read where they lie, each round's walk staging its sites' entries
    and flags, then a thread a member's sum and count, all written back
    once, tile after tile) equal n rounds of `sigma_round_plain`: tapes,
    sigma and n_irrev bit for bit onto nonzero starting values; tiles
    that split B unevenly, fewer threads than a phase's items, n = 1 and
    n >= 4, a call from k0 > 0, shared and per-member shifts past L and
    below 0, four sites a thread by the lane walk (E a multiple of 4) and
    a site a thread (E = 1, 5, 6), a tenth of the cells outside [0,
    size_a), random tables with a fifth of their entries irreversible."""
    lib = _unit(tag, tmp_path_factory)
    _, tdm = _dm(tag)
    B = 13
    rng = np.random.RandomState(L + E + n)
    # Random entries (a fifth irreversible), so that every site's entry
    # is inexact and the sums' order shows in the bits.
    shape = (tdm.size_a**tdm.n_cells, tdm.num_specs)
    sig_tab = torch.as_tensor(rng.randn(*shape))
    irr_tab = torch.as_tensor(rng.rand(*shape) < 0.2)
    pt, dt = _start(tag, B, L, L + E)
    for t in (pt, dt):
        odd = rng.rand(B, L) < 0.1
        t[odd] = rng.randint(-3, tdm.size_a + 3, int(odd.sum()))
    pt, dt = pt.astype(np.int8), dt.astype(np.int8)
    shape = (k0 + n, B) if per_member else (k0 + n,)
    shifts = rng.randint(-2 * L, 3 * L, shape).astype(np.int32)
    u = rng.rand(n, B, E).astype(np.float32)
    accs = [rng.randn(B), rng.randint(0, 9, B).astype(np.int32)]
    got = [pt.copy(), dt.copy()] + [a.copy() for a in accs]
    fn = lib.ckpe_k23_host_resident
    fn.argtypes = [_P] * 4 + [_I] * 6 + [_P, _P, _I, _P, _P, _I, _I, _I]
    fn.restype = _I
    assert fn(*(x.ctypes.data for x in (*got[:2], u, shifts)),
              int(per_member), k0, n, B, L, E, sig_tab.data_ptr(),
              irr_tab.data_ptr(), tdm.num_specs,
              *(x.ctypes.data for x in got[2:]), tile, threads,
              int(stage)) == 0
    want = [torch.as_tensor(x.copy()) for x in [pt, dt] + accs]
    for j in range(n):
        thermo.sigma_round_plain(tdm, want[0], want[1],
                                 torch.as_tensor(shifts[k0 + j]), E,
                                 torch.as_tensor(u[j]), (sig_tab, irr_tab),
                                 *want[2:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert (got[0] != pt).any() or (got[1] != dt).any()
    assert (got[2] != accs[0]).any() and (got[3] != accs[1]).any()


def test_k23_tile_by_geometry():
    """`k23_tile`: phase 13 (a)'s geometry on ex2 fits 10 members a block
    at two blocks an SM and keeps 8, the walk's whole passes of 512
    threads, with ex2's 16 x 3 tables staged; (b)'s spreads B over the
    SMs; tables past `K23_STAGED_TABLE_BYTES` stay in global memory; rows
    past a block's shared memory take the launch a round."""
    per = 2 * 4100 + 8 * (1 + 257) + 4 + 4 * 65
    assert thermo.k23_tile(16384, 4096, 256, 3, 16) == (
        8, 512, 8 * per + 9 * 48, True)
    assert thermo.k23_tile(8192, 12, 1, 3, 16)[:2] == (32, 256)
    big = thermo.K23_STAGED_TABLE_BYTES // 9 + 1
    assert thermo.k23_tile(16384, 4096, 256, 1, big) == (8, 512, 8 * per,
                                                         False)
    assert thermo.k23_tile(8, 131_072, 4, 3, 16) is None


def test_k24_tile_by_geometry():
    """`k24_tile`: phase 13 (a)'s geometry on ex4var2 fits 10 members a
    block at two blocks an SM and keeps 8, the walk's whole passes of 512
    threads; at E = 1 13; (c)'s spreads B over the SMs; rows past a
    block's shared memory take the launch a round."""
    S = _dm(EX4V2)[1].num_specs
    per = 2 * 4100 + 8 * (1 + S + 257) + 4 * S + 4 * 65
    assert thermo.k24_tile(16384, 4096, 256, S) == (8, 512, 8 * per + 4096)
    assert thermo.k24_tile(16384, 4096, 1, S)[:2] == (13, 256)
    assert thermo.k24_tile(4096, 128, 4, S)[:2] == (16, 256)
    assert thermo.k24_tile(8, 131_072, 4, S) is None


def test_round_wrappers_run_plain_on_cpu():
    """`sigma_round` and `ledger_round` on CPU tensors run their plain
    versions (one call each, no launch) and equal them."""
    _, tt = _tables(EX2)
    tdm, pt, dt, shifts, u = _round_inputs(EX2, 16, 24, 3, True, 9)
    tabs = thermo.device_tables(tt, device="cpu")
    sig = torch.zeros(16, dtype=torch.float64)
    nirr = torch.zeros(16, dtype=torch.int32)
    ref = [pt.clone(), dt.clone(), sig.clone(), nirr.clone()]
    calls = thermo.sigma_round_plain.calls
    thermo.sigma_round(tdm, pt, dt, shifts, 3, u, tabs, sig, nirr)
    assert thermo.sigma_round_plain.calls == calls + 1
    assert thermo.sigma_round.launches == 0
    thermo.sigma_round_plain(tdm, ref[0], ref[1], shifts, 3, u, tabs,
                             ref[2], ref[3])
    for got, w in zip((pt, dt, sig, nirr), ref):
        assert torch.equal(got, w)
    S = tdm.num_specs
    led = (torch.zeros(16, dtype=torch.float64),
           torch.zeros((16, S), dtype=torch.int32),
           torch.zeros((16, S), dtype=torch.float64))
    ref = [pt.clone(), dt.clone()] + [x.clone() for x in led]
    g = (np.array([0.25, -1.0]), np.array([2.0, 0.5]), 2.0)
    thermo.ledger_round(tdm, pt, dt, 5, 3, u, g, *led)
    thermo.ledger_round_plain(tdm, ref[0], ref[1], 5, 3, u,
                              (torch.as_tensor(g[0]), torch.as_tensor(g[1]),
                               2.0), *ref[2:])
    for got, w in zip((pt, dt, *led), ref):
        assert torch.equal(got, w)
    assert thermo.ledger_round.launches == 0


# --- Twins of tests/test_thermo.py -------------------------------------------------


def test_sigma_table_antisymmetric_and_reversible(ex2_tables):
    t = ex2_tables
    assert not t.irrev.any()
    n_jumps = 0
    for w, r in enumerate(t.rates):
        for w2, fwd in r.items():
            rev = t.rates[w2].get(w, 0.0)
            assert rev > 0.0
            s_fwd = np.log(fwd) - np.log(rev)
            s_rev = np.log(rev) - np.log(fwd)
            assert abs(s_fwd + s_rev) < 1e-14
            n_jumps += 1
    assert n_jumps > 0


def test_ex2_sigma_is_ising_delta_E(ex2_dm, ex2_tables):
    """ln[R(w->w')/R(w'->w)] = -beta (E(w') - E(w)) with the window
    Ising energy at J_eff = 2J."""
    dm, t = ex2_dm, ex2_tables
    a, n = dm.size_a, dm.n_cells

    def energy(dig):
        s = [1.0 if d == 1 else -1.0 for d in dig[dm.n_p:]]
        return -(2 * J) * (s[0] * s[1] + s[1] * s[2]) - H * s[1]

    for w, r in enumerate(t.rates):
        dig = thermo._decode_rank(w, n, a)
        for w2, fwd in r.items():
            dig2 = thermo._decode_rank(w2, n, a)
            lhs = np.log(fwd) - np.log(t.rates[w2][w])
            rhs = -BETA * (energy(dig2) - energy(dig))
            assert abs(lhs - rhs) < 1e-12


def test_master_total_rate_zero_at_gibbs_positive_elsewhere(ex2_master_L8):
    Q = ex2_master_L8
    gibbs = tmaster.ring_gibbs_states(8, J_eff=2 * J, h=H, beta=BETA)
    tot, med = thermo.master_entropy_rates(Q, gibbs)
    assert abs(tot) < 1e-12
    p = np.random.RandomState(0).dirichlet(np.ones(2**8))
    tot, med = thermo.master_entropy_rates(Q, p)
    assert tot > 0.1


def test_master_total_rate_is_minus_dD_dt(ex2_master_L8):
    Q = ex2_master_L8
    gibbs = tmaster.ring_gibbs_states(8, J_eff=2 * J, h=H, beta=BETA)
    p = np.random.RandomState(1).dirichlet(np.ones(2**8))
    tot, _ = thermo.master_entropy_rates(Q, p)
    dt = 1e-6
    pdot = Q @ p
    D_m = thermo.relative_entropy(p - dt * pdot, gibbs)
    D_p = thermo.relative_entropy(p + dt * pdot, gibbs)
    assert abs(tot + (D_p - D_m) / (2 * dt)) < 1e-6 * max(1.0, tot)


def test_closure_expression_matches_master_medium_rate(
        ex2_dm, ex2_tables, ex2_master_L8):
    dm, t, Q = ex2_dm, ex2_tables, ex2_master_L8
    L, a = 8, dm.size_a
    p = np.random.RandomState(2).dirichlet(np.ones(a**L))
    _, med = thermo.master_entropy_rates(Q, p)
    pw = _window_marginals(p, dm, L, a, t)
    rate, irrev_flux = thermo.medium_entropy_rate_from_window_probs(pw, t)
    assert irrev_flux == 0.0
    assert abs(rate * L - med) < 1e-9 * max(1.0, abs(med))


def test_medium_rate_vanishes_at_gibbs_marginals(ex2_dm, ex2_tables):
    dm, t = ex2_dm, ex2_tables
    L, a = 8, dm.size_a
    gibbs = tmaster.ring_gibbs_states(L, J_eff=2 * J, h=H, beta=BETA)
    pw = _window_marginals(gibbs, dm, L, a, t)
    rate, irrev_flux = thermo.medium_entropy_rate_from_window_probs(pw, t)
    assert irrev_flux == 0.0
    assert abs(rate) < 1e-12


def _kernel_iterates(L, a):
    import scipy.sparse as sp

    Q = tmaster.build_ring_generator(EX2, L)
    S = a**L
    return (sp.identity(S) + Q / L).tocsr(), np.full(S, 1.0 / S)


def test_ensemble_sigma_tracks_exact_kernel(ex2_dm, ex2_tables):
    """Sampled cumulative medium entropy (the port's generator) vs the
    exact expectation under the discrete round kernel (I + Q/L),
    6-sigma gate, at the JAX test's sizes."""
    dm, t = ex2_dm, ex2_tables
    tdev = thermo.device_tables(t, device="cpu")
    L, B, rounds, a = 8, 4096, 40, dm.size_a
    gen = torch.Generator().manual_seed(1)
    pt = torch.zeros((B, L), dtype=torch.int32)
    dt_ = torch.randint(0, a, (B, L), generator=gen, dtype=torch.int32)
    (_, dtf), sigma, nirr, _ = thermo.run_ensemble_sigma(
        2, (pt, dt_), dm, tdev, (rounds, 1), independent_sites=True,
        device="cpu")
    sigma = sigma.numpy()
    assert int(nirr.sum()) == 0
    K, p = _kernel_iterates(L, a)
    expected = 0.0
    for _ in range(rounds):
        pw = _window_marginals(p, dm, L, a, t)
        rate, _ = thermo.medium_entropy_rate_from_window_probs(pw, t)
        expected += rate
        p = K @ p
    se = sigma.std() / np.sqrt(B)
    assert abs(sigma.mean() - expected) < 6 * se


def test_integral_fluctuation_theorem(ex2_dm, ex2_tables):
    """<exp(-sigma_tot)> = 1 with sigma_tot = sigma_med + ln p0(x0)
    - ln pT(xT), the port's run at the JAX test's sizes."""
    dm, t = ex2_dm, ex2_tables
    tdev = thermo.device_tables(t, device="cpu")
    L, B, rounds, a = 8, 8192, 40, dm.size_a
    gen = torch.Generator().manual_seed(3)
    pt = torch.zeros((B, L), dtype=torch.int32)
    dt_ = torch.randint(0, a, (B, L), generator=gen, dtype=torch.int32)
    (_, dtf), sigma, _, _ = thermo.run_ensemble_sigma(
        4, (pt, dt_), dm, tdev, (rounds, 1), independent_sites=True,
        device="cpu")
    sigma = sigma.numpy()
    K, p = _kernel_iterates(L, a)
    for _ in range(rounds):
        p = K @ p
    dtf_np = dtf.numpy()
    rank = np.zeros(B, dtype=np.int64)
    for j in range(L):
        rank = rank * a + dtf_np[:, j]
    sig_tot = sigma - L * np.log(a) - np.log(np.maximum(p[rank], 1e-300))
    ift = np.exp(-sig_tot)
    se = ift.std() / np.sqrt(B)
    assert abs(ift.mean() - 1.0) < 6 * se
    assert sig_tot.mean() > 0.0


def test_ex3_channels_reported_irreversible():
    """ex3's polymerization events have no same-site reverse: every
    jump is flagged irreversible, and the runner counts them rather
    than fold a bogus 0 into sigma."""
    _, t = _tables(EX3)
    _, dm = _dm(EX3)
    n_jumps = sum(len(r) for r in t.rates)
    assert n_jumps > 0
    assert int(t.irrev.sum()) > 0
    assert not t.sigma.any()
    pw = np.full(t.num_windows, 1.0 / t.num_windows)
    rate, irrev_flux = thermo.medium_entropy_rate_from_window_probs(pw, t)
    assert rate == 0.0 and irrev_flux > 0.0
    pt, dt = _start(EX3, 256, 64, 8)
    _, sigma, nirr, _ = thermo.run_ensemble_sigma(
        5, (pt, dt), dm, thermo.device_tables(t, device="cpu"), (10, 4),
        device="cpu")
    assert int(nirr.sum()) > 0 and not sigma.any()


def test_master_entropy_rates_raises_on_irreversible_flux():
    Q = tmaster.build_ring_generator("ex1-radioactive-decay", 5)
    p = np.random.RandomState(3).dirichlet(np.ones(2**5))
    with pytest.raises(ValueError):
        thermo.master_entropy_rates(Q, p)


def _ex4v2_outcomes(wp, wd):
    problem = dsl.get_problem(EX4V2)
    sym = {s: i for i, s in enumerate(problem.symbols)}
    outs, _, _ = tmaster.enumerate_pair_outcomes(
        problem, {k: sym[v] for k, v in wp.items()},
        {k: sym[v] for k, v in wd.items()})
    res = []
    for prob, wrp, wrd in outs:
        if prob <= 0:
            continue
        res.append((prob,
                    {k: problem.symbols[v] for k, v in wrp.items()},
                    {k: problem.symbols[v] for k, v in wrd.items()}))
    return res


def _rate_of(outs, wrp_want, wrd_want):
    return sum(p for p, wrp, wrd in outs
               if wrp == wrp_want and wrd == wrd_want)


def test_ex4var2_channel_affinities():
    """Every reaction channel of ex4var2 satisfies exact local detailed
    balance against 2*beta*G, outcome-resolved, in the port's rule and
    pair enumerator."""
    G, beta = _EX4V2_G, _EX4V2_BETA
    n_checked = 0

    def affinity(r_f, r_b, species_dG):
        assert r_f > 0 and r_b > 0
        lhs = np.log(r_f) - np.log(r_b)
        assert abs(lhs + 2 * beta * species_dG) < 1e-10, (
            lhs, -2 * beta * species_dG)

    for cur, nxt, bit in (("A", "B", "I"), ("B", "C", "O"),
                          ("C", "D", "I")):
        for b1 in "IO":
            for b2 in "IO":
                fw = _ex4v2_outcomes({0: "P"}, {0: cur, 1: b1, 2: b2})
                r_f = _rate_of(fw, {0: "X"}, {0: bit, 1: nxt})
                rv = _ex4v2_outcomes({0: "X"}, {0: nxt, -1: bit, -2: b2})
                r_b = _rate_of(rv, {0: "P"}, {0: b1, -1: cur})
                dG = ((G["X"] - G["P"]) + (G[bit] - G[cur])
                      + (G[nxt] - G[b1]))
                affinity(r_f, r_b, dG)
                n_checked += 1
    for cur in ("A", "D"):
        for bit in "IO":
            for b1 in "IO":
                fw = _ex4v2_outcomes({0: "S"}, {0: cur, 1: b1, -1: b1})
                r_f = _rate_of(fw, {0: "E"}, {0: bit})
                rv = _ex4v2_outcomes({0: "E"}, {0: bit, 1: b1, -1: b1})
                r_b = _rate_of(rv, {0: "S"}, {0: cur})
                dG = (G["E"] - G["S"]) + (G[bit] - G[cur])
                affinity(r_f, r_b, dG)
                n_checked += 1
    assert n_checked == 20


def test_ex4var2_ledger_bookkeeping_identity():
    """The port's ledger: cumulative sigma equals Phi(0) - Phi(T) a
    member, the spec counts account for every event, the per-spec
    decomposition re-sums to the total (the JAX test's sizes, the
    port's generator)."""
    _, dm = _dm(EX4V2)
    beta_eff = 2.0 * _EX4V2_BETA
    B, L, rounds, E = 256, 64, 20, 2
    gen = torch.Generator().manual_seed(5)
    ptape = torch.tensor([6, 7, 8, 9])[torch.multinomial(
        torch.tensor([0.4, 0.3, 0.2, 0.1]), B * L, True,
        generator=gen)].reshape(B, L)
    dtape = torch.multinomial(torch.tensor([0.1, 0.1, 0.1, 0.1, 0.3, 0.3]),
                              B * L, True, generator=gen).reshape(B, L)
    phi0 = thermo.tape_potential(ptape, dtape, G_VEC, G_VEC, beta_eff)
    (pt, dt_), sigma, (counts, spec_sig), _ = thermo.run_ensemble_ledger(
        gen, (ptape, dtape), dm, (G_VEC, G_VEC, beta_eff), (rounds, E),
        device="cpu")
    phiT = thermo.tape_potential(pt, dt_, G_VEC, G_VEC, beta_eff)
    np.testing.assert_allclose(sigma.numpy(), (phi0 - phiT).numpy(),
                               rtol=0, atol=1e-9)
    assert (counts.sum(dim=1) == rounds * E).all()
    assert float(sigma.sum()) != 0.0
    np.testing.assert_allclose(spec_sig.sum(dim=1).numpy(), sigma.numpy(),
                               rtol=0, atol=1e-9)


def _gibbs_product(cl_k):
    w = np.exp(-2.0 * _EX4V2_BETA * G_VEC)
    p1 = w / w.sum()
    spd = p1.copy()
    for _ in range(cl_k - 1):
        spd = np.multiply.outer(spd, p1)
    return spd.ravel()


def test_ex4var2_gibbs_product_is_stationary():
    """The iid Boltzmann product at beta_eff = 2 beta is stationary
    under the port's dual closure (the dense dual RHS, plain versions on
    the CPU), and visibly not at uniform."""
    cl_k = 3
    spd = _gibbs_product(cl_k)
    dual = tdense.compile_dense_dual(EX4V2, cl_k)
    fn = tdense.make_dense_dy_dt(dual, jit=False, device="cpu")
    dy = fn(np.concatenate([spd, spd])).numpy()
    assert np.abs(dy).max() < 1e-8
    u = np.full(spd.size, 1.0 / spd.size)
    assert np.abs(fn(np.concatenate([u, u])).numpy()).max() > 1e-5


def test_ex4var2_ledger_artifacts_claims():
    """The committed ex4var2_ledger.npz supports the claims (exact
    bookkeeping, monotone free energy, the 12-nat strokes), and the
    port recomputes its dual panel from the committed trajectory
    (examples/ex4var2_ledger_dual.npz): F(t) and the heat within 1e-12
    of the artifact, the Gibbs residual through its own RHS."""
    path = os.path.join(EXAMPLES, "ex4var2_ledger.npz")
    dual_path = os.path.join(EXAMPLES, "ex4var2_ledger_dual.npz")
    if not (os.path.exists(path) and os.path.exists(dual_path)):
        pytest.skip("run examples/ex4var2_ledger.py first")
    d = np.load(path)
    assert float(d["book_err"]) < 1e-8
    assert float(d["decomp_err"]) < 1e-8
    assert float(d["gibbs_res"]) < 1e-8
    F = np.asarray(d["F_dual"])
    assert (np.diff(F) <= 1e-9).all()
    assert F[-1] >= float(d["F_gibbs"]) - 1e-9
    sigma_spec, fired = np.asarray(d["sigma_spec"]), np.asarray(d["fired"])
    counts = np.asarray(d["counts_total"])
    adv = np.asarray(d["advance"]) & fired
    assert adv.any() and counts[adv].sum() > 0
    assert all(min(abs(s - 12.0), abs(s - 7.0)) < 1e-9
               for s in sigma_spec[adv])
    heat, dS = np.asarray(d["heat_dual"]), np.asarray(d["dS_dual"])
    assert heat[-1] > 0 and heat[-1] > dS[-1]
    # The dual panel recomputed by the port from the committed solve.
    cl_k, a = 3, 10
    ys = np.load(dual_path)["ode_ys"]
    half = a**cl_k

    def mean_g(spd):
        marg = spd.reshape((a,) * cl_k).sum(axis=(1, 2))
        return float(marg @ G_VEC)

    def entropy(spd):
        return float(markov.markov_entropy(spd.reshape((a,) * cl_k)))

    gsum = np.array([mean_g(y[:half]) + mean_g(y[half:]) for y in ys])
    s_sum = np.array([entropy(y[:half]) + entropy(y[half:]) for y in ys])
    np.testing.assert_allclose(2.0 * (gsum[0] - gsum), heat, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(2.0 * gsum - s_sum, F, rtol=0, atol=1e-12)
    dual = tdense.compile_dense_dual(EX4V2, cl_k)
    fn = tdense.make_dense_dy_dt(dual, jit=False, device="cpu")
    gb = _gibbs_product(cl_k)
    res = float(fn(np.concatenate([gb, gb])).abs().max())
    assert res < 1e-8
    # Each advance channel's stroke from the port's machine, as the
    # example reads it: A->B and B->C burn 12 nats, C->D 7.
    _, dm = _dm(EX4V2)
    _, val = thermo._machine_write_specs(dm)
    prev_cursor = {"B": "A", "C": "B", "D": "C"}
    G = _EX4V2_G
    for s in np.flatnonzero(adv):
        nxt = _EX4V2_SYMS[val[s, dm.n_p + 1 - dm.d_lo]]
        want = 2.0 * ((G["P"] - G["X"]) + G[prev_cursor[nxt]] - G[nxt])
        assert abs(sigma_spec[s] - want) < 1e-9, (nxt, sigma_spec[s], want)


def test_relative_entropy_rate_is_exact_dD_dt(ex2_master_L8):
    Q = ex2_master_L8
    gibbs = tmaster.ring_gibbs_states(8, J_eff=2 * J, h=H, beta=BETA)
    p = np.random.RandomState(4).dirichlet(np.ones(2**8))
    rate = thermo.relative_entropy_rate(Q, p, gibbs)
    dt = 1e-6
    pdot = Q @ p
    D_m = thermo.relative_entropy(p - dt * pdot, gibbs)
    D_p = thermo.relative_entropy(p + dt * pdot, gibbs)
    assert abs(rate - (D_p - D_m) / (2 * dt)) < 1e-6 * max(1.0, abs(rate))


def test_ex2_entropy_artifacts_claims(ex2_dm, ex2_tables):
    """The committed ex2_entropy_production.npz against the exact kernel
    expectation recomputed by the port (its tables, its ring generator
    and window marginals): z < 6 at every snapshot, the IFT and the
    second law."""
    import scipy.sparse as sp

    path = os.path.join(EXAMPLES, "ex2_entropy_production.npz")
    if not os.path.exists(path):
        pytest.skip("run examples/ex2_entropy_production.py first")
    d = np.load(path)
    cum_mean, cum_se = d["cum_mean"], d["cum_se"]
    n_snaps = len(cum_mean) - 1
    rounds_per_snap = 6
    dm, t = ex2_dm, ex2_tables
    L, a = 12, dm.size_a
    S = a**L
    Q = tmaster.build_ring_generator(EX2, L)
    K = (sp.identity(S) + Q / L).tocsr()
    p = np.full(S, 1.0 / S)
    expected = [0.0]
    acc = 0.0
    for _ in range(n_snaps):
        for _ in range(rounds_per_snap):
            pw = _window_marginals(p, dm, L, a, t)
            rate, _ = thermo.medium_entropy_rate_from_window_probs(pw, t)
            acc += rate
            p = K @ p
        expected.append(acc)
    expected = np.asarray(expected)
    np.testing.assert_allclose(expected, d["exp_cum"], rtol=1e-10,
                               atol=1e-12)
    z = np.abs(cum_mean[1:] - expected[1:]) / np.maximum(cum_se[1:], 1e-12)
    assert float(z.max()) < 6.0, float(z.max())
    assert abs(float(d["ift_mean"][-1]) - 1.0) < 6 * float(d["ift_se"][-1])
    assert float(d["sig_tot_mean"][-1]) > 0.0
