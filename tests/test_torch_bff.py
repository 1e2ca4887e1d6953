"""Parity of the PyTorch port's BFF interpreter with the JAX package (CPU).

The same machines, windows, tapes, shifts and mutation draws go through
the JAX package's `engine/bff.py` and the port's: `bff_fire` bit for
bit on random windows (with and without lineage), `run_bff_rounds` at
the JAX run's own shifts and draws (tapes, opcode totals) in every mode.
The port's own runs are held to the exact master equation of the port's
`engine/master.py` and to its exact SPD closure, at the JAX tests'
sizes and thresholds; `engine/soup_we.py` to brute force and the Hill
relation. K16's and K18's rule (`csrc/bff_rule.cuh`) is built here with
the host's C++ compiler and held to the plain versions; the kernels
themselves run only on the card (`tests/test_torch_gpu.py`).
"""

import ctypes
import math
import shutil
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu.engine import bff as jbff
from chemical_kinetics_and_program_execution_tpu.engine import (
    soup_we as jsoup,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch import engine as tengine
from chemical_kinetics_and_program_execution_torch.engine import bff as tbff
from chemical_kinetics_and_program_execution_torch.engine import dsl as tdsl
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as tens,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    master as tmaster,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    soup_we as tsoup,
)
from chemical_kinetics_and_program_execution_torch.ode.integrate import solve

FAITHFUL, LITE, MIDI = "ex6-mini-bff", "ex6-mini-bff-lite", "ex6-mini-bff-midi"
SELF, SELF_LITE, SELF_MIDI = ("ex6-mini-bff-self", "ex6-mini-bff-self-lite",
                              "ex6-mini-bff-self-midi")
TAGS = [FAITHFUL, LITE, MIDI, SELF, SELF_LITE, SELF_MIDI]


@pytest.fixture(autouse=True)
def _two_threads():
    """At most two intra-op threads a test: the rounds here are many short
    ops on tensors of 10^4-10^5 cells, which a full thread pool ran 40-80x
    slower than two threads on a host whose cores other test workers
    kept busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _machines(tag):
    return jbff.compile_bff(tag), tbff.compile_bff(tag)


def _arr(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _eq(got, want):
    np.testing.assert_array_equal(_arr(got), _arr(want))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# --- Machines and bff_fire ----------------------------------------------------------


@pytest.mark.parametrize("tag", TAGS)
def test_compile_bff_matches_jax(tag):
    jm, tm = _machines(tag)
    assert tbff.bff_machine_from_jax(jm) == tm
    assert (tm.n_p, tm.n_d, tm.span) == (jm.n_p, jm.n_d, jm.span)
    assert tm.summary() == jm.summary()


@pytest.mark.parametrize("lineage", [False, True], ids=["plain", "lineage"])
@pytest.mark.parametrize("tag", TAGS)
def test_bff_fire_matches_jax(tag, lineage):
    """bff_fire equals the JAX package's bit for bit on random windows
    (int8 cells as the rounds hold them; lineage ids riding along)."""
    jm, tm = _machines(tag)
    rng = np.random.default_rng(zlib.crc32(tag.encode()) + lineage)
    N = 400
    D = rng.integers(0, tm.size_a, (N, tm.n_d)).astype(np.int8)
    P = (None if tm.self_modifying
         else rng.integers(0, tm.size_a, (N, tm.n_p)).astype(np.int8))
    V = rng.integers(-1, 1000, (N, tm.n_d)).astype(np.int32)
    args = (P, D, V) if lineage else (P, D)
    want = jbff.bff_fire(jm, *args)
    got = tbff.bff_fire(tm, *(None if a is None else torch.as_tensor(a)
                              for a in args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.as_tensor(np.array(w)).dtype
        _eq(g, w)
    assert (got[-1].sum(-1) == tm.fuel).all()


@pytest.mark.parametrize("tag", [FAITHFUL, LITE, SELF, SELF_LITE])
def test_bff_fire_matches_host_rule(tag):
    """Twins of tests/test_bff.py's test_bff_fire_matches_host_rule and
    test_bff_self_fire_matches_host_rule: bff_fire against the DSL rule
    run on the host by the port's master.py, on random windows; one
    outcome, reads and writes inside the declared windows."""
    _, m = _machines(tag)
    problem = tdsl.get_problem(tag)
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    N = 200
    P = rng.integers(0, m.size_a, (N, m.n_p)).astype(np.int32)
    D = rng.integers(0, m.size_a, (N, m.n_d)).astype(np.int32)
    new_d, ops = (x.numpy() for x in tbff.bff_fire(
        m, None if m.self_modifying else torch.as_tensor(P),
        torch.as_tensor(D)))
    assert (ops.sum(axis=-1) == m.fuel).all()
    for i in range(N):
        wd = {o: int(D[i, o - m.d_lo]) for o in range(m.d_lo, m.d_hi + 1)}
        if m.self_modifying:
            outs, reach = tmaster.enumerate_window_outcomes(problem, wd)
            writes = outs[0][1] if len(outs) == 1 else None
        else:
            wp = {o: int(P[i, o - m.p_lo])
                  for o in range(m.p_lo, m.p_hi + 1)}
            outs, reach_p, reach = tmaster.enumerate_pair_outcomes(
                problem, wp, wd)
            assert not outs[0][1]  # the program tape is read-only
            assert m.p_lo <= reach_p[0] and reach_p[1] <= m.p_hi
            writes = outs[0][2]
        assert len(outs) == 1 and outs[0][0] == 1.0
        assert m.d_lo <= reach[0] and reach[1] <= m.d_hi
        want = D[i].copy()
        for o, v in writes.items():
            want[o - m.d_lo] = v
        assert np.array_equal(want, new_d[i]), i


def test_bff_self_writes_reach_the_instruction_stream():
    """Twin of tests/test_bff.py's: step 1's 'dot' overwrites the 'plus'
    that step 2 fetches, so the live fetch copies 'dot' again."""
    _, m = _machines(SELF_LITE)
    D = torch.tensor([[m.zero, m.dot, m.plus, m.zero]], dtype=torch.int32)
    new_d, _ = tbff.bff_fire(m, None, D)
    _eq(new_d, [[m.zero, m.dot, m.dot, m.zero]])


def _host_fire_with_prov(m, d, prov):
    """The self-modifying machine with lineage, straight from the
    language (tests/test_bff.py's independent host interpreter)."""
    d, prov = list(d), list(prov)
    pc, d0, d1, mode = 0, 0, m.d1_start, 0
    A = m.size_a

    def i(o):
        return o - m.d_lo

    for _ in range(m.fuel):
        op = d[i(pc)]
        if mode < 0:
            if op == m.bl and mode == -1:
                mode = 0
                pc += 1
            else:
                mode += (op == m.bl) - (op == m.br)
                pc -= 1
        elif mode > 0:
            if op == m.br and mode == 1:
                mode = 0
            else:
                mode += (op == m.bl) - (op == m.br)
            pc += 1
        else:
            if op == m.lt:
                d0 -= 1
            elif op == m.gt:
                d0 += 1
            elif op == m.cl:
                d1 -= 1
            elif op == m.cr:
                d1 += 1
            elif op in (m.plus, m.minus):
                d[i(d0)] = (d[i(d0)] + (1 if op == m.plus else -1)) % A
            elif op == m.dot:
                d[i(d1)] = d[i(d0)]
                prov[i(d1)] = prov[i(d0)]
            elif op == m.comma:
                d[i(d0)] = d[i(d1)]
                prov[i(d0)] = prov[i(d1)]
            elif op == m.bl:
                mode = 1 if d[i(d0)] == m.zero else 0
            elif op == m.br and d[i(d0)] != m.zero:
                mode = -1
                pc -= 2
            pc += 1
    return d, prov


@pytest.mark.parametrize("tag", [SELF, SELF_LITE])
def test_bff_lineage_matches_host_interpreter(tag):
    """Twin of tests/test_bff.py's: provenance equals the host
    interpreter's, and the content equals the run without lineage."""
    _, m = _machines(tag)
    rng = np.random.default_rng(zlib.crc32(tag.encode()) ^ 0xBEEF)
    N = 300
    D = torch.as_tensor(rng.integers(0, m.size_a, (N, m.n_d)),
                        dtype=torch.int32)
    P0 = torch.arange(m.n_d, dtype=torch.int32).repeat(N, 1)
    new_d, new_p, _ = tbff.bff_fire(m, None, D, P0)
    plain_d, _ = tbff.bff_fire(m, None, D)
    assert torch.equal(new_d, plain_d)
    for k in range(N):
        wd, wp = _host_fire_with_prov(m, D[k].tolist(), P0[k].tolist())
        assert new_d[k].tolist() == wd and new_p[k].tolist() == wp, k


@pytest.mark.parametrize("tag", [FAITHFUL, SELF])
def test_bff_round_matches_host_application(tag):
    """Twins of test_bff_round_matches_host_application and
    test_bff_self_round_matches_host_application: one round (span 31,
    stride 128) of K16's plain version against the host rule applied
    site by site, at shifts 0, 31 and 255."""
    _, m = _machines(tag)
    problem = tdsl.get_problem(tag)
    rng = np.random.default_rng(11 + m.self_modifying)
    B, L, E = 8, 256, 2
    stride = L // E
    pt = rng.integers(0, m.size_a, (B, L)).astype(np.int8)
    dt = rng.integers(0, m.size_a, (B, L)).astype(np.int8)
    for shift in (0, 31, 255):
        p2 = None if m.self_modifying else torch.as_tensor(pt.copy())
        d2 = torch.as_tensor(dt.copy())
        tot = tbff.bff_round_plain(m, p2, d2, None, shift, E)
        if p2 is not None:
            _eq(p2, pt)
        assert int(tot.sum()) == B * E * m.fuel
        want = dt.astype(np.int32)
        for b in range(B):
            for e in range(E):
                site = (shift + e * stride) % L
                wd = {o: int(want[b, (site + o) % L])
                      for o in range(m.d_lo, m.d_hi + 1)}
                if m.self_modifying:
                    outs, _ = tmaster.enumerate_window_outcomes(problem, wd)
                    writes = outs[0][1]
                else:
                    wp = {o: int(pt[b, (site + o) % L])
                          for o in range(m.p_lo, m.p_hi + 1)}
                    outs, _, _ = tmaster.enumerate_pair_outcomes(
                        problem, wp, wd)
                    writes = outs[0][2]
                for o, v in writes.items():
                    want[b, (site + o) % L] = v
        _eq(d2.to(torch.int32), want)


# --- Whole runs at the JAX package's own draws -----------------------------------------


def jax_draws(key, n, B, L, size_a, *, per_member, mutate):
    """The shifts and mutation draws `_run_ensemble_bff` makes from
    ``key``: split(key, n); a round key split again when mutating; the
    shift(s) randint(k, (), 0, L) or (B,); uniform(ku, (B, L)) float64 and
    randint(kv, (B, L), 0, size_a) from split(km). Per-member runs keep
    each member rolled by its shift, so their draws are rolled back into
    the tapes' own frame. Returns (shifts, draws or None)."""
    shifts, us, vals = [], [], []
    for k in jax.random.split(key, n):
        if mutate:
            k, km = jax.random.split(k)
        shifts.append(np.asarray(jax.random.randint(
            k, (B,) if per_member else (), 0, L, dtype=jnp.int32)))
        if mutate:
            ku, kv = jax.random.split(km)
            us.append(np.asarray(jax.random.uniform(ku, (B, L))))
            vals.append(np.asarray(jax.random.randint(
                kv, (B, L), 0, size_a, dtype=jnp.int32)))
    shifts = np.stack(shifts).astype(np.int32)
    if not mutate:
        return shifts, None
    u, v = np.stack(us), np.stack(vals)
    assert u.dtype == np.float64
    if per_member:
        for j in range(n):
            back = -torch.as_tensor(shifts[j]).long()
            u[j] = tens._roll_rows_plain(torch.as_tensor(u[j]), back).numpy()
            v[j] = tens._roll_rows_plain(torch.as_tensor(v[j]), back).numpy()
    return shifts, (u, v)


_MODES = {
    # mode: (tag, B, L, E, rounds, independent, mutation, lineage)
    "two-tape": (FAITHFUL, 8, 256, 4, 5, False, 0.0, False),
    "self": (SELF, 8, 256, 4, 5, False, 0.0, False),
    "lineage": (SELF, 8, 256, 4, 5, False, 0.0, True),
    "mutation": (SELF, 8, 256, 4, 5, False, 0.05, False),
    "mutation-lineage": (SELF, 8, 256, 4, 4, False, 0.02, True),
    "independent": (FAITHFUL, 8, 256, 4, 5, True, 0.0, False),
    "independent-self": (SELF_MIDI, 8, 128, 4, 6, True, 0.0, False),
    "independent-mutation": (SELF_LITE, 16, 4, 1, 8, True, 0.1, True),
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_run_bff_rounds_matches_jax(mode):
    """run_bff_rounds at the JAX run's shifts and mutation draws equals
    JAX run_ensemble_bff(engine="scan") bit for bit: tapes, lineage and
    the [rounds, size_a] opcode totals; run_ensemble_bff's times equal
    the JAX run's."""
    tag, B, L, E, n, ind, mu, lineage = _MODES[mode]
    jm, tm = _machines(tag)
    rng = np.random.default_rng(zlib.crc32(mode.encode()))
    key = jax.random.PRNGKey(len(mode))
    prov = (rng.permutation(B * L).astype(np.int32).reshape(B, L)
            if lineage else None)
    if tm.self_modifying:
        tapes = rng.integers(0, tm.size_a, (B, L)).astype(np.int32)
    else:
        tapes = tuple(rng.integers(0, tm.size_a, (B, L)).astype(np.int32)
                      for _ in range(2))
    jout, (jops, jtimes) = jbff.run_ensemble_bff(
        key, tapes, jm, (n, E), independent_sites=ind, mutation_rate=mu,
        prov=prov, engine="scan")
    shifts, draws = jax_draws(key, n, B, L, tm.size_a, per_member=ind,
                              mutate=bool(mu))
    calls = tbff.bff_round_plain.calls
    tout, tops = tbff.run_bff_rounds(tm, tapes, shifts, E,
                                     mutation_draws=draws,
                                     mutation_rate=mu, prov=prov,
                                     device="cpu")
    assert tbff.bff_round_plain.calls == calls + n
    for g, w in zip(_as_tuple(tout), _as_tuple(jout), strict=True):
        assert g.dtype == torch.int32
        _eq(g, w)
    _eq(tops, jops)
    changed = _as_tuple(tout)[0].numpy() != (tapes if tm.self_modifying
                                             else tapes[1])
    assert changed.any()
    _, (_, times) = tbff.run_ensemble_bff(0, tapes, tm, (n, E),
                                          independent_sites=ind,
                                          mutation_rate=mu, prov=prov,
                                          device="cpu")
    assert times.dtype == torch.float64
    _eq(times, jtimes)


def test_run_ensemble_bff_contract():
    """Twin of tests/test_bff.py's: shapes, the program tape read-only,
    fuel ops a site event, times, the geometry gate, non-BFF rules."""
    _, m = _machines(FAITHFUL)
    B, L, E, steps = 16, 256, 4, 3
    rng = np.random.default_rng(0)
    pt, dt = (rng.integers(0, m.size_a, (B, L)).astype(np.int32)
              for _ in range(2))
    (p_out, d_out), (ops, times) = tbff.run_ensemble_bff(
        2, (pt, dt), m, (steps, E), device="cpu")
    _eq(p_out, pt)
    assert d_out.dtype == torch.int32 and d_out.shape == (B, L)
    assert ops.shape == (steps, m.size_a) and ops.dtype == torch.int64
    assert (ops.sum(1) == B * E * m.fuel).all()
    dt_round = -math.log1p(-E / L)
    np.testing.assert_allclose(times.numpy(),
                               dt_round * np.arange(1, steps + 1))
    with pytest.raises(ValueError, match="stride"):
        tbff.run_ensemble_bff(0, (pt, dt), m, (1, 8), device="cpu")
    with pytest.raises(ValueError, match="not a mini-BFF"):
        tbff.compile_bff("ex2-ferromagnetic-chain")
    with pytest.raises(TypeError, match="BffMachine"):
        tbff.run_ensemble_bff(0, (pt, dt), tens.compile_decision_machine(
            "ex2-ferromagnetic-chain"), (1, 1), device="cpu")
    # Same seed, same run; the generator's stream drives it.
    again, _ = tbff.run_ensemble_bff(2, (pt, dt), m, (steps, E),
                                     device="cpu")
    assert torch.equal(again[1], d_out)


def test_bff_mutation_rejected_for_two_tape_machines():
    """Twin of tests/test_bff.py's, with the lineage ring too."""
    _, m = _machines(LITE)
    t0 = np.zeros((2, 64), np.int32)
    with pytest.raises(ValueError, match="self-modifying"):
        tbff.run_ensemble_bff(0, (t0, t0), m, (1, 1), mutation_rate=0.01,
                              device="cpu")
    with pytest.raises(ValueError, match="self-modifying"):
        tbff.run_ensemble_bff(0, (t0, t0), m, (1, 1), prov=t0,
                              device="cpu")
    with pytest.raises(ValueError, match="self-modifying"):
        tbff.run_bff_rounds(m, (t0, t0), np.zeros(1, np.int32), 1,
                            mutation_rate=0.01, device="cpu")


def test_scan_wrappers_check_their_inputs():
    """K16's and K18's wrappers refuse what their kernels cannot take."""
    _, m = _machines(SELF_LITE)
    t = torch.zeros((4, 16), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        tbff.bff_round(m, None, t.to(torch.int32), 0, 1)
    with pytest.raises(ValueError, match="program tape"):
        tbff.bff_round(m, t, t.clone(), 0, 1)
    with pytest.raises(ValueError, match="prov"):
        tbff.bff_round(m, None, t, 0, 1, prov=torch.zeros((4, 16)))
    with pytest.raises(TypeError, match="shifts"):
        tbff.run_bff_rounds(m, t, np.zeros((2, 3), np.int32), 1,
                            device="cpu")
    with pytest.raises(ValueError, match="mutation draws"):
        tbff.run_bff_rounds(m, t, np.zeros(2, np.int32), 1,
                            mutation_draws=(np.zeros((1, 4, 16)),
                                            np.zeros((1, 4, 16), np.int32)),
                            mutation_rate=0.1, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        tbff.bff_mutate(t, None, torch.zeros((4, 16), dtype=torch.float32),
                        torch.zeros((4, 16), dtype=torch.int32), 0.5)
    with pytest.raises(ValueError, match="unknown engine"):
        tbff.run_ensemble_bff(0, t, m, (1, 1), engine="warp", device="cpu")


def test_bff_mutate_plain_semantics():
    """K18's plain version: cells below the rate take their drawn symbol
    and lineage -1; the rest stay; rate 1 hits every cell."""
    g = torch.Generator().manual_seed(3)
    tape = torch.randint(0, 12, (64, 32), generator=g).to(torch.int8)
    prov = torch.arange(64 * 32, dtype=torch.int32).reshape(64, 32)
    u = torch.rand((64, 32), generator=g, dtype=torch.float64)
    vals = torch.randint(0, 12, (64, 32), generator=g, dtype=torch.int32)
    t2, p2 = tape.clone(), prov.clone()
    tbff.bff_mutate(t2, p2, u, vals, 0.3)
    hit = u < 0.3
    assert torch.equal(t2, torch.where(hit, vals.to(torch.int8), tape))
    assert torch.equal(p2, torch.where(hit, -1, prov))
    assert 0.2 < float(hit.double().mean()) < 0.4
    tbff.bff_mutate(t2, p2, u, vals, 1.0)
    assert torch.equal(t2, vals.to(torch.int8)) and (p2 == -1).all()


# --- Law gates against the port's master equation --------------------------------------


def _z(reps, want, floor_n):
    reps = np.stack(reps)
    got = reps.mean(axis=0)
    sem = reps.std(axis=0, ddof=1) / np.sqrt(len(reps))
    floor = np.sqrt(np.maximum(want, 1e-9) * np.clip(1.0 - want, 0, 1)
                    / floor_n)
    return float((np.abs(got - want) / np.maximum(sem, floor)).max())


def _replicas(tape, n_keys, B_k, size_a, cl_k):
    """Window marginals of each group of B_k members (independent sites:
    the groups of one run are independent replicas)."""
    w = np.full(B_k, 1.0 / B_k)
    return [tens.weighted_window_counts(
        tape[k * B_k:(k + 1) * B_k], w, size_a, cl_k, device="cpu").numpy()
        for k in range(n_keys)]


# The program ring of tests/test_bff.py's gate (seed 3: [9 1 2 2], which
# never writes, so its law is the uniform start), and one that writes
# (seed 0: [10 7 6 3], window marginals up to 0.076 off uniform after 24
# rounds).
@pytest.mark.parametrize("seed", [pytest.param(3, id="reference-program"),
                                  pytest.param(0, id="writing-program")])
def test_bff_ensemble_matches_conditioned_master(seed):
    """Twin of tests/test_bff.py's at its settings (lite, L=4, E=1, 24
    rounds, 8 replicas of 1,024 members, one frozen program ring): data
    marginals against I + Q/L of the conditioned master equation, z < 6.
    The replicas run as one batch with independent sites."""
    tag, L, cl_k = LITE, 4, 2
    _, m = _machines(tag)
    assert m.span <= L
    rng = np.random.default_rng(seed)
    pr = rng.integers(0, m.size_a, L)
    Q = tmaster.build_conditioned_ring_generator(tag, pr)
    S = m.size_a ** L
    p = np.full(S, 1.0 / S)
    rounds, E = 24, 1
    for _ in range(rounds):
        p = p + (Q @ p) / L
    want = tmaster.state_window_marginals(p, L, m.size_a, cl_k)
    # The writing program's law moves; the reference program's does not.
    assert (np.abs(want - 1.0 / m.size_a ** cl_k).max() > 0.05) == (seed == 0)
    n_keys, B_k = 8, 1024
    g = torch.Generator().manual_seed(4200)
    dtape = torch.randint(0, m.size_a, (n_keys * B_k, L), generator=g)
    ptape = np.tile(np.asarray(pr, np.int32), (n_keys * B_k, 1))
    (_, dt_), _ = tbff.run_ensemble_bff(g, (ptape, dtape), m, (rounds, E),
                                        independent_sites=True,
                                        device="cpu")
    reps = _replicas(dt_, n_keys, B_k, m.size_a, cl_k)
    assert _z(reps, want, n_keys * B_k * L / cl_k) < 6.0


def _ring_law(tag, L, rounds, q=0.0):
    """Window marginals of the exact per-round kernel M(q) (I + Q/L) from
    the uniform ring, and Q."""
    _, m = _machines(tag)
    A = m.size_a
    Q = tmaster.build_ring_generator(tag, L)
    mut = np.full((A, A), q / A)
    mut[np.diag_indices(A)] += 1.0 - q
    p = np.full(A ** L, 1.0 / A ** L)
    for _ in range(rounds):
        p = p + (Q @ p) / L
        if q:
            t = p.reshape((A,) * L)
            for ax in range(L):
                t = np.moveaxis(np.tensordot(mut, t, axes=(1, ax)), 0, ax)
            p = t.ravel()
    return p, Q


@pytest.mark.parametrize("q", [0.0, 0.05], ids=["ring", "mutation"])
def test_bff_self_ensemble_matches_ring_master(q):
    """Twins of test_bff_self_ensemble_matches_ring_master and
    test_bff_self_mutation_matches_composed_master_kernel (self-lite, L=4,
    E=1, 24 rounds, 8 x 1,024 members, cl_k 2): against I + Q/L, and with
    mutation q = 0.05 against M(q) (I + Q/L), z < 6."""
    tag, L, cl_k = SELF_LITE, 4, 2
    _, m = _machines(tag)
    p, Q = _ring_law(tag, L, 24, q)
    assert np.abs(np.asarray(Q.sum(axis=0)).ravel()).max() < 1e-12
    want = tmaster.state_window_marginals(p, L, m.size_a, cl_k)
    n_keys, B_k = 8, 1024
    g = torch.Generator().manual_seed(5200 + int(q * 100))
    tape = torch.randint(0, m.size_a, (n_keys * B_k, L), generator=g)
    out, _ = tbff.run_ensemble_bff(g, tape, m, (24, 1),
                                   independent_sites=True, mutation_rate=q,
                                   device="cpu")
    reps = _replicas(out, n_keys, B_k, m.size_a, cl_k)
    assert _z(reps, want, n_keys * B_k * L / cl_k) < 6.0


def test_bff_self_lite_exact_stationary_mutation_balance():
    """Twin of tests/test_bff.py's: the composed kernel's stationary
    p(dot) is non-monotone in q (0.0, 0.01, 0.2), and 6 x 1,024 members
    over 6,000 rounds at q = 0.01 reach its marginals (z < 6)."""
    tag, L, cl_k = SELF_LITE, 4, 1
    _, m = _machines(tag)
    A = m.size_a
    Q = tmaster.build_ring_generator(tag, L)

    def stationary(q, iters=20000):
        mut = np.full((A, A), q / A)
        mut[np.diag_indices(A)] += 1.0 - q
        p = np.full(A ** L, 1.0 / A ** L)
        for _ in range(iters):
            p2 = p + (Q @ p) / L
            t = p2.reshape((A,) * L)
            for ax in range(L):
                t = np.moveaxis(np.tensordot(mut, t, axes=(1, ax)), 0, ax)
            p2 = t.ravel()
            if np.abs(p2 - p).max() < 1e-14:
                return p2
            p = p2
        raise AssertionError("power iteration did not converge")

    stat = {q: stationary(q) for q in (0.0, 0.01, 0.2)}
    pd = {q: tmaster.state_window_marginals(s, L, A, cl_k)[m.dot]
          for q, s in stat.items()}
    assert pd[0.01] > pd[0.0] + 0.1, pd
    assert pd[0.2] < pd[0.0] - 0.1, pd
    want = tmaster.state_window_marginals(stat[0.01], L, A, cl_k)
    n_keys, B_k, rounds = 6, 1024, 6000
    g = torch.Generator().manual_seed(9300)
    tape = torch.randint(0, A, (n_keys * B_k, L), generator=g)
    out, _ = tbff.run_ensemble_bff(g, tape, m, (rounds, 1),
                                   independent_sites=True,
                                   mutation_rate=0.01, device="cpu")
    reps = _replicas(out, n_keys, B_k, A, cl_k)
    assert _z(reps, want, n_keys * B_k * L) < 6.0


def test_bff_lineage_run_content_invariant_and_conserving():
    """Twin of tests/test_bff.py's: lineage leaves the content stream as
    it is (same seed, with and without mutation), ids only coarsen (the
    initial ids and -1), mutation at rate 1 stamps every cell -1."""
    _, m = _machines(SELF)
    B, L = 16, 256
    rng = np.random.default_rng(33)
    tape = rng.integers(0, m.size_a, (B, L)).astype(np.int32)
    prov0 = np.tile(np.arange(L, dtype=np.int32), (B, 1))
    for mu in (0.0, 0.02):
        plain, _ = tbff.run_ensemble_bff(34, tape, m, (6, 4),
                                         mutation_rate=mu, device="cpu")
        (lt, lp), _ = tbff.run_ensemble_bff(34, tape, m, (6, 4),
                                            mutation_rate=mu, prov=prov0,
                                            device="cpu")
        assert torch.equal(plain, lt)
        vals = set(torch.unique(lp).tolist())
        assert vals <= set(range(L)) | {-1}
        assert (-1 in vals) == (mu > 0)
    (_, lp1), _ = tbff.run_ensemble_bff(35, tape, m, (1, 4),
                                        mutation_rate=1.0, prov=prov0,
                                        device="cpu")
    assert (lp1 == -1).all()


def test_bff_self_ensemble_tracks_exact_spd_closure():
    """Twin of tests/test_bff.py's: self-lite, 8 replicas of 256 members,
    L=256, E=8, 63 rounds with independent sites, cl_k 3 window counts
    within 6 sigma plus the cl_k 3 <-> 4 closure gap of the port's exact
    closure (dense engine, solved by the port's solver on the CPU)."""
    tag, cl_k = SELF_LITE, 3
    _, m = _machines(tag)
    B, L, E, rounds, n_keys = 256, 256, 8, 63, 8
    A = m.size_a
    g = torch.Generator().manual_seed(100)
    tape = torch.randint(0, A, (n_keys * B, L), generator=g)
    out, (_, times) = tbff.run_ensemble_bff(g, tape, m, (rounds, E),
                                            independent_sites=True,
                                            device="cpu")
    reps = np.stack([tens.window_counts(out[k * B:(k + 1) * B], A, cl_k,
                                        device="cpu").numpy()
                     for k in range(n_keys)])
    t_eff = float(times[-1])
    got = reps.mean(axis=0)
    sem = reps.std(axis=0, ddof=1) / np.sqrt(n_keys)
    ts = np.linspace(0.0, t_eff, 5)
    want = {}
    for k in (3, 4):
        fn, _ = tengine.build_dy_dt(tag, k, device="cpu")
        p0 = np.full(A ** k, 1.0 / A ** k)
        pk = np.asarray(solve(lambda y, t: fn(y), p0, ts, rtol=1e-9,
                              atol=1e-12, device="cpu")[-1])
        if k == 4:
            pk = pk.reshape(A ** cl_k, A).sum(axis=1)
        want[k] = pk
    closure_gap = np.abs(want[3] - want[4])
    assert closure_gap.max() < 1e-3
    assert np.abs(want[3] - 1 / A ** cl_k).max() > 0.05
    floor = np.sqrt(np.maximum(want[3], 1e-9) * (1.0 - want[3])
                    / (n_keys * B * L / cl_k))
    bound = 6.0 * np.maximum(sem, floor) + closure_gap
    err = np.abs(got - want[3])
    assert (err <= bound).all(), float((err - bound).max())


# --- soup_we ---------------------------------------------------------------------------


def test_max_cyclic_run_matches_bruteforce():
    """Twin of tests/test_bff.py's, and equal to the JAX package's."""
    rng = np.random.default_rng(5)
    t = rng.integers(0, 3, (64, 12)).astype(np.int32)
    t[0] = 1
    t[1, :] = 0
    t[1, -3:] = 1
    t[1, :2] = 1
    got = tsoup.max_cyclic_run(t, 1)
    _eq(got, jsoup.max_cyclic_run(t, 1))
    L = t.shape[1]
    for b in range(t.shape[0]):
        best = 0
        for start in range(L):
            run = 0
            for j in range(L):
                if t[b, (start + j) % L] == 1:
                    run += 1
                    best = max(best, run)
                else:
                    break
        assert got[b] == min(best, L), (b, got[b], best)


def test_systematic_resampling_matches_jax():
    rng_j, rng_t = (np.random.default_rng(7) for _ in range(2))
    idx = np.arange(10, 30)
    w = np.random.default_rng(1).random(20)
    for n in (1, 7, 40):
        a = jsoup._systematic(idx, w, n, rng_j)
        b = tsoup._systematic(idx, w, n, rng_t)
        _eq(a[0], b[0])
        _eq(a[1], b[1])


def _make_init(m, L, s):
    rng = np.random.default_rng(900 + s)
    return lambda n: rng.integers(0, m.size_a, (n, L), dtype=np.int32)


def test_we_emergence_unbiased():
    """Twin of tests/test_bff.py's: splitting on and off agree on the
    emergence probability of a dot run >= 8 within 6 sigma over 4 seeds
    (K 1,024, L 256, 10 blocks of 8 rounds at E 4); emergence happens,
    and splitting resolves the tail no later."""
    _, m = _machines(SELF)
    L, K, blocks, n_seeds = 256, 1024, 10, 4
    finals, early = {}, {}
    for split in (True, False):
        vals, early_hits = [], []
        for s in range(n_seeds):
            r = tsoup.we_emergence(40 + 10 * s + split, m,
                                   _make_init(m, L, s),
                                   plan=(K, blocks, 8, 4), q_target=8,
                                   split=split, seed=s, device="cpu")
            vals.append(1.0 - r.survival[-1])
            early_hits.append(int(np.argmax(r.survival < 1.0))
                              if (r.survival < 1.0).any() else blocks)
        finals[split] = np.asarray(vals)
        early[split] = np.asarray(early_hits)
    mean_t, mean_f = finals[True].mean(), finals[False].mean()
    sem = np.sqrt(finals[True].var(ddof=1) / n_seeds
                  + finals[False].var(ddof=1) / n_seeds + 1e-12)
    assert abs(mean_t - mean_f) < 6.0 * max(sem, 1e-3), (mean_t, mean_f,
                                                         sem)
    assert mean_f > 0.01
    assert early[True].mean() <= early[False].mean()


def test_we_emergence_recycle_satisfies_hill_relation():
    """Twin of tests/test_bff.py's: the recycle mode's late flux times
    E[T] from the survival mode is 1 within 0.2 on average over 3 seeds
    and 0.3 each (K 1,024, L 256, 32 blocks)."""
    _, m = _machines(SELF)
    L, K, blocks = 256, 1024, 32
    dt_block = -math.log1p(-4 / L) * 8
    ratios = []
    for s in range(3):
        rs = tsoup.we_emergence(60 + s, m, _make_init(m, L, s),
                                plan=(K, blocks, 8, 4), q_target=8, seed=s,
                                device="cpu")
        S = rs.survival
        h_late = (np.log(max(S[blocks // 2], 1e-300))
                  - np.log(max(S[-1], 1e-300))) / (
                      rs.times[-1] - rs.times[blocks // 2])
        ts = np.concatenate([[0.0], rs.times])
        Sf = np.concatenate([[1.0], S])
        ET = np.trapezoid(Sf, ts) + S[-1] / h_late
        rr = tsoup.we_emergence(160 + s, m, _make_init(m, L, s),
                                plan=(K, blocks, 8, 4), q_target=8,
                                recycle=True, seed=s, device="cpu")
        rate = rr.flux[blocks // 2:].mean() / dt_block
        ratios.append(rate * ET)
    ratios = np.asarray(ratios)
    assert 0.8 < ratios.mean() < 1.2, ratios
    assert (np.abs(ratios - 1.0) < 0.3).all(), ratios


def test_we_emergence_rejects_two_tape_machines():
    with pytest.raises(ValueError, match="self-modifying"):
        tsoup.we_emergence(0, _machines(LITE)[1], lambda n: None,
                           plan=(2, 1, 1, 1), q_target=2, device="cpu")


# --- K16's and K18's rule, built for the host ----------------------------------------


def _cxx():
    return next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                       "clang++")) if c),
                None)


@pytest.fixture(scope="module")
def rule_lib(tmp_path_factory):
    """`csrc/bff_rule.cuh` built with the host's C++ compiler."""
    cxx = _cxx()
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("bff_rule")
    (out / "unit.cpp").write_text('#include "bff_rule.cuh"\n')
    lib = out / "librule.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib),
                    str(out / "unit.cpp")], check=True, capture_output=True,
                   timeout=300)
    dll = ctypes.CDLL(str(lib))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    dll.ckpe_bff_host_fire.argtypes = [P, P, P, P, I, P]
    dll.ckpe_bff_host_fire.restype = I
    dll.ckpe_bff_host_round.argtypes = [P, P, P, P, P, I, I, I, I, P, P, P,
                                        D]
    dll.ckpe_bff_host_round.restype = I
    return dll


def _ptr(a):
    return None if a is None else a.ctypes.data


@pytest.mark.parametrize("tag", TAGS)
def test_bff_rule_fire_matches_plain(rule_lib, tag):
    """K16's interpreter step (`csrc/bff_rule.cuh:bff_fire`) on the host
    equals the plain bff_fire on random windows, data, lineage and
    opcode counts, with symbols outside [0, size_a) in some windows."""
    _, m = _machines(tag)
    rng = np.random.default_rng(zlib.crc32(tag.encode()) ^ 0x16)
    N = 500
    D = rng.integers(0, m.size_a, (N, m.n_d)).astype(np.int8)
    P = rng.integers(0, m.size_a, (N, m.n_p)).astype(np.int8)
    odd = rng.random((N, 1)) < 0.1
    D = np.where(odd & (rng.random(D.shape) < 0.2),
                 rng.integers(-5, 20, D.shape), D).astype(np.int8)
    V = rng.integers(-1, 10**6, (N, m.n_d)).astype(np.int32)
    params = tbff.rule_params(m)
    for lineage in (False, True):
        kd, kv = D.copy(), V.copy()
        counts = np.zeros((N, m.size_a), np.int64)
        assert rule_lib.ckpe_bff_host_fire(
            _ptr(params), None if m.self_modifying else _ptr(P), _ptr(kd),
            _ptr(kv) if lineage else None, N, _ptr(counts)) == 0
        args = [None if m.self_modifying else torch.as_tensor(P),
                torch.as_tensor(D)]
        if lineage:
            args.append(torch.as_tensor(V))
        want = tbff.bff_fire(m, *args)
        _eq(kd, want[0])
        _eq(counts, want[-1])
        if lineage:
            _eq(kv, want[1])


# B=6, L=320, E=4 for four tags; the master-equation gates' geometry (a
# ring of 4 cells, one site a round) for the lite machines.
_ROUND_CASES = [
    pytest.param(tag, per_member, mutation, B, L, E,
                 id=f"{tag}-{per_member}-{mutation}{name}")
    for tags, (B, L, E), name in (((FAITHFUL, MIDI, SELF, SELF_LITE),
                                   (6, 320, 4), ""),
                                  ((LITE, SELF_LITE), (64, 4, 1), "-L4E1"))
    for tag in tags
    for per_member in (False, True)
    for mutation in ((False, True) if "self" in tag else (False,))]


@pytest.mark.parametrize("tag,per_member,mutation,B,L,E", _ROUND_CASES)
def test_bff_rule_round_matches_plain(rule_lib, tag, per_member, mutation, B,
                                      L, E):
    """K16's per-thread body run for every site of a round on the host
    (the windows read where they lie: shifts past L and negative ones
    too), then K18's per-cell body, equal to bff_round_plain and
    bff_mutate_plain: tapes, lineage (self-modifying machines) and the
    round's totals."""
    _, m = _machines(tag)
    rng = np.random.default_rng(len(tag) * 7 + per_member + 2 * mutation)
    params = tbff.rule_params(m)
    pt = rng.integers(0, m.size_a, (B, L)).astype(np.int8)
    dt = rng.integers(0, m.size_a, (B, L)).astype(np.int8)
    prov = (np.arange(B * L, dtype=np.int32).reshape(B, L)
            if m.self_modifying else None)
    for shift in ([rng.integers(-700, 700, B) for _ in range(3)]
                  if per_member else [0, 79, 319, 1000, -3]):
        shifts = np.atleast_1d(np.asarray(shift, np.int32))
        u = rng.random((B, L)) if mutation else None
        vals = (rng.integers(0, m.size_a, (B, L)).astype(np.int32)
                if mutation else None)
        kp, kd = pt.copy(), dt.copy()
        kv = None if prov is None else prov.copy()
        totals = np.zeros(m.size_a, np.int64)
        assert rule_lib.ckpe_bff_host_round(
            _ptr(params), None if m.self_modifying else _ptr(kp), _ptr(kd),
            _ptr(kv), _ptr(shifts), int(per_member), B, L, E,
            _ptr(totals), _ptr(u), _ptr(vals), 0.3) == 0
        tp = None if m.self_modifying else torch.as_tensor(pt.copy())
        td = torch.as_tensor(dt.copy())
        tv = None if prov is None else torch.as_tensor(prov.copy())
        tot = tbff.bff_round_plain(m, tp, td, tv, torch.as_tensor(shifts),
                                   E)
        if mutation:
            tbff.bff_mutate_plain(td, tv, torch.as_tensor(u),
                                  torch.as_tensor(vals), 0.3)
        _eq(kd, td)
        _eq(totals, tot)
        if tp is not None:
            _eq(kp, tp)
        if tv is not None:
            _eq(kv, tv)
        assert (kd != dt).any()
        dt, prov = kd, kv


def test_bff_modules_import_no_jax():
    """`engine/bff.py`, `bff_bitslice.py`, `bff_bitslice_source.py` and
    `soup_we.py`, and runs through them, import neither jax nor the JAX
    package."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from chemical_kinetics_and_program_execution_torch.engine import "
        "bff, bff_bitslice, bff_bitslice_source, soup_we\n"
        "m = bff.compile_bff('ex6-mini-bff-self-lite')\n"
        "bff_bitslice_source.k17_source(m, bff_bitslice.compile_bff_circuit(m))\n"
        "t = np.zeros((32, 64), np.int32)\n"
        "bff.run_ensemble_bff(0, t, m, (2, 4), device='cpu')\n"
        "bff.run_ensemble_bff(0, t, m, (2, 4), mutation_rate=0.1, "
        "independent_sites=True, device='cpu')\n"
        "soup_we.max_cyclic_run(t, m.dot)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith("
        "('jax.', 'chemical_kinetics_and_program_execution_tpu'))]\n"
        "assert not bad, bad\n"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
