"""Parity of the port's rolled lattice rounds with the JAX package (CPU).

Transition tables and device tables, K10 `table_round` and K11
`lattice_round` (shared and per-member shifts, strides above 64), the
rolled branch of `run_ensemble`, K12's pattern scans and first passage,
K13 `weighted_window_counts`, and `sample_tapes_from_spd(ring=)`. The
same inputs, made with numpy or drawn by JAX, go through the JAX
functions and the port's plain path: tapes agree bit for bit, float64
sums to rtol 1e-12. Each kernel's per-site rule (`csrc/table_rule.cuh`,
`csrc/lattice_round.cuh` in a machine's unit, `csrc/pattern_rule.cuh`,
`csrc/weighted_rule.cuh`) is built with the host's C++ compiler and
held to its plain version; the kernels themselves run only on the card
(`tests/test_torch_gpu.py`).
"""

import ctypes
import dataclasses
import functools
import inspect
import math
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
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as tens,
)
from chemical_kinetics_and_program_execution_torch.engine import k1_source

# The four tags of the JAX package's tests/test_ensemble.py:147-152.
ROUND_TAGS = ["ex5-msrtf-machine", "ex2-ferromagnetic-chain",
              "ex3-copolymerization", "ex4-chemical-turing"]
# Every registered tag whose table compiles (the ex6 rules other than
# self-lite exceed the table's rows or the enumeration's worlds).
TABLE_TAGS = [
    "__canary_problem_radioactive_decay", "ex1-radioactive-decay",
    "ex2-ferromagnetic-chain", "ex3-copolymerization",
    "ex3var1-copolymerization", "ex3var2-copolymerization",
    "ex4-chemical-turing", "ex4var1-chemical-turing",
    "ex4var2-chemical-turing", "ex5-msrtf-machine", "ex5var1-msrtf-machine",
    "ex6-mini-bff-self-lite", "fuzz-wide-specs"]


@functools.lru_cache(maxsize=None)
def _tables(tag):
    jt = jens.compile_transition_table(tag)
    return jt, tens.compile_transition_table(tag)


@functools.lru_cache(maxsize=None)
def _device_tables(tag, f32=False):
    jt, tt = _tables(tag)
    dtype = np.float32 if f32 else None
    return (jens.device_table(jt, dtype=dtype),
            tens.device_table(tt, dtype=dtype, device="cpu"))


@functools.lru_cache(maxsize=None)
def _machines(tag):
    return (jens.compile_decision_machine(tag),
            tens.compile_decision_machine(tag))


def _tapes(rng, size_a, B, L, dtype=np.int32):
    return (rng.randint(0, size_a, (B, L)).astype(dtype),
            rng.randint(0, size_a, (B, L)).astype(dtype))


# Symbols that reach ex4's reverse reaction (program X or P, data B/C/D
# with I/O neighbours) at a useful rate.
_ACTIVE = {"ex4-chemical-turing": ((6, 7), (0, 1, 2, 3, 4, 5)),
           "ex3-copolymerization": ((0, 0, 1), (0, 0, 0, 2))}


def _active_tapes(rng, tag, size_a, B, L):
    p_sym, d_sym = _ACTIVE.get(tag, (range(size_a),) * 2)
    return (rng.choice(np.asarray(p_sym), (B, L)).astype(np.int32),
            rng.choice(np.asarray(d_sym), (B, L)).astype(np.int32))


def _t(x):
    return torch.as_tensor(np.array(x, copy=True))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _jax_draws(key, n, B, E, L, *, per_member, u_dtype):
    """The shifts and uniforms of the JAX package's rolled rounds
    (`run_ensemble`'s scan and `first_passage_times`): round k's key is
    split into (k1, k2); k1 draws the shift over [0, L) ([B] of them for
    independent sites), k2 the [B, E] uniforms."""
    def one(k):
        k1, k2 = jax.random.split(k)
        u = jax.random.uniform(k2, (B, E), dtype=u_dtype)
        s = jax.random.randint(k1, (B,) if per_member else (), 0, L,
                               dtype=jnp.int32)
        return s, u

    s, u = jax.vmap(one)(jax.random.split(key, n))
    return np.asarray(s), np.asarray(u)


# --- Transition tables -----------------------------------------------------------


@pytest.mark.parametrize("tag", TABLE_TAGS)
def test_transition_table_rows_are_distributions(tag):
    """The JAX package's gate on every table, and the port's table equal
    to the JAX package's field for field."""
    jt, t = _tables(tag)
    assert (np.diff(t.out_cum, axis=1) >= -1e-15).all()
    np.testing.assert_array_equal(t.out_cum[:, -1], 1.0)
    assert t.out_world.max() < len(t.wr_mask)
    for name in tens._TABLE_FIELDS:
        _eq(getattr(t, name), getattr(jt, name))
    assert (t.span, t.num_rows, t.summary()) == (jt.span, jt.num_rows,
                                                 jt.summary())


def test_decay_table_semantics():
    t = _tables("ex1-radioactive-decay")[1]
    assert (t.d_lo, t.d_hi) == (0, 0)
    assert t.out_cum.shape[1] == 1
    n_p = t.n_p
    for row in range(t.num_rows):
        d_val = int(np.base_repr(row, 2).zfill(t.n_cells)[n_p])
        spec = t.out_world[row, 0]
        if d_val == 1:
            assert t.wr_mask[spec, n_p] and t.wr_val[spec, n_p] == 0
        else:
            assert not t.wr_mask[spec].any()


@pytest.mark.parametrize("tag", ["ex5-msrtf-machine", "ex4-chemical-turing",
                                 "fuzz-wide-specs"])
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_device_table_matches_jax(tag, f32):
    """Offsets, place values and outcome arrays (float64, or float32 when
    asked), as the JAX package places them; a table built from the JAX
    table's fields gives the same. The port keeps no packed write words:
    its per-step frontier (K22) decodes from wr_mask and wr_val."""
    jdt, tdt = _device_tables(tag, f32)
    for name in ("p_offs", "d_offs", "pv", "out_cum", "out_world",
                 "wr_mask", "wr_val"):
        _eq(getattr(tdt, name).numpy(), getattr(jdt, name))
    assert tdt.out_cum.dtype == (torch.float32 if f32 else torch.float64)
    assert (tdt.size_a, tdt.p_lo, tdt.d_lo, tdt.span) == (
        jdt.size_a, jdt.p_lo, jdt.d_lo, jdt.span)
    assert ({f.name for f in dataclasses.fields(jdt)}
            - {f.name for f in dataclasses.fields(tdt)}
            == {"wr_words", "n_wr_words"})
    jt = _tables(tag)[0]
    crossed = tens.transition_table_from_fields(
        {f.name: getattr(jt, f.name) for f in dataclasses.fields(jt)})
    for name in tens._TABLE_FIELDS:
        _eq(getattr(crossed, name), getattr(jt, name))


# --- K10: the table round -------------------------------------------------------


@pytest.mark.parametrize("tag", ROUND_TAGS)
@pytest.mark.parametrize("shift", [0, 5, 13, 31, 300, -7])
def test_table_round_matches_jax(tag, shift):
    """K10's plain version equals the JAX package's
    `_apply_lattice_round` bit for bit at any shift (one at and beyond
    the stride, beyond L, negative), and the reference's rolled round as
    the port writes it out (`rolled_round_plain`) agrees."""
    jdt, tdt = _device_tables(tag)
    rng = np.random.RandomState(3)
    B, L, E = 3, 256, 8
    pt, dt = _tapes(rng, tdt.size_a, B, L)
    u = rng.rand(B, E)
    want = jens._apply_lattice_round(jdt, jnp.asarray(pt), jnp.asarray(dt),
                                     jnp.asarray(shift, jnp.int32),
                                     jnp.asarray(u))
    p, d = _t(pt), _t(dt)
    tens.table_round(tdt, p, d, shift, _t(u))
    _eq(p, want[0])
    _eq(d, want[1])
    lit = tens.rolled_round_plain(tdt, _t(pt), _t(dt), shift, E, _t(u))
    assert torch.equal(lit[0], p) and torch.equal(lit[1], d)


@pytest.mark.parametrize("tag", ["ex2-ferromagnetic-chain",
                                 "ex3-copolymerization"])
def test_table_round_float32_table_matches_jax(tag):
    """A float32 table compares float32 uniforms, as the reference's
    `device_table(dtype=float32)` rounds do."""
    jdt, tdt = _device_tables(tag, True)
    rng = np.random.RandomState(8)
    B, L, E = 4, 128, 8
    pt, dt = _tapes(rng, tdt.size_a, B, L)
    u = rng.rand(B, E).astype(np.float32)
    want = jens._apply_lattice_round(jdt, jnp.asarray(pt), jnp.asarray(dt),
                                     jnp.asarray(9, jnp.int32),
                                     jnp.asarray(u))
    p, d = _t(pt), _t(dt)
    tens.table_round(tdt, p, d, 9, _t(u))
    _eq(p, want[0])
    _eq(d, want[1])


def test_lattice_round_matches_scatter_formulation():
    """One table round equals the scatter formulation at the same sites
    (the port's `_apply_events_plain` and the JAX package's
    `_apply_events`), and every event applies."""
    jdt, tdt = _device_tables("ex2-ferromagnetic-chain")
    L, E = 256, 8
    stride = L // E
    assert stride > 2 * tdt.span
    rng = np.random.RandomState(0)
    pt, dt = _tapes(rng, 2, 1, L)
    u = rng.rand(1, E)
    p, d = _t(pt), _t(dt)
    tens.table_round(tdt, p, d, 37, _t(u))
    sites = (37 + np.arange(E) * stride) % L
    sp, sd, applied = tens._apply_events_plain(
        tdt, _t(pt[0]), _t(dt[0]), _t(sites.astype(np.int32)), _t(u[0]))
    assert applied == E
    assert torch.equal(p[0], sp) and torch.equal(d[0], sd)
    jp, jd, jn = jens._apply_events(jdt, jnp.asarray(pt[0]),
                                    jnp.asarray(dt[0]),
                                    jnp.asarray(sites, jnp.int32),
                                    jnp.asarray(u[0]))
    assert int(jn) == E
    _eq(sp, jp)
    _eq(sd, jd)
    # Sites closer than 2*span: the later ones drop, as in the reference.
    close = np.array([3, 5, 100], np.int32)
    sp, sd, applied = tens._apply_events_plain(
        tdt, _t(pt[0]), _t(dt[0]), _t(close), _t(u[0, :3]))
    jp, jd, jn = jens._apply_events(jdt, jnp.asarray(pt[0]),
                                    jnp.asarray(dt[0]), jnp.asarray(close),
                                    jnp.asarray(u[0, :3]))
    assert applied == int(jn) == 2
    _eq(sp, jp)
    _eq(sd, jd)


def _odd_tapes(rng, size_a, B, L):
    """Tapes with symbols outside [0, size_a): negative ones and ones
    whose int32 row sum wraps."""
    pt, dt = _tapes(rng, size_a, B, L)
    pick = rng.randint(0, 8, (B, L))
    dt = np.where(pick == 0, -rng.randint(1, 4, (B, L)), dt)
    dt = np.where(pick == 1, 2**30 + rng.randint(0, 9, (B, L)), dt)
    pt = np.where(pick == 2, -(2**31) + rng.randint(0, 9, (B, L)), pt)
    return pt.astype(np.int32), dt.astype(np.int32)


@pytest.mark.parametrize("tag", ["ex5-msrtf-machine", "ex3-copolymerization"])
def test_table_round_out_of_range_symbols_match_jax(tag):
    """A symbol outside [0, size_a) makes a row outside the table; the
    port reads it by the JAX gather's rule (a negative row plus the row
    count, then clamped) and writes what the reference writes."""
    jdt, tdt = _device_tables(tag)
    rng = np.random.RandomState(11)
    B, L, E = 4, 128, 4
    pt, dt = _odd_tapes(rng, tdt.size_a, B, L)
    u = rng.rand(B, E)
    for shift in (0, 3, 77):
        want = jens._apply_lattice_round(
            jdt, jnp.asarray(pt), jnp.asarray(dt),
            jnp.asarray(shift, jnp.int32), jnp.asarray(u))
        p, d = _t(pt), _t(dt)
        tens.table_round(tdt, p, d, shift, _t(u))
        _eq(p, want[0])
        _eq(d, want[1])


# --- K11: the FSM round on [B, L] tapes ------------------------------------------


@pytest.mark.parametrize("tag", ROUND_TAGS)
def test_decision_machine_matches_table_round(tag):
    """The twin of the JAX package's `test_decision_machine_matches_table_
    round`. K11 reads float32 uniforms (the reference's machines do), so
    the uniforms here are float32 values: the table rounds (JAX's and
    K10's plain version) take them widened to float64, the FSM rounds
    (JAX's and K11's plain version) as float32. Each port round equals
    its JAX twin bit for bit; K10 equals K11 wherever the two JAX rounds
    agree, which they do on these draws."""
    jdt, tdt = _device_tables(tag)
    jdm, tdm = _machines(tag)
    assert tdm.span == _tables(tag)[1].span
    rng = np.random.RandomState(1)
    B, L, E = 4, 256, 8
    pt, dt = _tapes(rng, tdm.size_a, B, L)
    u32 = rng.rand(B, E).astype(np.float32)
    u64 = u32.astype(np.float64)
    s = jnp.asarray(13, jnp.int32)
    want_t = jens._apply_lattice_round(jdt, jnp.asarray(pt), jnp.asarray(dt),
                                       s, jnp.asarray(u64))
    want_m = jens._apply_lattice_round_fsm(
        jdm, jnp.asarray(pt, jnp.int8), jnp.asarray(dt, jnp.int8), s,
        jnp.asarray(u32))
    p, d = _t(pt), _t(dt)
    tens.table_round(tdt, p, d, 13, _t(u64))
    _eq(p, want_t[0])
    _eq(d, want_t[1])
    p8, d8 = _t(pt.astype(np.int8)), _t(dt.astype(np.int8))
    tens.lattice_round(tdm, p8, d8, 13, E, _t(u32))
    _eq(p8, want_m[0])
    _eq(d8, want_m[1])
    jax_agree = all(np.array_equal(np.asarray(a, np.int32),
                                   np.asarray(b, np.int32))
                    for a, b in zip(want_t, want_m))
    assert jax_agree
    assert torch.equal(p8.to(torch.int32), p)
    assert torch.equal(d8.to(torch.int32), d)


@pytest.mark.parametrize("tag", ["ex5-msrtf-machine", "ex2-ferromagnetic-chain",
                                 "ex4-chemical-turing"])
@pytest.mark.parametrize("shift", [0, 5, 15, 16, 211])
def test_lattice_round_matches_jax_rolled_and_plane_rounds(tag, shift):
    """K11's plain version equals the JAX package's rolled FSM round at
    shifts 0, 5 and 15 (its `test_plane_round_matches_roll_round`) and at
    a shift at and beyond the stride, and, for a shift below the stride,
    the JAX plane round too."""
    jdm, tdm = _machines(tag)
    rng = np.random.RandomState(7)
    B, L, E = 4, 256, 16
    stride = L // E
    pt, dt = _tapes(rng, tdm.size_a, B, L, np.int8)
    u = rng.rand(B, E).astype(np.float32)
    s = jnp.asarray(shift, jnp.int32)
    want = jens._apply_lattice_round_fsm(jdm, jnp.asarray(pt),
                                         jnp.asarray(dt), s, jnp.asarray(u))
    p, d = _t(pt), _t(dt)
    tens.lattice_round(tdm, p, d, shift, E, _t(u))
    _eq(p, want[0])
    _eq(d, want[1])
    lit = tens.rolled_round_plain(tdm, _t(pt), _t(dt), shift, E, _t(u))
    assert torch.equal(lit[0], p) and torch.equal(lit[1], d)
    if shift < stride:
        gp, gd = jens._apply_plane_round_fsm(
            jdm, jens._tape_to_planes(jnp.asarray(pt), stride),
            jens._tape_to_planes(jnp.asarray(dt), stride), s, jnp.asarray(u))
        _eq(p, jens._planes_to_tape(gp))
        _eq(d, jens._planes_to_tape(gd))


def _rule(tag, kind):
    return _device_tables(tag) if kind == "table" else _machines(tag)


@pytest.mark.parametrize("tag,kind", [
    ("ex2-ferromagnetic-chain", "machine"), ("ex4-chemical-turing", "machine"),
    ("ex3-copolymerization", "machine"), ("ex5-msrtf-machine", "table"),
    ("ex2-ferromagnetic-chain", "table")])
def test_independent_sites_match_jax_run_ensemble(tag, kind):
    """Independent sites: the JAX package keeps each member rolled by
    its phase and rolls by the change each round; the port fires each
    member's sites where they lie. Given the JAX run's own shifts and
    uniforms over several rounds (`run_lattice_rounds`), the tapes are
    bit-identical to JAX `run_ensemble(independent_sites=True)`, and to
    the port's literal twin of the JAX loop."""
    jrule, trule = _rule(tag, kind)
    table = kind == "table"
    rng = np.random.RandomState(5)
    B, L, E, n = 8, 64, 4, 12
    pt, dt = _active_tapes(rng, tag, trule.size_a, B, L)
    key = jax.random.PRNGKey(21)
    (jp, jd), _ = jens.run_ensemble(key, (jnp.asarray(pt), jnp.asarray(dt)),
                                    jrule, (n, E), independent_sites=True)
    u_dtype = jnp.float64 if table else jnp.float32
    shifts, u = _jax_draws(key, n, B, E, L, per_member=True,
                           u_dtype=u_dtype)
    tape_dtype = np.int32 if table else np.int8
    p, d = _t(pt.astype(tape_dtype)), _t(dt.astype(tape_dtype))
    tens.run_lattice_rounds(trule, p, d, _t(shifts), E, _t(u))
    _eq(p.to(torch.int32), jp)
    _eq(d.to(torch.int32), jd)
    lp, ld = tens.independent_rounds_rolled_plain(
        trule, _t(pt.astype(tape_dtype)), _t(dt.astype(tape_dtype)),
        _t(shifts), E, _t(u))
    assert torch.equal(lp, p) and torch.equal(ld, d)
    assert (np.asarray(jd) != dt).any() or (np.asarray(jp) != pt).any()


@pytest.mark.parametrize("tag,kind,L,E", [
    ("ex4-chemical-turing", "machine", 512, 4),  # stride 128 > 64
    ("ex5-msrtf-machine", "machine", 1024, 8),
    ("ex5-msrtf-machine", "table", 256, 16),      # a table, stride 16
    ("ex3-copolymerization", "table", 300, 3)])
def test_shared_shift_runs_match_jax_run_ensemble(tag, kind, L, E):
    """The rolled branch at a shared shift (a table at any stride, a
    machine above stride 64), fed the JAX run's draws, gives the JAX
    `run_ensemble` tapes bit for bit."""
    jrule, trule = _rule(tag, kind)
    table = kind == "table"
    rng = np.random.RandomState(6)
    B, n = 4, 6
    pt, dt = _tapes(rng, trule.size_a, B, L)
    key = jax.random.PRNGKey(2)
    (jp, jd), (ja, jt) = jens.run_ensemble(
        key, (jnp.asarray(pt), jnp.asarray(dt)), jrule, (n, E))
    shifts, u = _jax_draws(key, n, B, E, L, per_member=False,
                           u_dtype=jnp.float64 if table else jnp.float32)
    tape_dtype = np.int32 if table else np.int8
    p, d = _t(pt.astype(tape_dtype)), _t(dt.astype(tape_dtype))
    tens.run_lattice_rounds(trule, p, d, _t(shifts), E, _t(u))
    _eq(p.to(torch.int32), jp)
    _eq(d.to(torch.int32), jd)
    # The port's own run: its draws, the same bookkeeping as JAX's.
    (tp, td), (ta, tt) = tens.run_ensemble(0, (pt, dt), trule, (n, E),
                                           device="cpu")
    assert tp.dtype == torch.int32 and tp.shape == (B, L)
    _eq(ta, ja)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-15)


def test_rolled_paths_reject_planes():
    """keep_planes and a PlaneState need the plane path, with the JAX
    package's messages; a machine's shared-site call at stride <= 64
    still takes the plane path (K1)."""
    _, tdm = _machines("ex5-msrtf-machine")
    _, tdt = _device_tables("ex5-msrtf-machine")
    tapes = (np.zeros((4, 64), np.int32),) * 2
    with pytest.raises(ValueError, match="plane"):
        tens.run_ensemble(0, tapes, tdm, (2, 4), independent_sites=True,
                          keep_planes=True, device="cpu")
    with pytest.raises(ValueError, match="plane"):
        tens.run_ensemble(0, tapes, tdt, (2, 4), keep_planes=True,
                          device="cpu")
    st, _ = tens.run_ensemble(0, tapes, tdm, (2, 4), keep_planes=True,
                              device="cpu")
    with pytest.raises(ValueError, match="plane-eligible"):
        tens.run_ensemble(0, st, tdm, (2, 4), independent_sites=True,
                          device="cpu")
    calls = (tens.plane_round_plain.calls, tens.lattice_round_plain.calls)
    tens.run_ensemble(0, tapes, tdm, (3, 4), device="cpu")
    assert tens.plane_round_plain.calls == calls[0] + 3
    assert tens.lattice_round_plain.calls == calls[1]


def test_rolled_round_checks():
    _, tdm = _machines("ex4-chemical-turing")
    _, tdt = _device_tables("ex2-ferromagnetic-chain")
    p8 = torch.zeros((2, 64), dtype=torch.int8)
    p32 = torch.zeros((2, 64), dtype=torch.int32)
    u32 = torch.zeros((1, 2, 4), dtype=torch.float32)
    s = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tens.run_lattice_rounds(tdt, p8, p8.clone(), s, 4,
                                u32.to(torch.float64))
    with pytest.raises(TypeError, match="int8"):
        tens.run_lattice_rounds(tdm, p32, p32.clone(), s, 4, u32)
    with pytest.raises(ValueError, match="uniforms"):
        tens.run_lattice_rounds(tdt, p32, p32.clone(), s, 4, u32)
    with pytest.raises(ValueError, match="uniforms"):
        tens.run_lattice_rounds(tdm, p8, p8.clone(), s, 4, None)
    with pytest.raises(ValueError, match="too small"):
        tens.run_lattice_rounds(tdm, p8, p8.clone(), s, 16, None)
    with pytest.raises(TypeError, match="shifts"):
        tens.run_lattice_rounds(tdm, p8, p8.clone(),
                                torch.zeros((1, 3), dtype=torch.int32), 4,
                                u32)


# --- The kernels' rules, built for the host ----------------------------------------


def _cxx():
    return next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                       "clang++")) if c),
                None)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """Builds a C++ source (a header of `csrc/` included, or a generated
    unit) with the host's compiler, once per text, and loads it."""
    cxx = _cxx()
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    built = {}

    def get(text):
        if text not in built:
            out = tmp_path_factory.mktemp("rule")
            (out / "unit.cpp").write_text(text)
            lib = out / "librule.so"
            subprocess.run(
                [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                 "-shared", "-fPIC", "-I", str(cuda.CSRC_DIR), "-o",
                 str(lib), str(out / "unit.cpp")], check=True,
                capture_output=True, timeout=300)
            built[text] = ctypes.CDLL(str(lib))
        return built[text]

    return get


_P, _I = ctypes.c_void_p, ctypes.c_int


def _ptr(a):
    return a.ctypes.data


@pytest.mark.parametrize("tag", ["ex5-msrtf-machine", "ex3-copolymerization",
                                 "ex2-ferromagnetic-chain"])
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_table_rule_matches_plain(host_lib, tag, f32):
    """K10's per-site rule (`csrc/table_rule.cuh`) for every site on the
    host equals K10's plain version: shared and per-member shifts,
    symbols outside [0, size_a)."""
    fn = host_lib('#include "table_rule.cuh"\n').ckpe_k10_host_round
    fn.argtypes = [_P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I,
                   _P, _P, _I, _I, _I, _I]
    fn.restype = _I
    _, tdt = _device_tables(tag, f32)
    np_u = np.float32 if f32 else np.float64
    rng = np.random.RandomState(2)
    B, L, E = 5, 96, 4
    pt, dt = _odd_tapes(rng, tdt.size_a, B, L)
    arrays = [np.ascontiguousarray(getattr(tdt, n).numpy()) for n in
              ("pv", "out_cum", "out_world", "wr_mask", "wr_val")]
    for shifts in (np.array([7], np.int32),
                   rng.randint(-300, 300, B).astype(np.int32)):
        u = rng.rand(B, E).astype(np_u)
        kp, kd = pt.copy(), dt.copy()
        assert fn(_ptr(kp), _ptr(kd), _ptr(u), int(not f32), _ptr(shifts),
                  int(len(shifts) > 1), B, L, E, _ptr(arrays[0]),
                  _ptr(arrays[1]), _ptr(arrays[2]), tdt.num_rows,
                  arrays[1].shape[1], _ptr(arrays[3]), _ptr(arrays[4]),
                  tdt.p_lo, tdt.n_p, tdt.d_lo, tdt.n_d) == 0
        p, d = _t(pt), _t(dt)
        tens.table_round_plain(tdt, p, d, _t(shifts), _t(u))
        _eq(kp, p)
        _eq(kd, d)


@pytest.mark.parametrize("tag,f32,L,E,tile,threads,n,k0,per_member", [
    ("ex5-msrtf-machine", False, 96, 4, 3, 7, 6, 2, False),
    ("ex5-msrtf-machine", True, 96, 8, 2, 64, 4, 0, True),
    ("ex3-copolymerization", True, 100, 5, 4, 9, 5, 1, True),
    ("ex3-copolymerization", False, 90, 6, 13, 32, 4, 3, False),
    ("ex2-ferromagnetic-chain", False, 64, 8, 5, 5, 1, 0, True),
    ("ex2-ferromagnetic-chain", True, 40, 1, 6, 33, 7, 1, False),
    ("ex1-radioactive-decay", False, 64, 8, 3, 16, 4, 1, True)])
def test_resident_table_rounds_match_plain(host_lib, tag, f32, L, E, tile,
                                           threads, n, k0, per_member):
    """K10's resident rounds as their host twin runs them
    (`csrc/table_resident.cuh:ckpe_k10_host_resident`: both int32 rows
    loaded into the tile's buffer at padded columns, 16 bytes at a time
    where L % 4 == 0, n rounds of a thread a site on them, written back,
    tile after tile) equal n rounds of `table_round_plain` bit for bit:
    tiles that split B unevenly, fewer threads than a round's sites, n =
    1 and n >= 4, a call from k0 > 0, shared and per-member shifts past
    L and below 0, float64 and float32 tables, one outcome a row (ex5:
    no uniform read) and two (ex3, ex2, ex1), windows of 7, 8 and 4
    cells (the unrolled forms) and of 2 (ex1: the count at run time),
    symbols outside [0, size_a) whose radix sum wraps."""
    fn = host_lib('#include "table_resident.cuh"\n').ckpe_k10_host_resident
    fn.argtypes = ([_P, _P, _P, _I, _P] + [_I] * 6 + [_P, _P, _P, _I, _I,
                                                      _P, _P] + [_I] * 6)
    fn.restype = _I
    _, tdt = _device_tables(tag, f32)
    rng = np.random.RandomState(L + E + n)
    B = 11
    pt, dt = _active_tapes(rng, tag, tdt.size_a, B, L)
    dt[0, ::7] = -2
    dt[1, ::5] = 2**30 + 3
    pt[2, ::9] = -(2**31) + 4
    shape = (k0 + n, B) if per_member else (k0 + n,)
    shifts = rng.randint(-L, 2 * L, shape).astype(np.int32)
    u = rng.rand(n, B, E).astype(np.float32 if f32 else np.float64)
    arrays = [np.ascontiguousarray(getattr(tdt, a).numpy()) for a in
              ("pv", "out_cum", "out_world", "wr_mask", "wr_val")]
    kp, kd = pt.copy(), dt.copy()
    assert fn(_ptr(kp), _ptr(kd), _ptr(u), int(not f32), _ptr(shifts),
              int(per_member), k0, n, B, L, E, _ptr(arrays[0]),
              _ptr(arrays[1]), _ptr(arrays[2]), tdt.num_rows,
              arrays[1].shape[1], _ptr(arrays[3]), _ptr(arrays[4]),
              tdt.p_lo, tdt.n_p, tdt.d_lo, tdt.n_d, tile, threads) == 0
    p, d = _t(pt), _t(dt)
    for j in range(n):
        tens.table_round_plain(tdt, p, d, _t(shifts)[k0 + j], _t(u[j]))
    _eq(kp, p)
    _eq(kd, d)
    assert (kp != pt).any() or (kd != dt).any()


def test_k10_tile_by_geometry():
    """`k10_tile`: phase 9 (a)'s geometry fits three members a block at
    two blocks an SM (384 threads, two sites each); d:323's 512 members
    at L = 10, E = 1 spread over the SMs; a row of 28,000 fits one member
    a block, one of 32,768 (8 bytes a padded word past 227 KB) takes the
    launch a round."""
    assert tens.k10_tile(16384, 4096, 256) == (3, 384, 3 * 33792)
    assert tens.k10_tile(512, 10, 1) == (2, 32, 176)
    assert tens.k10_tile(8, 28_000, 16) == (1, 32, 231_000)
    assert tens.k10_tile(8, 32_768, 16) is None


@pytest.mark.parametrize("tag", ["ex5-msrtf-machine", "ex4-chemical-turing",
                                 "ex2-ferromagnetic-chain",
                                 "ex3-copolymerization"])
def test_generated_lattice_round_matches_plain(host_lib, tag):
    """K11's per-site body, compiled from the machine's generated unit
    (`csrc/lattice_round.cuh` at its end) and run for every site on the
    host, equals K11's plain version at shared and per-member shifts,
    with out-of-range symbols in two rows (the exact walk)."""
    _, tdm = _machines(tag)
    fn = host_lib(k1_source.k1_source(tdm)).ckpe_k11_host_round
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I]
    fn.restype = _I
    rng = np.random.RandomState(4)
    B, L, E = 7, 200, 8
    changed = 0
    for shifts in (np.array([0], np.int32), np.array([131], np.int32),
                   rng.randint(0, L, B).astype(np.int32),
                   np.array([57], np.int32), np.array([199], np.int32),
                   rng.randint(0, L, B).astype(np.int32)):
        pt, dt = (x.astype(np.int8)
                  for x in _active_tapes(rng, tag, tdm.size_a, B, L))
        pt[0, ::9] = tdm.size_a + 3
        dt[1, ::5] = -2
        u = rng.rand(B, E).astype(np.float32)
        u.ravel()[::3] *= 1e-3
        kp, kd = pt.copy(), dt.copy()
        assert fn(_ptr(kp), _ptr(kd), _ptr(u), _ptr(shifts),
                  int(len(shifts) > 1), B, L, E) == 0
        p, d = _t(pt), _t(dt)
        tens.lattice_round_plain(tdm, p, d, _t(shifts), E, _t(u))
        _eq(kp, p)
        _eq(kd, d)
        changed += int((kd != dt).sum() + (kp != pt).sum())
    assert changed > 0


# --- K12: pattern scans and first passage ----------------------------------------

_PATTERNS = [(1, 1, 1), (0, 1), (2,), (1, 0, 1, 1, 0, 0, 1), ()]


def _scan_tapes(rng, B, L, dtype):
    tape = rng.randint(0, 3, (B, L)).astype(dtype)
    tape[0] = 0
    tape[1, -2:] = 1       # (1, 1, 1) across the seam only
    tape[1, 0] = 1
    tape[1, 1:-2] = 0
    return tape


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_pattern_scans_match_jax(dtype):
    """`contains_pattern` and `pattern_progress` equal the JAX package's
    bit for bit, patterns that occur only across the seam included."""
    rng = np.random.RandomState(9)
    tape = _scan_tapes(rng, 12, 24, dtype)
    for pattern in _PATTERNS + [(1,) * 30]:
        got = tens.contains_pattern(tape, pattern, device="cpu")
        want = jens.contains_pattern(jnp.asarray(tape), pattern)
        assert got.dtype == torch.bool
        _eq(got, want)
        got = tens.pattern_progress(tape, pattern, device="cpu")
        want = jens.pattern_progress(jnp.asarray(tape), pattern)
        assert got.dtype == torch.int32
        _eq(got, want)
    assert bool(tens.contains_pattern(tape, (1, 1, 1), device="cpu")[1])


@pytest.mark.parametrize("elem", [1, 4])
def test_pattern_rule_matches_plain(host_lib, elem):
    """K12's rule (`csrc/pattern_rule.cuh`) on the host equals the plain
    version in every mode."""
    fn = host_lib('#include "pattern_rule.cuh"\n').ckpe_k12_host_scan
    fn.argtypes = [_P, _I, _I, _I, _P, _I, _I, _P, _P, _P]
    fn.restype = _I
    dtype = np.int8 if elem == 1 else np.int32
    rng = np.random.RandomState(10)
    B, L = 12, 24
    tape = _scan_tapes(rng, B, L, dtype)
    tape[2, 3] = -1
    for pattern in _PATTERNS:
        pat = np.asarray(pattern, np.int32)
        pat_t = torch.as_tensor(pat)
        present = np.zeros(B, np.uint8)
        progress = np.zeros(B, np.int32)
        fn(_ptr(tape), elem, B, L, _ptr(pat), len(pat), 0, _ptr(present),
           None, None)
        fn(_ptr(tape), elem, B, L, _ptr(pat), len(pat), 1, _ptr(progress),
           None, None)
        _eq(present.astype(bool),
            tens.pattern_scan_plain(_t(tape), pat_t, 0))
        _eq(progress, tens.pattern_scan_plain(_t(tape), pat_t, 1))
        t_hit = np.where(rng.rand(B) < 0.5, np.inf, 1.5)
        t_now = np.array([2.25])
        want = tens.pattern_scan_plain(_t(tape), pat_t, 2,
                                       t_hit=_t(t_hit), t_now=_t(t_now))
        fn(_ptr(tape), elem, B, L, _ptr(pat), len(pat), 2, None,
           _ptr(t_hit), _ptr(t_now))
        _eq(t_hit, want)


@pytest.mark.parametrize("tag,pattern,data_tape,L,E", [
    ("ex2-ferromagnetic-chain", (1, 1, 1), True, 64, 4),
    ("ex4-chemical-turing", (7,), False, 64, 4),
    ("ex1-radioactive-decay", (0, 0, 0), True, 32, 1)])
def test_first_passage_matches_jax_at_same_draws(tag, pattern, data_tape, L,
                                                 E):
    """`first_passage_times` fed the JAX run's draws
    (`first_passage_from_draws`) gives the JAX package's hit times, hits
    and final tapes bit for bit."""
    jdm, tdm = _machines(tag)
    rng = np.random.RandomState(12)
    B, n = 16, 40
    if tag == "ex4-chemical-turing":
        pt = rng.choice([5, 6], (B, L)).astype(np.int32)
        dt = rng.choice([0, 4, 5], (B, L)).astype(np.int32)
    elif tag == "ex1-radioactive-decay":
        pt = np.zeros((B, L), np.int32)
        dt = np.ones((B, L), np.int32)
        dt[:2, :3] = 0  # present from the start
    else:
        pt = np.zeros((B, L), np.int32)
        dt = (rng.rand(B, L) < 0.3).astype(np.int32)
    key = jax.random.PRNGKey(3)
    jt, jh, (jp, jd) = jens.first_passage_times(
        key, (jnp.asarray(pt), jnp.asarray(dt)), jdm, pattern, (n, E),
        data_tape=data_tape)
    shifts, u = _jax_draws(key, n, B, E, L, per_member=False,
                           u_dtype=jnp.float32)
    tt, th, (tp, td) = tens.first_passage_from_draws(
        tdm, (pt, dt), pattern, _t(shifts), E, _t(u), data_tape=data_tape)
    assert tt.dtype == torch.float64 and th.dtype == torch.bool
    _eq(tt, jt)
    _eq(th, jh)
    _eq(tp, jp)
    _eq(td, jd)
    assert 0 < int(th.sum()) and (tt[th] > 0).any()


def _first_passage_loop(dm, pt, dt, pattern, shifts, E, u, data_tape):
    """First passage written out: the initial scan, then a plain K11
    round and a plain K12 update a round."""
    pt, dt = (torch.as_tensor(t).to(torch.int8) for t in (pt, dt))
    pat = torch.tensor(pattern, dtype=torch.int32)
    times = torch.arange(len(shifts) + 1, dtype=torch.float64) * (
        -math.log1p(-E / pt.shape[1]))
    t_hit = torch.full((pt.shape[0],), math.inf, dtype=torch.float64)
    watch = dt if data_tape else pt
    tens.pattern_scan_plain(watch, pat, 2, t_hit=t_hit, t_now=times[:1])
    for k in range(len(shifts)):
        tens.lattice_round_plain(dm, pt, dt, _t(shifts)[k], E,
                                 _t(u)[k] if dm.has_choose else None)
        tens.pattern_scan_plain(watch, pat, 2, t_hit=t_hit,
                                t_now=times[k + 1:k + 2])
    return t_hit, pt.to(torch.int32), dt.to(torch.int32)


@pytest.mark.parametrize("per_call", [None, 1, 7, 40])
def test_first_passage_in_calls_matches_round_loop(per_call):
    """`first_passage_from_draws` sent in calls of ``per_call`` rounds
    (the last one short) gives the hit times and tapes of the round
    loop written out, on ex4 (choose nodes: each call reads its own
    rows of the uniforms)."""
    _, dm = _machines("ex4-chemical-turing")
    rng = np.random.RandomState(21)
    B, L, E, n = 12, 64, 4, 45
    pt = rng.choice([5, 6], (B, L)).astype(np.int32)
    dt = rng.choice([0, 4, 5], (B, L)).astype(np.int32)
    shifts = rng.randint(0, L, n).astype(np.int32)
    u = rng.rand(n, B, E).astype(np.float32)
    t_hit, hit, (p, d) = tens.first_passage_from_draws(
        dm, (pt, dt), (7,), _t(shifts), E, _t(u), data_tape=False,
        rounds_per_call=per_call)
    want, wp, wd = _first_passage_loop(dm, pt, dt, (7,), shifts, E, u, False)
    assert torch.equal(t_hit, want) and torch.equal(hit, torch.isfinite(want))
    assert torch.equal(p, wp) and torch.equal(d, wd)
    assert 0 < int(hit.sum()) < B and (t_hit[hit] > 0).any()


def test_first_passage_initial_hit_and_no_hit():
    _, dm = _machines("ex1-radioactive-decay")
    B, L = 8, 32
    pt0 = np.zeros((B, L), np.int32)
    t_hit, hit, _ = tens.first_passage_times(
        0, (pt0, np.zeros((B, L), np.int32)), dm, (0, 0), (4, 2),
        device="cpu")
    assert (t_hit == 0.0).all()
    t_hit, hit, _ = tens.first_passage_times(
        0, (pt0, np.zeros((B, L), np.int32)), dm, (1, 1), (4, 2),
        device="cpu")
    assert not hit.any() and torch.isinf(t_hit).all()


def test_first_passage_matches_occupancy_for_monotone_pattern():
    """ex1's A cells never revert, so P(first passage <= t) equals the
    pattern's occupancy at t, here through the port's own `run_ensemble`
    (K1's plane path) with other seeds: the JAX package's gate. Members
    of one run share each round's sites and ex1 is deterministic, so a
    run is one sample; 16 seeds a side give the scatter."""
    _, dm = _machines("ex1-radioactive-decay")
    B, L, E, rounds, seeds = 32, 64, 4, 24, 16
    pattern = (0, 0, 0)
    pt0 = np.zeros((B, L), np.int32)
    dt0 = np.ones((B, L), np.int32)
    t_hit = np.stack([
        tens.first_passage_times(k, (pt0, dt0), dm, pattern, (rounds, E),
                                 device="cpu")[0].numpy()
        for k in range(seeds)])
    dt_round = -math.log1p(-E / L)
    for r in (rounds // 2, rounds):
        occ = np.array([float(tens.contains_pattern(
            tens.run_ensemble(100 + r + k, (pt0, dt0), dm, (r, E),
                              device="cpu")[0][1],
            pattern, device="cpu").float().mean()) for k in range(seeds)])
        cdf = (t_hit <= r * dt_round + 1e-12).mean(axis=1)
        se = math.sqrt(occ.var(ddof=1) / seeds + cdf.var(ddof=1) / seeds)
        assert abs(cdf.mean() - occ.mean()) < 5 * se + 0.01, (r, cdf, occ)


# --- K11's resident rounds and K12's staged scan, as the card runs them ----------

_RES_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P,
             _P]


def _resident(host_lib, dm):
    fn = host_lib(k1_source.k1_source(dm)).ckpe_k11_host_resident
    fn.argtypes = _RES_ARGS
    fn.restype = _I
    return fn


@pytest.mark.parametrize("tag,L,E,tile,n,per_member", [
    ("ex5-msrtf-machine", 192, 8, 3, 6, False),
    ("ex5-msrtf-machine", 192, 8, 4, 6, True),
    ("ex4-chemical-turing", 200, 8, 3, 1, False),
    ("ex4-chemical-turing", 200, 8, 2, 5, True),
    ("ex4-chemical-turing", 200, 5, 3, 3, True),
    ("ex3-copolymerization", 96, 4, 7, 4, True)])
def test_resident_rounds_match_plain(host_lib, tag, L, E, tile, n,
                                     per_member):
    """K11's resident kernel as its host twin runs it (`csrc/
    lattice_round.cuh:ckpe_k11_host_resident`: rows loaded into the
    tile's buffer, 16 bytes at a time where L % 16 == 0, n rounds on
    them, written back, tile after tile) equals n rounds of
    `lattice_round_plain`: tiles that split B unevenly, shared and
    per-member shifts, machines with choose nodes (ex4, ex3), n = 1, a
    call that starts at k0 > 0, symbols out of range (the exact walk),
    four sites a thread by K1's lane walk (E a multiple of 4) and a site
    a thread (E = 5)."""
    _, dm = _machines(tag)
    fn = _resident(host_lib, dm)
    rng = np.random.RandomState(31)
    B, k0 = 7, 2
    pt, dt = (x.astype(np.int8)
              for x in _active_tapes(rng, tag, dm.size_a, B, L))
    pt[0, ::11] = dm.size_a + 2
    dt[1, ::7] = -3
    shape = (k0 + n, B) if per_member else (k0 + n,)
    shifts = rng.randint(-L, 2 * L, shape).astype(np.int32)
    u = rng.rand(n, B, E).astype(np.float32)
    kp, kd = pt.copy(), dt.copy()
    assert fn(_ptr(kp), _ptr(kd), _ptr(u), _ptr(shifts), int(per_member),
              k0, n, B, L, E, tile, 5, -1, None, 0, None, None) == 0
    p, d = _t(pt), _t(dt)
    for j in range(n):
        tens.lattice_round_plain(dm, p, d, _t(shifts)[k0 + j], E, _t(u[j]))
    _eq(kp, p)
    _eq(kd, d)
    assert (kp != pt).any() or (kd != dt).any()


@pytest.mark.parametrize("tag,pattern,data_tape,L,tile,threads", [
    ("ex2-ferromagnetic-chain", (1, 1, 1), True, 64, 5, 7),
    ("ex4-chemical-turing", (7,), False, 64, 4, 128),
    ("ex2-ferromagnetic-chain", (0, 1, 1, 0, 1), True, 40, 16, 100)])
def test_resident_first_passage_matches_plain(host_lib, tag, pattern,
                                              data_tape, L, tile, threads):
    """K11's fused first passage as its host twin runs it (K12's update
    of the watched rows in the tile's buffer after each round, the hit
    times held beside them) equals the round loop written out: hit times
    and both tapes, in two calls (the second from k0 > 0), tiles that
    split B unevenly, blocks narrower and wider than a row, patterns
    across the seam, a machine with choose nodes (ex4)."""
    _, dm = _machines(tag)
    fn = _resident(host_lib, dm)
    rng = np.random.RandomState(41)
    B, E, n = 11, 4, 30
    if tag == "ex4-chemical-turing":
        pt = rng.choice([5, 6], (B, L)).astype(np.int8)
        dt = rng.choice([0, 4, 5], (B, L)).astype(np.int8)
        dt[-3:] = 0  # no tape to fire on: never hit
    else:
        pt = np.zeros((B, L), np.int8)
        dt = (rng.rand(B, L) < 0.3).astype(np.int8)
        dt[3, -2:] = 1
        dt[3, :1] = 1
    shifts = rng.randint(0, L, n).astype(np.int32)
    u = rng.rand(n, B, E).astype(np.float32)
    want, wp, wd = _first_passage_loop(dm, pt.copy(), dt.copy(), pattern,
                                       shifts, E, u, data_tape)
    pat = np.asarray(pattern, np.int32)
    times = np.arange(n + 1) * -math.log1p(-E / L)
    watch = torch.as_tensor(dt if data_tape else pt)
    t_hit = tens.pattern_scan_plain(
        watch, torch.as_tensor(pat), 2,
        t_hit=torch.full((B,), math.inf, dtype=torch.float64),
        t_now=torch.zeros(1, dtype=torch.float64)).numpy().copy()
    kp, kd = pt.copy(), dt.copy()
    for k0, m in ((0, 13), (13, n - 13)):
        uk = np.ascontiguousarray(u[k0:k0 + m])
        assert fn(_ptr(kp), _ptr(kd), _ptr(uk), _ptr(shifts), 0, k0, m, B,
                  L, E, tile, threads, int(data_tape), _ptr(pat), len(pat),
                  _ptr(t_hit), _ptr(times)) == 0
    _eq(t_hit, want)
    _eq(kp.astype(np.int32), wp)
    _eq(kd.astype(np.int32), wd)
    hit = np.isfinite(t_hit)
    assert 0 < hit.sum() < B and (t_hit[hit] > 0).any()


@pytest.mark.parametrize("elem", [1, 4])
def test_staged_scan_matches_plain(host_lib, elem):
    """K12's staged scan as its host twin runs it (`pattern_rule.cuh:
    ckpe_k12_host_staged`: the row staged with its P - 1 wrap cells, 16
    bytes a lane where the row allows, int8 rows searched 4 bytes at a
    time by the emulated `__vcmpeq4`, a lane's candidates walked, the
    lanes' maximum) equals the plain version in every mode: patterns
    across the seam, longer than the ring, empty, a first symbol no int8
    holds, rows of 24, 13 and 32 symbols."""
    fn = host_lib('#include "pattern_rule.cuh"\n').ckpe_k12_host_staged
    fn.argtypes = [_P, _I, _I, _I, _P, _I, _I, _P, _P, _P]
    fn.restype = _I
    dtype = np.int8 if elem == 1 else np.int32
    rng = np.random.RandomState(10)
    for B, L in ((12, 24), (9, 13), (6, 32)):
        tape = _scan_tapes(rng, B, L, dtype)
        tape[2, 3] = -1
        for pattern in _PATTERNS + [(1,) * 30, (200, 1), (-1, 0)]:
            pat = np.asarray(pattern, np.int32)
            pat_t = torch.as_tensor(pat)
            present = np.zeros(B, np.uint8)
            progress = np.zeros(B, np.int32)
            assert fn(_ptr(tape), elem, B, L, _ptr(pat), len(pat), 0,
                      _ptr(present), None, None) == 0
            fn(_ptr(tape), elem, B, L, _ptr(pat), len(pat), 1,
               _ptr(progress), None, None)
            _eq(present.astype(bool),
                tens.pattern_scan_plain(_t(tape), pat_t, 0))
            _eq(progress, tens.pattern_scan_plain(_t(tape), pat_t, 1))
            t_hit = np.where(rng.rand(B) < 0.5, np.inf, 1.5)
            t_now = np.array([2.25])
            want = tens.pattern_scan_plain(_t(tape), pat_t, 2,
                                           t_hit=_t(t_hit), t_now=_t(t_now))
            fn(_ptr(tape), elem, B, L, _ptr(pat), len(pat), 2, None,
               _ptr(t_hit), _ptr(t_now))
            _eq(t_hit, want)


def test_resident_geometry():
    """K11's tile and K12's members by the geometry alone: the full
    width two blocks an SM, the examples' first passage spread over the
    card, rows too long to keep resident (2L past 227 KB) and rows too
    long to stage take the kernels that read the tapes where they lie."""
    assert tens.k11_tile(16384, 4096, 256) == (14, 512, 14 * 8200)
    assert tens.k11_tile(4096, 128, 4, 4) == (16, 256, 16 * 276 + 16)
    assert tens.k11_tile(3, 128, 4) == (1, 256, 264)
    assert tens.k11_tile(64, 80_000, 16) == (1, 256, 160_008)
    assert tens.k11_tile(64, 116_100, 16) == (1, 256, 232_200)
    assert tens.k11_tile(64, 116_101, 16) is None
    assert tens.k11_tile(64, 131_072, 16, 3) is None
    assert tens.k12_members(4096, 1, 3) == 8
    assert tens.k12_members(4096, 4, 3) == 7
    assert tens.k12_members(40_000, 4, 1) == 1
    assert tens.k12_members(60_000, 4, 1) == 0
    assert tens.k12_members(200_000, 1, 1) == 1


# --- K13: weighted window counts -------------------------------------------------


@pytest.mark.parametrize("size_a,cl_k,B,L", [(2, 3, 5, 12), (5, 3, 300, 40),
                                             (9, 2, 7, 33), (2, 15, 3, 20)])
@pytest.mark.parametrize("odd", [False, True], ids=["in_range", "odd"])
def test_weighted_window_counts_match_jax(size_a, cl_k, B, L, odd):
    """Within rtol 1e-12 of the JAX package's float64 sum (another
    order), symbols outside [0, size_a) counted by K2's rule."""
    rng = np.random.RandomState(size_a * 7 + cl_k)
    tape = rng.randint(0, size_a, (B, L)).astype(np.int32)
    if odd:
        pick = rng.randint(0, 6, (B, L))
        tape = np.where(pick == 0, -rng.randint(1, 3, (B, L)), tape)
        tape = np.where(pick == 1, 2**32 // size_a ** (cl_k - 1) + 1,
                        tape).astype(np.int32)
    w = rng.rand(B) + 0.1
    got = tens.weighted_window_counts(tape, w, size_a, cl_k, device="cpu")
    want = np.asarray(jens.weighted_window_counts(jnp.asarray(tape),
                                                  jnp.asarray(w), size_a,
                                                  cl_k))
    assert got.dtype == torch.float64 and got.shape == (size_a**cl_k,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("size_a,cl_k,B,L", [(2, 3, 5, 12), (5, 3, 300, 40),
                                             (3, 10, 9, 50)])
def test_weighted_rule_matches_plain(host_lib, size_a, cl_k, B, L):
    """K13's rule (`csrc/weighted_rule.cuh`: the blocks' members in
    order, then the partials in block order) on the host equals the
    plain version bit for bit, out-of-range symbols included."""
    fn = host_lib('#include "weighted_rule.cuh"\n').ckpe_k13_host
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = None
    rng = np.random.RandomState(B + L)
    tape = rng.randint(-1, size_a, (B, L)).astype(np.int32)
    w = rng.rand(B)
    w /= w.sum()
    out = np.zeros(size_a**cl_k)
    per = tens.k13_members_per_block(B, size_a**cl_k)
    fn(_ptr(tape), _ptr(w), B, L, size_a, cl_k, per, _ptr(out))
    want = tens.weighted_window_counts_plain(_t(tape), _t(w), size_a, cl_k)
    _eq(out, want)


def test_k13_members_per_block():
    assert tens.k13_members_per_block(16384, 125) == 64
    assert tens.k13_members_per_block(7, 125) == 1
    assert -(-16384 // tens.k13_members_per_block(16384, 59049)) <= 94


# --- Tapes from an SPD: the ring and the linear chain --------------------------------


def test_sample_tapes_signature_matches_jax():
    """A drop-in call works on the port: the same positional arguments in
    the same number, and the JAX package's keyword arguments (`ring`
    among them) with their defaults; the port adds only `device`."""
    for name in ("sample_tapes_from_spd", "run_ensemble",
                 "first_passage_times", "contains_pattern",
                 "pattern_progress", "weighted_window_counts",
                 "compile_transition_table", "device_table"):
        jp = inspect.signature(getattr(jens, name)).parameters
        tp = inspect.signature(getattr(tens, name)).parameters

        def split(params):
            pos = [p for p in params.values()
                   if p.kind is p.POSITIONAL_OR_KEYWORD]
            kw = {p.name: p.default for p in params.values()
                  if p.kind is p.KEYWORD_ONLY}
            return pos, kw

        (j_pos, j_kw), (t_pos, t_kw) = split(jp), split(tp)
        assert len(t_pos) == len(j_pos), name
        assert [p.default for p in t_pos] == [p.default for p in j_pos]
        assert set(t_kw) - set(j_kw) <= {"device"}, name
        assert {k: t_kw[k] for k in j_kw} == j_kw, name
    assert "ring" in inspect.signature(
        tens.sample_tapes_from_spd).parameters


def test_linear_chain_sampling_matches_jax_statistically():
    """`ring=False` draws the linear chain: its seam fabricates the single
    U islands (p(DUD) > 0) that the ex2 pair SPD does not hold, as the
    JAX package's does, and the two agree on every window's frequency
    within their sampling noise."""
    from chemical_kinetics_and_program_execution_tpu.models.initial_states import (  # noqa: E501
        ferromagnet_p0,
    )

    p0 = np.asarray(ferromagnet_p0(5, p_pair=1 / 250)).ravel()
    B, L = 2048, 128
    port = tens.sample_tapes_from_spd(0, p0, 2, 5, B, L, ring=False,
                                      device="cpu")
    ring = tens.sample_tapes_from_spd(0, p0, 2, 5, B, L, ring=True,
                                      device="cpu")
    jx = np.asarray(jens.sample_tapes_from_spd(jax.random.PRNGKey(0), p0, 2,
                                               5, B, L, ring=False))
    c_port = tens.window_counts(port, 2, 5, device="cpu").numpy()
    c_ring = tens.window_counts(ring, 2, 5, device="cpu").numpy()
    c_jax = np.asarray(jens.window_counts(jnp.asarray(jx), 2, 5))

    def dud(c):
        return float(c.reshape((2,) * 5)[0, 1, 0].sum())

    assert dud(c_ring) == 0.0
    assert dud(c_port) > 1e-5 and dud(c_jax) > 1e-5
    # Each window's frequency, two independent draws: a binomial z gate
    # on L*B/cl_k effective windows.
    sd = np.sqrt(np.maximum(c_jax, 1e-9) / (B * L / 5))
    assert float((np.abs(c_port - c_jax) / sd).max()) < 6.0
    assert np.abs(c_port - p0).sum() < 0.05


# --- The port's ensemble against exact decay (statistical twins) ---------------------


def test_serial_table_ensemble_matches_exponential_decay():
    _, tdt = _device_tables("ex1-radioactive-decay")
    B, L = 64, 256
    tapes = (np.zeros((B, L), np.int32), np.ones((B, L), np.int32))
    # Independent sites: the members are independent draws, which the
    # binomial gate assumes (with one shared site a round, every member
    # fires the same sites).
    (_, dtape), (applied, times) = tens.run_ensemble(
        0, tapes, tdt, (512, 1), independent_sites=True, device="cpu")
    t_eff = float(times[-1])
    p_b = float(dtape.double().mean())
    assert int(applied.sum()) == 512 * B
    assert abs(p_b - np.exp(-t_eff)) < 4 * np.sqrt(np.exp(-t_eff) / (B * L))


def test_parallel_table_rounds_match_low_density_decay():
    _, tdt = _device_tables("ex1-radioactive-decay")
    B, L, E = 32, 2048, 64
    tapes = (np.zeros((B, L), np.int32), np.ones((B, L), np.int32))
    (_, dtape), (_, times) = tens.run_ensemble(1, tapes, tdt, (40, E),
                                               device="cpu")
    expect = np.exp(-float(times[-1]))
    sigma = np.sqrt(expect * (1 - expect) / (B * (L // E)))
    assert abs(float(dtape.double().mean()) - expect) < 0.05 * expect \
        + 5 * sigma


def test_table_ensemble_ferromagnet_approaches_spd_dynamics():
    """The tape ensemble's window statistics follow the exact SPD ODE
    loosely (the JAX package's gate; the ODE from the JAX package)."""
    from chemical_kinetics_and_program_execution_tpu import (
        compile_problem,
        make_dy_dt,
    )
    from chemical_kinetics_and_program_execution_tpu.models.initial_states import (  # noqa: E501
        ferromagnet_p0,
    )
    from chemical_kinetics_and_program_execution_tpu.ode.integrate import (
        solve,
    )

    cl_k = 3
    p0 = np.asarray(ferromagnet_p0(cl_k, p_pair=0.05, corrected=True)).ravel()
    _, tdt = _device_tables("ex2-ferromagnetic-chain")
    B, L = 64, 2048
    dtape = tens.sample_tapes_from_spd(2, p0, 2, cl_k, B, L, device="cpu")
    np.testing.assert_allclose(
        tens.window_counts(dtape, 2, cl_k, device="cpu").numpy(), p0,
        atol=0.02)
    (_, dtape), (_, times) = tens.run_ensemble(
        3, (np.zeros((B, L), np.int32), dtape), tdt, (30, 64), device="cpu")
    p_emp = tens.window_counts(dtape, 2, cl_k, device="cpu").numpy()
    fn = make_dy_dt(compile_problem("ex2-ferromagnetic-chain", cl_k))
    ys = solve(lambda y, t: fn(y), p0, np.linspace(0, float(times[-1]), 5),
               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(p_emp, np.asarray(ys)[-1], atol=0.02)

