"""Parity of the PyTorch port's ensemble slice with the JAX package (CPU).

The same inputs, made with numpy or drawn by JAX, go through the JAX
functions and through the port's plain path; integer and bit logic must
agree bit for bit, and float64 observables exactly where the arithmetic
is the same. The port's CUDA kernels run only on the card
(`tests/test_torch_gpu.py`); here K1's generated unit is built with the
host's C++ compiler and its per-thread body, run for every thread in a
host loop, is held against the plain round.
"""

import ctypes
import dataclasses
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu.engine import dsl as jdsl
from chemical_kinetics_and_program_execution_tpu.engine import (
    ensemble as jens,
)
from chemical_kinetics_and_program_execution_tpu.engine import (
    enumerate as jenum,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.engine import dsl as tdsl
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as tens,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    enumerate as tenum,
)
from chemical_kinetics_and_program_execution_torch.engine import k1_source
from chemical_kinetics_and_program_execution_torch.utils import config

TAGS = ["ex5-msrtf-machine", "ex4-chemical-turing", "ex2-ferromagnetic-chain"]
CPU = torch.device("cpu")


# A rule whose second choose reads the uniform renormalised by the first:
# the reference's float32 branch-0 width shows in the outcome only for
# uniforms next to a second-level threshold.
_NESTED_TAG = "torch-port-test-nested-choose"


def _nested_choose_rule(t):
    t.get(True, 0)
    if t.choose([(0.7, True), (0.3, False)]):
        t.set(True, 0, t.choose([(0.5, 0), (0.25, 1), (0.25, 2)]))


jdsl.register_problem(_NESTED_TAG, ("a", "b", "c"))(_nested_choose_rule)
tdsl.register_problem(_NESTED_TAG, ("a", "b", "c"))(_nested_choose_rule)


@functools.lru_cache(maxsize=None)
def _machines(tag):
    return (jens.compile_decision_machine(tag),
            tens.compile_decision_machine(tag))


def _jax_fields(jdm):
    """The JAX machine's fields as plain ints and tuples."""
    nodes = tuple(
        ("reveal", n.node_id, n.cell, n.child_words, n.spec_words)
        if isinstance(n, jens._Reveal)
        else ("choose", n.node_id, n.probs, n.child_words, n.spec_words)
        for n in jdm.nodes)
    return dict(tag=jdm.tag, size_a=jdm.size_a, p_lo=jdm.p_lo,
                d_lo=jdm.d_lo, n_p=jdm.n_p, n_d=jdm.n_d, span=jdm.span,
                nodes=nodes, root=jdm.root, n_states=jdm.n_states,
                bits=jdm.bits, wr_words=jdm.wr_words,
                num_specs=jdm.num_specs, wr_bits=jdm.wr_bits)


def _random_tapes(rng, size_a, B, L):
    return (rng.randint(0, size_a, (B, L)).astype(np.int32),
            rng.randint(0, size_a, (B, L)).astype(np.int32))


def _planes(tape, stride):
    return tens._tape_to_planes(torch.as_tensor(tape).to(torch.int8),
                                stride)


def _to_jax(t):
    """A JAX copy of a torch tensor. (A view could alias memory that the
    port then updates in place while JAX's asynchronous dispatch still
    reads it.)"""
    return jnp.array(t.numpy(), copy=True)


@functools.lru_cache(maxsize=None)
def _jax_round(tag):
    jdm = _machines(tag)[0]
    return jax.jit(lambda p, d, s, u: jens._apply_plane_round_fsm_stacked(
        jdm, p, d, s, u))


# --- Host layer: enumeration, machine, level plan -----------------------------


@pytest.mark.parametrize("tag", TAGS)
def test_enumerate_worlds_match_jax(tag):
    for cl_k in (2, 3):
        want = jenum.enumerate_worlds(jdsl.get_problem(tag), cl_k)
        got = tenum.enumerate_worlds(tdsl.get_problem(tag), cl_k)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for f in ("const", "factors", "tape_sigs", "decisions",
                      "tape_cells", "decision_meta", "factor_tapes"):
                assert getattr(g, f) == getattr(w, f), f


@pytest.mark.parametrize("tag", TAGS + [_NESTED_TAG])
def test_machine_fields_match_jax(tag):
    jdm, tdm = _machines(tag)
    assert tens.machine_fields(tdm) == _jax_fields(jdm)
    np.testing.assert_array_equal(
        np.asarray(jdm.p_offs), np.arange(tdm.p_lo, tdm.p_lo + tdm.n_p))
    np.testing.assert_array_equal(
        np.asarray(jdm.d_offs), np.arange(tdm.d_lo, tdm.d_lo + tdm.n_d))


@pytest.mark.parametrize("tag", TAGS + [_NESTED_TAG])
def test_level_plan_matches_jax(tag):
    jdm, tdm = _machines(tag)
    want = [dataclasses.astuple(lv) for lv in jens._level_plan(jdm)]
    got = [dataclasses.astuple(lv) for lv in tens._level_plan(tdm)]
    assert got == want


@pytest.mark.parametrize("tag", TAGS)
def test_device_machine_from_jax_fields(tag):
    """A machine compiled by the JAX package crosses over as plain
    fields and equals the port's own compilation."""
    jdm, tdm = _machines(tag)
    assert tens.device_machine_from_fields(_jax_fields(jdm)) == tdm


# --- K1's plain version against the JAX round ---------------------------------


@pytest.mark.parametrize("tag", TAGS)
def test_one_round_matches_jax_every_shift(tag):
    """One round of `run_rounds` equals JAX `_apply_plane_round_fsm_stacked`
    bit for bit at every phase, with JAX's own uniforms fed to both."""
    _, tdm = _machines(tag)
    rng = np.random.RandomState(7)
    B, L, E = 64, 256, 16
    stride = L // E
    pt, dt = _random_tapes(rng, tdm.size_a, B, L)
    jround = _jax_round(tag)
    keys = jax.random.split(jax.random.PRNGKey(3), stride)
    for shift in range(stride):
        u = jax.random.uniform(keys[shift], (B, E), dtype=jnp.float32)
        p_st, d_st = _planes(pt, stride), _planes(dt, stride)
        wp, wd = jround(_to_jax(p_st), _to_jax(d_st),
                        jnp.int32(shift), u)
        tens.run_rounds(tdm, p_st, d_st,
                        torch.tensor([shift], dtype=torch.int32),
                        torch.as_tensor(np.array(u))[None])
        np.testing.assert_array_equal(p_st.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(d_st.numpy(), np.asarray(wd))


# Symbols that reach the rules' rare branches: ex4's reverse reaction
# needs p0 = X, d0 in {B, C, D} and I/O neighbours; uniform tapes over
# all nine symbols reach it at a few sites per thousand.
_ACTIVE_SYMBOLS = {"ex4-chemical-turing": ((6, 7), (0, 1, 2, 3, 4, 5))}


def _active_draws(rng, tag, size_a, B, L, E):
    """Tapes over each tape's active symbols, and uniforms a third each
    in [0, 1e-3), [0.95, 1) and [0, 1) (rare choose branches both ends)."""
    p_sym, d_sym = _ACTIVE_SYMBOLS.get(tag, (range(size_a),) * 2)
    pt = rng.choice(np.asarray(p_sym), (B, L)).astype(np.int32)
    dt = rng.choice(np.asarray(d_sym), (B, L)).astype(np.int32)
    u = rng.rand(B, E)
    pick = rng.randint(0, 3, (B, E))
    u = np.where(pick == 0, u * 1e-3, np.where(pick == 1, 0.95 + 0.05 * u, u))
    return pt, dt, u.astype(np.float32)


@pytest.mark.parametrize("tag", TAGS)
def test_one_round_matches_jax_rare_branches(tag):
    """As above, on tapes and uniforms that drive the rare branches
    (reverse reactions, spin flips) at every phase."""
    _, tdm = _machines(tag)
    rng = np.random.RandomState(17)
    B, L, E = 64, 256, 16
    stride = L // E
    jround = _jax_round(tag)
    changed = 0
    for shift in range(stride):
        pt, dt, u = _active_draws(rng, tag, tdm.size_a, B, L, E)
        p_st, d_st = _planes(pt, stride), _planes(dt, stride)
        wp, wd = jround(_to_jax(p_st), _to_jax(d_st),
                        jnp.int32(shift), jnp.asarray(u))
        tens.run_rounds(tdm, p_st, d_st,
                        torch.tensor([shift], dtype=torch.int32),
                        torch.as_tensor(u)[None])
        np.testing.assert_array_equal(p_st.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(d_st.numpy(), np.asarray(wd))
        changed += int((tens._planes_to_tape(d_st).numpy() != dt).sum())
    assert changed > 0


@pytest.mark.parametrize("tag", TAGS)
def test_fifty_rounds_match_jax(tag):
    """50 rounds with shared numpy draws stay bit-identical."""
    _, tdm = _machines(tag)
    rng = np.random.RandomState(11)
    B, L, E, n = 64, 256, 16, 50
    stride = L // E
    pt, dt = _random_tapes(rng, tdm.size_a, B, L)
    shifts = rng.randint(0, stride, n).astype(np.int32)
    uniforms = rng.rand(n, B, E).astype(np.float32)
    jround = _jax_round(tag)
    p_st, d_st = _planes(pt, stride), _planes(dt, stride)
    jp, jd = _to_jax(p_st), _to_jax(d_st)
    for k in range(n):
        jp, jd = jround(jp, jd, jnp.int32(shifts[k]),
                        jnp.asarray(uniforms[k]))
    tens.run_rounds(tdm, p_st, d_st, torch.as_tensor(shifts),
                    torch.as_tensor(uniforms) if tdm.has_choose else None)
    np.testing.assert_array_equal(p_st.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(d_st.numpy(), np.asarray(jd))
    # The rounds did something: some cells changed.
    assert not np.array_equal(tens._planes_to_tape(p_st).numpy(), pt) or \
        not np.array_equal(tens._planes_to_tape(d_st).numpy(), dt)


@pytest.mark.parametrize("tag", TAGS)
def test_run_rounds_matches_jax_run_ensemble(tag):
    """The slice end to end: JAX `run_ensemble` (FSM plane path) against
    the port's tape->plane conversion, rounds and decode, fed the draws
    JAX's run makes from its key."""
    jdm, tdm = _machines(tag)
    rng = np.random.RandomState(5)
    B, L, E, n = 64, 256, 16, 12
    stride = L // E
    pt, dt = _random_tapes(rng, tdm.size_a, B, L)
    key = jax.random.PRNGKey(21)
    (wp, wd), (w_applied, w_times) = jens.run_ensemble(
        key, (jnp.asarray(pt), jnp.asarray(dt)), jdm, (n, E),
        bitslice=False)
    shifts, uniforms = [], []
    for k in jax.random.split(key, n):
        k1, k2 = jax.random.split(k)
        shifts.append(int(jax.random.randint(k1, (), 0, stride,
                                             dtype=jnp.int32)))
        uniforms.append(np.asarray(
            jax.random.uniform(k2, (B, E), dtype=jnp.float32)))
    p_st, d_st = _planes(pt, stride), _planes(dt, stride)
    tens.run_rounds(tdm, p_st, d_st, torch.tensor(shifts, dtype=torch.int32),
                    torch.as_tensor(np.stack(uniforms)))
    st = tens.PlaneState(p_st, d_st, batch=B, length=L)
    gp, gd = st.tapes()
    assert gp.dtype == torch.int32 and gp.shape == (B, L)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    # applied and times of the port's own run, against JAX's: times to
    # 1 ulp-level (log1p of two libraries), applied exactly.
    _, (applied, times) = tens.run_ensemble(0, (pt, dt), tdm, (n, E),
                                            device="cpu")
    assert applied.dtype == torch.int64 and times.dtype == torch.float64
    np.testing.assert_array_equal(applied.numpy(), np.asarray(w_applied))
    np.testing.assert_allclose(times.numpy(), np.asarray(w_times),
                               rtol=1e-15, atol=0)


_NESTED_CUM2 = np.array([0.5, 0.75])  # the second choose's thresholds


def _nested_threshold_uniforms():
    """float32 uniforms in the first choose's branch 0, packed next to
    the second choose's thresholds as the first renormalises them."""
    us = []
    for c in _NESTED_CUM2:
        centre = np.float32(c * 0.7)
        us.append(centre + np.arange(-2000, 2000, dtype=np.float32)
                  * np.spacing(centre))
    u = np.concatenate(us).astype(np.float32)
    return u[u < 0.7]


def test_nested_choose_float32_width_matches_jax():
    """The reference's walk divides the first choose group's branch-0
    uniform by a float32 width; the port reproduces that rounding.
    Uniforms packed next to the second choose's thresholds make the
    difference visible, and the test first checks that a float64 width
    would indeed have picked other branches there."""
    jdm, tdm = _machines(_NESTED_TAG)
    w0 = np.float64(np.float32(0.7))
    u = _nested_threshold_uniforms()
    cum2 = _NESTED_CUM2
    u64 = u.astype(np.float64)
    with_f32 = np.searchsorted(cum2, u64 / w0, side="right")
    with_f64 = np.searchsorted(cum2, u64 / 0.7, side="right")
    assert np.any(with_f32 != with_f64)  # the test can see the rounding
    cells = [np.zeros(u.shape, np.int8)] * tdm.n_cells
    want = jens._machine_specs_planes_leveled(
        jdm, [jnp.asarray(c) for c in cells], jnp.asarray(u))
    got = tens._walk_plain(tdm, [torch.as_tensor(c) for c in cells],
                           torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- K1's generated unit, built for the host ------------------------------------


def _cxx():
    return next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                       "clang++")) if c),
                None)


@pytest.fixture(scope="module")
def k1_host_library(tmp_path_factory):
    """Builds K1's unit of a machine with the host's C++ compiler (once
    per machine) and returns its `ckpe_k1_host_round`."""
    cxx = _cxx()
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    built = {}

    def get(tag):
        if tag not in built:
            out = tmp_path_factory.mktemp("k1")
            unit = out / "k1.cpp"
            unit.write_text(k1_source.k1_source(_machines(tag)[1]))
            lib = out / "libk1.so"
            subprocess.run(
                [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                 "-shared", "-fPIC", "-I", str(cuda.CSRC_DIR), "-o",
                 str(lib), str(unit)], check=True, capture_output=True,
                timeout=300)
            fn = ctypes.CDLL(str(lib)).ckpe_k1_host_round
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            fn.restype = ctypes.c_int
            built[tag] = fn
        return built[tag]

    return get


@pytest.mark.parametrize("B,L,E", [(61, 128, 8), (37, 112, 7)],
                         ids=["words", "bytes"])
@pytest.mark.parametrize("tag", TAGS + [_NESTED_TAG])
def test_generated_kernel_matches_plain_round(k1_host_library, tag, B, L, E):
    """K1's per-thread body, compiled from the machine's generated unit
    and run for every thread on the host, gives the plain round's planes
    at every phase: on the word path (E a multiple of 4) and the byte
    path (E not), with cells that spill to either side of the row, and
    with out-of-range symbols in two rows (the exact walk)."""
    _, tdm = _machines(tag)
    round_fn = k1_host_library(tag)
    rng = np.random.RandomState(4)
    stride = L // E
    changed = 0
    for shift in range(stride):
        pt, dt, u = _active_draws(rng, tag, tdm.size_a, B, L, E)
        if tag == _NESTED_TAG:
            near = _nested_threshold_uniforms()
            u.ravel()[::2] = rng.choice(near, u.size - u.size // 2)
        pt[0, ::9] = tdm.size_a + 3
        dt[1, ::5] = -2
        p_st, d_st = _planes(pt, stride), _planes(dt, stride)
        kp, kd = p_st.numpy().copy(), d_st.numpy().copy()
        assert round_fn(kp.ctypes.data, kd.ctypes.data, u.ctypes.data,
                        shift, B, E, stride) == 0
        tens.plane_round_plain(tdm, p_st, d_st,
                               torch.tensor([shift], dtype=torch.int32), 0,
                               torch.as_tensor(u))
        np.testing.assert_array_equal(kp, p_st.numpy())
        np.testing.assert_array_equal(kd, d_st.numpy())
        changed += int((tens._planes_to_tape(d_st).numpy() != dt).sum())
    assert changed > 0


def test_generated_source_is_deterministic_and_keyed_on_fields():
    """The same machine gives the same unit, and so the same library
    name; a machine with the same tag and other fields gives another."""
    _, tdm = _machines("ex5-msrtf-machine")
    fresh = tens.compile_decision_machine("ex5-msrtf-machine")
    src = k1_source.k1_source(tdm)
    assert src == k1_source.k1_source(fresh)
    path = cuda.unit_library_path("k1", src)
    assert path == cuda.unit_library_path("k1", k1_source.k1_source(fresh))
    wr = list(tdm.wr_words)
    wr[4] = (wr[4][0] ^ (1 << 4),) + wr[4][1:]
    other = dataclasses.replace(tdm, wr_words=tuple(wr))
    assert other.tag == tdm.tag
    other_src = k1_source.k1_source(other)
    assert other_src != src
    assert cuda.unit_library_path("k1", other_src) != path


@pytest.mark.parametrize("tag", TAGS + [_NESTED_TAG])
def test_cell_traffic_is_what_the_round_reads_and_writes(tag):
    """K1's bound counts the cells of `cell_traffic`: cells outside its
    written set keep their symbols, and cells outside its read set change
    no written cell."""
    _, tdm = _machines(tag)
    read, written = k1_source.cell_traffic(tdm)
    rng = np.random.RandomState(7)
    n = 4096
    cells = [torch.as_tensor(rng.randint(0, tdm.size_a, n).astype(np.int8))
             for _ in range(tdm.n_cells)]
    u = torch.as_tensor(rng.rand(n).astype(np.float32))
    outs = tens._writes_plain(tdm, tens._walk_plain(tdm, cells, u), cells)
    for c in range(tdm.n_cells):
        if c not in written:
            assert torch.equal(outs[c], cells[c])
    assert any(not torch.equal(outs[c], cells[c]) for c in written)
    other = [x if c in read else torch.as_tensor(
        rng.randint(0, tdm.size_a, n).astype(np.int8))
        for c, x in enumerate(cells)]
    outs2 = tens._writes_plain(tdm, tens._walk_plain(tdm, other, u), other)
    for c in written:
        assert torch.equal(outs2[c], outs[c])


# --- run_ensemble --------------------------------------------------------------


@pytest.mark.parametrize("tag", ["ex5-msrtf-machine", "ex4-chemical-turing"])
def test_plane_state_continuation_matches_one_long_run(tag):
    """Two chained calls (tapes in and out, or PlaneState kept) equal
    one `run_rounds` over both calls' draws, and a PlaneState passed in
    is left unchanged."""
    _, tdm = _machines(tag)
    rng = np.random.RandomState(9)
    B, L, E, n = 32, 128, 8, 7
    stride = L // E
    pt, dt = _random_tapes(rng, tdm.size_a, B, L)
    seeds = (101, 202)

    # K1's plane path (at B = 32 the default takes the bit-sliced round).
    (p_a, d_a), _ = tens.run_ensemble(seeds[0], (pt, dt), tdm, (n, E),
                                      bitslice=False, device="cpu")
    (p_a, d_a), (app_a, t_a) = tens.run_ensemble(
        seeds[1], (p_a, d_a), tdm, (n, E), bitslice=False, device="cpu")

    st, _ = tens.run_ensemble(seeds[0], (pt, dt), tdm, (n, E),
                              bitslice=False, keep_planes=True, device="cpu")
    assert isinstance(st, tens.PlaneState) and st.kind == "fsm"
    before = (st.pbp.clone(), st.dbp.clone())
    st2, (app_b, t_b) = tens.run_ensemble(seeds[1], st, tdm, (n, E),
                                          keep_planes=True, device="cpu")
    assert torch.equal(st.pbp, before[0]) and torch.equal(st.dbp, before[1])
    p_b, d_b = st2.tapes()
    (p_c, d_c), _ = tens.run_ensemble(seeds[1], st, tdm, (n, E),
                                      device="cpu")

    shifts, uniforms = [], []
    for seed in seeds:  # run_ensemble's draw order
        g = torch.Generator().manual_seed(seed)
        shifts.append(torch.randint(0, stride, (n,), generator=g,
                                    dtype=torch.int32))
        if tdm.has_choose:
            uniforms += [torch.rand((B, E), generator=g) for _ in range(n)]
    p_st, d_st = _planes(pt, stride), _planes(dt, stride)
    tens.run_rounds(tdm, p_st, d_st, torch.cat(shifts),
                    torch.stack(uniforms) if uniforms else None)
    long_p, long_d = tens.PlaneState(p_st, d_st, batch=B, length=L).tapes()

    for got_p, got_d in ((p_a, d_a), (p_b, d_b), (p_c, d_c)):
        assert torch.equal(got_p, long_p) and torch.equal(got_d, long_d)
    assert torch.equal(app_a, app_b) and torch.equal(t_a, t_b)
    assert not torch.equal(long_d, torch.as_tensor(dt))


def test_chunked_uniform_draws_match_one_chunk(monkeypatch):
    """`run_ensemble` draws a choose machine's uniforms a chunk of rounds
    at a time; chunks of three rounds give the tapes of one chunk."""
    _, tdm = _machines("ex4-chemical-turing")
    rng = np.random.RandomState(12)
    B, L, E, n = 16, 128, 8, 7
    tapes = _active_draws(rng, "ex4-chemical-turing", tdm.size_a, B, L, E)[:2]
    (p_one, d_one), _ = tens.run_ensemble(3, tapes, tdm, (n, E),
                                          device="cpu")
    monkeypatch.setattr(tens, "_UNIFORM_CHUNK", 3 * B * E)
    calls = tens.plane_round_plain.calls
    (p_ch, d_ch), _ = tens.run_ensemble(3, tapes, tdm, (n, E), device="cpu")
    assert tens.plane_round_plain.calls == calls + n
    assert torch.equal(p_one, p_ch) and torch.equal(d_one, d_ch)
    assert not torch.equal(d_one, torch.as_tensor(tapes[1]))


def test_plane_storage_roundtrip():
    rng = np.random.RandomState(1)
    tape = torch.as_tensor(rng.randint(0, 5, (3, 64)).astype(np.int8))
    planes = tens._tape_to_planes(tape, 16)
    assert planes.shape == (16, 3, 4)
    np.testing.assert_array_equal(planes[5].numpy(), tape.numpy()[:, 5::16])
    assert torch.equal(tens._planes_to_tape(planes), tape)
    want = jnp.stack(jens._tape_to_planes(jnp.asarray(tape.numpy()), 16))
    np.testing.assert_array_equal(planes.numpy(), np.asarray(want))


@pytest.mark.parametrize("tau", [0.3, 0.5, 0.7])
def test_choose_sampling_dist_matches_jax(tau):
    """Tempered choose sampling (once the raise of an unported path):
    q ∝ p^tau and the increments log p − log q equal the JAX package's
    bit for bit, zero-probability branches included."""
    for probs in ((0.5, 0.5), (0.1, 0.0, 0.6, 0.3), (1e-9, 1.0 - 1e-9)):
        q, delta = tens._choose_sampling_dist(probs, tau)
        jq, jdelta = jens._choose_sampling_dist(probs, tau)
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(delta, jdelta)


def test_round_geometry_checks():
    _, tdm = _machines("ex5-msrtf-machine")
    tapes = (np.zeros((4, 64), np.int32),) * 2
    with pytest.raises(ValueError, match="divide"):
        tens.run_ensemble(0, tapes, tdm, (1, 5), device="cpu")
    with pytest.raises(ValueError, match="too small"):
        tens.run_ensemble(0, tapes, tdm, (1, 16), device="cpu")
    st, _ = tens.run_ensemble(0, tapes, tdm, (1, 4), keep_planes=True,
                              device="cpu")
    with pytest.raises(ValueError, match="stride"):
        tens.run_ensemble(0, st, tdm, (1, 2), device="cpu")


def test_choose_machine_needs_uniforms():
    _, tdm = _machines("ex4-chemical-turing")
    p_st = torch.zeros((16, 2, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="uniforms"):
        tens.run_rounds(tdm, p_st, p_st.clone(),
                        torch.zeros(1, dtype=torch.int32))


def test_cuda_is_the_default_device():
    """Entry points go to cuda unless asked; without a card that
    request raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert config.get_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config.get_device()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tens.window_counts(np.zeros((1, 4), np.int32), 2, 2)
    assert config.get_device("cpu") == CPU


# --- Observables ---------------------------------------------------------------


@pytest.mark.parametrize("size_a,cl_k,B,L", [
    (2, 2, 3, 17), (5, 3, 8, 64), (9, 2, 4, 33), (2, 5, 16, 128),
])
def test_window_counts_matches_jax(size_a, cl_k, B, L):
    rng = np.random.RandomState(size_a * 10 + cl_k)
    tape = rng.randint(0, size_a, (B, L)).astype(np.int32)
    want = np.asarray(jens.window_counts(jnp.asarray(tape), size_a, cl_k))
    got = tens.window_counts(tape, size_a, cl_k, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert tens.window_counts_plain(torch.as_tensor(tape), size_a,
                                    cl_k).sum() == B * L


def _wrap_symbol(size_a, cl_k):
    """An int32 symbol s for which the int32 rank of the window
    [s, 0, ..., 0], s * size_a**(cl_k-1), wraps into [0, size_a**cl_k)
    although s * size_a**(cl_k-1) itself lies far above it."""
    s = 2**32 // size_a ** (cl_k - 1) + 1
    return s - 2**32 if s >= 2**31 else s


def _edge_tape(kind, rng, size_a, cl_k, B, L):
    """A [B, L] int32 tape whose windows the reference's rank rule
    treats apart from in-range ones: ``negative`` symbols in
    [-size_a, size_a); ``wrap``, in-range symbols with every tenth site
    the wrap symbol or its negative; ``edge``, windows of rank exactly
    -n and -n-1 (n = size_a**cl_k) among in-range symbols; ``constant``,
    every symbol -1."""
    if kind == "negative":
        return rng.randint(-size_a, size_a, (B, L)).astype(np.int32)
    if kind == "constant":
        return np.full((B, L), -1, np.int32)
    tape = rng.randint(0, size_a, (B, L)).astype(np.int64)
    if kind == "wrap":
        s = _wrap_symbol(size_a, cl_k)
        pick = rng.randint(0, 10, (B, L))
        tape[pick == 0] = s
        tape[pick == 1] = -s
    else:
        assert kind == "edge"
        for b in range(B):
            for i in range(0, L - cl_k, 2 * cl_k):
                tape[b, i:i + cl_k] = 0
                tape[b, i] = -size_a  # rank -n
                if (b + i) % 3 == 0:
                    tape[b, i + cl_k - 1] = -1  # rank -n-1
    return tape.astype(np.int32)


_EDGE_KINDS = ["negative", "wrap", "edge", "constant"]


@pytest.mark.parametrize("cl_k", [2, 3, 4])
@pytest.mark.parametrize("size_a", [2, 5, 9])
@pytest.mark.parametrize("kind", _EDGE_KINDS)
def test_window_counts_out_of_range_symbols_match_jax(kind, size_a, cl_k):
    """Symbols outside [0, size_a): the reference's int32 rank wraps and
    its scatter counts a rank in [-n, 0) in bin rank + n; the port's
    counts equal it exactly."""
    rng = np.random.RandomState(100 * size_a + 10 * cl_k
                                + _EDGE_KINDS.index(kind))
    tape = _edge_tape(kind, rng, size_a, cl_k, 5, 37)
    want = np.asarray(jens.window_counts(jnp.asarray(tape), size_a, cl_k))
    got = tens.window_counts(tape, size_a, cl_k, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


_K2_HOST_LOOP = r"""
#include "window_rule.cuh"
extern "C" void k2_host_counts(const int* tape, long long B, int L,
                               int size_a, int cl_k, long long* counts) {
  long long n = 1;
  for (int j = 0; j < cl_k; ++j) n *= size_a;
  for (long long b = 0; b < B; ++b)
    for (int i = 0; i < L; ++i) {
      unsigned int rank = 0;
      for (int j = 0; j < cl_k; ++j)
        rank = k2_rank_step(rank, size_a, tape[b * L + (i + j) % L]);
      const int bin = k2_bin(rank, (int)n);
      if (bin >= 0) ++counts[bin];
    }
}
"""


@pytest.fixture(scope="module")
def k2_host_counts(tmp_path_factory):
    """K2's per-site rule (`csrc/window_rule.cuh`) built with the host's
    C++ compiler into a loop over every site."""
    cxx = _cxx()
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k2")
    (out / "k2.cpp").write_text(_K2_HOST_LOOP)
    lib = out / "libk2.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(cuda.CSRC_DIR), "-o", str(lib), str(out / "k2.cpp")],
                   check=True, capture_output=True, timeout=120)
    fn = ctypes.CDLL(str(lib)).k2_host_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = None
    return fn


@pytest.mark.parametrize("size_a,cl_k", [(2, 2), (5, 3), (9, 4), (2, 14)])
@pytest.mark.parametrize("kind", _EDGE_KINDS)
def test_window_rule_matches_plain(k2_host_counts, kind, size_a, cl_k):
    """K2's rank-and-bin rule, compiled for the host, counts every window
    as `window_counts_plain` does, out-of-range symbols included."""
    rng = np.random.RandomState(size_a + cl_k)
    tape = _edge_tape(kind, rng, size_a, cl_k, 6, 41)
    counts = np.zeros(size_a**cl_k, np.int64)
    k2_host_counts(tape.ctypes.data, *tape.shape, size_a, cl_k,
                   counts.ctypes.data)
    np.testing.assert_array_equal(
        counts, tens.window_counts_plain(torch.as_tensor(tape), size_a,
                                         cl_k).numpy())


def test_window_counts_simple():
    counts = tens.window_counts(np.asarray([[0, 1, 0, 1]]), 2, 2,
                                device="cpu")
    np.testing.assert_allclose(counts.numpy(), [0, 0.5, 0.5, 0])


def test_sample_tapes_from_spd_statistics():
    """The JAX package's statistical gate, at its tolerance."""
    q = np.array([0.8, 0.2])
    spd = np.einsum("i,j->ij", q, q).ravel()
    tapes = tens.sample_tapes_from_spd(4, spd, 2, 2, 16, 4096, device="cpu")
    assert tapes.dtype == torch.int32 and tapes.shape == (16, 4096)
    counts = tens.window_counts(tapes, 2, 2, device="cpu")
    np.testing.assert_allclose(counts.numpy(), spd, atol=0.01)


def test_ring_bridge_sampling_has_no_seam_artifact():
    """The ex2 pair SPD has exactly zero single-U islands (p(DUD) = 0);
    the ring bridge must not fabricate them at the seam, and the bulk
    window statistics must follow the SPD."""
    from chemical_kinetics_and_program_execution_tpu.models.initial_states import (  # noqa: E501
        ferromagnet_p0,
    )

    p0 = np.asarray(ferromagnet_p0(5, p_pair=1 / 250)).ravel()
    tapes = tens.sample_tapes_from_spd(0, p0, 2, 5, 2048, 128, device="cpu")
    c = tens.window_counts(tapes, 2, 5, device="cpu").numpy()
    assert c.reshape((2,) * 5)[0, 1, 0].sum() == 0.0
    assert np.abs(c - p0).sum() < 0.02


# --- Package boundary ------------------------------------------------------------


def test_port_imports_no_jax():
    """The port (every module of it, the exact closure's solves by DOP853
    and dopri5 driven once, a pruned ex6 program through the C++
    enumerator with its mass) imports neither jax nor the JAX
    package."""
    code = (
        "import sys\n"
        "import chemical_kinetics_and_program_execution_torch as p\n"
        "from chemical_kinetics_and_program_execution_torch import cuda\n"
        "from chemical_kinetics_and_program_execution_torch.engine import "
        "ensemble\n"
        "ensemble.compile_decision_machine('ex4-chemical-turing')\n"
        "from chemical_kinetics_and_program_execution_torch import "
        "markov_tapes\n"
        "from chemical_kinetics_and_program_execution_torch.engine import "
        "compile, dense\n"
        "from chemical_kinetics_and_program_execution_torch.models import "
        "initial_states\n"
        "from chemical_kinetics_and_program_execution_torch.ode import "
        "dop853, dopri5, integrate\n"
        "from chemical_kinetics_and_program_execution_torch.ops import "
        "observables\n"
        "markov_tapes._run_validation(device='cpu')\n"
        "markov_tapes.ode_integrate_ivp(tag='ex1-radioactive-decay', "
        "size_a=2, cl_k=3, p0=[1/8] * 8, ts=[0, 1], backend='torch', "
        "device='cpu', ivp_kwargs=dict(rtol=1e-10, atol=1e-10))\n"
        "markov_tapes.ode_integrate(tag='ex1-radioactive-decay', size_a=2, "
        "cl_k=3, p0=[1/8] * 8, ts=[0, 1], backend='torch', device='cpu')\n"
        "prog = dense.compile_dense('ex6-mini-bff', 2, prune_threshold=1e-3)\n"
        "dense.make_dense_dy_dt(prog, with_mass=True, device='cpu')([1/144] "
        "* 144)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'chemical_kinetics_and_program_execution_tpu'))]\n"
        "assert not bad, bad\n"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """Without `nvcc` the build raises (nothing falls back to the plain
    versions on a card) and leaves no build directory behind."""
    monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda.Path, "is_file", lambda self: False)
    monkeypatch.setattr(cuda, "library_path",
                        lambda: cuda.BUILD_DIR / "absent.so")
    existed = cuda.BUILD_DIR.exists()
    with pytest.raises(FileNotFoundError, match="nvcc"):
        cuda.build()
    assert cuda.BUILD_DIR.exists() == existed
