"""Parity of the PyTorch port's ensemble slice with the JAX package (CPU).

The same inputs, made with numpy or drawn by JAX, go through the JAX
functions and through the port's plain path; integer and bit logic must
agree bit for bit, and float64 observables exactly where the arithmetic
is the same. The port's CUDA kernels run only on the card
(`tests/test_torch_gpu.py`); here the flat kernel plan they read is
checked through a Python model of the kernel's per-site loop.
"""

import dataclasses
import functools
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


def test_nested_choose_float32_width_matches_jax():
    """The reference's walk divides the first choose group's branch-0
    uniform by a float32 width; the port reproduces that rounding.
    Uniforms packed next to the second choose's thresholds make the
    difference visible, and the test first checks that a float64 width
    would indeed have picked other branches there."""
    jdm, tdm = _machines(_NESTED_TAG)
    w0 = np.float64(np.float32(0.7))
    cum2 = np.array([0.5, 0.75])  # the second choose's thresholds
    us = []
    for c in cum2:
        centre = np.float32(c * 0.7)
        us.append(centre + np.arange(-2000, 2000, dtype=np.float32)
                  * np.spacing(centre))
    u = np.concatenate(us).astype(np.float32)
    u = u[u < 0.7]  # branch 0 of the first choose
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


# --- The flat plan K1 reads ---------------------------------------------------


def _kernel_model_round(dm, p_st, d_st, shift, uniforms):
    """A line-by-line Python model of `csrc/plane_round.cu`'s per-site
    loop, reading only the flat plan arrays (the kernel's inputs)."""
    ints, fl = (a.tolist() for a in tens._kernel_plan(dm))
    n_p, (p_lo, d_lo, S, n_levels, wr_bits, off_wr, n_cells) = (
        ints[0], ints[2:9])
    off_wf, n_wf = ints[9], ints[10]
    stride, B, E = p_st.shape
    sts = (p_st, d_st)

    def field_at(n_fields, off_fields, n_words, off_words, idx, bits):
        if 0 <= idx < n_fields:
            return ints[off_fields + idx]
        per = 31 // bits
        widx, sh = idx // per, bits * (idx % per)
        w = ints[off_words + widx] if 1 <= widx < n_words else ints[off_words]
        return (w >> sh) & ((1 << bits) - 1)

    for b in range(B):
        for i in range(E):
            loc, cells = [], []
            for k in range(n_cells):
                data = k >= n_p
                a = shift + (d_lo + k - n_p if data else p_lo + k)
                c, e = a % stride, a // stride
                loc.append((int(data), c, (i + e) % E))
                cells.append(int(sts[int(data)][c, b, (i + e) % E]))
            state = S
            u = float(uniforms[b, i]) if uniforms is not None else 0.0
            for lvl in range(n_levels):
                lv = ints[16 + 10 * lvl:26 + 10 * lvl]
                branch = 0
                if lv[0]:
                    branch = cells[ints[lv[1]]]
                    for g in range(1, lv[0]):
                        if state >= S + ints[lv[1] + 2 * g + 1]:
                            branch = cells[ints[lv[1] + 2 * g]]
                for g in range(lv[2]):
                    id_lo, id_hi, n_br, off_f, f32_div = ints[
                        lv[3] + 5 * g:lv[3] + 5 * g + 5]
                    if not S + id_lo <= state <= S + id_hi:
                        continue
                    cum, width = fl[off_f:off_f + n_br - 1], fl[
                        off_f + n_br - 1:off_f + 2 * n_br - 1]
                    bb, lo, w = 0, 0.0, width[0]
                    for j in range(1, n_br):
                        if u >= cum[j - 1]:
                            bb, lo, w = j, cum[j - 1], width[j]
                    branch = bb
                    u = (float(np.float32(u) / np.float32(w)) if f32_div
                         else (u - lo) / w)
                idx = max(state - S, 0) * lv[4] + branch
                nxt = field_at(lv[8], lv[9], lv[6], lv[7], idx, lv[5])
                if state >= S:
                    state = nxt
            for k in range(n_cells):
                if 0 <= state < n_wf:
                    f = ints[off_wf + state * n_cells + k]
                else:
                    f = field_at(0, 0, ints[off_wr + 2 * k],
                                 ints[off_wr + 2 * k + 1], state, wr_bits)
                if f >> (wr_bits - 1) == 1:
                    t, c, col = loc[k]
                    sts[t][c, b, col] = f & ((1 << (wr_bits - 1)) - 1)


@pytest.mark.parametrize("tag", TAGS)
def test_kernel_plan_model_matches_plain_round(tag):
    """K1's flat plan, read the way the CUDA kernel reads it, gives the
    plain round's planes at every phase (so a fault on the card is in
    the CUDA code, not in the plan it was handed)."""
    _, tdm = _machines(tag)
    rng = np.random.RandomState(2)
    B, L, E = 4, 128, 8
    stride = L // E
    pt, dt = _random_tapes(rng, tdm.size_a, B, L)
    for shift in range(stride):
        u = torch.as_tensor(rng.rand(B, E).astype(np.float32))
        p_st, d_st = _planes(pt, stride), _planes(dt, stride)
        mp, md = p_st.numpy().copy(), d_st.numpy().copy()
        _kernel_model_round(tdm, mp, md, shift,
                            u.numpy() if tdm.has_choose else None)
        tens.run_rounds(tdm, p_st, d_st,
                        torch.tensor([shift], dtype=torch.int32), u[None])
        np.testing.assert_array_equal(mp, p_st.numpy())
        np.testing.assert_array_equal(md, d_st.numpy())


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

    (p_a, d_a), _ = tens.run_ensemble(seeds[0], (pt, dt), tdm, (n, E),
                                      device="cpu")
    (p_a, d_a), (app_a, t_a) = tens.run_ensemble(
        seeds[1], (p_a, d_a), tdm, (n, E), device="cpu")

    st, _ = tens.run_ensemble(seeds[0], (pt, dt), tdm, (n, E),
                              keep_planes=True, device="cpu")
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


def test_plane_storage_roundtrip():
    rng = np.random.RandomState(1)
    tape = torch.as_tensor(rng.randint(0, 5, (3, 64)).astype(np.int8))
    planes = tens._tape_to_planes(tape, 16)
    assert planes.shape == (16, 3, 4)
    np.testing.assert_array_equal(planes[5].numpy(), tape.numpy()[:, 5::16])
    assert torch.equal(tens._planes_to_tape(planes), tape)
    want = jnp.stack(jens._tape_to_planes(jnp.asarray(tape.numpy()), 16))
    np.testing.assert_array_equal(planes.numpy(), np.asarray(want))


@pytest.mark.parametrize("kwargs,match", [
    (dict(bitslice=True), "bit-sliced"),
    (dict(independent_sites=True), "lattice"),
])
def test_unported_run_options_raise(kwargs, match):
    _, tdm = _machines("ex5-msrtf-machine")
    tapes = (np.zeros((32, 64), np.int32),) * 2
    with pytest.raises(NotImplementedError, match=match):
        tens.run_ensemble(0, tapes, tdm, (2, 4), device="cpu", **kwargs)


def test_unported_paths_raise():
    _, tdm = _machines("ex5-msrtf-machine")
    tapes = (np.zeros((4, 1024), np.int32),) * 2
    table = jens.device_table(jens.compile_transition_table(
        "ex2-ferromagnetic-chain"))
    with pytest.raises(NotImplementedError, match="transition-table"):
        tens.run_ensemble(0, tapes, table, (2, 64), device="cpu")
    with pytest.raises(NotImplementedError, match="stride > 64"):
        tens.run_ensemble(0, tapes, tdm, (2, 8), device="cpu")
    with pytest.raises(NotImplementedError, match="tau"):
        tens._choose_sampling_dist((0.5, 0.5), tau=0.5)


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
    """The port (every module of it) imports neither jax nor the JAX
    package."""
    code = (
        "import sys\n"
        "import chemical_kinetics_and_program_execution_torch as p\n"
        "from chemical_kinetics_and_program_execution_torch import cuda\n"
        "from chemical_kinetics_and_program_execution_torch.engine import "
        "ensemble\n"
        "ensemble.compile_decision_machine('ex4-chemical-turing')\n"
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
