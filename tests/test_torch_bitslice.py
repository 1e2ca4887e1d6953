"""Parity of the PyTorch port's bit-sliced rounds with the JAX package (CPU).

The same machines, tapes, shifts and random words go through the JAX
package's `engine/bitslice.py` and the port's: circuits must come out op
for op the same, words and tapes bit for bit (the port's int32 words
read as the reference's uint32 ones). The port's own runs are held to
its FSM plane path (bit for bit for choose-free machines) and to the
sampled law. K14's generated unit is built here with the host's C++
compiler and its per-thread body, run for every word column in a host
loop, is held to the plain round; the kernels themselves run only on
the card (`tests/test_torch_gpu.py`).
"""

import ctypes
import functools
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu.engine import (
    bitslice as jbs,
)
from chemical_kinetics_and_program_execution_tpu.engine import (
    ensemble as jens,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.engine import (
    bitslice as tbs,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    bitslice_source,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as tens,
)

EX5, EX4, EX2 = ("ex5-msrtf-machine", "ex4-chemical-turing",
                 "ex2-ferromagnetic-chain")
ROUND_TAGS = ["ex1-radioactive-decay", EX5, "ex5var1-msrtf-machine"]
SAMPLING_TAGS = [EX2, "ex3-copolymerization", "ex3var2-copolymerization",
                 EX4, "fuzz-wide-specs"]
# Every rule the port registers whose machine compiles in seconds (the
# ex6 rules left out take minutes to enumerate, and ex6-mini-bff never
# finishes).
ELIGIBILITY_TAGS = [
    "__canary_problem_radioactive_decay", "ex1-radioactive-decay", EX2,
    "ex3-copolymerization", "ex3var1-copolymerization",
    "ex3var2-copolymerization", EX4, "ex4var1-chemical-turing",
    "ex4var2-chemical-turing", EX5, "ex5var1-msrtf-machine",
    "ex6-mini-bff-lite", "fuzz-wide-specs"]
# (B, L, E): the straight layout, the 2-D transposed [E, W] one and the
# reference's 3-D [E, S, P] one (W = 256 splits as 2 x 128 at E = 1).
LAYOUTS = {"straight": (64, 256, 16), "2d": (4096, 64, 4),
           "3d": (8192, 16, 1)}


@functools.lru_cache(maxsize=None)
def _machines(tag):
    return (jens.compile_decision_machine(tag),
            tens.compile_decision_machine(tag))


@functools.lru_cache(maxsize=None)
def _circuits(tag):
    jdm, tdm = _machines(tag)
    jc = (jbs.compile_round_circuit(jdm) if jbs.machine_is_bitsliceable(jdm)
          else jbs.compile_sampling_circuit(jdm))
    return jc, tbs.machine_circuit(tdm)


def _u32(t):
    """The port's int32 words as the reference's uint32 ones."""
    return t.numpy().view(np.uint32)


def _i32(a):
    """uint32 words (numpy or JAX) as the port's int32 tensor."""
    return torch.as_tensor(np.asarray(a).view(np.int32).copy())


def _tapes(rng, size_a, B, L):
    return (rng.randint(0, size_a, (B, L)).astype(np.int32),
            rng.randint(0, size_a, (B, L)).astype(np.int32))


def _geometry(B, L, E):
    """(stride, transpose, word shape, site axis) as `run_ensemble`
    chooses them."""
    transpose = E < B // 32
    wshape = (tbs.transposed_word_shape(E, B // 32) if transpose
              else (B // 32, E))
    return L // E, transpose, wshape, (-len(wshape) if transpose else -1)


# --- Circuits ---------------------------------------------------------------------


@pytest.mark.parametrize("tag", ROUND_TAGS)
def test_round_circuit_matches_jax(tag):
    jdm, tdm = _machines(tag)
    assert tbs.machine_is_bitsliceable(tdm)
    want = jbs.compile_round_circuit(jdm)
    got = tbs.compile_round_circuit(tdm)
    assert got == want and got[3] == 0
    assert tbs.compile_round_circuit(tdm) is got  # cached per machine


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
@pytest.mark.parametrize("tag", SAMPLING_TAGS)
def test_sampling_circuit_matches_jax(tag, split):
    jdm, tdm = _machines(tag)
    want = jbs.compile_sampling_circuit(jdm, force_split=split)
    got = tbs.compile_sampling_circuit(tdm, force_split=split)
    assert got == want
    assert tens.circuit_from_jax(want) == got


@pytest.mark.parametrize("tag", ELIGIBILITY_TAGS)
def test_eligibility_matches_jax(tag):
    """Twin of tests/test_ensemble.py:279 on every rule that compiles in
    seconds: the predicates agree, the CPU's circuit limit included (and
    the card takes any circuit)."""
    jdm, tdm = _machines(tag)
    assert tbs.machine_is_bitsliceable(tdm) == jbs.machine_is_bitsliceable(
        jdm)
    assert tbs.machine_is_sampleable(tdm) == jbs.machine_is_sampleable(jdm)
    assert tbs.circuit_cpu_ok(tdm, "cpu") == jbs.circuit_cpu_ok(jdm)
    assert tbs.circuit_cpu_ok(tdm, "cuda")


def test_bitslice_eligibility():
    """tests/test_ensemble.py:279 itself."""
    assert tbs.machine_is_bitsliceable(_machines(EX5)[1])
    assert not tbs.machine_is_bitsliceable(_machines(EX4)[1])
    assert not tbs.machine_is_bitsliceable(_machines(EX2)[1])


@pytest.mark.parametrize("tag", [EX5, EX4, EX2, "fuzz-wide-specs"])
def test_eval_circuit_matches_jax(tag):
    """`_eval_circuit` on int32 words equals the reference's on the same
    uint32 words from numpy, lane 31 included."""
    jc, tc = _circuits(tag)
    ops, outputs, nb, n_rand = tc
    n_in = _machines(tag)[1].n_cells * nb + n_rand
    rng = np.random.default_rng(len(tag))
    words = [rng.integers(0, 2**32, size=(3, 37), dtype=np.uint32)
             for _ in range(n_in)]
    want = jbs._eval_circuit(jc[0], jc[1], words, (3, 37))
    got = tbs._eval_circuit(ops, outputs, [_i32(w) for w in words], (3, 37))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_u32(g), np.asarray(w, np.uint32))


def test_sampling_circuit_split_matches_unsplit():
    """Twin of tests/test_ensemble.py:1159: the split synthesis gives the
    whole-level circuit's output words, on the port's evaluator."""
    tdm = _machines("fuzz-wide-specs")[1]
    c0 = tbs.compile_sampling_circuit(tdm)
    c1 = tbs.compile_sampling_circuit(tdm, force_split=True)
    assert c0[2:] == c1[2:] and len(c0[1]) == len(c1[1])
    n_in = tdm.n_cells * c0[2] + c0[3]
    g = torch.Generator().manual_seed(0)
    words = [tbs.draw_rand_words(g, (9,), "cpu") for _ in range(n_in)]
    for a, b in zip(tbs._eval_circuit(c0[0], c0[1], words, (9,)),
                    tbs._eval_circuit(c1[0], c1[1], words, (9,))):
        assert torch.equal(a, b)


# --- K15's transposes --------------------------------------------------------------


@pytest.mark.parametrize("E,W", [(256, 512), (2, 312500), (2, 1024),
                                 (2, 128), (1, 256), (4, 128), (16, 2)])
def test_transposed_word_shape_matches_jax(E, W):
    assert tbs.transposed_word_shape(E, W) == jbs.transposed_word_shape(E, W)


def test_transposed_word_shape_cost_choice():
    """Twin of tests/test_ensemble.py:299."""
    assert tbs.transposed_word_shape(256, 512) == (256, 512)
    shape = tbs.transposed_word_shape(2, 312500)
    assert len(shape) == 3 and shape[0] == 2 and shape[1] * shape[2] == 312500
    assert tbs.transposed_word_shape(2, 1024) == (2, 8, 128)
    assert tbs.transposed_word_shape(2, 128) == (2, 128)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.int32, torch.int8])
def test_tape_transposes_match_jax(layout, dtype):
    """`tapes_to_bitplanes` and `bitplanes_to_tapes` give the reference's
    arrays (the reference's shape, the 3-D one a view of [E, W]) and
    round-trip, from int32 and int8 tapes."""
    B, L, E = LAYOUTS[layout]
    stride, transpose, wshape, _ = _geometry(B, L, E)
    rng = np.random.RandomState(B + L)
    tape = rng.randint(0, 5, (B, L)).astype(np.int32)
    want = jbs.tapes_to_bitplanes(jnp.asarray(tape), stride, 3,
                                  transpose=transpose)
    got = tbs.tapes_to_bitplanes(torch.as_tensor(tape).to(dtype), stride, 3,
                                 transpose=transpose)
    assert tuple(got.shape) == tuple(want.shape) == (stride, 3) + wshape
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    back = tbs.bitplanes_to_tapes(got, transpose=transpose)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), tape)
    np.testing.assert_array_equal(
        np.asarray(jbs.bitplanes_to_tapes(jnp.asarray(np.asarray(want)),
                                          transpose=transpose)), tape)


def test_bitplane_roundtrip():
    """Twin of tests/test_ensemble.py:290 (B = 96, the straight layout)."""
    rng = np.random.RandomState(5)
    t = torch.as_tensor(rng.randint(0, 5, (96, 256)), dtype=torch.int32)
    bp = tbs.tapes_to_bitplanes(t, 16, 3)
    assert torch.equal(tbs.bitplanes_to_tapes(bp), t)


def test_bitplane_roundtrip_transposed_3d():
    """Twin of tests/test_ensemble.py:315."""
    rng = np.random.RandomState(6)
    B, L, stride = 32768, 32, 16
    t = torch.as_tensor(rng.randint(0, 3, (B, L)), dtype=torch.int32)
    bp = tbs.tapes_to_bitplanes(t, stride, 2, transpose=True)
    assert bp.shape == (stride, 2, 2, 8, 128)
    assert torch.equal(tbs.bitplanes_to_tapes(bp, transpose=True), t)


@pytest.mark.parametrize("E,K", [(4, 128), (2, 32768)])
def test_stacked_plane_transposes_match_jax(E, K):
    """The frontier's [stride, E, K] int8 planes: both directions equal
    the reference's and round-trip (K = 32768 gives the 3-D words)."""
    rng = np.random.RandomState(K)
    st = rng.randint(0, 5, (16, E, K)).astype(np.int8)
    want = jbs.stacked_planes_to_bitwords(jnp.asarray(st), 3)
    got = tbs.stacked_planes_to_bitwords(torch.as_tensor(st), 3)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    back = tbs.bitwords_to_stacked_planes(got)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(back.numpy(), st)
    np.testing.assert_array_equal(
        np.asarray(jbs.bitwords_to_stacked_planes(want)), st)


def test_pack_takes_any_strided_view():
    """K15's plain version reads the FSM planes [stride, B, E] through
    their [B, E, stride] view and gives the tape's words; unpack writes
    back through the view. Symbols outside [0, 2**nb) keep their low
    bits, as the reference's int8 cast does."""
    rng = np.random.RandomState(2)
    B, L, stride = 64, 128, 16
    tape = torch.as_tensor(rng.randint(-3, 9, (B, L)), dtype=torch.int32)
    planes = tens._tape_to_planes(tape.to(torch.int8), stride)
    words = tbs.pack_bitwords(planes.permute(1, 2, 0), 3)
    want = jbs.tapes_to_bitplanes(jnp.asarray(tape.numpy()), stride, 3)
    np.testing.assert_array_equal(_u32(words), np.asarray(want))
    out = torch.zeros_like(planes)
    tbs.unpack_bitwords(words, out.permute(1, 2, 0))
    assert torch.equal(out, planes & 7)
    with pytest.raises(ValueError, match="B % 32"):
        tbs.pack_bitwords(tape[:40].reshape(40, 8, 16), 3)


# --- K14's round ----------------------------------------------------------------


def _round_inputs(tag, layout, seed):
    """JAX and port words of both tapes at a layout, and a draw of
    random words for every phase (None for a round circuit)."""
    jdm, tdm = _machines(tag)
    _, tc = _circuits(tag)
    B, L, E = LAYOUTS[layout]
    stride, transpose, wshape, axis = _geometry(B, L, E)
    rng = np.random.RandomState(seed)
    pt, dt = _tapes(rng, tdm.size_a, B, L)
    words = [tbs.tapes_to_bitplanes(torch.as_tensor(t), stride, tc[2],
                                    transpose=transpose) for t in (pt, dt)]
    rand = [rng.randint(0, 2**32, (tc[3],) + wshape, dtype=np.uint64)
            .astype(np.uint32) if tc[3] else None for _ in range(stride)]
    return words, rand, stride, axis, dt


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tag", [EX5, EX4, EX2])
def test_apply_round_matches_jax_every_shift(tag, layout):
    """`apply_round_bitsliced` equals the reference's at every phase in
    [0, stride), at the same words and random words, round after
    round."""
    jdm, tdm = _machines(tag)
    jc, tc = _circuits(tag)
    (p, d), rand, stride, axis, dt = _round_inputs(tag, layout, 3)
    jp, jd = jnp.asarray(_u32(p)), jnp.asarray(_u32(d))
    calls = tbs.apply_round_bitsliced.calls
    for shift in np.random.RandomState(4).permutation(stride):
        r = rand[shift]
        jp, jd = jbs.apply_round_bitsliced(
            jdm, jc, jp, jd, jnp.int32(shift), site_axis=axis,
            rand_words=None if r is None else jnp.asarray(r))
        tbs.apply_round_bitsliced(tdm, tc, p, d, int(shift), site_axis=axis,
                                  rand_words=None if r is None else _i32(r))
        np.testing.assert_array_equal(_u32(p), np.asarray(jp))
        np.testing.assert_array_equal(_u32(d), np.asarray(jd))
    assert tbs.apply_round_bitsliced.calls == calls + stride
    changed = tbs.bitplanes_to_tapes(d, transpose=axis != -1).numpy() != dt
    assert changed.any()


def _cxx():
    return next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                       "clang++")) if c),
                None)


@pytest.fixture(scope="module")
def k14_host_library(tmp_path_factory):
    """Builds K14's unit of a machine's circuit with the host's C++
    compiler (once a machine) and returns its `ckpe_bs_host_round`."""
    cxx = _cxx()
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    built = {}

    def get(tag):
        if tag not in built:
            out = tmp_path_factory.mktemp("k14")
            unit = out / "k14.cpp"
            unit.write_text(bitslice_source.k14_source(_machines(tag)[1],
                                                       _circuits(tag)[1]))
            lib = out / "libk14.so"
            subprocess.run(
                [cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
                 "-I", str(cuda.CSRC_DIR), "-o", str(lib), str(unit)],
                check=True, capture_output=True, timeout=300)
            fn = ctypes.CDLL(str(lib)).ckpe_bs_host_round
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
                ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            built[tag] = fn
        return built[tag]

    return get


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tag", [EX5, EX4, EX2])
def test_generated_kernel_matches_plain_round(k14_host_library, tag, layout):
    """K14's per-thread body, compiled from the circuit's generated unit
    and run for every word column on the host, gives the plain round's
    words at every phase, in each layout (the kernel's loads and stores
    and the circuit as code)."""
    _, tdm = _machines(tag)
    _, tc = _circuits(tag)
    round_fn = k14_host_library(tag)
    (p, d), rand, stride, axis, _ = _round_inputs(tag, layout, 5)
    E, W, site_minor = tbs._word_dims(p, axis)
    kp, kd = p.clone(), d.clone()
    for shift in range(stride):
        r = None if rand[shift] is None else _i32(rand[shift])
        assert round_fn(kp.data_ptr(), kd.data_ptr(),
                        None if r is None else r.data_ptr(), shift, E, W,
                        int(site_minor), stride, None) == 0
        tbs.apply_round_bitsliced(tdm, tc, p, d, shift, site_axis=axis,
                                  rand_words=r)
        assert torch.equal(kp, p) and torch.equal(kd, d), shift


def test_generated_source_is_deterministic():
    """The same circuit gives the same unit and library name; another
    circuit another name."""
    tdm = _machines(EX5)[1]
    src = bitslice_source.k14_source(tdm, _circuits(EX5)[1])
    assert src == bitslice_source.k14_source(tdm, _circuits(EX5)[1])
    assert src.count("const uint32_t v") == len(_circuits(EX5)[1][0])
    other = bitslice_source.k14_source(_machines(EX4)[1], _circuits(EX4)[1])
    assert (cuda.unit_library_path("k14", src)
            != cuda.unit_library_path("k14", other))


def test_round_checks():
    tdm = _machines(EX4)[1]
    tc = _circuits(EX4)[1]
    p = tbs.tapes_to_bitplanes(torch.zeros((64, 128), dtype=torch.int32), 16,
                               tc[2])
    shifts = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="random words"):
        tbs.bitslice_round(tdm, tc, p, p.clone(), shifts, 0)
    with pytest.raises(ValueError, match="site_axis"):
        tbs.bitslice_round(tdm, tc, p, p.clone(), shifts, 0,
                           torch.zeros((tc[3], 2, 8), dtype=torch.int32),
                           site_axis=-3)
    with pytest.raises(TypeError, match="int32"):
        tbs.bitslice_round(tdm, tc, p.to(torch.int64), p.clone(), shifts, 0)


# --- run_ensemble's bit-sliced branch -----------------------------------------


@pytest.mark.parametrize("layout,seed", [("straight", 13), ("2d", 17),
                                         ("3d", 19)])
def test_bitsliced_ensemble_matches_fsm(layout, seed):
    """Twins of tests/test_ensemble.py:328, :346, :364: a choose-free
    machine's bit-sliced run gives the FSM plane path's tapes bit for
    bit at the same seed, in each layout, through K14 and K15's plain
    versions and never K1's."""
    _, tdm = _machines(EX5)
    B, L, E = LAYOUTS[layout]
    rng = np.random.RandomState(seed)
    tapes = _tapes(rng, tdm.size_a, B, L)
    (p1, d1), (a1, t1) = tens.run_ensemble(99, tapes, tdm, (12, E),
                                           bitslice=False, device="cpu")
    calls = (tbs.apply_round_bitsliced.calls, tens.plane_round_plain.calls,
             tbs.pack_bitwords_plain.calls, tbs.unpack_bitwords_plain.calls)
    (p2, d2), (a2, t2) = tens.run_ensemble(99, tapes, tdm, (12, E),
                                           bitslice=True, device="cpu")
    assert tbs.apply_round_bitsliced.calls == calls[0] + 12
    assert tens.plane_round_plain.calls == calls[1]
    assert tbs.pack_bitwords_plain.calls == calls[2] + 2
    assert tbs.unpack_bitwords_plain.calls == calls[3] + 2
    assert p2.dtype == torch.int32
    assert torch.equal(p1, p2) and torch.equal(d1, d2)
    assert torch.equal(a1, a2) and torch.equal(t1, t2)
    assert not torch.equal(d1, torch.as_tensor(tapes[1]))


@pytest.mark.parametrize("tag", [EX4, EX2])
def test_sampling_circuit_branch_law(tag):
    """Twin of tests/test_ensemble.py:435: the sampling circuit's run and
    the FSM path's sample the same law: window counts at cl_k 2 within
    7 sigma + 3e-3 (n_eff = B * L / E independent residue classes)."""
    _, tdm = _machines(tag)
    B, L, steps, E = 512, 1024, 20, 32
    rng = np.random.RandomState(31)
    tapes = _tapes(rng, tdm.size_a, B, L)
    (pf, df), _ = tens.run_ensemble(100, tapes, tdm, (steps, E),
                                    bitslice=False, device="cpu")
    calls = tbs.apply_round_bitsliced.calls
    (ps, ds), _ = tens.run_ensemble(200, tapes, tdm, (steps, E),
                                    device="cpu")
    assert tbs.apply_round_bitsliced.calls == calls + steps
    n_eff = B * (L // E)
    for a, b in ((pf, ps), (df, ds)):
        ca = tens.window_counts(a, tdm.size_a, 2, device="cpu").numpy()
        cb = tens.window_counts(b, tdm.size_a, 2, device="cpu").numpy()
        pbar = 0.5 * (ca + cb)
        sigma = np.sqrt(2.0 * pbar * (1 - pbar) / n_eff)
        assert (np.abs(ca - cb) < 7 * sigma + 3e-3).all(), \
            f"max dev {np.abs(ca - cb).max():.4f}"
    assert not torch.equal(ds, torch.as_tensor(tapes[1]))


def test_wide_window_machine_sampling_circuit_exact_law():
    """Twin of tests/test_ensemble.py:1185: ex6-mini-bff-lite's split
    circuit, evaluated by the port on int32 words of 32 members, samples
    each window's outcome law walked exactly from the decision nodes at
    the circuit's 24-bit thresholds."""
    _, dm = _machines("ex6-mini-bff-lite")
    assert tbs.machine_is_sampleable(dm)
    ops, outputs, nb, n_rand = tbs.compile_sampling_circuit(dm)
    n_cells = dm.n_cells
    by_id = {n.node_id: n for n in dm.nodes}
    fields = 31 // dm.bits
    mask = (1 << dm.bits) - 1

    def branch(n, b):
        child = (int(n.child_words[b // fields])
                 >> (dm.bits * (b % fields))) & mask
        spec = (int(n.spec_words[b // fields])
                >> (dm.bits * (b % fields))) & mask
        return child, spec

    def q_quant(probs):
        q, _ = tens._choose_sampling_dist(probs, 1.0)
        t = [0] + [int(round(float(c) * (1 << 24)))
                   for c in np.cumsum(q)[:-1]] + [1 << 24]
        return [(t[b + 1] - t[b]) / (1 << 24) for b in range(len(q))]

    def exact_law(win):
        out: dict = {}

        def apply_spec(spec, pr):
            new = list(win)
            for c in range(n_cells):
                wm, wv = tens.wr_field_host(dm.wr_words[c],
                                            np.asarray([spec]), dm.wr_bits)
                if bool(wm[0]):
                    new[c] = int(wv[0])
            key = tuple(new)
            out[key] = out.get(key, 0.0) + pr

        def walk(nid, pr):
            n = by_id[nid]
            if isinstance(n, tens._Choose):
                for b, p in enumerate(q_quant(n.probs)):
                    if p == 0.0:
                        continue
                    child, spec = branch(n, b)
                    if child == 0:
                        apply_spec(spec, pr * p)
                    else:
                        walk(child, pr * p)
            else:
                child, spec = branch(n, win[n.cell])
                if child == 0:
                    apply_spec(spec, pr)
                else:
                    walk(child, pr)

        walk(dm.root, 1.0)
        return out

    rng = np.random.default_rng(12)
    gen = torch.Generator().manual_seed(12)
    W = 256
    n_samp = 32 * W
    lanes = torch.arange(32, dtype=torch.int32)
    for _ in range(12):
        win = rng.integers(0, dm.size_a, n_cells)
        law = exact_law(win)
        in_words = [torch.full((W,), -1 if (int(win[c]) >> k) & 1 else 0,
                               dtype=torch.int32)
                    for c in range(n_cells) for k in range(nb)]
        in_words += [tbs.draw_rand_words(gen, (W,), "cpu")
                     for _ in range(n_rand)]
        outs = tbs._eval_circuit(ops, outputs, in_words, (W,))
        sym = np.zeros((n_cells, n_samp), np.int64)
        for c in range(n_cells):
            for k in range(nb):
                bits = (outs[c * nb + k][:, None] >> lanes) & 1
                sym[c] |= bits.numpy().astype(np.int64).ravel() << k
        keys, counts = np.unique(sym.T, axis=0, return_counts=True)
        emp = {tuple(int(x) for x in row): n / n_samp
               for row, n in zip(keys, counts)}
        assert set(emp) <= set(law), (sorted(emp), sorted(law))
        for key, p in law.items():
            e = emp.get(key, 0.0)
            tol = 7 * np.sqrt(p * (1 - p) / n_samp) + 2e-3
            assert abs(e - p) < tol, (key, e, p, tol)


@pytest.mark.parametrize("tag", [EX5, EX4])
def test_plane_state_continuation_bit_identical(tag):
    """Twin of tests/test_ensemble.py:1039: keep_planes and a PlaneState
    passed back give chained calls' tapes bit for bit, for the
    bit-sliced round (kind "bits", its state left unchanged by the
    continuation) and K1's (kind "fsm")."""
    _, tdm = _machines(tag)
    rng = np.random.RandomState(3)
    B, L, E = 4096, 64, 4
    tapes = _tapes(rng, tdm.size_a, B, L)
    for flag in (True, False):
        (p_a, d_a), _ = tens.run_ensemble(11, tapes, tdm, (6, E),
                                          bitslice=flag, device="cpu")
        (p_a, d_a), (app_a, t_a) = tens.run_ensemble(
            12, (p_a, d_a), tdm, (6, E), bitslice=flag, device="cpu")
        st, _ = tens.run_ensemble(11, tapes, tdm, (6, E), bitslice=flag,
                                  keep_planes=True, device="cpu")
        assert isinstance(st, tens.PlaneState)
        assert st.kind == ("bits" if flag else "fsm")
        before = (st.pbp.clone(), st.dbp.clone())
        st2, (app_b, t_b) = tens.run_ensemble(12, st, tdm, (6, E),
                                              bitslice=flag,
                                              keep_planes=True, device="cpu")
        assert torch.equal(st.pbp, before[0]) and torch.equal(st.dbp,
                                                              before[1])
        p_b, d_b = st2.tapes()
        assert torch.equal(p_b, p_a) and torch.equal(d_b, d_a)
        assert torch.equal(app_b, app_a) and torch.equal(t_b, t_a)
        (p_c, d_c), _ = tens.run_ensemble(12, st, tdm, (6, E),
                                          bitslice=flag, device="cpu")
        assert torch.equal(p_c, p_a) and torch.equal(d_c, d_a)


def test_plane_state_rejects_mismatched_calls():
    """Twin of tests/test_ensemble.py:1075, the reference's messages."""
    _, tdm = _machines(EX5)
    rng = np.random.RandomState(4)
    B, L, E = 2048, 64, 4
    tapes = _tapes(rng, tdm.size_a, B, L)
    st, _ = tens.run_ensemble(5, tapes, tdm, (2, E), keep_planes=True,
                              device="cpu")
    assert st.kind == "bits" and st.nb == 3 and st.transpose
    with pytest.raises(ValueError, match="stride"):
        tens.run_ensemble(5, st, tdm, (2, 2 * E), device="cpu")
    with pytest.raises(ValueError, match="bit-sliced"):
        tens.run_ensemble(5, st, tdm, (2, E), bitslice=False, device="cpu")
    with pytest.raises(ValueError, match="plane"):
        tens.run_ensemble(5, tapes, tdm, (2, E), independent_sites=True,
                          keep_planes=True, device="cpu")
    odd = tens.PlaneState(st.pbp, st.dbp, batch=B, length=L, kind="bits",
                          nb=2, transpose=True)
    with pytest.raises(ValueError, match="layout"):
        tens.run_ensemble(5, odd, tdm, (2, E), device="cpu")
    with pytest.raises(ValueError, match="bitslice=True"):
        tens.run_ensemble(5, (tapes[0][:40], tapes[1][:40]), tdm, (2, E),
                          bitslice=True, device="cpu")


def test_jax_plane_state_continues_in_the_port():
    """A JAX `PlaneState("bits")` and a JAX circuit cross over:
    `plane_state_from_jax` gives the reference's tapes, and the port's
    run from it equals its run from those tapes."""
    jdm, tdm = _machines(EX5)
    rng = np.random.RandomState(6)
    B, L, E = 1024, 64, 4
    pt, dt = _tapes(rng, tdm.size_a, B, L)
    jst, _ = jens.run_ensemble(jax.random.PRNGKey(2),
                               (jnp.asarray(pt), jnp.asarray(dt)), jdm,
                               (3, E), keep_planes=True)
    assert jst.kind == "bits"
    st = tens.plane_state_from_jax(jst, device="cpu")
    assert (st.kind, st.nb, st.transpose) == ("bits", jst.nb, jst.transpose)
    want_p, want_d = (np.array(t) for t in jst.tapes())
    got_p, got_d = st.tapes()
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    (p1, d1), _ = tens.run_ensemble(7, st, tdm, (5, E), device="cpu")
    (p2, d2), _ = tens.run_ensemble(7, (want_p, want_d), tdm, (5, E),
                                    device="cpu")
    assert torch.equal(p1, p2) and torch.equal(d1, d2)
    jc = jbs.compile_round_circuit(jdm)
    assert tens.circuit_from_jax(jc) == tbs.compile_round_circuit(tdm)


# The reference's selection (JAX engine/ensemble.py:1357-1363), with its
# CPU circuit limit: the grid's machines and geometries.
_SELECTION_GRID = [
    (EX5, 64, 256, 16, False), (EX5, 48, 256, 16, False),
    (EX5, 64, 512, 4, False), (EX5, 64, 256, 16, True),
    (EX4, 64, 256, 16, False), (EX4, 96, 256, 16, False),
    (EX2, 32, 12, 1, False), (EX2, 32, 12, 1, True),
    ("ex1-radioactive-decay", 32, 64, 4, False),
    ("ex3var2-copolymerization", 64, 256, 16, False),
    ("fuzz-wide-specs", 64, 256, 16, False),
    ("ex6-mini-bff-lite", 64, 256, 16, False),
]


@pytest.mark.parametrize("tag,B,L,E,independent", _SELECTION_GRID)
def test_default_selection_matches_jax(tag, B, L, E, independent):
    """`bitslice=None` takes the bit-sliced round exactly where the
    reference's rule does on the CPU: plane path (a machine, stride <=
    64, shared sites), B % 32 == 0, tabulable or sampleable, and a
    circuit of at most 2,000 ops."""
    jdm, tdm = _machines(tag)
    stride = L // E
    want = (stride <= jens._MAX_PLANE_STRIDE and not independent
            and B % 32 == 0
            and (jbs.machine_is_bitsliceable(jdm)
                 or jbs.machine_is_sampleable(jdm))
            and jbs.circuit_cpu_ok(jdm))
    rng = np.random.RandomState(1)
    calls = tbs.apply_round_bitsliced.calls
    tens.run_ensemble(0, _tapes(rng, tdm.size_a, B, L), tdm, (1, E),
                      independent_sites=independent, device="cpu")
    assert (tbs.apply_round_bitsliced.calls == calls + 1) == want


def test_random_words_have_all_32_bits():
    """The random words set member lane 31 (the sign bit) in about half
    of the draws, as every other lane, in `draw_rand_words` and in the
    chunks `run_ensemble` draws."""
    g = torch.Generator().manual_seed(3)
    words = tbs.draw_rand_words(g, (1 << 16,), "cpu")
    lanes = (words[:, None] >> torch.arange(32, dtype=torch.int32)) & 1
    frac = lanes.double().mean(0)
    assert float((frac - 0.5).abs().max()) < 0.01
    chunks = list(tens._draw_word_chunks(g, 26, (4, 128), 5, "cpu"))
    assert [(k0, n) for k0, n, _ in chunks] == [(0, 5)]
    lane31 = float((chunks[0][2] < 0).double().mean())
    assert abs(lane31 - 0.5) < 0.01
    assert list(tens._draw_word_chunks(g, 0, (4, 128), 5, "cpu")) == [
        (0, 5, None)]


def test_bitslice_modules_import_no_jax():
    """`engine/bitslice.py` and `engine/bitslice_source.py`, and a
    bit-sliced run through them, import neither jax nor the JAX
    package."""
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import numpy as np\n"
        "from chemical_kinetics_and_program_execution_torch.engine import "
        "bitslice, bitslice_source, ensemble\n"
        "dm = ensemble.compile_decision_machine('ex2-ferromagnetic-chain')\n"
        "bitslice_source.k14_source(dm, bitslice.machine_circuit(dm))\n"
        "t = np.zeros((32, 64), np.int32)\n"
        "ensemble.run_ensemble(0, (t, t), dm, (2, 4), bitslice=True, "
        "device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'chemical_kinetics_and_program_execution_tpu'))]\n"
        "assert not bad, bad\n"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
