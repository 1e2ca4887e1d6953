"""Parity of the port's bit-sliced BFF rounds with the JAX package (CPU).

The same machines, tapes and shifts go through the JAX package's
`engine/bff_bitslice.py` and the port's: circuits op for op, K17's plain
round word for word (the port's int32 words read as the reference's
uint32 ones) with its opcode totals, whole runs bit for bit against the
JAX scan at the JAX run's shifts, the faithful circuits included (eager
torch does not hit XLA:CPU's compile blow-up). The default route's
choice on the CPU is the reference's. K17's generated unit
(`engine/bff_bitslice_source.py` + `csrc/bitslice_round.cuh`) is
built here with the host's C++ compiler and its per-thread body is held
to the plain round; the kernel itself runs only on the card
(`tests/test_torch_gpu.py`).
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

from chemical_kinetics_and_program_execution_tpu.engine import bff as jbff
from chemical_kinetics_and_program_execution_tpu.engine import (
    bff_bitslice as jbb,
)
from chemical_kinetics_and_program_execution_tpu.engine import (
    bitslice as jbs,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.engine import bff as tbff
from chemical_kinetics_and_program_execution_torch.engine import (
    bff_bitslice as tbb,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    bff_bitslice_source,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    bitslice as tbs,
)

FAITHFUL, LITE, MIDI = "ex6-mini-bff", "ex6-mini-bff-lite", "ex6-mini-bff-midi"
SELF, SELF_LITE, SELF_MIDI = ("ex6-mini-bff-self", "ex6-mini-bff-self-lite",
                              "ex6-mini-bff-self-midi")
TAGS = [FAITHFUL, LITE, MIDI, SELF, SELF_LITE, SELF_MIDI]
SMALL = [LITE, MIDI, SELF_LITE, SELF_MIDI]


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


@functools.lru_cache(maxsize=None)
def _machines(tag):
    return jbff.compile_bff(tag), tbff.compile_bff(tag)


@functools.lru_cache(maxsize=None)
def _circuits(tag):
    jm, tm = _machines(tag)
    return jbb.compile_bff_circuit(jm), tbb.compile_bff_circuit(tm)


def _u32(t):
    return t.numpy().view(np.uint32)


def _tapes(rng, m, B, L):
    """One tape for a self-modifying machine, a pair otherwise."""
    if m.self_modifying:
        return rng.integers(0, m.size_a, (B, L)).astype(np.int32)
    return tuple(rng.integers(0, m.size_a, (B, L)).astype(np.int32)
                 for _ in range(2))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _jax_shifts(key, n, L):
    """`_run_ensemble_bff`'s shared shifts without mutation:
    randint(k, (), 0, L) over split(key, n)."""
    return np.array([int(jax.random.randint(k, (), 0, L, dtype=jnp.int32))
                     for k in jax.random.split(key, n)], np.int32)


# --- Circuits ---------------------------------------------------------------------


@pytest.mark.parametrize("tag", TAGS)
def test_circuit_matches_jax(tag):
    """compile_bff_circuit equals the JAX package's op for op (inputs,
    gates, outputs, the counter planes last)."""
    jc, tc = _circuits(tag)
    assert tbb.bff_circuit_from_jax(jc) == tc
    _, tm = _machines(tag)
    assert len(tc[1]) == tm.n_d * tc[2] + 4 * tm.size_a and tc[3] == 0


def test_popcount_words():
    """Set bits of int32 words read as uint32, lane 31 included."""
    w = torch.tensor([0, -1, -2**31, 1, 0x0F0F0F0F, -0x0F0F0F10],
                     dtype=torch.int32)
    want = sum(bin(int(x) & 0xFFFFFFFF).count("1") for x in w)
    got = tbb.popcount_words(w)
    assert got.dtype == torch.int64 and int(got) == want


# --- K17's plain round against the JAX round --------------------------------------


def _words(tag, B, L, E, seed):
    """JAX and port bit-plane words of the same tapes, the layout and
    site axis as the run chooses them."""
    _, tm = _machines(tag)
    jc, _ = _circuits(tag)
    nb = jc[2]
    stride = L // E
    transpose = E < B // 32
    rng = np.random.default_rng(seed)
    tapes = _as_tuple(_tapes(rng, tm, B, L))
    jw = [jbs.tapes_to_bitplanes(jnp.asarray(t), stride, nb,
                                 transpose=transpose) for t in tapes]
    tw = [tbs.tapes_to_bitplanes(torch.as_tensor(t), stride, nb,
                                 transpose=transpose) for t in tapes]
    axis = -(tw[0].dim() - 2) if transpose else -1
    return jw, tw, stride, axis


def _np_popcount(words):
    return int(np.unpackbits(np.ascontiguousarray(words).view(np.uint8)).sum())


@pytest.mark.parametrize("B,L,E", [(64, 256, 4), (4096, 128, 4)],
                         ids=["straight", "transposed"])
@pytest.mark.parametrize("tag", SMALL)
def test_apply_round_bitsliced_matches_jax(tag, B, L, E):
    """K17's plain round equals JAX apply_bff_round_bitsliced word for
    word, with the totals of its counter planes, at shifts over the
    whole tape: every cell spills somewhere, the offset-0 cell too."""
    jm, tm = _machines(tag)
    jc, tc = _circuits(tag)
    jw, tw, stride, axis = _words(tag, B, L, E, len(tag))
    jp, jd = (None, jw[0]) if tm.self_modifying else jw
    tp, td = (None, tw[0]) if tm.self_modifying else tw
    for shift in (0, stride - 1, stride, L // 2 + 3, L - 1):
        jd, oh = jbb.apply_bff_round_bitsliced(
            jm, jc, jp, jd, jnp.int32(shift), stride=stride, site_axis=axis)
        want = np.zeros(tm.size_a, np.int64)
        for a in range(tm.size_a):
            for k in range(4):
                want[a] += _np_popcount(np.asarray(oh[4 * a + k])) << k
        got = tbb.apply_bff_round_bitsliced(tm, tc, tp, td, shift,
                                            stride=stride, site_axis=axis)
        np.testing.assert_array_equal(_u32(td), np.asarray(jd))
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == B * E * tm.fuel


# --- Whole runs -----------------------------------------------------------------------


@pytest.mark.parametrize("tag,B,L,steps,events", [
    (MIDI, 32, 256, 5, 4), (LITE, 64, 64, 6, 4),
    (SELF_MIDI, 32, 256, 4, 4), (SELF_LITE, 64, 64, 6, 4),
    (LITE, 4096, 64, 3, 4)])
def test_bitslice_matches_scan(tag, B, L, steps, events):
    """Twins of tests/test_bff_bitslice.py's two-tape and self-modifying
    gates: the bit-sliced route equals the scan at the same seed (tapes,
    totals, times), and at the JAX run's shifts both equal the JAX
    scan's tapes and totals (the transposed layout at B = 4096)."""
    jm, tm = _machines(tag)
    rng = np.random.default_rng(B + L)
    tapes = _tapes(rng, tm, B, L)
    calls = tbb.apply_bff_round_bitsliced.calls
    out1, (ops1, t1) = tbff.run_ensemble_bff(5, tapes, tm, (steps, events),
                                             engine="scan", device="cpu")
    assert tbb.apply_bff_round_bitsliced.calls == calls
    out2, (ops2, t2) = tbff.run_ensemble_bff(5, tapes, tm, (steps, events),
                                             engine="bitslice", device="cpu")
    assert tbb.apply_bff_round_bitsliced.calls == calls + steps
    for a, b in zip(_as_tuple(out1), _as_tuple(out2), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(ops1, ops2) and torch.equal(t1, t2)
    assert int(ops1.sum()) == steps * B * events * tm.fuel
    key = jax.random.PRNGKey(B)
    jout, (jops, _) = jbff.run_ensemble_bff(key, tapes, jm, (steps, events),
                                            engine="scan")
    shifts = _jax_shifts(key, steps, L)
    for engine in ("scan", "bitslice"):
        tout, tops = tbff.run_bff_rounds(tm, tapes, shifts, events,
                                         engine=engine, device="cpu")
        for a, b in zip(_as_tuple(tout), _as_tuple(jout), strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(tops.numpy(), np.asarray(jops))


@pytest.mark.parametrize("tag", [LITE, SELF_LITE])
def test_run_ensemble_bff_bitsliced_name(tag):
    """The reference's `run_ensemble_bff_bitsliced(key, ts, mach,
    steps_events)` has a port name of the same arguments: the tape tuple
    and (totals, times) back, as the JAX function returns them, and the
    same bits as `run_ensemble_bff(engine="bitslice")` at the same
    seed."""
    jm, tm = _machines(tag)
    B, L, steps, events = 32, 64, 3, 4
    tapes = _as_tuple(_tapes(np.random.default_rng(3), tm, B, L))
    got, (ops, times) = tbb.run_ensemble_bff_bitsliced(
        9, tapes, tm, (steps, events), device="cpu")
    jgot, (jops, jtimes) = jbb.run_ensemble_bff_bitsliced(
        jax.random.PRNGKey(9), tuple(jnp.asarray(t) for t in tapes), jm,
        (steps, events))
    assert isinstance(got, tuple) and len(got) == len(jgot)
    assert ops.shape == jops.shape and times.shape == jtimes.shape
    np.testing.assert_allclose(times.numpy(), np.asarray(jtimes), rtol=1e-12)
    want, (wops, _) = tbff.run_ensemble_bff(
        9, tapes if len(tapes) == 2 else tapes[0], tm, (steps, events),
        engine="bitslice", device="cpu")
    for a, b in zip(got, _as_tuple(want), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(ops, wops)


@pytest.mark.parametrize("tag", [FAITHFUL, SELF])
def test_faithful_circuit_bit_identity_on_cpu(tag):
    """Twin of tests/test_bff_bitslice.py's (B=32, L=512, E=8, 2 rounds),
    the self-modifying faithful circuit too: the faithful circuit, which
    auto keeps off the CPU, run by the plain bit-sliced round at the JAX
    run's shifts, equals the JAX int8 scan in tapes and opcode totals."""
    jm, tm = _machines(tag)
    _, tc = _circuits(tag)
    assert len(tc[0]) > tbb.CPU_MAX_CIRCUIT_OPS
    B, L, steps, events = 32, 512, 2, 8
    rng = np.random.default_rng(7)
    tapes = _tapes(rng, tm, B, L)
    key = jax.random.PRNGKey(7)
    jout, (jops, _) = jbff.run_ensemble_bff(key, tapes, jm, (steps, events),
                                            engine="scan")
    calls = tbb.apply_bff_round_bitsliced.calls
    tout, tops = tbff.run_bff_rounds(tm, tapes, _jax_shifts(key, steps, L),
                                     events, engine="bitslice", device="cpu")
    assert tbb.apply_bff_round_bitsliced.calls == calls + steps
    for a, b in zip(_as_tuple(tout), _as_tuple(jout), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tops.numpy(), np.asarray(jops))
    assert int(tops.sum()) == steps * B * events * tm.fuel


_SELECTION = [
    # (tag, B, L, E, independent_sites, mutation_rate)
    (LITE, 32, 64, 4, False, 0.0),
    (MIDI, 64, 256, 4, False, 0.0),
    (FAITHFUL, 32, 256, 4, False, 0.0),
    (SELF, 64, 256, 4, False, 0.0),
    (SELF_LITE, 48, 64, 4, False, 0.0),
    (SELF_LITE, 32, 64, 4, True, 0.0),
    (SELF_MIDI, 32, 256, 4, False, 0.01),
]


@pytest.mark.parametrize("tag,B,L,E,independent,mu", _SELECTION)
def test_auto_selection_matches_jax(tag, B, L, E, independent, mu):
    """engine='auto' on the CPU takes the bit-sliced route exactly where
    the reference's rule does (eligible, and a circuit of at most 2,000
    ops), and gives the scan's run either way."""
    jm, tm = _machines(tag)
    want = (jbb.bff_bitslice_eligible(jm, B, independent_sites=independent,
                                      mutation_rate=mu)
            and len(jbb.compile_bff_circuit(jm)[0])
            <= jbb.CPU_MAX_CIRCUIT_OPS)
    tapes = _tapes(np.random.default_rng(B), tm, B, L)
    calls = tbb.apply_bff_round_bitsliced.calls
    out, (ops, _) = tbff.run_ensemble_bff(3, tapes, tm, (2, E),
                                          independent_sites=independent,
                                          mutation_rate=mu, device="cpu")
    assert (tbb.apply_bff_round_bitsliced.calls == calls + 2) == want
    ref, (ops2, _) = tbff.run_ensemble_bff(3, tapes, tm, (2, E),
                                           independent_sites=independent,
                                           mutation_rate=mu, engine="scan",
                                           device="cpu")
    for a, b in zip(_as_tuple(out), _as_tuple(ref), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(ops, ops2)


def test_bitslice_ineligible_calls_raise_or_fall_back():
    """Twin of tests/test_bff_bitslice.py's: engine='bitslice' raises on
    B % 32 != 0, independent sites, mutation and lineage; an unknown
    engine raises; auto on an ineligible call keeps the scan."""
    _, m = _machines(SELF_LITE)
    rng = np.random.default_rng(3)
    tape = rng.integers(0, m.size_a, (48, 64)).astype(np.int32)
    with pytest.raises(ValueError, match="bitslice"):
        tbff.run_ensemble_bff(0, tape, m, (2, 4), engine="bitslice",
                              device="cpu")
    tape32 = tape[:32]
    for kw in ({"independent_sites": True}, {"mutation_rate": 0.01},
               {"prov": np.zeros((32, 64), np.int32)}):
        with pytest.raises(ValueError, match="bitslice"):
            tbff.run_ensemble_bff(0, tape32, m, (2, 4), engine="bitslice",
                                  device="cpu", **kw)
    with pytest.raises(ValueError, match="bitslice"):
        tbff.run_bff_rounds(m, tape32, np.zeros((2, 32), np.int32), 4,
                            engine="bitslice", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tbff.run_ensemble_bff(0, tape32, m, (2, 4), engine="warp",
                              device="cpu")
    calls = tbb.apply_bff_round_bitsliced.calls
    out, _ = tbff.run_ensemble_bff(0, tape, m, (2, 4), device="cpu")
    assert out.shape == tape.shape
    assert tbb.apply_bff_round_bitsliced.calls == calls


def test_auto_keeps_scan_for_big_circuits_on_cpu():
    """Twin of tests/test_bff_bitslice.py's: the faithful circuits stay
    over the CPU limit and midi under it; auto on the card takes any
    size."""
    assert len(_circuits(FAITHFUL)[1][0]) > tbb.CPU_MAX_CIRCUIT_OPS
    assert len(_circuits(SELF)[1][0]) > tbb.CPU_MAX_CIRCUIT_OPS
    assert len(_circuits(MIDI)[1][0]) <= tbb.CPU_MAX_CIRCUIT_OPS
    _, m = _machines(FAITHFUL)
    kw = dict(independent_sites=False, mutation_rate=0.0, lineage=False)
    assert not tbff._pick_engine(m, "auto", 32, "cpu", **kw)
    assert tbff._pick_engine(m, "auto", 32, "cuda", **kw)
    assert tbff._pick_engine(m, "bitslice", 32, "cpu", **kw)


def test_circuit_is_pure_window_function():
    """Twin of tests/test_bff_bitslice.py's: the first 32 members run
    alone at the same seed give their rows of the 64-member run (the
    shifts depend on the seed only)."""
    _, m = _machines(LITE)
    rng = np.random.default_rng(4)
    pt, dt = _tapes(rng, m, 64, 64)
    (_, d_all), _ = tbff.run_ensemble_bff(4, (pt, dt), m, (4, 4),
                                          engine="bitslice", device="cpu")
    (_, d_sub), _ = tbff.run_ensemble_bff(4, (pt[:32], dt[:32]), m, (4, 4),
                                          engine="bitslice", device="cpu")
    assert torch.equal(d_all[:32], d_sub)


def test_bitsliced_word_checks():
    _, m = _machines(SELF_LITE)
    _, c = _circuits(SELF_LITE)
    d = tbs.tapes_to_bitplanes(torch.zeros((32, 64), dtype=torch.int32), 16,
                               c[2])
    shifts = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="program words"):
        tbb.bff_bitslice_round(m, c, d, d.clone(), shifts, 0)
    with pytest.raises(TypeError, match="int32"):
        tbb.bff_bitslice_round(m, c, None, d.to(torch.int64), shifts, 0)
    with pytest.raises(ValueError, match="site_axis"):
        tbb.bff_bitslice_round(m, c, None, d, shifts, 0, site_axis=-3)
    with pytest.raises(ValueError, match="not a BFF circuit"):
        tbb.bff_bitslice_round(m, _circuits(SELF_MIDI)[1], None, d, shifts,
                               0)
    with pytest.raises(IndexError, match="outside"):
        tbb.bff_bitslice_round(m, c, None, d, shifts, 1)


# --- K17's generated unit, built for the host ------------------------------------------


def _cxx():
    return next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                       "clang++")) if c),
                None)


@pytest.fixture(scope="module")
def k17_host_library(tmp_path_factory):
    """Builds K17's unit of a machine's circuit with the host's C++
    compiler (once a machine) and returns its `ckpe_bs_host_round`."""
    cxx = _cxx()
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    built = {}

    def get(tag):
        if tag not in built:
            out = tmp_path_factory.mktemp("k17")
            unit = out / "k17.cpp"
            unit.write_text(bff_bitslice_source.k17_source(
                _machines(tag)[1], _circuits(tag)[1]))
            lib = out / "libk17.so"
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


# The two layouts for every tag, and the master-equation gates' ring of
# four cells with one site a round for the lite machines.
_UNIT_CASES = [pytest.param(tag, B, L, E, id=f"{tag}-{name}")
               for tag in TAGS
               for name, (B, L, E) in (("straight", (64, 512, 8)),
                                       ("transposed", (4096, 128, 2)))] + [
    pytest.param(tag, 64, 4, 1, id=f"{tag}-L4E1") for tag in (LITE, SELF_LITE)]


@pytest.mark.parametrize("tag,B,L,E", _UNIT_CASES)
def test_generated_unit_matches_plain_round(k17_host_library, tag, B, L, E):
    """K17's per-thread body, compiled from the circuit's generated unit
    and run for every word column on the host, gives the plain round's
    words and opcode totals at shifts over the whole tape (every cell
    spills somewhere, the offset-0 cell too), in both layouts and on a
    ring of 4 cells with one site; the program words stay as they
    are."""
    _, tm = _machines(tag)
    _, tc = _circuits(tag)
    round_fn = k17_host_library(tag)
    _, tw, stride, axis = _words(tag, B, L, E, 3)
    tp, td = (None, tw[0]) if tm.self_modifying else tw
    E_, W, site_minor = tbs._word_dims(td, axis)
    kd = td.clone()
    p0 = None if tp is None else tp.clone()
    totals = np.zeros(tm.size_a, np.int64)
    for shift in (0, 5, stride, stride + 9, L - 1):
        assert round_fn(None if tp is None else tp.data_ptr(),
                        kd.data_ptr(), None, shift, E_, W, int(site_minor),
                        stride, totals.ctypes.data) == 0
        want = tbb.apply_bff_round_bitsliced(tm, tc, tp, td, shift,
                                             stride=td.shape[0],
                                             site_axis=axis)
        assert torch.equal(kd, td), shift
        np.testing.assert_array_equal(totals, want.numpy())
    if tp is not None:
        assert torch.equal(tp, p0)


def test_generated_source_is_deterministic():
    """The same circuit gives the same unit and library name; another
    circuit another name; the unit holds a statement an op."""
    tm, tc = _machines(MIDI)[1], _circuits(MIDI)[1]
    src = bff_bitslice_source.k17_source(tm, tc)
    assert src == bff_bitslice_source.k17_source(tm, tc)
    assert src.count("const uint32_t v") == len(tc[0])
    other = bff_bitslice_source.k17_source(_machines(SELF_MIDI)[1],
                                           _circuits(SELF_MIDI)[1])
    assert "#define BS_N_P 0" in other
    assert (cuda.unit_library_path("k17", src)
            != cuda.unit_library_path("k17", other))
    with pytest.raises(ValueError, match="BFF round"):
        bff_bitslice_source.k17_source(tm, _circuits(LITE)[1])
