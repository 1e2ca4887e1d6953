"""Parity of the port's weighted frontier with the JAX package (CPU).

Tempered sampling (the walk's importance increments), K19
`content_hash`, K20 `merge_resample` (after the sort), K21
`gather_pair`, one block of the blocked frontier's rounds, the per-step
beam's steps (K22), and twins of the JAX package's frontier gates
(`tests/test_ensemble.py`) at its sizes, held to the port's exact SPD
solve and `engine/master.py`. The same inputs, made with numpy or drawn
by JAX (its own key splits, fed to the port's from-draws forms), go
through both packages: tapes and integer results agree bit for bit,
float64 weights to rtol 1e-12, weights that carry float32 increments to
rtol 1e-6. Two reference caveats bind the gates (ROADMAP): merges are
compared at one K (the reference changes its slot weights at
`_MERGE_STAGED_MIN_K`) and nothing is asserted on `hit` or the NaN ESS
with ``ess_frac > 0``. The kernels run only on the card
(`tests/test_torch_gpu.py`); K11's tempered per-member body is built
here with the host's C++ compiler.
"""

import ctypes
import dataclasses
import inspect
import math
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu import engine as jengine
from chemical_kinetics_and_program_execution_tpu.engine import (
    bff_bitslice as jbb,
)
from chemical_kinetics_and_program_execution_tpu.engine import (
    dense as jdense,
)
from chemical_kinetics_and_program_execution_tpu.engine import (
    ensemble as jens,
)
from chemical_kinetics_and_program_execution_tpu.engine import rhs as jrhs
from chemical_kinetics_and_program_execution_tpu.ode import (
    integrate as jintegrate,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch import engine as tengine
from chemical_kinetics_and_program_execution_torch.engine import (
    bff_bitslice as tbb,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    dense as tdense,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as tens,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    frontier as tfr,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    k1_source,
    master,
)
from chemical_kinetics_and_program_execution_torch.engine import rhs as trhs
from chemical_kinetics_and_program_execution_torch.engine.compile import (
    compile_problem,
)
from chemical_kinetics_and_program_execution_torch.models.initial_states import (
    ferromagnet_p0,
)
from chemical_kinetics_and_program_execution_torch.ode import (
    integrate as tintegrate,
)

CPU = "cpu"
WALK_TAGS = ["ex5-msrtf-machine", "ex2-ferromagnetic-chain",
             "ex4-chemical-turing", "ex3-copolymerization"]


def _dm(tag):
    return jens.compile_decision_machine(tag), tens.compile_decision_machine(tag)


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _planes(tape, stride):
    """JAX transposed planes of an [K, L] tape."""
    return jens._to_planes_t(jnp.asarray(tape), stride=stride)


def _from_planes(planes):
    return np.asarray(jens._from_planes_t(planes))


# --- Tempered sampling -----------------------------------------------------------


@pytest.mark.parametrize("tag", WALK_TAGS)
@pytest.mark.parametrize("tau", [1.0, 0.5, 0.3])
def test_tempered_walk_matches_jax(tag, tau):
    """The plain walk with increments equals JAX's leveled walk with
    want_logp: the same specs, and float32 increments bit for bit."""
    jdm, tdm = _dm(tag)
    rng = np.random.RandomState(7)
    shape = (64, 32)
    cells = [rng.randint(0, tdm.size_a, shape).astype(np.int8)
             for _ in range(tdm.n_cells)]
    u = rng.rand(*shape).astype(np.float32)
    js, jl = jens._machine_specs_planes_leveled(
        jdm, tuple(jnp.asarray(c) for c in cells), jnp.asarray(u), tau=tau,
        want_logp=True)
    ts, tl = tens._walk_plain(tdm, [_t(c) for c in cells], _t(u), tau=tau,
                              want_logp=True)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.dtype == torch.float32


@pytest.mark.parametrize("tag", ["ex2-ferromagnetic-chain",
                                 "ex4-chemical-turing"])
def test_tempered_unit_rule_matches_plain(tag, tmp_path):
    """K11's tempered per-member body (the generated unit at tau 0.5,
    `ckpe_k11_host_round_logp`), built with the host's compiler, equals
    `lattice_round_plain(tau=0.5, lw=...)`: tapes bit for bit, lw bit
    for bit."""
    cxx = next((c for c in ("g++", "c++", "clang++") if shutil.which(c)),
               None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    _, tdm = _dm(tag)
    src = k1_source.k1_source(tdm, 0.5)
    assert "#define K1_LOGP 1" in src
    assert k1_source.k1_source(tdm, 1.0) == k1_source.k1_source(tdm)
    unit = tmp_path / "unit.cpp"
    unit.write_text(src)
    lib = tmp_path / "librule.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1",
                    "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(cuda.CSRC_DIR), "-o", str(lib), str(unit)],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).ckpe_k11_host_round_logp
    rng = np.random.RandomState(3)
    K, L, E = 96, 64, 4
    pt = torch.as_tensor(rng.randint(0, tdm.size_a, (K, L)), dtype=torch.int8)
    dt = torch.as_tensor(rng.randint(0, tdm.size_a, (K, L)), dtype=torch.int8)
    u = torch.as_tensor(rng.rand(K, E).astype(np.float32))
    lw = torch.as_tensor(rng.randn(K))
    shift = torch.tensor([5], dtype=torch.int32)
    want = [x.clone() for x in (pt, dt, lw)]
    tens.lattice_round_plain(tdm, want[0], want[1], shift, E, u, tau=0.5,
                             lw=want[2])
    if tag == "ex2-ferromagnetic-chain":  # every site chooses
        assert not torch.equal(want[2], lw)
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, P, ctypes.c_int, ctypes.c_int, ctypes.c_int, P]
    assert fn(pt.data_ptr(), dt.data_ptr(), u.data_ptr(), shift.data_ptr(),
              K, L, E, lw.data_ptr()) == 0
    for got, w in zip((pt, dt, lw), want):
        assert torch.equal(got, w)


_TEMPERED_UNITS = {}


def _tempered_unit(tag, tmp_path_factory):
    """The generated unit of ``tag`` at tau 0.5, built once with the
    host's compiler."""
    cxx = next((c for c in ("g++", "c++", "clang++") if shutil.which(c)),
               None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    if tag not in _TEMPERED_UNITS:
        d = tmp_path_factory.mktemp("tempered_unit")
        (d / "unit.cpp").write_text(k1_source.k1_source(_dm(tag)[1], 0.5))
        subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1",
                        "-ffp-contract=off", "-shared", "-fPIC", "-I",
                        str(cuda.CSRC_DIR), "-o", str(d / "librule.so"),
                        str(d / "unit.cpp")], check=True,
                       capture_output=True, timeout=300)
        _TEMPERED_UNITS[tag] = ctypes.CDLL(str(d / "librule.so"))
    return _TEMPERED_UNITS[tag]


@pytest.mark.parametrize("tag,L,E,tile,threads,n,k0", [
    ("ex2-ferromagnetic-chain", 64, 4, 5, 3, 6, 2),
    ("ex2-ferromagnetic-chain", 64, 4, 13, 32, 1, 0),
    ("ex2-ferromagnetic-chain", 48, 3, 4, 4, 4, 0),
    ("ex4-chemical-turing", 96, 8, 6, 4, 5, 1),
    ("ex4-chemical-turing", 60, 5, 4, 2, 4, 3)])
def test_tempered_resident_rounds_match_plain(tag, L, E, tile, threads, n,
                                              k0, tmp_path_factory):
    """K11's resident tempered rounds as their host twin runs them
    (`csrc/lattice_round.cuh:ckpe_k11_host_resident_logp`: rows loaded
    into the tile's buffer, a thread a member for all n rounds with its
    log-weight held, rows written back, tile after tile) equal n rounds
    of `lattice_round_plain(tau=0.5, lw=...)`: tapes and lw bit for bit;
    tiles that split B unevenly, fewer threads than members, n = 1 and n
    >= 4, a call from k0 > 0, shifts outside [0, L), four sites at a time
    by the lane walk with a sum a lane (E a multiple of 4) and a site at
    a time (E = 3, 5), symbols out of range (the exact walk)."""
    _, tdm = _dm(tag)
    fn = _tempered_unit(tag, tmp_path_factory).ckpe_k11_host_resident_logp
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 4 + [I] * 5 + [P, I, I]
    fn.restype = I
    rng = np.random.RandomState(17 + L + E)
    B = 13
    if tag == "ex4-chemical-turing":  # its tape mix, where chooses fire
        pt = rng.choice([5, 6], (B, L)).astype(np.int8)
        dt = rng.choice([0, 4, 5], (B, L)).astype(np.int8)
    else:
        pt = rng.randint(0, tdm.size_a, (B, L)).astype(np.int8)
        dt = rng.randint(0, tdm.size_a, (B, L)).astype(np.int8)
    pt[0, ::11] = tdm.size_a + 2
    dt[1, ::7] = -3
    shifts = rng.randint(-L, 2 * L, k0 + n).astype(np.int32)
    u = rng.rand(n, B, E).astype(np.float32)
    lw = rng.randn(B)
    kp, kd, klw = pt.copy(), dt.copy(), lw.copy()
    assert fn(kp.ctypes.data, kd.ctypes.data, u.ctypes.data,
              shifts.ctypes.data, k0, n, B, L, E, klw.ctypes.data, tile,
              threads) == 0
    p, d, w = _t(pt.copy()), _t(dt.copy()), _t(lw.copy())
    for j in range(n):
        tens.lattice_round_plain(tdm, p, d, _t(shifts)[k0 + j:k0 + j + 1], E,
                                 _t(u[j]), tau=0.5, lw=w)
    np.testing.assert_array_equal(kp, p.numpy())
    np.testing.assert_array_equal(kd, d.numpy())
    np.testing.assert_array_equal(klw, w.numpy())
    if tag == "ex2-ferromagnetic-chain":  # every site chooses (ex4 seldom)
        assert (klw != lw).all()
    assert (kp != pt).any() or (kd != dt).any()


def test_tempered_tile_by_geometry():
    """`ensemble.k11_tempered_tile`: phase 12 (a)'s K = 10^6, L = 64 keeps
    512 members a block (two blocks an SM), a small K spreads over the
    SMs, and rows past a block's shared memory take the launch a round."""
    assert tens.k11_odd_stride(64) == 68 and tens.k11_odd_stride(61) == 68
    assert tens.k11_odd_stride(4096) == 4100
    assert tens.k11_tempered_tile(10**6, 64) == (512, 512, 512 * 136)
    assert tens.k11_tempered_tile(4096, 64) == (16, 32, 16 * 136)
    assert tens.k11_tempered_tile(8, 131_072) is None


# --- K19 -------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("flagged", [False, True])
@pytest.mark.parametrize("stride", [1, 16])
def test_content_hash_matches_jax(bits, flagged, stride):
    """K19's plain version equals `_content_hash` bit for bit over the
    plane columns (the blocked merges' order) or the natural order, with
    the hit flag last, on symbols 0-15."""
    rng = np.random.RandomState(bits + stride)
    K, L = 200, 64
    pt = rng.randint(0, 16, (K, L)).astype(np.int8)
    dt = rng.randint(0, 16, (K, L)).astype(np.int8)
    dt[1] = dt[0]
    pt[1] = pt[0]
    flag = rng.rand(K) < 0.5
    pp, dd = _planes(pt, stride), _planes(dt, stride)
    E = L // stride
    cols = ([pl[e] for pl in pp for e in range(E)]
            + [pl[e] for pl in dd for e in range(E)])
    if flagged:
        cols.append(jnp.asarray(flag).astype(jnp.int8))
    want = np.asarray(jens._content_hash(cols, bits=bits)).view(np.int64)
    got = tfr.content_hash(_t(pt), _t(dt), stride=stride, bits=bits,
                           flag=_t(flag) if flagged else None)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0] == got[1]) == (not flagged or flag[0] == flag[1])


def test_content_hash_distinguishes_and_matches():
    a = torch.tensor([[0, 1, 2], [0, 1, 2], [2, 1, 0]], dtype=torch.int8)
    z = torch.zeros_like(a)
    h = tfr.content_hash(a, z)
    assert h[0] == h[1] and h[0] != h[2]


# --- K20 -------------------------------------------------------------------------


def _hash_pool(seed, K, n_pool, n_inf):
    rng = np.random.RandomState(seed)
    pool = rng.randint(0, 2**63, size=n_pool).astype(np.uint64)
    pool[0] = np.uint64(2**64 - 5)  # a hash with the top bit set
    h = pool[rng.randint(0, len(pool), K)]
    lw = rng.normal(size=K) * 3.0
    lw[:n_inf] = -np.inf
    return h, lw


def _u_of(key):
    _, k_u = jax.random.split(key)
    return float(jax.random.uniform(k_u, (), jnp.float64))


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_resample_sorted_matches_jax(seed):
    """K20's plain w/m merge equals `_merge_resample_sorted` at the same
    hashes, weights and uniform: parents and n_groups exactly. new_lw
    to rtol 2e-6 against JAX: its group masses are differences of XLA's
    reassociated cumsum, which the JAX test measures at ~1e-7 relative
    (and gates at 2e-6); against each group's exact mass (math.fsum) the
    port's new_lw holds to rtol 1e-12."""
    h, lw = _hash_pool(seed, 4096, 300, 7)
    key = jax.random.PRNGKey(seed + 1)
    jp, jl, jn = jens._merge_resample_sorted(key, jnp.asarray(h),
                                             jnp.asarray(lw))
    tp, tl, tn = tfr._merge_resample_sorted(
        _u_of(key), _t(h.view(np.int64)), _t(lw))
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-6)
    top = lw[np.isfinite(lw)].max()
    parent = tp.numpy()
    for p in np.unique(parent):
        grp = h == h[p]
        mass = math.fsum(np.exp(lw[grp & np.isfinite(lw)] - top))
        m = (parent == p).sum()
        np.testing.assert_allclose(tl.numpy()[parent == p],
                                   top + math.log(mass) - math.log(m),
                                   rtol=1e-12)


@pytest.mark.parametrize("seed", [2, 3])
def test_merge_resample_positions_matches_jax(seed):
    """K20's plain equal-weight merge equals `_merge_resample_positions`:
    parents and n_unique exactly, new_lw to rtol 1e-12."""
    h, lw = _hash_pool(seed, 4096, 257, 5)
    key = jax.random.PRNGKey(seed + 3)
    jp, jl, jn = jens._merge_resample_positions(key, jnp.asarray(h),
                                                jnp.asarray(lw))
    tp, tl, tn = tfr._merge_resample_positions(
        _u_of(key), _t(h.view(np.int64)), _t(lw))
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-12)


def test_merge_stats_matches_jax_without_collisions():
    """Where no two distinct hashes share a bucket, `_merge_stats` by
    sort equals the reference's hash-table election: grp, is_rep and
    n_groups exactly, merged_lw to rtol 1e-12."""
    rng = np.random.RandomState(4)
    K = 512
    n_buckets = 1 << (2 * K - 1).bit_length()
    pool = np.arange(1, 201, dtype=np.uint64) * np.uint64(
        n_buckets + 1)  # distinct buckets
    h = pool[rng.randint(0, len(pool), K)]
    lw = rng.normal(size=K)
    jg, jm, jr, jn = jens._merge_stats(jnp.asarray(h), jnp.asarray(lw))
    tg, tm, tr, tn = tfr._merge_stats(_t(h.view(np.int64)), _t(lw))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-12)


def test_merge_stats_and_resample_core():
    """Twin of the JAX package's hand-built frontier: members 0 and 2
    share a key and merge into member 0's group; resampling keeps each
    configuration's mass."""
    h = torch.tensor([7, 3, 7, 5], dtype=torch.int64)
    lw = torch.log(torch.tensor([0.1, 0.3, 0.2, 0.4], dtype=torch.float64))
    grp, merged_lw, is_rep, n_groups = tfr._merge_stats(h, lw)
    assert int(n_groups) == 3
    assert grp[0] == grp[2] == 0 and grp[1] == 1 and grp[3] == 3
    np.testing.assert_array_equal(is_rep.numpy(), [True, True, False, True])
    merged = np.exp(merged_lw.numpy())
    np.testing.assert_allclose(merged[[0, 1, 3]], [0.3, 0.3, 0.4],
                               rtol=1e-12)
    assert merged[2] == 0.0
    parent, new_lw, ng = tfr._merge_resample(_u_of(jax.random.PRNGKey(0)),
                                             h, lw)
    assert int(ng) == 3
    parent, new_lw = parent.numpy(), new_lw.numpy()
    np.testing.assert_allclose(np.exp(new_lw).sum(), 1.0, rtol=1e-8)
    assert set(parent) <= {0, 1, 3}
    for rep_idx, w_cfg in ((0, 0.3), (1, 0.3), (3, 0.4)):
        mass = np.exp(new_lw)[parent == rep_idx].sum()
        if mass > 0:
            np.testing.assert_allclose(mass, w_cfg, rtol=1e-8)


def test_merge_resample_collision_merges_not_corrupts():
    """Twin of `test_merge_resample_collision_defers_not_corrupts` as it
    holds for a sort: keys that share a hash-table bucket but differ
    stay distinct groups, equal keys merge at once (the reference would
    defer a pair that lost its bucket), and nothing is corrupted."""
    K = 4
    n_buckets = 1 << (2 * K - 1).bit_length()
    h = torch.tensor([1, 1 + n_buckets * 3, 2, 3], dtype=torch.int64)
    lw = torch.full((K,), -math.log(K), dtype=torch.float64)
    _, merged_lw, is_rep, n_groups = tfr._merge_stats(h, lw)
    assert int(n_groups) == K
    np.testing.assert_allclose(np.exp(merged_lw.numpy()), 1.0 / K,
                               rtol=1e-12)
    h2 = torch.tensor([1 + n_buckets, 5, 1 + n_buckets, 1], dtype=torch.int64)
    grp, merged_lw, is_rep, n_groups = tfr._merge_stats(h2, lw)
    assert int(n_groups) == 3
    assert grp.tolist() == [0, 1, 0, 3]
    np.testing.assert_allclose(np.exp(merged_lw.numpy()),
                               [0.5, 0.25, 0.0, 0.25], rtol=1e-12)


def test_merge_weights_inplace_moves_mass_to_one_rep():
    h = torch.tensor([9, 9, 9, 2], dtype=torch.int64)
    lw = torch.log(torch.full((4,), 0.25, dtype=torch.float64))
    new_lw = tfr._merge_weights_inplace(h, lw).numpy()
    finite = np.isfinite(new_lw)
    assert finite.sum() == 2
    np.testing.assert_allclose(np.exp(new_lw[finite]).sum(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(sorted(np.exp(new_lw[finite])), [0.25, 0.75],
                               rtol=1e-12)


def test_merge_resample_sorted_invariants():
    """Twin of the JAX test: merged group weights (to 1e-12 of the total
    mass, where the JAX test allows 2e-6 relative for its reassociated
    cumsum), valid parents, the systematic slot guarantee and the group
    count."""
    rng = np.random.RandomState(0)
    K = 4096
    pool = rng.randint(0, 2**63, size=300).astype(np.uint64)
    h_np = pool[rng.randint(0, len(pool), K)]
    lw_np = rng.normal(size=K) * 3.0
    lw_np[:7] = -np.inf
    parent, new_lw, n_groups = tfr._merge_resample_sorted(
        _u_of(jax.random.PRNGKey(1)), _t(h_np.view(np.int64)), _t(lw_np))
    parent, new_lw = parent.numpy(), new_lw.numpy()
    uniq = np.unique(h_np[np.isfinite(lw_np)])
    assert int(n_groups) == len(np.unique(h_np))
    assert np.all((parent >= 0) & (parent < K))
    top = lw_np[np.isfinite(lw_np)].max()
    w = np.where(np.isfinite(lw_np), np.exp(lw_np - top), 0.0)
    truth = {hh: w[h_np == hh].sum() for hh in uniq}
    total = sum(truth.values())
    slot_w = np.exp(new_lw - top)
    for hh in uniq:
        sel = h_np[parent] == hh
        if sel.any():
            # A group's mass is a difference of running sums: its error
            # scales with the total, not with the group.
            np.testing.assert_allclose(slot_w[sel].sum(), truth[hh],
                                       rtol=0, atol=1e-12 * total)
        else:
            assert truth[hh] < total / K * (1 + 1e-9), hh
    _, merged_lw, is_rep, ng2 = tfr._merge_stats(_t(h_np.view(np.int64)),
                                                 _t(lw_np))
    assert int(ng2) == int(n_groups)  # a sort defers nothing
    merged_lw, is_rep = merged_lw.numpy(), is_rep.numpy()
    for hh in uniq:
        rep = np.flatnonzero(is_rep & (h_np == hh))
        assert len(rep) == 1
        np.testing.assert_allclose(np.exp(merged_lw[rep] - top).sum(),
                                   truth[hh], rtol=0, atol=1e-12 * total)


def test_merge_resample_positions_invariants():
    """Twin of the JAX test: exact n_unique, valid parents, total weight
    kept exactly, group slot counts within 1 of K times the share, and
    no absorbed member becomes a parent."""
    rng = np.random.RandomState(2)
    K = 4096
    pool = rng.randint(0, 2**63, size=257).astype(np.uint64)
    h_np = pool[rng.randint(0, len(pool), K)]
    lw_np = rng.normal(size=K) * 2.0
    lw_np[:5] = -np.inf
    parent, new_lw, n_unique = tfr._merge_resample_positions(
        _u_of(jax.random.PRNGKey(3)), _t(h_np.view(np.int64)), _t(lw_np))
    parent, new_lw = parent.numpy(), new_lw.numpy()
    assert int(n_unique) == len(np.unique(h_np))
    assert np.all((parent >= 0) & (parent < K))
    lse = float(torch.logsumexp(_t(lw_np), 0))
    np.testing.assert_allclose(new_lw, lse - np.log(K), rtol=1e-12)
    w = np.where(np.isfinite(lw_np), np.exp(lw_np - lw_np[5:].max()), 0.0)
    for hh in np.unique(h_np[np.isfinite(lw_np)]):
        share = w[h_np == hh].sum() / w.sum()
        got = (h_np[parent] == hh).sum()
        assert abs(got - K * share) < 1.0 + 1e-9, (hh, got, K * share)
    assert np.isfinite(lw_np[parent]).all()


def _scan_emulated(xs):
    """K20's scan order in Python floats."""
    rows = [xs[i:i + 32] for i in range(0, len(xs), 32)]
    local = []
    for row in rows:
        acc, out = row[0], [row[0]]
        for v in row[1:]:
            acc = acc + v
            out.append(acc)
        local.append(out)
    if len(rows) == 1:
        return local[0]
    tot = _scan_emulated([r[-1] for r in local])
    return local[0] + [tot[r - 1] + v for r in range(1, len(rows))
                       for v in local[r]]


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1025, 40000])
def test_scan_order(dtype, n):
    """K20's fixed-order scan (`scan_plain`): integers exactly as a
    cumsum; float64 bit for bit as the order emulated in Python floats,
    and to rounding against a float64 cumsum."""
    rng = np.random.RandomState(n)
    x = torch.as_tensor(rng.rand(n) if dtype == torch.float64
                        else rng.randint(0, 3, n)).to(dtype)
    got = tfr.scan_plain(x)
    assert got.dtype == dtype
    if dtype == torch.int32:
        assert torch.equal(got, torch.cumsum(x, 0).to(torch.int32))
        return
    assert got.tolist() == _scan_emulated(x.tolist())
    np.testing.assert_allclose(got.numpy(), np.cumsum(x.numpy()),
                               rtol=1e-13)


# --- K21 -------------------------------------------------------------------------


@pytest.mark.parametrize("flagged", [False, True])
def test_gather_pair_matches_jax(flagged):
    """K21's plain version equals `_gather_planes_pair_packed` after the
    layout change (negative int8 cells included), and carries the flag."""
    rng = np.random.RandomState(5)
    stride, E, K = 16, 4, 2048
    L = stride * E
    pt = rng.randint(-128, 128, (K, L)).astype(np.int8)
    dt = rng.randint(0, 12, (K, L)).astype(np.int8)
    flag = rng.rand(K) < 0.3
    parent = rng.randint(0, K, K)
    jp, jd = jens._gather_planes_pair_packed(
        _planes(pt, stride), _planes(dt, stride),
        jnp.asarray(parent, jnp.int32))
    out = tfr.gather_pair(_t(pt), _t(dt), _t(parent, torch.int64),
                          _t(flag) if flagged else None)
    np.testing.assert_array_equal(out[0].numpy(), _from_planes(jp))
    np.testing.assert_array_equal(out[1].numpy(), _from_planes(jd))
    if flagged:
        np.testing.assert_array_equal(out[2].numpy(), flag[parent])


# --- One block of the blocked frontier's rounds -----------------------------------


def _jax_block_draws(key, rounds, stride, E, K):
    """`_blocked_rounds`' own draws: split(key, rounds); each round's
    key split into the shift's and the uniforms' ([E, K] float32)."""
    shifts, us = [], []
    for k in jax.random.split(key, rounds):
        k1, k2 = jax.random.split(k)
        shifts.append(int(jax.random.randint(k1, (), 0, stride,
                                             dtype=jnp.int32)))
        us.append(np.asarray(jax.random.uniform(k2, (E, K),
                                                dtype=jnp.float32)).T)
    return (torch.tensor(shifts, dtype=torch.int32),
            torch.as_tensor(np.ascontiguousarray(np.stack(us))))


@pytest.mark.parametrize("tag,tau,bitslice", [
    ("ex2-ferromagnetic-chain", 1.0, False),
    ("ex2-ferromagnetic-chain", 0.5, None),
    ("ex4-chemical-turing", 1.0, False),
    ("ex4-chemical-turing", 0.5, None),
    ("ex5-msrtf-machine", 1.0, None),
    ("ex5-msrtf-machine", 0.5, False),
])
def test_blocked_rounds_match_jax(tag, tau, bitslice):
    """One block of `_blocked_rounds` fed JAX's own draws: tapes bit for
    bit, lw to rtol 1e-6 with atol 1e-6: the increments are float32 of
    magnitude about 1 (an ulp is 1.2e-7), and XLA's fused sum over the
    sites associates them otherwise for some members. ex5 takes the round circuit by default
    (K14 on K15's words) as the reference does; the choose machines at
    tau = 1 are held on the FSM walk (the sampling circuit's stream is
    not JAX's)."""
    jdm, tdm = _dm(tag)
    rng = np.random.RandomState(11)
    K, L, E, rounds = 256, 64, 4, 6
    stride = L // E
    hi = tdm.size_a
    pt = rng.randint(0, hi, (K, L)).astype(np.int8)
    dt = rng.randint(0, hi, (K, L)).astype(np.int8)
    lw = rng.randn(K)
    key = jax.random.PRNGKey(7)
    jp, jd, jl = jens._blocked_rounds(
        key, _planes(pt, stride), _planes(dt, stride), jnp.asarray(lw), jdm,
        rounds=rounds, tau=tau, bitslice=bitslice)
    shifts, u = _jax_block_draws(key, rounds, stride, E, K)
    p, d, l_ = tfr.blocked_rounds_from_draws(
        tdm, _t(pt).clone(), _t(dt).clone(), _t(lw).clone(), shifts, E, u,
        tau=tau, bitslice=bitslice)
    np.testing.assert_array_equal(p.numpy(), _from_planes(jp))
    np.testing.assert_array_equal(d.numpy(), _from_planes(jd))
    np.testing.assert_allclose(l_.numpy(), np.asarray(jl), rtol=1e-6,
                               atol=1e-6)
    if tau != 1.0 and tdm.has_choose:
        assert not np.array_equal(l_.numpy(), lw)


@pytest.mark.parametrize("K", [256, 32768])
def test_blocked_rounds_bitsliced_matches_fsm(K):
    """Twins of `test_blocked_rounds_bitsliced_matches_fsm` and its 3-D
    layout case: the port's bit-sliced block equals its FSM block bit
    for bit, lw untouched."""
    _, tdm = _dm("ex5-msrtf-machine")
    rng = np.random.RandomState(23)
    L, E = 64, 4
    pt = torch.as_tensor(rng.randint(0, tdm.size_a, (K, L)), dtype=torch.int8)
    dt = torch.as_tensor(rng.randint(0, tdm.size_a, (K, L)), dtype=torch.int8)
    lw = torch.as_tensor(rng.randn(K))
    shifts = torch.as_tensor(rng.randint(0, L // E, 4), dtype=torch.int32)
    a = tfr.blocked_rounds_from_draws(tdm, pt.clone(), dt.clone(), lw.clone(),
                                      shifts, E, bitslice=False)
    b = tfr.blocked_rounds_from_draws(tdm, pt.clone(), dt.clone(), lw.clone(),
                                      shifts, E, bitslice=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(b[2], lw)


# --- The per-step beam (K22) -------------------------------------------------------


def _jax_sites(key, steps, L, lo):
    """The absolute sites of `run_weighted_frontier`'s steps: each step
    draws randint(k, (), 0, L) in the frame its earlier rolls left (each
    a roll by -(site + lo)), so step t fires at site_t + the sum of
    (site_i + lo) over the earlier steps, mod L."""
    out, acc = [], 0
    for k in jax.random.split(key, steps):
        s = int(jax.random.randint(k, (), 0, L, dtype=jnp.int32))
        out.append((s + acc) % L)
        acc += s + lo
    return torch.tensor(out, dtype=torch.int32)


@pytest.mark.parametrize("tag", ["ex2-ferromagnetic-chain",
                                 "ex5-msrtf-machine", "ex4-chemical-turing"])
def test_per_step_beam_matches_jax(tag):
    """`run_weighted_frontier` (no merge) fed JAX's site draws: the same
    tapes bit for bit and lw to rtol 1e-12, against both of the JAX
    package's write decodes (packed words and the gather fallback: the
    twin of `test_frontier_write_decode_paths_agree`)."""
    jt = jens.compile_transition_table(tag)
    jtab = jens.device_table(jt)
    ttab = tens.device_table(tens.compile_transition_table(tag), device=CPU)
    rng = np.random.RandomState(1)
    K, L, steps = 64, 32, 12
    hi = jt.size_a
    pt = rng.randint(0, hi, (K, L)).astype(np.int32)
    dt = rng.randint(0, hi, (K, L)).astype(np.int32)
    logw = np.full(K, -math.log(K))
    key = jax.random.PRNGKey(1)
    sites = _jax_sites(key, steps, L, min(jt.p_lo, jt.d_lo))
    (tp, td), tl = tfr.run_weighted_frontier_from_draws(
        (pt, dt), logw, ttab, sites, K)
    assert tp.dtype == torch.int32
    tabs = [jtab]
    if jtab.n_wr_words:
        tabs.append(dataclasses.replace(jtab, wr_words=None, n_wr_words=0))
    for tab in tabs:
        (jp, jd), jl = jens.run_weighted_frontier(
            key, (jnp.asarray(pt), jnp.asarray(dt)), jnp.asarray(logw), tab,
            steps, K)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-12)


# K22's top K as the card's launches run it, in turn: the radix select's
# passes (stopping where a pass's keys are one key), the compaction by
# tiles of K22_TILE (counts, their scan, each key's place), the LSD passes
# by tiles (digit-major counts, their scan, the stable scatter), on the
# rules of `csrc/beam_rule.cuh`.
_K22_HOST = r"""
#include <vector>
#include "beam_rule.cuh"
extern "C" int k22_host_top(const double* child, long long N, int K,
                            int* out_idx) {
  std::vector<uint64_t> key(N);
  for (long long i = 0; i < N; ++i) key[i] = k22_desc_key(child[i]);
  K22Sel s = {0, (unsigned)K, 0, 0, 0};
  for (unsigned pass = 0; pass < K22_PASSES && !s.done; ++pass) {
    unsigned hist[K22_BINS] = {0};
    uint64_t lo = ~0ULL, hi = 0;
    for (long long i = 0; i < N; ++i)
      if (k22_in_pass(key[i], s, pass)) {
        ++hist[k22_digit(key[i], pass)];
        lo = key[i] < lo ? key[i] : lo;
        hi = key[i] > hi ? key[i] : hi;
      }
    s = lo == hi ? k22_select_single(s, hi) : k22_select_step(s, hist, pass);
  }
  const long long tn = (N + K22_TILE - 1) / K22_TILE;
  std::vector<unsigned> lt(tn + 1, 0), eq(tn + 1, 0);
  for (long long i = 0; i < N; ++i) {
    const int c = k22_kept_class(key[i], s);
    lt[i / K22_TILE + 1] += c == 1;
    eq[i / K22_TILE + 1] += c == 2;
  }
  for (long long t = 0; t < tn; ++t) {
    lt[t + 1] += lt[t];
    eq[t + 1] += eq[t];
  }
  std::vector<uint64_t> kk[2] = {std::vector<uint64_t>(K),
                                 std::vector<uint64_t>(K)};
  std::vector<int> ki[2] = {std::vector<int>(K), std::vector<int>(K)};
  uint64_t all_and = ~0ULL, all_or = 0;
  long long kept = 0;
  for (long long t = 0; t < tn; ++t) {
    unsigned a = lt[t], e = eq[t];
    for (long long i = t * K22_TILE; i < N && i < (t + 1) * K22_TILE; ++i) {
      const int c = k22_kept_class(key[i], s);
      if (c == 1 || (c == 2 && e < s.need)) {
        const unsigned pos = a + (e < s.need ? e : s.need);
        if (pos >= (unsigned)K) return 1;
        kk[0][pos] = key[i];
        ki[0][pos] = (int)i;
        all_and &= key[i];
        all_or |= key[i];
        ++kept;
      }
      a += c == 1;
      e += c == 2;
    }
  }
  if (kept != K) return 2;
  const long long tk = (K + K22_TILE - 1) / K22_TILE;
  for (unsigned pass = 0; pass < K22_PASSES; ++pass) {
    if (!k22_varying(all_and, all_or, pass)) continue;
    const unsigned par = k22_parity(all_and, all_or, pass);
    std::vector<unsigned> cnt(K22_BINS * tk, 0);
    for (long long i = 0; i < K; ++i)
      ++cnt[k22_lsd_digit(kk[par][i], pass) * tk + i / K22_TILE];
    unsigned run = 0;
    for (auto& c : cnt) {
      const unsigned x = c;
      c = run;
      run += x;
    }
    for (long long i = 0; i < K; ++i) {
      const unsigned pos =
          cnt[k22_lsd_digit(kk[par][i], pass) * tk + i / K22_TILE]++;
      kk[par ^ 1][pos] = kk[par][i];
      ki[par ^ 1][pos] = ki[par][i];
    }
  }
  const unsigned fin = k22_parity(all_and, all_or, K22_PASSES);
  for (long long i = 0; i < K; ++i) out_idx[i] = ki[fin][i];
  return 0;
}
"""


@pytest.fixture(scope="module")
def k22_host(tmp_path_factory):
    """K22's top K (`csrc/beam_rule.cuh` in the launches' sequence) built
    with the host's C++ compiler."""
    cxx = next((c for c in ("g++", "c++", "clang++") if shutil.which(c)),
               None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k22")
    (out / "k22.cpp").write_text(_K22_HOST)
    lib = out / "libk22.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib),
                    str(out / "k22.cpp")], check=True, capture_output=True,
                   timeout=120)
    fn = ctypes.CDLL(str(lib)).k22_host_top
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _beam_children(case, rng):
    """(child [K*M], K): the K*M children lw[b] + out_log[row, m] of a
    beam step at rows drawn from a table of 16 rows (some outcomes of
    probability 0), in the cases the card's top K must order as the
    stable descending sort does."""
    K, M = {"block": (4099, 2), "tie_across_tiles": (5000, 2),
            "three_outcomes": (3001, 3)}.get(case, (2500, 2))
    out_log = np.log(rng.dirichlet(np.ones(M), size=16))
    out_log[rng.random((16, M)) < 0.2] = -np.inf
    rows = rng.integers(0, 16, K)
    if case == "uniform":  # whole groups tie
        lw = np.full(K, -math.log(K))
    elif case == "presorted":  # a step's output: non-increasing
        lw = -np.sort(rng.exponential(2.0, K))
        lw -= lw[0]
    elif case == "after_merge":  # out of order, dropped slots at -inf
        lw = -np.sort(rng.exponential(2.0, K))
        lw[rng.random(K) < 0.3] = -np.inf
        lw = rng.permutation(lw)
    elif case == "tie_across_tiles":
        # the K-th key inside one value that spans the tiles' boundary at
        # 4096 (children 3000-5999 all equal, the first 2,600 of them
        # kept); the rest above or below
        lw = np.where(np.arange(K) < 1200, 0.0, -5.0)
        lw[1500:3000] = -1.0
        out_log[:] = np.log(0.5)
    else:  # "block", "three_outcomes": rounded weights, many ties
        lw = np.round(-rng.exponential(1.0, K), 1)
    child = (lw[:, None] + out_log[rows]).reshape(-1)
    return child, K


@pytest.mark.parametrize("case", ["uniform", "presorted", "after_merge",
                                  "block", "tie_across_tiles",
                                  "three_outcomes"])
def test_k22_top_k_rule_matches_stable_sort(k22_host, case):
    """K22's select and order (`csrc/beam_rule.cuh`, g++) keep the first
    K of `torch.sort(stable=True, descending=True)` of the children, in
    its order: uniform start weights (whole groups tie), -inf children,
    weights a merge left out of order, presorted runs, K not a multiple
    of the tiles (4099), a K-th key whose ties span a tile boundary, and
    three outcomes a member."""
    rng = np.random.default_rng(["uniform", "presorted", "after_merge",
                                 "block", "tie_across_tiles",
                                 "three_outcomes"].index(case))
    child, K = _beam_children(case, rng)
    got = np.zeros(K, dtype=np.int32)
    assert k22_host(child.ctypes.data, child.size, K, got.ctypes.data) == 0
    want = torch.sort(torch.as_tensor(child), descending=True,
                      stable=True)[1][:K].numpy()
    np.testing.assert_array_equal(got, want)
    if case == "tie_across_tiles":
        assert want[-1] == 5599
        assert child[want[-1]] == child[4095] == child[4096] == child[5600]


def _ex2_exact(cl_k, p0, t_end):
    fn = trhs.make_dy_dt(compile_problem("ex2-ferromagnetic-chain", cl_k),
                         device=CPU)
    return tintegrate.solve(lambda y, t: fn(y), p0,
                            np.linspace(0, t_end, 3), rtol=1e-8,
                            atol=1e-10, device=CPU)[-1]


def _weighted_spd(tape, lw, cl_k):
    w = torch.exp(torch.as_tensor(lw))
    return tens.weighted_window_counts(tape, w, 2, cl_k,
                                       device=CPU).numpy()


def test_weighted_frontier_tracks_exact_spd():
    """Twin of the JAX gate: the per-step beam's weighted windows track
    the exact SPD solve (beam bias allowed at 0.04 absolute)."""
    cl_k = 3
    p0 = ferromagnet_p0(cl_k, p_pair=0.05, corrected=True).ravel()
    dtab = tens.device_table(
        tens.compile_transition_table("ex2-ferromagnetic-chain"), device=CPU)
    K, L = 256, 128
    dtape = tens.sample_tapes_from_spd(2, p0, 2, cl_k, K, L, device=CPU)
    ptape = torch.zeros((K, L), dtype=torch.int32)
    logw = torch.full((K,), -math.log(K), dtype=torch.float64)
    (_, dtape), logw = tfr.run_weighted_frontier(3, (ptape, dtape), logw,
                                                 dtab, 2 * L, K)
    w = np.exp(logw.numpy())
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-9)
    assert 1.0 / np.sum((w / w.sum()) ** 2) > K / 10
    np.testing.assert_allclose(_weighted_spd(dtape, logw, cl_k),
                               _ex2_exact(cl_k, p0, 2.0), atol=0.04)


def test_weighted_frontier_deterministic_rule_keeps_uniform_weights():
    dtab = tens.device_table(
        tens.compile_transition_table("ex5-msrtf-machine"), device=CPU)
    assert dtab.out_cum.shape[1] == 1
    K, L = 64, 32
    rng = np.random.RandomState(0)
    ptape = torch.as_tensor(rng.randint(0, 3, (K, L)), dtype=torch.int32)
    dtape = torch.zeros((K, L), dtype=torch.int32)
    logw = torch.full((K,), -math.log(K), dtype=torch.float64)
    (pt2, dt2), lw = tfr.run_weighted_frontier(1, (ptape, dtape), logw, dtab,
                                               20, K)
    np.testing.assert_allclose(lw.numpy(), -math.log(K), rtol=1e-12)
    assert pt2.dtype == ptape.dtype
    assert int(dt2.abs().sum()) > 0


def test_per_step_frontier_merge_every_tightens_tracking():
    """Twin of the JAX gate: merge_every keeps the beam at least as close
    to the exact SPD, with normalised weights."""
    cl_k = 3
    p0 = ferromagnet_p0(cl_k, p_pair=0.05, corrected=True).ravel()
    dtab = tens.device_table(
        tens.compile_transition_table("ex2-ferromagnetic-chain"), device=CPU)
    K, L = 128, 64
    dtape = tens.sample_tapes_from_spd(2, p0, 2, cl_k, K, L, device=CPU)
    ptape = torch.zeros((K, L), dtype=torch.int32)
    logw = torch.full((K,), -math.log(K), dtype=torch.float64)
    steps = 2 * L
    ys = _ex2_exact(cl_k, p0, steps / L)
    errs = {}
    for me in (0, 4):
        (_, dt2), lw = tfr.run_weighted_frontier(3, (ptape, dtape), logw,
                                                 dtab, steps, K, me)
        np.testing.assert_allclose(np.exp(lw.numpy()).sum(), 1.0, rtol=1e-9)
        errs[me] = np.abs(_weighted_spd(dt2, lw, cl_k) - ys).max()
    assert errs[4] <= errs[0] + 0.01
    assert errs[4] < 0.05


def test_frontier_rejects_wide_alphabet():
    dtab = tens.device_table(
        tens.compile_transition_table("ex2-ferromagnetic-chain"), device=CPU)
    wide = dataclasses.replace(dtab, size_a=200)
    K, L = 8, 32
    pt = torch.zeros((K, L), dtype=torch.int32)
    lw = torch.full((K,), -math.log(K), dtype=torch.float64)
    with pytest.raises(ValueError, match="int8"):
        tfr.run_weighted_frontier(0, (pt, pt), lw, wide, 2, K)
    with pytest.raises(ValueError, match="top_k"):
        tfr.run_weighted_frontier(0, (pt, pt), lw, dtab, 2, K - 1)


def test_per_step_merge_every_collapses_engineered_duplicates():
    """Twin of the JAX gate: from K copies of one tape, merge_every=1
    ends with strictly more distinct tapes than no merging."""
    dtab = tens.device_table(
        tens.compile_transition_table("ex2-ferromagnetic-chain"), device=CPU)
    K, L, steps = 32, 32, 16
    one = torch.as_tensor(np.random.RandomState(0).randint(0, 2, (1, L)),
                          dtype=torch.int32)
    dtape = one.repeat(K, 1)
    ptape = torch.zeros((K, L), dtype=torch.int32)
    logw = torch.full((K,), -math.log(K), dtype=torch.float64)
    counts = {}
    for me in (0, 1):
        (_, dt2), lw = tfr.run_weighted_frontier(3, (ptape, dtape), logw,
                                                 dtab, steps, K, me)
        w = np.exp(lw.numpy())
        np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-9)
        counts[me] = len({tuple(r) for r, wi in zip(dt2.numpy(), w)
                          if wi > 0})
    assert counts[1] > counts[0], counts


# --- The blocked frontier's gates ------------------------------------------------


def test_choose_sampling_dist_tau1_is_exact_identity():
    p = np.array([0.3, 0.7 + 1e-16, 0.0])
    q, delta = tens._choose_sampling_dist(p, 1.0)
    assert (q == p).all() and (delta == 0.0).all()
    q2, delta2 = tens._choose_sampling_dist(p, 0.5)
    np.testing.assert_allclose(q2.sum(), 1.0, rtol=1e-15)
    assert (delta2[:2] != 0.0).any()


def test_blocked_frontier_merges_duplicate_configurations():
    _, tdm = _dm("ex5-msrtf-machine")
    K, L = 64, 32
    base = torch.as_tensor(np.random.RandomState(5).randint(0, 3, (2, L)),
                           dtype=torch.int32)
    pt = base.repeat(K // 2, 1)
    dt = torch.zeros((K, L), dtype=torch.int32)
    lw = torch.full((K,), -math.log(K), dtype=torch.float64)
    (_, _), lw2, nu = tfr.run_weighted_frontier_blocked(
        2, (pt, dt), lw, tdm, (1, 1, 2), device=CPU)
    assert int(nu[0]) == 2
    np.testing.assert_allclose(np.exp(lw2.numpy()), 1.0 / K, rtol=1e-9)


def test_blocked_frontier_deterministic_rule_uniform_weights():
    _, tdm = _dm("ex5-msrtf-machine")
    K, L = 64, 32
    pt = torch.as_tensor(np.random.RandomState(0).randint(0, 3, (K, L)),
                         dtype=torch.int32)
    dt = torch.zeros((K, L), dtype=torch.int32)
    lw = torch.full((K,), -math.log(K), dtype=torch.float64)
    (pt2, dt2), lw2, nu = tfr.run_weighted_frontier_blocked(
        1, (pt, dt), lw, tdm, (3, 4, 2), device=CPU)
    assert (nu.numpy() == K).all()
    np.testing.assert_allclose(lw2.numpy(), -math.log(K), rtol=1e-9)
    assert int(dt2.abs().sum()) > 0
    assert pt2.dtype == pt.dtype


@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_blocked_frontier_tracks_exact_spd(tau):
    """Twin of the JAX gate: the blocked frontier's weighted windows
    track the exact SPD solve within 0.04 at tau 1 and 0.5."""
    cl_k = 3
    p0 = ferromagnet_p0(cl_k, p_pair=0.05, corrected=True).ravel()
    _, tdm = _dm("ex2-ferromagnetic-chain")
    K, L, E, rounds = 256, 128, 8, 4
    dtape = tens.sample_tapes_from_spd(2, p0, 2, cl_k, K, L, device=CPU)
    ptape = torch.zeros((K, L), dtype=torch.int32)
    logw = torch.full((K,), -math.log(K), dtype=torch.float64)
    dt_round = -math.log1p(-E / L)
    blocks = max(1, round(2.0 / (dt_round * rounds)))
    (_, dtape2), lw, nu = tfr.run_weighted_frontier_blocked(
        3, (ptape, dtape), logw, tdm, (blocks, rounds, E), tau=tau,
        device=CPU)
    w = np.exp(lw.numpy())
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-9)
    assert 1.0 / np.sum((w / w.sum()) ** 2) > K / 10
    np.testing.assert_allclose(
        _weighted_spd(dtape2, lw, cl_k),
        _ex2_exact(cl_k, p0, blocks * rounds * dt_round), atol=0.04)


def test_blocked_frontier_rejects_wide_alphabet_and_bad_plans():
    from chemical_kinetics_and_program_execution_torch.engine import dsl

    tag = "_test-wide-alphabet-17"
    if tag not in dsl.registered_problems():
        @dsl.register_problem(tag, symbols=tuple(f"W{i}" for i in range(17)))
        def rule(t):
            if t.get(False, 0) == 1:
                t.set(False, 0, 0)

    tdm = tens.compile_decision_machine(tag)
    K, L = 8, 32
    pt = torch.zeros((K, L), dtype=torch.int32)
    lw = torch.full((K,), -math.log(K), dtype=torch.float64)
    with pytest.raises(ValueError, match="4-bit"):
        tfr.run_weighted_frontier_blocked(0, (pt, pt), lw, tdm, (1, 2, 2),
                                          device=CPU)
    _, ex2 = _dm("ex2-ferromagnetic-chain")
    for plan, match in (((1, 2, 16), "stride"), ((1, 2, 3), "divide"),
                        ((1, 2, 1), "_MAX_PLANE_STRIDE")):
        with pytest.raises(ValueError, match=match):
            tfr.run_weighted_frontier_blocked(
                0, (torch.zeros((K, 128 if plan[2] == 1 else L),
                                dtype=torch.int32),) * 2, lw, ex2, plan,
                device=CPU)
    with pytest.raises(ValueError, match="tau"):
        tfr.run_weighted_frontier_blocked(0, (pt, pt), lw, ex2, (1, 2, 2),
                                          tau=1.5, device=CPU)
    with pytest.raises(TypeError, match="DeviceMachine"):
        tfr.run_weighted_frontier_blocked(0, (pt, pt), lw, None, (1, 2, 2),
                                          device=CPU)


def test_weighted_first_passage_matches_unweighted_and_is_tau_invariant():
    """Twin of the JAX gate: the hit-flagged weighted ensemble at one
    round a block reproduces the brute-force survival (the port's
    `first_passage_times`) at tau 1, and at tau 0.5."""
    _, tdm = _dm("ex2-ferromagnetic-chain")
    K, L, E, n_rounds = 2048, 64, 4, 24
    pattern = (1, 1, 1)
    p0 = ferromagnet_p0(4, p_pair=0.05, corrected=True).ravel()
    dtape = tens.sample_tapes_from_spd(0, p0, 2, 4, K, L, device=CPU)
    ptape = torch.zeros((K, L), dtype=torch.int8)
    lw0 = torch.full((K,), -math.log(K), dtype=torch.float64)
    t_hit, _, _ = tens.first_passage_times(7, (ptape, dtape), tdm, pattern,
                                           (n_rounds, E), device=CPU)
    t_hit = t_hit.numpy()
    surv = {}
    for tau in (1.0, 0.5):
        s, ess, t_blocks, _, _, _, nu = tfr.weighted_first_passage(
            8, (ptape, dtape), lw0, tdm, pattern, (n_rounds, 1, E), tau=tau,
            device=CPU)
        surv[tau] = (s.numpy(), t_blocks)
        if tau == 1.0:
            np.testing.assert_allclose(ess.numpy(), K, rtol=1e-9)
        nu = nu.numpy()
        assert nu.shape == (n_rounds,) and np.all((nu >= 1) & (nu <= K))
    s1, t_blocks = surv[1.0]
    for bi in (n_rounds // 2 - 1, n_rounds - 1):
        s_bf = float((t_hit > t_blocks[bi] + 1e-12).mean())
        se = math.sqrt(max(s_bf * (1 - s_bf), 1e-4) / K)
        assert abs(float(s1[bi]) - s_bf) < 10 * se + 0.02, (bi, s1[bi], s_bf)
        s_t = float(surv[0.5][0][bi])
        assert abs(s_t - s_bf) < 10 * se + 0.05, (bi, s_t, s_bf)


def test_tempered_first_passage_ess_adaptive_exact_oracle():
    """Twin of part (a) of `test_tempered_first_passage_ess_adaptive`:
    at tau 0.5 the absorbing ESS-adaptive estimator's survival on the
    L=12 ring matches the port's master-equation oracle."""
    tag, size_a, cl_k, L = "ex2-ferromagnetic-chain", 2, 3, 12
    pattern, E = (1, 1, 1), 1
    spd = ferromagnet_p0(cl_k, p_pair=0.3).reshape((2,) * cl_k)
    p0 = master.ring_trace_measure(spd, size_a, cl_k, L)
    hitmask = master.ring_contains_pattern(L, size_a, pattern)
    Q = master.build_ring_generator(tag, L)
    S_exact = float(master.discrete_survival(Q, p0, hitmask, 60, L)[-1])
    _, tdm = _dm(tag)
    K = 4096
    lw0 = torch.full((K,), -math.log(K), dtype=torch.float64)
    devs = []
    for seed in (8, 9):
        dtape = tens.sample_tapes_from_spd(seed, spd, size_a, cl_k, K, L,
                                           device=CPU).to(torch.int8)
        ptape = torch.zeros((K, L), dtype=torch.int8)
        s, ess, _, _, lw, _, _ = tfr.weighted_first_passage(
            seed + 100, (ptape, dtape), lw0, tdm, pattern, (4, 15, E),
            tau=0.5, ess_frac=0.5, check_every=1, device=CPU)
        dev = float(s[-1]) - S_exact
        assert abs(dev) < 0.03, (seed, dev, S_exact)
        devs.append(dev)
    assert abs(np.mean(devs)) < 0.02, (devs, S_exact)


def test_tempered_first_passage_ess_adaptive_degeneracy_contrast():
    """Twin of part (b): on the measured collapse scenario plain tau=0.5
    collapses (ESS below K/50, P(hit) 5x low) while the adaptive run
    holds its ESS above K/2 and lands within 3x of the brute-force
    rate."""
    _, tdm = _dm("ex2-ferromagnetic-chain")
    K, L, E = 2048, 64, 4
    blocks, rounds = 2, 128
    pattern = (1,) * 6
    p0 = ferromagnet_p0(4, p_pair=0.05, corrected=True).ravel()
    dtape = tens.sample_tapes_from_spd(0, p0, 2, 4, K, L, device=CPU)
    ptape = torch.zeros((K, L), dtype=torch.int8)
    lw0 = torch.full((K,), -math.log(K), dtype=torch.float64)
    P_BF = 0.033
    s_p, ess_p, *_ = tfr.weighted_first_passage(
        8, (ptape, dtape), lw0, tdm, pattern, (blocks, rounds, E), tau=0.5,
        device=CPU)
    assert float(ess_p[-1]) < K / 50
    assert 1.0 - float(s_p[-1]) < P_BF / 5
    s_a, ess_a, *_ = tfr.weighted_first_passage(
        8, (ptape, dtape), lw0, tdm, pattern, (blocks, rounds, E), tau=0.5,
        ess_frac=0.5, check_every=4, device=CPU)
    assert float(ess_a[-1]) > K / 2
    assert P_BF / 3 < 1.0 - float(s_a[-1]) < 3 * P_BF


def test_we_binned_first_passage_unbiased_and_enriching():
    """Twin of the JAX gate: WE splitting on the progress coordinate is
    unbiased against split=False and a 10x-walker brute force (6 sigma),
    and on the state-rare 6-U motif its leading edge climbs at least two
    bins above equal-K brute force at the JAX test's 6 blocks. At 6
    blocks the JAX package itself resolves flux in 2 of 12 seeds (its
    test's seed is one of them; measured), so the flux is asserted at 12
    blocks, where splitting resolved it in 8 of 8 port seeds while brute
    force sees none."""
    _, tdm = _dm("ex2-ferromagnetic-chain")
    K, L = 256, 64
    pat = (1,) * 8
    n_seeds = 4

    def run(split, s, k_walkers):
        rng = np.random.RandomState(900 + s)
        dtp = torch.as_tensor(rng.randint(0, 2, (k_walkers, L)),
                              dtype=torch.int32)
        pt = torch.zeros((k_walkers, L), dtype=torch.int32)
        lw = torch.full((k_walkers,), -math.log(k_walkers),
                        dtype=torch.float64)
        surv, _, _, qmax = tfr.weighted_first_passage_binned(
            40 + 10 * s + split, (pt, dtp), lw, tdm, pat, (8, 4, 8),
            split=split, seed=s, device=CPU)
        return 1.0 - surv[-1], qmax

    finals = {split: np.asarray([run(split, s, K)[0] for s in range(n_seeds)])
              for split in (True, False)}
    sem = np.sqrt(finals[True].var(ddof=1) / n_seeds
                  + finals[False].var(ddof=1) / n_seeds + 1e-12)
    assert abs(finals[True].mean() - finals[False].mean()) < 6 * sem
    brute10 = np.asarray([run(False, s, 10 * K)[0] for s in range(2)])
    sem10 = np.sqrt(finals[True].var(ddof=1) / n_seeds
                    + brute10.var(ddof=1) / 2 + 1e-12)
    assert abs(finals[True].mean() - brute10.mean()) < 6 * sem10
    rare = (1,) * 6
    Kr = 512
    pt0 = torch.zeros((Kr, L), dtype=torch.int32)
    lw0 = torch.full((Kr,), -math.log(Kr), dtype=torch.float64)
    for blocks in (6, 12):
        out = {split: tfr.weighted_first_passage_binned(
            5, (pt0, pt0), lw0, tdm, rare, (blocks, 4, 8), split=split,
            seed=1, device=CPU) for split in (True, False)}
        assert out[False][0][-1] == 1.0
        assert out[True][3].max() >= out[False][3].max() + 2
    assert out[True][0][-1] < 1.0


# --- The reference's parameters (ROADMAP Queue 3, the RHS factories) -----------


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


@pytest.mark.parametrize("name", [
    "dense.make_dense_dy_dt", "engine.build_dy_dt", "rhs.make_dy_dt",
    "rhs.make_chain_dy_dt", "rhs.make_dual_dy_dt", "integrate.solve",
    "bff_bitslice.apply_bff_round_bitsliced",
    "ensemble.run_weighted_frontier", "ensemble.run_weighted_frontier_blocked",
    "ensemble.weighted_first_passage",
    "ensemble.weighted_first_passage_binned",
])
def test_signature_matches_jax(name):
    """A drop-in call works on the port: every parameter of the JAX
    function in the same place, of the same kind and with the same
    default, except the generator for the key; the port adds only
    keyword-only ``device``. ``dtype`` defaults to None (float64)."""
    mods = {"dense": (jdense, tdense), "engine": (jengine, tengine),
            "rhs": (jrhs, trhs), "integrate": (jintegrate, tintegrate),
            "bff_bitslice": (jbb, tbb), "ensemble": (jens, tens)}
    mod, attr = name.split(".")
    jp = _params(getattr(mods[mod][0], attr))
    tp = _params(getattr(mods[mod][1], attr))
    extra = [p for p in tp if p.name == "device"]
    assert all(p.kind is p.KEYWORD_ONLY and p.default is None for p in extra)
    tp = [p for p in tp if p.name != "device"]
    assert len(tp) == len(jp), (name, [p.name for p in tp])
    for j, t in zip(jp, tp):
        want = "generator" if j.name == "key" else j.name
        assert (t.name, t.kind) == (want, j.kind), (name, j.name)
        if j.name == "dtype":
            assert t.default is None
        elif j.name == "backend":
            assert t.default is None and j.default == "jax"
        else:
            assert t.default == j.default, (name, j.name)


def test_examples_reference_calls_run():
    """The reference's calls that raised TypeError on the port:
    `dense.make_dense_dy_dt(dual, jit=False)` (examples ex3_dual_tape,
    ex4_dual_fuel, ex4_ignition, ex3_tethered_master, ex4var2_ledger),
    `build_dy_dt(tag, cl_k, jit=False)` (bench.py), `solve(...,
    backend="jax")`; dtype float64 passes and float32 raises."""
    prog = tdense.compile_dense("ex4-chemical-turing", 3)
    dual = tdense.compile_dense_dual("ex3-copolymerization", 3)
    y = tdense.make_dense_dy_dt(prog, device=CPU)(np.full(9**3, 9.0**-3))
    for fn in (tdense.make_dense_dy_dt(prog, jit=False, device=CPU),
               tdense.make_dense_dy_dt(prog, np.float64, False, device=CPU),
               tengine.build_dy_dt("ex4-chemical-turing", 3, jit=False,
                                   device=CPU)[0]):
        assert torch.equal(fn(np.full(9**3, 9.0**-3)), y)
    tdense.make_dense_dy_dt(dual, jit=False, device=CPU)
    with pytest.raises(TypeError, match="float64"):
        tdense.make_dense_dy_dt(prog, torch.float32, device=CPU)
    with pytest.raises(TypeError, match="float64"):
        tengine.build_dy_dt("ex4-chemical-turing", 3, dtype="float32",
                            device=CPU)
    fn = tdense.make_dense_dy_dt(prog, jit=False, device=CPU)
    y0 = np.full(9**3, 9.0**-3)
    a = tintegrate.solve(lambda y, t: fn(y), y0, [0.0, 0.5], backend="jax",
                         device=CPU)
    b = tintegrate.solve(lambda y, t: fn(y), y0, [0.0, 0.5], device=CPU)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match="scipy"):
        tintegrate.solve(lambda y, t: fn(y), y0, [0.0, 0.5],
                         backend="scipy", device=CPU)
    with pytest.raises(ValueError, match="stride"):
        tbb.apply_bff_round_bitsliced(None, (None, None, 1, 0), None,
                                      torch.zeros((4, 1, 2, 2),
                                                  dtype=torch.int32),
                                      0, stride=8)
