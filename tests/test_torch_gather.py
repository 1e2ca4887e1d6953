"""Parity of the port's gather engine, dual-SPD programs and chunked
solves with the JAX package (CPU).

The same inputs, made with numpy from a seed, go through the JAX package
(on the CPU) and through the port on ``device="cpu"``, where the kernels'
wrappers run their plain versions: the compiled event tables and the
prefix tree must be equal, the C++ expander (built with the host's
`g++`) equal to the Python one, dp/dt of the tree and chain engines (K7,
K8) and of the dual programs equal to rounding (rtol 1e-12, atol 1e-14;
the dual oracles at the JAX package's own tolerances), and the chunked
and checkpointed solves equal to the JAX package's. K7's and K8's rules
(`csrc/gather_rule.cuh`) and K5's dual items (`csrc/sweep_rule.cuh`) are
built with `g++` and held to the plain versions bit for bit. The kernels
themselves run only on the card (`tests/test_torch_gpu.py`).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu import markov_tapes as jmt
from chemical_kinetics_and_program_execution_tpu.engine import (
    compile as jcompile,
)
from chemical_kinetics_and_program_execution_tpu.engine import dense as jdense
from chemical_kinetics_and_program_execution_tpu.engine import rhs as jrhs
from chemical_kinetics_and_program_execution_tpu.engine import tree as jtree
from chemical_kinetics_and_program_execution_tpu.ode import (
    integrate as j_integrate,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch import markov_tapes as tmt
from chemical_kinetics_and_program_execution_torch.engine import (
    compile as tcompile,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    dense as tdense,
)
from chemical_kinetics_and_program_execution_torch.engine import native
from chemical_kinetics_and_program_execution_torch.engine import rhs as trhs
from chemical_kinetics_and_program_execution_torch.engine import tree as ttree
from chemical_kinetics_and_program_execution_torch.models import (
    initial_states as t_init,
)
from chemical_kinetics_and_program_execution_torch.ode import dop853 as t_dop
from chemical_kinetics_and_program_execution_torch.ode import (
    integrate as t_integrate,
)
from chemical_kinetics_and_program_execution_torch.ops import (
    observables as t_obs,
)

# The cases of `tests/test_engine.py:18-32`.
CASES = [
    ("ex1-radioactive-decay", 3),
    ("ex1-radioactive-decay", 5),
    ("ex2-ferromagnetic-chain", 3),
    ("ex2-ferromagnetic-chain", 5),
    ("ex3-copolymerization", 4),
    ("ex3var1-copolymerization", 4),
    ("ex3var2-copolymerization", 4),
    ("ex4-chemical-turing", 3),
    ("ex4var1-chemical-turing", 3),
    ("ex4var2-chemical-turing", 3),
    ("ex5-msrtf-machine", 3),
    ("ex5var1-msrtf-machine", 3),
    ("ex6-mini-bff-lite", 2),
]
IDS = [f"{tag}-{k}" for tag, k in CASES]
# dp/dt: the same arithmetic, sums in another order (rounding).
RTOL, ATOL = 1e-12, 1e-14
DUAL_TAGS = ["ex1-radioactive-decay", "ex2-ferromagnetic-chain",
             "ex3-copolymerization", "ex4-chemical-turing",
             "ex5-msrtf-machine"]
_COMPILED = {}


def _compiled(tag, cl_k, dual=False):
    """The JAX package's and the port's compiled event tables (cached)."""
    key = (tag, cl_k, dual)
    if key not in _COMPILED:
        _COMPILED[key] = (
            (jcompile.compile_problem_dual(tag, cl_k) if dual
             else jcompile.compile_problem(tag, cl_k, use_cache=False)),
            (tcompile.compile_problem_dual(tag, cl_k) if dual
             else tcompile.compile_problem(tag, cl_k)))
    return _COMPILED[key]


def _from_jax(jc):
    """The JAX package's tables carried over by `problem_from_arrays`."""
    return tcompile.problem_from_arrays(
        jc.tag, jc.size_a, jc.cl_k, jc.pyramid_size, jc.num_signatures,
        {f: getattr(jc, f) for f in tcompile._ARRAY_FIELDS},
        dual=isinstance(jc, jcompile.CompiledDualProblem))


def _spd(rng, size, concentrated=False):
    return rng.dirichlet(np.ones(size) * (0.2 if concentrated else 1.0))


def _ptr(t):
    return t.data_ptr() if isinstance(t, torch.Tensor) else t.ctypes.data


# --- the compiled tables -------------------------------------------------------


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_compile_problem_fields_equal_jax(tag, cl_k):
    """Every table equal to the JAX package's (integers and the float
    w_const, ev_sign exactly), through the C++ expander."""
    jc, tc = _compiled(tag, cl_k)
    for name in tcompile._ARRAY_FIELDS:
        want, got = getattr(jc, name), getattr(tc, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (tc.pyramid_size, tc.num_signatures, tc.state_size,
            tc.num_events) == (jc.pyramid_size, jc.num_signatures,
                               jc.state_size, jc.num_events)


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_native_expander_equals_python_expander(tag, cl_k):
    """The port's C++ expander (`csrc/expander.cc`, built with g++) gives
    the Python `accumulate.Expander`'s tables, event for event."""
    _, native_tables = _compiled(tag, cl_k)
    py = tcompile.compile_problem(tag, cl_k, expander="python")
    for name in tcompile._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(py, name),
                                      getattr(native_tables, name),
                                      err_msg=name)
    assert native.library_path().exists()
    with pytest.raises(ValueError, match="expander"):
        tcompile.compile_problem(tag, cl_k, expander="other")


@pytest.mark.parametrize("tag,cl_k", [("ex4-chemical-turing", 3),
                                       ("ex6-mini-bff-lite", 2)])
def test_no_native_selects_python_expander(monkeypatch, tag, cl_k):
    """With CKPE_NO_NATIVE set, `compile_problem` (and its dual) expand
    by the Python expander, as the JAX package does: no g++ call and no
    native expansion, the native expander's fields."""
    _, native_tables = _compiled(tag, cl_k)
    _, native_dual = _compiled("ex4-chemical-turing", 3, dual=True)

    def refuse(*args, **kwargs):
        raise AssertionError("the native expander was used")

    monkeypatch.setenv("CKPE_NO_NATIVE", "1")
    monkeypatch.setattr(native, "expand_signatures", refuse)
    monkeypatch.setattr(native, "build", refuse)
    monkeypatch.setattr(subprocess, "run", refuse)
    for got, want in (
            (tcompile.compile_problem(tag, cl_k), native_tables),
            (tcompile.compile_problem_dual("ex4-chemical-turing", 3),
             native_dual)):
        for name in tcompile._ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
    with pytest.raises(AssertionError, match="native"):
        tcompile.compile_problem(tag, cl_k, expander="native")


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_build_tree_equals_jax(tag, cl_k):
    """`build_tree`'s levels and event order, `recover_targets` and
    `sorted_scatter` equal to the JAX package's."""
    jc, tc = _compiled(tag, cl_k)
    args = (tc.e_num, tc.e_den, tc.pyramid_size - 1, tc.pyramid_size)
    got, want = ttree.build_tree(*args), jtree.build_tree(*args)
    assert len(got.levels) == len(want.levels)
    for lg, lw in zip(got.levels, want.levels):
        for f in ("num", "den", "parent", "ev_node"):
            np.testing.assert_array_equal(getattr(lg, f), getattr(lw, f))
            assert getattr(lg, f).dtype == getattr(lw, f).dtype
    np.testing.assert_array_equal(got.event_order, want.event_order)
    targets = ttree.recover_targets(tc.num_events, tc.ev_idx, tc.ev_sign,
                                    tc.ev_tgt)
    for g, w in zip(targets, jtree.recover_targets(
            jc.num_events, jc.ev_idx, jc.ev_sign, jc.ev_tgt)):
        np.testing.assert_array_equal(g, w)
    order = got.event_order
    for g, w in zip(ttree.sorted_scatter(targets[0][order],
                                         targets[1][order]),
                    jtree.sorted_scatter(targets[0][order],
                                         targets[1][order])):
        np.testing.assert_array_equal(g, w)


def _flat_tree_tables(tc):
    """The tree's tables as they stood before the compact ones: int32
    (num, den, parent) a node (pyramid indices as the kernels read
    them), every event's node in the levels' concatenation, and the
    sorted signed scatter's entries (event, sign, target) in tree
    order."""
    tr = ttree.build_tree(tc.e_num, tc.e_den, tc.pyramid_size - 1,
                          tc.pyramid_size)
    remap = (lambda x: tcompile.two_pointer_index(x, tc.size_a, tc.cl_k,
                                                  tc.dual))
    sizes = [len(lv.num) for lv in tr.levels]
    level_ptr = np.concatenate([[0], np.cumsum(sizes)])
    node_of = np.empty(tc.num_events, np.int64)
    node_of[tr.event_order] = np.concatenate(
        [lv.ev_node + level_ptr[i] for i, lv in enumerate(tr.levels)])
    levels = [(remap(lv.num), remap(lv.den), lv.parent)
              for lv in tr.levels]
    return levels, node_of


def _decode_slab(t, lv, sl):
    """A slab's (num, den) pyramid indices and parents, from the compact
    tables."""
    i = trhs.ids(sl.id).numpy() + lv.first
    num, den = t.dict_num.numpy()[i], t.dict_den.numpy()[i]
    if sl.off is None:
        return num, den, np.zeros(len(i), np.int64)
    base = sl.base.numpy().astype(np.int64)
    return num, den, base[np.arange(len(i)) // trhs.TILE] + trhs.ids(
        sl.off).numpy()


def _decode_entries(t):
    """Each event value's (+ target, - target) from the compact scatter,
    checking each value has one entry of each sign."""
    tgt = trhs.entry_targets(t).numpy()
    e = t.ent.numpy().astype(np.int64)
    idx, minus = e & (2**31 - 1), e < 0
    plus_t = np.full(t.num_values, -1, np.int64)
    minus_t = np.full(t.num_values, -1, np.int64)
    plus_t[idx[~minus]] = tgt[~minus]
    minus_t[idx[minus]] = tgt[minus]
    assert np.bincount(idx, minlength=t.num_values).tolist() == \
        [2] * t.num_values
    return plus_t, minus_t


@pytest.mark.parametrize("wide", [False, True], ids=["16-bit", "32-bit"])
@pytest.mark.parametrize("tag,cl_k,dual", [(t, k, False) for t, k in CASES]
                         + [(t, 3, True) for t in DUAL_TAGS],
                         ids=IDS + [f"{t}-dual" for t in DUAL_TAGS])
def test_compact_tables_decode_to_flat_tables(tag, cl_k, dual, wide):
    """The compact tables hold the flat ones exactly: the tree's levels
    above the last (num, den, parent a node) as built, its last level's
    nodes in its leaves, each event value's node, signature and two
    signed targets (so each target's entries) as compiled; the chains'
    columns as compiled."""
    _, tc = _compiled(tag, cl_k, dual)
    t = trhs.device_tables(tc, "cpu", wide=wide)
    c = trhs.chain_tables(tc, "cpu", wide=wide)
    flat, node_of = _flat_tree_tables(tc)
    assert t.num_levels == len(flat) and t.num_nodes == sum(
        len(x[0]) for x in flat)
    level_ptr = np.concatenate([[0], np.cumsum([len(x[0]) for x in flat])])
    leaf_node = np.empty(t.num_values, np.int64)
    for l, (lv, (num, den, parent)) in enumerate(zip(t.levels, flat)):
        assert lv.wide == wide
        if lv.node is not None:
            got = _decode_slab(t, lv, lv.node)
            for g, w in zip(got, (num, den, parent if l else got[2])):
                np.testing.assert_array_equal(g, w)
        # each leaf's node: the node of its level with its (parent, pair)
        key = (parent.astype(np.int64) * 2**32
               + num.astype(np.int64) * 2**16 + den) if l else (
            num.astype(np.int64) * 2**16 + den)
        ln, ld, lp = _decode_slab(t, lv, lv.leaf)
        leaf_key = (lp * 2**32 + ln.astype(np.int64) * 2**16 + ld) if l \
            else ln.astype(np.int64) * 2**16 + ld
        order = np.argsort(key)
        at = order[np.searchsorted(key, leaf_key, sorter=order)]
        assert np.array_equal(key[at], leaf_key)
        sl = slice(lv.leaf_first, lv.leaf_first + len(at))
        leaf_node[sl] = level_ptr[l] + at
        np.testing.assert_array_equal(trhs.ids(lv.leaf.sig).numpy(),
                                      tc.e_sig[t.event_order[sl]])
    assert sorted(t.event_order.tolist()) == list(range(tc.num_events))
    np.testing.assert_array_equal(leaf_node, node_of[t.event_order])
    tgt_orig, tgt_adj = ttree.recover_targets(tc.num_events, tc.ev_idx,
                                              tc.ev_sign, tc.ev_tgt)
    for tables in (t, c):
        plus_t, minus_t = _decode_entries(tables)
        np.testing.assert_array_equal(plus_t, tgt_adj[tables.event_order])
        np.testing.assert_array_equal(minus_t,
                                      tgt_orig[tables.event_order])
        counts = np.bincount(trhs.entry_targets(tables).numpy(),
                             minlength=tc.state_size)
        np.testing.assert_array_equal(
            counts, np.bincount(tc.ev_tgt, minlength=tc.state_size))
    np.testing.assert_array_equal(c.event_order, np.arange(tc.num_events))
    np.testing.assert_array_equal(trhs.ids(c.sig).numpy(), tc.e_sig)
    for col, lv in enumerate(c.levels):
        num, den, _ = _decode_slab(c, lv, lv.leaf)
        for g, w in ((num, tc.e_num[:, col]), (den, tc.e_den[:, col])):
            np.testing.assert_array_equal(g, tcompile.two_pointer_index(
                w, tc.size_a, tc.cl_k, tc.dual))


# --- dp/dt ---------------------------------------------------------------------


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_tree_and_chain_dy_dt_match_jax(tag, cl_k):
    """dp/dt of the port's tree and chain engines against the JAX
    package's `rhs.make_dy_dt` and `make_chain_dy_dt`, through the
    port's compile and through the JAX tables carried over, on a random
    and a concentrated SPD."""
    jc, tc = _compiled(tag, cl_k)
    rng = np.random.RandomState(5)
    fns = [(jrhs.make_dy_dt(jc), jrhs.make_chain_dy_dt(jc))]
    for compiled in (tc, _from_jax(jc)):
        fns.append((trhs.make_dy_dt(compiled, device="cpu"),
                    trhs.make_chain_dy_dt(compiled, device="cpu")))
    for concentrated in (False, True):
        p = _spd(rng, tc.state_size, concentrated)
        want_tree, want_chain = (np.asarray(f(jnp.asarray(p)))
                                 for f in fns[0])
        for f_tree, f_chain in fns[1:]:
            got = f_tree(p)
            assert got.dtype == torch.float64 and got.shape == p.shape
            np.testing.assert_allclose(got.numpy(), want_tree, rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(f_chain(p).numpy(), want_chain,
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tag,cl_k", CASES[:8], ids=IDS[:8])
def test_tree_kernel_matches_chain_kernel(tag, cl_k):
    """Twin of the JAX package's test: the tree engine against the chain
    engine on the same tables, with p[0] = -1e-13 (the noise guard)."""
    _, tc = _compiled(tag, cl_k)
    rng = np.random.RandomState(7)
    p = _spd(rng, tc.state_size)
    p[0] = -1e-13
    got = trhs.make_dy_dt(tc, device="cpu")(p).numpy()
    want = trhs.make_chain_dy_dt(tc, device="cpu")(p).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_auto_engine_falls_back_to_tree(monkeypatch):
    """``engine="auto"`` takes the tree engine above DENSE_GROUP_LIMIT
    signature groups, as the JAX package does; "tree" and "chains" name
    the gather engines; a `CompiledProblem` comes back."""
    from chemical_kinetics_and_program_execution_torch import engine

    p = _spd(np.random.RandomState(3), 9**3)
    dense_fn, dense_prog = engine.build_dy_dt("ex4-chemical-turing", 3,
                                              device="cpu")
    assert isinstance(dense_prog, tdense.DenseProgram)
    monkeypatch.setattr(engine, "DENSE_GROUP_LIMIT", 0)
    for name in ("auto", "tree", "chains"):
        fn, prog = engine.build_dy_dt("ex4-chemical-turing", 3, engine=name,
                                      device="cpu")
        assert isinstance(prog, tcompile.CompiledProblem)
        assert fn.tables.kind == ("chains" if name == "chains" else "tree")
        np.testing.assert_allclose(fn(p).numpy(), dense_fn(p).numpy(),
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown engine"):
        engine.build_dy_dt("ex4-chemical-turing", 3, engine="other",
                           device="cpu")


def test_gather_entry_points_default_to_cuda():
    """The gather and dual entry points run on ``cuda`` unless
    ``device="cpu"`` is passed: without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only machine's error")
    _, tc = _compiled("ex2-ferromagnetic-chain", 3)
    _, td = _compiled("ex2-ferromagnetic-chain", 3, dual=True)
    for make, compiled in ((trhs.make_dy_dt, tc), (trhs.make_chain_dy_dt, tc),
                           (trhs.make_dual_dy_dt, td)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(compiled)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmt.build_dy_dt("ex2-ferromagnetic-chain", 3, engine="tree")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdense.make_dense_dy_dt(tdense.compile_dense_dual(
            "ex2-ferromagnetic-chain", 3))


def test_tree_rhs_writes_into_out():
    """The gather engines write dp/dt into ``out`` (a solver's stage row)
    and the ODE driver solves through them as through the dense one."""
    fn, prog = tmt.build_dy_dt("ex4-chemical-turing", 3, engine="tree",
                               device="cpu")
    p = torch.as_tensor(_spd(np.random.RandomState(2), prog.state_size))
    buf = torch.zeros((2, prog.state_size), dtype=torch.float64)
    assert fn(p, out=buf[1]).data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1], fn(p))
    with pytest.raises(TypeError, match="out must be"):
        fn(p, out=torch.zeros(3, dtype=torch.float64))


# --- K7's and K8's rules and K5's dual items, built with g++ -------------------


_GATHER_HOST = r"""
#include "gather_rule.cuh"
static K5Ctx ctx(int a, int k, const double* p, const double* low,
                 unsigned n_state) {
  K5Ctx c;
  c.a = a;
  c.k = k;
  c.p = p;
  c.low = low;
  k5_levels(c);
  c.n_state = n_state;
  return c;
}
extern "C" void k7_host_ratios(int a, int k, const double* p,
                               const double* low, unsigned n_state,
                               const int* dict_num, const int* dict_den,
                               long long n_dict, double* ratio) {
  const K5Ctx c = ctx(a, k, p, low, n_state);
  for (long long q = 0; q < n_dict; ++q)
    ratio[q] = k7_ratio(c, dict_num[q], dict_den[q]);
}
// K7's values launch after phase 0, as its threads walk it: the levels
// above the last, then every level's leaves.
extern "C" void k7_host_values(const double* ratio, const double* s,
                               const long long* rows, int n_levels,
                               double* nv, double* ev) {
  const double* prev = nullptr;
  for (int l = 0; l < n_levels; ++l) {
    const long long* r = rows + l * 13;
    const K7Slab node = {(const void*)r[6], (const void*)r[7],
                         (const int*)r[8]};
    for (long long i = 0; i < r[0]; ++i)
      nv[r[4] + i] = k7_value(ratio, (unsigned)r[3], node, (int)r[2], prev,
                              i);
    prev = nv + r[4];
  }
  for (int l = 0; l < n_levels; ++l) {
    const long long* r = rows + l * 13;
    const K7Slab leaf = {(const void*)r[9], (const void*)r[10],
                         (const int*)r[11]};
    const double* par = l ? nv + rows[(l - 1) * 13 + 4] : nullptr;
    for (long long i = 0; i < r[1]; ++i)
      ev[r[5] + i] = k7_value(ratio, (unsigned)r[3], leaf, (int)r[2], par,
                              i) * s[k7_at((const void*)r[12], (int)r[2], i)];
  }
}
extern "C" void k8_host_values(const double* ratio, const double* s,
                               const long long* rows, int n_cols,
                               const void* sig, int sig_wide, long long n_ev,
                               double* ev) {
  K8Column cols[32];
  for (int c = 0; c < n_cols; ++c)
    cols[c] = {(const void*)rows[c * 3 + 2], (unsigned)rows[c * 3 + 1],
               (int)rows[c * 3]};
  for (long long e = 0; e < n_ev; ++e)
    ev[e] = k8_value(ratio, cols, n_cols, e) * s[k7_at(sig, sig_wide, e)];
}
extern "C" void k7_host_scatter(const double* ev, const unsigned* ent,
                                const int* tgt_ptr, int n_tgt, double* dy) {
  for (int t = 0; t < n_tgt; ++t) {
    double x[kLanes];
    for (int l = 0; l < kLanes; ++l)
      x[l] = k7_lane_sum(ev, ent, tgt_ptr[t], tgt_ptr[t + 1], l);
    dy[t] = k7_fold32(x);
  }
}
extern "C" void k5_host_items(int a, int k, const double* p,
                              const double* low, const double* s,
                              const int* table, double* work, double* dy,
                              const long long* items, int n_items) {
  K5Ctx c = ctx(a, k, p, low, 0);
  c.s = s;
  c.table = table;
  c.work = work;
  c.dy = dy;
  for (int q = 0; q < n_items; ++q) {
    const K5Item it = k5_item(items + (size_t)q * K5_FIELDS, c);
    for (unsigned e = 0; e < it.n; ++e) k5_element<true>(c, it, e);
  }
}
"""


@pytest.fixture(scope="module")
def gather_host(tmp_path_factory):
    """K7's and K8's rules (`csrc/gather_rule.cuh`) and K5's item loop,
    built with the host's C++ compiler without contraction of products
    into sums."""
    cxx = next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                      "clang++")) if c), None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k7")
    (out / "k7.cpp").write_text(_GATHER_HOST)
    lib_path = out / "libk7.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib_path),
                    str(out / "k7.cpp")], check=True, capture_output=True,
                   timeout=120)
    lib = ctypes.CDLL(str(lib_path))
    i, u, ll, p = ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, \
        ctypes.c_void_p
    lib.k7_host_ratios.argtypes = [i, i, p, p, u, p, p, ll, p]
    lib.k7_host_values.argtypes = [p, p, p, i, p, p]
    lib.k8_host_values.argtypes = [p, p, p, i, p, i, ll, p]
    lib.k7_host_scatter.argtypes = [p, p, p, i, p]
    lib.k5_host_items.argtypes = [i, i, p, p, p, p, p, p, p, i]
    return lib


@pytest.mark.parametrize("tag,cl_k,dual", [
    ("ex4-chemical-turing", 3, False), ("ex6-mini-bff-lite", 2, False),
    ("ex1-radioactive-decay", 5, False), ("ex3-copolymerization", 3, True),
    ("ex4-chemical-turing", 3, True)])
def test_gather_rules_match_plain(gather_host, tag, cl_k, dual):
    """K7's and K8's rules built with g++, walked in the kernels' order:
    phase 0's ratios (the dictionaries' guarded ratios), K7's node and
    leaf values (ratio lookup times the parent's value, implicit in the
    tiles' bases and offsets, times the signature's weight), K8's chain
    products, and the scatter's order (a lane's partial from 0.0
    over entries l, l + 32, ... of a target, the xor butterfly's folds):
    each equal to the plain versions (`ratios_plain`,
    `tree_values_plain`, `chain_values_plain`, `scatter_plain`) bit for
    bit, with 16-bit and with 32-bit ids (the same dy), on a concentrated
    SPD with exact zeros and a p[0] of -1e-13."""
    _, tc = _compiled(tag, cl_k, dual)
    a, n = tc.size_a, tc.state_size
    rng = np.random.RandomState(19)
    p = _spd(rng, n, True)
    p[rng.rand(n) < 0.2] = 0.0
    p = p / p.sum()
    p[0] = -1e-13
    p = torch.as_tensor(p)
    low = tdense.pyramids(tc, p, plain=True)
    dys = {}
    for wide in (False, True):
        for t in (trhs.device_tables(tc, "cpu", wide=wide),
                  trhs.chain_tables(tc, "cpu", wide=wide)):
            assert all(lv.wide == wide for lv in t.levels)
            s = tdense.signature_weights_plain(t, p, low)
            ratio = torch.full((t.dict_num.numel(),), np.nan,
                               dtype=torch.float64)
            gather_host.k7_host_ratios(a, cl_k, _ptr(p), _ptr(low), n,
                                       _ptr(t.dict_num), _ptr(t.dict_den),
                                       ratio.numel(), _ptr(ratio))
            assert torch.equal(ratio, trhs.ratios_plain(t, p, low))
            got = torch.full((t.num_values,), np.nan, dtype=torch.float64)
            if t.kind == "tree":
                nv = torch.full((max(t.num_node_values, 1),), np.nan,
                                dtype=torch.float64)
                gather_host.k7_host_values(_ptr(ratio), _ptr(s),
                                           _ptr(t.desc), len(t.levels),
                                           _ptr(nv), _ptr(got))
                want = trhs.tree_values_plain(t, p, low, s)
            else:
                gather_host.k8_host_values(_ptr(ratio), _ptr(s),
                                           _ptr(t.desc), len(t.levels),
                                           _ptr(t.sig), int(t.sig_wide()),
                                           t.num_values, _ptr(got))
                want = trhs.chain_values_plain(t, p, low, s)
            assert torch.equal(got, want), t.kind
            dy = torch.full((n,), np.nan, dtype=torch.float64)
            gather_host.k7_host_scatter(_ptr(got), _ptr(t.ent),
                                        _ptr(t.tgt_ptr), n, _ptr(dy))
            assert torch.equal(dy, trhs.scatter_plain(t, want)), t.kind
            assert bool((dy != 0).any())
            dys.setdefault(t.kind, []).append(dy)
    for tree, chains in zip(dys["tree"], dys["chains"]):
        assert torch.equal(tree, dys["tree"][0])
        assert torch.equal(chains, dys["chains"][0])
        np.testing.assert_allclose(chains.numpy(), tree.numpy(), rtol=RTOL,
                                   atol=ATOL)  # another order of the sums
    if tag == "ex6-mini-bff-lite":  # targets of more than 32 entries
        ptr = t.tgt_ptr
        assert int((ptr[1:] - ptr[:-1]).max()) > trhs.LANES


@pytest.mark.parametrize("tag", ["ex3-copolymerization",
                                 "ex4-chemical-turing"])
def test_sweep_rule_dual_items_match_plain(gather_host, tag):
    """A dual program's K5 items, each reading its tape's p and levels
    and writing its tape's dy half by the offsets in its row (F_POFF,
    F_LOFF), built with g++ and run item by item in plan order: dy equal
    to `sweep_plain`'s bit for bit; no item mixes tapes."""
    prog = tdense.compile_dense_dual(tag, 3)
    dp = tdense.device_program(prog, "cpu")
    plan, n = dp.plan, prog.state_size
    rng = np.random.RandomState(23)
    p = torch.as_tensor(np.concatenate([_spd(rng, n // 2, True),
                                        _spd(rng, n // 2)]))
    low = tdense.pyramids(prog, p, plain=True)
    s = tdense.signature_weights_plain(dp, p, low)
    work = torch.zeros(max(plan.work_size, 1), dtype=torch.float64)
    dy = torch.zeros(n, dtype=torch.float64)
    items = np.ascontiguousarray(plan.items)
    gather_host.k5_host_items(prog.size_a, 3, _ptr(p), _ptr(low), _ptr(s),
                              _ptr(plan.table), _ptr(work), _ptr(dy),
                              _ptr(items), len(items))
    assert torch.equal(dy, tdense.sweep_plain(dp, p, low, s))
    fields = {f: i for i, f in enumerate(tdense.ITEM_FIELDS)}
    tapes = items[:, fields["poff"]] // (n // 2)
    assert set(tapes.tolist()) == {0, 1}
    assert np.array_equal(items[:, fields["loff"]],
                          tapes * (low.numel() // 2))
    assert [plan.steps[i].tape for i in plan.item_step] == tapes.tolist()


# --- the single-tape plan is unchanged by the dual work ------------------------

# sha256 (first 16 hex digits) of each case's single-tape sweep plan: the
# item rows' fields before the dual offsets, item_step, phase_ptr, table
# and (work_size, max_phase, num_groups), as the plan stood before dual
# programs were added.
_PLAN_DIGESTS = {
    ("ex1-radioactive-decay", 3): "7b89925b22173468",
    ("ex1-radioactive-decay", 5): "50f7a82ddca428c9",
    ("ex2-ferromagnetic-chain", 3): "eada75c77490593d",
    ("ex2-ferromagnetic-chain", 5): "94e10a6880032518",
    ("ex3-copolymerization", 4): "5b6c7f466fc5bf35",
    ("ex3var1-copolymerization", 4): "1d2cfa39ccbb6e3b",
    ("ex3var2-copolymerization", 4): "6c75ffccf6485c43",
    ("ex4-chemical-turing", 3): "5f0042949a18ff15",
    ("ex4var1-chemical-turing", 3): "5f0042949a18ff15",
    ("ex4var2-chemical-turing", 3): "ae9d314fda9dbb49",
    ("ex5-msrtf-machine", 3): "947791ebfdd03f94",
    ("ex5var1-msrtf-machine", 3): "947791ebfdd03f94",
    ("ex6-mini-bff-lite", 2): "d4d8ef032c432463",
}


@pytest.mark.parametrize("tag,cl_k", CASES, ids=IDS)
def test_single_tape_plan_unchanged(tag, cl_k):
    plan = tdense.sweep_plan(tdense.compile_dense(tag, cl_k))
    n_old = tdense.ITEM_FIELDS.index("poff")
    h = hashlib.sha256()
    for arr in (plan.items[:, :n_old], plan.item_step, plan.phase_ptr,
                plan.table):
        h.update(np.ascontiguousarray(arr).astype(np.int64).tobytes())
    h.update(f"{plan.work_size}:{plan.max_phase}:{plan.num_groups}".encode())
    assert h.hexdigest()[:16] == _PLAN_DIGESTS[tag, cl_k]
    assert not plan.items[:, n_old:].any()


# --- dual SPDs: twins of tests/test_dual.py ------------------------------------


@pytest.mark.parametrize("tag", DUAL_TAGS)
def test_dual_halves_sum_to_shared_engine_at_equal_spds(tag):
    """At p_prog = p_data the dual tree engine's halves sum to the shared
    tree engine's dp/dt; each half conserves probability; the dual
    tables equal the JAX package's."""
    jd, td = _compiled(tag, 3, dual=True)
    for name in tcompile._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name),
                                      err_msg=name)
    _, shared = _compiled(tag, 3)
    fn_shared = trhs.make_dy_dt(shared, device="cpu")
    fn_dual = trhs.make_dual_dy_dt(td, device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(3):
        p = rng.dirichlet(np.ones(shared.state_size))
        dy_p, dy_d = fn_dual(p, p)
        np.testing.assert_allclose((dy_p + dy_d).numpy(),
                                   fn_shared(p).numpy(), rtol=1e-12,
                                   atol=1e-15)
        assert abs(float(dy_p.sum())) < 1e-13
        assert abs(float(dy_d.sum())) < 1e-13


def test_dual_tree_and_chain_kernels_agree():
    _, td = _compiled("ex2-ferromagnetic-chain", 3, dual=True)
    rng = np.random.RandomState(1)
    pp, pd = rng.dirichlet(np.ones(8)), rng.dirichlet(np.ones(8))
    dy_p, dy_d = trhs.make_dual_dy_dt(td, device="cpu")(pp, pd)
    want = trhs.make_chain_dy_dt(td, device="cpu")(np.concatenate([pp, pd]))
    np.testing.assert_allclose(torch.cat([dy_p, dy_d]).numpy(),
                               want.numpy(), rtol=1e-13, atol=1e-16)


def test_dual_directional_independence_ex1():
    """ex1 reads and writes only the data tape: the program half of
    dp/dt is 0 and the data half does not depend on the program SPD."""
    _, td = _compiled("ex1-radioactive-decay", 3, dual=True)
    fn = trhs.make_dual_dy_dt(td, device="cpu")
    rng = np.random.RandomState(2)
    pd = rng.dirichlet(np.ones(8))
    outs = []
    for _ in range(2):
        dy_p, dy_d = fn(rng.dirichlet(np.ones(8)), pd)
        assert not bool(dy_p.any())
        outs.append(dy_d)
    assert torch.equal(outs[0], outs[1])


def test_dual_asymmetric_coupling_ex3():
    """ex3 couples the tapes: both halves live, and the data half moves
    with the program tape's monomer density."""
    _, td = _compiled("ex3-copolymerization", 3, dual=True)
    fn = trhs.make_dual_dy_dt(td, device="cpu")
    rng = np.random.RandomState(3)
    pd = rng.dirichlet(np.ones(64))
    dy_d = []
    for alpha in (0.2, 0.8):
        pp = (1 - alpha) * np.full(64, 1 / 64.0) + alpha * rng.dirichlet(
            np.ones(64))
        out = fn(pp, pd)
        assert float(out[0].abs().max()) > 0
        assert float(out[1].abs().max()) > 0
        dy_d.append(out[1])
    assert float((dy_d[0] - dy_d[1]).abs().max()) > 1e-12


@pytest.mark.parametrize("tag", DUAL_TAGS[:4])
def test_dense_dual_matches_tree_dual_and_jax(tag):
    """The dense dual program (fields and plans equal to the JAX
    package's `compile_dense_dual`) against the tree dual engine and the
    JAX dense dual at arbitrary (p_prog, p_data), through the port's
    compile and the JAX program carried over; at p_prog = p_data its
    halves sum to the shared dense engine."""
    jprog, tprog = jdense.compile_dense_dual(tag, 3), \
        tdense.compile_dense_dual(tag, 3)
    for name in ("w_num", "w_den", "w_const", "pair_world", "pair_sig"):
        np.testing.assert_array_equal(getattr(tprog, name),
                                      getattr(jprog, name), err_msg=name)
    plans = [(q.sid, q.length, q.orig, q.adj, q.tape) for q in jprog.plans]
    assert [(q.sid, q.length, q.orig, q.adj, q.tape)
            for q in tprog.plans] == plans
    assert (tprog.state_size, tprog.pyramid_size) == (jprog.state_size,
                                                      jprog.pyramid_size)
    carried = tdense.program_from_arrays(
        tag, jprog.size_a, 3, jprog.w_num, jprog.w_den, jprog.w_const,
        jprog.pair_world, jprog.pair_sig, plans, dual=True)
    n = tprog.size_a**3
    rng = np.random.RandomState(4)
    y = np.concatenate([rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))])
    want = np.asarray(jdense.make_dense_dy_dt(jprog)(jnp.asarray(y)))
    _, td = _compiled(tag, 3, dual=True)
    dy_p, dy_d = trhs.make_dual_dy_dt(td, device="cpu")(y[:n], y[n:])
    np.testing.assert_allclose(torch.cat([dy_p, dy_d]).numpy(), want,
                               rtol=1e-12, atol=1e-15)
    shared = tdense.make_dense_dy_dt(tdense.compile_dense(tag, 3),
                                     device="cpu")
    for prog in (tprog, carried):
        fn = tdense.make_dense_dy_dt(prog, device="cpu")
        np.testing.assert_allclose(fn(y).numpy(), want, rtol=1e-12,
                                   atol=1e-15)
        eq = fn(np.concatenate([y[:n], y[:n]])).numpy()
        np.testing.assert_allclose(eq[:n] + eq[n:], shared(y[:n]).numpy(),
                                   rtol=1e-12, atol=1e-15)


def test_ex3_dual_solve_matches_artifact():
    """The port's dense dual solve of `examples/ex3_dual_tape.py` (ex3 at
    cl_k 5, the monomer-rich soup, 401 samples to t=1000, rtol 1e-9,
    atol 1e-11) against the committed `ex3_dual_tape_rich.npz`."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "ex3_dual_tape_rich.npz")
    with np.load(path) as f:
        want, ts = f["ode_ys"], f["ts"]
    fn = tdense.make_dense_dy_dt(
        tdense.compile_dense_dual("ex3-copolymerization", 5), device="cpu")
    y0 = np.concatenate([t_init.copolymerization_p0(5, p_a=0.06).ravel(),
                         t_init.copolymerization_p0(5, p_a=0.02).ravel()])
    got = t_integrate.solve(lambda y, t: fn(y), y0, ts, rtol=1e-9,
                            atol=1e-11, method="dop853", device="cpu")
    assert got.shape == want.shape == (401, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# --- chunked and checkpointed solves: twins of tests/test_ode.py --------------


def _ex1():
    fn, _ = tmt.build_dy_dt("ex1-radioactive-decay", 3, device="cpu")
    return (lambda y, t: fn(y)), np.full(8, 0.125), np.linspace(0.0, 3.0, 31)


def test_chunked_solve_matches_unchunked():
    """Chunks of 7, 10 and 5 samples (10 and 5 divide the 30 steps of the
    grid) against one call, to solver accuracy, through
    `markov_tapes.ode_integrate_ivp`; and each against the JAX package's
    chunked solve, whose chunks these are, at rtol 1e-12 with an
    absolute floor of 1e-14: each chunk derives its first step anew from
    the carried state, so a last-bit difference between the two
    steppers' arithmetic moves a chunk's steps within the solver's
    tolerance (unchunked, the two agree to 1.1e-14 rel here)."""
    kw = dict(tag="ex1-radioactive-decay", size_a=2, cl_k=3,
              p0=np.full(8, 0.125), ts=np.linspace(0.0, 3.0, 31))
    ivp = dict(rtol=1e-12, atol=1e-12, method="DOP853")
    full = tmt.ode_integrate_ivp(backend="torch", device="cpu",
                                 ivp_kwargs=ivp, **kw)
    for chunk in (7, 10, 5):
        got = tmt.ode_integrate_ivp(backend="torch", device="cpu",
                                    ivp_kwargs=dict(ivp, chunk_size=chunk),
                                    **kw)
        assert got.shape == full.shape
        np.testing.assert_allclose(got, full, rtol=1e-9, atol=1e-11)
        want = jmt.ode_integrate_ivp(backend="jax",
                                     ivp_kwargs=dict(ivp, chunk_size=chunk),
                                     **kw)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                                   atol=1e-14)


class _Crash(Exception):
    pass


def _crash_after(monkeypatch, chunks):
    """Makes the stepper raise after ``chunks`` calls; returns the call
    count."""
    calls = {"n": 0}

    def stepper(*a, **k):
        calls["n"] += 1
        if calls["n"] > chunks:
            raise _Crash
        return t_dop.odeint_dop853_dense(*a, **k)

    monkeypatch.setattr(t_integrate, "odeint_dop853_dense", stepper)
    return calls


def test_checkpointed_solve_resumes_after_crash(tmp_path, monkeypatch):
    """A chunked solve killed after two of its five chunks resumes from
    its checkpoint, runs the other three, gives the uninterrupted
    trajectory and removes its files."""
    rhs, p0, ts = _ex1()
    kw = dict(rtol=1e-10, atol=1e-12, chunk_size=7, device="cpu")
    full = t_integrate.solve(rhs, p0, ts, **kw)
    ckpt = str(tmp_path / "solve.npy")
    _crash_after(monkeypatch, 2)
    with pytest.raises(_Crash):
        t_integrate.solve(rhs, p0, ts, checkpoint_path=ckpt, **kw)
    assert (tmp_path / "solve.npy").exists()
    assert (tmp_path / "solve.npy.meta.json").exists()
    calls = _crash_after(monkeypatch, 99)
    resumed, info = t_integrate.solve(rhs, p0, ts, checkpoint_path=ckpt,
                                      return_info=True, progress=True, **kw)
    np.testing.assert_allclose(resumed, full, rtol=1e-9, atol=1e-12)
    assert calls["n"] == 3
    assert info["num_accepted"] > 0
    assert sorted(os.listdir(tmp_path)) == []


def test_projected_solve_resumes_from_state_sidecar(tmp_path, monkeypatch):
    """With a projection the observables of the chunked solve equal the
    full solve's, the full state sampled at the end rides in
    ``info["y_final"]``, and a crash after two chunks resumes from the
    ``.y.npy`` sidecar to the same observables."""
    fn, _ = tmt.build_dy_dt("ex2-ferromagnetic-chain", 4, device="cpu")

    def rhs(y, t):
        return fn(y)

    p0 = np.full(16, 1 / 16)  # (the JAX test's sparse p0 takes 4,900 steps)
    ts = np.linspace(0.0, 2.0, 31)
    seqs = [(1,), (1, 1), (0, 1, 1, 0)]
    proj = t_obs.seq_prob_projector(seqs, 2, 4)
    kw = dict(rtol=1e-11, atol=1e-12, chunk_size=7, method="dop853",
              device="cpu")
    full = t_integrate.solve(rhs, p0, ts, **kw)
    obs, info = t_integrate.solve(rhs, p0, ts, project=proj,
                                  return_info=True, **kw)
    assert obs.shape == (31, 3)
    np.testing.assert_allclose(info["y_final"], full[-1], rtol=1e-12)
    want = proj(torch.as_tensor(full)).numpy()
    np.testing.assert_allclose(obs, want, rtol=1e-9, atol=1e-15)
    ckpt = str(tmp_path / "proj.npy")
    _crash_after(monkeypatch, 2)
    with pytest.raises(_Crash):
        t_integrate.solve(rhs, p0, ts, project=proj, checkpoint_path=ckpt,
                          **kw)
    assert (tmp_path / "proj.npy.y.npy").exists()
    _crash_after(monkeypatch, 99)
    resumed = t_integrate.solve(rhs, p0, ts, project=proj,
                                checkpoint_path=ckpt, **kw)
    np.testing.assert_allclose(resumed, obs, rtol=1e-9, atol=1e-15)
    assert sorted(os.listdir(tmp_path)) == []


def test_chunked_solve_matches_jax_chunked_on_ex4():
    """ex4 at cl_k 3 in chunks of 4 samples: the port's samples against
    the JAX package's chunked solve at rtol 1e-12 (an absolute floor of
    1e-14, as above), with the same accepted and rejected steps."""
    y0 = t_init.chemical_turing_p0(3, powered_fraction=0.04).ravel()
    ts = np.linspace(0.0, 60.0, 13)
    kw = dict(rtol=1e-10, atol=1e-12, method="dop853", chunk_size=4,
              return_info=True)
    jfn = jdense.make_dense_dy_dt(jdense.compile_dense(
        "ex4-chemical-turing", 3))
    want, want_info = j_integrate.solve(lambda y, t: jfn(y), y0, ts, **kw)
    tfn, _ = tmt.build_dy_dt("ex4-chemical-turing", 3, device="cpu")
    got, info = t_integrate.solve(lambda y, t: tfn(y), y0, ts, device="cpu",
                                  **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                               atol=1e-14)
    assert (info["num_accepted"], info["num_rejected"]) == (
        int(want_info["num_accepted"]), int(want_info["num_rejected"]))


def test_ode_chunk_variable_chunks_as_jax(monkeypatch):
    """CKPE_ODE_CHUNK set and no ``chunk_size``: ex4 scenario b at cl_k 3
    solves in the variable's chunks, as the JAX package's solve does:
    the same samples as ``chunk_size=4`` bit for bit, the JAX package's
    accepted and rejected steps, its samples at rtol 1e-12 (an absolute
    floor of 1e-14)."""
    y0 = t_init.chemical_turing_p0(3, powered_fraction=0.01).ravel()
    ts = np.linspace(0.0, 60.0, 13)
    kw = dict(rtol=1e-10, atol=1e-12, method="dop853", return_info=True)
    tfn, _ = tmt.build_dy_dt("ex4-chemical-turing", 3, device="cpu")
    explicit, explicit_info = t_integrate.solve(
        lambda y, t: tfn(y), y0, ts, device="cpu", chunk_size=4, **kw)
    monkeypatch.setenv("CKPE_ODE_CHUNK", "4")
    jfn = jdense.make_dense_dy_dt(jdense.compile_dense(
        "ex4-chemical-turing", 3))
    want, want_info = j_integrate.solve(lambda y, t: jfn(y), y0, ts, **kw)
    calls = _crash_after(monkeypatch, 99)
    got, info = t_integrate.solve(lambda y, t: tfn(y), y0, ts, device="cpu",
                                  **kw)
    assert calls["n"] == 3  # samples 1-4, 5-8, 9-12
    assert np.array_equal(got, explicit) and info == explicit_info
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                               atol=1e-14)
    assert (info["num_accepted"], info["num_rejected"]) == (
        int(want_info["num_accepted"]), int(want_info["num_rejected"]))
