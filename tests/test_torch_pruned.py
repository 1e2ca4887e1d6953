"""Parity of the port's pruned exact mode with the JAX package (CPU).

Weight-threshold pruning (`engine/enumerate.py:BeamGuide`), the C++ ex6
enumerator (`csrc/enumerate6.cc`, `engine/native.py:enumerate_ex6`, built
with g++), the ex6 family and ``fuzz-wide-specs``, pruned dense programs
with their mass tables (`engine/dense.py:compile_dense(p_ref=,
prune_threshold=)`) and the measured mass (`make_dense_dy_dt(
with_mass=True)`, kernel K9's plain version on ``device="cpu"``), held to
the JAX package on the same inputs, made with numpy: worlds and program
fields equal, dp/dt to rounding (rtol 1e-12, atol 1e-14), the mass at
rtol 1e-14 (the same products, summed in another order). K9's rule
(`csrc/mass_rule.cuh`) is built with the host's C++ compiler and held to
its plain version bit for bit. The kernel itself runs only on the card
(`tests/test_torch_gpu.py`).
"""

import ctypes
import itertools
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_tpu import markov as jmarkov
from chemical_kinetics_and_program_execution_tpu.engine import dense as jdense
from chemical_kinetics_and_program_execution_tpu.engine import dsl as jdsl
from chemical_kinetics_and_program_execution_tpu.engine import (
    enumerate as jem,
)
from chemical_kinetics_and_program_execution_tpu.ode.integrate import (
    solve as j_solve,
)
from chemical_kinetics_and_program_execution_torch import cuda
from chemical_kinetics_and_program_execution_torch.engine import (
    dense as tdense,
)
from chemical_kinetics_and_program_execution_torch.engine import dsl as tdsl
from chemical_kinetics_and_program_execution_torch.engine import (
    enumerate as tem,
)
from chemical_kinetics_and_program_execution_torch.engine import native
from chemical_kinetics_and_program_execution_torch.ode.integrate import (
    solve as t_solve,
)

RTOL, ATOL = 1e-12, 1e-14  # dp/dt: the same arithmetic, another order
MASS_RTOL = 1e-14  # the same world weights, summed in another order
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
_FIELDS = ("w_num", "w_den", "w_const", "pair_world", "pair_sig", "m_num",
           "m_den", "m_const")


def _iid(psym, cl_k):
    out = np.array([1.0])
    for _ in range(cl_k):
        out = np.kron(out, psym)
    return out


def _zero_heavy(a):
    """`examples/ex6_mini_bff.py`'s mostly quiescent tape: symbol 0 at
    0.9, the rest 0.1 between them."""
    psym = np.full(a, 0.1 / (a - 1))
    psym[0] = 0.9
    return psym


def _dot_heavy(prob, eps):
    """`examples/ex6_bff_self_spd.py`'s replicator monoculture: p(dot) =
    1 - eps, the rest eps between them."""
    a = prob.size_a
    psym = np.full(a, eps / (a - 1))
    psym[prob.symbols.index("dot")] = 1.0 - eps
    return psym


def _ref(tag, cl_k, kind):
    prob = tdsl.get_problem(tag)
    a = prob.size_a
    if kind == "uniform":
        return None
    if kind == "zero":
        return _iid(_zero_heavy(a), cl_k)
    return _iid(_dot_heavy(prob, 0.02), cl_k)


# (rule, cl_k, threshold, reference SPD): the example's settings, the JAX
# package's parity tests' and a uniform reference.
PRUNED = [
    ("ex6-mini-bff", 3, 1e-4, "zero"),
    ("ex6-mini-bff-self-lite", 3, 1e-6, "uniform"),
    ("ex6-mini-bff-midi", 3, 1e-5, "zero"),
    ("ex6-mini-bff-self", 3, 1e-7, "dot"),
]
PRUNED_IDS = [f"{t}-{k}-{thr:g}-{ref}" for t, k, thr, ref in PRUNED]
_PROGRAMS = {}


def _programs(tag, cl_k, thr, ref):
    """The JAX package's and the port's pruned programs (cached)."""
    key = (tag, cl_k, thr, ref)
    if key not in _PROGRAMS:
        p_ref = _ref(tag, cl_k, ref)
        kw = dict(p_ref=p_ref, prune_threshold=thr, max_worlds=20_000_000)
        _PROGRAMS[key] = (jdense.compile_dense(tag, cl_k, **kw),
                          tdense.compile_dense(tag, cl_k, **kw))
    return _PROGRAMS[key]


def _plans(prog):
    return [(p.sid, p.length, p.orig, p.adj, p.tape) for p in prog.plans]


def _jax_mass(jprog, p):
    """The JAX package's mass, as its `make_dense_dy_dt(with_mass=True)`
    forms it (`engine/dense.py:575-579`), without building the dp/dt
    closure."""
    pyr = jmarkov.pyramid(jnp.asarray(p), jprog.size_a, jprog.cl_k)
    return float(jnp.sum(jnp.asarray(jprog.m_const) * jmarkov.
                         guarded_ratio_prod(pyr, jnp.asarray(jprog.m_num),
                                            jnp.asarray(jprog.m_den))))


# --- twins of tests/test_engine.py ------------------------------------------------


def test_pruned_enumeration_exact_at_tiny_threshold():
    """A prune threshold below every world's weight reproduces the exact
    engine bit for bit and reports mass 1 (within 1e-12); the mass equals
    the JAX package's at rtol 1e-14."""
    full = tdense.compile_dense("ex5-msrtf-machine", 3)
    beam = tdense.compile_dense("ex5-msrtf-machine", 3,
                                prune_threshold=1e-30)
    assert beam.num_worlds == full.num_worlds and beam.pruned
    f_full = tdense.make_dense_dy_dt(full, device="cpu")
    f_beam = tdense.make_dense_dy_dt(beam, with_mass=True, device="cpu")
    p = np.random.RandomState(5).dirichlet(np.ones(full.state_size))
    dy1, mass = f_beam(p)
    assert torch.equal(f_full(p), dy1)
    assert abs(float(mass) - 1.0) < 1e-12
    jbeam = jdense.compile_dense("ex5-msrtf-machine", 3,
                                 prune_threshold=1e-30)
    _, jmass = jdense.make_dense_dy_dt(jbeam, with_mass=True)(p)
    np.testing.assert_allclose(float(mass), float(jmass), rtol=MASS_RTOL)


def test_faithful_ex6_pruned_mode_with_measured_mass():
    """The faithful (non-enumerable) ex6 mini-BFF runs in pruned exact
    mode: enumeration bounded by a reference-weight threshold, the mass
    measured at run time; dp/dt and the mass equal the JAX package's."""
    prob = tdsl.get_problem("ex6-mini-bff")
    a, k = prob.size_a, 3
    psym = _zero_heavy(a)
    p_ref = np.array([np.prod([psym[s] for s in w])
                      for w in itertools.product(range(a), repeat=k)])
    prog = tdense.compile_dense("ex6-mini-bff", k, p_ref=p_ref,
                                prune_threshold=1e-4, max_worlds=100_000)
    assert prog.pruned and prog.num_worlds > 0
    fn = tdense.make_dense_dy_dt(prog, with_mass=True, device="cpu")
    dy, mass = fn(p_ref)
    assert torch.isfinite(dy).all()
    assert abs(float(dy.sum())) < 1e-12  # probability conservation
    assert 0.0 < float(mass) < 1.0  # bounded, measured weight loss
    jprog = jdense.compile_dense("ex6-mini-bff", k, p_ref=p_ref,
                                 prune_threshold=1e-4, max_worlds=100_000)
    jdy, jmass = jdense.make_dense_dy_dt(jprog, with_mass=True)(p_ref)
    np.testing.assert_allclose(dy.numpy(), np.asarray(jdy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(mass), float(jmass), rtol=MASS_RTOL)


def _worlds_equal(got, want):
    assert len(got) == len(want) > 0
    for w_n, w_p in zip(got, want):
        assert w_n.factors == w_p.factors
        assert w_n.tape_sigs == w_p.tape_sigs
        assert w_n.const == w_p.const


def _without(rule, attr, fn):
    """``fn()`` with ``rule.attr`` removed, so the Python odometer runs."""
    saved = getattr(rule, attr)
    delattr(rule, attr)
    try:
        return fn()
    finally:
        setattr(rule, attr, saved)


def test_native_ex6_enumeration_parity():
    """The C++ guided enumerator emits the Python odometer's worlds, bit
    for bit and in its depth-first order, and the JAX package's, for a
    uniform and a concentrated reference (the latter with long zero
    runs)."""
    prob = tdsl.get_problem("ex6-mini-bff")
    jprob = jdsl.get_problem("ex6-mini-bff")
    a = prob.size_a
    for cl_k, p_ref, thr in ((4, np.full(a**4, a**-4.0), 1e-4),
                             (3, _iid(_zero_heavy(a), 3), 1e-5)):
        g = tem.BeamGuide(p_ref, a, cl_k, thr)
        ws_native = tem.enumerate_worlds(prob, cl_k, guide=g)
        ws_python = _without(prob.rule, "native_ex6",
                             lambda: tem.enumerate_worlds(prob, cl_k,
                                                          guide=g))
        _worlds_equal(ws_native, ws_python)
        ws_jax = jem.enumerate_worlds(jprob, cl_k,
                                      guide=jem.BeamGuide(p_ref, a, cl_k,
                                                          thr))
        _worlds_equal(ws_native, ws_jax)
    assert native.library_path(native.ENUM6_SOURCE).exists()


def test_native_ex6_self_enumeration_parity():
    """The C++ enumerator on the single-tape self-modifying variants
    (opcodes fetched from the live data ring): the Python odometer's and
    the JAX package's worlds, for the lite rule and the faithful fuel-10
    rule near a replicator monoculture."""
    for tag, cl_k, thr, concentrated in (
            ("ex6-mini-bff-self-lite", 3, 1e-6, False),
            ("ex6-mini-bff-self", 3, 1e-4, True)):
        prob = tdsl.get_problem(tag)
        a = prob.size_a
        if concentrated:
            psym = np.full(a, 0.02)
            psym[prob.symbols.index("dot")] = 1.0 - 0.02 * (a - 1)
        else:
            psym = np.full(a, 1.0 / a)
        p_ref = _iid(psym, cl_k)
        g = tem.BeamGuide(p_ref, a, cl_k, thr)
        ws_native = tem.enumerate_worlds(prob, cl_k, guide=g)
        ws_python = _without(prob.rule, "native_ex6_self",
                             lambda: tem.enumerate_worlds(prob, cl_k,
                                                          guide=g))
        _worlds_equal(ws_native, ws_python)
        assert all(w.tape_sigs[0] == (0, 0, 0) for w in ws_native)
        ws_jax = jem.enumerate_worlds(jdsl.get_problem(tag), cl_k,
                                      guide=jem.BeamGuide(p_ref, a, cl_k,
                                                          thr))
        _worlds_equal(ws_native, ws_jax)


def test_no_native_selects_python_enumerator(monkeypatch):
    """With CKPE_NO_NATIVE set, a guided ex6 enumeration takes the Python
    odometer (no g++ call, no native enumeration) and gives the native
    enumerator's worlds; without it a failed build raises and nothing
    falls back."""
    prob = tdsl.get_problem("ex6-mini-bff-self-lite")
    a = prob.size_a
    g = tem.BeamGuide(np.full(a**3, a**-3.0), a, 3, 1e-6)
    want = tem.enumerate_worlds(prob, 3, guide=g)

    def refuse(*args, **kwargs):
        raise AssertionError("the native enumerator was used")

    monkeypatch.setattr(native, "enumerate_ex6", refuse)
    monkeypatch.setattr(native, "build", refuse)
    monkeypatch.setattr(subprocess, "run", refuse)
    with pytest.raises(AssertionError, match="native"):
        tem.enumerate_worlds(prob, 3, guide=g)
    monkeypatch.setenv("CKPE_NO_NATIVE", "1")
    _worlds_equal(tem.enumerate_worlds(prob, 3, guide=g), want)


# --- pruned programs and their mass --------------------------------------------


@pytest.mark.parametrize("tag,cl_k,thr,ref", PRUNED, ids=PRUNED_IDS)
def test_pruned_program_fields_equal_jax(tag, cl_k, thr, ref):
    """The pruned program: the live worlds' chains, pairs and plans and
    the mass tables over every enumerated world equal the JAX package's;
    its sweep plans (K5) and the mass tables on the device carry them."""
    jprog, tprog = _programs(tag, cl_k, thr, ref)
    assert tprog.pruned and jprog.pruned
    for name in _FIELDS:
        np.testing.assert_array_equal(getattr(tprog, name),
                                      getattr(jprog, name), err_msg=name)
    assert _plans(tprog) == _plans(jprog)
    assert (tprog.num_signatures, tprog.num_worlds, tprog.pyramid_size) == (
        jprog.num_signatures, jprog.num_worlds, jprog.pyramid_size)
    dp = tdense.device_program(tprog, "cpu")
    assert dp.m_num.dtype == torch.int32 and dp.m_const.dtype == torch.float64
    np.testing.assert_array_equal(dp.m_num.numpy(), jprog.m_num)
    assert dp.plan.num_phases >= 1


def test_ex6_self_example_sizes_match_jax_and_artifact():
    """`examples/ex6_bff_self_spd.py`'s exact side (cl_k 3, eps 0.02,
    threshold 1e-7): the JAX package's counts of live and enumerated
    worlds and of signatures, the committed artifact's ``n_worlds``, and
    its ``mass[0]`` within 1e-11 (the mass at p0, K9's plain version)."""
    jprog, tprog = _programs("ex6-mini-bff-self", 3, 1e-7, "dot")
    assert (tprog.num_worlds, len(tprog.m_const), tprog.num_signatures) == (
        jprog.num_worlds, len(jprog.m_const), jprog.num_signatures)
    art = np.load(EXAMPLES / "ex6_bff_self_spd.npz")
    assert tprog.num_worlds == int(art["n_worlds"])
    p0 = _ref("ex6-mini-bff-self", 3, "dot")
    _, mass = tdense.make_dense_dy_dt(tprog, with_mass=True,
                                      device="cpu")(p0)
    assert abs(float(mass) - float(art["mass"][0])) < 1e-11


@pytest.mark.parametrize("tag,cl_k,thr,ref", PRUNED, ids=PRUNED_IDS)
def test_mass_and_dy_dt_match_jax(tag, cl_k, thr, ref):
    """``make_dense_dy_dt(with_mass=True)``: dp/dt equal (bit for bit) to
    the program's dp/dt without mass and to rounding to the JAX
    package's (rtol 1e-12; on the programs of 300 signatures or fewer:
    the JAX package jits one function a group), the mass a 0-d float64
    tensor at rtol 1e-14 of the JAX package's, at the reference SPD and
    at a random one."""
    jprog, tprog = _programs(tag, cl_k, thr, ref)
    fn = tdense.make_dense_dy_dt(tprog, with_mass=True, device="cpu")
    plain = tdense.make_dense_dy_dt(tprog, device="cpu")
    n = tprog.state_size
    p_ref = _ref(tag, cl_k, ref)
    for p in (np.full(n, 1.0 / n) if p_ref is None else p_ref,
              np.random.RandomState(3).dirichlet(np.full(n, 0.3))):
        dy, mass = fn(p)
        assert mass.shape == () and mass.dtype == torch.float64
        assert torch.equal(dy, plain(p))
        assert 0.0 < float(mass) <= 1.0 + 1e-12
        np.testing.assert_allclose(float(mass), _jax_mass(jprog, p),
                                   rtol=MASS_RTOL)
        if jprog.num_signatures <= 300:
            jdy, _ = jdense.make_dense_dy_dt(jprog, with_mass=True)(p)
            np.testing.assert_allclose(dy.numpy(), np.asarray(jdy),
                                       rtol=RTOL, atol=ATOL)


def test_with_mass_writes_dy_into_out_and_keeps_calls_apart():
    """``fn(p, out=row)`` with mass writes dp/dt into the row; two calls'
    masses are two tensors (the second call does not overwrite the
    first's)."""
    _, tprog = _programs("ex6-mini-bff", 3, 1e-4, "zero")
    fn = tdense.make_dense_dy_dt(tprog, with_mass=True, device="cpu")
    rng = np.random.RandomState(9)
    p1, p2 = (rng.dirichlet(np.ones(tprog.state_size)) for _ in range(2))
    row = torch.empty(tprog.state_size, dtype=torch.float64)
    dy, m1 = fn(p1, out=row)
    assert dy.data_ptr() == row.data_ptr()
    keep = float(m1)
    _, m2 = fn(p2)
    assert float(m1) == keep and float(m2) != keep


def test_fuzz_wide_specs_dy_dt_matches_jax():
    """``fuzz-wide-specs`` at cl_k 3: the dense program equal to the JAX
    package's, dp/dt to rounding, probability conserved."""
    jprog = jdense.compile_dense("fuzz-wide-specs", 3)
    tprog = tdense.compile_dense("fuzz-wide-specs", 3)
    for name in _FIELDS[:5]:
        np.testing.assert_array_equal(getattr(tprog, name),
                                      getattr(jprog, name), err_msg=name)
    assert _plans(tprog) == _plans(jprog)
    jfn = jdense.make_dense_dy_dt(jprog)
    fn = tdense.make_dense_dy_dt(tprog, device="cpu")
    rng = np.random.RandomState(4)
    for conc in (1.0, 0.2):
        p = rng.dirichlet(np.full(tprog.state_size, conc))
        dy = fn(p)
        np.testing.assert_allclose(dy.numpy(), np.asarray(jfn(p)), rtol=RTOL,
                                   atol=ATOL)
        assert abs(float(dy.sum())) < 1e-13


# Each segment's kept worlds, the final mass: `examples/ex6_mini_bff.py`
# at its defaults (cl_k 3, threshold 1e-4, t 0-50, 201 samples, 10
# segments re-pruned at the state reached, dopri5 at 1e-9).
def _ex6_mini_bff_loop(compile_dense, make, solve_fn):
    prob = tdsl.get_problem("ex6-mini-bff")
    y = _iid(_zero_heavy(prob.size_a), 3)
    ts = np.linspace(0.0, 50.0, 201)
    seg = (len(ts) - 1) // 10
    counts, masses = [], []
    for s in range(10):
        prog = compile_dense("ex6-mini-bff", 3, p_ref=y,
                             prune_threshold=1e-4, max_worlds=1_000_000)
        fn = make(prog)
        ys = solve_fn(fn, y, ts[s * seg:(s + 1) * seg + 1])
        masses.extend(float(fn(yy)[1]) for yy in ys[1:])
        y = np.asarray(ys[-1])
        counts.append(prog.num_worlds)
    return counts, masses, y


def test_ex6_mini_bff_loop_matches_jax():
    """The example's re-pruned loop through both packages: each
    segment's kept-world count equal, the masses at every sample and the
    final state within 1e-10 abs (dopri5 at 1e-9: the two solves may
    take different steps, see `tests/test_torch_solvers.py`)."""
    want = _ex6_mini_bff_loop(
        jdense.compile_dense,
        lambda prog: jdense.make_dense_dy_dt(prog, with_mass=True),
        lambda fn, y, ts: np.asarray(j_solve(lambda y_, t: fn(y_)[0], y,
                                             ts, rtol=1e-9, atol=1e-9)))
    got = _ex6_mini_bff_loop(
        tdense.compile_dense,
        lambda prog: tdense.make_dense_dy_dt(prog, with_mass=True,
                                             device="cpu"),
        lambda fn, y, ts: t_solve(lambda y_, t: fn(y_)[0], y, ts, rtol=1e-9,
                                  atol=1e-9, device="cpu"))
    assert got[0] == want[0]
    assert len(set(got[0])) > 3  # the kept worlds change as p moves
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-10)


# --- K9's rule under g++ -------------------------------------------------------

_K9_HOST = r"""
#include "mass_rule.cuh"
extern "C" double k9_host(int a, int k, const double* p, const double* low,
                          const int* num, const int* den,
                          const double* m_const, int chain, int n_worlds) {
  K5Ctx c;
  c.a = a;
  c.k = k;
  c.p = p;
  c.low = low;
  k5_levels(c);
  K4Pairs w;
  w.num = num;
  w.den = den;
  w.w_const = m_const;
  w.csr_ptr = nullptr;
  w.chain = chain;
  return k9_host_mass(c, w, n_worlds);
}
"""


@pytest.fixture(scope="module")
def k9_host(tmp_path_factory):
    """K9's rule (`csrc/mass_rule.cuh`: K4's world weight and the launch's
    fixed order of the sum, walked block by block) built with the host's
    C++ compiler without contraction of products into sums."""
    cxx = next((c for c in (shutil.which(n) for n in ("g++", "c++",
                                                      "clang++")) if c), None)
    if cxx is None:
        pytest.skip("no C++ compiler (g++, c++, clang++) on PATH")
    out = tmp_path_factory.mktemp("k9")
    (out / "k9.cpp").write_text(_K9_HOST)
    lib = out / "libk9.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda.CSRC_DIR), "-o", str(lib),
                    str(out / "k9.cpp")], check=True, capture_output=True,
                   timeout=120)
    fn = ctypes.CDLL(str(lib)).k9_host
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, p, p, p, p, p, i, i]
    fn.restype = ctypes.c_double
    return fn


def _ptr(t):
    return t.data_ptr()


@pytest.mark.parametrize("case", ["ex6-self", "ex5-tiny", "ex6-self-x40"])
def test_mass_rule_matches_plain(k9_host, case):
    """K9's rule equals `world_mass_plain` bit for bit: ex6-mini-bff-self
    at the example's settings (9,912 worlds, 39 blocks), ex5 at a tiny
    threshold (every world kept, mass 1) and the ex6 tables repeated 40
    times (396,480 worlds: 1,024 blocks, each thread over several)."""
    if case == "ex5-tiny":
        prog = tdense.compile_dense("ex5-msrtf-machine", 3,
                                    prune_threshold=1e-30)
    else:
        _, prog = _programs("ex6-mini-bff-self", 3, 1e-7, "dot")
    dp = tdense.device_program(prog, "cpu")
    if case.endswith("x40"):
        dp.m_num, dp.m_den = dp.m_num.repeat(40, 1), dp.m_den.repeat(40, 1)
        dp.m_const = dp.m_const.repeat(40)
    a, k = prog.size_a, prog.cl_k
    rng = np.random.RandomState(13)
    p = rng.dirichlet(np.full(prog.state_size, 0.3))
    p[rng.rand(p.size) < 0.1] = 0.0  # the guard's 0 branch
    p = torch.as_tensor(p / p.sum())
    low = tdense.pyramid(p, a, k)
    want = tdense.world_mass_plain(dp, p, low)
    got = k9_host(a, k, _ptr(p), _ptr(low), _ptr(dp.m_num), _ptr(dp.m_den),
                  _ptr(dp.m_const), dp.m_num.shape[1], dp.m_num.shape[0])
    assert got == want.item() and want.item() > 0.0
    if case == "ex5-tiny":
        assert abs(want.item() - 1.0) < 1e-12
