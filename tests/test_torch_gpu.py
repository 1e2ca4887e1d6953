"""Card-only tests: the port's CUDA kernels against their plain versions.

On a machine with an NVIDIA card (and no jax, which `tests/conftest.py`
imports), run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a card every test here skips. This file imports no jax and
nothing of the JAX package.
"""

import math

import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_torch import markov_tapes
from chemical_kinetics_and_program_execution_torch.engine import (
    compile as tcompile,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    dense as tdense,
)
from chemical_kinetics_and_program_execution_torch.engine import rhs as trhs
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as tens,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    frontier as tfr,
)
from chemical_kinetics_and_program_execution_torch.engine import dsl as tdsl
from chemical_kinetics_and_program_execution_torch.engine import (
    bitslice as tbs,
)
from chemical_kinetics_and_program_execution_torch.models.initial_states import (  # noqa: E501
    chemical_turing_p0,
    copolymerization_p0,
)
from chemical_kinetics_and_program_execution_torch.ode import dop853, dopri5
from chemical_kinetics_and_program_execution_torch.ode.integrate import solve
from chemical_kinetics_and_program_execution_torch.ops import thermo

pytestmark = pytest.mark.gpu

TAGS = ["ex5-msrtf-machine", "ex4-chemical-turing", "ex2-ferromagnetic-chain"]
# Symbols that reach ex4's reverse reaction (p0 = X, d0 in B/C/D, I/O
# neighbours) at a useful rate.
_ACTIVE_SYMBOLS = {"ex4-chemical-turing": ((6, 7), (0, 1, 2, 3, 4, 5))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def _draws(rng, tag, dm, B, L, E, n):
    """Tapes over the active symbols, shifts covering every phase, and
    uniforms a third each near 0, near 1 and anywhere in [0, 1)."""
    p_sym, d_sym = _ACTIVE_SYMBOLS.get(tag, (range(dm.size_a),) * 2)
    pt = rng.choice(np.asarray(p_sym), (B, L)).astype(np.int32)
    dt = rng.choice(np.asarray(d_sym), (B, L)).astype(np.int32)
    stride = L // E
    shifts = np.concatenate([rng.permutation(stride),
                             rng.randint(0, stride, max(0, n - stride))])
    u = rng.rand(n, B, E)
    pick = rng.randint(0, 3, (n, B, E))
    u = np.where(pick == 0, u * 1e-3, np.where(pick == 1, 0.95 + 0.05 * u, u))
    return pt, dt, shifts[:n].astype(np.int32), u.astype(np.float32)


def _planes(tape, stride, device):
    return tens._tape_to_planes(
        torch.as_tensor(tape, device=device).to(torch.int8), stride)


def _kernel_against_plain(cuda, tag, B, L, E, n, seed, shifts=None):
    """Runs K1 and its plain version, both on the card, round by round,
    and checks the planes after each; returns the number of cells K1
    changed."""
    dm = tens.compile_decision_machine(tag)
    rng = np.random.RandomState(seed)
    stride = L // E
    pt, dt, drawn, u = _draws(rng, tag, dm, B, L, E, n)
    kp, kd = _planes(pt, stride, cuda), _planes(dt, stride, cuda)
    start_p, start_d = kp.clone(), kd.clone()
    pp, pd = kp.clone(), kd.clone()
    shifts_t = torch.as_tensor(drawn if shifts is None else shifts,
                               dtype=torch.int32, device=cuda)
    u_t = torch.as_tensor(u, device=cuda)
    launches = tens.plane_round.launches
    for k in range(n):
        tens.plane_round(dm, kp, kd, shifts_t, k, u_t[k])
        tens.plane_round_plain(dm, pp, pd, shifts_t, k, u_t[k])
        torch.cuda.synchronize()
        assert torch.equal(kp, pp) and torch.equal(kd, pd), k
    assert tens.plane_round.launches == launches + n
    return int((kp != start_p).sum() + (kd != start_d).sum())


@pytest.mark.parametrize("B,L,E", [(512, 1024, 64), (300, 1008, 63)],
                         ids=["words", "bytes"])
@pytest.mark.parametrize("tag", TAGS)
def test_plane_round_kernel_matches_plain(cuda, tag, B, L, E):
    """K1 and its plain version, both on the card, give identical planes
    after every round; every phase is covered, on the word path (E a
    multiple of 4) and the byte path (E not)."""
    assert _kernel_against_plain(cuda, tag, B, L, E, 24, 1) > 0


@pytest.mark.parametrize("tag,spill", [("ex4-chemical-turing", -1),
                                       ("ex5-msrtf-machine", 1)])
def test_plane_round_kernel_spilled_cells(cuda, tag, spill):
    """Phases at which a window cell spills into the row's previous
    (ex4, offset -2 at phase 0) or next (ex5, offset 3 at the last
    phase) element, on the word path, where such a cell is funnelled
    from two words and stored byte by byte."""
    dm = tens.compile_decision_machine(tag)
    B, L, E = 256, 1024, 64
    stride = L // E
    shift = 0 if spill < 0 else stride - 1
    assert spill in {e for _, _, e in tens._round_cells(dm, shift, stride)}
    assert _kernel_against_plain(cuda, tag, B, L, E, 8, 5,
                                 shifts=[shift] * 8) > 0


@pytest.mark.parametrize("tag", TAGS)
def test_run_rounds_on_card_matches_cpu(cuda, tag):
    """The same explicit draws give the same tapes on the card (K1) and
    on the CPU (plain version)."""
    dm = tens.compile_decision_machine(tag)
    rng = np.random.RandomState(2)
    B, L, E, n = 64, 256, 16, 40
    stride = L // E
    pt, dt, shifts, u = _draws(rng, tag, dm, B, L, E, n)
    out = []
    for dev in (cuda, torch.device("cpu")):
        p_st, d_st = _planes(pt, stride, dev), _planes(dt, stride, dev)
        tens.run_rounds(dm, p_st, d_st, torch.as_tensor(shifts, device=dev),
                        torch.as_tensor(u, device=dev))
        out.append((p_st.cpu(), d_st.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_run_ensemble_goes_through_the_kernel(cuda):
    dm = tens.compile_decision_machine("ex4-chemical-turing")
    rng = np.random.RandomState(3)
    B, L, E, n = 128, 512, 32, 25
    tapes = (rng.randint(0, dm.size_a, (B, L)), rng.randint(0, dm.size_a,
                                                             (B, L)))
    launches, calls = tens.plane_round.launches, tens.plane_round_plain.calls
    (pt, dt), (applied, times) = tens.run_ensemble(
        torch.Generator(device=cuda).manual_seed(0), tapes, dm, (n, E),
        bitslice=False)
    assert tens.plane_round.launches == launches + n
    assert tens.plane_round_plain.calls == calls
    assert pt.device.type == "cuda" and pt.dtype == torch.int32
    assert int(pt.min()) >= 0 and int(dt.max()) < dm.size_a
    assert applied.tolist() == [B * E] * n
    assert torch.all(torch.diff(times) > 0)


def _window_tape(rng, kind, size_a, cl_k, B, L):
    """A tape uniform over [0, size_a); all 0 (``constant``); or with a
    tenth of its symbols negative and a tenth each s and -s, where the
    int32 rank of [s, 0, ..., 0] wraps into range (``out of range``)."""
    if kind == "constant":
        return np.zeros((B, L), np.int32)
    tape = rng.randint(0, size_a, (B, L))
    if kind == "out of range":
        s = 2**32 // size_a ** (cl_k - 1) + 1
        s = s - 2**32 if s >= 2**31 else s
        pick = rng.randint(0, 10, (B, L))
        tape = np.where(pick == 0, -rng.randint(1, size_a + 1, (B, L)), tape)
        tape = np.where(pick == 1, s, np.where(pick == 2, -s, tape))
    return tape.astype(np.int32)


def _yardstick_bins(tape, size_a, cl_k):
    """The bins the reference counts, found apart from `window_bins`:
    each rank as sum_j tape[:, (i+j) mod L] * (size_a**(cl_k-1-j) mod
    2**32) mod 2**32, read as an int32; a rank in [-n, 0) in bin
    rank + n, any other outside [0, n) dropped."""
    n, L = size_a**cl_k, tape.shape[1]
    cols = torch.arange(L, device=tape.device)
    rank = torch.zeros(tape.shape, dtype=torch.int64, device=tape.device)
    for j in range(cl_k):
        term = tape[:, (cols + j) % L].to(torch.int64) * pow(
            size_a, cl_k - 1 - j, 2**32)
        rank = torch.remainder(rank + torch.remainder(term, 2**32), 2**32)
    rank = torch.where(rank >= 2**31, rank - 2**32, rank)
    rank = torch.where(rank < 0, rank + n, rank)
    return rank[(rank >= 0) & (rank < n)]


@pytest.mark.parametrize("L", [999, 1000], ids=["scalar", "int4"])
@pytest.mark.parametrize("size_a,cl_k,kind", [
    (2, 2, "uniform"), (5, 3, "uniform"), (9, 4, "uniform"),
    (2, 14, "uniform"), (5, 3, "out of range"), (5, 3, "constant"),
    (5, 6, "uniform"), (2, 16, "uniform"),
])
def test_window_counts_kernel_matches_plain(cuda, size_a, cl_k, kind, L):
    """K2 equals its plain version and `torch.bincount` exactly: with the
    histogram in shared memory (up to 2**14 bins here) and in device
    memory (2**16 bins), on rows read a symbol at a time (L = 999) and
    16 bytes at a time (L = 1000), with symbols outside [0, size_a)."""
    rng = np.random.RandomState(size_a + cl_k)
    tape = torch.as_tensor(_window_tape(rng, kind, size_a, cl_k, 64, L),
                           device=cuda)
    launches = tens.window_counts.launches
    got = tens.window_counts(tape, size_a, cl_k)
    assert tens.window_counts.launches == launches + 1
    plain = tens.window_counts_plain(tape, size_a, cl_k)
    assert torch.equal(got, plain.to(torch.float64) / tape.numel())
    lib = torch.bincount(_yardstick_bins(tape, size_a, cl_k),
                         minlength=size_a**cl_k)
    assert torch.equal(plain, lib)


def test_kernel_wrappers_reject_bad_inputs(cuda):
    dm = tens.compile_decision_machine("ex5-msrtf-machine")
    planes = torch.zeros((16, 4, 8), dtype=torch.int32, device=cuda)
    shifts = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        tens.plane_round(dm, planes, planes, shifts, 0)
    p8 = planes.to(torch.int8)
    with pytest.raises(IndexError):
        tens.plane_round(dm, p8, p8.clone(), shifts, 1)
    with pytest.raises(ValueError, match="shifts"):
        tens.plane_round(dm, p8, p8.clone(), shifts.cpu(), 0)


# --- The exact closure: K3-K6 ---------------------------------------------------

# The cases of the JAX package's `tests/test_engine.py:18-32`.
EXACT_CASES = [
    ("ex1-radioactive-decay", 3), ("ex1-radioactive-decay", 5),
    ("ex2-ferromagnetic-chain", 3), ("ex2-ferromagnetic-chain", 5),
    ("ex3-copolymerization", 4), ("ex3var1-copolymerization", 4),
    ("ex3var2-copolymerization", 4), ("ex4-chemical-turing", 3),
    ("ex4var1-chemical-turing", 3), ("ex4var2-chemical-turing", 3),
    ("ex5-msrtf-machine", 3), ("ex5var1-msrtf-machine", 3),
    ("ex6-mini-bff-lite", 2),
]
# dp/dt against the plain version on the card: the digit sums run in the
# same order, the plain version's scatters use atomics (their order
# varies), so agreement is to rounding.
RTOL, ATOL = 1e-12, 1e-14


def _spd(rng, size, concentrated=False):
    return rng.dirichlet(np.ones(size) * (0.2 if concentrated else 1.0))


def _programs(tag, cl_k, cuda):
    prog = tdense.compile_dense(tag, cl_k)
    return prog, tdense.device_program(prog, cuda)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


K3_CASES = [(9, k) for k in (3, 5, 6, 7, 8)] + [(2, 5), (2, 13), (2, 16),
                                                (5, 6), (6, 3)]


@pytest.mark.parametrize("a,cl_k", K3_CASES)
def test_pyramid_kernel_matches_plain(cuda, a, cl_k):
    """K3 (one launch when a tile holds p, else two) against its plain
    version on the card, a random SPD with exact zeros: the same sums in
    the same order, so the same bits; and the same bits twice."""
    rng = np.random.RandomState(cl_k)
    p = _spd(rng, a**cl_k, concentrated=True)
    p[rng.rand(p.size) < 0.3] = 0.0
    p = torch.as_tensor(p, device=cuda)
    launches = tdense.pyramid.launches
    low = tdense.pyramid(p, a, cl_k)
    assert tdense.pyramid.launches == launches + tdense.pyramid_launches(
        a, cl_k)
    assert torch.equal(low, tdense.pyramid_plain(p, a, cl_k))
    assert torch.equal(low, tdense.pyramid(p, a, cl_k))


@pytest.mark.parametrize("tag,cl_k", EXACT_CASES
                         + [("ex4-chemical-turing", k) for k in (5, 6, 7, 8)])
def test_signature_weights_kernel_matches_plain(cuda, tag, cl_k):
    """K4, K5's phase 0: the signature weights one K5 launch leaves in
    ``s`` equal its plain version bit for bit (both sum each signature's
    pairs in pair order from 0), up to ex6-lite's 11,520 worlds and 4,536
    signatures and ex4 at cl_k 8."""
    prog, dp = _programs(tag, cl_k, cuda)
    p = torch.as_tensor(_spd(np.random.RandomState(1), prog.state_size),
                        device=cuda)
    low = tdense.pyramid_plain(p, prog.size_a, cl_k)
    s = torch.full((prog.num_signatures,), float("nan"),
                   dtype=torch.float64, device=cuda)
    launches = tdense.sweep.launches
    tdense.sweep(dp, p, low, s=s)
    assert tdense.sweep.launches == launches + 1
    want = tdense.signature_weights_plain(dp, p, low)
    assert torch.equal(s, want)
    assert torch.equal(want, tdense.signature_weights_plain(dp, p, low))


@pytest.mark.parametrize("tag,cl_k", EXACT_CASES
                         + [("ex4-chemical-turing", k) for k in (5, 6, 7, 8)])
def test_sweep_kernel_matches_plain(cuda, tag, cl_k):
    """K5 (one launch, the signature weights its phase 0) against the
    plain versions, on the same pyramid: each dy window's terms in the
    same order, so equal to the plain version's own rounding (its
    scatters' atomics); two runs the same bits; in every launch form the
    program can take (`dense.forms_for`: the grid, one block, a cluster,
    the chosen form), each the others' bits, and `dense_rhs` (the levels
    formed in the launch in the block and cluster forms) too."""
    prog, dp = _programs(tag, cl_k, cuda)
    p = torch.as_tensor(_spd(np.random.RandomState(2), prog.state_size),
                        device=cuda)
    low = tdense.pyramid_plain(p, prog.size_a, cl_k)
    s = tdense.signature_weights_plain(dp, p, low)
    chosen, by_form = dp.form, []
    for form in tdense.forms_for(dp):
        dp.form = form
        launches = tdense.sweep.launches
        by_form.append(tdense.sweep(dp, p, low))
        assert tdense.sweep.launches == launches + 1
        assert torch.equal(tdense.dense_rhs(dp, p), by_form[-1])
    dp.form = chosen
    got = by_form[-1]
    assert all(torch.equal(x, got) for x in by_form)
    _close(got, tdense.sweep_plain(dp, p, low, s))
    # Into a caller's row (a solver's stage row): the same bits, nothing
    # else of the tensor touched.
    rows = torch.full((2, prog.state_size), 7.0, dtype=torch.float64,
                      device=cuda)
    assert tdense.sweep(dp, p, low, rows[1]).data_ptr() == \
        rows[1].data_ptr()
    assert torch.equal(rows[1], got) and bool((rows[0] == 7.0).all())


def test_dense_kernels_reject_bad_inputs(cuda):
    prog, dp = _programs("ex4-chemical-turing", 3, cuda)
    n = prog.state_size
    p = torch.as_tensor(_spd(np.random.RandomState(4), n), device=cuda)
    low = tdense.pyramid(p, 9, 3)
    s = torch.empty(prog.num_signatures, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float64"):
        tdense.pyramid(p.float(), 9, 3)
    with pytest.raises(TypeError, match="float64"):
        tdense.pyramid(p[:-1], 9, 3)
    with pytest.raises(TypeError):
        tdense.sweep(dp, p, low[:-1])
    with pytest.raises(ValueError):
        tdense.sweep(dp, p, low.cpu())
    with pytest.raises(TypeError):
        tdense.sweep(dp, p, low, s=s.float())
    with pytest.raises(TypeError):
        tdense.sweep(dp, p, low, s=s[:-1])
    with pytest.raises(TypeError):
        tdense.sweep(dp, p, low, torch.empty(n + 1, dtype=torch.float64,
                                             device=cuda)[1:][:-1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdense.pyramid(p.to("meta"), 9, 3)


@pytest.mark.parametrize("tag,cl_k", EXACT_CASES)
def test_dense_rhs_on_card_matches_plain(cuda, tag, cl_k):
    """The kernel path K3 -> K5 (one C call) against the plain dp/dt
    on the card, on a random and a concentrated SPD; float64; conserves
    probability; two runs the same bits; a NaN in p gives a non-finite
    dy, as the plain version's."""
    prog = tdense.compile_dense(tag, cl_k)
    fn = tdense.make_dense_dy_dt(prog, device=cuda)
    rng = np.random.RandomState(3)
    for concentrated in (False, True):
        p = torch.as_tensor(_spd(rng, prog.state_size, concentrated),
                            device=cuda)
        got = fn(p)
        assert got.dtype == torch.float64 and got.device.type == "cuda"
        _close(got, tdense.dy_dt_dense(fn.device_program, p))
        assert torch.equal(got, fn(p))
        assert abs(float(got.sum())) < 1e-13
    p[prog.state_size // 2] = float("nan")
    assert not bool(torch.isfinite(fn(p)).all())
    assert not bool(torch.isfinite(tdense.dy_dt_dense(
        fn.device_program, p)).all())


@pytest.mark.parametrize("cl_k", [5, 6, 7, 8])
def test_dense_rhs_launches_three_times(cuda, cl_k):
    """ex4's RHS on the card through one C call, counted: in the grid
    form (cl_k 5-8) K3's two launches and K5's one (K4 is its phase 0);
    in the block and cluster forms K5's one, its leading phases the
    levels."""
    prog = tdense.compile_dense("ex4-chemical-turing", cl_k)
    fn = tdense.make_dense_dy_dt(prog, device=cuda)
    p = torch.full((prog.state_size,), 1.0 / prog.state_size,
                   dtype=torch.float64, device=cuda)
    before = tdense.pyramid.launches, tdense.sweep.launches
    fn(p)
    torch.cuda.synchronize(cuda)
    got = (tdense.pyramid.launches - before[0],
           tdense.sweep.launches - before[1])
    kind = fn.device_program.form.kind
    assert kind == 0
    assert got == ((0, 1) if kind else (2, 1))
    assert tdense.pyramid_launches(9, cl_k) == 2


def test_dense_rhs_on_two_streams_at_once(cuda):
    """One program's RHS queued on two streams in turn, so that their K5
    launches may overlap: each call has its own work buffer and grid
    barrier, so each gives the bits it gives alone."""
    prog = tdense.compile_dense("ex4-chemical-turing", 4)
    fn = tdense.make_dense_dy_dt(prog, device=cuda)
    rng = np.random.RandomState(5)
    ps = [torch.as_tensor(_spd(rng, prog.state_size), device=cuda)
          for _ in range(2)]
    want = [fn(p) for p in ps]
    streams = [torch.cuda.Stream(cuda) for _ in ps]
    torch.cuda.synchronize(cuda)
    got = [[], []]
    for _ in range(20):
        for q, (p, st) in enumerate(zip(ps, streams)):
            with torch.cuda.stream(st):
                got[q].append(fn(p))
    torch.cuda.synchronize(cuda)
    for q in range(2):
        assert all(torch.equal(g, want[q]) for g in got[q])


def _k6_inputs(cuda, n, padded, seed=4):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if padded:
        ks = dop853.rows_tensor(16, n, cuda)
        F = dop853.rows_tensor(7, n, cuda)
        assert ks.stride(0) % 32 == 0 and ks.stride(0) > n
    else:
        ks = torch.empty((16, n), dtype=torch.float64, device=cuda)
        F = torch.empty((7, n), dtype=torch.float64, device=cuda)
    ks.copy_(torch.rand((16, n), generator=gen, dtype=torch.float64,
                        device=cuda) - 0.5)
    y = torch.rand(n, generator=gen, dtype=torch.float64, device=cuda)
    return ks, F, y, y + 1e-3 * ks[3]


@pytest.mark.parametrize("n", [9**5, 9**8], ids=["k5", "full"])
def test_dop853_kernels_match_plain(cuda, n):
    """Each K6 kernel against its plain version on random stages, with
    the stages and the dense stack at a row stride of n and in the
    solver's padded rows (`dop853.rows_tensor`): `stage` from the card's
    tableau at every row, in both swap states, and `dense_coeffs` the
    plain version's bits; `norms` in one launch a call, one scratch for
    all, the plain version's bits (its sums in the kernel's order) and
    the same twice; one `dense_eval` launch for a step's samples."""
    before = [k.launches for k in dop853.KERNELS]
    for padded in (False, True):
        ks, F, y, y_new = _k6_inputs(cuda, n, padded)
        rows = list(range(16))
        out, want = torch.empty_like(y), torch.empty_like(y)
        for swap in (0, 1):
            for which in range(dop853._E5_ROW):
                assert torch.equal(
                    dop853.stage(y, ks, 0.37, which, out, swap),
                    dop853.stage_plain(y, ks, 0.37,
                                       dop853.tableau_terms(which, swap),
                                       want)), (which, swap)
        scratch = dop853.norm_scratch(cuda)
        for swap in (0, 1):
            for mode, args in ((dop853._RMS, dict(f0=ks[0])),
                               (dop853._RMS_DIFF, dict(f0=ks[0], f1=ks[1])),
                               (dop853._ERR, dict(y_new=y_new, ks=ks,
                                                  swap=swap))):
                got = dop853.norms(mode, y, 1e-10, 1e-12, scratch=scratch,
                                   **args).clone()
                assert torch.equal(got, dop853.norms(mode, y, 1e-10, 1e-12,
                                                     **args))
                plain = dict(args)
                if mode == dop853._ERR:
                    plain.pop("swap")
                    plain.update(
                        terms5=dop853.tableau_terms(dop853._E5_ROW, swap),
                        terms3=dop853.tableau_terms(dop853._E3_ROW, swap))
                assert torch.equal(got, dop853.norms_plain(
                    mode, y, 1e-10, 1e-12, **plain)), (mode, swap)
        F_want = torch.empty((7, n), dtype=torch.float64, device=cuda)
        assert torch.equal(
            dop853.dense_coeffs(y, y_new, 0.37, ks[0], ks[12], ks, rows, F),
            dop853.dense_coeffs_plain(y, y_new, 0.37, ks[0], ks[12], ks,
                                      rows, F_want))
        ts = torch.tensor([0.0, 1.0, 1.1, 1.3, 1.37, 1.5], dtype=torch.float64,
                          device=cuda)
        s_got = dop853.rows_tensor(5, n, cuda)
        s_want = dop853.rows_tensor(5, n, cuda)
        assert torch.equal(
            dop853.dense_eval(F, y, ts, 1, 5, 1.0, 0.37, s_got),
            dop853.dense_eval_plain(F, y, ts, 1, 5, 1.0, 0.37, s_want))
    # stage: 16 rows x 2 swaps; norms: 3 modes x 2 swaps x 2 calls; one
    # launch each of dense_coeffs and dense_eval; twice (two layouts).
    assert [k.launches - b for k, b in zip(dop853.KERNELS, before)] == \
        [64, 24, 2, 2]


@pytest.mark.parametrize("n,m", [(9**5, 1), (9**5, 7), (9**5, 200),
                                 (9**8, 8)])
def test_dense_eval_step_matches_plain(cuda, n, m):
    """One `dense_eval` launch for a step's m samples (chunks of 8 rows
    on blockIdx.y) against the plain version's per-fraction evaluation,
    bit for bit: sample times inside the step, one before (fraction 0)
    and one past it (fraction 1); rows past m untouched."""
    ks, F, y, y_new = _k6_inputs(cuda, n, True, seed=m)
    dop853.dense_coeffs(y, y_new, 0.37, ks[0], ks[12], ks, list(range(16)),
                        F)
    del ks
    rng = np.random.RandomState(m)
    t, h = 2.0, 0.37
    ts = np.concatenate([[0.0, t - 0.5],
                         np.sort(t + h * rng.rand(max(m - 2, 0))),
                         [t + h + 0.5]])[:m + 1]
    ts_dev = torch.as_tensor(ts, device=cuda)
    got = dop853.rows_tensor(m + 1, n, cuda)
    got[m].fill_(7.0)
    launches = dop853.dense_eval.launches
    dop853.dense_eval(F, y, ts_dev, 1, m, t, h, got)
    assert dop853.dense_eval.launches == launches + 1
    want = dop853.rows_tensor(m, n, cuda)
    dop853.dense_eval_plain(F, y, ts_dev, 1, m, t, h, want)
    assert torch.equal(got[:m], want)
    assert bool((got[m] == 7.0).all())
    with pytest.raises(TypeError, match="float64"):
        dop853.dense_eval(F, y, ts_dev.float(), 1, m, t, h, got)
    with pytest.raises(ValueError):
        dop853.dense_eval(F, y, ts_dev, 1, m + 1, t, h, got)


def test_norms_on_two_streams_at_once(cuda):
    """Two runs of `norms` queued on two streams in turn, each with its
    own scratch (as two solves have): each gives the bits it gives alone,
    every time."""
    n = 9**6
    ks, _, y, y_new = _k6_inputs(cuda, n, True)
    ys = [y, y_new]
    want = [dop853.norms(dop853._ERR, v, 1e-13, 1e-13, y_new=y_new, ks=ks)
            .clone() for v in ys]
    streams = [torch.cuda.Stream(cuda) for _ in ys]
    scratch = [dop853.norm_scratch(cuda) for _ in ys]
    torch.cuda.synchronize(cuda)
    got = [[], []]
    for _ in range(20):
        for q, (v, st) in enumerate(zip(ys, streams)):
            with torch.cuda.stream(st):
                got[q].append(dop853.norms(
                    dop853._ERR, v, 1e-13, 1e-13, y_new=y_new, ks=ks,
                    scratch=scratch[q]).clone())
    torch.cuda.synchronize(cuda)
    for q in range(2):
        assert all(torch.equal(g, want[q]) for g in got[q])


@pytest.mark.parametrize("n", [9**5, 4**8], ids=["k5", "ex3var2-k8"])
def test_dopri5_rows_match_plain(cuda, n):
    """K6's second table on the card: `stage` at the Euler row and at each
    dopri5 row (A's rows 1-6, B5, B5 - B4), in both states of the swap of
    stages 0 and 6, and `norms` in dopri5's mode (`_ERR_H`), each the
    plain version's bits and the same bits twice."""
    gen = torch.Generator(device=cuda).manual_seed(n % 1009)
    ks = dop853.rows_tensor(7, n, cuda)
    ks.copy_(torch.rand((7, n), generator=gen, dtype=torch.float64,
                        device=cuda) - 0.5)
    y = torch.rand(n, generator=gen, dtype=torch.float64, device=cuda)
    y_new = y + 1e-3 * ks[3]
    fsal = dopri5.FSAL
    out, want = torch.empty_like(y), torch.empty_like(y)
    rows = [dop853._EULER, *dop853.DP5_ROWS[1:], dop853.DP5_B5_ROW,
            dop853.DP5_ERR_ROW]
    before = (dop853.stage.launches, dop853.norms.launches)
    for swap in (0, 1):
        for which in rows:
            got = dop853.stage(y, ks, 0.37, which, out, swap, fsal).clone()
            assert torch.equal(got, dop853.stage(y, ks, 0.37, which, out,
                                                 swap, fsal))
            assert torch.equal(got, dop853.stage_plain(
                y, ks, 0.37, dop853.tableau_terms(which, swap, fsal),
                want)), (which, swap)
        args = dict(y_new=y_new, ks=ks, swap=swap, h=0.37, fsal=fsal,
                    rows=(dop853.DP5_ERR_ROW,))
        got = dop853.norms(dop853._ERR_H, y, 1e-9, 1e-9, **args).clone()
        assert torch.equal(got, dop853.norms(dop853._ERR_H, y, 1e-9, 1e-9,
                                             **args))
        assert torch.equal(got, dop853.norms_plain(
            dop853._ERR_H, y, 1e-9, 1e-9, y_new=y_new, ks=ks, h=0.37,
            terms5=dop853.tableau_terms(dop853.DP5_ERR_ROW, swap, fsal)))
        assert got[1].item() == 0.0
    assert (dop853.stage.launches - before[0],
            dop853.norms.launches - before[1]) == (2 * 2 * len(rows), 4)


def _pruned(tag, cl_k, thr, p_ref):
    return tdense.compile_dense(tag, cl_k, p_ref=p_ref, prune_threshold=thr,
                                max_worlds=20_000_000)


def _dot_heavy_p0(tag, cl_k, eps):
    prob = tdsl.get_problem(tag)
    psym = np.full(prob.size_a, eps / (prob.size_a - 1))
    psym[prob.symbols.index("dot")] = 1.0 - eps
    out = np.array([1.0])
    for _ in range(cl_k):
        out = np.kron(out, psym)
    return out


@pytest.mark.parametrize("case", ["ex6-self", "ex5-tiny"])
def test_world_mass_kernel_matches_plain(cuda, case):
    """K9 against its plain version on the same pyramid, bit for bit, the
    same bits twice, one launch a call: ex6-mini-bff-self at
    `examples/ex6_bff_self_spd.py`'s settings (9,912 worlds) and ex5 at
    a tiny threshold (every world kept: mass 1 within 1e-12); through
    ``make_dense_dy_dt(with_mass=True)``, three launches (K3, K5, K9),
    the mass K9's bits and dp/dt the kernels' without mass."""
    if case == "ex6-self":
        p_ref = _dot_heavy_p0("ex6-mini-bff-self", 3, 0.02)
        prog = _pruned("ex6-mini-bff-self", 3, 1e-7, p_ref)
        assert (prog.num_worlds, len(prog.m_const)) == (4517, 9912)
    else:
        prog = _pruned("ex5-msrtf-machine", 3, 1e-30, None)
        p_ref = np.full(prog.state_size, 1.0 / prog.state_size)
    dp = tdense.device_program(prog, cuda)
    a, k = prog.size_a, prog.cl_k
    rng = np.random.RandomState(31)
    for p in (p_ref, _spd(rng, prog.state_size, concentrated=True)):
        p = torch.as_tensor(p, device=cuda)
        low = tdense.pyramid_plain(p, a, k)
        before = tdense.world_mass.launches
        got = tdense.world_mass(dp, p, low)
        again = tdense.world_mass(dp, p, low, tdense.mass_scratch(cuda))
        assert tdense.world_mass.launches == before + 2
        want = tdense.world_mass_plain(dp, p, low)
        assert got.shape == () and torch.equal(got, want)
        assert torch.equal(got, again)
        if case == "ex5-tiny":
            assert abs(got.item() - 1.0) < 1e-12
    fn = tdense.make_dense_dy_dt(prog, with_mass=True, device=cuda)
    counts = (tdense.pyramid.launches, tdense.sweep.launches,
              tdense.world_mass.launches)
    dy, mass = fn(p)
    assert (tdense.pyramid.launches - counts[0], tdense.sweep.launches
            - counts[1], tdense.world_mass.launches - counts[2]) == (
        tdense.rhs_pyramid_launches(fn.device_program), 1, 1)
    assert torch.equal(mass, tdense.world_mass_plain(
        dp, p, tdense.pyramid_plain(p, a, k)))
    assert torch.equal(dy, tdense.make_dense_dy_dt(prog, device=cuda)(p))


@pytest.mark.parametrize("method", ["dopri5", "dop853-step"])
def test_loose_solve_on_card_matches_cpu(cuda, method):
    """ex3var2 at cl_k 4 on `examples/ex3_copolymerization.py`'s grid
    (1,001 samples to t = 200, rtol = atol = 1e-9): the solve through K3,
    K5 and K6 walks the CPU's plain solve's steps; no plain version runs
    on the card."""
    y0 = copolymerization_p0(4).ravel()
    ts = np.linspace(0.0, 200.0, 1001)
    out = []
    for dev in (cuda, torch.device("cpu")):
        dy_dt = markov_tapes.get_dy_dt(tag="ex3var2-copolymerization",
                                       size_a=4, cl_k=4, device=dev)
        plain = [f.calls for f in dop853.PLAIN]
        out.append(solve(markov_tapes._device_rhs(dy_dt), y0, ts, rtol=1e-9,
                         atol=1e-9, method=method, return_info=True,
                         device=dev))
        if dev.type == "cuda":
            assert [f.calls for f in dop853.PLAIN] == plain
    (got, info), (want, want_info) = out
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert info["num_accepted"] == want_info["num_accepted"]
    assert info["num_rejected"] == want_info["num_rejected"]


def test_exact_canary_on_card(cuda):
    assert markov_tapes._run_validation(device=cuda) == [
        0.375, 0.125, 0.125, -0.125, 0.125, -0.125, -0.125, -0.375]


def test_exact_solve_on_card_matches_cpu(cuda):
    """ex4 cl_k 3: the solve through K3-K6 walks the CPU's plain solve's
    steps; no plain version runs on the card."""
    y0 = chemical_turing_p0(3, powered_fraction=0.04).ravel()
    ts = np.linspace(0.0, 50.0, 6)
    out = []
    for dev in (cuda, torch.device("cpu")):
        dy_dt = markov_tapes.get_dy_dt(tag="ex4-chemical-turing", size_a=9,
                                       cl_k=3, device=dev)
        plain = [f.calls for f in dop853.PLAIN]
        out.append(solve(markov_tapes._device_rhs(dy_dt), y0, ts, rtol=1e-10,
                         atol=1e-12, return_info=True, device=dev))
        if dev.type == "cuda":
            assert [f.calls for f in dop853.PLAIN] == plain
    (got, info), (want, want_info) = out
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert info["num_accepted"] == want_info["num_accepted"]
    assert info["num_rejected"] == want_info["num_rejected"]


# --- K7, K8 and the dual K3/K5 ------------------------------------------------


def _gather_input(cuda, compiled, seed):
    """A concentrated SPD with exact zeros and p[0] = -1e-13 (the noise
    guard), and the levels below it by K3's plain version."""
    rng = np.random.RandomState(seed)
    p = _spd(rng, compiled.state_size, concentrated=True)
    p[rng.rand(p.size) < 0.2] = 0.0
    p = p / p.sum()
    p[0] = -1e-13
    p = torch.as_tensor(p, device=cuda)
    return p, tdense.pyramids(compiled, p, plain=True)


def _compile(tag, cl_k, dual):
    return (tcompile.compile_problem_dual(tag, cl_k) if dual
            else tcompile.compile_problem(tag, cl_k))


def _gather_tables(compiled, cuda, wide):
    """The tree's and the chains' tables on the card, with their
    wrappers."""
    return ((trhs.device_tables(compiled, cuda, wide=wide), trhs.tree_rhs),
            (trhs.chain_tables(compiled, cuda, wide=wide), trhs.chain_rhs))


@pytest.mark.parametrize("wide", [False, True], ids=["16-bit", "32-bit"])
@pytest.mark.parametrize("tag,cl_k,dual", [(t, k, False) for t, k in
                                           EXACT_CASES]
                         + [("ex4-chemical-turing", 4, False),
                            ("ex3-copolymerization", 4, True),
                            ("ex4-chemical-turing", 3, True)])
def test_gather_kernels_match_plain(cuda, tag, cl_k, dual, wide):
    """K7 and K8 against their plain versions on the card on the same
    pyramid, with 16-bit and 32-bit ids: the same products and every
    sum in the same order, so the same bits; two runs the same bits; 2
    launches an RHS each and no plain version called."""
    compiled = _compile(tag, cl_k, dual)
    p, low = _gather_input(cuda, compiled, 6)
    for t, kern in _gather_tables(compiled, cuda, wide):
        assert all(lv.wide == wide for lv in t.levels)
        before = kern.launches
        plain = (trhs.scatter_plain.calls, trhs.tree_values_plain.calls,
                 trhs.chain_values_plain.calls)
        got = kern(t, p, low)
        assert kern.launches == before + t.launches == before + 2
        assert plain == (trhs.scatter_plain.calls,
                         trhs.tree_values_plain.calls,
                         trhs.chain_values_plain.calls)
        assert torch.equal(got, trhs.gather_plain(t, p))
        assert torch.equal(got, kern(t, p, low))
        assert bool(got.any())


@pytest.mark.parametrize("tag,cl_k,dual", [(t, k, False) for t, k in
                                           EXACT_CASES]
                         + [("ex4-chemical-turing", 3, True)])
def test_gather_rhs_matches_dense_on_card(cuda, tag, cl_k, dual):
    """The tree and chain engines' dp/dt on the card, with 16-bit and
    32-bit ids (the same bits), against the dense RHS's, on a random and
    a concentrated SPD; each writes into ``out``."""
    compiled = _compile(tag, cl_k, dual)
    prog = (tdense.compile_dense_dual(tag, cl_k) if dual
            else tdense.compile_dense(tag, cl_k))
    dense_fn = tdense.make_dense_dy_dt(prog, device=cuda)
    rng = np.random.RandomState(8)
    n = compiled.state_size
    for make, rhs in ((trhs.device_tables, trhs.dy_dt_from_tables),
                      (trhs.chain_tables, trhs.dy_dt_from_chain_tables)):
        fns = [trhs._closure(compiled, make(compiled, cuda, wide=wide), rhs)
               for wide in (False, True)]
        for concentrated in (False, True):
            p = torch.as_tensor(_spd(rng, n, concentrated), device=cuda)
            got = fns[0](p)
            _close(got, dense_fn(p))
            assert torch.equal(got, fns[1](p))
        for fn in fns:
            rows = torch.full((2, n), 7.0, dtype=torch.float64, device=cuda)
            assert fn(p, rows[1]).data_ptr() == rows[1].data_ptr()
            assert torch.equal(rows[1], fn(p))
            assert bool((rows[0] == 7.0).all())


def _kernel_launches(fn):
    """The CUDA kernels the profiler sees ``fn`` launch, by name. A first
    profile, over one small launch, starts the profiler's tracing: the
    first profile a process takes can miss the kernels in it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and any(k in e.name for k in ("k7_", "k8_", "gather_scatter"))]


@pytest.mark.parametrize("wide", [False, True], ids=["16-bit", "32-bit"])
@pytest.mark.parametrize("tag,cl_k,dual", [("ex4-chemical-turing", 4, False),
                                           ("ex6-mini-bff-lite", 2, False),
                                           ("ex3-copolymerization", 4, True)])
def test_gather_rhs_launches_as_planned(cuda, tag, cl_k, dual, wide):
    """`tree_rhs` and `chain_rhs` launch exactly `GatherTables.launches`
    kernels an RHS, by the profiler's count of the card's kernels (the
    values kernel, then the scatter) as by the wrappers' counts."""
    compiled = _compile(tag, cl_k, dual)
    p, low = _gather_input(cuda, compiled, 2)
    for t, kern in _gather_tables(compiled, cuda, wide):
        kern(t, p, low)  # built and loaded before the count
        before = kern.launches
        names = _kernel_launches(lambda: kern(t, p, low))
        assert kern.launches - before == t.launches == len(names) == 2
        assert "gather_scatter" in names[-1]
        assert ("k7_" if t.kind == "tree" else "k8_") in names[0]


@pytest.mark.parametrize("tag", ["ex1-radioactive-decay",
                                 "ex2-ferromagnetic-chain",
                                 "ex3-copolymerization",
                                 "ex4-chemical-turing", "ex5-msrtf-machine"])
def test_dual_dense_rhs_on_card(cuda, tag):
    """A dual program's RHS on the card: K3 once a tape (its launches
    counted), K5's items on their tapes; against the plain version on
    the card and the tree dual engine; at p_prog = p_data the halves sum
    to the shared RHS; K5's phase-0 weights equal K4's plain version."""
    prog = tdense.compile_dense_dual(tag, 3)
    fn = tdense.make_dense_dy_dt(prog, device=cuda)
    tree = trhs.make_dual_dy_dt(tcompile.compile_problem_dual(tag, 3),
                                device=cuda)
    shared = tdense.make_dense_dy_dt(tdense.compile_dense(tag, 3),
                                     device=cuda)
    n = prog.size_a**3
    rng = np.random.RandomState(9)
    y = torch.as_tensor(np.concatenate([_spd(rng, n, True), _spd(rng, n)]),
                        device=cuda)
    before = tdense.pyramid.launches, tdense.sweep.launches
    got = fn(y)
    assert (tdense.pyramid.launches - before[0],
            tdense.sweep.launches - before[1]) == (
        tdense.rhs_pyramid_launches(fn.device_program), 1)
    _close(got, tdense.dy_dt_dense(fn.device_program, y))
    _close(got, torch.cat(tree(y[:n], y[n:])))
    assert torch.equal(got, fn(y))
    eq = fn(torch.cat([y[:n], y[:n]]))
    _close(eq[:n] + eq[n:], shared(y[:n]))
    dp = fn.device_program
    low = tdense.pyramids(prog, y)
    assert torch.equal(low, tdense.pyramids(prog, y, plain=True))
    s = torch.full((prog.num_signatures,), float("nan"),
                   dtype=torch.float64, device=cuda)
    tdense.sweep(dp, y, low, s=s)
    assert torch.equal(s, tdense.signature_weights_plain(dp, y, low))


@pytest.mark.parametrize("wide", [False, True], ids=["16-bit", "32-bit"])
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_gather_kernels_reject_bad_inputs(cuda, wide, dual):
    compiled = _compile("ex4-chemical-turing", 3, dual)
    t = trhs.device_tables(compiled, cuda, wide=wide)
    c = trhs.chain_tables(compiled, cuda, wide=wide)
    p, low = _gather_input(cuda, compiled, 1)
    with pytest.raises(TypeError, match="float64"):
        trhs.tree_rhs(t, p.float(), low)
    with pytest.raises(TypeError):
        trhs.tree_rhs(t, p, low[:-1])
    with pytest.raises(ValueError):
        trhs.tree_rhs(t, p, low.cpu())
    with pytest.raises(TypeError, match="out must be"):
        trhs.chain_rhs(c, p, low, torch.empty(3, dtype=torch.float64,
                                              device=cuda))
    with pytest.raises(ValueError, match="tree"):
        trhs.tree_rhs(c, p, low)
    with pytest.raises(ValueError, match="chain"):
        trhs.chain_rhs(t, p, low)
    ev = torch.zeros(t.num_values, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="event values"):
        trhs.scatter(t, ev[:-1])
    with pytest.raises(TypeError, match="event values"):
        trhs.scatter(t, ev.float())


# --- K10-K13: the rolled lattice rounds, pattern scans, weighted counts ----------


def _rolled_draws(rng, tag, size_a, B, L, E, n, per_member):
    p_sym, d_sym = _ACTIVE_SYMBOLS.get(tag, (range(size_a),) * 2)
    pt = rng.choice(np.asarray(p_sym), (B, L)).astype(np.int32)
    dt = rng.choice(np.asarray(d_sym), (B, L)).astype(np.int32)
    pt[0, ::7] = size_a + 2  # out-of-range symbols in two rows
    dt[1, ::5] = -3
    shape = (n, B) if per_member else (n,)
    shifts = rng.randint(-L, 2 * L, shape).astype(np.int32)
    u = rng.rand(n, B, E)
    pick = rng.randint(0, 3, (n, B, E))
    u = np.where(pick == 0, u * 1e-3, np.where(pick == 1, 0.95 + 0.05 * u, u))
    return pt, dt, shifts, u


@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "own"])
@pytest.mark.parametrize("tag,f32", [("ex5-msrtf-machine", False),
                                     ("ex4-chemical-turing", False),
                                     ("ex3-copolymerization", True)])
def test_table_round_kernel_matches_plain(cuda, tag, f32, per_member):
    """K10 and its plain version, both on the card, give identical tapes
    after every round, at shared and per-member shifts, on float64 and
    float32 tables, with symbols outside [0, size_a): one-round calls (a
    launch a round), then all the rounds in one call (`run_lattice_rounds`:
    one resident launch)."""
    dt_ = tens.device_table(tens.compile_transition_table(tag),
                            dtype=torch.float32 if f32 else None,
                            device=cuda)
    rng = np.random.RandomState(3)
    B, L, E, n = 300, 512, 16, 12
    pt, dt, shifts, u = _rolled_draws(rng, tag, dt_.size_a, B, L, E, n,
                                      per_member)
    u_t = torch.as_tensor(u, dtype=dt_.out_cum.dtype, device=cuda)
    s_t = torch.as_tensor(shifts, device=cuda)
    kp, kd = (torch.as_tensor(x, device=cuda) for x in (pt, dt))
    pp, pd = kp.clone(), kd.clone()
    launches = tens.table_round.launches
    for k in range(n):
        tens.table_round(dt_, kp, kd, s_t[k], u_t[k])
        tens.table_round_plain(dt_, pp, pd, s_t[k], u_t[k])
        torch.cuda.synchronize()
        assert torch.equal(kp, pp) and torch.equal(kd, pd), k
    assert tens.table_round.launches == launches + n
    assert int((kd.cpu().numpy() != dt).sum() + (kp.cpu().numpy()
                                                  != pt).sum()) > 0
    rp, rd = (torch.as_tensor(x, device=cuda) for x in (pt, dt))
    launches = tens.table_round.launches
    tens.run_lattice_rounds(dt_, rp, rd, s_t, E, u_t)
    assert tens.k10_tile(B, L, E) is not None
    assert tens.table_round.launches == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(rp, pp) and torch.equal(rd, pd)


@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "own"])
@pytest.mark.parametrize("tag,B,L,E,n", [
    ("ex5-msrtf-machine", 16384, 4096, 256, 6),
    ("ex4-chemical-turing", 16384, 4096, 256, 5),
    ("ex2-ferromagnetic-chain", 512, 10, 1, 12),
    ("ex1-radioactive-decay", 4096, 1024, 64, 5),
    ("ex5-msrtf-machine", 8, 32_768, 16, 4)])
def test_table_resident_matches_plain_at_widths(cuda, tag, B, L, E, n,
                                                per_member):
    """K10's resident rounds (`run_lattice_rounds`: one launch for every
    round of the call) at phase 9 (a)'s full width (ex5's table, one
    outcome a row, so no uniform is read; ex4's, three a row, whose
    uniforms decide), at d:323's 512 members of L = 10, E = 1, on ex1's
    two-cell windows (the cell count at run time: the other tables'
    windows take the unrolled forms), and at rows too long to keep
    resident (`ensemble.k10_tile` None: one launch a round) equal n
    plain rounds bit for bit, float64 uniforms."""
    dt_ = tens.device_table(tens.compile_transition_table(tag), device=cuda)
    rng = np.random.RandomState(B % 977 + E)
    pt, dt, shifts, u = _rolled_draws(rng, tag, dt_.size_a, B, L, E, n,
                                      per_member)
    u_t = torch.as_tensor(u, dtype=torch.float64, device=cuda)
    s_t = torch.as_tensor(shifts, device=cuda)
    start = [torch.as_tensor(x, device=cuda) for x in (pt, dt)]
    kp, kd = (x.clone() for x in start)
    launches = tens.table_round.launches
    tens.run_lattice_rounds(dt_, kp, kd, s_t, E, u_t)
    resident = tens.k10_tile(B, L, E) is not None
    assert resident == (L < 28_000)
    assert tens.table_round.launches == launches + (1 if resident else n)
    pp, pd = (x.clone() for x in start)
    for k in range(n):
        tens.table_round_plain(dt_, pp, pd, s_t[k], u_t[k])
    torch.cuda.synchronize()
    assert torch.equal(kp, pp) and torch.equal(kd, pd)
    assert not (torch.equal(kp, start[0]) and torch.equal(kd, start[1]))


@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "own"])
@pytest.mark.parametrize("tag,L,E", [("ex5-msrtf-machine", 512, 32),
                                     ("ex4-chemical-turing", 1024, 8),
                                     ("ex2-ferromagnetic-chain", 500, 5)])
def test_lattice_round_kernel_matches_plain(cuda, tag, L, E, per_member):
    """K11 and its plain version, both on the card, give identical int8
    tapes after every round, at shared and per-member shifts, at strides
    16 and above 64, with symbols outside [0, size_a); and all rounds
    from one call (`run_lattice_rounds`) give the same tapes again."""
    dm = tens.compile_decision_machine(tag)
    rng = np.random.RandomState(4)
    B, n = 257, 10
    pt, dt, shifts, u = _rolled_draws(rng, tag, dm.size_a, B, L, E, n,
                                      per_member)
    u_t = torch.as_tensor(u, dtype=torch.float32, device=cuda)
    s_t = torch.as_tensor(shifts, device=cuda)
    start = [torch.as_tensor(x, device=cuda).to(torch.int8) for x in (pt, dt)]
    kp, kd = (x.clone() for x in start)
    pp, pd = (x.clone() for x in start)
    launches = tens.lattice_round.launches
    for k in range(n):
        uk = u_t[k] if dm.has_choose else None
        tens.lattice_round(dm, kp, kd, s_t[k], E, uk)
        tens.lattice_round_plain(dm, pp, pd, s_t[k], E, uk)
        torch.cuda.synchronize()
        assert torch.equal(kp, pp) and torch.equal(kd, pd), k
    assert tens.lattice_round.launches == launches + n
    cp, cd = (x.clone() for x in start)
    tens.run_lattice_rounds(dm, cp, cd, s_t, E, u_t)
    assert torch.equal(cp, kp) and torch.equal(cd, kd)
    # One resident launch runs all n rounds of a call.
    assert tens.lattice_round.launches == launches + n + 1


def _plain_rounds(dm, start, s_t, E, u_t):
    pp, pd = (x.clone() for x in start)
    for k in range(s_t.shape[0]):
        tens.lattice_round_plain(dm, pp, pd, s_t[k], E,
                                 u_t[k] if dm.has_choose else None)
    return pp, pd


@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "own"])
@pytest.mark.parametrize("tag,B,L,E,n", [
    ("ex5-msrtf-machine", 16384, 4096, 256, 12),
    ("ex4-chemical-turing", 16384, 4096, 32, 12),
    ("ex5-msrtf-machine", 8, 131_072, 16, 3),
    ("ex4-chemical-turing", 4, 120_000, 8, 3)])
def test_resident_rounds_match_plain(cuda, tag, B, L, E, n, per_member):
    """K11's resident rounds (`run_lattice_rounds`: one launch for every
    round of the call) at the full width (B=16384, L=4096, E=256 and E=32
    on ex4, whose uniforms decide), and rows too long to keep resident
    (2L past 227 KB: one launch a round, `ensemble.k11_tile` None), equal
    the plain rounds bit for bit."""
    dm = tens.compile_decision_machine(tag)
    rng = np.random.RandomState(11)
    pt, dt, shifts, u = _rolled_draws(rng, tag, dm.size_a, B, L, E, n,
                                      per_member)
    u_t = torch.as_tensor(u, dtype=torch.float32, device=cuda)
    s_t = torch.as_tensor(shifts, device=cuda)
    start = [torch.as_tensor(x, device=cuda).to(torch.int8) for x in (pt, dt)]
    kp, kd = (x.clone() for x in start)
    launches = tens.lattice_round.launches
    tens.run_lattice_rounds(dm, kp, kd, s_t, E, u_t)
    resident = tens.k11_tile(B, L, E) is not None
    assert resident == (L < 116_000)
    assert tens.lattice_round.launches == launches + (1 if resident else n)
    pp, pd = _plain_rounds(dm, start, s_t, E, u_t)
    torch.cuda.synchronize()
    assert torch.equal(kp, pp) and torch.equal(kd, pd)
    assert not (torch.equal(kp, start[0]) and torch.equal(kd, start[1]))


def _first_passage_plain(dm, tapes, pattern, shifts, E, u, data_tape):
    pt, dt = (t.to(torch.int8).clone() for t in tapes)
    pat = torch.tensor(pattern, dtype=torch.int32, device=pt.device)
    times = torch.arange(shifts.shape[0] + 1, dtype=torch.float64,
                         device=pt.device) * -math.log1p(-E / pt.shape[1])
    t_hit = torch.full((pt.shape[0],), math.inf, dtype=torch.float64,
                       device=pt.device)
    watch = dt if data_tape else pt
    tens.pattern_scan_plain(watch, pat, 2, t_hit=t_hit, t_now=times[:1])
    for k in range(shifts.shape[0]):
        tens.lattice_round_plain(dm, pt, dt, shifts[k], E,
                                 u[k] if dm.has_choose else None)
        tens.pattern_scan_plain(watch, pat, 2, t_hit=t_hit,
                                t_now=times[k + 1:k + 2])
    return t_hit, pt.to(torch.int32), dt.to(torch.int32)


@pytest.mark.parametrize("tag,pattern,data_tape,B,L,n,per_call", [
    ("ex2-ferromagnetic-chain", (1, 1, 1, 1), True, 4096, 128, 400, 150),
    ("ex4-chemical-turing", (7,), False, 4096, 128, 300, 128),
    ("ex2-ferromagnetic-chain", (1, 1, 1), True, 512, 4096, 40, None),
    ("ex2-ferromagnetic-chain", (1, 1, 1), True, 4, 131_072, 6, None)])
def test_fused_first_passage_matches_plain(cuda, tag, pattern, data_tape, B,
                                           L, n, per_call):
    """The fused first passage (K12's update inside K11's resident
    rounds: one K11 launch a C call, K12 at t = 0 only) equals the plain
    round-and-scan loop at the examples' geometry (B=4096, L=128, E=4),
    at L=4096, and at rows too long to keep resident (a K11 and a K12
    launch a round): hit times, hits and both tapes bit for bit."""
    dm = tens.compile_decision_machine(tag)
    rng = np.random.RandomState(12)
    E = 4
    if tag == "ex4-chemical-turing":
        pt = rng.choice([5, 6], (B, L)).astype(np.int32)
        dt = rng.choice([0, 4, 5], (B, L)).astype(np.int32)
    else:
        pt = np.zeros((B, L), np.int32)
        dt = (rng.rand(B, L) < 0.25).astype(np.int32)
    tapes = [torch.as_tensor(x, device=cuda) for x in (pt, dt)]
    shifts = torch.as_tensor(rng.randint(0, L, n).astype(np.int32),
                             device=cuda)
    u = torch.as_tensor(rng.rand(n, B, E).astype(np.float32), device=cuda)
    tens.lattice_round.launches = tens.pattern_scan.launches = 0
    t_k, h_k, (p_k, d_k) = tens.first_passage_from_draws(
        dm, tapes, pattern, shifts, E, u, data_tape=data_tape,
        rounds_per_call=per_call)
    calls = -(-n // (per_call or n))
    resident = tens.k11_tile(B, L, E, len(pattern)) is not None
    assert tens.lattice_round.launches == (calls if resident else n)
    assert tens.pattern_scan.launches == (1 if resident else n + 1)
    t_p, p_p, d_p = _first_passage_plain(dm, tapes, pattern, shifts, E, u,
                                         data_tape)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_p) and torch.equal(h_k, torch.isfinite(t_p))
    assert torch.equal(p_k, p_p) and torch.equal(d_k, d_p)
    assert int(h_k.sum()) > 0


@pytest.mark.parametrize("dtype,B,L", [
    (torch.int8, 16384, 4096), (torch.int32, 16384, 4096),
    (torch.int8, 77, 13), (torch.int32, 33, 45),
    (torch.int8, 3, 240_000), (torch.int32, 3, 60_000)])
def test_pattern_scan_staged_shapes(cuda, dtype, B, L):
    """K12 (a warp a member on staged rows; a block a member where a row
    cannot be staged, `ensemble.k12_members` 0) equals its plain version
    in modes 0-2 at the full width, at rows whose bytes are not a
    multiple of 16, and at rows too long to stage."""
    rng = np.random.RandomState(13)
    tape = torch.as_tensor(rng.randint(0, 3, (B, L)), dtype=dtype,
                           device=cuda)
    tape[0, -2:] = 1
    tape[0, 0] = 1
    for pattern in [(1, 1, 1), (2, 0, 1, 1), (1,) * 40, ()]:
        pat = torch.as_tensor(pattern, dtype=torch.int32, device=cuda)
        for mode in (0, 1):
            got = tens.pattern_scan(tape, pat, mode)
            want = tens.pattern_scan_plain(tape, pat, mode)
            assert torch.equal(got, want), (pattern, mode)
        t0 = torch.where(torch.as_tensor(rng.rand(B) < 0.5, device=cuda),
                         torch.inf, 1.5).to(torch.float64)
        now = torch.tensor([2.5], dtype=torch.float64, device=cuda)
        got = tens.pattern_scan(tape, pat, 2, t_hit=t0.clone(), t_now=now)
        want = tens.pattern_scan_plain(tape, pat, 2, t_hit=t0.clone(),
                                       t_now=now)
        assert torch.equal(got, want), pattern


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_pattern_scan_kernel_matches_plain(cuda, dtype):
    """K12 equals its plain version in every mode, patterns across the
    seam and longer than the ring included."""
    rng = np.random.RandomState(5)
    B, L = 1000, 300
    tape = torch.as_tensor(rng.randint(0, 3, (B, L)), dtype=dtype,
                           device=cuda)
    tape[1, -2:] = 1
    tape[1, 0] = 1
    for pattern in [(1, 1, 1), (0, 1, 2), (2,), (1, 0) * 9, (), (0,) * 400]:
        pat = torch.as_tensor(pattern, dtype=torch.int32, device=cuda)
        for mode in (0, 1):
            got = tens.pattern_scan(tape, pat, mode)
            want = tens.pattern_scan_plain(tape, pat, mode)
            assert torch.equal(got, want), (pattern, mode)
        t0 = torch.where(torch.as_tensor(rng.rand(B) < 0.5, device=cuda),
                         torch.inf, 1.5).to(torch.float64)
        now = torch.tensor([2.5], dtype=torch.float64, device=cuda)
        got = tens.pattern_scan(tape, pat, 2, t_hit=t0.clone(), t_now=now)
        want = tens.pattern_scan_plain(tape, pat, 2, t_hit=t0.clone(),
                                       t_now=now)
        assert torch.equal(got, want), pattern


@pytest.mark.parametrize("tag,pattern,data_tape", [
    ("ex2-ferromagnetic-chain", (1, 1, 1, 1), True),
    ("ex4-chemical-turing", (7,), False)])
def test_first_passage_on_card_matches_cpu(cuda, tag, pattern, data_tape):
    """The same explicit draws give the same hit times and tapes on the
    card (K11 and K12 from one C call a chunk, here 70 rounds a call,
    the last one short) and on the CPU."""
    dm = tens.compile_decision_machine(tag)
    rng = np.random.RandomState(6)
    B, L, E, n = 128, 128, 4, 300
    pt, dt, shifts, u = _rolled_draws(rng, tag, dm.size_a, B, L, E, n,
                                      False)
    if tag == "ex2-ferromagnetic-chain":
        dt = (rng.rand(B, L) < 0.3).astype(np.int32)
    else:  # no X (the pattern) at the start: cursors A over bits, fuel P
        pt = rng.choice([5, 6], (B, L)).astype(np.int32)
        dt = rng.choice([0, 4, 5], (B, L)).astype(np.int32)
    u32 = u.astype(np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        out.append(tens.first_passage_from_draws(
            dm, (torch.as_tensor(pt, device=dev),
                 torch.as_tensor(dt, device=dev)), pattern,
            torch.as_tensor(shifts, device=dev), E,
            torch.as_tensor(u32, device=dev), data_tape=data_tape,
            rounds_per_call=70 if dev.type == "cuda" else None))
    (t_k, h_k, (p_k, d_k)), (t_p, h_p, (p_p, d_p)) = out
    assert torch.equal(t_k.cpu(), t_p) and torch.equal(h_k.cpu(), h_p)
    assert torch.equal(p_k.cpu(), p_p) and torch.equal(d_k.cpu(), d_p)
    assert int(h_p.sum()) > 0 and (t_p[h_p] > 0).any()


@pytest.mark.parametrize("size_a,cl_k,B,L", [(5, 3, 2000, 700),
                                             (9, 5, 300, 256),
                                             (2, 14, 100, 1000)])
def test_weighted_counts_kernel_matches_plain(cuda, size_a, cl_k, B, L):
    """K13 equals its plain version bit for bit, twice (shared-memory
    histograms, and device-memory ones above 16,384 bins), with symbols
    outside [0, size_a)."""
    rng = np.random.RandomState(size_a + cl_k)
    tape = torch.as_tensor(rng.randint(-1, size_a, (B, L)), dtype=torch.int32,
                           device=cuda)
    w = torch.as_tensor(rng.rand(B) + 0.01, device=cuda)
    launches = tens.weighted_window_counts.launches
    a = tens.weighted_window_counts(tape, w, size_a, cl_k, device=cuda)
    b = tens.weighted_window_counts(tape, w, size_a, cl_k, device=cuda)
    plain = tens.weighted_window_counts_plain(tape, w / w.sum(), size_a,
                                              cl_k)
    assert tens.weighted_window_counts.launches == launches + 2
    assert torch.equal(a, b) and torch.equal(a, plain)


# --- K14 and K15: the bit-sliced rounds ------------------------------------------

# (B, L, E, transpose): the straight layout, the 2-D transposed [E, W]
# and the reference's 3-D [E, S, P] view of it.
_BIT_LAYOUTS = [(128, 1024, 64, False), (4096, 64, 4, True),
                (32768, 32, 2, True)]


def _bit_words(cuda, rng, dm, circ, B, L, E, transpose):
    stride = L // E
    tapes = [torch.as_tensor(rng.randint(0, dm.size_a, (B, L)),
                             dtype=torch.int32, device=cuda)
             for _ in range(2)]
    return [tbs.tapes_to_bitplanes(t, stride, circ[2], transpose=transpose)
            for t in tapes], tapes


@pytest.mark.parametrize("B,L,E,transpose", _BIT_LAYOUTS,
                         ids=["straight", "2d", "3d"])
@pytest.mark.parametrize("tag", TAGS)
def test_bitslice_round_kernel_matches_plain(cuda, tag, B, L, E, transpose):
    """K14 and its plain version, both on the card, give identical words
    after every round, one round at every phase (random words drawn for
    the sampling circuits of ex4 and ex2)."""
    dm = tens.compile_decision_machine(tag)
    circ = tbs.machine_circuit(dm)
    rng = np.random.RandomState(len(tag) + B)
    (kp, kd), tapes = _bit_words(cuda, rng, dm, circ, B, L, E, transpose)
    pp, pd = kp.clone(), kd.clone()
    axis = tbs.site_axis_of(kp, transpose)
    stride = L // E
    shifts = torch.as_tensor(rng.permutation(stride), dtype=torch.int32,
                             device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    launches = tbs.bitslice_round.launches
    for k in range(stride):
        rw = (tbs.draw_rand_words(gen, (circ[3],) + tuple(kp.shape[2:]),
                                  cuda) if circ[3] else None)
        tbs.bitslice_round(dm, circ, kp, kd, shifts, k, rw, site_axis=axis)
        tbs.apply_round_bitsliced(dm, circ, pp, pd, shifts[k],
                                  site_axis=axis, rand_words=rw)
        torch.cuda.synchronize()
        assert torch.equal(kp, pp) and torch.equal(kd, pd), k
    assert tbs.bitslice_round.launches == launches + stride
    out = tbs.bitplanes_to_tapes(kd, transpose=transpose)
    assert int((out != tapes[1]).sum()) > 0


def _symbol_views(cuda, rng, B, L, stride, dtype):
    """The three layouts K15 reads, each as its [B, E, stride] view:
    [B, L] tapes, the FSM planes [stride, B, E] and the frontier's
    [stride, E, K] (K = B)."""
    E = L // stride
    tape = torch.as_tensor(rng.randint(0, 5, (B, L)), dtype=dtype,
                           device=cuda)
    planes = tens._tape_to_planes(tape.to(torch.int8), stride)
    frontier = planes.permute(0, 2, 1).contiguous()
    return {"tape": (tape, tape.view(B, E, stride)),
            "fsm planes": (planes, planes.permute(1, 2, 0)),
            "frontier": (frontier, frontier.permute(2, 1, 0))}


@pytest.mark.parametrize("B,L,stride", [(32, 64, 16), (4096, 256, 16),
                                        (1024, 32, 16)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int8])
@pytest.mark.parametrize("transpose", [False, True])
def test_bitplanes_kernel_matches_plain(cuda, B, L, stride, dtype,
                                        transpose):
    """K15's pack and unpack equal their plain versions bit for bit on
    the three layouts (int32 and int8 tapes, B = 32 too), and unpack
    restores the symbols."""
    rng = np.random.RandomState(B + L)
    launches = (tbs.pack_bitwords.launches, tbs.unpack_bitwords.launches)
    for name, (base, view) in _symbol_views(cuda, rng, B, L, stride,
                                            dtype).items():
        words = tbs.pack_bitwords(view, 3, transpose=transpose)
        plain = tbs.pack_bitwords_plain(view, 3, transpose=transpose)
        assert torch.equal(words, plain), name
        out = torch.full_like(base, -1)
        target = {"tape": lambda t: t.view(B, L // stride, stride),
                  "fsm planes": lambda t: t.permute(1, 2, 0),
                  "frontier": lambda t: t.permute(2, 1, 0)}[name]
        tbs.unpack_bitwords(words, target(out), transpose=transpose)
        back = torch.full_like(base, -1)
        tbs.unpack_bitwords_plain(words, target(back), transpose=transpose)
        assert torch.equal(out, back) and torch.equal(out, base), name
    assert tbs.pack_bitwords.launches == launches[0] + 3
    assert tbs.unpack_bitwords.launches == launches[1] + 3


def test_bitsliced_run_on_card_matches_k1(cuda):
    """A choose-free machine's default run takes K14 and K15 (K1 never)
    and gives K1's tapes at the same seed; the random words of a
    sampling run set member lane 31 about half the time."""
    dm = tens.compile_decision_machine("ex5-msrtf-machine")
    rng = np.random.RandomState(8)
    B, L, E, n = 4096, 64, 4, 30
    tapes = [rng.randint(0, dm.size_a, (B, L)) for _ in range(2)]
    counts = (tbs.bitslice_round.launches, tens.plane_round.launches,
              tbs.apply_round_bitsliced.calls)
    (p1, d1), _ = tens.run_ensemble(3, tapes, dm, (n, E))
    assert tbs.bitslice_round.launches == counts[0] + n
    assert tens.plane_round.launches == counts[1]
    assert tbs.apply_round_bitsliced.calls == counts[2]
    (p2, d2), _ = tens.run_ensemble(3, tapes, dm, (n, E), bitslice=False)
    assert torch.equal(p1, p2) and torch.equal(d1, d2)
    words = tbs.draw_rand_words(torch.Generator(device=cuda).manual_seed(1),
                                (1 << 16,), cuda)
    lane31 = float((words < 0).double().mean())
    assert abs(lane31 - 0.5) < 0.01


def test_bitslice_kernels_reject_bad_launches(cuda):
    """A launch the card refuses raises (no fallback): K14 on words of no
    plane, K15 on symbols of a type it does not hold."""
    dm = tens.compile_decision_machine("ex5-msrtf-machine")
    circ = tbs.machine_circuit(dm)
    empty = torch.zeros((0, circ[2], 2, 8), dtype=torch.int32, device=cuda)
    launches = tbs.bitslice_round.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        tbs.bitslice_round(dm, circ, empty, empty.clone(),
                           torch.zeros(1, dtype=torch.int32, device=cuda),
                           0)
    assert tbs.bitslice_round.launches == launches
    with pytest.raises(TypeError, match="int8 or int32"):
        tbs.pack_bitwords(torch.zeros((32, 4, 4), dtype=torch.int64,
                                      device=cuda), 3)


# --- The BFF interpreter: K16, K17, K18 -------------------------------------------------

from chemical_kinetics_and_program_execution_torch.engine import (  # noqa: E402
    bff as tbff,
)
from chemical_kinetics_and_program_execution_torch.engine import (  # noqa: E402
    bff_bitslice as tbb,
)

_BFF_FAITHFUL, _BFF_SELF = "ex6-mini-bff", "ex6-mini-bff-self"


def _bff_tapes(dev, m, B, L, seed):
    """(ptape or None, dtape) int8 and a lineage ring on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pt = (None if m.self_modifying else
          torch.randint(0, m.size_a, (B, L), generator=g, device=dev,
                        dtype=torch.int8))
    dt = torch.randint(0, m.size_a, (B, L), generator=g, device=dev,
                       dtype=torch.int8)
    prov = torch.arange(B * L, dtype=torch.int32, device=dev).reshape(B, L)
    return pt, dt, prov, g


# B=512, L=256, E=4; and the master-equation gates' geometry (a ring of 4
# cells, one site a round, 8,192 members) for the lite machines.
_K16_CASES = [
    pytest.param(tag, mode, B, L, E, id=f"{tag}-{mode}{name}")
    for tags, (B, L, E), name in (((_BFF_FAITHFUL, _BFF_SELF,
                                    "ex6-mini-bff-self-lite"),
                                   (512, 256, 4), ""),
                                  (("ex6-mini-bff-lite",
                                    "ex6-mini-bff-self-lite"),
                                   (8192, 4, 1), "-L4E1"))
    for tag in tags
    for mode in ("shared", "per-member")
    + (("lineage", "mutation") if "self" in tag else ())]


@pytest.mark.parametrize("tag,mode,B,L,E", _K16_CASES)
def test_bff_round_kernel_matches_plain(cuda, tag, mode, B, L, E):
    """K16 (and K18 after it in the mutation mode) and their plain
    versions, both on the card, give identical tapes, lineage and opcode
    totals after each of 4 rounds: shared shifts past L and negative,
    per-member shifts, the lineage ring, mutation at rate 0.2."""
    m = tbff.compile_bff(tag)
    pt, dt, prov, g = _bff_tapes(cuda, m, B, L, len(tag))
    lineage = mode in ("lineage", "mutation")
    n = 4
    if mode == "per-member":
        shifts = torch.randint(-3 * L, 3 * L, (n, B), generator=g,
                               device=cuda, dtype=torch.int32)
    else:
        shifts = torch.tensor([0, L - 1, 5 * L + 3, -7], dtype=torch.int32,
                              device=cuda)
    kp = None if pt is None else pt.clone()
    kd, kv = dt.clone(), prov.clone() if lineage else None
    pp = None if pt is None else pt.clone()
    pd, pv = dt.clone(), prov.clone() if lineage else None
    launches = (tbff.bff_round.launches, tbff.bff_mutate.launches)
    for k in range(n):
        got = tbff.bff_round(m, kp, kd, shifts[k], E, prov=kv)
        want = tbff.bff_round_plain(m, pp, pd, pv, shifts[k], E)
        if mode == "mutation":
            u = torch.rand((B, L), generator=g, device=cuda,
                           dtype=torch.float64)
            vals = torch.randint(0, m.size_a, (B, L), generator=g,
                                 device=cuda, dtype=torch.int32)
            tbff.bff_mutate(kd, kv, u, vals, 0.2)
            tbff.bff_mutate_plain(pd, pv, u, vals, 0.2)
        torch.cuda.synchronize()
        assert torch.equal(got, want), k
        assert torch.equal(kd, pd), k
        if kv is not None:
            assert torch.equal(kv, pv), k
        if kp is not None:
            assert torch.equal(kp, pp), k
    assert tbff.bff_round.launches == launches[0] + n
    assert tbff.bff_mutate.launches == launches[1] + (
        n if mode == "mutation" else 0)
    assert int((kd != dt).sum()) > 0


def test_bff_rounds_in_one_call_match_plain(cuda):
    """run_bff_rounds on the card (K16 and K18 from one C call a chunk)
    equals the same rounds on the CPU's plain versions, per-member
    shifts, lineage and mutation at the same draws."""
    m = tbff.compile_bff(_BFF_SELF)
    B, L, E, n = 256, 256, 4, 6
    rng = np.random.RandomState(4)
    tape = rng.randint(0, m.size_a, (B, L)).astype(np.int32)
    prov = np.arange(B * L, dtype=np.int32).reshape(B, L)
    shifts = rng.randint(0, L, (n, B)).astype(np.int32)
    draws = (rng.rand(n, B, L), rng.randint(0, m.size_a, (n, B, L)).astype(
        np.int32))
    out = []
    for dev in (cuda, torch.device("cpu")):
        (t, p), tot = tbff.run_bff_rounds(
            m, tape, shifts, E, mutation_draws=draws, mutation_rate=0.05,
            prov=prov, device=dev)
        out.append((t.cpu(), p.cpu(), tot.cpu()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


_K17_CASES = [
    pytest.param(tag, B, L, E, id=f"{tag}-{name}")
    for tag in (_BFF_FAITHFUL, _BFF_SELF, "ex6-mini-bff-midi",
                "ex6-mini-bff-self-lite")
    for name, (B, L, E) in (("straight", (1024, 512, 8)),
                            ("transposed", (8192, 256, 4)))] + [
    pytest.param(tag, 8192, 4, 1, id=f"{tag}-L4E1")
    for tag in ("ex6-mini-bff-lite", "ex6-mini-bff-self-lite")]


@pytest.mark.parametrize("tag,B,L,E", _K17_CASES)
def test_bff_bitslice_kernel_matches_plain(cuda, tag, B, L, E):
    """K17 and its plain version, both on the card, give identical words
    and opcode totals after each round, at phases over the whole tape
    (every cell spills somewhere, the offset-0 cell too), in both
    layouts and on a ring of 4 cells with one site."""
    m = tbff.compile_bff(tag)
    circ = tbb.compile_bff_circuit(m)
    pt, dt, _, g = _bff_tapes(cuda, m, B, L, B + len(tag))
    stride = L // E
    transpose = E < B // 32
    words = [None if t is None else
             tbs.tapes_to_bitplanes(t, stride, circ[2], transpose=transpose)
             for t in (pt, dt)]
    axis = tbs.site_axis_of(words[1], transpose)
    shifts = torch.tensor([0, 3, stride, stride + 7, L - 1],
                          dtype=torch.int32, device=cuda)
    kd, pd = words[1].clone(), words[1].clone()
    launches = tbb.bff_bitslice_round.launches
    for k in range(len(shifts)):
        got = tbb.bff_bitslice_round(m, circ, words[0], kd, shifts, k,
                                     site_axis=axis)
        want = tbb.apply_bff_round_bitsliced(m, circ, words[0], pd,
                                             int(shifts[k]),
                                             stride=pd.shape[0],
                                             site_axis=axis)
        torch.cuda.synchronize()
        assert torch.equal(kd, pd), k
        assert torch.equal(got, want), k
        assert int(got.sum()) == B * E * m.fuel
    assert tbb.bff_bitslice_round.launches == launches + len(shifts)


def test_bff_default_route_on_card_matches_scan(cuda):
    """run_ensemble_bff on the card takes K17 with K15 (the faithful
    circuit: auto has no size limit there) and gives the scan's (K16)
    tapes and totals at the same seed; neither calls a plain version."""
    m = tbff.compile_bff(_BFF_FAITHFUL)
    B, L, E, n = 2048, 512, 8, 12
    rng = np.random.RandomState(2)
    tapes = [rng.randint(0, m.size_a, (B, L)) for _ in range(2)]
    counts = (tbb.bff_bitslice_round.launches, tbff.bff_round.launches,
              tbb.apply_bff_round_bitsliced.calls,
              tbff.bff_round_plain.calls)
    (p1, d1), (ops1, t1) = tbff.run_ensemble_bff(9, tapes, m, (n, E))
    assert tbb.bff_bitslice_round.launches == counts[0] + n
    assert tbff.bff_round.launches == counts[1]
    (p2, d2), (ops2, t2) = tbff.run_ensemble_bff(9, tapes, m, (n, E),
                                                 engine="scan")
    assert tbff.bff_round.launches == counts[1] + n
    assert tbb.apply_bff_round_bitsliced.calls == counts[2]
    assert tbff.bff_round_plain.calls == counts[3]
    assert torch.equal(p1, p2) and torch.equal(d1, d2)
    assert torch.equal(ops1, ops2) and torch.equal(t1, t2)
    assert int(ops1.sum()) == n * B * E * m.fuel


def test_bff_kernels_reject_bad_launches(cuda):
    """A launch the card refuses raises (no fallback): K17 on words of no
    plane; K16's wrapper on a machine its counters cannot hold."""
    m = tbff.compile_bff("ex6-mini-bff-self-lite")
    circ = tbb.compile_bff_circuit(m)
    empty = torch.zeros((0, circ[2], 2, 8), dtype=torch.int32, device=cuda)
    launches = tbb.bff_bitslice_round.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        tbb.bff_bitslice_round(m, circ, None, empty,
                               torch.zeros(1, dtype=torch.int32,
                                           device=cuda), 0)
    assert tbb.bff_bitslice_round.launches == launches
    import dataclasses

    deep = dataclasses.replace(m, fuel=16)
    t = torch.zeros((4, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="4 bits"):
        tbff.bff_round(deep, None, t, 0, 4)


# --- The weighted frontier (K19-K22, K11's tempered rounds) --------------------

def _frontier_tapes(rng, K, L, hi, device):
    return [torch.as_tensor(rng.randint(0, hi, (K, L)), dtype=torch.int8,
                            device=device) for _ in range(2)]


@pytest.mark.parametrize("L,stride", [(64, 16), (64, 1), (30, 5)])
@pytest.mark.parametrize("bits,flagged", [(4, False), (4, True), (8, False)])
def test_content_hash_kernel_matches_plain(cuda, L, stride, bits, flagged):
    rng = np.random.RandomState(L + bits)
    K = 5003
    pt, dt = _frontier_tapes(rng, K, L, 16, cuda)
    dt[7] = dt[3]
    pt[7] = pt[3]
    flag = (torch.as_tensor(rng.rand(K) < 0.5, device=cuda)
            if flagged else None)
    n = tfr.content_hash.launches
    got = tfr.content_hash(pt, dt, stride=stride, bits=bits, flag=flag)
    assert tfr.content_hash.launches == n + 1
    want = tfr.content_hash_plain(pt, dt, stride, bits, flag)
    cpu = tfr.content_hash_plain(pt.cpu(), dt.cpu(), stride, bits,
                                 None if flag is None else flag.cpu())
    assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("K", [1, 2, 33, 4096, 100003])
def test_merge_resample_kernel_matches_plain(cuda, mode, K):
    """K20 equals its plain version on the card bit for bit: parents (or
    grp), new_lw and n_groups, with heavy duplication, hashes with the
    top bit set and absorbed (-inf) members."""
    rng = np.random.RandomState(K + mode)
    pool = rng.randint(-2**63, 2**63 - 1, size=max(1, K // 7),
                       dtype=np.int64)
    h = torch.as_tensor(pool[rng.randint(0, len(pool), K)], device=cuda)
    lw = torch.as_tensor(rng.normal(size=K) * 3.0, device=cuda)
    lw[:K // 50] = -math.inf
    u = torch.tensor(rng.rand(), dtype=torch.float64, device=cuda)
    n = tfr.merge_resample.launches
    got = tfr.merge_resample(h, lw, u, mode)
    assert tfr.merge_resample.launches == n + 1
    hs, perm = tfr.sort_hashes(h)
    want = tfr.merge_resample_plain(hs, perm, lw, u, mode, math.log(K))
    for a, b in zip(got, want):
        assert torch.equal(a, b.to(a.dtype)), mode


@pytest.mark.parametrize("L", [64, 30])
@pytest.mark.parametrize("flagged", [False, True])
def test_gather_pair_kernel_matches_plain(cuda, L, flagged):
    rng = np.random.RandomState(L)
    K = 20011
    pt = torch.as_tensor(rng.randint(-128, 128, (K, L)), dtype=torch.int8,
                         device=cuda)
    dt = torch.as_tensor(rng.randint(0, 16, (K, L)), dtype=torch.int8,
                         device=cuda)
    flag = (torch.as_tensor(rng.rand(K) < 0.5, device=cuda)
            if flagged else None)
    parent = torch.as_tensor(rng.randint(0, K, K), device=cuda)
    n = tfr.gather_pair.launches
    got = tfr.gather_pair(pt, dt, parent, flag)
    assert tfr.gather_pair.launches == n + 1
    for a, b in zip(got, tfr.gather_pair_plain(pt, dt, parent, flag)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("start,L", [("normal", 32), ("uniform", 32),
                                     ("merge", 32), ("normal", 48),
                                     ("normal", 30)])
@pytest.mark.parametrize("tag", TAGS)
def test_frontier_step_kernel_matches_plain(cuda, tag, start, L):
    """K22 over 12 steps of the per-step beam equals its plain version
    on the card: tapes bit for bit and weights bit for bit; from random
    weights, from uniform ones (whole groups of children tie), and with
    half the members duplicated and a weight-only merge after step 6
    (weights out of order, dropped slots at -inf); rows of 32 and 48
    bytes (16-byte vectors) and 30 (bytes); the kernel's steps in one
    run's buffers (the tapes double-buffered)."""
    tab = tens.device_table(tens.compile_transition_table(tag), device=cuda)
    rng = np.random.RandomState(4)
    K, steps = 4099, 12
    pt, dt = _frontier_tapes(rng, K, L, tab.size_a, cuda)
    if start == "merge":
        pt[1::2], dt[1::2] = pt[0:-1:2].clone(), dt[0:-1:2].clone()
    lw = (torch.full((K,), -math.log(K), dtype=torch.float64, device=cuda)
          if start == "uniform" else
          torch.as_tensor(rng.normal(size=K), device=cuda))
    sites = torch.as_tensor(rng.randint(0, L, steps), dtype=torch.int32,
                            device=cuda)
    out_log = tfr._out_log(tab).contiguous()
    bufs = tfr.BeamBuffers(K, L, out_log.shape[1], cuda)
    k = (pt.clone(), dt.clone(), lw.clone())
    p = (pt.clone(), dt.clone(), lw.clone())
    for s in range(steps):
        k = tfr.frontier_step(tab, out_log, *k, sites, s, bufs)
        p = tfr.frontier_step_plain(tab, out_log, *p, sites[s])
        for a, b in zip(k, p):
            assert torch.equal(a, b), (tag, start, s)
        if start == "merge" and s == 5:
            h = tfr.content_hash(k[0], k[1], stride=1, bits=8)
            k = (k[0], k[1], tfr._merge_weights_inplace(h, k[2]))
            p = (p[0], p[1], tfr._merge_weights_inplace(h, p[2]))
            if out_log.shape[1] > 1:
                assert bool(torch.isinf(k[2]).any())


@pytest.mark.parametrize("n", [1, 3, 6])
@pytest.mark.parametrize("tag", ["ex2-ferromagnetic-chain",
                                 "ex4-chemical-turing"])
def test_tempered_round_kernel_matches_plain(cuda, tag, n):
    """K11's tempered rounds (tau 0.5) equal the plain tempered round on
    the card: tapes and log-weights bit for bit, in both forms: a call
    of n >= 4 rounds is one resident launch, a shorter call a launch a
    round."""
    dm = tens.compile_decision_machine(tag)
    rng = np.random.RandomState(6)
    K, L, E = 8192, 64, 4
    pt, dt = _frontier_tapes(rng, K, L, dm.size_a, cuda)
    lw = torch.as_tensor(rng.normal(size=K), device=cuda)
    shifts = torch.as_tensor(rng.randint(0, L // E, n), dtype=torch.int32,
                             device=cuda)
    u = torch.as_tensor(rng.rand(n, K, E).astype(np.float32), device=cuda)
    k = [pt.clone(), dt.clone(), lw.clone()]
    p = [pt.clone(), dt.clone(), lw.clone()]
    launches = tfr.tempered_round.launches
    tfr.tempered_round(dm, k[0], k[1], shifts, E, u, 0.5, k[2])
    assert tfr.tempered_round.launches == launches + (1 if n >= 4 else n)
    for j in range(n):
        tens.lattice_round_plain(dm, p[0], p[1], shifts[j], E, u[j], tau=0.5,
                                 lw=p[2])
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,L,E,n", [(1_000_000, 64, 4, 8),
                                     (4099, 60, 5, 5), (8, 131_072, 4, 4)])
def test_tempered_resident_matches_plain_at_width(cuda, K, L, E, n):
    """K11's tempered entry on ex2 at tau 0.5 at phase 12 (a)'s width (K =
    10^6, L = 64: 512 members a block), at a tile that splits K unevenly
    with five sites a member (a site at a time), and at rows too long to
    keep resident (a launch a round): tapes and lw bit for bit against
    the plain round; launches 1 where the tile fits, else n."""
    dm = tens.compile_decision_machine("ex2-ferromagnetic-chain")
    rng = np.random.RandomState(K % 1000 + L)
    pt, dt = _frontier_tapes(rng, K, L, dm.size_a, cuda)
    dt[::97, ::13] = 5  # out of range: the exact walk
    lw = torch.as_tensor(rng.normal(size=K), device=cuda)
    shifts = torch.as_tensor(rng.randint(0, L // E, n), dtype=torch.int32,
                             device=cuda)
    u = torch.rand((n, K, E), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(K))
    k = [pt.clone(), dt.clone(), lw.clone()]
    p = [pt.clone(), dt.clone(), lw.clone()]
    launches = tfr.tempered_round.launches
    tfr.tempered_round(dm, k[0], k[1], shifts, E, u, 0.5, k[2])
    resident = tens.k11_tempered_tile(K, L) is not None
    assert tfr.tempered_round.launches == launches + (1 if resident else n)
    for j in range(n):
        tens.lattice_round_plain(dm, p[0], p[1], shifts[j], E, u[j], tau=0.5,
                                 lw=p[2])
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert bool((k[2] != lw).any())


def test_blocked_frontier_on_card_runs_kernels(cuda):
    """The blocked frontier and the per-step beam on the card launch
    K11 (tempered: one resident launch for each block's 8 rounds), K19,
    K20, K21 and K22 and call no plain version."""
    dm = tens.compile_decision_machine("ex2-ferromagnetic-chain")
    rng = np.random.RandomState(8)
    K, L = 4096, 64
    tapes = [rng.randint(0, 2, (K, L)) for _ in range(2)]
    lw = np.full(K, -math.log(K))
    plain = [tfr.content_hash_plain, tfr.merge_resample_plain,
             tfr.gather_pair_plain, tens.lattice_round_plain,
             tfr.frontier_rank_plain, tfr.frontier_write_plain]
    before = [f.calls for f in plain]
    counts = [tfr.content_hash.launches, tfr.merge_resample.launches,
              tfr.gather_pair.launches, tfr.tempered_round.launches]
    (pt, dt), lw2, nu = tfr.run_weighted_frontier_blocked(
        3, tapes, lw, dm, (2, 8, 4), tau=0.5)
    assert [tfr.content_hash.launches, tfr.merge_resample.launches,
            tfr.gather_pair.launches, tfr.tempered_round.launches] == [
        counts[0] + 2, counts[1] + 2, counts[2] + 2, counts[3] + 2]
    assert abs(float(torch.logsumexp(lw2, 0))) < 1e-12
    assert nu.shape == (2,) and int(nu.min()) >= 1
    tab = tens.device_table(
        tens.compile_transition_table("ex2-ferromagnetic-chain"),
        device=cuda)
    n22 = tfr.frontier_step.launches
    (pt, dt), lw3 = tfr.run_weighted_frontier(4, tapes, lw, tab, 10, K, 2)
    assert tfr.frontier_step.launches == n22 + 20
    assert [f.calls for f in plain] == before
    assert abs(float(torch.logsumexp(lw3, 0))) < 1e-12


# --- K23 and K24: the thermodynamic rounds ---------------------------------------

_THERMO_TABLES = {}


def _thermo_tables(tag, device):
    if tag not in _THERMO_TABLES:
        dm = tens.compile_decision_machine(tag)
        _THERMO_TABLES[tag] = (dm, thermo.sigma_spec_tables(dm))
    dm, t = _THERMO_TABLES[tag]
    return dm, t, thermo.device_tables(t, device=device)


def _thermo_start(rng, tag, B, L, odd=False):
    """Tapes of the tag's mix; with ``odd`` a tenth of the cells hold
    symbols outside [0, size_a)."""
    pt, dt = _thermo_mix(rng, tag, B, L)
    if odd:
        size_a = tens.compile_decision_machine(tag).size_a
        for t in (pt, dt):
            pick = rng.rand(B, L) < 0.1
            t[pick] = rng.randint(-3, size_a + 3, int(pick.sum()))
    return pt, dt


def _thermo_mix(rng, tag, B, L):
    if tag == "ex4var2-chemical-turing":
        pt = rng.choice([6, 7, 8, 9], (B, L), p=[0.4, 0.3, 0.2, 0.1])
        dt = rng.choice(6, (B, L), p=[0.1, 0.1, 0.1, 0.1, 0.3, 0.3])
    elif tag == "ex3-copolymerization":
        pt = rng.choice(4, (B, L), p=[0.7, 0.1, 0.1, 0.1])
        dt = rng.choice(4, (B, L), p=[0.6, 0.2, 0.1, 0.1])
    else:
        pt = rng.randint(0, 2, (B, L))
        dt = rng.randint(0, 2, (B, L))
    return pt.astype(np.int32), dt.astype(np.int32)


def _thermo_draws(rng, B, L, E, n, per_member):
    shifts = rng.randint(-L, 2 * L, (n, B) if per_member else n)
    return (torch.as_tensor(shifts.astype(np.int32)),
            torch.as_tensor(rng.rand(n, B, E).astype(np.float32)))


@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "own"])
@pytest.mark.parametrize("tag,L,E", [("ex2-ferromagnetic-chain", 512, 1),
                                     ("ex2-ferromagnetic-chain", 512, 64),
                                     ("ex3-copolymerization", 1024, 32)])
def test_sigma_round_kernel_matches_plain(cuda, tag, L, E, per_member):
    """K23 and its plain version, both on the card, round by round (a
    tenth of the cells outside [0, size_a)): tapes, sigma and n_irrev
    bit for bit; the from-draws run on the card (its 8 rounds in one
    resident launch) equals the CPU's (plain versions) bit for bit; ex3
    counts irreversible events."""
    dm, _, tabs = _thermo_tables(tag, cuda)
    rng = np.random.RandomState(23)
    B, n = 333, 8
    pt, dt = _thermo_start(rng, tag, B, L, odd=True)
    shifts, u = _thermo_draws(rng, B, L, E, n, per_member)
    start = [torch.as_tensor(x, device=cuda).to(torch.int8) for x in (pt, dt)]
    k = [x.clone() for x in start] + [
        torch.zeros(B, dtype=torch.float64, device=cuda),
        torch.zeros(B, dtype=torch.int32, device=cuda)]
    p = [x.clone() for x in k]
    s_t, u_t = shifts.to(cuda), u.to(cuda)
    launches = thermo.sigma_round.launches
    for j in range(n):
        thermo.sigma_round(dm, k[0], k[1], s_t[j], E, u_t[j], tabs, k[2],
                           k[3])
        thermo.sigma_round_plain(dm, p[0], p[1], s_t[j], E, u_t[j], tabs,
                                 p[2], p[3])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k, p)), j
    assert thermo.sigma_round.launches == launches + n
    launches = thermo.sigma_round.launches
    run = thermo.run_ensemble_sigma_from_draws((pt, dt), dm, tabs, s_t, E,
                                               u_t, device=cuda)
    assert thermo.k23_tile(B, L, E, dm.num_specs, tabs[0].shape[0])
    assert thermo.sigma_round.launches == launches + 1
    cpu = thermo.run_ensemble_sigma_from_draws(
        (pt, dt), dm, thermo.device_tables(_THERMO_TABLES[tag][1], "cpu"),
        shifts, E, u, device="cpu")
    for a, b in zip((*run[0], *run[1:3]), (*cpu[0], *cpu[1:3])):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(run[0][0].cpu(), k[0].cpu().to(torch.int32))
    if tag == "ex3-copolymerization":
        assert int(k[3].sum()) > 0 and not k[2].any()


@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "own"])
@pytest.mark.parametrize("tag,L,E", [("ex4var2-chemical-turing", 1024, 1),
                                     ("ex4var2-chemical-turing", 1024, 64),
                                     ("ex2-ferromagnetic-chain", 256, 32)])
def test_ledger_round_kernel_matches_plain(cuda, tag, L, E, per_member):
    """K24 and its plain version, both on the card, round by round (a
    tenth of the cells outside [0, size_a)): tapes, sigma, counts and
    spec_sig bit for bit; the from-draws run on the
    card equals the CPU's bit for bit."""
    dm = tens.compile_decision_machine(tag)
    rng = np.random.RandomState(24)
    B, n, S = 333, 8, dm.num_specs
    g = (rng.randn(dm.size_a), rng.randn(dm.size_a), 1.7)
    pt, dt = _thermo_start(rng, tag, B, L, odd=True)
    shifts, u = _thermo_draws(rng, B, L, E, n, per_member)
    start = [torch.as_tensor(x, device=cuda).to(torch.int8) for x in (pt, dt)]
    k = [x.clone() for x in start] + [
        torch.zeros(B, dtype=torch.float64, device=cuda),
        torch.zeros((B, S), dtype=torch.int32, device=cuda),
        torch.zeros((B, S), dtype=torch.float64, device=cuda)]
    p = [x.clone() for x in k]
    s_t, u_t = shifts.to(cuda), u.to(cuda)
    g_t = (torch.as_tensor(g[0], device=cuda),
           torch.as_tensor(g[1], device=cuda), g[2])
    launches = thermo.ledger_round.launches
    for j in range(n):
        thermo.ledger_round(dm, k[0], k[1], s_t[j], E, u_t[j], g, *k[2:])
        thermo.ledger_round_plain(dm, p[0], p[1], s_t[j], E, u_t[j], g_t,
                                  *p[2:])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k, p)), j
    assert thermo.ledger_round.launches == launches + n
    assert int(k[3].sum()) == B * E * n and k[2].abs().max() > 0
    # The same rounds in one call: one resident launch.
    r = [x.clone() for x in start] + [torch.zeros_like(x) for x in k[2:]]
    thermo.ledger_rounds(dm, r[0], r[1], s_t, E, u_t, g, *r[2:])
    assert thermo.ledger_round.launches == launches + n + 1
    assert all(torch.equal(a, b) for a, b in zip(r, p))
    run = thermo.run_ensemble_ledger_from_draws((pt, dt), dm, g, s_t, E, u_t,
                                                device=cuda)
    cpu = thermo.run_ensemble_ledger_from_draws((pt, dt), dm, g, shifts, E,
                                                u, device="cpu")
    for a, b in zip((*run[0], run[1], *run[2]), (*cpu[0], cpu[1], *cpu[2])):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "own"])
@pytest.mark.parametrize("tag,B,L,E", [
    ("ex2-ferromagnetic-chain", 16384, 4096, 256),
    ("ex2-ferromagnetic-chain", 16384, 4096, 1),
    ("ex2-ferromagnetic-chain", 8192, 12, 1),
    ("ex2-ferromagnetic-chain", 333, 1000, 5),
    ("ex2-ferromagnetic-chain", 8, 131_072, 4),
    ("ex3-copolymerization", 16384, 4096, 256)])
def test_sigma_resident_matches_plain_at_widths(cuda, tag, B, L, E,
                                                per_member):
    """K23's resident form at phase 13's geometries ((a) at E 256 and 1,
    (b)), at a tile that splits B unevenly with five sites a member, and
    at rows too long to keep (a launch a round), on ex2 (its tables
    staged in shared memory) and ex3 (its tables read through L2; it
    fires irreversible jumps) with a tenth of the cells outside [0,
    size_a): five rounds in one call (`sigma_rounds`) equal five plain
    rounds, tapes, sigma and n_irrev bit for bit onto nonzero starting
    values; launches 1 where the tile fits, else 5."""
    dm, _, tabs = _thermo_tables(tag, cuda)
    rng = np.random.RandomState(B % 977 + E)
    n = 5
    pt, dt = _thermo_start(rng, tag, B, L, odd=True)
    shifts, u = _thermo_draws(rng, B, L, E, n, per_member)
    k = [torch.as_tensor(x, device=cuda).to(torch.int8) for x in (pt, dt)] + [
        torch.as_tensor(rng.randn(B), device=cuda),
        torch.as_tensor(rng.randint(0, 9, B).astype(np.int32), device=cuda)]
    p = [x.clone() for x in k]
    s_t, u_t = shifts.to(cuda), u.to(cuda)
    launches = thermo.sigma_round.launches
    thermo.sigma_rounds(dm, k[0], k[1], s_t, E, u_t, tabs, *k[2:])
    tile = thermo.k23_tile(B, L, E, dm.num_specs, tabs[0].shape[0])
    assert (tile is not None) == (L < 100_000)
    assert tile is None or tile[3] == (tag == "ex2-ferromagnetic-chain")
    assert thermo.sigma_round.launches == launches + (1 if tile else n)
    for j in range(n):
        thermo.sigma_round_plain(dm, p[0], p[1], s_t[j], E, u_t[j], tabs,
                                 *p[2:])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert not torch.equal(k[1].cpu().to(torch.int32), torch.as_tensor(dt))


@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "own"])
@pytest.mark.parametrize("B,L,E", [(16384, 4096, 256), (16384, 4096, 1),
                                   (8192, 12, 1), (4096, 128, 4),
                                   (333, 1000, 5), (8, 131_072, 4)])
def test_ledger_resident_matches_plain_at_widths(cuda, B, L, E, per_member):
    """K24's resident form at phase 13's geometries ((a) at E 256 and 1,
    (b), (c)), at a tile that splits B unevenly with five sites a member,
    and at rows too long to keep (a launch a round), on ex4var2 with a
    tenth of the cells outside [0, size_a): five rounds in one call equal
    five plain rounds, tapes, sigma, counts and spec_sig bit for bit;
    launches 1 where the tile fits, else 5."""
    tag = "ex4var2-chemical-turing"
    dm = tens.compile_decision_machine(tag)
    rng = np.random.RandomState(B % 977 + E)
    n, S = 5, dm.num_specs
    g = (rng.randn(dm.size_a), rng.randn(dm.size_a), 1.7)
    pt, dt = _thermo_start(rng, tag, B, L, odd=True)
    shifts, u = _thermo_draws(rng, B, L, E, n, per_member)
    k = [torch.as_tensor(x, device=cuda).to(torch.int8) for x in (pt, dt)] + [
        torch.as_tensor(rng.randn(B), device=cuda),
        torch.as_tensor(rng.randint(0, 9, (B, S)).astype(np.int32),
                        device=cuda),
        torch.as_tensor(rng.randn(B, S), device=cuda)]
    p = [x.clone() for x in k]
    s_t, u_t = shifts.to(cuda), u.to(cuda)
    g_t = (torch.as_tensor(g[0], device=cuda),
           torch.as_tensor(g[1], device=cuda), g[2])
    launches = thermo.ledger_round.launches
    thermo.ledger_rounds(dm, k[0], k[1], s_t, E, u_t, g, *k[2:])
    resident = thermo.k24_tile(B, L, E, S) is not None
    assert thermo.ledger_round.launches == launches + (1 if resident else n)
    for j in range(n):
        thermo.ledger_round_plain(dm, p[0], p[1], s_t[j], E, u_t[j], g_t,
                                  *p[2:])
    assert all(torch.equal(a, b) for a, b in zip(k, p))


def test_thermo_runs_on_card_launch_kernels(cuda):
    """`run_ensemble_sigma` on the card launches K23 once for its 20
    rounds and `run_ensemble_ledger` K24 once for its 30 (one chunk of
    draws each, resident), and neither calls a plain version; the ledger
    keeps its bookkeeping identity."""
    dm, _, tabs = _thermo_tables("ex2-ferromagnetic-chain", cuda)
    rng = np.random.RandomState(25)
    tapes = _thermo_start(rng, "ex2-ferromagnetic-chain", 512, 256)
    before = (thermo.sigma_round_plain.calls, thermo.ledger_round_plain.calls)
    n23, n24 = thermo.sigma_round.launches, thermo.ledger_round.launches
    (pt, dt), sigma, nirr, times = thermo.run_ensemble_sigma(
        3, tapes, dm, tabs, (20, 16), independent_sites=True)
    assert thermo.sigma_round.launches == n23 + 1
    assert sigma.device.type == "cuda" and int(nirr.sum()) == 0
    dm4 = tens.compile_decision_machine("ex4var2-chemical-turing")
    g = np.array([-1.0, -1.0, -1.0, 1.5, 0.0, 0.0, 6.0, 0.0, 0.0, 1.0])
    tapes = _thermo_start(rng, "ex4var2-chemical-turing", 512, 256)
    phi0 = thermo.tape_potential(torch.as_tensor(tapes[0], device=cuda),
                                 torch.as_tensor(tapes[1], device=cuda), g,
                                 g, 2.0)
    (pt, dt), sigma, (counts, spec_sig), _ = thermo.run_ensemble_ledger(
        4, tapes, dm4, (g, g, 2.0), (30, 8))
    assert thermo.ledger_round.launches == n24 + 1
    assert (thermo.sigma_round_plain.calls,
            thermo.ledger_round_plain.calls) == before
    phi_t = thermo.tape_potential(pt, dt, g, g, 2.0)
    assert float((sigma - (phi0 - phi_t)).abs().max()) < 1e-9
    assert (counts.sum(dim=1) == 30 * 8).all()
    assert float((spec_sig.sum(dim=1) - sigma).abs().max()) < 1e-9


# --- Forward-mode derivatives: K25, K26, K6's Kvaerno entries ---------------


def _jvp_state(n, dev, zeroed, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.rand(n, generator=g, device=dev, dtype=torch.float64) + 0.05
    if zeroed:
        p = torch.where(torch.rand(n, generator=g, device=dev,
                                   dtype=torch.float64) < 1 / 3, 0.0, p)
    v = torch.randn(n, generator=g, device=dev, dtype=torch.float64) * p
    return p / p.sum(), v


@pytest.mark.parametrize("tag,cl_k,dual", [
    ("ex4-chemical-turing", 5, False), ("ex1-radioactive-decay", 3, False),
    ("ex3-copolymerization", 3, True)])
def test_k25_matches_plain(cuda, tag, cl_k, dual):
    """K25 (`dense_jvp`) equals `dense_jvp_plain` bit for bit at a positive
    p and at one with zeroed windows, one K25 launch a call; its value
    path's dy equals the RHS's (K5) bits; in every launch form the
    program can take (`dense.forms_for`), each the others' bits, with p's
    levels given and formed in the launch (low None)."""
    prog = (tdense.compile_dense_dual(tag, cl_k) if dual
            else tdense.compile_dense(tag, cl_k))
    dp = tdense.device_program(prog, cuda)
    chosen = dp.form
    for zeroed in (False, True):
        p, v = _jvp_state(prog.state_size, cuda, zeroed, 25)
        low = tdense.pyramids(prog, p)
        want = tdense.dense_jvp_plain(dp, p, v, low)
        for form in tdense.forms_for(dp):
            dp.form = form
            before = tdense.dense_jvp.launches
            jv = tdense.dense_jvp(dp, p, v, low)
            assert tdense.dense_jvp.launches == before + 1
            assert torch.equal(jv, want), tdense.form_name(form)
            dy, jv2 = tdense.dense_jvp(dp, p, v, value=True)
            assert torch.equal(jv2, jv)
            assert torch.equal(dy, tdense.dense_rhs(dp, p))
        dp.form = chosen


def _launch_calls(fn):
    """The kernel launches ``fn`` makes, by the profiler's record of the
    CUDA runtime's launch calls (cudaLaunchKernel, cudaLaunchKernelExC,
    cudaLaunchCooperativeKernel), recorded as the host makes them; and
    the names of the kernels the profiler saw run, for the message."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    calls = [e.name for e in events if e.name.startswith("cudaLaunch")]
    kernels = [e.name for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return calls, kernels


@pytest.mark.parametrize("tag,cl_k,kind", [
    ("ex2-ferromagnetic-chain", 3, 1), ("ex4var2-chemical-turing", 3, 1),
    ("ex4-chemical-turing", 4, 2), ("ex6-mini-bff-lite", 2, 2)])
def test_jvp_is_one_launch_in_fused_forms(cuda, tag, cl_k, kind):
    """In the block and cluster forms a J.v is one launch, by the
    profiler's count of the runtime's launch calls: `dense_jvp` with p's
    levels given and made by the call (the forward-mode dual call's
    case), and an RHS (`dense_rhs`) too; the grid form launches K3 before
    K25."""
    prog = tdense.compile_dense(tag, cl_k)
    dp = tdense.device_program(prog, cuda)
    assert dp.form.kind == kind
    p, v = _jvp_state(prog.state_size, cuda, False, 7)
    low = tdense.pyramids(prog, p)
    for fn in (lambda: tdense.dense_jvp(dp, p, v, low),
               lambda: tdense.dense_jvp(dp, p, v, value=True),
               lambda: tdense.dense_rhs(dp, p)):
        calls, kernels = _launch_calls(fn)
        assert len(calls) == 1, (calls, kernels)
    dp.form = tdense.LaunchForm(0)
    calls, kernels = _launch_calls(lambda: tdense.dense_jvp(dp, p, v, low))
    assert len(calls) == 1 + tdense.pyramid_launches(prog.size_a, cl_k), \
        (calls, kernels)


# (a, k): phase 14's (d) and (e) programs (ex2 and ex1 at cl_k 3, ex2 at
# cl_k 6, ex4var2 at cl_k 3, ex2's parametric rule at cl_k 4), n =
# 100,000 (ex4var2 at cl_k 5) and the largest x the block form holds
# (4^7, where the split form is chosen).
_K26_SHAPES = [(2, 3), (2, 6), (10, 3), (2, 4), (10, 5), (4, 7)]


@pytest.mark.parametrize("a,k", _K26_SHAPES)
def test_k26_forms_match_plain(cuda, monkeypatch, a, k):
    """K26 in every launch form it can take equals its plain version bit
    for bit, both modes, the callers' arithmetic fused or not (f - L +
    const; f - L; support mode's L + ww, f - L + const and the mask's
    where), twice the same bits."""
    from chemical_kinetics_and_program_execution_torch.ode import steady

    g = torch.Generator(device=cuda).manual_seed(a * 100 + k)
    n = a**k
    x, f, cst, ww, keep = (torch.randn(n, generator=g, device=cuda,
                                       dtype=torch.float64) for _ in range(5))
    mask = torch.rand(n, generator=g, device=cuda) < 0.7
    w = torch.linalg.qr(torch.randn(a, 2, generator=g, device=cuda,
                                    dtype=torch.float64))[0].T.contiguous()
    c_norm = float(a) ** ((k - 1) / 2.0)
    cases = [(0, {}), (0, dict(f=f, const=cst)), (0, dict(f=f)),
             (1, {}), (1, dict(ww=ww)),
             (1, dict(f=f, const=cst, ww=ww, mask=mask, keep=keep)),
             (1, dict(f=f, ww=ww, mask=mask, keep=keep))]
    for form in steady.aug_forms(a, k):
        monkeypatch.setattr(steady, "aug_form", lambda a_, k_, f_=form: f_)
        bufs = {}
        for mode, kw in cases:
            got = steady.steady_aug(x, a, k, w, c_norm, mode, bufs=bufs, **kw)
            again = steady.steady_aug(x, a, k, w, c_norm, mode, bufs=bufs,
                                      **kw)
            want = steady.steady_aug_plain(x, a, k, w, c_norm, mode, **kw)
            assert torch.equal(got, want), (form, mode, sorted(kw))
            assert torch.equal(again, want), (form, mode, sorted(kw))


@pytest.mark.parametrize("a,k", [(2, 3), (10, 3), (10, 4), (10, 5)])
def test_k26_is_one_launch_in_tile_forms(cuda, a, k):
    """A K26 call in the block form is one kernel launch and runs no K3
    (by the profiler's launch calls and the pyramid's count); in the
    split form K3's launches come first, then two."""
    from chemical_kinetics_and_program_execution_torch.ode import steady

    g = torch.Generator(device=cuda).manual_seed(7)
    n = a**k
    x, f = (torch.randn(n, generator=g, device=cuda, dtype=torch.float64)
            for _ in range(2))
    w = torch.zeros((0, a), dtype=torch.float64, device=cuda)
    form = steady.aug_form(a, k)
    bufs = {}
    steady.steady_aug(x, a, k, w, 1.0, 0, f=f, bufs=bufs)
    before = tdense.pyramid.launches
    calls, kernels = _launch_calls(
        lambda: steady.steady_aug(x, a, k, w, 1.0, 0, f=f, bufs=bufs))
    if form == "block":
        assert len(calls) == 1, (form, calls, kernels)
        assert tdense.pyramid.launches == before
    else:
        assert len(calls) == 2 + tdense.pyramid_launches(a, k), (calls,
                                                                 kernels)


def test_k26_and_kvaerno_entries_match_plain(cuda):
    """K26 in both modes and K6's third table (rows 26-30 in both swap
    states, the Newton and error sums, the residual) equal their plain
    versions bit for bit."""
    from chemical_kinetics_and_program_execution_torch.ode import steady

    g = torch.Generator(device=cuda).manual_seed(26)
    a, k = 10, 4
    n = a**k
    x = torch.randn(n, generator=g, device=cuda, dtype=torch.float64)
    w = torch.linalg.qr(torch.randn(a, 2, generator=g, device=cuda,
                                    dtype=torch.float64))[0].T.contiguous()
    for mode in (0, 1):
        assert torch.equal(steady.steady_aug(x, a, k, w, 31.6, mode),
                           steady.steady_aug_plain(x, a, k, w, 31.6, mode))
    y, y_new, dz, f, gg = (torch.randn(n, generator=g, device=cuda,
                                       dtype=torch.float64) for _ in range(5))
    ks = dop853.rows_tensor(4, n, cuda)
    ks.copy_(torch.randn((4, n), generator=g, device=cuda,
                         dtype=torch.float64))
    out, out2 = torch.empty_like(y), torch.empty_like(y)
    for which in (26, 27, 28, 29, 30):
        for swap in (0, 1):
            dop853.stage(y, ks, 0.3, which, out, swap, 3)
            dop853.stage_plain(y, ks, 0.3, dop853.tableau_terms(
                which, swap, 3), out2)
            assert torch.equal(out, out2)
    z1, z2 = gg.clone(), gg.clone()
    got = dop853.norms(dop853._NEWTON, y, 1e-8, 1e-10, f0=dz, f1=z1).clone()
    assert torch.equal(got, dop853.norms_plain(dop853._NEWTON, y, 1e-8,
                                               1e-10, f0=dz, f1=z2))
    assert torch.equal(z1, z2)
    got = dop853.norms(dop853._ERR_DIFF, y, 1e-8, 1e-10, y_new=y_new,
                       f0=dz).clone()
    assert torch.equal(got, dop853.norms_plain(
        dop853._ERR_DIFF, y, 1e-8, 1e-10, y_new=y_new, f0=dz))
    assert torch.equal(dop853.resid(y, gg, f, 0.25, out),
                       dop853.resid_plain(y, gg, f, 0.25, out2))


def test_solver_paths_launch_k25_and_k26(cuda):
    """kvaerno3 launches K25 once a J v of its count, the steady state K25
    once a J_G v and K26 once a J_G v and a G; no plain version runs."""
    from chemical_kinetics_and_program_execution_torch.ode import steady

    prog = tdense.compile_dense("ex2-ferromagnetic-chain", 3)
    fn = tdense.make_dense_dy_dt(prog, device=cuda)
    plain = (tdense.dense_jvp_plain, tdense.sweep_plain,
             steady.steady_aug_plain)
    for f in plain:
        f.calls = 0
    tdense.dense_jvp.launches = steady.steady_aug.launches = 0
    ys, info = solve(lambda y, t: fn(y), np.full(8, 0.125), [0.0, 0.3],
                     rtol=1e-8, atol=1e-10, method="kvaerno3", device=cuda,
                     return_info=True)
    assert tdense.dense_jvp.launches == info["num_jvp"] > 0
    tdense.dense_jvp.launches = 0
    p_inf, sinfo = steady.steady_state("ex2-ferromagnetic-chain", 3,
                                       np.full(8, 0.125), warm_t=5.0,
                                       device=cuda)
    assert sinfo.converged
    assert tdense.dense_jvp.launches == sinfo.matvecs
    assert steady.steady_aug.launches == sinfo.matvecs + sinfo.residuals
    assert all(f.calls == 0 for f in plain)


# --- The companion simulators: K27, K28, K29 ---------------------------------

from chemical_kinetics_and_program_execution_torch.models import (  # noqa: E402,E501
    autocatalysis,
    ferromagnet,
    gillespie,
)

_SSA_NETS = {
    "bench": (gillespie.autocatalysis_network(1.0, 100.0, 1.0, 1.0, 100.0,
                                              1.0, 10.0, 2.0), (0, 0, 2000)),
    # A -> 0: quiescent after 5 events (inf times, counts held).
    "decay": (gillespie.ReactionNetwork(np.array([[1]]), np.array([[0]]),
                                        np.array([1.0])), (5,)),
}


def _wide_network():
    """32 reactions over 8 species, orders up to 3 a species and 8 factors
    a reaction: K27's limits."""
    rng = np.random.RandomState(12)
    reactants = rng.randint(0, 3, (32, 8)) * (rng.rand(32, 8) < 0.3)
    reactants[0] = [3, 3, 2, 0, 0, 0, 0, 0]
    products = rng.randint(0, 3, (32, 8)) * (rng.rand(32, 8) < 0.3)
    return (gillespie.ReactionNetwork(reactants, products,
                                      rng.rand(32) * 1e-3),
            tuple(rng.randint(20, 200, 8)))


@pytest.mark.parametrize("name", ["bench", "decay", "wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [4099, 64])
def test_ssa_round_kernel_matches_plain(cuda, name, dtype, B):
    """K27 against `ssa_round_plain` on the same draws, in two calls (the
    state carried): times and counts bit for bit, B not a multiple of 32
    too."""
    net, n0 = _wide_network() if name == "wide" else _SSA_NETS[name]
    S, E = len(n0), 40
    gen = torch.Generator(device=cuda).manual_seed(27)
    u = torch.rand((E, 2, B), generator=gen, dtype=dtype, device=cuda)
    out = []
    for fn in (gillespie.ssa_round, gillespie.ssa_round_plain):
        t = torch.zeros(B, dtype=torch.float64, device=cuda)
        n = torch.as_tensor(np.asarray(n0, np.int32), device=cuda)[:, None]
        n = n.expand(S, B).contiguous()
        ts = torch.empty((E, B), dtype=torch.float64, device=cuda)
        ns = torch.empty((E, S, B), dtype=torch.int32, device=cuda)
        for e0, e1 in ((0, 17), (17, E)):
            fn(net, u[e0:e1], t, n, ts[e0:e1], ns[e0:e1])
        out.append((ts, ns, t, n))
    torch.cuda.synchronize()
    for a, b in zip(*out):
        assert torch.equal(a, b)
    if name == "decay":
        assert bool(torch.isinf(out[0][0][-1]).all())


def _past_limits(kind):
    """A network past one of K27's shared-memory limits (33 reactions, 9
    species, 9 factors a reaction), as the CPU tests build it."""
    rng = np.random.RandomState({"reactions": 1, "species": 2,
                                 "factors": 3}[kind])
    R, S = {"reactions": (33, 3), "species": (12, 9),
            "factors": (5, 2)}[kind]
    reactants = rng.randint(0, 2, (R, S))
    if S > 8:
        reactants[:, 8] = 0
        reactants[0] = 0
        reactants[0, 8] = 1
    if kind == "factors":
        reactants[1] = 0
        reactants[1, 0] = 9
    products = rng.randint(0, 3, (R, S))
    rates = rng.uniform(0.2, 1.0, R) * 20.0 ** -reactants.sum(axis=1)
    return (gillespie.ReactionNetwork(reactants, products, rates),
            tuple([25] * S))


@pytest.mark.parametrize("kind", ["reactions", "species", "factors"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ssa_round_wide_form_matches_plain(cuda, kind, dtype):
    """K27's wide form (the network in global memory) at a network past
    each shared-memory limit against `ssa_round_plain` on the same draws,
    in two calls: times and counts bit for bit."""
    net, n0 = _past_limits(kind)
    assert not gillespie._fits_shared(net)
    S, E, B = len(n0), 40, 4099
    gen = torch.Generator(device=cuda).manual_seed(31)
    u = torch.rand((E, 2, B), generator=gen, dtype=dtype, device=cuda)
    out = []
    for fn in (gillespie.ssa_round, gillespie.ssa_round_plain):
        t = torch.zeros(B, dtype=torch.float64, device=cuda)
        n = torch.as_tensor(np.asarray(n0, np.int32), device=cuda)[:, None]
        n = n.expand(S, B).contiguous()
        ts = torch.empty((E, B), dtype=torch.float64, device=cuda)
        ns = torch.empty((E, S, B), dtype=torch.int32, device=cuda)
        for e0, e1 in ((0, 17), (17, E)):
            fn(net, u[e0:e1], t, n, ts[e0:e1], ns[e0:e1])
        out.append((ts, ns, t, n))
    torch.cuda.synchronize()
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert not torch.equal(out[0][1][-1], out[0][1][0])


def test_ssa_batch_tm_launches_k27(cuda):
    net, n0 = _SSA_NETS["bench"]
    gillespie.ssa_round.launches = gillespie.ssa_round_plain.calls = 0
    ts, ns = gillespie.ssa_batch_tm(3, n0, net, 100, 1000, device=cuda)
    assert gillespie.ssa_round.launches == 1
    assert gillespie.ssa_round_plain.calls == 0
    assert bool(torch.isfinite(ts).all()) and int(ns.min()) >= 0


@pytest.mark.parametrize("J,h,trials,rounds,N,T", [
    (1.0, -0.25, 500, 20, 50_000, 3),  # the example: 50 KB of chain
    (0.5, 0.3, 64, 8, 1000, 5),  # h > 0
    (0.3, -0.25, 24, 24, 999, 4),  # sequential: one trial a round
    (0.4, -0.1, 30, 4, 333, 2),  # 7 a round, 2 dropped
    (0.5, -0.25, 320, 8, 1001, 3),  # 40 a round: two round warps
    (1.0, -0.25, 500, 20, 50, 3),  # a ring below 64: the count a site
    (0.2, -0.1, 640, 20, 64, 2),  # 32 a round on a ring of 64
    (1.0, -0.25, 500, 20, 4097, 2)])  # a partial last word
@pytest.mark.parametrize("count_first", [True, False])
def test_metropolis_kernel_matches_plain(cuda, J, h, trials, rounds, N, T,
                                         count_first):
    """K28 against `metropolis_plain` on the same draws: counts and
    chains bit for bit."""
    rs, steps = trials // rounds, 12
    gen = torch.Generator(device=cuda).manual_seed(28)
    chains = (torch.rand((T, N), generator=gen, device=cuda) < 0.3).to(
        torch.int32)
    sites = torch.randint(0, N, (T, steps, rounds, rs), generator=gen,
                          dtype=torch.int32, device=cuda)
    u = torch.rand((T, steps, rounds, rs), generator=gen,
                   dtype=torch.float64, device=cuda)
    thr = ferromagnet.acceptance_table(J, h, 1.0)
    ck, cp = chains.clone(), chains.clone()
    got = ferromagnet.metropolis(ck, sites, u, thr, count_first)
    want = ferromagnet.metropolis_plain(
        cp, sites, u, torch.as_tensor(thr, device=cuda), count_first)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(ck, cp)
    assert not torch.equal(ck, chains)


def test_metropolis_bit_chains_match_plain(cuda):
    """K28 on long chains (300,000 sites at 25 trials a round, 87,168
    bytes of shared memory a block) against `metropolis_plain`: counts
    and chains bit for bit."""
    T, N, rounds, rs, steps = 2, 300_000, 20, 25, 6
    ferromagnet.k28_check(N, rounds, rs)
    gen = torch.Generator(device=cuda).manual_seed(29)
    chains = (torch.rand((T, N), generator=gen, device=cuda) < 0.3).to(
        torch.int32)
    sites = torch.randint(0, N, (T, steps, rounds, rs), generator=gen,
                          dtype=torch.int32, device=cuda)
    u = torch.rand((T, steps, rounds, rs), generator=gen,
                   dtype=torch.float64, device=cuda)
    thr = ferromagnet.acceptance_table(1.0, -0.25, 1.0)
    ck, cp = chains.clone(), chains.clone()
    got = ferromagnet.metropolis(ck, sites, u, thr, True)
    want = ferromagnet.metropolis_plain(
        cp, sites, u, torch.as_tensor(thr, device=cuda), True)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(ck, cp)
    assert not torch.equal(ck, chains)


def test_mc_island_history_launches_k28(cuda):
    ferromagnet.metropolis.launches = ferromagnet.metropolis_plain.calls = 0
    counts = ferromagnet.mc_island_history(
        num_trials=4, chain_length=2000, num_steps=50, trials_per_step=20,
        rounds_per_step=4, device=cuda)
    assert counts.shape == (4, 50, 6) and (counts[..., 0] == 0).all()
    assert ferromagnet.metropolis.launches >= 1
    assert ferromagnet.metropolis_plain.calls == 0


_AC_ROWS = np.array([  # examples/autocatalysis.py's first and last rows
    [0.0, 0.0, 1.0, 0.001, 20.0, 10.0, 0.001, 50.0, 20.0, 0.0, 0.0],
    [0.2, 0.1, 0.4, 0.001, 20.0, 10.0, 0.001, 50.0, 20.0, 0.0, 0.0],
    [0.0, 0.0, 1.0, 0.01, 20.0, 10.0, 0.01, 50.0, 20.0, 10.0, 10.0],
    [0.0, 0.0, 1.0, 0.05, 20.0, 10.0, 0.05, 25.0, 10.0, 30.0, 30.0]])


@pytest.mark.parametrize("n_out,max_steps", [(101, 200_000), (201, 150)])
def test_dopri5_batch_kernel_matches_plain(cuda, n_out, max_steps):
    """K29 against `_solve_batch_plain` on four example rows (and a cap
    that stops every member early: later samples stay 0): equal steps a
    member, samples within rtol 1e-12."""
    y0 = torch.as_tensor(_AC_ROWS[:, :3].copy(), device=cuda)
    p = torch.as_tensor(_AC_ROWS[:, 3:].copy(), device=cuda)
    ts = torch.linspace(0.0, 0.01 * (n_out - 1), n_out, dtype=torch.float64,
                        device=cuda)
    ys, acc, rej = autocatalysis.dopri5_batch(y0, p, ts, max_steps)
    want, acc_p, rej_p = autocatalysis._solve_batch_plain(y0, p, ts,
                                                          max_steps)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_p) and torch.equal(rej, rej_p)
    assert torch.equal(ys == 0, want == 0)
    torch.testing.assert_close(ys, want, rtol=1e-12, atol=0)
    if max_steps == 150:
        assert bool(((acc + rej) == 150).all()) and bool((ys[:, -1] == 0).all())


# --- Reverse-mode derivatives: K30 and K6's adjoint rows ----------------------


@pytest.mark.parametrize("tag,cl_k,dual", [
    ("ex2-ferromagnetic-chain", 5, False), ("ex4-chemical-turing", 3, False),
    ("ex4-chemical-turing", 5, False), ("ex3-copolymerization", 3, True),
    ("ex6-mini-bff-lite", 2, False)])
def test_k30_matches_plain(cuda, tag, cl_k, dual):
    """K30 (`dense_vjp`) equals `dense_vjp_plain` bit for bit (p_bar and
    w_bar) in every launch form the program can take, at a positive p,
    at one with a third of its windows 0 and a run-time w_const; one K30
    launch a call, autograd's backward through the closure the same
    bits."""
    prog = (tdense.compile_dense_dual(tag, cl_k) if dual
            else tdense.compile_dense(tag, cl_k))
    dp = tdense.device_program(prog, cuda)
    n = prog.state_size
    gen = torch.Generator(device=cuda).manual_seed(30)
    chosen = dp.form
    for zero in (False, True):
        p = torch.rand(n, generator=gen, device=cuda, dtype=torch.float64)
        if zero:
            p = torch.where(torch.rand(n, generator=gen, device=cuda) < 1 / 3,
                            0.0, p)
        p = p / p.sum()
        u = torch.randn(n, generator=gen, device=cuda, dtype=torch.float64)
        w = (torch.as_tensor(prog.w_const, device=cuda) * 1.25 if zero
             else None)
        want = tdense.dense_vjp_plain(dp, p, u, w_const=w, want_w=True)
        for form in tdense.forms_for(dp):
            dp.form = form
            before = tdense.dense_vjp.launches
            got = tdense.dense_vjp(dp, p, u, w_const=w, want_w=True)
            assert tdense.dense_vjp.launches == before + 1
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
        dp.form = chosen
    fn = tdense.make_dense_dy_dt(prog, device=cuda)
    q = p.clone().requires_grad_(True)
    torch.dot(fn(q), u).backward()
    assert torch.equal(q.grad, tdense.dense_vjp_plain(fn.device_program, p,
                                                      u)[0])


def test_k6_adjoint_rows_match_plain(cuda):
    """K6's adjoint rows 31-37 equal their plain versions bit for bit,
    each one launch counted as an adjoint launch."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    n = 10_000
    adj = dop853.rows_tensor(8, n, cuda)
    adj.copy_(torch.randn(adj.shape, generator=gen, device=cuda,
                          dtype=torch.float64))
    base = torch.randn(n, generator=gen, device=cuda, dtype=torch.float64)
    out, ref = torch.empty_like(base), torch.empty_like(base)
    before = dop853.stage.adjoint_launches
    rows = dop853.DP5_ADJ_ROWS + (dop853.DP5_ADJ_SUM,)
    for row in rows:
        dop853.stage(base, adj, 0.0375, row, out)
        dop853.stage_plain(base, adj, 0.0375, dop853.tableau_terms(row), ref)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
    assert dop853.stage.adjoint_launches == before + len(rows)
