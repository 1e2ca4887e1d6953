"""Card-only tests: the port's CUDA kernels against their plain versions.

On a machine with an NVIDIA card (and no jax, which `tests/conftest.py`
imports), run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a card every test here skips. This file imports no jax and
nothing of the JAX package.
"""

import numpy as np
import pytest
import torch

from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as tens,
)

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


@pytest.mark.parametrize("tag", TAGS)
def test_plane_round_kernel_matches_plain(cuda, tag):
    """K1 and its plain version, both on the card, give identical planes
    after every round; every phase is covered."""
    dm = tens.compile_decision_machine(tag)
    rng = np.random.RandomState(1)
    B, L, E, n = 512, 1024, 64, 24
    stride = L // E
    pt, dt, shifts, u = _draws(rng, tag, dm, B, L, E, n)
    kp, kd = _planes(pt, stride, cuda), _planes(dt, stride, cuda)
    pp, pd = kp.clone(), kd.clone()
    shifts_t = torch.as_tensor(shifts, device=cuda)
    u_t = torch.as_tensor(u, device=cuda)
    plan = tens.device_plan(dm, cuda)
    launches = tens.plane_round.launches
    for k in range(n):
        tens.plane_round(dm, kp, kd, shifts_t, k, u_t[k], plan=plan)
        tens.plane_round_plain(dm, pp, pd, shifts_t, k, u_t[k])
        torch.cuda.synchronize()
        assert torch.equal(kp, pp) and torch.equal(kd, pd), k
    assert tens.plane_round.launches == launches + n
    assert not torch.equal(kd, _planes(dt, stride, cuda))


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
        torch.Generator(device=cuda).manual_seed(0), tapes, dm, (n, E))
    assert tens.plane_round.launches == launches + n
    assert tens.plane_round_plain.calls == calls
    assert pt.device.type == "cuda" and pt.dtype == torch.int32
    assert int(pt.min()) >= 0 and int(dt.max()) < dm.size_a
    assert applied.tolist() == [B * E] * n
    assert torch.all(torch.diff(times) > 0)


@pytest.mark.parametrize("size_a,cl_k", [(2, 2), (5, 3), (9, 4), (2, 14)])
def test_window_counts_kernel_matches_plain(cuda, size_a, cl_k):
    """K2 equals its plain version and `torch.bincount` exactly, with
    the shared-memory histogram (small alphabets) and without it
    (2**14 bins)."""
    rng = np.random.RandomState(size_a + cl_k)
    tape = torch.as_tensor(rng.randint(0, size_a, (64, 999)).astype(np.int32),
                           device=cuda)
    launches = tens.window_counts.launches
    got = tens.window_counts(tape, size_a, cl_k)
    assert tens.window_counts.launches == launches + 1
    plain = tens.window_counts_plain(tape, size_a, cl_k)
    assert torch.equal(got, plain.to(torch.float64) / tape.numel())
    rank = torch.zeros_like(tape, dtype=torch.int64)
    for j in range(cl_k):
        rank = rank * size_a + torch.roll(tape, -j, dims=1)
    lib = torch.bincount(rank.reshape(-1), minlength=size_a**cl_k)
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
