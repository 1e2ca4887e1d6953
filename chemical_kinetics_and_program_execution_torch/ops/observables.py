"""Observable projections over SPD trajectories, on the device.

Counterpart of the JAX package's `ops/observables.py`: every example
observable (``seq_prob`` of a window no longer than cl_k, per-symbol
marginals) is a linear slice-sum of the SPD, and the Markov entropy rate
a short reduction. Used through the ``project=`` parameter of
`ode.integrate.solve`, so only the projected rows leave the device.
Plain torch functions on the device of their input (ROADMAP Queue 2
names `seq_prob_projector` for a later kernel or a fusion into K6).
"""

from __future__ import annotations

import torch


def seq_prob_projector(seqs, size_a: int, cl_k: int):
    """``[T, size_a**cl_k] -> [T, len(seqs)]`` projection.

    Column j is ``seq_prob(p, seqs[j])`` for a sequence of length
    l <= cl_k: marginalise the leading ``cl_k - l`` window axes and read
    the trailing-rank slice (`markov.seq_prob`'s short-sequence branch).
    """
    plan = []
    for seq in seqs:
        length = len(seq)
        if length < 1:
            raise ValueError(f"empty sequence {seq!r}")
        if length > cl_k:
            raise ValueError(
                f"sequence {seq!r} longer than cl_k={cl_k}: the "
                "Markov-chain extension is not linear in p"
            )
        rank = 0
        for s in seq:
            if not 0 <= s < size_a:
                raise ValueError(f"symbol {s} outside alphabet "
                                 f"[0, {size_a})")
            rank = rank * size_a + s
        plan.append((length, rank))

    def project(p):
        t = p.shape[0]
        cols = [
            p.reshape(t, size_a ** (cl_k - length), size_a**length)[
                :, :, rank
            ].sum(dim=1)
            for length, rank in plan
        ]
        return torch.stack(cols, dim=1)

    return project


def markov_entropy_projector(size_a: int, cl_k: int):
    """``[T, size_a**cl_k] -> [T, 1]`` Markov entropy-rate column, with
    `markov.markov_entropy`'s clipping."""
    n_ctx = size_a ** (cl_k - 1)

    def project(p):
        t = p.shape[0]
        spd = torch.clamp(p.reshape(t, n_ctx, size_a), 1e-280, 1.0)
        reduced = spd.sum(dim=-1)
        conditional = spd / reduced[..., None]
        h = (-conditional * torch.log(conditional)).sum(dim=-1)
        return torch.sum(h * reduced, dim=-1, keepdim=True)

    return project


def stack_projectors(*projectors):
    """Concatenates projector outputs column-wise into one projection."""

    def project(p):
        return torch.cat([proj(p) for proj in projectors], dim=1)

    return project
