"""Markov-process helpers over sequence probability distributions (SPDs).

Counterpart of the JAX package's `markov.py`. An SPD is an array of
shape ``(A,)*k`` whose entry at a k-index-tuple is the probability of
reading that symbol window at a random tape position; tape content is
modelled as a stationary order-(k-1) Markov process.

The analysis helpers (`mpp_from_spd`, `ctm_from_mpp`,
`get_ctm_eigenvalue1_eigenspace`, `markov_entropy`, `seq_prob`, `tprint`,
`pyramid_np`) are numpy, as in the reference. `pyramid`, `guarded_ratio`
and `guarded_ratio_prod` are plain torch functions on the device of
their inputs; the exact RHS runs them as kernels K3 and K4
(`engine/dense.py`), with these as the plain versions' building blocks.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def mpp_from_spd(spd, eps=None):
    """Markov process parameters (conditional next-symbol probs) from an SPD.

    ``r[prefix + (s,)]`` is the probability that the (k-1)-window ``prefix``
    is followed by symbol ``s``. Entries are clipped into ``[eps, 1]``
    before normalising over the last axis, so impossible prefixes yield a
    uniform follow-up distribution instead of 0/0.
    """
    if eps is None:
        eps = 1e-100
    spd = np.clip(np.asarray(spd, dtype=np.float64), eps, 1)
    return spd / spd.sum(axis=-1, keepdims=True)


def pyramid_offsets(size_a, cl_k):
    """Offsets of each level (cl_k down to 0) in the flat pyramid buffer.

    Returns ``(offsets, total)`` where ``offsets[j]`` is the start of the
    length-``size_a**j`` level-``j`` table, and ``total`` includes the final
    constant-1 slot at index ``total - 1``.
    """
    offsets = {}
    pos = 0
    for j in range(cl_k, -1, -1):
        offsets[j] = pos
        pos += size_a**j
    return offsets, pos + 1  # + 1 for the constant-1 slot


def ctm_from_mpp(num_alphabet, num_context, mpp):
    """Context transfer matrix from Markov process parameters.

    Returns an ``[A**c, A**c]`` matrix M with ``M[next_ctx, ctx]``
    transition probabilities: for every (c+1)-sequence, its conditional
    probability is added at row ``rank(seq[1:])``, column
    ``rank(seq[:-1])``.
    """
    dim = num_alphabet**num_context
    mpp = np.asarray(mpp, dtype=np.float64).reshape(
        [num_alphabet] * (num_context + 1)
    )
    result = np.zeros([dim, dim])
    flat = mpp.ravel()
    seqs = np.indices([num_alphabet] * (num_context + 1)).reshape(
        num_context + 1, -1
    )
    pow_ = num_alphabet ** np.arange(num_context - 1, -1, -1)
    rows = pow_ @ seqs[1:]
    cols = pow_ @ seqs[:-1]
    np.add.at(result, (rows, cols), flat)
    return result


def get_ctm_eigenvalue1_eigenspace(spd, eps_mpp=None, eps=1e-7):
    """Validity gate for initial SPDs.

    Checks that left and right (k-1)-marginals agree, then measures how
    well the marginal lies in the eigenvalue-1 eigenspace of the context
    transfer matrix. Returns ``(deviation, eigenspace)`` or
    ``(marginal_distance, None)`` when the marginals are incompatible.
    """
    spd = np.asarray(spd, dtype=np.float64)
    num_alphabet = spd.shape[0]
    num_context = spd.ndim - 1
    marg_right = spd.sum(axis=-1)
    marg_left = spd.sum(axis=0)
    marginal_distance = np.linalg.norm(marg_right.ravel() - marg_left.ravel())
    if not marginal_distance <= eps:
        return marginal_distance, None
    mpp = mpp_from_spd(spd, eps=eps_mpp)
    ctm = ctm_from_mpp(num_alphabet, num_context, mpp)
    eigvals, eigvecs = np.linalg.eig(ctm)
    eigenspace = eigvecs[:, abs(eigvals - 1.0) <= eps]
    _, residuals, *_ = np.linalg.lstsq(
        eigenspace, marg_left.ravel(), rcond=None
    )
    return np.linalg.norm(residuals**0.5), eigenspace


def markov_entropy(spd):
    """Markov-chain entropy rate of the SPD."""
    eps = 1e-280
    spd = np.clip(np.asarray(spd, dtype=np.float64), eps, 1)
    reduced = spd.sum(axis=-1)
    conditional = spd / reduced[..., np.newaxis]
    return (
        (-conditional * np.log(conditional)).sum(axis=-1).ravel()
        @ reduced.ravel()
    )


def seq_prob(spd, seq, *, num_prefix_indices=0, eps=None, mpp=None,
             want_mpp=False):
    """Probability of a symbol sequence under an SPD.

    Sequences no longer than the tracked window marginalise the leading
    axes; longer sequences are extended with the Markov chain's
    conditional probabilities. Returns ``(probability, mpp)``.
    """
    spd = np.asarray(spd, dtype=np.float64)
    num_sequence_indices = spd.ndim - num_prefix_indices
    excess = num_sequence_indices - len(seq)
    if excess >= 0:
        prob = spd[..., *seq].sum(
            axis=tuple(
                range(num_prefix_indices, num_prefix_indices + excess)
            )
        )
        return prob, (mpp_from_spd(spd, eps=eps) if want_mpp else mpp)
    if mpp is None:
        mpp = mpp_from_spd(spd, eps=eps)
    p = spd[..., *seq[:num_sequence_indices]]
    tail = seq[1:]
    while len(tail) >= num_sequence_indices:
        p = mpp[..., *tail[:num_sequence_indices]] * p
        tail = tail[1:]
    return p, mpp


def tprint(size_a, cl_k, adata, epsilon=1e-10, nmax=float("inf"), file=None):
    """Debug-prints non-negligible entries of a transition table."""
    num_in = cl_k - 1
    a = np.asarray(adata).reshape([size_a] * (2 * num_in))
    for n, idx in enumerate(
        itertools.product(range(size_a), repeat=2 * num_in)
    ):
        if n >= nmax:
            print("... more entries...", file=file)
            break
        val = a[idx]
        if not abs(val) < epsilon:
            print(f"{idx[:num_in]} {idx[num_in:]}: {val}", file=file)


# --- Marginal pyramid -------------------------------------------------------
#
# Level j is the marginal over the FIRST j symbols, obtained by repeatedly
# summing over the trailing axis. The engine consumes all levels as one
# flat buffer with a trailing constant-1 slot (used for padding in factor
# chains); `pyramid_offsets` above gives the layout.


def guarded_ratio(num, den):
    """The reference's conditional-probability noise guard,
    ``num > 0 ? num / max(num, den) : 0``, elementwise.

    Written with the masked denominator forced to 1 (the "double-where"
    idiom), as in the reference, so no lane ever forms 0/0."""
    pos = num > 0
    safe_den = torch.where(pos, torch.maximum(num, den),
                           torch.ones((), dtype=num.dtype, device=num.device))
    return torch.where(pos, num, torch.zeros(
        (), dtype=num.dtype, device=num.device)) / safe_den


def guarded_ratio_prod(pyr, num_idx, den_idx):
    """Chain products of guarded ratios gathered from a flat pyramid."""
    return torch.prod(guarded_ratio(pyr[num_idx], pyr[den_idx]), dim=-1)


def pyramid(p, size_a, cl_k):
    """Flat marginal-pyramid buffer ``[lv[k], ..., lv[0], 1]`` of an SPD
    vector ``p`` (a float64 tensor), on ``p``'s device."""
    p = p.reshape(-1)
    levels = [p]
    cur = p
    for j in range(cl_k - 1, -1, -1):
        cur = cur.reshape(size_a**j, size_a).sum(dim=-1)
        levels.append(cur)
    levels.append(torch.ones(1, dtype=p.dtype, device=p.device))
    return torch.cat(levels)


def pyramid_np(p, size_a, cl_k):
    """Numpy twin of :func:`pyramid` for host-side use."""
    p = np.asarray(p, dtype=np.float64).reshape(-1)
    levels = [p]
    cur = p
    for j in range(cl_k - 1, -1, -1):
        cur = cur.reshape(size_a**j, size_a).sum(axis=-1)
        levels.append(cur)
    levels.append(np.ones((1,), dtype=np.float64))
    return np.concatenate(levels)
