"""Markov-process helpers over sequence probability distributions (SPDs).

Numpy copies of the two helpers of
the JAX package's `markov.py` that the ensemble
slice needs: `mpp_from_spd` (the sampler's conditional next-symbol
probabilities) and `pyramid_offsets` (the enumerator's pyramid layout).
The rest arrives with the exact-closure slice.
"""

from __future__ import annotations

import numpy as np


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
