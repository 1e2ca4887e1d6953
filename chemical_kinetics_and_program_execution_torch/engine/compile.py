"""The part of the problem compiler that the dense program needs.

Counterpart of the JAX package's `engine/compile.py`: `_pad_chains`
(ragged factor chains into padded index arrays) and `collect_signatures`
(worlds that can contribute, and their deduplicated window signatures).
The event-table compiler (`CompiledProblem`, `compile_problem`, its disk
cache) serves the gather fallback, which is not ported yet (ROADMAP
Queue 1 item 4).
"""

from __future__ import annotations

import numpy as np


def _pad_chains(chains, one_slot, dtype=np.int32):
    """Packs ragged (num, den) chains into dense padded arrays; padding
    points at the pyramid's constant-1 slot ``one_slot``."""
    n = len(chains)
    width = max((len(c) for c in chains), default=0)
    width = max(width, 1)
    num = np.full((n, width), one_slot, dtype=dtype)
    den = np.full((n, width), one_slot, dtype=dtype)
    for i, chain in enumerate(chains):
        for j, (a, b) in enumerate(chain):
            num[i, j] = a
            den[i, j] = b
    return num, den


def collect_signatures(worlds):
    """Keeps worlds that can contribute (nonzero choose-weight product, at
    least one changed tape) and maps each changed tape view to a
    deduplicated signature id. Zero-weight and unchanged worlds
    contribute exactly 0 in the reference as well.

    Returns (live_worlds, sig_ids, pair_world, pair_sig).
    """
    live = []
    sig_ids: dict[tuple[int, int, int], int] = {}
    pair_world: list[int] = []
    pair_sig: list[int] = []
    for world in worlds:
        changed = [s for s in world.tape_sigs if s[0] != s[1]]
        if world.const == 0.0 or not changed:
            continue
        wi = len(live)
        live.append(world)
        for sig in changed:
            pair_world.append(wi)
            pair_sig.append(sig_ids.setdefault(sig, len(sig_ids)))
    return live, sig_ids, pair_world, pair_sig
