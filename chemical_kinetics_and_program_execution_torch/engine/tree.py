"""Prefix-tree (levelized) form of the event factor chains.

Counterpart of the JAX package's `engine/tree.py`, host numpy with the
same `np.unique` and stable sorts, so its tables equal the JAX
package's. The port's tree kernel K7 (`csrc/gather_rhs.cu`) walks them.

The window-sweep expansion (`accumulate.py`, porting `lr-rec-extend-1`,
`tape_multiverse.scm:1249-1401`) is a depth-first recursion: every event's
ratio chain extends its parent's chain by exactly one factor, so the set
of all chains is a prefix tree. The padded-chain kernel (`rhs.py` stage
3, K8 on the card) recomputes each chain from scratch — ``O(E · L̄)``
pyramid gathers per RHS call (ex4 cl_k=5: 11.8M events × mean chain 6.7
≈ 79M gathers ×2).

This module rebuilds that tree from the compiled chain tables with a
level-by-level ``np.unique`` pass. The runtime kernel then computes one
ratio and one parent-value multiply **per node** (nodes ≈ events, since
internal nodes are shared), a ~4-6× reduction in gather traffic and table
memory, with bit-equivalent semantics (same left-to-right product order
as the reference recursion).

Built on the host at device-table construction time (seconds for 10^7
events) from the padded-chain tables that `compile.py` makes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Level:
    """One tree level: node factor indices + parent links + event taps."""

    num: np.ndarray  # [N_l] int32 pyramid index (ratio numerator)
    den: np.ndarray  # [N_l] int32 pyramid index (ratio denominator)
    parent: np.ndarray  # [N_l] int32 local index into level l-1 (l=0: unused)
    ev_node: np.ndarray  # [E_l] int32 local node index of events ending here


@dataclasses.dataclass(frozen=True)
class Tree:
    levels: tuple[Level, ...]
    event_order: np.ndarray  # [E] original event index, grouped by level

    @property
    def num_nodes(self) -> int:
        return sum(len(lv.num) for lv in self.levels)


def build_tree(e_num: np.ndarray, e_den: np.ndarray, one_slot: int,
               pyramid_size: int) -> Tree:
    """Levelizes padded factor chains into a shared prefix tree.

    ``e_num``/``e_den`` are the compiled ``[E, Lmax]`` padded chain tables
    (padding slots hold ``one_slot``, whose pyramid value is the constant
    1). Zero-length chains read their padding slot as a (1, 1) factor, so
    every event terminates at level ``max(len, 1) - 1`` with no special
    casing.
    """
    e_num = np.asarray(e_num, dtype=np.int64)
    e_den = np.asarray(e_den, dtype=np.int64)
    E, l_max = e_num.shape
    lens = (e_num != one_slot).sum(axis=1)
    term_level = np.maximum(lens, 1) - 1
    n_levels = int(term_level.max()) + 1 if E else 1

    pair_mod = pyramid_size * pyramid_size
    levels: list[Level] = []
    order_chunks: list[np.ndarray] = []
    active = np.arange(E)
    parent_local = np.zeros(E, dtype=np.int64)  # per active event
    for lev in range(n_levels):
        num = e_num[active, lev]
        den = e_den[active, lev]
        keys = (parent_local * pair_mod if lev else 0) \
            + num * pyramid_size + den
        uniq, inv = np.unique(keys, return_inverse=True)
        node_num = ((uniq // pyramid_size) % pyramid_size).astype(np.int32)
        node_den = (uniq % pyramid_size).astype(np.int32)
        node_par = (uniq // pair_mod).astype(np.int32)

        ends = term_level[active] == lev
        levels.append(Level(
            num=node_num,
            den=node_den,
            parent=node_par,
            ev_node=inv[ends].astype(np.int32),
        ))
        order_chunks.append(active[ends])
        keep = ~ends
        active = active[keep]
        parent_local = inv[keep]

    event_order = (np.concatenate(order_chunks) if E
                   else np.zeros((0,), dtype=np.int64))
    return Tree(levels=tuple(levels), event_order=event_order)


def recover_targets(num_events: int, ev_idx: np.ndarray, ev_sign: np.ndarray,
                    ev_tgt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-event (target_orig, target_adj) from the sorted signed scatter."""
    tgt_adj = np.zeros(num_events, np.int64)
    tgt_orig = np.zeros(num_events, np.int64)
    plus = ev_sign > 0
    tgt_adj[ev_idx[plus]] = ev_tgt[plus]
    tgt_orig[ev_idx[~plus]] = ev_tgt[~plus]
    return tgt_orig, tgt_adj


def sorted_scatter(tgt_orig: np.ndarray, tgt_adj: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Builds the pre-sorted signed scatter (ev_idx, ev_sign, ev_tgt)."""
    n = len(tgt_orig)
    all_tgt = np.concatenate([np.asarray(tgt_adj, dtype=np.int64),
                              np.asarray(tgt_orig, dtype=np.int64)])
    all_sign = np.concatenate([np.ones(n), -np.ones(n)])
    order = np.argsort(all_tgt.astype(np.int32), kind="stable")
    return ((order % max(n, 1)).astype(np.int32), all_sign[order],
            all_tgt[order].astype(np.int32))
