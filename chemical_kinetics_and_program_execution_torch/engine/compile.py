"""Problem compiler: multiverse -> event tables.

Counterpart of the JAX package's `engine/compile.py`. `_pad_chains` and
`collect_signatures` serve the dense program (`dense.compile_dense`);
`compile_problem` makes the event tables of the gather engine
(`rhs.py`): the worlds' factor chains (stage 1), the world-to-signature
pairs (stage 2), and each signature's accumulation events (stage 3)
with the pre-sorted signed scatter. The events come from the C++
expander (`native.py`) unless the caller asks for the Python one
(``expander="python"``, the oracle) or sets ``CKPE_NO_NATIVE``, as the
JAX package's `engine/native.py` reads it. `compile_problem_dual` and
`collect_signatures_dual` are the dual-SPD compilers. The JAX package's
disk cache of compiled problems is not ported (ROADMAP).

`two_pointer_index` maps flat pyramid indices to where the port's
kernels read them: below the state size from the state vector itself,
above it from K3's levels (`dense.pyramid`), one block a tape.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..markov import pyramid_offsets
from . import accumulate, dsl, enumerate as enum_mod, native

_ARRAY_FIELDS = (
    "w_num", "w_den", "w_const",
    "pair_world", "pair_sig",
    "e_num", "e_den", "e_sig",
    "ev_idx", "ev_sign", "ev_tgt",
)


@dataclasses.dataclass
class CompiledProblem:
    tag: str
    size_a: int
    cl_k: int
    pyramid_size: int
    num_signatures: int
    # Stage 1: per-world factor chains, padded with the constant-1 slot.
    w_num: np.ndarray  # [W, Lw] int32
    w_den: np.ndarray  # [W, Lw] int32
    w_const: np.ndarray  # [W] float64
    # Stage 2: world->signature segment mapping.
    pair_world: np.ndarray  # [M] int32
    pair_sig: np.ndarray  # [M] int32
    # Stage 3: per-event factor chains and the pre-sorted signed scatter.
    e_num: np.ndarray  # [E, Le] int32
    e_den: np.ndarray  # [E, Le] int32
    e_sig: np.ndarray  # [E] int32
    ev_idx: np.ndarray  # [2E] int32  (event index per signed contribution)
    ev_sign: np.ndarray  # [2E] float64
    ev_tgt: np.ndarray  # [2E] int32  (sorted window ranks)

    dual = False

    @property
    def state_size(self) -> int:
        return self.size_a**self.cl_k

    @property
    def num_worlds(self) -> int:
        return len(self.w_const)

    @property
    def num_events(self) -> int:
        return len(self.e_sig)

    def summary(self) -> str:
        return (
            f"{self.tag}[A={self.size_a},k={self.cl_k}]: "
            f"{self.num_worlds} worlds, {self.num_signatures} signatures, "
            f"{self.num_events} events "
            f"(chains: worlds<={self.w_num.shape[1]}, "
            f"events<={self.e_num.shape[1]})"
        )


@dataclasses.dataclass
class CompiledDualProblem(CompiledProblem):
    """Dual-SPD compilation: program and data tapes draw from separate
    sequence distributions. The state is ``[p_program | p_data]``;
    factor indices point into the concatenated per-tape pyramid (program
    first, then data, then the shared constant-1 slot) and each tape's
    events into its own half of dy/dt, so the tables have the shared
    case's shape (the JAX package's `CompiledDualProblem`)."""

    dual = True

    @property
    def state_size(self) -> int:
        return 2 * self.size_a**self.cl_k


def _stable_argsort_i32(values: np.ndarray) -> np.ndarray:
    """Stable argsort of window ranks, as int32 keys (numpy's stable kind
    sorts integers by radix; narrower keys take fewer passes)."""
    return np.argsort(values.astype(np.int32), kind="stable")


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


def collect_signatures_dual(tag: str, worlds, half: int, one_slot: int):
    """`collect_signatures` for the dual-SPD compilers: signatures keyed
    by (tape, sig), and world chains remapped into the concatenated
    per-tape pyramid (data offset by ``half``, constant 1 at
    ``one_slot``). Returns (live, sig_ids, pair_world, pair_sig, w_num,
    w_den, w_const); raises when the worlds lack per-factor tape
    provenance."""
    live, sig_ids = [], {}
    pair_world, pair_sig = [], []
    for world in worlds:
        changed = [(ti, s) for ti, s in enumerate(world.tape_sigs)
                   if s[0] != s[1]]
        if world.const == 0.0 or not changed:
            continue
        if len(world.factor_tapes) != len(world.factors):
            raise ValueError(
                f"{tag!r}: worlds lack per-factor tape provenance; "
                "dual-SPD compilation needs the plain odometer path")
        wi = len(live)
        live.append(world)
        for ti, sig in changed:
            pair_world.append(wi)
            pair_sig.append(sig_ids.setdefault((ti, sig), len(sig_ids)))
    w_chains = [
        tuple((a + (half if dt else 0), b + (half if dt else 0))
              for (a, b), dt in zip(w.factors, w.factor_tapes))
        for w in live
    ]
    w_num, w_den = _pad_chains(w_chains, one_slot)
    w_const = np.array([w.const for w in live], dtype=np.float64)
    return live, sig_ids, pair_world, pair_sig, w_num, w_den, w_const


def _expand(size_a: int, cl_k: int, sigs, one_slot: int,
            expander: str | None):
    """Every signature's events, signature by signature: (e_num, e_den,
    e_sig, tgt_orig, tgt_adj) by the C++ expander or, when asked, the
    Python one (``expander`` None: the Python one where ``CKPE_NO_NATIVE``
    is set, else the C++ one; a failed build raises all the same);
    ``e_sig`` is the signature's position in ``sigs``."""
    if expander is None:
        expander = "python" if os.environ.get("CKPE_NO_NATIVE") else "native"
    if expander == "native":
        return native.expand_signatures(
            size_a, cl_k, np.array(list(sigs), dtype=np.int64).reshape(-1, 3),
            one_slot)
    if expander != "python":
        raise ValueError(f"expander is 'native' or 'python', not "
                         f"{expander!r}")
    ex = accumulate.Expander(size_a, cl_k)
    chains, e_sig, tgt_orig, tgt_adj = [], [], [], []
    for sid, sig in enumerate(sigs):
        for event in ex.expand(*sig):
            chains.append(event.factors)
            e_sig.append(sid)
            tgt_orig.append(event.target_orig)
            tgt_adj.append(event.target_adj)
    e_num, e_den = _pad_chains(chains, one_slot)
    return (e_num, e_den, np.asarray(e_sig, dtype=np.int32),
            np.asarray(tgt_orig, dtype=np.int64),
            np.asarray(tgt_adj, dtype=np.int64))


def _signed_scatter(tgt_orig, tgt_adj):
    """The pre-sorted signed scatter: +v[e] at the adjusted rank, -v[e]
    at the original rank, stably sorted by rank. Returns (ev_idx,
    ev_sign, ev_tgt)."""
    n = len(tgt_orig)
    all_tgt = (np.concatenate([np.asarray(tgt_adj, dtype=np.int64),
                               np.asarray(tgt_orig, dtype=np.int64)])
               if n else np.zeros((0,), dtype=np.int64))
    all_sign = np.concatenate([np.ones(n), -np.ones(n)])
    order = _stable_argsort_i32(all_tgt)
    return ((order % max(n, 1)).astype(np.int32), all_sign[order],
            all_tgt[order].astype(np.int32))


def compile_problem(tag: str, cl_k: int, *, max_worlds: int | None = None,
                    expander: str | None = None) -> CompiledProblem:
    """Compiles ``tag`` into its event tables (`CompiledProblem`); the
    events by the C++ expander, or by `accumulate.Expander` when
    ``expander="python"`` or, with ``expander`` None, when
    ``CKPE_NO_NATIVE`` is set."""
    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    _, pyr_total = pyramid_offsets(size_a, cl_k)
    one_slot = pyr_total - 1
    worlds = enum_mod.enumerate_worlds(problem, cl_k, max_worlds=max_worlds)
    live, sig_ids, pair_world, pair_sig = collect_signatures(worlds)
    w_num, w_den = _pad_chains([w.factors for w in live], one_slot)
    e_num, e_den, e_sig, tgt_orig, tgt_adj = _expand(
        size_a, cl_k, list(sig_ids), one_slot, expander)
    ev_idx, ev_sign, ev_tgt = _signed_scatter(tgt_orig, tgt_adj)
    return CompiledProblem(
        tag=problem.tag, size_a=size_a, cl_k=cl_k, pyramid_size=pyr_total,
        num_signatures=len(sig_ids), w_num=w_num, w_den=w_den,
        w_const=np.array([w.const for w in live], dtype=np.float64),
        pair_world=np.asarray(pair_world, dtype=np.int32),
        pair_sig=np.asarray(pair_sig, dtype=np.int32),
        e_num=e_num, e_den=e_den, e_sig=np.asarray(e_sig, dtype=np.int32),
        ev_idx=ev_idx, ev_sign=ev_sign, ev_tgt=ev_tgt)


def compile_problem_dual(tag: str, cl_k: int, *,
                         max_worlds: int | None = None,
                         expander: str | None = None
                         ) -> CompiledDualProblem:
    """Compiles ``tag`` with separate program and data SPDs
    (`CompiledDualProblem`). Each (tape, signature) is expanded as the
    shared compile expands the signature; its chains are then moved into
    its tape's pyramid and its targets into its tape's half of dy."""
    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    _, pyr_total = pyramid_offsets(size_a, cl_k)
    half = pyr_total - 1  # per-tape pyramid entries (less the 1-slot)
    one_slot = 2 * half
    window_mod = size_a**cl_k
    worlds = enum_mod.enumerate_worlds(problem, cl_k, max_worlds=max_worlds)
    (live, sig_ids, pair_world, pair_sig,
     w_num, w_den, w_const) = collect_signatures_dual(
        tag, worlds, half, one_slot)
    e_num, e_den, e_sig, tgt_orig, tgt_adj = _expand(
        size_a, cl_k, [sig for _, sig in sig_ids], half, expander)
    tape = np.array([ti for ti, _ in sig_ids], dtype=np.int64)[e_sig]

    def remap(x):  # padding (the single pyramid's 1-slot) to the dual one
        x = x.astype(np.int64)
        x = np.where(x == half, one_slot, x + half * tape[:, None])
        return x.astype(np.int32)

    ev_idx, ev_sign, ev_tgt = _signed_scatter(
        tgt_orig + window_mod * tape, tgt_adj + window_mod * tape)
    return CompiledDualProblem(
        tag=problem.tag, size_a=size_a, cl_k=cl_k,
        pyramid_size=one_slot + 1, num_signatures=len(sig_ids),
        w_num=w_num, w_den=w_den, w_const=w_const,
        pair_world=np.asarray(pair_world, dtype=np.int32),
        pair_sig=np.asarray(pair_sig, dtype=np.int32),
        e_num=remap(e_num), e_den=remap(e_den),
        e_sig=np.asarray(e_sig, dtype=np.int32),
        ev_idx=ev_idx, ev_sign=ev_sign, ev_tgt=ev_tgt)


def problem_from_arrays(tag: str, size_a: int, cl_k: int, pyramid_size: int,
                        num_signatures: int, arrays: dict,
                        dual: bool = False) -> CompiledProblem:
    """A `CompiledProblem` (a `CompiledDualProblem` when ``dual``) from
    its fields, ``arrays`` holding `_ARRAY_FIELDS` as numpy arrays: the
    JAX package's compiled tables carried over as they are."""
    cls = CompiledDualProblem if dual else CompiledProblem
    dtypes = {"w_const": np.float64, "ev_sign": np.float64}
    return cls(tag=tag, size_a=int(size_a), cl_k=int(cl_k),
               pyramid_size=int(pyramid_size),
               num_signatures=int(num_signatures),
               **{name: np.asarray(arrays[name],
                                   dtype=dtypes.get(name, np.int32))
                  for name in _ARRAY_FIELDS})


def two_pointer_index(idx, size_a: int, cl_k: int, dual: bool = False):
    """Flat pyramid indices (``[lv[k], ..., lv[0], 1]``, or for a dual
    program the program tape's pyramid less its 1-slot, then the data
    tape's, then the 1-slot) mapped to the layout the kernels read: x <
    N from the state vector ``[p_prog | p_data]`` (N entries), x >= N
    from ``low`` at x - N, where ``low`` holds K3's levels below p, one
    block of `pyramid_offsets` total - A^k doubles a tape (its last the
    1-slot). A single-tape index maps to itself."""
    idx = np.asarray(idx)
    if not dual:
        return idx.astype(np.int32)
    n = size_a**cl_k
    half = pyramid_offsets(size_a, cl_k)[1] - 1
    low = half - n + 1  # a tape's block of ``low``
    x = idx.astype(np.int64)
    data = (x >= half) & (x < 2 * half)
    y = np.where(data, x - half, x)  # index within the tape's pyramid
    out = np.where(y < n, y + n * data,
                   2 * n + low * data + (y - n))
    out = np.where(x == 2 * half, 2 * n + half - n, out)
    return out.astype(np.int32)
