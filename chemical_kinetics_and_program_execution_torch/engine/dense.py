"""Dense transfer-matrix RHS: the exact SPD closure's dp/dt.

Counterpart of the JAX package's `engine/dense.py`. A rule is compiled
on the host into a :class:`DenseProgram` (`compile_dense`): per-world
factor chains into the flat marginal pyramid, world-to-signature pairs,
and one :class:`SigPlan` per revealed-window signature. Signatures with
the same (revealed length, changed positions) share one window sweep
(`_group_plans`). dp/dt then takes three stages, each hand-written
CUDA on the card (`csrc/dense_rhs.cu`) with its plain PyTorch version
here, which the wrapper runs for a CPU tensor:

- K3 `pyramid`: the marginal levels below p (`_levels` there);
- K4, the signature weights: world weights, chain products of guarded
  ratios, summed into signature weights (`signature_weights_plain`); on
  the card phase 0 of K5's launch (`csrc/sweep_rule.cuh:
  k4_pair_weight`, a warp a signature);
- K5 `sweep`: every group's sweep in one launch (`csrc/sweep_rule.cuh`
  is the per-element rule), planned once a program on the host
  (`sweep_plan`), each ratio formed where it is needed from the pyramid
  (`_ratio_tables` there).

On a card `make_dense_dy_dt`'s fn runs K3 and K5 from one C call
(`dense_rhs`) in the program's launch form (`launch_form`, chosen once
a program by its largest phase): one block or one thread-block cluster,
whose launch forms the levels itself (one launch an RHS), or the
cooperative grid after K3 (3 launches at ex4's cl_k 5-8).

Its J.v (forward mode: `torch.func.jvp` on the closure, or a
forward-AD dual, as the solvers pass it) is kernel K25 (`dense_jvp`):
K5's kernel (`csrc/dense_rhs.cu`) and rule (`csrc/sweep_rule.cuh`) on
(value, tangent) pairs, over the levels of p and of v, in K5's form;
`dense_jvp_plain` is its plain version. Its v^T J (reverse mode:
autograd's backward through the closure, in p and in a run-time
w_const) is kernel K30 (`dense_vjp`, `csrc/dense_vjp.cu`): the sweep run
forward and then transposed, each cotangent a gather in plan order
(`vjp_plan`), then the ratios' partials, the world chains and the
pyramid's transpose; `dense_vjp_plain` is its plain version. Second
derivatives and the world mass's derivatives are not ported
(`SECOND_ORDER`).

A pruned program (`compile_dense` with ``prune_threshold > 0``: worlds
whose weight under a reference SPD drops below the threshold are left
out, `enumerate.BeamGuide`) keeps the kept worlds exact and carries mass
tables over every enumerated world (``m_num``, ``m_den``, ``m_const``).
``make_dense_dy_dt(with_mass=True)`` then returns the mass of the
enumerated worlds under p beside dp/dt (exactly 1 for a complete
multiverse, so 1 - mass is the weight the pruning lost at p): kernel K9
`world_mass` (`csrc/world_mass.cu`, `csrc/mass_rule.cuh`), its own
launch after K3 and K5, over the pyramid K3 built for the same p.

A dual-SPD program (`compile_dense_dual`) has separate program and data
tape distributions: the state is ``[p_prog | p_data]``, each plan names
its tape, groups never mix tapes, K3 runs on each tape into its block
of the levels, and K5's items carry their tape as offsets into p, the
levels and dy (``poff``, ``loff``), 0 in a single-tape plan, whose items
are otherwise those of a program with no dual mode. World chains index
the concatenated per-tape pyramid; `device_program` maps them to where
the kernels read them (`compile.two_pointer_index`).

The sweep plan follows `_apply_group` step for step: seed a one-hot
vector, left-extend it to a (k-1)-context (phase A), emit and left-shift
while a changed cell stays in frame (phase C), right-extend while a
changed cell stays in context (phase B). The plain version computes each
step densely as `_apply_group` does (tile, repeat, reshape-sum, a
sub-slice scatter for the emission), sums digits in digit order and adds
each dy window's terms in K5's order: the plan's phase order
(`_phases`). The TPU's emission layout guard
(`_ROLL_EMIT_MIN_STATE` there) has no counterpart: the plain version
uses one emission form at every size.

K5 forms each step only at its live windows. Why that is exact: a
group's seed is one-hot at its members' ranks, so it is nonzero only
where the revealed run digits are a member's original digits. A step
multiplies by a guarded ratio, g(n, d) = n > 0 ? n / max(n, d) : 0,
which for a finite p is finite (at most 1), and moves digits: a tile or
repeat adds an unrevealed digit, a digit sum drops one. So after each
step the vector is nonzero only at windows whose revealed-run digits
(``(j / lo) % span``) equal one of the members' in-window original
digits, the step's sorted live ranks: A^k D / span windows for D
distinct ranks. Every skipped window holds an exact 0 (+-0). A digit sum
over the remaining terms, still in digit order (d = 0 first), gives the
dense sum's bits: adding an exact 0 leaves a nonzero partial sum as it
is and changes at most the sign of a zero one. The emission then reads
and writes dy only where a run is an original or adjusted rank, and dy,
zeroed once, never holds -0, so the skipped +-0 terms would not have
changed its bits either. For a p with a NaN or an infinity the ratio can
be NaN, and a dense step's NaN * 0 spreads where K5 forms nothing: both
give a non-finite dy, not the same one.

Not ported yet (ROADMAP Queue 1, "The exact engines' other entry
points"): the streamed RHS.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from .. import cuda
from ..markov import guarded_ratio, pyramid_offsets
from ..utils import config
from ..utils.autodiff import SECOND_ORDER, first_order_only
from . import dsl, enumerate as enum_mod
from .compile import two_pointer_index


@dataclasses.dataclass(frozen=True)
class SigPlan:
    """Static sweep metadata for one revealed-window signature."""

    sid: int  # index into the signature-weight vector
    length: int  # revealed length L0
    orig: tuple[int, ...]  # revealed original digits (left->right)
    adj: tuple[int, ...]  # adjusted digits
    tape: int = 0  # dual-SPD programs: the tape's pyramid and dy half


@dataclasses.dataclass
class DenseProgram:
    tag: str
    size_a: int
    cl_k: int
    pyramid_size: int
    num_signatures: int
    # Stage 1-2: per-world factor chains (tens to thousands of rows).
    w_num: np.ndarray
    w_den: np.ndarray
    w_const: np.ndarray
    pair_world: np.ndarray
    pair_sig: np.ndarray
    plans: tuple[SigPlan, ...]
    # Mass accounting over ALL enumerated worlds (no-change ones too):
    # the weights sum to 1 for a complete multiverse, less when pruned.
    m_num: np.ndarray | None = None
    m_den: np.ndarray | None = None
    m_const: np.ndarray | None = None
    pruned: bool = False
    # Dual-SPD mode: the state is [p_prog | p_data], factor indices into
    # the concatenated per-tape pyramid.
    dual: bool = False

    @property
    def state_size(self) -> int:
        n = self.size_a**self.cl_k
        return 2 * n if self.dual else n

    @property
    def num_worlds(self) -> int:
        return len(self.w_const)


def _digits(x: int, n: int, a: int) -> tuple[int, ...]:
    return tuple((x // a**i) % a for i in range(n - 1, -1, -1))


def _rank(digits, a: int) -> int:
    r = 0
    for d in digits:
        r = r * a + d
    return r


def compile_dense(tag: str, cl_k: int, *,
                  max_worlds: int | None = None,
                  p_ref=None, prune_threshold: float = 0.0) -> DenseProgram:
    """Compiles a problem to its dense transfer-matrix program.

    For rules whose multiverse is too deep to enumerate (ex6-mini-bff at
    its faithful parameters), pass ``prune_threshold > 0`` and a
    reference SPD ``p_ref`` (uniform when None): paths whose weight
    under ``p_ref`` drops below the threshold are skipped, kept paths
    stay exact, and the program carries mass tables over every
    enumerated world, so that ``make_dense_dy_dt(with_mass=True)``
    reports the measured mass ``sum of the worlds' weights(p)`` per call.
    As in the JAX package, ``p_ref`` without a threshold prunes nothing.
    """
    from .compile import _pad_chains, collect_signatures

    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    _, pyr_total = pyramid_offsets(size_a, cl_k)
    one_slot = pyr_total - 1
    guide = None
    if prune_threshold > 0.0:
        if p_ref is None:
            p_ref = np.full(size_a**cl_k, 1.0 / size_a**cl_k)
        guide = enum_mod.BeamGuide(p_ref, size_a, cl_k, prune_threshold)
    worlds = enum_mod.enumerate_worlds(problem, cl_k, max_worlds=max_worlds,
                                       guide=guide)
    live, sig_ids, pair_world, pair_sig = collect_signatures(worlds)
    w_num, w_den = _pad_chains([w.factors for w in live], one_slot)
    plans = tuple(
        SigPlan(sid=sid, length=length,
                orig=_digits(io, length, size_a),
                adj=_digits(ia, length, size_a))
        for (io, ia, length), sid in sig_ids.items()
    )
    mass = None
    if guide is not None:
        m_num, m_den = _pad_chains([w.factors for w in worlds], one_slot)
        mass = (m_num, m_den,
                np.array([w.const for w in worlds], dtype=np.float64))
    return program_from_arrays(
        tag, size_a, cl_k, w_num, w_den,
        np.array([w.const for w in live], dtype=np.float64),
        pair_world, pair_sig,
        [(p.sid, p.length, p.orig, p.adj) for p in plans], mass=mass)


def compile_dense_dual(tag: str, cl_k: int, *,
                       max_worlds: int | None = None) -> DenseProgram:
    """The dense program with separate program and data tape SPDs: world
    chains offset into the concatenated per-tape pyramid, each plan
    carrying its tape, as the JAX package's `compile_dense_dual`."""
    from .compile import collect_signatures_dual

    problem = dsl.get_problem(tag)
    size_a = problem.size_a
    half = pyramid_offsets(size_a, cl_k)[1] - 1
    worlds = enum_mod.enumerate_worlds(problem, cl_k, max_worlds=max_worlds)
    (_, sig_ids, pair_world, pair_sig,
     w_num, w_den, w_const) = collect_signatures_dual(tag, worlds, half,
                                                       2 * half)
    plans = [(sid, length, _digits(io, length, size_a),
              _digits(ia, length, size_a), ti)
             for (ti, (io, ia, length)), sid in sig_ids.items()]
    return program_from_arrays(tag, size_a, cl_k, w_num, w_den, w_const,
                               pair_world, pair_sig, plans, dual=True)


def program_from_arrays(tag: str, size_a: int, cl_k: int, w_num, w_den,
                        w_const, pair_world, pair_sig, plans,
                        dual: bool = False, mass=None) -> DenseProgram:
    """A :class:`DenseProgram` from its fields as numpy arrays and
    ``plans`` as ``(sid, length, orig, adj)`` tuples, one a signature,
    with the tape as a fifth item in a ``dual`` program's: the JAX
    package's compiled program carried over as it is. ``mass`` is a
    pruned program's ``(m_num, m_den, m_const)``."""
    plans = tuple(SigPlan(sid=int(sid), length=int(length),
                          orig=tuple(int(x) for x in orig),
                          adj=tuple(int(x) for x in adj),
                          tape=int(tape[0]) if tape else 0)
                  for sid, length, orig, adj, *tape in plans)
    _, pyr_total = pyramid_offsets(size_a, cl_k)
    if dual:
        pyr_total = 2 * (pyr_total - 1) + 1
    if mass is not None:
        mass = dict(m_num=np.asarray(mass[0], dtype=np.int32),
                    m_den=np.asarray(mass[1], dtype=np.int32),
                    m_const=np.asarray(mass[2], dtype=np.float64),
                    pruned=True)
    return DenseProgram(
        tag=tag, size_a=int(size_a), cl_k=int(cl_k),
        pyramid_size=pyr_total,
        num_signatures=len(plans),
        w_num=np.asarray(w_num, dtype=np.int32),
        w_den=np.asarray(w_den, dtype=np.int32),
        w_const=np.asarray(w_const, dtype=np.float64),
        pair_world=np.asarray(pair_world, dtype=np.int32),
        pair_sig=np.asarray(pair_sig, dtype=np.int32),
        plans=plans, dual=bool(dual), **(mass or {}),
    )


def _emit_sub_ranks(plan: SigPlan, s0: int, k: int, a: int
                    ) -> tuple[int, int]:
    """(orig, adj) ranks of the revealed digit run inside the window
    starting at tape cell ``s0``."""
    q_lo = max(0, s0)
    q_hi = min(plan.length - 1, s0 + k - 1)
    return (_rank(plan.orig[q_lo:q_hi + 1], a),
            _rank(plan.adj[q_lo:q_hi + 1], a))


def _sweep_meta(l0: int, changed: tuple[int, ...], k: int
                ) -> tuple[int, int, list[int]]:
    """(m_l, m_r, emission window starts) for one (L0, changed) shape."""
    base = min(l0, k)
    m_l = base - 1 - changed[0]
    m_r = k - l0 + changed[-1]
    s0s = [base - k - m for m in range(0, m_l + 1)]
    s0s += [l0 + m - k for m in range(1, m_r + 1)]
    return m_l, m_r, s0s


def _group_plans(plans, a: int, k: int):
    """Groups signatures that can share one sweep.

    Signatures with the same (revealed length, changed positions) walk
    identical sweep schedules, and their weight tensors can share the
    dense transfer steps because their supports are disjoint slices.
    The one hazard: at an emission step, two members whose *in-window*
    original digits coincide would mix mass in the extraction slice —
    allowed only if their adjusted digits coincide too (then it is one
    merged emission); otherwise they are split into separate groups.
    """
    from collections import defaultdict

    by_key = defaultdict(list)
    for p in plans:
        ch = tuple(q for q in range(p.length) if p.orig[q] != p.adj[q])
        # Dual-SPD plans also key on the tape: members of one group share
        # its ratios and its dy half.
        by_key[(p.tape, p.length, ch)].append(p)

    groups = []
    for (_, l0, ch), members in by_key.items():
        _, _, s0s = _sweep_meta(l0, ch, k)
        placed: list[dict] = []
        for p in members:
            subs = [_emit_sub_ranks(p, s0, k, a) for s0 in s0s]
            for g in placed:
                if all(g["maps"][i].get(o_s, a_s) == a_s
                       for i, (o_s, a_s) in enumerate(subs)):
                    g["members"].append(p)
                    for i, (o_s, a_s) in enumerate(subs):
                        g["maps"][i][o_s] = a_s
                    break
            else:
                placed.append({
                    "members": [p],
                    "maps": [{o_s: a_s} for (o_s, a_s) in subs],
                })
        for g in placed:
            groups.append((l0, ch, tuple(g["members"])))
    return groups


# --- The sweep plan ------------------------------------------------------------

# Step kinds. IDENT to RSHIFT are `_apply_group`'s dense steps (the plain
# version walks them); RSHIFT_RUN is an RSHIFT whose dropped leading digit
# is revealed (its compact form differs); EMIT and INTERIOR are K5's
# emission items (`csrc/sweep_rule.cuh`).
IDENT, EXTEND, SHIFT, RIGHT, RSHIFT, RSHIFT_RUN, EMIT, INTERIOR = range(8)
# Fields of a K5 item row, in order (`csrc/sweep_rule.cuh:K5_*`).
ITEM_FIELDS = ("op", "start", "n", "dst", "src", "hi", "d", "lo", "span",
               "tab", "lev", "xn", "xd", "xlo", "kids", "seed",
               # multipliers of the item's divisors (`_magic`)
               "m_lo", "m_d", "m_ne", "m_xn", "m_hx", "m_xlo", "m_a", "m_pw1",
               # the item's tape: its offset into p and dy, into the levels
               "poff", "loff")


@dataclasses.dataclass(frozen=True)
class Step:
    """One step of a group's sweep: its dense form (what `_apply_group`
    and the plain version compute, over A^lev windows) and the compact
    layout K5 stores it in: window rank j = (h * span + ranks[i]) * lo +
    s at compact index c = (h * len(ranks) + i) * lo + s, for prefix h <
    hi and suffix s < lo. ``ranks`` are the live run ranks; every other
    window of the dense vector is an exact 0 for a finite p."""

    kind: int
    level: int  # dependency depth: 0 reads a seed
    lev: int  # the dense vector has A^lev windows
    src: int  # index of the source step, -1 for the seed
    seed: tuple = ()  # ((rank, sid), ...) by rank, member order kept
    seed_size: int = 0  # A^(length of the seed's ranks)
    hi: int = 1
    ranks: tuple = ()
    lo: int = 1
    span: int = 1
    kids: tuple = ()  # SHIFT, RSHIFT_RUN: source live indices of each i
    pairs: tuple = ()  # emission (orig, adj) run ranks; () emits nothing
    interior: tuple = ()  # INTERIOR: (rank, sid, sign) in member order
    tape: int = 0  # dual-SPD programs: the tape whose p and dy it uses

    @property
    def n(self) -> int:
        return self.hi * len(self.ranks) * self.lo

    def live(self) -> np.ndarray:
        """Dense window ranks of the compact vector, in compact order."""
        h = np.arange(self.hi)[:, None, None] * self.span
        r = np.asarray(self.ranks, dtype=np.int64)[None, :, None]
        return ((h + r) * self.lo + np.arange(self.lo)[None, None, :]
                ).reshape(-1)

    def targets(self) -> tuple[int, ...]:
        """Run ranks of the windows the emission reads and writes."""
        return tuple(sorted({o for o, _ in self.pairs}
                            | {x for _, x in self.pairs}))

    def target_windows(self) -> np.ndarray:
        if self.kind == INTERIOR:
            return np.unique([r for r, _, _ in self.interior])
        h = np.arange(self.hi)[:, None, None] * self.span
        e = np.asarray(self.targets(), dtype=np.int64)[None, :, None]
        return ((h + e) * self.lo + np.arange(self.lo)[None, None, :]
                ).reshape(-1)


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Every group's sweep, planned once a program: ``steps`` in plan
    order (group by group, each in `_apply_group`'s order), and K5's one
    launch: ``items`` (int64 rows, `ITEM_FIELDS`) grouped into phases
    (``phase_ptr``), each phase's items run side by side and a grid
    barrier between phases; ``table`` holds the items' int32 lists
    (ranks, children, seeds, emission targets, interior ops);
    ``work_size`` doubles hold every step's compact vector."""

    steps: tuple
    items: np.ndarray
    item_step: np.ndarray  # the step of each item
    phase_ptr: np.ndarray
    table: np.ndarray
    work_size: int
    max_phase: int  # elements of the largest phase
    num_groups: int

    @property
    def num_launches(self) -> int:
        """K5 launches an RHS: one."""
        return 1

    @property
    def num_phases(self) -> int:
        return len(self.phase_ptr) - 1

    @property
    def element_steps(self) -> tuple[int, int]:
        """(live, dense) elements over the sweep's steps: what K5 forms
        against what a dense step by step sweep forms."""
        steps = [s for s in self.steps if s.kind != INTERIOR]
        return (sum(s.n for s in steps), sum(s.hi * s.span * s.lo
                                             for s in steps))


def ratio_offsets(a: int, k: int) -> tuple[dict, int]:
    """Layout of the plain ratio tables: r_le[j] (A^j) at ``offsets[j]``
    for j = 1..k, then r_re (A^k) at ``offsets["re"]``; and its length."""
    offsets, pos = {}, 0
    for j in range(1, k + 1):
        offsets[j] = pos
        pos += a**j
    offsets["re"] = pos
    return offsets, pos + a**k


def _magic(d: int) -> int:
    """m = ceil(2^s / d), s = 31 + ceil(log2 d): x // d = (x * m) >> s
    for 0 <= x < 2^31 (`csrc/sweep_rule.cuh:K5Div`)."""
    s = 31 + (d - 1).bit_length()
    return -(-(1 << s) // d)


def _with_magic(row: list, a: int, k: int) -> list:
    """An item row with the multipliers of its divisors appended."""
    f = dict(zip(ITEM_FIELDS, row))
    lev = f["lev"]
    divisors = (f["lo"], f["d"], lev if f["op"] == EMIT else 1, f["xn"],
                f["xn"] // f["xd"] if f["xd"] > 0 else 1, f["xlo"], a,
                a ** (lev - 1) if 1 <= lev <= k else 1)
    return row + [_magic(max(x, 1)) for x in divisors]


def _ilog(x: int, a: int) -> int:
    e = 0
    while x > 1:
        x //= a
        e += 1
    return e


def _group_steps(l0: int, changed, members, a: int, k: int,
                 first_index: int) -> list[Step]:
    """One group's steps in `_apply_group`'s order, with their compact
    layouts; indices in ``src`` count from ``first_index``."""
    m_l, m_r, _ = _sweep_meta(l0, changed, k)
    base = min(l0, k)
    sids = [m.sid for m in members]
    tape = members[0].tape
    out: list[Step] = []

    def add(kind, lev, src, layout, kids=(), s0=None, seed=(),
            seed_size=0):
        hi, ranks, lo, span = layout
        pairs = ()
        if s0 is not None:
            pairs = tuple(sorted({_emit_sub_ranks(m, s0, k, a)
                                  for m in members}))
            q_lo = max(0, s0)
            run = min(l0 - 1, s0 + k - 1) - q_lo + 1
            assert (lo, span) == (a ** (k - (q_lo - s0) - run), a**run)
            assert tuple(sorted({o for o, _ in pairs})) == ranks
        level = 0 if src < 0 else out[src - first_index].level + 1
        out.append(Step(kind, level, lev, src, seed, seed_size, hi,
                        ranks, lo, span, kids, pairs, tape=tape))
        return first_index + len(out) - 1

    def seed(ranks, length):
        pairs = tuple(sorted(zip(ranks, sids), key=lambda x: x[0]))
        return pairs, (1, tuple(sorted(set(ranks))), 1, a**length)

    def layout(i):
        s = out[i - first_index]
        return s.hi, s.ranks, s.lo, s.span

    def shifted(lay):  # drop the trailing (run) digit, add a leading one
        hi, ranks, lo, span = lay
        new = tuple(sorted({r // a for r in ranks}))
        kids = tuple(tuple(i for i, r in enumerate(ranks) if r // a == x)
                     for x in new)
        return (hi * a, new, 1, span // a), kids

    def rshifted(lay):  # drop the leading digit, add a trailing one
        hi, ranks, lo, span = lay
        if hi > 1:
            return RSHIFT, (hi // a, ranks, lo * a, span), ()
        sub = span // a
        new = tuple(sorted({r % sub for r in ranks}))
        kids = tuple(tuple(i for i, r in enumerate(ranks) if r % sub == x)
                     for x in new)
        return RSHIFT_RUN, (1, new, lo * a, sub), kids

    if l0 > k:
        ops = []
        for j in range(1, l0 - k + 1):
            if any(j <= q <= j + k - 1 for q in changed):
                ops.extend((_rank(m.orig[j:j + k], a), m.sid, -1)
                           for m in members)
                ops.extend((_rank(m.adj[j:j + k], a), m.sid, 1)
                           for m in members)
        if ops:
            out.append(Step(INTERIOR, 0, k, -1, interior=tuple(ops),
                            tape=tape))
    if l0 <= k - 1:
        sd, sd_lay = seed([_rank(m.orig, a) for m in members], l0)
        cur, lay = -1, sd_lay
        for j in range(l0 + 1, k):
            hi, ranks, lo, span = lay
            lay = (hi * a, ranks, lo, span)
            cur = add(EXTEND, j, cur, lay,
                      **(dict(seed=sd, seed_size=a ** (j - 1))
                         if cur < 0 else {}))
        ctx, ctx_seed = cur, (sd, a ** (k - 1))
        ctx_lay = lay
        hi, ranks, lo, span = lay
        first = (EXTEND, (hi * a, ranks, lo, span), ctx,
                 ctx_seed if ctx < 0 else ((), 0))
    else:
        sd, sd_lay = seed([_rank(m.orig[:k], a) for m in members], k)
        first = (IDENT, sd_lay, -1, (sd, a**k))
        csd, ctx_lay = seed([_rank(m.orig[l0 - k + 1:], a)
                             for m in members], k - 1)
        ctx, ctx_seed = -1, (csd, a ** (k - 1))

    # Phase C: emit the length-k frame, then left-shift while changed.
    prev = None
    for m in range(0, m_l + 1):
        if m == 0:
            kind, lay, src, (sd, size) = first
            prev = add(kind, k, src, lay, s0=base - k, seed=sd,
                       seed_size=size)
        else:
            lay, kids = shifted(layout(prev))
            prev = add(SHIFT, k, prev, lay, kids=kids, s0=base - k - m)
    # Phase B: right-extend while a changed cell stays in context.
    for m in range(1, m_r + 1):
        if m == 1:
            hi, ranks, lo, span = ctx_lay
            sd, size = ctx_seed if ctx < 0 else ((), 0)
            prev = add(RIGHT, k, ctx, (hi, ranks, lo * a, span),
                       s0=l0 + m - k, seed=sd, seed_size=size)
        else:
            kind, lay, kids = rshifted(layout(prev))
            prev = add(kind, k, prev, lay, kids=kids, s0=l0 + m - k)
    return out


def _emission_pattern(s: Step, a: int):
    """What `_emissions_meet` reads of an emission: its tape, and an
    INTERIOR item's windows or an EMIT step's run (its digit position and
    length, lo, span and target ranks). An EMIT step's targets span every
    prefix and suffix (its dense vector holds all A^k windows), so its
    windows are exactly those whose run digits are a target rank."""
    if s.kind == INTERIOR:
        return s.tape, None, set(s.target_windows().tolist())
    return (s.tape, (_ilog(s.lo, a), _ilog(s.span, a), s.lo, s.span),
            s.targets())


def _emissions_meet(x1, x2, a: int) -> bool:
    """Whether two emissions (`_emission_pattern`s) read and write a
    common dy window: two of one tape where two of their target ranks
    agree on the digits their runs share."""
    if x1[0] != x2[0]:
        return False
    (_, r1, t1), (_, r2, t2) = x1, x2
    if r1 is None and r2 is None:
        return bool(t1 & t2)
    if r1 is None or r2 is None:
        if r2 is None:
            (r1, t1), (r2, t2) = (r2, t2), (r1, t1)
        _, _, lo, span = r2
        targets = set(t2)
        return any((j // lo) % span in targets for j in t1)
    # The digits both runs cover, [lo, hi) from the least significant.
    lo, hi = max(r1[0], r2[0]), min(r1[0] + r1[1], r2[0] + r2[1])
    if lo >= hi:
        return True
    return bool({(y // a ** (lo - r1[0])) % a ** (hi - lo) for y in t1}
                & {(y // a ** (lo - r2[0])) % a ** (hi - lo) for y in t2})


def _phases(steps, a: int) -> list[int]:
    """K5's phase of each step. A step that forms a vector runs in the
    phase of its level. Two emissions that share a dy window
    (`_emissions_meet`) run in different phases, so each window takes
    its terms in phase order, and each runs after its vector's phase
    (phase 0 also zeroes dy): a greedy colouring of the emissions'
    conflict graph, the most conflicted first, each in the first phase
    after its vector that no emission it meets holds."""
    phase = [0] * len(steps)
    emits = [i for i, s in enumerate(steps) if s.pairs or s.interior]
    pattern = {i: _emission_pattern(steps[i], a) for i in emits}
    meets = {i: set() for i in emits}
    for x, i in enumerate(emits):
        meets[i].update(i2 for i2 in emits[:x]
                        if _emissions_meet(pattern[i2], pattern[i], a))
    for i in emits:
        for i2 in meets[i]:
            meets[i2].add(i)
    placed = set()
    for i in sorted(emits, key=lambda i: (-len(meets[i]), steps[i].level,
                                          i)):
        taken = {phase[i2] for i2 in meets[i] if i2 in placed}
        p = steps[i].level + 1
        while p in taken:
            p += 1
        phase[i] = p
        placed.add(i)
    return phase


def sweep_plan(prog: DenseProgram) -> SweepPlan:
    """Every group's steps, their compact layouts and K5's items."""
    a, k = prog.size_a, prog.cl_k
    n = a**k
    if prog.state_size >= 2**31:
        raise ValueError(f"{prog.state_size} states: K5 indexes them in 31 "
                         "bits")
    low = low_size(prog) // (1 + prog.dual)  # a tape's block of the levels
    groups = _group_plans(prog.plans, a, k)
    steps: list[Step] = []
    for l0, changed, members in groups:
        steps.extend(_group_steps(l0, changed, members, a, k, len(steps)))
    phase = _phases(steps, a)

    table: list[int] = []
    dst, work = {}, 0
    rows = []  # (phase, step, row)

    def csr(lists):
        off = len(table)
        pos = off + len(lists) + 1
        for lst in lists:
            table.append(pos)
            pos += len(lst)
        table.append(pos)
        for lst in lists:
            table.extend(lst)
        return off

    for i, s in enumerate(steps):
        if s.kind == INTERIOR:
            tab = len(table)
            for op in s.interior:
                table.extend(op)
            rows.append((phase[i], i, [INTERIOR, 0, 1, 0, -1, 1, 0, 1, 1,
                                       tab, len(s.interior), 0, 0, 0, 0,
                                       0]))
            continue
        dst[i] = work
        work += s.n
        tab = len(table)
        table.extend(s.ranks)
        if s.src >= 0:
            x = steps[s.src]
            xn, xd, xlo, seed = x.n, len(x.ranks), x.lo, 0
        else:
            ranks = sorted({r for r, _ in s.seed})
            xn, xd, xlo = len(ranks), len(ranks), 1
            seed = csr([[sid for r, sid in s.seed if r == x]
                        for x in ranks])
        kids = csr(s.kids) if s.kids else 0
        rows.append((s.level, i, [s.kind, 0, s.n, dst[i],
                                  dst[s.src] if s.src >= 0 else -1, s.hi,
                                  len(s.ranks), s.lo, s.span, tab, s.lev,
                                  xn, xd, xlo, kids, seed]))
        if s.pairs:
            e = s.targets()
            adj = dict(s.pairs)
            tab = len(table)
            block = []
            for x in e:
                block.append([x, s.ranks.index(x) if x in adj else -1,
                              [ix for ix, r in enumerate(s.ranks)
                               if adj[r] == x]])
            pos = tab + 4 * len(e)
            for x, own, partners in block:
                table.extend([x, own, pos, len(partners)])
                pos += len(partners)
            for _, _, partners in block:
                table.extend(partners)
            rows.append((phase[i], i, [EMIT, 0, s.hi * len(e) * s.lo,
                                       dst[i], -1, s.hi, len(s.ranks), s.lo,
                                       s.span, tab, len(e), 0, 0, 0, 0, 0]))
    used = {p: q for q, p in enumerate(sorted({r[0] for r in rows} | {0}))}
    rows = [(used[p], i, row) for p, i, row in rows]  # no empty phase
    order = sorted(range(len(rows)), key=lambda q: rows[q][0])
    n_phases = len(used)
    items, item_step, phase_ptr, totals = [], [], [0], [0] * n_phases
    for q in order:
        p, i, row = rows[q]
        item_step.append(i)
        while len(phase_ptr) <= p:
            phase_ptr.append(len(items))
        row[1] = totals[p]
        totals[p] += row[2]
        tape = steps[i].tape
        items.append(_with_magic(row, a, k) + [tape * n, tape * low])
    while len(phase_ptr) <= n_phases:
        phase_ptr.append(len(items))
    if any(x >= 2**31 for x in table):
        raise ValueError("the sweep's table outgrows int32")
    return SweepPlan(
        steps=tuple(steps),
        items=np.asarray(items, dtype=np.int64).reshape(-1,
                                                        len(ITEM_FIELDS)),
        item_step=np.asarray(item_step, dtype=np.int64),
        phase_ptr=np.asarray(phase_ptr, dtype=np.int64),
        table=np.asarray(table, dtype=np.int32),
        work_size=work, max_phase=max(totals + [prog.state_size]),
        num_groups=len(groups),
    )


# --- K5's and K25's launch forms --------------------------------------------

LAUNCH_FORMS = ("grid", "block", "cluster")  # `csrc/dense_rhs.cu:kForm*`
WIDE_THREADS = 1024  # the block and cluster forms' threads a block
MAX_CLUSTER = 16  # blocks of a cluster (past 8 a non-portable size)
# The chooser's limits (`launch_form`), set by `time_jvp.py`'s timings
# on the H100: a block takes a launch whose largest phase
# (`launch_elements`, a warp's lanes for each signature in phase 0
# counted) is up to BLOCK_MOST elements; a cluster, at about
# ELEMENTS_A_THREAD elements a thread, a plan whose largest phase is up
# to CLUSTER_MOST (ex4 at cl_k 4, ex6-lite); past that the grid's
# threads win over its barriers (ex4 and ex4var2 at cl_k 5).
BLOCK_MOST = 8192
CLUSTER_MOST = 32_768
ELEMENTS_A_THREAD = 4


@dataclasses.dataclass(frozen=True)
class LaunchForm:
    """How K5 and K25 launch (`csrc/dense_rhs.cu:k5_launch`): ``kind``
    an index of `LAUNCH_FORMS`; the block form one block of
    `WIDE_THREADS`, its phases apart by ``__syncthreads``; the cluster
    form one thread-block cluster of ``blocks`` such blocks, apart by the
    cluster's hardware barrier; the grid form a cooperative launch that
    sizes itself (``blocks`` 0), apart by the grid's sync. In the block
    and cluster forms the launch also forms the levels below p (and v)
    as its leading phases, so an RHS or a J.v is one launch; the grid
    form runs K3 before it."""

    kind: int
    blocks: int = 0

    @property
    def fused_levels(self) -> bool:
        return self.kind != 0


def launch_elements(prog, plan) -> int:
    """Elements of a K5 launch's largest phase: the plan's (dy's zeroing
    counted), or a lane for each signature's pairs in phase 0."""
    return max(plan.max_phase, 32 * prog.num_signatures)


def launch_form(prog, plan) -> LaunchForm:
    """K5's and K25's form for a program, chosen once on the host by its
    largest phase: one block of 1,024 threads where `launch_elements`
    fits `BLOCK_MOST`, one cluster of up to `MAX_CLUSTER` blocks of
    1,024 (about `ELEMENTS_A_THREAD` elements a thread) where the plan's
    largest phase fits `CLUSTER_MOST`, else the cooperative grid."""
    most = launch_elements(prog, plan)
    if most <= BLOCK_MOST:
        return LaunchForm(1, 1)
    each = -(-plan.max_phase // ELEMENTS_A_THREAD)
    if plan.max_phase <= CLUSTER_MOST:
        return LaunchForm(2, min(MAX_CLUSTER,
                                 max(2, -(-each // WIDE_THREADS))))
    return LaunchForm(0)


def forms_for(dp) -> list:
    """The forms a program can take, for timing them side by side: the
    grid always; one block and a cluster of 16 up to 2^20 elements; the
    chosen form."""
    forms = [LaunchForm(0)]
    if launch_elements(dp.prog, dp.plan) <= 1 << 20:
        forms += [LaunchForm(1, 1), LaunchForm(2, MAX_CLUSTER)]
    chosen = launch_form(dp.prog, dp.plan)
    return forms + ([chosen] if chosen not in forms else [])


def form_name(form: LaunchForm) -> str:
    if form.kind == 0:
        return "grid"
    if form.kind == 1:
        return "block"
    return f"cluster of {form.blocks}"


def rhs_pyramid_launches(dp) -> int:
    """K3's launches in a `dense_rhs` call: none where K5's launch forms
    the levels, else K3's once a tape."""
    if dp.form.fused_levels:
        return 0
    return (1 + dp.prog.dual) * pyramid_launches(dp.prog.size_a,
                                                 dp.prog.cl_k)


@dataclasses.dataclass
class DeviceProgram:
    """A :class:`DenseProgram`, its sweep plan and its tables on one
    device: for K4 each signature's pairs in CSR order (pair order kept),
    each with its world's chain indices and w_const, and the same pairs
    as columns of world indices for its plain version; K5's items and
    table; a pruned program's mass tables for K9 (None otherwise); K5's
    and K25's launch form (`launch_form`)."""

    prog: DenseProgram
    plan: SweepPlan
    device: torch.device
    w_num: torch.Tensor
    w_den: torch.Tensor
    w_const: torch.Tensor
    csr_ptr: torch.Tensor  # [signatures + 1]
    pair_num: torch.Tensor  # [pairs, chain], CSR order
    pair_den: torch.Tensor
    pair_const: torch.Tensor  # [pairs]
    sig_pairs: torch.Tensor  # [most pairs of a signature, signatures]
    items: torch.Tensor
    phase_ptr: torch.Tensor
    table: torch.Tensor
    m_num: torch.Tensor | None = None  # [worlds, chain]
    m_den: torch.Tensor | None = None
    m_const: torch.Tensor | None = None  # [worlds]
    csr_world: torch.Tensor | None = None  # [pairs]: each pair's world
    # K5's and K25's launch form on a card (`launch_form`)
    form: LaunchForm | None = None
    # index tensors the plain dual sweep makes once (`_plain_tensors`)
    plain_cache: dict = dataclasses.field(default_factory=dict, repr=False)


def world_tables(prog, device: torch.device) -> dict:
    """K4's tables of a program (`DenseProgram` or
    `compile.CompiledProblem`) on ``device``: the worlds' chains, their
    pyramid indices as the kernels read them
    (`compile.two_pointer_index`), and each signature's pairs in CSR
    order (pair order kept), each with its world's chain and w_const,
    and as columns of world indices for the plain version."""
    order = np.argsort(prog.pair_sig, kind="stable")
    counts = np.bincount(prog.pair_sig, minlength=prog.num_signatures)
    csr_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    csr_world = prog.pair_world[order]
    # Column c: each signature's c-th world in pair order, num_worlds (a
    # weight of 0) past its last.
    rank = np.arange(len(order)) - csr_ptr[prog.pair_sig[order]]
    sig_pairs = np.full((max(counts.max(initial=0), 1), prog.num_signatures),
                        prog.num_worlds, dtype=np.int64)
    sig_pairs[rank, prog.pair_sig[order]] = csr_world
    w_num, w_den = (two_pointer_index(x, prog.size_a, prog.cl_k, prog.dual)
                    for x in (prog.w_num, prog.w_den))

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    i32, f64 = torch.int32, config.DEFAULT_FLOAT
    return dict(
        w_num=dev(w_num, i32), w_den=dev(w_den, i32),
        w_const=dev(prog.w_const, f64), csr_ptr=dev(csr_ptr, i32),
        pair_num=dev(w_num[csr_world], i32),
        pair_den=dev(w_den[csr_world], i32),
        pair_const=dev(prog.w_const[csr_world], f64),
        sig_pairs=dev(sig_pairs, torch.int64))


def device_program(prog: DenseProgram, device=None) -> DeviceProgram:
    """Plans ``prog``'s sweep and moves its tables to ``device``
    (``cuda`` unless named)."""
    device = config.get_device(device)
    plan = sweep_plan(prog)
    worlds = world_tables(prog, device)

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    mass = {}
    if prog.m_const is not None:
        mass = dict(
            m_num=dev(two_pointer_index(prog.m_num, prog.size_a, prog.cl_k,
                                        prog.dual), torch.int32),
            m_den=dev(two_pointer_index(prog.m_den, prog.size_a, prog.cl_k,
                                        prog.dual), torch.int32),
            m_const=dev(prog.m_const, config.DEFAULT_FLOAT))
    order = np.argsort(prog.pair_sig, kind="stable")
    return DeviceProgram(
        prog=prog, plan=plan, form=launch_form(prog, plan),
        device=worlds["w_const"].device,  # "cuda" -> "cuda:0"
        csr_world=dev(prog.pair_world[order], torch.int64),
        items=dev(plan.items, torch.int64),
        phase_ptr=dev(plan.phase_ptr, torch.int64),
        table=dev(plan.table, torch.int32), **worlds, **mass)


def _digit_sum_last(x: torch.Tensor, a: int) -> torch.Tensor:
    """``x.reshape(-1, a).sum(-1)``, summed in digit order."""
    x2 = x.reshape(-1, a)
    c = x2[:, 0].clone()
    for d in range(1, a):
        c += x2[:, d]
    return c


def _digit_sum_first(x: torch.Tensor, a: int) -> torch.Tensor:
    """``x.reshape(a, -1).sum(0)``, summed in digit order."""
    x2 = x.reshape(a, -1)
    c = x2[0].clone()
    for d in range(1, a):
        c += x2[d]
    return c


# --- K3: the pyramid -----------------------------------------------------------


def pyramid_tile_digits(a: int, k: int) -> int:
    """m: K3's first launch sums tiles of A^m entries of p, the largest
    power of A up to 8,192 doubles (at most k digits)."""
    m = 1
    while m < k and a ** (m + 1) <= 8192:
        m += 1
    return m


def pyramid_launches(a: int, k: int) -> int:
    """K3's launches: one when a tile holds all of p, else two."""
    return 1 if pyramid_tile_digits(a, k) == k else 2


def pyramid_plain(p: torch.Tensor, a: int, k: int) -> torch.Tensor:
    """Plain version of K3: the pyramid below p, ``[lv[k-1], ..., lv[0],
    1]`` (the flat pyramid less its level k, which is p), each level
    summed over its trailing digit in digit order."""
    pyramid_plain.calls += 1
    lv, cur = [], p
    for j in range(k - 1, -1, -1):
        cur = _digit_sum_last(cur, a)
        lv.append(cur)
    return torch.cat(lv + [torch.ones(1, dtype=p.dtype, device=p.device)])


pyramid_plain.calls = 0


def pyramid(p: torch.Tensor, a: int, k: int,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """K3: the pyramid below a float64 SPD vector ``p`` [A^k] (see
    `pyramid_plain`), into ``out`` (a new tensor when None); the kernel
    for a CUDA tensor (`pyramid_launches`), the plain version for a CPU
    one."""
    size = pyramid_offsets(a, k)[1] - a**k
    if not cuda.on_card(p, "pyramid"):
        low = pyramid_plain(p, a, k)
        return low if out is None else out.copy_(low)
    if p.dtype != torch.float64 or p.shape != (a**k,):
        raise TypeError(f"p must be a float64 [{a**k}] tensor")
    p = p.contiguous()
    low = (torch.empty(size, dtype=p.dtype, device=p.device) if out is None
           else _checked_out(out, size, p.device))
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_pyramid(p.data_ptr(), a, k, pyramid_tile_digits(a, k),
                              low.data_ptr(), cuda.stream(p))
    cuda.check(rc, "pyramid", lib)
    pyramid.launches += pyramid_launches(a, k)
    return low


pyramid.launches = 0


def low_size(prog) -> int:
    """Doubles of the levels below p that a program's kernels read: K3's
    output, one block a tape for a dual program."""
    a, k = prog.size_a, prog.cl_k
    return (1 + prog.dual) * (pyramid_offsets(a, k)[1] - a**k)


def pyramids(prog, p: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """K3 (its plain version when ``plain``) on each tape of the state
    ``p``: the levels below it, one block a tape (`low_size`)."""
    a, k, n = prog.size_a, prog.cl_k, prog.size_a**prog.cl_k
    if not prog.dual:
        return pyramid_plain(p, a, k) if plain else pyramid(p, a, k)
    if plain:
        return torch.cat([pyramid_plain(p[:n], a, k),
                          pyramid_plain(p[n:], a, k)])
    low = torch.empty(low_size(prog), dtype=p.dtype, device=p.device)
    half = low.numel() // 2
    for t in range(2):
        pyramid(p[t * n:(t + 1) * n], a, k, out=low[t * half:(t + 1) * half])
    return low


def levels(p: torch.Tensor, low: torch.Tensor, a: int, k: int) -> list:
    """lv[0..k] as views of p (level k) and the lower pyramid."""
    off, _ = pyramid_offsets(a, k)
    return [low[off[j] - a**k:off[j] - a**k + a**j] for j in range(k)] + [p]


def ratio_tables_plain(p: torch.Tensor, low: torch.Tensor, a: int, k: int):
    """The guarded ratio tables in `ratio_offsets`' layout, ``r_le[j] =
    g(lv[j], tile(lv[j-1], A))``, ``r_re = g(p, repeat(lv[k-1], A))``:
    the yardstick of K5's ratio rule, which forms them at the live
    windows from the pyramid."""
    lv = levels(p, low, a, k)
    tables = [guarded_ratio(lv[j], lv[j - 1].repeat(a))
              for j in range(1, k + 1)]
    tables.append(guarded_ratio(p, torch.repeat_interleave(lv[k - 1], a)))
    return torch.cat(tables)


# --- K4: signature weights -----------------------------------------------------


def signature_weights_plain(dp: DeviceProgram, p: torch.Tensor,
                            low: torch.Tensor, w_const=None):
    """Plain version of K4 (on the card K5's phase 0): ``s[sig] = sum over
    the pairs of sig of w_const[w] * prod_c g(pyr[w_num[w, c]],
    pyr[w_den[w, c]])``, the product in chain order, pyr = [p, low], the
    sum from 0 in pair order: a column of pairs at a time (`sig_pairs`),
    so on a card too, where an ``index_add_`` would add in no fixed
    order. ``w_const`` [worlds] replaces the program's where given."""
    signature_weights_plain.calls += 1
    pyr = torch.cat([p, low])
    g = guarded_ratio(pyr[dp.w_num.long()], pyr[dp.w_den.long()])
    prod = g[:, 0].clone()
    for c in range(1, g.shape[1]):
        prod = prod * g[:, c]
    wc = dp.w_const if w_const is None else w_const
    wv = torch.cat([wc * prod, prod.new_zeros(1)])
    s = torch.zeros(dp.sig_pairs.shape[1], dtype=p.dtype, device=p.device)
    for col in dp.sig_pairs:
        s = s + wv[col]
    return s


signature_weights_plain.calls = 0


def _check_pyramid(dp: DeviceProgram, p: torch.Tensor, low: torch.Tensor):
    prog = dp.prog
    n, m = prog.state_size, low_size(prog)
    if (p.dtype != torch.float64 or low.dtype != torch.float64
            or p.shape != (n,) or low.shape != (m,)):
        raise TypeError(f"p must be a float64 [{n}] tensor and low K3's "
                        f"float64 [{m}] output")
    if p.device != dp.device or low.device != dp.device:
        raise ValueError(f"p on {p.device}, low on {low.device}, the "
                         f"program on {dp.device}")
    return p.contiguous(), low.contiguous()


# --- K5: the sweep -------------------------------------------------------------


def ordered_add(out: torch.Tensor, idx, values: torch.Tensor
                ) -> torch.Tensor:
    """``out`` with ``values[q]`` added at ``idx[q]`` for q = 0, 1, ... in
    turn, each entry's terms in list order, as a new tensor on ``out``'s
    device: the CPU's ``index_add_`` (a loop in index order), or for a
    card's tensors, whose ``index_add_`` adds in no fixed order, numpy's
    unbuffered ``add.at`` on the host."""
    if out.device.type == "cpu":
        return out.clone().index_add_(
            0, torch.as_tensor(np.asarray(idx, dtype=np.int64)), values)
    acc = out.detach().cpu().numpy().copy()
    np.add.at(acc, np.asarray(idx, dtype=np.int64),
              values.detach().cpu().numpy())
    return torch.as_tensor(acc, device=out.device)


def _seed_dense(step: Step, s: torch.Tensor) -> torch.Tensor:
    """A step's seed as a dense one-hot sum over ``step.seed_size`` ranks,
    each from 0 in member order."""
    out = torch.zeros(step.seed_size, dtype=s.dtype, device=s.device)
    ranks = [r for r, _ in step.seed]
    sids = torch.as_tensor([x for _, x in step.seed], device=s.device)
    return ordered_add(out, ranks, s[sids])


def sweep_step_plain(step: Step, src: torch.Tensor, tables: dict,
                     a: int) -> torch.Tensor:
    """Plain version of one step's dense vector t (`_apply_group`'s):
    ``src`` is the dense previous vector (a seed made dense), ``tables``
    the ratio tables by name ("le", j) and "re"."""
    x = step_operand(step, src, a)
    return x if step.kind == IDENT else step_table(step, tables) * x


def step_operand(step: Step, src: torch.Tensor, a: int) -> torch.Tensor:
    """What a step multiplies by its ratio table, densely: the source
    tiled (EXTEND), repeated (RIGHT), or summed over a digit in digit
    order and then tiled (SHIFT) or repeated (RSHIFT, RSHIFT_RUN); the
    source itself for IDENT."""
    kind = step.kind
    if kind == IDENT:
        return src
    if kind == EXTEND:
        return src.repeat(a)
    if kind == SHIFT:
        return _digit_sum_last(src, a).repeat(a)
    if kind == RIGHT:
        return torch.repeat_interleave(src, a)
    if kind in (RSHIFT, RSHIFT_RUN):
        return torch.repeat_interleave(_digit_sum_first(src, a), a)
    raise ValueError(f"step kind {kind} forms no vector")


def step_table(step: Step, tables):
    """The ratio table a step multiplies by (``tables`` by name)."""
    if step.kind in (EXTEND, SHIFT):
        return tables["le", step.lev]
    return tables["re"]


def emit_plain(dy: torch.Tensor, t: torch.Tensor, lo: int, span: int,
               pairs) -> None:
    """Plain version of a step's +-emission, in place: ``dy`` loses t at
    every window whose run digits are an orig rank and gains it at the
    adjusted rank, as `_apply_group`'s sub-slice scatter does."""
    pairs = torch.as_tensor(pairs, device=dy.device).reshape(-1, 2)
    o, adj = pairs[:, 0], pairs[:, 1]
    d3 = dy.view(-1, span, lo)
    sub = t.view(-1, span, lo)[:, o, :]
    d3.index_add_(1, o, -sub)
    d3.index_add_(1, adj, sub)


def interior_plain(dy: torch.Tensor, s: torch.Tensor, ops) -> None:
    """Plain version of a group's interior emissions (l0 > k), in member
    order: each op (rank, signature id, sign) adds +-s[sid] at rank."""
    for rank, sid, sign in ops:
        dy[rank] += -s[sid] if sign < 0 else s[sid]


def named_tables(p, low, a, k) -> dict:
    rat = ratio_tables_plain(p, low, a, k)
    off, _ = ratio_offsets(a, k)
    tables = {("le", j): rat[off[j]:off[j] + a**j] for j in range(1, k + 1)}
    tables["re"] = rat[off["re"]:]
    return tables


def sweep_plain(dp: DeviceProgram, p: torch.Tensor, low: torch.Tensor,
                s: torch.Tensor, out: torch.Tensor | None = None):
    """Plain version of K5: every group's dense sweep into ``out`` (a new
    dy when None), walking K5's items in their order, so each dy window
    takes its terms in K5's (phase) order; a dual program's steps each
    on their tape's p, levels and dy half."""
    sweep_plain.calls += 1
    a, k = dp.prog.size_a, dp.prog.cl_k
    n, n_state = a**k, dp.prog.state_size
    dy = (torch.zeros(n_state, dtype=s.dtype, device=s.device)
          if out is None else _checked_out(out, n_state, s.device).zero_())
    tapes = 1 + dp.prog.dual
    m = low.numel() // tapes
    tables = [named_tables(p[t * n:(t + 1) * n], low[t * m:(t + 1) * m],
                           a, k) for t in range(tapes)]
    dys = [dy[t * n:(t + 1) * n] for t in range(tapes)]
    steps = dp.plan.steps
    # The vectors a later item still reads: the next steps and the emission.
    readers = collections.Counter(st.src for st in steps)
    readers.update(i for i, st in enumerate(steps) if st.pairs)
    vecs = {}

    def read(i):
        t = vecs[i]
        readers[i] -= 1
        if not readers[i]:
            del vecs[i]
        return t

    for op, i in zip(dp.plan.items[:, 0].tolist(),
                     dp.plan.item_step.tolist()):
        step = steps[i]
        if op == INTERIOR:
            interior_plain(dys[step.tape], s, step.interior)
        elif op == EMIT:
            emit_plain(dys[step.tape], read(i), step.lo, step.span,
                       step.pairs)
        else:
            src = read(step.src) if step.src >= 0 else _seed_dense(step, s)
            t = sweep_step_plain(step, src, tables[step.tape], a)
            if readers[i]:
                vecs[i] = t
    return dy


sweep_plain.calls = 0


def _checked_out(out: torch.Tensor, n: int, device) -> torch.Tensor:
    if (out.dtype != torch.float64 or out.shape != (n,)
            or out.device != device or not out.is_contiguous()):
        raise TypeError(f"out must be a contiguous float64 [{n}] tensor "
                        f"on {device}")
    return out


def _k5_args(dp, p, low, work, dy, s, pair_const=None, n_phases=None):
    """K5's arguments as `ckpe_dense_sweep` and `ckpe_dense_rhs` take
    them, less the stream: the plan (its first ``n_phases`` phases where
    given), the work buffer, dy, the pyramid, each signature's pairs with
    their worlds' chains, the signature weights ``s`` that phase 0
    writes, the program's launch form and the plan's sizes (items, table,
    work buffer) that decide what a block of the block and cluster forms
    copies into shared memory. The work buffer and ``s`` are a call's own
    (`_work`, `_weights_out`), so two calls on two streams do not share
    them."""
    prog, plan = dp.prog, dp.plan
    return (dp.items.data_ptr(), dp.phase_ptr.data_ptr(),
            plan.num_phases if n_phases is None else n_phases,
            plan.max_phase, dp.table.data_ptr(), work.data_ptr(),
            dy.data_ptr(), prog.state_size, p.data_ptr(), low.data_ptr(),
            dp.pair_num.data_ptr(), dp.pair_den.data_ptr(),
            (dp.pair_const if pair_const is None else pair_const).data_ptr(),
            prog.w_num.shape[1], dp.csr_ptr.data_ptr(), prog.num_signatures,
            s.data_ptr(), prog.size_a, prog.cl_k, dp.form.kind, dp.form.blocks,
            plan.items.shape[0], plan.table.size, plan.work_size)


def _k25_args(dp, p, low, v, vlow, work, jdy, dy, s, pair_const,
              n_phases=None):
    """K25's arguments as `ckpe_dense_jvp` takes them, less the stream:
    `_k5_args`' with jdy before dy and v, vlow after p, low."""
    a = _k5_args(dp, p, low, work, jdy, s, pair_const, n_phases)
    return (a[:7] + (None if dy is None else dy.data_ptr(),) + a[7:10]
            + (v.data_ptr(), vlow.data_ptr()) + a[10:])


def pair_consts(dp, w_const=None):
    """The pairs' w_const in CSR order as K4 reads them: the program's,
    or a run-time float64 ``w_const`` [worlds] on its device gathered (a
    torch gather, so a derivative can flow through it)."""
    if w_const is None:
        return dp.pair_const
    if (w_const.dtype != torch.float64 or w_const.device != dp.device
            or w_const.shape != (dp.prog.num_worlds,)):
        raise TypeError(f"w_const must be a float64 [{dp.prog.num_worlds}] "
                        f"tensor on {dp.device}")
    return w_const[dp.csr_world].contiguous()


def _work(dp, p):
    """K5's work buffer for one call (every step's compact vector), from
    the caching allocator on ``p``'s stream."""
    return torch.empty(max(dp.plan.work_size, 1), dtype=torch.float64,
                       device=p.device)


def _weights_out(dp, s):
    """Where K5's phase 0 writes the signature weights: ``s`` (checked),
    or a call's own tensor when None."""
    n_sig = dp.prog.num_signatures
    if s is None:
        return torch.empty(n_sig, dtype=torch.float64, device=dp.device)
    if (s.dtype != torch.float64 or s.shape != (n_sig,)
            or s.device != dp.device or not s.is_contiguous()):
        raise TypeError(f"s must be a contiguous float64 [{n_sig}] tensor "
                        f"on {dp.device}")
    return s


def sweep(dp: DeviceProgram, p: torch.Tensor, low: torch.Tensor,
          out: torch.Tensor | None = None, s: torch.Tensor | None = None):
    """K5: dp/dt [A^k] from p and the pyramid below it, into ``out`` (a
    new tensor when None), the signature weights formed first (phase 0,
    K4) and left in ``s`` when one is given; the kernel for CUDA tensors
    (one launch), the plain versions (`signature_weights_plain`,
    `sweep_plain`) for CPU ones."""
    if not cuda.on_card(p, "sweep"):
        w = signature_weights_plain(dp, p, low)
        if s is not None:
            s.copy_(w)
        return sweep_plain(dp, p, low, w, out)
    p, low = _check_pyramid(dp, p, low)
    n = dp.prog.state_size
    dy = (torch.empty(n, dtype=torch.float64, device=p.device)
          if out is None else _checked_out(out, n, p.device))
    work, s = _work(dp, p), _weights_out(dp, s)
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_dense_sweep(*_k5_args(dp, p, low, work, dy, s),
                                  cuda.stream(p))
    cuda.check(rc, "sweep", lib)
    sweep.launches += 1
    return dy


sweep.launches = 0


def bare_sweep(dp, p, low, dy, work, s, n_phases=None):
    """K5's launch alone in the program's form, into ``dy`` (K3's levels
    ``low`` made before; ``work`` and ``s`` the caller's, as `sweep`
    makes them), cut to the plan's first ``n_phases`` phases where given:
    a timing hook (`time_jvp.py`, `chip_smoke.py`), not counted."""
    lib = cuda.load()
    rc = lib.ckpe_dense_sweep(*_k5_args(dp, p, low, work, dy, s,
                                        n_phases=n_phases), cuda.stream(p))
    cuda.check(rc, "K5 alone", lib)


def bare_jvp(dp, p, low, v, vlow, jdy, work, s, n_phases=None):
    """K25's launch alone in the program's form, J v into ``jdy``, over
    the levels ``low`` and ``vlow`` made before (``work`` and ``s`` of
    pairs, as `dense_jvp` makes them), cut to the plan's first
    ``n_phases`` phases where given: a timing hook, not counted."""
    lib = cuda.load()
    rc = lib.ckpe_dense_jvp(*_k25_args(dp, p, low, v, vlow, work, jdy, None,
                                       s, dp.pair_const, n_phases),
                            cuda.stream(p))
    cuda.check(rc, "K25 alone", lib)


# --- K9: the world mass --------------------------------------------------------

# Scratch of one K9 launch, in doubles: 1,024 blocks' partials and the
# ticket (`csrc/world_mass.cu:ckpe_world_mass`).
_MASS_PARTIALS = 1024


def mass_scratch(device) -> torch.Tensor:
    """Scratch for `world_mass` on ``device``, its ticket 0: one for a
    `make_dense_dy_dt` closure, reused by each of its calls (calls on two
    streams at once need two)."""
    return torch.zeros(_MASS_PARTIALS + 1, dtype=torch.float64,
                       device=device)


def world_mass_plain(dp: DeviceProgram, p: torch.Tensor,
                     low: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: ``sum over the enumerated worlds w of
    m_const[w] * prod_c g(pyr[m_num[w, c]], pyr[m_den[w, c]])``, the
    product in chain order (K4's world weight), pyr = [p, low], the sum in
    K9's order (`cuda.block_order_sum`); a 0-d float64 tensor."""
    world_mass_plain.calls += 1
    pyr = torch.cat([p, low])
    g = guarded_ratio(pyr[dp.m_num.long()], pyr[dp.m_den.long()])
    prod = g[:, 0].clone()
    for c in range(1, g.shape[1]):
        prod = prod * g[:, c]
    return cuda.block_order_sum(dp.m_const * prod)


world_mass_plain.calls = 0


def world_mass(dp: DeviceProgram, p: torch.Tensor, low: torch.Tensor,
               scratch: torch.Tensor | None = None) -> torch.Tensor:
    """K9: the mass of a pruned program's enumerated worlds under p (see
    `world_mass_plain`), from p and the pyramid below it (K3's ``low``):
    a new 0-d float64 tensor on p's device, no host sync; the kernel for
    CUDA tensors (one launch, its partials and ticket in ``scratch``:
    `mass_scratch`, a new one when None), the plain version for CPU
    ones."""
    if dp.m_const is None:
        raise ValueError(
            "Program has no mass tables; compile with prune_threshold>0.")
    if not cuda.on_card(p, "world_mass"):
        return world_mass_plain(dp, p, low)
    p, low = _check_pyramid(dp, p, low)
    if not dp.m_const.numel():  # every path pruned: no world, no mass
        return torch.zeros((), dtype=torch.float64, device=p.device)
    if scratch is None:
        scratch = mass_scratch(p.device)
    elif (scratch.dtype != torch.float64 or scratch.device != p.device
          or scratch.shape != (_MASS_PARTIALS + 1,)):
        raise TypeError(f"world_mass: scratch must be a float64 "
                        f"[{_MASS_PARTIALS + 1}] tensor on {p.device}")
    out = torch.empty((), dtype=torch.float64, device=p.device)
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_world_mass(
            p.data_ptr(), low.data_ptr(), p.numel(), low.numel(),
            dp.m_num.data_ptr(), dp.m_den.data_ptr(), dp.m_const.data_ptr(),
            dp.m_num.shape[1], dp.m_num.shape[0], scratch.data_ptr(),
            out.data_ptr(), cuda.stream(p))
    cuda.check(rc, "world_mass", lib)
    world_mass.launches += 1
    return out


world_mass.launches = 0


# --- K25: J.v -------------------------------------------------------------------

# What is not ported of the derivatives, by ROADMAP Queue 1 title: the
# tree and chain engines' J.v and v^T J (slice (b) of the reverse mode),
# and second derivatives (a backward through K30's backward, or through
# a solver's adjoint) with the derivatives of the world mass (K9,
# `make_dense_dy_dt(with_mass=True)`): `utils/autodiff.SECOND_ORDER`.
REVERSE_MODE = ("ROADMAP Queue 1, 'Derivative-based solvers and instruments: "
                "reverse mode', slice (b): the tree and chain engines")


def guarded_ratio_dual(num, den, dnum, dden):
    """The guarded ratio g(n, d) = n > 0 ? n / m : 0 (m = max(n, d)) and
    its tangent as K25 forms it (`csrc/sweep_rule.cuh:k5_guarded` on pairs): 0
    where n <= 0 (one-sided), dm = dd where d > n, dn where n > d and
    0.5 (dn + dd) at a tie (the max's tangent split as JAX's max rule
    splits it), dg = (dn - g dm) / m, exactly 0 where n > d."""
    g = guarded_ratio(num, den)
    pos = num > 0
    one = torch.ones((), dtype=num.dtype, device=num.device)
    m = torch.where(pos, torch.maximum(num, den), one)
    dm = torch.where(den > num, dden,
                     torch.where(num > den, dnum, 0.5 * (dnum + dden)))
    dg = torch.where(pos, (dnum - g * dm) / m, torch.zeros_like(g))
    return g, dg


def signature_weights_dual_plain(dp: DeviceProgram, p, low, v, vlow,
                                 w_const=None):
    """K4 in dual numbers (K25's phase 0): the signature weights and their
    tangents along v, each chain's guarded ratios multiplied in pairs in
    chain order (``(P, dP) (g, dg) = (P g, dP g + P dg)``), times w_const,
    summed from 0 in pair order as `signature_weights_plain`."""
    pyr, dpyr = torch.cat([p, low]), torch.cat([v, vlow])
    num, den = dp.w_num.long(), dp.w_den.long()
    g, dg = guarded_ratio_dual(pyr[num], pyr[den], dpyr[num], dpyr[den])
    prod, dprod = g[:, 0].clone(), dg[:, 0].clone()
    for c in range(1, g.shape[1]):
        dprod = dprod * g[:, c] + prod * dg[:, c]
        prod = prod * g[:, c]
    wc = dp.w_const if w_const is None else w_const
    zero = prod.new_zeros(1)
    wv, dwv = torch.cat([wc * prod, zero]), torch.cat([wc * dprod, zero])
    s = torch.zeros(dp.sig_pairs.shape[1], dtype=p.dtype, device=p.device)
    ds = torch.zeros_like(s)
    for col in dp.sig_pairs:
        s = s + wv[col]
        ds = ds + dwv[col]
    return s, ds


def _dual_step(step: Step, src: torch.Tensor, tables, a: int):
    """`sweep_step_plain` in dual numbers: ``src`` the [2, N] stack of a
    vector's values and tangents, each table a (value, tangent) pair;
    every product ``r * x`` is (r x, dr x + r dx), K25's order
    (`csrc/sweep_rule.cuh:k5_mul` on pairs). Digit sums run on the stack, each row
    in digit order."""
    kind = step.kind
    if kind == IDENT:
        return src
    if kind == EXTEND:
        x, r = src.repeat(1, a), tables["le", step.lev]
    elif kind == SHIFT:
        x, r = _digit_sum_last2(src, a).repeat(1, a), tables["le", step.lev]
    elif kind == RIGHT:
        x, r = torch.repeat_interleave(src, a, dim=1), tables["re"]
    elif kind in (RSHIFT, RSHIFT_RUN):
        x = torch.repeat_interleave(_digit_sum_first2(src, a), a, dim=1)
        r = tables["re"]
    else:
        raise ValueError(f"step kind {kind} forms no vector")
    r, dr = r
    rx = x * r  # [r x, r dx]
    return torch.stack([rx[0], dr * x[0] + rx[1]])


def _digit_sum_last2(x: torch.Tensor, a: int) -> torch.Tensor:
    x3 = x.reshape(2, -1, a)
    c = x3[:, :, 0].clone()
    for d in range(1, a):
        c += x3[:, :, d]
    return c


def _digit_sum_first2(x: torch.Tensor, a: int) -> torch.Tensor:
    x3 = x.reshape(2, a, -1)
    c = x3[:, 0].clone()
    for d in range(1, a):
        c += x3[:, d]
    return c


def _dual_tables(p, low, v, vlow, a: int, k: int) -> dict:
    """The ratio tables of `named_tables` with their tangents."""
    lv, dlv = levels(p, low, a, k), levels(v, vlow, a, k)
    tables = {("le", j): guarded_ratio_dual(
        lv[j], lv[j - 1].repeat(a), dlv[j], dlv[j - 1].repeat(a))
        for j in range(1, k + 1)}
    tables["re"] = guarded_ratio_dual(
        p, torch.repeat_interleave(lv[k - 1], a), v,
        torch.repeat_interleave(dlv[k - 1], a))
    return tables


def _plain_tensors(dp: DeviceProgram, i: int):
    """Step i's index tensors for the plain dual sweep, made once a
    program: its seed's ranks and signature ids, its emission's orig and
    adjusted run ranks."""
    cache = dp.plain_cache
    if i not in cache:
        step, dev = dp.plan.steps[i], dp.device
        seed = [torch.as_tensor([x[q] for x in step.seed], device=dev,
                                dtype=torch.int64) for q in (0, 1)]
        pairs = torch.as_tensor(step.pairs, device=dev,
                                dtype=torch.int64).reshape(-1, 2)
        cache[i] = (seed, pairs[:, 0], pairs[:, 1])
    return cache[i]


def dense_jvp_plain(dp: DeviceProgram, p: torch.Tensor, v: torch.Tensor,
                    low: torch.Tensor | None = None, w_const=None,
                    value: bool = False):
    """Plain version of K25: J v, the tangent of dp/dt at ``p`` along
    ``v``, as its own dual-number sweep in K25's order: K3's plain levels
    of p (``low`` where given) and of v, K4 in pairs
    (`signature_weights_dual_plain`), then `sweep_plain`'s walk of the
    plan's items with every dense vector a [2, N] stack of values and
    tangents (`_dual_step`), the emissions and interior ops into a zeroed
    stack of dy and its tangent (`emit_plain`'s scatter on both rows: the
    same terms in the same order). Not torch's forward AD through
    `sweep_plain`, whose in-place ``index_add_`` and ``out=`` writes are
    not known to carry tangents. ``value=True`` returns ``(dy, J v)``, dy
    from the values (`sweep_plain`'s bits)."""
    dense_jvp_plain.calls += 1
    prog = dp.prog
    a, k = prog.size_a, prog.cl_k
    n = a**k
    p, v = p.reshape(-1), v.reshape(-1)
    if low is None:
        low = pyramids(prog, p, plain=True)
    vlow = pyramids(prog, v, plain=True)
    s2 = torch.stack(signature_weights_dual_plain(dp, p, low, v, vlow,
                                                  w_const))
    tapes = 1 + prog.dual
    m = low.numel() // tapes
    tables = [_dual_tables(p[t * n:(t + 1) * n], low[t * m:(t + 1) * m],
                           v[t * n:(t + 1) * n], vlow[t * m:(t + 1) * m],
                           a, k) for t in range(tapes)]
    dy2 = torch.zeros((2, prog.state_size), dtype=p.dtype, device=p.device)
    steps = dp.plan.steps
    readers = collections.Counter(st.src for st in steps)
    readers.update(i for i, st in enumerate(steps) if st.pairs)
    vecs = {}

    def read(i):
        t = vecs[i]
        readers[i] -= 1
        if not readers[i]:
            del vecs[i]
        return t

    for op, i in zip(dp.plan.items[:, 0].tolist(),
                     dp.plan.item_step.tolist()):
        step = steps[i]
        d2 = dy2[:, step.tape * n:(step.tape + 1) * n]
        if op == INTERIOR:
            for rank, sid, sign in step.interior:
                d2[:, rank] += -s2[:, sid] if sign < 0 else s2[:, sid]
        elif op == EMIT:
            _, o, adj = _plain_tensors(dp, i)
            d4 = d2.view(2, -1, step.span, step.lo)
            sub = read(i).view(2, -1, step.span, step.lo)[:, :, o, :]
            d4.index_add_(2, o, -sub)
            d4.index_add_(2, adj, sub)
        else:
            if step.src >= 0:
                src = read(step.src)
            else:
                (ranks, sids), _, _ = _plain_tensors(dp, i)
                src = torch.zeros((2, step.seed_size), dtype=p.dtype,
                                  device=p.device).index_add_(
                                      1, ranks, s2[:, sids])
            t = _dual_step(step, src, tables[step.tape], a)
            if readers[i]:
                vecs[i] = t
    return (dy2[0], dy2[1]) if value else dy2[1]


dense_jvp_plain.calls = 0


def dense_jvp(dp: DeviceProgram, p: torch.Tensor, v: torch.Tensor,
              low: torch.Tensor | None = None, w_const=None,
              value: bool = False):
    """K25: J v, the tangent of dp/dt at the float64 state ``p`` along
    ``v`` (a new tensor), with ``low`` K3's levels of p (made by the call
    when None) and ``w_const`` [worlds] a run-time weight vector in place
    of the program's. On a card one C call (`ckpe_dense_jvp_rhs`) in the
    program's form (`launch_form`): in the block and cluster forms one
    K25 launch whose leading phases form the levels of v (and of p when
    ``low`` is None); in the grid form K3 on p when ``low`` is None, K3
    on each tape of v, then K25's cooperative launch. On the CPU
    `dense_jvp_plain`. ``value=True`` returns ``(dy, J v)``: K25 writes
    dp/dt too (K5's bits), so one launch serves the forward-mode dual
    call."""
    if not cuda.on_card(p, "dense_jvp"):
        return dense_jvp_plain(dp, p, v, low, w_const, value)
    prog = dp.prog
    a, k, n = prog.size_a, prog.cl_k, prog.state_size
    tapes = 1 + prog.dual
    fused = dp.form.fused_levels
    levels_p = low is None and fused
    if low is None:
        low = (torch.empty(low_size(prog), dtype=torch.float64,
                           device=p.device) if fused
               else pyramids(prog, p.reshape(-1)))
    p, low = _check_pyramid(dp, p.reshape(-1), low)
    v = v.reshape(-1)
    if v.dtype != torch.float64 or v.shape != (n,) or v.device != p.device:
        raise TypeError(f"v must be a float64 [{n}] tensor on {p.device}")
    v = v.contiguous()
    vlow = torch.empty(low_size(prog), dtype=torch.float64, device=p.device)
    jdy = torch.empty(n, dtype=torch.float64, device=p.device)
    dy = torch.empty_like(jdy) if value else None
    work = torch.empty(2 * max(dp.plan.work_size, 1), dtype=torch.float64,
                       device=p.device)
    s = torch.empty(2 * prog.num_signatures, dtype=torch.float64,
                    device=p.device)
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_dense_jvp_rhs(
            tapes, pyramid_tile_digits(a, k), int(levels_p),
            *_k25_args(dp, p, low, v, vlow, work, jdy, dy, s,
                       pair_consts(dp, w_const)), cuda.stream(p))
    cuda.check(rc, "dense_jvp", lib)
    if not fused:
        pyramid.launches += tapes * pyramid_launches(a, k)
    dense_jvp.launches += 1
    return (dy, jdy) if value else jdy


dense_jvp.launches = 0


# --- K30: v^T J -----------------------------------------------------------------

# Fields of a K30 reverse item row (`csrc/sweep_rule.cuh:RV_*`): an item
# forms the cotangent of one step's compact vector (or of the seed a
# first step reads), then up to `MAX_READERS` reader blocks of
# `READER_FIELDS` each.
RV_FIELDS = ("start", "n", "out", "seed", "ident", "hi", "d", "lo", "span",
             "ranks", "adj", "poff", "readers")
READER_FIELDS = ("kind", "dst", "p1", "p2", "p3", "parent")
MAX_READERS = 2
STEP_FIELDS = ("dst", "hi", "d", "lo", "span", "ranks")
MAX_CHAIN = 32  # `csrc/sweep_rule.cuh:kK30MaxChain`


@dataclasses.dataclass(frozen=True)
class VjpPlan:
    """K30's plan, made once a program on the host beside the sweep plan
    (`vjp_plan`): the sweep's compute items by level (K5's rows, restarted
    a phase), the reverse items (`RV_FIELDS`) in phases of descending
    level and then the seeds, and the gather lists that turn the sweep's
    scatter into sums each formed by one thread in plan order: each
    ratio table's steps (``tab_ptr``, ``tab_steps``, over `STEP_FIELDS`
    rows ``steps``), each signature's terms (indices into ``[seed
    cotangents, u, -u]``), each world's signatures (pair order), and the
    world chains' pyramid terms sorted by pyramid entry (``wt_pyr``,
    ``wt_q``: indices into the partials, `vjp_partials`). ``table`` is
    K5's with each emitting step's adjusted ranks and each SHIFT's and
    RSHIFT_RUN's parents appended. ``readers`` lists each step's readers
    in plan order, ``xs_off`` the seed cotangent's offset of each step
    that reads a seed."""

    fwd_items: np.ndarray
    fwd_ptr: np.ndarray
    rv_items: np.ndarray
    rv_ptr: np.ndarray
    table: np.ndarray
    steps: np.ndarray
    tab_ptr: np.ndarray
    tab_steps: np.ndarray
    sig_ptr: np.ndarray
    sig_terms: np.ndarray
    world_ptr: np.ndarray
    world_sigs: np.ndarray
    wt_pyr: np.ndarray
    wt_q: np.ndarray
    n_xs: int
    rat_len: int
    max_phase: int
    readers: tuple
    xs_off: dict

    ARRAYS = ("fwd_items", "fwd_ptr", "rv_items", "rv_ptr", "table", "steps",
              "tab_ptr", "tab_steps", "sig_ptr", "sig_terms", "world_ptr",
              "world_sigs", "wt_pyr", "wt_q")

    @property
    def nbytes(self) -> int:
        """Bytes of the plan's arrays (what K30 reads besides p)."""
        return sum(getattr(self, name).nbytes for name in self.ARRAYS)


def vjp_partials(prog) -> int:
    """Doubles of K30's partials buffer: two a ratio-table entry (the
    cotangent times dg/dn, and times dg/dd) on each tape, then two a
    world chain factor."""
    _, rat_len = ratio_offsets(prog.size_a, prog.cl_k)
    return 2 * ((1 + prog.dual) * rat_len + prog.w_num.size)


def _table_slot(step: Step, k: int) -> int:
    """A step's ratio table: lev - 1 for the left tables, k for r_re."""
    return step.lev - 1 if step.kind in (EXTEND, SHIFT) else k


def vjp_plan(prog: DenseProgram, plan: SweepPlan | None = None) -> VjpPlan:
    """K30's plan for ``prog`` (its sweep plan made when not given)."""
    plan = sweep_plan(prog) if plan is None else plan
    a, k = prog.size_a, prog.cl_k
    n = a**k
    tapes = 1 + prog.dual
    steps = plan.steps
    if prog.w_num.shape[1] > MAX_CHAIN:
        raise ValueError(f"chains of {prog.w_num.shape[1]} factors: K30 "
                         f"takes up to {MAX_CHAIN}")
    compute = [(row, i) for row, i in zip(plan.items.tolist(),
                                          plan.item_step.tolist())
               if row[0] not in (EMIT, INTERIOR)]
    dst = {i: row[ITEM_FIELDS.index("dst")] for row, i in compute}
    tab = {i: row[ITEM_FIELDS.index("tab")] for row, i in compute}
    table = plan.table.tolist()

    def phased(rows, phase_of, col):
        """Rows grouped into phases (stable), each phase's elements
        counted from 0: column ``col`` a row's start, ``col + 1`` its
        elements."""
        order = sorted(range(len(rows)), key=lambda q: phase_of[q])
        ptr, out, total = [0], [], {}
        for q in order:
            p = phase_of[q]
            while len(ptr) <= p:
                ptr.append(len(out))
            row = list(rows[q])
            row[col] = total.get(p, 0)
            total[p] = row[col] + row[col + 1]
            out.append(row)
        ptr.append(len(out))
        return out, ptr, max(total.values(), default=0)

    levels = 1 + max((s.level for s in steps if s.kind != INTERIOR),
                     default=-1)
    fwd_rows, fwd_ptr, fwd_most = phased(
        [row for row, _ in compute], [steps[i].level for _, i in compute],
        ITEM_FIELDS.index("start"))

    readers = [[] for _ in steps]
    for j, s in enumerate(steps):
        if s.kind != INTERIOR and s.src >= 0:
            readers[s.src].append(j)
    if any(len(r) > MAX_READERS for r in readers):
        raise ValueError(f"a step with more than {MAX_READERS} readers")

    def reader_block(src_layout, j):
        hi, ranks, lo, n_src = src_layout
        s = steps[j]
        p1 = p2 = p3 = 0
        parent = -1
        if s.kind == EXTEND:
            p1 = n_src
        elif s.kind == SHIFT:
            assert lo == 1, "a SHIFT reads a source with lo 1"
            p1, p2, p3 = len(ranks), hi, len(s.ranks)
            parent = len(table)
            table.extend(s.ranks.index(r // a) for r in ranks)
        elif s.kind == RSHIFT:
            assert hi > 1 and n_src % a == 0
            p1 = n_src // a
        elif s.kind == RSHIFT_RUN:
            assert hi == 1, "an RSHIFT_RUN reads a source with hi 1"
            p1 = lo
            sub = s.span
            parent = len(table)
            table.extend(s.ranks.index(r % sub) for r in ranks)
        return [s.kind, dst[j], p1, p2, p3, parent]

    def rv_row(n_el, out, seed, ident, layout, ranks_tab, adj, poff, rd):
        hi, ranks, lo, span = layout
        blocks = [reader_block((hi, ranks, lo, n_el), j) for j in rd]
        blocks += [[0] * len(READER_FIELDS)] * (MAX_READERS - len(rd))
        return ([0, n_el, out, seed, ident, hi, len(ranks), lo, span,
                 ranks_tab, adj, poff, len(rd)]
                + [x for b in blocks for x in b])

    rv, rv_phase, xs_off, n_xs = [], [], {}, 0
    for i, s in enumerate(steps):
        if s.kind == INTERIOR:
            continue
        adj = -1
        if s.pairs:
            adj = len(table)
            to = dict(s.pairs)
            table.extend(to[r] for r in s.ranks)
        rv.append(rv_row(s.n, dst[i], 0, int(s.kind == IDENT),
                         (s.hi, s.ranks, s.lo, s.span), tab[i], adj,
                         s.tape * n, readers[i]))
        rv_phase.append(levels - 1 - s.level)
        if s.src < 0:
            ranks = tuple(sorted({r for r, _ in s.seed}))
            xs_off[i] = n_xs
            rv.append(rv_row(len(ranks), n_xs, 1, 0,
                             (1, ranks, 1, s.seed_size), -1, -1, 0, [i]))
            rv_phase.append(levels)
            n_xs += len(ranks)
    rv_rows, rv_ptr, rv_most = phased(rv, rv_phase, 0)

    # Each ratio table's steps, in plan order.
    slots = [[] for _ in range(tapes * (k + 1))]
    info = np.zeros((len(steps), len(STEP_FIELDS)), dtype=np.int64)
    for i, s in enumerate(steps):
        if s.kind in (INTERIOR, IDENT):
            continue
        info[i] = (dst[i], s.hi, len(s.ranks), s.lo, s.span, tab[i])
        slots[s.tape * (k + 1) + _table_slot(s, k)].append(i)

    # Each signature's terms in plan order: the interior ops' +-u and the
    # seed cotangents of the seeds it sits in.
    sig_terms = [[] for _ in range(prog.num_signatures)]
    n_state = prog.state_size
    for i, s in enumerate(steps):
        if s.kind == INTERIOR:
            for rank, sid, sign in s.interior:
                x = s.tape * n + rank
                sig_terms[sid].append(n_xs + x if sign > 0
                                      else n_xs + n_state + x)
        elif s.src < 0:
            ranks = sorted({r for r, _ in s.seed})
            for r, sid in s.seed:
                sig_terms[sid].append(xs_off[i] + ranks.index(r))

    worlds = [[] for _ in range(prog.num_worlds)]
    for w, sig in zip(prog.pair_world.tolist(), prog.pair_sig.tolist()):
        worlds[w].append(sig)

    # The world chains' pyramid terms (the constant 1 left out), by entry.
    _, rat_len = ratio_offsets(a, k)
    base = 2 * tapes * rat_len
    chain = prog.w_num.shape[1]
    low_block = pyramid_offsets(a, k)[1] - n
    terms = []
    for name, side in (("w_num", 0), ("w_den", 1)):
        idx = two_pointer_index(getattr(prog, name), a, k, prog.dual)
        for w in range(prog.num_worlds):
            for c in range(chain):
                y = int(idx[w, c])
                if y >= n_state and (y - n_state) % low_block == low_block - 1:
                    continue
                terms.append((y, base + 2 * (w * chain + c) + side))
    terms.sort()

    def csr(lists):
        ptr = np.zeros(len(lists) + 1, dtype=np.int32)
        ptr[1:] = np.cumsum([len(x) for x in lists])
        flat = np.asarray([x for lst in lists for x in lst], dtype=np.int32)
        return ptr, flat

    tab_ptr, tab_steps = csr(slots)
    sig_ptr, sig_terms = csr(sig_terms)
    world_ptr, world_sigs = csr(worlds)
    if max(table, default=0) >= 2**31 or base + 2 * prog.w_num.size >= 2**31:
        raise ValueError("K30's tables outgrow int32")
    pyr_size = n_state + tapes * low_block
    return VjpPlan(
        fwd_items=np.asarray(fwd_rows, dtype=np.int64).reshape(
            -1, len(ITEM_FIELDS)),
        fwd_ptr=np.asarray(fwd_ptr, dtype=np.int64),
        rv_items=np.asarray(rv_rows, dtype=np.int64).reshape(
            -1, len(RV_FIELDS) + MAX_READERS * len(READER_FIELDS)),
        rv_ptr=np.asarray(rv_ptr, dtype=np.int64),
        table=np.asarray(table, dtype=np.int32), steps=info,
        tab_ptr=tab_ptr, tab_steps=tab_steps, sig_ptr=sig_ptr,
        sig_terms=sig_terms, world_ptr=world_ptr, world_sigs=world_sigs,
        wt_pyr=np.asarray([y for y, _ in terms], dtype=np.int32),
        wt_q=np.asarray([q for _, q in terms], dtype=np.int32),
        n_xs=n_xs, rat_len=rat_len,
        max_phase=max(fwd_most, rv_most, tapes * rat_len, pyr_size,
                      32 * prog.num_signatures, prog.num_worlds),
        readers=tuple(tuple(r) for r in readers), xs_off=xs_off)


def vjp_tables(dp: DeviceProgram) -> dict:
    """K30's plan (`vjp_plan`) and its arrays on the program's device,
    made once a program (kept in ``dp.plain_cache``)."""
    cache = dp.plain_cache
    if "vjp" not in cache:
        vp = vjp_plan(dp.prog, dp.plan)
        tensors = {
            name: torch.as_tensor(
                np.ascontiguousarray(getattr(vp, name)), device=dp.device,
                dtype=torch.int64 if getattr(vp, name).dtype == np.int64
                else torch.int32)
            for name in VjpPlan.ARRAYS}
        cache["vjp"] = dict(plan=vp, **tensors)
    return cache["vjp"]


def guarded_ratio_partials(num, den):
    """The guarded ratio's partials (dg/dn, dg/dd), in the form K30 takes
    them (`csrc/sweep_rule.cuh:k30_partials`): with m = max(n, d), g =
    n / m and dm/dn = 1 where n > d, 0 where d > n and 0.5 at a tie (JAX's
    max rule), dm/dd = 1 - dm/dn: dg/dn = (1 - g dm/dn) / m and dg/dd =
    -(g dm/dd) / m where n > 0, exactly 0 where n <= 0 (no NaN at a zero
    context: the JAX package's double-where form)."""
    pos = num > 0
    one = torch.ones((), dtype=num.dtype, device=num.device)
    m = torch.where(pos, torch.maximum(num, den), one)
    g = guarded_ratio(num, den)
    half = torch.full((), 0.5, dtype=num.dtype, device=num.device)
    dmn = torch.where(num > den, one, torch.where(den > num, 0.0 * one,
                                                  half))
    dmd = one - dmn
    zero = torch.zeros((), dtype=num.dtype, device=num.device)
    return (torch.where(pos, (one - g * dmn) / m, zero),
            torch.where(pos, -(g * dmd) / m, zero))


def _transpose_add(acc: torch.Tensor, step: Step, cot: torch.Tensor,
                   a: int) -> torch.Tensor:
    """``acc`` (a source vector's cotangent, dense) plus the transpose of
    `step_operand` applied to ``cot`` (the reader's cotangent times its
    ratio), one copy of the A a source entry feeds at a time, in digit
    order: the terms K30 adds for each source element, in its order."""
    if step.kind == IDENT:
        return acc + cot
    m = acc.numel()
    if step.kind == EXTEND:  # source x feeds d * m + x
        for d, row in enumerate(cot.view(a, m)):
            acc = acc + row
        return acc
    if step.kind == RIGHT:  # source x feeds x * a + d
        for d in range(a):
            acc = acc + cot.view(m, a)[:, d]
        return acc
    if step.kind == SHIFT:  # source y * a + e feeds d * (m / a) + y
        for d in range(a):
            acc = (acc.view(m // a, a)
                   + cot.view(a, m // a)[d][:, None]).reshape(-1)
        return acc
    # RSHIFT, RSHIFT_RUN: source e * (m / a) + y feeds y * a + d
    for d in range(a):
        acc = (acc.view(a, m // a)
               + cot.view(m // a, a)[:, d][None, :]).reshape(-1)
    return acc


def _ordered_sums(values: torch.Tensor, ptr, flat, n_out: int
                  ) -> torch.Tensor:
    """``out[g] = sum over flat[ptr[g]:ptr[g+1]] of values[.]``, each sum
    from 0 in list order (`ordered_add`)."""
    seg = np.repeat(np.arange(n_out), np.diff(np.asarray(ptr)))
    out = torch.zeros(n_out, dtype=values.dtype, device=values.device)
    return ordered_add(out, seg, values[torch.as_tensor(
        np.asarray(flat, dtype=np.int64), device=values.device)])


def dense_vjp_plain(dp: DeviceProgram, p: torch.Tensor, u: torch.Tensor,
                    low: torch.Tensor | None = None, w_const=None,
                    want_w: bool = False):
    """Plain version of K30: ``(p_bar, w_bar)``, the cotangents u^T J of
    dp/dt at ``p`` in p and, where ``want_w``, in the worlds' weights
    (``w_const`` [worlds] a run-time vector in place of the program's;
    w_bar is None otherwise). Each cotangent is a sum from 0 of its terms
    in the plan's order (`vjp_plan`), as K30 forms it:

    - the forward: K3's plain levels (``low`` where given), K4's weights,
      every step's dense vector t = r x (r its ratio table, x
      `step_operand` of its source);
    - the steps in reverse plan order: a step's cotangent is its
      emission's u[adj] - u[orig] (each window whose run is an original
      rank), then each reader's ratio times cotangent, transposed
      (`_transpose_add`), readers in plan order; then its ratio's
      cotangent term (cotangent times x) and its source's term (ratio
      times cotangent); a seed's cotangent likewise from its step;
    - each ratio-table entry: the terms of the steps that read it, in
      plan order, times the guarded ratio's partials
      (`guarded_ratio_partials`);
    - each signature: its seeds' cotangents and its interior ops' +-u;
      each world: its pairs' signatures (pair order) into w_bar_v, then
      w_bar = w_bar_v prod g and each chain factor's cotangent w_bar_v
      w_const (prefix product times suffix product), times its
      partials;
    - each pyramid entry: its numerator terms, its denominator terms by
      digit, its chain factors' terms; then the pyramid's transpose,
      level 0 up: lv_bar[j + 1] += lv_bar[j] repeated over the last
      digit, into p_bar.

    Non-live windows of a dense vector hold exact zeros (the module
    docstring), so their terms change no bits of what K30 skips, but the
    sign of a zero."""
    dense_vjp_plain.calls += 1
    prog = dp.prog
    a, k = prog.size_a, prog.cl_k
    n, n_state = a**k, prog.state_size
    tapes = 1 + prog.dual
    vt = vjp_tables(dp)
    vp = vt["plan"]
    p, u = p.reshape(-1), u.reshape(-1)
    if low is None:
        low = pyramids(prog, p, plain=True)
    s = signature_weights_plain(dp, p, low, w_const)
    m = low.numel() // tapes
    off, rat_len = ratio_offsets(a, k)
    # Every ratio-table entry's numerator and denominator, tape by tape
    # in `ratio_offsets`' layout: the tables, and later their partials.
    num, den = [], []
    for t in range(tapes):
        lv = levels(p[t * n:(t + 1) * n], low[t * m:(t + 1) * m], a, k)
        num += [lv[j] for j in range(1, k + 1)] + [lv[k]]
        den += [lv[j - 1].repeat(a) for j in range(1, k + 1)]
        den.append(torch.repeat_interleave(lv[k - 1], a))
    num, den = torch.cat(num), torch.cat(den)
    rat = guarded_ratio(num, den)
    tables = []
    for t in range(tapes):
        r = rat[t * rat_len:(t + 1) * rat_len]
        named = {("le", j): r[off[j]:off[j] + a**j] for j in range(1, k + 1)}
        named["re"] = r[off["re"]:]
        tables.append(named)
    steps = dp.plan.steps
    ts, ops = {}, {}
    for i, st in enumerate(steps):  # the forward, every vector kept
        if st.kind == INTERIOR:
            continue
        src = ts[st.src] if st.src >= 0 else _seed_dense(st, s)
        ops[i] = step_operand(st, src, a)
        ts[i] = (ops[i] if st.kind == IDENT
                 else step_table(st, tables[st.tape]) * ops[i])
    cot, prods, seed_cot = {}, {}, {}
    for i in range(len(steps) - 1, -1, -1):
        st = steps[i]
        if st.kind == INTERIOR:
            continue
        acc = torch.zeros_like(ts[i])
        if st.pairs:
            o, adj = (torch.as_tensor(x, device=p.device)
                      for x in zip(*st.pairs))
            u3 = u[st.tape * n:(st.tape + 1) * n].view(-1, st.span, st.lo)
            acc3 = acc.view(-1, st.span, st.lo)
            acc3[:, o, :] = acc3[:, o, :] + (u3[:, adj, :] - u3[:, o, :])
        for j in vp.readers[i]:
            acc = _transpose_add(acc, steps[j], cot[j], a)
        if st.kind == IDENT:
            cot[i] = acc
        else:
            cot[i] = step_table(st, tables[st.tape]) * acc
            prods[i] = acc * ops[i]
        if st.src < 0:
            seed_cot[i] = _transpose_add(
                torch.zeros(st.seed_size, dtype=p.dtype, device=p.device),
                st, cot[i], a)
    # Seed cotangents at their live ranks, laid out as K30's.
    xs_all = torch.zeros(vp.n_xs, dtype=p.dtype, device=p.device)
    for i, at in vp.xs_off.items():
        ranks = sorted({r for r, _ in steps[i].seed})
        xs_all[at:at + len(ranks)] = seed_cot[i][ranks]
    # Ratio-table entries (each step's terms in plan order), then their
    # partials.
    rbar = torch.zeros(tapes * rat_len, dtype=p.dtype, device=p.device)
    for i in sorted(prods):
        st = steps[i]
        at = st.tape * rat_len + (off[st.lev] if st.kind in (EXTEND, SHIFT)
                                  else off["re"])
        rbar[at:at + prods[i].numel()] += prods[i]
    dn, dd = guarded_ratio_partials(num, den)
    q = torch.stack([rbar * dn, rbar * dd], dim=1).reshape(-1)
    # Signatures, worlds and the chains' partials.
    values = torch.cat([xs_all, u, -u])
    sbar = _ordered_sums(values, vp.sig_ptr, vp.sig_terms,
                         prog.num_signatures)
    wvbar = _ordered_sums(sbar, vp.world_ptr, vp.world_sigs,
                          prog.num_worlds)
    pyr = torch.cat([p, low])
    w_num, w_den = pyr[dp.w_num.long()], pyr[dp.w_den.long()]
    g = guarded_ratio(w_num, w_den)
    dn, dd = guarded_ratio_partials(w_num, w_den)
    chain = g.shape[1]
    prod = g[:, 0].clone()
    for c in range(1, chain):
        prod = prod * g[:, c]
    wc = dp.w_const if w_const is None else w_const
    weight = wvbar * wc
    pre = [torch.ones_like(prod)]
    for c in range(1, chain):
        pre.append(pre[-1] * g[:, c - 1])
    suf = [torch.ones_like(prod)]
    for c in range(chain - 2, -1, -1):
        suf.insert(0, suf[0] * g[:, c + 1])
    gbar = torch.stack([weight * (pre[c] * suf[c]) for c in range(chain)],
                       dim=1)
    qw = torch.stack([gbar * dn, gbar * dd], dim=2).reshape(-1)
    q = torch.cat([q, qw])
    # Each pyramid entry's direct terms, then the chains', then the
    # pyramid's transpose.
    direct = torch.zeros(pyr.numel(), dtype=p.dtype, device=p.device)
    lv_off, _ = pyramid_offsets(a, k)
    for t in range(tapes):
        def qt(slot, x_start, size, side):
            start = off["re"] if slot == k else off[slot + 1]
            e = 2 * (t * rat_len + start + x_start) + side
            return q[e:e + 2 * size:2]

        for j in range(k + 1):
            size = a**j
            acc = torch.zeros(size, dtype=p.dtype, device=p.device)
            if j == k:
                acc = acc + qt(k - 1, 0, size, 0)
                acc = acc + qt(k, 0, size, 0)
            elif j >= 1:
                acc = acc + qt(j - 1, 0, size, 0)
            if j < k:
                for d in range(a):
                    acc = acc + qt(j, d * size, size, 1)
            if j == k - 1:
                for d in range(a):
                    acc = acc + qt(k, 0, a * size, 1).view(size, a)[:, d]
            at = (t * n if j == k
                  else n_state + t * m + lv_off[j] - n)
            direct[at:at + size] = acc
    direct = ordered_add(direct, vp.wt_pyr, q[torch.as_tensor(
        vp.wt_q.astype(np.int64), device=p.device)])
    pbar = torch.empty(n_state, dtype=p.dtype, device=p.device)
    for t in range(tapes):
        def dlev(j):
            at = n_state + t * m + lv_off[j] - n
            return direct[at:at + a**j]

        acc = dlev(0)
        for j in range(1, k):
            acc = dlev(j) + torch.repeat_interleave(acc, a)
        pbar[t * n:(t + 1) * n] = (direct[t * n:(t + 1) * n]
                                   + torch.repeat_interleave(acc, a))
    return pbar, (wvbar * prod if want_w else None)


dense_vjp_plain.calls = 0


def _k30_scratch(dp, vp) -> int:
    """Doubles of a K30 call's scratch (`csrc/dense_vjp.cu`)."""
    prog = dp.prog
    return (3 * max(dp.plan.work_size, 1) + vp.n_xs
            + 2 * prog.num_signatures + vjp_partials(prog)
            + prog.state_size + low_size(prog))


def dense_vjp(dp: DeviceProgram, p: torch.Tensor, u: torch.Tensor,
              low: torch.Tensor | None = None, w_const=None,
              want_w: bool = False):
    """K30: ``(p_bar, w_bar)``, u^T J of dp/dt at the float64 state ``p``
    in p and, where ``want_w``, in the worlds' weights (None otherwise),
    ``low`` K3's levels of p (made by the call when None) and
    ``w_const`` [worlds] a run-time weight vector in place of the
    program's. On a card one C call (`ckpe_dense_vjp`) in the program's
    form (`launch_form`): one K30 launch, which in the block and cluster
    forms also forms the levels when ``low`` is None; in the grid form K3
    on each tape first where ``low`` is None. On the CPU
    `dense_vjp_plain`."""
    if not cuda.on_card(p, "dense_vjp"):
        return dense_vjp_plain(dp, p, u, low, w_const, want_w)
    prog = dp.prog
    a, k, n = prog.size_a, prog.cl_k, prog.state_size
    tapes = 1 + prog.dual
    fused = dp.form.fused_levels
    levels_p = low is None and fused
    if low is None:
        low = (torch.empty(low_size(prog), dtype=torch.float64,
                           device=p.device) if fused
               else pyramids(prog, p.reshape(-1)))
    p, low = _check_pyramid(dp, p.reshape(-1), low)
    u = u.reshape(-1)
    if u.dtype != torch.float64 or u.shape != (n,) or u.device != p.device:
        raise TypeError(f"u must be a float64 [{n}] tensor on {p.device}")
    u = u.contiguous()
    vt = vjp_tables(dp)
    vp = vt["plan"]
    consts = pair_consts(dp, w_const)  # checks a run-time w_const
    wc = dp.w_const if w_const is None else w_const.contiguous()
    scratch = torch.empty(_k30_scratch(dp, vp), dtype=torch.float64,
                          device=p.device)
    pbar = torch.empty(n, dtype=torch.float64, device=p.device)
    wbar = (torch.empty(prog.num_worlds, dtype=torch.float64,
                        device=p.device) if want_w else None)
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_dense_vjp(
            tapes, int(levels_p), vt["fwd_items"].data_ptr(),
            vt["fwd_ptr"].data_ptr(), len(vp.fwd_ptr) - 1,
            vt["rv_items"].data_ptr(), vt["rv_ptr"].data_ptr(),
            len(vp.rv_ptr) - 1, vt["table"].data_ptr(),
            vt["steps"].data_ptr(), vt["tab_ptr"].data_ptr(),
            vt["tab_steps"].data_ptr(), vt["sig_ptr"].data_ptr(),
            vt["sig_terms"].data_ptr(), vt["world_ptr"].data_ptr(),
            vt["world_sigs"].data_ptr(), vt["wt_pyr"].data_ptr(),
            vt["wt_q"].data_ptr(), len(vp.wt_pyr), dp.w_num.data_ptr(),
            dp.w_den.data_ptr(), wc.data_ptr(), prog.w_num.shape[1],
            prog.num_worlds, dp.pair_num.data_ptr(), dp.pair_den.data_ptr(),
            consts.data_ptr(), dp.csr_ptr.data_ptr(),
            prog.num_signatures, vp.n_xs, n, p.data_ptr(), low.data_ptr(),
            u.data_ptr(), scratch.data_ptr(), dp.plan.work_size,
            vjp_partials(prog), pbar.data_ptr(),
            None if wbar is None else wbar.data_ptr(), a, k, dp.form.kind,
            dp.form.blocks, vp.max_phase, cuda.stream(p))
    cuda.check(rc, "dense_vjp", lib)
    dense_vjp.launches += 1
    return pbar, wbar


dense_vjp.launches = 0


def forward_dual(p):
    """``(primal, tangent)`` of a forward-mode dual tensor that carries
    nothing else (no torch.func wrapper, no autograd history), else
    None: the closures then compute dp/dt and J v in one K25 launch and
    return them as a dual."""
    if (torch._C._functorch.is_functorch_wrapped_tensor(p)
            or p.requires_grad):
        return None
    primal, tangent = torch.autograd.forward_ad.unpack_dual(p)
    return None if tangent is None else (primal, tangent)


def _unwrapped(t):
    """The plain tensor under torch.func's wrappers (a kernel needs its
    pointer)."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def transformed(t) -> bool:
    """Whether ``t`` carries a derivative: wrapped by a torch.func
    transform, a forward-mode dual, or tracked by autograd."""
    return (torch._C._functorch.is_functorch_wrapped_tensor(t)
            or t.requires_grad
            or torch.autograd.forward_ad.unpack_dual(t).tangent is not None)


class RHSFunction(torch.autograd.Function):
    """dp/dt as a function torch's transforms can drive: ``apply(p, w,
    rhs, jvp, vjp)`` with ``w`` a run-time weight vector or None, ``rhs(p,
    w) -> (dy, saved)``, ``jvp(p, w, saved, v, w_t) -> J v`` (the
    tangent along v in p and w_t in w, either None) and ``vjp(p, w,
    saved, u, want_w) -> (p_bar, w_bar)`` (None: not ported, and raises
    NotImplementedError naming `REVERSE_MODE`). forward runs on plain
    tensors (a ctypes launch sees real pointers); the derivative rules get
    p, w and ``saved`` (K3's levels) unwrapped, and a zero tangent or
    cotangent gives zeros without a launch. A backward run with
    ``create_graph`` returns cotangents whose own backward raises
    NotImplementedError naming `SECOND_ORDER`."""

    @staticmethod
    def forward(p, w, rhs, jvp, vjp):
        with torch._C._DisableFuncTorch():  # plain tensors: no dispatch
            return rhs(p, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        p, w, _, jvp, vjp = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_forward(p, output[1], w)
        ctx.save_for_backward(p, output[1], w)
        ctx.jvp_fn, ctx.vjp_fn = jvp, vjp

    @staticmethod
    def jvp(ctx, p_t, w_t, *_):
        if ctx.jvp_fn is None:
            raise NotImplementedError(
                f"the J.v of this RHS is not ported yet ({REVERSE_MODE})")
        p, saved, w = (None if x is None else _unwrapped(x)
                       for x in ctx.saved_tensors)
        if p_t is None and w_t is None:
            return torch.zeros_like(p), None
        with torch._C._DisableFuncTorch():
            return ctx.jvp_fn(p, w, saved,
                              None if p_t is None else _unwrapped(p_t),
                              None if w_t is None else _unwrapped(w_t)), None

    @staticmethod
    def backward(ctx, g_dy, _g_saved):
        if ctx.vjp_fn is None:
            raise NotImplementedError(
                "reverse mode through this RHS is not ported yet "
                f"({REVERSE_MODE})")
        p, saved, w = ctx.saved_tensors
        want_p, want_w = ctx.needs_input_grad[:2]
        if g_dy is None:
            p_bar = torch.zeros_like(p)
            w_bar = None if w is None else torch.zeros_like(w)
        else:
            with torch.no_grad():
                p_bar, w_bar = ctx.vjp_fn(p.detach(), None if w is None
                                          else w.detach(), saved,
                                          g_dy.detach(), want_w)
        what = "the dense RHS"
        p_bar = first_order_only(p_bar, what, p, w, g_dy)
        w_bar = first_order_only(w_bar, what, p, w, g_dy)
        return (p_bar if want_p else None, w_bar if want_w else None,
                None, None, None)


# --- dp/dt ---------------------------------------------------------------------


def dy_dt_dense(dp: DeviceProgram, p: torch.Tensor,
                out: torch.Tensor | None = None,
                low: torch.Tensor | None = None,
                w_const=None) -> torch.Tensor:
    """Plain dp/dt: K3's, K4's and K5's plain versions in turn, on ``p``'s
    device, into ``out`` as `sweep_plain`; K3's levels also into ``low``
    where one is given; ``w_const`` [worlds] replaces the program's."""
    p = p.reshape(-1)
    levels = pyramids(dp.prog, p, plain=True)
    if low is not None:
        low.copy_(levels)
    return sweep_plain(dp, p, levels,
                       signature_weights_plain(dp, p, levels, w_const), out)


def dense_rhs(dp: DeviceProgram, p: torch.Tensor,
              out: torch.Tensor | None = None,
              low: torch.Tensor | None = None,
              w_const=None) -> torch.Tensor:
    """dp/dt of a float64 ``p`` (the program's state) into ``out`` (a new
    tensor when None): on a card one C call (`ckpe_dense_rhs`) in the
    program's form (`launch_form`), one K5 launch whose leading phases
    form the levels (block and cluster forms) or K3 once a tape and then
    K5 (grid form), K4 K5's phase 0; on the CPU their plain versions.
    The levels below p go into ``low`` (`low_size` doubles)
    where one is given, else into a tensor of the call's own. A run-time
    ``w_const`` [worlds] (the parametric path) replaces the program's:
    dp/dt is linear in it, so the sweep is the same, with K4 reading the
    pairs' constants from `pair_consts`."""
    a, k, n = dp.prog.size_a, dp.prog.cl_k, dp.prog.state_size
    if not cuda.on_card(p, "dense_rhs"):
        return dy_dt_dense(dp, p, out, low, w_const)
    tapes = 1 + dp.prog.dual
    if low is None:
        low = torch.empty(low_size(dp.prog), dtype=torch.float64,
                          device=p.device)
    p, low = _check_pyramid(dp, p, low)
    dy = (torch.empty(n, dtype=torch.float64, device=p.device)
          if out is None else _checked_out(out, n, p.device))
    work, s = _work(dp, p), _weights_out(dp, None)
    consts = pair_consts(dp, w_const)
    lib = cuda.load()
    with torch.cuda.device(p.device):
        rc = lib.ckpe_dense_rhs(tapes, pyramid_tile_digits(a, k),
                                *_k5_args(dp, p, low, work, dy, s, consts),
                                cuda.stream(p))
    cuda.check(rc, "dense_rhs", lib)
    pyramid.launches += rhs_pyramid_launches(dp)
    sweep.launches += 1
    return dy


def rhs_fn(dp: DeviceProgram, p: torch.Tensor,
           out: torch.Tensor | None = None, w_const=None) -> torch.Tensor:
    """dp/dt of a closure's float64 [A^k] ``p`` (``w_const`` [worlds] a
    run-time weight vector in place of the program's): `dense_rhs` for
    plain tensors, into ``out`` where one is given; for a forward-AD dual
    p that carries nothing else (and a plain w_const), dp/dt and J v from
    one K25 launch, returned as a dual; under any other transform of p
    or of w_const, `RHSFunction` (K3 -> K5 forward; K25 its J.v in p,
    and dp/dt at the tangent its J.v in w_const, which dp/dt is linear
    in; K30 its v^T J in both). ``out=`` takes plain tensors only."""
    w_transformed = w_const is not None and transformed(w_const)
    if not transformed(p) and not w_transformed:
        return dense_rhs(dp, p, out, w_const=w_const)
    if out is not None:
        raise ValueError("out= takes a plain tensor, not one under a "
                         "transform")
    dual = None if w_transformed else forward_dual(p)
    if dual is not None:
        return torch.autograd.forward_ad.make_dual(
            *dense_jvp(dp, *dual, w_const=w_const, value=True))

    def rhs(q, w):
        low = torch.empty(low_size(dp.prog), dtype=torch.float64,
                          device=dp.device)
        return dense_rhs(dp, q, None, low, w), low

    def jvp(q, w, low, v, w_t):
        jv = None if v is None else dense_jvp(dp, q, v, low, w)
        if w_t is not None:
            lin = dense_rhs(dp, q, None, None, w_t.contiguous())
            jv = lin if jv is None else jv + lin
        return jv

    def vjp(q, w, low, u, want_w):
        return dense_vjp(dp, q, u, low, w, want_w)

    return RHSFunction.apply(p, w_const, rhs, jvp, vjp)[0]


def make_dense_dy_dt(prog: DenseProgram, dtype=None, jit: bool = True,
                     with_mass: bool = False, *, device=None):
    """Builds ``fn(p, out=None) -> dp/dt`` (float64) for a dense program
    on ``device`` (``cuda`` unless named): K3 -> K5 in one C call on a
    card (`dense_rhs`), their plain versions on the CPU. ``p`` is a
    tensor or an array of A^k values; it is moved to the device as
    float64. K5 writes dp/dt into ``out`` where one is given (a solver's
    stage row), else into a new tensor.

    ``with_mass=True`` (pruned programs) makes ``fn`` return ``(dp/dt,
    mass)``, the mass of the enumerated worlds under p (K9 after K3 and
    K5, over the pyramid K3 built: a 0-d float64 tensor on the device,
    no host sync); exactly 1 for a complete multiverse, so ``1 - mass``
    is the weight the pruning lost at p; K9's scratch is the closure's
    own (`mass_scratch`), so one closure serves one stream at a time. A
    program with no mass tables raises ValueError.

    Under a transform ``fn`` is `RHSFunction` (`torch.func.jvp`,
    autograd): its J.v is K25 (`dense_jvp`) and its v^T J K30
    (`dense_vjp`), each over the levels K3 built for the primal call; a
    second derivative raises NotImplementedError naming `SECOND_ORDER`.
    A forward-mode dual p (`torch.autograd.forward_ad`, as the solvers'
    J.v take it: `ode/krylov.jvp`) gets dp/dt and J v from one K25
    launch, as a dual. ``out=`` takes a plain tensor; ``with_mass`` under
    a transform raises NotImplementedError naming `SECOND_ORDER`.

    ``dtype`` and ``jit`` are the reference's parameters, in its order:
    ``dtype`` None or float64 (anything else raises: the exact path is
    float64 throughout), ``jit`` changes nothing here."""
    config.check_float64(dtype)
    if with_mass and prog.m_num is None:
        raise ValueError(
            "Program has no mass tables; compile with prune_threshold>0.")
    dp = device_program(prog, device)
    n = prog.state_size
    scratch = mass_scratch(dp.device) if with_mass else None

    def fn(p, out=None):
        p = torch.as_tensor(p, dtype=torch.float64,
                            device=dp.device).reshape(-1)
        if p.numel() != n:
            raise ValueError(f"p has {p.numel()} entries, the program "
                             f"{n}")
        if not with_mass:
            return rhs_fn(dp, p, out)
        if transformed(p):
            raise NotImplementedError(
                "derivatives through the world mass are not ported yet "
                f"({SECOND_ORDER})")
        low = torch.empty(low_size(prog), dtype=torch.float64,
                          device=dp.device)
        dy = dense_rhs(dp, p, out, low)
        return dy, world_mass(dp, p, low, scratch)

    fn.device_program = dp
    return fn
