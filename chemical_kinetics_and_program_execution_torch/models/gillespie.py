"""Gillespie SSA (direct method) for mass-action reaction networks.

Counterpart of the JAX package's `models/gillespie.py`. A network is
integer reactant and product matrices ``[R, S]`` and rates ``[R]``; the
propensity of reaction r in state n is ``rates[r] * prod_s
falling_factorial(n_s, reactants[r, s])``.

- `ssa_batch_tm` is the batch-native core: the whole ensemble advances
  one event a step, time-major outputs (times ``[E, B]`` float64, counts
  ``[E, S, B]`` int32), propensities in ``dtype`` (float32 by default,
  float64 on request). Its events are kernel K27 (`ssa_round`,
  `csrc/ssa_round.cu`, rule `csrc/ssa_rule.cuh`) on the card and
  `ssa_round_plain` on the CPU; the two uniforms of an event come from
  the caller's `torch.Generator`, drawn in chunks of events on its
  stream (`ssa_batch_tm_from_draws` takes them explicitly).
- `ssa_batch` and `run_ssa_ensemble` are its batch-major wrappers.
- `ssa_trajectories` is the float64 formulation with an exponential
  waiting time and a categorical choice over p, int64 counts, plain
  torch (a batch of trajectories written out): the law the float32
  core is held to.

The port's generator is not the TPU's threefry stream, so runs agree with
the JAX package in law; given the same draws, the core agrees event for
event.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import cuda
from ..utils.config import get_device, make_generator

# Draws a chunk of `ssa_batch_tm`: at most this many uniforms (events x
# 2 x batch) at a time.
DRAW_CHUNK = 1 << 26
MAX_REACTIONS, MAX_SPECIES, MAX_FACTORS = 32, 8, 8  # `csrc/ssa_rule.cuh`


@dataclasses.dataclass(frozen=True)
class ReactionNetwork:
    reactants: np.ndarray  # [R, S] int
    products: np.ndarray  # [R, S] int
    rates: np.ndarray  # [R] float

    @property
    def num_species(self) -> int:
        return self.reactants.shape[1]

    @property
    def stoichiometry(self) -> np.ndarray:
        return self.products - self.reactants

    @property
    def static(self) -> tuple:
        """Hashable form (the JAX package's jit static argument)."""
        return (
            tuple(map(tuple, self.reactants.tolist())),
            tuple(map(tuple, self.products.tolist())),
            tuple(self.rates.tolist()),
        )


def network_from_jax(net) -> ReactionNetwork:
    """The port's network from the JAX package's (its three arrays)."""
    return ReactionNetwork(np.asarray(net.reactants),
                           np.asarray(net.products), np.asarray(net.rates))


def _as_network(network) -> ReactionNetwork:
    """A `ReactionNetwork` from one, or from its ``static`` tuple."""
    if isinstance(network, ReactionNetwork):
        return network
    reactants, products, rates = (np.asarray(x) for x in network)
    return ReactionNetwork(reactants, products, rates.astype(np.float64))


def autocatalysis_network(c_form_a, c_auto_a, c_stab_a,
                          c_form_b, c_auto_b, c_stab_b,
                          c_add, c_remove, volume=1000.0):
    """Discrete counterpart of the autocatalysis ODE
    (`models/autocatalysis.py:dy_dt`); ``volume`` converts concentration
    rate constants to stochastic ones. Species order: [A, B, M]."""
    reactants, products, rates = [], [], []

    def add(r, p, k):
        reactants.append(np.array(r))
        products.append(np.array(p))
        rates.append(k)

    # 2M -> A / B (spontaneous formation), A + 2M -> 2A (autocatalysis),
    # and the reverse dissociations; flow feed/removal.
    add((0, 0, 2), (1, 0, 0), c_form_a / volume)
    add((0, 0, 2), (0, 1, 0), c_form_b / volume)
    add((1, 0, 2), (2, 0, 0), c_auto_a / volume**2)
    add((0, 1, 2), (0, 2, 0), c_auto_b / volume**2)
    add((1, 0, 0), (0, 0, 2), c_form_a / c_stab_a)
    add((0, 1, 0), (0, 0, 2), c_form_b / c_stab_b)
    add((2, 0, 0), (1, 0, 2), c_auto_a / c_stab_a / volume)
    add((0, 2, 0), (0, 1, 2), c_auto_b / c_stab_b / volume)
    add((0, 0, 0), (0, 0, 1), c_add * volume)
    add((1, 0, 0), (0, 0, 0), c_remove)
    add((0, 1, 0), (0, 0, 0), c_remove)
    add((0, 0, 1), (0, 0, 0), c_remove)
    return ReactionNetwork(
        np.stack(reactants), np.stack(products), np.asarray(rates))


def _fits_shared(net: ReactionNetwork) -> bool:
    """Whether K27's shared-memory form takes ``net`` (`csrc/ssa_rule.cuh`:
    at most 32 reactions, 8 species and 8 factors a reaction, no negative
    order); any other network takes its wide form."""
    R, S = net.reactants.shape
    orders = np.maximum(net.reactants, 0).sum(axis=1)
    return (R <= MAX_REACTIONS and S <= MAX_SPECIES
            and int(orders.max()) <= MAX_FACTORS
            and bool((net.reactants >= 0).all()))


def _wide_tables(net: ReactionNetwork, device):
    """K27's wide form of ``net``: each reaction's factor list (species s,
    offset j for j < order, in the order s, then j: the plain version's
    product order) as fac_lo [R + 1], fac_s and fac_j int32, stoich [R, S]
    int32 and rates [R] float64, on ``device``."""
    fac_s, fac_j, fac_lo = [], [], [0]
    for row in net.reactants:
        for s, m in enumerate(row.tolist()):
            fac_s += [s] * max(m, 0)
            fac_j += list(range(max(m, 0)))
        fac_lo.append(len(fac_s))

    def i32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int32).reshape(-1),
                               device=device)

    return (i32(fac_lo), i32(fac_s + [0]), i32(fac_j + [0]),
            i32(net.stoichiometry),
            torch.as_tensor(np.asarray(net.rates, dtype=np.float64),
                            device=device))


# --- K27: events of the batch -------------------------------------------------

def ssa_round_plain(network, u: torch.Tensor, t: torch.Tensor,
                    n: torch.Tensor, t_out: torch.Tensor,
                    n_out: torch.Tensor) -> None:
    """Plain version of `ssa_round`: ``u.shape[0]`` events of every
    trajectory in the working type ``u.dtype``, in the XLA program's
    order (`csrc/ssa_rule.cuh`: sum and running sum in reaction order,
    written out, since torch's own sums take other orders). Advances the
    state ``t`` [B] float64 and ``n`` [S, B] int32 in place and writes
    each event's into ``t_out`` [E, B], ``n_out`` [E, S, B]."""
    ssa_round_plain.calls += 1
    net = _as_network(network)
    dtype, dev = u.dtype, u.device
    R, S = net.reactants.shape
    rates = [torch.tensor(float(k), dtype=torch.float64).to(dtype)
             for k in net.rates]
    stoich_t = torch.as_tensor(net.stoichiometry.T.astype(np.int32),
                               device=dev)  # [S, R]
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    for e in range(u.shape[0]):
        nf = n.to(dtype)
        props = []
        for r in range(R):
            p = torch.full_like(nf[0], rates[r].item())
            for s in range(S):
                for j in range(int(net.reactants[r, s])):
                    p = p * torch.clamp_min(nf[s] - j, 0.0)
            props.append(p)
        total = props[0]
        for p in props[1:]:
            total = total + p
        alive = total > 0
        dt = torch.where(alive, -torch.log1p(-u[e, 0])
                         / torch.clamp_min(total, 1e-30), inf)
        t.add_(dt.to(torch.float64))
        uu = u[e, 1] * total
        cum = props[0]
        cnt = (uu >= cum).to(torch.int64)
        for p in props[1:]:
            cum = cum + p
            cnt += uu >= cum
        r = torch.clamp_max(cnt, R - 1)
        n.copy_(torch.where(alive, n + stoich_t[:, r], n))
        t_out[e] = t
        n_out[e] = n


ssa_round_plain.calls = 0


def ssa_round(network, u: torch.Tensor, t: torch.Tensor, n: torch.Tensor,
              t_out: torch.Tensor, n_out: torch.Tensor) -> None:
    """K27: ``u.shape[0]`` events of every trajectory (see
    `ssa_round_plain`), u [E, 2, B] float32 or float64, t [B] float64,
    n [S, B] int32, t_out [E, B], n_out [E, S, B]; one launch on the
    card, the plain version on the CPU."""
    if not cuda.on_card(u, "ssa_round"):
        return ssa_round_plain(network, u, t, n, t_out, n_out)
    net = _as_network(network)
    R, S = net.reactants.shape
    if R < 1 or S < 1:
        raise ValueError(f"K27 takes at least one reaction and one "
                         f"species; got R={R}, S={S}")
    E, two, B = u.shape
    if u.dtype not in (torch.float32, torch.float64) or two != 2:
        raise TypeError("u must be a float32 or float64 [E, 2, B] tensor")
    for x, dtype, shape in ((t, torch.float64, (B,)),
                            (n, torch.int32, (S, B)),
                            (t_out, torch.float64, (E, B)),
                            (n_out, torch.int32, (E, S, B))):
        if (x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous() or x.device != u.device):
            raise TypeError(f"ssa_round: expected a contiguous {dtype} "
                            f"{shape} tensor on {u.device}")
    u = u.contiguous()
    lib = cuda.load()
    is_double = int(u.dtype == torch.float64)
    outs = (t.data_ptr(), n.data_ptr(), t_out.data_ptr(), n_out.data_ptr(),
            cuda.stream(u))
    with torch.cuda.device(u.device):
        if _fits_shared(net):
            order = np.ascontiguousarray(net.reactants, dtype=np.int32)
            stoich = np.ascontiguousarray(net.stoichiometry, dtype=np.int32)
            rates = np.ascontiguousarray(net.rates, dtype=np.float64)
            buf = torch.empty(lib.ckpe_ssa_net_bytes(), dtype=torch.uint8,
                              device=u.device)
            rc = lib.ckpe_ssa_rounds(
                order.ctypes.data, stoich.ctypes.data, rates.ctypes.data, R,
                S, buf.data_ptr(), is_double, u.data_ptr(), B, E, *outs)
        else:
            tables = _wide_tables(net, u.device)
            rc = lib.ckpe_ssa_rounds_wide(
                *(x.data_ptr() for x in tables), R, S, is_double,
                u.data_ptr(), B, E, *outs)
    cuda.check(rc, "ssa_round", lib)
    ssa_round.launches += 1


ssa_round.launches = 0


# --- The batch core and its wrappers ----------------------------------------

def _run_events(net, n0, draws, num_events, batch, dtype, device):
    """Times [E, B] and counts [E, S, B] from ``draws(e0, c)``, the
    uniforms [c, 2, B] of events e0..e0+c-1, fed to K27 chunk by chunk."""
    S = net.num_species
    n0 = torch.as_tensor(np.asarray(n0, dtype=np.int32).reshape(S),
                         device=device)
    t = torch.zeros(batch, dtype=torch.float64, device=device)
    n = n0[:, None].expand(S, batch).contiguous()
    ts = torch.empty((num_events, batch), dtype=torch.float64, device=device)
    ns = torch.empty((num_events, S, batch), dtype=torch.int32, device=device)
    chunk = max(1, DRAW_CHUNK // (2 * max(batch, 1)))
    for e0 in range(0, num_events, chunk):
        c = min(chunk, num_events - e0)
        u = draws(e0, c).to(dtype)
        ssa_round(net, u, t, n, ts[e0:e0 + c], ns[e0:e0 + c])
    return ts, ns


def ssa_batch_tm(generator, n0, network, num_events: int, batch: int,
                 dtype=torch.float32, device=None):
    """Batch-native SSA, time-major: ``batch`` trajectories from counts
    ``n0`` [S] for ``num_events`` events each, one event a step for the
    whole batch (K27 on the card). ``generator`` is a seed or a
    `torch.Generator` on the device; each event's two uniforms (the
    waiting time by ``-log1p(-u0) / total``, the reaction by ``u1 *
    total`` against the running sum) are drawn on its stream in chunks.
    ``network`` is a `ReactionNetwork` or its ``static`` tuple.

    Returns (times [E, B] float64, counts [E, S, B] int32); past the last
    possible event the time is ``inf`` and the counts stay.

    ``dtype`` is the propensity and sampling type: float32 (default)
    loses resolution in the falling factorials once counts near 2^24;
    float64 is the exact formulation at batch layout."""
    dtype = _check_dtype(dtype)
    dev = get_device(device)
    gen = make_generator(generator, dev)
    net = _as_network(network)
    return _run_events(
        net, n0, lambda e0, c: torch.rand((c, 2, batch), generator=gen,
                                          dtype=dtype, device=dev),
        num_events, batch, dtype, dev)


def ssa_batch_tm_from_draws(n0, network, u: torch.Tensor, dtype=None):
    """`ssa_batch_tm` given its draws: ``u`` [E, 2, B] (event e's u0 and
    u1 a trajectory), on the device the run takes; ``dtype`` defaults to
    ``u``'s. The deterministic update of each event, as the JAX package's
    scan body forms it from ``jax.random.uniform(k, (2, B), dtype)``."""
    dtype = _check_dtype(dtype or u.dtype)
    net = _as_network(network)
    E, _, B = u.shape
    return _run_events(net, n0, lambda e0, c: u[e0:e0 + c], E, B, dtype,
                       u.device)


def _check_dtype(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be torch.float32 or torch.float64, "
                        f"not {dtype!r}")
    return dtype


def ssa_batch(generator, n0, network, num_events: int, batch: int,
              dtype=torch.float32, device=None):
    """Batch-major wrapper of `ssa_batch_tm`: (times [B, E] float64,
    counts [B, E, S] int32)."""
    ts, ns = ssa_batch_tm(generator, n0, network, num_events, batch, dtype,
                          device)
    return ts.T.contiguous(), ns.permute(2, 0, 1).contiguous()


def run_ssa_ensemble(network: ReactionNetwork, n0, num_trajectories: int,
                     num_events: int, seed: int = 0, device=None):
    """SSA ensemble as numpy arrays: (times [B, E], counts [B, E, S])."""
    ts, ns = ssa_batch(seed, tuple(int(x) for x in n0), network, num_events,
                       num_trajectories, device=device)
    return ts.cpu().numpy(), ns.cpu().numpy()


# --- The float64 formulation --------------------------------------------------

def _propensities(n, reactants, rates, max_order):
    """Mass-action propensities [..., R] of counts ``n`` [..., S] with
    falling-factorial combinatorics (float64)."""
    prop = rates.expand(n.shape[:-1] + rates.shape)
    for j in range(max_order):
        factor = torch.where(reactants > j,
                             (n[..., None, :] - j).to(torch.float64),
                             torch.ones((), dtype=torch.float64,
                                        device=n.device))
        prop = prop * torch.prod(torch.clamp_min(factor, 0.0), dim=-1)
    return prop


def ssa_trajectories(generator, n0, network, num_events: int,
                     num_trajectories: int | None = None, device=None):
    """SSA jump chains of ``num_events`` events in float64 (the JAX
    package's `ssa_trajectories`, vmapped there by its callers, written
    out over a batch here): an exponential waiting time ``-log1p(-u) /
    max(total, 1e-300)`` and the reaction drawn from ``p / total`` (the
    JAX package's `choice`: the first running sum at or above ``total *
    (1 - u)``), counts in int64; ``inf`` time and no change once
    quiescent. Plain torch; the reference law of the float32 core.

    Returns one chain in the JAX shapes, (times [E] float64, counts [E,
    S] int64), or with ``num_trajectories`` = T a batch of T, (times [T,
    E], counts [T, E, S])."""
    if num_trajectories is None:
        ts, ns = ssa_trajectories(generator, n0, network, num_events, 1,
                                  device)
        return ts[0], ns[0]
    dev = get_device(device)
    gen = make_generator(generator, dev)
    net = _as_network(network)
    R, S = net.reactants.shape
    max_order = int(net.reactants.max()) if net.reactants.size else 0
    reactants = torch.as_tensor(net.reactants, device=dev)
    rates = torch.as_tensor(net.rates, dtype=torch.float64, device=dev)
    stoich = torch.as_tensor(net.stoichiometry, dtype=torch.int64,
                             device=dev)
    n = torch.as_tensor(np.asarray(n0, dtype=np.int64).reshape(S),
                        device=dev).expand(num_trajectories, S).clone()
    t = torch.zeros(num_trajectories, dtype=torch.float64, device=dev)
    ts = torch.empty((num_trajectories, num_events), dtype=torch.float64,
                     device=dev)
    ns = torch.empty((num_trajectories, num_events, S), dtype=torch.int64,
                     device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    for e in range(num_events):
        prop = _propensities(n, reactants, rates, max_order)  # [T, R]
        total = prop.sum(dim=-1)
        alive = total > 0
        u = torch.rand((2, num_trajectories), generator=gen,
                       dtype=torch.float64, device=dev)
        dt = torch.where(alive, -torch.log1p(-u[0])
                         / torch.clamp_min(total, 1e-300), inf)
        p = torch.where(alive[:, None],
                        prop / torch.clamp_min(total, 1e-300)[:, None],
                        torch.full_like(prop, 1.0 / R))
        cum = torch.cumsum(p, dim=-1)
        target = cum[:, -1:] * (1 - u[1][:, None])
        r = torch.clamp_max(torch.searchsorted(cum, target).squeeze(1),
                            R - 1)
        n = torch.where(alive[:, None], n + stoich[r], n)
        t = t + dt
        ts[:, e] = t
        ns[:, e] = n
    return ts, ns
