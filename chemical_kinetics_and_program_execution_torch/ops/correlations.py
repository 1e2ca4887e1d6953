"""Spatial correlation functions of the Markov tape measure.

Counterpart of the JAX package's `ops/correlations.py` (host numpy and
scipy, as there).

The closure state stores window probabilities only up to length
``cl_k``, but the measure it describes — the stationary order-(cl_k-1)
Markov extension (`markov.mpp_from_spd`, reference semantics at
`framework/markov_tapes.py:81-233`) — determines joint statistics at
EVERY separation. This module computes them exactly:

- :func:`pair_prob` — P(word A at position 0 AND word B at position d)
  under the infinite-chain Markov extension, or under the cyclic
  (ring) measure the ensemble engine's bridge-sampled tapes follow.
- :func:`observable_correlation` — connected correlators
  C(d) = <f(0) g(d)> − <f><g> for word-weighted observables (spins,
  island indicators, ...).
- :func:`correlation_length` — ξ = −1/ln|λ₂| from the subleading
  eigenvalue of the context transfer operator.
- :func:`run_length_distribution` — exact distribution of runs of a
  symbol CLASS (e.g. copolymer strand lengths, island sizes) at any
  length, via class-summed transfer steps.

Word positions may be ints (exactly that symbol) or iterables of ints
(any symbol of the class): ``(0, (1, 2), 0)`` reads 'O, then A-or-M,
then O'. Classes cost one extra scatter per member symbol — runs of
length 100 are 100 matvecs either way.

Everything here is host-side analysis math over tiny
``[A^(cl_k-1)]``-dimensional context vectors, in the same spirit as
`markov.py`'s helpers (the reference has no counterpart — it can report
single-window marginals only). The per-symbol step never materialises
the dense transfer matrix: one step is a row-sparse
``v'[shift(c, s)] += v[c]·mpp[c, s]`` accumulation, so chain-mode
correlators work at any alphabet size; only the cyclic trace formula
and the dense eigensolve are gated on ``n_ctx``.
"""

from __future__ import annotations

import numpy as np

from .. import markov

_DENSE_CTX_LIMIT = 4096


def _shape_spd(spd, size_a, cl_k):
    """Normalise an SPD to the ``(A,)*k`` axis layout. Flat arrays are
    ambiguous (a flat ``[A**k]`` vector reads as an order-0 measure over
    an ``A**k``-letter alphabet), so they require explicit dimensions."""
    spd = np.asarray(spd, dtype=np.float64)
    if size_a is not None:
        if cl_k is None:
            raise ValueError("pass both size_a and cl_k, or neither")
        return spd.reshape((size_a,) * cl_k)
    if spd.ndim == 1:
        raise ValueError(
            "flat SPD is ambiguous: pass size_a= and cl_k= explicitly "
            "(or reshape to (size_a,)*cl_k)")
    return spd


def context_arrays(spd, *, size_a=None, cl_k=None, eps=None,
                   zero_tol=1e-300):
    """Context-chain arrays of an SPD's Markov extension.

    Returns ``(mpp, nctx, pi)``: conditional next-symbol probabilities
    ``mpp [n_ctx, size_a]`` (rows of unreachable contexts zeroed — see
    below), successor contexts ``nctx [n_ctx, size_a]`` with
    ``nctx[c, s] = (c·A + s) mod n_ctx``, and the stationary context
    marginal ``pi [n_ctx]``.

    `markov.mpp_from_spd` gives IMPOSSIBLE prefixes a uniform follow-up
    row (reference parity). For chain-mode propagation that is harmless
    (those contexts carry zero mass), but the cyclic trace formula sums
    conditional-probability cycles unweighted by ``pi``, so an
    artificial uniform row would contribute spurious cycles through
    zero-probability contexts. Rows with ``pi <= zero_tol`` are
    therefore zeroed here; stationarity (``pi`` is the fixed point of
    the transfer operator) guarantees no probability flows into them.
    """
    spd = _shape_spd(spd, size_a, cl_k)
    size_a = spd.shape[-1]
    n_ctx = spd.size // size_a
    mpp = markov.mpp_from_spd(spd, eps=eps).reshape(n_ctx, size_a).copy()
    pi = spd.reshape(n_ctx, size_a).sum(axis=-1)
    mpp[pi <= zero_tol, :] = 0.0
    nctx = (np.arange(n_ctx)[:, None] * size_a
            + np.arange(size_a)[None, :]) % n_ctx
    return mpp, nctx, pi


def _norm_word(word):
    """Normalise a word to a tuple of symbol-CLASS tuples: each position
    is an int (exactly that symbol) or an iterable of ints (any of
    them) — e.g. ``(0, (1, 2), 0)`` reads 'O, then A-or-M, then O'."""
    out = []
    for cell in word:
        if isinstance(cell, (int, np.integer)):
            out.append((int(cell),))
        else:
            cls = tuple(sorted({int(c) for c in cell}))
            if not cls:
                raise ValueError("empty symbol class in word")
            out.append(cls)
    return tuple(out)


def _emit(v, word, mpp, nctx):
    """Multiply the context-mass vector by the word's step operators
    (summing within each position's symbol class): afterwards ``v[c]``
    is P(previous mass ∧ word read ∧ context = c)."""
    n_ctx = v.shape[0]
    for cls in _norm_word(word):
        out = np.zeros(n_ctx)
        for s in cls:
            np.add.at(out, nctx[:, s], v * mpp[:, s])
        v = out
    return v


def _propagate(v, steps, mpp, nctx):
    """Advance the context-mass vector ``steps`` symbols, summing over
    emissions (one application of the transfer operator per step)."""
    n_ctx = v.shape[0]
    for _ in range(steps):
        out = np.zeros(n_ctx)
        np.add.at(out, nctx.ravel(), (v[:, None] * mpp).ravel())
        v = out
    return v


def _merge_cells(a, b):
    """Intersect two symbol classes (None = unconstrained)."""
    if a is None:
        return b
    if b is None:
        return a
    both = tuple(sorted(set(a) & set(b)))
    return both or ()


def _merge_words(seq_a, seq_b, d):
    """Overlay word B at offset ``d`` onto word A (offset 0),
    intersecting overlapping symbol classes. Returns the merged word,
    or None when an overlap is contradictory (empty intersection)."""
    n = max(len(seq_a), d + len(seq_b))
    out = [None] * n
    for i, cls in enumerate(_norm_word(seq_a)):
        out[i] = cls
    for i, cls in enumerate(_norm_word(seq_b)):
        j = d + i
        merged = _merge_cells(out[j], cls)
        if merged == ():
            return None
        out[j] = merged
    assert all(c is not None for c in out), \
        "gap cells unsupported: chain mode guarantees d < len(seq_a)"
    return out


def _step_matrix(cls, mpp, nctx):
    """Dense one-cell step operator summed over the symbol class:
    E[c, c'] = Σ_{s∈cls} mpp[c, s]·[c' = shift(c, s)]. Used by the
    cyclic trace formula only."""
    n_ctx = mpp.shape[0]
    step = np.zeros((n_ctx, n_ctx))
    for s in cls:
        step[np.arange(n_ctx), nctx[:, s]] += mpp[:, s]
    return step


def _transfer_dense(mpp, nctx):
    n_ctx, size_a = mpp.shape
    T = np.zeros((n_ctx, n_ctx))
    np.add.at(T, (np.repeat(np.arange(n_ctx), size_a), nctx.ravel()),
              mpp.ravel())
    return T


def ring_operators(ctx, L):
    """Call-invariant cyclic-trace operators for rings of ``L`` sites:
    ``(T, Z)`` with T the dense transfer operator and Z = tr(T^L) the
    ring partition mass. Hoist out of separation/word loops —
    :func:`observable_correlation` computes this once per call."""
    mpp, nctx, _ = ctx
    n_ctx = mpp.shape[0]
    if n_ctx > _DENSE_CTX_LIMIT:
        raise ValueError(
            f"ring mode builds dense [n_ctx, n_ctx] operators; "
            f"n_ctx={n_ctx} exceeds {_DENSE_CTX_LIMIT}. Use chain mode "
            "(ring=None) for large alphabets/contexts.")
    T = _transfer_dense(mpp, nctx)
    Z = np.trace(np.linalg.matrix_power(T, int(L)))
    if Z <= 0:
        raise ValueError("cyclic measure has zero mass (periodic or "
                         "degenerate chain); no ring correlator")
    return T, Z


def pair_prob(spd, seq_a, seq_b, d, *, ring=None, ctx=None,
              size_a=None, cl_k=None, ring_ops=None):
    """P(word ``seq_a`` at position 0 AND word ``seq_b`` at position
    ``d >= 0``) under the SPD's Markov extension.

    ``ring=None`` (default) is the infinite stationary chain.
    ``ring=L`` is the cyclic measure on rings of ``L`` sites — the
    measure the ensemble engine's bridge sampler draws
    (`ensemble.sample_tapes_from_spd(ring=True)`); positions are taken
    mod L and overlaps (including wrap-around) are resolved by
    intersecting the symbol classes cell-wise — words longer than the
    ring simply wrap onto themselves (contradictory overlaps return
    exactly 0). Cyclic mode builds dense ``[n_ctx, n_ctx]`` operators
    (trace formula) and is gated at n_ctx <= 4096.

    Word positions are ints or symbol-class iterables (module
    docstring); overlapping positions intersect their classes.
    ``ctx`` optionally passes precomputed :func:`context_arrays`.
    """
    if d < 0:
        raise ValueError(f"separation d must be >= 0, got {d}")
    seq_a, seq_b = list(seq_a), list(seq_b)
    mpp, nctx, pi = (context_arrays(spd, size_a=size_a, cl_k=cl_k)
                     if ctx is None else ctx)

    if ring is None:
        if d < len(seq_a):
            merged = _merge_words(seq_a, seq_b, d)
            if merged is None:
                return 0.0
            return float(_emit(pi, merged, mpp, nctx).sum())
        v = _emit(pi, seq_a, mpp, nctx)
        v = _propagate(v, d - len(seq_a), mpp, nctx)
        return float(_emit(v, seq_b, mpp, nctx).sum())

    L = int(ring)
    T, Z = (ring_operators((mpp, nctx, pi), L) if ring_ops is None
            else ring_ops)
    n_ctx = mpp.shape[0]
    d = d % L
    # Resolve overlaps (direct and wrap-around) by intersecting symbol
    # classes onto a ring template of None-or-class cells.
    cells = [None] * L
    for i, cls in enumerate(_norm_word(seq_a)):
        merged = _merge_cells(cells[i % L], cls)
        if merged == ():
            return 0.0
        cells[i % L] = merged
    for i, cls in enumerate(_norm_word(seq_b)):
        j = (d + i) % L
        merged = _merge_cells(cells[j], cls)
        if merged == ():
            return 0.0
        cells[j] = merged
    # Walk the ring once, multiplying fixed-symbol step operators and
    # free-cell transfer steps in position order.
    op = np.eye(n_ctx)
    for cell in cells:
        op = op @ (T if cell is None else _step_matrix(cell, mpp, nctx))
    return float(np.trace(op) / Z)


def word_prob(spd, word, *, ring=None, ctx=None, size_a=None,
              cl_k=None, ring_ops=None):
    """P(word at a fixed position) — :func:`pair_prob` with an empty
    partner word."""
    return pair_prob(spd, word, (), 0, ring=ring, ctx=ctx,
                     size_a=size_a, cl_k=cl_k, ring_ops=ring_ops)


def observable_correlation(spd, f_words, g_words, ds, *, ring=None,
                           connected=True, size_a=None, cl_k=None):
    """Connected two-point correlator of word-weighted observables.

    ``f_words`` / ``g_words`` map words (symbol tuples) to weights; the
    observables are f(i) = Σ_w f[w]·1[w at i]. Returns
    ``C[j] = <f(0) g(d_j)> − <f><g>`` (the product term is dropped with
    ``connected=False``) for each separation in ``ds``.

    Chain mode reuses one emission of each f-word and propagates it
    incrementally across sorted separations, so the cost is
    O(max(ds)) transfer steps + one short emission per (word, d) pair.
    """
    ctx = context_arrays(spd, size_a=size_a, cl_k=cl_k)
    mpp, nctx, pi = ctx
    f_words = {tuple(w): float(c) for w, c in dict(f_words).items()}
    g_words = {tuple(w): float(c) for w, c in dict(g_words).items()}
    ds = [int(d) for d in ds]

    ring_ops = None if ring is None else ring_operators(ctx, ring)
    mean_f = sum(c * word_prob(spd, w, ring=ring, ctx=ctx,
                               ring_ops=ring_ops)
                 for w, c in f_words.items())
    mean_g = sum(c * word_prob(spd, w, ring=ring, ctx=ctx,
                               ring_ops=ring_ops)
                 for w, c in g_words.items())
    prod = mean_f * mean_g if connected else 0.0

    out = np.zeros(len(ds))
    if ring is not None:
        for j, d in enumerate(ds):
            out[j] = sum(
                cf * cg * pair_prob(spd, wf, wg, d, ring=ring, ctx=ctx,
                                    ring_ops=ring_ops)
                for wf, cf in f_words.items()
                for wg, cg in g_words.items()) - prod
        return out

    order = np.argsort(ds)
    for wf, cf in f_words.items():
        v = _emit(pi, wf, mpp, nctx)
        pos = len(wf)  # v currently sits right after word f
        for j in order:
            d = ds[j]
            if d < len(wf):  # overlap region: per-pair merged words
                out[j] += sum(
                    cf * cg * pair_prob(spd, wf, wg, d, ctx=ctx)
                    for wg, cg in g_words.items())
                continue
            v = _propagate(v, d - pos, mpp, nctx)
            pos = d
            for wg, cg in g_words.items():
                out[j] += cf * cg * float(_emit(v, wg, mpp, nctx).sum())
    return out - prod


def run_length_distribution(spd, inside, lengths, *, boundary=None,
                            ring=None, size_a=None, cl_k=None):
    """Exact run-length statistics of a symbol class: ``out[j]`` is the
    per-site probability that a maximal run of ``inside`` symbols of
    length exactly ``lengths[j]`` STARTS at a given position — i.e.
    P(boundary, inside^l, boundary) for the word anchored one cell
    before the run.

    ``inside`` is an iterable of symbol indices (e.g. the non-solvent
    monomers for copolymer strand lengths); ``boundary`` defaults to
    its complement. Mass identity (useful as a self-check and for
    conditioning): summing l·P(l) over ALL lengths recovers the total
    ``inside`` symbol density, and P(l | a run starts) =
    out[j] / sum(out). ``ring=L`` evaluates on the cyclic measure
    (runs up to L−1; the all-``inside`` ring has no boundary and is
    excluded by construction).
    """
    spd_t = _shape_spd(spd, size_a, cl_k)
    size_a_ = spd_t.shape[-1]
    inside = tuple(sorted({int(c) for c in inside}))
    if boundary is None:
        boundary = tuple(c for c in range(size_a_) if c not in inside)
    boundary = tuple(sorted({int(c) for c in boundary}))
    if not inside or not boundary:
        raise ValueError("inside and boundary classes must be non-empty")
    ctx = context_arrays(spd_t)
    mpp, nctx, pi = ctx
    lengths = [int(ell) for ell in lengths]
    for ell in lengths:
        if ell < 1 or (ring is not None and ell > int(ring) - 1):
            raise ValueError(f"run length {ell} invalid"
                             + (f" on a ring of {ring}" if ring else ""))
    out = np.zeros(len(lengths))
    if ring is None:
        for j, ell in enumerate(lengths):
            word = (boundary,) + (inside,) * ell + (boundary,)
            out[j] = pair_prob(spd_t, word, (), 0, ctx=ctx)
        return out
    # Ring mode in O(L) dense matmuls (not O(L^2) cell walks):
    # P(run = l) = tr(E_b · E_in^l · E_b · T^(L-l-2)) / Z, with the
    # l = L-1 run wrapping its two boundaries onto one cell:
    # P = tr(E_b · E_in^(L-1)) / Z.
    L = int(ring)
    T, Z = ring_operators(ctx, L)
    e_b = _step_matrix(boundary, mpp, nctx)
    e_in = _step_matrix(inside, mpp, nctx)
    t_pows = {0: np.eye(mpp.shape[0])}
    for j in range(1, L - 1):
        t_pows[j] = t_pows[j - 1] @ T
    in_pows = {1: e_in}
    for ell in range(2, max(lengths) + 1):
        in_pows[ell] = in_pows[ell - 1] @ e_in
    for j, ell in enumerate(lengths):
        if ell == L - 1:
            out[j] = np.trace(e_b @ in_pows[ell]) / Z
        else:
            out[j] = np.trace(
                e_b @ in_pows[ell] @ e_b @ t_pows[L - ell - 2]) / Z
    return out


def correlation_length(spd, *, ctx=None, size_a=None, cl_k=None):
    """ξ = −1/ln|λ₂| of the context transfer operator: the exact decay
    length of every connected correlator of the Markov extension
    (C(d) ~ exp(−d/ξ) up to polynomial prefactors). Returns ``inf``
    when |λ₂| = 1 (non-mixing chain) and 0 for an order-0 measure.
    """
    mpp, nctx, pi = (context_arrays(spd, size_a=size_a, cl_k=cl_k)
                     if ctx is None else ctx)
    n_ctx = mpp.shape[0]
    if n_ctx <= _DENSE_CTX_LIMIT:
        lam = np.linalg.eigvals(_transfer_dense(mpp, nctx))
        lam = np.sort(np.abs(lam))[::-1]
        lam2 = lam[1] if len(lam) > 1 else 0.0
    else:  # matrix-free: a few dominant eigenvalues via scipy Arnoldi
        from scipy.sparse.linalg import LinearOperator, eigs

        def matvec(x):  # (T^T x): column action, row-sparse accumulate
            return ((x[nctx] * mpp).sum(axis=1))

        def rmatvec(x):
            out = np.zeros(n_ctx)
            np.add.at(out, nctx.ravel(), (x[:, None] * mpp).ravel())
            return out

        op = LinearOperator((n_ctx, n_ctx), matvec=matvec,
                            rmatvec=rmatvec)
        lam = np.sort(np.abs(eigs(op, k=2, which="LM", tol=1e-12,
                                  return_eigenvectors=False)))[::-1]
        lam2 = lam[1]
    if lam2 <= 0:
        return 0.0
    if lam2 >= 1.0 - 1e-12:
        return float("inf")
    return float(-1.0 / np.log(lam2))
