// K7's and K8's per-element rules: the gather engine's event values and
// their signed scatter (`engine/rhs.py`), as the JAX package's
// `engine/rhs.py:dy_dt_from_tables` and `dy_dt_from_chain_tables`
// compute them, over the compact tables `rhs.device_tables` and
// `rhs.chain_tables` build.
//
// The pyramid is read in two pieces, as K4's rule reads it
// (`sweep_rule.cuh:k4_pyramid`): the state vector below its size, K3's
// levels above (`engine/compile.py:two_pointer_index` maps the tables'
// flat indices there on the host).
//
//   ratio           R[q] = g(pyr[dict_num[q]], pyr[dict_den[q]]) for every
//                   entry q of every tree level's or chain column's
//                   dictionary of distinct (num, den) pairs, g the guarded
//                   ratio
//   K7 node, leaf   v = R[first + id[i]] * w[parent(i)] (level 0: R
//                   alone), w the node values of the level before and
//                   parent(i) = base[i / kTile] + off[i]; a leaf is an
//                   event, and its value v * s[sig[i]]
//   K8 event        v = R[first_0 + id_0[e]] * R[first_1 + id_1[e]] * ...
//                   in chain order (K4's `k4_chain_product`'s order), then
//                   v * s[sig[e]]
//   scatter         dy[t] = the sum over the entries q of target t of
//                   +-ev[ent[q] & kIndex] (the top bit a minus)
//
// A node's or a chain factor's ratio is looked up, not formed there:
// R[q] is the same function of the same two pyramid values, so the
// products' bits are those of forming it at each node. The ids, parent
// offsets and signatures are uint16, or int32 where a level's (or
// column's) are not all below 2^16 (``wide``); `k7_at` reads either.
//
// The scatter's entries are sorted by target: target t's are a
// contiguous run. A warp sums a run: lane l adds entries l, l + 32, ...
// from 0.0 in entry order (`k7_lane_sum`), then the warp folds its 32
// partials by an xor butterfly, which lane 0 reads in the order of
// `k7_fold32`. The plain version (`engine/rhs.py:scatter_plain`) adds in
// that order too, so K7 and K8
// equal it bit for bit; no float atomics.
//
// Plain C++ under `g++` as well, so a CPU test holds these rules to the
// plain versions.

#pragma once

#include "sweep_rule.cuh"

constexpr int kLanes = 32;
constexpr int kTileShift = 8;  // parent bases a tile of 256 (`rhs.TILE`)
constexpr unsigned kMinus = 0x80000000u;  // an entry's sign bit
constexpr unsigned kIndex = 0x7fffffffu;  // its value's index

K5_FN double k7_ratio(const K5Ctx& c, int num, int den) {
  return k5_guarded(k4_pyramid(c, num), k4_pyramid(c, den));
}

// Element i of a uint16 (``wide`` 0) or int32 (``wide`` 1) index array.
K5_FN unsigned k7_at(const void* a, int wide, long long i) {
  return wide ? (unsigned)((const int*)a)[i]
              : (unsigned)((const unsigned short*)a)[i];
}

// One tree level's nodes, or its leaves (the events that end there).
struct K7Slab {
  const void* id;   // pair ids into the level's dictionary
  const void* off;  // parent offsets (levels >= 1)
  const int* base;  // [ceil(n / 256)] each tile's first parent
};

// Node or leaf i of a level: its ratio times its parent's value in
// ``prev`` (nullptr at level 0: the ratio alone). ``ratio`` holds every
// dictionary's entries, the level's from ``first``.
K5_FN double k7_value(const double* ratio, unsigned first, const K7Slab& sl,
                      int wide, const double* prev, long long i) {
  const double r = ratio[first + k7_at(sl.id, wide, i)];
  if (!prev) return r;
  const long long parent =
      (long long)sl.base[i >> kTileShift] + k7_at(sl.off, wide, i);
  return r * k5_load(prev + parent);
}

// One chain column: its ids into its dictionary, from ``first``.
struct K8Column {
  const void* id;
  unsigned first;
  int wide;
};

// Event e's chain: its columns' ratios multiplied in chain order (the
// loads issued kK4Batch at a time, as `k4_chain_product` issues them).
K5_FN double k8_value(const double* ratio, const K8Column* cols, int n_cols,
                      long long e) {
  double prod = 0.0;
  for (int c0 = 0; c0 < n_cols; c0 += kK4Batch) {
    double r[kK4Batch];
#pragma unroll
    for (int u = 0; u < kK4Batch; ++u)
      if (c0 + u < n_cols) {
        const K8Column& col = cols[c0 + u];
        r[u] = ratio[col.first + k7_at(col.id, col.wide, e)];
      }
#pragma unroll
    for (int u = 0; u < kK4Batch; ++u)
      if (c0 + u < n_cols) prod = c0 + u == 0 ? r[u] : prod * r[u];
  }
  return prod;
}

// An entry: its event value, with a minus where the top bit is set.
K5_FN unsigned k7_entry(const unsigned* ent, long long q) {
#if defined(__CUDA_ARCH__)
  return __ldcs(ent + q);  // streamed once: leave L2 to the values
#else
  return ent[q];
#endif
}

K5_FN double k7_term(const double* ev, const unsigned* ent, long long q) {
  const unsigned u = k7_entry(ent, q);
  const double v = ev[u & kIndex];
  return (u & kMinus) ? -v : v;
}

// Lane ``lane``'s partial sum of the entries [q0, q1) of one target.
K5_FN double k7_lane_sum(const double* ev, const unsigned* ent, long long q0,
                         long long q1, int lane) {
  double acc = 0.0;
  for (long long q = q0 + lane; q < q1; q += kLanes)
    acc = acc + k7_term(ev, ent, q);
  return acc;
}

// The 32 partials folded as lane 0 of the warp's xor butterfly folds
// them (``x`` is overwritten).
K5_FN double k7_fold32(double* x) {
  for (int off = kLanes / 2; off >= 1; off >>= 1)
    for (int l = 0; l < off; ++l) x[l] = x[l] + x[l + off];
  return x[0];
}
