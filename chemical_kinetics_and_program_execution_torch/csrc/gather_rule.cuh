// K7's and K8's per-element rules: the gather engine's event values and
// their signed scatter (`engine/rhs.py`), as the JAX package's
// `engine/rhs.py:dy_dt_from_tables` and `dy_dt_from_chain_tables`
// compute them.
//
// The pyramid is read in two pieces, as K4's rule reads it
// (`sweep_rule.cuh:k4_pyramid`): the state vector below its size, K3's
// levels above (`engine/compile.py:two_pointer_index` maps the tables'
// flat indices there on the host).
//
//   K7 tree node    v[i] = g(pyr[num[i]], pyr[den[i]]) * v_parent[i]
//                   (level 0: the ratio alone), g the guarded ratio
//   K8 chain        v[e] = product over the chain's (num, den) of g, in
//                   chain order (K4's `k4_chain_product`)
//   scatter         dy[t] = sum over the entries q of target t of
//                   +-(v[val[q]] * s[sig[q]]), the sign folded into sig
//                   (sig < 0 holds ~sig and a minus)
//
// A target's entries are a contiguous run (they were sorted at compile
// time). A warp sums a run: lane l adds entries l, l + 32, ... from 0.0
// in entry order (`k7_lane_sum`), then the warp folds its 32 partials by
// an xor butterfly, which lane 0 reads in the order of `k7_fold32`. The
// plain version (`engine/rhs.py:scatter_plain`) adds in that order too,
// so K7 and K8 equal it bit for bit; no float atomics.
//
// Plain C++ under `g++` as well, so a CPU test holds these rules to the
// plain versions.

#pragma once

#include "sweep_rule.cuh"

constexpr int kLanes = 32;

K5_FN double k7_ratio(const K5Ctx& c, int num, int den) {
  return k5_guarded(k4_pyramid(c, num), k4_pyramid(c, den));
}

// One entry's signed term.
K5_FN double k7_term(const double* vals, const int* ent_val,
                     const int* ent_sig, const double* s, long long q) {
  int g = ent_sig[q];
  const bool neg = g < 0;
  g = neg ? ~g : g;
  const double v = vals[ent_val[q]] * s[g];
  return neg ? -v : v;
}

// Lane ``lane``'s partial sum of the entries [q0, q1) of one target.
K5_FN double k7_lane_sum(const double* vals, const int* ent_val,
                         const int* ent_sig, const double* s, long long q0,
                         long long q1, int lane) {
  double acc = 0.0;
  for (long long q = q0 + lane; q < q1; q += kLanes)
    acc = acc + k7_term(vals, ent_val, ent_sig, s, q);
  return acc;
}

// The 32 partials folded as lane 0 of the warp's xor butterfly folds
// them (``x`` is overwritten).
K5_FN double k7_fold32(double* x) {
  for (int off = kLanes / 2; off >= 1; off >>= 1)
    for (int l = 0; l < off; ++l) x[l] = x[l] + x[l + off];
  return x[0];
}
