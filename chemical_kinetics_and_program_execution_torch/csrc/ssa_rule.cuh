// K27's rule: one event of the direct-method SSA for one trajectory.
//
// The JAX package's `models/gillespie.py:194-226` (the `lax.scan` body of
// `ssa_batch_tm`) in the working type T (float or double), for one
// trajectory; the port's plain version is `models/gillespie.py:
// ssa_round_plain`. What it keeps of the XLA program, in its order:
//
//   prop[r] = T(rate[r]) * prod over s, then j < order[r][s] of
//             max(T(n[s]) - j, 0)                      (falling factorials)
//   total   = prop[0] + prop[1] + ... (reaction order)
//   dt      = total > 0 ? -log1p(-u0) / max(total, T(1e-30)) : inf,
//             formed in T and widened to double before t + dt
//   r       = min(#{r : u1 * total >= cum[r]}, R - 1), cum the running
//             sum in reaction order
//   n      += stoich[r] where total > 0
//
// The network is launch data: `ssa_build_net` turns reactant orders,
// stoichiometry and rates into each reaction's factor list (species s,
// offset j) in the order s, then j, for R <= 32 reactions, S <= 8
// species and at most 8 factors a reaction. A network past any of those
// limits takes the wide form (`SsaWide`): the same factor lists, built
// by the caller, read from global memory, the counts kept in the state
// array itself, and each reaction's propensity formed again for the
// running sum (the same operations in the same order, so the same bits).
//
// Plain C++ under `g++` as well (`ssa_host_run`), so a CPU test holds the
// rule to the plain version.

#pragma once

#ifdef __CUDACC__
#define SSA_FN __host__ __device__ __forceinline__
#else
#include <cmath>
#define SSA_FN static inline
#endif

constexpr int kSsaMaxR = 32;
constexpr int kSsaMaxS = 8;
constexpr int kSsaMaxFactors = 8;

struct SsaNet {
  int R, S;
  int n_fac[kSsaMaxR];
  int fac_s[kSsaMaxR][kSsaMaxFactors];
  int fac_j[kSsaMaxR][kSsaMaxFactors];
  int stoich[kSsaMaxR][kSsaMaxS];
  double rate[kSsaMaxR];
};

// The network from row-major reactant orders [R, S], stoichiometry [R, S]
// and rates [R]; false when it exceeds the limits above.
static inline bool ssa_build_net(const int* order, const int* stoich,
                                 const double* rates, int R, int S,
                                 SsaNet* g) {
  if (R < 1 || R > kSsaMaxR || S < 1 || S > kSsaMaxS) return false;
  g->R = R;
  g->S = S;
  for (int r = 0; r < kSsaMaxR; ++r) {
    g->n_fac[r] = 0;
    g->rate[r] = r < R ? rates[r] : 0.0;
    for (int s = 0; s < kSsaMaxS; ++s)
      g->stoich[r][s] = (r < R && s < S) ? stoich[r * S + s] : 0;
    for (int q = 0; q < kSsaMaxFactors; ++q) g->fac_s[r][q] = g->fac_j[r][q] = 0;
  }
  for (int r = 0; r < R; ++r)
    for (int s = 0; s < S; ++s) {
      const int m = order[r * S + s];
      if (m < 0) return false;
      for (int j = 0; j < m; ++j) {
        if (g->n_fac[r] == kSsaMaxFactors) return false;
        g->fac_s[r][g->n_fac[r]] = s;
        g->fac_j[r][g->n_fac[r]] = j;
        ++g->n_fac[r];
      }
    }
  return true;
}

SSA_FN float ssa_log1p(float x) { return log1pf(x); }
SSA_FN double ssa_log1p(double x) { return log1p(x); }

// v[s] for a species index s that is the same in every thread of a warp;
// a select over the unrolled entries keeps v in registers.
template <typename T>
SSA_FN T ssa_pick(const T (&v)[kSsaMaxS], int s) {
  T x = v[0];
#pragma unroll
  for (int q = 1; q < kSsaMaxS; ++q)
    if (q == s) x = v[q];
  return x;
}

// One event: the counts n and the time t advance as the header says.
template <typename T>
SSA_FN void ssa_event(const SsaNet& g, int (&n)[kSsaMaxS], double& t, T u0,
                      T u1) {
  T nf[kSsaMaxS];
#pragma unroll
  for (int s = 0; s < kSsaMaxS; ++s) nf[s] = (T)n[s];
  T prop[kSsaMaxR];
  T total = (T)0;
#pragma unroll
  for (int r = 0; r < kSsaMaxR; ++r) {
    if (r < g.R) {
      T p = (T)g.rate[r];
      for (int q = 0; q < g.n_fac[r]; ++q) {
        const T x = ssa_pick(nf, g.fac_s[r][q]) - (T)g.fac_j[r][q];
        p = p * (x > (T)0 ? x : (T)0);
      }
      prop[r] = p;
      total = r == 0 ? p : total + p;
    }
  }
  const bool alive = total > (T)0;
  const T floor = (T)1e-30;
  const T dt = alive ? -ssa_log1p(-u0) / (total > floor ? total : floor)
                     : (T)INFINITY;
  t = t + (double)dt;
  const T uu = u1 * total;
  T cum = (T)0;
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kSsaMaxR; ++r) {
    if (r < g.R) {
      cum = r == 0 ? prop[r] : cum + prop[r];
      cnt += uu >= cum ? 1 : 0;
    }
  }
  const int rr = cnt < g.R - 1 ? cnt : g.R - 1;
  if (alive) {
#pragma unroll
    for (int s = 0; s < kSsaMaxS; ++s)
      if (s < g.S) n[s] += g.stoich[rr][s];
  }
}

// Trajectory b over E events from its state (t_state[b], n_state[s*B+b]):
// draws u [E, 2, B] (u0 then u1 of each event), outputs time-major
// t_out [E, B] and n_out [E, S, B]; the state is written back.
template <typename T>
SSA_FN void ssa_trajectory(const SsaNet& g, const T* u, long long B, int E,
                           long long b, double* t_state, int* n_state,
                           double* t_out, int* n_out) {
  double t = t_state[b];
  int n[kSsaMaxS];
#pragma unroll
  for (int s = 0; s < kSsaMaxS; ++s) n[s] = s < g.S ? n_state[s * B + b] : 0;
  for (int e = 0; e < E; ++e) {
    const T u0 = u[(2LL * e) * B + b];
    const T u1 = u[(2LL * e + 1) * B + b];
    ssa_event<T>(g, n, t, u0, u1);
    t_out[(long long)e * B + b] = t;
#pragma unroll
    for (int s = 0; s < kSsaMaxS; ++s)
      if (s < g.S) n_out[((long long)e * g.S + s) * B + b] = n[s];
  }
  t_state[b] = t;
#pragma unroll
  for (int s = 0; s < kSsaMaxS; ++s)
    if (s < g.S) n_state[s * B + b] = n[s];
}

// The wide form: factor q of reaction r (q in [fac_lo[r], fac_lo[r+1]))
// is species fac_s[q] at offset fac_j[q]; stoich [R, S] row-major.
struct SsaWide {
  int R, S;
  const int* fac_lo;
  const int* fac_s;
  const int* fac_j;
  const int* stoich;
  const double* rate;
};

// Reaction r's propensity at the counts n[s * B] (a trajectory's column).
template <typename T>
SSA_FN T ssa_wide_prop(const SsaWide& g, const int* n, long long B, int r) {
  T p = (T)g.rate[r];
  for (int q = g.fac_lo[r]; q < g.fac_lo[r + 1]; ++q) {
    const T x = (T)n[(long long)g.fac_s[q] * B] - (T)g.fac_j[q];
    p = p * (x > (T)0 ? x : (T)0);
  }
  return p;
}

// `ssa_event` in the wide form, on the counts n[s * B] in place.
template <typename T>
SSA_FN void ssa_wide_event(const SsaWide& g, int* n, long long B, double& t,
                           T u0, T u1) {
  T total = (T)0;
  for (int r = 0; r < g.R; ++r) {
    const T p = ssa_wide_prop<T>(g, n, B, r);
    total = r == 0 ? p : total + p;
  }
  const bool alive = total > (T)0;
  const T floor = (T)1e-30;
  const T dt = alive ? -ssa_log1p(-u0) / (total > floor ? total : floor)
                     : (T)INFINITY;
  t = t + (double)dt;
  const T uu = u1 * total;
  T cum = (T)0;
  int cnt = 0;
  for (int r = 0; r < g.R; ++r) {
    const T p = ssa_wide_prop<T>(g, n, B, r);
    cum = r == 0 ? p : cum + p;
    cnt += uu >= cum ? 1 : 0;
  }
  const int rr = cnt < g.R - 1 ? cnt : g.R - 1;
  if (alive)
    for (int s = 0; s < g.S; ++s)
      n[(long long)s * B] += g.stoich[(long long)rr * g.S + s];
}

// `ssa_trajectory` in the wide form: the counts stay in n_state.
template <typename T>
SSA_FN void ssa_wide_trajectory(const SsaWide& g, const T* u, long long B,
                                int E, long long b, double* t_state,
                                int* n_state, double* t_out, int* n_out) {
  double t = t_state[b];
  int* n = n_state + b;
  for (int e = 0; e < E; ++e) {
    const T u0 = u[(2LL * e) * B + b];
    const T u1 = u[(2LL * e + 1) * B + b];
    ssa_wide_event<T>(g, n, B, t, u0, u1);
    t_out[(long long)e * B + b] = t;
    for (int s = 0; s < g.S; ++s)
      n_out[((long long)e * g.S + s) * B + b] = n[(long long)s * B];
  }
  t_state[b] = t;
}

#ifndef __CUDACC__
// The wide launch on the host: every trajectory in turn.
extern "C" int ssa_host_run_wide(const int* fac_lo, const int* fac_s,
                                 const int* fac_j, const int* stoich,
                                 const double* rates, int R, int S,
                                 int is_double, const void* u, long long B,
                                 int E, double* t_state, int* n_state,
                                 double* t_out, int* n_out) {
  if (R < 1 || S < 1) return 1;
  const SsaWide g{R, S, fac_lo, fac_s, fac_j, stoich, rates};
  for (long long b = 0; b < B; ++b) {
    if (is_double)
      ssa_wide_trajectory<double>(g, (const double*)u, B, E, b, t_state,
                                  n_state, t_out, n_out);
    else
      ssa_wide_trajectory<float>(g, (const float*)u, B, E, b, t_state,
                                 n_state, t_out, n_out);
  }
  return 0;
}

// The launch on the host: every trajectory in turn (``is_double`` picks T).
// Returns 0, or 1 when the network exceeds the limits.
extern "C" int ssa_host_run(const int* order, const int* stoich,
                            const double* rates, int R, int S, int is_double,
                            const void* u, long long B, int E,
                            double* t_state, int* n_state, double* t_out,
                            int* n_out) {
  SsaNet g;
  if (!ssa_build_net(order, stoich, rates, R, S, &g)) return 1;
  for (long long b = 0; b < B; ++b) {
    if (is_double)
      ssa_trajectory<double>(g, (const double*)u, B, E, b, t_state, n_state,
                             t_out, n_out);
    else
      ssa_trajectory<float>(g, (const float*)u, B, E, b, t_state, n_state,
                            t_out, n_out);
  }
  return 0;
}
#endif
