// K28's rule: a step of the conflict-masked Metropolis chain on a ring.
//
// The JAX package's `models/ferromagnet.py:95 simulate_metropolis`
// (`do_round` `:111-126`, `island_counts` `:128-142`, the acceptance
// `_flip_acceptance` `:71-91`); the port's plain version is
// `models/ferromagnet.py:metropolis_plain`. A chain is N sites of 0/1.
// A step is ``rounds`` rounds of ``rs`` trials; a round has two phases:
//
//   1. trial i at site s with uniform u: left, mid, right the round-start
//      values at s - 1, s, s + 1 (mod N), same = (left == mid) + (mid ==
//      right); accepted when u < thr[2 * same + mid] (`mc_trial`), and
//      dropped when any earlier trial j < i of the round, accepted or
//      not, lies within circular distance 1 (min(|s_i - s_j|, N - |s_i -
//      s_j|) <= 1, the same site included);
//   2. the surviving flips XOR in (no two share a site).
//
// ``thr`` holds the six thresholds exp(-beta J (e + 4)) times the field
// factor (branching on h > 0), formed on the host in float64 as the JAX
// package forms them (`models/ferromagnet.py:acceptance_table`). After
// the last round, the up-islands of exact length L = 1..5 over the ring:
// site i starts one when chain[i-1] = 0, chain[i..i+L-1] = 1 and
// chain[i+L] = 0 (`mc_island_site`, the JAX product formula's terms);
// column 0 is 0 and longer runs count nowhere.
//
// Plain C++ under `g++` as well (`mc_host_run` runs the block's phases in
// turn, `mc_host_run_bits` on a chain held as bits), so a CPU test holds
// the rule to the plain version.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define MC_FN __host__ __device__ __forceinline__
#define MC_MEMBER __host__ __device__ __forceinline__
#else
#define MC_FN static inline
#define MC_MEMBER inline
#endif

constexpr int kMcCols = 6;  // island-count columns: 0 (unused), L = 1..5

// A chain held as bits, site i at bit i & 31 of word i >> 5: the form a
// chain too long for a byte a site in shared memory takes. The rule
// reads a chain through `chain[i]`, so a byte pointer or this serves.
struct McBits {
  const uint32_t* w;
  MC_MEMBER int operator[](int i) const {
    return (int)((w[i >> 5] >> (i & 31)) & 1u);
  }
};

struct McArgs {
  int N, rounds, rs;
  double thr[6];  // by 2 * same + mid
};

// i mod N for i in [-N, 2N).
MC_FN int mc_wrap(int i, int N) {
  return i < 0 ? i + N : (i >= N ? i - N : i);
}

// Phase 1 of trial i of a round: its flip survives.
template <typename Chain>
MC_FN bool mc_trial(const Chain& chain, const int* sites, int i, double u,
                    const McArgs& a) {
  const int s = sites[i];
  const int left = chain[mc_wrap(s - 1, a.N)];
  const int mid = chain[s];
  const int right = chain[mc_wrap(s + 1, a.N)];
  const int same = (left == mid ? 1 : 0) + (mid == right ? 1 : 0);
  bool conflict = false;
  for (int j = 0; j < i; ++j) {
    int d = sites[j] - s;
    d = d < 0 ? -d : d;
    d = d < a.N - d ? d : a.N - d;
    conflict = conflict || d <= 1;
  }
  return u < a.thr[2 * same + mid] && !conflict;
}

// The islands that start at site i, added to cnt[1..5].
template <typename Chain>
MC_FN void mc_island_site(const Chain& c, int N, int i,
                          int (&cnt)[kMcCols]) {
  int run = 1 - c[mc_wrap(i - 1, N)];
  int j = i;
#pragma unroll
  for (int L = 1; L < kMcCols; ++L) {
    run &= c[j];
    j = mc_wrap(j + 1, N);
    cnt[L] += run & (1 - c[j]);
  }
}

#ifndef __CUDACC__
// A launch on the host, one chain at a time: ``chains`` [T, N] int32
// advanced in place over ``steps`` steps of draws ``sites`` [T, steps,
// rounds, rs] and ``u`` (float64, alike); ``counts`` [T, steps +
// count_first, 6] (the chain before the first step first when
// ``count_first``). Every phase in turn; ``threads`` the block's width,
// each thread summing the sites t, t + threads, ... and the block's
// partial sums added in thread order (integers: any order gives the
// kernel's counts).
// With ``bits`` the chain is held as `McBits` words, as the kernel holds
// a chain too long for a byte a site, and a flip is an XOR of its bit.
#include <vector>
static int mc_host_run_impl(int T, int N, int rounds, int rs,
                            const double* thr, int* chains, const int* sites,
                            const double* u, int steps, int count_first,
                            int threads, int* counts, bool bits) {
  if (N < 1 || rs < 1 || threads < 1) return 1;
  McArgs a;
  a.N = N;
  a.rounds = rounds;
  a.rs = rs;
  for (int q = 0; q < 6; ++q) a.thr[q] = thr[q];
  std::vector<unsigned char> c(N), flag(rs);
  std::vector<uint32_t> w((N + 31) / 32);
  const McBits cb{w.data()};
  auto site = [&](int i) { return bits ? cb[i] : (int)c[i]; };
  auto count = [&](int* out) {
    long long tot[kMcCols] = {0, 0, 0, 0, 0, 0};
    for (int t = 0; t < threads; ++t) {
      int cnt[kMcCols] = {0, 0, 0, 0, 0, 0};
      for (int i = t; i < N; i += threads) {
        if (bits)
          mc_island_site(cb, N, i, cnt);
        else
          mc_island_site(c.data(), N, i, cnt);
      }
      for (int L = 0; L < kMcCols; ++L) tot[L] += cnt[L];
    }
    for (int L = 0; L < kMcCols; ++L) out[L] = (int)tot[L];
  };
  const int rows = steps + (count_first ? 1 : 0);
  for (int ch = 0; ch < T; ++ch) {
    for (auto& x : w) x = 0;
    for (int i = 0; i < N; ++i) {
      const int v = chains[(long long)ch * N + i] & 1;
      c[i] = (unsigned char)v;
      w[i >> 5] |= (uint32_t)v << (i & 31);
    }
    int* out = counts + (long long)ch * rows * kMcCols;
    if (count_first) {
      count(out);
      out += kMcCols;
    }
    for (int st = 0; st < steps; ++st) {
      for (int r = 0; r < rounds; ++r) {
        const long long base = (((long long)ch * steps + st) * rounds + r) * rs;
        for (int i = 0; i < rs; ++i)
          flag[i] = bits ? mc_trial(cb, sites + base, i, u[base + i], a)
                         : mc_trial(c.data(), sites + base, i, u[base + i], a);
        for (int i = 0; i < rs; ++i) {
          if (!flag[i]) continue;
          const int s = sites[base + i];
          c[s] ^= 1;
          w[s >> 5] ^= 1u << (s & 31);
        }
      }
      count(out);
      out += kMcCols;
    }
    for (int i = 0; i < N; ++i) chains[(long long)ch * N + i] = site(i);
  }
  return 0;
}

extern "C" int mc_host_run(int T, int N, int rounds, int rs,
                           const double* thr, int* chains, const int* sites,
                           const double* u, int steps, int count_first,
                           int threads, int* counts) {
  return mc_host_run_impl(T, N, rounds, rs, thr, chains, sites, u, steps,
                          count_first, threads, counts, false);
}

extern "C" int mc_host_run_bits(int T, int N, int rounds, int rs,
                                const double* thr, int* chains,
                                const int* sites, const double* u, int steps,
                                int count_first, int threads, int* counts) {
  return mc_host_run_impl(T, N, rounds, rs, thr, chains, sites, u, steps,
                          count_first, threads, counts, true);
}
#endif
