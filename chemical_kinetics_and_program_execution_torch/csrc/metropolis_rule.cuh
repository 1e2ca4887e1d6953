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
// The card holds a chain as bits (`McBits`) and runs its rounds on one
// warp where rs <= 32, a lane a trial, finding the conflicts by the keys
// of `mc_conflict_mask` instead of a loop over the earlier trials; it
// counts the islands a 32-bit word at a time (`mc_count_word`), on rings
// of 64 sites or more.
//
// Plain C++ under `g++` as well (`mc_host_run` runs the rule's phases in
// turn on a chain of bytes; `mc_host_run_bits` runs the card's form: bits,
// the warp's conflict keys, the word count), so a CPU test holds the
// rule and the card's form to the plain version.

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

// The acceptance of a trial at site s with uniform u, against the
// round-start chain.
template <typename Chain>
MC_FN bool mc_accept(const Chain& chain, int s, double u, const McArgs& a) {
  const int left = chain[mc_wrap(s - 1, a.N)];
  const int mid = chain[s];
  const int right = chain[mc_wrap(s + 1, a.N)];
  const int same = (left == mid ? 1 : 0) + (mid == right ? 1 : 0);
  return u < a.thr[2 * same + mid];
}

// Phase 1 of trial i of a round: its flip survives.
template <typename Chain>
MC_FN bool mc_trial(const Chain& chain, const int* sites, int i, double u,
                    const McArgs& a) {
  const int s = sites[i];
  bool conflict = false;
  for (int j = 0; j < i; ++j) {
    int d = sites[j] - s;
    d = d < 0 ? -d : d;
    d = d < a.N - d ? d : a.N - d;
    conflict = conflict || d <= 1;
  }
  return mc_accept(chain, s, u, a) && !conflict;
}

// The warp form's conflict keys. Two sites lie within circular distance
// 1 exactly when they share the key s >> 1, or the key (s + 1) >> 1, or
// are the ring's two ends (0 and N - 1): of two sites at most 1 apart,
// the lower is even (one pair under the first key) or odd (under the
// second), and two sites of one pair under either key are at most 1
// apart. The card forms the mask of matching lanes by __match_any_sync
// on each key and two ballots; `mc_conflict_mask` is its twin.
MC_FN int mc_key0(int s) { return s >> 1; }
MC_FN int mc_key1(int s) { return (s + 1) >> 1; }

// The lanes j < i of a round's first n trials whose sites conflict with
// trial i's by the keys (the host's twin of the card's warp mask).
MC_FN uint32_t mc_conflict_mask(const int* sites, int n, int N, int i) {
  const int s = sites[i];
  uint32_t m = 0;
  for (int j = 0; j < i && j < n; ++j) {
    const int t = sites[j];
    const bool hit = mc_key0(t) == mc_key0(s) || mc_key1(t) == mc_key1(s) ||
                     (s == 0 && t == N - 1) || (s == N - 1 && t == 0);
    m |= hit ? 1u << j : 0u;
  }
  return m;
}

MC_FN int mc_popc(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// 32 sites of a ring of N >= 64 held as bits, from site i (0 <= i < N):
// site i + t at bit t, sites past N - 1 wrapping to 0. The bits of the
// last word past N are 0.
MC_FN uint32_t mc_ring32(const uint32_t* w, int N, int i) {
  const int W = (N + 31) >> 5;
  const int q = i >> 5, r = i & 31;
  const uint64_t lo = w[q];
  const uint64_t hi = q + 1 < W ? w[q + 1] : 0u;
  const uint32_t x = (uint32_t)((lo | (hi << 32)) >> r);
  const int left = N - i;  // sites before the wrap
  if (left >= 32) return x;
  return (x & ((1u << left) - 1u)) | (w[0] << left);
}

// The islands that start in word wd of a ring of N >= 64 held as bits,
// added to cnt[1..5] (what `mc_island_site` adds over the word's sites):
// z holds the 64 sites from the word's first (wrapping), ``prev`` the
// site before it; bit t of ``run`` after L - 1 steps marks the sites
// s0 + t whose site before is 0 and whose L sites from s0 + t are 1, and
// run & ~(z >> L) those where the site after them is 0: the starts of
// up-runs of exact length L. The last word of a ring whose N is not a
// multiple of 32 counts only its sites below N.
MC_FN void mc_count_word(const uint32_t* w, int N, int wd,
                         int (&cnt)[kMcCols]) {
  const int s0 = wd << 5;
  const int nv = N - s0 < 32 ? N - s0 : 32;
  const int s1 = s0 + 32 < N ? s0 + 32 : s0 + 32 - N;
  const uint64_t z =
      (uint64_t)mc_ring32(w, N, s0) | ((uint64_t)mc_ring32(w, N, s1) << 32);
  const int pi = s0 == 0 ? N - 1 : s0 - 1;
  const uint64_t prev = (w[pi >> 5] >> (pi & 31)) & 1u;
  const uint32_t valid = nv == 32 ? ~0u : (1u << nv) - 1u;
  uint64_t run = z & ~((z << 1) | prev);
#pragma unroll
  for (int L = 1; L < kMcCols; ++L) {
    cnt[L] += mc_popc((uint32_t)(run & ~(z >> L)) & valid);
    run &= z >> L;
  }
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
// ``count_first``). ``threads`` counting threads, each summing its share
// (sites, or words in the card's form) t, t + threads, ..., the partial
// sums added in thread order (integers: any order gives the kernel's
// counts).
//
// Without ``bits`` (`mc_host_run`) the rule's phases in turn on a chain
// of bytes: `mc_trial`, the flips, `mc_island_site`. With ``bits``
// (`mc_host_run_bits`) the card's form: the chain as `McBits` words, a
// flip an XOR of its bit; where rs <= 32 a trial survives when
// `mc_accept` holds and `mc_conflict_mask` is empty (the warp's keys),
// else by `mc_trial`; the islands by `mc_count_word` where N >= 64,
// else by `mc_island_site`.
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
  const int W = (N + 31) / 32;
  std::vector<unsigned char> c(N), flag(rs);
  std::vector<uint32_t> w(W);
  const McBits cb{w.data()};
  auto site = [&](int i) { return bits ? cb[i] : (int)c[i]; };
  auto count = [&](int* out) {
    long long tot[kMcCols] = {0, 0, 0, 0, 0, 0};
    for (int t = 0; t < threads; ++t) {
      int cnt[kMcCols] = {0, 0, 0, 0, 0, 0};
      if (bits && N >= 64) {
        for (int wd = t; wd < W; wd += threads)
          mc_count_word(w.data(), N, wd, cnt);
      } else {
        for (int i = t; i < N; i += threads) {
          if (bits)
            mc_island_site(cb, N, i, cnt);
          else
            mc_island_site(c.data(), N, i, cnt);
        }
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
        const int* rsites = sites + base;
        for (int i = 0; i < rs; ++i) {
          if (!bits)
            flag[i] = mc_trial(c.data(), rsites, i, u[base + i], a);
          else if (rs <= 32)
            flag[i] = mc_accept(cb, rsites[i], u[base + i], a) &&
                      !mc_conflict_mask(rsites, rs, N, i);
          else
            flag[i] = mc_trial(cb, rsites, i, u[base + i], a);
        }
        for (int i = 0; i < rs; ++i) {
          if (!flag[i]) continue;
          const int s = rsites[i];
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

// The word count alone on T rings [T, N] int32 of 0/1 into counts [T, 6]
// (`mc_count_word` over every word, N >= 64; `mc_island_site` below).
extern "C" int mc_host_count_words(int T, int N, const int* chains,
                                   int* counts) {
  if (N < 1) return 1;
  const int W = (N + 31) / 32;
  std::vector<uint32_t> w(W);
  for (int ch = 0; ch < T; ++ch) {
    for (auto& x : w) x = 0;
    for (int i = 0; i < N; ++i)
      w[i >> 5] |= (uint32_t)(chains[(long long)ch * N + i] & 1) << (i & 31);
    int cnt[kMcCols] = {0, 0, 0, 0, 0, 0};
    if (N >= 64) {
      for (int wd = 0; wd < W; ++wd) mc_count_word(w.data(), N, wd, cnt);
    } else {
      const McBits cb{w.data()};
      for (int i = 0; i < N; ++i) mc_island_site(cb, N, i, cnt);
    }
    for (int L = 0; L < kMcCols; ++L) counts[ch * kMcCols + L] = cnt[L];
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
