// K12's rule: the longest prefix of a pattern that occurs on a ring, as
// the JAX package's `engine/ensemble.py` computes `contains_pattern` and
// `pattern_progress` (the tape rolled left by j compared with symbol j
// of the pattern, for j in turn).
//
// Starting at column i, the prefix matches while row[(i + m) mod L]
// equals pattern[m] (the symbol widened to int, so an int8 tape reads
// its signed value); the ring's progress is the longest such prefix
// over every i, and the pattern is present where that is its length
// (an empty pattern is present on every ring). The first-passage update
// sets t_hit to t_now where the pattern is present and t_hit is still
// infinite. Plain C++ under `g++` as well, so a CPU test holds the rule
// to `ensemble.pattern_scan_plain`.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define K12_FN __host__ __device__ __forceinline__
#else
#define K12_FN static inline
#endif

enum { kK12Contains = 0, kK12Progress = 1, kK12FirstPassage = 2 };

template <typename Sym>
K12_FN int k12_prefix_at(const Sym* row, int L, int i, const int* pat,
                         int P) {
  int m = 0;
  int col = i;
  while (m < P && (int)row[col] == pat[m]) {
    ++m;
    if (++col == L) col = 0;
  }
  return m;
}

// Member b's result from its progress ``best``, by ``mode``.
K12_FN void k12_finish(int mode, int best, int P, void* out, double* t_hit,
                       const double* t_now, int b) {
  if (mode == kK12Contains)
    ((uint8_t*)out)[b] = best == P ? 1 : 0;
  else if (mode == kK12Progress)
    ((int*)out)[b] = best;
  else if (best == P && isinf(t_hit[b]))
    t_hit[b] = *t_now;
}

#ifndef __CUDACC__
// Every member on the host (the CPU test of the rule); elem is 1 for an
// int8 tape, 4 for int32.
extern "C" int ckpe_k12_host_scan(const void* tape, int elem, int B, int L,
                                  const int* pat, int P, int mode, void* out,
                                  double* t_hit, const double* t_now) {
  for (int b = 0; b < B; ++b) {
    int best = 0;
    for (int i = 0; i < L; ++i) {
      const int m =
          elem == 1
              ? k12_prefix_at((const int8_t*)tape + (long long)b * L, L, i,
                              pat, P)
              : k12_prefix_at((const int*)tape + (long long)b * L, L, i, pat,
                              P);
      best = m > best ? m : best;
    }
    k12_finish(mode, best, P, out, t_hit, t_now, b);
  }
  return 0;
}
#endif
