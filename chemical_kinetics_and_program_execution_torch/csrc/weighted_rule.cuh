// K13's rule: the weighted window histogram sum_b w[b] * counts_b / L of
// the JAX package's `engine/ensemble.py:weighted_window_counts`, in one
// fixed order.
//
// Windows: every circular length-cl_k window of each member's row, its
// bin by K2's rule (`window_rule.cuh`: the int32 Horner rank, a rank in
// [-n, 0) in bin rank + n, any other outside [0, n) dropped). Each
// member's counts are exact integers. The sum: block g of the launch
// takes members [g*per, (g+1)*per) in order and, for each, adds
// w[b] * count to the block's partial of every bin the member counts
// (one addition a bin a member, so the order of a member's windows
// does not matter), each partial starting at 0.0; then each bin's
// partials are added in block order from 0.0 and divided by L. No float
// atomics: two runs give the same bits, and the plain version
// (`ensemble.weighted_window_counts_plain`), which also adds w[b] * 0 =
// 0.0 for the bins a member misses (leaving the partial's bits as they
// are), gives them too. Plain C++ under `g++` as well: `k13_host` walks
// the launch's blocks in turn, so a CPU test holds the rule to the plain
// version bit for bit.

#pragma once

#include "window_rule.cuh"

#ifdef __CUDACC__
#define K13_FN __host__ __device__ __forceinline__
#else
#include <stddef.h>

#include <vector>
#define K13_FN static inline
#endif

// The bin of the window that starts at column i of a row of L symbols,
// or -1 when the reference drops it.
K13_FN int k13_window_bin(const int* row, int L, int i, int size_a,
                          int cl_k, int n_bins) {
  unsigned int rank = 0u;
  int col = i;
  for (int j = 0; j < cl_k; ++j) {
    rank = k2_rank_step(rank, size_a, row[col]);
    if (++col == L) col = 0;
  }
  return k2_bin(rank, n_bins);
}

#ifndef __CUDACC__
// The launch on the host: each block's members in turn, then the sum of
// the partials in block order.
static inline void k13_host(const int* tape, const double* w, int B, int L,
                            int size_a, int cl_k, int per, double* out) {
  int n_bins = 1;
  for (int j = 0; j < cl_k; ++j) n_bins *= size_a;
  const int groups = (B + per - 1) / per;
  std::vector<long long> hist(n_bins, 0);
  std::vector<double> partial((size_t)groups * n_bins, 0.0);
  for (int g = 0; g < groups; ++g) {
    double* acc = partial.data() + (size_t)g * n_bins;
    const int end = (g + 1) * per < B ? (g + 1) * per : B;
    for (int b = g * per; b < end; ++b) {
      const int* row = tape + (long long)b * L;
      for (int i = 0; i < L; ++i) {
        const int bin = k13_window_bin(row, L, i, size_a, cl_k, n_bins);
        if (bin >= 0) ++hist[bin];
      }
      for (int x = 0; x < n_bins; ++x)
        if (hist[x]) {
          acc[x] = acc[x] + w[b] * (double)hist[x];
          hist[x] = 0;
        }
    }
  }
  for (int x = 0; x < n_bins; ++x) {
    double s = 0.0;
    for (int g = 0; g < groups; ++g) s = s + partial[(size_t)g * n_bins + x];
    out[x] = s / (double)L;
  }
}

extern "C" void ckpe_k13_host(const int* tape, const double* w, int B,
                              int L, int size_a, int cl_k, int per,
                              double* out) {
  k13_host(tape, w, B, L, size_a, cl_k, per, out);
}
#endif
