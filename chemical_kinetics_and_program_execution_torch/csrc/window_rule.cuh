// K2's per-site rule: a window's rank and the bin that counts it, as the
// JAX package's `engine/ensemble.py:window_counts` computes them.
//
// The reference's rank is an int32 Horner sum over the window's symbols,
// r = r * size_a + symbol, which wraps; its scatter `.at[r].add(1)` then
// reads a rank in [-n, 0) as bin r + n (numpy's rule for negative
// indices) and drops any other rank outside [0, n), n = size_a**cl_k.
// The sum is taken in uint32, whose wrap is defined, and read as a
// two's-complement int at the end. Plain C++ under `g++` as well, so a
// CPU test holds it to `window_counts_plain`.

#pragma once

#ifdef __CUDACC__
#define K2_FN __host__ __device__ __forceinline__
#else
#define K2_FN static inline
#endif

// One Horner step of the rank: the rank of the window so far, times
// size_a, plus the next symbol, modulo 2**32.
K2_FN unsigned int k2_rank_step(unsigned int rank, int size_a, int symbol) {
  return rank * (unsigned int)size_a + (unsigned int)symbol;
}

// The bin that counts a window of ``rank`` among ``n_bins`` = size_a**cl_k
// (< 2**31), or -1 when the reference drops it.
K2_FN int k2_bin(unsigned int rank, int n_bins) {
  int r = (int)rank;
  if (r < 0) r += n_bins;
  return (unsigned int)r < (unsigned int)n_bins ? r : -1;
}
