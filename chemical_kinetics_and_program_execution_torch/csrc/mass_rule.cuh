// K9's rule: a pruned program's world mass, sum over its enumerated
// worlds w of m_const[w] times the product of w's guarded ratios in
// chain order (`engine/dense.py:world_mass_plain`).
//
// Each world's weight is K4's (`sweep_rule.cuh:k4_pair_weight` over the
// mass tables: the same guarded ratio `k5_guarded` of the same two
// pyramid values, multiplied in chain order), so it has the bits of
// K4's. The sum takes one fixed order, the order of K6's norms
// (`cuda.block_order_sum`): a launch of B = min(ceil(W / 256), 1024)
// blocks of 256 threads; thread t of block b adds worlds b*256 + t +
// q*B*256 in turn from 0.0 (`k9_thread_sum`); each block's 256 sums
// halve in a tree (the upper half added to the lower); then thread t
// adds block partials t, t + 256, ... from 0.0 and one more tree gives
// the mass. No float atomics: two runs give the same bits.
//
// Plain C++ under `g++` as well: `k9_host_mass` walks the launch's
// threads and trees in turn, so a CPU test holds the rule to the plain
// version bit for bit.

#pragma once

#include "sweep_rule.cuh"

constexpr int kK9Threads = 256;
constexpr int kK9MaxBlocks = 1024;

K5_FN int k9_blocks(int n_worlds) {
  const int b = (n_worlds + kK9Threads - 1) / kK9Threads;
  return b < 1 ? 1 : (b > kK9MaxBlocks ? kK9MaxBlocks : b);
}

// Thread ``tid`` of a launch of ``stride`` threads: the weights of worlds
// tid, tid + stride, ... summed from 0.0.
K5_FN double k9_thread_sum(const K5Ctx& c, const K4Pairs& w, int n_worlds,
                           unsigned tid, unsigned stride) {
  double acc = 0.0;
  for (unsigned q = tid; q < (unsigned)n_worlds; q += stride)
    acc = acc + k4_pair_weight(c, w, (int)q);
  return acc;
}

#ifndef __CUDACC__
// The block tree of 256 values, in place: x[t] += x[t + w] for w = 128,
// 64, ..., 1, as the kernel's threads do between barriers.
static inline double k9_tree(double* x) {
  for (int w = kK9Threads / 2; w > 0; w >>= 1)
    for (int t = 0; t < w; ++t) x[t] = x[t] + x[t + w];
  return x[0];
}

// The launch on the host: every block's threads and tree, then the last
// block's sum of the partials.
static inline double k9_host_mass(const K5Ctx& c, const K4Pairs& w,
                                  int n_worlds) {
  const int blocks = k9_blocks(n_worlds);
  const unsigned stride = (unsigned)blocks * kK9Threads;
  double x[kK9Threads];
  double partial[kK9MaxBlocks];
  for (int b = 0; b < blocks; ++b) {
    for (int t = 0; t < kK9Threads; ++t)
      x[t] = k9_thread_sum(c, w, n_worlds, (unsigned)(b * kK9Threads + t),
                           stride);
    partial[b] = k9_tree(x);
  }
  for (int t = 0; t < kK9Threads; ++t) {
    double acc = 0.0;
    for (int b = t; b < blocks; b += kK9Threads) acc = acc + partial[b];
    x[t] = acc;
  }
  return k9_tree(x);
}
#endif
