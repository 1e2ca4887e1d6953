// K28 `metropolis`: steps of the conflict-masked Metropolis chains.
//
// Replaces the JAX package's `models/ferromagnet.py:95
// simulate_metropolis` (its scan over steps, `do_round` under
// `fori_loop`, `island_counts`; XLA, vmapped over chains by
// `mc_island_history` `:166`; no Pallas kernel). Plain PyTorch version:
// `models/ferromagnet.py:metropolis_plain`; the rule is
// `metropolis_rule.cuh`.
//
// One block a chain, which lives as bytes in dynamic shared memory (N
// bytes: 50,000 at the example's width, above the 48 KB default, so the
// launch raises the kernel's limit) for the whole chunk of steps. Each
// round: the round's sites to shared memory; barrier; phase 1, a thread
// a trial, against the round-start chain and the earlier trials'
// sites; barrier; phase 2, the surviving flips XOR in; barrier. After a
// step's last round every thread counts the islands that start at its
// sites t, t + blockDim, ..., warp shuffles and then warp 0 add the
// partials in warp order, and thread 0 writes counts[chain, step, 0..5].
// A chain too long for a byte a site in the block's 227 KB (past about
// 229,000 sites at 25 trials a round) is held as bits instead (the
// caller chooses by the geometry, `ferromagnet.k28_bits`): a warp packs
// 32 sites into a word by a ballot, a surviving flip is an atomic XOR of
// its bit (order-free: no two flips of a round share a site), and the
// rule reads the chain through `McBits`; up to about 1.8 million sites.
// Bound: bytes (each trial's int32 site and float64 uniform read once,
// the chains read and written once, the counts written); what holds the
// block is the barriers of the rounds and the island pass over every
// site a step. At 100 chains the grid is one partial wave on 132 SMs.

#include <cuda_runtime.h>

#include "metropolis_rule.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <typename Chain>
__device__ __forceinline__ void k28_count(const Chain& c, int N,
                                          int (*red)[kMcCols], int* out) {
  int cnt[kMcCols] = {0, 0, 0, 0, 0, 0};
  for (int i = threadIdx.x; i < N; i += kThreads) mc_island_site(c, N, i, cnt);
#pragma unroll
  for (int L = 1; L < kMcCols; ++L) {
    int v = cnt[L];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][L] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    out[0] = 0;
    for (int L = 1; L < kMcCols; ++L) {
      int v = 0;
      for (int w = 0; w < kWarps; ++w) v += red[w][L];
      out[L] = v;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    k28_kernel(McArgs a, int* chains, const int* __restrict__ sites,
               const double* __restrict__ u, int steps, int count_first,
               int* counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[kWarps][kMcCols];
  const int N = a.N, rs = a.rs;
  unsigned char* c = smem;
  int* ssite = reinterpret_cast<int*>(smem + ((N + 15) & ~15));
  unsigned char* flag = reinterpret_cast<unsigned char*>(ssite + rs);
  const long long ch = blockIdx.x;
  for (int i = threadIdx.x; i < N; i += kThreads)
    c[i] = (unsigned char)chains[ch * N + i];
  __syncthreads();
  int* out = counts + ch * (long long)(steps + count_first) * kMcCols;
  if (count_first) {
    k28_count(c, N, red, out);
    out += kMcCols;
  }
  for (int st = 0; st < steps; ++st) {
    for (int r = 0; r < a.rounds; ++r) {
      const long long base = ((ch * steps + st) * a.rounds + r) * rs;
      for (int i = threadIdx.x; i < rs; i += kThreads)
        ssite[i] = sites[base + i];
      __syncthreads();
      for (int i = threadIdx.x; i < rs; i += kThreads)
        flag[i] = mc_trial(c, ssite, i, u[base + i], a) ? 1 : 0;
      __syncthreads();
      for (int i = threadIdx.x; i < rs; i += kThreads)
        if (flag[i]) c[ssite[i]] ^= 1;
      __syncthreads();
    }
    k28_count(c, N, red, out);
    out += kMcCols;
  }
  for (int i = threadIdx.x; i < N; i += kThreads) chains[ch * N + i] = c[i];
}

// The chain as bits (`McBits`), the rounds and counts as above.
__global__ void __launch_bounds__(kThreads)
    k28_bits_kernel(McArgs a, int* chains, const int* __restrict__ sites,
                    const double* __restrict__ u, int steps, int count_first,
                    int* counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[kWarps][kMcCols];
  const int N = a.N, rs = a.rs, W = (N + 31) >> 5;
  uint32_t* w = reinterpret_cast<uint32_t*>(smem);
  int* ssite = reinterpret_cast<int*>(smem + (((size_t)W * 4 + 15) & ~15));
  unsigned char* flag = reinterpret_cast<unsigned char*>(ssite + rs);
  const McBits c{w};
  const long long ch = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x - lane; base < N; base += kThreads) {
    const int i = base + lane;
    const unsigned word =
        __ballot_sync(0xffffffffu, i < N && chains[ch * N + i] != 0);
    if (lane == 0) w[base >> 5] = word;
  }
  __syncthreads();
  int* out = counts + ch * (long long)(steps + count_first) * kMcCols;
  if (count_first) {
    k28_count(c, N, red, out);
    out += kMcCols;
  }
  for (int st = 0; st < steps; ++st) {
    for (int r = 0; r < a.rounds; ++r) {
      const long long base = ((ch * steps + st) * a.rounds + r) * rs;
      for (int i = threadIdx.x; i < rs; i += kThreads)
        ssite[i] = sites[base + i];
      __syncthreads();
      for (int i = threadIdx.x; i < rs; i += kThreads)
        flag[i] = mc_trial(c, ssite, i, u[base + i], a) ? 1 : 0;
      __syncthreads();
      for (int i = threadIdx.x; i < rs; i += kThreads)
        if (flag[i]) atomicXor(&w[ssite[i] >> 5], 1u << (ssite[i] & 31));
      __syncthreads();
    }
    k28_count(c, N, red, out);
    out += kMcCols;
  }
  for (int i = threadIdx.x; i < N; i += kThreads) chains[ch * N + i] = c[i];
}

}  // namespace

// ``steps`` steps of T chains (``chains`` [T, N] int32 of 0/1, advanced
// in place) on draws ``sites`` [T, steps, rounds, rs] int32 in [0, N) and
// ``u`` [T, steps, rounds, rs] float64, thresholds ``thr`` [6] (host);
// ``counts`` [T, steps + count_first, 6] int32, the chains before the
// first step first when ``count_first``. ``bits`` holds the chains as
// bits (the caller's choice by the geometry); the dynamic shared memory
// is the chain's bytes or words, rounded to 16, then 5 bytes a trial.
extern "C" int ckpe_metropolis(int T, int N, int rounds, int rs,
                               const double* thr, int* chains,
                               const int* sites, const double* u, int steps,
                               int count_first, int* counts, int bits,
                               cudaStream_t stream) {
  if (T < 1 || N < 1 || rounds < 0 || rs < 1 || steps < 0)
    return (int)cudaErrorInvalidValue;
  McArgs a;
  a.N = N;
  a.rounds = rounds;
  a.rs = rs;
  for (int q = 0; q < 6; ++q) a.thr[q] = thr[q];
  const size_t chain = bits ? (((size_t)N + 31) >> 5) * 4 : (size_t)N;
  const size_t bytes = ((chain + 15) & ~(size_t)15) + (size_t)rs * 5;
  const void* fn = bits ? (const void*)k28_bits_kernel : (const void*)k28_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (bits)
    k28_bits_kernel<<<(unsigned)T, kThreads, bytes, stream>>>(
        a, chains, sites, u, steps, count_first ? 1 : 0, counts);
  else
    k28_kernel<<<(unsigned)T, kThreads, bytes, stream>>>(
        a, chains, sites, u, steps, count_first ? 1 : 0, counts);
  return (int)cudaGetLastError();
}
