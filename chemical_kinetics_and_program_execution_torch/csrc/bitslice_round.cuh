// K14 and K17: one bit-sliced round on bit-plane words, in place,
// compiled for one circuit.
//
// K14 replaces the JAX package's `engine/bitslice.py`
// `apply_round_bitsliced` with `_eval_circuit` (an XLA program on the
// TPU); plain PyTorch version: `engine/bitslice.py:apply_round_bitsliced`.
// K17 replaces the JAX package's `engine/bff_bitslice.py:318
// apply_bff_round_bitsliced` with `engine/bitslice.py:698 _eval_circuit`
// and the per-round popcount of `bff_bitslice.py:439-442`; plain
// PyTorch version: `engine/bff_bitslice.py:apply_bff_round_bitsliced`.
//
// Sources. `engine/bitslice_source.py` writes a translation unit from
// one circuit (the port's own synthesis, op for op the reference's): it
// defines the macros below, includes this file and then defines
// `bs_circuit`, one `uint32_t` statement a gate, so that the whole DAG
// lives in registers and nvcc can fuse gates into LOP3s. `cuda.py`
// compiles the unit with one `nvcc` call a circuit. The two kernels
// differ in three macros: K14's circuits write back every window cell
// (BS_WRITE_P 1) and a sampling circuit reads BS_N_RAND random words a
// column; K17's write back the data cells only (the program ring is
// read-only; a self-modifying machine has no program cells, BS_N_P 0,
// and fetches from the data cells inside the circuit) and end in
// BS_SIZE_A bit-serial 4-plane counters of the executed opcodes.
//
// Layout. A tape is `stride` planes of nb bit words each, [stride, nb,
// E, W] words (the transposed layout: the member words minor) or
// [stride, nb, W, E] (straight: the sites minor), W = B/32: bit `lane`
// of word (c, k, e, w) is bit k of the symbol of member 32*w + lane at
// tape column e*stride + c. Round `round` has phase s = shifts[round],
// read on the device. Window cell `off` of site e lies in plane
// c = (s + off) mod stride at site (e + q) mod E, q = floor((s + off) /
// stride); division and modulo are floored. K14's phase lies in [0,
// stride), so its offset-0 cell never spills (q = 0, as the reference
// rolls); K17's ranges over the whole tape [0, L), so every cell may
// spill, the offset-0 cell too, and p_lo is negative.
//
// Design. A thread owns one word column: site e and member word w. Its
// thread index is the column's offset in one plane's [E, W] or [W, E]
// words, so the minor axis runs along threadIdx.x and every load and
// store of a warp is one coalesced run (the rolled cells too: a roll
// moves whole rows along the site axis). It reads its n_cells * nb
// window words and the round's BS_N_RAND random words (at its own
// offset: they are not rolled), evaluates the circuit and writes the
// new words where it read them.
//
// Counters (K17). count[a] = sum_k 2^k * popcount(plane 4a + k). No
// counter plane goes to memory: each thread sums its own, a warp adds
// them with __reduce_add_sync, a block in shared memory, and the block
// adds its sums to the round's int64 totals with integer atomics
// (integer sums do not depend on order).
//
// In place. The caller's geometry check keeps a round's sites more
// than 2*span apart (at E > 1), so the window cells of one tape lie in
// distinct planes and each word is read and written by one thread only.
//
// Bounds. A round must read every window word and the random words and
// write every written word, 4 B each. K14 on ex5-msrtf-machine at
// B=16384, E=256 (131,072 columns, 21 words in and out): 22.0 MB, 6.6 us
// at the H100's 3.35 TB/s; the circuit's 576 ops a column run at about
// 16.7 T int32 ops/s, 4.5 us. K17 on ex6-mini-bff at B=16384, E=64
// (32,768 columns, 200 words in and 124 out): 42.5 MB, 12.7 us; its
// 6,536 gates a column would take 12.8 us at one instruction a gate, but
// LOP3 absorbs every NOT and fuses chains of gates, so the bytes bound.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define BS_FN __device__ __forceinline__
#else
#define BS_FN static inline
#endif

// The generated unit defines BS_N_P, BS_N_D, BS_P_LO, BS_D_LO, BS_NB,
// BS_N_RAND, BS_WRITE_P, BS_SIZE_A and BS_THREADS (threads a block)
// before it includes this file, and after it
//   bs_circuit(in, out): out[BS_N_OUT] words from in[BS_N_WIN + n_rand]
//     (window cells in order, program cells first, nb bits each, then
//     the random words); the first BS_N_WRITE outputs are the written
//     cells' words, the rest the counter planes.
#define BS_N_CELLS (BS_N_P + BS_N_D)
#define BS_N_WIN (BS_N_CELLS * BS_NB)
#define BS_FIRST_WRITTEN (BS_WRITE_P ? 0 : BS_N_P)
#define BS_N_WRITE ((BS_N_CELLS - BS_FIRST_WRITTEN) * BS_NB)
#define BS_N_OUT (BS_N_WRITE + 4 * BS_SIZE_A)
#define BS_N_CNT (BS_SIZE_A > 0 ? BS_SIZE_A : 1)
BS_FN void bs_circuit(const uint32_t* in, uint32_t* out);

BS_FN long long bs_floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

BS_FN int bs_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// Word column t of one plane (t in [0, E*W)) at phase s: reads the
// window and random words, runs the circuit, writes the written cells
// back and adds its opcode counts to cnt[BS_SIZE_A].
template <bool SITE_MINOR>
BS_FN void bs_thread(long long t, uint32_t* p, uint32_t* d,
                     const uint32_t* rand, int s, int E, long long W,
                     int stride, unsigned* cnt) {
  const long long EW = (long long)E * W;
  long long e, w;
  if (SITE_MINOR) {
    w = t / E;
    e = t - w * E;
  } else {
    e = t / W;
    w = t - e * W;
  }
  uint32_t* at[BS_N_CELLS];
#pragma unroll
  for (int k = 0; k < BS_N_CELLS; ++k) {
    const int off = k < BS_N_P ? BS_P_LO + k : BS_D_LO + (k - BS_N_P);
    const long long a = (long long)s + off;
    const long long q = bs_floor_div(a, stride);
    const long long c = a - q * stride;
    long long site = (e + q) % E;
    if (site < 0) site += E;
    at[k] = (k < BS_N_P ? p : d) + c * (BS_NB * EW) +
            (SITE_MINOR ? w * E + site : site * W + w);
  }
  uint32_t in[BS_N_WIN + (BS_N_RAND > 0 ? BS_N_RAND : 1)];
#pragma unroll
  for (int k = 0; k < BS_N_CELLS; ++k)
#pragma unroll
    for (int b = 0; b < BS_NB; ++b) in[k * BS_NB + b] = at[k][b * EW];
#pragma unroll
  for (int r = 0; r < BS_N_RAND; ++r) in[BS_N_WIN + r] = rand[r * EW + t];
  uint32_t out[BS_N_OUT];
  bs_circuit(in, out);
#pragma unroll
  for (int k = BS_FIRST_WRITTEN; k < BS_N_CELLS; ++k)
#pragma unroll
    for (int b = 0; b < BS_NB; ++b)
      at[k][b * EW] = out[(k - BS_FIRST_WRITTEN) * BS_NB + b];
#pragma unroll
  for (int a = 0; a < BS_SIZE_A; ++a) {
    unsigned c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      c += (unsigned)bs_popc(out[BS_N_WRITE + 4 * a + k]) << k;
    cnt[a] += c;
  }
}

#ifdef __CUDACC__

template <bool SITE_MINOR>
__global__ void __launch_bounds__(BS_THREADS)
    bs_kernel(uint32_t* __restrict__ p, uint32_t* __restrict__ d,
              const uint32_t* __restrict__ rand,
              const int* __restrict__ shifts, int round,
              unsigned long long* __restrict__ totals, int E, long long W,
              int stride) {
#if BS_SIZE_A > 0
  __shared__ unsigned block_cnt[BS_SIZE_A];
  if (threadIdx.x < BS_SIZE_A) block_cnt[threadIdx.x] = 0;
  __syncthreads();
#endif
  unsigned cnt[BS_N_CNT];
#pragma unroll
  for (int a = 0; a < BS_N_CNT; ++a) cnt[a] = 0;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < (long long)E * W)
    bs_thread<SITE_MINOR>(t, p, d, rand, shifts[round], E, W, stride, cnt);
#if BS_SIZE_A > 0
  const unsigned lane = threadIdx.x & 31u;
#pragma unroll
  for (int a = 0; a < BS_SIZE_A; ++a) {
    const unsigned sum = __reduce_add_sync(0xffffffffu, cnt[a]);
    if (lane == 0 && sum) atomicAdd(&block_cnt[a], sum);
  }
  __syncthreads();
  if (threadIdx.x < BS_SIZE_A && block_cnt[threadIdx.x])
    atomicAdd(totals + threadIdx.x,
              (unsigned long long)block_cnt[threadIdx.x]);
#endif
}

// Rounds [k0, k0+n) of a run, one launch a round on `stream`: round k0+j
// reads phase shifts[k0+j] on the device and random words
// [j*n_rand*E*W, (j+1)*n_rand*E*W) (none without BS_N_RAND), and adds
// its opcode totals into totals[j*size_a, (j+1)*size_a) (int64, set to
// 0 here first; none without BS_SIZE_A). The words are [stride, nb, W,
// E] when site_minor, else [stride, nb, E, W]; p is unused without
// program cells. Returns the first error, or 0.
extern "C" int ckpe_bs_rounds(void* p, void* d, const void* rand,
                              const void* shifts, void* totals, int k0,
                              int n, int E, long long W, int site_minor,
                              int stride, void* stream) {
  const long long cols = (long long)E * W;
  if (cols * BS_NB * stride >= (1LL << 31) || E <= 0 || stride <= 0 ||
      (BS_N_P > 0 && !p))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
#if BS_SIZE_A > 0
  const cudaError_t set = cudaMemsetAsync(
      totals, 0, sizeof(unsigned long long) * BS_SIZE_A * (size_t)n, st);
  if (set != cudaSuccess) return (int)set;
#endif
  if (cols == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((cols + BS_THREADS - 1) / BS_THREADS);
  for (int j = 0; j < n; ++j) {
    const uint32_t* r =
        BS_N_RAND ? (const uint32_t*)rand + (long long)j * BS_N_RAND * cols
                  : nullptr;
    unsigned long long* tot =
        BS_SIZE_A ? (unsigned long long*)totals + (long long)j * BS_SIZE_A
                  : nullptr;
    if (site_minor)
      bs_kernel<true><<<blocks, BS_THREADS, 0, st>>>(
          (uint32_t*)p, (uint32_t*)d, r, (const int*)shifts, k0 + j, tot, E,
          W, stride);
    else
      bs_kernel<false><<<blocks, BS_THREADS, 0, st>>>(
          (uint32_t*)p, (uint32_t*)d, r, (const int*)shifts, k0 + j, tot, E,
          W, stride);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* ckpe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#else

// The kernel's per-thread body for every word column of one round at
// phase `shift`, in a loop on the host (the CPU test of the unit); the
// round's opcode totals into totals[size_a] (int64; none without
// BS_SIZE_A).
extern "C" int ckpe_bs_host_round(uint32_t* p, uint32_t* d,
                                  const uint32_t* rand, int shift, int E,
                                  long long W, int site_minor, int stride,
                                  long long* totals) {
  const long long cols = (long long)E * W;
  unsigned cnt[BS_N_CNT];
  for (int a = 0; a < BS_SIZE_A; ++a) totals[a] = 0;
  for (long long t = 0; t < cols; ++t) {
    memset(cnt, 0, sizeof cnt);
    if (site_minor)
      bs_thread<true>(t, p, d, rand, shift, E, W, stride, cnt);
    else
      bs_thread<false>(t, p, d, rand, shift, E, W, stride, cnt);
    for (int a = 0; a < BS_SIZE_A; ++a) totals[a] += cnt[a];
  }
  return 0;
}

#endif
