// K14: one bit-sliced ensemble round on bit-plane words, in place,
// compiled for one circuit.
//
// Replaces the JAX package's `engine/bitslice.py` `apply_round_bitsliced`
// with `_eval_circuit` (an XLA program on the TPU). Plain PyTorch
// version: `engine/bitslice.py:apply_round_bitsliced`.
//
// Sources. `engine/bitslice_source.py` writes a translation unit from
// one circuit (the port's own synthesis, op for op the reference's): it
// defines the macros below, includes this file and then defines
// `k14_circuit`, one `uint32_t` statement a gate, so that the whole DAG
// lives in registers and nvcc can fuse gates into LOP3s. `cuda.py`
// compiles the unit with one `nvcc` call a circuit.
//
// Layout. A tape is `stride` planes of nb bit words each, [stride, nb,
// E, W] words (the transposed layout: the member words minor) or
// [stride, nb, W, E] (straight: the sites minor), W = B/32: bit `lane`
// of word (c, k, e, w) is bit k of the symbol of member 32*w + lane at
// tape column e*stride + c. Round `round` has phase s = shifts[round],
// read on the device. Window cell `off` of site e lies in plane
// c = (s + off) mod stride at site (e + q) mod E, q = floor((s + off) /
// stride), and q = 0 for off = 0, as the reference rolls; division and
// modulo are floored.
//
// Design. A thread owns one word column: site e and member word w. Its
// thread index is the column's offset in one plane's [E, W] or [W, E]
// words, so the minor axis runs along threadIdx.x and every load and
// store of a warp is one coalesced run (the rolled cells too: a roll
// moves whole rows along the site axis). It reads its n_cells * nb
// window words and, for a sampling circuit, the round's K14_N_RAND
// random words (at its own offset: they are not rolled), evaluates the
// circuit and writes the new words where it read them.
//
// In place. The caller's geometry check keeps a round's sites more
// than 2*span apart (at E > 1), so the window cells of one tape lie in
// distinct planes and each word is read and written by one thread only.
//
// Bound. A round must read and write every window word and read the
// random words: (2 * n_cells * nb + n_rand) * 4 B a word column. On
// ex5-msrtf-machine at B=16384, E=256 (131,072 columns, 21 words in and
// out): 22.0 MB, 6.6 us at the H100's 3.35 TB/s; the circuit's 576 ops
// a column run at about 16.7 T int32 ops/s, 4.5 us. The bound is bytes.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K14_FN __device__ __forceinline__
#else
#define K14_FN static inline
#endif

#define K14_THREADS 256  // threads a block

// The generated unit defines K14_N_P, K14_N_D, K14_P_LO, K14_D_LO,
// K14_NB and K14_N_RAND before it includes this file, and after it
//   k14_circuit(in, out): the circuit's out[n_cells * nb] words from its
//     in[n_cells * nb + n_rand] words (window cells in order, program
//     cells first, nb bits each, then the random words).
#define K14_N_CELLS (K14_N_P + K14_N_D)
#define K14_N_WIN (K14_N_CELLS * K14_NB)
K14_FN void k14_circuit(const uint32_t* in, uint32_t* out);

K14_FN long long k14_floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Word column t of one plane (t in [0, E*W)) at phase s: reads the
// window and random words, runs the circuit, writes the window back.
template <bool SITE_MINOR>
K14_FN void k14_thread(long long t, uint32_t* p, uint32_t* d,
                       const uint32_t* rand, int s, int E, long long W,
                       int stride) {
  const long long EW = (long long)E * W;
  long long e, w;
  if (SITE_MINOR) {
    w = t / E;
    e = t - w * E;
  } else {
    e = t / W;
    w = t - e * W;
  }
  uint32_t* at[K14_N_CELLS];
#pragma unroll
  for (int k = 0; k < K14_N_CELLS; ++k) {
    const int off = k < K14_N_P ? K14_P_LO + k : K14_D_LO + (k - K14_N_P);
    const long long a = (long long)s + off;
    const long long q = k14_floor_div(a, stride);
    const long long c = a - q * stride;
    long long site = off == 0 ? e : (e + q) % E;
    if (site < 0) site += E;
    at[k] = (k < K14_N_P ? p : d) + c * (K14_NB * EW) +
            (SITE_MINOR ? w * E + site : site * W + w);
  }
  uint32_t in[K14_N_WIN + (K14_N_RAND > 0 ? K14_N_RAND : 1)];
#pragma unroll
  for (int k = 0; k < K14_N_CELLS; ++k)
#pragma unroll
    for (int b = 0; b < K14_NB; ++b) in[k * K14_NB + b] = at[k][b * EW];
#pragma unroll
  for (int r = 0; r < K14_N_RAND; ++r) in[K14_N_WIN + r] = rand[r * EW + t];
  uint32_t out[K14_N_WIN];
  k14_circuit(in, out);
#pragma unroll
  for (int k = 0; k < K14_N_CELLS; ++k)
#pragma unroll
    for (int b = 0; b < K14_NB; ++b) at[k][b * EW] = out[k * K14_NB + b];
}

#ifdef __CUDACC__

template <bool SITE_MINOR>
__global__ void __launch_bounds__(K14_THREADS)
    k14_kernel(uint32_t* __restrict__ p, uint32_t* __restrict__ d,
               const uint32_t* __restrict__ rand,
               const int* __restrict__ shifts, int round, int E,
               long long W, int stride) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)E * W) return;
  k14_thread<SITE_MINOR>(t, p, d, rand, shifts[round], E, W, stride);
}

// Rounds [k0, k0+n) of a run, one launch a round on `stream`: round k0+j
// reads phase shifts[k0+j] on the device and random words
// [j*n_rand*E*W, (j+1)*n_rand*E*W) (none for a round circuit). The words
// are [stride, nb, W, E] when site_minor, else [stride, nb, E, W].
// Returns the first launch error, or 0.
extern "C" int ckpe_k14_rounds(void* p, void* d, const void* rand,
                               const void* shifts, int k0, int n, int E,
                               long long W, int site_minor, int stride,
                               void* stream) {
  const long long cols = (long long)E * W;
  if (cols * K14_NB * stride >= (1LL << 31) || E <= 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  if (cols == 0 || n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((cols + K14_THREADS - 1) / K14_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  for (int j = 0; j < n; ++j) {
    const uint32_t* r =
        K14_N_RAND ? (const uint32_t*)rand + (long long)j * K14_N_RAND * cols
                   : nullptr;
    if (site_minor)
      k14_kernel<true><<<blocks, K14_THREADS, 0, st>>>(
          (uint32_t*)p, (uint32_t*)d, r, (const int*)shifts, k0 + j, E, W,
          stride);
    else
      k14_kernel<false><<<blocks, K14_THREADS, 0, st>>>(
          (uint32_t*)p, (uint32_t*)d, r, (const int*)shifts, k0 + j, E, W,
          stride);
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
// phase `shift`, in a loop on the host (the CPU test of the unit).
extern "C" int ckpe_k14_host_round(uint32_t* p, uint32_t* d,
                                   const uint32_t* rand, int shift, int E,
                                   long long W, int site_minor,
                                   int stride) {
  const long long cols = (long long)E * W;
  for (long long t = 0; t < cols; ++t) {
    if (site_minor)
      k14_thread<true>(t, p, d, rand, shift, E, W, stride);
    else
      k14_thread<false>(t, p, d, rand, shift, E, W, stride);
  }
  return 0;
}

#endif
