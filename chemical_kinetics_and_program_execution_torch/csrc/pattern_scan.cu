// K12 `pattern_scan`: whether a pattern occurs on each ring, the longest
// prefix of it that does, or the first-passage update of a member's hit
// time, on [B, L] int8 or int32 tapes.
//
// Replaces the JAX package's `engine/ensemble.py:1533 contains_pattern`,
// `:2750 pattern_progress` and the `t_hit` update inside
// `first_passage_times` (`:1580-1589`): XLA programs that roll the whole
// tape once a pattern symbol and reduce (no Pallas kernel). Plain
// PyTorch version: `engine/ensemble.py:pattern_scan_plain`.
//
// Design: one block a member. Each thread takes start columns i, i+256,
// ... of the row and walks the prefix that matches from there
// (`pattern_rule.cuh`), so a column that does not match the first
// symbol costs one load; the block's longest prefix is an integer max
// (a shared-memory atomic: exact whatever the order). Thread 0 then
// writes the member's result. First passage launches this kernel once a
// round from the C call of K11's rounds (`lattice_round.cuh`), through
// `ckpe_pattern_scan`'s address.
//
// Bound: bytes, one read of the tape (67 MB as int8, 268 MB as int32 at
// B=16384, L=4096: 20 and 80 us at 3.35 TB/s) plus a byte or word a
// member written.

#include <cuda_runtime.h>

#include "pattern_rule.cuh"

namespace {

constexpr int kThreads = 256;

template <typename Sym>
__global__ void __launch_bounds__(kThreads)
    k12_kernel(const Sym* __restrict__ tape, int L,
               const int* __restrict__ pat, int P, int mode, void* out,
               double* t_hit, const double* t_now) {
  __shared__ int best_s;
  if (threadIdx.x == 0) best_s = 0;
  __syncthreads();
  const int b = blockIdx.x;
  const Sym* row = tape + (long long)b * L;
  int best = 0;
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const int m = k12_prefix_at(row, L, i, pat, P);
    best = m > best ? m : best;
  }
  if (best) atomicMax(&best_s, best);
  __syncthreads();
  if (threadIdx.x == 0) k12_finish(mode, best_s, P, out, t_hit, t_now, b);
}

}  // namespace

// One launch on `stream` over B members of L symbols (elem 1: int8,
// 4: int32) for the int32 pattern [P] on the device: mode 0 writes a
// byte a member to out (1 where present), mode 1 an int (the progress),
// mode 2 updates t_hit [B] from *t_now. Returns the launch error, or 0.
// The first-passage C call of K11 (`lattice_round.cuh`) calls it by
// address, with the same signature.
extern "C" int ckpe_pattern_scan(const void* tape, int elem, int B, int L,
                                 const int* pattern, int P, int mode,
                                 void* out, double* t_hit,
                                 const double* t_now, void* stream) {
  if ((elem != 1 && elem != 4) || L <= 0 || P < 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (elem == 1)
    k12_kernel<int8_t><<<B, kThreads, 0, st>>>(
        (const int8_t*)tape, L, pattern, P, mode, out, t_hit, t_now);
  else
    k12_kernel<int><<<B, kThreads, 0, st>>>((const int*)tape, L, pattern, P,
                                            mode, out, t_hit, t_now);
  return (int)cudaGetLastError();
}
