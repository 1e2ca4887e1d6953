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
// Design: a warp a member, several members a block (the caller's
// choice, `ensemble.k12_members`). The warp stages its row in shared
// memory, 16 bytes a lane where the row allows, and appends the P - 1
// wrap cells, so no prefix walk takes a modulo; an int8 row is searched
// 4 bytes a lane at a time for the pattern's first symbol (`__vcmpeq4`)
// and only those starts are walked (`pattern_rule.cuh`); an int32 row a
// symbol a lane. The lanes' longest prefixes meet by warp shuffles (an
// integer max: exact in any order) and lane 0 writes the member's
// result. First passage updates its hit times inside K11's resident
// rounds (`lattice_round.cuh`) and launches this kernel at t = 0; rows
// too long for one staged row a block (past about 227,000 int8 or 56,000
// int32 symbols) take the kernel of a block a member that reads the row
// where it lies (members 0, chosen by the geometry alone), which K11's
// long-row first passage also calls, by `ckpe_pattern_scan`'s address.
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

// A warp a member: warp w of block x owns member x * members + w.
template <typename Sym>
__global__ void k12_staged_kernel(const Sym* __restrict__ tape, int B, int L,
                                  const int* __restrict__ pat, int P,
                                  int mode, void* out, double* t_hit,
                                  const double* t_now, int members, int S,
                                  int vec) {
  extern __shared__ __align__(16) unsigned char k12_smem[];
  int* spat = (int*)k12_smem;
  Sym* rows = (Sym*)(k12_smem + ((4 * P + 15) & ~15));
  for (int k = threadIdx.x; k < P; k += blockDim.x) spat[k] = pat[k];
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * members + w;
  if (b >= B) return;
  Sym* s = rows + (long long)w * S;
  k12_stage(lane, 32, tape + (long long)b * L, s, L, P, vec != 0);
  __syncwarp();
  int best = k12_staged_best(lane, 32, s, L, spat, P);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v = __shfl_xor_sync(0xffffffffu, best, o);
    best = v > best ? v : best;
  }
  if (lane == 0) k12_finish(mode, best, P, out, t_hit, t_now, b);
}

template <typename Sym>
int k12_launch(const Sym* tape, int B, int L, const int* pattern, int P,
               int mode, void* out, double* t_hit, const double* t_now,
               int members, cudaStream_t st) {
  if (members <= 0) {
    k12_kernel<Sym><<<B, kThreads, 0, st>>>(tape, L, pattern, P, mode, out,
                                            t_hit, t_now);
    return (int)cudaGetLastError();
  }
  const int S = k12_staged_stride(L, P, (int)sizeof(Sym));
  const long long bytes =
      ((4LL * P + 15) & ~15LL) + (long long)members * S * sizeof(Sym);
  if (members > 32 || bytes > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k12_staged_kernel<Sym>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec = (L * sizeof(Sym)) % 16 == 0 && (uintptr_t)tape % 16 == 0;
  k12_staged_kernel<Sym><<<(B + members - 1) / members, 32 * members,
                           (size_t)bytes, st>>>(
      tape, B, L, pattern, P, mode, out, t_hit, t_now, members, S, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch on `stream` over B members of L symbols (elem 1: int8,
// 4: int32) for the int32 pattern [P] on the device: mode 0 writes a
// byte a member to out (1 where present), mode 1 an int (the progress),
// mode 2 updates t_hit [B] from *t_now. ``members`` a block of the
// staged kernel, or 0 for the kernel of a block a member. Returns the
// launch error, or 0. K11's long-row first passage (`lattice_round.cuh`)
// calls it by address, with the same signature.
extern "C" int ckpe_pattern_scan(const void* tape, int elem, int B, int L,
                                 const int* pattern, int P, int mode,
                                 void* out, double* t_hit,
                                 const double* t_now, int members,
                                 void* stream) {
  if ((elem != 1 && elem != 4) || L <= 0 || P < 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (elem == 1)
    return k12_launch((const int8_t*)tape, B, L, pattern, P, mode, out,
                      t_hit, t_now, members, st);
  return k12_launch((const int*)tape, B, L, pattern, P, mode, out, t_hit,
                    t_now, members, st);
}
