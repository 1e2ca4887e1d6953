// K16 `bff_round`: one round of the mini-BFF interpreter on [B, L] int8
// tapes, in place, at a shift shared by the batch or one a member, with
// the int32 lineage ring when given and the round's exact int64
// executed-opcode totals; and K18 `bff_mutate`, the background mutation
// of self-modifying runs.
//
// K16 replaces the JAX package's `engine/bff.py:461-550` scan body of
// `_run_ensemble_bff`: `:162 bff_fire` under `:288 apply_bff_round` and
// `:320 apply_bff_self_round` with `ensemble.py` `_roll_cols` and
// `_roll_rows` (XLA programs: rolls of the tapes by the round's shift,
// `fuel` select cascades over the rolled windows, the roll back; no
// Pallas kernel). K18 replaces its mutation step, `bff.py:506-518`.
// Plain PyTorch versions: `engine/bff.py:bff_round_plain`,
// `bff_mutate_plain`.
//
// K16's design: one thread a site event (b, e). The machine is the rule
// header `bff_rule.cuh` (compiled by g++ too for the CPU tests). Site e
// of member b at shift s reads its windows where they lie on the ring,
// columns (s + e*stride + lo + j) mod L, as K10 and K11 do: no tape
// moves. The cells go to the thread's own slots in shared memory, [cell]
// [thread] (the heads index them at run time, which registers cannot
// take), the machine runs `fuel` steps as a switch on the opcode's kind,
// and only the data cells it wrote go back (the program ring is
// read-only). The caller's geometry check keeps a round's windows
// disjoint (sites more than 2*span apart, or one a member), so the
// update is in place. Each thread's counts live in a uint64, 4 bits a
// symbol (fuel <= 15, size_a <= 16); a warp adds them with
// __reduce_add_sync, the block in shared memory, and the block adds its
// sums to the round's int64 totals with integer atomics: integer sums do
// not depend on order, so the totals equal the plain version's.
//
// K18: one thread a cell: where u < rate (float64, the dtype the
// reference draws) the cell takes its drawn symbol and its lineage -1.
//
// Bounds: bytes. K16 must read each site's n_p + n_d window cells and
// write its n_d data cells, a byte each (4 more a cell of lineage):
// ex6-mini-bff at B=16384, E=64 is 1,048,576 sites of 81 B, 84.9 MB, 25.3
// us at 3.35 TB/s. K18 must read u (8 B), vals (4 B) and the cell, and
// write the cell, 14 B a cell (19 with lineage).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bff_rule.cuh"

#define K16_THREADS 128  // threads a block
#define K18_THREADS 256

__global__ void __launch_bounds__(K16_THREADS)
    k16_kernel(BffParams m, const int8_t* __restrict__ p,
               int8_t* __restrict__ d, int32_t* __restrict__ prov,
               const int* __restrict__ shifts, int per_member, int B, int L,
               int E, unsigned long long* __restrict__ totals) {
  extern __shared__ int32_t k16_smem[];
  __shared__ unsigned block_cnt[BFF_MAX_A];
  if (threadIdx.x < BFF_MAX_A) block_cnt[threadIdx.x] = 0;
  // Slots: lineage [n_d][T] int32, then program [n_p][T] (two-tape
  // machines) and data [n_d][T] bytes.
  const int n_sp = m.self_modifying ? 0 : m.n_p;
  int32_t* sv = k16_smem + threadIdx.x;
  int8_t* bytes = (int8_t*)(k16_smem + (prov ? m.n_d * K16_THREADS : 0));
  int8_t* sp = bytes + threadIdx.x;
  int8_t* sd = bytes + n_sp * K16_THREADS + threadIdx.x;
  __syncthreads();
  const long long t = (long long)blockIdx.x * K16_THREADS + threadIdx.x;
  uint64_t counts = 0;
  if (t < (long long)B * E)
    counts = bff_site(m, t, p, d, prov, shifts, per_member, L, E, sp, sd, sv,
                      K16_THREADS);
  const unsigned lane = threadIdx.x & 31u;
  for (int a = 0; a < m.size_a; ++a) {
    const unsigned c = (unsigned)((counts >> (4 * a)) & 15u);
    const unsigned sum = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0 && sum) atomicAdd(&block_cnt[a], sum);
  }
  __syncthreads();
  if (threadIdx.x < m.size_a && block_cnt[threadIdx.x])
    atomicAdd(totals + threadIdx.x,
              (unsigned long long)block_cnt[threadIdx.x]);
}

__global__ void __launch_bounds__(K18_THREADS)
    k18_kernel(int8_t* __restrict__ tape, int32_t* __restrict__ prov,
               const double* __restrict__ u,
               const int32_t* __restrict__ vals, double rate,
               long long count) {
  const long long i = (long long)blockIdx.x * K18_THREADS + threadIdx.x;
  if (i < count) bff_mutate_cell(i, tape, prov, u, vals, rate);
}

static int k18_launch(void* tape, void* prov, const void* u, const void* vals,
                      double rate, long long count, cudaStream_t st) {
  if (count <= 0) return (int)cudaGetLastError();
  const unsigned blocks =
      (unsigned)((count + K18_THREADS - 1) / K18_THREADS);
  k18_kernel<<<blocks, K18_THREADS, 0, st>>>(
      (int8_t*)tape, (int32_t*)prov, (const double*)u, (const int32_t*)vals,
      rate, count);
  return (int)cudaGetLastError();
}

// Rounds [k0, k0+n) of a run on `stream`: round k0+j is one K16 launch at
// shifts[k0+j] (shared) or shifts[(k0+j)*B + b] (per member), read on the
// device, its opcode totals added into totals[j*size_a, (j+1)*size_a)
// (int64, set to 0 here first); then, when u is not null, one K18 launch
// over u and vals [j*B*L, (j+1)*B*L). Returns the first error, or 0.
extern "C" int ckpe_bff_rounds(const int* params, const void* p, void* d,
                               void* prov, const void* shifts, int per_member,
                               int k0, int n, int B, int L, int E,
                               void* totals, const void* u, const void* vals,
                               double rate, void* stream) {
  const BffParams m = bff_params(params);
  if (!bff_params_ok(m) || E <= 0 || L % E != 0 ||
      (long long)B * L >= (1LL << 31) || (!m.self_modifying && !p))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      totals, 0, sizeof(unsigned long long) * m.size_a * (size_t)n, st);
  if (err != cudaSuccess) return (int)err;
  const long long sites = (long long)B * E;
  const unsigned blocks = (unsigned)((sites + K16_THREADS - 1) / K16_THREADS);
  const size_t smem =
      (size_t)K16_THREADS * ((prov ? 4 * m.n_d : 0) +
                             (m.self_modifying ? 0 : m.n_p) + m.n_d);
  const long long cells = (long long)B * L;
  for (int j = 0; j < n; ++j) {
    if (sites > 0) {
      k16_kernel<<<blocks, K16_THREADS, smem, st>>>(
          m, (const int8_t*)p, (int8_t*)d, (int32_t*)prov,
          (const int*)shifts + (long long)(k0 + j) * (per_member ? B : 1),
          per_member, B, L, E, (unsigned long long*)totals + j * m.size_a);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (u) {
      const int rc =
          k18_launch(d, prov, (const double*)u + j * cells,
                     (const int32_t*)vals + j * cells, rate, cells, st);
      if (rc) return rc;
    }
  }
  return 0;
}

// K18 alone: one launch over count cells.
extern "C" int ckpe_bff_mutate(void* tape, void* prov, const void* u,
                               const void* vals, double rate,
                               long long count, void* stream) {
  return k18_launch(tape, prov, u, vals, rate, count, (cudaStream_t)stream);
}
