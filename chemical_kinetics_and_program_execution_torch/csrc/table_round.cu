// K10 `table_round`: one transition-table round of the ensemble on
// [B, L] int32 tapes, in place, at a shift shared by the batch or one a
// member.
//
// Replaces the JAX package's `engine/ensemble.py:927
// _apply_lattice_round` (an XLA program: a roll of each tape by the
// shift, a reshape into [B, E, stride] blocks, a gather of the table
// rows, a compare against the uniforms, a scatter of the written cells
// and the roll back; no Pallas kernel), and the per-member
// `_roll_rows` of `run_ensemble(independent_sites=True)`. Plain PyTorch
// version: `engine/ensemble.py:table_round_plain`.
//
// Design: one thread a site (b, e). It reads its window's cells where
// they lie, at columns (shift + lo + e*stride + j) mod L, so no roll
// moves a tape; forms the row and slot by `table_rule.cuh`; and stores
// only the cells its write spec changes. The caller's geometry check
// keeps a round's sites more than 2*span apart (or one site a member),
// so the windows of one round are disjoint and the update in place
// equals the reference's. One launch a round, all rounds of a call
// from one C call.
//
// Bound: bytes. A round must read every window cell (4 B each) and the
// site's uniform (8 B in float64, 4 B in float32), and write the cells
// that some spec writes; the table (0.94 MB for ex5-msrtf-machine,
// 19.1 MB for ex4-chemical-turing) sits in the 50 MB L2. At B=16384,
// E=256 on ex5 that is 4,194,304 sites x (7 x 4 + 3 x 4 + 8) B = 201 MB,
// 60 us at 3.35 TB/s; each window's cells lie in one or two 32-byte
// sectors of each tape, so the sectors a round touches carry more.

#include <cuda_runtime.h>

#include "table_rule.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k10_kernel(int* __restrict__ p, int* __restrict__ d,
               const T* __restrict__ u, const int* __restrict__ shifts,
               int per_member, int B, int L, int E, K10Table t) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)B * E) return;
  const int b = (int)(i / E);
  const int e = (int)(i - (long long)b * E);
  const long long base =
      (long long)shifts[per_member ? b : 0] + (long long)e * (L / E);
  k10_site<T>(t, p + (long long)b * L, d + (long long)b * L, L, base, u[i]);
}

}  // namespace

// Rounds [k0, k0+n) of a run, one launch a round on `stream`: round k0+j
// reads shifts[k0+j] (shared) or shifts[(k0+j)*B + b] (per member) on the
// device and uniforms [j*B*E, (j+1)*B*E) (double when u_f64, else
// float). Returns the first launch error, or 0.
extern "C" int ckpe_table_rounds(void* p, void* d, const void* u, int u_f64,
                                 const void* shifts, int per_member, int k0,
                                 int n, int B, int L, int E, int p_lo,
                                 int n_p, int d_lo, int n_d, const void* pv,
                                 const void* out_cum, const void* out_world,
                                 int rows, int M, const void* wr_mask,
                                 const void* wr_val, void* stream) {
  if (E <= 0 || L % E != 0 || n_p + n_d > K10_MAX_CELLS || rows < 1 ||
      M < 1 || (long long)B * L >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long sites = (long long)B * E;
  if (sites == 0 || n <= 0) return (int)cudaGetLastError();
  const K10Table t = {(const int*)pv, out_cum, (const int*)out_world,
                      (const uint8_t*)wr_mask, (const int*)wr_val, rows, M,
                      p_lo, n_p, d_lo, n_d};
  const unsigned blocks = (unsigned)((sites + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  for (int j = 0; j < n; ++j) {
    const int* s =
        (const int*)shifts + (long long)(k0 + j) * (per_member ? B : 1);
    if (u_f64)
      k10_kernel<double><<<blocks, kThreads, 0, st>>>(
          (int*)p, (int*)d, (const double*)u + j * sites, s, per_member, B,
          L, E, t);
    else
      k10_kernel<float><<<blocks, kThreads, 0, st>>>(
          (int*)p, (int*)d, (const float*)u + j * sites, s, per_member, B,
          L, E, t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
