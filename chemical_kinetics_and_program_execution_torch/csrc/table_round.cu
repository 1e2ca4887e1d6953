// K10 `table_round`: transition-table rounds of the ensemble on [B, L]
// int32 tapes, in place, at a shift shared by the batch or one a member.
//
// Replaces the JAX package's `engine/ensemble.py:927
// _apply_lattice_round` (an XLA program: a roll of each tape by the
// shift, a reshape into [B, E, stride] blocks, a gather of the table
// rows, a compare against the uniforms, a scatter of the written cells
// and the roll back; no Pallas kernel), and the per-member
// `_roll_rows` of `run_ensemble(independent_sites=True)`. Plain PyTorch
// version: `engine/ensemble.py:table_round_plain`.
//
// Design: a site (b, e) reads its window's cells where they lie, at
// columns (shift + lo + e*stride + j) mod L, so no roll moves a tape;
// forms the row and slot by `table_rule.cuh`; and stores only the cells
// its write spec changes. The caller's geometry check keeps a round's
// sites more than 2*span apart (or one site a member), so the windows of
// one round are disjoint and the update in place equals the reference's.
// A table with one outcome a row (M = 1) takes slot 0 whatever the
// uniform, so no uniform is read then. Resident rounds (the rule): one
// launch for the n rounds of a call on a tile of members whose rows stay
// in shared memory (`table_resident.cuh`), a thread a site, a barrier
// between rounds; the table stays in global memory, read through L2. The
// caller sizes the tile (`ensemble.k10_tile`: two blocks an SM). Rows
// too long for a block (8L bytes and the padding past 227 KB) and calls
// of fewer than four rounds keep `k10_kernel`, a thread a site on the
// tapes in global memory, a launch a round.
//
// Bound: bytes. A round must read every window cell (4 B each), write
// the cells that some spec writes and read the site's uniform where the
// table has more than one outcome a row (8 B in float64, 4 B in float32);
// the table (0.94 MB for ex5-msrtf-machine, 19.1 MB for
// ex4-chemical-turing) sits in the 50 MB L2. At B=16384, E=256 on ex5
// (one outcome a row: no uniform) that is 168.7 MB a round, 50.4 us at
// 3.35 TB/s. Over a resident call of n rounds the rows cross once each
// way (8BL bytes, 1.074 GB at B=16384, L=4096) and each round moves only
// its shifts and uniforms.

#include <cuda_runtime.h>

#include "table_resident.cuh"

namespace {

constexpr int kThreads = 256;
// The most dynamic shared memory a block may have (227 KB on the H100).
constexpr long long kSmemMax = 232448;

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
  k10_site<T>(t, p + (long long)b * L, d + (long long)b * L, L, base,
              t.M > 1 ? u[i] : T(0));
}

// The resident rounds [k0, k0+n) of a tile a block (see the header and
// `table_resident.cuh`): both rows of each member into shared memory,
// the rounds (each reads its shift and, where M > 1, its uniforms, the
// next round's prefetched), the rows back. At most 512 threads, two
// blocks an SM.
template <typename T, int N>
__global__ void __launch_bounds__(512, 2)
    k10_resident_kernel(int* __restrict__ p, int* __restrict__ d,
                        const T* __restrict__ u,
                        const int* __restrict__ shifts, int per_member,
                        int k0, int n, int B, int L, int E, K10Table t,
                        int tile, int vec) {
  extern __shared__ __align__(16) unsigned char k10_smem[];
  const int Ws = k10_row_words(L);
  int* sp = (int*)k10_smem;
  int* sd = sp + (long long)tile * Ws;
  const int b0 = blockIdx.x * tile;
  const int m = min(tile, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  int* gp = p + (long long)b0 * L;
  int* gd = d + (long long)b0 * L;
  k10_tile_copy(tid, nt, gp, sp, m, L, Ws, vec, true);
  k10_tile_copy(tid, nt, gd, sd, m, L, Ws, vec, true);
  const K10Window<N> win = k10_window<N>(t, L);
  __syncthreads();
  const long long sites = (long long)B * E;
  const int mine = tid < m * E;
  const int i0 = tid / E;
  const long long u0 = (long long)(b0 + i0) * E + (tid - i0 * E);
  for (int j = 0; j < n; ++j) {
    const int k = k0 + j;
    if (mine && j + 1 < n) {
      k10_prefetch(shifts + (long long)(k + 1) * (per_member ? B : 1) +
                   (per_member ? b0 + i0 : 0));
      if (t.M > 1) k10_prefetch(u + (j + 1) * sites + u0);
    }
    k10_tile_sites<T, N>(tid, nt, t, win, sp, sd, m, L, Ws, E, b0,
                         u + j * sites,
                         shifts + (long long)k * (per_member ? B : 1),
                         per_member);
    __syncthreads();
  }
  k10_tile_copy(tid, nt, gp, sp, m, L, Ws, vec, false);
  k10_tile_copy(tid, nt, gd, sd, m, L, Ws, vec, false);
}

template <typename T, int N>
int k10_resident(void* p, void* d, const void* u, const int* shifts,
                 int per_member, int k0, int n, int B, int L, int E,
                 const K10Table& t, int tile, int threads, cudaStream_t st) {
  const long long bytes = k10_tile_bytes(tile, L);
  if (threads < 32 || threads > 512 || bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k10_resident_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec = L % 4 == 0 && (uintptr_t)p % 16 == 0 &&
                  (uintptr_t)d % 16 == 0;
  k10_resident_kernel<T, N><<<(unsigned)((B + tile - 1) / tile), threads,
                              (size_t)bytes, st>>>(
      (int*)p, (int*)d, (const T*)u, shifts, per_member, k0, n, B, L, E, t,
      tile, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Rounds [k0, k0+n) of a run on `stream`: round k0+j reads shifts[k0+j]
// (shared) or shifts[(k0+j)*B + b] (per member) on the device and
// uniforms [j*B*E, (j+1)*B*E) (double when u_f64, else float; read only
// where M > 1). With ``tile`` > 0 one resident launch of ``tile`` members
// a block of ``threads`` threads (cudaErrorInvalidValue where the tile
// does not fit); with ``tile`` 0 (rows too long to keep resident, or a
// call of few rounds) one launch a round. Returns the first launch error,
// or 0.
extern "C" int ckpe_table_rounds(void* p, void* d, const void* u, int u_f64,
                                 const void* shifts, int per_member, int k0,
                                 int n, int B, int L, int E, int p_lo,
                                 int n_p, int d_lo, int n_d, const void* pv,
                                 const void* out_cum, const void* out_world,
                                 int rows, int M, const void* wr_mask,
                                 const void* wr_val, int tile, int threads,
                                 void* stream) {
  if (E <= 0 || L % E != 0 || n_p + n_d > K10_MAX_CELLS || rows < 1 ||
      M < 1 || (long long)B * L >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long sites = (long long)B * E;
  if (sites == 0 || n <= 0) return (int)cudaGetLastError();
  const K10Table t = {(const int*)pv, out_cum, (const int*)out_world,
                      (const uint8_t*)wr_mask, (const int*)wr_val, rows, M,
                      p_lo, n_p, d_lo, n_d};
  cudaStream_t st = (cudaStream_t)stream;
  if (tile > 0)
    return k10_by_cells(n_p + n_d, [&](auto cells) {
      constexpr int N = decltype(cells)::value;
      return u_f64 ? k10_resident<double, N>(p, d, u, (const int*)shifts,
                                             per_member, k0, n, B, L, E, t,
                                             tile, threads, st)
                   : k10_resident<float, N>(p, d, u, (const int*)shifts,
                                            per_member, k0, n, B, L, E, t,
                                            tile, threads, st);
    });
  const unsigned blocks = (unsigned)((sites + kThreads - 1) / kThreads);
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
