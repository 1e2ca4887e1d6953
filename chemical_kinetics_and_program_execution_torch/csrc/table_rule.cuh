// K10's per-site rule: one event of the transition-table round, as the
// JAX package's `engine/ensemble.py:_apply_lattice_round` computes it.
//
// The site's window cells are read from their columns on the two tapes
// (the caller gives each row and base = shift + e*stride; cell j of a
// tape with read offset lo is at column (base + lo + j) mod L, floored).
// The table row is the reference's int32 radix sum of the cells times
// the place values, which wraps (taken here in uint32, whose wrap is
// defined), read by the reference gather's index rule: a negative row
// plus the row count, then clamped into [0, rows). The slot is the
// count of the row's cumulative probabilities below the uniform,
// compared in the table's type and capped at M - 1; its write spec
// decides which cells take which symbols. Plain C++ under `g++` as
// well, so a CPU test holds the rule to `ensemble.table_round_plain`.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define K10_FN __host__ __device__ __forceinline__
#else
#define K10_FN static inline
#endif

#define K10_MAX_CELLS 24  // ensemble.py: _K10_MAX_CELLS

struct K10Table {
  const int* pv;          // [n_cells] place values
  const void* out_cum;    // [rows, M] float or double
  const int* out_world;   // [rows, M] write specs
  const uint8_t* wr_mask; // [W, n_cells] 0 or 1
  const int* wr_val;      // [W, n_cells]
  int rows, M;
  int p_lo, n_p, d_lo, n_d;
};

// a mod L, floored.
K10_FN int k10_col(long long a, int L) {
  long long r = a % L;
  return (int)(r < 0 ? r + L : r);
}

// The row of a window's wrapped radix sum by the gather's index rule.
K10_FN int k10_clamp_row(uint32_t rank, int rows) {
  int r = (int)rank;
  if (r < 0) r += rows;
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// The row of a window of ``n`` cells by the reference's rule.
K10_FN int k10_row(const int* cells, const int* pv, int n, int rows) {
  uint32_t rank = 0;
  for (int j = 0; j < n; ++j)
    rank += (uint32_t)cells[j] * (uint32_t)pv[j];
  return k10_clamp_row(rank, rows);
}

// #(u > cum[m]) over the row's M slots, capped at M - 1: 0 where M == 1
// whatever u, so no slot is read then.
template <typename T>
K10_FN int k10_slot(const T* cum, int M, T u) {
  if (M == 1) return 0;
  int k = 0;
  for (int m = 0; m < M; ++m) k += u > cum[m] ? 1 : 0;
  return k < M - 1 ? k : M - 1;
}

// One event at base = shift + e*stride on member rows prow, drow of
// length L, with uniform u, in place: only the cells that the spec
// changes are stored.
template <typename T>
K10_FN void k10_site(const K10Table& t, int* prow, int* drow, int L,
                     long long base, T u) {
  int cells[K10_MAX_CELLS];
  int cols[K10_MAX_CELLS];
  const int n = t.n_p + t.n_d;
  for (int j = 0; j < n; ++j) {
    const bool prog = j < t.n_p;
    cols[j] = k10_col(base + (prog ? t.p_lo + j : t.d_lo + (j - t.n_p)), L);
    cells[j] = (prog ? prow : drow)[cols[j]];
  }
  const int r = k10_row(cells, t.pv, n, t.rows);
  const long long at = (long long)r * t.M;
  const int k = k10_slot((const T*)t.out_cum + at, t.M, u);
  const long long spec = t.out_world[at + k];
  const uint8_t* mask = t.wr_mask + spec * n;
  const int* val = t.wr_val + spec * n;
  for (int j = 0; j < n; ++j)
    if (mask[j] && val[j] != cells[j]) (j < t.n_p ? prow : drow)[cols[j]] = val[j];
}

#ifndef __CUDACC__
// The kernel's per-site body for every site of one round on the host
// (the CPU test of the rule): tapes int32 [B, L], uniforms [B, E]
// (double when u_f64, else float), shifts[0] shared or shifts[b] a
// member.
extern "C" int ckpe_k10_host_round(int* p, int* d, const void* u, int u_f64,
                                   const int* shifts, int per_member, int B,
                                   int L, int E, const int* pv,
                                   const void* out_cum, const int* out_world,
                                   int rows, int M, const uint8_t* wr_mask,
                                   const int* wr_val, int p_lo, int n_p,
                                   int d_lo, int n_d) {
  if (n_p + n_d > K10_MAX_CELLS) return 1;
  const K10Table t = {pv, out_cum, out_world, wr_mask, wr_val, rows, M,
                      p_lo, n_p, d_lo, n_d};
  for (int b = 0; b < B; ++b)
    for (int e = 0; e < E; ++e) {
      const long long base =
          (long long)shifts[per_member ? b : 0] + (long long)e * (L / E);
      const long long i = (long long)b * E + e;
      if (u_f64)
        k10_site<double>(t, p + (long long)b * L, d + (long long)b * L, L,
                         base, M > 1 ? ((const double*)u)[i] : 0.0);
      else
        k10_site<float>(t, p + (long long)b * L, d + (long long)b * L, L,
                        base, M > 1 ? ((const float*)u)[i] : 0.0f);
    }
  return 0;
}
#endif
