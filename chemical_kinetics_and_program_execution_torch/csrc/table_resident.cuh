// K10's resident rounds: the phases of a tile, shared by the kernel
// (`table_round.cu:k10_resident_kernel`) and its host twin below, as
// K11's are (`lattice_round.cuh`). ``tid`` and ``nt`` are the thread and
// the block's width; a phase touches what no other thread of the same
// phase touches, so the host runs each phase thread after thread.
//
// A block owns a tile of members for every round of a C call: both int32
// rows of each go to shared memory once (16 bytes a thread in global
// memory where the rows allow), column c of a row at `k10_pos`(c), a
// word of padding after every 32 columns; each round's sites run a
// thread two sites at a time, neighbouring threads on neighbouring sites
// of a member (so a warp's reads of one window cell fall in 32 banks),
// reading and writing the shared rows (`k10_site_row`,
// `k10_site_writes`: columns in 32-bit steps, no per-thread arrays); a
// barrier between rounds; the rows go back once. The rows stay int32:
// symbols outside [0, size_a) enter the row's wrapping radix sum
// (`k10_row`). Plain C++ under `g++` as well.

#pragma once

#include <stdint.h>
#include <stdlib.h>

#include <type_traits>

#include "table_rule.cuh"

// Where column c of a resident row lies: a word of padding after every
// 32 columns, so that 32 sites of a member at a stride of 16 (or 8, or
// 32) columns fall in 32 different banks.
K10_FN int k10_pos(int c) { return c + (c >> 5); }

// Words of a resident row of L columns (`k10_pos`).
K10_FN int k10_row_words(int L) { return L + ((L + 31) >> 5); }

// Bytes of shared memory of a tile: both rows a member.
K10_FN long long k10_tile_bytes(int tile, int L) {
  return 8LL * tile * k10_row_words(L);
}

#ifdef __CUDACC__
typedef int4 k10_v4;
// A hint to bring the line holding p into L1.
__device__ __forceinline__ void k10_prefetch(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}
#else
struct k10_v4 {
  int x, y, z, w;
};
static inline void k10_prefetch(const void*) {}
#endif

// Copies m rows of L int32 columns between global rows ``g`` (row stride
// L) and resident rows ``s`` (row stride Ws, column c at k10_pos(c)): 16
// bytes a thread in global memory where ``vec`` (L % 4 == 0 and both
// tapes 16-byte aligned; four columns from a multiple of 4 lie within one
// run of 32, so at consecutive words), a column a thread else.
K10_FN void k10_tile_copy(int tid, int nt, int* g, int* s, int m, int L,
                          int Ws, bool vec, bool to_shared) {
  if (vec) {
    const int q = L >> 2;
    for (int c = tid; c < m * q; c += nt) {
      const int r = c / q;
      const int col = 4 * (c - r * q);
      k10_v4* gp = (k10_v4*)(g + (long long)r * L + col);
      int* sp = s + (long long)r * Ws + k10_pos(col);
      if (to_shared) {
        const k10_v4 v = *gp;
        sp[0] = v.x;
        sp[1] = v.y;
        sp[2] = v.z;
        sp[3] = v.w;
      } else {
        k10_v4 v;
        v.x = sp[0];
        v.y = sp[1];
        v.z = sp[2];
        v.w = sp[3];
        *gp = v;
      }
    }
    return;
  }
  for (int c = tid; c < m * L; c += nt) {
    const int r = c / L;
    const int col = c - r * L;
    int* gp = g + (long long)r * L + col;
    int* sp = s + (long long)r * Ws + k10_pos(col);
    if (to_shared)
      *sp = *gp;
    else
      *gp = *sp;
  }
}

// The window a resident site reads, for N cells (N > 0 a compile-time
// count, whose loops unroll and whose arrays the kernel keeps in
// registers; 0 for t.n_p + t.n_d at run time): cell j's offset from the
// site's base column, brought within (-L, L) once for the call, and its
// place value.
template <int N>
struct K10Window {
  int off[N > 0 ? N : K10_MAX_CELLS];
  int pv[N > 0 ? N : K10_MAX_CELLS];
  int n, n_p;
};

template <int N>
K10_FN K10Window<N> k10_window(const K10Table& t, int L) {
  K10Window<N> w;
  w.n = N > 0 ? N : t.n_p + t.n_d;
  w.n_p = t.n_p;
#pragma unroll
  for (int j = 0; j < (N > 0 ? N : w.n); ++j) {
    const int off = j < t.n_p ? t.p_lo + j : t.d_lo + (j - t.n_p);
    w.off[j] = off >= L || off <= -L ? off % L : off;
    w.pv[j] = t.pv[j];
  }
  return w;
}

// Window cell j's word in resident rows at base in [0, L): base plus the
// cell's offset wrapped once, in 32-bit steps; the column (base +
// offset) mod L, floored, as `k10_col` gives it.
template <int N>
K10_FN int* k10_cell(const K10Window<N>& w, int* prow, int* drow, int L,
                     int base, int j) {
  int c = base + w.off[j];
  c = c < 0 ? c + L : (c >= L ? c - L : c);
  return (j < w.n_p ? prow : drow) + k10_pos(c);
}

// `k10_site` on resident rows, without its per-thread arrays, in two
// halves. The first forms the row's radix sum over the window's cells
// and returns the row's first slot (row * M); the second, given the
// fired spec, reads each cell the spec writes again and stores it where
// it changes. A tape's window cells lie in distinct columns (the
// geometry check keeps a window within the ring), so the second half
// reads the values the first did.
template <int N>
K10_FN long long k10_site_row(const K10Table& t, const K10Window<N>& w,
                              int* prow, int* drow, int L, int base) {
  uint32_t rank = 0;
#pragma unroll
  for (int j = 0; j < (N > 0 ? N : w.n); ++j)
    rank += (uint32_t)*k10_cell(w, prow, drow, L, base, j) *
            (uint32_t)w.pv[j];
  return (long long)k10_clamp_row(rank, t.rows) * t.M;
}

template <int N>
K10_FN void k10_site_writes(const K10Table& t, const K10Window<N>& w,
                            int* prow, int* drow, int L, int base,
                            long long spec) {
  const uint8_t* mask = t.wr_mask + spec * w.n;
  const int* val = t.wr_val + spec * w.n;
#pragma unroll
  for (int j = 0; j < (N > 0 ? N : w.n); ++j) {
    if (!mask[j]) continue;
    int* cell = k10_cell(w, prow, drow, L, base, j);
    if (*cell != val[j]) *cell = val[j];
  }
}

// Member i's site e of a round on the tile's rows: its rows and its
// base (shift + e*stride) mod L in 32-bit steps.
struct K10Site {
  int* prow;
  int* drow;
  int base;
};

K10_FN K10Site k10_tile_site(int* sp, int* sd, int Ws, int L, int stride,
                             int i, int e, int shift) {
  K10Site s;
  s.prow = sp + (long long)i * Ws;
  s.drow = sd + (long long)i * Ws;
  int b = shift % L;
  b = (b < 0 ? b + L : b) + e * stride;
  s.base = b >= L ? b - L : b;
  return s;
}

// One round's sites of the tile's m members (b0 the first; rows ``sp``,
// ``sd`` at stride Ws): member i's site e at shift sh[b0 + i] (per
// member) or sh[0], neighbouring threads on neighbouring sites; its
// uniform u[(b0 + i)*E + e] of the round's [B, E] read only where the
// table has more than one outcome a row. A thread takes two sites at a
// time, items w and w + nt: both rows' sums, then both table gathers
// (their L2 round trips overlap), then both sites' writes. The round's
// windows are disjoint, so this order equals the sites' in turn.
template <typename T, int N>
K10_FN void k10_tile_sites(int tid, int nt, const K10Table& t,
                           const K10Window<N>& win, int* sp, int* sd, int m,
                           int L, int Ws, int E, int b0, const T* u,
                           const int* sh, int per_member) {
  const int stride = L / E;
  const int items = m * E;
  for (int w = tid; w < items; w += 2 * nt) {
    const int w2 = w + nt;
    const bool two = w2 < items;
    const int i = w / E, e = w - (w / E) * E;
    const int i2 = two ? w2 / E : i, e2 = two ? w2 - (w2 / E) * E : e;
    const K10Site a = k10_tile_site(sp, sd, Ws, L, stride, i, e,
                                    sh[per_member ? b0 + i : 0]);
    const K10Site c = k10_tile_site(sp, sd, Ws, L, stride, i2, e2,
                                    sh[per_member ? b0 + i2 : 0]);
    const long long at = k10_site_row(t, win, a.prow, a.drow, L, a.base);
    const long long at2 =
        two ? k10_site_row(t, win, c.prow, c.drow, L, c.base) : at;
    const T ua = t.M > 1 ? u[(long long)(b0 + i) * E + e] : T(0);
    const T uc = t.M > 1 && two ? u[(long long)(b0 + i2) * E + e2] : T(0);
    const long long spec =
        t.out_world[at + k10_slot((const T*)t.out_cum + at, t.M, ua)];
    const long long spec2 =
        two ? t.out_world[at2 + k10_slot((const T*)t.out_cum + at2, t.M, uc)]
            : 0;
    k10_site_writes(t, win, a.prow, a.drow, L, a.base, spec);
    if (two) k10_site_writes(t, win, c.prow, c.drow, L, c.base, spec2);
  }
}

// Calls f with std::integral_constant<int, N> for a window of n cells:
// N = n for the cell counts of the tables the paths drive (4: ex2's;
// 6: ex4's; 7: ex5's; 8: ex3's), else N = 0 (the count at run time).
template <class F>
static inline int k10_by_cells(int n, F f) {
  switch (n) {
    case 4: return f(std::integral_constant<int, 4>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
    default: return f(std::integral_constant<int, 0>());
  }
}

#ifndef __CUDACC__
// The resident kernel on the host (the CPU test of the rule): tile after
// tile, each of the kernel's phases run for every thread ``tid`` <
// ``threads`` in turn, on a buffer laid out as the kernel's shared
// memory. Rounds [k0, k0+n): round k0+j reads shifts[k0+j] (shared) or
// shifts[(k0+j)*B + b] (per member) and uniforms [j*B*E, (j+1)*B*E)
// (double when u_f64, else float); the rest as `ckpe_k10_host_round`.
extern "C" int ckpe_k10_host_resident(
    int* p, int* d, const void* u, int u_f64, const int* shifts,
    int per_member, int k0, int n, int B, int L, int E, const int* pv,
    const void* out_cum, const int* out_world, int rows, int M,
    const uint8_t* wr_mask, const int* wr_val, int p_lo, int n_p, int d_lo,
    int n_d, int tile, int threads) {
  if (E <= 0 || L % E != 0 || n_p + n_d > K10_MAX_CELLS || tile < 1 ||
      threads < 1)
    return 1;
  const K10Table t = {pv, out_cum, out_world, wr_mask, wr_val, rows, M,
                      p_lo, n_p, d_lo, n_d};
  const int Ws = k10_row_words(L);
  const long long bytes = k10_tile_bytes(tile, L);
  int* sp = (int*)aligned_alloc(16, (bytes + 15) & ~15LL);
  if (!sp) return 1;
  int* sd = sp + (long long)tile * Ws;
  const bool vec = L % 4 == 0 && (uintptr_t)p % 16 == 0 &&
                   (uintptr_t)d % 16 == 0;
  const long long sites = (long long)B * E;
  for (int b0 = 0; b0 < B; b0 += tile) {
    const int m = tile < B - b0 ? tile : B - b0;
    int* gp = p + (long long)b0 * L;
    int* gd = d + (long long)b0 * L;
    for (int w = 0; w < threads; ++w) {
      k10_tile_copy(w, threads, gp, sp, m, L, Ws, vec, true);
      k10_tile_copy(w, threads, gd, sd, m, L, Ws, vec, true);
    }
    k10_by_cells(n_p + n_d, [&](auto cells) {
      constexpr int N = decltype(cells)::value;
      const K10Window<N> win = k10_window<N>(t, L);
      for (int j = 0; j < n; ++j) {
        const int* sh = shifts + (long long)(k0 + j) * (per_member ? B : 1);
        for (int w = 0; w < threads; ++w)
          if (u_f64)
            k10_tile_sites<double, N>(w, threads, t, win, sp, sd, m, L, Ws,
                                      E, b0, (const double*)u + j * sites,
                                      sh, per_member);
          else
            k10_tile_sites<float, N>(w, threads, t, win, sp, sd, m, L, Ws, E,
                                     b0, (const float*)u + j * sites, sh,
                                     per_member);
      }
      return 0;
    });
    for (int w = 0; w < threads; ++w) {
      k10_tile_copy(w, threads, gp, sp, m, L, Ws, vec, false);
      k10_tile_copy(w, threads, gd, sd, m, L, Ws, vec, false);
    }
  }
  free(sp);
  return 0;
}
#endif
