// K11 `lattice_round`: FSM rounds of the ensemble on [B, L] int8 tapes,
// in place, at a shift shared by the batch or one a member; and first
// passage, K11's rounds with K12's update after each.
//
// Replaces the JAX package's `engine/ensemble.py:989
// _apply_lattice_round_fsm` with `:913 _roll_cols` and `:1229
// _roll_rows` (XLA programs: rolls of both tapes by the round's shift,
// the walk on the rolled blocks, the roll back; for independent sites a
// gather a member to move each tape by the change of its phase; no
// Pallas kernel), the path of `run_ensemble(independent_sites=True)`,
// of strides above the plane path's 64 and of `first_passage_times`.
// Plain PyTorch version: `engine/ensemble.py:lattice_round_plain`.
//
// Sources. The generated unit of a machine (`engine/k1_source.py`)
// includes this file after `plane_round.cuh`, so the round walks the
// machine's own code: K1's exact walk (`k1_walk_exact`, one site at a
// time, any int8 symbol) and K1's writes (`k1_write_lanes`, lane 0).
//
// Addressing: site e of member b at shift s reads window cell j of a
// tape with read offset lo at column (s + lo + e*stride + j) mod L,
// floored: the reference's roll by the shift, its roll by each member's
// phase and its reshape land the same cells on the same uniform, so no
// tape moves. The caller's geometry check keeps a round's windows
// disjoint (sites more than 2*span apart, or one a member), and a site
// stores only the cells its spec changes (`k11_site`).
//
// Design: resident rounds. Members never interact, so a block owns a
// tile of members for every round of a C call: it loads both rows of
// each (2L bytes a member, 16-byte loads where the rows allow) into
// dynamic shared memory, runs the call's n rounds on them (each round
// reads its shift and its uniforms from global memory, prefetched a
// round ahead; the tile syncs between rounds) and writes the rows back
// once. Where E % 4 == 0 a thread takes four sites of a member by K1's
// lane walk, neighbouring threads on neighbouring members: a member's
// sites lie 16 bytes apart, which would put a warp's byte reads in a few
// banks, so the rows are padded to lie a bank apart (`k11_row_stride`).
// What bounds a round then is the walk's integer work, as for K1. First
// passage applies K12's update (`pattern_rule.cuh`) to the watched rows
// in shared memory after each round, so a C call of n rounds is one
// launch, where it was 2n. The tempered entry is resident too (below).
// The caller sizes the tile from
// the block's 227 KB (`ensemble.k11_tile`: two blocks an SM where their
// rows fit, and enough blocks for the card's 132 SMs). Rows too long for
// one member a block (2L past 227 KB, L past about 116,000) keep the
// kernel of one launch a round, a thread a site, reading and writing
// the tapes in global memory (tile 0, chosen by the geometry alone), as
// do calls of fewer than four rounds (`ensemble.K11_RESIDENT_MIN_ROUNDS`:
// loading and storing whole rows costs about three rounds).
//
// Tempered rounds (a unit with K1_LOGP: chooses sampled from q ~ p^tau,
// tau != 1) replace the FSM route of the JAX package's
// `engine/ensemble.py:2090 _blocked_rounds` with `:1170
// _apply_plane_round_fsm_stacked(want_logp=True)` and the increments of
// `:705 _machine_specs_planes_leveled` (the weighted frontier's rounds;
// its [E, K] planes hold the same site lattice as a shared shift here).
// One thread a member walks its E sites in order, each site's float32
// increments summed level by level, the sites' sums added in float32
// from 0 in site order, and that sum added to the member's float64
// log-weight: the order of `ensemble.lattice_round_plain(lw=...)`. The
// rounds of a call are resident as K11's are: a block loads a tile of
// members' rows (an odd count of words a row, `k11_odd_stride`), each
// thread runs all the call's rounds on its own members, four sites at
// a time by the lane walk with a float32 sum a lane, their log-weights
// in registers, and the rows go back once (`k11t_tile_rounds`;
// `ensemble.k11_tempered_tile`); rows too long and calls of fewer than
// four rounds keep a launch a round, a thread a member.
//
// Bound: bytes, by this count (what holds a resident round is the walk's
// integer work). A round must read the cells the walk reveals and the
// written cells some spec leaves alone, write the cells some spec
// writes (`k1_source.cell_traffic`), a byte each, and read a float32
// uniform a site for a machine with choose nodes: 41.9 MB at B=16384,
// E=256 on ex5-msrtf-machine, 12.5 us at 3.35 TB/s, as K1. Unlike K1's
// planes, the [B, L] layout puts a round's sites 16 bytes apart at
// stride 16, so every 32-byte sector of both tapes is read and written
// by a kernel that goes back to global memory each round. Over a call of
// n resident rounds the rows cross once each way (4BL bytes) and each
// round moves only its shifts and uniforms (and, tempered, lw once each
// way a call).

#pragma once

#include "pattern_rule.cuh"

K1_FN int k11_col(long long a, int L) {
  long long r = a % L;
  return (int)(r < 0 ? r + L : r);
}

#ifndef K1_LOGP
#define K1_LOGP 0
#endif

// One site on member rows prow, drow of length L, at base = shift +
// e*stride, with uniform u; returns the fired spec. In a tempered unit,
// with lp non-null, the walk adds the site's increments to *lp; with
// c_out and y_out non-null, the site's cells before and after its writes
// go there (K23's and K24's sums read them).
K1_FN int k11_site(int8_t* prow, int8_t* drow, int L, long long base,
                   double u, float* lp = nullptr, int* c_out = nullptr,
                   int* y_out = nullptr) {
  int col[K1_N_CELLS];
  int c[K1_N_CELLS];
#pragma unroll
  for (int k = 0; k < K1_N_CELLS; ++k) {
    const int off = k < K1_N_P ? K1_P_LO + k : K1_D_LO + (k - K1_N_P);
    col[k] = k11_col(base + off, L);
    c[k] = (int)(k < K1_N_P ? prow : drow)[col[k]];
  }
#if K1_LOGP
  const uint32_t spec =
      (uint32_t)(lp ? k1_walk_exact_logp(c, u, lp) : k1_walk_exact(c, u));
#else
  (void)lp;
  const uint32_t spec = (uint32_t)k1_walk_exact(c, u);
#endif
#pragma unroll
  for (int k = 0; k < K1_N_CELLS; ++k) {
    if (c_out) c_out[k] = c[k];
    if (y_out) y_out[k] = c[k];
    if (!k1_written(k)) continue;
    const uint32_t x = (uint8_t)c[k];
    const uint32_t y = k1_write_lanes(k, spec, x) & 0xffu;
    if (y != x) {
      (k < K1_N_P ? prow : drow)[col[k]] = (int8_t)(uint8_t)y;
      if (y_out) y_out[k] = (int)(int8_t)(uint8_t)y;
    }
  }
  return (int)spec;
}

// Site t = b*E + e of a round.
K1_FN void k11_thread(long long t, int8_t* p, int8_t* d, const float* u,
                      const int* shifts, int per_member, int L, int E) {
  const int b = (int)(t / E);
  const int e = (int)(t - (long long)b * E);
  const long long base =
      (long long)shifts[per_member ? b : 0] + (long long)e * (L / E);
  k11_site(p + (long long)b * L, d + (long long)b * L, L, base,
           K1_CHOOSE ? (double)u[t] : 0.0);
}

#if K1_LOGP
// Member b of a tempered round at the shared shift: its E sites in
// order, then lw[b] += the float32 sum of their increments.
K1_FN void k11_member_logp(int b, int8_t* p, int8_t* d, const float* u,
                           const int* shifts, int L, int E, double* lw) {
  float s = 0.0f;
  for (int e = 0; e < E; ++e) {
    float lp = 0.0f;
    k11_site(p + (long long)b * L, d + (long long)b * L, L,
             (long long)shifts[0] + (long long)e * (L / E),
             (double)u[(long long)b * E + e], &lp);
    s = s + lp;
  }
  lw[b] = lw[b] + (double)s;
}
#endif

// --- Resident rounds: the phases of a tile, shared by the kernel and its
// host twin. ``tid`` and ``nt`` are the thread and the block's width; a
// phase touches what no other thread of the same phase touches, so the
// host runs each phase thread after thread.

#ifdef __CUDACC__
#define K11_HD __host__ __device__ __forceinline__
#else
#define K11_HD static inline
#endif

#ifdef __CUDACC__
// A hint to bring the line holding p into L1.
__device__ __forceinline__ void k11_prefetch(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}
#else
static inline void k11_prefetch(const void*) {}
#endif

// Row stride of a member in shared memory: L rounded up to 4 bytes, then
// to 4 more than a multiple of 128, so that the same column of
// neighbouring members lies in neighbouring banks.
K11_HD int k11_row_stride(int L) {
  const int w = (L + 3) & ~3;
  return w + ((132 - w % 128) & 127);
}

// Shared memory of a tile of ``tile`` members: both rows, then for first
// passage t_hit (double) and a flag (int) a member and the pattern.
K11_HD long long k11_tile_bytes(int tile, int L, int fp, int P) {
  const long long rows = 2LL * tile * k11_row_stride(L);
  return fp ? rows + 12LL * tile + 4LL * P : rows;
}

// Copies m rows of L bytes between global rows ``g`` (row stride L) and
// shared rows ``s`` (row stride Ls, a multiple of 4), 16 bytes a thread
// in global memory (four 4-byte words in shared memory) where ``vec``
// (L % 16 == 0 and both tapes 16-byte aligned), a byte a thread else.
K1_FN void k11_tile_copy(int tid, int nt, int8_t* g, int8_t* s, int m,
                         int L, int Ls, bool vec, bool to_shared) {
  if (vec) {
    const int q = L >> 4;
    for (int c = tid; c < m * q; c += nt) {
      const int r = c / q;
      k12_v16* gp = (k12_v16*)(g + (long long)r * L) + (c - r * q);
      uint32_t* sp = (uint32_t*)(s + (long long)r * Ls) + 4 * (c - r * q);
      if (to_shared) {
        const k12_v16 v = *gp;
        sp[0] = v.x;
        sp[1] = v.y;
        sp[2] = v.z;
        sp[3] = v.w;
      } else {
        k12_v16 v;
        v.x = sp[0];
        v.y = sp[1];
        v.z = sp[2];
        v.w = sp[3];
        *gp = v;
      }
    }
  } else {
    for (int c = tid; c < m * L; c += nt) {
      const int r = c / L;
      int8_t* gp = g + (long long)r * L + (c - r * L);
      int8_t* sp = s + (long long)r * Ls + (c - r * L);
      if (to_shared)
        *sp = *gp;
      else
        *gp = *sp;
    }
  }
}

// Column r + off of a row of L for r in [0, 2L) and an offset |off| < L:
// the floored (r + off) mod L, as `k11_col` gives it, in 32-bit steps.
K1_FN int k11_wrap(int v, int L) {
  if (v < 0) return v + L;
  if (v >= L) v -= L;
  return v >= L ? v - L : v;
}

// Window cell k's offset, brought within (-L, L) (a remainder only for a
// rule that reads a ring's length or more away).
K1_FN int k11_offset(int k, int L) {
  const int off = k < K1_N_P ? K1_P_LO + k : K1_D_LO + (k - K1_N_P);
  return off >= L || off <= -L ? off % L : off;
}

// Sites e0..e0+3 of a member's rows at shift s, uniforms u[0..4): K1's
// lane walk, a site a byte lane of each window cell's word (the four
// windows are disjoint, so reading all cells before any write is the
// sites' walk in turn), where every cell holds a symbol in [0, size_a);
// else the exact walk site by site, as K1 does. The cells stored are
// those whose byte changed. A site's column r + off (r its start, below
// 2L) wraps by `k11_wrap`, its offset within (-L, L) (`k11_offset`).
// Returns the four specs, a byte lane each. In a tempered unit, with lp
// non-null, site j's increments are added to lp[j]; with x_out and
// y_out non-null, each window cell's word before and after the writes
// goes there (K24's resident rounds read them).
K1_FN uint32_t k11_four_sites(int8_t* prow, int8_t* drow, int L, int s,
                              int e0, int stride, const float* u,
                              float* lp = nullptr, uint32_t* x_out = nullptr,
                              uint32_t* y_out = nullptr) {
  int r = s % L;
  r = (r < 0 ? r + L : r) + e0 * stride;
  uint32_t x[K1_N_CELLS];
  uint32_t bad = 0;
#pragma unroll
  for (int k = 0; k < K1_N_CELLS; ++k) {
    const int off = k11_offset(k, L);
    const int8_t* row = k < K1_N_P ? prow : drow;
    x[k] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[k] |= (uint32_t)(uint8_t)row[k11_wrap(r + j * stride + off, L)]
              << (8 * j);
    bad |= x[k] | (x[k] + (0x80 - K1_SIZE_A) * 0x01010101u);
  }
  bad &= 0x80808080u;
  double uu[4] = {0.0, 0.0, 0.0, 0.0};
  if (K1_CHOOSE)
#pragma unroll
    for (int j = 0; j < 4; ++j) uu[j] = (double)u[j];
  uint32_t spec = 0;
  if (bad) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c[K1_N_CELLS];
#pragma unroll
      for (int k = 0; k < K1_N_CELLS; ++k)
        c[k] = (int)(int8_t)(uint8_t)(x[k] >> (8 * j));
#if K1_LOGP
      spec |= (uint32_t)(lp ? k1_walk_exact_logp(c, uu[j], lp + j)
                            : k1_walk_exact(c, uu[j])) << (8 * j);
#else
      spec |= (uint32_t)k1_walk_exact(c, uu[j]) << (8 * j);
#endif
    }
  } else {
#if K1_LOGP
    spec = lp ? k1_walk_lanes_logp(x, uu, lp) : k1_walk_lanes(x, uu);
#else
    (void)lp;
    spec = k1_walk_lanes(x, uu);
#endif
  }
#pragma unroll
  for (int k = 0; k < K1_N_CELLS; ++k) {
    if (x_out) {
      x_out[k] = x[k];
      y_out[k] = x[k];
    }
    if (!k1_written(k)) continue;
    const uint32_t y = k1_write_lanes(k, spec, x[k]);
    if (y_out) y_out[k] = y;
    if (y == x[k]) continue;
    const int off = k11_offset(k, L);
    int8_t* row = k < K1_N_P ? prow : drow;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t nb = (uint8_t)(y >> (8 * j));
      if (nb != (uint8_t)(x[k] >> (8 * j)))
        row[k11_wrap(r + j * stride + off, L)] = (int8_t)nb;
    }
  }
  return spec;
}

// One round's sites of the tile's m members (b0 the first): member
// i's site e at shift sh[b0 + i] (per member) or sh[0], uniform
// u[(b0 + i)*E + e] of the round's [B, E]. Four sites a thread by K1's
// lane walk where E is a multiple of 4 (`k11_four_sites`), neighbouring
// threads on neighbouring members (whose rows `k11_row_stride` puts a
// bank apart: the sites of one member lie 16 bytes apart, which would
// put a warp's reads in few banks); else a site a thread (`k11_site`).
K1_FN void k11_tile_sites(int tid, int nt, int8_t* sp, int8_t* sd, int m,
                          int L, int Ls, int E, int b0, const float* u,
                          const int* sh, int per_member) {
  if (E % 4 == 0) {
    const int q = E / 4;
    for (int t = tid; t < m * q; t += nt) {
      const int g = t / m;
      const int i = t - g * m;
      const int e0 = 4 * g;
      k11_four_sites(sp + (long long)i * Ls, sd + (long long)i * Ls, L,
                     sh[per_member ? b0 + i : 0], e0, L / E,
                     K1_CHOOSE ? u + (long long)(b0 + i) * E + e0 : nullptr);
    }
    return;
  }
  for (int t = tid; t < m * E; t += nt) {
    const int i = t / E;
    const int e = t - i * E;
    const long long base =
        (long long)sh[per_member ? b0 + i : 0] + (long long)e * (L / E);
    k11_site(sp + (long long)i * Ls, sd + (long long)i * Ls, L, base,
             K1_CHOOSE ? (double)u[(long long)(b0 + i) * E + e] : 0.0);
  }
}

// First passage, after a round: flag[i] = 1 where member i has not hit
// (th[i] infinite) and the pattern occurs on its watched row ``w``.
K1_FN void k11_tile_scan(int tid, int nt, const int8_t* w, int m, int L,
                         int Ls, const int* pat, int P, const double* th,
                         int* flag) {
  // Position x = i*L + c, stepped by nt without a division a step.
  const int di = nt / L, dc = nt - (nt / L) * L;
  int i = tid / L, c = tid - (tid / L) * L;
  for (; i < m; i += di, c += dc) {
    if (c >= L) {
      c -= L;
      ++i;
      if (i >= m) break;
    }
    if (!isinf(th[i]) || flag[i]) continue;
    if (k12_prefix_at(w + (long long)i * Ls, L, c, pat, P) == P) flag[i] = 1;
  }
}

// Then K12's mode 2 (`k12_finish`, the progress P where flagged): th[i]
// = *t_now where the pattern occurs and th[i] is still infinite (t_now
// read only then).
K1_FN void k11_tile_hits(int tid, int nt, int m, int P, double* th,
                         int* flag, const double* t_now) {
  for (int i = tid; i < m; i += nt) {
    if (flag[i]) k12_finish(kK12FirstPassage, P, P, nullptr, th, t_now, i);
    flag[i] = 0;
  }
}

// Row stride of a member in the resident tempered rounds and K24's
// (`thermo_round.cuh`): an odd count of 4-byte words, so that one column
// of 32 neighbouring members lies in 32 banks (`k11_row_stride`'s 33
// words mod 32 do the same at more bytes a row).
K11_HD int k11_odd_stride(int L) { return 4 * (((L + 3) >> 2) | 1); }

#if K1_LOGP
// Rounds [k0, k0+n) of a resident tempered tile of m members (b0 the
// first; its rows at stride Ls in ``sp``, ``sd``), a thread a member:
// thread tid owns members tid, tid + nt, ... for every round of the
// call, so no other thread touches their rows and the rounds need no
// barrier, and it keeps the member's float64 log-weight lw[b0 + i] in a
// register from the first round to the last. A round walks the member's
// E sites in site order, four at a time by the lane walk where E % 4 ==
// 0 (`k11_four_sites`, each site's increments in its lane's sum), else
// one by one (`k11_site`); sums the sites' float32 increments from 0 in
// site order and adds that sum once to lw: the order of
// `ensemble.lattice_round_plain(lw=...)`. Round k0+j reads shifts[k0+j]
// and the uniforms u + j*sites, and prefetches the next round's.
K1_FN void k11t_tile_rounds(int tid, int nt, int8_t* sp, int8_t* sd, int m,
                            int L, int Ls, int E, int b0, long long sites,
                            const float* u, const int* shifts, int k0, int n,
                            double* lw) {
  const int stride = L / E;
  for (int i = tid; i < m; i += nt) {
    int8_t* pr = sp + (long long)i * Ls;
    int8_t* dr = sd + (long long)i * Ls;
    double w = lw[b0 + i];
    for (int j = 0; j < n; ++j) {
      const float* ur = u + j * sites + (long long)(b0 + i) * E;
      if (j + 1 < n) k11_prefetch(ur + sites);
      const int s = shifts[k0 + j];
      float sum = 0.0f;
      if (E % 4 == 0) {
        for (int e0 = 0; e0 < E; e0 += 4) {
          float lp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          k11_four_sites(pr, dr, L, s, e0, stride, ur + e0, lp);
#pragma unroll
          for (int q = 0; q < 4; ++q) sum = sum + lp[q];
        }
      } else {
        for (int e = 0; e < E; ++e) {
          float lp = 0.0f;
          k11_site(pr, dr, L, (long long)s + (long long)e * stride,
                   (double)ur[e], &lp);
          sum = sum + lp;
        }
      }
      w = w + (double)sum;
    }
    lw[b0 + i] = w;
  }
}
#endif

#ifdef __CUDACC__

__global__ void __launch_bounds__(K1_THREADS)
    k11_kernel(int8_t* __restrict__ p, int8_t* __restrict__ d,
               const float* __restrict__ u, const int* __restrict__ shifts,
               int per_member, int B, int L, int E) {
  const long long t = (long long)blockIdx.x * K1_THREADS + threadIdx.x;
  if (t >= (long long)B * E) return;
  k11_thread(t, p, d, u, shifts, per_member, L, E);
}

static inline int k11_launch(void* p, void* d, const float* u,
                             const int* shifts, int per_member, int B, int L,
                             int E, cudaStream_t st) {
  const long long sites = (long long)B * E;
  const unsigned blocks = (unsigned)((sites + K1_THREADS - 1) / K1_THREADS);
  k11_kernel<<<blocks, K1_THREADS, 0, st>>>(
      (int8_t*)p, (int8_t*)d, K1_CHOOSE ? u : nullptr, shifts, per_member, B,
      L, E);
  return (int)cudaGetLastError();
}

static inline bool k11_bad_geometry(int B, int L, int E) {
  return E <= 0 || L % E != 0 || (long long)B * L >= (1LL << 31);
}

// The most dynamic shared memory a block may have (227 KB on the H100).
#define K11_SMEM_MAX 232448

// The resident rounds [k0, k0+n) of a tile a block (see the header).
// ``watch`` is -1 without first passage, else the watched tape (0 the
// program tape, 1 the data tape).
__global__ void k11_resident_kernel(int8_t* __restrict__ p,
                                    int8_t* __restrict__ d,
                                    const float* __restrict__ u,
                                    const int* __restrict__ shifts,
                                    int per_member, int k0, int n, int B,
                                    int L, int E, int tile, int vec,
                                    int watch, const int* __restrict__ pat,
                                    int P, double* __restrict__ t_hit,
                                    const double* __restrict__ times) {
  extern __shared__ __align__(16) unsigned char k11_smem[];
  const int Ls = k11_row_stride(L);
  const int b0 = blockIdx.x * tile;
  const int m = min(tile, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  int8_t* sp = (int8_t*)k11_smem;
  int8_t* sd = sp + (long long)tile * Ls;
  double* th = (double*)(sd + (long long)tile * Ls);
  int* flag = (int*)(th + tile);
  int* spat = flag + tile;
  int8_t* gp = p + (long long)b0 * L;
  int8_t* gd = d + (long long)b0 * L;
  k11_tile_copy(tid, nt, gp, sp, m, L, Ls, vec, true);
  k11_tile_copy(tid, nt, gd, sd, m, L, Ls, vec, true);
  if (watch >= 0) {
    for (int i = tid; i < m; i += nt) {
      th[i] = t_hit[b0 + i];
      flag[i] = 0;
    }
    for (int k = tid; k < P; k += nt) spat[k] = pat[k];
  }
  __syncthreads();
  const long long sites = (long long)B * E;
  // The member and first uniform of this thread's first site group (four
  // sites where E % 4 == 0, else one), whose next-round draws it
  // prefetches into L1 while the round runs.
  const int lanes = E % 4 == 0;
  const int mine = tid < m * (lanes ? E / 4 : E);
  const int i0 = lanes ? tid % m : tid / E;
  const long long u0 = (long long)(b0 + i0) * E +
                       (lanes ? 4 * (tid / m) : tid - i0 * E);
  for (int j = 0; j < n; ++j) {
    const int k = k0 + j;
    if (mine && j + 1 < n) {
      k11_prefetch(shifts + (long long)(k + 1) * (per_member ? B : 1) +
                   (per_member ? b0 + i0 : 0));
      if (K1_CHOOSE) k11_prefetch(u + (j + 1) * sites + u0);
    }
    k11_tile_sites(tid, nt, sp, sd, m, L, Ls, E, b0,
                   K1_CHOOSE ? u + j * sites : nullptr,
                   shifts + (long long)k * (per_member ? B : 1), per_member);
    __syncthreads();
    if (watch >= 0) {
      k11_tile_scan(tid, nt, watch ? sd : sp, m, L, Ls, spat, P, th, flag);
      __syncthreads();
      k11_tile_hits(tid, nt, m, P, th, flag, times + k + 1);
    }
  }
  __syncthreads();
  k11_tile_copy(tid, nt, gp, sp, m, L, Ls, vec, false);
  k11_tile_copy(tid, nt, gd, sd, m, L, Ls, vec, false);
  if (watch >= 0)
    for (int i = tid; i < m; i += nt) t_hit[b0 + i] = th[i];
}

// One launch of the resident kernel for rounds [k0, k0+n): ``tile``
// members a block of ``threads`` threads. Returns the launch error, or
// cudaErrorInvalidValue where the tile's rows do not fit.
static int k11_resident(void* p, void* d, const void* u, const void* shifts,
                        int per_member, int k0, int n, int B, int L, int E,
                        int tile, int threads, int watch, const void* pat,
                        int P, void* t_hit, const void* times,
                        cudaStream_t st) {
  const long long bytes = k11_tile_bytes(tile, L, watch >= 0, P);
  if (tile < 1 || threads < 32 || threads > 1024 || bytes > K11_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k11_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec = L % 16 == 0 && (uintptr_t)p % 16 == 0 &&
                  (uintptr_t)d % 16 == 0;
  const unsigned blocks = (unsigned)((B + tile - 1) / tile);
  k11_resident_kernel<<<blocks, threads, (size_t)bytes, st>>>(
      (int8_t*)p, (int8_t*)d, (const float*)u, (const int*)shifts,
      per_member, k0, n, B, L, E, tile, vec, watch, (const int*)pat, P,
      (double*)t_hit, (const double*)times);
  return (int)cudaGetLastError();
}

#if K1_LOGP
__global__ void __launch_bounds__(K1_THREADS)
    k11_logp_kernel(int8_t* __restrict__ p, int8_t* __restrict__ d,
                    const float* __restrict__ u,
                    const int* __restrict__ shifts, int B, int L, int E,
                    double* __restrict__ lw) {
  const int b = blockIdx.x * K1_THREADS + threadIdx.x;
  if (b >= B) return;
  k11_member_logp(b, p, d, u, shifts, L, E, lw);
}

// The resident tempered rounds [k0, k0+n) of a tile a block: both rows of
// each member into shared memory, the call's rounds (`k11t_tile_rounds`,
// no barrier between them), the rows back. At most 512 threads, two
// blocks an SM.
__global__ void __launch_bounds__(512, 2)
    k11t_resident_kernel(int8_t* __restrict__ p, int8_t* __restrict__ d,
                         const float* __restrict__ u,
                         const int* __restrict__ shifts, int k0, int n,
                         int B, int L, int E, int tile, int vec,
                         double* __restrict__ lw) {
  extern __shared__ __align__(16) unsigned char k11_smem[];
  const int Ls = k11_odd_stride(L);
  const int b0 = blockIdx.x * tile;
  const int m = min(tile, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  int8_t* sp = (int8_t*)k11_smem;
  int8_t* sd = sp + (long long)tile * Ls;
  int8_t* gp = p + (long long)b0 * L;
  int8_t* gd = d + (long long)b0 * L;
  k11_tile_copy(tid, nt, gp, sp, m, L, Ls, vec, true);
  k11_tile_copy(tid, nt, gd, sd, m, L, Ls, vec, true);
  __syncthreads();
  k11t_tile_rounds(tid, nt, sp, sd, m, L, Ls, E, b0, (long long)B * E, u,
                   shifts, k0, n, lw);
  __syncthreads();
  k11_tile_copy(tid, nt, gp, sp, m, L, Ls, vec, false);
  k11_tile_copy(tid, nt, gd, sd, m, L, Ls, vec, false);
}

// Tempered rounds [k0, k0+n) at shared shifts: round k0+j reads
// shifts[k0+j] and uniforms [j*B*E, (j+1)*B*E) and adds each member's
// increments to lw [B] float64. With ``tile`` > 0 one resident launch of
// ``tile`` members a block of ``threads`` (at most 512) threads; with
// ``tile`` 0 (rows too long to keep resident, or a call of few rounds)
// one launch a round, a thread a member. Returns the first launch error,
// or cudaErrorInvalidValue where the tile's rows do not fit.
extern "C" int ckpe_k11_rounds_logp(void* p, void* d, const void* uniforms,
                                    const void* shifts, int k0, int n,
                                    int B, int L, int E, void* lw, int tile,
                                    int threads, void* stream) {
  if (k11_bad_geometry(B, L, E)) return (int)cudaErrorInvalidValue;
  if (B == 0 || n <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (tile > 0) {
    const long long bytes = 2LL * tile * k11_odd_stride(L);
    if (threads < 32 || threads > 512 || bytes > K11_SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        k11t_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int vec = L % 16 == 0 && (uintptr_t)p % 16 == 0 &&
                    (uintptr_t)d % 16 == 0;
    k11t_resident_kernel<<<(unsigned)((B + tile - 1) / tile), threads,
                           (size_t)bytes, st>>>(
        (int8_t*)p, (int8_t*)d, (const float*)uniforms, (const int*)shifts,
        k0, n, B, L, E, tile, vec, (double*)lw);
    return (int)cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((B + K1_THREADS - 1) / K1_THREADS);
  for (int j = 0; j < n; ++j) {
    k11_logp_kernel<<<blocks, K1_THREADS, 0, st>>>(
        (int8_t*)p, (int8_t*)d,
        (const float*)uniforms + (long long)j * B * E,
        (const int*)shifts + k0 + j, B, L, E, (double*)lw);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}
#endif

// Rounds [k0, k0+n) of a run on `stream`: round k0+j reads shifts[k0+j]
// (shared) or shifts[(k0+j)*B + b] (per member) on the device and
// uniforms [j*B*E, (j+1)*B*E) (ignored by a machine without choose
// nodes). With ``tile`` > 0 one resident launch of ``tile`` members a
// block of ``threads`` threads; with ``tile`` 0 (rows too long to keep
// resident, or a call of few rounds) one launch a round. Returns the
// first launch error, or 0.
extern "C" int ckpe_k11_rounds(void* p, void* d, const void* uniforms,
                               const void* shifts, int per_member, int k0,
                               int n, int B, int L, int E, int tile,
                               int threads, void* stream) {
  if (k11_bad_geometry(B, L, E)) return (int)cudaErrorInvalidValue;
  const long long sites = (long long)B * E;
  if (sites == 0 || n <= 0) return (int)cudaGetLastError();
  if (tile > 0)
    return k11_resident(p, d, uniforms, shifts, per_member, k0, n, B, L, E,
                        tile, threads, -1, nullptr, 0, nullptr, nullptr,
                        (cudaStream_t)stream);
  for (int j = 0; j < n; ++j) {
    const int rc = k11_launch(
        p, d, (const float*)uniforms + j * sites,
        (const int*)shifts + (long long)(k0 + j) * (per_member ? B : 1),
        per_member, B, L, E, (cudaStream_t)stream);
    if (rc) return rc;
  }
  return 0;
}

// K12's entry point (`pattern_scan.cu:ckpe_pattern_scan`), called by
// address.
typedef int (*k11_scan_fn)(const void* tape, int elem, int B, int L,
                           const int* pattern, int P, int mode, void* out,
                           double* t_hit, const double* t_now, int members,
                           void* stream);

// First-passage rounds [k0, k0+n) at the shared shifts shifts[k0+j]:
// after round k0+j, K12's update of t_hit [B] on the data tape
// (data_tape) or the program tape at time times[k0+j+1]. With ``tile`` >
// 0 one resident launch that applies the update in shared memory; with
// ``tile`` 0 (rows too long to keep resident) a K11 launch and a K12
// launch (``scan``, `ckpe_pattern_scan`'s address) a round, both on
// `stream`. Returns the first launch error, or 0.
extern "C" int ckpe_k11_first_passage(void* p, void* d, const void* uniforms,
                                      const void* shifts, int k0, int n,
                                      int B, int L, int E, int data_tape,
                                      const void* pattern, int P,
                                      void* t_hit, const void* times,
                                      void* scan, int tile, int threads,
                                      void* stream) {
  if (k11_bad_geometry(B, L, E) || (tile <= 0 && !scan))
    return (int)cudaErrorInvalidValue;
  const long long sites = (long long)B * E;
  if (sites == 0 || n <= 0) return (int)cudaGetLastError();
  if (tile > 0)
    return k11_resident(p, d, uniforms, shifts, 0, k0, n, B, L, E, tile,
                        threads, data_tape ? 1 : 0, pattern, P, t_hit, times,
                        (cudaStream_t)stream);
  const k11_scan_fn fn = (k11_scan_fn)scan;
  for (int j = 0; j < n; ++j) {
    int rc = k11_launch(p, d, (const float*)uniforms + j * sites,
                        (const int*)shifts + k0 + j, 0, B, L, E,
                        (cudaStream_t)stream);
    if (rc) return rc;
    rc = fn(data_tape ? d : p, 1, B, L, (const int*)pattern, P, 2, nullptr,
            (double*)t_hit, (const double*)times + k0 + j + 1, 0, stream);
    if (rc) return rc;
  }
  return 0;
}

#else

#include <stdlib.h>

// The resident kernel on the host (the CPU test of the generated unit):
// tile after tile, each of the kernel's phases run for every thread
// ``tid`` < ``threads`` in turn, on a buffer laid out as the kernel's
// shared memory. ``watch`` -1 runs rounds only; 0 or 1 first passage on
// the program or the data tape. Arguments as `ckpe_k11_rounds` and
// `ckpe_k11_first_passage` take them, on host arrays.
extern "C" int ckpe_k11_host_resident(int8_t* p, int8_t* d, const float* u,
                                      const int* shifts, int per_member,
                                      int k0, int n, int B, int L, int E,
                                      int tile, int threads, int watch,
                                      const int* pat, int P, double* t_hit,
                                      const double* times) {
  if (E <= 0 || L % E != 0 || tile < 1 || threads < 1) return 1;
  const int Ls = k11_row_stride(L);
  const long long bytes = k11_tile_bytes(tile, L, watch >= 0, P);
  unsigned char* smem = (unsigned char*)aligned_alloc(16, (bytes + 15) & ~15LL);
  if (!smem) return 1;
  int8_t* sp = (int8_t*)smem;
  int8_t* sd = sp + (long long)tile * Ls;
  double* th = (double*)(sd + (long long)tile * Ls);
  int* flag = (int*)(th + tile);
  int* spat = flag + tile;
  const bool vec = L % 16 == 0 && (uintptr_t)p % 16 == 0 &&
                   (uintptr_t)d % 16 == 0;
  const long long sites = (long long)B * E;
  for (int b0 = 0; b0 < B; b0 += tile) {
    const int m = tile < B - b0 ? tile : B - b0;
    int8_t* gp = p + (long long)b0 * L;
    int8_t* gd = d + (long long)b0 * L;
    for (int t = 0; t < threads; ++t) {
      k11_tile_copy(t, threads, gp, sp, m, L, Ls, vec, true);
      k11_tile_copy(t, threads, gd, sd, m, L, Ls, vec, true);
    }
    if (watch >= 0) {
      for (int i = 0; i < m; ++i) {
        th[i] = t_hit[b0 + i];
        flag[i] = 0;
      }
      for (int k = 0; k < P; ++k) spat[k] = pat[k];
    }
    for (int j = 0; j < n; ++j) {
      const int k = k0 + j;
      for (int t = 0; t < threads; ++t)
        k11_tile_sites(t, threads, sp, sd, m, L, Ls, E, b0,
                       K1_CHOOSE ? u + j * sites : nullptr,
                       shifts + (long long)k * (per_member ? B : 1),
                       per_member);
      if (watch >= 0) {
        for (int t = 0; t < threads; ++t)
          k11_tile_scan(t, threads, watch ? sd : sp, m, L, Ls, spat, P, th,
                        flag);
        for (int t = 0; t < threads; ++t)
          k11_tile_hits(t, threads, m, P, th, flag, times + k + 1);
      }
    }
    for (int t = 0; t < threads; ++t) {
      k11_tile_copy(t, threads, gp, sp, m, L, Ls, vec, false);
      k11_tile_copy(t, threads, gd, sd, m, L, Ls, vec, false);
    }
    if (watch >= 0)
      for (int i = 0; i < m; ++i) t_hit[b0 + i] = th[i];
  }
  free(smem);
  return 0;
}

// The kernel's per-thread body for every site of one round on the host
// (the CPU test of the generated unit).
extern "C" int ckpe_k11_host_round(int8_t* p, int8_t* d, const float* u,
                                   const int* shifts, int per_member, int B,
                                   int L, int E) {
  if (E <= 0 || L % E != 0) return 1;
  for (long long t = 0; t < (long long)B * E; ++t)
    k11_thread(t, p, d, u, shifts, per_member, L, E);
  return 0;
}

#if K1_LOGP
// The resident tempered kernel on the host (the CPU test of the tempered
// unit): tile after tile, the rows copied into a buffer laid out as the
// kernel's shared memory by every thread ``t`` < ``threads`` in turn,
// each thread's rounds (`k11t_tile_rounds`), the rows copied back.
// Arguments as `ckpe_k11_rounds_logp` takes them, on host arrays.
extern "C" int ckpe_k11_host_resident_logp(int8_t* p, int8_t* d,
                                           const float* u, const int* shifts,
                                           int k0, int n, int B, int L, int E,
                                           double* lw, int tile,
                                           int threads) {
  if (E <= 0 || L % E != 0 || tile < 1 || threads < 1) return 1;
  const int Ls = k11_odd_stride(L);
  const long long bytes = 2LL * tile * Ls;
  int8_t* sp = (int8_t*)aligned_alloc(16, (bytes + 15) & ~15LL);
  if (!sp) return 1;
  int8_t* sd = sp + (long long)tile * Ls;
  const bool vec = L % 16 == 0 && (uintptr_t)p % 16 == 0 &&
                   (uintptr_t)d % 16 == 0;
  for (int b0 = 0; b0 < B; b0 += tile) {
    const int m = tile < B - b0 ? tile : B - b0;
    int8_t* gp = p + (long long)b0 * L;
    int8_t* gd = d + (long long)b0 * L;
    for (int t = 0; t < threads; ++t) {
      k11_tile_copy(t, threads, gp, sp, m, L, Ls, vec, true);
      k11_tile_copy(t, threads, gd, sd, m, L, Ls, vec, true);
    }
    for (int t = 0; t < threads; ++t)
      k11t_tile_rounds(t, threads, sp, sd, m, L, Ls, E, b0,
                       (long long)B * E, u, shifts, k0, n, lw);
    for (int t = 0; t < threads; ++t) {
      k11_tile_copy(t, threads, gp, sp, m, L, Ls, vec, false);
      k11_tile_copy(t, threads, gd, sd, m, L, Ls, vec, false);
    }
  }
  free(sp);
  return 0;
}

// The tempered kernel's per-member body for one round on the host.
extern "C" int ckpe_k11_host_round_logp(int8_t* p, int8_t* d, const float* u,
                                        const int* shifts, int B, int L,
                                        int E, double* lw) {
  if (E <= 0 || L % E != 0) return 1;
  for (int b = 0; b < B; ++b) k11_member_logp(b, p, d, u, shifts, L, E, lw);
  return 0;
}
#endif

#endif
