// K1: one stratified ensemble round on stacked int8 plane tapes, in place,
// compiled for one decision machine.
//
// Replaces the TPU kernels `probes/pallas_plane_round.py:41 fsm_kernel`
// and `probes/pallas_packed32.py:126 fsm_kernel_packed`, and the JAX
// package's `engine/ensemble.py` `_apply_plane_round_fsm_stacked` with
// `_machine_specs_planes_leveled` and `_machine_writes_planes`, which
// compute the same round. Plain PyTorch version:
// `engine/ensemble.py:plane_round_plain`.
//
// Sources. Everything is built from sources in the repository: this
// template, and a translation unit that `engine/k1_source.py` writes from
// the port's own level plan of one machine. The unit defines the macros
// and functions declared below (the walk as code with immediates, the
// write table per cell) and includes this file; `cuda.py` compiles it
// with one `nvcc` call per machine.
//
// Layout. Each tape is `stride` planes stacked as [stride, B, E] int8:
// plane c holds tape columns c::stride. Round `round` has phase
// s = shifts[round], read on the device. Site (b, i) sits at tape column
// s + i*stride; its window cell at offset `off` is plane (s+off) mod
// stride, element (i+e) mod E with e = floor((s+off)/stride). Division
// and modulo are floored, as `jnp.mod` / `jnp.floor_divide` are: `off`
// can be negative. For a phase in [0, stride) e is -1, 0 or 1; any other
// phase takes the division (a branch that is uniform over the grid).
//
// Design. A thread takes four sites at a time, in K1_ROWS rows: four
// consecutive sites of a row when E is a multiple of 4 and the planes
// are word-aligned (the word path), else one column of four rows (the
// byte path, which serves every other E). The cells' planes and spills,
// which depend on the phase and the column only, are worked out once
// for all its rows. On the word path each window cell of the four sites
// is one aligned word, or two words funnelled when the cell's spill is
// not a multiple of 4; the uniforms are 16-byte loads. The walk reads
// no plan: levels,
// cell groups, next-state tables, choose thresholds and write specs are
// immediates of the generated unit, so there is no shared-memory copy
// and no barrier. The bound on this card is the integer issue rate (64
// results a clock an SM), so the walk runs on the four sites at once,
// one byte lane each of a 32-bit word: byte-wise compares give lane
// masks, and one `prmt` looks up four lanes in an 8-entry byte table.
// Only choose levels, which divide in float64, take the sites one by
// one.
//
// Exactness. The lane walk assumes every window symbol is in
// [0, size_a); one test a word checks that, and a thread that sees any
// other byte walks its sites one by one by the reference's packed-field
// rule for out-of-range indices. Arithmetic is IEEE: built with
// -fmad=false, and double subtraction and division are the
// round-to-nearest intrinsics (plain operators on the host, where the
// CPU test builds this file with g++ -ffp-contract=off).
//
// In place. The caller's geometry check keeps one round's sites more
// than 2*span apart, so every window cell of every site is a distinct
// byte, and each cell of a round lies in its own plane. A thread stores
// only its own bytes: the whole word when the cell is aligned, else byte
// by byte. It reads all its cells before it writes any; the neighbours'
// bytes that a funnelled load also reads are discarded.
//
// Bound. A round must read, a byte a site, the cells the walk reveals
// and the written cells that some spec leaves alone, and must write the
// cells that some spec writes (`k1_source.cell_traffic`), plus 4 B of
// uniform per site for a machine with choose nodes: on
// ex5-msrtf-machine at B=16384, E=256, 7 reads and 3 writes, 10 B x
// 4,194,304 sites = 41.9 MB, 12.5 us at the H100's 3.35 TB/s. The bound
// is bytes.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K1_FN __device__ __forceinline__
#define K1_DSUB(a, b) __dsub_rn((a), (b))
#define K1_DDIV(a, b) __ddiv_rn((a), (b))
#define K1_FDIV(a, b) __fdiv_rn((a), (b))
#else
#define K1_FN static inline
#define K1_DSUB(a, b) ((a) - (b))
#define K1_DDIV(a, b) ((a) / (b))
#define K1_FDIV(a, b) ((a) / (b))
#endif

#define K1_ROWS 8       // rows a thread
#define K1_THREADS 256  // threads a block

// The generated unit defines K1_N_P, K1_N_D, K1_P_LO, K1_D_LO, K1_SIZE_A
// and K1_CHOOSE before it includes this file, and these after it:
//   k1_walk_lanes(x, u): the write specs of four sites, one byte lane
//     each, with window cells x[0..n_cells) (lane j of x[k] is site j's
//     cell k) and uniforms u[0..4), all symbols in [0, size_a);
//   k1_walk_exact(c, u): the write spec of one site with window cells
//     c[0..n_cells) (any int8) and uniform u;
//   k1_written(k): whether any spec writes window cell k;
//   k1_write_lanes(k, spec, x): window cell k's lanes x after the specs.
#define K1_N_CELLS (K1_N_P + K1_N_D)
K1_FN uint32_t k1_walk_lanes(const uint32_t* x, double* u);
K1_FN int k1_walk_exact(const int* c, double u);
K1_FN bool k1_written(int k);
K1_FN uint32_t k1_write_lanes(int k, uint32_t spec, uint32_t x);

// prmt.b32 in its default mode: byte i of the result is byte (s_i & 7)
// of {b, a} (a holds bytes 0-3), with its top bit copied to all eight
// bits when s_i & 8, s_i being nibble i of s.
K1_FN uint32_t k1_prmt(uint32_t a, uint32_t b, uint32_t s) {
#ifdef __CUDACC__
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
#else
  const uint64_t ab = ((uint64_t)b << 32) | a;
  uint32_t d = 0;
  for (int i = 0; i < 4; ++i) {
    const unsigned n = (s >> (4 * i)) & 0xf;
    uint32_t byte = (uint32_t)(ab >> (8 * (n & 7))) & 0xff;
    if (n & 8) byte = (byte & 0x80) ? 0xff : 0;
    d |= byte << (8 * i);
  }
  return d;
#endif
}

// 0xff in each lane whose top bit is set, else 0.
K1_FN uint32_t k1_lane_mask(uint32_t x) { return k1_prmt(x, 0, 0xba98); }

// Lanes of x (each below 128) that are >= k (at most 128), as a mask.
K1_FN uint32_t k1_lanes_ge(uint32_t x, uint32_t k) {
  return k1_lane_mask((x | 0x80808080u) - k * 0x01010101u);
}

// The low three bits of each lane of idx as the selector of a prmt
// lookup in an 8-entry table.
K1_FN uint32_t k1_selector(uint32_t idx) {
  const uint32_t lo = idx & 0x07070707u;
  return k1_prmt(lo | (lo >> 4), 0, 0x20);
}

K1_FN int k1_floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Plane of window cell k at phase s, and its spill as a column shift in
// [0, E): element (i + spill) mod E of that plane's row.
K1_FN void k1_cell_place(int k, int s, int stride, int E, int& plane,
                         int& spill) {
  const int off = k < K1_N_P ? K1_P_LO + k : K1_D_LO + (k - K1_N_P);
  const int a = s + off;
  if (a < -stride || a >= 2 * stride) {
    const int q = k1_floor_div(a, stride);
    plane = a - q * stride;
    spill = q - k1_floor_div(q, E) * E;
    return;
  }
  const int q = a < 0 ? -1 : (a >= stride ? 1 : 0);
  plane = a - q * stride;
  spill = q < 0 ? q + E : q;
  if (spill >= E) spill -= E;  // E == 1
}

// Funnel shift: the 32 bits of {hi, lo} from bit sh (sh < 32).
K1_FN uint32_t k1_funnel(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDACC__
  return __funnelshift_r(lo, hi, sh);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> sh);
#endif
}

// Thread t's sites, four lanes at a time. On the word path (WORDS) the
// lanes are the sites of one word, its column col of the row's E/4
// words, in each of rows [row0, row0 + K1_ROWS) in turn; on the byte
// path they are column col of four rows at a time.
template <bool WORDS>
K1_FN void k1_thread(int t, int8_t* p_st, int8_t* d_st,
                     const float* uniforms, int s, int B, int E,
                     int stride) {
  const int cols = WORDS ? E / 4 : E;
  const int group = t / cols;
  const int col = t - group * cols;
  const int row0 = group * K1_ROWS;
  // Per window cell: its plane's first row; the byte, in that row, that
  // holds the cell of the thread's first site (on the word path the word
  // holding it, the step to the next word round the ring and the funnel
  // shift); and the spill.
  int8_t* plane[K1_N_CELLS];
  int8_t* at[K1_N_CELLS];
  int next[K1_N_CELLS], sh[K1_N_CELLS], spill[K1_N_CELLS];
#pragma unroll
  for (int k = 0; k < K1_N_CELLS; ++k) {
    int pl;
    k1_cell_place(k, s, stride, E, pl, spill[k]);
    plane[k] = (k < K1_N_P ? p_st : d_st) + pl * (B * E);
    if (WORDS) {
      int q0 = col + (unsigned)spill[k] / 4;
      if (q0 >= cols) q0 -= cols;
      at[k] = plane[k] + 4 * q0;
      next[k] = q0 + 1 == cols ? 4 - E : 4;
      sh[k] = 8 * ((unsigned)spill[k] % 4);
    } else {
      int e = col + spill[k];
      if (e >= E) e -= E;
      at[k] = plane[k] + e;
    }
  }
  const int row_end = row0 + K1_ROWS < B ? row0 + K1_ROWS : B;
  for (int row = row0; row < row_end; row += WORDS ? 1 : 4) {
    const int rE = row * E;
    const int lanes = WORDS ? 4 : (row_end - row < 4 ? row_end - row : 4);
    uint32_t x[K1_N_CELLS];
    uint32_t bad = 0;
#pragma unroll
    for (int k = 0; k < K1_N_CELLS; ++k) {
      if (WORDS) {
        const uint32_t lo = *reinterpret_cast<const uint32_t*>(at[k] + rE);
        x[k] = lo;
        if (sh[k])
          x[k] = k1_funnel(
              lo, *reinterpret_cast<const uint32_t*>(at[k] + rE + next[k]),
              sh[k]);
      } else {
        x[k] = 0;
        for (int j = 0; j < lanes; ++j)
          x[k] |= (uint32_t)(uint8_t)at[k][rE + j * E] << (8 * j);
      }
      // Lanes >= 128 set their own top bit; lanes in [size_a, 128) set
      // it after the add (a carry out of a lane >= 128 lands in a word
      // already marked).
      bad |= x[k] | (x[k] + (0x80 - K1_SIZE_A) * 0x01010101u);
    }
    bad &= 0x80808080u;

    double u[4] = {0.0, 0.0, 0.0, 0.0};
    if (K1_CHOOSE) {
      if (WORDS) {
        const float* ur = uniforms + rE + 4 * col;
#ifdef __CUDACC__
        const float4 f = *reinterpret_cast<const float4*>(ur);
        u[0] = f.x;
        u[1] = f.y;
        u[2] = f.z;
        u[3] = f.w;
#else
        for (int j = 0; j < 4; ++j) u[j] = ur[j];
#endif
      } else {
        for (int j = 0; j < lanes; ++j) u[j] = uniforms[rE + j * E + col];
      }
    }

    uint32_t spec = 0;
    if (bad) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c[K1_N_CELLS];
#pragma unroll
        for (int k = 0; k < K1_N_CELLS; ++k)
          c[k] = (int)(int8_t)(uint8_t)(x[k] >> (8 * j));
        spec |= (uint32_t)k1_walk_exact(c, u[j]) << (8 * j);
      }
    } else {
      spec = k1_walk_lanes(x, u);
    }

#pragma unroll
    for (int k = 0; k < K1_N_CELLS; ++k) {
      if (!k1_written(k)) continue;
      const uint32_t y = k1_write_lanes(k, spec, x[k]);
      if (y == x[k]) continue;
      if (WORDS && sh[k] == 0) {
        *reinterpret_cast<uint32_t*>(at[k] + rE) = y;
        continue;
      }
      for (int j = 0; j < lanes; ++j) {
        const uint8_t nb = (uint8_t)(y >> (8 * j));
        if (nb == (uint8_t)(x[k] >> (8 * j))) continue;
        if (WORDS) {
          int e = 4 * col + j + spill[k];
          if (e >= E) e -= E;
          plane[k][rE + e] = (int8_t)nb;
        } else {
          at[k][rE + j * E] = (int8_t)nb;
        }
      }
    }
  }
}

// Threads a round takes: one per four sites of a row (the word path) or
// per column (the byte path), in each K1_ROWS rows.
static inline long long k1_threads(int B, int E, bool words) {
  return (long long)(words ? E / 4 : E) * ((B + K1_ROWS - 1) / K1_ROWS);
}

// Whether a launch can take the word path: E a multiple of 4, the
// planes word-aligned and the uniforms 16-byte aligned.
static inline bool k1_word_path(const void* p_st, const void* d_st,
                                const void* uniforms, int E) {
  return E % 4 == 0 && (uintptr_t)p_st % 4 == 0 &&
         (uintptr_t)d_st % 4 == 0 &&
         (!K1_CHOOSE || (uintptr_t)uniforms % 16 == 0);
}

#ifdef __CUDACC__

template <bool WORDS>
__global__ void __launch_bounds__(K1_THREADS)
    k1_kernel(int8_t* __restrict__ p_st, int8_t* __restrict__ d_st,
              const float* __restrict__ uniforms,
              const int* __restrict__ shifts, int round, int B, int E,
              int stride, int n_threads) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  k1_thread<WORDS>(t, p_st, d_st, uniforms, shifts[round], B, E, stride);
}

// Rounds [k0, k0+n) of a run, one launch a round on `stream`: round
// k0+j reads phase shifts[k0+j] on the device and uniforms
// [j*B*E, (j+1)*B*E) (ignored by a machine without choose nodes).
// Returns the first launch error, or 0.
extern "C" int ckpe_k1_rounds(void* p_st, void* d_st, const void* uniforms,
                              const void* shifts, int k0, int n, int B,
                              int E, int stride, void* stream) {
  const long long n_sites = (long long)B * E;
  if (n_sites * stride >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n_sites == 0 || n <= 0) return (int)cudaGetLastError();
  const bool words = k1_word_path(p_st, d_st, uniforms, E);
  const int n_threads = (int)k1_threads(B, E, words);
  const unsigned blocks = (unsigned)((n_threads + K1_THREADS - 1) /
                                     K1_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  for (int j = 0; j < n; ++j) {
    const float* u = K1_CHOOSE ? (const float*)uniforms + j * n_sites
                               : nullptr;
    if (words)
      k1_kernel<true><<<blocks, K1_THREADS, 0, st>>>(
          (int8_t*)p_st, (int8_t*)d_st, u, (const int*)shifts, k0 + j, B, E,
          stride, n_threads);
    else
      k1_kernel<false><<<blocks, K1_THREADS, 0, st>>>(
          (int8_t*)p_st, (int8_t*)d_st, u, (const int*)shifts, k0 + j, B, E,
          stride, n_threads);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* ckpe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#else

// The kernel's per-thread body for every thread of one round at phase
// `shift`, in a loop on the host (the CPU test of the generated unit).
extern "C" int ckpe_k1_host_round(int8_t* p_st, int8_t* d_st,
                                  const float* uniforms, int shift, int B,
                                  int E, int stride) {
  if ((long long)B * E * stride >= (1LL << 31)) return 1;
  const bool words = k1_word_path(p_st, d_st, uniforms, E);
  for (int t = 0; t < k1_threads(B, E, words); ++t) {
    if (words)
      k1_thread<true>(t, p_st, d_st, uniforms, shift, B, E, stride);
    else
      k1_thread<false>(t, p_st, d_st, uniforms, shift, B, E, stride);
  }
  return 0;
}

#endif
