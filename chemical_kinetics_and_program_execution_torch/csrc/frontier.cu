// The weighted frontier's kernels: K19 `content_hash`, K20
// `merge_resample`, K21 `gather_pair` and K22 `frontier_step`. Plain
// PyTorch versions: `engine/frontier.py` (`content_hash_plain`,
// `merge_resample_plain`, `gather_pair_plain`, `frontier_rank_plain` and
// `frontier_write_plain`).
//
// Layout. The frontier keeps K members as two int8 tapes [K, L],
// member-major: a member's tape at the benched L = 64 is two 32-byte
// sectors. The JAX package stores transposed planes [E, K] because its
// TPU gathers along the minor axis are slow; here a parent gather is a
// copy of contiguous rows and a hash reads one row a tape.
//
// K19 replaces `engine/ensemble.py:1618 _content_hash` (an XLA fold of
// the packed cells into a uint64 FNV-1a hash; no Pallas kernel). One
// thread a member folds its columns in the reference's order: program
// tape, then data tape, column c + e*stride for c in [0, stride), then e
// in [0, L/stride) (the order of the blocked merge's plane columns,
// `:2296`; stride 1 is the natural order), then the flag (`:2494`).
// Cells are packed `per = max(1, 28/bits)` to an int32 word, the first
// of a word plus 1; each word folds as h = (h ^ word) * prime in uint64.
// Bound: bytes, 2L bytes a member read and 8 written (1.28 GB read at
// K = 10^7, L = 64: 0.41 ms at 3.35 TB/s).
//
// K20 replaces what follows the sort in `:1823 _merge_resample_sorted`,
// `:1778 _merge_resample_positions` and `:1645 _merge_stats` (XLA
// gathers, cumsums and unique scatters). The caller sorts the hashes
// (stable, the sign bit flipped so that int64 order is the reference's
// uint64 order) with their member index, a library sort as the JAX
// package's `jax.lax.sort`; K20 is one C call of a few launches. Sums
// are fixed-order scans in float64 (`k20_scan`): rows of K20_G
// consecutive elements summed in order, the row totals scanned the same
// way, recursively, and each row after the first offset by the inclusive
// total of the rows before it. No float atomics: the plain version
// repeats the order and agrees bit for bit. Bound: bytes (at K = 10^7
// each of its about 18 passes over K-element vectors moves 40-80 MB).
//
// K21 replaces `:2251 _gather_planes_pair_packed` (with `:2181
// _gather_plane_columns`, and the flagged merge's `flag[parent]`,
// `:2501`): slot s of the new tapes is row parent[s] of the old, 16
// bytes a thread where rows are 16-byte aligned. Bound: bytes, 4L bytes
// a slot (2.56 GB at K = 10^7, L = 64: 0.76 ms).
//
// K22 replaces the step of `:1899 run_weighted_frontier` (`:2019-2070`,
// with `:1991 _write_decode`; XLA rolls, gathers, `lax.top_k` and a
// scan). The rank: a block forms the shared site's columns once; a
// thread a member reads the window's 4-byte words where they lie (no
// roll), takes the cells out of registers, forms its table row and
// child_lw = lw + out_log[row] [K, M] (stored side by side); at M = 1 it
// patches the window's words in registers and stores those that change,
// and the maximum for the shift is an integer max of order-preserving
// keys. At M > 1 the top K in the order of a stable descending sort
// (the reference's `lax.top_k` keeps the lower index first among ties),
// hand-written on the rules of `beam_rule.cuh`: a radix select of the
// K*M keys (8-bit digits from the top, stopping where a pass's keys are
// one key), a compaction of the kept in index order, a stable LSD radix
// sort of the kept (key, index) pairs (warp-owned runs ranked by
// `__match_any_sync`, digit-major tile counts, their scan, the scatter;
// a digit all keys share is skipped); then a thread a slot copies its
// parent's rows in 16-byte vectors and patches the child's writes from
// wr_mask/wr_val. No library sort, no atomics on floats: the plain
// version's bits and slot order. Bound: bytes (the tapes read and
// written once, the weights).
//
// Arithmetic is IEEE (built with -fmad=false): the plain versions do the
// same operations in the same order.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define FR_THREADS 256
#define K20_G 32  // elements a row of the fixed-order scan

static inline unsigned fr_blocks(long long n) {
  return (unsigned)((n + FR_THREADS - 1) / FR_THREADS);
}

// --- K19 ----------------------------------------------------------------

__global__ void k19_kernel(const int8_t* __restrict__ p,
                           const int8_t* __restrict__ d,
                           const uint8_t* __restrict__ flag, int K, int L,
                           int stride, int bits,
                           unsigned long long* __restrict__ out) {
  const int b = blockIdx.x * FR_THREADS + threadIdx.x;
  if (b >= K) return;
  const int per = 28 / bits > 1 ? 28 / bits : 1;
  const int E = L / stride;
  const int n = 2 * L + (flag ? 1 : 0);
  const int8_t* row[2] = {p + (long long)b * L, d + (long long)b * L};
  unsigned long long h = 1469598103934665603ULL;
  uint32_t word = 0;
  for (int i = 0; i < n; ++i) {
    int v;
    if (i < 2 * L) {
      const int j = i % L;
      v = row[i / L][(j / E) + (j % E) * stride];
    } else {
      v = flag[b] ? 1 : 0;
    }
    word = (i % per == 0) ? (uint32_t)(v + 1) : ((word << bits) | (uint32_t)v);
    if (i % per == per - 1 || i == n - 1)
      h = (h ^ (unsigned long long)(long long)(int32_t)word) *
          1099511628211ULL;
  }
  out[b] = h;
}

// content_hash(p, d, flag or null, K, L, stride, bits, out [K] uint64).
extern "C" int ckpe_content_hash(const void* p, const void* d,
                                 const void* flag, int K, int L, int stride,
                                 int bits, void* out, void* stream) {
  if (K <= 0) return (int)cudaGetLastError();
  if (stride <= 0 || L % stride || bits <= 0 || bits > 28)
    return (int)cudaErrorInvalidValue;
  k19_kernel<<<fr_blocks(K), FR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)p, (const int8_t*)d, (const uint8_t*)flag, K, L, stride,
      bits, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

// --- K20 ----------------------------------------------------------------

// Row r of a scan: x[rK20_G .. ) summed in order in place, its total in
// tot[r].
template <typename T>
__global__ void k20_scan_rows(T* __restrict__ x, long long n,
                              T* __restrict__ tot) {
  const long long r = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  const long long i0 = r * K20_G;
  if (i0 >= n) return;
  const long long i1 = i0 + K20_G < n ? i0 + K20_G : n;
  T acc = x[i0];
  for (long long i = i0 + 1; i < i1; ++i) {
    acc = acc + x[i];
    x[i] = acc;
  }
  tot[r] = acc;
}

template <typename T>
__global__ void k20_add_rows(T* __restrict__ x, long long n,
                             const T* __restrict__ incl) {
  const long long i = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  if (i >= n) return;
  const long long r = i / K20_G;
  if (r > 0) x[i] = incl[r - 1] + x[i];
}

// Inclusive scan of x [n] in place in the fixed order; scratch holds at
// least n/(K20_G-1) + 64 elements.
template <typename T>
static int k20_scan(T* x, long long n, T* scratch, cudaStream_t st) {
  if (n <= 1) return 0;
  const long long rows = (n + K20_G - 1) / K20_G;
  k20_scan_rows<T><<<fr_blocks(rows), FR_THREADS, 0, st>>>(x, n, scratch);
  int rc = (int)cudaGetLastError();
  if (rc || rows == 1) return rc;
  rc = k20_scan<T>(scratch, rows, scratch + rows, st);
  if (rc) return rc;
  k20_add_rows<T><<<fr_blocks(n), FR_THREADS, 0, st>>>(x, n, scratch);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ bool k20_start(const long long* hs, long long i) {
  return i == 0 || hs[i] != hs[i - 1];
}

__device__ __forceinline__ bool k20_end(const long long* hs, long long i,
                                        long long K) {
  return i == K - 1 || hs[i] != hs[i + 1];
}

// ws[i] = lw[perm[i]]; cnt[i] = 1 where sorted position i starts a group.
__global__ void k20_prep(const long long* __restrict__ hs,
                         const long long* __restrict__ perm,
                         const double* __restrict__ lw, long long K,
                         double* __restrict__ ws, int* __restrict__ cnt) {
  const long long i = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  if (i >= K) return;
  ws[i] = lw[perm[i]];
  cnt[i] = k20_start(hs, i) ? 1 : 0;
}

// The largest finite ws, by blocks then one block: part[blockIdx.x], and
// with last, part[0] of n partials -> *m (0 when none is finite).
__global__ void k20_max(const double* __restrict__ x, long long n,
                        double* __restrict__ out, int last) {
  __shared__ double sh[FR_THREADS];
  double v = -INFINITY;
  for (long long i = (long long)blockIdx.x * FR_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * FR_THREADS)
    if (isfinite(x[i]) && x[i] > v) v = x[i];
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int w = FR_THREADS / 2; w; w >>= 1) {
    if (threadIdx.x < w && sh[threadIdx.x + w] > sh[threadIdx.x])
      sh[threadIdx.x] = sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    out[blockIdx.x] = last ? (isfinite(sh[0]) ? sh[0] : 0.0) : sh[0];
}

// e[i] = exp(ws[i] - *shift) for finite ws, else 0.
__global__ void k20_exp(const double* __restrict__ ws, long long K,
                        const double* __restrict__ shift,
                        double* __restrict__ e) {
  const long long i = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  if (i >= K) return;
  e[i] = isfinite(ws[i]) ? exp(ws[i] - *shift) : 0.0;
}

// Group g's end (the scanned mass up to its last member) and its first
// member's index; cnt is the inclusive count of starts.
__global__ void k20_groups(const long long* __restrict__ hs,
                           const long long* __restrict__ perm,
                           const int* __restrict__ cnt,
                           const double* __restrict__ ce, long long K,
                           double* __restrict__ end_ce,
                           long long* __restrict__ first) {
  const long long i = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  if (i >= K) return;
  const int g = cnt[i] - 1;
  if (k20_end(hs, i, K)) end_ce[g] = ce[i];
  if (k20_start(hs, i)) first[g] = perm[i];
}

// gsum[g] = end_ce[g] - end_ce[g-1] (end_ce[0] - 0 at g = 0) for the
// n_groups = cnt[K-1] groups, 0 past them; cum = a copy to scan.
__global__ void k20_gsum(const double* __restrict__ end_ce,
                         const int* __restrict__ cnt, long long K,
                         double* __restrict__ gsum, double* __restrict__ cum) {
  const long long g = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  if (g >= K) return;
  const double v =
      g < cnt[K - 1] ? end_ce[g] - (g ? end_ce[g - 1] : 0.0) : 0.0;
  gsum[g] = v;
  cum[g] = v;
}

__device__ __forceinline__ double k20_f(const double* cum, long long g,
                                        double total, double Kd, double u) {
  return floor(Kd * (cum[g] / total) - u);
}

// Systematic multiplicities mult[g] = f[g] - f[g-1] (f[-1] = -1), f[g] =
// floor(K * cum[g]/cum[K-1] - u) with u clipped to [1e-12, 1 - 1e-12];
// C = a copy to scan.
__global__ void k20_mult(const double* __restrict__ cum, long long K,
                         const double* __restrict__ u_ptr,
                         int* __restrict__ mult, int* __restrict__ C) {
  const long long g = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  if (g >= K) return;
  const double u = fmin(fmax(*u_ptr, 1e-12), 1.0 - 1e-12);
  const double total = cum[K - 1], Kd = (double)K;
  const double f = k20_f(cum, g, total, Kd, u);
  const double fp = g ? k20_f(cum, g - 1, total, Kd, u) : -1.0;
  const int m = (int)(f - fp);
  mult[g] = m;
  C[g] = m;
}

// The owner of slot s: the number of g < K-1 with C[g] <= s, at most K-1.
__device__ __forceinline__ long long k20_owner(const int* C, long long K,
                                               long long s) {
  long long lo = 0, hi = K - 1;  // search C[0 .. K-2]
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if ((long long)C[mid] <= s) lo = mid + 1; else hi = mid;
  }
  return lo < K - 1 ? lo : K - 1;
}

// Mode 0 (w/m weights): parent and new_lw of each slot by its group.
__global__ void k20_slots_groups(const int* __restrict__ C,
                                 const int* __restrict__ mult,
                                 const double* __restrict__ gsum,
                                 const long long* __restrict__ first,
                                 const double* __restrict__ m_ptr,
                                 long long K, long long* __restrict__ parent,
                                 double* __restrict__ new_lw) {
  const long long s = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  if (s >= K) return;
  const long long g = k20_owner(C, K, s);
  parent[s] = first[g];
  const double gs = gsum[g];
  const int mu = mult[g] > 1 ? mult[g] : 1;
  new_lw[s] = gs > 0.0 ? (*m_ptr + log(fmax(gs, 1e-300))) - log((double)mu)
                       : -INFINITY;
}

// Mode 1 (equal weights): parent by sorted position, new_lw = lse - log K.
__global__ void k20_slots_positions(const int* __restrict__ C,
                                    const long long* __restrict__ perm,
                                    const double* __restrict__ lse,
                                    double log_k, long long K,
                                    long long* __restrict__ parent,
                                    double* __restrict__ new_lw) {
  const long long s = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  if (s >= K) return;
  parent[s] = perm[k20_owner(C, K, s)];
  new_lw[s] = *lse - log_k;
}

// lse = log(total) + m, the reference's logsumexp order.
__global__ void k20_lse(const double* __restrict__ ce, long long K,
                        const double* __restrict__ m,
                        double* __restrict__ lse) {
  *lse = log(ce[K - 1]) + *m;
}

// Mode 2 (weights only): in member space, the group's merged weight at
// its first member and -inf at the others; grp = the first member.
__global__ void k20_stats(const long long* __restrict__ hs,
                          const long long* __restrict__ perm,
                          const int* __restrict__ cnt,
                          const double* __restrict__ gsum,
                          const long long* __restrict__ first,
                          const double* __restrict__ m_ptr, long long K,
                          double* __restrict__ out_lw,
                          long long* __restrict__ grp) {
  const long long i = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  if (i >= K) return;
  const int g = cnt[i] - 1;
  const double gs = gsum[g];
  const double merged =
      gs > 0.0 ? *m_ptr + log(fmax(gs, 1e-300)) : -INFINITY;
  out_lw[perm[i]] = k20_start(hs, i) ? merged : -INFINITY;
  grp[perm[i]] = first[g];
}

__global__ void k20_count(const int* __restrict__ cnt, long long K,
                          int* __restrict__ n_groups) {
  *n_groups = cnt[K - 1];
}

// merge_resample(mode, hs [K] sorted keys, perm [K] int64, lw [K] f64,
// u (device f64, modes 0-1), log_k (mode 1), K, parent [K] int64 (modes
// 0-1) or grp (mode 2), new_lw [K] f64, n_groups [1] int32, scratch:
// f64 [6K + K/16 + 128], i32 [4K + K/16 + 128], i64 [K]).
extern "C" int ckpe_merge_resample(int mode, const void* hs_, const void* perm_,
                                   const void* lw_, const void* u, double log_k,
                                   long long K, void* parent_, void* new_lw_,
                                   void* n_groups_, void* fscr, void* iscr,
                                   void* lscr, void* stream) {
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (K <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const long long* hs = (const long long*)hs_;
  const long long* perm = (const long long*)perm_;
  const double* lw = (const double*)lw_;
  double* f = (double*)fscr;
  double *ws = f, *e = f + K, *end_ce = f + 2 * K, *gsum = f + 3 * K,
         *cum = f + 4 * K, *part = f + 5 * K, *fs = f + 5 * K + 1024;
  double* m = part + 1023;  // the shift (last slot of the partials)
  double* lse = part + 1022;
  int* ii = (int*)iscr;
  int *cnt = ii, *mult = ii + K, *C = ii + 2 * K, *is = ii + 3 * K;
  long long* first = (long long*)lscr;
  const unsigned nb = fr_blocks(K);
  const unsigned mb = nb < 1000 ? nb : 1000;
  int rc;
  k20_prep<<<nb, FR_THREADS, 0, st>>>(hs, perm, lw, K, ws, cnt);
  k20_max<<<mb, FR_THREADS, 0, st>>>(ws, K, part, 0);
  k20_max<<<1, FR_THREADS, 0, st>>>(part, mb, m, 1);
  k20_exp<<<nb, FR_THREADS, 0, st>>>(ws, K, m, e);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = k20_scan<int>(cnt, K, is, st))) return rc;
  if ((rc = k20_scan<double>(e, K, fs, st))) return rc;
  k20_count<<<1, 1, 0, st>>>(cnt, K, (int*)n_groups_);
  if (mode == 1) {
    k20_lse<<<1, 1, 0, st>>>(e, K, m, lse);
    k20_exp<<<nb, FR_THREADS, 0, st>>>(ws, K, lse, cum);
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = k20_scan<double>(cum, K, fs, st))) return rc;
    k20_mult<<<nb, FR_THREADS, 0, st>>>(cum, K, (const double*)u, mult, C);
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = k20_scan<int>(C, K, is, st))) return rc;
    k20_slots_positions<<<nb, FR_THREADS, 0, st>>>(
        C, perm, lse, log_k, K, (long long*)parent_, (double*)new_lw_);
    return (int)cudaGetLastError();
  }
  k20_groups<<<nb, FR_THREADS, 0, st>>>(hs, perm, cnt, e, K, end_ce, first);
  k20_gsum<<<nb, FR_THREADS, 0, st>>>(end_ce, cnt, K, gsum, cum);
  if ((rc = (int)cudaGetLastError())) return rc;
  if (mode == 2) {
    k20_stats<<<nb, FR_THREADS, 0, st>>>(hs, perm, cnt, gsum, first, m, K,
                                         (double*)new_lw_,
                                         (long long*)parent_);
    return (int)cudaGetLastError();
  }
  if ((rc = k20_scan<double>(cum, K, fs, st))) return rc;
  k20_mult<<<nb, FR_THREADS, 0, st>>>(cum, K, (const double*)u, mult, C);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = k20_scan<int>(C, K, is, st))) return rc;
  k20_slots_groups<<<nb, FR_THREADS, 0, st>>>(C, mult, gsum, first, m, K,
                                              (long long*)parent_,
                                              (double*)new_lw_);
  return (int)cudaGetLastError();
}

// --- K21 ----------------------------------------------------------------

template <typename T>
__global__ void k21_kernel(const T* __restrict__ p, const T* __restrict__ d,
                           T* __restrict__ op, T* __restrict__ od,
                           const long long* __restrict__ parent, long long K,
                           int w, const uint8_t* __restrict__ flag,
                           uint8_t* __restrict__ oflag) {
  const long long t = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  if (t >= 2 * K * w) return;
  const int tape = t >= K * w;
  const long long r = tape ? t - K * w : t;
  const long long s = r / w;
  const int j = (int)(r - s * w);
  const long long src = parent[s] * w + j;
  if (tape) od[s * w + j] = d[src]; else op[s * w + j] = p[src];
  if (flag && !tape && j == 0) oflag[s] = flag[parent[s]];
}

// gather_pair(p, d, parent [K] int64, K, L, out_p, out_d, flag or null,
// out_flag): rows of both tapes, 16 bytes a thread when aligned.
extern "C" int ckpe_gather_pair(const void* p, const void* d,
                                const void* parent, long long K, int L,
                                void* op, void* od, const void* flag,
                                void* oflag, void* stream) {
  if (K <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = L % 16 == 0 &&
                    ((uintptr_t)p | (uintptr_t)d | (uintptr_t)op |
                     (uintptr_t)od) % 16 == 0;
  if (wide) {
    const int w = L / 16;
    k21_kernel<int4><<<fr_blocks(2 * K * w), FR_THREADS, 0, st>>>(
        (const int4*)p, (const int4*)d, (int4*)op, (int4*)od,
        (const long long*)parent, K, w, (const uint8_t*)flag,
        (uint8_t*)oflag);
  } else {
    k21_kernel<int8_t><<<fr_blocks(2 * K * L), FR_THREADS, 0, st>>>(
        (const int8_t*)p, (const int8_t*)d, (int8_t*)op, (int8_t*)od,
        (const long long*)parent, K, L, (const uint8_t*)flag,
        (uint8_t*)oflag);
  }
  return (int)cudaGetLastError();
}

// --- K22 ----------------------------------------------------------------

#include "beam_rule.cuh"

#define K22_MAX_CELLS 32
#define K22_MAX_WORDS 20  // distinct 4-byte words of a window, both tapes
#define K22_ROUNDS (K22_TILE / FR_THREADS)
#define K22_WARPS (FR_THREADS / 32)

struct K22Table {
  int p_lo, n_p, d_lo, n_d, rows, M;
  const int* pv;            // [n_cells]
  const double* out_log;    // [rows, M]
  const int* out_world;     // [rows, M]
  const uint8_t* wr_mask;   // [W, n_cells] bool
  const int* wr_val;        // [W, n_cells]
};

// The shared site's window, one copy a block: cell c's column, and where
// rows are read as 4-byte words, the slot of its word among the distinct
// words the window touches (both tapes) and its byte's shift.
struct K22Win {
  int nc, nw;
  int col[K22_MAX_CELLS], slot[K22_MAX_CELLS], shift[K22_MAX_CELLS];
  int wtape[K22_MAX_WORDS], widx[K22_MAX_WORDS];
};

// One thread: the columns (site + lo + j) mod L once a block, with no
// 64-bit remainder a member; ``words`` 0 leaves the rows to byte loads.
__device__ void k22_window(K22Win& w, const K22Table& t, int site, int L,
                           bool words) {
  w.nc = t.n_p + t.n_d;
  w.nw = 0;
  for (int c = 0; c < w.nc; ++c) {
    const bool is_p = c < t.n_p;
    int col = (site + (is_p ? t.p_lo + c : t.d_lo + c - t.n_p)) % L;
    if (col < 0) col += L;
    w.col[c] = col;
    if (!words) continue;
    const int tape = is_p ? 0 : 1, idx = col >> 2;
    int q = 0;
    while (q < w.nw && !(w.wtape[q] == tape && w.widx[q] == idx)) ++q;
    if (q == w.nw) {
      if (q == K22_MAX_WORDS) {  // wider than the register slots: bytes
        w.nw = -1;
        break;
      }
      w.wtape[q] = tape;
      w.widx[q] = idx;
      ++w.nw;
    }
    w.slot[c] = q;
    w.shift[c] = (col & 3) * 8;
  }
  if (w.nw < 0) w.nw = 0;
}

__device__ __forceinline__ uint32_t k22_pick(
    const uint32_t (&wv)[K22_MAX_WORDS], int s) {
  uint32_t r = 0;
#pragma unroll
  for (int q = 0; q < K22_MAX_WORDS; ++q) r = q == s ? wv[q] : r;
  return r;
}

// The reference's index rule on the int32 radix sum (wrapping).
__device__ __forceinline__ int k22_row_of(uint32_t acc, int rows) {
  int r = (int)acc;
  if (r < 0) r += rows;
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// The select's and the sort's control block (its head zeroed by each
// select, the maximum by each M = 1 rank).
struct K22Ctl {
  unsigned hist[K22_PASSES][K22_BINS];
  unsigned ticket[K22_PASSES];
  K22Sel sel[K22_PASSES + 1];
  // The largest key, and the complement of the least, that took part in
  // each pass (0 where none did).
  unsigned long long cmax[K22_PASSES], cnmin[K22_PASSES];
  unsigned long long maxkey;   // M = 1: the largest child's ascending key
  unsigned long long all_and;  // AND and OR of the kept keys
  unsigned long long all_or;
};

// The workspace of a step at K members and M outcomes, in 256-byte
// aligned pieces.
struct K22Ws {
  K22Ctl* ctl;
  unsigned* tile_cnt;  // [2, tiles of K*M]: keys below, equal
  unsigned* tile_off;  // their exclusive scans
  unsigned long long* key[2];  // the kept keys, ping-pong [K]
  int* idx[2];                 // their flat child indices
  unsigned* lsd_cnt;           // [256, tiles of K]
  unsigned* lsd_tot;           // [256] each digit's count
  long long bytes;
};

static inline long long k22_round(long long b) { return (b + 255) / 256 * 256; }

static K22Ws k22_ws(void* base, long long K, int M) {
  K22Ws w;
  const long long tn = (K * M + K22_TILE - 1) / K22_TILE;
  const long long tk = (K + K22_TILE - 1) / K22_TILE;
  char* p = (char*)base;
  long long off = 0;
  w.ctl = (K22Ctl*)(p + off);
  off += k22_round(sizeof(K22Ctl));
  w.tile_cnt = (unsigned*)(p + off);
  off += k22_round(8 * tn);
  w.tile_off = (unsigned*)(p + off);
  off += k22_round(8 * tn);
  for (int q = 0; q < 2; ++q) {
    w.key[q] = (unsigned long long*)(p + off);
    off += k22_round(8 * K);
  }
  for (int q = 0; q < 2; ++q) {
    w.idx[q] = (int*)(p + off);
    off += k22_round(4 * K);
  }
  w.lsd_cnt = (unsigned*)(p + off);
  off += k22_round(4LL * K22_BINS * tk);
  w.lsd_tot = (unsigned*)(p + off);
  off += k22_round(4LL * K22_BINS);
  w.bytes = off;
  return w;
}

// Exclusive scan of one value a thread over a block of FR_THREADS; the
// block's total to ``total``. ``sh`` holds K22_WARPS + 1 values.
__device__ __forceinline__ unsigned k22_block_scan(unsigned v, unsigned* sh,
                                                   unsigned& total) {
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= (unsigned)o) incl += y;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned run = 0;
    for (int q = 0; q < K22_WARPS; ++q) {
      const unsigned c = sh[q];
      sh[q] = run;
      run += c;
    }
    sh[K22_WARPS] = run;
  }
  __syncthreads();
  const unsigned out = sh[warp] + incl - v;
  total = sh[K22_WARPS];
  __syncthreads();
  return out;
}

// The select's pass 0 state: nothing resolved, K to take.
__device__ __forceinline__ K22Sel k22_sel0(unsigned K) {
  K22Sel s;
  s.prefix = 0;
  s.need = K;
  s.done = 0;
  s.resolved = 0;
  s.pad = 0;
  return s;
}

// A key's part in a pass's histogram: warp aggregated into the block's
// bins ``h`` (dg K22_BINS takes no part).
__device__ __forceinline__ void k22_count_digit(unsigned dg, unsigned* h) {
  const unsigned peers = __match_any_sync(0xffffffffu, dg);
  if (dg < K22_BINS && (threadIdx.x & 31) == (unsigned)(__ffs(peers) - 1))
    atomicAdd(&h[dg], (unsigned)__popc(peers));
}

// The end of a select pass, by every block: its bins ``h`` added to
// ctl->hist[pass]; the last block to arrive finds the bucket that holds
// the need-th key (a warp's scan of the 256 bins, lane l holding bins 8l
// .. 8l + 7, as `k22_select_step` walks them) into ctl->sel[pass + 1],
// or stops the select where the pass's keys were one key
// (`k22_select_single`).
__device__ void k22_finish_pass(K22Ctl* ctl, unsigned pass, const K22Sel& s,
                                unsigned* h) {
  __shared__ bool last;
  __syncthreads();
  if (h[threadIdx.x]) atomicAdd(&ctl->hist[pass][threadIdx.x], h[threadIdx.x]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&ctl->ticket[pass], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  h[threadIdx.x] = __ldcg(&ctl->hist[pass][threadIdx.x]);
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const unsigned lane = threadIdx.x;
  unsigned sum = 0;
  for (int q = 0; q < 8; ++q) sum += h[8 * lane + q];
  unsigned incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= (unsigned)o) incl += y;
  }
  const unsigned hit = __ballot_sync(0xffffffffu, incl >= s.need);
  const unsigned first = hit ? (unsigned)(__ffs(hit) - 1) : 31u;
  const unsigned long long top = __ldcg(&ctl->cmax[pass]);
  if (top == ~__ldcg(&ctl->cnmin[pass])) {  // the pass's keys are one key
    if (lane == 0) ctl->sel[pass + 1] = k22_select_single(s, top);
    return;
  }
  if (lane == first) {
    unsigned below = incl - sum, b = 8 * lane;
    while (b < 8 * lane + 7 && below + h[b] < s.need) below += h[b++];
    K22Sel t = s;
    t.prefix = s.prefix | ((unsigned long long)b << (56 - 8 * pass));
    t.need = s.need - below;
    t.resolved = pass + 1;
    t.done = (h[b] == t.need || pass == K22_PASSES - 1) ? 1u : 0u;
    ctl->sel[pass + 1] = t;
  }
}

// Rank: a thread a member reads the window's words (or bytes), forms its
// table row and child[b, m] = lw[b] + out_log[row, m] (stored side by
// side, so a warp's stores are contiguous). At M = 1 it patches the
// window's words in registers and stores those that change, and the
// block's largest child goes to ctl->maxkey.
__global__ void __launch_bounds__(FR_THREADS)
k22_rank_kernel(int8_t* __restrict__ p, int8_t* __restrict__ d,
                const double* __restrict__ lw,
                const int* __restrict__ site_ptr, int K, int L, K22Table t,
                int words, int* __restrict__ rows,
                double* __restrict__ child, K22Ctl* __restrict__ ctl) {
  __shared__ K22Win w;
  __shared__ unsigned long long best[K22_WARPS];
  if (threadIdx.x == 0) k22_window(w, t, *site_ptr, L, words != 0);
  __syncthreads();
  const long long b = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  unsigned long long top = 0;
  if (b < K) {
    int8_t* prow = p + b * L;
    int8_t* drow = d + b * L;
    uint32_t wv[K22_MAX_WORDS];
#pragma unroll
    for (int q = 0; q < K22_MAX_WORDS; ++q)
      wv[q] = q < w.nw ? *reinterpret_cast<const uint32_t*>(
                             (w.wtape[q] ? drow : prow) + 4 * w.widx[q])
                       : 0u;
    uint32_t acc = 0;
    for (int c = 0; c < w.nc; ++c) {
      const int cell =
          w.nw ? (int)(int8_t)(k22_pick(wv, w.slot[c]) >> w.shift[c])
               : (int)(c < t.n_p ? prow : drow)[w.col[c]];
      acc += (uint32_t)cell * (uint32_t)t.pv[c];
    }
    const int r = k22_row_of(acc, t.rows);
    rows[b] = r;
    const double base = lw[b];
    for (int m = 0; m < t.M; ++m)
      child[b * t.M + m] = base + t.out_log[(long long)r * t.M + m];
    if (t.M == 1) {
      top = k22_asc_key(child[b]);
      const int spec = t.out_world[r];
      const uint8_t* mk = t.wr_mask + (long long)spec * w.nc;
      const int* val = t.wr_val + (long long)spec * w.nc;
      if (w.nw) {
#pragma unroll
        for (int q = 0; q < K22_MAX_WORDS; ++q) {
          if (q >= w.nw) continue;
          uint32_t nv = wv[q];
          for (int c = 0; c < w.nc; ++c)
            if (w.slot[c] == q && mk[c])
              nv = (nv & ~(0xffu << w.shift[c])) |
                   ((uint32_t)(uint8_t)(int8_t)val[c] << w.shift[c]);
          if (nv != wv[q])
            *reinterpret_cast<uint32_t*>((w.wtape[q] ? drow : prow) +
                                         4 * w.widx[q]) = nv;
        }
      } else {
        for (int c = 0; c < w.nc; ++c)
          if (mk[c]) (c < t.n_p ? prow : drow)[w.col[c]] = (int8_t)val[c];
      }
    }
  }
  if (t.M > 1) return;
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_down_sync(0xffffffffu, top, o);
    top = y > top ? y : top;
  }
  if ((threadIdx.x & 31) == 0) best[threadIdx.x >> 5] = top;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < K22_WARPS; ++q) top = best[q] > top ? best[q] : top;
    atomicMax(&ctl->maxkey, top);
  }
}

// M = 1: new_lw = child - its maximum (`torch.max`'s: NaN if any is).
__global__ void k22_shift_kernel(const double* __restrict__ child, int K,
                                 const K22Ctl* __restrict__ ctl,
                                 double* __restrict__ new_lw) {
  const long long b = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
  if (b < K) new_lw[b] = child[b] - k22_asc_value(ctl->maxkey);
}

// One pass of the radix select over the N = K*M children: a histogram of
// digit ``pass`` of the keys that match the resolved digits and their
// least and largest, then `k22_finish_pass`. (Passing the matching keys on to the next pass, and
// pass 0 inside the rank's launch, measured slower on the H100: PERF.md.)
__global__ void __launch_bounds__(FR_THREADS)
k22_select_pass(const double* __restrict__ child, long long N, unsigned K,
                unsigned pass, K22Ctl* __restrict__ ctl) {
  __shared__ unsigned h[K22_BINS];
  const K22Sel s = pass == 0 ? k22_sel0(K) : ctl->sel[pass];
  if (s.done) {
    if (blockIdx.x == 0 && threadIdx.x == 0) ctl->sel[pass + 1] = s;
    return;
  }
  __shared__ unsigned long long rmax[K22_WARPS], rnmin[K22_WARPS];
  h[threadIdx.x] = 0;
  __syncthreads();
  unsigned long long top = 0, nlow = 0;  // largest key, ~least key
  const long long stride = (long long)gridDim.x * FR_THREADS;
  for (long long i0 = (long long)blockIdx.x * FR_THREADS; i0 < N;
       i0 += stride) {
    const long long i = i0 + threadIdx.x;
    unsigned dg = K22_BINS;
    if (i < N) {
      const uint64_t key = k22_desc_key(child[i]);
      if (k22_in_pass(key, s, pass)) {
        dg = k22_digit(key, pass);
        top = key > top ? key : top;
        nlow = ~key > nlow ? ~key : nlow;
      }
    }
    k22_count_digit(dg, h);
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long a = __shfl_down_sync(0xffffffffu, top, o);
    const unsigned long long b = __shfl_down_sync(0xffffffffu, nlow, o);
    top = a > top ? a : top;
    nlow = b > nlow ? b : nlow;
  }
  if ((threadIdx.x & 31) == 0) {
    rmax[threadIdx.x >> 5] = top;
    rnmin[threadIdx.x >> 5] = nlow;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < K22_WARPS; ++q) {
      top = rmax[q] > top ? rmax[q] : top;
      nlow = rnmin[q] > nlow ? rnmin[q] : nlow;
    }
    if (top) atomicMax(&ctl->cmax[pass], top);
    if (nlow) atomicMax(&ctl->cnmin[pass], nlow);
  }
  k22_finish_pass(ctl, pass, s, h);
}

// Tiles of K22_TILE keys, a block each: warp w owns keys [w * 512, (w +
// 1) * 512) of its tile, read in K22_ROUNDS rounds of 32 (coalesced),
// so a warp ranks its own run with no block barrier and the warps are
// joined once.
#define K22_RUN (K22_TILE / K22_WARPS)

__device__ __forceinline__ long long k22_at(long long tile, int r) {
  return tile * K22_TILE + (threadIdx.x >> 5) * K22_RUN + r * 32 +
         (threadIdx.x & 31);
}

// Compaction, first launch: each tile's counts of keys below and equal.
__global__ void __launch_bounds__(FR_THREADS)
k22_count_kernel(const double* __restrict__ child, long long N,
                 const K22Ctl* __restrict__ ctl, unsigned* __restrict__ cnt) {
  __shared__ unsigned wl[K22_WARPS], we[K22_WARPS];
  const K22Sel s = ctl->sel[K22_PASSES];
  unsigned lt = 0, eq = 0;
#pragma unroll 4
  for (int r = 0; r < K22_ROUNDS; ++r) {
    const long long i = k22_at(blockIdx.x, r);
    const int cls = i < N ? k22_kept_class(k22_desc_key(child[i]), s) : 0;
    lt += __popc(__ballot_sync(0xffffffffu, cls == 1));
    eq += __popc(__ballot_sync(0xffffffffu, cls == 2));
  }
  if ((threadIdx.x & 31) == 0) {
    wl[threadIdx.x >> 5] = lt;
    we[threadIdx.x >> 5] = eq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    lt = eq = 0;
    for (int q = 0; q < K22_WARPS; ++q) {
      lt += wl[q];
      eq += we[q];
    }
    cnt[2 * blockIdx.x] = lt;
    cnt[2 * blockIdx.x + 1] = eq;
  }
}

// One block: the exclusive scan of the tiles' (below, equal) counts, a
// chunk of FR_THREADS tiles at a time; the kept keys' AND and OR set to
// their starting values.
__global__ void __launch_bounds__(FR_THREADS)
k22_scan_kernel(const unsigned* __restrict__ in, long long n,
                unsigned* __restrict__ out, K22Ctl* __restrict__ ctl) {
  __shared__ unsigned sh[K22_WARPS + 1];
  unsigned run0 = 0, run1 = 0;
  for (long long c = 0; c < n; c += FR_THREADS) {
    const long long i = c + threadIdx.x;
    const unsigned v0 = i < n ? in[2 * i] : 0, v1 = i < n ? in[2 * i + 1] : 0;
    unsigned t0, t1;
    const unsigned e0 = k22_block_scan(v0, sh, t0);
    const unsigned e1 = k22_block_scan(v1, sh, t1);
    if (i < n) {
      out[2 * i] = run0 + e0;
      out[2 * i + 1] = run1 + e1;
    }
    run0 += t0;
    run1 += t1;
  }
  if (threadIdx.x == 0) {
    ctl->all_and = ~0ULL;
    ctl->all_or = 0ULL;
  }
}

// Compaction, last launch: the K kept (key, flat index) in index order,
// a key below the prefix always, one equal to it while fewer than need
// equal ones precede it; the kept keys' AND and OR.
__global__ void __launch_bounds__(FR_THREADS)
k22_compact_kernel(const double* __restrict__ child, long long N,
                   K22Ctl* __restrict__ ctl, const unsigned* __restrict__ off,
                   unsigned long long* __restrict__ okey,
                   int* __restrict__ oidx) {
  __shared__ unsigned wl[K22_WARPS], we[K22_WARPS];
  __shared__ unsigned long long ra[K22_WARPS], ro[K22_WARPS];
  const K22Sel s = ctl->sel[K22_PASSES];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1;
  uint64_t key[K22_ROUNDS];
  unsigned bl[K22_ROUNDS], be[K22_ROUNDS];
  unsigned lt = 0, eq = 0;
#pragma unroll
  for (int r = 0; r < K22_ROUNDS; ++r) {
    const long long i = k22_at(blockIdx.x, r);
    key[r] = i < N ? k22_desc_key(child[i]) : 0;
    const int cls = i < N ? k22_kept_class(key[r], s) : 0;
    bl[r] = __ballot_sync(0xffffffffu, cls == 1);
    be[r] = __ballot_sync(0xffffffffu, cls == 2);
    lt += __popc(bl[r]);
    eq += __popc(be[r]);
  }
  if (lane == 0) {
    wl[warp] = lt;
    we[warp] = eq;
  }
  __syncthreads();
  lt = off[2 * blockIdx.x];
  eq = off[2 * blockIdx.x + 1];
  for (unsigned q = 0; q < warp; ++q) {
    lt += wl[q];
    eq += we[q];
  }
  unsigned long long all_and = ~0ULL, all_or = 0ULL;
#pragma unroll
  for (int r = 0; r < K22_ROUNDS; ++r) {
    const unsigned lt_before = lt + __popc(bl[r] & lt_mask);
    const unsigned eq_before = eq + __popc(be[r] & lt_mask);
    const bool is_lt = (bl[r] >> lane) & 1u, is_eq = (be[r] >> lane) & 1u;
    if (is_lt || (is_eq && eq_before < s.need)) {
      const unsigned pos =
          lt_before + (eq_before < s.need ? eq_before : s.need);
      okey[pos] = key[r];
      oidx[pos] = (int)k22_at(blockIdx.x, r);
      all_and &= key[r];
      all_or |= key[r];
    }
    lt += __popc(bl[r]);
    eq += __popc(be[r]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    all_and &= __shfl_down_sync(0xffffffffu, all_and, o);
    all_or |= __shfl_down_sync(0xffffffffu, all_or, o);
  }
  if (lane == 0) {
    ra[warp] = all_and;
    ro[warp] = all_or;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < K22_WARPS; ++q) {
      all_and &= ra[q];
      all_or |= ro[q];
    }
    atomicAnd(&ctl->all_and, all_and);
    atomicOr(&ctl->all_or, all_or);
  }
}

// A warp's stable ranks of its run's digits (dg K22_BINS where a key is
// past the end): each key's place among its warp's keys of the same
// digit, and the warp's count of each digit in ``wh``.
__device__ __forceinline__ void k22_warp_ranks(const unsigned (&dg)[K22_ROUNDS],
                                               unsigned (&rank)[K22_ROUNDS],
                                               unsigned* wh) {
  const unsigned lane = threadIdx.x & 31;
  for (int q = lane; q < K22_BINS; q += 32) wh[q] = 0;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < K22_ROUNDS; ++r) {
    const unsigned peers = __match_any_sync(0xffffffffu, dg[r]);
    const unsigned base = dg[r] < K22_BINS ? wh[dg[r]] : 0;
    __syncwarp();
    if (dg[r] < K22_BINS && lane == (unsigned)(__ffs(peers) - 1))
      wh[dg[r]] = base + __popc(peers);
    __syncwarp();
    rank[r] = base + __popc(peers & ((1u << lane) - 1));
  }
}

// LSD pass ``pass``, first launch: each tile's count of each digit
// (digit-major, [256, tiles]); nothing where the digit is constant.
__global__ void __launch_bounds__(FR_THREADS)
k22_lsd_hist(const K22Ctl* __restrict__ ctl, K22Ws w, int K, unsigned pass) {
  if (!k22_varying(ctl->all_and, ctl->all_or, pass)) return;
  __shared__ unsigned wh[K22_WARPS][K22_BINS];
  const unsigned long long* key =
      w.key[k22_parity(ctl->all_and, ctl->all_or, pass)];
  unsigned dg[K22_ROUNDS], rank[K22_ROUNDS];
#pragma unroll
  for (int r = 0; r < K22_ROUNDS; ++r) {
    const long long i = k22_at(blockIdx.x, r);
    dg[r] = i < K ? k22_lsd_digit(key[i], pass) : K22_BINS;
  }
  k22_warp_ranks(dg, rank, wh[threadIdx.x >> 5]);
  __syncthreads();
  unsigned c = 0;
  for (int q = 0; q < K22_WARPS; ++q) c += wh[q][threadIdx.x];
  w.lsd_cnt[(long long)threadIdx.x * gridDim.x + blockIdx.x] = c;
}

// LSD pass ``pass``: block d scans digit d's counts over the tiles (in
// place, exclusive) and writes the digit's total.
__global__ void __launch_bounds__(FR_THREADS)
k22_lsd_scan(const K22Ctl* __restrict__ ctl, K22Ws w, long long tiles,
             unsigned pass) {
  if (!k22_varying(ctl->all_and, ctl->all_or, pass)) return;
  __shared__ unsigned sh[K22_WARPS + 1];
  unsigned* row = w.lsd_cnt + blockIdx.x * tiles;
  unsigned run = 0;
  for (long long c = 0; c < tiles; c += FR_THREADS) {
    const long long i = c + threadIdx.x;
    const unsigned v = i < tiles ? row[i] : 0;
    unsigned total;
    const unsigned e = k22_block_scan(v, sh, total);
    if (i < tiles) row[i] = run + e;
    run += total;
  }
  if (threadIdx.x == 0) w.lsd_tot[blockIdx.x] = run;
}

// LSD pass ``pass``, the stable scatter: a key's place is its digit's
// start (the totals of the digits below it), the same digit's keys in
// earlier tiles, in earlier warps of its tile, and its rank in its warp.
__global__ void __launch_bounds__(FR_THREADS)
k22_lsd_scatter(const K22Ctl* __restrict__ ctl, K22Ws w, int K,
                unsigned pass) {
  if (!k22_varying(ctl->all_and, ctl->all_or, pass)) return;
  __shared__ unsigned wh[K22_WARPS][K22_BINS];
  __shared__ unsigned sh[K22_WARPS + 1];
  const unsigned par = k22_parity(ctl->all_and, ctl->all_or, pass);
  const unsigned long long* skey = w.key[par];
  const int* sidx = w.idx[par];
  unsigned long long* dkey = w.key[par ^ 1];
  int* didx = w.idx[par ^ 1];
  unsigned long long key[K22_ROUNDS];
  unsigned dg[K22_ROUNDS], rank[K22_ROUNDS];
#pragma unroll
  for (int r = 0; r < K22_ROUNDS; ++r) {
    const long long i = k22_at(blockIdx.x, r);
    key[r] = i < K ? skey[i] : 0;
    dg[r] = i < K ? k22_lsd_digit(key[r], pass) : K22_BINS;
  }
  const unsigned warp = threadIdx.x >> 5;
  k22_warp_ranks(dg, rank, wh[warp]);
  unsigned total;
  const unsigned start = k22_block_scan(w.lsd_tot[threadIdx.x], sh, total);
  unsigned run = start + w.lsd_cnt[(long long)threadIdx.x * gridDim.x +
                                   blockIdx.x];
  for (int q = 0; q < K22_WARPS; ++q) {
    const unsigned c = wh[q][threadIdx.x];
    wh[q][threadIdx.x] = run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < K22_ROUNDS; ++r) {
    if (dg[r] >= K22_BINS) continue;
    const unsigned pos = wh[warp][dg[r]] + rank[r];
    dkey[pos] = key[r];
    didx[pos] = sidx[k22_at(blockIdx.x, r)];
  }
}

// Byte ``at`` of a vector set to v.
__device__ __forceinline__ void k22_set_byte(int8_t& x, int, int8_t v) {
  x = v;
}

__device__ __forceinline__ void k22_set_byte(int4& x, int at, int8_t v) {
  const int sh = (at & 3) * 8;
  const uint32_t m = ~(0xffu << sh), b = (uint32_t)(uint8_t)v << sh;
  const int q = at >> 2;
  if (q == 0) x.x = (int)(((uint32_t)x.x & m) | b);
  if (q == 1) x.y = (int)(((uint32_t)x.y & m) | b);
  if (q == 2) x.z = (int)(((uint32_t)x.z & m) | b);
  if (q == 3) x.w = (int)(((uint32_t)x.w & m) | b);
}

// The window's writes of outcome ``spec`` into vector h of a tape's row
// (cells c0 .. c1 - 1 of the window).
template <class V>
__device__ __forceinline__ void k22_patch(V& v, unsigned h, int c0, int c1,
                                          int spec, const K22Win& w,
                                          const K22Table& t) {
  for (int c = c0; c < c1; ++c) {
    const int k = spec * w.nc + c;
    if ((unsigned)w.col[c] / (unsigned)sizeof(V) == h && t.wr_mask[k])
      k22_set_byte(v, w.col[c] % (int)sizeof(V), (int8_t)t.wr_val[k]);
  }
}

// Write: a thread a slot. Slot s takes the kept child idx[s] (parent idx
// / M, outcome idx % M): each tape's row of the parent copied a vector V
// at a time, the child's writes patched from wr_mask/wr_val into the
// vectors that hold the window, and new_lw[s] = child[idx[s]] -
// child[idx[0]]. (Holding a row's vectors in registers, their loads
// issued before the outcome's lookups, measured no faster: PERF.md.)
template <class V>
__global__ void __launch_bounds__(FR_THREADS)
k22_write_kernel(const int8_t* __restrict__ p, const int8_t* __restrict__ d,
                 int8_t* __restrict__ op, int8_t* __restrict__ od,
                 const int* __restrict__ rows, const K22Ctl* __restrict__ ctl,
                 K22Ws ws, const double* __restrict__ child,
                 const int* __restrict__ site_ptr, int K, int L, K22Table t,
                 double* __restrict__ new_lw) {
  __shared__ K22Win w;
  const int* kidx = ws.idx[k22_parity(ctl->all_and, ctl->all_or, K22_PASSES)];
  if (threadIdx.x == 0) k22_window(w, t, *site_ptr, L, false);
  __syncthreads();
  const unsigned s = blockIdx.x * FR_THREADS + threadIdx.x;
  if (s >= (unsigned)K) return;
  const unsigned nv = (unsigned)L / (unsigned)sizeof(V);
  const int ci = kidx[s];
  const int par = ci / t.M, m = ci - par * t.M;
  const int spec = t.out_world[rows[par] * t.M + m];
  for (int tape = 0; tape < 2; ++tape) {
    const V* src = reinterpret_cast<const V*>(tape ? d : p) + (size_t)par * nv;
    V* dst = reinterpret_cast<V*>(tape ? od : op) + (size_t)s * nv;
    const int c0 = tape ? t.n_p : 0, c1 = tape ? w.nc : t.n_p;
    for (unsigned h = 0; h < nv; ++h) {
      V v = src[h];
      for (int c = c0; c < c1; ++c) {
        const int k = spec * w.nc + c;
        if ((unsigned)w.col[c] / (unsigned)sizeof(V) == h && t.wr_mask[k])
          k22_set_byte(v, w.col[c] % (int)sizeof(V), (int8_t)t.wr_val[k]);
      }
      dst[h] = v;
    }
  }
  new_lw[s] = child[ci] - child[kidx[0]];
}

static inline K22Table k22_table(int p_lo, int n_p, int d_lo, int n_d,
                                 int rows, int M, const void* pv,
                                 const void* out_log, const void* out_world,
                                 const void* wr_mask, const void* wr_val) {
  K22Table t;
  t.p_lo = p_lo; t.n_p = n_p; t.d_lo = d_lo; t.n_d = n_d;
  t.rows = rows; t.M = M;
  t.pv = (const int*)pv;
  t.out_log = (const double*)out_log;
  t.out_world = (const int*)out_world;
  t.wr_mask = (const uint8_t*)wr_mask;
  t.wr_val = (const int*)wr_val;
  return t;
}

static inline unsigned k22_tiles(long long n) {
  return (unsigned)((n + K22_TILE - 1) / K22_TILE);
}

// Bytes of a step's workspace at K members and M outcomes.
extern "C" long long ckpe_k22_workspace_bytes(long long K, int M) {
  return k22_ws(nullptr, K, M).bytes;
}

#define K22_TABLE_ARGS                                                  \
  int p_lo, int n_p, int d_lo, int n_d, int rows, int M, const void* pv, \
      const void* out_log, const void* out_world, const void* wr_mask,   \
      const void* wr_val
#define K22_TABLE \
  k22_table(p_lo, n_p, d_lo, n_d, rows, M, pv, out_log, out_world, wr_mask, wr_val)

// K22's first C call: the rank (rows, child [K, M]); at M = 1, after the
// maximum's slot is zeroed, the window written in place and new_lw =
// child - max (a second launch).
extern "C" int ckpe_k22_rank(void* p, void* d, const void* lw,
                             const void* site, int K, int L, K22_TABLE_ARGS,
                             void* rows_out, void* child, void* ws,
                             void* new_lw, void* stream) {
  if (n_p + n_d > K22_MAX_CELLS || M < 1 || L <= 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const K22Table t = K22_TABLE;
  K22Ws w = k22_ws(ws, K, M);
  cudaError_t err = cudaSuccess;
  if (M == 1) {  // the maximum's slot zeroed
    err = cudaMemsetAsync(&w.ctl->maxkey, 0, sizeof(w.ctl->maxkey), st);
    if (err != cudaSuccess) return (int)err;
  }
  const int words = L % 4 == 0 && ((uintptr_t)p | (uintptr_t)d) % 4 == 0;
  k22_rank_kernel<<<fr_blocks(K), FR_THREADS, 0, st>>>(
      (int8_t*)p, (int8_t*)d, (const double*)lw, (const int*)site, K, L, t,
      words, (int*)rows_out, (double*)child, w.ctl);
  err = cudaGetLastError();
  if (err != cudaSuccess || M > 1) return (int)err;
  k22_shift_kernel<<<fr_blocks(K), FR_THREADS, 0, st>>>(
      (const double*)child, K, w.ctl, (double*)new_lw);
  return (int)cudaGetLastError();
}

// The select (M > 1): the control block's head zeroed, eight passes of
// the radix select, then the compaction's count, scan and compact
// launches: the K kept (key, flat index) in index order in the
// workspace's first buffer.
static int k22_select(const void* child, int K, int M, K22Ws w,
                      cudaStream_t st) {
  const long long N = (long long)K * M;
  if (N >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(w.ctl, 0, offsetof(K22Ctl, maxkey), st);
  if (err != cudaSuccess) return (int)err;
  const long long want = (N + 16LL * FR_THREADS - 1) / (16LL * FR_THREADS);
  const unsigned blocks = (unsigned)(want > 528 ? 528 : want);
  for (unsigned pass = 0; pass < K22_PASSES; ++pass)
    k22_select_pass<<<blocks, FR_THREADS, 0, st>>>(
        (const double*)child, N, (unsigned)K, pass, w.ctl);
  const unsigned tn = k22_tiles(N);
  k22_count_kernel<<<tn, FR_THREADS, 0, st>>>((const double*)child, N,
                                               w.ctl, w.tile_cnt);
  k22_scan_kernel<<<1, FR_THREADS, 0, st>>>(w.tile_cnt, tn, w.tile_off,
                                             w.ctl);
  k22_compact_kernel<<<tn, FR_THREADS, 0, st>>>(
      (const double*)child, N, w.ctl, w.tile_off, w.key[0], w.idx[0]);
  return (int)cudaGetLastError();
}

// The order: the LSD radix sort of the K kept pairs, eight passes of
// three launches, each launch returning at once where its digit is
// constant over the kept keys.
static int k22_order(int K, K22Ws w, cudaStream_t st) {
  const unsigned tk = k22_tiles(K);
  for (unsigned pass = 0; pass < K22_PASSES; ++pass) {
    k22_lsd_hist<<<tk, FR_THREADS, 0, st>>>(w.ctl, w, K, pass);
    k22_lsd_scan<<<K22_BINS, FR_THREADS, 0, st>>>(w.ctl, w, tk, pass);
    k22_lsd_scatter<<<tk, FR_THREADS, 0, st>>>(w.ctl, w, K, pass);
  }
  return (int)cudaGetLastError();
}

// The write (M > 1): the new tapes from the ordered slots, 16-byte
// vectors where rows and tapes are 16-byte aligned (else bytes), and
// new_lw.
static int k22_write(const void* p, const void* d, void* op, void* od,
                     const void* rows_in, const void* child, const void* site,
                     int K, int L, const K22Table& t, K22Ws w, void* new_lw,
                     cudaStream_t st) {
  const bool wide = L % 16 == 0 &&
                    ((uintptr_t)p | (uintptr_t)d | (uintptr_t)op |
                     (uintptr_t)od) % 16 == 0;
  const int8_t *cp = (const int8_t*)p, *cd = (const int8_t*)d;
  int8_t *wp = (int8_t*)op, *wd = (int8_t*)od;
  const int* rw = (const int*)rows_in;
  const double* ch = (const double*)child;
  const int* sp = (const int*)site;
  double* nl = (double*)new_lw;
  if (wide)
    k22_write_kernel<int4><<<fr_blocks(K), FR_THREADS, 0, st>>>(
        cp, cd, wp, wd, rw, w.ctl, w, ch, sp, K, L, t, nl);
  else
    k22_write_kernel<int8_t><<<fr_blocks(K), FR_THREADS, 0, st>>>(
        cp, cd, wp, wd, rw, w.ctl, w, ch, sp, K, L, t, nl);
  return (int)cudaGetLastError();
}

// K22's second C call at M > 1: the select, the order and the write.
extern "C" int ckpe_k22_keep(const void* p, const void* d, void* op,
                             void* od, const void* rows_in, const void* child,
                             const void* site, int K, int L, K22_TABLE_ARGS,
                             void* ws, void* new_lw, void* stream) {
  if (n_p + n_d > K22_MAX_CELLS || M < 2 || L <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const K22Ws w = k22_ws(ws, K, M);
  int rc = k22_select(child, K, M, w, st);
  if (rc) return rc;
  rc = k22_order(K, w, st);
  if (rc) return rc;
  return k22_write(p, d, op, od, rows_in, child, site, K, L, K22_TABLE, w,
                   new_lw, st);
}
