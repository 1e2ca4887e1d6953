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
// with `:1991 _write_decode`; XLA rolls, gathers, top_k and a scan): one
// thread a member reads the shared site's window where it lies (no
// roll), forms its table row and child_lw = lw + out_log[row] [K, M];
// at M = 1 it also writes its window in place. At M > 1 the caller ranks
// the K*M children by a stable descending library sort (the reference's
// `lax.top_k`, which keeps the lower index first among ties) and one
// thread a slot copies its parent's rows, decodes the child's writes
// from wr_mask/wr_val and writes them. Bound: bytes (the tapes read and
// written once, the weights).
//
// Arithmetic is IEEE (built with -fmad=false): the plain versions do the
// same operations in the same order.

#include <cuda_runtime.h>
#include <math.h>
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

#define K22_MAX_CELLS 32

struct K22Table {
  int p_lo, n_p, d_lo, n_d, rows, M;
  const int* pv;            // [n_cells]
  const double* out_log;    // [rows, M]
  const int* out_world;     // [rows, M]
  const uint8_t* wr_mask;   // [W, n_cells] bool
  const int* wr_val;        // [W, n_cells]
};

__device__ __forceinline__ int k22_col(long long a, int L) {
  long long r = a % L;
  return (int)(r < 0 ? r + L : r);
}

// The table row of member rows prow, drow at the shared site: the int32
// radix sum (wrapping), then the reference's index rule.
__device__ __forceinline__ int k22_row(const int8_t* prow, const int8_t* drow,
                                       int L, int site, const K22Table& t) {
  uint32_t acc = 0;
  for (int j = 0; j < t.n_p; ++j)
    acc += (uint32_t)(int)prow[k22_col((long long)site + t.p_lo + j, L)] *
           (uint32_t)t.pv[j];
  for (int j = 0; j < t.n_d; ++j)
    acc += (uint32_t)(int)drow[k22_col((long long)site + t.d_lo + j, L)] *
           (uint32_t)t.pv[t.n_p + j];
  int r = (int)acc;
  if (r < 0) r += t.rows;
  return r < 0 ? 0 : (r >= t.rows ? t.rows - 1 : r);
}

// The window of rows prow, drow at site after spec's writes, applied to
// the cells of the parent rows qrow, erow (the same rows in place).
__device__ __forceinline__ void k22_write(int8_t* prow, int8_t* drow,
                                          const int8_t* qrow,
                                          const int8_t* erow, int L, int site,
                                          int spec, const K22Table& t) {
  const int nc = t.n_p + t.n_d;
  for (int c = 0; c < nc; ++c) {
    const bool is_p = c < t.n_p;
    const int col = k22_col(
        (long long)site + (is_p ? t.p_lo + c : t.d_lo + c - t.n_p), L);
    const int8_t old = (is_p ? qrow : erow)[col];
    const long long k = (long long)spec * nc + c;
    (is_p ? prow : drow)[col] = t.wr_mask[k] ? (int8_t)t.wr_val[k] : old;
  }
}

// Rank: rows [K], child [K, M] = lw + out_log[row]; at M = 1 also the
// write, in place.
__global__ void k22_rank(int8_t* __restrict__ p, int8_t* __restrict__ d,
                         const double* __restrict__ lw,
                         const int* __restrict__ site_ptr, int K, int L,
                         K22Table t, int* __restrict__ rows,
                         double* __restrict__ child) {
  const int b = blockIdx.x * FR_THREADS + threadIdx.x;
  if (b >= K) return;
  const int site = *site_ptr;
  int8_t* prow = p + (long long)b * L;
  int8_t* drow = d + (long long)b * L;
  const int r = k22_row(prow, drow, L, site, t);
  rows[b] = r;
  for (int m = 0; m < t.M; ++m)
    child[(long long)b * t.M + m] = lw[b] + t.out_log[(long long)r * t.M + m];
  if (t.M == 1) k22_write(prow, drow, prow, drow, L, site, t.out_world[r], t);
}

// Write (M > 1): slot s takes child idx[s] (parent idx/M, outcome idx%M):
// its parent's rows, the outcome's writes at the site, and new_lw[s] =
// vals[s] - vals[0] (vals sorted descending).
__global__ void k22_write_slots(const int8_t* __restrict__ p,
                                const int8_t* __restrict__ d,
                                int8_t* __restrict__ op,
                                int8_t* __restrict__ od,
                                const int* __restrict__ rows,
                                const long long* __restrict__ idx,
                                const double* __restrict__ vals,
                                const int* __restrict__ site_ptr, int K,
                                int L, K22Table t,
                                double* __restrict__ new_lw) {
  const int s = blockIdx.x * FR_THREADS + threadIdx.x;
  if (s >= K) return;
  const int site = *site_ptr;
  const long long i = idx[s];
  const long long par = i / t.M;
  const int slot = (int)(i - par * t.M);
  const int8_t* qrow = p + par * L;
  const int8_t* erow = d + par * L;
  int8_t* prow = op + (long long)s * L;
  int8_t* drow = od + (long long)s * L;
  for (int j = 0; j < L; ++j) {
    prow[j] = qrow[j];
    drow[j] = erow[j];
  }
  const int spec = t.out_world[(long long)rows[par] * t.M + slot];
  k22_write(prow, drow, qrow, erow, L, site, spec, t);
  new_lw[s] = vals[s] - vals[0];
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

// frontier_rank(p, d, lw, site (device int32), K, L, table..., rows,
// child): K22's first launch (in place at M = 1).
extern "C" int ckpe_frontier_rank(void* p, void* d, const void* lw,
                                  const void* site, int K, int L, int p_lo,
                                  int n_p, int d_lo, int n_d, int rows,
                                  int M, const void* pv, const void* out_log,
                                  const void* out_world, const void* wr_mask,
                                  const void* wr_val, void* rows_out,
                                  void* child, void* stream) {
  if (n_p + n_d > K22_MAX_CELLS || M < 1 || L <= 0)
    return (int)cudaErrorInvalidValue;
  if (K <= 0) return (int)cudaGetLastError();
  const K22Table t = k22_table(p_lo, n_p, d_lo, n_d, rows, M, pv, out_log,
                               out_world, wr_mask, wr_val);
  k22_rank<<<fr_blocks(K), FR_THREADS, 0, (cudaStream_t)stream>>>(
      (int8_t*)p, (int8_t*)d, (const double*)lw, (const int*)site, K, L, t,
      (int*)rows_out, (double*)child);
  return (int)cudaGetLastError();
}

// frontier_write(p, d, out_p, out_d, rows, idx [K] int64, vals [K] f64,
// site, K, L, table..., new_lw): K22's second launch (M > 1).
extern "C" int ckpe_frontier_write(const void* p, const void* d, void* op,
                                   void* od, const void* rows_in,
                                   const void* idx, const void* vals,
                                   const void* site, int K, int L, int p_lo,
                                   int n_p, int d_lo, int n_d, int rows,
                                   int M, const void* pv, const void* out_log,
                                   const void* out_world, const void* wr_mask,
                                   const void* wr_val, void* new_lw,
                                   void* stream) {
  if (n_p + n_d > K22_MAX_CELLS || M < 2 || L <= 0)
    return (int)cudaErrorInvalidValue;
  if (K <= 0) return (int)cudaGetLastError();
  const K22Table t = k22_table(p_lo, n_p, d_lo, n_d, rows, M, pv, out_log,
                               out_world, wr_mask, wr_val);
  k22_write_slots<<<fr_blocks(K), FR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)p, (const int8_t*)d, (int8_t*)op, (int8_t*)od,
      (const int*)rows_in, (const long long*)idx, (const double*)vals,
      (const int*)site, K, L, t, (double*)new_lw);
  return (int)cudaGetLastError();
}
