// K6 `dop853_arith`: the DOP853 stepper's vector arithmetic on the card.
//
// Replaces the body of the JAX package's `ode/dop853.py:157
// odeint_dop853_dense` and its host-stepped twins `ode/streamed_solve.py`
// `_lincomb`, `_error_norms`, `_rms_scaled`, `_rms_diff_scaled`,
// `_dense_coeffs` and `_dense_eval` (XLA programs; no Pallas kernel).
// Plain PyTorch versions: `ode/dop853.py` (`*_plain`). The host drives
// the steps (`ode/dop853.py:odeint_dop853_dense`) and reads two scalars
// a step; the state and the 16 stages ([16, n] float64, one tensor) stay
// on the card. Stage rows lie ``ks_ld`` doubles apart and the stack's
// rows ``f_ld`` apart: the solver rounds both up to a multiple of 32, so
// each row starts on a 256-byte boundary (n = A^k is odd, and a row at a
// stride of n would start 8 bytes into a sector every other row).
//
// - stage: y + h * sum_j c_j k_j, one elementwise launch; the host drops
//   the zero coefficients and passes the rest in stage order, the sum
//   taken in that order (the plain version's order, `-fmad=false`).
// - norms: the combined 5th/3rd-order error sums, and the initial-step
//   rule's scaled sums, as a two-pass block reduction: a fixed grid
//   whose blocks each reduce a fixed slice in a fixed tree, then one
//   block that reduces the partials in a fixed tree. No atomics: two
//   runs give the same bits (the order differs from torch.sum's, which
//   the solver's tolerance absorbs).
// - dense_coeffs: the 7-row continuous-output stack [7, n] in one launch.
//   A thread loads each stage row that D reads once into registers and
//   forms D's four combinations from them, each in stage order (the
//   plain version's order). Read row by row through `lincomb`, an
//   element took 40-odd loads, and with the stage rows on 256-byte
//   boundaries the kernel ran far slower than at a stride of n
//   (PERF.md).
// - dense_eval: the 7th-order interpolant at one fraction x, one launch.
//
// Bound: bytes. A stage reads y and its m nonzero stages and writes one
// vector: (m + 2) n doubles; the error sums read y, y_new and 12 stages;
// the coefficients read y, y_new and 12 stages and write 7 rows; an
// evaluation reads the 7 rows and y and writes one vector.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTerms = 16;
constexpr int kReduceBlocks = 1024;

struct Terms {
  int n;
  int row[kMaxTerms];
  double c[kMaxTerms];
};

struct DenseRows {
  int nu;                  // stage rows D reads, in stage order
  int row[kMaxTerms];
  double c[4][kMaxTerms];  // D row r's weight of row[u]; 0 where none
};

__device__ __forceinline__ double lincomb(const double* __restrict__ ks,
                                          long long ld, const Terms& t,
                                          long long i) {
  double acc = t.c[0] * ks[t.row[0] * ld + i];
  for (int q = 1; q < t.n; ++q) acc = acc + t.c[q] * ks[t.row[q] * ld + i];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
k6_stage_kernel(const double* __restrict__ y, const double* __restrict__ ks,
                long long ks_ld, long long n, double h, Terms t,
                double* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = y[i] + h * lincomb(ks, ks_ld, t, i);
}

enum { kRms = 0, kRmsDiff = 1, kErr = 2 };

struct NormArgs {
  int mode;
  long long n;
  double rtol, atol;
  const double* y;      // scale from y (and y_new in kErr)
  const double* y_new;
  const double* f0;     // kRms: f; kRmsDiff: f0
  const double* f1;     // kRmsDiff: f1
  const double* ks;     // kErr: the stages, rows ks_ld apart
  long long ks_ld;
  Terms e5, e3;
};

__device__ __forceinline__ void block_sum2(double& a, double& b) {
  __shared__ double sa[kThreads], sb[kThreads];
  sa[threadIdx.x] = a;
  sb[threadIdx.x] = b;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      sa[threadIdx.x] = sa[threadIdx.x] + sa[threadIdx.x + w];
      sb[threadIdx.x] = sb[threadIdx.x] + sb[threadIdx.x + w];
    }
    __syncthreads();
  }
  a = sa[0];
  b = sb[0];
}

// Pass 1: block b reduces elements b*kThreads + t + m*stride, in order.
__global__ void __launch_bounds__(kThreads)
k6_norm_partial_kernel(NormArgs g, double* __restrict__ partial) {
  double s0 = 0.0, s1 = 0.0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < g.n;
       i += stride) {
    if (g.mode == kErr) {
      const double ay = fabs(g.y[i]), an = fabs(g.y_new[i]);
      const double scale = g.atol + (an > ay ? an : ay) * g.rtol;
      const double e5 = lincomb(g.ks, g.ks_ld, g.e5, i) / scale;
      const double e3 = lincomb(g.ks, g.ks_ld, g.e3, i) / scale;
      s0 = s0 + e5 * e5;
      s1 = s1 + e3 * e3;
    } else {
      const double scale = g.atol + fabs(g.y[i]) * g.rtol;
      if (g.mode == kRms) {
        const double u = g.y[i] / scale, v = g.f0[i] / scale;
        s0 = s0 + u * u;
        s1 = s1 + v * v;
      } else {
        const double u = (g.f1[i] - g.f0[i]) / scale;
        s0 = s0 + u * u;
      }
    }
  }
  block_sum2(s0, s1);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = s0;
    partial[2 * blockIdx.x + 1] = s1;
  }
}

// Pass 2: one block sums the partials in a fixed tree.
__global__ void __launch_bounds__(kThreads)
k6_norm_final_kernel(const double* __restrict__ partial, int n_partial,
                     double* __restrict__ out) {
  double s0 = 0.0, s1 = 0.0;
  for (int b = threadIdx.x; b < n_partial; b += kThreads) {
    s0 = s0 + partial[2 * b];
    s1 = s1 + partial[2 * b + 1];
  }
  block_sum2(s0, s1);
  if (threadIdx.x == 0) {
    out[0] = s0;
    out[1] = s1;
  }
}

__global__ void __launch_bounds__(kThreads)
k6_dense_coeffs_kernel(const double* __restrict__ y,
                       const double* __restrict__ y_new,
                       const double* __restrict__ f_old,
                       const double* __restrict__ f_new,
                       const double* __restrict__ ks, long long ks_ld,
                       long long n, double h, DenseRows rows,
                       double* __restrict__ out, long long f_ld) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const double delta = y_new[i] - y[i];
  out[i] = delta;
  out[f_ld + i] = h * f_old[i] - delta;
  out[2 * f_ld + i] = 2.0 * delta - h * (f_new[i] + f_old[i]);
  double v[kMaxTerms];
#pragma unroll
  for (int u = 0; u < kMaxTerms; ++u)
    v[u] = u < rows.nu ? ks[rows.row[u] * ks_ld + i] : 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    double acc = 0.0;
    bool first = true;
#pragma unroll
    for (int u = 0; u < kMaxTerms; ++u) {
      if (u < rows.nu && rows.c[r][u] != 0.0) {
        const double t = rows.c[r][u] * v[u];
        acc = first ? t : acc + t;
        first = false;
      }
    }
    out[(3 + r) * f_ld + i] = h * acc;
  }
}

__global__ void __launch_bounds__(kThreads)
k6_dense_eval_kernel(const double* __restrict__ F, long long f_ld,
                     const double* __restrict__ y, long long n, double x,
                     double one_minus_x, double* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  double acc = 0.0;
  for (int r = 6; r >= 0; --r) {
    acc = acc + F[r * f_ld + i];
    acc = acc * ((6 - r) % 2 == 0 ? x : one_minus_x);
  }
  out[i] = y[i] + acc;
}

unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

int reduce_blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kReduceBlocks ? (b > 0 ? b : 1) : kReduceBlocks);
}

bool make_terms(const int* rows, const double* coefs, int m, Terms* t) {
  if (m < 1 || m > kMaxTerms) return false;
  t->n = m;
  for (int q = 0; q < m; ++q) {
    t->row[q] = rows[q];
    t->c[q] = coefs[q];
  }
  return true;
}

}  // namespace

// Stage: out = y + h * sum_q coefs[q] * ks[rows[q]] (host arrays of m).
extern "C" int ckpe_k6_stage(const double* y, const double* ks,
                             long long ks_ld, long long n, double h,
                             const int* rows, const double* coefs, int m,
                             double* out, cudaStream_t stream) {
  Terms t;
  if (!make_terms(rows, coefs, m, &t)) return (int)cudaErrorInvalidValue;
  k6_stage_kernel<<<blocks(n), kThreads, 0, stream>>>(y, ks, ks_ld, n, h, t,
                                                      out);
  return (int)cudaGetLastError();
}

// The scratch ``partial`` holds 2 * 1024 doubles; two sums go to out[0..1].
// mode 0: sum (y/scale)^2, sum (f0/scale)^2; mode 1: sum ((f1-f0)/scale)^2;
// mode 2: sum (e5/scale)^2, sum (e3/scale)^2 with e5, e3 the stage
// combinations given by (rows5, coefs5, m5) and (rows3, coefs3, m3).
extern "C" int ckpe_k6_norms(int mode, long long n, double rtol, double atol,
                             const double* y, const double* y_new,
                             const double* f0, const double* f1,
                             const double* ks, long long ks_ld,
                             const int* rows5,
                             const double* coefs5, int m5, const int* rows3,
                             const double* coefs3, int m3, double* partial,
                             double* out, cudaStream_t stream) {
  NormArgs g;
  g.mode = mode;
  g.n = n;
  g.rtol = rtol;
  g.atol = atol;
  g.y = y;
  g.y_new = y_new;
  g.f0 = f0;
  g.f1 = f1;
  g.ks = ks;
  g.ks_ld = ks_ld;
  g.e5.n = g.e3.n = 0;
  if (mode == kErr && !(make_terms(rows5, coefs5, m5, &g.e5) &&
                        make_terms(rows3, coefs3, m3, &g.e3)))
    return (int)cudaErrorInvalidValue;
  const int nb = reduce_blocks(n);
  k6_norm_partial_kernel<<<nb, kThreads, 0, stream>>>(g, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k6_norm_final_kernel<<<1, kThreads, 0, stream>>>(partial, nb, out);
  return (int)cudaGetLastError();
}

// The [7, n] continuous-output stack; rows 3..6 weigh the nu stage rows
// rows[u] (in stage order) by coefs[r * nu + u], skipping the zeros.
extern "C" int ckpe_k6_dense_coeffs(const double* y, const double* y_new,
                                    const double* f_old, const double* f_new,
                                    const double* ks, long long ks_ld,
                                    long long n, double h, const int* rows,
                                    const double* coefs, int nu, double* out,
                                    long long f_ld, cudaStream_t stream) {
  if (nu < 1 || nu > kMaxTerms) return (int)cudaErrorInvalidValue;
  DenseRows d;
  d.nu = nu;
  for (int u = 0; u < kMaxTerms; ++u) {
    d.row[u] = u < nu ? rows[u] : 0;
    for (int r = 0; r < 4; ++r) d.c[r][u] = u < nu ? coefs[r * nu + u] : 0.0;
  }
  k6_dense_coeffs_kernel<<<blocks(n), kThreads, 0, stream>>>(
      y, y_new, f_old, f_new, ks, ks_ld, n, h, d, out, f_ld);
  return (int)cudaGetLastError();
}

extern "C" int ckpe_k6_dense_eval(const double* F, long long f_ld,
                                  const double* y, long long n, double x,
                                  double one_minus_x, double* out,
                                  cudaStream_t stream) {
  k6_dense_eval_kernel<<<blocks(n), kThreads, 0, stream>>>(
      F, f_ld, y, n, x, one_minus_x, out);
  return (int)cudaGetLastError();
}
