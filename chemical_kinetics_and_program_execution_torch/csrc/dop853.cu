// K6 `dop853_arith`: the Runge-Kutta steppers' vector arithmetic on the card.
//
// Replaces the bodies of the JAX package's `ode/dop853.py:157
// odeint_dop853_dense` and its host-stepped twins `ode/streamed_solve.py`
// `_lincomb`, `_error_norms`, `_rms_scaled`, `_rms_diff_scaled`,
// `_dense_coeffs` and `_dense_eval`; of `ode/dop853.py:45 odeint_dop853`
// (the step-clamped DOP853); and of `ode/dopri5.py:48 odeint_dopri5` with
// `_rms_norm` (:43), and of `ode/kvaerno3.py:54 _newton_stage` and :99
// `odeint_kvaerno3` (XLA programs; no Pallas kernel). Plain PyTorch
// versions: `ode/dop853.py` (`*_plain`). The host drives the steps
// (`ode/dop853.py:odeint_dop853_dense`, `odeint_dop853`,
// `ode/dopri5.py:odeint_dopri5`) and reads one or two scalars a step; the
// state and the stages ([16, n] or [7, n] float64, one tensor) stay on
// the card. Stage rows lie ``ks_ld`` doubles apart and the stack's rows
// ``f_ld`` apart: the solver rounds both up to a multiple of 32, so each
// row starts on a 256-byte boundary (n = A^k is odd, and a row at a
// stride of n would start 8 bytes into a sector every other row).
//
// At the solver's sizes (n = 9^5 is 231 blocks of 256 threads) a launch
// is mostly ramp and tail, and the host's cost to queue one (a Python
// call, ctypes, building its arguments) is larger than the card's time.
// So the design cuts launches and what the host builds for each:
//
// - The tableau: both methods' fixed stage combinations (`ode/dop853.py:
//   TABLEAU`: the initial step's Euler row, DOP853's A rows 1-11, B, the
//   three extra rows, E5 and E3, then Dormand-Prince 5(4)'s A rows 1-6,
//   B5 and its error row B5 - B4), each as its nonzero (stage,
//   coefficient) terms in stage order, live in `__constant__` memory,
//   uploaded once a card (`ckpe_k6_tableau`). A launch names its row; a
//   warp reads each term by broadcast. The one row map the solver makes,
//   stage 0 and the first-same-as-last stage (12 for DOP853, 6 for
//   dopri5: ``fsal``, a launch argument) swapping rows after an accepted
//   step, is one flag.
// - stage: y + h * sum_q c_q k_q, one elementwise launch, the sum taken
//   in stage order (the plain version's order, `-fmad=false`).
// - norms: DOP853's combined 5th/3rd-order error sums, dopri5's one error
//   sum of (h e / scale)^2, and the initial-step rule's scaled sums, in
//   one launch: a fixed grid whose blocks each reduce a fixed slice in a
//   fixed tree and write a partial; the last block to finish (a
//   `__threadfence` and an atomic ticket) reduces the partials in a fixed
//   tree and resets the ticket. No float atomics: two runs give the same
//   bits, the plain version's (it sums in this order,
//   `cuda.block_order_sum`). The partials, the ticket and the sums are
//   the caller's scratch: one a solve, so two solves on two streams never
//   share a ticket. The host takes the square root of the mean, as
//   `_rms_norm` does.
// - dense_coeffs: the 7-row continuous-output stack [7, n] in one launch.
//   A thread loads each stage row that D reads once into registers and
//   forms D's four combinations from them, each in stage order (the
//   plain version's order). Read row by row through `lincomb`, an
//   element took 40-odd loads, and with the stage rows on 256-byte
//   boundaries the kernel ran far slower than at a stride of n
//   (PERF.md).
// - dense_eval: the 7th-order interpolant at every sample time a step
//   holds, one launch. A thread loads its element of the stack's 7 rows
//   and of y once, forms each sample's fraction x = min(max((ts[q] - t) /
//   h, 0), 1) as the host did (a subtraction and a division, which
//   cannot fuse) and writes its element of every row of its chunk by the
//   per-fraction Horner order. Chunks of kEvalRows rows go to blockIdx.y,
//   so a step with many samples fills the card.
//
// - Kvaerno 3(2) (`ode/kvaerno3.py`), the third table: its stage bases
//   g_s and Newton predictors are tableau rows (26-30) run by `stage`
//   (with g_s as the base vector of the predictor); the Newton residual
//   phi(z) = z - h gamma f(z) - g is `resid`, one elementwise launch; the
//   Newton step's scaled norm fused with z += dz and the embedded error
//   are two more `norms` modes (kNewton, kErrDiff).
//
// Bound: bytes. A stage reads y and its m nonzero stages and writes one
// vector: (m + 2) n doubles; the error sums read y, y_new and the stages
// their rows name (12 for DOP853, 6 for dopri5); the coefficients read
// y, y_new and 12 stages and write 7 rows; an evaluation of m samples
// reads the 7 rows and y and writes m vectors.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTerms = 16;
constexpr int kReduceBlocks = 1024;
constexpr int kMaxRows = 48;  // `ode/dop853.py:TABLEAU` has 31
constexpr int kEvalRows = 8;
constexpr int kMaxEvalChunks = 65535;

struct Terms {
  int n;
  int row[kMaxTerms];
  double c[kMaxTerms];
};

__constant__ Terms c_tableau[kMaxRows];
int g_rows = 0;  // rows uploaded (the same table on every card)

struct DenseRows {
  int nu;                  // stage rows D reads, in stage order
  int row[kMaxTerms];
  double c[4][kMaxTerms];  // D row r's weight of row[u]; 0 where none
};

// The row of ks that holds stage r: stages 0 and fsal trade rows when
// ``swap``.
__device__ __forceinline__ int stage_row(int r, int swap, int fsal) {
  return swap && (r == 0 || r == fsal) ? fsal - r : r;
}

// sum_q c_q ks[stage q] over tableau row `which`, in stage order.
__device__ __forceinline__ double lincomb(const double* __restrict__ ks,
                                          long long ld, int which, int swap,
                                          int fsal, long long i) {
  const Terms& t = c_tableau[which];
  double acc = t.c[0] * ks[stage_row(t.row[0], swap, fsal) * ld + i];
  for (int q = 1; q < t.n; ++q)
    acc = acc + t.c[q] * ks[stage_row(t.row[q], swap, fsal) * ld + i];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
k6_stage_kernel(const double* __restrict__ y, const double* __restrict__ ks,
                long long ks_ld, long long n, int which, int swap, int fsal,
                double h, double* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = y[i] + h * lincomb(ks, ks_ld, which, swap, fsal, i);
}

enum { kRms = 0, kRmsDiff = 1, kErr = 2, kErrH = 3, kNewton = 4,
       kErrDiff = 5 };

struct NormArgs {
  int mode, swap, fsal;
  int e0, e1;           // kErr: the rows E5 and E3; kErrH: the row e0
  long long n;
  double rtol, atol, h;
  const double* y;      // scale from y (and y_new in kErr, kErrH)
  const double* y_new;
  const double* f0;     // kRms: f; kRmsDiff: f0; kNewton: dz; kErrDiff: z3
  const double* f1;     // kRmsDiff: f1
  double* z;            // kNewton: the iterate, z += dz in place
  const double* ks;     // kErr, kErrH: the stages, rows ks_ld apart
  long long ks_ld;
  double* partial;      // 2 a block
  unsigned* ticket;     // 0 between launches
  double* out;          // the two sums
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

// Block b reduces elements b*kThreads + t + m*stride, in order, and
// writes its partial; the last block to finish sums the partials, thread
// t taking blocks t, t + kThreads, ... in order, then the block's tree.
__global__ void __launch_bounds__(kThreads) k6_norms_kernel(NormArgs g) {
  double s0 = 0.0, s1 = 0.0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < g.n;
       i += stride) {
    if (g.mode == kNewton) {  // Kvaerno 3(2): rms(dz / y_scale), z += dz
      const double dz = g.f0[i];
      const double u = dz / (g.atol + fabs(g.y[i]) * g.rtol);
      s0 = s0 + u * u;
      g.z[i] = g.z[i] + dz;
    } else if (g.mode == kErrDiff) {  // its embedded error (y_new - z3)
      const double ay = fabs(g.y[i]), an = fabs(g.y_new[i]);
      const double scale = g.atol + (an > ay ? an : ay) * g.rtol;
      const double u = (g.y_new[i] - g.f0[i]) / scale;
      s0 = s0 + u * u;
    } else if (g.mode == kErr || g.mode == kErrH) {
      const double ay = fabs(g.y[i]), an = fabs(g.y_new[i]);
      const double scale = g.atol + (an > ay ? an : ay) * g.rtol;
      if (g.mode == kErr) {
        const double e5 =
            lincomb(g.ks, g.ks_ld, g.e0, g.swap, g.fsal, i) / scale;
        const double e3 =
            lincomb(g.ks, g.ks_ld, g.e1, g.swap, g.fsal, i) / scale;
        s0 = s0 + e5 * e5;
        s1 = s1 + e3 * e3;
      } else {  // dopri5: (h * e) / scale, as `_rms_norm`'s argument
        const double u =
            g.h * lincomb(g.ks, g.ks_ld, g.e0, g.swap, g.fsal, i) / scale;
        s0 = s0 + u * u;
      }
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
  __shared__ bool last;
  if (threadIdx.x == 0) {
    g.partial[2 * blockIdx.x] = s0;
    g.partial[2 * blockIdx.x + 1] = s1;
    __threadfence();  // the partial is visible before the ticket counts it
    last = atomicAdd(g.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double t0 = 0.0, t1 = 0.0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
    t0 = t0 + __ldcg(g.partial + 2 * b);
    t1 = t1 + __ldcg(g.partial + 2 * b + 1);
  }
  block_sum2(t0, t1);
  if (threadIdx.x == 0) {
    g.out[0] = t0;
    g.out[1] = t1;
    *g.ticket = 0u;
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

// Rows q0 .. q0 + kEvalRows - 1 (below m) of the samples at ts[i_out + q].
__global__ void __launch_bounds__(kThreads)
k6_dense_eval_kernel(const double* __restrict__ F, long long f_ld,
                     const double* __restrict__ y, long long n,
                     const double* __restrict__ ts, long long i_out, int m,
                     double t, double h, double* __restrict__ out,
                     long long out_ld) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  double f[7];
#pragma unroll
  for (int r = 0; r < 7; ++r) f[r] = F[r * f_ld + i];
  const double yi = y[i];
  const int q0 = blockIdx.y * kEvalRows;
  const int q1 = m - q0 < kEvalRows ? m : q0 + kEvalRows;
  for (int q = q0; q < q1; ++q) {
    // min(max(v, 0), 1) as the host takes it: v unless 0 > v, then that
    // unless 1 < it.
    const double v = (ts[i_out + q] - t) / h;
    const double lo = 0.0 > v ? 0.0 : v;
    const double x = 1.0 < lo ? 1.0 : lo;
    const double one_minus_x = 1.0 - x;
    double acc = 0.0;
#pragma unroll
    for (int r = 6; r >= 0; --r) {
      acc = acc + f[r];
      acc = acc * ((6 - r) % 2 == 0 ? x : one_minus_x);
    }
    out[q * out_ld + i] = yi + acc;
  }
}

__global__ void __launch_bounds__(kThreads)
k6_resid_kernel(const double* __restrict__ z, const double* __restrict__ g,
                const double* __restrict__ f, double hg, long long n,
                double* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = (z[i] - hg * f[i]) - g[i];
}

unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

int reduce_blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kReduceBlocks ? (b > 0 ? b : 1) : kReduceBlocks);
}

}  // namespace

// The tableau into the current card's constant memory: row r has
// count[r] terms, (rows[r * 16 + q], coefs[r * 16 + q]) in stage order.
extern "C" int ckpe_k6_tableau(const int* count, const int* rows,
                               const double* coefs, int n_rows) {
  if (n_rows < 1 || n_rows > kMaxRows) return (int)cudaErrorInvalidValue;
  Terms t[kMaxRows] = {};
  for (int r = 0; r < n_rows; ++r) {
    if (count[r] < 1 || count[r] > kMaxTerms)
      return (int)cudaErrorInvalidValue;
    t[r].n = count[r];
    for (int q = 0; q < kMaxTerms; ++q) {
      t[r].row[q] = rows[r * kMaxTerms + q];
      t[r].c[q] = coefs[r * kMaxTerms + q];
    }
  }
  const cudaError_t err = cudaMemcpyToSymbol(c_tableau, t, sizeof(t));
  if (err == cudaSuccess) g_rows = n_rows;
  return (int)err;
}

// Stage: out = y + h * sum_q c_q * ks[stage q] over tableau row `which`;
// with `swap`, stages 0 and fsal each read the other's row.
extern "C" int ckpe_k6_stage(const double* y, const double* ks,
                             long long ks_ld, long long n, int which,
                             int swap, int fsal, double h, double* out,
                             cudaStream_t stream) {
  if (which < 0 || which >= g_rows || fsal < 1 || fsal >= kMaxTerms)
    return (int)cudaErrorInvalidValue;
  k6_stage_kernel<<<blocks(n), kThreads, 0, stream>>>(y, ks, ks_ld, n, which,
                                                      swap, fsal, h, out);
  return (int)cudaGetLastError();
}

// Two sums into scratch[2048..2049], one launch; scratch holds 2 * 1024
// partials, the two sums, and the ticket (an unsigned, 0 between calls)
// in the first bytes of scratch[2050]. mode 0: sum (y/scale)^2, sum
// (f0/scale)^2; mode 1: sum ((f1-f0)/scale)^2; mode 2: sum (e5/scale)^2,
// sum (e3/scale)^2 with e5, e3 the tableau's rows e0 and e1; mode 3: sum
// (h e/scale)^2 with e the row e0, and 0; mode 4 (Kvaerno 3(2)'s Newton
// step): sum (f0/scale)^2 with scale = atol + |y| rtol, and f1 += f0 in
// place (f1 the iterate z, f0 the update dz); mode 5 (its embedded
// error): sum ((y_new - f0)/scale)^2 with mode 2's scale. Stages 0 and
// fsal trade rows when ``swap``.
extern "C" int ckpe_k6_norms(int mode, long long n, double rtol, double atol,
                             double h, const double* y, const double* y_new,
                             const double* f0, const double* f1,
                             const double* ks, long long ks_ld, int swap,
                             int fsal, int e0, int e1, double* scratch,
                             cudaStream_t stream) {
  if (mode < kRms || mode > kErrDiff ||
      ((mode == kErr || mode == kErrH) &&
       (e0 < 0 || e0 >= g_rows || (mode == kErr && (e1 < 0 || e1 >= g_rows)) ||
        fsal < 1 || fsal >= kMaxTerms)))
    return (int)cudaErrorInvalidValue;
  NormArgs g;
  g.mode = mode;
  g.swap = swap;
  g.fsal = fsal;
  g.e0 = e0;
  g.e1 = e1;
  g.n = n;
  g.rtol = rtol;
  g.atol = atol;
  g.h = h;
  g.y = y;
  g.y_new = y_new;
  g.f0 = f0;
  g.f1 = f1;
  g.z = const_cast<double*>(f1);  // kNewton: f1 names the iterate
  g.ks = ks;
  g.ks_ld = ks_ld;
  g.partial = scratch;
  g.out = scratch + 2 * kReduceBlocks;
  g.ticket = reinterpret_cast<unsigned*>(scratch + 2 * kReduceBlocks + 2);
  k6_norms_kernel<<<reduce_blocks(n), kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// Kvaerno 3(2)'s Newton residual: out = (z - hg * f) - g, elementwise.
extern "C" int ckpe_k6_resid(const double* z, const double* g,
                             const double* f, double hg, long long n,
                             double* out, cudaStream_t stream) {
  k6_resid_kernel<<<blocks(n), kThreads, 0, stream>>>(z, g, f, hg, n, out);
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

// The samples at ts[i_out .. i_out + m) (ts on the card) of the step from
// t of size h, into rows 0..m-1 of out (rows out_ld apart); one launch.
extern "C" int ckpe_k6_dense_eval(const double* F, long long f_ld,
                                  const double* y, long long n,
                                  const double* ts, long long i_out, int m,
                                  double t, double h, double* out,
                                  long long out_ld, cudaStream_t stream) {
  const int chunks = (m + kEvalRows - 1) / kEvalRows;
  if (m < 1 || chunks > kMaxEvalChunks) return (int)cudaErrorInvalidValue;
  k6_dense_eval_kernel<<<dim3(blocks(n), chunks), kThreads, 0, stream>>>(
      F, f_ld, y, n, ts, i_out, m, t, h, out, out_ld);
  return (int)cudaGetLastError();
}
