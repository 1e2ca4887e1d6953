// K26 `steady_aug`: the steady state's augmentation, a linear map L(x).
//
// Replaces the JAX package's `ode/steady.py:175-183 _ctcp` and `:232-249`
// (`_cons_vals`, `_cons_embed`, the normalization), which its augmented
// residual G(p) = F(p) - L(p) + constants and matvec J_G v = J v - L(v)
// run every Newton-Krylov step (XLA; no Pallas kernel). Plain PyTorch
// version: `ode/steady.py:steady_aug_plain`. For x [a^k] (a window
// distribution's shape), with K3's levels of x (`dense_rhs.cu:
// ckpe_pyramid`, launched first by the wrapper: lv[k-1] is the sum over
// the trailing digit, lv[1] the single-symbol marginal, lv[0] the total):
//
//   defect[t] = sum_d x[d a^(k-1) + t] - lv[k-1][t]      t < a^(k-1)
//   L(x)[i]  = ((defect[i mod a^(k-1)] - defect[i / a]) + lv[0] / S)
//              + emb[i / a^(k-1)]
//   emb[i0]  = (sum_j w[j, i0] (sum_i w[j, i] lv[1][i]) / c) / c
//
// the consistency defect's C^T C x, the normalization's (sum x) / S and
// the lifted conserved functionals through the marginal (``mode`` 0);
// ``mode`` 1 (support mode) keeps the C^T C x term alone, the caller
// adding its W^T W x by a plain product. Two launches: the defect (a
// thread an entry, its leading-digit sum in digit order; block 0's first
// warp also forms emb and lv[0] / S), then the map (a thread an entry).
// Every sum in a fixed order, no atomics, `-fmad=false`: the plain
// version's bits. Bound: bytes, x read about twice (the second read
// strided by a^(k-1), one sector an element) and L(x) written once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxA = 64;

struct AugArgs {
  const double* x;
  const double* low;  // K3's levels of x: [lv[k-1], ..., lv[0], 1]
  const double* w;    // [n_c, a] conserved weights
  int n_c, a, mode;
  long long n, tail;  // a^k, a^(k-1)
  long long off1, off0;  // lv[1] and lv[0] in low
  double c_norm;
  double* defect;     // scratch: [a^(k-1)] defects, [a] emb, total / S
  double* out;
};

__global__ void __launch_bounds__(kThreads) k26_defect_kernel(AugArgs g) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t < g.tail) {
    double head = g.x[t];
    for (int d = 1; d < g.a; ++d) head = head + g.x[(long long)d * g.tail + t];
    g.defect[t] = head - g.low[t];
  }
  if (blockIdx.x == 0 && threadIdx.x < g.a) {
    const int i0 = threadIdx.x;
    double emb = 0.0;
    if (g.mode == 0) {
      for (int j = 0; j < g.n_c; ++j) {
        double val = 0.0;
        for (int i = 0; i < g.a; ++i)
          val = val + g.w[j * g.a + i] * g.low[g.off1 + i];
        emb = emb + g.w[j * g.a + i0] * (val / g.c_norm);
      }
      emb = emb / g.c_norm;
    }
    g.defect[g.tail + i0] = emb;
    if (i0 == 0)
      g.defect[g.tail + g.a] = g.mode == 0 ? g.low[g.off0] / (double)g.n : 0.0;
  }
}

__global__ void __launch_bounds__(kThreads) k26_map_kernel(AugArgs g) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.n) return;
  const double ct = g.defect[i % g.tail] - g.defect[i / g.a];
  if (g.mode == 0)
    g.out[i] = (ct + g.defect[g.tail + g.a]) + g.defect[g.tail + i / g.tail];
  else
    g.out[i] = ct;
}

}  // namespace

// L(x) into out [a^k]; ``low`` K3's levels of x, ``w`` [n_c, a] row-major,
// ``scratch`` a^(k-1) + a + 1 doubles. mode 0: C^T C x + (sum x)/S + the
// conserved functionals' term; mode 1: C^T C x.
extern "C" int ckpe_steady_aug(const double* x, const double* low, int a,
                               int k, const double* w, int n_c,
                               double c_norm, int mode, double* scratch,
                               double* out, cudaStream_t stream) {
  if (a < 2 || a > kMaxA || k < 2 || mode < 0 || mode > 1 || n_c < 0)
    return (int)cudaErrorInvalidValue;
  AugArgs g;
  g.x = x;
  g.low = low;
  g.w = w;
  g.n_c = n_c;
  g.a = a;
  g.mode = mode;
  long long pw = 1, below = 0;
  for (int j = 0; j < k; ++j) {
    below += pw;
    pw *= a;
  }
  g.n = pw;
  g.tail = pw / a;
  // low holds lv[k-1] .. lv[0]: lv[j] starts at sum_{j < i < k} a^i.
  g.off0 = below - 1;
  g.off1 = below - 1 - a;
  g.c_norm = c_norm;
  g.defect = scratch;
  g.out = out;
  const unsigned b1 =
      (unsigned)((g.tail + kThreads - 1) / kThreads > 0
                     ? (g.tail + kThreads - 1) / kThreads
                     : 1);
  k26_defect_kernel<<<b1, kThreads, 0, stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k26_map_kernel<<<(unsigned)((g.n + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(g);
  return (int)cudaGetLastError();
}
