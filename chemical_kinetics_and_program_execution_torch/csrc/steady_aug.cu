// K26 `steady_aug`: the steady state's augmentation, a linear map L(x),
// with its callers' elementwise arithmetic.
//
// Replaces the JAX package's `ode/steady.py:175-183 _ctcp` and `:232-249`
// (`_cons_vals`, `_cons_embed`, the normalization), which its augmented
// residual G(p) = F(p) - L(p) + constants and matvec J_G v = J v - L(v)
// run every Newton-Krylov step (XLA; no Pallas kernel). Plain PyTorch
// version: `ode/steady.py:steady_aug_plain`. For x [a^k] (a window
// distribution's shape), with the levels of x (lv[k-1] the sum over the
// trailing digit, lv[1] the single-symbol marginal, lv[0] the total,
// each entry its a children summed in digit order, as K3 and
// `pyramid_plain` form them):
//
//   defect[t] = sum_d x[d a^(k-1) + t] - lv[k-1][t]      t < a^(k-1)
//   L(x)[i]  = ((defect[i mod a^(k-1)] - defect[i / a]) + lv[0] / S)
//              + emb[i / a^(k-1)]
//   emb[i0]  = (sum_j w[j, i0] (sum_i w[j, i] lv[1][i]) / c) / c
//
// the consistency defect's C^T C x, the normalization's (sum x) / S and
// the lifted conserved functionals through the marginal (``mode`` 0);
// ``mode`` 1 (support mode) keeps the C^T C x term alone. The callers'
// arithmetic is fused, in their order (each input optional): L + ww
// (support mode's W^T W x, a library product beforehand), then f - L (f
// the RHS or its J v), then + cst (G's constant), then mask ? r : keep.
//
// Two launch forms, chosen on the host by a^k (`ode/steady.py:
// aug_form`):
// - one block (up to 1,024 threads) where x, its levels and the defects
//   fit the block's shared memory and x has at most 10,000 entries (past
//   that the split form measured faster): the block stages x with
//   16-byte loads, forms the levels k-1 .. 0, the defects, emb and lv[0]
//   / S, and writes the map once. No scratch in device memory, no K3.
// - past it, K3 on x, then the defects and the map in two launches (the
//   split form: one cooperative launch with the grid's barrier between
//   them, and a thread-block cluster holding x in distributed shared
//   memory, measured slower on the H100, PERF.md).
// Every sum in a fixed order, no atomics, `-fmad=false`: the plain
// version's bits in both forms. Bound: bytes, x and the fused inputs
// read once, L(x) written once.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxA = 64;
constexpr int kMaxThreads = 1024;
constexpr int kSplitThreads = 256;
constexpr int kFormSplit = 0, kFormBlock = 1;
// Doubles of dynamic shared memory a block may take (227 KB).
constexpr long long kSmemDoubles = 232448 / 8;

struct AugArgs {
  const double* x;
  const double* w;  // [n_c, a] conserved weights
  int n_c, a, mode;
  long long n, tail;  // a^k, a^(k-1)
  double c_norm;
  // The callers' arithmetic, each null when absent.
  const double* f;
  const double* cst;
  const double* ww;
  const unsigned char* mask;
  const double* keep;
  double* out;
  // Split form: K3's levels of x ([lv[k-1], ..., lv[0], 1]) and the
  // defects, emb and lv[0] / S ([a^(k-1) + a + 1]).
  const double* low;
  double* scratch;
};

// Doubles of the block form's shared memory: x [n], its levels k-1 .. 0
// ((n - 1) / (a - 1) together), the defects [n / a], emb [a] and lv[0] /
// S (`ode/steady.py:block_doubles` chooses the form by the same count).
inline long long block_doubles(long long n, int a) {
  return n + (n - 1) / (a - 1) + n / a + a + 1;
}

// The callers' arithmetic on L(x)[i], in their order.
__device__ __forceinline__ double k26_finish(const AugArgs& g, long long i,
                                             double L) {
  if (g.ww) L = L + g.ww[i];
  double r = g.f ? g.f[i] - L : L;
  if (g.cst) r = r + g.cst[i];
  if (g.mask) r = g.mask[i] ? r : g.keep[i];
  return r;
}

// emb[i0] (mode 0) from the marginal lv1 [a], in today's order.
__device__ __forceinline__ double k26_emb(const AugArgs& g, const double* lv1,
                                          int i0) {
  double emb = 0.0;
  for (int j = 0; j < g.n_c; ++j) {
    double val = 0.0;
    for (int i = 0; i < g.a; ++i) val = val + g.w[j * g.a + i] * lv1[i];
    emb = emb + g.w[j * g.a + i0] * (val / g.c_norm);
  }
  return emb / g.c_norm;
}

__global__ void __launch_bounds__(kMaxThreads) k26_block_kernel(AugArgs g) {
  extern __shared__ __align__(16) double k26_smem[];
  // 32-bit indices: the block's shared memory holds all of x.
  const unsigned a = (unsigned)g.a, n = (unsigned)g.n;
  const unsigned tail = (unsigned)g.tail, nlv = (n - 1) / (a - 1);
  double* xs = k26_smem;
  double* lvs = xs + n;
  double* defs = lvs + nlv;
  double* emb = defs + tail;
  double* tot = emb + a;
  const unsigned threads = blockDim.x, tid = threadIdx.x;
  // x, 16 bytes a load where its length is even.
  if (n % 2 == 0 && ((size_t)g.x & 15) == 0) {
    const double2* src = reinterpret_cast<const double2*>(g.x);
    double2* dst = reinterpret_cast<double2*>(xs);
    for (unsigned q = tid; q < n / 2; q += threads) dst[q] = src[q];
  } else {
    for (unsigned q = tid; q < n; q += threads) xs[q] = g.x[q];
  }
  __syncthreads();
  // The levels k-1 .. 0, each entry its a children in digit order.
  {
    const double* src = xs;
    double* dst = lvs;
    for (unsigned len = tail;; len /= a) {
      for (unsigned q = tid; q < len; q += threads) {
        const double* c = src + q * a;
        double acc = c[0];
        for (unsigned j = 1; j < a; ++j) acc = acc + c[j];
        dst[q] = acc;
      }
      __syncthreads();
      if (len == 1) break;
      src = dst;
      dst += len;
    }
  }
  // emb and lv[0] / S (mode 0), and the defects: defect t sums x[d
  // a^(k-1) + t] over d in order, minus lv[k-1][t].
  const double* lv0 = lvs + nlv - 1;
  if (g.mode == 0) {
    if (tid < a) emb[tid] = k26_emb(g, lv0 - a, (int)tid);
    if (tid == 0) *tot = *lv0 / (double)g.n;
  }
  for (unsigned q = tid; q < tail; q += threads) {
    double head = xs[q];
    for (unsigned d = 1; d < a; ++d) head = head + xs[d * tail + q];
    defs[q] = head - lvs[q];
  }
  __syncthreads();
  // The map and the callers' arithmetic, one write an entry.
  for (unsigned q = tid; q < n; q += threads) {
    const unsigned lead = q / tail;
    const double ct = defs[q - lead * tail] - defs[q / a];
    const double L = g.mode == 0 ? (ct + *tot) + emb[lead] : ct;
    g.out[q] = k26_finish(g, q, L);
  }
}

// The split form, after K3: the defects (block 0 also emb and lv[0] /
// S) into the scratch, then the map, two launches.
__global__ void __launch_bounds__(kSplitThreads) k26_defect_kernel(AugArgs g) {
  const long long t = (long long)blockIdx.x * kSplitThreads + threadIdx.x;
  double* defect = g.scratch;
  if (t < g.tail) {
    double head = g.x[t];
    for (int d = 1; d < g.a; ++d) head = head + g.x[(long long)d * g.tail + t];
    defect[t] = head - g.low[t];
  }
  if (blockIdx.x == 0 && threadIdx.x < (unsigned)g.a) {
    // low holds lv[k-1] .. lv[0]: lv[0] at (n - 1) / (a - 1) - 1.
    const long long at0 = (g.n - 1) / (g.a - 1) - 1;
    const int i0 = threadIdx.x;
    defect[g.tail + i0] = g.mode == 0 ? k26_emb(g, g.low + at0 - g.a, i0) : 0.0;
    if (i0 == 0)
      defect[g.tail + g.a] = g.mode == 0 ? g.low[at0] / (double)g.n : 0.0;
  }
}

// The map; kFused where any of the callers' inputs is given, so that L
// alone reads no null pointer's test an entry.
template <bool kFused>
__global__ void __launch_bounds__(kSplitThreads) k26_map_kernel(AugArgs g) {
  const long long i = (long long)blockIdx.x * kSplitThreads + threadIdx.x;
  if (i >= g.n) return;
  const double* defect = g.scratch;
  const double ct = defect[i % g.tail] - defect[i / g.a];
  const double L = g.mode == 0 ? (ct + defect[g.tail + g.a]) +
                                     defect[g.tail + i / g.tail]
                               : ct;
  g.out[i] = kFused ? k26_finish(g, i, L) : L;
}

// Threads of the block form: about two entries a thread, whole warps, at
// most 1,024.
int block_threads(long long n) {
  long long t = (n / 2 + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t);
}

// Raises the block kernel's dynamic shared memory limit once: a host
// call each launch would pace the host-paced solvers.
cudaError_t prepare(unsigned bytes) {
  static unsigned most;
  if (bytes <= 48 * 1024 || bytes <= most) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      k26_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err == cudaSuccess) most = bytes;
  return err;
}

}  // namespace

// out [a^k] = the callers' arithmetic on L(x) (see `k26_finish`); ``w``
// [n_c, a] row-major (read in mode 0); f, cst, ww, mask (bytes), keep
// null or [a^k]. ``form`` 0 the split form (``low`` K3's levels of x,
// ``scratch`` a^(k-1) + a + 1 doubles), 1 one block.
extern "C" int ckpe_steady_aug(const double* x, int a, int k, const double* w,
                               int n_c, double c_norm, int mode,
                               const double* f, const double* cst,
                               const double* ww, const void* mask,
                               const double* keep, int form,
                               const double* low, double* scratch,
                               double* out, cudaStream_t stream) {
  if (a < 2 || a > kMaxA || k < 2 || mode < 0 || mode > 1 || n_c < 0 ||
      (mask != nullptr) != (keep != nullptr))
    return (int)cudaErrorInvalidValue;
  AugArgs g = {};
  g.x = x;
  g.w = w;
  g.n_c = n_c;
  g.a = a;
  g.mode = mode;
  long long pw = 1;
  for (int j = 0; j < k; ++j) pw *= a;
  g.n = pw;
  g.tail = pw / a;
  g.c_norm = c_norm;
  g.f = f;
  g.cst = cst;
  g.ww = ww;
  g.mask = (const unsigned char*)mask;
  g.keep = keep;
  g.out = out;
  cudaError_t err;
  if (form == kFormSplit) {
    if (!low || !scratch) return (int)cudaErrorInvalidValue;
    g.low = low;
    g.scratch = scratch;
    const long long b1 = (g.tail + kSplitThreads - 1) / kSplitThreads;
    k26_defect_kernel<<<(unsigned)(b1 > 0 ? b1 : 1), kSplitThreads, 0,
                        stream>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const unsigned b2 = (unsigned)((g.n + kSplitThreads - 1) / kSplitThreads);
    if (f || cst || ww || mask)
      k26_map_kernel<true><<<b2, kSplitThreads, 0, stream>>>(g);
    else
      k26_map_kernel<false><<<b2, kSplitThreads, 0, stream>>>(g);
  } else if (form == kFormBlock) {
    const long long doubles = block_doubles(g.n, a);
    if (doubles > kSmemDoubles) return (int)cudaErrorInvalidValue;
    const unsigned bytes = (unsigned)(doubles * 8);
    err = prepare(bytes);
    if (err != cudaSuccess) return (int)err;
    k26_block_kernel<<<1, block_threads(g.n), bytes, stream>>>(g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
