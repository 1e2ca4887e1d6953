// K3, K4 and K5: the exact SPD closure's dense dp/dt on the card.
//
// They replace the jitted XLA program of the JAX package's
// `engine/dense.py:dy_dt_dense` (the JAX package has no Pallas kernel on
// this path). Plain PyTorch versions: `engine/dense.py`
// `pyramid_ratios_plain`, `signature_weights_plain`, `sweep_plain`.
// Every sum is taken in a fixed order and no float atomic is used, so
// two runs give the same bits; built with `-fmad=false` (no contraction
// of a product into a sum), so each element's arithmetic is the plain
// version's.
//
// K3 `pyramid_ratios` (`dense.py:423 _levels`, `:432 _ratio_tables`;
// `markov.py:174 guarded_ratio`, `:194 pyramid`). One launch a level:
// thread i sums its A children in digit order into level j (the first
// launch also copies p into the flat pyramid, the last writes its
// constant-1 slot); then one launch forms every ratio table,
// r_le[j][f] = g(lv[j][f], lv[j-1][f mod A^(j-1)]) for j = 1..k and
// r_re[w] = g(lv[k][w], lv[k-1][w / A]), g(n, d) = n > 0 ? n / max(n, d)
// : 0. Bound: bytes, p read once, the pyramid (about 1.13 A^k doubles)
// and the tables (about 2.13 A^k) written once.
//
// K4 `signature_weights` (`dense.py:464-468`: `markov.py:189
// guarded_ratio_prod`, then `segment_sum`). One single-block launch:
// a thread takes a world's chain product of guarded ratios in chain
// order, times w_const; after a barrier a thread takes a signature and
// sums its worlds' weights walking a CSR of its pairs, built on the
// host once a program, in the original pair order. Tens to thousands
// of worlds: bound by the launch, not by bytes.
//
// K5 `sweep_step` (`dense.py:310 _apply_group`). One launch a sweep
// step (`sweep_rule.cuh`): thread j forms the step's value t[j] from the
// previous vector and a ratio table (a shift step's digit reduce fused
// into its gather), writes it for the next step, and adds the step's
// emission into dy[j] as a gather, recomputing the partner values it
// needs. The group's one-hot seed is read sparsely by the first step
// that uses it (a binary search in the seed's sorted ranks), and the
// interior emissions of a revealed run longer than the window (l0 > k,
// duplicate ranks legal) go to one single-thread launch that walks the
// members in order. Bound: bytes; a step reads its source and its
// ratio table and reads and writes dy, where a fused sweep would read
// each table once and write dy once. One launch a step is the simple
// first cut: a later version fuses a group's steps.

#include <cuda_runtime.h>

#include "sweep_rule.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 16;

__device__ __forceinline__ double guarded(double num, double den) {
  const bool pos = num > 0.0;
  double m = den > num ? den : num;
  if (den != den) m = den;  // max propagates NaN, as torch.maximum does
  return (pos ? num : 0.0) / (pos ? m : 1.0);
}

// K3: level j from level j + 1 (or from p); thread i sums its A children.
__global__ void __launch_bounds__(kThreads)
k3_level_kernel(const double* __restrict__ src, double* __restrict__ dst,
                unsigned n_out, int a, double* __restrict__ copy,
                double* __restrict__ one_slot) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i == 0 && one_slot) *one_slot = 1.0;
  if (i >= n_out) return;
  const double* c = src + (size_t)i * a;
  double acc = c[0];
  if (copy) copy[(size_t)i * a] = acc;
  for (int d = 1; d < a; ++d) {
    const double v = c[d];
    if (copy) copy[(size_t)i * a + d] = v;
    acc = acc + v;
  }
  dst[i] = acc;
}

struct K3Tables {
  int k, a;
  unsigned lv_off[kMaxK + 1];   // level j's offset in the pyramid
  unsigned lv_size[kMaxK + 1];  // A^j
  unsigned rat_off[kMaxK + 2];  // r_le[j] at rat_off[j], r_re at [k + 1]
};

// K3: every ratio table in one launch.
__global__ void __launch_bounds__(kThreads)
k3_ratio_kernel(const double* __restrict__ pyr, double* __restrict__ rat,
                K3Tables tb, unsigned n_total) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_total) return;
  int j = 1;
  while (j <= tb.k && i >= tb.rat_off[j] + tb.lv_size[j]) ++j;
  double num, den;
  if (j <= tb.k) {  // r_le[j]: tile of level j - 1
    const unsigned f = i - tb.rat_off[j];
    num = pyr[tb.lv_off[j] + f];
    den = pyr[tb.lv_off[j - 1] + f % tb.lv_size[j - 1]];
  } else {  // r_re: repeat of level k - 1
    const unsigned w = i - tb.rat_off[tb.k + 1];
    num = pyr[tb.lv_off[tb.k] + w];
    den = pyr[tb.lv_off[tb.k - 1] + w / (unsigned)tb.a];
  }
  rat[i] = guarded(num, den);
}

// K4: world weights, then signature weights, in one block.
__global__ void __launch_bounds__(1024)
k4_kernel(const double* __restrict__ pyr, const int* __restrict__ w_num,
          const int* __restrict__ w_den, const double* __restrict__ w_const,
          int n_worlds, int chain, const int* __restrict__ csr_ptr,
          const int* __restrict__ csr_world, int n_sig,
          double* __restrict__ wv, double* __restrict__ s) {
  for (int w = threadIdx.x; w < n_worlds; w += blockDim.x) {
    const int* num = w_num + (size_t)w * chain;
    const int* den = w_den + (size_t)w * chain;
    double prod = guarded(pyr[num[0]], pyr[den[0]]);
    for (int c = 1; c < chain; ++c)
      prod = prod * guarded(pyr[num[c]], pyr[den[c]]);
    wv[w] = w_const[w] * prod;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < n_sig; g += blockDim.x) {
    double acc = 0.0;
    for (int q = csr_ptr[g]; q < csr_ptr[g + 1]; ++q)
      acc = acc + wv[csr_world[q]];
    s[g] = acc;
  }
}

// K5: one sweep step over n_out window ranks.
__global__ void __launch_bounds__(kThreads) k5_step_kernel(K5Step step) {
  const unsigned j = blockIdx.x * kThreads + threadIdx.x;
  if (j < step.n_out) k5_element(step, j);
}

// K5: a group's interior emissions, (rank, signature id, sign) in order.
__global__ void k5_interior_kernel(double* __restrict__ dy,
                                   const int* __restrict__ ops, int n_ops,
                                   const double* __restrict__ sig_w) {
  for (int q = 0; q < n_ops; ++q) {
    const double w = sig_w[ops[3 * q + 1]];
    double* d = dy + ops[3 * q];
    *d = *d + (ops[3 * q + 2] < 0 ? -w : w);
  }
}

unsigned blocks(unsigned n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// K3. ``pyr`` holds (A^(k+1) - 1) / (A - 1) + 1 doubles, ``rat``
// sum_{j=1..k} A^j + A^k; k + 1 launches.
extern "C" int ckpe_pyramid_ratios(const double* p, int a, int k,
                                   double* pyr, double* rat,
                                   cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  K3Tables tb;
  tb.k = k;
  tb.a = a;
  unsigned pos = 0;
  for (int j = k; j >= 0; --j) {
    unsigned size = 1;
    for (int i = 0; i < j; ++i) size *= (unsigned)a;
    tb.lv_size[j] = size;
    tb.lv_off[j] = pos;
    pos += size;
  }
  double* one_slot = pyr + pos;
  for (int j = k - 1; j >= 0; --j) {
    const double* src = j == k - 1 ? p : pyr + tb.lv_off[j + 1];
    k3_level_kernel<<<blocks(tb.lv_size[j]), kThreads, 0, stream>>>(
        src, pyr + tb.lv_off[j], tb.lv_size[j], a,
        j == k - 1 ? pyr : nullptr, j == 0 ? one_slot : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  unsigned r = 0;
  for (int j = 1; j <= k; ++j) {
    tb.rat_off[j] = r;
    r += tb.lv_size[j];
  }
  tb.rat_off[k + 1] = r;
  r += tb.lv_size[k];
  k3_ratio_kernel<<<blocks(r), kThreads, 0, stream>>>(pyr, rat, tb, r);
  return (int)cudaGetLastError();
}

// K4. ``wv`` is scratch of n_worlds doubles; one launch.
extern "C" int ckpe_signature_weights(const double* pyr, const int* w_num,
                                      const int* w_den, const double* w_const,
                                      int n_worlds, int chain,
                                      const int* csr_ptr,
                                      const int* csr_world, int n_sig,
                                      double* wv, double* s,
                                      cudaStream_t stream) {
  k4_kernel<<<1, 1024, 0, stream>>>(pyr, w_num, w_den, w_const, n_worlds,
                                    chain, csr_ptr, csr_world, n_sig, wv, s);
  return (int)cudaGetLastError();
}

// K5: a whole sweep, one launch a step. ``steps`` is a host array of
// ``n_steps`` rows of 13 int64 fields (`engine/dense.py:sweep_plan`):
// kind, n_out, n_src, src buffer (-1: the sparse seed), dst buffer (-1:
// none), ratio offset, emits, lo, span, pair offset, pairs, seed (or
// interior) offset, seed (or interior) length. Buffer b is ``work`` + b
// * n (b = 0, 1: A^k doubles; b = 2: A^(k-1)). dy is zeroed first.
extern "C" int ckpe_dense_sweep(const long long* steps, int n_steps,
                                int a, long long n, double* work,
                                double* dy, const double* rat,
                                const double* sig_w, const int* seed_rank,
                                const int* seed_sid, const int* pairs,
                                const int* interior, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(dy, 0, (size_t)n * sizeof(double),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  for (int q = 0; q < n_steps; ++q) {
    const long long* f = steps + 13 * (size_t)q;
    if (f[0] == K5_INTERIOR) {
      k5_interior_kernel<<<1, 1, 0, stream>>>(dy, interior + 3 * f[11],
                                              (int)f[12], sig_w);
    } else {
      K5Step s;
      s.kind = (int)f[0];
      s.a = a;
      s.n_out = (unsigned)f[1];
      s.n_src = (unsigned)f[2];
      s.src = f[3] >= 0 ? work + f[3] * n : nullptr;
      s.seed_rank = seed_rank + f[11];
      s.seed_sid = seed_sid + f[11];
      s.seed_len = (int)f[12];
      s.sig_w = sig_w;
      s.ratio = f[5] >= 0 ? rat + f[5] : nullptr;
      s.dst = f[4] >= 0 ? work + f[4] * n : nullptr;
      s.dy = f[6] ? dy : nullptr;
      s.lo = (unsigned)f[7];
      s.span = (unsigned)f[8];
      s.pairs = pairs + 2 * f[9];
      s.n_pairs = (int)f[10];
      k5_step_kernel<<<blocks(s.n_out), kThreads, 0, stream>>>(s);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
