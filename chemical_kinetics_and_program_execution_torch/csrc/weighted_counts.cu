// K13 `weighted_window_counts`: the weighted empirical SPD
// sum_b w[b] * counts_b / L of a batch of tapes, float64 bins.
//
// Replaces the JAX package's `engine/ensemble.py:2904
// weighted_window_counts` (an XLA program: the int32 rank by rolls, a
// float64 histogram a member by scatter-add, and a weighted sum; no
// Pallas kernel). Plain PyTorch version:
// `engine/ensemble.py:weighted_window_counts_plain`; `torch.bincount`
// with a weight a window computes the same sum in another order and
// serves only as a yardstick.
//
// Design: one launch of at most 256 blocks; block g takes members
// [g*per, (g+1)*per) in turn (`ensemble.k13_members_per_block`). For a
// member its threads count the row's windows into an int histogram by
// integer atomics (exact in any order), then, window by window again,
// the thread that takes a bin's count (an atomic exchange with 0, so
// the histogram is zero again for the next member) adds w[b] * count to
// the block's float64 partial of that bin. The histogram and partial
// are in shared memory up to kSharedBins bins (12 B a bin), else in the
// caller's scratch in device memory. The last block to finish (a
// `__threadfence` and an atomic ticket, as K6's norms and K9) adds each
// bin's partials in block order and divides by L: the order of
// `weighted_rule.cuh`, which the plain version repeats.
//
// Bound: bytes, the int32 tape read once (268 MB at B=16384, L=4096: 80
// us at 3.35 TB/s), the weights and the bins written once.

#include <cuda_runtime.h>

#include "weighted_rule.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBins = 16384;  // ensemble.py: _K13_SHARED_BINS

struct K13Args {
  const int* tape;
  const double* w;
  int B, L, size_a, cl_k, n_bins, per;
  double* partial;   // [blocks, n_bins]
  int* hist;         // [blocks, n_bins] zeros, or null: shared memory
  unsigned* ticket;  // 0 between launches
  double* out;
};

__global__ void __launch_bounds__(kThreads) k13_kernel(K13Args a) {
  extern __shared__ double smem[];
  __shared__ bool last;
  const bool shared = a.hist == nullptr;
  const int g = blockIdx.x;
  double* acc = shared ? smem : a.partial + (long long)g * a.n_bins;
  int* hist = shared ? reinterpret_cast<int*>(smem + a.n_bins)
                     : a.hist + (long long)g * a.n_bins;
  for (int x = threadIdx.x; x < a.n_bins; x += kThreads) {
    acc[x] = 0.0;
    if (shared) hist[x] = 0;
  }
  __syncthreads();
  const int end = (g + 1) * a.per < a.B ? (g + 1) * a.per : a.B;
  for (int b = g * a.per; b < end; ++b) {
    const int* row = a.tape + (long long)b * a.L;
    for (int i = threadIdx.x; i < a.L; i += kThreads) {
      const int bin =
          k13_window_bin(row, a.L, i, a.size_a, a.cl_k, a.n_bins);
      if (bin >= 0) atomicAdd(hist + bin, 1);
    }
    __syncthreads();
    const double wb = a.w[b];
    for (int i = threadIdx.x; i < a.L; i += kThreads) {
      const int bin =
          k13_window_bin(row, a.L, i, a.size_a, a.cl_k, a.n_bins);
      if (bin < 0) continue;
      const int c = atomicExch(hist + bin, 0);
      if (c) acc[bin] = acc[bin] + wb * (double)c;
    }
    __syncthreads();
  }
  if (shared)
    for (int x = threadIdx.x; x < a.n_bins; x += kThreads)
      a.partial[(long long)g * a.n_bins + x] = acc[x];
  __threadfence();  // the partials are visible before the ticket counts
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int x = threadIdx.x; x < a.n_bins; x += kThreads) {
    double s = 0.0;
    for (unsigned q = 0; q < gridDim.x; ++q)
      s = s + __ldcg(a.partial + (long long)q * a.n_bins + x);
    a.out[x] = s / (double)a.L;
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

}  // namespace

// out [size_a**cl_k] from the int32 tape [B, L] and the normalised
// float64 weights w [B], one launch of ceil(B / per) blocks on `stream`.
// partial holds blocks * n_bins doubles; hist is null when n_bins <=
// kSharedBins, else blocks * n_bins ints that are 0 (and are 0 again
// after the launch); ticket is an unsigned that is 0. Returns the launch
// error, or 0.
extern "C" int ckpe_weighted_counts(const int* tape, const double* w, int B,
                                    int L, int size_a, int cl_k, int per,
                                    double* partial, int* hist,
                                    unsigned* ticket, double* out,
                                    void* stream) {
  long long n = 1;
  for (int j = 0; j < cl_k; ++j) n *= size_a;
  if (B < 1 || L < 1 || per < 1 || cl_k < 1 || n >= (1LL << 31) ||
      (long long)B * L >= (1LL << 31) || (n > kSharedBins && !hist))
    return (int)cudaErrorInvalidValue;
  K13Args a = {tape,  w,       B,    L,      size_a, cl_k, (int)n,
               per,   partial, n > kSharedBins ? hist : nullptr,
               ticket, out};
  const int blocks = (B + per - 1) / per;
  size_t smem = 0;
  if (!a.hist) {
    smem = (size_t)n * (sizeof(double) + sizeof(int));
    const cudaError_t err = cudaFuncSetAttribute(
        k13_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k13_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
