// K2: histogram of every circular length-cl_k window of a batch of tapes.
//
// Replaces the JAX package's `engine/ensemble.py:window_counts` (a
// rank computation by rolls plus a scatter-add). Plain PyTorch version:
// `engine/ensemble.py:window_counts_plain`; `torch.bincount` on the flat
// ranks computes the same counts and serves only as a yardstick.
//
// For site (b, i): rank = sum_j tape[b, (i+j) mod L] * A^(cl_k-1-j), and
// counts[rank] += 1 (int64). Ranks outside [0, A^cl_k) are dropped, as
// the reference's scatter drops them. The counts are integers, so the
// result does not depend on the order of the additions.
//
// Bound. The tape is read once: 4 B a site, 268 MB at B=16384, L=4096,
// which is 80 us at the H100's 3.35 TB/s; the bound is bytes. What this
// design does about it: each block keeps a private 32-bit histogram in
// shared memory (when A^cl_k bins fit in 48 KB) and adds it to the
// global int64 counts once at the end, so device memory sees one atomic
// per bin per block instead of one per site; the window's other
// cl_k - 1 reads hit the lines its neighbours just loaded.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBins = 12288;  // 48 KB of uint32

__global__ void window_counts_kernel(const int* __restrict__ tape,
                                     long long n_sites, int L, int size_a,
                                     int cl_k, int n_bins,
                                     unsigned long long* __restrict__ counts,
                                     bool shared_hist) {
  extern __shared__ unsigned int hist[];
  if (shared_hist) {
    for (int k = threadIdx.x; k < n_bins; k += blockDim.x) hist[k] = 0u;
    __syncthreads();
  }
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_sites; t += step) {
    const long long row = t / L;
    const int i = (int)(t - row * L);
    const int* r = tape + row * L;
    long long rank = 0;
    for (int j = 0; j < cl_k; ++j) rank = rank * size_a + r[(i + j) % L];
    if (rank < 0 || rank >= n_bins) continue;
    if (shared_hist)
      atomicAdd(&hist[rank], 1u);
    else
      atomicAdd(&counts[rank], 1ull);
  }
  if (shared_hist) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_bins; k += blockDim.x)
      if (hist[k]) atomicAdd(&counts[k], (unsigned long long)hist[k]);
  }
}

}  // namespace

extern "C" int ckpe_window_counts(const void* tape, long long B, int L,
                                  int size_a, int cl_k, void* counts,
                                  void* stream) {
  long long n_bins = 1;
  for (int j = 0; j < cl_k; ++j) n_bins *= size_a;
  const long long n_sites = B * L;
  if (n_sites == 0) return (int)cudaGetLastError();
  const int threads = 256;
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  // Enough blocks to fill the card, few enough that each block's shared
  // histogram is flushed once per many sites; every block sees fewer
  // than 2^32 sites, so its 32-bit bins cannot wrap.
  long long blocks = (n_sites + threads - 1) / threads;
  long long cap = 16LL * (n_sm > 0 ? n_sm : 132);
  long long floor_blocks = n_sites / (1LL << 31) + 1;
  if (blocks > cap) blocks = cap > floor_blocks ? cap : floor_blocks;
  const bool shared_hist = n_bins <= kMaxSharedBins;
  const size_t smem = shared_hist ? (size_t)n_bins * sizeof(unsigned int) : 0;
  window_counts_kernel<<<(unsigned)blocks, threads, smem,
                         (cudaStream_t)stream>>>(
      (const int*)tape, n_sites, L, size_a, cl_k, (int)n_bins,
      (unsigned long long*)counts, shared_hist);
  return (int)cudaGetLastError();
}

extern "C" const char* ckpe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
