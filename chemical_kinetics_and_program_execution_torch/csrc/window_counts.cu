// K2: histogram of every circular length-cl_k window of a batch of tapes.
//
// Replaces the JAX package's `engine/ensemble.py:window_counts` (a
// rank computation by rolls plus a scatter-add). Plain PyTorch version:
// `engine/ensemble.py:window_counts_plain`; `torch.bincount` on the
// bins of `window_bins` computes the same counts and serves only as a
// yardstick.
//
// For site (b, i): rank = sum_j tape[b, (i+j) mod L] * A^(cl_k-1-j) as
// the reference's int32 sum, and counts[bin] += 1 (int64), the bin by
// the reference's rule (`window_rule.cuh`). The counts are integers, so
// the result does not depend on the order of the additions.
//
// Bound. The tape is read once: 4 B a site, 268 MB at B=16384, L=4096,
// plus 8 B a bin written, which is 80 us at the H100's 3.35 TB/s; the
// bound is bytes. What this design does about it:
//
// - No division or modulo a site. A warp takes a run of kRun sites of
//   one row at a time (row and column computed once a run), stages the
//   run's symbols in shared memory with 16-byte loads coalesced across
//   the warp, plus the cl_k - 1 symbols that follow it (wrapping to the
//   row's start), and forms each site's rank from there. The next run's
//   loads are in flight while a run is counted. A persistent grid,
//   sized by the occupancy of the SMs, walks the runs.
// - Counts that tolerate skew. Each block keeps a private uint32
//   histogram in shared memory; where the bins fit, one copy for each
//   lane, laid out so that lane l always hits bank l: a warp's 32
//   increments then never collide, even when every window falls in one
//   bin. The copies are summed and added to the int64 counts once at
//   the block's end.
// - Many bins. The histogram takes up to the block's opt-in shared
//   memory beside the staged runs (227 KB on the H100: some 50,000 bins
//   with one copy); above that the same kernel adds each window to the
//   int64 counts in device memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "window_rule.cuh"

namespace {

constexpr int kThreads = 256;            // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 1024;               // sites a warp stages at a time
constexpr int kVecs = kRun / 128;        // int4 loads a lane a run
constexpr int kMaxCopies = 32;           // one histogram copy a lane
constexpr int kCopiesBytes = 48 * 1024;  // room for the copies

// Symbols a warp stages for a run: kRun sites and the cl_k - 1 after
// them, rounded up to whole int4s.
__host__ __device__ int staged(int cl_k) {
  return (kRun + cl_k - 1 + 3) & ~3;
}

// K > 0: cl_k is K, known when compiled; K == 0: cl_k at run time.
template <int K>
__global__ void __launch_bounds__(kThreads)
window_counts_kernel(const int* __restrict__ tape, long long B, int L,
                     int size_a, int cl_k_runtime, int n_bins, int copies,
                     bool shared_hist, bool vec,
                     unsigned long long* __restrict__ counts) {
  extern __shared__ int4 smem[];
  const int cl_k = K > 0 ? K : cl_k_runtime;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* run = reinterpret_cast<int*>(smem) + warp * staged(cl_k);
  unsigned int* hist =
      reinterpret_cast<unsigned int*>(smem) + kWarps * staged(cl_k);
  const int n_cells = n_bins * copies;
  if (shared_hist) {
    for (int k = threadIdx.x; k < n_cells; k += kThreads) hist[k] = 0u;
    __syncthreads();
  }
  const int lane_copy = lane & (copies - 1);
  const int runs_per_row = (L + kRun - 1) / kRun;
  const long long n_runs = B * runs_per_row;
  const long long step = (long long)gridDim.x * kWarps;
  // A run's place in the tape: its row, first column and sites.
  auto locate = [&](long long w, long long& row, int& start, int& n) {
    row = w / runs_per_row;
    start = (int)(w - row * runs_per_row) * kRun;
    n = min(kRun, L - start);
  };
  // The next run's symbols, loaded while this one is counted (vec only:
  // L % 4 == 0 and the tape 16-byte aligned).
  int4 v[kVecs];
  auto fetch = [&](long long w) {
    long long row;
    int start, n;
    locate(w, row, start, n);
    const int* src = tape + row * L + start;
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int k = (lane + 32 * u) * 4;
      if (k < n) v[u] = __ldg(reinterpret_cast<const int4*>(src + k));
    }
  };
  long long w = (long long)blockIdx.x * kWarps + warp;
  if (vec && w < n_runs) fetch(w);
  for (; w < n_runs; w += step) {
    long long row;
    int start, n;
    locate(w, row, start, n);
    if (vec) {
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int k = (lane + 32 * u) * 4;
        if (k < n) *reinterpret_cast<int4*>(run + k) = v[u];
      }
    } else {
      const int* src = tape + row * L + start;
      for (int k = lane; k < n; k += 32) run[k] = __ldg(src + k);
    }
    for (int k = lane; k < cl_k - 1; k += 32)
      run[n + k] = __ldg(tape + row * L + (start + n + k) % L);
    __syncwarp();
    if (vec && w + step < n_runs) fetch(w + step);
    for (int i = lane; i < n; i += 32) {
      unsigned int rank = 0;
#pragma unroll
      for (int j = 0; j < cl_k; ++j)
        rank = k2_rank_step(rank, size_a, run[i + j]);
      const int bin = k2_bin(rank, n_bins);
      if (bin < 0) continue;
      if (shared_hist)
        atomicAdd(&hist[bin * copies + lane_copy], 1u);
      else
        atomicAdd(&counts[bin], 1ull);
    }
    __syncwarp();
  }
  if (shared_hist) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += kThreads) {
      unsigned int sum = 0;
      for (int c = 0; c < copies; ++c) sum += hist[b * copies + c];
      if (sum) atomicAdd(&counts[b], (unsigned long long)sum);
    }
  }
}

template <int K>
cudaError_t launch(const int* tape, long long B, int L, int size_a,
                   int cl_k, int n_bins, unsigned long long* counts,
                   cudaStream_t stream) {
  int device = 0, n_sm = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  // As many copies of the histogram as fit kCopiesBytes, at least one;
  // the histogram stays in shared memory while one copy fits beside the
  // staged runs.
  int copies = kMaxCopies;
  while (copies > 1 && (long long)n_bins * copies * 4 > kCopiesBytes)
    copies >>= 1;
  const size_t stage_bytes = (size_t)kWarps * staged(cl_k) * sizeof(int);
  const size_t hist_bytes = (size_t)n_bins * copies * sizeof(unsigned int);
  const bool shared_hist = stage_bytes + hist_bytes <= (size_t)max_smem;
  const size_t smem = stage_bytes + (shared_hist ? hist_bytes : 0);
  auto kernel = window_counts_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  // One wave of blocks that stay resident, no more than there are runs;
  // every block sees fewer than 2^31 sites, so its uint32 bins cannot
  // wrap.
  const long long n_runs = B * ((L + kRun - 1) / kRun);
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * n_sm;
  const long long needed = (n_runs + kWarps - 1) / kWarps;
  if (blocks > needed) blocks = needed;
  const long long floor_blocks = B * L / (1LL << 31) + 1;
  if (blocks < floor_blocks) blocks = floor_blocks;
  const bool vec =
      L % 4 == 0 && (reinterpret_cast<uintptr_t>(tape) & 15) == 0;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      tape, B, L, size_a, cl_k, n_bins, copies, shared_hist, vec, counts);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ckpe_window_counts(const void* tape, long long B, int L,
                                  int size_a, int cl_k, void* counts,
                                  void* stream) {
  if (cl_k < 1 || L < 1 || size_a < 1) return (int)cudaErrorInvalidValue;
  long long n_bins = 1;
  for (int j = 0; j < cl_k; ++j)
    if ((n_bins *= size_a) >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const int* t = static_cast<const int*>(tape);
  auto* c = static_cast<unsigned long long*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  const int n = (int)n_bins;
  switch (cl_k) {
    case 1: return (int)launch<1>(t, B, L, size_a, cl_k, n, c, s);
    case 2: return (int)launch<2>(t, B, L, size_a, cl_k, n, c, s);
    case 3: return (int)launch<3>(t, B, L, size_a, cl_k, n, c, s);
    case 4: return (int)launch<4>(t, B, L, size_a, cl_k, n, c, s);
    case 5: return (int)launch<5>(t, B, L, size_a, cl_k, n, c, s);
    case 6: return (int)launch<6>(t, B, L, size_a, cl_k, n, c, s);
    default: return (int)launch<0>(t, B, L, size_a, cl_k, n, c, s);
  }
}

extern "C" const char* ckpe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
