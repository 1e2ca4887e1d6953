// K28 `metropolis`: steps of the conflict-masked Metropolis chains.
//
// Replaces the JAX package's `models/ferromagnet.py:95
// simulate_metropolis` (its scan over steps, `do_round` under
// `fori_loop`, `island_counts`; XLA, vmapped over chains by
// `mc_island_history` `:166`; no Pallas kernel). Plain PyTorch version:
// `models/ferromagnet.py:metropolis_plain`; the rule is
// `metropolis_rule.cuh`.
//
// One block of 512 threads a chain, which lives as bits in dynamic
// shared memory for the whole launch (a word a 32 sites: 6,252 bytes at
// the example's 50,000), beside a snapshot of it and two buffers of a
// step's draws. The warps take two roles.
//
// - The round warps run the step's rounds. Where rs <= 32 (the
//   example's 25) that is warp 0 alone, lane i trial i: it reads its
//   three sites from the round-start words and its bit of the round's
//   conflict mask, and XORs a surviving flip into its word
//   (`atomicXor`: two flips of a round may share a word, never a site),
//   with `__syncwarp` between reading and flipping: no block barrier in
//   a round. Past 32 trials ceil(rs / 32) warps, at most 8, each thread
//   its trials in turn, against every earlier trial of the round
//   (`mc_trial`), a named barrier between the phases.
// - The other warps, while the rounds run step t, copy step t + 1's
//   sites and uniforms into the other draw buffer (`cp.async`, 4 and 8
//   bytes a copy: any alignment), count the islands of the snapshot of
//   step t - 1, a thread a word (`mc_count_word`: the starts of
//   exact-length up-runs as masks, `__popc`), a warp's sum by
//   `__reduce_add_sync`, the warps' by shared atomics (integers: any
//   order gives the same counts; rings below 64 sites by
//   `mc_island_site`, a site a thread), and then form step t + 1's
//   conflict masks (rs <= 32), a warp a round: the earlier lanes within
//   circular distance 1 by `__match_any_sync` on the two keys of
//   `mc_conflict_mask` and two ballots.
//
// At the end of a step one barrier; every thread copies the words into
// the snapshot; a second barrier. Bound: bytes (each trial's int32 site
// and float64 uniform read once, the chains read and written once, the
// counts written). What remains is the rounds' serial latency: a round
// is a few dependent shared-memory reads and a flip. At
// 100 chains the grid is one partial wave on 132 SMs.

#include <cuda_runtime.h>

#include "metropolis_rule.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRoundWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

// The dynamic shared memory of a launch, in bytes from its start: the
// words, the snapshot, the two buffers of a step's sites and uniforms,
// then (rs <= 32) two buffers of a step's conflict masks, a word a
// round, or (rs > 32) a flag a trial. `models/ferromagnet.py:k28_bytes`
// is its twin.
struct McLayout {
  size_t words, snap, sites, u, flag, bytes;
};

__host__ __device__ inline size_t mc_up16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

__host__ __device__ inline McLayout mc_layout(int N, int rounds, int rs) {
  const size_t W = ((size_t)N + 31) >> 5, T = (size_t)rounds * rs;
  McLayout l;
  l.words = 0;
  l.snap = mc_up16(4 * W);
  l.sites = l.snap + mc_up16(4 * W);
  l.u = l.sites + mc_up16(2 * 4 * T);
  l.flag = l.u + 2 * 8 * T;  // the masks where rs <= 32
  l.bytes = l.flag + (rs > 32 ? mc_up16((size_t)rs)
                              : mc_up16(2 * 4 * (size_t)rounds));
  return l;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A barrier over the first (id 2: the round warps) or the last (id 1:
// the counting warps) ``threads`` threads of the block.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The round warp's lanes within circular distance 1 of this lane's site
// and before it (rs <= 32): `mc_conflict_mask`'s keys by matches.
__device__ __forceinline__ unsigned mc_conflict_warp(int s, bool act, int N,
                                                     int lane) {
  unsigned m = __match_any_sync(kFull, mc_key0(s)) |
               __match_any_sync(kFull, mc_key1(s));
  const unsigned lo = __ballot_sync(kFull, act && s == 0);
  const unsigned hi = __ballot_sync(kFull, act && s == N - 1);
  if (s == 0) m |= hi;
  if (s == N - 1) m |= lo;
  return m & __ballot_sync(kFull, act) & ((1u << lane) - 1u);
}

// A step's conflict masks (rs <= 32), a warp a round from ``warp0`` in
// steps of ``warps``: bit i of mask[r] set where trial i of round r lies
// within circular distance 1 of an earlier trial of the round. They
// depend on the sites alone, so they are formed off the rounds' path.
// An idle lane's key lies below every site.
__device__ __forceinline__ void k28_masks(const int* bs, unsigned* mask,
                                          const McArgs& a, int warp0,
                                          int warps) {
  const int lane = threadIdx.x & 31;
  const bool act = lane < a.rs;
  for (int r = warp0; r < a.rounds; r += warps) {
    const int s = act ? bs[r * a.rs + lane] : -4 * (lane + 1);
    const unsigned hit = __ballot_sync(kFull,
                                       mc_conflict_warp(s, act, a.N, lane));
    if (lane == 0) mask[r] = hit;
  }
}

// One step's rounds on warp 0, a lane a trial (rs <= 32), the conflicts
// read from the step's masks: a round's dependent path is its three
// reads of the round-start words, the threshold and the flip.
__device__ __forceinline__ void k28_rounds_warp(uint32_t* words,
                                                const int* bs,
                                                const double* bu,
                                                const unsigned* mask,
                                                const McArgs& a) {
  const int lane = threadIdx.x & 31;
  const McBits c{words};
  const bool act = lane < a.rs;
  for (int r = 0; r < a.rounds; ++r) {
    const int q = r * a.rs + lane;
    const int s = act ? bs[q] : 0;
    const bool ok =
        act && !((mask[r] >> lane) & 1u) && mc_accept(c, s, bu[q], a);
    __syncwarp();  // every lane has read the round-start words
    if (ok) atomicXor(&words[s >> 5], 1u << (s & 31));
    __syncwarp();
  }
}

// One step's rounds on the first ``threads`` threads (rs > 32): each its
// trials t, t + threads, ... against every earlier trial of the round.
__device__ __forceinline__ void k28_rounds_wide(uint32_t* words,
                                                const int* bs,
                                                const double* bu,
                                                unsigned char* flag,
                                                const McArgs& a,
                                                int threads) {
  const McBits c{words};
  for (int r = 0; r < a.rounds; ++r) {
    const int* rsites = bs + r * a.rs;
    for (int i = threadIdx.x; i < a.rs; i += threads)
      flag[i] = mc_trial(c, rsites, i, bu[r * a.rs + i], a) ? 1 : 0;
    named_barrier(2, threads);
    for (int i = threadIdx.x; i < a.rs; i += threads)
      if (flag[i]) atomicXor(&words[rsites[i] >> 5], 1u << (rsites[i] & 31));
    named_barrier(2, threads);
  }
}

// The counting warps' count of the snapshot into out[0..5]: ``ct`` this
// thread's index among the ``threads`` counting threads.
__device__ __forceinline__ void k28_count(const uint32_t* snap, int N,
                                          int ct, int threads, int* tot,
                                          int* out) {
  int cnt[kMcCols] = {0, 0, 0, 0, 0, 0};
  if (N >= 64) {
    const int W = (N + 31) >> 5;
    for (int wd = ct; wd < W; wd += threads) mc_count_word(snap, N, wd, cnt);
  } else {
    const McBits c{snap};
    for (int i = ct; i < N; i += threads) mc_island_site(c, N, i, cnt);
  }
#pragma unroll
  for (int L = 1; L < kMcCols; ++L) {
    const int v = __reduce_add_sync(kFull, cnt[L]);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(&tot[L], v);
  }
  named_barrier(1, threads);
  if (ct == 0) {
    out[0] = 0;
    for (int L = 1; L < kMcCols; ++L) {
      out[L] = tot[L];
      tot[L] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    k28_kernel(McArgs a, int* chains, const int* __restrict__ sites,
               const double* __restrict__ u, int steps, int count_first,
               int* counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tot[kMcCols];
  __shared__ McArgs sa;  // the thresholds where the rounds read them
  const int N = a.N, rs = a.rs, W = (N + 31) >> 5;
  const int T = a.rounds * rs;
  const McLayout lay = mc_layout(N, a.rounds, rs);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + lay.words);
  uint32_t* snap = reinterpret_cast<uint32_t*>(smem + lay.snap);
  int* bs = reinterpret_cast<int*>(smem + lay.sites);
  double* bu = reinterpret_cast<double*>(smem + lay.u);
  unsigned char* flag = smem + lay.flag;
  unsigned* mask = reinterpret_cast<unsigned*>(smem + lay.flag);
  const long long ch = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rwarps =
      rs <= 32 ? 1 : min((rs + 31) >> 5, kMaxRoundWarps);
  const bool rounder = warp < rwarps;
  const int cthreads = kThreads - 32 * rwarps;
  const int ct = threadIdx.x - 32 * rwarps;  // among the counting threads
  const int* csites = sites + ch * (long long)steps * T;
  const double* cu = u + ch * (long long)steps * T;
  // The chain as bits (into the snapshot too, for count_first), step 0's
  // draws, the totals.
  for (int base = threadIdx.x - lane; base < N; base += kThreads) {
    const int i = base + lane;
    const unsigned word =
        __ballot_sync(kFull, i < N && chains[ch * N + i] != 0);
    if (lane == 0) words[base >> 5] = snap[base >> 5] = word;
  }
  if (steps > 0)
    for (int i = threadIdx.x; i < T; i += kThreads) {
      bs[i] = csites[i];
      bu[i] = cu[i];
    }
  if (threadIdx.x < kMcCols) tot[threadIdx.x] = 0;
  if (threadIdx.x == 0) sa = a;
  __syncthreads();
  if (rs <= 32 && steps > 0) {
    k28_masks(bs, mask, sa, warp, kThreads / 32);
    __syncthreads();
  }
  int* out = counts + ch * (long long)(steps + count_first) * kMcCols;
  bool pending = count_first != 0;  // a snapshot not counted yet
  int row = 0;
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    if (rounder) {
      if (rs <= 32)
        k28_rounds_warp(words, bs + buf * T, bu + buf * T,
                        mask + buf * a.rounds, sa);
      else
        k28_rounds_wide(words, bs + buf * T, bu + buf * T, flag, sa,
                        32 * rwarps);
    } else {
      if (st + 1 < steps) {
        const long long next = (long long)(st + 1) * T;
        for (int i = ct; i < T; i += cthreads) {
          cp_async(bs + (buf ^ 1) * T + i, csites + next + i, 4);
          cp_async(bu + (buf ^ 1) * T + i, cu + next + i, 8);
        }
      }
      if (pending) k28_count(snap, N, ct, cthreads, tot, out + row * kMcCols);
      cp_async_wait_all();
      if (rs <= 32 && st + 1 < steps) {
        named_barrier(1, cthreads);  // the next step's draws are in
        k28_masks(bs + (buf ^ 1) * T, mask + (buf ^ 1) * a.rounds, sa,
                  warp - rwarps, kThreads / 32 - rwarps);
      }
    }
    __syncthreads();  // the step's flips, the count and the copies done
    for (int i = threadIdx.x; i < W; i += kThreads) snap[i] = words[i];
    pending = true;
    row = st + count_first;
    __syncthreads();
  }
  if (!rounder && pending)
    k28_count(snap, N, ct, cthreads, tot, out + row * kMcCols);
  for (int i = threadIdx.x; i < N; i += kThreads)
    chains[ch * N + i] = (int)((words[i >> 5] >> (i & 31)) & 1u);
}

}  // namespace

// The dynamic shared memory K28 takes for a chain of N sites and steps of
// ``rounds`` rounds of ``rs`` trials (`mc_layout`).
extern "C" long long ckpe_metropolis_bytes(int N, int rounds, int rs) {
  return (long long)mc_layout(N, rounds, rs).bytes;
}

// ``steps`` steps of T chains (``chains`` [T, N] int32 of 0/1, advanced
// in place) on draws ``sites`` [T, steps, rounds, rs] int32 in [0, N) and
// ``u`` [T, steps, rounds, rs] float64, thresholds ``thr`` [6] (host);
// ``counts`` [T, steps + count_first, 6] int32, the chains before the
// first step first when ``count_first``. The caller checks that the
// layout fits a block (`models/ferromagnet.py:k28_bytes`).
extern "C" int ckpe_metropolis(int T, int N, int rounds, int rs,
                               const double* thr, int* chains,
                               const int* sites, const double* u, int steps,
                               int count_first, int* counts,
                               cudaStream_t stream) {
  if (T < 1 || N < 1 || rounds < 0 || rs < 1 || steps < 0)
    return (int)cudaErrorInvalidValue;
  McArgs a;
  a.N = N;
  a.rounds = rounds;
  a.rs = rs;
  for (int q = 0; q < 6; ++q) a.thr[q] = thr[q];
  const size_t bytes = mc_layout(N, rounds, rs).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      k28_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  k28_kernel<<<(unsigned)T, kThreads, bytes, stream>>>(
      a, chains, sites, u, steps, count_first ? 1 : 0, counts);
  return (int)cudaGetLastError();
}
