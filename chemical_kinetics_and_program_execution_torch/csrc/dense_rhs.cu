// K3, K4 and K5: the exact SPD closure's dense dp/dt on the card, and
// K25, its J.v.
//
// They replace the jitted XLA program of the JAX package's
// `engine/dense.py:dy_dt_dense` (the JAX package has no Pallas kernel on
// this path). Plain PyTorch versions: `engine/dense.py` `pyramid_plain`,
// `signature_weights_plain`, `sweep_plain`. Every sum is taken in a fixed
// order and no float atomic is used, so two runs give the same bits;
// built with `-fmad=false` (no contraction of a product into a sum), so
// each element's arithmetic is the plain version's. `ckpe_dense_rhs`
// runs K3 -> K5 from one host call: K3's one or two launches, then K5's
// one, whose phase 0 is K4.
//
// K3 `pyramid` (`dense.py:423 _levels`; `markov.py:194 pyramid`). The
// levels below p, [lv[k-1], ..., lv[0], 1]; p itself is not copied (K4
// and K5 read it as level k). A block stages a tile of A^m entries of p
// in shared memory with 16-byte loads and writes every level inside its
// tile (levels k-1 .. k-m); where m < k, one single-block launch finishes
// levels k-m-1 .. 0. Each entry sums its A children in digit order, as
// the plain version does. No ratio table is written: K5 forms each ratio
// where it needs one. Bound: bytes, p read once and about A^k / (A - 1)
// doubles written once. A dual program's RHS runs it on each tape, into
// the tape's block of ``low``; the gather engine (`gather_rhs.cu`) reads
// it too.
//
// K4 `signature_weights` (`dense.py:464-468`: `markov.py:189
// guarded_ratio_prod`, then `segment_sum`) is K5's phase 0, before its
// first grid barrier: a warp a signature, grid-stride. The signature's
// pairs lie in CSR order, each with its world's chain indices and
// w_const (built on the host once a program); lane l forms the weight of
// pairs l, l + 32, ... (`sweep_rule.cuh:k4_pair_weight`: the chain's
// guarded ratios multiplied in chain order, their loads issued four
// at a time), and the warp adds them from 0.0 in pair order by
// shuffles, the plain version's order. The pyramid is read as p below
// index A^k and K3's levels above. Tens to thousands of worlds: a
// launch of its own cost a launch and its place in the chain K3 -> K4
// -> K5, not bytes; as a phase it costs one grid barrier and a few
// dependent loads (a thread walking a signature's 12 pairs in turn took
// 13 µs more at cl_k 5). A world that serves several signatures (ex4's
// serve two each) is formed again for each: one code path for every
// program, where per-block copies of the world weights in shared memory
// would not fit beside K5's staging for the largest (ex6-mini-bff-lite:
// 11,520 worlds, 4,536 signatures).
//
// K5 `sweep` (`dense.py:310 _apply_group`). One cooperative launch for
// the whole sweep of every group: phase 0 (K4's signature weights into
// the launch's own ``s``), then the plan's phases in turn, a grid
// barrier (`cooperative_groups`' grid sync, its state the launch's own)
// before each; the first of them also zeroes dy. A phase's items (`sweep_rule.cuh`) run side
// by side, a thread an element in a grid-stride loop: compute items form
// a step's vector over its live windows only (a step's A^k D / span
// windows, not A^k), reading the previous step's vector or the group's
// seed and forming each ratio from the pyramid; EMIT items read and
// write dy only at the step's target windows. The plan puts two
// emissions that share a window in two phases (a greedy colouring of
// their conflicts), so each dy window takes its terms in phase order and
// two threads of a phase never write one element. Vectors written in
// one phase are read in a later one through L2 (`__ldcg`); the signature
// weights, which no block reads before the barrier after phase 0, by
// plain loads. A block unpacks a phase's items into shared memory, with
// host-made multipliers for their divisors. A dual program's items name
// their tape by two offsets (`sweep_rule.cuh:F_POFF`): no branch on the
// tape in the loop. Bound: bytes, dy written
// once and each distinct entry of p and lv[k-1] that the live windows
// need read once, with the signature weights and the plan. Steps whose
// run is the trailing digits (lo = 1) read p and dy at scattered
// windows, a 32-byte sector for few of them (`chip_smoke.py:
// k5_sector_bytes` models that traffic); at cl_k 5 the phases' barriers
// and small items, not bytes, set the time.
//
// K25 `dense_jvp` (`dense.py:dense_jvp`; plain `dense_jvp_plain`)
// replaces `jax.jvp` of the JAX package's `engine/dense.py:441
// dy_dt_dense`, which the Newton-Krylov steady states
// (`ode/steady.py:347,525`) and the stiff stepper's Newton systems
// (`ode/kvaerno3.py:79`) call (XLA; no Pallas kernel). It is K5's kernel
// on pairs (`sweep_rule.cuh`'s rule with T = K25Dual): the same plan,
// phases and barriers, its phase 0 K4's weights with their tangents,
// every compact vector a (value, tangent) pair. It reads p and K3's
// levels of p (which the RHS call before it saved), v and K3's levels
// of v (`ckpe_dense_jvp_rhs` launches K3 on v first), and writes dy's
// tangent, and dy itself where asked (the forward-mode dual call: K5's
// bits, from the same values, in one launch where an RHS and a J.v would
// take two). Bound: bytes, as K5's, with p, v and their top levels read
// and pair-valued weights; the work buffer of pairs is twice K5's and a
// product of pairs three products and a sum.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sweep_rule.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTileThreads = 512;
constexpr int kFinishThreads = 1024;
constexpr int kStaged = 32;  // K5 items unpacked into shared memory at once
// K5 keeps 4 blocks an SM (64 registers a thread): at cl_k 7-8 its grid
// is what fits, and phase 0's code at 66 registers left room for 3.
constexpr int kK5BlocksPerSm = 4;

struct K3Levels {
  int a, k, m;
  unsigned lv_off[kMaxK + 1];  // level j < k at low + lv_off[j]
  unsigned pw[kMaxK + 1];      // A^j
  unsigned one_slot;
};

// K3, first launch: block b sums the tile p[b A^m, (b + 1) A^m) into its
// share of levels k-1 .. k-m.
__global__ void __launch_bounds__(kTileThreads)
k3_tile_kernel(const double* __restrict__ p, double* __restrict__ low,
               K3Levels lv) {
  extern __shared__ double sm[];
  const unsigned tile = lv.pw[lv.m];
  const double* src = p + (size_t)blockIdx.x * tile;
  // Stage the tile: one lead double up to a 16-byte boundary, then
  // 16-byte loads, then the tail.
  const unsigned head = ((size_t)src & 15) ? 1u : 0u;
  const unsigned pairs = (tile - head) / 2;
  if (head && threadIdx.x == 0) sm[0] = src[0];
  const double2* src2 = reinterpret_cast<const double2*>(src + head);
  for (unsigned q = threadIdx.x; q < pairs; q += blockDim.x) {
    const double2 v = src2[q];
    sm[head + 2 * q] = v.x;
    sm[head + 2 * q + 1] = v.y;
  }
  const unsigned tail = head + 2 * pairs;
  if (tail < tile && threadIdx.x == 0) sm[tail] = src[tail];
  __syncthreads();
  const unsigned a = (unsigned)lv.a;
  double* cur = sm;
  unsigned size = tile;
  for (int i = 1; i <= lv.m; ++i) {
    const unsigned out = size / a;
    double* nxt = cur + size;
    double* dst = low + lv.lv_off[lv.k - i] + (size_t)blockIdx.x * out;
    for (unsigned o = threadIdx.x; o < out; o += blockDim.x) {
      const double* ch = cur + (size_t)o * a;
      double acc = ch[0];
      for (unsigned d = 1; d < a; ++d) acc = acc + ch[d];
      nxt[o] = acc;
      dst[o] = acc;
    }
    __syncthreads();
    cur = nxt;
    size = out;
  }
  if (lv.m == lv.k && threadIdx.x == 0) low[lv.one_slot] = 1.0;
}

// K3, second launch (m < k): levels k-m-1 .. 0 in one block.
__global__ void __launch_bounds__(kFinishThreads)
k3_finish_kernel(double* __restrict__ low, K3Levels lv) {
  const unsigned a = (unsigned)lv.a;
  for (int j = lv.k - lv.m - 1; j >= 0; --j) {
    const double* src = low + lv.lv_off[j + 1];
    double* dst = low + lv.lv_off[j];
    for (unsigned o = threadIdx.x; o < lv.pw[j]; o += blockDim.x) {
      const double* ch = src + (size_t)o * a;
      double acc = ch[0];
      for (unsigned d = 1; d < a; ++d) acc = acc + ch[d];
      dst[o] = acc;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) low[lv.one_slot] = 1.0;
}

template <class T>
struct K5Launch {
  K5CtxT<T> ctx;
  K4Pairs pairs;
  T* s;  // the signature weights, phase 0's output (ctx.s)
  int n_sig;
  const long long* items;
  const long long* phase_ptr;
  int n_phases;
  unsigned n;  // A^k
};

// K5: phase 0 (K4), then every phase of the sweep, in one cooperative
// launch. A block unpacks up to kStaged of a phase's items (fields and
// divisors) into shared memory at a time, then takes their elements
// grid-stride. kDual: a dual program's plan, whose items read their
// tapes' offsets (`sweep_rule.cuh`). T: double for K5, K25Dual for K25.
template <bool kDual, class T>
__global__ void __launch_bounds__(kThreads, kK5BlocksPerSm)
k5_sweep_kernel(K5Launch<T> L) {
  __shared__ K5Item staged[kStaged];
  const unsigned stride = gridDim.x * kThreads;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  k4_warp_weights(L.ctx, L.pairs, L.s, L.n_sig, tid, stride);
  for (int ph = 0; ph < L.n_phases; ++ph) {
    cg::this_grid().sync();
    if (ph == 0)  // no item of the first phase touches dy
      for (unsigned x = tid; x < L.n; x += stride) k5_dy_set(L.ctx, x, T());
    const long long end = L.phase_ptr[ph + 1];
    for (long long first = L.phase_ptr[ph]; first < end;
         first += kStaged) {
      const int count = (int)(end - first < kStaged ? end - first : kStaged);
      __syncthreads();  // the previous chunk's elements are done
      for (int q = threadIdx.x; q < count; q += kThreads) {
        K5Item it = k5_item(L.items + (first + q) * K5_FIELDS, L.ctx);
        if (!kDual) it.poff = it.loff = 0;  // a single tape's: not read
        staged[q] = it;
      }
      __syncthreads();
      const long long base = staged[0].start;
      const unsigned total =
          (unsigned)(staged[count - 1].start + staged[count - 1].n - base);
      for (unsigned x = tid; x < total; x += stride) {
        int lo = 0, hi = count - 1;  // the last item starting <= x
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (staged[mid].start - base <= (long long)x)
            lo = mid;
          else
            hi = mid - 1;
        }
        k5_element<kDual>(L.ctx, staged[lo],
                          (unsigned)(x - (staged[lo].start - base)));
      }
    }
  }
}

K3Levels k3_levels(int a, int k, int m) {
  K3Levels lv;
  lv.a = a;
  lv.k = k;
  lv.m = m;
  unsigned size = 1;
  for (int j = 0; j <= k; ++j) {
    lv.pw[j] = size;
    size *= (unsigned)a;
  }
  unsigned pos = 0;
  for (int j = k - 1; j >= 0; --j) {
    lv.lv_off[j] = pos;
    pos += lv.pw[j];
  }
  lv.one_slot = pos;
  return lv;
}

// The most blocks of k5_sweep_kernel<kDual, T> that fit on the card at
// once.
template <bool kDual, class T>
int k5_resident_blocks() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (!cached[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, k5_sweep_kernel<kDual, T>, kThreads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

// K5's or K25's one cooperative launch, its grid sized to about four
// elements a thread in the largest phase (a lane each for a signature's
// pairs in phase 0), at most what fits.
template <class T>
int k5_launch(K5Launch<T>& L, long long max_phase, cudaStream_t stream) {
  const bool dual = L.ctx.n_state != L.ctx.pw[L.ctx.k];  // [program | data]
  const int resident = dual ? k5_resident_blocks<true, T>()
                            : k5_resident_blocks<false, T>();
  if (resident <= 0) return (int)cudaErrorLaunchFailure;
  const long long most =
      max_phase > 32LL * L.n_sig ? max_phase : 32LL * L.n_sig;
  long long want = (most + 4 * kThreads - 1) / (4 * kThreads);
  const int grid = (int)(want < 1 ? 1 : want > resident ? resident : want);
  void* args[] = {&L};
  const void* kernel = dual ? (const void*)k5_sweep_kernel<true, T>
                            : (const void*)k5_sweep_kernel<false, T>;
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch's plan, pairs and pyramid (K5's and K25's arguments alike).
template <class T>
K5Launch<T> k5_args(const long long* items, const long long* phase_ptr,
                    int n_phases, const int* table, T* work, double* dy,
                    long long n, const double* p, const double* low,
                    const int* pair_num, const int* pair_den,
                    const double* pair_const, int chain, const int* csr_ptr,
                    int n_sig, T* s, int a, int k) {
  K5Launch<T> L = {};
  L.ctx.a = a;
  L.ctx.k = k;
  L.ctx.p = p;
  L.ctx.low = low;
  L.ctx.s = s;
  L.ctx.table = table;
  L.ctx.work = work;
  L.ctx.dy = dy;
  k5_levels(L.ctx);
  L.ctx.n_state = (unsigned)n;
  L.pairs.num = pair_num;
  L.pairs.den = pair_den;
  L.pairs.w_const = pair_const;
  L.pairs.csr_ptr = csr_ptr;
  L.pairs.chain = chain;
  L.s = s;
  L.n_sig = n_sig;
  L.items = items;
  L.phase_ptr = phase_ptr;
  L.n_phases = n_phases;
  L.n = (unsigned)n;
  return L;
}

}  // namespace

// K3. ``low`` holds (A^k - 1) / (A - 1) + 1 doubles; m is the tile's
// digits (`dense.py:pyramid_tile_digits`); one launch when m == k, else
// two.
extern "C" int ckpe_pyramid(const double* p, int a, int k, int m,
                            double* low, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || m < 1 || m > k) return (int)cudaErrorInvalidValue;
  const K3Levels lv = k3_levels(a, k, m);
  size_t smem = 0;
  for (int i = 0; i <= m; ++i) smem += lv.pw[i];
  smem *= sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      k3_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  k3_tile_kernel<<<lv.pw[k - m], kTileThreads, smem, stream>>>(p, low, lv);
  err = cudaGetLastError();
  if (err != cudaSuccess || m == k) return (int)err;
  k3_finish_kernel<<<1, kFinishThreads, 0, stream>>>(low, lv);
  return (int)cudaGetLastError();
}

// K5: the signature weights (phase 0, K4) and the whole sweep, one
// cooperative launch. ``items`` (int64 rows of K5_FIELDS), ``phase_ptr``
// (n_phases + 1 item offsets) and ``table`` are the plan on the card
// (`engine/dense.py:sweep_plan`); csr_ptr [n_sig + 1] each signature's
// pairs, and pair_num, pair_den [pairs, chain] and pair_const [pairs]
// their worlds' chains and w_const; ``work`` holds every step's vector
// and ``s``
// the signature weights (both the launch's own: two launches at once
// need two of each). max_phase sizes the grid.
extern "C" int ckpe_dense_sweep(const long long* items,
                                const long long* phase_ptr, int n_phases,
                                long long max_phase, const int* table,
                                double* work, double* dy, long long n,
                                const double* p, const double* low,
                                const int* pair_num, const int* pair_den,
                                const double* pair_const, int chain,
                                const int* csr_ptr, int n_sig, double* s,
                                int a, int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || chain < 1) return (int)cudaErrorInvalidValue;
  K5Launch<double> L = k5_args(items, phase_ptr, n_phases, table, work, dy,
                               n, p, low, pair_num, pair_den, pair_const,
                               chain, csr_ptr, n_sig, s, a, k);
  return k5_launch(L, max_phase, stream);
}

// K3 -> K5 from one host call: K3's pyramid below each tape's p into its
// block of ``low`` (``tapes`` 2 for a dual program: p and dy are then
// [program | data], 2 A^k each), then K5 (phase 0 and the sweep) with
// the arguments `ckpe_dense_sweep` takes.
extern "C" int ckpe_dense_rhs(int tapes, int m, const long long* items,
                              const long long* phase_ptr, int n_phases,
                              long long max_phase, const int* table,
                              double* work, double* dy, long long n,
                              const double* p, double* low,
                              const int* pair_num, const int* pair_den,
                              const double* pair_const, int chain,
                              const int* csr_ptr, int n_sig, double* s,
                              int a, int k, cudaStream_t stream) {
  if (tapes < 1 || tapes > 2 || k < 1 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  const K3Levels lv = k3_levels(a, k, m);
  for (int t = 0; t < tapes; ++t) {
    const int rc = ckpe_pyramid(p + (size_t)t * lv.pw[k], a, k, m,
                                low + (size_t)t * (lv.one_slot + 1), stream);
    if (rc) return rc;
  }
  return ckpe_dense_sweep(items, phase_ptr, n_phases, max_phase, table,
                          work, dy, n, p, low, pair_num, pair_den,
                          pair_const, chain, csr_ptr, n_sig, s, a, k, stream);
}

// K25: the tangent of dp/dt along v into jdy (and its value into dy
// unless dy is null), one cooperative launch; the arguments of
// `ckpe_dense_sweep` with v and vlow (K3's levels of v) beside p and low,
// ``work`` of pairs (2 * work_size doubles) and ``s`` of pairs (2 * n_sig
// doubles).
extern "C" int ckpe_dense_jvp(const long long* items,
                              const long long* phase_ptr, int n_phases,
                              long long max_phase, const int* table,
                              double* work, double* jdy, double* dy,
                              long long n, const double* p,
                              const double* low, const double* v,
                              const double* vlow, const int* pair_num,
                              const int* pair_den, const double* pair_const,
                              int chain, const int* csr_ptr, int n_sig,
                              double* s, int a, int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || chain < 1) return (int)cudaErrorInvalidValue;
  K5Launch<K25Dual> L = k5_args(
      items, phase_ptr, n_phases, table, reinterpret_cast<K25Dual*>(work),
      dy, n, p, low, pair_num, pair_den, pair_const, chain, csr_ptr, n_sig,
      reinterpret_cast<K25Dual*>(s), a, k);
  L.ctx.v = v;
  L.ctx.vlow = vlow;
  L.ctx.jdy = jdy;
  return k5_launch(L, max_phase, stream);
}

// K3 on each tape of v into vlow, then K25: one host call a J.v.
extern "C" int ckpe_dense_jvp_rhs(int tapes, int m, const long long* items,
                                  const long long* phase_ptr, int n_phases,
                                  long long max_phase, const int* table,
                                  double* work, double* jdy, double* dy,
                                  long long n, const double* p,
                                  const double* low, const double* v,
                                  double* vlow, const int* pair_num,
                                  const int* pair_den,
                                  const double* pair_const, int chain,
                                  const int* csr_ptr, int n_sig, double* s,
                                  int a, int k, cudaStream_t stream) {
  if (tapes < 1 || tapes > 2 || k < 1 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  const K3Levels lv = k3_levels(a, k, m);
  for (int t = 0; t < tapes; ++t) {
    const int rc = ckpe_pyramid(v + (size_t)t * lv.pw[k], a, k, m,
                                vlow + (size_t)t * (lv.one_slot + 1), stream);
    if (rc) return rc;
  }
  return ckpe_dense_jvp(items, phase_ptr, n_phases, max_phase, table, work,
                        jdy, dy, n, p, low, v, vlow, pair_num, pair_den,
                        pair_const, chain, csr_ptr, n_sig, s, a, k, stream);
}
