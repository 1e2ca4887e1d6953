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
// runs K3 -> K5 from one host call: in the grid form K3's one or two
// launches, then K5's one, whose phase 0 is K4; in the block and
// cluster forms K5's one launch, its leading phases the levels.
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
// K5 `sweep` (`dense.py:310 _apply_group`). One launch for the whole
// sweep of every group: phase 0 (K4's signature weights into the
// launch's own ``s``), then the plan's phases in turn, a barrier before
// each; the first of them also zeroes dy. The barrier's scope follows
// the plan's size, in one of three launch forms the host chooses once a
// program (`engine/dense.py:launch_form`): one block of 1,024 threads
// (`__syncthreads`), one thread-block cluster of up to 16 such blocks
// (the cluster's hardware barrier), or the cooperative grid
// (`cooperative_groups`' grid sync, its state the launch's own). A
// phase costs the grid form 2.6-3.5 µs on the H100 whatever its size
// (`time_jvp.py`): the grid's barrier, then the items' loads and the
// element's dependent loads, each an L2 round trip. In the block and
// cluster forms each block copies the plan into shared memory first
// where it fits (the items unpacked, the phase offsets and the table;
// the block form the work buffer too), which leaves a phase about 1 µs
// in a block, and the launch forms the levels below p (and v) as its
// leading phases (`sweep_rule.cuh:k5_level_entry`), so an RHS or a J.v
// is one launch. The grid form keeps the most threads, which the
// largest plans need (ex4 and ex4var2 at cl_k 5-8). A phase's items (`sweep_rule.cuh`) run side
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
// k5_sector_bytes` models that traffic); at cl_k 5 the phases' latency,
// not bytes, sets the time.
//
// K25 `dense_jvp` (`dense.py:dense_jvp`; plain `dense_jvp_plain`)
// replaces `jax.jvp` of the JAX package's `engine/dense.py:441
// dy_dt_dense`, which the Newton-Krylov steady states
// (`ode/steady.py:347,525`) and the stiff stepper's Newton systems
// (`ode/kvaerno3.py:79`) call (XLA; no Pallas kernel). It is K5's kernel
// on pairs (`sweep_rule.cuh`'s rule with T = K25Dual): the same plan,
// phases and barriers, its phase 0 K4's weights with their tangents,
// every compact vector a (value, tangent) pair, in K5's launch forms.
// It reads p and the levels of p (which the RHS call before it saved,
// or which its leading phases form), v and the levels of v (formed by
// its leading phases in the block and cluster forms; in the grid form
// `ckpe_dense_jvp_rhs` launches K3 on v first), and writes dy's
// tangent, and dy itself where asked (the forward-mode dual call: K5's
// bits, from the same values, in one launch where an RHS and a J.v would
// take two). Bound: bytes, as K5's, with p, v and their top levels read
// and pair-valued weights; the work buffer of pairs is twice K5's and a
// product of pairs three products and a sum.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sweep_rule.cuh"

namespace {

constexpr int kThreads = 256;  // the grid form's block
constexpr int kWideThreads = 1024;  // the block and cluster forms' most
constexpr int kTileThreads = 512;
constexpr int kFinishThreads = 1024;
// K5 keeps 4 blocks an SM (64 registers a thread): at cl_k 7-8 its grid
// is what fits, and phase 0's code at 66 registers left room for 3. The
// block and cluster forms' 1,024 threads a block get the same 64.
constexpr int kK5BlocksPerSm = 4;
constexpr int kMaxCluster = 16;  // past 8 a non-portable cluster size

template <int F>
struct K5Shape {  // the grid form
  static constexpr int threads = kThreads, min_blocks = kK5BlocksPerSm;
};
template <>
struct K5Shape<kFormBlock> {
  static constexpr int threads = kWideThreads, min_blocks = 1;
};
template <>
struct K5Shape<kFormCluster> {
  static constexpr int threads = kWideThreads, min_blocks = 1;
};

// A launch form (`engine/dense.py:LaunchForm`) with the plan's sizes that
// decide what a block copies into shared memory (`k5_stage_plan`).
struct K5Form {
  int kind, blocks, n_items, table_len;
  long long work_len;
};

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

// What a block of the block and cluster forms keeps in dynamic shared
// memory for the whole launch (`k5_stage_plan`): every item unpacked,
// the phase offsets and the table, and in the block form the work
// buffer too, each where it fits; ``bytes`` 0 where nothing fits (the
// items are then unpacked a chunk at a time, as in the grid form).
struct K5Stage {
  int n_items, table_len;
  long long work_len;  // values of the work buffer in shared memory, or 0
  unsigned off_pp, off_table, off_work, bytes;
};

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
  // The block and cluster forms' leading phases (`sweep_rule.cuh:
  // k5_level_entry`): p's levels into lv.lv (ctx.low) and v's into
  // lv.vlv (ctx.vlow), each where it is not null.
  K5LevelOut lv;
  K5Stage stage;
};

// K5: the levels (block and cluster forms, where asked), phase 0 (K4),
// then every phase of the sweep, in one launch of form F, a barrier
// before each phase. In the block and cluster forms each block first
// copies the plan into shared memory where it fits (`K5Stage`): the
// items unpacked (fields and divisors), the phase offsets, the table,
// and in the block form the work buffer; the rule then reads the table
// and work through the block's copy of the context. Otherwise (and
// always in the grid form) a block unpacks up to kK5Staged of a phase's
// items into shared memory at a time. Each phase's elements are taken
// in a loop strided by the launch's threads. kDual: a dual program's
// plan, whose items read their tapes' offsets (`sweep_rule.cuh`). T:
// double for K5, K25Dual for K25.
template <int F, bool kDual, class T>
__global__ void __launch_bounds__(K5Shape<F>::threads, K5Shape<F>::min_blocks)
k5_sweep_kernel(K5Launch<T> L) {
  __shared__ K5Item staged[kK5Staged];
  __shared__ K5CtxT<T> sctx;
  extern __shared__ __align__(16) unsigned char k5_dyn[];
  const unsigned threads = blockDim.x;
  const unsigned stride = gridDim.x * threads;
  const unsigned tid = blockIdx.x * threads + threadIdx.x;
  const K5CtxT<T>* cp = &L.ctx;
  const K5Item* all = nullptr;
  const long long* pp = L.phase_ptr;
  if constexpr (F != kFormGrid) {
    if (L.stage.bytes) {
      K5Item* si = reinterpret_cast<K5Item*>(k5_dyn);
      long long* sp = reinterpret_cast<long long*>(k5_dyn + L.stage.off_pp);
      int* st = reinterpret_cast<int*>(k5_dyn + L.stage.off_table);
      for (int q = threadIdx.x; q < L.stage.n_items; q += threads) {
        K5Item it = k5_item(L.items + (long long)q * K5_FIELDS, L.ctx);
        if (!kDual) it.poff = it.loff = 0;  // a single tape's: not read
        si[q] = it;
      }
      for (int q = threadIdx.x; q <= L.n_phases; q += threads)
        sp[q] = L.phase_ptr[q];
      for (int q = threadIdx.x; q < L.stage.table_len; q += threads)
        st[q] = L.ctx.table[q];
      if (threadIdx.x == 0) {
        sctx = L.ctx;
        sctx.table = st;
        if (L.stage.work_len)
          sctx.work = reinterpret_cast<T*>(k5_dyn + L.stage.off_work);
      }
      cp = &sctx;
      all = si;
      pp = sp;
      __syncthreads();
    }
  }
  const K5CtxT<T>& c = *cp;
  k5_form_levels<F>(c, L.lv, tid, stride);
  k4_warp_weights(c, L.pairs, L.s, L.n_sig, tid, stride);
  for (int ph = 0; ph < L.n_phases; ++ph) {
    k5_form_barrier<F>();
    if (ph == 0)  // no item of the first phase touches dy
      for (unsigned x = tid; x < L.n; x += stride) k5_dy_set(c, x, T());
    k5_phase_elements<kDual>(
        c, L.items, all, pp[ph], pp[ph + 1], staged, tid, stride,
        [&](const K5Item& it, unsigned e) { k5_element<kDual>(c, it, e); });
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

// The most blocks of the grid form of k5_sweep_kernel<kDual, T> that
// fit on the card at once.
template <bool kDual, class T>
int k5_resident_blocks() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (!cached[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, k5_sweep_kernel<kFormGrid, kDual, T>, kThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

constexpr unsigned kStageBudget = 200 * 1024;  // dynamic shared memory

unsigned k5_up16(unsigned long long x) { return (unsigned)((x + 15) & ~15ULL); }

// The block's copy of the plan (`K5Stage`): the items, the phase offsets
// and the table where together they fit kStageBudget bytes, and the
// work buffer (``value`` bytes a value) beside them in the block form
// where it fits too.
K5Stage k5_stage_plan(const K5Form& f, int n_phases, int value) {
  K5Stage g = {};
  if (f.kind == kFormGrid || f.n_items <= 0) return g;
  const unsigned long long pp = k5_up16((unsigned long long)f.n_items *
                                        sizeof(K5Item));
  const unsigned long long table = k5_up16(pp + 8ULL * (n_phases + 1));
  const unsigned long long meta = k5_up16(table + 4ULL * f.table_len);
  if (meta > kStageBudget) return g;
  g.n_items = f.n_items;
  g.table_len = f.table_len;
  g.off_pp = (unsigned)pp;
  g.off_table = (unsigned)table;
  g.bytes = (unsigned)meta;
  const unsigned long long work = (unsigned long long)f.work_len * value;
  if (f.kind == kFormBlock && f.work_len > 0 && meta + work <= kStageBudget) {
    g.work_len = f.work_len;
    g.off_work = (unsigned)meta;
    g.bytes = (unsigned)(meta + work);
  }
  return g;
}

// Sets a kernel's attributes once (a host call a launch would pace the
// host-paced solvers): its dynamic shared memory limit up to ``bytes``
// and, for a cluster past 8 blocks, the non-portable cluster size.
cudaError_t k5_prepare(const void* kernel, unsigned bytes, bool wide) {
  static const void* seen[16];
  static unsigned most[16];
  static bool wide_ok[16];
  int slot = 0;
  while (slot < 15 && seen[slot] && seen[slot] != kernel) ++slot;
  if (seen[slot] != kernel) {  // a new kernel (the block and cluster forms
    seen[slot] = kernel;       // have 8), or the last slot taken anew
    most[slot] = 0;
    wide_ok[slot] = false;
  }
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024 && bytes > most[slot]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    most[slot] = bytes;
  }
  if (wide && !wide_ok[slot]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide_ok[slot] = true;
  }
  return err;
}

template <bool kDual, class T>
const void* k5_kernel(int kind) {
  if (kind == kFormBlock)
    return (const void*)k5_sweep_kernel<kFormBlock, kDual, T>;
  if (kind == kFormCluster)
    return (const void*)k5_sweep_kernel<kFormCluster, kDual, T>;
  return (const void*)k5_sweep_kernel<kFormGrid, kDual, T>;
}

// K5's or K25's one launch in form f. The grid form: a cooperative
// launch of 256-thread blocks, about four elements a thread in the
// largest phase (a lane each for a signature's pairs in phase 0), at
// most what fits. The block form: one block of kWideThreads. The
// cluster form: one cluster of f.blocks such blocks. The grid
// form takes no leading levels (K3 runs before it).
template <class T>
int k5_launch(K5Launch<T>& L, long long max_phase, K5Form f,
              cudaStream_t stream) {
  const bool dual = L.ctx.n_state != L.ctx.pw[L.ctx.k];  // [program | data]
  void* args[] = {&L};
  const void* kernel =
      dual ? k5_kernel<true, T>(f.kind) : k5_kernel<false, T>(f.kind);
  cudaError_t err;
  if (f.kind == kFormGrid) {
    if (L.lv.lv || L.lv.vlv) return (int)cudaErrorInvalidValue;
    const int resident = dual ? k5_resident_blocks<true, T>()
                              : k5_resident_blocks<false, T>();
    if (resident <= 0) return (int)cudaErrorLaunchFailure;
    const long long most =
        max_phase > 32LL * L.n_sig ? max_phase : 32LL * L.n_sig;
    long long want = (most + 4 * kThreads - 1) / (4 * kThreads);
    const int grid = (int)(want < 1 ? 1 : want > resident ? resident : want);
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads),
                                      args, 0, stream);
  } else if (f.kind == kFormBlock) {
    if (f.blocks != 1) return (int)cudaErrorInvalidValue;
    L.stage = k5_stage_plan(f, L.n_phases, (int)sizeof(T));
    err = k5_prepare(kernel, L.stage.bytes, false);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernel(kernel, dim3(1), dim3(kWideThreads), args,
                           L.stage.bytes, stream);
  } else if (f.kind == kFormCluster) {
    if (f.blocks < 1 || f.blocks > kMaxCluster)
      return (int)cudaErrorInvalidValue;
    L.stage = k5_stage_plan(f, L.n_phases, (int)sizeof(T));
    err = k5_prepare(kernel, L.stage.bytes, f.blocks > 8);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)f.blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)f.blocks);
    cfg.blockDim = dim3((unsigned)kWideThreads);
    cfg.dynamicSmemBytes = L.stage.bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelExC(&cfg, kernel, args);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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
  L.lv.tapes = (int)((unsigned)n / L.ctx.pw[k]);
  L.lv.low_block = L.ctx.lv_off[0] + 2;  // the levels and the 1 above
  return L;
}

bool k5_args_ok(int k, int chain, K5Form f) {
  return k >= 1 && k <= kMaxK && chain >= 1 && f.kind >= kFormGrid &&
         f.kind <= kFormCluster;
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
// launch in the form (form, blocks) (`engine/dense.py:
// LaunchForm`; the grid form sizes itself by max_phase). ``items``
// (int64 rows of K5_FIELDS), ``phase_ptr`` (n_phases + 1 item offsets)
// and ``table`` are the plan on the card (`engine/dense.py:sweep_plan`);
// csr_ptr [n_sig + 1] each signature's pairs, and pair_num, pair_den
// [pairs, chain] and pair_const [pairs] their worlds' chains and
// w_const; ``work`` holds every step's vector and ``s`` the signature
// weights (both the launch's own: two launches at once need two of
// each); ``low`` K3's levels of p, made before.
extern "C" int ckpe_dense_sweep(const long long* items,
                                const long long* phase_ptr, int n_phases,
                                long long max_phase, const int* table,
                                double* work, double* dy, long long n,
                                const double* p, const double* low,
                                const int* pair_num, const int* pair_den,
                                const double* pair_const, int chain,
                                const int* csr_ptr, int n_sig, double* s,
                                int a, int k, int form, int blocks,
                                int n_items, int table_len,
                                long long work_len, cudaStream_t stream) {
  const K5Form f = {form, blocks, n_items, table_len, work_len};
  if (!k5_args_ok(k, chain, f)) return (int)cudaErrorInvalidValue;
  K5Launch<double> L = k5_args(items, phase_ptr, n_phases, table, work, dy,
                               n, p, low, pair_num, pair_den, pair_const,
                               chain, csr_ptr, n_sig, s, a, k);
  return k5_launch(L, max_phase, f, stream);
}

// dp/dt from p in one host call: in the grid form K3's pyramid below each
// tape's p into its block of ``low`` (``tapes`` 2 for a dual program: p
// and dy are then [program | data], 2 A^k each), then K5 (phase 0 and
// the sweep); in the block and cluster forms one K5 launch whose leading
// phases write the levels into ``low``. The arguments of
// `ckpe_dense_sweep` after ``tapes`` and m.
extern "C" int ckpe_dense_rhs(int tapes, int m, const long long* items,
                              const long long* phase_ptr, int n_phases,
                              long long max_phase, const int* table,
                              double* work, double* dy, long long n,
                              const double* p, double* low,
                              const int* pair_num, const int* pair_den,
                              const double* pair_const, int chain,
                              const int* csr_ptr, int n_sig, double* s,
                              int a, int k, int form, int blocks, int n_items,
                              int table_len, long long work_len,
                              cudaStream_t stream) {
  const K5Form f = {form, blocks, n_items, table_len, work_len};
  if (tapes < 1 || tapes > 2 || !k5_args_ok(k, chain, f))
    return (int)cudaErrorInvalidValue;
  if (form == kFormGrid) {
    const K3Levels lv = k3_levels(a, k, m);
    for (int t = 0; t < tapes; ++t) {
      const int rc = ckpe_pyramid(p + (size_t)t * lv.pw[k], a, k, m,
                                  low + (size_t)t * (lv.one_slot + 1), stream);
      if (rc) return rc;
    }
  }
  K5Launch<double> L = k5_args(items, phase_ptr, n_phases, table, work, dy,
                               n, p, low, pair_num, pair_den, pair_const,
                               chain, csr_ptr, n_sig, s, a, k);
  if (form != kFormGrid) L.lv.lv = low;
  return k5_launch(L, max_phase, f, stream);
}

// K25: the tangent of dp/dt along v into jdy (and its value into dy
// unless dy is null), one launch in the form (form, blocks);
// the arguments of `ckpe_dense_sweep` with v and vlow (K3's levels of v)
// beside p and low, ``work`` of pairs (2 * work_size doubles) and ``s``
// of pairs (2 * n_sig doubles).
extern "C" int ckpe_dense_jvp(const long long* items,
                              const long long* phase_ptr, int n_phases,
                              long long max_phase, const int* table,
                              double* work, double* jdy, double* dy,
                              long long n, const double* p,
                              const double* low, const double* v,
                              const double* vlow, const int* pair_num,
                              const int* pair_den, const double* pair_const,
                              int chain, const int* csr_ptr, int n_sig,
                              double* s, int a, int k, int form, int blocks,
                              int n_items, int table_len,
                              long long work_len, cudaStream_t stream) {
  const K5Form f = {form, blocks, n_items, table_len, work_len};
  if (!k5_args_ok(k, chain, f)) return (int)cudaErrorInvalidValue;
  K5Launch<K25Dual> L = k5_args(
      items, phase_ptr, n_phases, table, reinterpret_cast<K25Dual*>(work),
      dy, n, p, low, pair_num, pair_den, pair_const, chain, csr_ptr, n_sig,
      reinterpret_cast<K25Dual*>(s), a, k);
  L.ctx.v = v;
  L.ctx.vlow = vlow;
  L.ctx.jdy = jdy;
  return k5_launch(L, max_phase, f, stream);
}

// One host call a J.v: in the grid form K3 on each tape of v into vlow,
// then K25 (p's levels ``low`` made before: ``levels_p`` must be 0); in
// the block and cluster forms one K25 launch whose leading phases write
// v's levels into vlow, and p's into low too where ``levels_p`` is set.
extern "C" int ckpe_dense_jvp_rhs(int tapes, int m, int levels_p,
                                  const long long* items,
                                  const long long* phase_ptr, int n_phases,
                                  long long max_phase, const int* table,
                                  double* work, double* jdy, double* dy,
                                  long long n, const double* p, double* low,
                                  const double* v, double* vlow,
                                  const int* pair_num, const int* pair_den,
                                  const double* pair_const, int chain,
                                  const int* csr_ptr, int n_sig, double* s,
                                  int a, int k, int form, int blocks,
                                  int n_items, int table_len,
                                  long long work_len, cudaStream_t stream) {
  const K5Form f = {form, blocks, n_items, table_len, work_len};
  if (tapes < 1 || tapes > 2 || !k5_args_ok(k, chain, f) ||
      (form == kFormGrid && levels_p))
    return (int)cudaErrorInvalidValue;
  if (form == kFormGrid) {
    const K3Levels lv = k3_levels(a, k, m);
    for (int t = 0; t < tapes; ++t) {
      const int rc = ckpe_pyramid(v + (size_t)t * lv.pw[k], a, k, m,
                                  vlow + (size_t)t * (lv.one_slot + 1), stream);
      if (rc) return rc;
    }
  }
  K5Launch<K25Dual> L = k5_args(
      items, phase_ptr, n_phases, table, reinterpret_cast<K25Dual*>(work),
      dy, n, p, low, pair_num, pair_den, pair_const, chain, csr_ptr, n_sig,
      reinterpret_cast<K25Dual*>(s), a, k);
  L.ctx.v = v;
  L.ctx.vlow = vlow;
  L.ctx.jdy = jdy;
  if (form != kFormGrid) {
    L.lv.vlv = vlow;
    if (levels_p) L.lv.lv = low;
  }
  return k5_launch(L, max_phase, f, stream);
}
