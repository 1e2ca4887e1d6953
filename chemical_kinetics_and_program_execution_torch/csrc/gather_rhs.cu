// K7 and K8: the gather engine's dp/dt on the card.
//
// They replace the jitted XLA programs of the JAX package's
// `engine/rhs.py:135 dy_dt_from_tables` (K7, the levelized prefix tree;
// `make_dual_dy_dt` at `:235` is the same program on a dual problem's
// tables) and `:216 dy_dt_from_chain_tables` (K8, the padded chains, the
// structure-independent cross-check). Plain PyTorch versions:
// `engine/rhs.py` `ratios_plain`, `tree_values_plain`,
// `chain_values_plain`, `scatter_plain`, with
// `engine/dense.py:signature_weights_plain`. The pyramid comes from K3
// (`dense_rhs.cu`, once a tape); the rules are `gather_rule.cuh`. Built
// with `-fmad=false`, every sum in a fixed order and no float atomic: the
// plain versions' bits.
//
// One host call (`ckpe_tree_rhs`, `ckpe_chain_rhs`) makes two launches
// on one stream:
//   1. the values, one cooperative launch: phase 0 forms the guarded
//      ratio of every entry of every level's (or column's) dictionary
//      of distinct (num, den) pairs into ``ratio`` (118,033 at ex4 cl_k
//      5, 0.9 MB, which L2 holds) and the signature weights (K4's rule,
//      `sweep_rule.cuh:k4_warp_weights`); then K7 forms the tree's upper
//      levels, a grid barrier before each, a thread a node: its ratio,
//      looked up by its pair id, times its parent's value (the parent
//      implicit in the sorted child order: a tile's base plus a narrow
//      offset); after one more barrier every leaf (an event: the tree's
//      last level and the events that end above it) writes its value
//      times its signature's weight straight into ``ev``, four leaves a
//      thread. K8 forms each event's chain product over the
//      column-major chain ids, four events a thread.
//   2. the scatter: a warp a target over its run of 4-byte entries (the
//      value's index, the sign in the top bit).
// Two launches an RHS for either kernel (9 and 3 before the compact
// tables).
//
// Bound: bytes. Each table read once: the dictionaries' pyramid indices
// (8 bytes an entry), the pair ids, parent offsets and signatures (2
// bytes each where 16 bits hold them, else 4), a tile's parent base (4
// bytes a 256), the entries (4 bytes) and the targets' CSR; p and the
// levels read once, the signature weights and dy written once: 174.6 MB
// (K7) and 284.8 MB (K8) at ex4 cl_k 5, against 325.6 and 847.7 over the
// flat tables. The ratios, the upper levels' node values (14 MB at ex4
// cl_k 5), the event values and the weights are the launches' own
// intermediates. What the design does about it:
//   - the tables: the int32 (num, den, parent) a node and the row-major
//     [events, 7] chains become 16-bit ids and offsets, the 8-byte entry
//     (value index, signed signature) 4 bytes, because the event value
//     carries its signature's weight;
//   - the ratio a node forms once for each distinct pair instead: two
//     pyramid gathers a node become one lookup in a table that L2 (and
//     for a level's or column's share, L1) holds;
//   - the launches: a launch a level and one for the weights become the
//     phases of one launch; the ids, offsets and signatures of four
//     leaves (or a column's ids of four events) come in one 8-byte load
//     and every gather is issued before the first product, so more
//     loads are in flight a thread;
//   - the scatter: its entries are gathers, a 32-byte sector for one
//     8-byte value where a target's values lie thousands apart, so the
//     sectors, not the bytes, set its time (not traced). The tree's
//     leaf order keeps a target's values nearer each other than the
//     chains' compiled order does; the entries stream past once
//     (`__ldcs`), leaving L2 to the values.
//     Cutting the values into blocks that L2 holds, a target's entries
//     summed block by block, was no faster on the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gather_rule.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // == 1 << kTileShift: a tile a block
constexpr int kMaxLevels = 24;  // tree levels or chain columns
constexpr int kLevelFields = 13;  // a level's row (`rhs.LEVEL_FIELDS`)
constexpr int kColumnFields = 3;  // a column's row (`rhs.COLUMN_FIELDS`)
constexpr int kValueBlocksPerSm = 4;
constexpr int kK8Batch = 2;  // chain columns a batch of K8's loop
constexpr int kMaxScatterBlocks = 132 * 16;  // grid-stride past these

// Phase 0: every dictionary entry's ratio and the signature weights.
struct GatherPrep {
  K5Ctx ctx;      // p, low and n_state (the pyramid's two pieces)
  K4Pairs pairs;  // each signature's pairs (K4's rule)
  double* s;      // signature weights
  int n_sig;
  const int* dict_num;  // [n_dict] every dictionary's pairs
  const int* dict_den;
  double* ratio;  // [n_dict]
  unsigned n_dict;
};

struct K7Level {
  K7Slab node, leaf;  // its nodes (none at the last level), its leaves
  const void* sig;    // each leaf's signature
  unsigned n_node, n_leaf;
  unsigned first;       // its dictionary's first entry in ``ratio``
  unsigned node_first;  // its nodes' first value in ``nv``
  unsigned leaf_first;  // its leaves' first value in ``ev``
  int wide;
};

struct TreeLaunch {
  GatherPrep g;
  K7Level lv[kMaxLevels];
  int n_levels;
  double* nv;  // the upper levels' node values
  double* ev;  // the event (leaf) values
};

struct ChainLaunch {
  GatherPrep g;
  K8Column col[kMaxLevels];
  int n_cols;
  const void* sig;
  int sig_wide;
  unsigned n_ev;
  double* ev;
};

struct ScatterLaunch {
  const double* ev;
  const unsigned* ent;  // sorted by target
  const int* tgt_ptr;   // [n_tgt + 1] each target's run of entries
  int n_tgt;
  double* dy;
};

__device__ __forceinline__ void gather_prep(const GatherPrep& g, unsigned tid,
                                            unsigned stride) {
  for (unsigned q = tid; q < g.n_dict; q += stride)
    g.ratio[q] = k7_ratio(g.ctx, g.dict_num[q], g.dict_den[q]);
  k4_warp_weights(g.ctx, g.pairs, g.s, g.n_sig, tid, stride);
}

// Four elements of a uint16 or int32 index array from i (a multiple of
// four): one 8- or 16-byte load.
__device__ __forceinline__ void load4(const void* a, int wide, unsigned i,
                                      unsigned x[4]) {
  if (wide) {
    const int4 v = *reinterpret_cast<const int4*>((const int*)a + i);
    x[0] = (unsigned)v.x;
    x[1] = (unsigned)v.y;
    x[2] = (unsigned)v.z;
    x[3] = (unsigned)v.w;
  } else {
    const uint2 v =
        *reinterpret_cast<const uint2*>((const unsigned short*)a + i);
    x[0] = v.x & 0xffffu;
    x[1] = v.x >> 16;
    x[2] = v.y & 0xffffu;
    x[3] = v.y >> 16;
  }
}

// A level's leaves into ``out``: four a thread (`k7_value`'s arithmetic
// on each, times its signature's weight), their ids, offsets and
// signatures loaded four at a time and every gather issued before the
// first product; the last n % 4 one a thread.
__device__ __forceinline__ void k7_leaves(const TreeLaunch& L,
                                          const K7Level& lv,
                                          const double* par, double* out,
                                          unsigned tid, unsigned stride) {
  const unsigned n4 = lv.n_leaf / 4;
  for (unsigned j = tid; j < n4; j += stride) {
    const unsigned i = 4 * j;
    unsigned id[4], sig[4], off[4] = {0, 0, 0, 0};
    load4(lv.leaf.id, lv.wide, i, id);
    load4(lv.sig, lv.wide, i, sig);
    long long base = 0;
    if (par) {
      load4(lv.leaf.off, lv.wide, i, off);
      base = lv.leaf.base[i >> kTileShift];
    }
    double r[4], w[4], s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      r[u] = L.g.ratio[lv.first + id[u]];
      w[u] = par ? k5_load(par + base + off[u]) : 0.0;
      s[u] = L.g.s[sig[u]];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) out[i + u] = (par ? r[u] * w[u] : r[u]) * s[u];
  }
  for (unsigned i = 4 * n4 + tid; i < lv.n_leaf; i += stride)
    out[i] = k7_value(L.g.ratio, lv.first, lv.leaf, lv.wide, par, i) *
             L.g.s[k7_at(lv.sig, lv.wide, i)];
}

// K7. ``ratio``, ``s`` and the node values are written in one phase and
// read in a later one: the ratios and weights, which no block reads
// before the barrier after phase 0, by plain loads; the node values
// through L2 (`k5_load`: a line of the level before may sit in L1).
__global__ void __launch_bounds__(kThreads, kValueBlocksPerSm)
k7_tree_kernel(const __grid_constant__ TreeLaunch L) {
  const unsigned stride = gridDim.x * kThreads;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  gather_prep(L.g, tid, stride);
  const double* prev = nullptr;
  for (int l = 0; l + 1 < L.n_levels; ++l) {
    const K7Level lv = L.lv[l];
    cg::this_grid().sync();
    double* out = L.nv + lv.node_first;
    for (unsigned i = tid; i < lv.n_node; i += stride)
      out[i] = k7_value(L.g.ratio, lv.first, lv.node, lv.wide, prev, i);
    prev = out;
  }
  cg::this_grid().sync();
  for (int l = 0; l < L.n_levels; ++l) {
    const K7Level lv = L.lv[l];
    k7_leaves(L, lv, l ? L.nv + L.lv[l - 1].node_first : nullptr,
              L.ev + lv.leaf_first, tid, stride);
  }
}

// K8: each event's chain product times its signature's weight, four
// events a thread: kK8Batch columns' ids at a time loaded four events
// at once, their ratios gathered, then multiplied into each event's
// product in chain order (`k8_value`'s order); the last n % 4 one a
// thread. Two columns a batch keep the loop within the launch's 64
// registers (four spill).
__global__ void __launch_bounds__(kThreads, kValueBlocksPerSm)
k8_chain_kernel(const __grid_constant__ ChainLaunch L) {
  const unsigned stride = gridDim.x * kThreads;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  gather_prep(L.g, tid, stride);
  cg::this_grid().sync();
  double* __restrict__ ev = L.ev;
  const double* __restrict__ ratio = L.g.ratio;
  const unsigned n4 = L.n_ev / 4;
  for (unsigned j = tid; j < n4; j += stride) {
    const unsigned i = 4 * j;
    double prod[4];
    for (int c0 = 0; c0 < L.n_cols; c0 += kK8Batch) {
      unsigned id[kK8Batch][4];
#pragma unroll
      for (int b = 0; b < kK8Batch; ++b)
        if (c0 + b < L.n_cols)
          load4(L.col[c0 + b].id, L.col[c0 + b].wide, i, id[b]);
      double r[kK8Batch][4];
#pragma unroll
      for (int b = 0; b < kK8Batch; ++b)
        if (c0 + b < L.n_cols)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            r[b][u] = ratio[L.col[c0 + b].first + id[b][u]];
#pragma unroll
      for (int b = 0; b < kK8Batch; ++b)
        if (c0 + b < L.n_cols)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            prod[u] = c0 + b == 0 ? r[b][u] : prod[u] * r[b][u];
    }
    unsigned sig[4];
    load4(L.sig, L.sig_wide, i, sig);
#pragma unroll
    for (int u = 0; u < 4; ++u) ev[i + u] = prod[u] * L.g.s[sig[u]];
  }
  for (unsigned e = 4 * n4 + tid; e < L.n_ev; e += stride)
    ev[e] = k8_value(ratio, L.col, L.n_cols, e) *
            L.g.s[k7_at(L.sig, L.sig_wide, e)];
}

// The scatter: a warp a target, grid-stride.
__global__ void __launch_bounds__(kThreads)
gather_scatter_kernel(const __grid_constant__ ScatterLaunch S) {
  const unsigned stride = gridDim.x * kThreads;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const int lane = (int)(threadIdx.x & 31);
  for (unsigned t = tid >> 5; t < (unsigned)S.n_tgt; t += stride >> 5) {
    double acc =
        k7_lane_sum(S.ev, S.ent, S.tgt_ptr[t], S.tgt_ptr[t + 1], lane);
    for (int off = kLanes / 2; off >= 1; off >>= 1)
      acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) S.dy[t] = acc;
  }
}

// The most blocks of ``kernel`` that fit on the current card at once.
int resident_blocks(const void* kernel, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (!cache[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

// A cooperative launch of ``kernel`` over about four of ``work``'s
// elements a thread, at most what fits.
int launch(const void* kernel, int* cache, long long work, void* arg,
           cudaStream_t stream) {
  const int resident = resident_blocks(kernel, cache);
  if (resident <= 0) return (int)cudaErrorLaunchFailure;
  const long long want = (work + 4 * kThreads - 1) / (4 * kThreads);
  const int grid = (int)(want < 1 ? 1 : want > resident ? resident : want);
  void* args[] = {arg};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int tree_cache[64], chain_cache[64];

int launch_scatter(const double* ev, const unsigned* ent, const int* tgt_ptr,
                   int n_tgt, double* dy, cudaStream_t stream) {
  if (n_tgt < 1) return (int)cudaErrorInvalidValue;
  ScatterLaunch S;
  S.ev = ev;
  S.ent = ent;
  S.tgt_ptr = tgt_ptr;
  S.n_tgt = n_tgt;
  S.dy = dy;
  const long long want = (32LL * n_tgt + kThreads - 1) / kThreads;
  const int grid = (int)(want > kMaxScatterBlocks ? kMaxScatterBlocks : want);
  gather_scatter_kernel<<<grid, kThreads, 0, stream>>>(S);
  return (int)cudaGetLastError();
}

GatherPrep gather_prep_args(const double* p, const double* low,
                            long long n_state, int a, int k,
                            const int* pair_num, const int* pair_den,
                            const double* pair_const, int chain,
                            const int* csr_ptr, int n_sig, double* s,
                            const int* dict_num, const int* dict_den,
                            long long n_dict, double* ratio) {
  GatherPrep g;
  g.ctx.a = a;
  g.ctx.k = k;
  g.ctx.p = p;
  g.ctx.low = low;
  k5_levels(g.ctx);
  g.ctx.n_state = (unsigned)n_state;
  g.pairs.num = pair_num;
  g.pairs.den = pair_den;
  g.pairs.w_const = pair_const;
  g.pairs.csr_ptr = csr_ptr;
  g.pairs.chain = chain;
  g.s = s;
  g.n_sig = n_sig;
  g.dict_num = dict_num;
  g.dict_den = dict_den;
  g.ratio = ratio;
  g.n_dict = (unsigned)n_dict;
  return g;
}

long long phase0_work(const GatherPrep& g) {
  return g.n_dict > 32LL * g.n_sig ? g.n_dict : 32LL * g.n_sig;
}

}  // namespace

// K7: phase 0, the tree's upper levels and its leaves (one cooperative
// launch), then the scatter (one more). ``levels`` is a host array of
// n_levels rows of kLevelFields int64 (`rhs.LEVEL_FIELDS`): counts,
// offsets and the device pointers of each level's arrays.
extern "C" int ckpe_tree_rhs(
    const double* p, const double* low, long long n_state, int a, int k,
    const int* pair_num, const int* pair_den, const double* pair_const,
    int chain, const int* csr_ptr, int n_sig, double* s,
    const int* dict_num, const int* dict_den, long long n_dict,
    double* ratio, const long long* levels, int n_levels, double* nv,
    double* ev, const unsigned* ent, const int* tgt_ptr, int n_tgt,
    double* dy, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || chain < 1 || n_levels < 1 ||
      n_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  TreeLaunch L;
  L.g = gather_prep_args(p, low, n_state, a, k, pair_num, pair_den,
                         pair_const, chain, csr_ptr, n_sig, s, dict_num,
                         dict_den, n_dict, ratio);
  long long work = phase0_work(L.g), leaves = 0;
  for (int l = 0; l < n_levels; ++l) {
    const long long* r = levels + (size_t)l * kLevelFields;
    K7Level& lv = L.lv[l];
    lv.n_node = (unsigned)r[0];
    lv.n_leaf = (unsigned)r[1];
    lv.wide = (int)r[2];
    lv.first = (unsigned)r[3];
    lv.node_first = (unsigned)r[4];
    lv.leaf_first = (unsigned)r[5];
    lv.node.id = (const void*)r[6];
    lv.node.off = (const void*)r[7];
    lv.node.base = (const int*)r[8];
    lv.leaf.id = (const void*)r[9];
    lv.leaf.off = (const void*)r[10];
    lv.leaf.base = (const int*)r[11];
    lv.sig = (const void*)r[12];
    if (r[0] > work) work = r[0];
    leaves += r[1];
  }
  L.n_levels = n_levels;
  L.nv = nv;
  L.ev = ev;
  const int rc = launch((const void*)k7_tree_kernel, tree_cache,
                        leaves > work ? leaves : work, &L, stream);
  if (rc) return rc;
  return launch_scatter(ev, ent, tgt_ptr, n_tgt, dy, stream);
}

// K8: phase 0 and every event's chain product (one cooperative launch),
// then the scatter. ``cols`` is a host array of n_cols rows of
// kColumnFields int64 (`rhs.COLUMN_FIELDS`): wide, the dictionary's
// first entry, the device pointer of the column's ids.
extern "C" int ckpe_chain_rhs(
    const double* p, const double* low, long long n_state, int a, int k,
    const int* pair_num, const int* pair_den, const double* pair_const,
    int chain, const int* csr_ptr, int n_sig, double* s,
    const int* dict_num, const int* dict_den, long long n_dict,
    double* ratio, const long long* cols, int n_cols, const void* sig,
    int sig_wide, long long n_ev, double* ev, const unsigned* ent,
    const int* tgt_ptr, int n_tgt, double* dy, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || chain < 1 || n_cols < 1 || n_cols > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  ChainLaunch L;
  L.g = gather_prep_args(p, low, n_state, a, k, pair_num, pair_den,
                         pair_const, chain, csr_ptr, n_sig, s, dict_num,
                         dict_den, n_dict, ratio);
  for (int c = 0; c < n_cols; ++c) {
    const long long* r = cols + (size_t)c * kColumnFields;
    L.col[c].wide = (int)r[0];
    L.col[c].first = (unsigned)r[1];
    L.col[c].id = (const void*)r[2];
  }
  L.n_cols = n_cols;
  L.sig = sig;
  L.sig_wide = sig_wide;
  L.n_ev = (unsigned)n_ev;
  L.ev = ev;
  const long long work = phase0_work(L.g);
  const int rc = launch((const void*)k8_chain_kernel, chain_cache,
                        n_ev > work ? n_ev : work, &L, stream);
  if (rc) return rc;
  return launch_scatter(ev, ent, tgt_ptr, n_tgt, dy, stream);
}

// The scatter alone (one launch): dy from the event values ``ev`` as
// K7's and K8's second launch forms it, for timing it apart.
extern "C" int ckpe_gather_scatter(const double* ev, const unsigned* ent,
                                   const int* tgt_ptr, int n_tgt, double* dy,
                                   cudaStream_t stream) {
  return launch_scatter(ev, ent, tgt_ptr, n_tgt, dy, stream);
}
