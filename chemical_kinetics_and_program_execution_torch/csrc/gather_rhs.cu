// K7 and K8: the gather engine's dp/dt on the card.
//
// They replace the jitted XLA programs of the JAX package's
// `engine/rhs.py:135 dy_dt_from_tables` (K7, the levelized prefix tree;
// `make_dual_dy_dt` at `:235` is the same program on a dual problem's
// tables) and `:216 dy_dt_from_chain_tables` (K8, the padded chains, the
// structure-independent cross-check). Plain PyTorch versions:
// `engine/rhs.py` `tree_values_plain`, `chain_values_plain`,
// `scatter_plain`, with `engine/dense.py:signature_weights_plain`. The
// pyramid comes from K3 (`dense_rhs.cu`, once a tape); the rules are
// `gather_rule.cuh`. Built with `-fmad=false`, every sum in a fixed
// order and no float atomic: the plain versions' bits.
//
// One host call (`ckpe_tree_rhs`, `ckpe_chain_rhs`) launches, on one
// stream:
//   1. the signature weights: K4's rule (`sweep_rule.cuh:
//      k4_warp_weights`), a warp a signature;
//   2. K7: a launch a tree level, a thread a node, each node's ratio
//      times its parent's value (the parents sit in the level before,
//      sorted, so a warp's parent loads fall close together); K8: one
//      launch, a thread an event's chain;
//   3. the scatter: a warp a target over its run of the compile-time
//      sorted entries (a CSR of targets made on the host), the event
//      value and its signature weight multiplied where the entry is
//      read, so no event vector is written.
// K7 takes 2 + levels launches (9 at ex4 cl_k 5), K8 3.
//
// Bound: bytes. Each table read once (the tree's nodes 12 bytes each,
// or the chains' 8 bytes a factor; the entries 8 bytes each; the CSR),
// p and the levels read once, dy written once; the node (or event)
// values are the launches' own intermediates. The entries' value loads
// are gathers, a 32-byte sector for one 8-byte value where a target's
// events lie far apart.

#include <cuda_runtime.h>

#include "gather_rule.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride past this many blocks

struct GatherArgs {
  K5Ctx ctx;           // p, low and n_state (the pyramid's two pieces)
  K4Pairs pairs;       // each signature's pairs (K4's rule)
  double* s;           // signature weights
  int n_sig;
  double* vals;        // node (K7) or event (K8) values
  const int* ent_val;  // per entry: its value's index in vals
  const int* ent_sig;  // per entry: its signature, ~signature for a minus
  const int* tgt_ptr;  // [n_tgt + 1] each target's run of entries
  int n_tgt;
  double* dy;
};

int blocks_for(long long threads) {
  const long long b = (threads + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : b > kMaxBlocks ? kMaxBlocks : b);
}

__global__ void __launch_bounds__(kThreads)
gather_weights_kernel(GatherArgs g) {
  k4_warp_weights(g.ctx, g.pairs, g.s, g.n_sig,
                  blockIdx.x * kThreads + threadIdx.x, gridDim.x * kThreads);
}

// K7, one level: count nodes from ``num``, ``den``, ``parent`` (an index
// into ``prev``, the level before; prev == nullptr at level 0).
__global__ void __launch_bounds__(kThreads)
tree_level_kernel(K5Ctx c, const int* __restrict__ num,
                  const int* __restrict__ den, const int* __restrict__ parent,
                  const double* __restrict__ prev, double* __restrict__ out,
                  unsigned count) {
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < count;
       i += stride) {
    const double r = k7_ratio(c, num[i], den[i]);
    out[i] = prev ? r * prev[parent[i]] : r;
  }
}

// K8: each event's chain product.
__global__ void __launch_bounds__(kThreads)
chain_kernel(K5Ctx c, const int* __restrict__ num, const int* __restrict__ den,
             int chain, unsigned n_ev, double* __restrict__ out) {
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < n_ev;
       e += stride)
    out[e] = k4_chain_product(c, num + (size_t)e * chain,
                              den + (size_t)e * chain, chain);
}

// The scatter: a warp a target, grid-stride.
__global__ void __launch_bounds__(kThreads)
scatter_kernel(GatherArgs g) {
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;
  const int lane = (int)(threadIdx.x & 31);
  for (unsigned t = tid >> 5; t < (unsigned)g.n_tgt; t += stride >> 5) {
    double acc = k7_lane_sum(g.vals, g.ent_val, g.ent_sig, g.s,
                             g.tgt_ptr[t], g.tgt_ptr[t + 1], lane);
    for (int off = kLanes / 2; off >= 1; off >>= 1)
      acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) g.dy[t] = acc;
  }
}

GatherArgs gather_args(const double* p, const double* low, long long n_state,
                       int a, int k, const int* pair_num, const int* pair_den,
                       const double* pair_const, int chain,
                       const int* csr_ptr, int n_sig, double* s, double* vals,
                       const int* ent_val, const int* ent_sig,
                       const int* tgt_ptr, int n_tgt, double* dy) {
  GatherArgs g;
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
  g.vals = vals;
  g.ent_val = ent_val;
  g.ent_sig = ent_sig;
  g.tgt_ptr = tgt_ptr;
  g.n_tgt = n_tgt;
  g.dy = dy;
  return g;
}

int launch_weights(const GatherArgs& g, cudaStream_t stream) {
  gather_weights_kernel<<<blocks_for(32LL * g.n_sig), kThreads, 0, stream>>>(
      g);
  return (int)cudaGetLastError();
}

int launch_scatter(const GatherArgs& g, cudaStream_t stream) {
  scatter_kernel<<<blocks_for(32LL * g.n_tgt), kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// K7: the signature weights, the tree's levels and the scatter. The
// nodes of every level lie in ``num``, ``den``, ``parent`` (parent a
// node's index in the level before) at the host array level_ptr[0 ..
// n_levels]; ``vals`` holds every node's value.
extern "C" int ckpe_tree_rhs(const double* p, const double* low,
                             long long n_state, int a, int k,
                             const int* pair_num, const int* pair_den,
                             const double* pair_const, int chain,
                             const int* csr_ptr, int n_sig, double* s,
                             const int* num, const int* den,
                             const int* parent, const long long* level_ptr,
                             int n_levels, double* vals, const int* ent_val,
                             const int* ent_sig, const int* tgt_ptr,
                             int n_tgt, double* dy, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || chain < 1 || n_levels < 1)
    return (int)cudaErrorInvalidValue;
  const GatherArgs g = gather_args(p, low, n_state, a, k, pair_num, pair_den,
                                   pair_const, chain, csr_ptr, n_sig, s, vals,
                                   ent_val, ent_sig, tgt_ptr, n_tgt, dy);
  int rc = launch_weights(g, stream);
  if (rc) return rc;
  for (int l = 0; l < n_levels; ++l) {
    const long long first = level_ptr[l];
    const long long count = level_ptr[l + 1] - first;
    tree_level_kernel<<<blocks_for(count), kThreads, 0, stream>>>(
        g.ctx, num + first, den + first, parent + first,
        l ? vals + level_ptr[l - 1] : nullptr, vals + first,
        (unsigned)count);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return launch_scatter(g, stream);
}

// K8: the signature weights, every event's chain product ([n_ev, e_chain]
// ``e_num``, ``e_den``) into ``vals``, and the scatter.
extern "C" int ckpe_chain_rhs(const double* p, const double* low,
                              long long n_state, int a, int k,
                              const int* pair_num, const int* pair_den,
                              const double* pair_const, int chain,
                              const int* csr_ptr, int n_sig, double* s,
                              const int* e_num, const int* e_den, int e_chain,
                              long long n_ev, double* vals,
                              const int* ent_val, const int* ent_sig,
                              const int* tgt_ptr, int n_tgt, double* dy,
                              cudaStream_t stream) {
  if (k < 1 || k > kMaxK || chain < 1 || e_chain < 1)
    return (int)cudaErrorInvalidValue;
  const GatherArgs g = gather_args(p, low, n_state, a, k, pair_num, pair_den,
                                   pair_const, chain, csr_ptr, n_sig, s, vals,
                                   ent_val, ent_sig, tgt_ptr, n_tgt, dy);
  int rc = launch_weights(g, stream);
  if (rc) return rc;
  chain_kernel<<<blocks_for(n_ev), kThreads, 0, stream>>>(
      g.ctx, e_num, e_den, e_chain, (unsigned)n_ev, vals);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_scatter(g, stream);
}

// The scatter stage alone (one launch): dy from ``vals`` and ``s`` as
// K7's and K8's last launch forms it, for timing it apart.
extern "C" int ckpe_gather_scatter(const double* s, double* vals,
                                   const int* ent_val, const int* ent_sig,
                                   const int* tgt_ptr, int n_tgt, double* dy,
                                   cudaStream_t stream) {
  GatherArgs g = {};
  g.s = const_cast<double*>(s);
  g.vals = vals;
  g.ent_val = ent_val;
  g.ent_sig = ent_sig;
  g.tgt_ptr = tgt_ptr;
  g.n_tgt = n_tgt;
  g.dy = dy;
  return launch_scatter(g, stream);
}
