// K30 `dense_vjp`: u^T J of the exact SPD closure's dense dp/dt, in p and
// in the worlds' weights w_const.
//
// It replaces `jax.vjp` of the JAX package's `engine/dense.py:441
// dy_dt_dense` (XLA's transpose of the sweep, the pyramid and the
// factor chains; no Pallas kernel), which the JAX package's implicit
// gradient (`ode/steady.py:419,438`), its fixed-grid adjoint
// (`ode/fixed.py:121`) and `engine/parametric.py:153 rate_sensitivity`
// call. Plain PyTorch version: `engine/dense.py:dense_vjp_plain`; the
// per-element rules are `sweep_rule.cuh`'s K30 section, which says what
// each phase sums. Every cotangent is a gather summed by one thread from
// 0.0 over a list the host planned once a program
// (`engine/dense.py:vjp_plan`), in plan order, so no float atomic is
// used and K30 equals its plain version bit for bit; built with
// `-fmad=false`, as K5.
//
// One launch in the program's form (`engine/dense.py:launch_form`, K5's
// three): one block of 1,024 threads (`__syncthreads` between phases),
// one thread-block cluster (its hardware barrier), or the cooperative
// grid (its sync; K3 runs before it). In the block and cluster forms the
// launch forms the levels below p first where they were not made before.
// Then K4's signature weights (`k4_warp_weights`), the forward by level
// (K5's rule, each element's ratio and operand kept beside its value),
// the reverse items by descending level, the seeds with the ratio-table
// entries, the signatures, the worlds, the pyramid entries and p_bar.
// A phase's elements are taken a thread each in a loop strided by the
// launch's threads; a value written in an earlier phase is read through
// L2 (`k5_load`). Bound: bytes, p and u read and p_bar written once,
// the work buffer written and read three times over (value, ratio,
// operand), the ratio-table partials and the pyramid's terms once each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sweep_rule.cuh"

namespace {

constexpr int kThreads = 256;       // the grid form's block
constexpr int kWideThreads = 1024;  // the block and cluster forms'
constexpr int kMaxCluster = 16;

template <int F>
struct K30Shape {
  static constexpr int threads = kThreads;
};
template <>
struct K30Shape<kFormBlock> {
  static constexpr int threads = kWideThreads;
};
template <>
struct K30Shape<kFormCluster> {
  static constexpr int threads = kWideThreads;
};

struct K30Launch {
  K5Ctx ctx;
  K30Ctx v;
  K4Pairs pairs;
  double* s;  // the signature weights (ctx.s)
  const long long* fwd;  // the forward's K5 item rows, by level
  const long long* fwd_ptr;
  int n_fwd;  // forward phases
  const long long* rv;  // the reverse item rows (kK30Row each)
  const long long* rv_ptr;
  int n_rv;  // reverse phases, the seeds' last
  unsigned n_pyr;  // [p | low] entries
  K5LevelOut lv;  // the leading levels (block and cluster forms)
};

template <int F, bool kDual>
__global__ void __launch_bounds__(K30Shape<F>::threads)
k30_kernel(K30Launch L) {
  __shared__ K5Item staged[kK5Staged];
  const unsigned threads = blockDim.x;
  const unsigned stride = gridDim.x * threads;
  const unsigned tid = blockIdx.x * threads + threadIdx.x;
  const K5Ctx& c = L.ctx;
  const K30Ctx& v = L.v;
  k5_form_levels<F>(c, L.lv, tid, stride);
  k4_warp_weights(c, L.pairs, L.s, v.n_sig, tid, stride);
  for (int ph = 0; ph < L.n_fwd; ++ph) {
    k5_form_barrier<F>();
    k5_phase_elements<kDual>(
        c, L.fwd, nullptr, L.fwd_ptr[ph], L.fwd_ptr[ph + 1], staged, tid,
        stride, [&](const K5Item& it, unsigned e) {
          k30_forward<kDual>(c, v, it, e);
        });
  }
  for (int ph = 0; ph < L.n_rv; ++ph) {
    k5_form_barrier<F>();
    const long long i0 = L.rv_ptr[ph], i1 = L.rv_ptr[ph + 1];
    if (i1 > i0) {
      const long long* last = L.rv + (i1 - 1) * kK30Row;
      const unsigned total = (unsigned)(last[RV_START] + last[RV_N]);
      for (unsigned x = tid; x < total; x += stride) {
        long long lo = i0, hi = i1 - 1;  // the last item starting <= x
        while (lo < hi) {
          const long long mid = (lo + hi + 1) >> 1;
          if (L.rv[mid * kK30Row + RV_START] <= (long long)x)
            lo = mid;
          else
            hi = mid - 1;
        }
        const long long* r = L.rv + lo * kK30Row;
        k30_reverse(c, v, r, (unsigned)(x - r[RV_START]));
      }
    }
    if (ph == L.n_rv - 1)
      for (unsigned x = tid; x < (unsigned)v.tapes * v.rat_len; x += stride)
        k30_table_entry(c, v, x);
  }
  k5_form_barrier<F>();
  for (unsigned g = tid; g < (unsigned)v.n_sig; g += stride)
    k30_signature(c, v, (int)g);
  k5_form_barrier<F>();
  for (unsigned w = tid; w < (unsigned)v.n_worlds; w += stride)
    k30_world(c, v, (int)w);
  k5_form_barrier<F>();
  for (unsigned y = tid; y < L.n_pyr; y += stride) k30_direct(c, v, y);
  k5_form_barrier<F>();
  for (unsigned y = tid; y < c.n_state; y += stride) k30_pbar(c, v, y);
}

template <bool kDual>
const void* k30_pick(int kind) {
  if (kind == kFormBlock) return (const void*)k30_kernel<kFormBlock, kDual>;
  if (kind == kFormCluster)
    return (const void*)k30_kernel<kFormCluster, kDual>;
  return (const void*)k30_kernel<kFormGrid, kDual>;
}

// The most blocks of the grid form that fit on the card at once.
int k30_resident(const void* kernel) {
  int dev = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}

}  // namespace

// K30: p_bar = u^T J in p (and w_bar in the worlds' weights unless wbar
// is null) of the dense dp/dt at p, one launch in the form (form,
// blocks). The plan is `engine/dense.py:vjp_plan` on the card: the
// forward's K5 rows (fwd, fwd_ptr: n_fwd phases), the reverse rows (rv,
// rv_ptr: n_rv phases), the table, the steps' layouts and the gather
// lists; w_num, w_den [worlds, chain] the chains (K4's indices) and
// w_const [worlds] the weights; pair_num, pair_den, pair_const and
// csr_ptr K4's pairs. ``low`` holds the levels below p: made before
// (levels_p 0; the grid form always), else formed by the launch.
// ``scratch`` is the call's own: work_len doubles each for the values,
// the ratios and the operands, then n_xs, 2 n_sig, the partials (n_q)
// and the pyramid's entries.
extern "C" int ckpe_dense_vjp(
    int tapes, int levels_p, const long long* fwd, const long long* fwd_ptr,
    int n_fwd, const long long* rv, const long long* rv_ptr, int n_rv,
    const int* table, const long long* steps, const int* tab_ptr,
    const int* tab_steps, const int* sig_ptr, const int* sig_terms,
    const int* world_ptr, const int* world_sigs, const int* wt_pyr,
    const int* wt_q, int n_wt, const int* w_num, const int* w_den,
    const double* w_const, int chain, int n_worlds, const int* pair_num,
    const int* pair_den, const double* pair_const, const int* csr_ptr,
    int n_sig, int n_xs, long long n_state, const double* p, double* low,
    const double* u, double* scratch, long long work_len, long long n_q,
    double* pbar, double* wbar, int a, int k, int form, int blocks,
    long long max_phase, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || chain < 1 || chain > kK30MaxChain ||
      tapes < 1 || tapes > 2 || form < kFormGrid || form > kFormCluster ||
      (form == kFormGrid && levels_p))
    return (int)cudaErrorInvalidValue;
  K30Launch L = {};
  K5Ctx& c = L.ctx;
  c.a = a;
  c.k = k;
  c.p = p;
  c.low = low;
  c.table = table;
  k5_levels(c);
  c.n_state = (unsigned)n_state;
  const long long w = work_len > 0 ? work_len : 1;
  c.work = scratch;
  K30Ctx& v = L.v;
  v.g = scratch + w;
  v.px = scratch + 2 * w;
  v.xs = scratch + 3 * w;
  v.sbar = v.xs + n_xs;
  L.s = v.sbar + n_sig;
  c.s = L.s;
  v.q = L.s + n_sig;
  v.direct = v.q + n_q;
  v.table = table;
  v.steps = steps;
  v.tab_ptr = tab_ptr;
  v.tab_steps = tab_steps;
  v.sig_ptr = sig_ptr;
  v.sig_terms = sig_terms;
  v.world_ptr = world_ptr;
  v.world_sigs = world_sigs;
  v.wt_pyr = wt_pyr;
  v.wt_q = wt_q;
  v.n_wt = n_wt;
  v.w_num = w_num;
  v.w_den = w_den;
  v.w_const = w_const;
  v.chain = chain;
  v.n_worlds = n_worlds;
  v.n_sig = n_sig;
  v.n_xs = n_xs;
  v.tapes = tapes;
  unsigned pos = 0;
  for (int j = 1; j <= k; ++j) {
    v.off_le[j] = pos;
    pos += c.pw[j];
  }
  v.off_re = pos;
  v.rat_len = pos + c.pw[k];
  v.low_block = c.lv_off[0] + 2;
  v.u = u;
  v.pbar = pbar;
  v.wbar = wbar;
  L.pairs.num = pair_num;
  L.pairs.den = pair_den;
  L.pairs.w_const = pair_const;
  L.pairs.csr_ptr = csr_ptr;
  L.pairs.chain = chain;
  L.fwd = fwd;
  L.fwd_ptr = fwd_ptr;
  L.n_fwd = n_fwd;
  L.rv = rv;
  L.rv_ptr = rv_ptr;
  L.n_rv = n_rv;
  L.n_pyr = (unsigned)n_state + (unsigned)tapes * v.low_block;
  L.lv.tapes = tapes;
  L.lv.low_block = v.low_block;
  if (levels_p) L.lv.lv = low;
  const bool dual = tapes == 2;
  const void* kernel = dual ? k30_pick<true>(form) : k30_pick<false>(form);
  void* args[] = {&L};
  cudaError_t err;
  if (form == kFormGrid) {
    const int resident = k30_resident(kernel);
    if (resident <= 0) return (int)cudaErrorLaunchFailure;
    const long long want = (max_phase + 4 * kThreads - 1) / (4 * kThreads);
    const int grid = (int)(want < 1 ? 1 : want > resident ? resident : want);
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads),
                                      args, 0, stream);
  } else if (form == kFormBlock) {
    err = cudaLaunchKernel(kernel, dim3(1), dim3(kWideThreads), args, 0,
                           stream);
  } else {
    if (blocks < 1 || blocks > kMaxCluster) return (int)cudaErrorInvalidValue;
    if (blocks > 8) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3((unsigned)kWideThreads);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelExC(&cfg, kernel, args);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
