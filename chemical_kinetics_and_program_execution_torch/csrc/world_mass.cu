// K9 `world_mass`: a pruned program's measured world mass on the card.
//
// Replaces the mass of the JAX package's `engine/dense.py:565-580`
// (`make_dense_dy_dt(with_mass=True)`: `jnp.sum(m_const *
// guarded_ratio_prod(pyr, m_num, m_den))`, an XLA program; no Pallas
// kernel). Plain PyTorch version: `engine/dense.py:world_mass_plain`.
// It reads the pyramid that K3 has just built for the same p (p below
// the state size, K3's levels above: `compile.two_pointer_index`) and
// the program's mass tables: m_num, m_den int32 [W, C] (padded with the
// 1-slot) and m_const float64 [W], over every enumerated world (W = 9,912
// for ex6-mini-bff-self at cl_k 3 and threshold 1e-7, C = 21). Its own
// launch after K3 and K5 (`dense.py:dense_rhs`): an RHS with mass takes
// three launches at cl_k 3 (K3 1, K5 1, K9 1).
//
// The rule is `mass_rule.cuh`: K4's world weight, one fixed order of the
// sum (block partials, then the last block to finish sums them, as K6's
// norms: a `__threadfence` and an atomic ticket that it resets). The
// partials and the ticket are the caller's scratch, the mass its own
// tensor.
//
// Bound: bytes, the chains (8 C bytes a world), m_const and the
// pyramid entries they name, each read once. The pyramid is small
// (1,887 doubles at A = 12, k = 3: 15 KB) and each world's chain reads
// it at 2 C scattered places, so a block stages all of it in shared
// memory when it fits in 48 KB (the one Hopper feature this kernel
// uses); a larger one is read through L1 and L2.

#include <cuda_runtime.h>

#include "mass_rule.cuh"

namespace {

constexpr unsigned kStageDoubles = 48 * 1024 / sizeof(double);

struct K9Args {
  const double* p;
  const double* low;
  unsigned n_state, n_pyr;  // p's entries; p's and low's together
  K4Pairs worlds;           // the mass tables
  int n_worlds;
  double* partial;          // one a block
  unsigned* ticket;         // 0 between launches
  double* out;
};

__device__ __forceinline__ double block_tree(double v, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = kK9Threads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w)
      red[threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + w];
    __syncthreads();
  }
  return red[0];
}

template <bool kStaged>
__global__ void __launch_bounds__(kK9Threads) k9_mass_kernel(K9Args g) {
  extern __shared__ double pyr[];
  __shared__ double red[kK9Threads];
  __shared__ bool last;
  K5Ctx c;
  c.n_state = g.n_state;
  c.p = g.p;
  c.low = g.low;
  if (kStaged) {
    for (unsigned x = threadIdx.x; x < g.n_pyr; x += kK9Threads)
      pyr[x] = x < g.n_state ? g.p[x] : g.low[x - g.n_state];
    __syncthreads();
    c.p = pyr;
    c.low = pyr + g.n_state;
  }
  const double s = k9_thread_sum(c, g.worlds, g.n_worlds,
                                 blockIdx.x * kK9Threads + threadIdx.x,
                                 gridDim.x * kK9Threads);
  const double part = block_tree(s, red);
  if (threadIdx.x == 0) {
    g.partial[blockIdx.x] = part;
    __threadfence();  // the partial is visible before the ticket counts it
    last = atomicAdd(g.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double u = 0.0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kK9Threads)
    u = u + __ldcg(g.partial + b);
  __syncthreads();  // every thread has read red[0] of the first tree
  const double mass = block_tree(u, red);
  if (threadIdx.x == 0) {
    *g.out = mass;
    *g.ticket = 0u;
  }
}

}  // namespace

// The world mass into *out, one launch. p [n_state] and low [n_low] are
// the pyramid (K3's levels below p); num, den [n_worlds, chain] and
// m_const [n_worlds] the mass tables; scratch holds 1,024 partials and
// the ticket (an unsigned, 0 between calls) in the first bytes of
// scratch[1024].
extern "C" int ckpe_world_mass(const double* p, const double* low,
                               long long n_state, long long n_low,
                               const int* num, const int* den,
                               const double* m_const, int chain, int n_worlds,
                               double* scratch, double* out,
                               cudaStream_t stream) {
  if (chain < 1 || n_worlds < 1 || n_state < 1 || n_low < 1 ||
      n_state + n_low >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  K9Args g;
  g.p = p;
  g.low = low;
  g.n_state = (unsigned)n_state;
  g.n_pyr = (unsigned)(n_state + n_low);
  g.worlds.num = num;
  g.worlds.den = den;
  g.worlds.w_const = m_const;
  g.worlds.csr_ptr = nullptr;
  g.worlds.chain = chain;
  g.n_worlds = n_worlds;
  g.partial = scratch;
  g.ticket = reinterpret_cast<unsigned*>(scratch + kK9MaxBlocks);
  g.out = out;
  const int grid = k9_blocks(n_worlds);
  if (g.n_pyr <= kStageDoubles)
    k9_mass_kernel<true><<<grid, kK9Threads, g.n_pyr * sizeof(double),
                           stream>>>(g);
  else
    k9_mass_kernel<false><<<grid, kK9Threads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}
