// K27 `ssa_round`: events of the batched direct-method SSA.
//
// Replaces the JAX package's `models/gillespie.py:152 ssa_batch_tm`
// (its `lax.scan` body `:194-226`, XLA; no Pallas kernel), which
// `ssa_batch` (`:239`) and `run_ssa_ensemble` (`:250`) wrap. Plain
// PyTorch version: `models/gillespie.py:ssa_round_plain`. The rule is
// `ssa_rule.cuh`: propensities, total, dt, the chosen reaction and the
// update in the XLA program's order, in float or double.
//
// One thread a trajectory, its S counts and its time in registers,
// looping over the E events of a chunk; the network (a few hundred
// bytes) sits in shared memory. A network past the shared form's limits
// (32 reactions, 8 species, 8 factors a reaction) takes the wide kernel:
// the factor lists in global memory (read by every thread of a warp at
// the same address, so from the L1 cache), the counts read and written
// in the state array, one thread a trajectory as well. Draws u [E, 2, B] come from the caller's
// generator; outputs are time-major t [E, B] float64 and n [E, S, B]
// int32, so a warp's loads and stores coalesce. Bound: bytes, the draws
// read once and the outputs written once (28 bytes an event in float32
// at S = 3); the arithmetic is a few dozen operations an event.

#include <cuda_runtime.h>

#include "ssa_rule.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k27_kernel(const SsaNet* __restrict__ net, const T* __restrict__ u,
               long long B, int E, double* t_state, int* n_state,
               double* t_out, int* n_out) {
  __shared__ SsaNet g;
  const int* src = reinterpret_cast<const int*>(net);
  int* dst = reinterpret_cast<int*>(&g);
  for (int i = threadIdx.x; i < (int)(sizeof(SsaNet) / sizeof(int));
       i += kThreads)
    dst[i] = src[i];
  __syncthreads();
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  ssa_trajectory<T>(g, u, B, E, b, t_state, n_state, t_out, n_out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k27_wide_kernel(SsaWide g, const T* __restrict__ u, long long B, int E,
                    double* t_state, int* n_state, double* t_out,
                    int* n_out) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  ssa_wide_trajectory<T>(g, u, B, E, b, t_state, n_state, t_out, n_out);
}

}  // namespace

// E events of B trajectories from their state (t_state [B], n_state
// [S, B]); ``u`` [E, 2, B] float (``is_double`` 0) or double; t_out
// [E, B], n_out [E, S, B]. The network from host arrays (reactant orders
// and stoichiometry [R, S] int32, rates [R] float64) goes to ``net_buf``
// (device scratch of at least `ckpe_ssa_net_bytes` bytes) on ``stream``.
extern "C" int ckpe_ssa_net_bytes() { return (int)sizeof(SsaNet); }

extern "C" int ckpe_ssa_rounds(const int* order, const int* stoich,
                               const double* rates, int R, int S,
                               void* net_buf, int is_double, const void* u,
                               long long B, int E, double* t_state,
                               int* n_state, double* t_out, int* n_out,
                               cudaStream_t stream) {
  SsaNet g;
  if (!ssa_build_net(order, stoich, rates, R, S, &g) || B < 1 || E < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemcpyAsync(net_buf, &g, sizeof(SsaNet), cudaMemcpyHostToDevice,
                      stream);
  if (err != cudaSuccess) return (int)err;
  if (E == 0) return 0;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  const SsaNet* dev_net = static_cast<const SsaNet*>(net_buf);
  if (is_double)
    k27_kernel<double><<<blocks, kThreads, 0, stream>>>(
        dev_net, static_cast<const double*>(u), B, E, t_state, n_state, t_out,
        n_out);
  else
    k27_kernel<float><<<blocks, kThreads, 0, stream>>>(
        dev_net, static_cast<const float*>(u), B, E, t_state, n_state, t_out,
        n_out);
  return (int)cudaGetLastError();
}

// The wide form of `ckpe_ssa_rounds`: the network as device arrays
// (`SsaWide`: fac_lo [R + 1], fac_s and fac_j [fac_lo[R]], stoich [R, S]
// int32, rates [R] float64), any R >= 1 and S >= 1.
extern "C" int ckpe_ssa_rounds_wide(const int* fac_lo, const int* fac_s,
                                    const int* fac_j, const int* stoich,
                                    const double* rates, int R, int S,
                                    int is_double, const void* u,
                                    long long B, int E, double* t_state,
                                    int* n_state, double* t_out, int* n_out,
                                    cudaStream_t stream) {
  if (R < 1 || S < 1 || B < 1 || E < 0) return (int)cudaErrorInvalidValue;
  if (E == 0) return 0;
  const SsaWide g{R, S, fac_lo, fac_s, fac_j, stoich, rates};
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  if (is_double)
    k27_wide_kernel<double><<<blocks, kThreads, 0, stream>>>(
        g, static_cast<const double*>(u), B, E, t_state, n_state, t_out,
        n_out);
  else
    k27_wide_kernel<float><<<blocks, kThreads, 0, stream>>>(
        g, static_cast<const float*>(u), B, E, t_state, n_state, t_out,
        n_out);
  return (int)cudaGetLastError();
}
