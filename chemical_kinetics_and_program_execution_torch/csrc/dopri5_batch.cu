// K29 `dopri5_batch`: the autocatalysis sweep's adaptive dopri5, a member
// a thread.
//
// Replaces the JAX package's `models/autocatalysis.py:57 _solve_batch`
// (a vmap of `ode/dopri5.py:48 odeint_dopri5` over the rate law
// `models/autocatalysis.py:29 dy_dt`; XLA's batched `while_loop`, no
// Pallas kernel). Plain PyTorch version: `models/autocatalysis.py:
// _solve_batch_plain`; the rule is `dopri5_rule.cuh`.
//
// One thread a member runs its whole solve: the state, the 7 stages and
// the controller in registers, the rate law compiled in, the tableau (K6's
// second table) a launch argument, every sample it reaches written to
// ys[member, i, :]. Members step on their own: one that finishes early
// idles, as the vmapped `while_loop` leaves a finished member's state.
// Its arithmetic is the plain version's: every operation rounded on its
// own (the rule's intrinsics), and the unit compiled apart with
// contraction allowed (`cuda.FMAD_SOURCES`) so that the math library's
// `pow` has the bits of PyTorch's.
// Bound: the serial chain of the member with the most steps (six
// rate-law evaluations, three powers and a square root a step, one after
// the other); bytes (the samples written once) and the card's float64
// rate give far less.

#include <cuda_runtime.h>

#include "dopri5_rule.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    k29_kernel(Dp5Tab tab, int B, const double* __restrict__ y0,
               const double* __restrict__ params,
               const double* __restrict__ ts, int n_out, double rtol,
               double atol, long long max_steps, double* ys, int* n_acc,
               int* n_rej) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  dp5_member(tab, y0 + 3LL * b, params + (long long)kAcParams * b, ts, n_out,
             rtol, atol, max_steps, ys + 3LL * n_out * b, n_acc + b,
             n_rej + b);
}

}  // namespace

// B members: y0 [B, 3], params [B, 8], sample times ts [n_out] (device);
// ys [B, n_out, 3] (zeros from the caller where no sample is written),
// n_acc and n_rej [B] int32. ``coef`` [8, 7] and ``has`` [8, 7] (host)
// are the tableau rows: A rows 1-6, B5, the error row.
extern "C" int ckpe_dopri5_batch(const double* coef, const int* has, int B,
                                 const double* y0, const double* params,
                                 const double* ts, int n_out, double rtol,
                                 double atol, long long max_steps, double* ys,
                                 int* n_acc, int* n_rej,
                                 cudaStream_t stream) {
  if (B < 1 || n_out < 1 || max_steps < 0) return (int)cudaErrorInvalidValue;
  Dp5Tab tab;
  for (int r = 0; r < kDp5Rows; ++r)
    for (int j = 0; j < kDp5Stages; ++j) {
      tab.coef[r][j] = coef[r * kDp5Stages + j];
      tab.has[r][j] = has[r * kDp5Stages + j];
    }
  k29_kernel<<<(unsigned)((B + kThreads - 1) / kThreads), kThreads, 0,
               stream>>>(tab, B, y0, params, ts, n_out, rtol, atol, max_steps,
                         ys, n_acc, n_rej);
  return (int)cudaGetLastError();
}
