// K1: one stratified ensemble round on stacked int8 plane tapes, in place.
//
// Replaces the JAX package's `engine/ensemble.py`
// `_apply_plane_round_fsm_stacked` with `_machine_specs_planes_leveled`
// and `_machine_writes_planes`, and so the Pallas probes
// `probes/pallas_plane_round.py:fsm_kernel` and
// `probes/pallas_packed32.py:fsm_kernel_packed`, which compute the same
// round. Plain PyTorch version: `engine/ensemble.py:plane_round_plain`.
//
// Layout. Each tape is `stride` planes stacked as [stride, B, E] int8:
// plane c holds tape columns c::stride. Round `round` has phase
// s = shifts[round] in [0, stride), read here on the device. Site (b, i)
// sits at tape column s + i*stride; its window cell at offset `off` is
// plane c = (s+off) mod stride, element (i+e) mod E with
// e = floor((s+off)/stride) in {-1, 0, 1}. Division and modulo are
// floored, as `jnp.mod` / `jnp.floor_divide` are: `off` can be negative.
//
// One thread per site: read the window cells, walk the leveled decision
// DAG (reveal groups pick the branch from a cell, choose groups from the
// uniform, renormalised into the chosen branch in float64), decode the
// write spec and store the cells it writes.
//
// In place is safe: the caller's geometry check keeps one round's sites
// more than 2*span apart, so every window cell of every site is a
// distinct byte (in plane c, element m belongs to site m-e alone). No
// two threads touch the same byte, and a thread reads all its cells
// before it writes any.
//
// Bound. A round moves n_cells int8 reads and writes per site (plus 4 B
// of uniform per site for a machine with choose nodes): at B=16384,
// E=256 on ex5-msrtf-machine, 14 B x 4,194,304 sites = 58.7 MB, which is
// 17.5 us at the H100's 3.35 TB/s. The bound is bytes. What this design
// does about it: the walk reads no tables from device memory (the
// machine's plan, a few KB, is copied to shared memory per block, with
// its packed fields also stored unpacked so no lookup divides); the
// window cells stay in registers (packed 8 to a 64-bit word, the word
// count a template parameter, every cell index a compile-time constant
// after unrolling), so nothing spills to local memory; the per-round
// plane and spill of each cell are computed once per block; cells that
// the spec leaves alone are not stored; and consecutive threads touch
// consecutive bytes of a plane row. Each access is still one byte:
// loads of 16 bytes a thread are left for a later change.
//
// Arithmetic is exact: build with -fmad=false so that nothing is
// contracted; double division and subtraction are IEEE round-to-nearest,
// as on the CPU.

#include <cstdint>
#include <cuda_runtime.h>

#define MAX_WORDS 4  // window cells: at most 8 * MAX_WORDS = 32
#define PLAN_HEADER 16
#define LEVEL_WORDS 10
#define GROUP_WORDS 5

namespace {

typedef unsigned long long u64;

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  return a - floor_div(a, b) * b;
}

// words[widx] >> sh & mask, with words[0] for an out-of-range widx (the
// reference's select chain starts from words[0]).
__device__ __forceinline__ int unpack_field(const int* words, int n_words,
                                            int widx, int sh, int bits) {
  int w = (widx >= 1 && widx < n_words) ? words[widx] : words[0];
  return (w >> sh) & ((1 << bits) - 1);
}

// Field `idx` of packed `words`: from the unpacked copy where the words
// cover it, else by the reference's rule (floored index arithmetic).
__device__ __forceinline__ int field_at(const int* plan, int n_fields,
                                        int off_fields, int n_words,
                                        int off_words, int idx, int bits) {
  if (idx >= 0 && idx < n_fields) return plan[off_fields + idx];
  const int per = 31 / bits;
  return unpack_field(plan + off_words, n_words, floor_div(idx, per),
                      bits * floor_mod(idx, per), bits);
}

// Window cell `idx` (sign-extended int8) from the packed registers.
template <int NW>
__device__ __forceinline__ int cell_at(const u64 (&w)[NW], int idx) {
  u64 s = w[0];
#pragma unroll
  for (int q = 1; q < NW; ++q)
    if ((idx >> 3) == q) s = w[q];
  return (int)(int8_t)(uint8_t)(s >> (8 * (idx & 7)));
}

// Address of window cell k of the site at (row, i), from the per-block
// plane base and spill. 32-bit: the wrapper keeps the planes under 2^31
// symbols.
__device__ __forceinline__ int cell_addr(const int* base, const int* spill,
                                         int k, int row, int i, int E) {
  int col = i + spill[k];
  if (col < 0 || col >= E) col = floor_mod(col, E);
  return base[k] + row + col;
}

// At most 32 registers a thread at 256 threads a block, so that a whole
// SM's worth of warps is resident: the walk is latency-bound, and the
// window's addresses are recomputed at the write rather than held.
template <int NW>
__global__ void __launch_bounds__(256, 8)
    plane_round_kernel(int8_t* __restrict__ p_st, int8_t* __restrict__ d_st,
                       const float* __restrict__ uniforms,
                       const int* __restrict__ shifts, int round,
                       const int* __restrict__ gplan, int n_int,
                       const double* __restrict__ gfplan, int n_float, int B,
                       int E, int stride) {
  extern __shared__ double smem[];
  __shared__ int cell_base[8 * MAX_WORDS];
  __shared__ int cell_spill[8 * MAX_WORDS];
  double* fplan = smem;
  int* plan = reinterpret_cast<int*>(smem + n_float);
  for (int k = threadIdx.x; k < n_float; k += blockDim.x) fplan[k] = gfplan[k];
  for (int k = threadIdx.x; k < n_int; k += blockDim.x) plan[k] = gplan[k];
  const int n_p = gplan[0], n_cells = gplan[8];
  if (threadIdx.x < n_cells) {
    // Plane and spill of window cell k at this round's phase (floored:
    // the offset can be negative).
    const int k = threadIdx.x;
    const int off = k >= n_p ? gplan[3] + (k - n_p) : gplan[2] + k;
    const int a = shifts[round] + off;
    cell_base[k] = floor_mod(a, stride) * B * E;
    cell_spill[k] = floor_div(a, stride);
  }
  __syncthreads();

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * E) return;
  const int i = t % E;
  const int row = t - i;

  u64 w[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) w[q] = 0ull;
#pragma unroll
  for (int k = 0; k < 8 * NW; ++k) {
    if (k < n_cells) {
      const int8_t v = (k >= n_p ? d_st : p_st)[cell_addr(
          cell_base, cell_spill, k, row, i, E)];
      w[k >> 3] |= (u64)(uint8_t)v << (8 * (k & 7));
    }
  }

  // Level-synchronous walk: live states are S + local id, terminal
  // states (< S) are the write spec.
  const int S = plan[4], n_levels = plan[5];
  int state = S;
  double u = uniforms ? (double)uniforms[t] : 0.0;
  for (int l = 0; l < n_levels; ++l) {
    const int* lv = plan + PLAN_HEADER + LEVEL_WORDS * l;
    const int n_cg = lv[0];
    const int* cg = plan + lv[1];
    int branch = 0;
    if (n_cg > 0) {
      branch = cell_at<NW>(w, cg[0]);
      for (int g = 1; g < n_cg; ++g)
        if (state >= S + cg[2 * g + 1]) branch = cell_at<NW>(w, cg[2 * g]);
    }
    const int n_groups = lv[2];
    for (int g = 0; g < n_groups; ++g) {
      const int* grp = plan + lv[3] + GROUP_WORDS * g;
      if (state < S + grp[0] || state > S + grp[1]) continue;
      const int n_br = grp[2];
      const double* cum = fplan + grp[3];
      const double* width = cum + (n_br - 1);
      int bb = 0;
      double lo = 0.0, wd = width[0];
      for (int j = 1; j < n_br; ++j) {
        if (u >= cum[j - 1]) {
          bb = j;
          lo = cum[j - 1];
          wd = width[j];
        }
      }
      branch = bb;
      if (grp[4]) {
        // Single branch while the reference's uniform is still float32.
        u = (double)__fdiv_rn((float)u, (float)wd);
      } else {
        u = __ddiv_rn(__dsub_rn(u, lo), wd);
      }
    }
    const int idx = max(state - S, 0) * lv[4] + branch;
    const int nxt = field_at(plan, lv[8], lv[9], lv[6], lv[7], idx, lv[5]);
    if (state >= S) state = nxt;
  }

  // Write phase: field `state` of each cell's write words is
  // (writes? << (wr_bits-1) | symbol).
  const int wr_bits = plan[6], off_wr = plan[7];
  const int off_wf = plan[9], n_wf = plan[10];
  const bool direct = state >= 0 && state < n_wf;
#pragma unroll
  for (int k = 0; k < 8 * NW; ++k) {
    if (k < n_cells) {
      const int* wr = plan + off_wr + 2 * k;
      const int f = direct ? plan[off_wf + state * n_cells + k]
                           : field_at(plan, 0, 0, wr[0], wr[1], state,
                                      wr_bits);
      if ((f >> (wr_bits - 1)) == 1)
        (k >= n_p ? d_st : p_st)[cell_addr(cell_base, cell_spill, k, row,
                                           i, E)] =
            (int8_t)(f & ((1 << (wr_bits - 1)) - 1));
    }
  }
}

}  // namespace

// n_cells must equal the plan's; it picks the register width.
extern "C" int ckpe_plane_round(void* p_st, void* d_st, const void* uniforms,
                                const void* shifts, int round,
                                const void* plan, int n_int,
                                const void* fplan, int n_float, int n_cells,
                                int B, int E, int stride, void* stream) {
  const long long n_sites = (long long)B * E;
  if (n_sites == 0) return (int)cudaGetLastError();
  if (n_sites * stride >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n_cells < 1 || n_cells > 8 * MAX_WORDS)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_sites + threads - 1) / threads);
  const size_t smem = (size_t)n_float * sizeof(double) + n_int * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
#define CKPE_LAUNCH(NW)                                                    \
  plane_round_kernel<NW><<<blocks, threads, smem, st>>>(                   \
      (int8_t*)p_st, (int8_t*)d_st, (const float*)uniforms,                \
      (const int*)shifts, round, (const int*)plan, n_int,                  \
      (const double*)fplan, n_float, B, E, stride)
  switch ((n_cells + 7) / 8) {
    case 1: CKPE_LAUNCH(1); break;
    case 2: CKPE_LAUNCH(2); break;
    case 3: CKPE_LAUNCH(3); break;
    default: CKPE_LAUNCH(4); break;
  }
#undef CKPE_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* ckpe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
