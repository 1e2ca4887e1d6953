// K11 `lattice_round`: one FSM round of the ensemble on [B, L] int8
// tapes, in place, at a shift shared by the batch or one a member; and
// first passage, K11's rounds with K12's scan after each.
//
// Replaces the JAX package's `engine/ensemble.py:989
// _apply_lattice_round_fsm` with `:913 _roll_cols` and `:1229
// _roll_rows` (XLA programs: rolls of both tapes by the round's shift,
// the walk on the rolled blocks, the roll back; for independent sites a
// gather a member to move each tape by the change of its phase; no
// Pallas kernel), the path of `run_ensemble(independent_sites=True)`,
// of strides above the plane path's 64 and of `first_passage_times`.
// Plain PyTorch version: `engine/ensemble.py:lattice_round_plain`.
//
// Sources. The generated unit of a machine (`engine/k1_source.py`)
// includes this file after `plane_round.cuh`, so the round walks the
// machine's own code: K1's exact walk (`k1_walk_exact`, one site at a
// time, any int8 symbol) and K1's writes (`k1_write_lanes`, lane 0).
//
// Design: one thread a site (b, e). Site e of member b at shift s reads
// window cell j of a tape with read offset lo at column
// (s + lo + e*stride + j) mod L, floored: the reference's roll by the
// shift, its roll by each member's phase and its reshape land the same
// cells on the same uniform, so no tape moves. The caller's geometry
// check keeps a round's windows disjoint (sites more than 2*span apart,
// or one a member), and a thread stores only the cells its spec
// changes. One launch a round; all rounds of a call from one C call.
//
// Tempered rounds (a unit with K1_LOGP: chooses sampled from q ~ p^tau,
// tau != 1) replace the FSM route of the JAX package's
// `engine/ensemble.py:2090 _blocked_rounds` with `:1170
// _apply_plane_round_fsm_stacked(want_logp=True)` and the increments of
// `:705 _machine_specs_planes_leveled` (the weighted frontier's rounds;
// its [E, K] planes hold the same site lattice as a shared shift here).
// One thread a member walks its E sites in order, each site's float32
// increments summed level by level, the sites' sums added in float32
// from 0 in site order, and that sum added to the member's float64
// log-weight: the order of `ensemble.lattice_round_plain(lw=...)`.
//
// Bound: bytes. A round must read the cells the walk reveals and the
// written cells some spec leaves alone, write the cells some spec
// writes (`k1_source.cell_traffic`), a byte each, and read a float32
// uniform a site for a machine with choose nodes: 41.9 MB at B=16384,
// E=256 on ex5-msrtf-machine, 12.5 us at 3.35 TB/s, as K1. Unlike K1's
// planes, the [B, L] layout puts a round's sites 16 bytes apart at
// stride 16, so every 32-byte sector of both tapes is read and written.

#pragma once

K1_FN int k11_col(long long a, int L) {
  long long r = a % L;
  return (int)(r < 0 ? r + L : r);
}

#ifndef K1_LOGP
#define K1_LOGP 0
#endif

// One site on member rows prow, drow of length L, at base = shift +
// e*stride, with uniform u; returns the fired spec. In a tempered unit,
// with lp non-null, the walk adds the site's increments to *lp; with
// c_out and y_out non-null, the site's cells before and after its writes
// go there (K23's and K24's sums read them).
K1_FN int k11_site(int8_t* prow, int8_t* drow, int L, long long base,
                   double u, float* lp = nullptr, int* c_out = nullptr,
                   int* y_out = nullptr) {
  int col[K1_N_CELLS];
  int c[K1_N_CELLS];
#pragma unroll
  for (int k = 0; k < K1_N_CELLS; ++k) {
    const int off = k < K1_N_P ? K1_P_LO + k : K1_D_LO + (k - K1_N_P);
    col[k] = k11_col(base + off, L);
    c[k] = (int)(k < K1_N_P ? prow : drow)[col[k]];
  }
#if K1_LOGP
  const uint32_t spec =
      (uint32_t)(lp ? k1_walk_exact_logp(c, u, lp) : k1_walk_exact(c, u));
#else
  (void)lp;
  const uint32_t spec = (uint32_t)k1_walk_exact(c, u);
#endif
#pragma unroll
  for (int k = 0; k < K1_N_CELLS; ++k) {
    if (c_out) c_out[k] = c[k];
    if (y_out) y_out[k] = c[k];
    if (!k1_written(k)) continue;
    const uint32_t x = (uint8_t)c[k];
    const uint32_t y = k1_write_lanes(k, spec, x) & 0xffu;
    if (y != x) {
      (k < K1_N_P ? prow : drow)[col[k]] = (int8_t)(uint8_t)y;
      if (y_out) y_out[k] = (int)(int8_t)(uint8_t)y;
    }
  }
  return (int)spec;
}

// Site t = b*E + e of a round.
K1_FN void k11_thread(long long t, int8_t* p, int8_t* d, const float* u,
                      const int* shifts, int per_member, int L, int E) {
  const int b = (int)(t / E);
  const int e = (int)(t - (long long)b * E);
  const long long base =
      (long long)shifts[per_member ? b : 0] + (long long)e * (L / E);
  k11_site(p + (long long)b * L, d + (long long)b * L, L, base,
           K1_CHOOSE ? (double)u[t] : 0.0);
}

#if K1_LOGP
// Member b of a tempered round at the shared shift: its E sites in
// order, then lw[b] += the float32 sum of their increments.
K1_FN void k11_member_logp(int b, int8_t* p, int8_t* d, const float* u,
                           const int* shifts, int L, int E, double* lw) {
  float s = 0.0f;
  for (int e = 0; e < E; ++e) {
    float lp = 0.0f;
    k11_site(p + (long long)b * L, d + (long long)b * L, L,
             (long long)shifts[0] + (long long)e * (L / E),
             (double)u[(long long)b * E + e], &lp);
    s = s + lp;
  }
  lw[b] = lw[b] + (double)s;
}
#endif

#ifdef __CUDACC__

#if K1_LOGP
__global__ void __launch_bounds__(K1_THREADS)
    k11_logp_kernel(int8_t* __restrict__ p, int8_t* __restrict__ d,
                    const float* __restrict__ u,
                    const int* __restrict__ shifts, int B, int L, int E,
                    double* __restrict__ lw) {
  const int b = blockIdx.x * K1_THREADS + threadIdx.x;
  if (b >= B) return;
  k11_member_logp(b, p, d, u, shifts, L, E, lw);
}

// Tempered rounds [k0, k0+n) at shared shifts, one launch a round:
// round k0+j reads shifts[k0+j] and uniforms [j*B*E, (j+1)*B*E) and adds
// each member's increments to lw [B] float64. Returns the first launch
// error, or 0.
extern "C" int ckpe_k11_rounds_logp(void* p, void* d, const void* uniforms,
                                    const void* shifts, int k0, int n,
                                    int B, int L, int E, void* lw,
                                    void* stream) {
  if (E <= 0 || L % E != 0 || (long long)B * L >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((B + K1_THREADS - 1) / K1_THREADS);
  for (int j = 0; j < n; ++j) {
    k11_logp_kernel<<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
        (int8_t*)p, (int8_t*)d,
        (const float*)uniforms + (long long)j * B * E,
        (const int*)shifts + k0 + j, B, L, E, (double*)lw);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}
#endif

__global__ void __launch_bounds__(K1_THREADS)
    k11_kernel(int8_t* __restrict__ p, int8_t* __restrict__ d,
               const float* __restrict__ u, const int* __restrict__ shifts,
               int per_member, int B, int L, int E) {
  const long long t = (long long)blockIdx.x * K1_THREADS + threadIdx.x;
  if (t >= (long long)B * E) return;
  k11_thread(t, p, d, u, shifts, per_member, L, E);
}

static inline int k11_launch(void* p, void* d, const float* u,
                             const int* shifts, int per_member, int B, int L,
                             int E, cudaStream_t st) {
  const long long sites = (long long)B * E;
  const unsigned blocks = (unsigned)((sites + K1_THREADS - 1) / K1_THREADS);
  k11_kernel<<<blocks, K1_THREADS, 0, st>>>(
      (int8_t*)p, (int8_t*)d, K1_CHOOSE ? u : nullptr, shifts, per_member, B,
      L, E);
  return (int)cudaGetLastError();
}

static inline bool k11_bad_geometry(int B, int L, int E) {
  return E <= 0 || L % E != 0 || (long long)B * L >= (1LL << 31);
}

// Rounds [k0, k0+n) of a run, one launch a round on `stream`: round k0+j
// reads shifts[k0+j] (shared) or shifts[(k0+j)*B + b] (per member) on the
// device and uniforms [j*B*E, (j+1)*B*E) (ignored by a machine without
// choose nodes). Returns the first launch error, or 0.
extern "C" int ckpe_k11_rounds(void* p, void* d, const void* uniforms,
                               const void* shifts, int per_member, int k0,
                               int n, int B, int L, int E, void* stream) {
  if (k11_bad_geometry(B, L, E)) return (int)cudaErrorInvalidValue;
  const long long sites = (long long)B * E;
  if (sites == 0 || n <= 0) return (int)cudaGetLastError();
  for (int j = 0; j < n; ++j) {
    const int rc = k11_launch(
        p, d, (const float*)uniforms + j * sites,
        (const int*)shifts + (long long)(k0 + j) * (per_member ? B : 1),
        per_member, B, L, E, (cudaStream_t)stream);
    if (rc) return rc;
  }
  return 0;
}

// K12's entry point (`pattern_scan.cu:ckpe_pattern_scan`), called by
// address.
typedef int (*k11_scan_fn)(const void* tape, int elem, int B, int L,
                           const int* pattern, int P, int mode, void* out,
                           double* t_hit, const double* t_now, void* stream);

// First-passage rounds [k0, k0+n): round k0+j is a K11 launch at the
// shared shift shifts[k0+j], then K12's update of t_hit [B] on the data
// tape (data_tape) or the program tape at time times[k0+j+1], both on
// `stream`. Returns the first launch error, or 0.
extern "C" int ckpe_k11_first_passage(void* p, void* d, const void* uniforms,
                                      const void* shifts, int k0, int n,
                                      int B, int L, int E, int data_tape,
                                      const void* pattern, int P,
                                      void* t_hit, const void* times,
                                      void* scan, void* stream) {
  if (k11_bad_geometry(B, L, E) || !scan) return (int)cudaErrorInvalidValue;
  const long long sites = (long long)B * E;
  if (sites == 0 || n <= 0) return (int)cudaGetLastError();
  const k11_scan_fn fn = (k11_scan_fn)scan;
  for (int j = 0; j < n; ++j) {
    int rc = k11_launch(p, d, (const float*)uniforms + j * sites,
                        (const int*)shifts + k0 + j, 0, B, L, E,
                        (cudaStream_t)stream);
    if (rc) return rc;
    rc = fn(data_tape ? d : p, 1, B, L, (const int*)pattern, P, 2, nullptr,
            (double*)t_hit, (const double*)times + k0 + j + 1, stream);
    if (rc) return rc;
  }
  return 0;
}

#else

// The kernel's per-thread body for every site of one round on the host
// (the CPU test of the generated unit).
extern "C" int ckpe_k11_host_round(int8_t* p, int8_t* d, const float* u,
                                   const int* shifts, int per_member, int B,
                                   int L, int E) {
  if (E <= 0 || L % E != 0) return 1;
  for (long long t = 0; t < (long long)B * E; ++t)
    k11_thread(t, p, d, u, shifts, per_member, L, E);
  return 0;
}

#if K1_LOGP
// The tempered kernel's per-member body for one round on the host.
extern "C" int ckpe_k11_host_round_logp(int8_t* p, int8_t* d, const float* u,
                                        const int* shifts, int B, int L,
                                        int E, double* lw) {
  if (E <= 0 || L % E != 0) return 1;
  for (int b = 0; b < B; ++b) k11_member_logp(b, p, d, u, shifts, L, E, lw);
  return 0;
}
#endif

#endif
