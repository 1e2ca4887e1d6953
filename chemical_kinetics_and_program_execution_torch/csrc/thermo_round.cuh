// K23 `sigma_round` and K24 `ledger_round`: K11's rolled FSM round with
// each member's entropy ledger, on [B, L] int8 tapes, in place.
//
// Replaces the scan bodies of the JAX package's `ops/thermo.py:339
// run_ensemble_sigma` (`:369-382`, with `:322 _round_sigma`) and `:424
// run_ensemble_ledger` (`:461-483`): XLA programs that roll both tapes by
// the round's shift (or each member's change of phase), walk the rolled
// blocks, gather (window rank, spec) tables or per-symbol potentials,
// sum the sites a member and roll back; no Pallas kernel. Plain PyTorch
// versions: `ops/thermo.py:sigma_round_plain`, `ledger_round_plain`.
//
// Sources. The generated unit of a machine (`engine/k1_source.py`)
// includes this file after `lattice_round.cuh`, so a site is K11's own
// (`k11_site`: the addressing of `k11_col`, K1's exact walk and writes,
// with the cells before and after the writes returned): the same draws
// land on the same cells as in K11 and in the reference, whose thermo
// rounds always roll over [0, L).
//
// Design: one thread a member walks its E sites in site order. Site e at
// shift s reads window cell j of a tape with read offset lo at column
// (s + lo + e*stride + j) mod L and stores only the cells its spec
// changes (the caller's geometry check keeps a member's windows
// disjoint). K23 forms the combined window rank (program cells then data
// cells, big-endian; out-of-range symbols by the reference's gather
// rule), reads sigma[w, spec] and irrev[w, spec], takes 0
// where the jump is irreversible and counts it. K24 forms dg = sum_c
// (G_c[old] - G_c[new]) from 0 in cell order, then beta_eff * dg, adds
// it to its spec's share and counts the spec. A member's site
// increments are summed from 0 in site order and that sum is added once
// to its float64 sigma. The member owns its rows, so nothing is atomic,
// and the plain versions repeat this order bit for bit.
//
// Bound: bytes. A round reads the cells the walk reveals and the written
// cells some spec leaves alone, writes the cells some spec writes
// (`k1_source.cell_traffic`), a byte each, reads a float32 uniform a site
// for a machine with choose nodes, the tables once (K23: float64 sigma
// and a byte of irrev a (window, spec); K24: two float64 potentials a
// symbol) and reads and writes the per-member accumulators (K23: sigma
// float64 and n_irrev int32; K24: sigma, and counts int32 and spec_sig
// float64 a spec).

#pragma once

// The reference's gather index rule for a table of n rows: a negative
// index plus n, then clamped into [0, n) (`ops/thermo.py:_gather_index`).
K1_FN long long k23_index(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

K1_FN long long k23_base(const int* shifts, int per_member, int b, int e,
                         int L, int E) {
  return (long long)shifts[per_member ? b : 0] + (long long)e * (L / E);
}

// Member b of a K23 round: its E sites in order; sigma[b] += their sum
// from 0, n_irrev[b] += their irreversible count. The tables hold
// K1_SIZE_A^K1_N_CELLS rows of S specs.
K1_FN void k23_member(int b, int8_t* p, int8_t* d, const float* u,
                      const int* shifts, int per_member, int L, int E,
                      const double* sig_tab, const uint8_t* irr_tab, int S,
                      double* sigma, int* n_irrev) {
  long long rows = 1;
#pragma unroll
  for (int k = 0; k < K1_N_CELLS; ++k) rows *= K1_SIZE_A;
  int8_t* prow = p + (long long)b * L;
  int8_t* drow = d + (long long)b * L;
  double s = 0.0;
  int nirr = 0;
  for (int e = 0; e < E; ++e) {
    int c[K1_N_CELLS], y[K1_N_CELLS];
    const int spec = k11_site(
        prow, drow, L, k23_base(shifts, per_member, b, e, L, E),
        K1_CHOOSE ? (double)u[(long long)b * E + e] : 0.0, nullptr, c, y);
    long long w = 0;
#pragma unroll
    for (int k = 0; k < K1_N_CELLS; ++k) w = w * K1_SIZE_A + c[k];
    const long long at = k23_index(w, rows) * S + spec;
    const bool irr = irr_tab[at] != 0;
    s = s + (irr ? 0.0 : sig_tab[at]);
    nirr += irr ? 1 : 0;
  }
  sigma[b] = sigma[b] + s;
  n_irrev[b] += nirr;
}

// Member b of a K24 round: its E sites in order; per site beta_eff * dg
// with dg = sum_c (G_c[old] - G_c[new]) from 0 in cell order, added to
// spec_sig[b, spec] and counted in counts[b, spec]; sigma[b] += the
// sites' sum from 0.
K1_FN void k24_member(int b, int8_t* p, int8_t* d, const float* u,
                      const int* shifts, int per_member, int L, int E,
                      const double* g_prog, const double* g_data,
                      double beta_eff, int S, double* sigma, int* counts,
                      double* spec_sig) {
  int8_t* prow = p + (long long)b * L;
  int8_t* drow = d + (long long)b * L;
  int* cnt = counts + (long long)b * S;
  double* ss = spec_sig + (long long)b * S;
  double s = 0.0;
  for (int e = 0; e < E; ++e) {
    int c[K1_N_CELLS], y[K1_N_CELLS];
    const int spec = k11_site(
        prow, drow, L, k23_base(shifts, per_member, b, e, L, E),
        K1_CHOOSE ? (double)u[(long long)b * E + e] : 0.0, nullptr, c, y);
    double dg = 0.0;
#pragma unroll
    for (int k = 0; k < K1_N_CELLS; ++k) {
      const double* g = k < K1_N_P ? g_prog : g_data;
      dg = dg + (g[k23_index(c[k], K1_SIZE_A)]
                 - g[k23_index(y[k], K1_SIZE_A)]);
    }
    const double sig = beta_eff * dg;
    s = s + sig;
    cnt[spec] += 1;
    ss[spec] = ss[spec] + sig;
  }
  sigma[b] = sigma[b] + s;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(K1_THREADS)
    k23_kernel(int8_t* __restrict__ p, int8_t* __restrict__ d,
               const float* __restrict__ u, const int* __restrict__ shifts,
               int per_member, int B, int L, int E,
               const double* __restrict__ sig_tab,
               const uint8_t* __restrict__ irr_tab, int S,
               double* __restrict__ sigma, int* __restrict__ n_irrev) {
  const int b = blockIdx.x * K1_THREADS + threadIdx.x;
  if (b >= B) return;
  k23_member(b, p, d, u, shifts, per_member, L, E, sig_tab, irr_tab, S,
             sigma, n_irrev);
}

__global__ void __launch_bounds__(K1_THREADS)
    k24_kernel(int8_t* __restrict__ p, int8_t* __restrict__ d,
               const float* __restrict__ u, const int* __restrict__ shifts,
               int per_member, int B, int L, int E,
               const double* __restrict__ g_prog,
               const double* __restrict__ g_data, double beta_eff, int S,
               double* __restrict__ sigma, int* __restrict__ counts,
               double* __restrict__ spec_sig) {
  const int b = blockIdx.x * K1_THREADS + threadIdx.x;
  if (b >= B) return;
  k24_member(b, p, d, u, shifts, per_member, L, E, g_prog, g_data, beta_eff,
             S, sigma, counts, spec_sig);
}

// Rounds [k0, k0+n) of a K23 or K24 run, one launch a round on
// `stream`: launch(blocks, u, s) starts round k0+j's kernel on uniforms
// u = [j*B*E, (j+1)*B*E) (nullptr for a machine without choose nodes)
// and shifts s = shifts[k0+j] (shared) or shifts[(k0+j)*B + b] (per
// member). Returns the first launch error, or 0.
template <class Launch>
static inline int k23_rounds(const void* uniforms, const void* shifts,
                             int per_member, int k0, int n, int B, int L,
                             int E, int S, Launch launch) {
  if (k11_bad_geometry(B, L, E) || S <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((B + K1_THREADS - 1) / K1_THREADS);
  const long long sites = (long long)B * E;
  for (int j = 0; j < n; ++j) {
    launch(blocks, K1_CHOOSE ? (const float*)uniforms + j * sites : nullptr,
           (const int*)shifts + (long long)(k0 + j) * (per_member ? B : 1));
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

// Rounds [k0, k0+n) of a sigma run (`k23_rounds`).
extern "C" int ckpe_k23_rounds(void* p, void* d, const void* uniforms,
                               const void* shifts, int per_member, int k0,
                               int n, int B, int L, int E,
                               const void* sig_tab, const void* irr_tab,
                               int S, void* sigma, void* n_irrev,
                               void* stream) {
  return k23_rounds(
      uniforms, shifts, per_member, k0, n, B, L, E, S,
      [&](unsigned blocks, const float* u, const int* s) {
        k23_kernel<<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
            (int8_t*)p, (int8_t*)d, u, s, per_member, B, L, E,
            (const double*)sig_tab, (const uint8_t*)irr_tab, S,
            (double*)sigma, (int*)n_irrev);
      });
}

// Rounds [k0, k0+n) of a ledger run (`k23_rounds`).
extern "C" int ckpe_k24_rounds(void* p, void* d, const void* uniforms,
                               const void* shifts, int per_member, int k0,
                               int n, int B, int L, int E,
                               const void* g_prog, const void* g_data,
                               double beta_eff, int S, void* sigma,
                               void* counts, void* spec_sig, void* stream) {
  return k23_rounds(
      uniforms, shifts, per_member, k0, n, B, L, E, S,
      [&](unsigned blocks, const float* u, const int* s) {
        k24_kernel<<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
            (int8_t*)p, (int8_t*)d, u, s, per_member, B, L, E,
            (const double*)g_prog, (const double*)g_data, beta_eff, S,
            (double*)sigma, (int*)counts, (double*)spec_sig);
      });
}

#else

// The kernels' per-member bodies for every member of one round on the
// host (the CPU test of the generated unit).
extern "C" int ckpe_k23_host_round(int8_t* p, int8_t* d, const float* u,
                                   const int* shifts, int per_member, int B,
                                   int L, int E, const double* sig_tab,
                                   const uint8_t* irr_tab, int S,
                                   double* sigma, int* n_irrev) {
  if (E <= 0 || L % E != 0 || S <= 0) return 1;
  for (int b = 0; b < B; ++b)
    k23_member(b, p, d, u, shifts, per_member, L, E, sig_tab, irr_tab, S,
               sigma, n_irrev);
  return 0;
}

extern "C" int ckpe_k24_host_round(int8_t* p, int8_t* d, const float* u,
                                   const int* shifts, int per_member, int B,
                                   int L, int E, const double* g_prog,
                                   const double* g_data, double beta_eff,
                                   int S, double* sigma, int* counts,
                                   double* spec_sig) {
  if (E <= 0 || L % E != 0 || S <= 0) return 1;
  for (int b = 0; b < B; ++b)
    k24_member(b, p, d, u, shifts, per_member, L, E, g_prog, g_data,
               beta_eff, S, sigma, counts, spec_sig);
  return 0;
}

#endif
