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
// Design. K23: site e at shift s reads window cell j of a tape with read
// offset lo at column (s + lo + e*stride + j) mod L and stores only the
// cells its spec changes (the caller's geometry check keeps a member's
// windows disjoint). K23 forms the combined window rank (program cells
// then data cells, big-endian; out-of-range symbols by the reference's
// gather rule), reads sigma[w, spec] and irrev[w, spec], takes 0 where
// the jump is irreversible and counts it; a member's site entries are
// summed from 0 in site order and that sum is added once to its float64
// sigma. Resident rounds, in K24's form (below): a block owns a tile of
// members for every round of a C call, both rows (an odd count of words
// a row), sigma and n_irrev in shared memory, and the tables too where
// they fit (ex2's 16 x 3; the caller chooses by their size,
// `ops/thermo.py:k23_tile`). A round's walk runs four sites a thread by
// K1's lane walk where E % 4 == 0, else a site a thread, and stages each
// site's entry (0.0 where irreversible) and flag; after a barrier a
// thread a member sums the entries from 0 in site order and counts the
// flags. Rows too long for a block and calls of fewer than four rounds
// keep `k23_kernel`: a thread a member walks its E sites in order in
// global memory, a launch a round.
//
// K24: resident rounds, as K11's (`lattice_round.cuh`). A block owns a
// tile of members for every round of a C call: both rows (an odd count
// of words a row, `k11_odd_stride`) and the accumulators (sigma, counts
// and spec_sig) go to shared memory once, with each tape's potential by
// cell byte (the reference's gather rule applied once). A round's walk
// runs four sites a thread by K1's lane walk where E % 4 == 0,
// neighbouring threads on neighbouring members, else a site a thread;
// each site stages beta_eff * dg, dg = sum_c (G_c[old] - G_c[new]) from
// 0 in cell order, and its spec. After a barrier the ordered sums run a
// thread each: sigma[i] += the staged increments from 0 in site order;
// spec_sig[i, r] gains each increment of spec r in site order onto its
// running value, and counts[i, r] their number. A barrier, the next
// round; the rows and accumulators go back once. Nothing is atomic, and
// the plain versions repeat this order bit for bit. Rows too long for a
// block and calls of fewer than four rounds keep `k24_kernel`, a thread
// a member in global memory, a launch a round. The caller sizes the
// tile (`ops/thermo.py:k24_tile`).
//
// Bound: bytes. A round reads the cells the walk reveals and the written
// cells some spec leaves alone, writes the cells some spec writes
// (`k1_source.cell_traffic`), a byte each, reads a float32 uniform a site
// for a machine with choose nodes, the tables once (K23: float64 sigma
// and a byte of irrev a (window, spec); K24: two float64 potentials a
// symbol) and reads and writes the per-member accumulators (K23: sigma
// float64 and n_irrev int32; K24: sigma, and counts int32 and spec_sig
// float64 a spec). Over a resident call of n rounds (K23 or K24) the
// rows and accumulators cross once each way and each round moves only
// its shifts and uniforms.

#pragma once

// The reference's gather index rule for a table of n rows: a negative
// index plus n, then clamped into [0, n) (`ops/thermo.py:_gather_index`).
K1_FN long long k23_index(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Rows of K23's tables: K1_SIZE_A^K1_N_CELLS window ranks.
K11_HD long long k23_rows() {
  long long rows = 1;
#pragma unroll
  for (int k = 0; k < K1_N_CELLS; ++k) rows *= K1_SIZE_A;
  return rows;
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
  const long long rows = k23_rows();
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

// --- K24's resident rounds: the phases of a tile, shared by the kernel
// and its host twin, as K11's are (`lattice_round.cuh`).

// Staged strides a member: the round's site increments (float64) at an
// odd count, its specs (bytes) at an odd count of 4-byte words, so that
// the sums' reads of neighbouring members fall in different banks.
K11_HD int k24_sig_stride(int E) { return E | 1; }
K11_HD int k24_spec_stride(int E) { return 4 * (((E + 3) >> 2) | 1); }

// Shared memory of a tile: both rows a member (`k11_odd_stride`), then
// float64 each tape's potential by cell byte (2 x 256: the reference's
// gather rule applied once, `k23_index`), sigma, spec_sig [tile, S] and
// the staged increments; int32 counts [tile, S]; the staged specs, a
// byte a site (the walk's specs are below 128: `k1_source._check_lanes`).
K11_HD long long k24_tile_bytes(int tile, int L, int E, int S) {
  return 2LL * tile * k11_odd_stride(L) +
         8LL * (512 + (long long)tile * (1 + S + k24_sig_stride(E))) +
         4LL * tile * S + (long long)tile * k24_spec_stride(E);
}

struct K24Tile {
  int8_t* sp;       // program rows [tile, Ls]
  int8_t* sd;       // data rows
  double* g;        // g_prog then g_data by cell byte, 256 each
  double* sigma;    // [tile]
  double* ss;       // spec_sig [tile, S]
  double* stage;    // the round's site increments [tile, Es]
  int* cnt;         // counts [tile, S]
  uint8_t* spec;    // the round's fired specs [tile, Ep]
  int Ls, Es, Ep;
};

K11_HD K24Tile k24_tile_at(unsigned char* smem, int tile, int L, int E,
                           int S) {
  K24Tile t;
  t.Ls = k11_odd_stride(L);
  t.Es = k24_sig_stride(E);
  t.Ep = k24_spec_stride(E);
  t.sp = (int8_t*)smem;
  t.sd = t.sp + (long long)tile * t.Ls;
  t.g = (double*)(t.sd + (long long)tile * t.Ls);
  t.sigma = t.g + 512;
  t.ss = t.sigma + tile;
  t.stage = t.ss + (long long)tile * S;
  t.cnt = (int*)(t.stage + (long long)tile * t.Es);
  t.spec = (uint8_t*)(t.cnt + (long long)tile * S);
  return t;
}

// Loads (or, with ``load`` false, stores) the tile's accumulators of
// members [b0, b0+m): sigma, counts and spec_sig; a load also stages the
// potentials by cell byte.
K1_FN void k24_tile_accs(int tid, int nt, const K24Tile& t, int m, int b0,
                         int S, const double* g_prog, const double* g_data,
                         double* sigma, int* counts, double* spec_sig,
                         bool load) {
  if (load)
    for (int k = tid; k < 512; k += nt)
      t.g[k] = (k < 256 ? g_prog : g_data)[k23_index(
          (int8_t)(uint8_t)(k & 255), K1_SIZE_A)];
  for (int i = tid; i < m; i += nt) {
    if (load)
      t.sigma[i] = sigma[b0 + i];
    else
      sigma[b0 + i] = t.sigma[i];
  }
  const long long o = (long long)b0 * S;
  for (int x = tid; x < m * S; x += nt) {
    if (load) {
      t.ss[x] = spec_sig[o + x];
      t.cnt[x] = counts[o + x];
    } else {
      spec_sig[o + x] = t.ss[x];
      counts[o + x] = t.cnt[x];
    }
  }
}

// Site e of tile member i: its increment beta_eff * dg, dg = sum_c
// (G_c[old] - G_c[new]) from 0 in cell order over the cells' bytes
// before (``c``) and after (``y``) the writes, byte ``j`` of each word,
// and its spec, staged.
K1_FN void k24_stage(const K24Tile& t, int i, int e, const uint32_t* c,
                     const uint32_t* y, int j, int spec, double beta_eff) {
  double dg = 0.0;
#pragma unroll
  for (int k = 0; k < K1_N_CELLS; ++k) {
    const double* g = t.g + (k < K1_N_P ? 0 : 256);
    dg = dg + (g[(c[k] >> (8 * j)) & 0xffu] - g[(y[k] >> (8 * j)) & 0xffu]);
  }
  t.stage[(long long)i * t.Es + e] = beta_eff * dg;
  t.spec[(long long)i * t.Ep + e] = (uint8_t)spec;
}

// One round's walk of the tile's m members (b0 the first) at shifts
// ``sh`` (the round's row), uniforms ``u`` (the round's [B, E]): four
// sites a thread by K1's lane walk where E % 4 == 0, neighbouring
// threads on neighbouring members (`k11_four_sites`, the cells' words
// before and after the writes kept), else a site a thread
// (`k11_site`); each site's increment and spec staged (`k24_stage`).
K1_FN void k24_tile_sites(int tid, int nt, const K24Tile& t, int m, int L,
                          int E, int b0, const float* u, const int* sh,
                          int per_member, double beta_eff) {
  const int stride = L / E;
  if (E % 4 == 0) {
    const int q = E / 4;
    for (int w = tid; w < m * q; w += nt) {
      const int gi = w / m;
      const int i = w - gi * m;
      const int e0 = 4 * gi;
      uint32_t x[K1_N_CELLS], y[K1_N_CELLS];
      const uint32_t spec = k11_four_sites(
          t.sp + (long long)i * t.Ls, t.sd + (long long)i * t.Ls, L,
          sh[per_member ? b0 + i : 0], e0, stride,
          K1_CHOOSE ? u + (long long)(b0 + i) * E + e0 : nullptr, nullptr, x,
          y);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k24_stage(t, i, e0 + j, x, y, j, (int)((spec >> (8 * j)) & 0xffu),
                  beta_eff);
    }
    return;
  }
  for (int w = tid; w < m * E; w += nt) {
    const int i = w / E;
    const int e = w - i * E;
    int c[K1_N_CELLS], y[K1_N_CELLS];
    const int spec = k11_site(
        t.sp + (long long)i * t.Ls, t.sd + (long long)i * t.Ls, L,
        (long long)sh[per_member ? b0 + i : 0] + (long long)e * stride,
        K1_CHOOSE ? (double)u[(long long)(b0 + i) * E + e] : 0.0, nullptr, c,
        y);
    uint32_t cb[K1_N_CELLS], yb[K1_N_CELLS];
#pragma unroll
    for (int k = 0; k < K1_N_CELLS; ++k) {
      cb[k] = (uint8_t)c[k];
      yb[k] = (uint8_t)y[k];
    }
    k24_stage(t, i, e, cb, yb, 0, spec, beta_eff);
  }
}

// Then the round's ordered sums, a thread each: sigma[i] += its staged
// increments from 0 in site order; spec_sig[i, r] gains each increment
// of spec r in site order, onto its running value, and counts[i, r]
// their number (S + 1 threads a member). Four sites a step, their specs
// read as one word and their increments loaded ahead of the adds, which
// stay in site order.
K1_FN void k24_tile_sums(int tid, int nt, const K24Tile& t, int m, int E,
                         int S) {
  for (int w = tid; w < m * (S + 1); w += nt) {
    const int i = w / (S + 1);
    const int r = w - i * (S + 1);
    const double* st = t.stage + (long long)i * t.Es;
    const uint8_t* sc = t.spec + (long long)i * t.Ep;
    const int E4 = E & ~3;
    if (r == S) {
      double s = 0.0;
      for (int e = 0; e < E4; e += 4) {
        const double v0 = st[e], v1 = st[e + 1], v2 = st[e + 2],
                     v3 = st[e + 3];
        s = s + v0;
        s = s + v1;
        s = s + v2;
        s = s + v3;
      }
      for (int e = E4; e < E; ++e) s = s + st[e];
      t.sigma[i] = t.sigma[i] + s;
      continue;
    }
    double a = t.ss[i * S + r];
    int n = 0;
    for (int e = 0; e < E4; e += 4) {
      const uint32_t q = *(const uint32_t*)(sc + e);
      const double v0 = st[e], v1 = st[e + 1], v2 = st[e + 2],
                   v3 = st[e + 3];
      if ((q & 0xffu) == (uint32_t)r) a = a + v0, ++n;
      if (((q >> 8) & 0xffu) == (uint32_t)r) a = a + v1, ++n;
      if (((q >> 16) & 0xffu) == (uint32_t)r) a = a + v2, ++n;
      if ((q >> 24) == (uint32_t)r) a = a + v3, ++n;
    }
    for (int e = E4; e < E; ++e)
      if (sc[e] == r) a = a + st[e], ++n;
    t.ss[i * S + r] = a;
    t.cnt[i * S + r] += n;
  }
}

// --- K23's resident rounds, in K24's form: the walk stages each site's
// table entry (0.0 where irreversible) and flag, then a thread a member
// sums the entries from 0 in site order and counts the flags.

// Shared memory of a tile: both rows a member (`k11_odd_stride`); float64
// the staged table (``n_tab`` entries, each sigma or 0.0 where
// irreversible; 0 where the tables stay in global memory), sigma and the
// round's entries (an odd count a member, `k24_sig_stride`); int32
// n_irrev; the round's flags (a byte a site, an odd count of words,
// `k24_spec_stride`); the staged table's irreversible flags (a byte an
// entry).
K11_HD long long k23_tile_bytes(int tile, int L, int E, long long n_tab) {
  return 2LL * tile * k11_odd_stride(L) +
         8LL * (n_tab + (long long)tile * (1 + k24_sig_stride(E))) +
         4LL * tile + (long long)tile * k24_spec_stride(E) + n_tab;
}

struct K23Tile {
  int8_t* sp;      // program rows [tile, Ls]
  int8_t* sd;      // data rows
  double* tab;     // the staged table [n_tab]: sigma, 0.0 where irreversible
  double* sigma;   // [tile]
  double* stage;   // the round's site entries [tile, Es]
  int* nirr;       // n_irrev [tile]
  uint8_t* flag;   // the round's irreversible flags [tile, Ep]
  uint8_t* irr;    // the staged table's flags [n_tab]
  long long n_tab;
  int Ls, Es, Ep;
};

K11_HD K23Tile k23_tile_at(unsigned char* smem, int tile, int L, int E,
                           long long n_tab) {
  K23Tile t;
  t.n_tab = n_tab;
  t.Ls = k11_odd_stride(L);
  t.Es = k24_sig_stride(E);
  t.Ep = k24_spec_stride(E);
  t.sp = (int8_t*)smem;
  t.sd = t.sp + (long long)tile * t.Ls;
  t.tab = (double*)(t.sd + (long long)tile * t.Ls);
  t.sigma = t.tab + n_tab;
  t.stage = t.sigma + tile;
  t.nirr = (int*)(t.stage + (long long)tile * t.Es);
  t.flag = (uint8_t*)(t.nirr + tile);
  t.irr = t.flag + (long long)tile * t.Ep;
  return t;
}

// Loads (or, with ``load`` false, stores) the tile's sigma and n_irrev of
// members [b0, b0+m); a load also stages the tables where t.n_tab > 0.
K1_FN void k23_tile_accs(int tid, int nt, const K23Tile& t, int m, int b0,
                         const double* sig_tab, const uint8_t* irr_tab,
                         double* sigma, int* n_irrev, bool load) {
  if (load)
    for (long long x = tid; x < t.n_tab; x += nt) {
      const bool f = irr_tab[x] != 0;
      t.tab[x] = f ? 0.0 : sig_tab[x];
      t.irr[x] = f ? 1 : 0;
    }
  for (int i = tid; i < m; i += nt) {
    if (load) {
      t.sigma[i] = sigma[b0 + i];
      t.nirr[i] = n_irrev[b0 + i];
    } else {
      sigma[b0 + i] = t.sigma[i];
      n_irrev[b0 + i] = t.nirr[i];
    }
  }
}

// Site e of tile member i, its window cells ``c`` before the writes: the
// entry at (the window's rank by the gather rule, spec), 0.0 where the
// jump is irreversible, and its flag, staged; from the staged table, or
// from the tables in global memory.
K1_FN void k23_stage(const K23Tile& t, int i, int e, const int* c, int spec,
                     int S, const double* sig_tab, const uint8_t* irr_tab) {
  long long w = 0;
#pragma unroll
  for (int k = 0; k < K1_N_CELLS; ++k) w = w * K1_SIZE_A + c[k];
  const long long at = k23_index(w, k23_rows()) * S + spec;
  bool f;
  double v;
  if (t.n_tab) {
    f = t.irr[at] != 0;
    v = t.tab[at];
  } else {
    f = irr_tab[at] != 0;
    v = f ? 0.0 : sig_tab[at];
  }
  t.stage[(long long)i * t.Es + e] = v;
  t.flag[(long long)i * t.Ep + e] = f ? 1 : 0;
}

// One round's walk of the tile's m members, as `k24_tile_sites`: four
// sites a thread by the lane walk where E % 4 == 0, neighbouring threads
// on neighbouring members, else a site a thread; each site staged
// (`k23_stage`).
K1_FN void k23_tile_sites(int tid, int nt, const K23Tile& t, int m, int L,
                          int E, int b0, const float* u, const int* sh,
                          int per_member, int S, const double* sig_tab,
                          const uint8_t* irr_tab) {
  const int stride = L / E;
  if (E % 4 == 0) {
    const int q = E / 4;
    for (int w = tid; w < m * q; w += nt) {
      const int gi = w / m;
      const int i = w - gi * m;
      const int e0 = 4 * gi;
      uint32_t x[K1_N_CELLS], y[K1_N_CELLS];
      const uint32_t spec = k11_four_sites(
          t.sp + (long long)i * t.Ls, t.sd + (long long)i * t.Ls, L,
          sh[per_member ? b0 + i : 0], e0, stride,
          K1_CHOOSE ? u + (long long)(b0 + i) * E + e0 : nullptr, nullptr, x,
          y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c[K1_N_CELLS];
#pragma unroll
        for (int k = 0; k < K1_N_CELLS; ++k)
          c[k] = (int)(int8_t)(uint8_t)(x[k] >> (8 * j));
        k23_stage(t, i, e0 + j, c, (int)((spec >> (8 * j)) & 0xffu), S,
                  sig_tab, irr_tab);
      }
    }
    return;
  }
  for (int w = tid; w < m * E; w += nt) {
    const int i = w / E;
    const int e = w - i * E;
    int c[K1_N_CELLS], y[K1_N_CELLS];
    const int spec = k11_site(
        t.sp + (long long)i * t.Ls, t.sd + (long long)i * t.Ls, L,
        (long long)sh[per_member ? b0 + i : 0] + (long long)e * stride,
        K1_CHOOSE ? (double)u[(long long)(b0 + i) * E + e] : 0.0, nullptr, c,
        y);
    k23_stage(t, i, e, c, spec, S, sig_tab, irr_tab);
  }
}

// Then a thread a member: sigma[i] += its staged entries from 0 in site
// order, four a step with their loads ahead of the adds; n_irrev[i] +=
// its flags, a word of four at a time (each byte 0 or 1, so the
// product's top byte is their sum).
K1_FN void k23_tile_sums(int tid, int nt, const K23Tile& t, int m, int E) {
  for (int i = tid; i < m; i += nt) {
    const double* st = t.stage + (long long)i * t.Es;
    const uint8_t* fl = t.flag + (long long)i * t.Ep;
    const int E4 = E & ~3;
    double s = 0.0;
    int n = 0;
    for (int e = 0; e < E4; e += 4) {
      const double v0 = st[e], v1 = st[e + 1], v2 = st[e + 2],
                   v3 = st[e + 3];
      n += (int)((*(const uint32_t*)(fl + e) * 0x01010101u) >> 24);
      s = s + v0;
      s = s + v1;
      s = s + v2;
      s = s + v3;
    }
    for (int e = E4; e < E; ++e) {
      s = s + st[e];
      n += fl[e];
    }
    t.sigma[i] = t.sigma[i] + s;
    t.nirr[i] += n;
  }
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

// K23's resident rounds [k0, k0+n) of a tile a block: rows, sigma and
// n_irrev (and the tables where ``n_tab`` > 0) into shared memory once,
// then a round at a time the walk (`k23_tile_sites`, the next round's
// draws prefetched), a barrier, the sums (`k23_tile_sums`), a barrier;
// the rows and accumulators back once. At most 512 threads, two blocks
// an SM.
__global__ void __launch_bounds__(512, 2) k23_resident_kernel(
    int8_t* __restrict__ p, int8_t* __restrict__ d,
    const float* __restrict__ u, const int* __restrict__ shifts,
    int per_member, int k0, int n, int B, int L, int E,
    const double* __restrict__ sig_tab, const uint8_t* __restrict__ irr_tab,
    int S, long long n_tab, int tile, int vec, double* __restrict__ sigma,
    int* __restrict__ n_irrev) {
  extern __shared__ __align__(16) unsigned char k23_smem[];
  const K23Tile t = k23_tile_at(k23_smem, tile, L, E, n_tab);
  const int b0 = blockIdx.x * tile;
  const int m = min(tile, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  int8_t* gp = p + (long long)b0 * L;
  int8_t* gd = d + (long long)b0 * L;
  k11_tile_copy(tid, nt, gp, t.sp, m, L, t.Ls, vec, true);
  k11_tile_copy(tid, nt, gd, t.sd, m, L, t.Ls, vec, true);
  k23_tile_accs(tid, nt, t, m, b0, sig_tab, irr_tab, sigma, n_irrev, true);
  __syncthreads();
  const long long sites = (long long)B * E;
  // This thread's first member and uniform, prefetched a round ahead
  // (`k24_resident_kernel`).
  const int lanes = E % 4 == 0;
  const int mine = tid < m * (lanes ? E / 4 : E);
  const int i0 = lanes ? tid % m : tid / E;
  const long long u0 = (long long)(b0 + i0) * E +
                       (lanes ? 4 * (tid / m) : tid - i0 * E);
  for (int j = 0; j < n; ++j) {
    const int k = k0 + j;
    if (mine && j + 1 < n) {
      k11_prefetch(shifts + (long long)(k + 1) * (per_member ? B : 1) +
                   (per_member ? b0 + i0 : 0));
      if (K1_CHOOSE) k11_prefetch(u + (j + 1) * sites + u0);
    }
    k23_tile_sites(tid, nt, t, m, L, E, b0,
                   K1_CHOOSE ? u + j * sites : nullptr,
                   shifts + (long long)k * (per_member ? B : 1), per_member,
                   S, sig_tab, irr_tab);
    __syncthreads();
    k23_tile_sums(tid, nt, t, m, E);
    __syncthreads();
  }
  k11_tile_copy(tid, nt, gp, t.sp, m, L, t.Ls, vec, false);
  k11_tile_copy(tid, nt, gd, t.sd, m, L, t.Ls, vec, false);
  k23_tile_accs(tid, nt, t, m, b0, nullptr, nullptr, sigma, n_irrev, false);
}

// Rounds [k0, k0+n) of a sigma run: with ``tile`` > 0 one resident launch
// of ``tile`` members a block of ``threads`` threads, the tables staged
// in shared memory where ``stage_tab`` (cudaErrorInvalidValue where the
// tile does not fit); with ``tile`` 0 (rows too long to keep resident, or
// a call of few rounds) one launch a round (`k23_rounds`).
extern "C" int ckpe_k23_rounds(void* p, void* d, const void* uniforms,
                               const void* shifts, int per_member, int k0,
                               int n, int B, int L, int E,
                               const void* sig_tab, const void* irr_tab,
                               int S, void* sigma, void* n_irrev, int tile,
                               int threads, int stage_tab, void* stream) {
  if (tile > 0) {
    if (k11_bad_geometry(B, L, E) || S <= 0)
      return (int)cudaErrorInvalidValue;
    if (B == 0 || n <= 0) return (int)cudaGetLastError();
    const long long n_tab = stage_tab ? k23_rows() * S : 0;
    const long long bytes = k23_tile_bytes(tile, L, E, n_tab);
    if (threads < 32 || threads > 512 || bytes > K11_SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        k23_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int vec = L % 16 == 0 && (uintptr_t)p % 16 == 0 &&
                    (uintptr_t)d % 16 == 0;
    k23_resident_kernel<<<(unsigned)((B + tile - 1) / tile), threads,
                          (size_t)bytes, (cudaStream_t)stream>>>(
        (int8_t*)p, (int8_t*)d, (const float*)uniforms, (const int*)shifts,
        per_member, k0, n, B, L, E, (const double*)sig_tab,
        (const uint8_t*)irr_tab, S, n_tab, tile, vec, (double*)sigma,
        (int*)n_irrev);
    return (int)cudaGetLastError();
  }
  return k23_rounds(
      uniforms, shifts, per_member, k0, n, B, L, E, S,
      [&](unsigned blocks, const float* u, const int* s) {
        k23_kernel<<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
            (int8_t*)p, (int8_t*)d, u, s, per_member, B, L, E,
            (const double*)sig_tab, (const uint8_t*)irr_tab, S,
            (double*)sigma, (int*)n_irrev);
      });
}

// K24's resident rounds [k0, k0+n) of a tile a block: rows and
// accumulators into shared memory once, then a round at a time the walk
// (`k24_tile_sites`, the next round's draws prefetched), a barrier, the
// ordered sums (`k24_tile_sums`), a barrier; the rows and accumulators
// back once. At most 512 threads, two blocks an SM.
__global__ void __launch_bounds__(512, 2) k24_resident_kernel(
    int8_t* __restrict__ p, int8_t* __restrict__ d,
    const float* __restrict__ u, const int* __restrict__ shifts,
    int per_member, int k0, int n, int B, int L, int E,
    const double* __restrict__ g_prog, const double* __restrict__ g_data,
    double beta_eff, int S, int tile, int vec, double* __restrict__ sigma,
    int* __restrict__ counts, double* __restrict__ spec_sig) {
  extern __shared__ __align__(16) unsigned char k24_smem[];
  const K24Tile t = k24_tile_at(k24_smem, tile, L, E, S);
  const int b0 = blockIdx.x * tile;
  const int m = min(tile, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  int8_t* gp = p + (long long)b0 * L;
  int8_t* gd = d + (long long)b0 * L;
  k11_tile_copy(tid, nt, gp, t.sp, m, L, t.Ls, vec, true);
  k11_tile_copy(tid, nt, gd, t.sd, m, L, t.Ls, vec, true);
  k24_tile_accs(tid, nt, t, m, b0, S, g_prog, g_data, sigma, counts,
                spec_sig, true);
  __syncthreads();
  const long long sites = (long long)B * E;
  // This thread's first member and uniform (its first group of four sites
  // where E % 4 == 0, else its first site), whose next-round draws it
  // prefetches into L1 while the round runs.
  const int lanes = E % 4 == 0;
  const int mine = tid < m * (lanes ? E / 4 : E);
  const int i0 = lanes ? tid % m : tid / E;
  const long long u0 = (long long)(b0 + i0) * E +
                       (lanes ? 4 * (tid / m) : tid - i0 * E);
  for (int j = 0; j < n; ++j) {
    const int k = k0 + j;
    if (mine && j + 1 < n) {
      k11_prefetch(shifts + (long long)(k + 1) * (per_member ? B : 1) +
                   (per_member ? b0 + i0 : 0));
      if (K1_CHOOSE) k11_prefetch(u + (j + 1) * sites + u0);
    }
    k24_tile_sites(tid, nt, t, m, L, E, b0,
                   K1_CHOOSE ? u + j * sites : nullptr,
                   shifts + (long long)k * (per_member ? B : 1), per_member,
                   beta_eff);
    __syncthreads();
    k24_tile_sums(tid, nt, t, m, E, S);
    __syncthreads();
  }
  k11_tile_copy(tid, nt, gp, t.sp, m, L, t.Ls, vec, false);
  k11_tile_copy(tid, nt, gd, t.sd, m, L, t.Ls, vec, false);
  k24_tile_accs(tid, nt, t, m, b0, S, nullptr, nullptr, sigma, counts,
                spec_sig, false);
}

// Rounds [k0, k0+n) of a ledger run: with ``tile`` > 0 one resident
// launch of ``tile`` members a block of ``threads`` threads
// (cudaErrorInvalidValue where the tile does not fit); with ``tile`` 0
// (rows too long to keep resident, or a call of few rounds) one launch a
// round (`k23_rounds`).
extern "C" int ckpe_k24_rounds(void* p, void* d, const void* uniforms,
                               const void* shifts, int per_member, int k0,
                               int n, int B, int L, int E,
                               const void* g_prog, const void* g_data,
                               double beta_eff, int S, void* sigma,
                               void* counts, void* spec_sig, int tile,
                               int threads, void* stream) {
  if (tile > 0) {
    if (k11_bad_geometry(B, L, E) || S <= 0 || S > 128)
      return (int)cudaErrorInvalidValue;
    if (B == 0 || n <= 0) return (int)cudaGetLastError();
    const long long bytes = k24_tile_bytes(tile, L, E, S);
    if (threads < 32 || threads > 512 || bytes > K11_SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        k24_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int vec = L % 16 == 0 && (uintptr_t)p % 16 == 0 &&
                    (uintptr_t)d % 16 == 0;
    k24_resident_kernel<<<(unsigned)((B + tile - 1) / tile), threads,
                          (size_t)bytes, (cudaStream_t)stream>>>(
        (int8_t*)p, (int8_t*)d, (const float*)uniforms, (const int*)shifts,
        per_member, k0, n, B, L, E, (const double*)g_prog,
        (const double*)g_data, beta_eff, S, tile, vec, (double*)sigma,
        (int*)counts, (double*)spec_sig);
    return (int)cudaGetLastError();
  }
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

// K23's resident kernel on the host (the CPU test of the generated unit):
// tile after tile, each of the kernel's phases run for every thread
// ``t`` < ``threads`` in turn, on a buffer laid out as the kernel's
// shared memory. Arguments as `ckpe_k23_rounds` takes them, on host
// arrays.
extern "C" int ckpe_k23_host_resident(int8_t* p, int8_t* d, const float* u,
                                      const int* shifts, int per_member,
                                      int k0, int n, int B, int L, int E,
                                      const double* sig_tab,
                                      const uint8_t* irr_tab, int S,
                                      double* sigma, int* n_irrev, int tile,
                                      int threads, int stage_tab) {
  if (E <= 0 || L % E != 0 || S <= 0 || tile < 1 || threads < 1) return 1;
  const long long n_tab = stage_tab ? k23_rows() * S : 0;
  const long long bytes = k23_tile_bytes(tile, L, E, n_tab);
  unsigned char* smem = (unsigned char*)aligned_alloc(16, (bytes + 15) & ~15LL);
  if (!smem) return 1;
  const K23Tile t = k23_tile_at(smem, tile, L, E, n_tab);
  const bool vec = L % 16 == 0 && (uintptr_t)p % 16 == 0 &&
                   (uintptr_t)d % 16 == 0;
  const long long sites = (long long)B * E;
  for (int b0 = 0; b0 < B; b0 += tile) {
    const int m = tile < B - b0 ? tile : B - b0;
    int8_t* gp = p + (long long)b0 * L;
    int8_t* gd = d + (long long)b0 * L;
    for (int w = 0; w < threads; ++w) {
      k11_tile_copy(w, threads, gp, t.sp, m, L, t.Ls, vec, true);
      k11_tile_copy(w, threads, gd, t.sd, m, L, t.Ls, vec, true);
      k23_tile_accs(w, threads, t, m, b0, sig_tab, irr_tab, sigma, n_irrev,
                    true);
    }
    for (int j = 0; j < n; ++j) {
      const int k = k0 + j;
      for (int w = 0; w < threads; ++w)
        k23_tile_sites(w, threads, t, m, L, E, b0,
                       K1_CHOOSE ? u + j * sites : nullptr,
                       shifts + (long long)k * (per_member ? B : 1),
                       per_member, S, sig_tab, irr_tab);
      for (int w = 0; w < threads; ++w) k23_tile_sums(w, threads, t, m, E);
    }
    for (int w = 0; w < threads; ++w) {
      k11_tile_copy(w, threads, gp, t.sp, m, L, t.Ls, vec, false);
      k11_tile_copy(w, threads, gd, t.sd, m, L, t.Ls, vec, false);
      k23_tile_accs(w, threads, t, m, b0, nullptr, nullptr, sigma, n_irrev,
                    false);
    }
  }
  free(smem);
  return 0;
}

// K24's resident kernel on the host (the CPU test of the generated unit):
// tile after tile, each of the kernel's phases run for every thread
// ``t`` < ``threads`` in turn, on a buffer laid out as the kernel's
// shared memory. Arguments as `ckpe_k24_rounds` takes them, on host
// arrays.
extern "C" int ckpe_k24_host_resident(int8_t* p, int8_t* d, const float* u,
                                      const int* shifts, int per_member,
                                      int k0, int n, int B, int L, int E,
                                      const double* g_prog,
                                      const double* g_data, double beta_eff,
                                      int S, double* sigma, int* counts,
                                      double* spec_sig, int tile,
                                      int threads) {
  if (E <= 0 || L % E != 0 || S <= 0 || S > 128 || tile < 1 || threads < 1)
    return 1;
  const long long bytes = k24_tile_bytes(tile, L, E, S);
  unsigned char* smem = (unsigned char*)aligned_alloc(16, (bytes + 15) & ~15LL);
  if (!smem) return 1;
  const K24Tile t = k24_tile_at(smem, tile, L, E, S);
  const bool vec = L % 16 == 0 && (uintptr_t)p % 16 == 0 &&
                   (uintptr_t)d % 16 == 0;
  const long long sites = (long long)B * E;
  for (int b0 = 0; b0 < B; b0 += tile) {
    const int m = tile < B - b0 ? tile : B - b0;
    int8_t* gp = p + (long long)b0 * L;
    int8_t* gd = d + (long long)b0 * L;
    for (int w = 0; w < threads; ++w) {
      k11_tile_copy(w, threads, gp, t.sp, m, L, t.Ls, vec, true);
      k11_tile_copy(w, threads, gd, t.sd, m, L, t.Ls, vec, true);
      k24_tile_accs(w, threads, t, m, b0, S, g_prog, g_data, sigma, counts,
                    spec_sig, true);
    }
    for (int j = 0; j < n; ++j) {
      const int k = k0 + j;
      for (int w = 0; w < threads; ++w)
        k24_tile_sites(w, threads, t, m, L, E, b0,
                       K1_CHOOSE ? u + j * sites : nullptr,
                       shifts + (long long)k * (per_member ? B : 1),
                       per_member, beta_eff);
      for (int w = 0; w < threads; ++w) k24_tile_sums(w, threads, t, m, E, S);
    }
    for (int w = 0; w < threads; ++w) {
      k11_tile_copy(w, threads, gp, t.sp, m, L, t.Ls, vec, false);
      k11_tile_copy(w, threads, gd, t.sd, m, L, t.Ls, vec, false);
      k24_tile_accs(w, threads, t, m, b0, S, nullptr, nullptr, sigma, counts,
                    spec_sig, false);
    }
  }
  free(smem);
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
