// The mini-BFF register machine of K16 (`bff_round.cu`): one site event
// (`bff_fire`) and one thread's site of a round (`bff_site`), compiled by
// nvcc into K16 and by the host's C++ compiler into the CPU tests.
//
// Semantics: the JAX package's `engine/bff.py:162 bff_fire` (the
// reference's one-hot select cascade), step for step. Registers: pc,
// the heads d0 and d1 (offsets from the site), mode (< 0 scanning left
// for the |mode|-th '[', > 0 scanning right for the mode-th ']', 0
// executing). Each of the `fuel` steps fetches op from the program
// window (from the live data window on a self-modifying machine, so a
// write at step i changes the op step i+1 decodes), counts it, and
// then, by mode:
//   scanning left:  '[' at mode -1 ends the scan (mode 0, pc + 1); else
//                   mode += is '[' - is ']', pc - 1;
//   scanning right: ']' at mode 1 ends the scan (mode 0); else mode +=
//                   is '[' - is ']'; pc + 1;
//   executing:      '<' '>' move d0, '{' '}' (cl, cr) move d1; '-' '+'
//                   write (cell[d0] -+ 1) mod size_a at d0; '.' copies
//                   cell[d0] to d1, ',' cell[d1] to d0 (with the lineage
//                   id on a lineage run); '[' on a zero cell starts a
//                   right scan (mode 1); ']' on a nonzero cell starts a
//                   left scan (mode -1, pc - 1); otherwise pc + 1.
// Reads of a step come before its write. Symbols outside [0, size_a)
// execute as no-ops and are not counted, as the reference's one-hots
// read them; arithmetic on them is floored modulo size_a.
//
// Windows: cell c of a window lives at w[c * st] (st = 1 on the host,
// the block's thread count in K16's shared memory, where the heads index
// it at run time). After i steps each register has moved at most i
// cells, so reads and writes stay inside the windows `compile_bff` sets.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define BFF_FN __device__ __forceinline__
#else
#define BFF_FN static inline
#endif

#define BFF_MAX_A 16      // opcode counts: 4 bits a symbol in a uint64
#define BFF_MAX_CELLS 64  // written cells: a uint64 mask
#define BFF_N_PARAMS (9 + BFF_MAX_A)

// Operation kinds (`engine/bff.py:_KINDS`, from 1); 0 is any other
// symbol.
enum {
  BFF_OTHER = 0,
  BFF_LT,
  BFF_GT,
  BFF_CL,
  BFF_CR,
  BFF_MINUS,
  BFF_PLUS,
  BFF_DOT,
  BFF_COMMA,
  BFF_BL,
  BFF_BR
};

struct BffParams {
  int fuel, d1_start, size_a, p_lo, n_p, d_lo, n_d, self_modifying, zero;
  int8_t kind[BFF_MAX_A];
};

// From `engine/bff.py:rule_params`' BFF_N_PARAMS ints.
static inline BffParams bff_params(const int* v) {
  BffParams m;
  m.fuel = v[0];
  m.d1_start = v[1];
  m.size_a = v[2];
  m.p_lo = v[3];
  m.n_p = v[4];
  m.d_lo = v[5];
  m.n_d = v[6];
  m.self_modifying = v[7];
  m.zero = v[8];
  for (int a = 0; a < BFF_MAX_A; ++a) m.kind[a] = (int8_t)v[9 + a];
  return m;
}

static inline bool bff_params_ok(const BffParams& m) {
  return m.size_a > 0 && m.size_a <= BFF_MAX_A && m.fuel >= 0 &&
         m.fuel <= 15 && m.n_p > 0 && m.n_p <= BFF_MAX_CELLS && m.n_d > 0 &&
         m.n_d <= BFF_MAX_CELLS;
}

BFF_FN int bff_mod(int x, int a) {
  const int r = x % a;
  return r < 0 ? r + a : r;
}

// Fires the machine once at offset 0: program window p (n_p cells; unused
// on a self-modifying machine), data window d (n_d cells, written in
// place), lineage window prov (n_d int32 or null). Returns the executed
// opcodes' counts, 4 bits a symbol; *written gets the mask of data cells
// written.
BFF_FN uint64_t bff_fire(const BffParams& m, const int8_t* p, int8_t* d,
                         int32_t* prov, int st, uint64_t* written) {
  const int8_t* code = m.self_modifying ? d : p;
  const int code_lo = m.self_modifying ? m.d_lo : m.p_lo;
  int pc = 0, d0 = 0, d1 = m.d1_start, mode = 0;
  uint64_t counts = 0, wmask = 0;
  for (int step = 0; step < m.fuel; ++step) {
    const int op = code[(pc - code_lo) * st];
    const bool valid = op >= 0 && op < m.size_a;
    if (valid) counts += 1ull << (4 * op);
    const int kind = valid ? m.kind[op] : BFF_OTHER;
    if (mode < 0) {
      if (kind == BFF_BL && mode == -1) {
        mode = 0;
        pc += 1;
      } else {
        mode += (kind == BFF_BL) - (kind == BFF_BR);
        pc -= 1;
      }
      continue;
    }
    if (mode > 0) {
      if (kind == BFF_BR && mode == 1)
        mode = 0;
      else
        mode += (kind == BFF_BL) - (kind == BFF_BR);
      pc += 1;
      continue;
    }
    const int i0 = d0 - m.d_lo, i1 = d1 - m.d_lo;
    const int v0 = d[i0 * st], v1 = d[i1 * st];
    const bool z = v0 == m.zero;
    int next = pc + 1;
    switch (kind) {
      case BFF_LT: --d0; break;
      case BFF_GT: ++d0; break;
      case BFF_CL: --d1; break;
      case BFF_CR: ++d1; break;
      case BFF_MINUS:
        d[i0 * st] = (int8_t)bff_mod(v0 - 1, m.size_a);
        wmask |= 1ull << i0;
        break;
      case BFF_PLUS:
        d[i0 * st] = (int8_t)bff_mod(v0 + 1, m.size_a);
        wmask |= 1ull << i0;
        break;
      case BFF_DOT:
        d[i1 * st] = (int8_t)v0;
        if (prov) prov[i1 * st] = prov[i0 * st];
        wmask |= 1ull << i1;
        break;
      case BFF_COMMA:
        d[i0 * st] = (int8_t)v1;
        if (prov) prov[i0 * st] = prov[i1 * st];
        wmask |= 1ull << i0;
        break;
      case BFF_BL:
        if (z) mode = 1;
        break;
      case BFF_BR:
        if (!z) {
          mode = -1;
          next = pc - 1;
        }
        break;
      default: break;
    }
    pc = next;
  }
  *written = wmask;
  return counts;
}

BFF_FN int bff_col(long long a, int L) {
  const long long r = a % L;
  return (int)(r < 0 ? r + L : r);
}

// Site t = b*E + e of a round on [B, L] int8 rows (p null on a
// self-modifying machine, prov null without lineage) at shift
// shifts[b] (per_member) or shifts[0]: window cell j of a tape with read
// offset lo at column (shift + e*stride + lo + j) mod L, where the
// reference's rolls put it. The windows go to the slots sp, sd, sv
// (cell c at [c * st]), the machine fires, and the written cells go
// back. Returns the site's opcode counts, 4 bits a symbol.
BFF_FN uint64_t bff_site(const BffParams& m, long long t, const int8_t* p,
                         int8_t* d, int32_t* prov, const int* shifts,
                         int per_member, int L, int E, int8_t* sp,
                         int8_t* sd, int32_t* sv, int st) {
  const long long b = t / E;
  const long long e = t - b * E;
  const long long base =
      (long long)shifts[per_member ? b : 0] + e * (long long)(L / E);
  int8_t* drow = d + b * L;
  int32_t* vrow = prov ? prov + b * L : nullptr;
  if (!m.self_modifying) {
    const int8_t* prow = p + b * L;
    for (int c = 0; c < m.n_p; ++c)
      sp[c * st] = prow[bff_col(base + m.p_lo + c, L)];
  }
  for (int c = 0; c < m.n_d; ++c) {
    const int col = bff_col(base + m.d_lo + c, L);
    sd[c * st] = drow[col];
    if (vrow) sv[c * st] = vrow[col];
  }
  uint64_t written;
  const uint64_t counts = bff_fire(m, sp, sd, vrow ? sv : nullptr, st,
                                   &written);
  for (int c = 0; c < m.n_d; ++c) {
    if (!((written >> c) & 1u)) continue;
    const int col = bff_col(base + m.d_lo + c, L);
    drow[col] = sd[c * st];
    if (vrow) vrow[col] = sv[c * st];
  }
  return counts;
}

// The mutation of one cell (K18): where u < rate the cell takes val and
// its lineage -1.
BFF_FN void bff_mutate_cell(long long i, int8_t* tape, int32_t* prov,
                            const double* u, const int32_t* vals,
                            double rate) {
  if (u[i] < rate) {
    tape[i] = (int8_t)vals[i];
    if (prov) prov[i] = -1;
  }
}

#ifndef __CUDACC__

// bff_fire on n windows on the host: p [n, n_p] (null on a
// self-modifying machine), d [n, n_d], prov [n, n_d] or null, counts
// [n, size_a] (int64).
extern "C" int ckpe_bff_host_fire(const int* params, const int8_t* p,
                                  int8_t* d, int32_t* prov, int n,
                                  long long* counts) {
  const BffParams m = bff_params(params);
  if (!bff_params_ok(m)) return 1;
  for (int i = 0; i < n; ++i) {
    uint64_t written;
    const uint64_t c = bff_fire(m, p ? p + (long long)i * m.n_p : nullptr,
                                d + (long long)i * m.n_d,
                                prov ? prov + (long long)i * m.n_d : nullptr,
                                1, &written);
    for (int a = 0; a < m.size_a; ++a)
      counts[(long long)i * m.size_a + a] = (long long)((c >> (4 * a)) & 15u);
  }
  return 0;
}

// K16's per-thread body for every site of one round on the host (shifts
// [1] shared or [B] a member), its totals into totals[size_a] (int64),
// then K18's per-cell body when u is not null.
extern "C" int ckpe_bff_host_round(const int* params, const int8_t* p,
                                   int8_t* d, int32_t* prov,
                                   const int* shifts, int per_member, int B,
                                   int L, int E, long long* totals,
                                   const double* u, const int32_t* vals,
                                   double rate) {
  const BffParams m = bff_params(params);
  if (!bff_params_ok(m) || E <= 0 || L % E != 0) return 1;
  int8_t sp[BFF_MAX_CELLS], sd[BFF_MAX_CELLS];
  int32_t sv[BFF_MAX_CELLS];
  for (int a = 0; a < m.size_a; ++a) totals[a] = 0;
  for (long long t = 0; t < (long long)B * E; ++t) {
    const uint64_t c =
        bff_site(m, t, p, d, prov, shifts, per_member, L, E, sp, sd, sv, 1);
    for (int a = 0; a < m.size_a; ++a)
      totals[a] += (long long)((c >> (4 * a)) & 15u);
  }
  if (u)
    for (long long i = 0; i < (long long)B * L; ++i)
      bff_mutate_cell(i, d, prov, u, vals, rate);
  return 0;
}

#endif
