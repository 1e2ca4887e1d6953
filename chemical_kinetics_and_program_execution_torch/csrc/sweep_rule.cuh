// K5's per-element rule: one element of one item of the live-window sweep
// (`engine/dense.py:sweep_plan`), as the JAX package's
// `engine/dense.py:_apply_group` computes it (phases A, B and C and the
// +-emission).
//
// A step's vector is stored compactly, over its live windows only: for a
// layout (hi, D, lo, span) and the step's sorted live run ranks R[0..D),
// compact index c = (h * D + i) * lo + s holds window rank
// j = (h * span + R[i]) * lo + s (prefix digits h < hi, suffix s < lo).
// Every other window of the dense vector is an exact 0 for a finite p
// (the module docstring of `engine/dense.py` gives the argument). A
// compute item forms t[c] from its source vector (or the group's seed)
// and a guarded ratio formed at window j from the pyramid:
//
//   IDENT       t = seed[i]
//   EXTEND      t = r_le[lev](j) * src[c mod xn]       (tile: left-extend)
//   SHIFT       t = r_le[k](j) * sum_kids src[(h mod hx) * xd + kid]
//                                 (trailing run digit reduced, then tile)
//   RIGHT       t = src[c / A] * r_re(j)               (repeat: right-extend)
//   RSHIFT      t = (sum_d src[d * xn/A + c/A]) * r_re(j)
//                                 (leading prefix digit reduced, then repeat)
//   RSHIFT_RUN  t = (sum_kids src[kid * xlo + (c/A) mod xlo]) * r_re(j)
//                                 (leading run digit reduced, then repeat)
//
// with r_le[lev](j) = g(lv[lev][j], lv[lev-1][j mod A^(lev-1)]),
// r_re(j) = g(p[j], lv[k-1][j / A]) and g(n, d) = n > 0 ? n / max(n, d)
// : 0 (NaN in d propagates, as torch.maximum does). The sums run over
// the live children in digit order (d = 0 first), the order of the dense
// digit sum less its exact zeros. A seed's value at live index i is the
// sum of the signature weights of the members at rank R[i], from 0.0, in
// member order.
//
// An EMIT item runs over the step's target windows: those whose run
// digits are one of the step's original or adjusted ranks. Each gets its
// terms in pair order, dy[j] + (-t[own]) (when its run digits are an
// original rank) + t[o] for each pair (o, a) with a = its run digits; no
// two elements of one item share a window, so no atomics. An INTERIOR
// item (l0 > k; one element) walks the group's (rank, signature id,
// sign) ops in member order.
//
// A dual program's items carry their tape as two offsets (F_POFF,
// F_LOFF; 0 for a single-tape program): an item reads its tape's p (the
// state vector from A^k on for the data tape) and levels (the tape's
// block of ``low``) and writes its tape's half of dy. The functions that
// read them take kDual: K5 runs a single-tape program's plan with kDual
// false, which leaves the offsets (all 0) out of its index arithmetic.
//
// K25 (`engine/dense.py:dense_jvp`, the J.v of dp/dt) runs this rule in
// dual numbers: the functions below are templates on their value type T,
// double for K5 and K25Dual, a (value, tangent) pair, for K25. The
// pyramid is then read at the same index from [p | low] (values) and
// [v | vlow] (tangents: K3 on v, the pyramid being linear); a product of
// pairs is (a, da) * (b, db) = (a b, da b + a db), a sum adds values and
// tangents apart; the seeds, the signature weights and the work buffer
// hold pairs (16 bytes each); the emission writes the tangent of dy, and
// its value too where the context's ``dy`` is set: the values K25 forms
// are K5's, in K5's order, so one launch gives an RHS with K5's bits and
// its J.v. The guarded ratio's tangent is, with m = max(n, d):
//
//   dg = n > 0 ? (dn - g dm) / m : 0,
//   dm = d > n ? dd : (n > d ? dn : 0.5 (dn + dd)),
//
// one-sided 0 where n <= 0, the max's tangent split 0.5/0.5 at a tie (as
// JAX's max rule splits it), and the quotient's tangent written as
// (dn - g dm) / m, which is exactly 0 where n > d (g = 1, dm = dn).
// JAX's rule, dn / m - n dm / m^2, agrees to rounding only.
// `engine/dense.py:dense_jvp_plain` is K25's plain version.
//
// Plain C++ under `g++` as well, so a CPU test holds it to the plain step
// (`engine/dense.py:sweep_step_plain`, `emit_plain`) for every element,
// and K25's run of it to `dense_jvp_plain`.

#pragma once

#include <cstddef>

#ifdef __CUDACC__
#define K5_FN __host__ __device__ __forceinline__
#else
#define K5_FN static inline
#endif

enum {
  K5_IDENT = 0,
  K5_EXTEND = 1,
  K5_SHIFT = 2,
  K5_RIGHT = 3,
  K5_RSHIFT = 4,
  K5_RSHIFT_RUN = 5,
  K5_EMIT = 6,
  K5_INTERIOR = 7,
};

// Fields of an item row (`engine/dense.py:ITEM_FIELDS`).
enum {
  F_OP, F_START, F_N, F_DST, F_SRC, F_HI, F_D, F_LO, F_SPAN, F_TAB, F_LEV,
  F_XN, F_XD, F_XLO, F_KIDS, F_SEED,
  // the multipliers of the divisors lo, d, ne, xn, hx, xlo, A, A^(lev-1)
  F_M_LO, F_M_D, F_M_NE, F_M_XN, F_M_HX, F_M_XLO, F_M_A, F_M_PW1,
  // the item's tape: offsets into p and dy, and into low
  F_POFF, F_LOFF, K5_FIELDS,
};

constexpr int kMaxK = 16;

// K25's value type: a value and its tangent along v.
struct alignas(16) K25Dual {
  double v, d;
};

// The rule's context on values of type T (`K5Ctx`: K5's doubles).
template <class T>
struct K5CtxT {
  int a, k;
  const double* p;              // level k: the state vector
  const double* low;            // [lv[k-1], ..., lv[0], 1], a block a tape
  unsigned n_state;             // entries of p: A^k, 2 A^k for a dual program
  unsigned lv_off[kMaxK + 1];   // level j < k at low + lv_off[j]
  unsigned pw[kMaxK + 1];       // A^j
  const T* s;                   // signature weights (phase 0's output)
  const int* table;             // ranks, children, seeds, targets, ops
  T* work;                      // every step's compact vector
  double* dy;                   // dp/dt (K25: its value, or null)
  const double* v;              // K25 only: the tangent state, K3's levels
  const double* vlow;           // of v (laid out as ``low``) and the
  double* jdy;                  // tangent of dp/dt
};

using K5Ctx = K5CtxT<double>;

K5_FN double k5_guarded(double num, double den) {
  const bool pos = num > 0.0;
  double m = den > num ? den : num;
  if (den != den) m = den;  // max propagates NaN, as torch.maximum does
  return (pos ? num : 0.0) / (pos ? m : 1.0);
}

K5_FN K25Dual k5_guarded(const K25Dual& n, const K25Dual& d) {
  K25Dual r;
  r.v = k5_guarded(n.v, d.v);
  if (!(n.v > 0.0)) {
    r.d = 0.0;
    return r;
  }
  double m = d.v > n.v ? d.v : n.v;
  if (d.v != d.v) m = d.v;
  const double dm = d.v > n.v ? d.d : (n.v > d.v ? n.d : 0.5 * (n.d + d.d));
  r.d = (n.d - r.v * dm) / m;
  return r;
}

// A value written by another block in an earlier phase: from L2, not L1.
K5_FN double k5_load(const double* x) {
#if defined(__CUDA_ARCH__)
  return __ldcg(x);
#else
  return *x;
#endif
}

K5_FN K25Dual k5_load(const K25Dual* x) {
#if defined(__CUDA_ARCH__)
  const double2 t = __ldcg(reinterpret_cast<const double2*>(x));
  K25Dual r;
  r.v = t.x;
  r.d = t.y;
  return r;
#else
  return *x;
#endif
}

// A step's vector: in shared memory where the block form keeps the work
// buffer there (`csrc/dense_rhs.cu`), else from L2, as `k5_load`.
template <class T>
K5_FN T k5_work_load(const T* x) {
#if defined(__CUDA_ARCH__)
  if (__isShared(x)) return *x;
#endif
  return k5_load(x);
}

// The arithmetic on either value type.
K5_FN double k5_add(double a, double b) { return a + b; }
K5_FN double k5_mul(double a, double b) { return a * b; }
K5_FN double k5_neg(double a) { return -a; }
K5_FN double k5_scale(double w, double a) { return w * a; }

K5_FN K25Dual k5_add(const K25Dual& a, const K25Dual& b) {
  K25Dual r;
  r.v = a.v + b.v;
  r.d = a.d + b.d;
  return r;
}

K5_FN K25Dual k5_mul(const K25Dual& a, const K25Dual& b) {
  K25Dual r;
  r.v = a.v * b.v;
  r.d = a.d * b.v + a.v * b.d;
  return r;
}

K5_FN K25Dual k5_neg(const K25Dual& a) {
  K25Dual r;
  r.v = -a.v;
  r.d = -a.d;
  return r;
}

K5_FN K25Dual k5_scale(double w, const K25Dual& a) {  // w has no tangent
  K25Dual r;
  r.v = w * a.v;
  r.d = w * a.d;
  return r;
}

// Entry q of a pyramid piece x (p or low), with the tangent's (v or
// vlow) for a pair.
K5_FN void k5_pick(double& r, const double* x, const double*, unsigned q) {
  r = x[q];
}

K5_FN void k5_pick(K25Dual& r, const double* x, const double* dx,
                   unsigned q) {
  r.v = x[q];
  r.d = dx[q];
}

// dy at window j, read and written: K25's tangent in jdy, its value in
// dy where one is set.
K5_FN double k5_dy_get(const K5Ctx& c, unsigned j) {
  return k5_load(c.dy + j);
}

K5_FN void k5_dy_set(const K5Ctx& c, unsigned j, double x) { c.dy[j] = x; }

K5_FN K25Dual k5_dy_get(const K5CtxT<K25Dual>& c, unsigned j) {
  K25Dual r;
  r.v = c.dy ? k5_load(c.dy + j) : 0.0;
  r.d = k5_load(c.jdy + j);
  return r;
}

K5_FN void k5_dy_set(const K5CtxT<K25Dual>& c, unsigned j,
                     const K25Dual& x) {
  c.jdy[j] = x.d;
  if (c.dy) c.dy[j] = x.v;
}

// Division by a divisor fixed for an item, as a multiply and a shift:
// for x < 2^31 and d >= 1, q = (x * m) >> s with s = 31 + ceil(log2 d)
// and m = ceil(2^s / d), made on the host (`engine/dense.py:_magic`;
// Granlund and Montgomery: m d - 2^s < d <= 2^(s - 31), so q = floor(x /
// d) exactly).
struct K5Div {
  unsigned long long m;
  unsigned s, d;
};

K5_FN K5Div k5_div(long long d, long long m) {
  K5Div v;
  const unsigned below = (unsigned)(d - 1);  // d <= 2^31
#if defined(__CUDA_ARCH__)
  v.s = 31 + (below ? 32 - __clz(below) : 0);
#else
  v.s = 31 + (below ? 32 - __builtin_clz(below) : 0);
#endif
  v.d = (unsigned)d;
  v.m = (unsigned long long)m;
  return v;
}

K5_FN unsigned k5_q(unsigned x, const K5Div& v) {
  return (unsigned)(((unsigned long long)x * v.m) >> v.s);
}

K5_FN unsigned k5_r(unsigned x, const K5Div& v) {
  return x - k5_q(x, v) * v.d;
}

// An item row unpacked, with its divisors (built once a phase).
struct K5Item {
  int op, tab, lev, kids, seed;
  unsigned n, span, xd, n1;  // n1 = xn / A
  unsigned poff, loff;       // the item's tape in p and dy, and in low
  long long start, dst, src;
  K5Div lo, d, ne, xn, hx, xlo, a, pw1;
};

K5_FN long long k5_at_least_1(long long x) { return x < 1 ? 1 : x; }

template <class T>
K5_FN K5Item k5_item(const long long* r, const K5CtxT<T>& c) {
  K5Item it;
  it.op = (int)r[F_OP];
  it.tab = (int)r[F_TAB];
  it.lev = (int)r[F_LEV];
  it.kids = (int)r[F_KIDS];
  it.seed = (int)r[F_SEED];
  it.n = (unsigned)r[F_N];
  it.span = (unsigned)r[F_SPAN];
  it.xd = (unsigned)r[F_XD];
  it.n1 = (unsigned)r[F_XN] / (unsigned)c.a;
  it.poff = (unsigned)r[F_POFF];
  it.loff = (unsigned)r[F_LOFF];
  it.start = r[F_START];
  it.dst = r[F_DST];
  it.src = r[F_SRC];
  it.lo = k5_div(k5_at_least_1(r[F_LO]), r[F_M_LO]);
  it.d = k5_div(k5_at_least_1(r[F_D]), r[F_M_D]);
  it.ne = k5_div(it.op == K5_EMIT ? k5_at_least_1(r[F_LEV]) : 1, r[F_M_NE]);
  it.xn = k5_div(k5_at_least_1(r[F_XN]), r[F_M_XN]);
  it.hx = k5_div(r[F_XD] > 0 ? k5_at_least_1(r[F_XN] / r[F_XD]) : 1,
                 r[F_M_HX]);
  it.xlo = k5_div(k5_at_least_1(r[F_XLO]), r[F_M_XLO]);
  it.a = k5_div(c.a, r[F_M_A]);
  it.pw1 = k5_div(it.lev >= 1 && it.lev <= c.k ? c.pw[it.lev - 1] : 1,
                  r[F_M_PW1]);
  return it;
}

// The item's offsets into p and dy, and into low (0 unless kDual).
template <bool kDual>
K5_FN unsigned k5_poff(const K5Item& it) {
  return kDual ? it.poff : 0u;
}

template <bool kDual, class T>
K5_FN T k5_level(const K5CtxT<T>& c, const K5Item& it, int j, unsigned x) {
  T r;
  if (j == c.k)
    k5_pick(r, c.p, c.v, k5_poff<kDual>(it) + x);
  else
    k5_pick(r, c.low, c.vlow, (kDual ? it.loff : 0u) + c.lv_off[j] + x);
  return r;
}

template <bool kDual, class T>
K5_FN T k5_ratio(const K5CtxT<T>& c, const K5Item& it, unsigned j) {
  if (it.op == K5_RIGHT || it.op == K5_RSHIFT || it.op == K5_RSHIFT_RUN)
    return k5_guarded(k5_level<kDual>(c, it, c.k, j),
                      k5_level<kDual>(c, it, c.k - 1, k5_q(j, it.a)));
  return k5_guarded(k5_level<kDual>(c, it, it.lev, j),
                    k5_level<kDual>(c, it, it.lev - 1, k5_r(j, it.pw1)));
}

// The source vector at compact index x (the seed's at live index x).
template <class T>
K5_FN T k5_src(const K5CtxT<T>& c, const K5Item& it, unsigned x) {
  if (it.src >= 0) return k5_work_load(c.work + it.src + x);
  const int* t = c.table;
  const int row = it.seed + (int)x;
  T acc = T();
  for (int q = t[row]; q < t[row + 1]; ++q) acc = k5_add(acc, c.s[t[q]]);
  return acc;
}

// A compute item's two factors at compact index e: its ratio r (not for
// IDENT, which returns false) and the source operand x it multiplies.
template <bool kDual, class T>
K5_FN bool k5_parts(const K5CtxT<T>& c, const K5Item& it, unsigned e, T& r,
                    T& x) {
  const int op = it.op;
  const unsigned rest = k5_q(e, it.lo), h = k5_q(rest, it.d);
  const unsigned i = rest - h * it.d.d;
  const unsigned j = (h * it.span + (unsigned)c.table[it.tab + i]) * it.lo.d +
                     (e - rest * it.lo.d);
  if (op == K5_IDENT) {
    x = k5_src(c, it, e);
    return false;
  }
  r = k5_ratio<kDual>(c, it, j);
  switch (op) {
    case K5_EXTEND:
      x = k5_src(c, it, k5_r(e, it.xn));
      break;
    case K5_RIGHT:
      x = k5_src(c, it, k5_q(e, it.a));
      break;
    case K5_RSHIFT: {
      const unsigned cc = k5_q(e, it.a);
      x = k5_src(c, it, cc);
      for (unsigned dd = 1; dd < it.a.d; ++dd)
        x = k5_add(x, k5_src(c, it, dd * it.n1 + cc));
      break;
    }
    default: {  // K5_SHIFT, K5_RSHIFT_RUN: the live children of i
      const int* t = c.table;
      const int row = it.kids + (int)i;
      unsigned base, step;
      if (op == K5_SHIFT) {
        base = k5_r(h, it.hx) * it.xd;
        step = 1;
      } else {
        base = k5_r(k5_q(e, it.a), it.xlo);
        step = it.xlo.d;
      }
      x = k5_src(c, it, base + (unsigned)t[t[row]] * step);
      for (int q = t[row] + 1; q < t[row + 1]; ++q)
        x = k5_add(x, k5_src(c, it, base + (unsigned)t[q] * step));
    }
  }
  return true;
}

// A compute item's value at compact index e. A product's two factors
// commute bit for bit, in doubles and in pairs alike.
template <bool kDual, class T>
K5_FN T k5_value(const K5CtxT<T>& c, const K5Item& it, unsigned e) {
  T r, x;
  return k5_parts<kDual>(c, it, e, r, x) ? k5_mul(r, x) : x;
}

// One element e of one item.
template <bool kDual, class T>
K5_FN void k5_element(const K5CtxT<T>& c, const K5Item& it, unsigned e) {
  if (it.op == K5_INTERIOR) {
    const int* ops = c.table + it.tab;
    for (int q = 0; q < it.lev; ++q) {
      const T w = c.s[ops[3 * q + 1]];
      const unsigned j = k5_poff<kDual>(it) + (unsigned)ops[3 * q];
      k5_dy_set(c, j, k5_add(k5_dy_get(c, j),
                             ops[3 * q + 2] < 0 ? k5_neg(w) : w));
    }
    return;
  }
  if (it.op != K5_EMIT) {
    c.work[it.dst + e] = k5_value<kDual>(c, it, e);
    return;
  }
  const unsigned lo = it.lo.d;
  const unsigned rest = k5_q(e, it.lo), h = k5_q(rest, it.ne);
  const unsigned s = e - rest * lo, q = rest - h * it.ne.d;
  const int* tg = c.table + it.tab + 4 * q;  // rank, own, partners
  const unsigned j =
      k5_poff<kDual>(it) + (h * it.span + (unsigned)tg[0]) * lo + s;
  const T* t = c.work + it.dst + (size_t)h * it.d.d * lo + s;
  T acc = k5_dy_get(c, j);
  if (tg[1] >= 0)
    acc = k5_add(acc, k5_neg(k5_work_load(t + (size_t)tg[1] * lo)));
  for (int x = 0; x < tg[3]; ++x)
    acc = k5_add(acc, k5_work_load(t + (size_t)c.table[tg[2] + x] * lo));
  k5_dy_set(c, j, acc);
}

// The context's level offsets and powers of A.
template <class T>
K5_FN void k5_levels(K5CtxT<T>& c) {
  unsigned pos = 0, size = 1;
  for (int j = 0; j <= c.k; ++j) {
    c.pw[j] = size;
    size *= (unsigned)c.a;
  }
  for (int j = c.k - 1; j >= 0; --j) {
    c.lv_off[j] = pos;
    pos += c.pw[j];
  }
  c.lv_off[c.k] = 0;
  c.n_state = c.pw[c.k];
}

// The levels below p (and v) formed inside a K5 or K25 launch, its
// leading phases in the block and cluster forms (`csrc/dense_rhs.cu`):
// level j's phase (j = k - 1, ..., 0) forms ways * tapes * A^j entries,
// entry x the piece (p's levels, then v's) x / (tapes A^j), its tape
// and its index o. Each entry sums its A children, level j + 1 at o A
// (p or v itself at j = k - 1), in digit order from the first, as K3
// and `engine/dense.py:pyramid_plain` sum them; a level written in the
// previous phase is read through L2 (`k5_load`). Level 0's phase also
// writes the 1 above it (`k5_level_one`; for v too, as K3 on v writes
// it).
struct K5LevelOut {
  double* lv;   // p's levels (null: made before the launch)
  double* vlv;  // v's levels (null: none to form)
  int tapes;
  unsigned low_block;  // a tape's block of low: its levels and the 1
};

K5_FN unsigned k5_level_ways(const K5LevelOut& o) {
  return (o.lv ? 1u : 0u) + (o.vlv ? 1u : 0u);
}

template <class T>
K5_FN unsigned k5_level_count(const K5CtxT<T>& c, const K5LevelOut& o,
                              int j) {
  return k5_level_ways(o) * (unsigned)o.tapes * c.pw[j];
}

template <class T>
K5_FN void k5_level_entry(const K5CtxT<T>& c, const K5LevelOut& o, int j,
                          unsigned x) {
  const unsigned a = (unsigned)c.a, m = c.pw[j];
  const unsigned per = m * (unsigned)o.tapes;
  const unsigned piece = x / per, r = x - piece * per;
  const unsigned tape = r / m, q = r - tape * m;
  const bool is_v = piece == 1 || !o.lv;
  double* out = (is_v ? o.vlv : o.lv) + (size_t)tape * o.low_block;
  double acc;
  if (j == c.k - 1) {
    const double* src =
        (is_v ? c.v : c.p) + (size_t)tape * c.pw[c.k] + (size_t)q * a;
    acc = src[0];
    for (unsigned d = 1; d < a; ++d) acc = acc + src[d];
  } else {
    const double* src = out + c.lv_off[j + 1] + (size_t)q * a;
    acc = k5_load(src);
    for (unsigned d = 1; d < a; ++d) acc = acc + k5_load(src + d);
  }
  out[c.lv_off[j] + q] = acc;
}

// The 1 above level 0 of piece-and-tape y < ways * tapes.
template <class T>
K5_FN void k5_level_one(const K5CtxT<T>& c, const K5LevelOut& o,
                        unsigned y) {
  const unsigned piece = y / (unsigned)o.tapes;
  const unsigned tape = y - piece * (unsigned)o.tapes;
  const bool is_v = piece == 1 || !o.lv;
  (is_v ? o.vlv : o.lv)[(size_t)tape * o.low_block + c.lv_off[0] + 1] = 1.0;
}

// K4's rule, K5's phase 0 (`engine/dense.py:signature_weights_plain`):
// signature g's weight is the sum from 0.0, over its pairs in pair
// order, of each pair's world weight: w_const[w] times the product of
// w's guarded ratios in chain order (`k4_pair_weight`). The pairs lie in
// CSR order (by signature, pair order kept), each with its world's
// chain indices and w_const, so a world that serves several signatures
// is formed anew for each. The pyramid is read in two pieces: p below
// the state size, the levels above (`engine/compile.py:
// two_pointer_index`, which maps a dual program's indices there).
struct K4Pairs {
  const int* num;       // [pairs, chain] pyramid indices
  const int* den;
  const double* w_const;  // [pairs]
  const int* csr_ptr;   // [signatures + 1]
  int chain;
};

constexpr int kK4Batch = 4;  // chain factors whose loads issue together

template <class T>
K5_FN T k4_pyramid(const K5CtxT<T>& c, int x) {
  const unsigned n = c.n_state;
  T r;
  if ((unsigned)x < n)
    k5_pick(r, c.p, c.v, (unsigned)x);
  else
    k5_pick(r, c.low, c.vlow, (unsigned)x - n);
  return r;
}

// A chain's guarded ratios multiplied in chain order (the loads issued
// kK4Batch at a time). K8 forms an event's chain with it too.
template <class T>
K5_FN T k4_chain_product(const K5CtxT<T>& c, const int* num, const int* den,
                         int chain) {
  T prod = T();
  for (int j0 = 0; j0 < chain; j0 += kK4Batch) {
    T vn[kK4Batch], vd[kK4Batch];
#pragma unroll
    for (int u = 0; u < kK4Batch; ++u) {
      if (j0 + u < chain) {
        vn[u] = k4_pyramid(c, num[j0 + u]);
        vd[u] = k4_pyramid(c, den[j0 + u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kK4Batch; ++u) {
      if (j0 + u < chain) {
        const T g = k5_guarded(vn[u], vd[u]);
        prod = j0 + u == 0 ? g : k5_mul(prod, g);
      }
    }
  }
  return prod;
}

template <class T>
K5_FN T k4_pair_weight(const K5CtxT<T>& c, const K4Pairs& w, int q) {
  return k5_scale(w.w_const[q],
                  k4_chain_product(c, w.num + (size_t)q * w.chain,
                                   w.den + (size_t)q * w.chain, w.chain));
}

// --- K30: u^T J --------------------------------------------------------------
//
// K30 (`engine/dense.py:dense_vjp`; plain `dense_vjp_plain`, plan
// `vjp_plan`) runs the sweep forward and then backward, each cotangent a
// gather that one thread sums from 0.0 over a list fixed by the plan, in
// plan order; no atomic anywhere. Its phases, each apart by a barrier:
//
// - the forward (`k30_forward`): every compute item of K5's rule, by
//   level, keeping each element's ratio r in ``g`` and operand x in
//   ``px`` besides its value t = r x in the work buffer (`k5_parts`);
// - the reverse items by descending level (`k30_reverse`): element e of
//   a step sums its emission's u[adj] - u[orig] (where its run is an
//   original rank) and, for each reader in plan order, the reader's r x
//   cotangent at the A elements that read e, in digit order (by the
//   reader's kind: a tile reads e at e + d n, a repeat at e A + d, a
//   trailing-digit sum at its parent rank with each leading digit d, a
//   leading-digit sum at (e mod n / A) A + d); it then writes r x
//   cotangent into ``g`` and cotangent x x into ``px`` (an IDENT step,
//   which has no ratio, its cotangent into ``g``). The last reverse phase
//   forms the seeds' cotangents (``xs``) the same way, and each
//   ratio-table entry's cotangent (`k30_table_entry`): the ``px`` terms
//   of the steps that read the table, in plan order, at the entry's
//   window where it is live in the step, times the guarded ratio's
//   partials (`k30_partials`) into ``q``;
// - each signature weight's cotangent (`k30_signature`): its seeds' and
//   its interior ops' +-u terms, in plan order;
// - each world (`k30_world`): w_bar_v the sum of its pairs' signature
//   cotangents in pair order, w_bar = w_bar_v prod g, and each chain
//   factor's cotangent w_bar_v w_const (prefix product x suffix
//   product: no division by a g that may be 0) times its partials, into
//   ``q``;
// - each pyramid entry's own terms (`k30_direct`): as a numerator, as a
//   denominator by digit, then its chain factors' terms in ``q`` order;
// - the pyramid's transpose into p_bar (`k30_pbar`): a thread an entry
//   of p adds its ancestors' terms from level 0 down, as lv_bar[j + 1] =
//   direct[j + 1] + lv_bar[j] repeated over the last digit.
//
// The guarded ratio's partials, with m = max(n, d), g = n / m, dm/dn 1
// where n > d, 0 where d > n and 0.5 at a tie (JAX's max rule) and dm/dd
// = 1 - dm/dn: dg/dn = (1 - g dm/dn) / m, dg/dd = -(g dm/dd) / m where n
// > 0, and exactly 0 where n <= 0 (the JAX package's double-where form:
// no NaN at a zero context).

// A reverse item row (`engine/dense.py:RV_FIELDS`), then kK30Readers
// reader blocks (`READER_FIELDS`).
enum {
  RV_START, RV_N, RV_OUT, RV_SEED, RV_IDENT, RV_HI, RV_D, RV_LO, RV_SPAN,
  RV_RANKS, RV_ADJ, RV_POFF, RV_READERS, RV_FIELDS,
};
enum { RD_KIND, RD_DST, RD_P1, RD_P2, RD_P3, RD_PARENT, RD_FIELDS };
constexpr int kK30Readers = 2;
constexpr int kK30Row = RV_FIELDS + kK30Readers * RD_FIELDS;
// A step's layout as the table entries read it (`STEP_FIELDS`).
enum { ST_DST, ST_HI, ST_D, ST_LO, ST_SPAN, ST_RANKS, ST_FIELDS };
constexpr int kK30MaxChain = 32;  // `engine/dense.py:MAX_CHAIN`

struct K30Ctx {
  const int* table;  // K5's, then the adjusted ranks and the parents
  const long long* steps;  // ST_FIELDS a step
  const int* tab_ptr;  // each (tape, table)'s steps, plan order
  const int* tab_steps;
  const int* sig_ptr;  // each signature's terms: [xs, u, -u] indices
  const int* sig_terms;
  const int* world_ptr;  // each world's pairs' signatures, pair order
  const int* world_sigs;
  const int* wt_pyr;  // the chain factors' pyramid terms, by entry
  const int* wt_q;
  int n_wt;
  const int* w_num;  // [worlds, chain] pyramid indices (as K4's)
  const int* w_den;
  const double* w_const;  // [worlds]
  int chain, n_worlds, n_sig, n_xs, tapes;
  unsigned rat_len, off_re, low_block;
  unsigned off_le[kMaxK + 1];  // r_le[j] at off_le[j] in a tape's tables
  const double* u;  // the cotangent of dy
  double* g;        // each element's r, then r x its cotangent
  double* px;       // each element's x, then its cotangent x x
  double* xs;       // the seeds' cotangents
  double* sbar;     // the signature weights' cotangents
  double* q;        // the partials (`engine/dense.py:vjp_partials`)
  double* direct;   // each pyramid entry's own terms
  double* pbar;     // u^T J in p
  double* wbar;     // u^T J in w_const, or null
};

K5_FN void k30_partials(double n, double d, double& dn, double& dd) {
  if (!(n > 0.0)) {
    dn = 0.0;
    dd = 0.0;
    return;
  }
  double m = d > n ? d : n;
  if (d != d) m = d;
  const double g = n / m;
  const double dmn = n > d ? 1.0 : (d > n ? 0.0 : 0.5);
  const double dmd = 1.0 - dmn;
  dn = (1.0 - g * dmn) / m;
  dd = -(g * dmd) / m;
}

// The forward: K5's value of a compute item's element, its ratio and
// operand kept.
template <bool kDual>
K5_FN void k30_forward(const K5Ctx& c, const K30Ctx& v, const K5Item& it,
                       unsigned e) {
  double r, x;
  const long long at = it.dst + e;
  if (k5_parts<kDual>(c, it, e, r, x)) {
    c.work[at] = k5_mul(r, x);
    v.g[at] = r;
  } else {
    c.work[at] = x;
  }
  v.px[at] = x;
}

// One element e of a reverse item (a step's vector, or a seed).
K5_FN void k30_reverse(const K5Ctx& c, const K30Ctx& v, const long long* r,
                       unsigned e) {
  const unsigned a = (unsigned)c.a;
  double acc = 0.0;
  if (r[RV_ADJ] >= 0) {
    const unsigned lo = (unsigned)r[RV_LO], nd = (unsigned)r[RV_D];
    const unsigned rest = e / lo, s = e - rest * lo;
    const unsigned h = rest / nd, i = rest - h * nd;
    const unsigned hs = h * (unsigned)r[RV_SPAN];
    const double* u = v.u + r[RV_POFF];
    const unsigned w = (hs + (unsigned)v.table[r[RV_RANKS] + i]) * lo + s;
    const unsigned wa = (hs + (unsigned)v.table[r[RV_ADJ] + i]) * lo + s;
    acc = acc + (u[wa] - u[w]);
  }
  for (int q = 0; q < (int)r[RV_READERS]; ++q) {
    const long long* b = r + RV_FIELDS + q * RD_FIELDS;
    const double* gj = v.g + b[RD_DST];
    const unsigned p1 = (unsigned)b[RD_P1];
    switch ((int)b[RD_KIND]) {
      case K5_IDENT:
        acc = acc + k5_load(gj + e);
        break;
      case K5_EXTEND:
        for (unsigned d = 0; d < a; ++d)
          acc = acc + k5_load(gj + e + (size_t)d * p1);
        break;
      case K5_RIGHT:
        for (unsigned d = 0; d < a; ++d)
          acc = acc + k5_load(gj + (size_t)e * a + d);
        break;
      case K5_SHIFT: {
        const unsigned hs = e / p1, i = e - hs * p1;
        const unsigned par = (unsigned)v.table[b[RD_PARENT] + i];
        const unsigned p2 = (unsigned)b[RD_P2], p3 = (unsigned)b[RD_P3];
        for (unsigned d = 0; d < a; ++d)
          acc = acc + k5_load(gj + (size_t)(d * p2 + hs) * p3 + par);
        break;
      }
      case K5_RSHIFT: {
        const unsigned cc = e % p1;
        for (unsigned d = 0; d < a; ++d)
          acc = acc + k5_load(gj + (size_t)cc * a + d);
        break;
      }
      default: {  // K5_RSHIFT_RUN
        const unsigned i = e / p1, s = e - i * p1;
        const unsigned par = (unsigned)v.table[b[RD_PARENT] + i];
        for (unsigned d = 0; d < a; ++d)
          acc = acc + k5_load(gj + ((size_t)par * p1 + s) * a + d);
      }
    }
  }
  const long long at = r[RV_OUT] + e;
  if (r[RV_SEED]) {
    v.xs[at] = acc;
  } else if (r[RV_IDENT]) {
    v.g[at] = acc;
  } else {
    const double ratio = k5_load(v.g + at), x = k5_load(v.px + at);
    v.g[at] = ratio * acc;
    v.px[at] = acc * x;
  }
}

// Entry x (over the tapes' ratio tables, `engine/dense.py:ratio_offsets`
// a tape) of the ratio tables: its cotangent and partials into q[2 x],
// q[2 x + 1].
K5_FN void k30_table_entry(const K5Ctx& c, const K30Ctx& v, unsigned x) {
  const unsigned a = (unsigned)c.a;
  const unsigned t = x / v.rat_len, e = x - t * v.rat_len;
  int slot, lev;
  unsigned w;
  if (e >= v.off_re) {
    slot = c.k;
    lev = c.k;
    w = e - v.off_re;
  } else {
    lev = 1;
    while (e >= v.off_le[lev] + c.pw[lev]) ++lev;
    slot = lev - 1;
    w = e - v.off_le[lev];
  }
  double acc = 0.0;
  const int sl = (int)t * (c.k + 1) + slot;
  for (int q = v.tab_ptr[sl]; q < v.tab_ptr[sl + 1]; ++q) {
    const long long* st = v.steps + (size_t)v.tab_steps[q] * ST_FIELDS;
    const unsigned lo = (unsigned)st[ST_LO], span = (unsigned)st[ST_SPAN];
    const unsigned rest = w / lo, s = w - rest * lo;
    const unsigned h = rest / span, rank = rest - h * span;
    const int* ranks = v.table + st[ST_RANKS];
    int i0 = 0, i1 = (int)st[ST_D] - 1;
    while (i0 < i1) {  // the first live rank >= rank
      const int mid = (i0 + i1) >> 1;
      if ((unsigned)ranks[mid] < rank)
        i0 = mid + 1;
      else
        i1 = mid;
    }
    if ((unsigned)ranks[i0] == rank)
      acc = acc + k5_load(v.px + st[ST_DST] +
                          ((size_t)h * st[ST_D] + i0) * lo + s);
  }
  const unsigned pbase = t * c.pw[c.k];
  const unsigned lbase = c.n_state + t * v.low_block;
  unsigned yn, yd;
  if (slot == c.k) {
    yn = pbase + w;
    yd = lbase + c.lv_off[c.k - 1] + w / a;
  } else {
    yn = lev == c.k ? pbase + w : lbase + c.lv_off[lev] + w;
    yd = lbase + c.lv_off[lev - 1] + w % c.pw[lev - 1];
  }
  double dn, dd;
  k30_partials(k4_pyramid(c, (int)yn), k4_pyramid(c, (int)yd), dn, dd);
  v.q[2 * (size_t)x] = acc * dn;
  v.q[2 * (size_t)x + 1] = acc * dd;
}

// Signature g's weight's cotangent.
K5_FN void k30_signature(const K5Ctx& c, const K30Ctx& v, int g) {
  double acc = 0.0;
  for (int q = v.sig_ptr[g]; q < v.sig_ptr[g + 1]; ++q) {
    const int t = v.sig_terms[q];
    double x;
    if (t < v.n_xs)
      x = k5_load(v.xs + t);
    else if (t < v.n_xs + (int)c.n_state)
      x = v.u[t - v.n_xs];
    else
      x = -v.u[t - v.n_xs - (int)c.n_state];
    acc = acc + x;
  }
  v.sbar[g] = acc;
}

// World w: w_bar, and its chain factors' partials.
K5_FN void k30_world(const K5Ctx& c, const K30Ctx& v, int w) {
  double wv = 0.0;
  for (int q = v.world_ptr[w]; q < v.world_ptr[w + 1]; ++q)
    wv = wv + k5_load(v.sbar + v.world_sigs[q]);
  const int n = v.chain;
  double g[kK30MaxChain], dn[kK30MaxChain], dd[kK30MaxChain],
      suf[kK30MaxChain];
  for (int j = 0; j < n; ++j) {
    const double num = k4_pyramid(c, v.w_num[(size_t)w * n + j]);
    const double den = k4_pyramid(c, v.w_den[(size_t)w * n + j]);
    g[j] = k5_guarded(num, den);
    k30_partials(num, den, dn[j], dd[j]);
  }
  double prod = g[0];
  for (int j = 1; j < n; ++j) prod = prod * g[j];
  if (v.wbar) v.wbar[w] = wv * prod;
  const double weight = wv * v.w_const[w];
  suf[n - 1] = 1.0;
  for (int j = n - 2; j >= 0; --j) suf[j] = suf[j + 1] * g[j + 1];
  double pre = 1.0;
  double* q = v.q + 2 * (size_t)v.tapes * v.rat_len + 2 * (size_t)w * n;
  for (int j = 0; j < n; ++j) {
    const double gb = weight * (pre * suf[j]);
    q[2 * j] = gb * dn[j];
    q[2 * j + 1] = gb * dd[j];
    pre = pre * g[j];
  }
}

// The partial of the ratio-table entry `entry` of tape t (side 0: as a
// numerator, 1: as a denominator).
K5_FN double k30_q(const K30Ctx& v, unsigned t, unsigned entry, int side) {
  return k5_load(v.q + 2 * ((size_t)t * v.rat_len + entry) + side);
}

// Pyramid entry y ([p | low] coordinates, K4's): its own terms.
K5_FN void k30_direct(const K5Ctx& c, const K30Ctx& v, unsigned y) {
  const unsigned a = (unsigned)c.a, n = c.pw[c.k];
  unsigned t, x;
  int j;
  if (y < c.n_state) {
    t = y / n;
    x = y - t * n;
    j = c.k;
  } else {
    const unsigned z = y - c.n_state;
    t = z / v.low_block;
    const unsigned r = z - t * v.low_block;
    if (r == c.lv_off[0] + 1) {  // the constant 1 above level 0
      v.direct[y] = 0.0;
      return;
    }
    j = c.k - 1;
    while (r >= c.lv_off[j] + c.pw[j]) --j;
    x = r - c.lv_off[j];
  }
  double acc = 0.0;
  if (j == c.k) {
    acc = acc + k30_q(v, t, v.off_le[c.k] + x, 0);
    acc = acc + k30_q(v, t, v.off_re + x, 0);
  } else if (j >= 1) {
    acc = acc + k30_q(v, t, v.off_le[j] + x, 0);
  }
  if (j < c.k)
    for (unsigned d = 0; d < a; ++d)
      acc = acc + k30_q(v, t, v.off_le[j + 1] + d * c.pw[j] + x, 1);
  if (j == c.k - 1)
    for (unsigned d = 0; d < a; ++d)
      acc = acc + k30_q(v, t, v.off_re + x * a + d, 1);
  int lo = 0, hi = v.n_wt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v.wt_pyr[mid] < (int)y)
      lo = mid + 1;
    else
      hi = mid;
  }
  for (int q = lo; q < v.n_wt && v.wt_pyr[q] == (int)y; ++q)
    acc = acc + k5_load(v.q + v.wt_q[q]);
  v.direct[y] = acc;
}

// Entry y of p: the pyramid's transpose.
K5_FN void k30_pbar(const K5Ctx& c, const K30Ctx& v, unsigned y) {
  const unsigned n = c.pw[c.k], t = y / n, x = y - t * n;
  const double* lv = v.direct + c.n_state + (size_t)t * v.low_block;
  double acc = k5_load(lv + c.lv_off[0]);
  for (int j = 1; j < c.k; ++j)
    acc = k5_load(lv + c.lv_off[j] + x / c.pw[c.k - j]) + acc;
  v.pbar[y] = k5_load(v.direct + y) + acc;
}

#ifdef __CUDACC__
#include <cooperative_groups.h>

// K5's, K25's and K30's launch forms (`engine/dense.py:LaunchForm`), by
// the barrier between two phases: the cooperative grid's sync, one
// block's __syncthreads, one thread-block cluster's hardware barrier.
enum { kFormGrid = 0, kFormBlock = 1, kFormCluster = 2 };

constexpr int kK5Staged = 32;  // items unpacked into shared memory at once

// The barrier before each phase of form F. The cluster's is the hardware
// one, its arrive a release and its wait an acquire at the cluster's
// scope: what one block wrote before it, every block of the cluster
// reads after it.
template <int F>
__device__ __forceinline__ void k5_form_barrier() {
  if constexpr (F == kFormGrid) {
    cooperative_groups::this_grid().sync();
  } else if constexpr (F == kFormCluster) {
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// The block and cluster forms' leading phases: the levels ``o`` asks
// for, from level k-1 down, a barrier after each (none in the grid form,
// where K3 made them before the launch).
template <int F, class T>
__device__ __forceinline__ void k5_form_levels(const K5CtxT<T>& c,
                                               const K5LevelOut& o,
                                               unsigned tid,
                                               unsigned stride) {
  if constexpr (F != kFormGrid) {
    if (!o.lv && !o.vlv) return;
    for (int j = c.k - 1; j >= 0; --j) {
      const unsigned count = k5_level_count(c, o, j);
      for (unsigned x = tid; x < count; x += stride)
        k5_level_entry(c, o, j, x);
      if (j == 0 && tid < k5_level_ways(o) * (unsigned)o.tapes)
        k5_level_one(c, o, tid);
      k5_form_barrier<F>();
    }
  }
}

// One phase of K5's plan: ``op(item, e)`` for element e of each of the
// items [begin, end), a thread an element in a loop strided by the
// launch's threads (``tid`` the thread's index in it). The items are
// read from ``all`` where the block holds the plan unpacked, else
// unpacked from their rows (K5_FIELDS each) kK5Staged at a time into
// ``staged`` (the block's shared array); an element finds its item by a
// binary search on the items' starts. K5's values (`k5_element`) and
// K30's forward (`k30_forward`).
template <bool kDual, class T, class Op>
__device__ __forceinline__ void k5_phase_elements(
    const K5CtxT<T>& c, const long long* rows, const K5Item* all,
    long long begin, long long end, K5Item* staged, unsigned tid,
    unsigned stride, Op op) {
  for (long long first = begin; first < end; first += kK5Staged) {
    const int count =
        (int)(end - first < kK5Staged ? end - first : kK5Staged);
    const K5Item* its = staged;
    if (all) {
      its = all + first;
    } else {
      __syncthreads();  // the previous chunk's elements are done
      for (int q = threadIdx.x; q < count; q += blockDim.x) {
        K5Item it = k5_item(rows + (first + q) * K5_FIELDS, c);
        if (!kDual) it.poff = it.loff = 0;  // a single tape's: not read
        staged[q] = it;
      }
      __syncthreads();
    }
    const long long base = its[0].start;
    const unsigned total =
        (unsigned)(its[count - 1].start + its[count - 1].n - base);
    for (unsigned x = tid; x < total; x += stride) {
      int lo = 0, hi = count - 1;  // the last item starting <= x
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (its[mid].start - base <= (long long)x)
          lo = mid;
        else
          hi = mid - 1;
      }
      op(its[lo], (unsigned)(x - (its[lo].start - base)));
    }
  }
}

__device__ __forceinline__ double k5_shfl(double x, int lane) {
  return __shfl_sync(0xffffffffu, x, lane);
}

__device__ __forceinline__ K25Dual k5_shfl(const K25Dual& x, int lane) {
  K25Dual r;
  r.v = __shfl_sync(0xffffffffu, x.v, lane);
  r.d = __shfl_sync(0xffffffffu, x.d, lane);
  return r;
}

// K4's signature weights, a warp a signature, grid-stride over the
// warps of the launch (``tid`` the thread's index in it, ``stride`` its
// threads): lane l forms the weight of pairs l, l + 32, ... and the warp
// adds them from 0.0 in pair order by shuffles. K5's and K25's phase 0
// and K7's and K8's first launch.
template <class T>
__device__ __forceinline__ void k4_warp_weights(const K5CtxT<T>& c,
                                                const K4Pairs& w, T* s,
                                                int n_sig, unsigned tid,
                                                unsigned stride) {
  const int lane = (int)(tid & 31);
  for (unsigned g = tid >> 5; g < (unsigned)n_sig; g += stride >> 5) {
    const int q0 = w.csr_ptr[g], q1 = w.csr_ptr[g + 1];
    T acc = T();
    for (int base = q0; base < q1; base += 32) {
      const T x = base + lane < q1 ? k4_pair_weight(c, w, base + lane) : T();
      const int count = q1 - base < 32 ? q1 - base : 32;
      for (int j = 0; j < count; ++j) acc = k5_add(acc, k5_shfl(x, j));
    }
    if (lane == 0) s[g] = acc;
  }
}
#endif
