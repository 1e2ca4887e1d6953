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

// A compute item's value at compact index e. A product's two factors
// commute bit for bit, in doubles and in pairs alike.
template <bool kDual, class T>
K5_FN T k5_value(const K5CtxT<T>& c, const K5Item& it, unsigned e) {
  const int op = it.op;
  const unsigned rest = k5_q(e, it.lo), h = k5_q(rest, it.d);
  const unsigned i = rest - h * it.d.d;
  const unsigned j = (h * it.span + (unsigned)c.table[it.tab + i]) * it.lo.d +
                     (e - rest * it.lo.d);
  if (op == K5_IDENT) return k5_src(c, it, e);
  const T r = k5_ratio<kDual>(c, it, j);
  switch (op) {
    case K5_EXTEND:
      return k5_mul(r, k5_src(c, it, k5_r(e, it.xn)));
    case K5_RIGHT:
      return k5_mul(r, k5_src(c, it, k5_q(e, it.a)));
    case K5_RSHIFT: {
      const unsigned cc = k5_q(e, it.a);
      T sum = k5_src(c, it, cc);
      for (unsigned dd = 1; dd < it.a.d; ++dd)
        sum = k5_add(sum, k5_src(c, it, dd * it.n1 + cc));
      return k5_mul(r, sum);
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
      T sum = k5_src(c, it, base + (unsigned)t[t[row]] * step);
      for (int q = t[row] + 1; q < t[row + 1]; ++q)
        sum = k5_add(sum, k5_src(c, it, base + (unsigned)t[q] * step));
      return k5_mul(r, sum);
    }
  }
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

#ifdef __CUDACC__
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
