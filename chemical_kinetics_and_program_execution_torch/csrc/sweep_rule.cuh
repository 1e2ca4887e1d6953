// K5's per-element rule: one step of a signature group's window sweep at
// one window rank j, as the JAX package's `engine/dense.py:_apply_group`
// computes it (phases A, B and C and the +-emission).
//
// A step forms a vector t over window ranks from the previous vector (or
// from a group's sparse one-hot seed) and a ratio table:
//
//   IDENT   t[j] = src[j]                               (the seed itself)
//   EXTEND  t[j] = ratio[j] * src[j mod n_src]          (jnp.tile: left-extend)
//   SHIFT   t[j] = ratio[j] * sum_d src[(j mod n1)*A + d]
//                                  (trailing-digit reduce, then tile)
//   RIGHT   t[j] = src[j / A] * ratio[j]                (jnp.repeat: right-extend)
//   RSHIFT  t[j] = (sum_d src[d*n1 + j / A]) * ratio[j]
//                                  (leading-digit reduce, then repeat)
//
// and, when the step emits, adds its +-emission into dy[j] as a gather:
// with r = (j / lo) mod span the window's revealed-run digits, dy[j]
// gets -t[j] if r is one of the step's original run ranks, then +t[j']
// for each (orig o, adj a) pair with a == r, in pair order, where j' is
// j with its run digits set to o. t[j'] is recomputed from the step's
// inputs, never read from another thread's write, so no two threads
// write one element and the order of every sum is fixed. The digit sums
// run in digit order, d = 0 first.
//
// A sparse seed is a list of (rank, signature id) sorted by rank (stable,
// so equal ranks keep member order); its value at x is the sum of the
// signature weights at rank x in that order, 0 where none.
//
// Plain C++ under `g++` as well, so a CPU test holds it to the plain
// step (`engine/dense.py:sweep_step_plain`) for every j.

#pragma once

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
  K5_INTERIOR = 5,
};

struct K5Step {
  int kind;
  int a;                  // alphabet size
  unsigned n_out;         // elements of t (threads)
  unsigned n_src;         // EXTEND: the source's size; SHIFT/RSHIFT: A^(k-1)
  const double* src;      // dense source, or null for a sparse seed
  const int* seed_rank;   // sparse seed: ranks, ascending
  const int* seed_sid;    // sparse seed: signature ids
  int seed_len;
  const double* sig_w;    // signature weights (K4's output)
  const double* ratio;    // this step's ratio table (null for IDENT)
  double* dst;            // where t goes for the next step, or null
  double* dy;             // the RHS, or null when the step emits nothing
  unsigned lo, span;      // emission: run digits of j are (j / lo) % span
  const int* pairs;       // emission: (orig, adj) run ranks, 2 ints a pair
  int n_pairs;
};

// The source vector at index x.
K5_FN double k5_src(const K5Step& s, unsigned x) {
  if (s.src) return s.src[x];
  int lo = 0, hi = s.seed_len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((unsigned)s.seed_rank[mid] < x) lo = mid + 1; else hi = mid;
  }
  double acc = 0.0;
  for (int i = lo; i < s.seed_len && (unsigned)s.seed_rank[i] == x; ++i)
    acc = acc + s.sig_w[s.seed_sid[i]];
  return acc;
}

// The step's new value t[j].
K5_FN double k5_value(const K5Step& s, unsigned j) {
  switch (s.kind) {
    case K5_IDENT:
      return k5_src(s, j);
    case K5_EXTEND:
      return s.ratio[j] * k5_src(s, j % s.n_src);
    case K5_SHIFT: {
      const unsigned base = (j % s.n_src) * (unsigned)s.a;
      double c = k5_src(s, base);
      for (int d = 1; d < s.a; ++d) c = c + k5_src(s, base + d);
      return s.ratio[j] * c;
    }
    case K5_RIGHT:
      return k5_src(s, j / (unsigned)s.a) * s.ratio[j];
    default: {  // K5_RSHIFT
      const unsigned ctx = j / (unsigned)s.a;
      double c = k5_src(s, ctx);
      for (int d = 1; d < s.a; ++d) c = c + k5_src(s, d * s.n_src + ctx);
      return c * s.ratio[j];
    }
  }
}

// One element of one step: t[j] into dst, the emission into dy[j].
K5_FN void k5_element(const K5Step& s, unsigned j) {
  const double t = k5_value(s, j);
  if (s.dst) s.dst[j] = t;
  if (!s.dy) return;
  const unsigned r = (j / s.lo) % s.span;
  double acc = s.dy[j];
  for (int p = 0; p < s.n_pairs; ++p) {
    if ((unsigned)s.pairs[2 * p] == r) {  // orig ranks are unique
      acc = acc + (-t);
      break;
    }
  }
  for (int p = 0; p < s.n_pairs; ++p) {
    if ((unsigned)s.pairs[2 * p + 1] == r) {
      const unsigned jp = j - r * s.lo + (unsigned)s.pairs[2 * p] * s.lo;
      acc = acc + k5_value(s, jp);
    }
  }
  s.dy[j] = acc;
}
