// K22's selection and ordering rule (`frontier.cu`), host and device.
//
// The per-step beam keeps the top K of the K*M children, in the order of
// a stable descending sort (`torch.sort(stable=True, descending=True)`,
// the JAX package's `lax.top_k`): larger weight first, the lower flat
// index first among equal weights. As integers: each float64 child maps
// to a 64-bit key whose ascending order is that descending order
// (`k22_desc_key`); -0.0 maps as +0.0 (the two compare equal) and every
// NaN as one NaN above +inf (the sort puts NaNs first).
//
// Select: a radix select over the keys' 8-bit digits from the top, one
// pass a digit (`k22_select_step` after each pass's histogram of the
// keys that still match the prefix). It stops where the bucket that
// holds the K-th key is taken whole, where the keys of a pass are all
// one key (`k22_select_single`: a tie group holds the K-th), or after
// the last digit. The K kept
// are then every key whose resolved digits lie below the prefix, and the
// first `need` in index order of those equal to it (`k22_kept_class`).
// Compacted in index order, they go to the order step.
//
// Order: a stable LSD radix sort of the kept (key, index) pairs, one
// pass an 8-bit digit from the bottom, each pass skipped where every kept
// key has the same digit (`k22_varying`). Stable passes over keys in
// index order leave equal keys in index order.
//
// The card runs each rule in parallel (`frontier.cu`); the tests build
// this header with g++ and run the same rules in turn against the plain
// version's sort (`tests/test_torch_frontier.py`).

#ifndef CKPE_BEAM_RULE_CUH
#define CKPE_BEAM_RULE_CUH

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define K22_FN __host__ __device__ __forceinline__
#else
#define K22_FN inline
#endif

#define K22_BINS 256  // 8-bit digits, the select's and the sort's
#define K22_PASSES 8  // the select's passes and the sort's
#define K22_TILE 4096  // keys a block of the compaction and the sort

K22_FN uint64_t k22_bits(double v) {
#ifdef __CUDA_ARCH__
  return (uint64_t)__double_as_longlong(v);
#else
  uint64_t u;
  memcpy(&u, &v, sizeof u);
  return u;
#endif
}

// Ascending order of the key is descending order of the value.
K22_FN uint64_t k22_desc_key(double v) {
  uint64_t u = k22_bits(v);
  if (v != v) u = 0x7ff8000000000000ULL;  // one NaN, above +inf
  if (u == 0x8000000000000000ULL) u = 0;  // -0.0 as +0.0
  const uint64_t asc = (u >> 63) ? ~u : (u | 0x8000000000000000ULL);
  return ~asc;
}

// The ascending key of a value (for the largest child at M = 1, by an
// integer maximum): NaN above every number, so a maximum over values
// with a NaN is NaN, as `torch.max`'s.
K22_FN uint64_t k22_asc_key(double v) {
  uint64_t u = k22_bits(v);
  if (v != v) u = 0x7ff8000000000000ULL;
  return (u >> 63) ? ~u : (u | 0x8000000000000000ULL);
}

K22_FN double k22_asc_value(uint64_t asc) {
  const uint64_t u = (asc >> 63) ? (asc & 0x7fffffffffffffffULL) : ~asc;
#ifdef __CUDA_ARCH__
  return __longlong_as_double((long long)u);
#else
  double v;
  memcpy(&v, &u, sizeof v);
  return v;
#endif
}

// The select's state before a pass: the resolved digits (left-aligned),
// how many of the keys that match them are still to take, whether the
// bucket was taken whole, and the digits resolved.
struct K22Sel {
  unsigned long long prefix;
  unsigned need;
  unsigned done;
  unsigned resolved;
  unsigned pad;
};

K22_FN unsigned k22_digit(uint64_t key, unsigned pass) {  // from the top
  return (unsigned)(key >> (56 - 8 * pass)) & 0xffu;
}

// Whether a key takes part in pass ``pass`` (its resolved digits match).
K22_FN bool k22_in_pass(uint64_t key, const K22Sel& s, unsigned pass) {
  return pass == 0 || (key >> (64 - 8 * pass)) == (s.prefix >> (64 - 8 * pass));
}

// After pass ``pass``'s histogram: the bucket that holds the need-th key,
// the keys below it dropped from need.
K22_FN K22Sel k22_select_step(const K22Sel& s, const unsigned* hist,
                              unsigned pass) {
  K22Sel t = s;
  unsigned below = 0, b = 0;
  while (b < K22_BINS - 1 && below + hist[b] < s.need) below += hist[b++];
  t.prefix = s.prefix | ((unsigned long long)b << (56 - 8 * pass));
  t.need = s.need - below;
  t.resolved = pass + 1;
  t.done = (hist[b] == t.need || pass == K22_PASSES - 1) ? 1u : 0u;
  return t;
}

// Where every key that takes part in a pass is one key (their least and
// largest equal): the select stops there, that key resolved whole and
// need unchanged (no key of the pass lies below it).
K22_FN K22Sel k22_select_single(const K22Sel& s, uint64_t key) {
  K22Sel t = s;
  t.prefix = key;
  t.resolved = K22_PASSES;
  t.done = 1u;
  return t;
}

// 1 for a key below the prefix (kept), 2 for one equal to it (kept if
// among the first need in index order), 0 otherwise.
K22_FN int k22_kept_class(uint64_t key, const K22Sel& s) {
  const unsigned sh = 64 - 8 * s.resolved;
  const uint64_t top = sh == 64 ? 0 : key >> sh;
  const uint64_t want = sh == 64 ? 0 : s.prefix >> sh;
  return top < want ? 1 : top == want ? 2 : 0;
}

// The LSD passes' digit (from the bottom), and whether pass ``pass``
// sorts anything: the kept keys differ in that digit (``all_and``,
// ``all_or``: the AND and OR of every kept key).
K22_FN unsigned k22_lsd_digit(uint64_t key, unsigned pass) {
  return (unsigned)(key >> (8 * pass)) & 0xffu;
}

K22_FN bool k22_varying(uint64_t all_and, uint64_t all_or, unsigned pass) {
  return k22_lsd_digit(all_and ^ all_or, pass) != 0;
}

// Which of the two ping-pong buffers pass ``pass`` reads: one flip a pass
// that sorts.
K22_FN unsigned k22_parity(uint64_t all_and, uint64_t all_or,
                           unsigned pass) {
  unsigned p = 0;
  for (unsigned q = 0; q < pass; ++q) p ^= k22_varying(all_and, all_or, q);
  return p;
}

#endif  // CKPE_BEAM_RULE_CUH
