// K12's rule: the longest prefix of a pattern that occurs on a ring, as
// the JAX package's `engine/ensemble.py` computes `contains_pattern` and
// `pattern_progress` (the tape rolled left by j compared with symbol j
// of the pattern, for j in turn).
//
// Starting at column i, the prefix matches while row[(i + m) mod L]
// equals pattern[m] (the symbol widened to int, so an int8 tape reads
// its signed value); the ring's progress is the longest such prefix
// over every i, and the pattern is present where that is its length
// (an empty pattern is present on every ring). The first-passage update
// sets t_hit to t_now where the pattern is present and t_hit is still
// infinite. Plain C++ under `g++` as well, so a CPU test holds the rule
// to `ensemble.pattern_scan_plain`.
//
// The staged scan (`pattern_scan.cu`'s kernel, a warp a member) reads a
// row staged in shared memory with the P - 1 wrap cells appended (cell L
// + x holds cell x mod L), so a prefix walks without a modulo; an int8
// row is searched 4 bytes at a time for the pattern's first symbol (a
// byte compare of a word with that symbol in each byte, `__vcmpeq4` on
// the card, emulated byte by byte on the host), and only the candidate
// starts are walked.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K12_FN __host__ __device__ __forceinline__
typedef uint4 k12_v16;
#else
#define K12_FN static inline
struct alignas(16) k12_v16 {
  uint32_t x, y, z, w;
};
#endif

enum { kK12Contains = 0, kK12Progress = 1, kK12FirstPassage = 2 };

template <typename Sym>
K12_FN int k12_prefix_at(const Sym* row, int L, int i, const int* pat,
                         int P) {
  int m = 0;
  int col = i;
  while (m < P && (int)row[col] == pat[m]) {
    ++m;
    if (++col == L) col = 0;
  }
  return m;
}

// Member b's result from its progress ``best``, by ``mode``.
K12_FN void k12_finish(int mode, int best, int P, void* out, double* t_hit,
                       const double* t_now, int b) {
  if (mode == kK12Contains)
    ((uint8_t*)out)[b] = best == P ? 1 : 0;
  else if (mode == kK12Progress)
    ((int*)out)[b] = best;
  else if (best == P && isinf(t_hit[b]))
    t_hit[b] = *t_now;
}

// Staged row: L symbols (16 bytes a lane where ``vec``: the row's bytes
// a multiple of 16 and 16-byte aligned) and P - 1 wrap cells, for the
// lanes ``lane`` < ``nl`` of the warp that owns the member.
template <typename Sym>
K12_FN void k12_stage(int lane, int nl, const Sym* g, Sym* s, int L, int P,
                      bool vec) {
  if (vec) {
    const int q = (int)(L * sizeof(Sym) / 16);
    for (int c = lane; c < q; c += nl)
      ((k12_v16*)s)[c] = ((const k12_v16*)g)[c];
  } else {
    for (int c = lane; c < L; c += nl) s[c] = g[c];
  }
  for (int x = lane; x < P - 1; x += nl) s[L + x] = g[x % L];
}

// Bytes of a and b that are equal: 0xff in each such byte, else 0.
K12_FN uint32_t k12_vcmpeq4(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vcmpeq4(a, b);
#else
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k)
    if (((a >> (8 * k)) & 0xffu) == ((b >> (8 * k)) & 0xffu))
      r |= 0xffu << (8 * k);
  return r;
#endif
}

K12_FN int k12_low_byte(uint32_t x) {  // index of the lowest set byte
#ifdef __CUDA_ARCH__
  return (__ffs((int)x) - 1) >> 3;
#else
  return __builtin_ctz(x) >> 3;
#endif
}

// The prefix matched from start i of a staged row (no wrap needed).
template <typename Sym>
K12_FN int k12_prefix_staged(const Sym* s, int i, const int* pat, int P) {
  int m = 0;
  while (m < P && (int)s[i + m] == pat[m]) ++m;
  return m;
}

// The longest prefix over the starts of lane ``lane`` of ``nl`` on a
// staged row: int8 rows 4 starts a word (words lane, lane + nl, ...),
// int32 rows a start at a time; a start is walked only where its symbol
// is the pattern's first.
template <typename Sym>
K12_FN int k12_staged_best(int lane, int nl, const Sym* s, int L,
                           const int* pat, int P) {
  if (P == 0) return 0;
  int best = 0;
  if (sizeof(Sym) == 1) {
    if (pat[0] < -128 || pat[0] > 127) return 0;
    const uint32_t key = (uint32_t)(uint8_t)pat[0] * 0x01010101u;
    for (int w = lane; w < (L + 3) / 4; w += nl) {
      uint32_t hit = k12_vcmpeq4(((const uint32_t*)s)[w], key);
      while (hit) {
        const int k = k12_low_byte(hit);
        hit &= ~(0xffu << (8 * k));
        const int i = 4 * w + k;
        if (i >= L) break;
        const int m = k12_prefix_staged(s, i, pat, P);
        best = m > best ? m : best;
      }
    }
  } else {
    for (int i = lane; i < L; i += nl) {
      if ((int)s[i] != pat[0]) continue;
      const int m = k12_prefix_staged(s, i, pat, P);
      best = m > best ? m : best;
    }
  }
  return best;
}

// Symbols of a staged row in shared memory: L + P - 1, rounded up to 16
// bytes.
K12_FN int k12_staged_stride(int L, int P, int elem) {
  const int cells = L + (P > 1 ? P - 1 : 0);
  return ((cells * elem + 15) & ~15) / elem;
}

#ifndef __CUDACC__
// The staged kernel on the host: a warp of 32 lanes a member, member
// after member, staging its row (`k12_stage`) and taking each lane's
// best (`k12_staged_best`), the lanes' maximum then finishing the member.
#include <stdlib.h>
template <typename Sym>
static int k12_host_staged(const Sym* tape, int B, int L, const int* pat,
                           int P, int mode, void* out, double* t_hit,
                           const double* t_now) {
  const int S = k12_staged_stride(L, P, (int)sizeof(Sym));
  Sym* s = (Sym*)aligned_alloc(16, (size_t)S * sizeof(Sym));
  if (!s) return 1;
  const bool vec = (L * sizeof(Sym)) % 16 == 0 && (uintptr_t)tape % 16 == 0;
  for (int b = 0; b < B; ++b) {
    const Sym* g = tape + (long long)b * L;
    for (int lane = 0; lane < 32; ++lane) k12_stage(lane, 32, g, s, L, P, vec);
    int best = 0;
    for (int lane = 0; lane < 32; ++lane) {
      const int m = k12_staged_best(lane, 32, s, L, pat, P);
      best = m > best ? m : best;
    }
    k12_finish(mode, best, P, out, t_hit, t_now, b);
  }
  free(s);
  return 0;
}

extern "C" int ckpe_k12_host_staged(const void* tape, int elem, int B, int L,
                                    const int* pat, int P, int mode,
                                    void* out, double* t_hit,
                                    const double* t_now) {
  if (elem == 1)
    return k12_host_staged((const int8_t*)tape, B, L, pat, P, mode, out,
                           t_hit, t_now);
  return k12_host_staged((const int*)tape, B, L, pat, P, mode, out, t_hit,
                         t_now);
}

// Every member on the host (the CPU test of the rule); elem is 1 for an
// int8 tape, 4 for int32.
extern "C" int ckpe_k12_host_scan(const void* tape, int elem, int B, int L,
                                  const int* pat, int P, int mode, void* out,
                                  double* t_hit, const double* t_now) {
  for (int b = 0; b < B; ++b) {
    int best = 0;
    for (int i = 0; i < L; ++i) {
      const int m =
          elem == 1
              ? k12_prefix_at((const int8_t*)tape + (long long)b * L, L, i,
                              pat, P)
              : k12_prefix_at((const int*)tape + (long long)b * L, L, i, pat,
                              P);
      best = m > best ? m : best;
    }
    k12_finish(mode, best, P, out, t_hit, t_now, b);
  }
  return 0;
}
#endif
