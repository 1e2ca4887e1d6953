// K15: the symbol <-> bit-plane transposes of the bit-sliced rounds.
//
// Replaces the JAX package's `engine/bitslice.py` `tapes_to_bitplanes`,
// `bitplanes_to_tapes`, `stacked_planes_to_bitwords` and
// `bitwords_to_stacked_planes` (XLA programs on the TPU). Plain PyTorch
// versions: `engine/bitslice.py:pack_bitwords_plain` and
// `unpack_bitwords_plain`.
//
// Layout. The symbols are a [B, E, stride] array given by its element
// strides (sb, se, sc), int8 or int32, so one kernel serves every layout
// that holds them: [B, L] tapes (column e*stride + c), the FSM planes
// [stride, B, E] and the frontier's [stride, E, K]. The words are int32
// [stride, nb, W, E] (straight) or [stride, nb, E, W] (transposed),
// W = B/32: bit `lane` of word (c, k, w, e) is bit k of symbol
// (32*w + lane, e, c).
//
// Design. A block takes 8 member words (256 members, warp g the 32 of
// word g) and 32 columns, the columns running along whichever of the
// site and phase axes is denser in memory; a lane works out its
// column's offset once. Where the members lie apart ([B, L] tapes, the
// FSM planes), each warp stages its 32 members' rows of the 32 columns
// through shared memory (a row padded to 33 ints, so that both the
// row-wise and the column-wise accesses hit 32 banks): lane j reads and
// writes column j, so a warp's device-memory accesses are one run along
// the columns. Where the members are adjacent (the frontier's planes),
// lane j reads and writes member j directly. Pack's `__ballot_sync` on
// bit k of a column's 32 symbols gives a word; unpack takes each lane's
// bit of it. The block's 32 x nb x 8 words pass through a second
// buffer, so that 8 neighbouring threads store (or load) the 8 words of
// one column and bit, which sit side by side in the transposed layout:
// one 32-byte sector.
//
// Bound. Pack must read each symbol once and write each word once:
// B*L*elem + B*L*nb/8 bytes; unpack the reverse.

#include <cuda_runtime.h>
#include <stdint.h>

#define K15_WARPS 8   // member words a block, a warp each
#define K15_COLS 32   // columns a block
#define K15_MAX_NB 8

namespace {

struct K15Geom {
  long long sb, se, sc;  // symbol strides, in elements
  int B, E, stride, nb;
  int inner_c;    // 1: columns run along the phase axis, else the site axis
  int transpose;  // 1: [stride, nb, E, W] words, else [stride, nb, W, E]
};

__device__ __forceinline__ void k15_column(const K15Geom& g, int l, int& e,
                                           int& c) {
  if (g.inner_c) {
    e = l / g.stride;
    c = l - e * g.stride;
  } else {
    c = l / g.E;
    e = l - c * g.E;
  }
}

__device__ __forceinline__ long long k15_word(const K15Geom& g, int c, int k,
                                              int e, long long w,
                                              long long W) {
  const long long EW = (long long)g.E * W;
  return ((long long)c * g.nb + k) * EW +
         (g.transpose ? (long long)e * W + w : w * g.E + e);
}

struct K15Block {
  int lane, warp, l0, n;
  long long W, w0, w;  // member words: count, the block's first, the warp's
  long long col_off;   // lane's column offset in the symbols (lane < n)
};

__device__ __forceinline__ K15Block k15_block(const K15Geom& g) {
  K15Block b;
  b.lane = threadIdx.x & 31;
  b.warp = threadIdx.x >> 5;
  b.W = g.B / 32;
  b.w0 = (long long)blockIdx.x * K15_WARPS;
  b.w = b.w0 + b.warp;
  b.l0 = blockIdx.y * K15_COLS;
  const int L = g.E * g.stride;
  b.n = L - b.l0 < K15_COLS ? L - b.l0 : K15_COLS;
  b.col_off = 0;
  if (b.lane < b.n) {
    int e, c;
    k15_column(g, b.l0 + b.lane, e, c);
    b.col_off = e * g.se + c * g.sc;
  }
  return b;
}

// Entry q of the block's word buffer [col][k][warp]: its place in the
// words, or -1 past the last member word.
__device__ __forceinline__ long long k15_entry(const K15Geom& g,
                                               const K15Block& b, int q,
                                               int& col, int& k, int& gw) {
  gw = q % K15_WARPS;
  const int kc = q / K15_WARPS;
  k = kc % g.nb;
  col = kc / g.nb;
  const long long w = b.w0 + gw;
  if (w >= b.W) return -1;
  int e, c;
  k15_column(g, b.l0 + col, e, c);
  return k15_word(g, c, k, e, w, b.W);
}

template <typename T, bool TILED>
__global__ void __launch_bounds__(K15_WARPS * 32)
    k15_pack(const T* __restrict__ sym, K15Geom g, int32_t* __restrict__ out) {
  __shared__ int tile[TILED ? K15_WARPS : 1][32][33];
  __shared__ int32_t buf[K15_COLS][K15_MAX_NB][K15_WARPS];
  const K15Block b = k15_block(g);
  if (b.w < b.W) {  // uniform over the warp
    const T* rows = sym + b.w * 32 * g.sb;
    if (TILED && b.lane < b.n)
      for (int r = 0; r < 32; ++r)
        tile[TILED ? b.warp : 0][r][b.lane] = (int)rows[r * g.sb + b.col_off];
    __syncwarp();
    for (int col = 0; col < b.n; ++col) {
      const long long off = __shfl_sync(0xffffffffu, b.col_off, col);
      const int v = TILED ? tile[TILED ? b.warp : 0][b.lane][col]
                          : (int)rows[b.lane + off];
      for (int k = 0; k < g.nb; ++k) {
        const unsigned word = __ballot_sync(0xffffffffu, (v >> k) & 1);
        if (b.lane == 0) buf[col][k][b.warp] = (int32_t)word;
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < b.n * g.nb * K15_WARPS;
       q += K15_WARPS * 32) {
    int col, k, gw;
    const long long at = k15_entry(g, b, q, col, k, gw);
    if (at >= 0) out[at] = buf[col][k][gw];
  }
}

template <typename T, bool TILED>
__global__ void __launch_bounds__(K15_WARPS * 32)
    k15_unpack(const int32_t* __restrict__ words, K15Geom g,
               T* __restrict__ sym) {
  __shared__ int tile[TILED ? K15_WARPS : 1][32][33];
  __shared__ int32_t buf[K15_COLS][K15_MAX_NB][K15_WARPS];
  const K15Block b = k15_block(g);
  for (int q = threadIdx.x; q < b.n * g.nb * K15_WARPS;
       q += K15_WARPS * 32) {
    int col, k, gw;
    const long long at = k15_entry(g, b, q, col, k, gw);
    if (at >= 0) buf[col][k][gw] = words[at];
  }
  __syncthreads();
  if (b.w >= b.W) return;  // uniform over the warp; no barrier follows
  T* rows = sym + b.w * 32 * g.sb;
  for (int col = 0; col < b.n; ++col) {
    const long long off = __shfl_sync(0xffffffffu, b.col_off, col);
    int v = 0;
    for (int k = 0; k < g.nb; ++k)
      v |= (int)(((uint32_t)buf[col][k][b.warp] >> b.lane) & 1u) << k;
    if (TILED)
      tile[TILED ? b.warp : 0][b.lane][col] = v;
    else
      rows[b.lane + off] = (T)v;
  }
  if (TILED) {
    __syncwarp();
    if (b.lane < b.n)
      for (int r = 0; r < 32; ++r)
        rows[r * g.sb + b.col_off] = (T)tile[TILED ? b.warp : 0][r][b.lane];
  }
}

template <typename T, bool TILED>
void k15_go(bool pack, const void* sym, K15Geom g, const void* words,
            dim3 grid, cudaStream_t st) {
  if (pack)
    k15_pack<T, TILED><<<grid, K15_WARPS * 32, 0, st>>>(
        (const T*)sym, g, (int32_t*)words);
  else
    k15_unpack<T, TILED><<<grid, K15_WARPS * 32, 0, st>>>(
        (const int32_t*)words, g, (T*)sym);
}

int k15_launch(bool pack, const void* sym, int elem, K15Geom g,
               const void* words, void* stream) {
  if (g.B % 32 || g.nb < 1 || g.nb > K15_MAX_NB ||
      (elem != 1 && elem != 4))
    return (int)cudaErrorInvalidValue;
  const long long L = (long long)g.E * g.stride;
  if (g.B == 0 || L == 0) return (int)cudaGetLastError();
  if ((L + K15_COLS - 1) / K15_COLS > 65535) return (int)cudaErrorInvalidValue;
  const long long W = g.B / 32;
  const dim3 grid((unsigned)((W + K15_WARPS - 1) / K15_WARPS),
                  (unsigned)((L + K15_COLS - 1) / K15_COLS));
  cudaStream_t st = (cudaStream_t)stream;
  const bool tiled = g.sb != 1;  // members apart: stage through a tile
  if (elem == 1) {
    if (tiled)
      k15_go<int8_t, true>(pack, sym, g, words, grid, st);
    else
      k15_go<int8_t, false>(pack, sym, g, words, grid, st);
  } else {
    if (tiled)
      k15_go<int32_t, true>(pack, sym, g, words, grid, st);
    else
      k15_go<int32_t, false>(pack, sym, g, words, grid, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Packs the [B, E, stride] symbols at `sym` (element size `elem`, 1 or
// 4, strides sb, se, sc in elements; inner_c when the phase axis is the
// denser) into nb-bit words at `out`, [stride, nb, E, B/32] when
// `transpose`, else [stride, nb, B/32, E]. Returns the launch error or 0.
extern "C" int ckpe_bitplanes_pack(const void* sym, int elem, long long sb,
                                   long long se, long long sc, int B, int E,
                                   int stride, int inner_c, int nb,
                                   int transpose, void* out, void* stream) {
  const K15Geom g{sb, se, sc, B, E, stride, nb, inner_c, transpose};
  return k15_launch(true, sym, elem, g, out, stream);
}

// The inverse: the words at `words` into the symbols at `sym`.
extern "C" int ckpe_bitplanes_unpack(void* sym, int elem, long long sb,
                                     long long se, long long sc, int B,
                                     int E, int stride, int inner_c, int nb,
                                     int transpose, const void* words,
                                     void* stream) {
  const K15Geom g{sb, se, sc, B, E, stride, nb, inner_c, transpose};
  return k15_launch(false, sym, elem, g, words, stream);
}
