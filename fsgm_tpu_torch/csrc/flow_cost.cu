// K6 flow_cost: the fSGM flow cost volume on Hopper (sm_90a), label-minor.
//
// Replaces no Pallas kernel: the JAX package builds the flow cost volume in
// XLA (fsgm_tpu/ops/cost.py::cost_volume_flow_major), and its TPU backend
// then turns the label-major planes into the label-minor layout that the
// sweeps read (transpose_pallas.py::label_minor_from_major, here K5).  This
// kernel is the counterpart of that XLA stage and of K5's pass together:
// one launch writes the ([N,] H, W, nl_pad) u8 volume that K2 reads, with
// the values of ops/cost.py::cost_volume_flow_major.  Over the (2r+1)^2
// labels l = (dv + r) e + (du + r), e = 2r + 1, of slice n:
//
//   W[n, Y, X]    = cen2[n, Y + y_offset + bv, X + bu],  (bu, bv) the bases
//                   of row Y + halo, column X; invalid where the base row or
//                   X lies outside the bases, the global row Y + y_offset
//                   or the source lies outside the second image;
//   C[n, y, x, l] = popcount(cen1[n, y, x] ^ W[n, y + dv, x + du]),
//                   invalid_cost where W is invalid there;
//   labels nl ... nl_pad - 1 hold invalid_cost.
//
// halo is 0 (untiled: bases of the H rows, y_offset 0) or r (a row tile,
// parallel/tiled_flow.py: bases extended by r true rows of each neighbour,
// the tile's first global row y_offset, the whole second image of H2 rows).
//
// Bound: device-memory bytes.  At config 4 a frame holds 769,924 slice-
// pixels over its four levels (the forward pass at level 0, both directions
// at levels 1-3); each writes 96 label bytes (81 labels in 96 slots) and
// reads about 24 (its census word, the gathered second-image word, its two
// bases): about 92 MB, 0.028 ms at 3.35 TB/s.  74 M XOR-popcount-selects a
// frame at 16 32-bit POPC a clock per SM take about 0.018 ms.  Design:
//   * A block owns a tile of kTileH x kTileW output pixels of one slice (a
//     flat grid over N slices x tile rows x tile columns, 64-bit offsets),
//     so the coarse levels fill the card through the slice axis.
//   * Staging: each position (Y, X) of the tile's window region, (kTileH +
//     2r) x (kTileW + 2r), reads its own bases and gathers its warped
//     second-image word once into shared memory; the tile's cen1 words are
//     staged beside them.  Census words use at most 62 bits, so the top bit
//     of a staged word marks it invalid, with no second array.  Where the
//     caller's census window fits 31 bits (census_bits <= kWord32Bits) the
//     words are staged as 32 bits (bit 31 the mark) and one 32-bit popcount
//     makes a byte; above that, 64-bit words (bit 63).
//   * Label work: a thread makes one 16-label group of one pixel, packed
//     into one 16-byte store.  Unit u = (chunk of 16 pixels of a tile row,
//     group, pixel): a half-warp takes one group of 16 consecutive pixels,
//     so at each label its lanes read 16 consecutive staged words (no bank
//     conflict in a half-warp's 64-bit access), and a warp's two halves
//     store neighbouring groups of the same pixels: 32 contiguous bytes a
//     pixel.  A group wholly past nl stores invalid_cost without a read.
// The label loop walks the window row by row with an incremental staged
// offset (no division a label).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;      // labels of one thread: one 16-byte store
constexpr int kTileH = 16;      // output rows of one tile
constexpr int kTileW = 64;      // output columns of one tile
constexpr int kMaxRadius = 7;   // (ops/kernels/flow_cost.py MAX_RADIUS)
constexpr int kMaxGroups = 16;  // nl_pad up to 256
constexpr int kStageMax = (kTileH + 2 * kMaxRadius) * (kTileW + 2 * kMaxRadius);
// census_bits up to this take 32-bit words (ops/kernels/flow_cost.py
// WORD32_BITS): bit 31 must stay free for the invalid mark
constexpr int kWord32Bits = 31;

template <bool W32>
using Word = typename std::conditional<W32, uint32_t, unsigned long long>::type;

template <bool W32>
__device__ __forceinline__ Word<W32> invalid_mark() {
  return (Word<W32>)1 << (8 * sizeof(Word<W32>) - 1);
}

template <bool W32>
__device__ __forceinline__ int hamming(Word<W32> a, Word<W32> b) {
  if constexpr (W32) return __popc(a ^ b);
  else return __popcll(a ^ b);
}

template <bool W32>
__global__ void __launch_bounds__(kThreads)
flow_cost_kernel(const long long* __restrict__ cen1,
                 const long long* __restrict__ cen2,
                 const int* __restrict__ base_u,
                 const int* __restrict__ base_v, uint8_t* __restrict__ out,
                 int h, int w, int h2, int hb, int radius, int nl, int groups,
                 int invalid_cost, int y_offset, int tiles_y, int tiles_x) {
  __shared__ Word<W32> stage[kStageMax];
  __shared__ Word<W32> ref[kTileH * kTileW];
  const Word<W32> mark = invalid_mark<W32>();

  const long long tile = blockIdx.x;
  const int tx = (int)(tile % tiles_x);
  const long long rest = tile / tiles_x;
  const int ty = (int)(rest % tiles_y);
  const long long n = rest / tiles_y;
  const int y0 = ty * kTileH, x0 = tx * kTileW;
  const int e = 2 * radius + 1;
  const int halo = (hb - h) / 2;
  const int sh = kTileH + 2 * radius, sw = kTileW + 2 * radius;

  // the window region: staged (i, j) is output-row Y = y0 - r + i, column
  // X = x0 - r + j of this slice
  const int* const bu_n = base_u + n * hb * (long long)w;
  const int* const bv_n = base_v + n * hb * (long long)w;
  const long long* const c2_n = cen2 + n * h2 * (long long)w;
#pragma unroll 4
  for (int q = threadIdx.x; q < sh * sw; q += kThreads) {
    const int i = q / sw;
    const int j = q - i * sw;
    const int yy = y0 - radius + i;
    const int xx = x0 - radius + j;
    const int brow = yy + halo;
    Word<W32> word = mark;
    if (brow >= 0 && brow < hb && xx >= 0 && xx < w) {
      const long long b = (long long)brow * w + xx;
      const long long gy = (long long)yy + y_offset;
      const long long sy = gy + __ldg(bv_n + b);
      const long long sx = (long long)xx + __ldg(bu_n + b);
      if (gy >= 0 && gy < h2 && sy >= 0 && sy < h2 && sx >= 0 && sx < w)
        word = (Word<W32>)__ldg(c2_n + sy * w + sx);
    }
    stage[q] = word;
  }
  const long long* const c1_n = cen1 + n * h * (long long)w;
  for (int q = threadIdx.x; q < kTileH * kTileW; q += kThreads) {
    const int y = y0 + q / kTileW, x = x0 + q % kTileW;
    ref[q] = (y < h && x < w) ? (Word<W32>)__ldg(c1_n + (long long)y * w + x)
                              : (Word<W32>)0;
  }
  __syncthreads();

  const uint32_t inv = (uint32_t)invalid_cost * 0x01010101u;
  const int nd = groups * kGroup;
  uint8_t* const out_n = out + n * h * (long long)w * nd;
  for (int u = threadIdx.x; u < kTileH * kTileW * groups; u += kThreads) {
    const int unit = u >> 4;            // chunk * groups + group
    const int chunk = unit / groups;
    const int g = unit - chunk * groups;
    const int pix = chunk * 16 + (u & 15);  // pixel of the tile
    const int ty_ = pix / kTileW, tx_ = pix % kTileW;
    const int y = y0 + ty_, x = x0 + tx_;
    if (y >= h || x >= w) continue;
    const int l0 = g * kGroup;
    uint32_t v[kGroup / 4] = {inv, inv, inv, inv};
    if (l0 < nl) {
      const Word<W32> a = ref[pix];
      int dv = l0 / e;
      int du = l0 - dv * e;
      int off = (ty_ + dv) * sw + tx_ + du;  // staged word of label l0
      v[0] = v[1] = v[2] = v[3] = 0;
      // bytes never overlap, so | packs them
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        uint32_t c = (uint32_t)invalid_cost;
        if (l0 + k < nl) {
          const Word<W32> s = stage[off];
          if (!(s & mark)) c = (uint32_t)hamming<W32>(a, s);
        }
        v[k / 4] |= c << (8 * (k % 4));
        ++off;
        if (++du == e) {
          du = 0;
          off += sw - e;
        }
      }
    }
    *reinterpret_cast<uint4*>(out_n + ((long long)y * w + x) * nd + l0) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <bool W32>
int launch(const void* cen1, const void* cen2, const void* base_u,
           const void* base_v, void* out, long long tiles, int h, int w,
           int h2, int hb, int radius, int nl, int groups, int invalid_cost,
           int y_offset, int tiles_y, int tiles_x, cudaStream_t st) {
  flow_cost_kernel<W32><<<(unsigned)tiles, kThreads, 0, st>>>(
      (const long long*)cen1, (const long long*)cen2, (const int*)base_u,
      (const int*)base_v, (uint8_t*)out, h, w, h2, hb, radius, nl, groups,
      invalid_cost, y_offset, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

// cen1 (N, H, W) int64; cen2 (N, H2, W) int64; base_u, base_v (N, Hb, W)
// int32 with Hb = H (halo 0) or H + 2 radius (a row tile's halo rows);
// out (N, H, W, nl_pad) u8, 16-byte aligned; radius in 0..kMaxRadius;
// nl_pad a multiple of 16, (2 radius + 1)^2 <= nl_pad <= 256.  census_bits:
// the width of the census window's words (every word below
// 2^census_bits); up to kWord32Bits the kernel stages 32-bit words.
extern "C" int fsgm_flow_cost(const void* cen1, const void* cen2,
                              const void* base_u, const void* base_v,
                              void* out, int n, int h, int w, int h2, int hb,
                              int radius, int invalid_cost, int nl_pad,
                              int y_offset, int census_bits, void* stream) {
  const int e = 2 * radius + 1;
  if (n < 1 || h < 1 || w < 1 || h2 < 1 || radius < 0 ||
      radius > kMaxRadius || (hb != h && hb != h + 2 * radius) ||
      nl_pad % kGroup != 0 || nl_pad < e * e ||
      nl_pad > kGroup * kMaxGroups || invalid_cost < 0 || invalid_cost > 255 ||
      census_bits < 1 || census_bits > 64 || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const long long tiles = (long long)n * tiles_y * tiles_x;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int groups = nl_pad / kGroup;
  if (census_bits <= kWord32Bits)
    return launch<true>(cen1, cen2, base_u, base_v, out, tiles, h, w, h2, hb,
                        radius, e * e, groups, invalid_cost, y_offset,
                        tiles_y, tiles_x, st);
  return launch<false>(cen1, cen2, base_u, base_v, out, tiles, h, w, h2, hb,
                       radius, e * e, groups, invalid_cost, y_offset, tiles_y,
                       tiles_x, st);
}
