// K7 census: the census transform on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves census to XLA
// (fsgm_tpu/ops/census.py::census_transform).  This kernel is the
// counterpart of that XLA stage: one launch writes the (N, H, W) int64
// descriptors of N frames, with the values of ops/census.py::
// census_transform_plain (and golden/sgm.py::census_transform).  For a
// window of ch x cw (both odd, ch cw - 1 <= 62 bits), ry = ch / 2,
// rx = cw / 2:
//
//   P(n, y, x)      = img[n, clamp(y, 0, H - 1), clamp(x, 0, W - 1)]
//                     (edge padding, each frame on its own);
//   out[n, y, x]    = OR over (oy, ox) in row-major window order, the
//                     centre (ry, rx) skipped, bit b counting the visited
//                     positions: (P(n, y + oy - ry, x + ox - rx) <
//                     P(n, y, x)) << b.
//
// Bound: device-memory bytes.  A KITTI frame's pair reads 2 x 465,750
// pixels (1 byte each as uint8) and writes 8 bytes a pixel: 8.4 MB, about
// 2.5 us at 3.35 TB/s; 8 of the 9 bytes a pixel are the int64 store.  The
// 5x5 window's 24 compares a pixel, two instructions each, take about as
// long to issue on 132 SMs, so the kernel stays near half the byte floor
// (35 us against 20 for 16 KITTI frames, one H100).  Design:
//   * A block owns a tile of kTileH x kTileW pixels of one frame (a flat
//     grid over N frames x tile rows x tile columns, 64-bit offsets), so
//     the small pyramid levels fill the card through the frame axis.
//   * Staging: the tile and its clamped halo, (kTileH + 2 ry) x (kTileW +
//     2 rx) pixels, are read once from device memory (uint8 or int32,
//     consecutive threads on consecutive columns) and kept as int32 in
//     shared memory; the clamp lives only here.  A thread issues kBatch
//     loads before it stores any, so their latencies overlap.
//   * Words: warp w takes tile rows w kRows ... w kRows + kRows - 1 and
//     lane l the two columns 2l, 2l + 1 of each, so each thread makes the
//     words of a 2 x kRows strip.  The main path's 5x5 window is a
//     template: the strip's kRows + 4 staged rows of 6 values are loaded
//     into registers once and every compare reads them (6 loads a pixel
//     instead of 24); any other window walks the staged region with
//     runtime loops.  Over uint8 pixels a compare is a subtraction: v - c
//     lies in [-255, 255] and is negative exactly where v < c, and then
//     its bits 8 ... 31 are all ones, so bit b + 8 of the difference is
//     window bit b: one subtract and one three-input LOP a bit (where the
//     compare took three instructions), the word shifted down by 8 at the
//     end (windows up to 24 bits, as the main path's).  Measured on the
//     16-frame KITTI call, one H100: the loop a staged element of the
//     first form took 80 us, the batched loads 70, the subtraction 35.
//   * Stores: a thread stores its two words of a row as one 16-byte store,
//     so a warp writes 512 contiguous bytes of a row; where the row's
//     first pixel leaves the pair off a 16-byte boundary (an odd W on odd
//     rows), or at a ragged right edge, as 8-byte stores.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // tile rows of one thread
constexpr int kTileH = kWarps * kRows;   // 32
constexpr int kTileW = 64;               // two columns a lane
constexpr int kMaxBits = 62;             // (ops/census.py MAX_BITS)
constexpr int kBatch = 8;                // staging loads in flight a thread

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ void store_pair(long long* __restrict__ out,
                                           long long row, int x, int w,
                                           long long a, long long b) {
  long long* const p = out + row + x;
  if (x + 1 < w && ((uintptr_t)p & 15) == 0) {
    *reinterpret_cast<longlong2*>(p) = make_longlong2(a, b);
  } else {
    p[0] = a;
    if (x + 1 < w) p[1] = b;
  }
}

// CH = CW = 0: any window, from (ch, cw); else the window CH x CW
// unrolled.
template <typename T, int CH, int CW>
__global__ void __launch_bounds__(kThreads)
census_kernel(const T* __restrict__ img, long long* __restrict__ out, int h,
              int w, int ch_, int cw_, int tiles_y, int tiles_x) {
  extern __shared__ int stage[];
  const int ch = CH ? CH : ch_, cw = CW ? CW : cw_;
  const int ry = ch / 2, rx = cw / 2;
  const int sh = kTileH + 2 * ry, sw = kTileW + 2 * rx;

  const long long tile = blockIdx.x;
  const int tx = (int)(tile % tiles_x);
  const long long rest = tile / tiles_x;
  const int ty = (int)(rest % tiles_y);
  const long long n = rest / tiles_y;
  const int y0 = ty * kTileH, x0 = tx * kTileW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // staged (i, j) is pixel (y0 - ry + i, x0 - rx + j), clamped
  const T* const img_n = img + n * h * (long long)w;
  const int total = sh * sw;
  for (int q0 = 0; q0 < total; q0 += kThreads * kBatch) {
    int val[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int q = q0 + k * kThreads + threadIdx.x;
      if (q < total) {
        const int i = q / sw, j = q - i * sw;
        val[k] = (int)__ldg(img_n + (long long)clampi(y0 - ry + i, h - 1) * w +
                            clampi(x0 - rx + j, w - 1));
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int q = q0 + k * kThreads + threadIdx.x;
      if (q < total) stage[q] = val[k];
    }
  }
  __syncthreads();

  const int r0 = warp * kRows;   // the strip's first tile row
  const int c0 = 2 * lane;       // its first tile column
  unsigned long long word[kRows][2];
  if constexpr (CH > 0) {
    // staged rows r0 ... r0 + kRows + CH - 2, columns c0 ... c0 + CW
    int v[kRows + CH - 1][CW + 1];
#pragma unroll
    for (int i = 0; i < kRows + CH - 1; ++i)
#pragma unroll
      for (int j = 0; j <= CW; ++j) v[i][j] = stage[(r0 + i) * sw + c0 + j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = v[r + CH / 2][p + CW / 2];
        constexpr bool kDiff = sizeof(T) == 1 && CH * CW - 1 <= 24;
        std::conditional_t<CH * CW - 1 <= 32, uint32_t, unsigned long long>
            acc = 0;
        int bit = 0;
#pragma unroll
        for (int oy = 0; oy < CH; ++oy)
#pragma unroll
          for (int ox = 0; ox < CW; ++ox) {
            if (oy == CH / 2 && ox == CW / 2) continue;
            if constexpr (kDiff)
              acc |= (uint32_t)(v[r + oy][p + ox] - c) & (1u << (bit + 8));
            else
              acc |= (decltype(acc))(v[r + oy][p + ox] < c) << bit;
            ++bit;
          }
        word[r][p] = kDiff ? acc >> 8 : acc;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int* const base = stage + (r0 + r) * sw + c0;
      const int ca = base[ry * sw + rx], cb = base[ry * sw + rx + 1];
      unsigned long long a = 0, b = 0;
      int bit = 0;
      for (int oy = 0; oy < ch; ++oy)
        for (int ox = 0; ox < cw; ++ox) {
          if (oy == ry && ox == rx) continue;
          a |= (unsigned long long)(base[oy * sw + ox] < ca) << bit;
          b |= (unsigned long long)(base[oy * sw + ox + 1] < cb) << bit;
          ++bit;
        }
      word[r][0] = a;
      word[r][1] = b;
    }
  }

  const int x = x0 + c0;
  if (x >= w) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + r0 + r;
    if (y < h)
      store_pair(out, (n * h + y) * (long long)w, x, w,
                 (long long)word[r][0], (long long)word[r][1]);
  }
}

template <typename T>
int launch(const void* img, void* out, long long tiles, int h, int w, int ch,
           int cw, int tiles_y, int tiles_x, cudaStream_t st) {
  const size_t smem = sizeof(int) * (size_t)(kTileH + ch - 1) *
                      (size_t)(kTileW + cw - 1);
  if (ch == 5 && cw == 5)
    census_kernel<T, 5, 5><<<(unsigned)tiles, kThreads, smem, st>>>(
        (const T*)img, (long long*)out, h, w, ch, cw, tiles_y, tiles_x);
  else
    census_kernel<T, 0, 0><<<(unsigned)tiles, kThreads, smem, st>>>(
        (const T*)img, (long long*)out, h, w, ch, cw, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

// img (N, H, W) contiguous, uint8 (in_bytes 1) or int32 (in_bytes 4); out
// (N, H, W) int64 contiguous; ch, cw odd with ch cw - 1 <= kMaxBits.  The
// staged region takes at most (kTileH + 62) x kTileW int32, 24,064 bytes
// of shared memory (a 63 x 1 window).
extern "C" int fsgm_census(const void* img, void* out, int n, int h, int w,
                           int ch, int cw, int in_bytes, void* stream) {
  if (n < 1 || h < 1 || w < 1 || ch < 1 || cw < 1 || ch % 2 == 0 ||
      cw % 2 == 0 || ch * cw - 1 > kMaxBits ||
      (in_bytes != 1 && in_bytes != 4) || ((uintptr_t)out & 7))
    return (int)cudaErrorInvalidValue;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const long long tiles = (long long)n * tiles_y * tiles_x;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bytes == 1)
    return launch<uint8_t>(img, out, tiles, h, w, ch, cw, tiles_y, tiles_x,
                           st);
  return launch<int>(img, out, tiles, h, w, ch, cw, tiles_y, tiles_x, st);
}
