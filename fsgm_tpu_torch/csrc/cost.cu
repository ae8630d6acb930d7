// K1 census_cost: census-Hamming stereo matching cost on Hopper (sm_90a).
//
// Replaces the TPU kernels fsgm_tpu/ops/pallas/cost_tr.py::cost_volume_wlh
// (column-scan layout), ::cost_volume_hlw (row-scan layout) and
// ::cost_volume_wlh_batch (the column-scan layout of B frames lane-folded
// side by side).  Those exist because the TPU sweeps read the volume in two
// transposed layouts and fold a batch into the lane axis; the Hopper sweep
// (sgm_sweep.cu) reads one label-minor (B, H, W, D) u8 volume for every
// direction and every frame, so one kernel replaces all three:
//
//   left reference:  C[b, y, x, d] = popcount(cenL[b, y, x] ^ cenR[b, y, x - d]),
//                    invalid_cost where x - d < 0
//   right reference: C[b, y, x, d] = popcount(cenR[b, y, x] ^ cenL[b, y, x + d]),
//                    invalid_cost where x + d >= W
//
// Census descriptors are one int64 word per pixel (windows up to 62 bits).
//
// Bound: the volume written (B*H*W*D bytes, 59.6 MB a KITTI frame at
// 375x1242x128) over device memory, and beside it the popcount pipe (16
// 32-bit POPC a clock per SM: one a byte for windows of up to 32 bits, two
// for wider ones).  Design:
//   * Work items are tiles of kTile pixels of one image row of one frame
//     (item = (b * H + y) * tiles + tile, 64-bit row offsets).  The grid is
//     the blocks that fit the card at once (csrc/persistent.cuh), each
//     walking items blockIdx.x, + gridDim.x, ...  A block stages an item's
//     reference words and the matched words it reaches (kTile + 32 * NP - 1
//     of them) in shared memory; their 16-byte loads for the next item are
//     issued into registers before the current item's compute, so census
//     latency hides behind it, and census is read from device memory about
//     once.  Where the caller's census window fits 32 bits (census_bits <=
//     32) only the low words are staged and one 32-bit popcount makes a
//     byte.
//   * A thread makes a label group: kGroup = 16 consecutive labels of one
//     pixel, packed into one 16-byte store.  A warp takes 16 consecutive
//     pixels and two neighbouring groups of each (lane = 2 * pixel +
//     group), so it stores 32 contiguous bytes a pixel, and at each label
//     its 32 lanes read 32 consecutive staged words: no bank conflict.
//   * D enters as NP = ceil(D / 32), a template: unit, pixel and group come
//     from the thread index with no division by a runtime value.  A group
//     past D is skipped; a group cut by D, or one whose address is not 16-
//     byte aligned (D not a multiple of 16), takes a masked byte-store tail
//     in the same kernel.  Labels that leave the row (x - d < 0, x + d >= W)
//     take invalid_cost; a thread whose 16 labels all stay inside skips the
//     per-label test.
// A match never leaves its own row, so it never reads the next row or the
// next frame.

#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "persistent.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;   // labels of one thread: one 16-byte store
constexpr int kTile = 256;   // pixels of one work item
// census_bits up to this take 32-bit words (ops/kernels/cost.py WORD32_BITS)
constexpr int kWord32Bits = 32;

template <bool W32>
using Word = typename std::conditional<W32, uint32_t, unsigned long long>::type;

template <bool W32>
__device__ __forceinline__ int hamming(Word<W32> a, Word<W32> b) {
  if constexpr (W32) return __popc(a ^ b);
  else return __popcll(a ^ b);
}

// The staging of one work item: its reference words (columns x0 ..
// x0 + kTile - 1) and matched words (kMatch columns from m_lo), read from
// device memory in pairs of words at even element indices (16-byte loads
// where the tensors are 16-byte aligned, else one word at a time) into
// registers, then stored into shared memory.  A pair is read where it
// holds a column of the row inside the range; columns outside the row are
// never staged (their labels take invalid_cost).
template <int NP, bool RIGHT, bool W32>
struct Stage {
  static constexpr int kHalo = 32 * NP - 1;  // matched words past the tile
  static constexpr int kMatch = kTile + kHalo;
  static constexpr int kRefPairs = kTile / 2 + 1;
  static constexpr int kPairs = kRefPairs + (kMatch + 1) / 2 + 1;
  static constexpr int kPerThread = (kPairs + kThreads - 1) / kThreads;

  const long long* ref_t;    // the reference view's census
  const long long* match_t;  // the matched view's census
  int w;
  bool vec;
  Word<W32> v[2 * kPerThread];

  // pair q of item (row, x0): its tensor, first column, range and source
  struct Pair {
    const long long* src;
    long long e;  // element index of the pair's first word
    int x, lo, a, b;
  };

  __device__ __forceinline__ Pair pair(int q, long long row, int x0) const {
    const bool ref = q < kRefPairs;
    Pair p;
    p.src = ref ? ref_t : match_t;
    p.lo = ref ? x0 : (RIGHT ? x0 : x0 - kHalo);
    p.a = max(p.lo, 0);
    p.b = min(p.lo + (ref ? kTile : kMatch), w);
    const long long base = row * w;
    p.e = ((base + p.a) & ~1LL) + 2 * (ref ? q : q - kRefPairs);
    p.x = (int)(p.e - base);
    return p;
  }

  __device__ __forceinline__ void load(long long row, int x0) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int q = threadIdx.x + k * kThreads;
      v[2 * k] = v[2 * k + 1] = 0;
      if (q >= kPairs) continue;
      const Pair p = pair(q, row, x0);
      if (p.x >= p.b || p.x + 1 < p.a) continue;
      if (vec) {
        const longlong2 t = __ldg(reinterpret_cast<const longlong2*>(
            p.src + p.e));
        v[2 * k] = (Word<W32>)t.x;
        v[2 * k + 1] = (Word<W32>)t.y;
      } else {
        if (p.x >= p.a) v[2 * k] = (Word<W32>)__ldg(p.src + p.e);
        if (p.x + 1 < p.b) v[2 * k + 1] = (Word<W32>)__ldg(p.src + p.e + 1);
      }
    }
  }

  __device__ __forceinline__ void store(Word<W32>* ref, Word<W32>* match,
                                        long long row, int x0) const {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int q = threadIdx.x + k * kThreads;
      if (q >= kPairs) continue;
      const Pair p = pair(q, row, x0);
      Word<W32>* dst = q < kRefPairs ? ref : match;
      if (p.x >= p.a && p.x < p.b) dst[p.x - p.lo] = v[2 * k];
      if (p.x + 1 >= p.a && p.x + 1 < p.b) dst[p.x + 1 - p.lo] = v[2 * k + 1];
    }
  }
};

template <int NP, bool RIGHT, bool W32>
__global__ void __launch_bounds__(kThreads)
census_cost_kernel(const long long* __restrict__ cen_l,
                   const long long* __restrict__ cen_r,
                   uint8_t* __restrict__ out, long long rows, int w, int tiles,
                   int nd, int invalid_cost, int vec) {
  using St = Stage<NP, RIGHT, W32>;
  constexpr int kHalo = St::kHalo;
  __shared__ Word<W32> ref[kTile];
  __shared__ Word<W32> match[St::kMatch];
  St st{RIGHT ? cen_r : cen_l, RIGHT ? cen_l : cen_r, w, vec != 0};
  const long long items = rows * tiles;
  // item blockIdx.x, then steps of gridDim.x = step_row rows + step_tile
  long long row = blockIdx.x / tiles;
  int tile = (int)(blockIdx.x - row * tiles);
  const long long step_row = gridDim.x / tiles;
  const int step_tile = (int)(gridDim.x - step_row * tiles);
  st.load(row, tile * kTile);

  const int lane = threadIdx.x & 31;
  const int h = lane & 1;        // which group of the unit's pair
  const int p = lane >> 1;       // pixel within the unit's 16
  const bool aligned = nd % kGroup == 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int x0 = tile * kTile;
    __syncthreads();  // the previous item's compute is done with the stage
    st.store(ref, match, row, x0);
    __syncthreads();
    uint8_t* const out_row = out + row * w * nd;
    tile += step_tile;
    row += step_row;
    if (tile >= tiles) {
      tile -= tiles;
      ++row;
    }
    if (item + gridDim.x < items) st.load(row, tile * kTile);  // next item

    // unit u = 16 pixels (chunk u / NP) x two groups (pair u % NP)
    for (int u = threadIdx.x >> 5; u < (kTile / 16) * NP; u += kWarps) {
      const int xt = 16 * (u / NP) + p;  // pixel within the tile
      const int x = x0 + xt;
      const int d0 = kGroup * (2 * (u % NP) + h);
      if (x >= w || d0 >= nd) continue;
      const Word<W32> r = ref[xt];
      // staged index of label d0 + i: j0 - i (left) or j0 + i (right)
      const int j0 = RIGHT ? xt + d0 : xt + kHalo - d0;
      const int last = d0 + kGroup - 1;
      const bool inside = last < nd && (RIGHT ? x + last < w : x >= last);
      // bytes never overlap, so + packs them; the masked loop is a branch
      // of its own, taken only at the row's edges and D's end
      uint32_t v[kGroup / 4] = {0, 0, 0, 0};
      if (inside) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          v[i / 4] += (uint32_t)hamming<W32>(
                          r, match[RIGHT ? j0 + i : j0 - i])
                      << (8 * (i % 4));
      } else {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int d = d0 + i;
          int c = hamming<W32>(r, match[RIGHT ? j0 + i : j0 - i]);
          if (RIGHT ? x + d >= w : x < d) c = invalid_cost;
          v[i / 4] += (uint32_t)c << (8 * (i % 4));
        }
      }
      uint8_t* const o = out_row + (long long)x * nd + d0;
      if (aligned) {
        *reinterpret_cast<uint4*>(o) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          if (d0 + i < nd) o[i] = (uint8_t)(v[i / 4] >> (8 * (i % 4)));
      }
    }
  }
}

template <int NP, bool RIGHT, bool W32>
int launch(const void* cen_l, const void* cen_r, void* out, long long rows,
           int w, int tiles, int nd, int invalid_cost, int vec,
           cudaStream_t st) {
  static std::atomic<long long> cache{0};
  auto kernel = census_cost_kernel<NP, RIGHT, W32>;
  long long blocks = 0;
  cudaError_t e = fsgm_persistent::resident_blocks(kernel, kThreads, 0, cache,
                                                   &blocks);
  if (e != cudaSuccess) return (int)e;
  const long long items = rows * tiles;
  kernel<<<(unsigned)(items < blocks ? items : blocks), kThreads, 0, st>>>(
      (const long long*)cen_l, (const long long*)cen_r, (uint8_t*)out, rows,
      w, tiles, nd, invalid_cost, vec);
  return (int)cudaGetLastError();
}

template <bool RIGHT, bool W32>
int dispatch(int np, const void* cen_l, const void* cen_r, void* out,
             long long rows, int w, int tiles, int nd, int invalid_cost,
             int vec, cudaStream_t st) {
  switch (np) {
#define FSGM_CASE(N)                                                       \
  case N:                                                                  \
    return launch<N, RIGHT, W32>(cen_l, cen_r, out, rows, w, tiles, nd,    \
                                 invalid_cost, vec, st);
    FSGM_CASE(1) FSGM_CASE(2) FSGM_CASE(3) FSGM_CASE(4)
    FSGM_CASE(5) FSGM_CASE(6) FSGM_CASE(7) FSGM_CASE(8)
#undef FSGM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// cen_l, cen_r (B, H, W) int64; out (B, H, W, D) u8, 16-byte aligned; D in
// 1..256.  census_bits: the width of the census window's words (every word
// below 2^census_bits); up to kWord32Bits the kernel stages and counts 32-bit
// words.
extern "C" int fsgm_census_cost(const void* cen_l, const void* cen_r,
                                void* out, int b, int h, int w, int nd,
                                int invalid_cost, int right_reference,
                                int census_bits, void* stream) {
  const long long rows = (long long)b * h;
  const long long tiles = ((long long)w + kTile - 1) / kTile;
  if (rows < 1 || tiles < 1 || tiles > 0x7fffffffLL || nd < 1 || nd > 256 ||
      census_bits < 1 || census_bits > 64 || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int vec = (((uintptr_t)cen_l | (uintptr_t)cen_r) & 15) == 0;
  const int np = (nd + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  const bool w32 = census_bits <= kWord32Bits;
  if (right_reference)
    return w32 ? dispatch<true, true>(np, cen_l, cen_r, out, rows, w,
                                      (int)tiles, nd, invalid_cost, vec, st)
               : dispatch<true, false>(np, cen_l, cen_r, out, rows, w,
                                       (int)tiles, nd, invalid_cost, vec, st);
  return w32 ? dispatch<false, true>(np, cen_l, cen_r, out, rows, w,
                                     (int)tiles, nd, invalid_cost, vec, st)
             : dispatch<false, false>(np, cen_l, cen_r, out, rows, w,
                                      (int)tiles, nd, invalid_cost, vec, st);
}
