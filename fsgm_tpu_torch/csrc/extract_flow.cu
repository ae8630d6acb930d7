// K4 extract_flow: the flow WTA and the six subpixel neighbour values in
// one pass over S.
//
// Replaces the TPU kernel fsgm_tpu/ops/pallas/extract_tr.py::
// extract_flow_major (kernel body _make_flow_extract_kernel).  Per pixel of
// the label-minor (H, W, D) S whose first nl = e * e slots are the flow's
// (e x e) label grid, l = iv * e + iu:
//
//   l*         = argmin_{l < nl} S, smallest l on ties, as min of (S << 8) | l
//   iuc, ivc   = iu, iv of l* clipped to [1, e - 2]
//   u triple   = S[iv e + iuc - 1], S[iv e + iuc], S[iv e + iuc + 1]
//   v triple   = S[(ivc - 1) e + iu], S[ivc e + iu], S[(ivc + 1) e + iu]
//
// which is models/flow.py::wta_flow / subpixel_flow_major's selection bit
// for bit (all six labels lie in [0, nl) for e >= 3).  The parabola, the
// base + offset and the median stay in PyTorch, as they stayed in XLA.
// Requires nl <= 255 and S < 2^23 so the packed key is exact.
//
// Bound: device-memory bytes (S is read once, 81 labels of 2 bytes a pixel
// at the KITTI flow level 0; seven int32 planes written).  The 32-byte
// sectors that hold labels 0..80 of a 192-byte row are all six, so the
// sectors force the whole row to be read.  Design:
//   * A warp owns a group of kGroup = 32 consecutive pixels, whose S is one
//     contiguous run of 32 * D values.  It copies the run's 16-byte chunks
//     into a slot of its own ring in shared memory with cp.async: chunk i
//     of the run goes to lane i % 32, so every copy instruction of the warp
//     moves 512 contiguous bytes.  Chunks that hold only pad labels (past
//     nl) are not copied.  The ring holds kDepth = 2 slots: the warp keeps
//     its next group in flight while it reduces one.  A block holds kWarps
//     = 2 warps, so that D = 256 int32 S (2 x 2 slots of 33,280 bytes)
//     fits a block's shared memory (on an H100, rings of 2-4 slots and
//     blocks of 1-8 warps timed alike at the KITTI flow level 0).
//   * In the slot, pixel q's row starts at q * (row bytes + 16): an odd
//     count of 16-byte chunks, so the eight lanes of a quarter-warp that
//     read chunk c of eight consecutive pixels hit all 32 banks once.
//   * Lane t reduces pixel t alone: for each chunk c (the same c in every
//     lane, so the pad mask of the last chunk is a uniform branch) one
//     16-byte shared load, the chunk's minimum (__vmins2 on int16 pairs),
//     and the first chunk with the smallest minimum.  Only that chunk is
//     read again to find the first label with that value, so the pair
//     (value, label) is the packed key's minimum, smallest l on ties.
//   * The six neighbour values come from the same staged row.  Lane t
//     stores pixel t's seven values, so each output plane is written as
//     one 128-byte line a warp; the ragged last group is masked.
//   * The grid is the blocks that fit the card at once (csrc/persistent.cuh,
//     cached per instantiation); warps walk the groups with a stride of
//     all the grid's warps, and the ring runs on from one group to the
//     next.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "persistent.cuh"

namespace {

using fsgm_cp::cp_async16;
using fsgm_cp::cp_commit;
using fsgm_cp::cp_wait;

constexpr int kGroup = 32;          // pixels of a warp's group, one a lane
constexpr int kChunk = 16;          // bytes of one copy and one shared load;
                                    // ops/kernels/extract.py K4_CHUNK
constexpr int kRowPad = 16;         // bytes after each staged pixel row
constexpr int kDepth = 2;           // slots of a warp's ring
constexpr int kWarps = 2;           // warps of a block
constexpr int kBlockSmem = 232448;  // an H100 block's shared memory, at most

// bytes of one ring slot: a group of pixels of pb bytes each
__host__ __device__ constexpr int slot_bytes(int pb) {
  return kGroup * (pb + kRowPad);
}

// the smallest value of a 16-byte chunk of int16 or int32 labels
__device__ __forceinline__ int chunk_min(uint4 v, int16_t) {
  const unsigned m = __vmins2(__vmins2(v.x, v.y), __vmins2(v.z, v.w));
  return min((int)(int16_t)(m & 0xffffu), (int)m >> 16);
}
__device__ __forceinline__ int chunk_min(uint4 v, int32_t) {
  return min(min((int)v.x, (int)v.y), min((int)v.z, (int)v.w));
}
// word k of a chunk with its labels from `keep` on replaced by the type's
// largest value, which no real label's value exceeds: pads then never win
__device__ __forceinline__ unsigned mask_word(unsigned w, int k, int keep,
                                              int16_t) {
  return 2 * k >= keep       ? 0x7fff7fffu
         : 2 * k + 1 >= keep ? (w & 0xffffu) | 0x7fff0000u
                             : w;
}
__device__ __forceinline__ unsigned mask_word(unsigned w, int k, int keep,
                                              int32_t) {
  return k >= keep ? (unsigned)INT_MAX : w;
}
template <typename ST>
__device__ __forceinline__ uint4 mask_pads(uint4 v, int keep) {
  return make_uint4(mask_word(v.x, 0, keep, ST()),
                    mask_word(v.y, 1, keep, ST()),
                    mask_word(v.z, 2, keep, ST()),
                    mask_word(v.w, 3, keep, ST()));
}

template <int K, typename ST>
__global__ void __launch_bounds__(32 * kWarps)
extract_flow_kernel(const ST* __restrict__ s, int* __restrict__ l_out,
                    int* __restrict__ um, int* __restrict__ u0,
                    int* __restrict__ up, int* __restrict__ vm,
                    int* __restrict__ v0, int* __restrict__ vp,
                    long long npix, int nl, int ext, int with_sub) {
  constexpr int ND = 32 * K;
  constexpr int PB = ND * (int)sizeof(ST);  // bytes of one pixel's S
  constexpr int PS = PB + kRowPad;          // its stride in a slot
  constexpr int CPP = PB / kChunk;          // chunks of a pixel
  constexpr int VPC = kChunk / (int)sizeof(ST);  // labels of a chunk
  constexpr int SLOT = slot_bytes(PB);
  static_assert((PS / kChunk) % 2 == 1, "a staged row is an odd count of "
                "chunks, so 16-byte shared reads are conflict-free");
  static_assert(kWarps * kDepth * SLOT <= kBlockSmem, "a block's rings fit");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* const ring = smem + warp * kDepth * SLOT;
  const int real = (nl + VPC - 1) / VPC;  // chunks that hold a real label
  const long long groups = (npix + kGroup - 1) / kGroup;
  const long long stride = (long long)gridDim.x * kWarps;
  long long f_group = (long long)blockIdx.x * kWarps + warp;
  int f_slot = 0, slot = 0;
  auto fetch = [&]() {
    if (f_group < groups) {
      const long long p0 = f_group * kGroup;
      const int np = (int)min((long long)kGroup, npix - p0);
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(s + p0 * ND);
      unsigned char* dst = ring + f_slot * SLOT;
#pragma unroll
      for (int j = 0; j < CPP; ++j) {
        const int i = lane + 32 * j;  // chunk i of the group's run
        const int q = i / CPP, c = i - q * CPP;
        if (q < np && c < real)
          cp_async16(dst + q * PS + c * kChunk, src + (long long)i * kChunk);
      }
      f_group += stride;
    }
    cp_commit();
    if (++f_slot == kDepth) f_slot = 0;
  };
#pragma unroll 1
  for (int i = 0; i < kDepth - 1; ++i) fetch();

  const int tail = nl - (real - 1) * VPC;  // real labels of the last chunk
#pragma unroll 1
  for (long long g = (long long)blockIdx.x * kWarps + warp; g < groups;
       g += stride) {
    fetch();
    cp_wait<kDepth - 1>();
    __syncwarp();
    const unsigned char* row = ring + slot * SLOT + lane * PS;
    int best = INT_MAX, best_c = 0;
#pragma unroll 4
    for (int c = 0; c < real; ++c) {
      uint4 v = *reinterpret_cast<const uint4*>(row + c * kChunk);
      if (c == real - 1 && tail < VPC) v = mask_pads<ST>(v, tail);
      const int m = chunk_min(v, ST());
      if (m < best) {
        best = m;
        best_c = c;
      }
    }
    const ST* sv = reinterpret_cast<const ST*>(row);
    int first = VPC - 1;
#pragma unroll
    for (int k = VPC - 2; k >= 0; --k)
      if ((int)sv[best_c * VPC + k] == best) first = k;
    const int lab = best_c * VPC + first;
    const long long pix = g * kGroup + lane;
    if (pix < npix) {
      l_out[pix] = lab;
      if (with_sub) {
        const int iv = lab / ext;
        const int iu = lab - iv * ext;
        const int bu = iv * ext + min(max(iu, 1), ext - 2);
        const int bv = min(max(iv, 1), ext - 2) * ext + iu;
        um[pix] = sv[bu - 1];
        u0[pix] = sv[bu];
        up[pix] = sv[bu + 1];
        vm[pix] = sv[bv - ext];
        v0[pix] = sv[bv];
        vp[pix] = sv[bv + ext];
      }
    }
    __syncwarp();
    if (++slot == kDepth) slot = 0;
  }
}

template <int K, typename ST>
int launch(const void* s, void* const* outs, long long npix, int nl, int ext,
           int with_sub, cudaStream_t st) {
  constexpr size_t shmem =
      (size_t)kWarps * kDepth * slot_bytes(32 * K * (int)sizeof(ST));
  static std::atomic<long long> cache{0};
  if ((uintptr_t)s & 15) return (int)cudaErrorInvalidValue;
  auto kernel = extract_flow_kernel<K, ST>;
  long long blocks = 0;
  cudaError_t e = fsgm_persistent::resident_blocks(kernel, 32 * kWarps, shmem,
                                                   cache, &blocks);
  if (e != cudaSuccess) return (int)e;
  const long long groups = (npix + kGroup - 1) / kGroup;
  const long long want = (groups + kWarps - 1) / kWarps;
  kernel<<<(unsigned)(want < blocks ? want : blocks), 32 * kWarps, shmem,
           st>>>((const ST*)s, (int*)outs[0], (int*)outs[1], (int*)outs[2],
                 (int*)outs[3], (int*)outs[4], (int*)outs[5], (int*)outs[6],
                 npix, nl, ext, with_sub);
  return (int)cudaGetLastError();
}

template <typename ST>
int dispatch(int k, const void* s, void* const* outs, long long npix, int nl,
             int ext, int with_sub, cudaStream_t st) {
  switch (k) {
#define FSGM_CASE(KK) \
  case KK: return launch<KK, ST>(s, outs, npix, nl, ext, with_sub, st);
    FSGM_CASE(1) FSGM_CASE(2) FSGM_CASE(3) FSGM_CASE(4)
    FSGM_CASE(5) FSGM_CASE(6) FSGM_CASE(7) FSGM_CASE(8)
#undef FSGM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// s (H, W, D) int16 (s_int32 = 0) or int32, 16-byte aligned, D a multiple
// of 32 up to 256, nl = ext * ext <= min(D, 255), ext >= 3; seven (H, W)
// int32 outputs (l, u_m, u_0, u_p, v_m, v_0, v_p), the last six written
// only with with_sub.
extern "C" int fsgm_extract_flow(const void* s, int s_int32, void* l, void* um,
                                 void* u0, void* up, void* vm, void* v0,
                                 void* vp, int h, int w, int nd, int nl,
                                 int ext, int with_sub, void* stream) {
  if (nd % 32 != 0 || nd > 256 || ext < 3 || nl != ext * ext || nl > nd ||
      nl > 255 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  void* outs[7] = {l, um, u0, up, vm, v0, vp};
  const long long npix = (long long)h * w;
  cudaStream_t st = (cudaStream_t)stream;
  return s_int32
             ? dispatch<int32_t>(nd / 32, s, outs, npix, nl, ext, with_sub, st)
             : dispatch<int16_t>(nd / 32, s, outs, npix, nl, ext, with_sub, st);
}
