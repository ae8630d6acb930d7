// K3 extract_stereo: one pass over S for WTA, the subpixel neighbourhood,
// the right-view WTA and the LR validity plane.
//
// Replaces the TPU kernel fsgm_tpu/ops/pallas/extract_tr.py::
// extract_stereo_major (kernel body _make_extract_kernel, helpers _rwta_row,
// _round_disp, _lr_valid_row) as the main path calls it (with_sub,
// with_rwta, with_lr; without with_rwta for lr_mode="reagg", where the
// right view comes from its own S).  Per pixel of the label-minor
// (B, H, W, D) S:
//
//   d*          = argmin_d S, smallest d on ties, as min of (S << 8) | d
//   s_m,s_0,s_p = S[d*-1], S[d*], S[d*+1]; BIG = 1 << 24 out of range
//   rho(y, x)   = argmin_d S(y, x+d, d), s_invalid where x+d >= W, ties to
//                 the smallest d (the S-volume trick right-view WTA)
//   valid       = x >= dr and |dr - rho(y, x - dr)| <= max_diff, with
//                 dr = rint(subpixel d*) in IEEE f32, round half to even
//
// Bound: device-memory bytes (S is read once: 2*D bytes per pixel, 119 MB a
// KITTI frame in int16).  Design:
//   * A block of kWarps = 16 warps takes one image row of one frame at a
//     time (row = b * H + y, 64-bit offsets; every read of the row stays
//     inside it), and walks rows blockIdx.x, + gridDim.x, ...  The grid is
//     the blocks that fit the card at once (csrc/persistent.cuh), at most
//     the rows: a KITTI frame's 375 rows are one wave at three blocks an SM.
//   * The row is cut into chunks of P consecutive pixels (about 1 KB of S)
//     and warp `warp` takes chunks warp, warp + 16, ...  Their S comes
//     through the warp's own ring of ring_depth() >= 2 chunk slots in
//     shared memory (cp.async in 16-byte pieces, one slot fewer chunks
//     ahead, the block's ring at most kRingBytes); the ring runs on into
//     the block's next row, so loads stay in flight across the row's end.
//   * Lane l reads labels l, l + 32, ... of a staged pixel: consecutive
//     lanes on consecutive halves or words, no bank conflict.  The packed
//     WTA key (S << 8) | d is one full-warp __reduce_min_sync.  The right
//     view needs the diagonal S(y, x+d, d), which crosses D pixels; instead
//     of a second, uncoalesced read, every value S(y, x, d) is scattered
//     into rho[x - d] with a shared-memory atomicMin on the same key: at
//     each k the 32 lanes hit 32 consecutive words, no bank conflict, and
//     the row's rho builds in shared memory during the one read.  A pixel
//     whose every label lands inside the row skips the per-label test.
//     S[d*-1] and S[d*+1] are read back from the staged pixel by the lanes
//     that write them: lanes 0-3 store d*, s_0, s_m, s_p with one store
//     into planes of odd stride (no bank conflict).
//   * At the row's end the block writes every output plane coalesced,
//     valid beside them (dr from the planes, rho from the scatter).  The
//     division is IEEE (no fast-math), so dr matches the f32 host formula
//     bit for bit.
//   Without with_rwta the block skips the scatter and rho and writes no
//   validity plane.
//
// Windows (column tiling, fsgm_tpu_torch/parallel/tiled.py): S may span a
// window whose column x sits at the global column gx0 + x of an image
// w_global wide (gx0 < 0 or gx0 + W > w_global: columns outside the image).
// A right-view match at x + d then also needs gx0 + x + d < w_global, so a
// column past the global edge scatters nothing and rho starts at the first
// d that leaves either edge; the LR lookup x - dr must lie at or right of
// the global column 0 (x - dr >= -gx0), as the JAX rule d_R = -2^20 outside
// the image gives.  gx0 = 0, w_global = W is the untiled frame.  All the
// windows of one launch share gx0.
//
// Right-view pass (fsgm_wta_right; replaces the TPU kernel fsgm_tpu/ops/
// pallas/extract_tr.py::wta_right_major, which the JAX package's "minor"
// extraction runs, and the strided-roll shear it and tools/
// strideroll_probe.py build on): the same kernel with the scatter alone
// gives rho(y, x), written as a (B, H, W) int32 plane; no left-view output.
// Untiled frames only.

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

constexpr int kBig = 1 << 24;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlotBytes = 1024;    // a ring slot: P pixels of S, at most
constexpr int kRingBytes = 32768;   // the block's ring, at most
constexpr int kSmemBytes = 232448;  // an H100 block's shared memory, at most
// shared-memory int32 planes per column: rho, d*, s_0, s_m, s_p, each of
// stride W | 1 (at most W + 1); ops/kernels/extract.py's MAX_WIDTH is
// (kSmemBytes - kRingBytes) / (4 * kPlanes) - 1 and MAX_WIDTH_RIGHT
// (kSmemBytes - kRingBytes) / 4 - 1
constexpr int kPlanes = 5;

// what a launch computes: the left view alone, with the right view and the
// LR plane, or the right view alone (fsgm_wta_right)
enum Mode { kLeft = 0, kLeftLR = 1, kRight = 2 };

// pixels of one ring slot, and slots of one warp's ring, for pixels of pb
// bytes (32 K labels of S elements of sb bytes)
__host__ __device__ constexpr int slot_pixels(int pb) {
  return kSlotBytes / pb > 1 ? kSlotBytes / pb : 1;
}
__host__ __device__ constexpr int ring_depth(int pb) {
  return kRingBytes / (kWarps * slot_pixels(pb) * pb);
}

__device__ __forceinline__ int round_disp(int d, int sm, int s0, int sp, int nd,
                                          int with_sub) {
  if (!with_sub) return d;
  const float fm = (float)sm, f0 = (float)s0, fp = (float)sp;
  const float denom = __fadd_rn(__fsub_rn(fm, __fmul_rn(2.0f, f0)), fp);
  const bool ok = d > 0 && d < nd - 1 && denom > 0.0f;
  float off = 0.0f;
  if (ok) off = __fdiv_rn(__fsub_rn(fm, fp), fmaxf(__fmul_rn(2.0f, denom), 1e-12f));
  off = fminf(fmaxf(off, -0.5f), 0.5f);
  return (int)rintf(__fadd_rn((float)d, off));
}

template <int K, typename ST, int MODE>
__global__ void __launch_bounds__(kThreads, 3)
extract_kernel(const ST* __restrict__ s, int* __restrict__ d_out,
               int* __restrict__ sm_out, int* __restrict__ s0_out,
               int* __restrict__ sp_out, int* __restrict__ valid_out,
               long long rows, int w, int s_invalid, int max_diff,
               int with_sub, int gx0, int w_global) {
  constexpr int ND = 32 * K;
  constexpr int PB = ND * (int)sizeof(ST);  // bytes of one staged pixel
  constexpr int P = slot_pixels(PB);
  constexpr int SLOT = P * PB;
  constexpr int DEPTH = ring_depth(PB);
  static_assert(DEPTH >= 2 && SLOT % 16 == 0, "ring shape");
  constexpr bool LEFT = MODE != kRight;
  constexpr bool SCATTER = MODE != kLeft;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ws = w | 1;  // plane stride, odd: lanes 0-3 hit four banks
  unsigned char* const ring = smem + warp * DEPTH * SLOT;
  int* const planes = reinterpret_cast<int*>(smem + kWarps * DEPTH * SLOT);
  int* const rho = planes;                       // SCATTER: packed minimum
  int* const left = planes + (SCATTER ? ws : 0);  // LEFT: d*, s_0, s_m, s_p
  // the first window column at or past the global right edge
  const int x_end = min(w, w_global - gx0);
  const int x_lo = max(0, -gx0);  // the first column inside the image
  // this warp's chunks of a row, and the ring's fetch cursor: the next
  // chunk's first column and S bytes
  const int chunks = (w + P - 1) / P;
  const int n_w = warp < chunks ? (chunks - 1 - warp) / kWarps + 1 : 0;
  long long f_row = blockIdx.x;
  int f_x = warp * P, f_slot = 0, slot = 0;
  const unsigned char* f_src =
      reinterpret_cast<const unsigned char*>(s + (f_row * w + f_x) * ND);
  auto fetch = [&]() {
    if (n_w > 0 && f_row < rows) {
      const int pieces = min(P, w - f_x) * (PB / 16);
      unsigned char* dst = ring + f_slot * SLOT;
#pragma unroll
      for (int r = 0; r < (SLOT / 16 + 31) / 32; ++r) {
        const int c = lane + 32 * r;
        if (c < pieces) cp_async16(dst + 16 * c, f_src + 16 * c);
      }
      f_x += kWarps * P;
      f_src += kWarps * SLOT;
      if (f_x >= w) {  // on to the block's next row
        f_row += gridDim.x;
        f_x = warp * P;
        f_src = reinterpret_cast<const unsigned char*>(
            s + (f_row * w + f_x) * ND);
      }
    }
    cp_commit();
    if (++f_slot == DEPTH) f_slot = 0;
  };
  // lanes 0-3 store d*, s_0, s_m = S[d*-1], s_p = S[d*+1] of each pixel
  int* const mine = left + lane * ws;
  const int nb = lane == 2 ? -1 : 1;  // lanes 2, 3: the neighbour's offset
#pragma unroll 1
  for (int i = 0; i < DEPTH - 1; ++i) fetch();

  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    if (SCATTER) {
      // rho[x] before the scatter: the packed key of the first d at which
      // x + d leaves the image (x + d >= x_end), or INT_MAX if no d < ND does
      for (int x = threadIdx.x; x < w; x += kThreads) {
        const int first_out = max(x_end - x, 0);  // smallest invalid d
        rho[x] = first_out < ND ? ((s_invalid << 8) | first_out) : INT_MAX;
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int i = 0; i < n_w; ++i) {
      fetch();
      cp_wait<DEPTH - 1>();
      __syncwarp();
      const int x0 = (warp + kWarps * i) * P;
      const int np = min(P, w - x0);
#pragma unroll 1
      for (int q = 0; q < np; ++q) {
        const ST* sv = reinterpret_cast<const ST*>(ring + slot * SLOT + q * PB);
        const int x = x0 + q;
        int pk = INT_MAX;
        if (SCATTER && x >= ND - 1 && x < x_end) {  // every label inside
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int key = ((int)sv[lane + 32 * k] << 8) | (lane + 32 * k);
            if (LEFT) pk = min(pk, key);
            atomicMin(&rho[x - lane - 32 * k], key);
          }
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int d = lane + 32 * k;
            const int key = ((int)sv[d] << 8) | d;
            if (LEFT) pk = min(pk, key);
            if (SCATTER && x >= d && x < x_end) atomicMin(&rho[x - d], key);
          }
        }
        if (LEFT) {
          pk = __reduce_min_sync(kFull, pk);
          const int dstar = pk & 255;
          if (lane < 4) {
            int v = lane == 0 ? dstar : pk >> 8;
            const unsigned dn = dstar + nb;
            if (lane >= 2) v = dn < (unsigned)ND ? (int)sv[dn] : kBig;
            mine[x] = v;
          }
        }
      }
      __syncwarp();
      if (++slot == DEPTH) slot = 0;
    }
    __syncthreads();
    const long long o = row * w;
    for (int x = threadIdx.x; x < w; x += kThreads) {
      if (!LEFT) {
        valid_out[o + x] = rho[x] & 255;  // fsgm_wta_right's rho plane
        continue;
      }
      const int dstar = left[x], s0 = left[ws + x];
      const int smv = left[2 * ws + x], spv = left[3 * ws + x];
      d_out[o + x] = dstar;
      sm_out[o + x] = smv;
      s0_out[o + x] = s0;
      sp_out[o + x] = spv;
      if (SCATTER) {
        const int dr = round_disp(dstar, smv, s0, spv, ND, with_sub);
        int ok = 0;
        if (dr >= 0 && dr < ND && x - dr >= x_lo) {
          const int diff = dr - (rho[x - dr] & 255);
          ok = (diff < 0 ? -diff : diff) <= max_diff;
        }
        valid_out[o + x] = ok;
      }
    }
    __syncthreads();
  }
}

// shared-memory bytes of one block of MODE for a row of w columns
template <int K, typename ST, int MODE>
size_t smem_bytes(int w) {
  constexpr int PB = 32 * K * (int)sizeof(ST);
  const int planes = MODE == kLeftLR ? kPlanes : MODE == kLeft ? 4 : 1;
  return (size_t)kWarps * ring_depth(PB) * slot_pixels(PB) * PB +
         sizeof(int) * (size_t)planes * (w + 1);
}

template <int K, typename ST, int MODE>
int launch(const void* s, void* d, void* sm, void* s0, void* sp, void* valid,
           long long rows, int w, int s_invalid, int max_diff, int with_sub,
           int gx0, int w_global, cudaStream_t st) {
  static std::atomic<long long> cache{0};
  const size_t shmem = smem_bytes<K, ST, MODE>(w);
  if (shmem > (size_t)kSmemBytes || ((uintptr_t)s & 15))
    return (int)cudaErrorInvalidValue;
  auto kernel = extract_kernel<K, ST, MODE>;
  long long blocks = 0;
  cudaError_t e = fsgm_persistent::resident_blocks(kernel, kThreads, shmem,
                                                   cache, &blocks);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(rows < blocks ? rows : blocks), kThreads, shmem, st>>>(
      (const ST*)s, (int*)d, (int*)sm, (int*)s0, (int*)sp, (int*)valid, rows,
      w, s_invalid, max_diff, with_sub, gx0, w_global);
  return (int)cudaGetLastError();
}

template <typename ST, int MODE>
int dispatch(int k, const void* s, void* d, void* sm, void* s0, void* sp,
             void* valid, long long rows, int w, int s_invalid, int max_diff,
             int with_sub, int gx0, int w_global, cudaStream_t st) {
  switch (k) {
#define FSGM_CASE(KK)                                                      \
  case KK:                                                                 \
    return launch<KK, ST, MODE>(s, d, sm, s0, sp, valid, rows, w,          \
                                s_invalid, max_diff, with_sub, gx0,        \
                                w_global, st);
    FSGM_CASE(1) FSGM_CASE(2) FSGM_CASE(3) FSGM_CASE(4)
    FSGM_CASE(5) FSGM_CASE(6) FSGM_CASE(7) FSGM_CASE(8)
#undef FSGM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int MODE>
int dispatch_type(int s_int32, int nd, const void* s, void* d, void* sm,
                  void* s0, void* sp, void* valid, int b, int h, int w,
                  int s_invalid, int max_diff, int with_sub, int gx0,
                  int w_global, void* stream) {
  const long long rows = (long long)b * h;
  if (nd % 32 != 0 || rows < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return s_int32 ? dispatch<int32_t, MODE>(nd / 32, s, d, sm, s0, sp, valid,
                                           rows, w, s_invalid, max_diff,
                                           with_sub, gx0, w_global, st)
                 : dispatch<int16_t, MODE>(nd / 32, s, d, sm, s0, sp, valid,
                                           rows, w, s_invalid, max_diff,
                                           with_sub, gx0, w_global, st);
}

}  // namespace

extern "C" int fsgm_extract_stereo(const void* s, int s_int32, void* d,
                                   void* sm, void* s0, void* sp, void* valid,
                                   int b, int h, int w, int nd, int s_invalid,
                                   int max_diff, int with_sub, int with_rwta,
                                   int gx0, int w_global, void* stream) {
  return with_rwta
             ? dispatch_type<kLeftLR>(s_int32, nd, s, d, sm, s0, sp, valid, b,
                                      h, w, s_invalid, max_diff, with_sub,
                                      gx0, w_global, stream)
             : dispatch_type<kLeft>(s_int32, nd, s, d, sm, s0, sp, valid, b,
                                    h, w, s_invalid, max_diff, with_sub, gx0,
                                    w_global, stream);
}

// s (B, H, W, D) int16 (s_int32 = 0) or int32, 16-byte aligned, D a
// multiple of 32 up to 256; rho (B, H, W) int32: argmin_d S(y, x + d, d),
// s_invalid where x + d >= W, smallest d on ties.
extern "C" int fsgm_wta_right(const void* s, int s_int32, void* rho, int b,
                              int h, int w, int nd, int s_invalid,
                              void* stream) {
  return dispatch_type<kRight>(s_int32, nd, s, nullptr, nullptr, nullptr,
                               nullptr, rho, b, h, w, s_invalid, 0, 0, 0, w,
                               stream);
}
