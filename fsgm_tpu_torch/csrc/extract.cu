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
// KITTI frame in int16).  Design: one block per image row of one frame
// (blockIdx.x = b * H + y, B*H blocks in one launch; the row's 64-bit offset
// is blockIdx.x * W, and every read of the row stays inside it, so a frame
// never reads its neighbour).  A warp reads one
// pixel's D values coalesced (K = D/32 per lane) and reduces the packed WTA
// with __reduce_min_sync.  The right-view WTA needs the diagonal S(y, x+d, d),
// which crosses D pixels; instead of a second, uncoalesced diagonal read,
// every value S(y, x, d) read for the left view is scattered into rho[x - d]
// with a shared-memory atomicMin on the same packed key, so the whole row's
// rho builds in shared memory during the one read.  The validity pass then
// reads rho and dr from shared memory after one __syncthreads.  Without
// with_rwta the block skips the scatter, the validity pass and the shared
// memory, and writes no validity plane.  The division is IEEE (no
// fast-math), so dr matches the f32 host formula bit for bit.
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
// strideroll_probe.py build on): the same block-per-row read of S and the
// same shared-memory atomicMin scatter give rho(y, x) alone, written as a
// (B, H, W) int32 plane; no left-view output.  Untiled frames only.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 24;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

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

// rho[x] before the scatter: the packed key of the first d at which x + d
// leaves the image (x + d >= x_end), or INT_MAX if no d < ND does
__device__ __forceinline__ void init_rho(int* rho, int w, int x_end, int nd,
                                         int s_invalid) {
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    const int first_out = max(x_end - x, 0);  // smallest invalid d
    rho[x] = first_out < nd ? ((s_invalid << 8) | first_out) : INT_MAX;
  }
  __syncthreads();
}

template <int K, typename ST>
__global__ void __launch_bounds__(kThreads)
extract_kernel(const ST* __restrict__ s, int* __restrict__ d_out,
               int* __restrict__ sm_out, int* __restrict__ s0_out,
               int* __restrict__ sp_out, int* __restrict__ valid_out, int w,
               int s_invalid, int max_diff, int with_sub, int with_rwta,
               int gx0, int w_global) {
  constexpr int ND = 32 * K;
  extern __shared__ int smem[];
  int* rho = smem;       // packed (S << 8) | d right-view minimum, per x
  int* dr_sh = smem + w; // rint(subpixel d*), per x
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // the first window column at or past the global right edge
  const int x_end = min(w, w_global - gx0);
  const int x_lo = max(0, -gx0);  // the first column inside the image
  if (with_rwta) init_rho(rho, w, x_end, ND, s_invalid);
  const long long row = (long long)blockIdx.x * w;  // (b * H + y) * W
  for (int x = warp; x < w; x += nwarps) {
    const ST* sp = s + (row + x) * ND + lane * K;
    int v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = sp[k];
    int pk = INT_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      const int key = (v[k] << 8) | d;
      pk = min(pk, key);
      if (with_rwta && x >= d && x < x_end) atomicMin(&rho[x - d], key);
    }
    pk = __reduce_min_sync(kFull, pk);
    const int dstar = pk & 255;
    int smv = kBig, spv = kBig;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      if (d == dstar - 1) smv = min(smv, v[k]);
      if (d == dstar + 1) spv = min(spv, v[k]);
    }
    smv = __reduce_min_sync(kFull, smv);
    spv = __reduce_min_sync(kFull, spv);
    if (lane == 0) {
      const long long o = row + x;
      const int s0 = pk >> 8;
      d_out[o] = dstar;
      sm_out[o] = smv;
      s0_out[o] = s0;
      sp_out[o] = spv;
      if (with_rwta) dr_sh[x] = round_disp(dstar, smv, s0, spv, ND, with_sub);
    }
  }
  if (!with_rwta) return;  // uniform over the block
  __syncthreads();
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    const int dr = dr_sh[x];
    int ok = 0;
    if (dr >= 0 && dr < ND && x - dr >= x_lo) {
      const int diff = dr - (rho[x - dr] & 255);
      ok = (diff < 0 ? -diff : diff) <= max_diff;
    }
    valid_out[row + x] = ok;
  }
}

template <int K, typename ST>
__global__ void __launch_bounds__(kThreads)
wta_right_kernel(const ST* __restrict__ s, int* __restrict__ rho_out, int w,
                 int s_invalid) {
  constexpr int ND = 32 * K;
  extern __shared__ int rho[];  // packed (S << 8) | d minimum, per x
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  init_rho(rho, w, w, ND, s_invalid);
  const long long row = (long long)blockIdx.x * w;  // (b * H + y) * W
  for (int x = warp; x < w; x += nwarps) {
    const ST* sp = s + (row + x) * ND + lane * K;
    int v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = sp[k];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      if (x >= d) atomicMin(&rho[x - d], (v[k] << 8) | d);
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < w; x += blockDim.x)
    rho_out[row + x] = rho[x] & 255;
}

template <int K, typename ST>
int launch_wta_right(const void* s, void* rho, long long rows, int w,
                     int s_invalid, cudaStream_t st) {
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t shmem = sizeof(int) * (size_t)w;
  auto kernel = wta_right_kernel<K, ST>;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)rows, kThreads, shmem, st>>>((const ST*)s, (int*)rho, w,
                                                  s_invalid);
  return (int)cudaGetLastError();
}

template <typename ST>
int dispatch_wta_right(int k, const void* s, void* rho, long long rows, int w,
                       int s_invalid, cudaStream_t st) {
  switch (k) {
#define FSGM_CASE(KK)                                                     \
  case KK:                                                                \
    return launch_wta_right<KK, ST>(s, rho, rows, w, s_invalid, st);
    FSGM_CASE(1) FSGM_CASE(2) FSGM_CASE(3) FSGM_CASE(4)
    FSGM_CASE(5) FSGM_CASE(6) FSGM_CASE(7) FSGM_CASE(8)
#undef FSGM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int K, typename ST>
int launch(const void* s, void* d, void* sm, void* s0, void* sp, void* valid,
           long long rows, int w, int s_invalid, int max_diff, int with_sub,
           int with_rwta, int gx0, int w_global, cudaStream_t st) {
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t shmem = with_rwta ? 2 * sizeof(int) * (size_t)w : 0;
  auto kernel = extract_kernel<K, ST>;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)rows, kThreads, shmem, st>>>(
      (const ST*)s, (int*)d, (int*)sm, (int*)s0, (int*)sp, (int*)valid, w,
      s_invalid, max_diff, with_sub, with_rwta, gx0, w_global);
  return (int)cudaGetLastError();
}

template <typename ST>
int dispatch(int k, const void* s, void* d, void* sm, void* s0, void* sp,
             void* valid, long long rows, int w, int s_invalid, int max_diff,
             int with_sub, int with_rwta, int gx0, int w_global,
             cudaStream_t st) {
  switch (k) {
#define FSGM_CASE(KK)                                                     \
  case KK:                                                                \
    return launch<KK, ST>(s, d, sm, s0, sp, valid, rows, w, s_invalid,   \
                          max_diff, with_sub, with_rwta, gx0, w_global, st);
    FSGM_CASE(1) FSGM_CASE(2) FSGM_CASE(3) FSGM_CASE(4)
    FSGM_CASE(5) FSGM_CASE(6) FSGM_CASE(7) FSGM_CASE(8)
#undef FSGM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// s (B, H, W, D) int16 (s_int32 = 0) or int32, D a multiple of 32 up to
// 256; five (B, H, W) int32 outputs (valid written only with with_rwta);
// column x of S at the global column gx0 + x of an image w_global wide.
extern "C" int fsgm_extract_stereo(const void* s, int s_int32, void* d,
                                   void* sm, void* s0, void* sp, void* valid,
                                   int b, int h, int w, int nd, int s_invalid,
                                   int max_diff, int with_sub, int with_rwta,
                                   int gx0, int w_global, void* stream) {
  if (nd % 32 != 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * h;
  cudaStream_t st = (cudaStream_t)stream;
  return s_int32 ? dispatch<int32_t>(nd / 32, s, d, sm, s0, sp, valid, rows, w,
                                     s_invalid, max_diff, with_sub, with_rwta,
                                     gx0, w_global, st)
                 : dispatch<int16_t>(nd / 32, s, d, sm, s0, sp, valid, rows, w,
                                     s_invalid, max_diff, with_sub, with_rwta,
                                     gx0, w_global, st);
}

// s (B, H, W, D) int16 (s_int32 = 0) or int32, D a multiple of 32 up to
// 256; rho (B, H, W) int32: argmin_d S(y, x + d, d), s_invalid where
// x + d >= W, smallest d on ties.
extern "C" int fsgm_wta_right(const void* s, int s_int32, void* rho, int b,
                              int h, int w, int nd, int s_invalid,
                              void* stream) {
  if (nd % 32 != 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * h;
  cudaStream_t st = (cudaStream_t)stream;
  return s_int32 ? dispatch_wta_right<int32_t>(nd / 32, s, rho, rows, w,
                                               s_invalid, st)
                 : dispatch_wta_right<int16_t>(nd / 32, s, rho, rows, w,
                                               s_invalid, st);
}
