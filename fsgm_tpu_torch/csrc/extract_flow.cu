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
// Bound: device-memory bytes (S is read once: D values per pixel, 89 MB at
// the KITTI flow level 0 in int16; seven int32 planes written).  Design:
// one warp per pixel.  Each lane reads K = D/32 consecutive values, so a
// warp reads the pixel's D values in one coalesced sweep; the packed WTA is
// one __reduce_min_sync; lane 0 then reads the six neighbour values by
// index from the same row (an L1 hit) and writes the seven outputs.  The
// slots past nl (a volume padded to a multiple of 32) are never read.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // eight pixels per block

template <int K, typename ST>
__global__ void __launch_bounds__(kThreads)
extract_flow_kernel(const ST* __restrict__ s, int* __restrict__ l_out,
                    int* __restrict__ um, int* __restrict__ u0,
                    int* __restrict__ up, int* __restrict__ vm,
                    int* __restrict__ v0, int* __restrict__ vp,
                    long long npix, int nl, int ext, int with_sub) {
  constexpr int ND = 32 * K;
  const long long pix = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (pix >= npix) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const ST* sp = s + pix * ND;
  int pk = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int l = lane * K + k;
    if (l < nl) pk = min(pk, ((int)sp[l] << 8) | l);
  }
  pk = __reduce_min_sync(kFull, pk);
  if (lane != 0) return;
  const int lab = pk & 255;
  l_out[pix] = lab;
  if (!with_sub) return;
  const int iv = lab / ext;
  const int iu = lab - iv * ext;
  const int iuc = min(max(iu, 1), ext - 2);
  const int ivc = min(max(iv, 1), ext - 2);
  const int bu = iv * ext + iuc;
  const int bv = ivc * ext + iu;
  um[pix] = sp[bu - 1];
  u0[pix] = sp[bu];
  up[pix] = sp[bu + 1];
  vm[pix] = sp[bv - ext];
  v0[pix] = sp[bv];
  vp[pix] = sp[bv + ext];
}

template <int K, typename ST>
int launch(const void* s, void* const* outs, long long npix, int nl, int ext,
           int with_sub, cudaStream_t st) {
  const long long threads = npix * 32;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  extract_flow_kernel<K, ST><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const ST*)s, (int*)outs[0], (int*)outs[1], (int*)outs[2],
      (int*)outs[3], (int*)outs[4], (int*)outs[5], (int*)outs[6], npix, nl,
      ext, with_sub);
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

// s (H, W, D) int16 (s_int32 = 0) or int32, D a multiple of 32 up to 256,
// nl = ext * ext <= min(D, 255), ext >= 3; seven (H, W) int32 outputs
// (l, u_m, u_0, u_p, v_m, v_0, v_p), the last six written only with with_sub.
extern "C" int fsgm_extract_flow(const void* s, int s_int32, void* l, void* um,
                                 void* u0, void* up, void* vm, void* v0,
                                 void* vp, int h, int w, int nd, int nl,
                                 int ext, int with_sub, void* stream) {
  if (nd % 32 != 0 || nd > 256 || ext < 3 || nl != ext * ext || nl > nd ||
      nl > 255)
    return (int)cudaErrorInvalidValue;
  void* outs[7] = {l, um, u0, up, vm, v0, vp};
  const long long npix = (long long)h * w;
  cudaStream_t st = (cudaStream_t)stream;
  return s_int32
             ? dispatch<int32_t>(nd / 32, s, outs, npix, nl, ext, with_sub, st)
             : dispatch<int16_t>(nd / 32, s, outs, npix, nl, ext, with_sub, st);
}
