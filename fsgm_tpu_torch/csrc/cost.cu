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
// Bound: device-memory bytes.  Each output byte costs one popcount; the
// volume written (B*H*W*D bytes, 59.6 MB a KITTI frame at 375x1242x128)
// dominates the 2 x 8 bytes per pixel of census read.  Design: one block
// row of the grid per image row of one frame (blockIdx.x = b * H + y), the
// row's W*D output bytes split over blockIdx.y; one thread per output byte,
// consecutive threads on consecutive labels of one pixel, so a warp writes
// 32 consecutive bytes and reads the matched row's census from consecutive
// addresses; the reference word is a broadcast within the warp.  Label and
// column come from a 32-bit division inside the row, and the row offset is
// 64-bit (B*H*W*D passes 2^31 at 4K with B = 2).  A match never leaves its
// own row, so it never reads the next row or the next frame.  No shared
// memory: the census rows are L1/L2 resident for the D threads that reuse
// them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool RIGHT>
__global__ void census_cost_kernel(const long long* __restrict__ cen_l,
                                   const long long* __restrict__ cen_r,
                                   uint8_t* __restrict__ out, int w, int nd,
                                   int invalid_cost) {
  const int j = blockIdx.y * blockDim.x + threadIdx.x;  // byte within the row
  if (j >= w * nd) return;
  const long long row = blockIdx.x;                     // b * H + y
  const int d = j % nd;
  const int x = j / nd;
  const long long pix = row * w + x;
  int c = invalid_cost;
  if (RIGHT) {
    if (x + d < w)
      c = __popcll((unsigned long long)(cen_r[pix] ^ cen_l[pix + d]));
  } else {
    if (x >= d)
      c = __popcll((unsigned long long)(cen_l[pix] ^ cen_r[pix - d]));
  }
  out[row * w * nd + j] = (uint8_t)c;
}

}  // namespace

// cen_l, cen_r (B, H, W) int64; out (B, H, W, D) u8.
extern "C" int fsgm_census_cost(const void* cen_l, const void* cen_r,
                                void* out, int b, int h, int w, int nd,
                                int invalid_cost, int right_reference,
                                void* stream) {
  const long long rows = (long long)b * h;
  const long long chunks = ((long long)w * nd + kThreads - 1) / kThreads;
  if (rows > 0x7fffffffLL || chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)rows, (unsigned)chunks);
  cudaStream_t st = (cudaStream_t)stream;
  if (right_reference) {
    census_cost_kernel<true><<<grid, kThreads, 0, st>>>(
        (const long long*)cen_l, (const long long*)cen_r, (uint8_t*)out, w, nd,
        invalid_cost);
  } else {
    census_cost_kernel<false><<<grid, kThreads, 0, st>>>(
        (const long long*)cen_l, (const long long*)cen_r, (uint8_t*)out, w, nd,
        invalid_cost);
  }
  return (int)cudaGetLastError();
}
