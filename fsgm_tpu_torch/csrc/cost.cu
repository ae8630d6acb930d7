// K1 census_cost: census-Hamming stereo matching cost on Hopper (sm_90a).
//
// Replaces the TPU kernels fsgm_tpu/ops/pallas/cost_tr.py::cost_volume_wlh
// (column-scan layout) and ::cost_volume_hlw (row-scan layout).  Those two
// exist because the TPU sweeps read the volume in two transposed layouts;
// the Hopper sweep (sgm_sweep.cu) reads one label-minor (H, W, D) u8 volume
// for every direction, so one kernel replaces both.
//
//   C[y, x, d] = popcount(cenL[y, x] ^ cenR[y, x - d]),  invalid_cost where x - d < 0
//
// Census descriptors are one int64 word per pixel (windows up to 62 bits).
//
// Bound: device-memory bytes.  Each output byte costs one popcount; the
// volume written (H*W*D bytes, 59.6 MB at KITTI 375x1242x128) dominates the
// 2 x 8 bytes per pixel of census read.  Design: one thread per output byte,
// consecutive threads on consecutive labels of one pixel, so a warp writes 32
// consecutive bytes and reads cenR[y, x - d] from consecutive (descending)
// addresses; the cenL word is a broadcast within the warp.  No shared memory:
// the census rows are L1/L2 resident for the D threads that reuse them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void census_cost_kernel(const long long* __restrict__ cen_l,
                                   const long long* __restrict__ cen_r,
                                   uint8_t* __restrict__ out,
                                   long long total, int w, int nd,
                                   int invalid_cost) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int d = (int)(i % nd);
  const long long pix = i / nd;
  const int x = (int)(pix % w);
  int c = invalid_cost;
  if (x >= d) {
    c = __popcll((unsigned long long)(cen_l[pix] ^ cen_r[pix - d]));
  }
  out[i] = (uint8_t)c;
}

}  // namespace

extern "C" int fsgm_census_cost(const void* cen_l, const void* cen_r,
                                void* out, int h, int w, int nd,
                                int invalid_cost, void* stream) {
  const long long total = (long long)h * w * nd;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  census_cost_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)cen_l, (const long long*)cen_r, (uint8_t*)out, total,
      w, nd, invalid_cost);
  return (int)cudaGetLastError();
}
