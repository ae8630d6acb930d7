// K5 label_minor_from_major: u8 (H, L, W) -> (H, W, L).
//
// Replaces the TPU kernel fsgm_tpu/ops/pallas/transpose_pallas.py::
// label_minor_from_major (kernel body _tr_kernel, an in-VMEM Eklundh
// butterfly of 128 x 128 tiles that needed L padded to 128 and W to a
// multiple of 128).  The flow cost build writes its label planes
// contiguous along W (label-major); the sweeps and the extraction read one
// pixel's labels contiguously (label-minor).  This kernel exchanges the two
// axes for any L and W:
//
//   out[y, x, l] = in[y, l, x]
//
// Bound: device-memory bytes (each byte read once and written once: 2 H L W
// bytes, 89 MB at the KITTI flow level 0 with L = 96).  Design: the classic
// tiled transpose.  A block of 32 x 8 threads takes one 32 x 32 tile of one
// row y's (L, W) plane: it reads 32 labels x 32 columns with each warp on
// 32 consecutive bytes of a label plane, stages them in shared memory with a
// padded row (33 bytes) so the transposed read spreads over the banks, and
// writes 32 columns x 32 labels with each warp on 32 consecutive bytes of
// the label-minor output.  Ragged tiles at the L and W edges are masked.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // threads per tile column: 32 x 8 per block

__global__ void __launch_bounds__(kTile * kRows)
transpose_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int nl, int w) {
  __shared__ uint8_t tile[kTile][kTile + 1];
  const long long plane = (long long)blockIdx.z * nl * w;
  const int x0 = blockIdx.x * kTile, l0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int j = ty; j < kTile; j += kRows) {
    const int l = l0 + j, x = x0 + tx;
    if (l < nl && x < w) tile[j][tx] = in[plane + (long long)l * w + x];
  }
  __syncthreads();
  for (int j = ty; j < kTile; j += kRows) {
    const int x = x0 + j, l = l0 + tx;
    if (x < w && l < nl) out[plane + (long long)x * nl + l] = tile[tx][j];
  }
}

}  // namespace

// in (H, L, W) u8 -> out (H, W, L) u8, both contiguous; H <= 65535.
extern "C" int fsgm_label_minor_from_major(const void* in, void* out, int h,
                                           int nl, int w, void* stream) {
  if (h > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTile - 1) / kTile, (nl + kTile - 1) / kTile, h);
  const dim3 block(kTile, kRows);
  transpose_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, nl, w);
  return (int)cudaGetLastError();
}
