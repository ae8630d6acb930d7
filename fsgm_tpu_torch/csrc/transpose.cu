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
// Bound: device-memory bytes, each byte read once and written once (2 H L W
// bytes: 89 MB, 0.0267 ms at 3.35 TB/s, at the KITTI flow level 0 with
// L = 96).  The flow paths give L a multiple of 32 and W of any size, so a
// label row (y, l) starts at byte (y L + l) W: almost never on a 16-byte
// boundary.  Design for L a multiple of 16 up to 256 (the tiled kernel):
//   * A tile is kTileW = 128 columns of one row y with all L labels.  Its
//     output out[y, x0 : x0 + 128, :] is one contiguous span of 128 L
//     bytes, written whole by one block.
//   * Reads: for each of the tile's L label rows the block copies the
//     kRowChunks = 9 aligned 16-byte chunks that cover the row's 128
//     columns at any shift s = (row start + x0) mod 16 into shared memory
//     with cp.async (only those the span needs), and keeps s for the read-
//     out.  A chunk that reaches past the tensor's first or last byte is
//     copied byte by byte: no read leaves the tensor, at any base address.
//   * The exchange happens in registers.  Warp g owns label group g (16
//     labels) and lane t the columns 4t ... 4t + 3.  For each of the 16
//     rows the lane reads two consecutive 32-bit words of the staged row
//     and funnel-shifts them by s mod 4 bytes into the word of its four
//     columns (the warp reads 32 consecutive words of one row: no bank
//     conflict), turns each 4 x 4 byte block of four rows with eight
//     __byte_perm, and so holds 16 labels of each of its four pixels: four
//     16-byte stores into the staged output.
//   * The staged output puts each 4-pixel quad at an odd count of 16-byte
//     chunks (4 G + 1 for G = L / 16 groups), so the eight lanes of a
//     quarter-warp, on eight consecutive quads, store to distinct banks.
//     The block then writes the tile's span with consecutive threads on
//     consecutive 16-byte chunks: each warp store is 512 contiguous bytes.
//   * One block a tile, by a flat tile index (no limit on H), of
//     max(G, 8) warps: warps past G only copy in and out, which shortens a
//     block's serial path where L is small.  A block holds one tile
//     (26.6 KB at L = 96): eight blocks share an SM, and a block's copies
//     run under the others' exchanges.  On an H100 this was faster than a
//     persistent grid (csrc/persistent.cuh) that prefetched each block's
//     next tile, most on a 4K flow tile; 256-column tiles were slower at
//     the coarser pyramid levels, and stores straight from registers (16
//     bytes at a 4L-byte stride across a warp) much slower (PERF.md
//     section 6).
// Any other L (not a multiple of 16, or above 256) takes the generic
// kernel: 32 x 32 byte tiles through shared memory, one byte a thread a
// step, on a flat grid.  It is correct and slower; no flow path takes it.

#include <cstdint>

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

using fsgm_cp::cp_async16;
using fsgm_cp::cp_commit;
using fsgm_cp::cp_wait;

constexpr int kChunk = 16;      // bytes of a copy, a label group, a store;
                                // ops/kernels/transpose.py LABEL_GROUP
constexpr int kTileW = 128;     // columns of a tile: 32 lanes x 4
constexpr int kRowChunks = kTileW / kChunk + 1;  // staged chunks of a row:
                                                 // its span at any shift
constexpr int kMaxGroups = 16;  // label groups of the tiled kernel (L <= 256)
constexpr int kMinWarps = 8;    // warps of a tiled block, at least
constexpr int kBlockSmem = 232448;  // an H100 block's shared memory, at most
constexpr int kSmallTile = 32;  // the generic kernel's tile edge
constexpr int kSmallRows = 8;   // its threads per tile column

// bytes of a tile's staged label rows, of its staged output (each 4-pixel
// quad at 4 g + 1 chunks) and of a block's shared memory, for g label
// groups; ops/kernels/transpose.py staged_bytes
__host__ __device__ constexpr int in_bytes(int g) {
  return kChunk * g * kRowChunks * kChunk;
}
__host__ __device__ constexpr int quad_chunks(int g) { return 4 * g + 1; }
__host__ __device__ constexpr int out_bytes(int g) {
  return kTileW / 4 * quad_chunks(g) * kChunk;
}
__host__ __device__ constexpr int warps(int g) {
  return g > kMinWarps ? g : kMinWarps;
}
__host__ __device__ constexpr int smem_bytes(int g) {
  return in_bytes(g) + out_bytes(g);
}

template <int G>
__global__ void __launch_bounds__(32 * warps(G))
transpose_tiled_kernel(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, int w, long long numel) {
  constexpr int NL = kChunk * G;  // labels
  constexpr int THREADS = 32 * warps(G);
  constexpr int ROW_WORDS = kRowChunks * kChunk / 4;
  constexpr int QC = quad_chunks(G);
  static_assert(smem_bytes(G) <= kBlockSmem, "a block's tile fits");
  static_assert(kRowChunks % 2 == 1 && QC % 2 == 1,
                "staged rows and quads are an odd count of chunks");
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* const staged_out = reinterpret_cast<uint4*>(smem + in_bytes(G));
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int y = blockIdx.x / tiles_x;
  const int x0 = (blockIdx.x - y * tiles_x) * kTileW;
  const int n = min(kTileW, w - x0);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(in);
  const uintptr_t hi = lo + (uintptr_t)numel;
  const uintptr_t row0 = lo + (uintptr_t)((long long)y * NL * w + x0);

  // stage the tile's label rows: per row the aligned chunks that cover its
  // columns, a byte at a time where one leaves the tensor
#pragma unroll 1
  for (int i = tid; i < NL * kRowChunks; i += THREADS) {
    const int l = i / kRowChunks, c = i - l * kRowChunks;
    const uintptr_t a = row0 + (uintptr_t)l * w;
    if (c * kChunk >= (int)(a & 15) + n) continue;  // past the span
    const uintptr_t src = (a & ~(uintptr_t)15) + c * kChunk;
    unsigned char* dst = smem + i * kChunk;
    if (src >= lo && src + kChunk <= hi) {
      cp_async16(dst, reinterpret_cast<const void*>(src));
    } else {
      for (int k = 0; k < kChunk; ++k)
        if (src + k >= lo && src + k < hi)
          dst[k] = *reinterpret_cast<const uint8_t*>(src + k);
    }
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();  // the tile staged

  if (g < G && 4 * lane < n) {
    // row l = 16 g + r starts s(r) bytes into its first staged chunk;
    // 16 g W is a multiple of 16, so s depends on r alone
    const int s0 = (int)(row0 & 15);
    const int w16 = w & 15;
    const uint32_t* const rows = reinterpret_cast<const uint32_t*>(smem) +
                                 (kChunk * g) * ROW_WORDS + lane;
    uint32_t px[4][4];  // [pixel j of the quad][labels 4q ... 4q + 3]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t v[4];  // columns 4 lane ... + 3 of rows 4q ... 4q + 3
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * q + k;
        const int s = (s0 + r * w16) & 15;
        const uint32_t* p = rows + r * ROW_WORDS + (s >> 2);
        v[k] = __funnelshift_r(p[0], p[1], (s & 3) * 8);
      }
      const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
      const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);
      const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
      const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
      px[0][q] = __byte_perm(t0, t2, 0x5410);
      px[1][q] = __byte_perm(t0, t2, 0x7632);
      px[2][q] = __byte_perm(t1, t3, 0x5410);
      px[3][q] = __byte_perm(t1, t3, 0x7632);
    }
    uint4* const dst = staged_out + lane * QC + g;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[j * G] = make_uint4(px[j][0], px[j][1], px[j][2], px[j][3]);
  }
  __syncthreads();  // the tile's output staged

  // chunk c of the span (pixel c / G, label group c % G) sits in quad
  // c / 4G at chunk c % 4G: staged chunk c + c / 4G
  uint4* const span =
      reinterpret_cast<uint4*>(out + ((long long)y * w + x0) * NL);
#pragma unroll 4
  for (int c = tid; c < n * G; c += THREADS)
    span[c] = staged_out[c + c / (4 * G)];
}

// any L and W: one 32 x 32 tile of one row's (L, W) plane a block, tile
// (y, label tile, column tile) from the flat block index
__global__ void __launch_bounds__(kSmallTile * kSmallRows)
transpose_generic_kernel(const uint8_t* __restrict__ in,
                         uint8_t* __restrict__ out, int nl, int w) {
  __shared__ uint8_t tile[kSmallTile][kSmallTile + 1];
  const int tiles_x = (w + kSmallTile - 1) / kSmallTile;
  const int tiles_l = (nl + kSmallTile - 1) / kSmallTile;
  const int b = blockIdx.x;
  const int x0 = b % tiles_x * kSmallTile;
  const int l0 = b / tiles_x % tiles_l * kSmallTile;
  const long long plane = (long long)(b / tiles_x / tiles_l) * nl * w;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int j = ty; j < kSmallTile; j += kSmallRows) {
    const int l = l0 + j, x = x0 + tx;
    if (l < nl && x < w) tile[j][tx] = in[plane + (long long)l * w + x];
  }
  __syncthreads();
  for (int j = ty; j < kSmallTile; j += kSmallRows) {
    const int x = x0 + j, l = l0 + tx;
    if (x < w && l < nl) out[plane + (long long)x * nl + l] = tile[tx][j];
  }
}

template <int G>
int launch_tiled(const void* in, void* out, int h, int w, cudaStream_t st) {
  constexpr int shmem = smem_bytes(G);
  auto kernel = transpose_tiled_kernel<G>;
  if (shmem > 48 * 1024) {  // past the default limit: raise it (L >= 192)
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (long long)h * ((w + kTileW - 1) / kTileW);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, 32 * warps(G), shmem, st>>>(
      (const uint8_t*)in, (uint8_t*)out, w, (long long)h * kChunk * G * w);
  return (int)cudaGetLastError();
}

int launch_generic(const void* in, void* out, long long h, int nl, int w,
                   cudaStream_t st) {
  const long long blocks = h * ((nl + kSmallTile - 1) / kSmallTile) *
                           ((w + kSmallTile - 1) / kSmallTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  transpose_generic_kernel<<<(unsigned)blocks, dim3(kSmallTile, kSmallRows),
                             0, st>>>((const uint8_t*)in, (uint8_t*)out, nl,
                                      w);
  return (int)cudaGetLastError();
}

}  // namespace

// in (H, L, W) u8 -> out (H, W, L) u8, both contiguous, in at any address;
// L a multiple of 16 up to 256 takes the tiled kernel (out 16-byte
// aligned), any other L the generic one.
extern "C" int fsgm_label_minor_from_major(const void* in, void* out, int h,
                                           int nl, int w, void* stream) {
  if (h < 1 || nl < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nl % kChunk != 0 || nl > kChunk * kMaxGroups)
    return launch_generic(in, out, h, nl, w, st);
  if ((uintptr_t)out & 15) return (int)cudaErrorInvalidValue;
  switch (nl / kChunk) {
#define FSGM_CASE(G) \
  case G: return launch_tiled<G>(in, out, h, w, st);
    FSGM_CASE(1) FSGM_CASE(2) FSGM_CASE(3) FSGM_CASE(4)
    FSGM_CASE(5) FSGM_CASE(6) FSGM_CASE(7) FSGM_CASE(8)
    FSGM_CASE(9) FSGM_CASE(10) FSGM_CASE(11) FSGM_CASE(12)
    FSGM_CASE(13) FSGM_CASE(14) FSGM_CASE(15) FSGM_CASE(16)
#undef FSGM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
