// K2 sgm_sweep: the SGM path recurrence for one direction, summed into S.
//
// Replaces the TPU kernel fsgm_tpu/ops/pallas/aggregate_tr.py::tr_family_sweep
// (kernel body _make_tr_kernel).  For one direction r = (dy, dx):
//
//   L_r(p, d) = C(p, d) + min(L(p-r, d), min(L(p-r, d-1), L(p-r, d+1)) + P1,
//                             m + P2'(p)) - m,        m = min_k L(p-r, k)
//   L_r(p, d) = C(p, d) where p - r lies outside the image,
//
// and S = L_r (fresh) or S += L_r (read-modify-write).  Exact integer
// arithmetic: golden/sgm.py::aggregate_one_path bit for bit.
//
// Bound: latency of the serial chain along each path line, then
// device-memory bytes (per pixel and direction: D cost bytes read, D S values
// read and written).  Design, after libSGM (arXiv 1610.04121): one warp walks
// one path line and holds that pixel's D labels in registers, K = D/32
// consecutive labels per lane.  m is one __reduce_min_sync, the d-1 / d+1
// neighbours across lane boundaries are one __shfl_up_sync /
// __shfl_down_sync each, and L never leaves registers along the line.  Each
// step's loads are coalesced (a warp reads one pixel's D cost bytes and D S
// values) and the next pixel's cost, S and P2' are loaded before the current
// step's arithmetic, so the load latency overlaps the recurrence.  Lines
// start at every pixel whose predecessor p - r is outside the image (the
// first |dy| rows in scan order, then the first |dx| columns), which covers
// the 8 paths and the knight directions (|dy| = 2 steps two rows back) alike.
// The launches of one frame's directions run in order on one stream, so the
// read-modify-write of S needs no atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // four lines per block

template <int K, typename ST, bool FRESH>
__device__ __forceinline__ void load_step(const uint8_t* __restrict__ cost,
                                          const int* __restrict__ p2e,
                                          const ST* __restrict__ s,
                                          long long pix, int d0, int (&c)[K],
                                          int (&sv)[K], int& p2v) {
  const uint8_t* cp = cost + pix * (32 * K) + d0;
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = cp[k];
  if (!FRESH) {
    const ST* sp = s + pix * (32 * K) + d0;
#pragma unroll
    for (int k = 0; k < K; ++k) sv[k] = sp[k];
  }
  p2v = p2e[pix];
}

template <int K, typename ST, bool FRESH>
__global__ void __launch_bounds__(kThreads)
sgm_sweep_kernel(const uint8_t* __restrict__ cost, const int* __restrict__ p2e,
                 ST* __restrict__ s, int h, int w, int dy, int dx, int p1,
                 int n_row_starts, int rows_rem, int n_lines) {
  const int lane = threadIdx.x & 31;
  const int line = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (line >= n_lines) return;  // uniform over the warp
  int y, x;
  if (line < n_row_starts) {
    const int i = line / w;
    x = line % w;
    y = dy > 0 ? i : h - 1 - i;
  } else {
    const int g = line - n_row_starts;
    const int j = g / rows_rem;
    x = dx > 0 ? j : w - 1 - j;
    y = (dy > 0 ? dy : 0) + g % rows_rem;
  }
  const int d0 = lane * K;
  long long pix = (long long)y * w + x;
  int c[K], sv[K], prev[K];
  int p2v;
  load_step<K, ST, FRESH>(cost, p2e, s, pix, d0, c, sv, p2v);
  bool first = true;
  while (true) {
    const int ny = y + dy, nx = x + dx;
    const bool more = ny >= 0 && ny < h && nx >= 0 && nx < w;
    const long long npix = (long long)ny * w + nx;
    int nc[K], nsv[K];
    int np2 = 0;
    if (more) load_step<K, ST, FRESH>(cost, p2e, s, npix, d0, nc, nsv, np2);

    int l[K];
    if (first) {
#pragma unroll
      for (int k = 0; k < K; ++k) l[k] = c[k];
    } else {
      int mloc = prev[0];
#pragma unroll
      for (int k = 1; k < K; ++k) mloc = min(mloc, prev[k]);
      const int m = __reduce_min_sync(kFull, mloc);
      int left = __shfl_up_sync(kFull, prev[K - 1], 1);
      int right = __shfl_down_sync(kFull, prev[0], 1);
      if (lane == 0) left = kInf;
      if (lane == 31) right = kInf;
      const int mp = m + p2v;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int lo = k == 0 ? left : prev[k - 1];
        const int hi = k == K - 1 ? right : prev[k + 1];
        const int best = min(min(prev[k], min(lo, hi) + p1), mp);
        l[k] = c[k] + best - m;
      }
    }
    ST* sp = s + pix * (32 * K) + d0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sp[k] = (ST)(FRESH ? l[k] : sv[k] + l[k]);
      prev[k] = l[k];
    }
    if (!more) break;
    first = false;
    y = ny;
    x = nx;
    pix = npix;
    p2v = np2;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c[k] = nc[k];
      sv[k] = nsv[k];
    }
  }
}

template <int K, typename ST, bool FRESH>
void launch(const void* cost, const void* p2e, void* s, int h, int w, int dy,
            int dx, int p1, cudaStream_t stream) {
  const int ady = dy < 0 ? -dy : dy, adx = dx < 0 ? -dx : dx;
  const int row_band = ady < h ? ady : h;
  const int n_row_starts = row_band * w;
  const int rows_rem = h - row_band;
  const int n_lines = n_row_starts + rows_rem * (adx < w ? adx : w);
  const int per_block = kThreads / 32;
  const int blocks = (n_lines + per_block - 1) / per_block;
  sgm_sweep_kernel<K, ST, FRESH><<<blocks, kThreads, 0, stream>>>(
      (const uint8_t*)cost, (const int*)p2e, (ST*)s, h, w, dy, dx, p1,
      n_row_starts, rows_rem, n_lines);
}

template <typename ST, bool FRESH>
int dispatch(int k, const void* cost, const void* p2e, void* s, int h, int w,
             int dy, int dx, int p1, cudaStream_t st) {
  switch (k) {
    case 1: launch<1, ST, FRESH>(cost, p2e, s, h, w, dy, dx, p1, st); break;
    case 2: launch<2, ST, FRESH>(cost, p2e, s, h, w, dy, dx, p1, st); break;
    case 3: launch<3, ST, FRESH>(cost, p2e, s, h, w, dy, dx, p1, st); break;
    case 4: launch<4, ST, FRESH>(cost, p2e, s, h, w, dy, dx, p1, st); break;
    case 5: launch<5, ST, FRESH>(cost, p2e, s, h, w, dy, dx, p1, st); break;
    case 6: launch<6, ST, FRESH>(cost, p2e, s, h, w, dy, dx, p1, st); break;
    case 7: launch<7, ST, FRESH>(cost, p2e, s, h, w, dy, dx, p1, st); break;
    case 8: launch<8, ST, FRESH>(cost, p2e, s, h, w, dy, dx, p1, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// cost (H, W, D) u8, p2e (H, W) int32 P2' of this direction, s (H, W, D)
// int16 (s_int32 = 0) or int32; D a multiple of 32 up to 256.
extern "C" int fsgm_sgm_sweep(const void* cost, const void* p2e, void* s,
                              int s_int32, int fresh, int h, int w, int nd,
                              int dy, int dx, int p1, void* stream) {
  if (nd % 32 != 0) return (int)cudaErrorInvalidValue;
  const int k = nd / 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (s_int32) {
    return fresh ? dispatch<int32_t, true>(k, cost, p2e, s, h, w, dy, dx, p1, st)
                 : dispatch<int32_t, false>(k, cost, p2e, s, h, w, dy, dx, p1, st);
  }
  return fresh ? dispatch<int16_t, true>(k, cost, p2e, s, h, w, dy, dx, p1, st)
               : dispatch<int16_t, false>(k, cost, p2e, s, h, w, dy, dx, p1, st);
}
