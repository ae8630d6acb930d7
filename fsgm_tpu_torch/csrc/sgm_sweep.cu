// K2 sgm_sweep: the SGM path recurrence for one direction, summed into S.
//
// Replaces the TPU kernel fsgm_tpu/ops/pallas/aggregate_tr.py::tr_family_sweep
// (kernel body _make_tr_kernel, label-neighbour rules make_tr_nmin_1d and
// make_tr_nmin_2d), also as aggregate_paths_tr_batch calls it on the
// lane-folded (W, L, B*Hp) volume of B frames.  For one direction r = (dy, dx):
//
//   L_r(p, l) = C(p, l) + min(L(p-r, l), N(p-r, l) + P1, m + P2'(p)) - m,
//   m = min_k L(p-r, k),   L_r(p, l) = C(p, l) where p - r lies outside,
//
// and S = L_r (fresh) or S += L_r (read-modify-write).  The label
// neighbour term N is min(L[l-1], L[l+1]) for stereo (1D labels) and, for
// the flow's (e x e) label grid (label_ext = e), min(L[l-1], L[l+1],
// L[l-e], L[l+e]) with l-1 absent where l % e == 0, l+1 absent where
// l % e == e-1 and l-e, l+e absent outside [0, nl).  Only the first nl of
// the volume's D label slots are labels: the slots past nl (a volume padded
// to a multiple of 32) take part in no neighbour min and no m, and their S
// stays 0.  Exact integer arithmetic: golden/sgm.py::aggregate_one_path
// (with golden/flow.py::make_neighbor_min_2d for flow) bit for bit.
//
// Bound: latency of the serial chain along each path line, then
// device-memory bytes (per pixel and direction: D cost bytes read, D S values
// read and written).  Design, after libSGM (arXiv 1610.04121): one warp walks
// one path line and holds that pixel's D labels in registers, K = D/32
// consecutive labels per lane.  m is one __reduce_min_sync; the 1D
// neighbours d-1 / d+1 across lane boundaries are one __shfl_up_sync /
// __shfl_down_sync each.  The 2D rule's l +- e neighbours cross lanes by an
// amount that depends on e and K, so there the warp writes its previous L
// row to a per-warp row of shared memory and each lane reads its four
// neighbours by index (two __syncwarp per step).  L never leaves the SM
// along the line.  Each step's loads are coalesced (a warp reads one
// pixel's D cost bytes and D S values) and the next pixel's cost, S and P2'
// are loaded before the current step's arithmetic, so the load latency
// overlaps the recurrence.  Lines start at every pixel whose predecessor
// p - r is outside the image (the first |dy| rows in scan order, then the
// first |dx| columns), which covers the 8 paths and the knight directions
// (|dy| = 2 steps two rows back) alike.  The launches of one frame's
// directions run in order on one stream, so the read-modify-write of S
// needs no atomics.  Batch: one launch per direction covers B frames; the
// global line index gives the frame and the frame's own line, every pixel
// offset is the frame's 64-bit base plus y * W + x, and a walk stops at its
// own frame's edge, so a line never continues into the next frame (the TPU
// got this from neutral zero pad lanes between folded frames).  B frames
// give B times the lines: 16 KITTI frames give the horizontal directions
// 6,000 lines instead of 375.
//
// Carry (tiled execution; also replaces the first-generation TPU sweeps
// fsgm_tpu/ops/pallas/aggregate_pallas.py::_row_sweep, whose carry crossed
// tile seams, and ::_col_sweep).  For dy != 0, carry_in and carry_out are
// nullable (B, 2, W, D) int32 tensors in the canonical scan frame, row 0
// the most recent row (fsgm_tpu/ops/aggregate.py::aggregate_one_path's
// carry).  A line that starts at scan row i < |dy| whose predecessor
// column x - dx is inside the image loads carry_in[b, |dy|-1-i, x-dx] as
// its previous L (INF in the label slots past nl) and takes the normal
// recurrence at its first pixel instead of L = C; knights (|dy| = 2) read
// carry row 1 at scan row 0 and row 0 at scan row 1.  A walk in the last
// two scan rows stores its L (0 past nl) into carry_out row h-1-scan_row,
// so each carry entry is written once, by the line through that pixel.
// This is a few loads at a line's start and a few stores at its end: the
// walk itself is unchanged.

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

template <int K, typename ST, bool FRESH, bool LABEL2D>
__global__ void __launch_bounds__(kThreads)
sgm_sweep_kernel(const uint8_t* __restrict__ cost, const int* __restrict__ p2e,
                 ST* __restrict__ s, const int* __restrict__ carry_in,
                 int* __restrict__ carry_out, int h, int w, int nl, int ext,
                 int dy, int dx, int p1, int n_row_starts, int rows_rem,
                 int per_frame, long long n_lines) {
  constexpr int ND = 32 * K;
  // LABEL2D: each warp's previous L row, read by label index
  __shared__ int prev_row[LABEL2D ? kThreads / 32 : 1][LABEL2D ? ND : 1];
  const int lane = threadIdx.x & 31;
  const long long gline = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (gline >= n_lines) return;  // uniform over the warp
  // the frame and this frame's line: the walk below stays inside [0, H) x
  // [0, W) of its own frame, whose first pixel is `base`
  const long long frame = gline / per_frame;
  const int line = (int)(gline - frame * per_frame);
  const long long base = frame * h * w;
  int* row = prev_row[LABEL2D ? (threadIdx.x >> 5) : 0];
  int y, x;
  int start_row = -1;  // the scan row i < |dy| where the line starts, if so
  if (line < n_row_starts) {
    start_row = line / w;
    x = line % w;
    y = dy > 0 ? start_row : h - 1 - start_row;
  } else {
    const int g = line - n_row_starts;
    const int j = g / rows_rem;
    x = dx > 0 ? j : w - 1 - j;
    y = (dy > 0 ? dy : 0) + g % rows_rem;
  }
  const int d0 = lane * K;
  // which of this lane's labels are real, and (2D) which neighbours exist
  bool real[K], has_l[K], has_r[K], has_u[K], has_d[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + k;
    real[k] = d < nl;
    if (LABEL2D) {
      const int u = d % ext;
      has_l[k] = u != 0;
      has_r[k] = u != ext - 1 && d + 1 < nl;
      has_u[k] = d >= ext;
      has_d[k] = d + ext < nl;
    }
  }
  long long pix = base + (long long)y * w + x;
  int c[K], sv[K], prev[K];
  int p2v;
  load_step<K, ST, FRESH>(cost, p2e, s, pix, d0, c, sv, p2v);
  bool first = true;
  const int ady = dy < 0 ? -dy : dy;
  if (carry_in != nullptr && start_row >= 0 && x - dx >= 0 && x - dx < w) {
    // continue the scan from the previous tile: its L is this line's prev
    const int* cp = carry_in +
        ((frame * 2 + (ady - 1 - start_row)) * w + (x - dx)) * ND + d0;
#pragma unroll
    for (int k = 0; k < K; ++k) prev[k] = real[k] ? cp[k] : kInf;
    first = false;
  }
  while (true) {
    const int ny = y + dy, nx = x + dx;
    const bool more = ny >= 0 && ny < h && nx >= 0 && nx < w;
    const long long npix = base + (long long)ny * w + nx;
    int nc[K], nsv[K];
    int np2 = 0;
    if (more) load_step<K, ST, FRESH>(cost, p2e, s, npix, d0, nc, nsv, np2);

    int l[K];
    if (first) {
#pragma unroll
      for (int k = 0; k < K; ++k) l[k] = real[k] ? c[k] : kInf;
    } else {
      int mloc = prev[0];
#pragma unroll
      for (int k = 1; k < K; ++k) mloc = min(mloc, prev[k]);
      const int m = __reduce_min_sync(kFull, mloc);
      const int mp = m + p2v;
      int nb[K];
      if (LABEL2D) {
        __syncwarp();  // every lane has read the row of the step before
#pragma unroll
        for (int k = 0; k < K; ++k) row[d0 + k] = prev[k];
        __syncwarp();
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int d = d0 + k;
          int v = kInf;
          if (has_l[k]) v = min(v, row[d - 1]);
          if (has_r[k]) v = min(v, row[d + 1]);
          if (has_u[k]) v = min(v, row[d - ext]);
          if (has_d[k]) v = min(v, row[d + ext]);
          nb[k] = v;
        }
      } else {
        int left = __shfl_up_sync(kFull, prev[K - 1], 1);
        int right = __shfl_down_sync(kFull, prev[0], 1);
        if (lane == 0) left = kInf;
        if (lane == 31) right = kInf;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int lo = k == 0 ? left : prev[k - 1];
          const int hi = k == K - 1 ? right : prev[k + 1];
          nb[k] = min(lo, hi);  // slots past nl hold kInf
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int best = min(min(prev[k], nb[k] + p1), mp);
        l[k] = real[k] ? c[k] + best - m : kInf;
      }
    }
    ST* sp = s + pix * ND + d0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int add = real[k] ? l[k] : 0;
      sp[k] = (ST)(FRESH ? add : sv[k] + add);
      prev[k] = l[k];
    }
    const int back = dy > 0 ? h - 1 - y : y;  // scan rows left after this
    if (carry_out != nullptr && back <= 1) {
      int* co = carry_out + ((frame * 2 + back) * w + x) * ND + d0;
#pragma unroll
      for (int k = 0; k < K; ++k) co[k] = real[k] ? l[k] : 0;
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

template <int K, typename ST, bool FRESH, bool LABEL2D>
int launch(const void* cost, const void* p2e, void* s, const void* cin,
           void* cout, int b, int h, int w, int nl, int ext, int dy, int dx,
           int p1, cudaStream_t stream) {
  const int ady = dy < 0 ? -dy : dy, adx = dx < 0 ? -dx : dx;
  const int row_band = ady < h ? ady : h;
  const int n_row_starts = row_band * w;
  const int rows_rem = h - row_band;
  const int per_frame = n_row_starts + rows_rem * (adx < w ? adx : w);
  const long long n_lines = (long long)b * per_frame;
  const int per_block = kThreads / 32;
  const long long blocks = (n_lines + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sgm_sweep_kernel<K, ST, FRESH, LABEL2D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const uint8_t*)cost, (const int*)p2e, (ST*)s, (const int*)cin,
      (int*)cout, h, w, nl, ext, dy, dx, p1, n_row_starts, rows_rem, per_frame,
      n_lines);
  return (int)cudaGetLastError();
}

template <typename ST, bool FRESH, bool LABEL2D>
int dispatch(int k, const void* cost, const void* p2e, void* s, const void* cin,
             void* cout, int b, int h, int w, int nl, int ext, int dy, int dx,
             int p1, cudaStream_t st) {
  switch (k) {
#define FSGM_CASE(KK)                                                         \
  case KK:                                                                    \
    return launch<KK, ST, FRESH, LABEL2D>(cost, p2e, s, cin, cout, b, h, w,  \
                                          nl, ext, dy, dx, p1, st);
    FSGM_CASE(1) FSGM_CASE(2) FSGM_CASE(3) FSGM_CASE(4)
    FSGM_CASE(5) FSGM_CASE(6) FSGM_CASE(7) FSGM_CASE(8)
#undef FSGM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename ST>
int dispatch_mode(int fresh, int label2d, int k, const void* cost,
                  const void* p2e, void* s, const void* cin, void* cout, int b,
                  int h, int w, int nl, int ext, int dy, int dx, int p1,
                  cudaStream_t st) {
  if (label2d) {
    return fresh ? dispatch<ST, true, true>(k, cost, p2e, s, cin, cout, b, h, w, nl, ext, dy, dx, p1, st)
                 : dispatch<ST, false, true>(k, cost, p2e, s, cin, cout, b, h, w, nl, ext, dy, dx, p1, st);
  }
  return fresh ? dispatch<ST, true, false>(k, cost, p2e, s, cin, cout, b, h, w, nl, ext, dy, dx, p1, st)
               : dispatch<ST, false, false>(k, cost, p2e, s, cin, cout, b, h, w, nl, ext, dy, dx, p1, st);
}

}  // namespace

// cost (B, H, W, D) u8, p2e (B, H, W) int32 P2' of this direction, s
// (B, H, W, D) int16 (s_int32 = 0) or int32; D a multiple of 32 up to 256,
// of which the first nl slots are labels.  label_ext = 0: 1D labels;
// e >= 1: the e x e label grid (nl = e * e).  carry_in, carry_out: null, or
// (B, 2, W, D) int32 for dy != 0 (carry_out written in full when H >= 2;
// with H = 1 the caller fills its row 1).  One launch covers the B frames:
// B times each frame's lines.
extern "C" int fsgm_sgm_sweep(const void* cost, const void* p2e, void* s,
                              const void* carry_in, void* carry_out,
                              int s_int32, int fresh, int b, int h, int w,
                              int nd, int nl, int label_ext, int dy, int dx,
                              int p1, void* stream) {
  if (nd % 32 != 0 || nl < 1 || nl > nd || label_ext < 0)
    return (int)cudaErrorInvalidValue;
  if (dy == 0 && (carry_in != nullptr || carry_out != nullptr))
    return (int)cudaErrorInvalidValue;
  const int k = nd / 32;
  const int label2d = label_ext > 0;
  cudaStream_t st = (cudaStream_t)stream;
  return s_int32 ? dispatch_mode<int32_t>(fresh, label2d, k, cost, p2e, s,
                                          carry_in, carry_out, b, h, w, nl,
                                          label_ext, dy, dx, p1, st)
                 : dispatch_mode<int16_t>(fresh, label2d, k, cost, p2e, s,
                                          carry_in, carry_out, b, h, w, nl,
                                          label_ext, dy, dx, p1, st);
}
