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
// (|dy| = 2 steps two rows back) alike.  The per-direction launches of one
// frame run in order on one stream, so their read-modify-write of S needs no
// atomics.  Batch: one launch per direction covers B frames; the
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
//
// Family launch (fsgm_sgm_sweep_family; replaces the TPU kernels fsgm_tpu/
// ops/pallas/aggregate_tr.py::tr_dual_family_sweep, both families of a
// direction group in one launch, and tools/trexp.py::tr_row_family_sweep,
// the down family added into a given S).  One launch walks the lines of up
// to 16 directions of all B frames, S += sum_r L_r, each direction with its
// own P2' table.  The global line index is split by direction first (the
// lines of direction j follow those of j - 1), then by frame and line as
// above.  Warps of different directions add into the same S cells at the
// same time, so every S update is an atomic add: int32 S by atomicAdd, int16
// S by a 32-bit atomicAdd on the aligned word that holds two S values (v, or
// v << 16 for the upper one; with K even, one add for a lane's two
// neighbouring labels).  That is exact while every S value stays in
// [0, 2^15): each L is non-negative and, for int16 S, plan_dtypes bounds
// the full sum by s_max < 2^15, so no carry crosses from one half into the
// other.  Integer addition commutes, so any order of the adds gives the same
// S bit for bit.  A fresh S is zeroed on the stream first.  No carry: the
// tiled paths keep the per-direction launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // four lines per block

// how a sweep writes S: S = L (fresh), S += L by a plain read-modify-write
// (one direction per launch), or S += L by atomic adds (family launch)
enum Write { kFresh = 0, kAccum = 1, kAtomic = 2 };

template <int K, typename ST, int MODE>
__device__ __forceinline__ void load_step(const uint8_t* __restrict__ cost,
                                          const int* __restrict__ p2e,
                                          const ST* __restrict__ s,
                                          long long pix, int d0, int (&c)[K],
                                          int (&sv)[K], int& p2v) {
  const uint8_t* cp = cost + pix * (32 * K) + d0;
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = cp[k];
  if (MODE == kAccum) {
    const ST* sp = s + pix * (32 * K) + d0;
#pragma unroll
    for (int k = 0; k < K; ++k) sv[k] = sp[k];
  }
  p2v = p2e[pix];
}

// S[d0 + k] += L[k] for the real labels, by atomic adds (module comment)
template <int K>
__device__ __forceinline__ void atomic_add_row(int32_t* sp, const int (&l)[K],
                                               const bool (&real)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (real[k]) atomicAdd(sp + k, l[k]);
}

template <int K>
__device__ __forceinline__ void atomic_add_row(int16_t* sp, const int (&l)[K],
                                               const bool (&real)[K]) {
  if constexpr (K % 2 == 0) {
    // d0 and k are even: S[d0 + k] and S[d0 + k + 1] share one word
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const unsigned lo = real[k] ? (unsigned)l[k] : 0u;
      const unsigned hi = real[k + 1] ? (unsigned)l[k + 1] : 0u;
      if (lo | hi) atomicAdd((unsigned*)(sp + k), lo | (hi << 16));
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!real[k] || l[k] == 0) continue;
      const uintptr_t a = (uintptr_t)(sp + k);
      atomicAdd((unsigned*)(a & ~(uintptr_t)3),
                (unsigned)l[k] << ((a & 2) * 8));
    }
  }
}

// Walk one path line of direction (dy, dx) in frame `frame`: `line` is the
// frame's line index (the first n_row_starts lines start in the first |dy|
// scan rows, the others in the first |dx| columns of the remaining
// rows_rem rows).  `row` is the warp's shared-memory row (LABEL2D).
template <int K, typename ST, int MODE, bool LABEL2D>
__device__ __forceinline__ void walk(const uint8_t* __restrict__ cost,
                                     const int* __restrict__ p2e,
                                     ST* __restrict__ s,
                                     const int* __restrict__ carry_in,
                                     int* __restrict__ carry_out, int* row,
                                     int h, int w, int nl, int ext, int dy,
                                     int dx, int p1, int n_row_starts,
                                     int rows_rem, long long frame, int line) {
  constexpr int ND = 32 * K;
  const int lane = threadIdx.x & 31;
  // the walk below stays inside [0, H) x [0, W) of its own frame, whose
  // first pixel is `base`
  const long long base = frame * h * w;
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
  load_step<K, ST, MODE>(cost, p2e, s, pix, d0, c, sv, p2v);
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
    if (more) load_step<K, ST, MODE>(cost, p2e, s, npix, d0, nc, nsv, np2);

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
    if (MODE == kAtomic) {
      atomic_add_row<K>(sp, l, real);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int add = real[k] ? l[k] : 0;
        sp[k] = (ST)(MODE == kFresh ? add : sv[k] + add);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) prev[k] = l[k];
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

template <int K, typename ST, int MODE, bool LABEL2D>
__global__ void __launch_bounds__(kThreads)
sgm_sweep_kernel(const uint8_t* __restrict__ cost, const int* __restrict__ p2e,
                 ST* __restrict__ s, const int* __restrict__ carry_in,
                 int* __restrict__ carry_out, int h, int w, int nl, int ext,
                 int dy, int dx, int p1, int n_row_starts, int rows_rem,
                 int per_frame, long long n_lines) {
  // LABEL2D: each warp's previous L row, read by label index
  __shared__ int prev_row[LABEL2D ? kThreads / 32 : 1][LABEL2D ? 32 * K : 1];
  const long long gline = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (gline >= n_lines) return;  // uniform over the warp
  const long long frame = gline / per_frame;
  const int line = (int)(gline - frame * per_frame);
  walk<K, ST, MODE, LABEL2D>(cost, p2e, s, carry_in, carry_out,
                             prev_row[LABEL2D ? (threadIdx.x >> 5) : 0], h, w,
                             nl, ext, dy, dx, p1, n_row_starts, rows_rem,
                             frame, line);
}

constexpr int kMaxDirs = 16;

// The directions of one family launch and where their lines start in the
// launch's global line index (first[n] = all lines of the launch).
struct Family {
  int n;
  int dy[kMaxDirs], dx[kMaxDirs];
  int n_row_starts[kMaxDirs], rows_rem[kMaxDirs], per_frame[kMaxDirs];
  long long first[kMaxDirs + 1];
};

template <int K, typename ST, bool LABEL2D>
__global__ void __launch_bounds__(kThreads)
sgm_family_kernel(const uint8_t* __restrict__ cost, const int* __restrict__ p2e,
                  ST* __restrict__ s, int h, int w, int nl, int ext, int p1,
                  long long plane, const Family fam) {
  __shared__ int prev_row[LABEL2D ? kThreads / 32 : 1][LABEL2D ? 32 * K : 1];
  const long long gline = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (gline >= fam.first[fam.n]) return;  // uniform over the warp
  int j = 0;
  while (gline >= fam.first[j + 1]) ++j;
  const long long local = gline - fam.first[j];
  const long long frame = local / fam.per_frame[j];
  const int line = (int)(local - frame * fam.per_frame[j]);
  walk<K, ST, kAtomic, LABEL2D>(cost, p2e + j * plane, s, nullptr, nullptr,
                                prev_row[LABEL2D ? (threadIdx.x >> 5) : 0], h,
                                w, nl, ext, fam.dy[j], fam.dx[j], p1,
                                fam.n_row_starts[j], fam.rows_rem[j], frame,
                                line);
}

// the lines of direction (dy, dx) in one H x W frame
struct Lines {
  int n_row_starts, rows_rem, per_frame;
};

Lines lines_of(int h, int w, int dy, int dx) {
  const int ady = dy < 0 ? -dy : dy, adx = dx < 0 ? -dx : dx;
  const int row_band = ady < h ? ady : h;
  Lines r;
  r.n_row_starts = row_band * w;
  r.rows_rem = h - row_band;
  r.per_frame = r.n_row_starts + r.rows_rem * (adx < w ? adx : w);
  return r;
}

template <int K, typename ST, int MODE, bool LABEL2D>
int launch(const void* cost, const void* p2e, void* s, const void* cin,
           void* cout, int b, int h, int w, int nl, int ext, int dy, int dx,
           int p1, cudaStream_t stream) {
  const Lines ln = lines_of(h, w, dy, dx);
  const long long n_lines = (long long)b * ln.per_frame;
  const int per_block = kThreads / 32;
  const long long blocks = (n_lines + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sgm_sweep_kernel<K, ST, MODE, LABEL2D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const uint8_t*)cost, (const int*)p2e, (ST*)s, (const int*)cin,
      (int*)cout, h, w, nl, ext, dy, dx, p1, ln.n_row_starts, ln.rows_rem,
      ln.per_frame, n_lines);
  return (int)cudaGetLastError();
}

template <typename ST, int MODE, bool LABEL2D>
int dispatch(int k, const void* cost, const void* p2e, void* s, const void* cin,
             void* cout, int b, int h, int w, int nl, int ext, int dy, int dx,
             int p1, cudaStream_t st) {
  switch (k) {
#define FSGM_CASE(KK)                                                         \
  case KK:                                                                    \
    return launch<KK, ST, MODE, LABEL2D>(cost, p2e, s, cin, cout, b, h, w,   \
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
    return fresh ? dispatch<ST, kFresh, true>(k, cost, p2e, s, cin, cout, b, h, w, nl, ext, dy, dx, p1, st)
                 : dispatch<ST, kAccum, true>(k, cost, p2e, s, cin, cout, b, h, w, nl, ext, dy, dx, p1, st);
  }
  return fresh ? dispatch<ST, kFresh, false>(k, cost, p2e, s, cin, cout, b, h, w, nl, ext, dy, dx, p1, st)
               : dispatch<ST, kAccum, false>(k, cost, p2e, s, cin, cout, b, h, w, nl, ext, dy, dx, p1, st);
}

template <int K, typename ST, bool LABEL2D>
int launch_family(const void* cost, const void* p2e, void* s, int h, int w,
                  int nl, int ext, int p1, long long plane, const Family& fam,
                  cudaStream_t stream) {
  const int per_block = kThreads / 32;
  const long long blocks = (fam.first[fam.n] + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  sgm_family_kernel<K, ST, LABEL2D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const uint8_t*)cost, (const int*)p2e, (ST*)s, h, w, nl, ext, p1, plane,
      fam);
  return (int)cudaGetLastError();
}

template <typename ST, bool LABEL2D>
int dispatch_family(int k, const void* cost, const void* p2e, void* s, int h,
                    int w, int nl, int ext, int p1, long long plane,
                    const Family& fam, cudaStream_t st) {
  switch (k) {
#define FSGM_CASE(KK)                                                         \
  case KK:                                                                    \
    return launch_family<KK, ST, LABEL2D>(cost, p2e, s, h, w, nl, ext, p1,   \
                                          plane, fam, st);
    FSGM_CASE(1) FSGM_CASE(2) FSGM_CASE(3) FSGM_CASE(4)
    FSGM_CASE(5) FSGM_CASE(6) FSGM_CASE(7) FSGM_CASE(8)
#undef FSGM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
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

// cost (B, H, W, D) u8; p2e (n_dirs, B, H, W) int32, table j for direction
// j; s (B, H, W, D) int16 (s_int32 = 0) or int32, S += sum_j L_j by atomic
// adds (fresh = 1: S is zeroed first on the stream), int16 S values staying
// in [0, 2^15); dirs: n_dirs (dy, dx) pairs in host memory, 1 <= n_dirs <=
// 16, |dy|, |dx| <= 2.  D, nl and label_ext as for fsgm_sgm_sweep.  One
// launch covers every line of every direction of the B frames.
extern "C" int fsgm_sgm_sweep_family(const void* cost, const void* p2e,
                                     void* s, int s_int32, int fresh, int b,
                                     int h, int w, int nd, int nl,
                                     int label_ext, int n_dirs,
                                     const int* dirs, int p1, void* stream) {
  if (nd % 32 != 0 || nd > 256 || nl < 1 || nl > nd || label_ext < 0 ||
      n_dirs < 1 || n_dirs > kMaxDirs || b < 0 || h < 0 || w < 0)
    return (int)cudaErrorInvalidValue;
  Family fam;
  fam.n = n_dirs;
  fam.first[0] = 0;
  for (int j = 0; j < n_dirs; ++j) {
    const int dy = dirs[2 * j], dx = dirs[2 * j + 1];
    if ((dy == 0 && dx == 0) || dy < -2 || dy > 2 || dx < -2 || dx > 2)
      return (int)cudaErrorInvalidValue;
    const Lines ln = lines_of(h, w, dy, dx);
    fam.dy[j] = dy;
    fam.dx[j] = dx;
    fam.n_row_starts[j] = ln.n_row_starts;
    fam.rows_rem[j] = ln.rows_rem;
    fam.per_frame[j] = ln.per_frame;
    fam.first[j + 1] = fam.first[j] + (long long)b * ln.per_frame;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const long long plane = (long long)b * h * w;
  if (fresh) {
    const size_t bytes = (size_t)plane * nd * (s_int32 ? 4 : 2);
    cudaError_t e = cudaMemsetAsync(s, 0, bytes, st);
    if (e != cudaSuccess) return (int)e;
  }
  const int k = nd / 32;
  if (s_int32) {
    return label_ext > 0
        ? dispatch_family<int32_t, true>(k, cost, p2e, s, h, w, nl, label_ext, p1, plane, fam, st)
        : dispatch_family<int32_t, false>(k, cost, p2e, s, h, w, nl, label_ext, p1, plane, fam, st);
  }
  return label_ext > 0
      ? dispatch_family<int16_t, true>(k, cost, p2e, s, h, w, nl, label_ext, p1, plane, fam, st)
      : dispatch_family<int16_t, false>(k, cost, p2e, s, h, w, nl, label_ext, p1, plane, fam, st);
}
