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
// What bounds it on an H100.  Each path line is a serial chain: a step
// needs the L of the step before.  One warp walks one line (after libSGM,
// arXiv 1610.04121) and holds the pixel's D labels in registers, K = D/32
// consecutive labels a lane; m is one __reduce_min_sync, the 1D neighbours
// across lanes one __shfl_up_sync / __shfl_down_sync each, and L never
// leaves the SM along the line.  A step's arithmetic is a few dozen
// dependent instructions, far less than one round trip to device memory,
// and one direction has few lines (a KITTI frame: 375 horizontal, at most
// 1,616 vertical) against the tens of warps an SM holds.  So a walk that
// waits for each step's loads is latency-bound (loading one step ahead
// gives about 0.5 us a step), and only with many lines does the card fill
// and the bytes set the pace: per pixel and direction, D cost bytes read
// and D S values read and written.  With the design below, a KITTI
// frame's vertical directions (one launch each: 1,242 to 1,616 lines of
// 375 steps) move their bytes at about half the card's peak rate, its
// horizontal ones (375 lines of 1,242 steps) stay bound by the step's
// instructions, about 0.19 us a step, and 16 frames come within 25 % of
// the bytes' time (PERF.md).  The design answers each limit:
//
//  * Latency: a ring of N steps in shared memory for each warp
//    (sgm_walk.cuh).  The warp's lanes copy the cost row and the S row of
//    step t + N - 1 with cp.async (16-byte pieces, one commit group a
//    step) while step t computes, and cp.async.wait_group N - 1 makes step
//    t's group visible.  P2' arrives 32 steps at a time, one 4-byte copy a
//    lane into a double buffer, a block ahead (a 4-byte copy every step
//    stalls the walk).  N is the largest power
//    of two from 4 up to 16 whose slots (D cost bytes + D S values) fit
//    11 KB a warp: 16 for D = 128 with int16 S, 8 for D = 256 with int32
//    S; four warps a block then use at most 47 KB of static shared memory.
//    The copies of the steps past the end of a line are never issued (an
//    empty group is committed instead), so a line shorter than the ring (a
//    diagonal's corner, H = 1, W = 1, knight lines) reads nothing beyond
//    the image.
//  * Instructions and bytes per instruction: each lane reads its K cost
//    bytes and K S values from the slot, and stores its K S values, as
//    whole 4-, 8- or 16-byte words; with int16 S and K even the labels
//    are carried packed, two unsigned 16-bit labels a register, and the
//    minima are Hopper's DPX instructions: min(L, N + P1, m + P2') is one
//    __viaddmin_u16x2 (the two neighbours, + P1) and one __vimin3_u16x2,
//    C - m one 32-bit add and subtract.  Neighbours cross the pair by
//    __byte_perm, the lanes by a shuffle of the packed word, or for the 2D
//    rule the warp's row of the previous L in shared memory.  An absent
//    neighbour and a pad slot hold kSentinel = 0x8000.  The halves never
//    carry or borrow into each other while every value stays in [0,
//    0xffff]: best >= m, L = C + (best - m) <= 255 + P2', m + P2' <= 255 +
//    2 P2' and N + P1 <= kSentinel + P1.  So the wrapper takes packed
//    labels only for int16 S, K even, 0 <= P1 <= 0xffff - kSentinel and a
//    stated bound p2_max on the P2' table with 255 + 2 p2_max <=
//    kSentinel (ops/kernels/aggregate.py::packed16, the predicate); a
//    carry is shifted by its own minimum first (L does not change when
//    prev is shifted) and held at kSentinel above it.  Everything else
//    (int32 S, K odd: D = 32, flow's 96 slots; no bound given) runs the
//    int32 instantiation of the same walk.
//  * Each step takes m (the warp reduction) and the neighbour minimum of
//    the previous step's L before it waits for its own slot, so that the
//    reduction and the shuffles overlap the wait and the slot's reads.
//  * Launch: the wrapper reads the resident warps of the instantiation it
//    would launch (fsgm_sgm_sweep_occupancy: cudaOccupancyMaxActiveBlocks-
//    PerMultiprocessor times the SMs) to choose between one launch per
//    direction and the family launch below.
//
// Lines start at every pixel whose predecessor p - r is outside the image
// (the first |dy| rows in scan order, then the first |dx| columns), which
// covers the 8 paths and the knight directions (|dy| = 2 steps two rows
// back) alike.  The per-direction launches of one frame run in order on
// one stream, so their read-modify-write of S needs no atomics; within a
// launch the lines partition the pixels, so no S row that the ring
// prefetches is written before it is read.  Batch: one launch per direction
// covers B frames; the global line index gives the frame and the frame's
// own line, every pixel offset is the frame's 64-bit base plus y * W + x,
// and a walk stops at its own frame's edge.  cost and S must be aligned to
// 16 bytes (the wrapper checks it).
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
//
// Family launch (fsgm_sgm_sweep_family; replaces the TPU kernels fsgm_tpu/
// ops/pallas/aggregate_tr.py::tr_dual_family_sweep, both families of a
// direction group in one launch, and tools/trexp.py::tr_row_family_sweep,
// the down family added into a given S).  One launch walks the lines of up
// to 16 directions of all B frames, S += sum_r L_r, each direction with its
// own P2' table, through the same walk.  The global line index is split by
// direction first (the lines of direction j follow those of j - 1), then
// by frame and line as above.  Warps of different directions add into the
// same S cells at the same time, so every S update is an atomic add: int32
// S by atomicAdd, int16 S by a 32-bit atomicAdd on the aligned word that
// holds two S values (packed: the lane's packed word as it is).  That is
// exact while every S value stays in [0, 2^15): each L is non-negative
// and, for int16 S, plan_dtypes bounds the full sum by s_max < 2^15, so no
// carry crosses from one half into the other.  Integer addition commutes,
// so any order of the adds gives the same S bit for bit.  A fresh S is
// zeroed on the stream first.  No carry: the tiled paths keep the
// per-direction launches.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "sgm_walk.cuh"

namespace {

using namespace fsgm_k2;

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

// Calls f.run<K, ST, MODE, LABEL2D, PACKED>() for the runtime choice; a
// choice with no instantiation (packed labels with int32 S or K odd, K
// outside 1..8) gives cudaErrorInvalidValue.
template <int K, typename ST, int MODE, bool L2D, bool PACKED, class F>
int run_if(F& f) {
  if constexpr (PACKED && (K % 2 != 0 || sizeof(ST) != 2))
    return (int)cudaErrorInvalidValue;
  else
    return f.template run<K, ST, MODE, L2D, PACKED>();
}

template <typename ST, int MODE, bool L2D, bool PACKED, class F>
int by_k(int k, F& f) {
  switch (k) {
    case 1: return run_if<1, ST, MODE, L2D, PACKED>(f);
    case 2: return run_if<2, ST, MODE, L2D, PACKED>(f);
    case 3: return run_if<3, ST, MODE, L2D, PACKED>(f);
    case 4: return run_if<4, ST, MODE, L2D, PACKED>(f);
    case 5: return run_if<5, ST, MODE, L2D, PACKED>(f);
    case 6: return run_if<6, ST, MODE, L2D, PACKED>(f);
    case 7: return run_if<7, ST, MODE, L2D, PACKED>(f);
    case 8: return run_if<8, ST, MODE, L2D, PACKED>(f);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int MODE, class F>
int dispatch(int k, int s_int32, int label2d, int packed, F& f) {
  if (s_int32) {
    if (packed) return (int)cudaErrorInvalidValue;
    return label2d ? by_k<int32_t, MODE, true, false>(k, f)
                   : by_k<int32_t, MODE, false, false>(k, f);
  }
  if (packed)
    return label2d ? by_k<int16_t, MODE, true, true>(k, f)
                   : by_k<int16_t, MODE, false, true>(k, f);
  return label2d ? by_k<int16_t, MODE, true, false>(k, f)
                 : by_k<int16_t, MODE, false, false>(k, f);
}

// one direction of B frames
struct SweepLaunch {
  const void *cost, *p2e;
  void* s;
  const void* cin;
  void* cout;
  int b, h, w, nl, ext, dy, dx, p1;
  cudaStream_t stream;

  template <int K, typename ST, int MODE, bool L2D, bool PACKED>
  int run() {
    const Lines ln = lines_of(h, w, dy, dx);
    const long long n_lines = (long long)b * ln.per_frame;
    const long long blocks = (n_lines + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return (int)cudaSuccess;
    sgm_sweep_kernel<K, ST, MODE, L2D, PACKED>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            (const uint8_t*)cost, (const int*)p2e, (ST*)s, (const int*)cin,
            (int*)cout, h, w, nl, ext, dy, dx, p1, ln.n_row_starts,
            ln.rows_rem, ln.per_frame, n_lines);
    return (int)cudaGetLastError();
  }
};

// the directions of one family launch
struct FamilyLaunch {
  const void *cost, *p2e;
  void* s;
  int h, w, nl, ext, p1;
  long long plane;
  const Family* fam;
  cudaStream_t stream;

  template <int K, typename ST, int MODE, bool L2D, bool PACKED>
  int run() {
    const long long blocks = (fam->first[fam->n] + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return (int)cudaSuccess;
    sgm_family_kernel<K, ST, L2D, PACKED>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            (const uint8_t*)cost, (const int*)p2e, (ST*)s, h, w, nl, ext, p1,
            plane, *fam);
    return (int)cudaGetLastError();
  }
};

// resident warps of one SM for an instantiation
struct Occupancy {
  int* warps;

  template <int K, typename ST, int MODE, bool L2D, bool PACKED>
  int run() {
    int blocks = 0;
    cudaError_t e;
    if constexpr (MODE == kAtomic)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sgm_family_kernel<K, ST, L2D, PACKED>, kThreads, 0);
    else
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sgm_sweep_kernel<K, ST, MODE, L2D, PACKED>, kThreads, 0);
    *warps = blocks * kWarps;
    return (int)e;
  }
};

}  // namespace

// cost (B, H, W, D) u8, p2e (B, H, W) int32 P2' of this direction, s
// (B, H, W, D) int16 (s_int32 = 0) or int32; D a multiple of 32 up to 256,
// of which the first nl slots are labels; cost and s aligned to 16 bytes.
// label_ext = 0: 1D labels; e >= 1: the e x e label grid (nl = e * e).
// packed = 1: packed 16-bit labels (int16 S, D/32 even; the caller
// guarantees the predicate of the header comment).  carry_in, carry_out:
// null, or (B, 2, W, D) int32 for dy != 0 (carry_out written in full when
// H >= 2; with H = 1 the caller fills its row 1).  One launch covers the B
// frames: B times each frame's lines.
extern "C" int fsgm_sgm_sweep(const void* cost, const void* p2e, void* s,
                              const void* carry_in, void* carry_out,
                              int s_int32, int fresh, int packed, int b,
                              int h, int w, int nd, int nl, int label_ext,
                              int dy, int dx, int p1, void* stream) {
  if (nd % 32 != 0 || nl < 1 || nl > nd || label_ext < 0)
    return (int)cudaErrorInvalidValue;
  if (dy == 0 && (carry_in != nullptr || carry_out != nullptr))
    return (int)cudaErrorInvalidValue;
  SweepLaunch f{cost, p2e, s, carry_in, carry_out, b, h, w, nl,
                label_ext, dy, dx, p1, (cudaStream_t)stream};
  const int k = nd / 32, label2d = label_ext > 0;
  return fresh ? dispatch<kFresh>(k, s_int32, label2d, packed, f)
               : dispatch<kAccum>(k, s_int32, label2d, packed, f);
}

// cost (B, H, W, D) u8; p2e (n_dirs, B, H, W) int32, table j for direction
// j; s (B, H, W, D) int16 (s_int32 = 0) or int32, S += sum_j L_j by atomic
// adds (fresh = 1: S is zeroed first on the stream), int16 S values staying
// in [0, 2^15); dirs: n_dirs (dy, dx) pairs in host memory, 1 <= n_dirs <=
// 16, |dy|, |dx| <= 2.  D, nl, label_ext and packed as for fsgm_sgm_sweep.
// One launch covers every line of every direction of the B frames.
extern "C" int fsgm_sgm_sweep_family(const void* cost, const void* p2e,
                                     void* s, int s_int32, int fresh,
                                     int packed, int b, int h, int w, int nd,
                                     int nl, int label_ext, int n_dirs,
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
  FamilyLaunch f{cost, p2e, s, h, w, nl, label_ext, p1, plane, &fam, st};
  return dispatch<kAtomic>(nd / 32, s_int32, label_ext > 0, packed, f);
}

// *warps = the warps of one kernel instantiation that one SM of the
// current device holds at once: mode 0 the fresh sweep, 1 the
// read-modify-write sweep, 2 the family launch; the other arguments as for
// fsgm_sgm_sweep.
extern "C" int fsgm_sgm_sweep_occupancy(int s_int32, int mode, int label2d,
                                        int packed, int nd, int* warps) {
  if (nd % 32 != 0 || nd < 32 || nd > 256 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  Occupancy f{warps};
  const int k = nd / 32;
  switch (mode) {
    case kFresh: return dispatch<kFresh>(k, s_int32, label2d, packed, f);
    case kAccum: return dispatch<kAccum>(k, s_int32, label2d, packed, f);
    default: return dispatch<kAtomic>(k, s_int32, label2d, packed, f);
  }
}
