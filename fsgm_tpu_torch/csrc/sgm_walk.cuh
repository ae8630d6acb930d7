// K2's walk along one SGM path line, shared by the per-direction kernel,
// the family kernel and the carry path (csrc/sgm_sweep.cu says what the
// kernel computes and why it is built this way).
//
// One warp walks one line.  Lane `lane` owns the K = D/32 consecutive label
// slots d0 = lane*K .. d0+K-1.  Per step the warp needs the pixel's D cost
// bytes, (read-modify-write only) its D S values and its P2'; these arrive
// through a ring of N slots in shared memory, filled by cp.async N-1 steps
// ahead of the step that reads them (fetch, cp_wait).  The labels are
// carried either as int32 (one register a label) or, where the packed
// predicate holds (sgm_sweep.cu), as unsigned 16-bit pairs, two labels a
// register, with an absent neighbour held at kSentinel; the minima are
// Hopper's DPX instructions (__vimin3_u16x2, __viaddmin_u16x2).

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace fsgm_k2 {

constexpr int kInf = 1 << 30;          // int32 labels: an absent neighbour
constexpr unsigned kSentinel = 0x8000u;  // packed labels: an absent label
constexpr unsigned kSentinel2 = kSentinel * 0x10001u;  // in both halves
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;          // four path lines per block
constexpr int kWarps = kThreads / 32;
constexpr int kRingBudget = 11264;     // ring bytes of one warp, at most
constexpr int kMaxRing = 16;           // steps of one ring, at most

// how a sweep writes S: S = L (fresh), S += L by a plain read-modify-write
// (one direction per launch), or S += L by atomic adds (family launch)
enum Write { kFresh = 0, kAccum = 1, kAtomic = 2 };

// Steps of the ring for K labels a lane and S elements of sb bytes: the
// most (a power of two, from 4 up to kMaxRing) whose slots with an S row
// fit kRingBudget.  Mirrored by ops/kernels/aggregate.py::ring_plan.
__host__ __device__ constexpr int ring_steps(int k, int sb) {
  int n = kMaxRing;
  while (n > 4 && n * 32 * k * (1 + sb) > kRingBudget) n /= 2;
  return n;
}

// One ring slot: the cost row and the S row (read-modify-write only).
__host__ __device__ constexpr int slot_bytes(int k, int sb, int mode) {
  return 32 * k * (1 + (mode == kAccum ? sb : 0));
}

// ------------------------------------------------------------ cp.async

using fsgm_cp::cp_async16;
using fsgm_cp::cp_async4;
using fsgm_cp::cp_commit;
using fsgm_cp::cp_wait;

// Copy step data of pixel `pix` into `slot`: the cost row and the S row in
// 16-byte pieces spread over the warp's lanes.
template <int K, typename ST, int MODE>
__device__ __forceinline__ void fetch(const uint8_t* cost, const ST* s,
                                      long long pix, uint8_t* slot,
                                      int lane) {
  constexpr int ND = 32 * K;
  constexpr int NC = ND / 16;
  constexpr int NS = MODE == kAccum ? ND * (int)sizeof(ST) / 16 : 0;
  const uint8_t* cp = cost + pix * ND;
  const uint8_t* sp = reinterpret_cast<const uint8_t*>(s + pix * ND);
#pragma unroll
  for (int r = 0; r < (NC + NS + 31) / 32; ++r) {
    const int i = lane + 32 * r;  // piece i lands at slot + 16 i
    if (i < NC + NS)
      cp_async16(slot + 16 * i, i < NC ? cp + 16 * i : sp + 16 * (i - NC));
  }
}

// ------------------------------------------------ vector reads and writes

// BYTES (a multiple of 4) bytes at p, which is aligned to the largest
// power of two up to 16 that divides BYTES, as 32-bit words
template <int BYTES>
__device__ __forceinline__ void read_words(const void* p,
                                           unsigned (&w)[BYTES / 4]) {
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int q = 0; q < BYTES / 16; ++q) {
      const uint4 v = static_cast<const uint4*>(p)[q];
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else if constexpr (BYTES % 8 == 0) {
#pragma unroll
    for (int q = 0; q < BYTES / 8; ++q) {
      const uint2 v = static_cast<const uint2*>(p)[q];
      w[2 * q] = v.x; w[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < BYTES / 4; ++q)
      w[q] = static_cast<const unsigned*>(p)[q];
  }
}

template <int BYTES>
__device__ __forceinline__ void write_words(void* p,
                                            const unsigned (&w)[BYTES / 4]) {
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int q = 0; q < BYTES / 16; ++q)
      static_cast<uint4*>(p)[q] =
          make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  } else if constexpr (BYTES % 8 == 0) {
#pragma unroll
    for (int q = 0; q < BYTES / 8; ++q)
      static_cast<uint2*>(p)[q] = make_uint2(w[2 * q], w[2 * q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < BYTES / 4; ++q) static_cast<unsigned*>(p)[q] = w[q];
  }
}

// the lane's K cost bytes at p (p = slot + lane * K)
template <int K>
__device__ __forceinline__ void read_cost(const uint8_t* p, int (&c)[K]) {
  if constexpr (K % 4 == 0) {
    unsigned w[K / 4];
    read_words<K>(p, w);
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = (w[k / 4] >> (8 * (k % 4))) & 0xff;
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int q = 0; q < K / 2; ++q) {
      const unsigned v = reinterpret_cast<const uint16_t*>(p)[q];
      c[2 * q] = v & 0xff;
      c[2 * q + 1] = v >> 8;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = p[k];
  }
}

// the lane's K S values at p, widened to int32
template <int K, typename ST>
__device__ __forceinline__ void read_s(const ST* p, int (&v)[K]) {
  if constexpr (sizeof(ST) == 4) {
    unsigned w[K];
    read_words<4 * K>(p, w);
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = (int)w[k];
  } else if constexpr (K % 2 == 0) {
    unsigned w[K / 2];
    read_words<2 * K>(p, w);
#pragma unroll
    for (int q = 0; q < K / 2; ++q) {
      v[2 * q] = (int16_t)(w[q] & 0xffffu);
      v[2 * q + 1] = (int16_t)(w[q] >> 16);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = p[k];
  }
}

// the lane's K S values (int32, narrowed to ST) to p
template <int K, typename ST>
__device__ __forceinline__ void write_s(ST* p, const int (&v)[K]) {
  if constexpr (sizeof(ST) == 4) {
    unsigned w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = (unsigned)v[k];
    write_words<4 * K>(p, w);
  } else if constexpr (K % 2 == 0) {
    unsigned w[K / 2];
#pragma unroll
    for (int q = 0; q < K / 2; ++q)
      w[q] = ((unsigned)v[2 * q] & 0xffffu) | ((unsigned)v[2 * q + 1] << 16);
    write_words<2 * K>(p, w);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) p[k] = (ST)v[k];
  }
}

// S[d0 + k] += L[k] for the real labels, by atomic adds (family launch):
// int32 by atomicAdd, int16 by a 32-bit atomicAdd on the aligned word that
// holds two S values (exact while every S value stays in [0, 2^15))
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

// ------------------------------------------------------------- packed

// labels o and o + 1 of a packed row (32-bit words, nw of them) as one
// packed word; a half outside the row is garbage, which the caller masks
__device__ __forceinline__ unsigned pair_at(const unsigned* row, int o,
                                            int nw) {
  if ((o & 1) == 0) return row[min(max(o >> 1, 0), nw - 1)];
  const int i0 = min(max((o - 1) >> 1, 0), nw - 1);
  const int i1 = min(max((o + 1) >> 1, 0), nw - 1);
  return __byte_perm(row[i0], row[i1], 0x5432);
}

__device__ __forceinline__ unsigned half_mask(bool lo, bool hi) {
  return (lo ? 0xffffu : 0u) | (hi ? 0xffff0000u : 0u);
}

// x with kSentinel in the halves where mask is 0xffff
__device__ __forceinline__ unsigned sentinel_at(unsigned x, unsigned mask) {
  return (x & ~mask) | (mask & kSentinel2);
}

// ------------------------------------------------------------ the line

struct Line {
  int y, x;       // first pixel
  int start_row;  // the scan row i < |dy| where the line starts, else -1
  int steps;      // pixels on the line
};

// Line `line` of direction (dy, dx) in an H x W frame: the first
// n_row_starts lines start in the first |dy| scan rows, the others in the
// first |dx| columns of the remaining rows_rem rows.
__device__ __forceinline__ Line line_of(int h, int w, int dy, int dx,
                                        int n_row_starts, int rows_rem,
                                        int line) {
  Line ln;
  ln.start_row = -1;
  if (line < n_row_starts) {
    ln.start_row = line / w;
    ln.x = line % w;
    ln.y = dy > 0 ? ln.start_row : h - 1 - ln.start_row;
  } else {
    const int g = line - n_row_starts;
    const int j = g / rows_rem;
    ln.x = dx > 0 ? j : w - 1 - j;
    ln.y = (dy > 0 ? dy : 0) + g % rows_rem;
  }
  int n = 0x7fffffff;
  if (dy > 0) n = min(n, (h - 1 - ln.y) / dy + 1);
  if (dy < 0) n = min(n, ln.y / -dy + 1);
  if (dx > 0) n = min(n, (w - 1 - ln.x) / dx + 1);
  if (dx < 0) n = min(n, ln.x / -dx + 1);
  ln.steps = n;
  return ln;
}

// Walk one path line of direction (dy, dx) in frame `frame` (sgm_sweep.cu
// gives the recurrence).  `ring` is the warp's N * SLOT bytes of shared
// memory; `row` (LABEL2D) its D labels of the previous step, int32 or
// packed.  The carry pointers are null or (B, 2, W, D) int32.  Each step
// first takes what needs only the previous step's L (m and the neighbour
// minimum: the warp reduction, the shuffles or the row), then waits for
// its own slot, so that the reduction's latency overlaps the wait.
template <int K, typename ST, int MODE, bool LABEL2D, bool PACKED>
__device__ __forceinline__ void walk(
    const uint8_t* __restrict__ cost, const int* __restrict__ p2e,
    ST* __restrict__ s, const int* __restrict__ carry_in,
    int* __restrict__ carry_out, uint8_t* ring, int* p2buf, void* row,
    int h, int w,
    int nl, int ext, int dy, int dx, int p1, int n_row_starts, int rows_rem,
    long long frame, int line) {
  static_assert(!PACKED || (K % 2 == 0 && sizeof(ST) == 2),
                "packed labels need int16 S and an even K");
  constexpr int ND = 32 * K;
  constexpr int SB = (int)sizeof(ST);
  constexpr int N = ring_steps(K, SB);
  constexpr int SLOT = slot_bytes(K, SB, MODE);
  constexpr int KP = PACKED ? K / 2 : K;  // registers of the lane's labels
  const int lane = threadIdx.x & 31;
  const int d0 = lane * K;
  const Line ln = line_of(h, w, dy, dx, n_row_starts, rows_rem, line);
  const long long pix0 = frame * h * w + (long long)ln.y * w + ln.x;
  const long long dpix = (long long)dy * w + dx;

  // P2' of steps 32 b .. 32 b + 31 goes to p2buf[32 (b % 2) ..], one
  // 4-byte copy a lane, in the group of step 32 (b - 1) (blocks 0 and 1 in
  // step 0's group): a 4-byte cp.async every step would stall the walk
  auto p2_block = [&](int b) {
    const int i = 32 * b + lane;
    if (i < ln.steps)
      cp_async4(p2buf + 32 * (b % 2) + lane, p2e + pix0 + i * dpix);
  };
  // steps 0 .. N-2 in flight before the first step is read
  p2_block(0);
  p2_block(1);
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
    if (i < ln.steps)
      fetch<K, ST, MODE>(cost, s, pix0 + i * dpix, ring + i * SLOT, lane);
    cp_commit();
  }

  // which of the lane's labels are real (slots past nl take part in
  // nothing) and, for the 2D rule, which neighbours exist
  bool real[K], has_l[K], has_r[K], has_u[K], has_d[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + k;
    real[k] = d < nl;
    has_l[k] = has_r[k] = has_u[k] = has_d[k] = false;
    if (LABEL2D) {
      const int u = d % ext;
      has_l[k] = u != 0;
      has_r[k] = u != ext - 1 && d + 1 < nl;
      has_u[k] = d >= ext;
      has_d[k] = d + ext < nl;
    }
  }
  // packed: 0xffff in the halves of pad slots (pad) and of absent
  // neighbours (the 2D rule's four directions), which take kSentinel
  unsigned pad[KP], no_l[KP], no_r[KP], no_u[KP], no_d[KP];
  if constexpr (PACKED) {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      pad[j] = half_mask(!real[2 * j], !real[2 * j + 1]);
      no_l[j] = half_mask(!has_l[2 * j], !has_l[2 * j + 1]);
      no_r[j] = half_mask(!has_r[2 * j], !has_r[2 * j + 1]);
      no_u[j] = half_mask(!has_u[2 * j], !has_u[2 * j + 1]);
      no_d[j] = half_mask(!has_d[2 * j], !has_d[2 * j + 1]);
    }
  }

  using V = std::conditional_t<PACKED, unsigned, int>;
  V prev[KP];
  bool first = true;
  const int ady = dy < 0 ? -dy : dy;
  if (carry_in != nullptr && ln.start_row >= 0 && ln.x - dx >= 0 &&
      ln.x - dx < w) {
    // continue the scan from the previous tile: its L is this line's prev
    const int* cp = carry_in +
        ((frame * 2 + (ady - 1 - ln.start_row)) * w + (ln.x - dx)) * ND + d0;
    int cv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) cv[k] = real[k] ? cp[k] : kInf;
    if constexpr (PACKED) {
      // L is the same for prev and prev - min(prev): shift the carry to a
      // minimum of 0; a value of kSentinel or more can never win a min, so
      // it is held at kSentinel like an absent label
      int mloc = cv[0];
#pragma unroll
      for (int k = 1; k < K; ++k) mloc = min(mloc, cv[k]);
      const int m = __reduce_min_sync(kFull, mloc);
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const unsigned lo = (unsigned)min(cv[2 * j] - m, (int)kSentinel);
        const unsigned hi = (unsigned)min(cv[2 * j + 1] - m, (int)kSentinel);
        prev[j] = lo | (hi << 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) prev[k] = cv[k];
    }
    first = false;
  }
  const unsigned p1p = PACKED ? (unsigned)p1 * 0x10001u : 0u;


  for (int t = 0; t < ln.steps; ++t) {
    // m and N + P1 of the previous step's L (nothing at a line's start)
    V m = 0, nbp[KP];
    if (!first) {
      if constexpr (PACKED) {
        unsigned mw = prev[0];
#pragma unroll
        for (int j = 1; j < KP; ++j) mw = __vminu2(mw, prev[j]);
        m = __reduce_min_sync(kFull, min(mw & 0xffffu, mw >> 16));
        if constexpr (LABEL2D) {
          unsigned* rw = static_cast<unsigned*>(row);
#pragma unroll
          for (int j = 0; j < KP; ++j) rw[d0 / 2 + j] = prev[j];
          __syncwarp();
#pragma unroll
          for (int j = 0; j < KP; ++j) {
            const int d = d0 + 2 * j;
            constexpr int NW = ND / 2;  // words of the row
            const unsigned a = sentinel_at(pair_at(rw, d - 1, NW), no_l[j]);
            const unsigned b = sentinel_at(pair_at(rw, d + 1, NW), no_r[j]);
            const unsigned u = sentinel_at(pair_at(rw, d - ext, NW), no_u[j]);
            const unsigned v = sentinel_at(pair_at(rw, d + ext, NW), no_d[j]);
            nbp[j] = __vminu2(__vimin3_u16x2(a, b, u), v) + p1p;
          }
        } else {
          // labels d0-2, d0-1 of the lane before, d0+K, d0+K+1 after
          unsigned left = __shfl_up_sync(kFull, prev[KP - 1], 1);
          unsigned right = __shfl_down_sync(kFull, prev[0], 1);
          if (lane == 0) left = kSentinel2;
          if (lane == 31) right = kSentinel2;
#pragma unroll
          for (int j = 0; j < KP; ++j) {
            const unsigned lo =
                __byte_perm(j == 0 ? left : prev[j - 1], prev[j], 0x5432);
            const unsigned hi =
                __byte_perm(prev[j], j == KP - 1 ? right : prev[j + 1],
                            0x5432);
            nbp[j] = __viaddmin_u16x2(lo, p1p, hi + p1p);  // pads: kSentinel
          }
        }
      } else {
        int mloc = prev[0];
#pragma unroll
        for (int k = 1; k < K; ++k) mloc = min(mloc, prev[k]);
        m = __reduce_min_sync(kFull, mloc);
        if constexpr (LABEL2D) {
          int* rw = static_cast<int*>(row);
#pragma unroll
          for (int k = 0; k < K; ++k) rw[d0 + k] = prev[k];
          __syncwarp();
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int d = d0 + k;
            int v = kInf;
            if (has_l[k]) v = min(v, rw[d - 1]);
            if (has_r[k]) v = min(v, rw[d + 1]);
            if (has_u[k]) v = min(v, rw[d - ext]);
            if (has_d[k]) v = min(v, rw[d + ext]);
            nbp[k] = v + p1;
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
            nbp[k] = min(lo, hi) + p1;  // slots past nl hold kInf
          }
        }
      }
    }

    // the copy of step t + N - 1 takes the slot of step t - 1
    __syncwarp();  // every lane has read the slot of step t - 1
    if (t % 32 == 0 && t > 0) p2_block(t / 32 + 1);  // block t/32 - 1 read
    if (t + N - 1 < ln.steps)
      fetch<K, ST, MODE>(cost, s, pix0 + (t + N - 1) * dpix,
                         ring + ((t + N - 1) % N) * SLOT, lane);
    cp_commit();
    cp_wait<N - 1>();  // step t has landed
    __syncwarp();
    // P2', the lane's cost bytes and S values (read-modify-write) of step t
    const int p2v = p2buf[t % 64];
    const uint8_t* slot = ring + (t % N) * SLOT;
    int c[K];
    read_cost<K>(slot + d0, c);
    unsigned sw[PACKED ? KP : 1];
    int sv[PACKED ? 1 : K];
    if constexpr (MODE == kAccum) {
      if constexpr (PACKED)
        read_words<2 * K>(slot + ND + 2 * d0, sw);
      else
        read_s<K, ST>(reinterpret_cast<const ST*>(slot + ND) + d0, sv);
    }
    const long long pix = pix0 + t * dpix;
    ST* sp = s + pix * ND + d0;

    V l[KP];
    if constexpr (PACKED) {
      const unsigned mm = m * 0x10001u;
      const unsigned mp = mm + (unsigned)p2v * 0x10001u;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const unsigned cw =
            (unsigned)c[2 * j] | ((unsigned)c[2 * j + 1] << 16);
        // no half carries or borrows: best >= m and best - m + C stays
        // below kSentinel (the predicate)
        l[j] = sentinel_at(
            first ? cw : __vimin3_u16x2(prev[j], nbp[j], mp) + cw - mm,
            pad[j]);
      }
      unsigned out[KP];  // L with 0 in the pad slots
#pragma unroll
      for (int j = 0; j < KP; ++j) out[j] = l[j] & ~pad[j];
      if constexpr (MODE == kAtomic) {
#pragma unroll
        for (int j = 0; j < KP; ++j)
          if (out[j]) atomicAdd(reinterpret_cast<unsigned*>(sp) + j, out[j]);
      } else {
        if constexpr (MODE == kAccum) {
#pragma unroll
          for (int j = 0; j < KP; ++j) out[j] = __vadd2(sw[j], out[j]);
        }
        write_words<2 * K>(sp, out);
      }
    } else {
      const int mp = m + p2v;
#pragma unroll
      for (int k = 0; k < K; ++k)
        l[k] = !real[k] ? kInf
             : first    ? c[k]
                        : c[k] + min(min(prev[k], nbp[k]), mp) - m;
      if constexpr (MODE == kAtomic) {
        atomic_add_row<K>(sp, l, real);
      } else {
        int out[K];
#pragma unroll
        for (int k = 0; k < K; ++k) out[k] = real[k] ? l[k] : 0;
        if constexpr (MODE == kAccum) {
#pragma unroll
          for (int k = 0; k < K; ++k) out[k] += sv[k];
        }
        write_s<K, ST>(sp, out);
      }
    }

    const int y = ln.y + t * dy;
    const int back = dy > 0 ? h - 1 - y : y;  // scan rows left after this
    if (carry_out != nullptr && back <= 1) {
      int* co = carry_out +
          ((frame * 2 + back) * w + (ln.x + t * dx)) * ND + d0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        int v;
        if constexpr (PACKED)
          v = (int)((l[k / 2] & ~pad[k / 2]) >> (16 * (k % 2)) & 0xffffu);
        else
          v = real[k] ? l[k] : 0;
        co[k] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < KP; ++j) prev[j] = l[j];
    first = false;
  }
}

// One launch: one direction of B frames, one warp a line.
template <int K, typename ST, int MODE, bool LABEL2D, bool PACKED>
__global__ void __launch_bounds__(kThreads)
sgm_sweep_kernel(const uint8_t* __restrict__ cost, const int* __restrict__ p2e,
                 ST* __restrict__ s, const int* __restrict__ carry_in,
                 int* __restrict__ carry_out, int h, int w, int nl, int ext,
                 int dy, int dx, int p1, int n_row_starts, int rows_rem,
                 int per_frame, long long n_lines) {
  constexpr int RING = ring_steps(K, sizeof(ST)) *
                       slot_bytes(K, sizeof(ST), MODE);
  using R = std::conditional_t<PACKED, uint16_t, int>;
  __shared__ __align__(16) uint8_t ring[kWarps][RING];
  __shared__ int p2buf[kWarps][64];
  __shared__ __align__(16)
      R prev_row[LABEL2D ? kWarps : 1][LABEL2D ? 32 * K : 2];
  const int warp = threadIdx.x >> 5;
  const long long gline = (long long)blockIdx.x * kWarps + warp;
  if (gline >= n_lines) return;  // uniform over the warp
  const long long frame = gline / per_frame;
  const int line = (int)(gline - frame * per_frame);
  walk<K, ST, MODE, LABEL2D, PACKED>(
      cost, p2e, s, carry_in, carry_out, ring[warp], p2buf[warp],
      prev_row[LABEL2D ? warp : 0], h, w, nl, ext, dy, dx, p1, n_row_starts,
      rows_rem, frame, line);
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

// One launch: up to 16 directions of B frames, S += sum_r L_r by atomics.
template <int K, typename ST, bool LABEL2D, bool PACKED>
__global__ void __launch_bounds__(kThreads)
sgm_family_kernel(const uint8_t* __restrict__ cost,
                  const int* __restrict__ p2e, ST* __restrict__ s, int h,
                  int w, int nl, int ext, int p1, long long plane,
                  const Family fam) {
  constexpr int RING = ring_steps(K, sizeof(ST)) *
                       slot_bytes(K, sizeof(ST), kAtomic);
  using R = std::conditional_t<PACKED, uint16_t, int>;
  __shared__ __align__(16) uint8_t ring[kWarps][RING];
  __shared__ int p2buf[kWarps][64];
  __shared__ __align__(16)
      R prev_row[LABEL2D ? kWarps : 1][LABEL2D ? 32 * K : 2];
  const int warp = threadIdx.x >> 5;
  const long long gline = (long long)blockIdx.x * kWarps + warp;
  if (gline >= fam.first[fam.n]) return;  // uniform over the warp
  int j = 0;
  while (gline >= fam.first[j + 1]) ++j;
  const long long local = gline - fam.first[j];
  const long long frame = local / fam.per_frame[j];
  const int line = (int)(local - frame * fam.per_frame[j]);
  walk<K, ST, kAtomic, LABEL2D, PACKED>(
      cost, p2e + j * plane, s, nullptr, nullptr, ring[warp], p2buf[warp],
      prev_row[LABEL2D ? warp : 0], h, w, nl, ext, fam.dy[j], fam.dx[j], p1,
      fam.n_row_starts[j], fam.rows_rem[j], frame, line);
}

}  // namespace fsgm_k2
