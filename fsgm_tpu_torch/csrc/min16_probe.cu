// min16_probe: an elementwise int16 minimum in four formulations, and the
// int32 minimum beside them, each held to torch.minimum and timed.
//
// Replaces the TPU probe tools/tr_int16_probe.py::_min_matrix, which asks
// whether Mosaic legalises an int16 min of two (64, 256) arrays written as
// arith.minsi, as a select, or widened to int32.  On Hopper the question
// becomes whether int16 S could halve K2's bytes and double its min
// throughput (two 16-bit lanes per 32-bit register):
//
//   minsi   the 16-bit PTX min (min.s16)
//   select  a < b ? a : b on int16 values
//   widen   min of the values widened to int32, narrowed back
//   packed  __vmins2: two int16 minima per 32-bit word (SIMD within a
//           register)
//   int32   min of int32 arrays, the baseline
//
// Bound: device-memory bytes (two inputs read, one output written).
// Design: every form moves 16 bytes a thread a step: a thread loads one
// 16-byte vector of each input (8 int16 values, four packed words or four
// int32 values), applies its formulation to each element and stores one
// 16-byte vector.  A block takes tiles of kUnroll * kThreads consecutive
// vectors (thread t: vectors t, t + kThreads, ...), issues all of a tile's
// loads before its first minimum, so kUnroll 16-byte loads of each input
// are in flight a thread, and strides over the tiles by the grid.  The grid
// comes from the occupancy API (csrc/persistent.cuh): at most kWaves times
// the blocks the card holds at once, the tiles spread evenly over them.
// Many short-lived blocks stream faster on the H100 than one resident wave
// that loops (PERF.md, Findings).  The units (int16 values; packed words;
// int32 values) before the first 16-byte boundary of `a` (the head) and
// after the last one (the tail) are done one unit a thread.  The vector body needs b
// and out at the same offset from a 16-byte boundary as a (ops/kernels/
// probe.py places out so); where b is not, every unit is done one at a
// time.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "persistent.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVector = 16;  // bytes a thread moves a step
constexpr int kUnroll = 4;   // vectors a thread a tile
constexpr int kWaves = 32;   // the grid's blocks, at most, per resident wave
enum Form { kMinsi = 0, kSelect = 1, kWiden = 2, kPacked = 3, kInt32 = 4 };

// the unit of a form: one int16 value, one packed word of two, one int32
template <int FORM> struct Unit { using T = int16_t; };
template <> struct Unit<kPacked> { using T = unsigned; };
template <> struct Unit<kInt32> { using T = int; };

template <int FORM>
__device__ __forceinline__ int16_t min16(int16_t x, int16_t y) {
  int16_t r;
  if (FORM == kMinsi) {
    asm("min.s16 %0, %1, %2;" : "=h"(r) : "h"(x), "h"(y));
  } else if (FORM == kSelect) {
    r = x < y ? x : y;
  } else {
    r = (int16_t)min((int)x, (int)y);
  }
  return r;
}

// one unit
template <int FORM>
__device__ __forceinline__ typename Unit<FORM>::T op(
    typename Unit<FORM>::T x, typename Unit<FORM>::T y) {
  if constexpr (FORM == kPacked) return __vmins2(x, y);
  else if constexpr (FORM == kInt32) return min(x, y);
  else return min16<FORM>(x, y);
}

// one 32-bit word of a vector: two int16 values, one packed word or one
// int32 value
template <int FORM>
__device__ __forceinline__ unsigned op_word(unsigned x, unsigned y) {
  if constexpr (FORM == kPacked) {
    return __vmins2(x, y);
  } else if constexpr (FORM == kInt32) {
    return (unsigned)min((int)x, (int)y);
  } else {
    const int16_t lo = min16<FORM>((int16_t)(x & 0xffffu),
                                   (int16_t)(y & 0xffffu));
    const int16_t hi = min16<FORM>((int16_t)(x >> 16), (int16_t)(y >> 16));
    return (unsigned)(uint16_t)lo | ((unsigned)(uint16_t)hi << 16);
  }
}

template <int FORM>
__global__ void __launch_bounds__(kThreads)
min_kernel(const typename Unit<FORM>::T* __restrict__ a,
           const typename Unit<FORM>::T* __restrict__ b,
           typename Unit<FORM>::T* __restrict__ o, long long n,
           long long head, long long nvec) {
  using T = typename Unit<FORM>::T;
  constexpr int VU = kVector / (int)sizeof(T);  // units of a vector
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long tail0 = head + nvec * VU;
  for (long long i = tid; i < head; i += step) o[i] = op<FORM>(a[i], b[i]);
  for (long long i = tail0 + tid; i < n; i += step)
    o[i] = op<FORM>(a[i], b[i]);
  const uint4* av = reinterpret_cast<const uint4*>(a + head);
  const uint4* bv = reinterpret_cast<const uint4*>(b + head);
  uint4* ov = reinterpret_cast<uint4*>(o + head);
  constexpr int TILE = kUnroll * kThreads;
  for (long long base = (long long)blockIdx.x * TILE + threadIdx.x;
       base < nvec; base += (long long)gridDim.x * TILE) {
    uint4 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = base + u * kThreads;
      if (v < nvec) {
        x[u] = __ldg(av + v);
        y[u] = __ldg(bv + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = base + u * kThreads;
      if (v < nvec)
        ov[v] = make_uint4(op_word<FORM>(x[u].x, y[u].x),
                           op_word<FORM>(x[u].y, y[u].y),
                           op_word<FORM>(x[u].z, y[u].z),
                           op_word<FORM>(x[u].w, y[u].w));
    }
  }
}

// n units of a, b, out: the vector body where b and out sit at a's offset
// from a 16-byte boundary, the head and tail one unit a thread
template <int FORM>
int launch(const void* a, const void* b, void* out, long long n,
           cudaStream_t st) {
  using T = typename Unit<FORM>::T;
  constexpr int VU = kVector / (int)sizeof(T);
  static std::atomic<long long> cache{0};
  const uintptr_t pa = (uintptr_t)a, pb = (uintptr_t)b, po = (uintptr_t)out;
  if ((pa | pb | po) % sizeof(T)) return (int)cudaErrorInvalidValue;
  long long head = n, nvec = 0;
  if ((pb - pa) % kVector == 0 && (po - pa) % kVector == 0) {
    head = (long long)((kVector - pa % kVector) % kVector / sizeof(T));
    if (head > n) head = n;
    nvec = (n - head) / VU;
  }
  auto kernel = min_kernel<FORM>;
  long long blocks = 0;
  cudaError_t e = fsgm_persistent::resident_blocks(kernel, kThreads, 0,
                                                   cache, &blocks);
  if (e != cudaSuccess) return (int)e;
  // blocks wanted: one a tile, or enough for the scalar units; at most
  // kWaves resident waves, the tiles spread evenly over the blocks
  constexpr long long TILE = kUnroll * kThreads;
  const long long tiles = (nvec + TILE - 1) / TILE;
  const long long scalar = (n - nvec * VU + kThreads - 1) / kThreads;
  long long want = tiles > scalar ? tiles : (scalar > 0 ? scalar : 1);
  const long long per_block = (want + blocks * kWaves - 1) / (blocks * kWaves);
  want = (want + per_block - 1) / per_block;
  kernel<<<(unsigned)want, kThreads, 0, st>>>((const T*)a, (const T*)b,
                                              (T*)out, n, head, nvec);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: n int16 values (form 0-3; n even for packed, 4-byte aligned)
// or n int32 values (form 4).
extern "C" int fsgm_min16_probe(const void* a, const void* b, void* out,
                                long long n, int form, void* stream) {
  if (n < 0 || (form == kPacked && n % 2 != 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case kMinsi: return launch<kMinsi>(a, b, out, n, st);
    case kSelect: return launch<kSelect>(a, b, out, n, st);
    case kWiden: return launch<kWiden>(a, b, out, n, st);
    case kPacked: return launch<kPacked>(a, b, out, n / 2, st);
    case kInt32: return launch<kInt32>(a, b, out, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
