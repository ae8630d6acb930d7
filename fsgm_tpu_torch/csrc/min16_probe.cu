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
//           register), one thread per word
//   int32   min of int32 arrays, the baseline
//
// Bound: device-memory bytes (two inputs read, one output written).  One
// thread per element (per word for packed), a grid-stride loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
enum Form { kMinsi = 0, kSelect = 1, kWiden = 2, kPacked = 3, kInt32 = 4 };

template <int FORM>
__global__ void __launch_bounds__(kThreads)
min16_kernel(const int16_t* __restrict__ a, const int16_t* __restrict__ b,
             int16_t* __restrict__ o, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int16_t x = a[i], y = b[i];
    int16_t r;
    if (FORM == kMinsi) {
      asm("min.s16 %0, %1, %2;" : "=h"(r) : "h"(x), "h"(y));
    } else if (FORM == kSelect) {
      r = x < y ? x : y;
    } else {
      r = (int16_t)min((int)x, (int)y);
    }
    o[i] = r;
  }
}

__global__ void __launch_bounds__(kThreads)
min_packed_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
                  unsigned* __restrict__ o, long long n_words) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_words; i += step)
    o[i] = __vmins2(a[i], b[i]);
}

__global__ void __launch_bounds__(kThreads)
min32_kernel(const int* __restrict__ a, const int* __restrict__ b,
             int* __restrict__ o, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step)
    o[i] = min(a[i], b[i]);
}

unsigned blocks_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return (unsigned)(want < (1LL << 20) ? (want > 0 ? want : 1) : (1LL << 20));
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
  const int16_t* a16 = (const int16_t*)a;
  const int16_t* b16 = (const int16_t*)b;
  int16_t* o16 = (int16_t*)out;
  switch (form) {
    case kMinsi:
      min16_kernel<kMinsi><<<blocks_for(n), kThreads, 0, st>>>(a16, b16, o16, n);
      break;
    case kSelect:
      min16_kernel<kSelect><<<blocks_for(n), kThreads, 0, st>>>(a16, b16, o16, n);
      break;
    case kWiden:
      min16_kernel<kWiden><<<blocks_for(n), kThreads, 0, st>>>(a16, b16, o16, n);
      break;
    case kPacked:
      min_packed_kernel<<<blocks_for(n / 2), kThreads, 0, st>>>(
          (const unsigned*)a, (const unsigned*)b, (unsigned*)out, n / 2);
      break;
    case kInt32:
      min32_kernel<<<blocks_for(n), kThreads, 0, st>>>(
          (const int*)a, (const int*)b, (int*)out, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
