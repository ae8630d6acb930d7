// The card's peak rates of the operations that SGM's label rule is made
// of, as benchmark/work/<kind>.py counts them: one operation is one add or
// one min on one label.  Each kernel runs a long loop of one instruction
// form over kAcc accumulators a thread, each step reading two others, with
// every SM full (2048 threads); the host times each launch with CUDA events
// and keeps the fastest of kRepeats.  Thread-steps an SM and clock near 64
// show a form running on all of an SM's 64 INT32 lanes.  FP32 FMA (2
// operations) runs as a point of comparison only: this loop, one FFMA of
// three registers a step, reaches about 79 of the 128 FP32 lanes an SM and
// clock on an H100, well short of the data sheet's 67 TFLOP/s.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o peak_ops peak_ops.cu
//   ./peak_ops [iterations [highest SM clock in MHz]]
//
// prints one line a form: its name, operations a step, operations a second
// and thread-steps an SM and clock (at the card's highest SM clock).

#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>

namespace {

constexpr int kAcc = 8;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kRepeats = 5;

#define CHECK(x)                                                        \
  do {                                                                  \
    cudaError_t e_ = (x);                                               \
    if (e_ != cudaSuccess) {                                            \
      std::fprintf(stderr, "%s: %s\n", #x, cudaGetErrorString(e_));     \
      std::exit(1);                                                     \
    }                                                                   \
  } while (0)

enum Form { kAddMin32, kMin3U16x2, kAddMinU16x2, kMinU16x2, kAddU16x2,
            kFma32, kForms };
const char* kNames[kForms] = {"int32 add+min", "__vimin3_u16x2",
                              "__viaddmin_u16x2", "__vminu2", "__vadd2",
                              "fp32 fma"};
const int kOps[kForms] = {2, 4, 4, 2, 2, 2};

template <int F>
__device__ __forceinline__ unsigned step(unsigned a, unsigned b, unsigned c) {
  if constexpr (F == kAddMin32) return min(a + b, c);
  if constexpr (F == kMin3U16x2) return __vimin3_u16x2(a, b, c);
  if constexpr (F == kAddMinU16x2) return __viaddmin_u16x2(a, b, c);
  if constexpr (F == kMinU16x2) return __vminu2(a, b);
  if constexpr (F == kAddU16x2) return __vadd2(a, b);
  if constexpr (F == kFma32)
    return __float_as_uint(fmaf(__uint_as_float(a), __uint_as_float(b),
                                __uint_as_float(c)));
  return 0;
}

template <int F>
__global__ void spin(const unsigned* in, unsigned* out, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned v[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) v[j] = in[(t * kAcc + j) & 4095];
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
      v[j] = step<F>(v[j], v[(j + 1) % kAcc], v[(j + 2) % kAcc]);
  }
  unsigned r = 0;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) r ^= v[j];
  out[t] = r;
}

template <int F>
float best_ms(const unsigned* in, unsigned* out, int blocks, int iters) {
  cudaEvent_t a, b;
  CHECK(cudaEventCreate(&a));
  CHECK(cudaEventCreate(&b));
  spin<F><<<blocks, kThreads>>>(in, out, iters);  // load and warm up
  CHECK(cudaGetLastError());
  float best = 1e30f;
  for (int r = 0; r < kRepeats; ++r) {
    CHECK(cudaEventRecord(a));
    spin<F><<<blocks, kThreads>>>(in, out, iters);
    CHECK(cudaEventRecord(b));
    CHECK(cudaEventSynchronize(b));
    float ms = 0.f;
    CHECK(cudaEventElapsedTime(&ms, a, b));
    if (ms < best) best = ms;
  }
  CHECK(cudaEventDestroy(a));
  CHECK(cudaEventDestroy(b));
  return best;
}

template <int F>
void report(const unsigned* in, unsigned* out, int blocks, int iters,
            int sms, double clock_hz) {
  const double ms = best_ms<F>(in, out, blocks, iters);
  const double steps = double(blocks) * kThreads * iters * kAcc;
  const double s = ms * 1e-3;
  std::printf("%-18s ops/step %d  ops/s %.6e  thread-steps/SM/clock %.3f"
              "  (%.4f ms)\n", kNames[F], kOps[F], steps * kOps[F] / s,
              steps / (s * sms * clock_hz), ms);
}

}  // namespace

int main(int argc, char** argv) {
  const int iters = argc > 1 ? std::atoi(argv[1]) : 20000;
  int dev = 0, sms = 0, khz = argc > 2 ? std::atoi(argv[2]) * 1000 : 0;
  CHECK(cudaGetDevice(&dev));
  CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (khz == 0)
    CHECK(cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev));
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, dev));
  const int blocks = sms * kBlocksPerSm;
  unsigned host[4096];
  for (int i = 0; i < 4096; ++i)  // 16-bit halves and floats in (0.5, 1)
    host[i] = (i & 1) ? 0x3f000000u + (i * 2654435761u >> 9)
                      : (i * 2654435761u) & 0x3fff3fffu;
  unsigned *in = nullptr, *out = nullptr;
  CHECK(cudaMalloc(&in, sizeof(host)));
  CHECK(cudaMalloc(&out, sizeof(unsigned) * blocks * kThreads));
  CHECK(cudaMemcpy(in, host, sizeof(host), cudaMemcpyHostToDevice));
  std::printf("%s: %d SMs, highest SM clock %.0f MHz, %d blocks of %d, "
              "%d iterations of %d steps\n", prop.name, sms, khz * 1e-3,
              blocks, kThreads, iters, kAcc);
  const double hz = khz * 1e3;
  report<kAddMin32>(in, out, blocks, iters, sms, hz);
  report<kMin3U16x2>(in, out, blocks, iters, sms, hz);
  report<kAddMinU16x2>(in, out, blocks, iters, sms, hz);
  report<kMinU16x2>(in, out, blocks, iters, sms, hz);
  report<kAddU16x2>(in, out, blocks, iters, sms, hz);
  report<kFma32>(in, out, blocks, iters, sms, hz);
  CHECK(cudaFree(in));
  CHECK(cudaFree(out));
  return 0;
}
