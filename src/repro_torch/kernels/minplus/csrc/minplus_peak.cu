// The sustained (min, +) term rate of the card, in registers on all SMs:
// the ceiling of the operations bound of the min-plus kernels
// (minplus.cu, floyd_warshall.cu), measured rather than assumed.
//
// Each thread keeps three rows of 16 non-negative floats in registers
// and folds two (min, +) terms into one of them per step, each row fed
// by the other two, so nothing is loop-invariant and 16 updates of a row
// are independent. The 32 sums of a row's update are 32 distinct pairs
// (x[i] + y[i + 1] and x[i + 1] + y[i + 3]), so the compiler can share
// none of them: every term costs its own FADD, as in the kernels. Two
// term forms, as the kernels can write them:
//   form 0  acc = fminf(fminf(acc, x0 + y0), x1 + y1)   2 FADD + 2 FMNMX
//   form 1  acc = vimin3(acc, x0 + y0, x1 + y1) on the int32 patterns
//           (Hopper's DPX three-way minimum)              2 FADD + 1 VIMNMX3
// 96 terms per thread per iteration. Not a port of a TPU kernel: it only
// measures the card.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWidth = 16;              // floats per register row

template <int kForm>
__device__ __forceinline__ float term2(float acc, float x0, float y0,
                                       float x1, float y1) {
  if constexpr (kForm == 1) {
    return __int_as_float(__vimin3_s32(__float_as_int(acc),
                                       __float_as_int(x0 + y0),
                                       __float_as_int(x1 + y1)));
  } else {
    return fminf(fminf(acc, x0 + y0), x1 + y1);
  }
}

template <int kForm>
__global__ void __launch_bounds__(kThreads)
minplus_peak(float* __restrict__ out, int iters) {
  float a[kWidth], b[kWidth], c[kWidth];
  const float base = 1.0f + 1e-3f * threadIdx.x + blockIdx.x;
#pragma unroll
  for (int i = 0; i < kWidth; ++i) {
    a[i] = base + i;
    b[i] = 2.0f * base + i;
    c[i] = 3.0f * base + i;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kWidth; ++i)
      c[i] = term2<kForm>(c[i], a[i], b[(i + 1) % kWidth],
                          a[(i + 1) % kWidth], b[(i + 3) % kWidth]);
#pragma unroll
    for (int i = 0; i < kWidth; ++i)
      a[i] = term2<kForm>(a[i], b[i], c[(i + 1) % kWidth],
                          b[(i + 1) % kWidth], c[(i + 3) % kWidth]);
#pragma unroll
    for (int i = 0; i < kWidth; ++i)
      b[i] = term2<kForm>(b[i], c[i], a[(i + 1) % kWidth],
                          c[(i + 1) % kWidth], a[(i + 3) % kWidth]);
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s += a[i] + b[i] + c[i];
  out[static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x] = s;
}

}  // namespace

// Terms per thread per iteration of repro_minplus_peak.
extern "C" int repro_minplus_peak_terms() { return 3 * kWidth * 2; }

// `blocks` blocks of 256 threads, `iters` iterations each, in term form
// `form` (0 or 1); out holds blocks * 256 floats. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int repro_minplus_peak(void* out, int form, int blocks,
                                  int iters, void* stream) {
  if (blocks <= 0 || iters <= 0 || form < 0 || form > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (form == 1)
    minplus_peak<1><<<blocks, kThreads, 0, s>>>(o, iters);
  else
    minplus_peak<0><<<blocks, kThreads, 0, s>>>(o, iters);
  return cudaGetLastError();
}
