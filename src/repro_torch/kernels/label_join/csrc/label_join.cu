// Fused gather + 2-hop label join for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   src/repro/kernels/label_join/kernel.py::join_pallas    (_join_kernel)
//   src/repro/kernels/label_join/kernel.py::join_lb_pallas (_join_lb_kernel)
// and also the `table[rs]` / `table[rt]` gathers that the JAX serving
// paths run in XLA before calling them, so no (Q, W) copy of the gathered
// rows is ever written to device memory.
//
// For query i:  a_j = widen(s_table[rs[i], j]),  b_j = widen(t_table[rt[i], j])
//   out[i] = min_j (a_j + b_j)                       (Definition 1, λ)
//   lb[i]  = min_j a_j + min_j b_j                   (Definition 5, WITH_LB)
// widen() is the identity for float storage; for uint16 / int16 codes it
// maps the sentinel to +inf and any other code to its exact float value,
// and the result is then multiplied once by `scale` — the same arithmetic
// as the JAX package's quantized join, so answers match it bit for bit:
// min is exact and order-free, a + b is one IEEE float add, codes < 2^16
// and their sums are exact in float, and `* scale` is one float multiply.
// Built without fast-math and with -fmad=false so nothing is contracted.
//
// What bounds it: memory. Each query reads 2·W elements and does one add
// and one min on each (plus two mins with WITH_LB) — far below the card's
// operations-per-byte balance point.
//
// Design: one warp per query. Lanes stride over the W label slots, so a
// warp reads each row in contiguous 32-element runs; each lane keeps a
// running min in registers, then a __shfl_xor_sync butterfly reduces the
// 32 partial mins and lane 0 writes the result. No shared memory and no
// cross-block state. A row id outside its table yields +inf instead of a
// fault (the Python wrapper rejects such ids before launching).
// Later work: 16-byte vector loads, cp.async/TMA staging, a persistent grid.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;               // 8 queries per block

__device__ __forceinline__ float widen(float v, int) { return v; }

__device__ __forceinline__ float widen(uint16_t v, int sentinel) {
  return v == static_cast<uint16_t>(sentinel) ? __int_as_float(0x7f800000)
                                              : static_cast<float>(v);
}

__device__ __forceinline__ float widen(int16_t v, int sentinel) {
  return v == static_cast<int16_t>(sentinel) ? __int_as_float(0x7f800000)
                                             : static_cast<float>(v);
}

template <typename T, bool WITH_LB>
__global__ void __launch_bounds__(kThreads)
gather_join_kernel(const T* __restrict__ s_table,
                   const int64_t* __restrict__ rs, int64_t s_rows,
                   const T* __restrict__ t_table,
                   const int64_t* __restrict__ rt, int64_t t_rows,
                   int64_t q, int64_t w, int sentinel, float scale,
                   float* __restrict__ out, float* __restrict__ lb) {
  const int64_t query =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (query >= q) return;                   // uniform across the warp
  const float inf = __int_as_float(0x7f800000);
  float acc = inf, smin = inf, tmin = inf;
  const int64_t r_s = rs[query];
  const int64_t r_t = rt[query];
  if (r_s >= 0 && r_s < s_rows && r_t >= 0 && r_t < t_rows) {
    const T* srow = s_table + r_s * w;
    const T* trow = t_table + r_t * w;
    for (int64_t j = lane; j < w; j += kWarp) {
      const float a = widen(srow[j], sentinel);
      const float b = widen(trow[j], sentinel);
      acc = fminf(acc, a + b);
      if (WITH_LB) {
        smin = fminf(smin, a);
        tmin = fminf(tmin, b);
      }
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    acc = fminf(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (WITH_LB) {
      smin = fminf(smin, __shfl_xor_sync(0xffffffffu, smin, off));
      tmin = fminf(tmin, __shfl_xor_sync(0xffffffffu, tmin, off));
    }
  }
  if (lane == 0) {
    constexpr bool kCodes = !std::is_same<T, float>::value;
    out[query] = kCodes ? acc * scale : acc;
    if (WITH_LB) lb[query] = kCodes ? (smin + tmin) * scale : smin + tmin;
  }
}

template <typename T, bool WITH_LB>
cudaError_t launch(const void* s_table, const int64_t* rs, int64_t s_rows,
                   const void* t_table, const int64_t* rt, int64_t t_rows,
                   int64_t q, int64_t w, int sentinel, float scale,
                   float* out, float* lb, cudaStream_t stream) {
  const int64_t queries_per_block = kThreads / kWarp;
  const int64_t blocks = (q + queries_per_block - 1) / queries_per_block;
  gather_join_kernel<T, WITH_LB><<<static_cast<unsigned>(blocks), kThreads,
                                   0, stream>>>(
      static_cast<const T*>(s_table), rs, s_rows,
      static_cast<const T*>(t_table), rt, t_rows, q, w, sentinel, scale,
      out, lb);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   dtype: 0 = float32, 1 = uint16 codes, 2 = int16 codes
//   with_lb: nonzero also writes lb (float32 storage only)
// Returns the cudaError_t of the launch (0 = launched). q must be > 0.
extern "C" int repro_label_join(int dtype, int with_lb,
                                const void* s_table, const void* rs,
                                int64_t s_rows, const void* t_table,
                                const void* rt, int64_t t_rows, int64_t q,
                                int64_t w, int sentinel, float scale,
                                void* out, void* lb, void* stream) {
  if (q <= 0 || w < 0 || q > 8LL * 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto* rs_ = static_cast<const int64_t*>(rs);
  const auto* rt_ = static_cast<const int64_t*>(rt);
  auto* out_ = static_cast<float*>(out);
  auto* lb_ = static_cast<float*>(lb);
  auto st = static_cast<cudaStream_t>(stream);
  if (with_lb) {
    if (dtype != 0) return cudaErrorInvalidValue;
    return launch<float, true>(s_table, rs_, s_rows, t_table, rt_, t_rows, q,
                               w, sentinel, scale, out_, lb_, st);
  }
  switch (dtype) {
    case 0:
      return launch<float, false>(s_table, rs_, s_rows, t_table, rt_, t_rows,
                                  q, w, sentinel, scale, out_, lb_, st);
    case 1:
      return launch<uint16_t, false>(s_table, rs_, s_rows, t_table, rt_,
                                     t_rows, q, w, sentinel, scale, out_, lb_,
                                     st);
    case 2:
      return launch<int16_t, false>(s_table, rs_, s_rows, t_table, rt_,
                                    t_rows, q, w, sentinel, scale, out_, lb_,
                                    st);
    default:
      return cudaErrorInvalidValue;
  }
}
