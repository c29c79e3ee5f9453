// Blocked Floyd-Warshall APSP for Hopper (sm_90a), in place on one dense
// (n, n) float32 distance matrix.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/sssp_relax/kernel.py::floyd_warshall_pallas
//   (_phase1_kernel, _phase2_row_kernel, _phase2_col_kernel,
//    _phase3_kernel)
//
// Input: d = min(adj, diag 0), non-negative distances or +inf (never NaN
// or -inf). For each pivot block kb of kTile vertices, three launches:
//   phase 1  one block closes the pivot tile (kb, kb) in shared memory,
//            one barrier per in-tile pivot k;
//   phase 2  the pivot block-row tiles (kb, j) and block-column tiles
//            (i, kb), j, i != kb, each relaxed against the closed pivot
//            by one order-free min-plus product: row = min(row, P (x) row),
//            col = min(col, col (x) P);
//   phase 3  every other tile (i, j), i, j != kb: d = min(d, col (x) row).
// repro_floyd_warshall enqueues all 3 * ceil(n / kTile) launches on one
// stream, so a call costs one host round trip.
//
// Races, and why there are none:
//   * phase 1 updates the pivot tile in place. At in-tile step k, row k
//     and column k never change (d[k][k] is 0 or +inf and weights are
//     non-negative, so d[i][k] + d[k][k] >= d[i][k]); the kernel skips
//     writing them, so every read of row k / column k at step k sees a
//     value no thread writes during that step;
//   * phase 2 reads the pivot tile and writes only tiles of the pivot
//     row and column, never the pivot tile; each block reads its own tile
//     into shared memory before it writes it;
//   * phase 3 reads the pivot row and column tiles and writes only tiles
//     outside them (the TPU kernel computes those stale and overwrites
//     them afterwards; here they are never written).
//
// Ragged n: loads outside [0, n) read +inf and are never stored, which
// is the +inf padding of the TPU wrapper (padded vertices have a +inf
// diagonal there too), so no padded copy is made.
//
// Every term is one IEEE add and fminf (built with -fmad=false, no
// fast-math). The blocked order associates path sums differently from
// the rank-1 loop of the plain version, so the two agree bit for bit
// when every path sum is exact in float32 (integral weights, as in every
// synthetic_continent district) and within float32 rounding otherwise.
//
// Bound: operations. n^3 (min, +) terms at 2 instructions each on the
// FP32 lanes; the bytes (the matrix read and written once) are ~1/150 of
// that at n = 6400. Design: 64 x 64 tiles, 256 threads, each thread a
// 4 x 4 register tile at a stride of 16 rows and columns (as minplus.cu:
// one shared load per two terms, conflict-free); the two operand tiles
// of a product (2 x 16.6 KB) sit in static shared memory, so no opt-in
// to dynamic shared memory is needed. Phase 3 streams the matrix once
// per pivot block (n / 64 passes). Later work: a deeper register tile,
// fusing phase 1 and 2 into phase 3's launch, and keeping tiles in L2
// across pivots.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                 // tile edge (pivot block size)
constexpr int kSide = 16;                 // threads per tile edge
constexpr int kReg = kTile / kSide;       // 4 x 4 entries per thread
constexpr int kThreads = kSide * kSide;   // 256
constexpr int kPad = kTile + 1;           // shared row pitch

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// t[r][c] = d[row0 + r, col0 + c], +inf outside the matrix
__device__ __forceinline__ void load_tile(float (*t)[kPad],
                                          const float* __restrict__ d,
                                          int64_t n, int64_t row0,
                                          int64_t col0) {
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile, c = idx % kTile;
    const int64_t gr = row0 + r, gc = col0 + c;
    t[r][c] = (gr < n && gc < n) ? d[gr * n + gc] : inf_f();
  }
}

// acc[i][j] = d[row0 + ty + 16 i, col0 + tx + 16 j] (+inf outside)
__device__ __forceinline__ void load_acc(float (&acc)[kReg][kReg],
                                         const float* __restrict__ d,
                                         int64_t n, int64_t row0,
                                         int64_t col0) {
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
#pragma unroll
  for (int i = 0; i < kReg; ++i)
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int64_t gr = row0 + ty + i * kSide, gc = col0 + tx + j * kSide;
      acc[i][j] = (gr < n && gc < n) ? d[gr * n + gc] : inf_f();
    }
}

__device__ __forceinline__ void store_acc(const float (&acc)[kReg][kReg],
                                          float* __restrict__ d, int64_t n,
                                          int64_t row0, int64_t col0) {
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int64_t gr = row0 + ty + i * kSide;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int64_t gc = col0 + tx + j * kSide;
      if (gc < n) d[gr * n + gc] = acc[i][j];
    }
  }
}

// acc = min(acc, a (x) b) over the tile, a and b in shared memory
__device__ __forceinline__ void minplus_acc(float (&acc)[kReg][kReg],
                                            float (*a)[kPad],
                                            float (*b)[kPad]) {
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float av[kReg], bv[kReg];
#pragma unroll
    for (int i = 0; i < kReg; ++i) av[i] = a[ty + i * kSide][k];
#pragma unroll
    for (int j = 0; j < kReg; ++j) bv[j] = b[k][tx + j * kSide];
#pragma unroll
    for (int i = 0; i < kReg; ++i)
#pragma unroll
      for (int j = 0; j < kReg; ++j)
        acc[i][j] = fminf(acc[i][j], av[i] + bv[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
fw_phase1(float* __restrict__ d, int64_t n, int64_t kb) {
  __shared__ float t[kTile][kPad];
  const int64_t p0 = kb * kTile;
  load_tile(t, d, n, p0, p0);
  __syncthreads();
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  for (int k = 0; k < kTile; ++k) {
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int r = ty + i * kSide;
      if (r == k) continue;
      const float dik = t[r][k];
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const int c = tx + j * kSide;
        if (c != k) t[r][c] = fminf(t[r][c], dik + t[k][c]);
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile, c = idx % kTile;
    const int64_t gr = p0 + r, gc = p0 + c;
    if (gr < n && gc < n) d[gr * n + gc] = t[r][c];
  }
}

// blockIdx.y == 0: the pivot row's tile (kb, blockIdx.x);
// blockIdx.y == 1: the pivot column's tile (blockIdx.x, kb)
__global__ void __launch_bounds__(kThreads)
fw_phase2(float* __restrict__ d, int64_t n, int64_t kb) {
  if (blockIdx.x == kb) return;           // the pivot tile: phase 1's
  __shared__ float p[kTile][kPad];
  __shared__ float t[kTile][kPad];
  const int64_t p0 = kb * kTile;
  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const bool row = blockIdx.y == 0;
  const int64_t r0 = row ? p0 : o0, c0 = row ? o0 : p0;
  load_tile(p, d, n, p0, p0);
  load_tile(t, d, n, r0, c0);
  __syncthreads();
  float acc[kReg][kReg];
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
#pragma unroll
  for (int i = 0; i < kReg; ++i)
#pragma unroll
    for (int j = 0; j < kReg; ++j)
      acc[i][j] = t[ty + i * kSide][tx + j * kSide];
  if (row)
    minplus_acc(acc, p, t);               // row = min(row, P (x) row)
  else
    minplus_acc(acc, t, p);               // col = min(col, col (x) P)
  store_acc(acc, d, n, r0, c0);
}

// tile (blockIdx.y, blockIdx.x) = min(itself, col (x) row)
__global__ void __launch_bounds__(kThreads)
fw_phase3(float* __restrict__ d, int64_t n, int64_t kb) {
  if (blockIdx.x == kb || blockIdx.y == kb) return;   // phase 2's tiles
  __shared__ float col[kTile][kPad];
  __shared__ float row[kTile][kPad];
  const int64_t p0 = kb * kTile;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTile;
  load_tile(col, d, n, r0, p0);
  load_tile(row, d, n, p0, c0);
  float acc[kReg][kReg];
  load_acc(acc, d, n, r0, c0);
  __syncthreads();
  minplus_acc(acc, col, row);
  store_acc(acc, d, n, r0, c0);
}

}  // namespace

// Plain C entry point, loaded with ctypes. d is a contiguous (n, n)
// float32 matrix on the device holding min(adj, diag 0); it is closed in
// place. Enqueues 3 * ceil(n / 64) launches (1 when n <= 64) on `stream`
// and returns the first launch's cudaError_t that is not cudaSuccess
// (0 = all launched).
extern "C" int repro_floyd_warshall(void* d, int64_t n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const int64_t nb = (n + kTile - 1) / kTile;
  if (nb > 65535) return cudaErrorInvalidValue;
  float* m = static_cast<float*>(d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = static_cast<unsigned>(nb);
  for (int64_t kb = 0; kb < nb; ++kb) {
    fw_phase1<<<1, kThreads, 0, s>>>(m, n, kb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (nb == 1) break;
    fw_phase2<<<dim3(b, 2), kThreads, 0, s>>>(m, n, kb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fw_phase3<<<dim3(b, b), kThreads, 0, s>>>(m, n, kb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
