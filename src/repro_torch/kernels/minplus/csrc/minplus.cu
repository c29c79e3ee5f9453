// Min-plus (tropical) products for Hopper (sm_90a), batched over a
// leading district axis (blockIdx.z).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   src/repro/kernels/minplus/kernel.py::minplus_pallas (_minplus_kernel)
//   src/repro/kernels/minplus/kernel.py::relax_pallas   (_relax_kernel)
//
//   repro_minplus:  C[z,i,j] = min_k A[z,i,k] + B[z,k,j]
//   repro_relax:    D'[z,r,j] = min(D[z,r,j], min_k D[z,r,k] + A[z,k,j])
//
// Every term is one IEEE float add and the reduction is fminf, which is
// exact and order-free on the inputs these kernels take (non-negative
// distances and +inf; never NaN or -inf). So the result is bit for bit
// that of the plain versions and of the TPU kernels, whatever the tiling.
// Out-of-range loads read +inf, the semiring zero, in place of the TPU
// kernel's +inf padding to 128-blocks. Built with -fmad=false and no
// fast-math. Min-plus has no tensor-core form: FP32 CUDA cores only.
//
// minplus_tiled — the Border-Labeling builder's stage B (the (q, q)
// closure squarings) and stage C ((kmax, bmax) x (bmax, q) per district).
// Bound: operations at stage B (q^3 terms on 2 q^2 floats), bytes at
// stage C (k = bmax is tiny). Design: a 64 x 64 output tile per block of
// 256 threads, each thread a 4 x 4 register tile at a stride of 16 rows
// and columns (conflict-free shared reads, coalesced writes); 16-deep
// k-tiles of A and B staged through shared memory.
//
// relax_tiles — stage A, one Bellman-Ford sweep over every district at
// once: D is (S, V) with S = bmax (8) border rows, A the (V, V) dense
// adjacency. Bound: bytes — each A element feeds only S terms. What held
// the first design (one block per 128-column strip walking all V rows of
// it) at 2-50 % of its dense bound: 32 blocks at (16, 8, 256) and 50 at
// (1, 8, 6400) on 132 SMs, and every sweep reading the whole dense A,
// which for a grid district is > 99 % +inf. This design:
//   * A is cut into tiles of kKBlock = 32 k rows x kStrip = 128 columns.
//     A block owns one column strip (one thread per column, a register
//     tile of 8 D rows) and a run of consecutive k-tiles of it; the runs
//     split a strip's k range so that a launch has about 8 blocks per SM
//     (at least one k-tile each). Each k-tile's 8 x 32 D values sit
//     transposed in shared memory and are read as float4 broadcasts;
//     each thread issues its 32 A loads before it uses them (coalesced
//     512-byte rows);
//   * an optional occupancy map (kernel.relax_occupancy: one byte per
//     (column strip, k-tile), 1 where A holds a finite entry) is read
//     instead of the tile: a tile marked empty is never loaded, and
//     skipping its +inf terms leaves every minimum as it was;
//   * when a strip is split, the output is seeded with D (a device copy
//     in the same stream) and each block folds its partial minima in
//     with atomicMin on the int32 patterns — for non-negative floats and
//     +inf, IEEE order is the order of the int32 patterns (and -0.0, the
//     smallest pattern, is 0, the smallest value), so the result is
//     exact and order-free — and only where a partial beats D; an
//     unsplit strip stores min(D, partial) directly.
// The output is written out of place (Jacobi: D' never aliases D). The
// TPU kernel's 128-row blocks would pad S = 8 to 128: 16x the work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// ---- minplus_tiled ---------------------------------------------------------

constexpr int kTile = 64;      // output tile edge
constexpr int kDepth = 16;     // k-tile depth
constexpr int kSide = 16;      // threads per tile edge (16 x 16 = 256)
constexpr int kReg = kTile / kSide;  // 4 x 4 outputs per thread

__global__ void __launch_bounds__(kSide * kSide)
minplus_tiled(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, int64_t m, int64_t k, int64_t n) {
  __shared__ float as[kDepth][kTile + 1];   // as[kk][row], padded
  __shared__ float bs[kDepth][kTile];       // bs[kk][col]
  const int64_t z = blockIdx.z;
  a += z * m * k;
  b += z * k * n;
  c += z * m * n;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const float inf = inf_f();

  float acc[kReg][kReg];
#pragma unroll
  for (int i = 0; i < kReg; ++i)
#pragma unroll
    for (int j = 0; j < kReg; ++j) acc[i][j] = inf;

  for (int64_t k0 = 0; k0 < k; k0 += kDepth) {
#pragma unroll
    for (int l = 0; l < kTile * kDepth / (kSide * kSide); ++l) {
      const int idx = threadIdx.x + l * kSide * kSide;
      // A tile: consecutive threads walk k within a row
      const int ar = idx / kDepth, ak = idx % kDepth;
      const int64_t gr = row0 + ar, gk = k0 + ak;
      as[ak][ar] = (gr < m && gk < k) ? a[gr * k + gk] : inf;
      // B tile: consecutive threads walk the columns of a k row
      const int bk = idx / kTile, bc = idx % kTile;
      const int64_t gk2 = k0 + bk, gc = col0 + bc;
      bs[bk][bc] = (gk2 < k && gc < n) ? b[gk2 * n + gc] : inf;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[kReg], bv[kReg];
#pragma unroll
      for (int i = 0; i < kReg; ++i) av[i] = as[kk][ty + i * kSide];
#pragma unroll
      for (int j = 0; j < kReg; ++j) bv[j] = bs[kk][tx + j * kSide];
#pragma unroll
      for (int i = 0; i < kReg; ++i)
#pragma unroll
        for (int j = 0; j < kReg; ++j)
          acc[i][j] = fminf(acc[i][j], av[i] + bv[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int64_t gr = row0 + ty + i * kSide;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int64_t gc = col0 + tx + j * kSide;
      if (gc < n) c[gr * n + gc] = acc[i][j];
    }
  }
}

// ---- relax_tiles -----------------------------------------------------------

constexpr int kStrip = 128;    // columns per block = threads per block
constexpr int kRows = 8;       // D rows per block (register tile)
constexpr int kKBlock = 32;    // k rows per tile (and per occupancy byte)
constexpr int kBlocksPerSm = 8;  // the split's target

// blockIdx.x = strip + strips * run; the run covers k-tiles
// [run * per_run, (run + 1) * per_run); occ (strips, ktiles) bytes per
// district or null; split: fold into the seeded output with atomicMin
__global__ void __launch_bounds__(kStrip)
relax_tiles(const float* __restrict__ d, const float* __restrict__ adj,
            const uint8_t* __restrict__ occ, float* __restrict__ out,
            int64_t s, int64_t v, int strips, int ktiles, int per_run,
            bool split) {
  // ds[kk][r] = D[r0 + r, k0 + kk]: one k row of the tile is 8 floats,
  // read as two float4 broadcasts
  __shared__ float4 ds[kKBlock][kRows / 4];
  float* dsf = reinterpret_cast<float*>(ds);
  const int64_t z = blockIdx.z;
  d += z * s * v;
  out += z * s * v;
  adj += z * v * v;
  const int strip = blockIdx.x % strips;
  const int run = blockIdx.x / strips;
  if (occ != nullptr) occ += (z * strips + strip) * ktiles;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int64_t j = static_cast<int64_t>(strip) * kStrip + threadIdx.x;
  const bool live = j < v;
  const float inf = inf_f();
  const int kt1 = min(ktiles, (run + 1) * per_run);

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = inf;
  bool touched = false;
  for (int kt = run * per_run; kt < kt1; ++kt) {
    if (occ != nullptr && occ[kt] == 0) continue;   // uniform per block
    touched = true;
    const int64_t k0 = static_cast<int64_t>(kt) * kKBlock;
    __syncthreads();                        // the previous tile is spent
    for (int idx = threadIdx.x; idx < kRows * kKBlock; idx += kStrip) {
      const int r = idx / kKBlock, kk = idx % kKBlock;
      const int64_t gk = k0 + kk;
      dsf[kk * kRows + r] =
          (r0 + r < s && gk < v) ? d[(r0 + r) * v + gk] : inf;
    }
    __syncthreads();
    if (!live) continue;
    const float* col = adj + k0 * v + j;
    float av[kKBlock];
#pragma unroll
    for (int u = 0; u < kKBlock; ++u)
      av[u] = k0 + u < v ? col[static_cast<int64_t>(u) * v] : inf;
#pragma unroll
    for (int u = 0; u < kKBlock; ++u) {
      const float4 lo = ds[u][0];
      const float4 hi = ds[u][1];
      acc[0] = fminf(acc[0], lo.x + av[u]);
      acc[1] = fminf(acc[1], lo.y + av[u]);
      acc[2] = fminf(acc[2], lo.z + av[u]);
      acc[3] = fminf(acc[3], lo.w + av[u]);
      acc[4] = fminf(acc[4], hi.x + av[u]);
      acc[5] = fminf(acc[5], hi.y + av[u]);
      acc[6] = fminf(acc[6], hi.z + av[u]);
      acc[7] = fminf(acc[7], hi.w + av[u]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r >= s) break;
    const int64_t at = (r0 + r) * v + j;
    const float seed = d[at];
    if (!split) {
      out[at] = fminf(seed, acc[r]);
    } else if (touched && acc[r] < seed) {
      atomicMin(reinterpret_cast<int*>(out + at), __float_as_int(acc[r]));
    }
  }
}

static_assert(kRows == 8, "the inner loop is written for 8 rows");

}  // namespace

// Plain C entry points, loaded with ctypes. All tensors are contiguous
// float32 on the device; batch <= 65535. Each returns the cudaError_t of
// its launch (0 = launched). The output must be non-empty.

// c (batch, m, n) = a (batch, m, k) (min,+) b (batch, k, n)
extern "C" int repro_minplus(const void* a, const void* b, void* c,
                             int64_t batch, int64_t m, int64_t k, int64_t n,
                             void* stream) {
  if (batch <= 0 || batch > 65535 || m <= 0 || n <= 0 || k < 0)
    return cudaErrorInvalidValue;
  const int64_t gy = (m + kTile - 1) / kTile;
  const int64_t gx = (n + kTile - 1) / kTile;
  if (gy > 65535 || gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
            static_cast<unsigned>(batch));
  minplus_tiled<<<grid, kSide * kSide, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, k, n);
  return cudaGetLastError();
}

// out (batch, s, v) = min(d, d (min,+) adj), adj (batch, v, v); out and d
// must not overlap. occ is null or the (batch, ceil(v / 128), ceil(v / 32))
// uint8 occupancy map of adj (1: the tile holds a finite entry). One
// kernel launch, after a device copy of d into out when strips are split.
extern "C" int repro_relax(const void* d, const void* adj, const void* occ,
                           void* out, int64_t batch, int64_t s, int64_t v,
                           void* stream) {
  if (batch <= 0 || batch > 65535 || s <= 0 || v <= 0)
    return cudaErrorInvalidValue;
  const int64_t gy = (s + kRows - 1) / kRows;
  const int64_t strips = (v + kStrip - 1) / kStrip;
  const int64_t ktiles = (v + kKBlock - 1) / kKBlock;
  if (gy > 65535 || strips * ktiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  // split each strip's k range into runs until the launch has about
  // kBlocksPerSm blocks per SM, at least one k-tile per run
  const int64_t base = strips * gy * batch;
  int64_t runs = (static_cast<int64_t>(kBlocksPerSm) * sms + base - 1) / base;
  runs = runs < 1 ? 1 : (runs > ktiles ? ktiles : runs);
  const int64_t per_run = (ktiles + runs - 1) / runs;
  runs = (ktiles + per_run - 1) / per_run;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool split = runs > 1;
  if (split) {
    err = cudaMemcpyAsync(out, d, static_cast<size_t>(batch * s * v) * 4,
                          cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(static_cast<unsigned>(strips * runs), static_cast<unsigned>(gy),
            static_cast<unsigned>(batch));
  relax_tiles<<<grid, kStrip, 0, st>>>(
      static_cast<const float*>(d), static_cast<const float*>(adj),
      static_cast<const uint8_t*>(occ), static_cast<float*>(out), s, v,
      static_cast<int>(strips), static_cast<int>(ktiles),
      static_cast<int>(per_run), split);
  return cudaGetLastError();
}
