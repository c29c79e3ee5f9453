// Blocked Floyd-Warshall APSP for Hopper (sm_90a), in place on one dense
// (n, n) float32 distance matrix, n a multiple of kTile (the wrapper pads
// with +inf).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/sssp_relax/kernel.py::floyd_warshall_pallas
//   (_phase1_kernel, _phase2_row_kernel, _phase2_col_kernel,
//    _phase3_kernel)
//
// Input: d = min(adj, diag 0) + 0.0, non-negative distances or +inf, no
// -0.0 (the wrapper's + 0.0 turns -0.0 into +0.0), never NaN or -inf.
// For each pivot block kb of kTile = 128 vertices, three launches:
//   phase 1  one block closes the pivot tile (kb, kb), held in registers,
//            with one barrier per in-tile pivot k;
//   phase 2  the pivot block-row tiles (kb, j) and block-column tiles
//            (i, kb), j, i != kb, each relaxed against the closed pivot
//            by one order-free min-plus product: row = min(row, P (x) row),
//            col = min(col, col (x) P); a column tile also writes its new
//            values transposed into the scratch panel ct (k-major), the
//            operand layout phase 3 copies straight into shared memory;
//   phase 3  every other tile (i, j), i, j != kb: d = min(d, col (x) row).
// repro_floyd_warshall enqueues all 3 * n / kTile launches on one stream.
//
// Races, and why there are none:
//   * phase 1 reads the pivot tile once and updates it in registers; the
//     owners of row k and column k publish them to shared memory before
//     step k (double-buffered, one barrier per step). Row k and column k
//     do not change at step k (d[k][k] is 0 or +inf and weights are
//     non-negative), so every thread sees the values of step k - 1;
//   * phase 2 reads the pivot tile and writes only tiles of the pivot
//     row and column, and its own slice of ct; each block reads its own
//     tile before it writes it;
//   * phase 3 reads the pivot row tiles and ct, and writes only tiles
//     outside the pivot row and column.
//
// Every term is one IEEE add and a minimum (built with -fmad=false, no
// fast-math). The blocked order associates path sums differently from
// the rank-1 loop of the plain version, so the two agree bit for bit
// when every path sum is exact in float32 (integral weights, as in every
// synthetic_continent district) and within float32 rounding otherwise.
//
// Bound: operations, n^3 (min, +) terms at the card's sustained (min, +)
// rate (minplus_peak.cu measures it); the bytes (the matrix read and
// written once) are ~1/120 of that at n = 6400. What held the first
// design (64-vertex pivots, 4 x 4 register tiles) at 40 % of a rate of 2
// instructions a term (30 % of the measured one): phase 3 streamed the
// 164 MB matrix from HBM once per 64 pivots (9.8 ms of traffic at
// n = 6400), its 4 x 4 tiles issued >= 2.5 instructions per term
// against 2, and 300 dependent launches. This design:
//   * 128-vertex pivots: half the passes over the matrix (50 at n = 6400);
//   * 8 x 8 register tiles per thread (256 threads, 128 x 128 tiles),
//     the rows and columns of a thread in two 4-wide halves 64 apart, the
//     column operand k-major: four 128-bit shared loads feed 64 terms
//     (0.0625 loads per term), conflict-free;
//   * phase 3 keeps the next k-chunk's operands in flight with cp.async
//     (2 stages of 32 k, 64 KB) while it computes, 2 blocks per SM; the
//     output tile is read and written once per pass;
//   * phases 2 and 3 take two terms at a time with Hopper's DPX
//     three-way minimum on the int32 patterns (2 FADD + 1 VIMNMX3, one
//     instruction on sm_90a, against 2 FADD + 2 FMNMX with fminf, which
//     measured slower); for non-negative floats and +inf, 0x7f800000,
//     IEEE order is the order of the int32 patterns, so it is exact and
//     order-free;
//   * phase 1 keeps the pivot tile in registers: with the in-tile pivot
//     loop unrolled by 4 and by halves, the owners of row and column k
//     are known at compile time and publish them with 128-bit stores.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;                // pivot block and tile edge
constexpr int kSide = 16;                 // threads per tile edge
constexpr int kThreads = kSide * kSide;   // 256
constexpr int kReg = 8;                   // 8 x 8 entries per thread
constexpr int kHalf = kTile / 2;          // a thread's second half: +64
constexpr int kChunk = 32;                // phase 3: k rows per stage
constexpr int kChunks = kTile / kChunk;   // 4
constexpr int kStageFloats = 2 * kChunk * kTile;    // A and B of a stage
constexpr int kPhase3Smem = 2 * kStageFloats * 4;   // 2 stages: 64 KB
constexpr int kPhase2Smem = 2 * kTile * kTile * 4;  // A and B: 128 KB

// the tile row (or column) of a thread's entry i: two 4-wide halves
__device__ __forceinline__ int own(int t, int i) {
  return t * 4 + (i & 3) + (i >> 2) * kHalf;
}

// min(acc, x0, x1) for non-negative floats and +inf: one DPX VIMNMX3
__device__ __forceinline__ float min3(float acc, float x0, float x1) {
  return __int_as_float(__vimin3_s32(__float_as_int(acc), __float_as_int(x0),
                                     __float_as_int(x1)));
}

// v[i] = row[own(t, i)] from a 128-float row in shared memory
__device__ __forceinline__ void load8(float (&v)[kReg], const float* row,
                                      int t) {
  const float4 lo = *reinterpret_cast<const float4*>(row + t * 4);
  const float4 hi = *reinterpret_cast<const float4*>(row + kHalf + t * 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc[i][j] = d[r0 + own(ty, i), c0 + own(tx, j)]
__device__ __forceinline__ void load_acc(float (&acc)[kReg][kReg],
                                         const float* __restrict__ d,
                                         int64_t ld, int64_t r0, int64_t c0,
                                         int tx, int ty) {
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const float* row = d + (r0 + own(ty, i)) * ld + c0;
    const float4 lo = ldg4(row + tx * 4);
    const float4 hi = ldg4(row + kHalf + tx * 4);
    acc[i][0] = lo.x; acc[i][1] = lo.y; acc[i][2] = lo.z; acc[i][3] = lo.w;
    acc[i][4] = hi.x; acc[i][5] = hi.y; acc[i][6] = hi.z; acc[i][7] = hi.w;
  }
}

__device__ __forceinline__ void store_acc(const float (&acc)[kReg][kReg],
                                          float* __restrict__ d, int64_t ld,
                                          int64_t r0, int64_t c0, int tx,
                                          int ty) {
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    float* row = d + (r0 + own(ty, i)) * ld + c0;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + kHalf + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// acc = min(acc, A (x) B) over kDepth k; as[k * kTile + i] = A[i][k]
// (k-major), bs[k * kTile + j] = B[k][j]; two k per step
template <int kDepth>
__device__ __forceinline__ void product(float (&acc)[kReg][kReg],
                                        const float* as, const float* bs,
                                        int tx, int ty) {
#pragma unroll 1
  for (int k = 0; k < kDepth; k += 2) {
    float a0[kReg], b0[kReg], a1[kReg], b1[kReg];
    load8(a0, as + k * kTile, ty);
    load8(b0, bs + k * kTile, tx);
    load8(a1, as + (k + 1) * kTile, ty);
    load8(b1, bs + (k + 1) * kTile, tx);
#pragma unroll
    for (int i = 0; i < kReg; ++i)
#pragma unroll
      for (int j = 0; j < kReg; ++j)
        acc[i][j] = min3(acc[i][j], a0[i] + b0[j], a1[i] + b1[j]);
  }
}

// s[k * kTile + j] = src[(r0 + k) * ld + c0 + j], a whole tile
__device__ __forceinline__ void stage_rows(float* s, const float* src,
                                           int64_t ld, int64_t r0,
                                           int64_t c0) {
  for (int idx = threadIdx.x; idx < kTile * kTile / 4; idx += kThreads) {
    const int k = idx / (kTile / 4), j4 = idx % (kTile / 4);
    *reinterpret_cast<float4*>(s + k * kTile + j4 * 4) =
        ldg4(src + (r0 + k) * ld + c0 + j4 * 4);
  }
}

// s[k * kTile + i] = src[(r0 + i) * ld + c0 + k], a whole tile transposed;
// a warp stores 32 consecutive i of one k (conflict-free)
__device__ __forceinline__ void stage_cols(float* s, const float* src,
                                           int64_t ld, int64_t r0,
                                           int64_t c0) {
  const int i = threadIdx.x % kTile;
  const float* row = src + (r0 + i) * ld + c0;
  for (int k = (threadIdx.x / kTile) * 4; k < kTile;
       k += 4 * (kThreads / kTile)) {
    const float4 v = ldg4(row + k);
    s[k * kTile + i] = v.x;
    s[(k + 1) * kTile + i] = v.y;
    s[(k + 2) * kTile + i] = v.z;
    s[(k + 3) * kTile + i] = v.w;
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__global__ void __launch_bounds__(kThreads)
fw_phase1(float* __restrict__ d, int64_t ld, int64_t kb) {
  __shared__ __align__(16) float rowk[2][kTile];
  __shared__ __align__(16) float colk[2][kTile];
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int64_t p0 = kb * kTile;
  float acc[kReg][kReg];
  load_acc(acc, d, ld, p0, p0, tx, ty);
  // k = kh * 64 + k4 * 4 + kk: with kh and kk unrolled, row k is entry
  // row i = kh * 4 + kk of the threads with ty == k4, column k entry
  // column i of the threads with tx == k4 (see own)
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    for (int k4 = 0; k4 < kSide; ++k4) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int i = kh * 4 + kk, buf = kk & 1;
        // the owners publish row k and column k (values of step k - 1)
        if (ty == k4) {
          *reinterpret_cast<float4*>(&rowk[buf][tx * 4]) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(&rowk[buf][kHalf + tx * 4]) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
        if (tx == k4) {
          *reinterpret_cast<float4*>(&colk[buf][ty * 4]) =
              make_float4(acc[0][i], acc[1][i], acc[2][i], acc[3][i]);
          *reinterpret_cast<float4*>(&colk[buf][kHalf + ty * 4]) =
              make_float4(acc[4][i], acc[5][i], acc[6][i], acc[7][i]);
        }
        __syncthreads();
        float r[kReg], c[kReg];
        load8(r, rowk[buf], tx);
        load8(c, colk[buf], ty);
#pragma unroll
        for (int a = 0; a < kReg; ++a)
#pragma unroll
          for (int b = 0; b < kReg; ++b)
            acc[a][b] = fminf(acc[a][b], c[a] + r[b]);
      }
    }
  }
  store_acc(acc, d, ld, p0, p0, tx, ty);
}

// blockIdx.y == 0: the pivot row's tile (kb, o); 1: the pivot column's
// tile (o, kb), o = blockIdx.x skipping kb
__global__ void __launch_bounds__(kThreads)
fw_phase2(float* __restrict__ d, float* __restrict__ ct, int64_t ld,
          int64_t kb) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);
  float* bs = as + kTile * kTile;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int64_t p0 = kb * kTile;
  const int64_t o0 =
      (static_cast<int64_t>(blockIdx.x) + (blockIdx.x >= kb)) * kTile;
  const bool row = blockIdx.y == 0;
  const int64_t r0 = row ? p0 : o0, c0 = row ? o0 : p0;
  if (row) {
    stage_cols(as, d, ld, p0, p0);          // A = P, k-major
    stage_rows(bs, d, ld, p0, o0);          // B = the row tile
  } else {
    stage_cols(as, d, ld, o0, p0);          // A = the column tile, k-major
    stage_rows(bs, d, ld, p0, p0);          // B = P
  }
  float acc[kReg][kReg];
  load_acc(acc, d, ld, r0, c0, tx, ty);
  __syncthreads();
  product<kTile>(acc, as, bs, tx, ty);
  store_acc(acc, d, ld, r0, c0, tx, ty);
  if (row) return;
  // ct[k * ld + v] = d[v][p0 + k] for the tile's rows v: phase 3's A
#pragma unroll
  for (int j = 0; j < kReg; ++j) {
    float* col = ct + own(tx, j) * ld + o0;
    *reinterpret_cast<float4*>(col + ty * 4) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(col + kHalf + ty * 4) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
}

// phase 3's cp.async sources of one thread: its l-th 16-byte copy of a
// k-chunk reads a + l * 8 rows (A, from ct) and b + l * 8 rows (B, the
// pivot row tiles of d); the next chunk is kChunk rows further
struct ChunkSources {
  const float* a;
  const float* b;
  int64_t step;                             // 8 rows of the n-wide arrays
};

__device__ __forceinline__ ChunkSources chunk_sources(const float* ct,
                                                      const float* d,
                                                      int64_t ld, int64_t r0,
                                                      int64_t c0,
                                                      int64_t p0) {
  const int k = threadIdx.x / (kTile / 4), j = (threadIdx.x % (kTile / 4)) * 4;
  return {ct + k * ld + r0 + j, d + (p0 + k) * ld + c0 + j,
          (kThreads / (kTile / 4)) * ld};
}

// one k-chunk of phase 3's operands into a stage: A from ct, B from the
// pivot row tiles of d; the thread's shared offset is the same in both
__device__ __forceinline__ void issue_chunk(float* stage,
                                            const ChunkSources& src,
                                            int kc) {
  float* as = stage + (threadIdx.x / (kTile / 4)) * kTile +
              (threadIdx.x % (kTile / 4)) * 4;
  float* bs = as + kChunk * kTile;
  const int64_t off = static_cast<int64_t>(kc) * kChunk * (src.step / 8);
#pragma unroll
  for (int l = 0; l < kChunk * kTile / 4 / kThreads; ++l) {
    cp_async16(as + l * 8 * kTile, src.a + off + l * src.step);
    cp_async16(bs + l * 8 * kTile, src.b + off + l * src.step);
  }
  cp_async_commit();
}

// tile (i, j) = min(itself, col (x) row), i and j skipping kb; 2 blocks
// per SM, each keeping the next k-chunk's operands in flight
__global__ void __launch_bounds__(kThreads, 2)
fw_phase3(float* __restrict__ d, const float* __restrict__ ct, int64_t ld,
          int64_t kb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.y) + (blockIdx.y >= kb)) * kTile;
  const int64_t c0 =
      (static_cast<int64_t>(blockIdx.x) + (blockIdx.x >= kb)) * kTile;
  const ChunkSources src = chunk_sources(ct, d, ld, r0, c0, kb * kTile);
  issue_chunk(smem, src, 0);
  issue_chunk(smem + kStageFloats, src, 1);
  float acc[kReg][kReg];
  load_acc(acc, d, ld, r0, c0, tx, ty);
#pragma unroll
  for (int kc = 0; kc < kChunks; ++kc) {
    if (kc + 1 < kChunks)
      cp_async_wait<1>();                   // chunk kc has landed
    else
      cp_async_wait<0>();
    __syncthreads();
    const float* stage = smem + (kc & 1) * kStageFloats;
    product<kChunk>(acc, stage, stage + kChunk * kTile, tx, ty);
    if (kc + 2 < kChunks) {
      __syncthreads();                      // the stage is spent
      issue_chunk(smem + (kc & 1) * kStageFloats, src, kc + 2);
    }
  }
  store_acc(acc, d, ld, r0, c0, tx, ty);
}

static_assert(kChunks == 4, "phase 3's pipeline is written for 4 chunks");
static_assert(kChunk * kTile % (4 * kThreads) == 0, "whole cp.async rounds");

// Phases 2 and 3 take more than 48 KB of dynamic shared memory. The
// attribute belongs to the current device, so it is set on every call
// of an entry point (two host calls, next to up to 150 launches).
cudaError_t allow_smem() {
  const cudaError_t err = cudaFuncSetAttribute(
      fw_phase2, cudaFuncAttributeMaxDynamicSharedMemorySize, kPhase2Smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fw_phase3,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kPhase3Smem);
}

cudaError_t launch_phase(float* d, float* ct, int64_t n, int64_t kb,
                         int phase, cudaStream_t s) {
  const unsigned others = static_cast<unsigned>(n / kTile - 1);
  if (phase == 1) {
    fw_phase1<<<1, kThreads, 0, s>>>(d, n, kb);
  } else if (others > 0) {
    if (phase == 2)
      fw_phase2<<<dim3(others, 2), kThreads, kPhase2Smem, s>>>(d, ct, n, kb);
    else
      fw_phase3<<<dim3(others, others), kThreads, kPhase3Smem, s>>>(d, ct, n,
                                                                    kb);
  }
  return cudaGetLastError();
}

bool valid(int64_t n, int64_t kb) {
  return n > 0 && n % kTile == 0 && n / kTile <= 65535 && kb >= 0 &&
         kb < n / kTile;
}

}  // namespace

// Plain C entry points, loaded with ctypes. d is a contiguous (n, n)
// float32 matrix on the device holding min(adj, diag 0) + 0.0, n a
// multiple of 128; ct is (128, n) float32 scratch on the device. Each
// returns the first cudaError_t that is not cudaSuccess (0 = launched).

// One phase (1, 2 or 3) of pivot block kb; phase 3 of pivot kb reads what
// phase 2 of kb wrote to ct. Phases 2 and 3 launch nothing when n == 128.
extern "C" int repro_floyd_warshall_phase(void* d, void* ct, int64_t n,
                                          int64_t kb, int phase,
                                          void* stream) {
  if (!valid(n, kb) || phase < 1 || phase > 3) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  return launch_phase(static_cast<float*>(d), static_cast<float*>(ct), n, kb,
                      phase, static_cast<cudaStream_t>(stream));
}

// Closes d in place: 3 * n / 128 launches (1 when n == 128) on `stream`.
extern "C" int repro_floyd_warshall(void* d, void* ct, int64_t n,
                                    void* stream) {
  if (!valid(n, 0)) return cudaErrorInvalidValue;
  const cudaError_t smem = allow_smem();
  if (smem != cudaSuccess) return smem;
  float* m = static_cast<float*>(d);
  float* c = static_cast<float*>(ct);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int64_t kb = 0; kb < n / kTile; ++kb)
    for (int phase = 1; phase <= 3; ++phase) {
      const cudaError_t err = launch_phase(m, c, n, kb, phase, s);
      if (err != cudaSuccess) return err;
    }
  return cudaSuccess;
}
