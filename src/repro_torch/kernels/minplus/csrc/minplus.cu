// Min-plus (tropical) products for Hopper (sm_90a), batched over a
// leading district axis (blockIdx.z).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   src/repro/kernels/minplus/kernel.py::minplus_pallas (_minplus_kernel)
//   src/repro/kernels/minplus/kernel.py::relax_pallas   (_relax_kernel)
//
//   repro_minplus:         C[z,i,j] = min_k A[z,i,k] + B[z,k,j]
//   repro_minplus_closure: D <- D (x) D, up to `steps` times, in one launch
//   repro_minplus_kmajor:  C[z,i,j] = min_k At[z,k,i] + B[z,k,j]
//   repro_relax:           D'[z,r,j] = min(D[z,r,j], min_k D[z,r,k] + A[z,k,j])
//
// Every term is one IEEE float add and the reduction is a minimum, which
// is exact and order-free on the inputs these kernels take (non-negative
// distances and +inf; never NaN or -inf). So the result is bit for bit
// that of the plain versions and of the TPU kernels, whatever the tiling.
// Out-of-range loads read +inf, the semiring zero, in place of the TPU
// kernel's +inf padding to 128-blocks. Built with -fmad=false and no
// fast-math. Min-plus has no tensor-core form: FP32 CUDA cores only.
//
// minplus_closure — the Border-Labeling builder's stage B and the warm
// closure of a repair: the Jacobi squarings D <- D (x) D of a (q, q)
// overlay, q <= kClosureMaxQ. Bound: latency. At q ~ 96 a squaring is
// 0.9 M terms, under a microsecond of the card's (min, +) rate, and the
// tiled kernel spent ~9.4 us a launch on 4 blocks, 7 launches a closure.
// Design: one launch of one thread-block cluster of 16 blocks (a
// non-portable size; on the H100 8 blocks took 0.033 ms at q = 93, 16
// blocks 0.024).
// Each block keeps the whole current D in
// its shared memory (two buffers, pitch rounded up to 4, padding +inf)
// and computes its own panel of ceil(q / 16) rows of D (x) D: a thread
// owns a column quad of up to 4 panel rows, reads the row operand as
// float4 broadcasts over k and the column operand as float4 rows, and
// takes two terms at a time with Hopper's DPX three-way minimum on the
// int32 patterns (for non-negative floats and +inf IEEE order is the
// order of the patterns; -0.0 is turned into +0.0 on load). The panel
// goes into the block's next buffer and, by one bulk copy a block
// (cp.async.bulk, shared::cta to shared::cluster), into every other
// block's, each counted on the receiver's mbarrier: a block starts the
// next squaring as soon as every panel has landed, with no cluster-wide
// barrier. Never in place: an in-place update would associate path sums
// differently. From squaring `check_from` on, a block that finds its
// panel changed sets the squaring's flag in every block and the cluster
// synchronises once; it stops at the first squaring that returns its
// input bit for bit and reports its index.
//
// minplus_kmajor — stage C, (kmax, bmax) x (bmax, q) per district, with A
// read k-major (stage A's own (bmax, kmax) layout: no transpose copy).
// Bound: bytes — k = bmax = 8 terms per output, the (m, n) output is
// nearly all the traffic. Design: a block owns a tile of 16–128 rows
// (sized so that the launch is a whole number of waves on the card: no
// last wave idles most SMs) x up to 1024 columns of one district; A's
// k x rows tile sits in shared memory; each thread owns one column quad
// (or one column where n % 4 != 0, whose rows are not 16-byte aligned)
// and keeps its k x 4 B values in registers, then walks the rows: k
// broadcast reads of A, 4k terms, one float4 store. Lanes own
// consecutive quads, so a warp's stores cover 512 contiguous bytes. k is
// padded to 4, 8, 16 or 32 with +inf terms.
//
// minplus_tiled — every other product (the squarings of a closure above
// kClosureMaxQ, k > 32). Design: a 64 x 64 output tile per block of 256
// threads, each thread a 4 x 4 register tile at a stride of 16 rows and
// columns (conflict-free shared reads, coalesced writes); 16-deep
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

#include <atomic>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// ---- minplus_closure --------------------------------------------------------

constexpr int kClosureThreads = 256;
constexpr int kClosureMaxQ = 160;
constexpr int kClosureMaxSteps = 32;
constexpr int kClosureMaxRows = 4;      // rows of a panel a thread owns

__host__ __device__ constexpr int closure_pitch(int q) { return (q + 3) & ~3; }

// two (pitch, pitch) buffers, two mbarriers, the squarings' flags
__host__ constexpr size_t closure_smem(int q) {
  return 2 * static_cast<size_t>(closure_pitch(q)) * closure_pitch(q) * 4 +
         16 + kClosureMaxSteps * 4;
}

static_assert(closure_smem(kClosureMaxQ) <= 232448,
              "one block's shared memory");

// the panel rows a thread owns: quads = pitch / 4 column quads, groups =
// kClosureThreads / quads row groups, ceil(rows / groups) rows a group
__host__ __device__ constexpr int closure_rows_per_thread(int q, int blocks) {
  return ((q + blocks - 1) / blocks + kClosureThreads / (closure_pitch(q) / 4) -
          1) /
         (kClosureThreads / (closure_pitch(q) / 4));
}

__device__ __forceinline__ int min3_bits(int acc, float x0, float x1) {
  return __vimin3_s32(acc, __float_as_int(x0), __float_as_int(x1));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of `addr` (a shared::cta address) in block
// `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// spin until phase `parity` of the barrier completes; a phase that never
// completes traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (spins > (1LL << 22)) __trap();
  }
}

// `bytes` of this block's shared memory at `src` into another block's at
// `dst` (both 16-byte aligned), counted on that block's barrier `bar`
__device__ __forceinline__ void bulk_push(uint32_t dst, uint32_t src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// One launch of one cluster of gridDim.x blocks. Thread t owns column
// quad t % quads of panel rows t / quads + groups * v, v < RI. depth: the
// index of the squaring that returned its input (from check_from on),
// else steps.
template <int RI>
__global__ void __launch_bounds__(kClosureThreads)
minplus_closure(const float* __restrict__ w0, float* __restrict__ out, int q,
                int steps, int check_from, int* __restrict__ depth) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int p = closure_pitch(q);
  const int quads = p / 4;
  const int groups = kClosureThreads / quads;
  float* const buf0 = smem;             // D after an even number of squarings
  float* const buf1 = smem + p * p;     // ... and after an odd number
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + 2 * p * p);
  int* changed = reinterpret_cast<int*>(bars + 2);
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = (q + blocks - 1) / blocks;
  const int row0 = min(q, rank * rows);
  const int row1 = min(q, row0 + rows);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float inf = inf_f();

  // D0 into buffer 0 with asynchronous 4-byte copies (w0's rows are not
  // 16-byte aligned where q % 4 != 0), padding +inf in both buffers
  for (int i = warp; i < p; i += kClosureThreads / 32) {
    for (int j = lane; j < p; j += 32) {
      if (i < q && j < q) {
        cp_async4(buf0 + i * p + j, w0 + i * q + j);
      } else {
        buf0[i * p + j] = inf;
      }
      buf1[i * p + j] = inf;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // + 0.0f turns -0.0 into +0.0, the one pattern order that differs
  for (int idx = threadIdx.x; idx < p * p; idx += kClosureThreads)
    buf0[idx] += 0.0f;
  if (threadIdx.x < kClosureMaxSteps) changed[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(bars));
    mbar_init(smem_addr(bars + 1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block resident and initialised before any remote access
  cluster.sync();

  const int rg = threadIdx.x / quads;
  const int j0 = 4 * (threadIdx.x % quads);
  int gi[RI];
  bool row_ok[RI];
  bool any_row = false;
#pragma unroll
  for (int v = 0; v < RI; ++v) {
    const int r = row0 + rg + groups * v;
    row_ok[v] = rg < groups && r < row1;
    gi[v] = min(r, q - 1);              // a clamped row is read, not stored
    any_row |= row_ok[v];
  }
  // the bytes the other blocks' panels bring each squaring
  const uint32_t incoming = static_cast<uint32_t>((q - (row1 - row0)) * p * 4);
  const uint32_t panel = static_cast<uint32_t>((row1 - row0) * p * 4);

  int stop = steps;
  int s = 0;
  for (; s < steps; ++s) {
    const float* cur = (s & 1) ? buf1 : buf0;
    float* nxt = (s & 1) ? buf0 : buf1;
    const uint32_t bar = smem_addr(bars + ((s + 1) & 1));
    if (threadIdx.x == 0) mbar_expect(bar, incoming);
    int acc[RI][4];
#pragma unroll
    for (int v = 0; v < RI; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[v][e] = 0x7f800000;
    if (any_row) {
#pragma unroll 2
      for (int k = 0; k < p; k += 4) {
        float4 a[RI], b[4];
#pragma unroll
        for (int v = 0; v < RI; ++v)
          a[v] = *reinterpret_cast<const float4*>(cur + gi[v] * p + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          b[kk] = *reinterpret_cast<const float4*>(cur + (k + kk) * p + j0);
#pragma unroll
        for (int v = 0; v < RI; ++v) {
          acc[v][0] = min3_bits(acc[v][0], a[v].x + b[0].x, a[v].y + b[1].x);
          acc[v][0] = min3_bits(acc[v][0], a[v].z + b[2].x, a[v].w + b[3].x);
          acc[v][1] = min3_bits(acc[v][1], a[v].x + b[0].y, a[v].y + b[1].y);
          acc[v][1] = min3_bits(acc[v][1], a[v].z + b[2].y, a[v].w + b[3].y);
          acc[v][2] = min3_bits(acc[v][2], a[v].x + b[0].z, a[v].y + b[1].z);
          acc[v][2] = min3_bits(acc[v][2], a[v].z + b[2].z, a[v].w + b[3].z);
          acc[v][3] = min3_bits(acc[v][3], a[v].x + b[0].w, a[v].y + b[1].w);
          acc[v][3] = min3_bits(acc[v][3], a[v].z + b[2].w, a[v].w + b[3].w);
        }
      }
    }
    const bool check = s >= check_from;
    bool diff = false;
    if (check) {
#pragma unroll
      for (int v = 0; v < RI; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          diff |= row_ok[v] &&
                  acc[v][e] != __float_as_int(cur[gi[v] * p + j0 + e]);
    }
    // the panel into this block's next buffer (a quad's columns past q
    // are padding: their products are +inf, as the padding was) ...
#pragma unroll
    for (int v = 0; v < RI; ++v)
      if (row_ok[v])
        *reinterpret_cast<float4*>(nxt + gi[v] * p + j0) = make_float4(
            __int_as_float(acc[v][0]), __int_as_float(acc[v][1]),
            __int_as_float(acc[v][2]), __int_as_float(acc[v][3]));
    // ... visible to the bulk copies; the last squaring's copies have
    // read this buffer's panel before it was rewritten (wait_group.read)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();
    // ... and into every other block's next buffer: a block's panel
    // rows are contiguous, one bulk copy a block, counted on that
    // block's barrier. A block writes another's buffer only after it
    // has every panel of the squaring before, which that block sent
    // after its last read of this buffer: no write lands early.
    if (threadIdx.x == 0 && panel > 0) {
      const uint32_t src = smem_addr(nxt + row0 * p);
      for (int b = 0; b < blocks; ++b) {
        if (b == rank) continue;
        bulk_push(cluster_addr(src, b), src, panel, cluster_addr(bar, b));
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    mbar_wait(bar, (s >> 1) & 1);       // the other panels have landed
    if (check) {
      if (__syncthreads_or(diff) && threadIdx.x < blocks)
        *cluster.map_shared_rank(changed + s, static_cast<int>(threadIdx.x)) =
            1;
      cluster.sync();                   // the flags delivered
      if (changed[s] == 0) {            // uniform: every block got them
        stop = s;                       // the squaring returned cur
        break;
      }
    }
  }
  // every panel sent to this block has landed (its barrier waited) and
  // every copy out of it has read its source: blocks may exit
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  const float* result = (s & 1) ? buf1 : buf0;  // D after `stop` squarings
#pragma unroll
  for (int v = 0; v < RI; ++v)
    if (row_ok[v])
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + e < q) out[gi[v] * q + j0 + e] = result[gi[v] * p + j0 + e];
  if (rank == 0 && threadIdx.x == 0) *depth = stop;
}

constexpr int kClosureBlocks = 16;      // blocks of the one cluster
constexpr int kMaxDevices = 64;

// the SM count of `device`, read once per device
int sm_count(int device) {
  static std::atomic<int> cache[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 0;
  int sms = cache[device].load(std::memory_order_relaxed);
  if (sms == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) ==
          cudaSuccess)
    cache[device].store(sms, std::memory_order_relaxed);
  return sms;
}

// the current device (into *device) and its SM count, or 0
int current_sm_count(int* device) {
  return cudaGetDevice(device) == cudaSuccess ? sm_count(*device) : 0;
}

// one launch of one cluster of kClosureBlocks blocks; the instance's
// attributes (shared memory for q up to the cap, the non-portable cluster
// size) are set once per device
template <int RI>
cudaError_t launch_closure(const float* w0, float* out, int q, int steps,
                           int check_from, int* depth, cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices] = {};
  auto* fn = minplus_closure<RI>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(closure_smem(kClosureMaxQ)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready[device].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClosureBlocks, 1, 1);
  cfg.blockDim = dim3(kClosureThreads, 1, 1);
  cfg.dynamicSmemBytes = closure_smem(q);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClosureBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, w0, out, q, steps, check_from, depth);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---- minplus_kmajor ---------------------------------------------------------

constexpr int kKmThreads = 256;
constexpr int kKmRows = 128;            // most rows of C per block
constexpr int kKmMinRows = 16;
constexpr int kKmUnits = 256;           // column units (quads, columns) a block

// c (batch, m, n) = a_t (batch, k, m)^T (min,+) b (batch, k, n); K = k
// padded up (terms past k are +inf); VEC = 4 (float4 stores, n % 4 == 0)
// or 1; blockIdx.x: row tile of `tile_rows` (<= kKmRows) rows,
// blockIdx.y: column tile of VEC * kKmUnits columns, blockIdx.z: batch
template <int K, int VEC>
__global__ void __launch_bounds__(kKmThreads)
minplus_kmajor(const float* __restrict__ a_t, const float* __restrict__ b,
               float* __restrict__ c, int64_t m, int k, int64_t n,
               int tile_rows) {
  __shared__ float as[K][kKmRows];
  const int64_t z = blockIdx.z;
  a_t += z * k * m;
  b += z * k * n;
  c += z * m * n;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * VEC * kKmUnits;
  const float inf = inf_f();
  for (int idx = threadIdx.x; idx < K * tile_rows; idx += blockDim.x) {
    const int kk = idx / tile_rows, r = idx % tile_rows;
    as[kk][r] = (kk < k && i0 + r < m) ? a_t[kk * m + i0 + r] : inf;
  }
  __syncthreads();
  const int64_t cols = min(static_cast<int64_t>(VEC * kKmUnits), n - c0);
  const int units = static_cast<int>((cols + VEC - 1) / VEC);
  const int groups = blockDim.x / units;  // the launch has groups * units
  const int g = threadIdx.x / units;      // threads (or more: a narrower
  if (g >= groups) return;                // last column tile)
  const int64_t col = c0 + static_cast<int64_t>(threadIdx.x % units) * VEC;
  float bv[K][VEC];
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      bv[kk][e] = (kk < k && col + e < n) ? b[kk * n + col + e] : inf;
  const int rows = static_cast<int>(
      min(static_cast<int64_t>(tile_rows), m - i0));
  for (int r = g; r < rows; r += groups) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = inf;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float a = as[kk][r];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fminf(acc[e], a + bv[kk][e]);
    }
    float* dst = c + (i0 + r) * n + col;
    if constexpr (VEC == 4) {
      if (col + 4 <= n) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (col + e < n) dst[e] = acc[e];
  }
}

template <int K, int VEC>
cudaError_t launch_kmajor(const float* a_t, const float* b, float* c,
                          int64_t batch, int64_t m, int k, int64_t n,
                          cudaStream_t stream) {
  auto* fn = minplus_kmajor<K, VEC>;
  const int64_t tile = static_cast<int64_t>(VEC) * kKmUnits;
  const int64_t gy = (n + tile - 1) / tile;
  // one column tile's units (the last, narrower tile reuses the layout of
  // the first: its extra threads find no column and store nothing)
  const int64_t cols = n < tile ? n : tile;
  const int units = static_cast<int>((cols + VEC - 1) / VEC);
  const int threads = (kKmThreads / units) * units;
  // blocks resident on an SM, asked once per device and block size (a
  // column tile of fewer than VEC * kKmUnits columns takes fewer threads)
  static std::atomic<int> per_sm_cache[kMaxDevices][kKmThreads + 1] = {};
  int device = 0;
  const int sms = current_sm_count(&device);
  if (sms == 0) return cudaErrorInvalidDevice;
  int per_sm = per_sm_cache[device][threads].load(std::memory_order_relaxed);
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, threads, 0);
    if (err != cudaSuccess) return err;
    per_sm_cache[device][threads].store(per_sm, std::memory_order_relaxed);
  }
  // row tiles that make the launch a whole number of waves: the waves
  // 128-row tiles need, then as many row tiles per district as fill them
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t lanes = batch * gy;
  const int64_t waves = (lanes * ((m + kKmRows - 1) / kKmRows) + slots - 1) /
                        slots;
  const int64_t per_district = waves * slots / lanes > 0
                                   ? waves * slots / lanes : 1;
  int64_t rows = (m + per_district - 1) / per_district;
  rows = rows < kKmMinRows ? kKmMinRows : (rows > kKmRows ? kKmRows : rows);
  const int tile_rows = static_cast<int>(rows);
  const int64_t gx = (m + tile_rows - 1) / tile_rows;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
            static_cast<unsigned>(batch));
  fn<<<grid, threads, 0, stream>>>(a_t, b, c, m, k, n, tile_rows);
  return cudaGetLastError();
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

// out (q, q) = w0 squared `steps` times (D <- D (min,+) D), in one launch of
// one cluster of 16 blocks; from squaring check_from on it stops at the
// first squaring that returns its input bit for bit. *depth (int32 on the
// device) = that squaring's index, else steps. w0 and out must not
// overlap; 1 <= q <= 160 (kClosureMaxQ), steps <= 32.
extern "C" int repro_minplus_closure(const void* w0, void* out, int q,
                                     int steps, int check_from, void* depth,
                                     void* stream) {
  if (q <= 0 || q > kClosureMaxQ || steps < 0 || steps > kClosureMaxSteps ||
      check_from < 0)
    return cudaErrorInvalidValue;
  const int ri = closure_rows_per_thread(q, kClosureBlocks);
  if (ri > kClosureMaxRows) return cudaErrorInvalidValue;
  auto* fn = ri == 1   ? launch_closure<1>
             : ri == 2 ? launch_closure<2>
             : ri == 3 ? launch_closure<3>
                       : launch_closure<4>;
  return fn(static_cast<const float*>(w0), static_cast<float*>(out), q, steps,
            check_from, static_cast<int*>(depth),
            static_cast<cudaStream_t>(stream));
}

// c (batch, m, n) = a_t (batch, k, m)^T (min,+) b (batch, k, n), k <= 32;
// float4 stores where n % 4 == 0 (c is 16-byte aligned), else scalar ones
extern "C" int repro_minplus_kmajor(const void* a_t, const void* b, void* c,
                                    int64_t batch, int64_t m, int64_t k,
                                    int64_t n, void* stream) {
  if (batch <= 0 || batch > 65535 || m <= 0 || n <= 0 || k < 0 || k > 32)
    return cudaErrorInvalidValue;
  const auto* a_ = static_cast<const float*>(a_t);
  const auto* b_ = static_cast<const float*>(b);
  auto* c_ = static_cast<float*>(c);
  auto st = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (vec) {
    if (k <= 4) return launch_kmajor<4, 4>(a_, b_, c_, batch, m, kk, n, st);
    if (k <= 8) return launch_kmajor<8, 4>(a_, b_, c_, batch, m, kk, n, st);
    if (k <= 16) return launch_kmajor<16, 4>(a_, b_, c_, batch, m, kk, n, st);
    return launch_kmajor<32, 4>(a_, b_, c_, batch, m, kk, n, st);
  }
  if (k <= 4) return launch_kmajor<4, 1>(a_, b_, c_, batch, m, kk, n, st);
  if (k <= 8) return launch_kmajor<8, 1>(a_, b_, c_, batch, m, kk, n, st);
  if (k <= 16) return launch_kmajor<16, 1>(a_, b_, c_, batch, m, kk, n, st);
  return launch_kmajor<32, 1>(a_, b_, c_, batch, m, kk, n, st);
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
  int device = 0;
  const int sms = current_sm_count(&device);
  if (sms == 0) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSuccess;
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
