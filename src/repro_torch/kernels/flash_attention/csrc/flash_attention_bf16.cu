// GQA flash attention (online softmax, causal and key-padding masks) in
// bfloat16 on Hopper's tensor cores (sm_90a: TMA, mbarrier, wgmma, warp
// specialisation).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention/kernel.py:28 _flash_kernel
//   src/repro/kernels/flash_attention/kernel.py:69 flash_attention_pallas
//
//   out[b,i,h,:] = sum_j softmax_j(s_ij) v[b,j,h/G,:],
//   s_ij = (q[b,i,h,:] . k[b,j,h/G,:]) * scale, scale = 1/sqrt(hd),
//   s_ij = -1e30 where j >= T or (causal and j > i); G = H / KV.
//
// What it computes is the TPU kernel's: per (batch*head, query tile) it
// streams K/V tiles and keeps the running max m, the denominator l and the
// accumulator acc in float32; masked scores are -1e30 (not -inf); the
// output is acc / max(l, 1e-30) rounded once to bf16. One rounding more
// than the TPU kernel: the probabilities p enter the P.V product as bf16,
// as in every tensor-core flash kernel (l sums the unrounded p). Key tiles
// wholly above the causal diagonal are skipped: in the TPU kernel such a
// tile adds exactly nothing, because key 0 is never masked.
//
// Bound at the main path's shape, Qwen3-4B prefill (B, S, H, KV, hd) =
// (2, 4096, 32, 8, 128), causal: 2*B*H*S*T*hd = 275 GFLOP, 0.278 ms at the
// 989 TFLOP/s bf16 dense tensor-core peak; 168 MB of q, k, v and out,
// 0.050 ms at 3.35 TB/s. So it is bound by operations, and only wgmma
// reaches that rate. The design:
//
// * A block of 3 warpgroups owns 128 query rows of one (b, h). Warpgroup 0
//   is the producer: it gives up registers (setmaxnreg 40) and one thread
//   issues the TMA loads. Warpgroups 1 and 2 are consumers (setmaxnreg
//   232), each owning 64 query rows.
// * TMA: q (B,S,H,hd) and k, v (B,T,KV,hd) are described in place as 4-D
//   tensor maps with their real strides (16-byte aligned, checked by the
//   wrapper); a tile lands in shared memory with the 128-byte swizzle, one
//   box per 64 columns of the head dim. Rows past S or T, and columns past
//   hd (hd = 16, 32 run as 64), arrive as zeros. Q is loaded once; K and V
//   go through a ring of two stages, each with its own full barrier (TMA
//   bytes) and empty barrier (one arrival per consumer warp).
// * S = Q.K^T is wgmma m64n{BK}k16 with both operands in shared memory
//   (K-major descriptors, 128-byte swizzle). The f32 accumulator of S,
//   after the softmax, is converted to bf16 pairs in place: that is
//   exactly the register layout of wgmma's A operand, so O += P.V is
//   wgmma m64n{hd}k16 with P in registers and V from shared memory through
//   an MN-major descriptor (V is keys x hd, hd contiguous; transpose bit).
// * Within a warpgroup, S of tile j and P.V of tile j-1 are issued
//   together, and the softmax of tile j runs while P.V is in flight; O is
//   rescaled by tile j's alpha once P.V is in.
// * Softmax in registers: each row lives on the 4 threads of a quad; row
//   max by two xor shuffles; exponentials as 2^x on the special-function
//   unit with scale*log2(e) folded into one explicit __fmaf_rn (the shared
//   build flags carry -fmad=false); l kept per thread and summed over the
//   quad at the end.
//   Only the diagonal tile and the last, ragged key tile are masked.
// * Query tiles are launched last-first, so the long causal rows start
//   early.
//
// Key tile BK, by registers: ptxas allocates every thread of the block
// within the launch budget (65536 / 384 -> 168 registers; setmaxnreg
// moves registers at run time but does not raise that allocation), and a
// consumer thread holds O (hd/2 floats), S (BK/2) and P (BK/4 pairs) at
// once while P.V overlaps the softmax. BK = 128 at hd <= 64, 96 at
// hd = 128 (128 spills and serialises the wgmmas), 64 at hd = 192.
// Shared memory at hd = 128: Q 32 KB + 2 x (K 24 KB + V 24 KB).

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (no -lcuda: see encode_tiled)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;                 // query rows per block
constexpr int kStages = 2;               // K/V ring depth
constexpr int kThreads = 3 * 128;        // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;

template <int HD, int BK>
struct Tile {
  static constexpr int kBlocks = HD / 64;          // 64-column boxes
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = BK * HD * 2;
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;
  static_assert(HD % 64 == 0 && BK % 16 == 0, "whole boxes and k16 steps");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// one box of a 4-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from reading, moving or reusing registers that an
// asynchronous wgmma still writes or reads
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// 2^x on the special-function unit: what exp2f compiles to under
// -ftz=true (the shared build flags keep -ftz=false, whose exp2f wraps the
// same instruction in a range fix for results below 2^-126)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// m64nNk16 bf16 -> f32. The accumulator fragment: thread t of the
// warpgroup (warp w = t / 32, lane l) holds d[4j + 2i + c] at row
// 16w + l/4 + 8i, column 8j + 2(l%4) + c.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // D (64 x 64, f32) = (scale_d ? D : 0) + A (64 x 16) * B (16 x 64);
  // A and B from shared memory, both K-major
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // D += A (64 x 16, bf16 pairs in registers) * B (16 x 64); B MN-major
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  // D (64 x 96, f32) = (scale_d ? D : 0) + A (64 x 16) * B (16 x 96);
  // A and B from shared memory, both K-major
  static __device__ __forceinline__ void ss(float (&d)[48], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // D (64 x 128, f32) = (scale_d ? D : 0) + A (64 x 16) * B (16 x 128);
  // A and B from shared memory, both K-major
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // D += A (64 x 16, bf16 pairs in registers) * B (16 x 128); B MN-major
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  // D += A (64 x 16, bf16 pairs in registers) * B (16 x 192); B MN-major
  static __device__ __forceinline__ void rs(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// S = Q K^T for one key tile: 16 columns of the head dim per step, 4 steps
// per 64-column box; both operands K-major
template <int HD, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    Wgmma<BK>::ss(
        s,
        smem_desc(q_addr + (kk / 4) * (kBQ * 128) + (kk % 4) * 32, 16, 1024),
        smem_desc(k_addr + (kk / 4) * (BK * 128) + (kk % 4) * 32, 16, 1024),
        kk > 0);
}

// O += P V for one key tile: 16 keys per step; V MN-major, its 64-column
// boxes BK*128 bytes apart (leading offset), 8-key groups 1024 bytes apart
template <int HD, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         uint32_t (&p)[BK / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<HD>::rs(o, p[kk], smem_desc(v_addr + kk * 16 * 128, BK * 128, 1024));
}

// Fold one tile of raw scores into the running max m and sum l of the two
// rows this thread holds (row0 and row0 + 8; each row lives on the 4
// threads of a quad). Masked scores become -1e30 first; s becomes the
// unrounded p = exp(s * scale - m); alpha = exp(m_old - m) rescales O.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2], int k0,
                                             int row0, int col0, int t_len,
                                             int causal, int q_first,
                                             float scale_log2) {
  if (k0 + BK > t_len || (causal && k0 + BK - 1 > q_first)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = k0 + 8 * j + col0 + c;
          if (kpos >= t_len || (causal && kpos > row0 + 8 * i))
            s[4 * j + 2 * i + c] = kNegInf;
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m_run[i];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[i] = exp2_sfu((m_run[i] - mx) * scale_log2);
    m_run[i] = mx;
    const float neg_mc = -mx * scale_log2;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p =
            exp2_sfu(__fmaf_rn(s[4 * j + 2 * i + c], scale_log2, neg_mc));
        s[4 * j + 2 * i + c] = p;
        sum += p;
      }
    l_run[i] = __fmaf_rn(l_run[i], alpha[i], sum);
  }
}

// P as bf16 pairs: the S fragment of 16 keys is wgmma's A fragment
template <int BK>
__device__ __forceinline__ void to_bf16(const float (&s)[BK / 2],
                                        uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <int HD, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ out, int s_len, int t_len,
               int heads, int group, int hd, float scale_log2, int causal) {
  using Tl = Tile<HD, BK>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 4 * kStages];
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + Tl::kQBytes;                  // kStages K tiles
  uint8_t* sv = sk + kStages * Tl::kKVBytes;       // kStages V tiles

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int q0 = static_cast<int>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_last = min(q0 + kBQ, s_len) - 1;
  const int k_end = causal ? min(q_last + 1, t_len) : t_len;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(k_empty + i, kConsumerWarps);
      mbar_init(v_empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(q_full, Tl::kQBytes);
      for (int c = 0; c < Tl::kBlocks; ++c)
        tma_load(sq + c * kBQ * 128, &tm_q, q_full, c * 64, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t par = ((it / kStages) & 1) ^ 1;  // first round free
        uint8_t* dk = sk + st * Tl::kKVBytes;
        uint8_t* dv = sv + st * Tl::kKVBytes;
        mbar_wait(k_empty + st, par);
        mbar_expect_tx(k_full + st, Tl::kKVBytes);
        for (int c = 0; c < Tl::kBlocks; ++c)
          tma_load(dk + c * BK * 128, &tm_k, k_full + st, c * 64, it * BK,
                   kvh, b);
        mbar_wait(v_empty + st, par);
        mbar_expect_tx(v_full + st, Tl::kKVBytes);
        for (int c = 0; c < Tl::kBlocks; ++c)
          tma_load(dv + c * BK * 128, &tm_v, v_full + st, c * 64, it * BK,
                   kvh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x - 128;
    const int cw = tid / 128;                   // 64-row half of the tile
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const int q_first = q0 + cw * 64;
    const uint32_t q_addr = smem_u32(sq) + cw * 64 * 128;
    const uint32_t k_addr = smem_u32(sk);
    const uint32_t v_addr = smem_u32(sv);

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};
    float alpha[2];
    float s[BK / 2];
    uint32_t p[BK / 16][4];

    // tile 0: S, softmax, P
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    wgmma_fence();
    issue_qk<HD, BK>(s, q_addr, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty, lane);
    softmax_tile<BK>(s, m_run, l_run, alpha, 0, row0, col0, t_len, causal,
                     q_first, scale_log2);
    to_bf16<BK>(s, p);

    // tile it: S of tile it and O += P V of tile it - 1 in flight together;
    // the softmax of tile it runs while P V still does
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int pst = (it - 1) % kStages;
      mbar_wait(k_full + st, (it / kStages) & 1);
      wgmma_fence();
      issue_qk<HD, BK>(s, q_addr, k_addr + st * Tl::kKVBytes);
      wgmma_commit();
      mbar_wait(v_full + pst, ((it - 1) / kStages) & 1);
      issue_pv<HD, BK>(o, p, v_addr + pst * Tl::kKVBytes);
      wgmma_commit();
      wgmma_wait<1>();                        // S is in
      fence_regs(s);
      release(k_empty + st, lane);
      softmax_tile<BK>(s, m_run, l_run, alpha, it * BK, row0, col0, t_len,
                       causal, q_first, scale_log2);
      wgmma_wait<0>();                        // P V is in
      fence_regs(o);
      fence_regs(p);
      release(v_empty + pst, lane);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= alpha[i];
          o[4 * j + 2 * i + 1] *= alpha[i];
        }
      to_bf16<BK>(s, p);
    }

    const int last = (n_tiles - 1) % kStages;
    mbar_wait(v_full + last, ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv<HD, BK>(o, p, v_addr + last * Tl::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);

    // out = acc / max(l, 1e-30), l summed over the quad that holds the row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      // one correctly rounded reciprocal per row, then multiplies: within
      // one f32 ulp of acc / max(l, 1e-30) without 64 divisions a thread
      const float inv = __frcp_rn(fmaxf(l, 1e-30f));
      const int row = row0 + 8 * i;
      if (row >= s_len) continue;
      __nv_bfloat16* orow =
          out + ((static_cast<int64_t>(b) * s_len + row) * heads + h) * hd;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                    o[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, heads, batch) of hd bf16 values with element strides st = (batch,
// row, head), cut into boxes of 64 columns x box_rows rows
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* base,
                int64_t hd, int64_t rows, int64_t heads, int64_t batch,
                const int64_t* st, uint32_t box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, box_rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// encode the three tensor maps (Q boxes of kBQ rows, K and V boxes of BK
// rows) and launch; the cudaError_t of the launch, or kEncodeFailed + the
// CUresult of a refused map
constexpr int kNoEncoder = 1000;
constexpr int kEncodeFailed = 2000;

template <int HD, int BK>
int launch(EncodeTiled fn, const void* q, const void* k, const void* v,
           void* out, int64_t batch, int64_t s_len, int64_t t_len,
           int64_t heads, int64_t kv_heads, int64_t hd,
           const int64_t* strides, float scale_log2, int causal,
           cudaStream_t stream) {
  CUtensorMap maps[3];
  CUresult res = encode(fn, &maps[0], q, hd, s_len, heads, batch, strides,
                        kBQ);
  if (res == CUDA_SUCCESS)
    res = encode(fn, &maps[1], k, hd, t_len, kv_heads, batch, strides + 3,
                 BK);
  if (res == CUDA_SUCCESS)
    res = encode(fn, &maps[2], v, hd, t_len, kv_heads, batch, strides + 6,
                 BK);
  if (res != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(res);
  constexpr int bytes = Tile<HD, BK>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((s_len + kBQ - 1) / kBQ));
  flash_fwd_bf16<HD, BK><<<grid, kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out),
      static_cast<int>(s_len), static_cast<int>(t_len),
      static_cast<int>(heads), static_cast<int>(heads / kv_heads),
      static_cast<int>(hd), scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. q (B,S,H,hd), k and v (B,T,KV,hd)
// bf16 on the device, 16-byte aligned, with a contiguous last dim and the
// given element strides, each a multiple of 8 (strides[0..2] = q's b, s,
// h; [3..5] = k's b, t, kv; [6..8] = v's); out (B,S,H,hd) contiguous bf16.
// hd in {16, 32, 64, 128, 192}; H % KV == 0; 1 <= S, T < 2^31. scale_log2
// = log2(e) / sqrt(hd). Returns the cudaError_t of the launch (0 =
// launched), 1000 when the driver has no cuTensorMapEncodeTiled, or
// 2000 + the CUresult when a tensor map is refused.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* out,
                                          int64_t batch, int64_t s_len,
                                          int64_t t_len, int64_t heads,
                                          int64_t kv_heads, int64_t hd,
                                          const int64_t* strides,
                                          float scale_log2, int causal,
                                          void* stream) {
  if (batch <= 0 || s_len <= 0 || t_len <= 0 || heads <= 0 ||
      kv_heads <= 0 || heads % kv_heads != 0 || s_len > 0x7fffffffLL ||
      t_len > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (batch * heads > 0x7fffffffLL || (s_len + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
    case 32:
    case 64:
      return launch<64, 128>(fn, q, k, v, out, batch, s_len, t_len, heads,
                             kv_heads, hd, strides, scale_log2, causal, st);
    case 128:
      return launch<128, 96>(fn, q, k, v, out, batch, s_len, t_len, heads,
                             kv_heads, hd, strides, scale_log2, causal, st);
    case 192:
      return launch<192, 64>(fn, q, k, v, out, batch, s_len, t_len, heads,
                             kv_heads, hd, strides, scale_log2, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}
