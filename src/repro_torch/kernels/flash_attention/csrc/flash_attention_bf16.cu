// GQA flash attention (online softmax, causal and key-padding masks) in
// bfloat16 or float16 on Hopper's tensor cores (sm_90a: TMA, mbarrier,
// wgmma, warp specialisation).
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
// output is acc / max(l, 1e-30) rounded once to the input type. One
// rounding more than the TPU kernel: the probabilities p enter the P.V
// product in the input type, as in every tensor-core flash kernel (l sums
// the unrounded p). Key tiles wholly above the causal diagonal are
// skipped: in the TPU kernel such a tile adds exactly nothing, because key
// 0 is never masked.
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
// * The grid's x walks the query tiles, the last (with the most keys
//   under a causal mask) first, and y the (b, h) pairs, so the blocks on
//   the card at once share one head's K and V through the L2. With (b, h)
//   on x they would each belong to another pair of an MHA batch and
//   stream their own K and V from HBM (half the rate a sequence at
//   HuBERT-XLarge's 8 x 32 768).
// * TMA: q (B,S,H,hd) and k, v (B,T,KV,hd) are described in place as 4-D
//   tensor maps with their real strides (16-byte aligned, checked by the
//   wrapper); a tile lands in shared memory with the 128-byte swizzle, one
//   box per 64 columns of the layout width HDL (64, 128 or 192, the
//   multiple of 64 at or above hd). The map's inner extent is the real hd,
//   so columns past hd arrive as zeros: any hd that is a multiple of 8
//   (TMA's 16-byte stride rule) runs, in the instance of its layout width.
// * The compute width HDC is the head dim the products cover: HDL, except
//   at hd 72 and 80 (HuBERT-XLarge), whose instance keeps the 128 layout
//   and covers 80 columns: S = Q.K^T in 5 k16 steps (the fifth from box
//   1), O += P.V as one wgmma m64n80k16 a step (its MN-major descriptor
//   reads columns 64..79 from box 1, a leading offset away), O 40 floats
//   a thread, 80 columns stored.
// * S = Q.K^T is wgmma m64n{BK}k16 with both operands in shared memory
//   (K-major descriptors, 128-byte swizzle). The f32 accumulator of S,
//   after the softmax, is converted to 16-bit pairs in place: that is
//   exactly the register layout of wgmma's A operand, so O += P.V is
//   wgmma m64n{HDC}k16 with P in registers and V from shared memory
//   through an MN-major descriptor (V is keys x hd, hd contiguous;
//   transpose bit).
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
// * bfloat16 and float16 share the kernel: the type picks the wgmma's
//   input type, the conversion of P and of the output, and the TMA type.
//
// Key tile BK, by registers: ptxas allocates every thread of the block
// within the launch budget (65536 / 384 -> 168 registers; setmaxnreg
// moves registers at run time but does not raise that allocation), and a
// consumer thread holds O (HDC/2 floats), S (BK/2) and P (BK/4 pairs) at
// once while P.V overlaps the softmax. BK = 128 at HDC <= 80 (136 of
// those registers at 80), 96 at HDC = 128 (128 spills and serialises the
// wgmmas), 64 at HDC = 192. Shared memory at HDL = 128: Q 32 KB + 2 x (K
// + V), 24 KB each at BK = 96, 32 KB at BK = 128.

#include <cstdint>
#include <type_traits>

#include <cuda.h>  // CUtensorMap and its enums (no -lcuda: see encode_tiled)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;                 // query rows per block
constexpr int kStages = 2;               // K/V ring depth
constexpr int kThreads = 3 * 128;        // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;
constexpr int kMaxHeadDim = 192;

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// the shared-memory tiles of layout width HDL (64-column boxes of 2-byte
// values) for key tiles of BK rows; the products cover HDC columns
template <int HDL, int HDC, int BK>
struct Tile {
  static constexpr int kBlocks = HDL / 64;         // 64-column boxes
  static constexpr int kQBytes = kBQ * HDL * 2;
  static constexpr int kKVBytes = BK * HDL * 2;
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;
  static_assert(HDL % 64 == 0 && HDC % 16 == 0 && HDC <= HDL &&
                    HDC > HDL - 64 && BK % 16 == 0,
                "whole boxes, k16 steps, and every box computed on");
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

// two floats as one pair of T, rounded to nearest even, in a register
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// m64nNk16 with 16-bit inputs -> f32. The accumulator fragment: thread t of
// the warpgroup (warp w = t / 32, lane l) holds d[4j + 2i + c] at row
// 16w + l/4 + 8i, column 8j + 2(l%4) + c.
template <typename T, int N>
struct Wgmma;

// the accumulators as asm operands: the register list D of N/2 floats and
// the matching output constraints OUT, 8 at a time
#define L0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define L1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define L2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define L3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define L4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define L5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define L6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define L7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define L8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define L9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define L10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define L11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define D32 "{" L0 ", " L1 ", " L2 ", " L3 "}"
#define D40 "{" L0 ", " L1 ", " L2 ", " L3 ", " L4 "}"
#define D48 "{" L0 ", " L1 ", " L2 ", " L3 ", " L4 ", " L5 "}"
#define D64 "{" L0 ", " L1 ", " L2 ", " L3 ", " L4 ", " L5 ", " L6 ", " L7 "}"
#define D96                                                               \
  "{" L0 ", " L1 ", " L2 ", " L3 ", " L4 ", " L5 ", " L6 ", " L7 ", " L8 \
  ", " L9 ", " L10 ", " L11 "}"
#define F8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define F32(i) F8(i), F8(i + 8), F8(i + 16), F8(i + 24)
#define OUT32 F32(0)
#define OUT40 F32(0), F8(32)
#define OUT48 F32(0), F8(32), F8(40)
#define OUT64 F32(0), F32(32)
#define OUT96 F32(0), F32(32), F32(64)

// D (64 x N, f32) = (P ? D : 0) + A (64 x 16) * B (16 x N); A and B from
// shared memory, both K-major; TY is the inputs' type, bf16 or f16
#define WGMMA_SS(N, TY, D, A, B, P)                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                     \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " " D \
  ", " A ", " B ", p, 1, 1, 0, 0;\n}\n"
// D += A (64 x 16, 16-bit pairs in registers) * B (16 x N); B MN-major
#define WGMMA_RS(N, TY, D, A, B, P)                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                     \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " " D \
  ", " A ", " B ", p, 1, 1, 1;\n}\n"

// Wgmma<T, N>::ss and ::rs. After the R = N/2 accumulators come ss's A,
// B and scale_d (operands R, R+1, R+2) and rs's four A registers, B and
// scale_d (R..R+3, R+4, R+5).
#define DEFINE_WGMMA(N, R, SA, SB, SP, RA, RB, RP)                          \
  template <typename T>                                                     \
  struct Wgmma<T, N> {                                                      \
    static __device__ __forceinline__ void ss(float (&d)[R], uint64_t a,    \
                                              uint64_t b, int scale_d) {    \
      if constexpr (kIsHalf<T>)                                             \
        asm volatile(WGMMA_SS(N, "f16", D##R, SA, SB, SP)                   \
                     : OUT##R : "l"(a), "l"(b), "r"(scale_d));              \
      else                                                                  \
        asm volatile(WGMMA_SS(N, "bf16", D##R, SA, SB, SP)                  \
                     : OUT##R : "l"(a), "l"(b), "r"(scale_d));              \
    }                                                                       \
    static __device__ __forceinline__ void rs(float (&d)[R],                \
                                              const uint32_t (&a)[4],       \
                                              uint64_t b) {                 \
      if constexpr (kIsHalf<T>)                                             \
        asm volatile(WGMMA_RS(N, "f16", D##R, RA, RB, RP)                   \
                     : OUT##R                                               \
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),  \
                       "r"(1));                                             \
      else                                                                  \
        asm volatile(WGMMA_RS(N, "bf16", D##R, RA, RB, RP)                  \
                     : OUT##R                                               \
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),  \
                       "r"(1));                                             \
    }                                                                       \
  };

DEFINE_WGMMA(64, 32, "%32", "%33", "%34", "{%32, %33, %34, %35}", "%36",
             "%37")
DEFINE_WGMMA(80, 40, "%40", "%41", "%42", "{%40, %41, %42, %43}", "%44",
             "%45")
DEFINE_WGMMA(96, 48, "%48", "%49", "%50", "{%48, %49, %50, %51}", "%52",
             "%53")
DEFINE_WGMMA(128, 64, "%64", "%65", "%66", "{%64, %65, %66, %67}", "%68",
             "%69")
DEFINE_WGMMA(192, 96, "%96", "%97", "%98", "{%96, %97, %98, %99}", "%100",
             "%101")

// S = Q K^T for one key tile: 16 columns of the head dim per step, 4 steps
// per 64-column box, HDC / 16 in all; both operands K-major
template <typename T, int HDC, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < HDC / 16; ++kk)
    Wgmma<T, BK>::ss(
        s,
        smem_desc(q_addr + (kk / 4) * (kBQ * 128) + (kk % 4) * 32, 16, 1024),
        smem_desc(k_addr + (kk / 4) * (BK * 128) + (kk % 4) * 32, 16, 1024),
        kk > 0);
}

// O += P V for one key tile: 16 keys per step; V MN-major, its 64-column
// boxes BK*128 bytes apart (leading offset), 8-key groups 1024 bytes apart.
// At HDC = 80 one n80 wgmma reads columns 64..79 from the second box.
template <typename T, int HDC, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[HDC / 2],
                                         uint32_t (&p)[BK / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<T, HDC>::rs(o, p[kk],
                      smem_desc(v_addr + kk * 16 * 128, BK * 128, 1024));
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

// P as pairs of T: the S fragment of 16 keys is wgmma's A fragment
template <typename T, int BK>
__device__ __forceinline__ void to_pairs(const float (&s)[BK / 2],
                                         uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <typename T, int HDL, int HDC, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out,
             int s_len, int t_len, int heads, int group, int hd,
             float scale_log2, int causal) {
  using Tl = Tile<HDL, HDC, BK>;
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

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = static_cast<int>(gridDim.x - 1 - blockIdx.x) * kBQ;
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

    float o[HDC / 2];
#pragma unroll
    for (int i = 0; i < HDC / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};
    float alpha[2];
    float s[BK / 2];
    uint32_t p[BK / 16][4];

    // tile 0: S, softmax, P
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    wgmma_fence();
    issue_qk<T, HDC, BK>(s, q_addr, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty, lane);
    softmax_tile<BK>(s, m_run, l_run, alpha, 0, row0, col0, t_len, causal,
                     q_first, scale_log2);
    to_pairs<T, BK>(s, p);

    // tile it: S of tile it and O += P V of tile it - 1 in flight together;
    // the softmax of tile it runs while P V still does
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int pst = (it - 1) % kStages;
      mbar_wait(k_full + st, (it / kStages) & 1);
      wgmma_fence();
      issue_qk<T, HDC, BK>(s, q_addr, k_addr + st * Tl::kKVBytes);
      wgmma_commit();
      mbar_wait(v_full + pst, ((it - 1) / kStages) & 1);
      issue_pv<T, HDC, BK>(o, p, v_addr + pst * Tl::kKVBytes);
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
      for (int j = 0; j < HDC / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= alpha[i];
          o[4 * j + 2 * i + 1] *= alpha[i];
        }
      to_pairs<T, BK>(s, p);
    }

    const int last = (n_tiles - 1) % kStages;
    mbar_wait(v_full + last, ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv<T, HDC, BK>(o, p, v_addr + last * Tl::kKVBytes);
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
      T* orow =
          out + ((static_cast<int64_t>(b) * s_len + row) * heads + h) * hd;
#pragma unroll
      for (int j = 0; j < HDC / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < hd)
          *reinterpret_cast<uint32_t*>(orow + col) = pack2<T>(
              o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
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

// (rows, heads, batch) of hd 16-bit values of TMA type `type` with
// element strides st = (batch, row, head), cut into boxes of 64 columns x
// box_rows rows
CUresult encode(EncodeTiled fn, CUtensorMapDataType type, CUtensorMap* map,
                const void* base, int64_t hd, int64_t rows, int64_t heads,
                int64_t batch, const int64_t* st, uint32_t box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, box_rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, type, 4,
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

template <typename T, int HDL, int HDC, int BK>
int launch(EncodeTiled fn, const void* q, const void* k, const void* v,
           void* out, int64_t batch, int64_t s_len, int64_t t_len,
           int64_t heads, int64_t kv_heads, int64_t hd,
           const int64_t* strides, float scale_log2, int causal,
           cudaStream_t stream) {
  const CUtensorMapDataType type = kIsHalf<T>
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[3];
  CUresult res = encode(fn, type, &maps[0], q, hd, s_len, heads, batch,
                        strides, kBQ);
  if (res == CUDA_SUCCESS)
    res = encode(fn, type, &maps[1], k, hd, t_len, kv_heads, batch,
                 strides + 3, BK);
  if (res == CUDA_SUCCESS)
    res = encode(fn, type, &maps[2], v, hd, t_len, kv_heads, batch,
                 strides + 6, BK);
  if (res != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(res);
  constexpr int bytes = Tile<HDL, HDC, BK>::kSmem;
  auto* kernel = flash_fwd_tc<T, HDL, HDC, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((s_len + kBQ - 1) / kBQ),
                  static_cast<unsigned>(batch * heads));
  kernel<<<grid, kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<T*>(out),
      static_cast<int>(s_len), static_cast<int>(t_len),
      static_cast<int>(heads), static_cast<int>(heads / kv_heads),
      static_cast<int>(hd), scale_log2, causal);
  return cudaGetLastError();
}

// the instance for hd: layout width HDL (the multiple of 64 at or above
// hd), compute width HDC (HDL, or 80 for hd 72 and 80), key tile BK
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int64_t batch, int64_t s_len, int64_t t_len, int64_t heads,
             int64_t kv_heads, int64_t hd, const int64_t* strides,
             float scale_log2, int causal, void* stream) {
  if (batch <= 0 || s_len <= 0 || t_len <= 0 || heads <= 0 ||
      kv_heads <= 0 || heads % kv_heads != 0 || s_len > 0x7fffffffLL ||
      t_len > 0x7fffffffLL || hd <= 0 || hd > kMaxHeadDim || hd % 8 != 0)
    return cudaErrorInvalidValue;
  if (batch * heads > 65535) return cudaErrorInvalidValue;  // gridDim.y
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch<T, 64, 64, 128>(fn, q, k, v, out, batch, s_len, t_len,
                                  heads, kv_heads, hd, strides, scale_log2,
                                  causal, st);
  if (hd <= 80)
    return launch<T, 128, 80, 128>(fn, q, k, v, out, batch, s_len, t_len,
                                   heads, kv_heads, hd, strides, scale_log2,
                                   causal, st);
  if (hd <= 128)
    return launch<T, 128, 128, 96>(fn, q, k, v, out, batch, s_len, t_len,
                                   heads, kv_heads, hd, strides, scale_log2,
                                   causal, st);
  return launch<T, 192, 192, 64>(fn, q, k, v, out, batch, s_len, t_len,
                                 heads, kv_heads, hd, strides, scale_log2,
                                 causal, st);
}

}  // namespace

// Plain C entry points, loaded with ctypes, one a type. q (B,S,H,hd), k
// and v (B,T,KV,hd) bf16 (or f16) on the device, 16-byte aligned, with a
// contiguous last dim and the given element strides, each a multiple of 8
// (strides[0..2] = q's b, s, h; [3..5] = k's b, t, kv; [6..8] = v's); out
// (B,S,H,hd) contiguous, of the same type. hd a multiple of 8 up to 192;
// H % KV == 0; B·H <= 65535; 1 <= S, T < 2^31. scale_log2 = log2(e) /
// sqrt(hd).
// Returns the cudaError_t of the launch (0 = launched), 1000 when the
// driver has no cuTensorMapEncodeTiled, or 2000 + the CUresult when a
// tensor map is refused.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* out,
                                          int64_t batch, int64_t s_len,
                                          int64_t t_len, int64_t heads,
                                          int64_t kv_heads, int64_t hd,
                                          const int64_t* strides,
                                          float scale_log2, int causal,
                                          void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, batch, s_len, t_len, heads,
                                 kv_heads, hd, strides, scale_log2, causal,
                                 stream);
}

extern "C" int repro_flash_attention_f16(const void* q, const void* k,
                                         const void* v, void* out,
                                         int64_t batch, int64_t s_len,
                                         int64_t t_len, int64_t heads,
                                         int64_t kv_heads, int64_t hd,
                                         const int64_t* strides,
                                         float scale_log2, int causal,
                                         void* stream) {
  return dispatch<__half>(q, k, v, out, batch, s_len, t_len, heads, kv_heads,
                          hd, strides, scale_log2, causal, stream);
}
