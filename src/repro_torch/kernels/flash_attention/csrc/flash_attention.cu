// GQA flash attention (online softmax, causal and key-padding masks) in
// float32 on the CUDA cores, for Hopper (sm_90a). bfloat16 and float16
// inputs go to the tensor-core kernel of flash_attention_bf16.cu instead.
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
// accumulator acc in float32; masked scores are -1e30 (not -inf), every
// exponential is expf (no fast-math), and the output is acc / max(l, 1e-30).
// The TPU kernel's grid walks the key axis in order and carries m, l, acc
// in VMEM scratch; here one block owns a query tile and loops over the key
// tiles itself. q (B,S,H,hd) and k/v (B,T,KV,hd) are read in place through
// their strides (last dim contiguous) instead of the TPU wrapper's
// transposes and pads; the block masks the ragged edges itself (q rows and
// k/v rows past the end load as 0, their scores as -1e30). Key tiles that
// lie wholly above the causal diagonal are skipped: in the TPU kernel such a
// tile adds exactly nothing (p = exp(-1e30 - m) = 0, alpha = 1), because key
// 0 is never masked and so m is finite after the first tile.
//
// Design (simple and right, kept for float32): a block of 256 threads owns
// 64 query rows; K/V tiles of 32 rows are staged in shared memory (Q
// transposed, K transposed, V as is, each padded against bank conflicts;
// 75 KB at hd = 128, 108 KB at hd = 192). Thread (tx, ty) of the 16 x 16
// block owns query rows ty + 16 i (i < 4): the scores of keys tx + 16 j
// (j < 2) and output columns tx + 16 c (c < HD/16), with m, l and acc in
// registers. An instance of width HD (16, 32, 64, 80, 128 or 192) serves
// every hd up to it: columns past hd load as 0 (they add nothing to a
// score) and are not stored. Row max
// and row sum are reduced over the 16 threads of a row with xor shuffles
// (every lane ends with the same bits). P goes through shared memory to the
// PV product. Both products run on the float32 CUDA cores, with explicit
// fused multiply-adds (__fmaf_rn): the shared build flags carry
// -fmad=false, which forbids only contracting a separate multiply and add.
// Query tiles are launched last-first, so the long causal rows start early.
//
// Bound: float32 has no tensor-core path that keeps the 2e-5 agreement
// (TF32 keeps 10 mantissa bits), so its operations are bound by the
// 67 TFLOP/s float32 CUDA-core peak: 2*B*H*S*T*hd over that rate.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 32;                  // keys per K/V tile
constexpr int kSide = 16;                // threads per tile edge
constexpr int kThreads = kSide * kSide;  // 256
constexpr int kRows = kBQ / kSide;       // query rows per thread
constexpr int kKeys = kBK / kSide;       // keys per thread per tile
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr int smem_floats() {
  return HD * (kBQ + 1)      // qt[d][r]
         + HD * (kBK + 1)    // kt[d][c]
         + kBK * HD          // vs[c][d]
         + kBQ * (kBK + 1);  // ps[r][c]
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int64_t s_len,
          int64_t t_len, int heads, int group, int hd, int64_t qsb, int64_t qss,
          int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
          int64_t vss, int64_t vsh, float scale, int causal) {
  constexpr int kCols = HD / kSide;      // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;
  float* kt = qt + HD * (kBQ + 1);
  float* vs = kt + HD * (kBK + 1);
  float* ps = vs + kBK * HD;

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  for (int idx = threadIdx.x; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int64_t gr = q0 + r;
    qt[d * (kBQ + 1) + r] = gr < s_len && d < hd ? qb[gr * qss + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int64_t q_last = (q0 + kBQ < s_len ? q0 + kBQ : s_len) - 1;
  const int64_t k_end = causal && q_last + 1 < t_len ? q_last + 1 : t_len;
  for (int64_t k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                     // the previous tile is spent
    for (int idx = threadIdx.x; idx < kBK * HD; idx += kThreads) {
      const int c = idx / HD, d = idx % HD;
      const int64_t gk = k0 + c;
      const bool in = gk < t_len && d < hd;
      kt[d * (kBK + 1) + c] = in ? kb[gk * kss + d] : 0.f;
      vs[c * HD + d] = in ? vb[gk * vss + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qt[d * (kBQ + 1) + ty + i * kSide];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = kt[d * (kBK + 1) + tx + j * kSide];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t qpos = q0 + ty + i * kSide;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int64_t kpos = k0 + tx + j * kSide;
        const bool keep = kpos < t_len && (!causal || kpos <= qpos);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = kSide / 2; off > 0; off /= 2)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + i * kSide) * (kBK + 1) + tx + j * kSide] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = kSide / 2; off > 0; off /= 2)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + i * kSide) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * HD + tx + c * kSide];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = __fmaf_rn(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t gr = q0 + ty + i * kSide;
    if (gr >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + ((b * s_len + gr) * heads + h) * hd;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (tx + c * kSide < hd) orow[tx + c * kSide] = acc[i][c] / denom;
  }
}

static_assert(kBQ % kSide == 0 && kBK % kSide == 0, "tiles split evenly");
static_assert(kSide == 16, "row reductions shuffle within a half-warp");

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t batch, int64_t s_len, int64_t t_len, int heads,
                   int group, int hd, const int64_t* st, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((s_len + kBQ - 1) / kBQ));
  flash_fwd<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s_len, t_len,
      heads, group, hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale, causal);
  return cudaGetLastError();
}

// the instance of the smallest width at or above hd
cudaError_t dispatch_hd(int64_t hd, const void* q, const void* k,
                        const void* v, void* out, int64_t batch,
                        int64_t s_len, int64_t t_len, int heads, int group,
                        const int64_t* st, float scale, int causal,
                        cudaStream_t stream) {
  auto* fn = hd <= 16 ? launch<16>
             : hd <= 32 ? launch<32>
             : hd <= 64 ? launch<64>
             : hd <= 80 ? launch<80>
             : hd <= 128 ? launch<128>
                         : launch<192>;
  if (hd <= 0 || hd > 192) return cudaErrorInvalidValue;
  return fn(q, k, v, out, batch, s_len, t_len, heads, group,
            static_cast<int>(hd), st, scale, causal, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. q (B,S,H,hd), k and v (B,T,KV,hd)
// float32 on the device with a contiguous last dim and the given element
// strides (strides[0..2] = q's b, s, h; [3..5] = k's b, t, kv; [6..8] =
// v's); out (B,S,H,hd) contiguous float32. 1 <= hd <= 192;
// H % KV == 0; S >= 1, T >= 1. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* out,
                                         int64_t batch, int64_t s_len,
                                         int64_t t_len, int64_t heads,
                                         int64_t kv_heads, int64_t hd,
                                         const int64_t* strides, float scale,
                                         int causal, void* stream) {
  if (batch <= 0 || s_len <= 0 || t_len <= 0 || heads <= 0 ||
      kv_heads <= 0 || heads % kv_heads != 0)
    return cudaErrorInvalidValue;
  if (batch * heads > 0x7fffffffLL || (s_len + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  return dispatch_hd(hd, q, k, v, out, batch, s_len, t_len,
                     static_cast<int>(heads),
                     static_cast<int>(heads / kv_heads), strides, scale,
                     causal, static_cast<cudaStream_t>(stream));
}
