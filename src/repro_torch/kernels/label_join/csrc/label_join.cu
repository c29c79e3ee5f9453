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
// widen() is the identity for float32 storage; for uint16 / int16 codes
// it maps the sentinel to +inf and any other code to its exact float
// value, and the result is then multiplied once by `scale` — the same
// arithmetic as the JAX package's quantized join, so answers match it bit
// for bit: min is exact and order-free, a + b is one IEEE float add,
// codes < 2^16 and their sums are exact in float, and `* scale` is one
// float multiply. bfloat16 and float16 rows widen exactly to float32, the
// add and the mins run in float32, and out (and lb) are rounded once to
// the rows' type (round to nearest even), as join_pallas and
// join_lb_pallas widen with astype(float32) and return astype(s.dtype).
// Built without fast-math and with -fmad=false so nothing is contracted.
//
// What bounds it: memory. Each query reads 2·W elements and does one add
// and one min on each (plus two mins with WITH_LB) — far below the card's
// operations-per-byte balance point. What held the first design (one warp
// per query, 4- or 2-byte loads) at 35 % of its bound: a lane had only 3
// to 8 loads in flight at W = 96–256, and each warp loaded its row ids
// and only then its rows, two dependent HBM latencies per query. Design:
//   * a query is served by a group of `group` lanes (1–32, a power of
//     two, picked by the C entry so that a lane loads at most kUnroll
//     vectors of each row, and so that a small batch still spreads over
//     the SMs): 8 lanes x 16 B at W = 96 float32, so a warp serves
//     several queries;
//   * rows are read with V-byte vector loads through the read-only path
//     (V = 16, 8, 4, or 2 for 16-bit codes, picked by the C entry from
//     the row pitch and the tables' base alignment: a contiguous slice
//     can start off 16 B); a 16-byte load carries 8 codes;
//   * one block a tile of kThreads / group queries, the whole batch in
//     one grid: on the H100 a persistent grid-stride loop that fetched
//     the next tile's ids ahead was no faster at 65 536 queries and up to
//     13 % slower at the engine's 4096 and the rebuild window's 167;
//   * a group issues all its row loads before its first min. At small
//     batches the arithmetic after the rows land is on the critical
//     path, so 16-bit codes widen with one integer and one float op (not
//     the quarter-rate I2F conversion), and a sum with a sentinel is
//     skipped rather than made +inf;
//   * a __shfl_xor_sync butterfly over the group's lanes reduces the
//     partial mins and the group's first lane writes the result.
// A row id outside its table yields +inf instead of a fault (the Python
// wrapper rejects such ids before launching).
//
// multi_shard_join_kernel is the sharded serving join of a whole batch
// in one launch. It replaces join_pallas as the JAX package runs it
// under shard_map in kernels/label_join/ops.py (join_sharded_gathered,
// join_sharded_border_gathered): per shard the gathers, the pad to W, the
// select, the join and the owner mask, then the pmin over the shards.
// Every logical shard (or edge server) on the card is one entry of a
// shard table passed by value as a __grid_constant__ parameter (32 bytes
// an entry, at most 64 entries: 2 KB of the 4 KB parameter space), so no
// lane pays a dependent load to find its shard's tables. A lane loads its
// owner and its two row ids (three independent loads: one latency) and
// takes entry owner - owner_base. A row id r below the entry's
// block_rows is row r of its district block (pitch W); any other is
// border row v = r - block_rows: row v of the entry's own border source
// (B replicated, or a scatter-gather server's view), or, with row-sharded
// B (rows_pd > 0), row v % rows_pd of entry v / rows_pd's slice, read in
// place. Each B row lives in one shard, so that is the row the
// reference's ragged gather and pmin assemble, bit for bit. Lanes >= bw
// of a border row are the reference's padding (+inf, or the sentinel),
// which never win the min, so the fold runs over W lanes when both rows
// come from the block and over the first bw lanes otherwise. One shard
// owns each lane, so the pmin over the shards is the owner's value: the
// lane writes it to out[lane] and no seam runs. An owner outside the
// table, or a row id outside its source, gives +inf and loads no row.
// Three arithmetics (MODE): float32 rows; 16-bit codes joined in code
// units and scaled once (as gather_join_kernel; the sharded engine's
// uint16 path); 16-bit codes dequantized per element before the add,
// code * scale in one float32 multiply with the sentinel +inf, which is
// the scatter-gather plane's dequantize-then-join. Under a lossy scale
// (a + b)·s and a·s + b·s differ; each mode matches its own reference.
// What bounds it is what bounds gather_join_kernel: 2·W elements read a
// lane and 2 operations on each, memory latency at the engine's 4096
// lanes (rows L2-resident) and bytes at the center's 65 536. The design
// answer is the launch structure: one grid over all Q lanes fills the 132
// SMs (a launch a shard would spend (E - 1) / E of its groups on lanes
// that only load ids, and leave E - 1 seams), and the vector width and
// the lanes a query are picked once for the batch, over both pitches and
// every base address in the table. The owner's entry (and, row-sharded,
// the slice's) is one dependent lookup in the parameter bank between the
// ids and the rows.

#include <atomic>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // vectors of each row a lane keeps in flight

template <int V> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<2> { using type = uint16_t; };

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word(const uint2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }
__device__ __forceinline__ uint32_t word(uint16_t v, int) { return v; }

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// What a storage type is to the join: 16-bit codes (a sentinel, one
// scale) or float rows, and the type of out and lb (float32, or the
// rows' own 16-bit float type).
template <typename T> struct Storage {
  static constexpr bool kCodes = false;
  using Out = float;
};
template <> struct Storage<uint16_t> {
  static constexpr bool kCodes = true;
  using Out = float;
};
template <> struct Storage<int16_t> {
  static constexpr bool kCodes = true;
  using Out = float;
};
template <> struct Storage<__nv_bfloat16> {
  static constexpr bool kCodes = false;
  using Out = __nv_bfloat16;
};
template <> struct Storage<__half> {
  static constexpr bool kCodes = false;
  using Out = __half;
};

// a float32 result in the output type: one rounding to nearest even
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put(__half* p, float x) {
  *p = __float2half_rn(x);
}

// element e of a loaded vector as a float (little-endian halves). A
// 16-bit code c becomes float(c) without the quarter-rate I2F: the
// pattern 2^23 + (c + bias), bias 0 (uint16) or 2^15 (int16), is that
// float exactly, and subtracting 2^23 + bias is one exact float add, so
// the value (and its bits: +0.0 for c = 0) is static_cast<float>(c)'s.
// A bfloat16 is the high half of its float32; a float16 widens exactly.
template <typename T, typename VT>
__device__ __forceinline__ float element(const VT& v, int e) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(word(v, e));
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __uint_as_float(((word(v, e / 2) >> (16 * (e % 2))) & 0xFFFFu)
                           << 16);
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(
        word(v, e / 2) >> (16 * (e % 2)))));
  } else {
    constexpr bool kSigned = std::is_same<T, int16_t>::value;
    const uint32_t bits = (word(v, e / 2) >> (16 * (e % 2))) & 0xFFFFu;
    return __uint_as_float(0x4B000000u | (kSigned ? bits ^ 0x8000u : bits)) -
           (kSigned ? 8421376.0f : 8388608.0f);
  }
}

// One group's share of two rows: lane `lane` of `group` lanes folds the
// vectors lane, lane + group, ... of each row into acc (and, WITH_LB,
// each row's own minimum), issuing up to kUnroll vectors of each row
// before its first min. A code table's sentinel (its type's largest
// code) stands for +inf, so a sum with one never lowers acc: such a sum
// is skipped, and max(a, b) is the sentinel exactly when either is.
// DEQ dequantizes each code before the add: a·scale + b·scale, two
// rounded multiplies and one rounded add (never contracted).
template <typename T, bool WITH_LB, int V, bool DEQ = false>
__device__ __forceinline__ void fold_rows(
    const typename VecOf<V>::type* __restrict__ srow,
    const typename VecOf<V>::type* __restrict__ trow, int nvec, int lane,
    int group, float scale, float& acc, float& smin, float& tmin) {
  using VT = typename VecOf<V>::type;
  constexpr int kElems = V / static_cast<int>(sizeof(T));
  constexpr bool kCodes = Storage<T>::kCodes;
  const float sentinel =
      std::is_same<T, int16_t>::value ? 32767.0f : 65535.0f;
  for (int v0 = lane; v0 < nvec; v0 += group * kUnroll) {
    VT sv[kUnroll] = {}, tv[kUnroll] = {};
#pragma unroll
    for (int x = 0; x < kUnroll; ++x) {
      const int v = v0 + x * group;
      if (v < nvec) {
        sv[x] = __ldg(srow + v);
        tv[x] = __ldg(trow + v);
      }
    }
#pragma unroll
    for (int x = 0; x < kUnroll; ++x) {
      if (v0 + x * group >= nvec) break;
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const float a = element<T>(sv[x], e);
        const float b = element<T>(tv[x], e);
        if (kCodes) {
          if (fmaxf(a, b) != sentinel)
            acc = fminf(acc, DEQ ? __fadd_rn(__fmul_rn(a, scale),
                                             __fmul_rn(b, scale))
                                 : a + b);
        } else {
          acc = fminf(acc, a + b);
          if (WITH_LB) {
            smin = fminf(smin, a);
            tmin = fminf(tmin, b);
          }
        }
      }
    }
  }
}

// The butterfly over the group's lanes (every lane of the warp takes
// part; xor offsets < group stay inside the group), then the group's
// first lane writes query `query`'s answer (times scale with SCALE) in
// the output type.
template <typename T, bool WITH_LB, bool SCALE = Storage<T>::kCodes>
__device__ __forceinline__ void reduce_store(
    float acc, float smin, float tmin, int group, int lane, int64_t query,
    int64_t q, float scale, typename Storage<T>::Out* __restrict__ out,
    typename Storage<T>::Out* __restrict__ lb) {
  for (int off = group / 2; off > 0; off /= 2) {
    acc = fminf(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (WITH_LB) {
      smin = fminf(smin, __shfl_xor_sync(0xffffffffu, smin, off));
      tmin = fminf(tmin, __shfl_xor_sync(0xffffffffu, tmin, off));
    }
  }
  if (lane == 0 && query < q) {
    put(out + query, SCALE ? acc * scale : acc);
    if (WITH_LB) put(lb + query, SCALE ? (smin + tmin) * scale : smin + tmin);
  }
}

// Block b serves queries b * (kThreads >> group_log2) onward, one a
// group of 1 << group_log2 lanes.
template <typename T, bool WITH_LB, int V>
__global__ void __launch_bounds__(kThreads)
gather_join_kernel(const T* __restrict__ s_table,
                   const int64_t* __restrict__ rs, int64_t s_rows,
                   const T* __restrict__ t_table,
                   const int64_t* __restrict__ rt, int64_t t_rows,
                   int64_t q, int64_t w, int group_log2, float scale,
                   typename Storage<T>::Out* __restrict__ out,
                   typename Storage<T>::Out* __restrict__ lb) {
  using VT = typename VecOf<V>::type;
  constexpr int kElems = V / static_cast<int>(sizeof(T));
  const int group = 1 << group_log2;      // powers of two: shifts, no division
  const int lane = threadIdx.x & (group - 1);
  const int nvec = static_cast<int>(w / kElems);  // vectors a row (exact)
  const int64_t query = (static_cast<int64_t>(blockIdx.x) * kThreads +
                         threadIdx.x) >> group_log2;
  const float inf = inf_f();
  float acc = inf, smin = inf, tmin = inf;
  if (query < q) {
    const int64_t r_s = rs[query];
    const int64_t r_t = rt[query];
    const VT* svec = reinterpret_cast<const VT*>(s_table);
    const VT* tvec = reinterpret_cast<const VT*>(t_table);
    if (r_s >= 0 && r_s < s_rows && r_t >= 0 && r_t < t_rows)
      fold_rows<T, WITH_LB, V>(svec + r_s * nvec, tvec + r_t * nvec, nvec,
                               lane, group, scale, acc, smin, tmin);
  }
  reduce_store<T, WITH_LB>(acc, smin, tmin, group, lane, query, q, scale, out,
                           lb);
}

constexpr int kMaxShards = 64;

// One logical shard's tables, as a lane of the sharded join reads them.
struct JoinShard {
  const void* block;      // (block_rows, w) district block
  const void* border;     // (border_rows, bw) border source
  int64_t block_rows;
  int64_t border_rows;
};

struct ShardTable {
  JoinShard shard[kMaxShards];
};

// the arithmetic of multi_shard_join_kernel
constexpr int kFloatRows = 0, kJoinThenScale = 1, kDequantFirst = 2;

// Row id r of a lane that entry e owns, as a vector pointer (see the
// header); null where r lies outside its source.
template <typename VT>
__device__ __forceinline__ const VT* shard_row(const ShardTable& table,
                                               int shards, const JoinShard& e,
                                               int64_t r, int wvec, int bvec,
                                               int64_t rows_pd) {
  if (r < 0) return nullptr;
  if (r < e.block_rows) return static_cast<const VT*>(e.block) + r * wvec;
  int64_t v = r - e.block_rows;
  const JoinShard* src = &e;
  if (rows_pd > 0) {            // row-sharded B: the owning slice, in place
    const int64_t j = v / rows_pd;
    if (j >= shards) return nullptr;
    src = &table.shard[j];
    v -= j * rows_pd;
  }
  return v < src->border_rows ? static_cast<const VT*>(src->border) + v * bvec
                              : nullptr;
}

// The sharded join of a whole batch (see the header). Block b serves
// queries b * (kThreads >> group_log2) onward, one a group of
// 1 << group_log2 lanes.
template <typename T, int MODE, int V>
__global__ void __launch_bounds__(kThreads)
multi_shard_join_kernel(const __grid_constant__ ShardTable table, int shards,
                        int64_t owner_base, int64_t rows_pd, int64_t w,
                        int64_t bw, const int64_t* __restrict__ owner,
                        const int64_t* __restrict__ rs,
                        const int64_t* __restrict__ rt, int64_t q,
                        int group_log2, float scale, float* __restrict__ out) {
  using VT = typename VecOf<V>::type;
  constexpr int kElems = V / static_cast<int>(sizeof(T));
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int wvec = static_cast<int>(w / kElems);    // vectors a block row
  const int bvec = static_cast<int>(bw / kElems);   // vectors a border row
  const int64_t query = (static_cast<int64_t>(blockIdx.x) * kThreads +
                         threadIdx.x) >> group_log2;
  const float inf = inf_f();
  float acc = inf, smin = inf, tmin = inf;
  if (query < q) {
    // three independent loads: one memory latency before the rows
    const int64_t slot = owner[query] - owner_base;
    const int64_t r_s = rs[query];
    const int64_t r_t = rt[query];
    if (slot >= 0 && slot < shards) {
      const JoinShard& e = table.shard[slot];
      const VT* srow = shard_row<VT>(table, shards, e, r_s, wvec, bvec,
                                     rows_pd);
      const VT* trow = shard_row<VT>(table, shards, e, r_t, wvec, bvec,
                                     rows_pd);
      if (srow != nullptr && trow != nullptr)
        fold_rows<T, false, V, MODE == kDequantFirst>(
            srow, trow,
            r_s < e.block_rows && r_t < e.block_rows ? wvec : bvec, lane,
            group, scale, acc, smin, tmin);
    }
  }
  reduce_store<T, false, MODE == kJoinThenScale>(
      acc, smin, tmin, group, lane, query, q, scale, out, nullptr);
}

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

template <typename T, bool WITH_LB, int V>
cudaError_t launch(const void* s_table, const int64_t* rs, int64_t s_rows,
                   const void* t_table, const int64_t* rt, int64_t t_rows,
                   int64_t q, int64_t w, int group_log2, float scale,
                   void* out, void* lb, cudaStream_t stream) {
  using Out = typename Storage<T>::Out;
  const int64_t per_block = kThreads >> group_log2;
  const int64_t blocks = (q + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_join_kernel<T, WITH_LB, V>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(s_table), rs, s_rows,
          static_cast<const T*>(t_table), rt, t_rows, q, w, group_log2,
          scale, static_cast<Out*>(out), static_cast<Out*>(lb));
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const int64_t*, int64_t,
                               const void*, const int64_t*, int64_t, int64_t,
                               int64_t, int, float, void*, void*,
                               cudaStream_t);

// the instance for (storage type, LB, vector bytes); null where none
template <typename T, bool WITH_LB>
Launch pick(int vec) {
  switch (vec) {
    case 16: return launch<T, WITH_LB, 16>;
    case 8: return launch<T, WITH_LB, 8>;
    case 4: return launch<T, WITH_LB, 4>;
    case 2:
      if constexpr (sizeof(T) == 2) return launch<T, WITH_LB, 2>;
      return nullptr;
    default: return nullptr;
  }
}

// The widest vector (16, 8, 4 bytes, or 2 for 16-bit storage) dividing
// every pitch and each of the `count` base addresses; 0 where none does.
int widest_vec(int64_t item, std::initializer_list<int64_t> pitches,
               const void* const* bases, int count) {
  for (int v : {16, 8, 4, 2}) {
    bool fits = v >= item;
    for (int64_t p : pitches) fits = fits && p % v == 0;
    for (int i = 0; fits && i < count; ++i)
      fits = reinterpret_cast<uintptr_t>(bases[i]) % v == 0;
    if (fits) return v;
  }
  return 0;
}

// The lanes a query of q on `sms` SMs, for rows of `pitch` bytes read in
// `vec`-byte vectors: `lanes` if nonzero, else the fewest (a power of
// two, at most 32) that load each row in at most kUnroll vectors a lane.
// A batch too small to fill the card is latency-bound, so it takes more:
// doubled (up to 4x) while its blocks would leave SMs idle, then doubled
// while a lane would load more than 32 bytes of a row and twice the
// threads would still fit that bound; more lanes a query lengthen its
// shuffle reduction, which a short row does not repay (the H100's best at
// the engine's, the center's and the rebuild window's batches).
// False where `lanes` is not a power of two in [1, 32].
bool lanes_for(int64_t pitch, int vec, int64_t q, int lanes, int sms,
               int* group) {
  if (lanes != 0) {
    *group = lanes;
    return lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  }
  const int64_t want = (pitch / vec + kUnroll - 1) / kUnroll;
  int g = 1;
  while (g < want && g < 32) g *= 2;
  const int cap = g * 4 < 32 ? g * 4 : 32;
  const int64_t threads = static_cast<int64_t>(kThreads) * sms;
  while (g < cap && q * g < threads) g *= 2;
  while (g < 32 && pitch > 32 * g && q * g < 2 * threads) g *= 2;
  *group = g;
  return true;
}

// The load layout of a join of q queries over rows of w items of `item`
// bytes: the widest vector dividing the row pitch and both tables' base
// addresses, and the lanes a query for that pitch.
bool layout(int64_t item, const void* s_table, const void* t_table,
            int64_t w, int64_t q, int lanes, int sms, int* vec, int* group) {
  const int64_t pitch = w * item;
  const void* bases[] = {s_table, t_table};
  *vec = widest_vec(item, {pitch}, bases, 2);
  return *vec != 0 && lanes_for(pitch, *vec, q, lanes, sms, group);
}

template <typename T, int MODE, int V>
cudaError_t launch_multi(const ShardTable& table, int shards,
                         int64_t owner_base, int64_t rows_pd, int64_t w,
                         int64_t bw, const int64_t* owner, const int64_t* rs,
                         const int64_t* rt, int64_t q, int group_log2,
                         float scale, float* out, cudaStream_t stream) {
  const int64_t per_block = kThreads >> group_log2;
  const int64_t blocks = (q + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  multi_shard_join_kernel<T, MODE, V>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          table, shards, owner_base, rows_pd, w, bw, owner, rs, rt, q,
          group_log2, scale, out);
  return cudaGetLastError();
}

using MultiLaunch = cudaError_t (*)(const ShardTable&, int, int64_t, int64_t,
                                    int64_t, int64_t, const int64_t*,
                                    const int64_t*, const int64_t*, int64_t,
                                    int, float, float*, cudaStream_t);

template <typename T, int MODE>
MultiLaunch pick_multi(int vec) {
  switch (vec) {
    case 16: return launch_multi<T, MODE, 16>;
    case 8: return launch_multi<T, MODE, 8>;
    case 4: return launch_multi<T, MODE, 4>;
    case 2:
      if constexpr (sizeof(T) == 2) return launch_multi<T, MODE, 2>;
      return nullptr;
    default: return nullptr;
  }
}

// the instance for (dtype code, mode, vector bytes); null where none
MultiLaunch pick_multi(int dtype, int mode, int vec) {
  if (dtype == 0) {
    return mode == kFloatRows ? pick_multi<float, kFloatRows>(vec) : nullptr;
  }
  if (mode == kJoinThenScale) {
    return dtype == 1   ? pick_multi<uint16_t, kJoinThenScale>(vec)
           : dtype == 2 ? pick_multi<int16_t, kJoinThenScale>(vec)
                        : nullptr;
  }
  if (mode == kDequantFirst) {
    return dtype == 1   ? pick_multi<uint16_t, kDequantFirst>(vec)
           : dtype == 2 ? pick_multi<int16_t, kDequantFirst>(vec)
                        : nullptr;
  }
  return nullptr;
}

// the SM count of the current device
int current_sms() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  return sm_count(device);
}

// The sharded join's layout on the current device, once for the batch:
// the widest vector both pitches and every entry's two base addresses
// allow, and the lanes a query for a block row (the longest fold).
bool multi_layout(int64_t item, int shards, const void* const* blocks,
                  const void* const* borders, int64_t w, int64_t bw,
                  int64_t q, int* vec, int* group) {
  const int sms = current_sms();
  const int a = widest_vec(item, {w * item, bw * item}, blocks, shards);
  const int b = widest_vec(item, {w * item, bw * item}, borders, shards);
  *vec = a < b ? a : b;         // both powers of two: the smaller divides
  return sms > 0 && *vec != 0 && lanes_for(w * item, *vec, q, 0, sms, group);
}

}  // namespace

// Plain C entry points, loaded with ctypes.
//   dtype: 0 = float32, 1 = uint16 codes, 2 = int16 codes, 3 = bfloat16,
//          4 = float16 (both tables one type)
//   with_lb: nonzero also writes lb (float storage only: dtype 0, 3, 4)
//   out, lb: q float32 each, or q of the rows' type for dtype 3 and 4
//   lanes: lanes per query, a power of two in [1, 32]; 0 = the layout's
//          pick (see layout above: the vector width is always picked)
// Returns the cudaError_t of the launch (0 = launched). q must be > 0.
extern "C" int repro_label_join(int dtype, int with_lb, int lanes,
                                const void* s_table, const void* rs,
                                int64_t s_rows, const void* t_table,
                                const void* rt, int64_t t_rows, int64_t q,
                                int64_t w, int sentinel, float scale,
                                void* out, void* lb, void* stream) {
  const int64_t item = dtype == 0 ? 4 : 2;
  if (q <= 0 || w < 0 || w > 0x7fffffffLL ||
      (dtype == 1 && sentinel != 0xFFFF) || (dtype == 2 && sentinel != 0x7FFF))
    return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(device);
  int vec = 0, group = 0;
  if (sms == 0 ||
      !layout(item, s_table, t_table, w, q, lanes, sms, &vec, &group))
    return cudaErrorInvalidValue;
  Launch fn = nullptr;
  if (with_lb) {
    fn = dtype == 0   ? pick<float, true>(vec)
         : dtype == 3 ? pick<__nv_bfloat16, true>(vec)
         : dtype == 4 ? pick<__half, true>(vec)
                      : nullptr;
  } else {
    fn = dtype == 0   ? pick<float, false>(vec)
         : dtype == 1 ? pick<uint16_t, false>(vec)
         : dtype == 2 ? pick<int16_t, false>(vec)
         : dtype == 3 ? pick<__nv_bfloat16, false>(vec)
         : dtype == 4 ? pick<__half, false>(vec)
                      : nullptr;
  }
  if (fn == nullptr) return cudaErrorInvalidValue;
  int group_log2 = 0;
  while ((1 << group_log2) < group) ++group_log2;
  return fn(s_table, static_cast<const int64_t*>(rs), s_rows, t_table,
            static_cast<const int64_t*>(rt), t_rows, q, w, group_log2, scale,
            out, lb, static_cast<cudaStream_t>(stream));
}

// The layout repro_label_join picks for these arguments on `sms` SMs
// (0: the current device's): layout_out[0] = vector bytes, [1] = lanes
// a query. Returns 0, or cudaErrorInvalidValue where no layout fits.
extern "C" int repro_label_join_layout(int dtype, const void* s_table,
                                       const void* t_table, int64_t w,
                                       int64_t q, int lanes, int sms,
                                       int* layout_out) {
  if (sms == 0) {
    int device = 0;
    const cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    sms = sm_count(device);
  }
  if (sms <= 0 || !layout(dtype == 0 ? 4 : 2, s_table, t_table, w, q, lanes,
                          sms, layout_out, layout_out + 1))
    return cudaErrorInvalidValue;
  return 0;
}

// The sharded join of a whole batch (multi_shard_join_kernel).
//   dtype, sentinel, scale: as repro_label_join
//   mode: 0 float32 rows; 1 codes joined, then scaled; 2 codes
//         dequantized (code * scale, sentinel +inf) before the add
//   shards: entries in the table, 1 to 64; entry s is blocks[s], a
//           (block_rows[s], w) district block, and borders[s], a
//           (border_rows[s], bw) border source, bw <= w
//   rows_pd: 0, or with row-sharded B the rows of each border slice:
//            border row v is row v % rows_pd of entry v / rows_pd's
//            source (owner_base must then be 0)
//   owner_base: lane i takes entry owner[i] - owner_base
//   owner, rs, rt: q int64 each; out: q float32, every lane written
// Returns the cudaError_t of the launch (0 = launched). q must be > 0.
extern "C" int repro_label_join_multi(
    int dtype, int mode, int shards, const void* const* blocks,
    const int64_t* block_rows, const void* const* borders,
    const int64_t* border_rows, int64_t w, int64_t bw, int64_t rows_pd,
    int64_t owner_base, const void* owner, const void* rs, const void* rt,
    int64_t q, int sentinel, float scale, void* out, void* stream) {
  const int64_t item = dtype == 0 ? 4 : 2;
  if (q <= 0 || shards < 1 || shards > kMaxShards || w < 0 ||
      w > 0x7fffffffLL || bw < 0 || bw > w || rows_pd < 0 ||
      (rows_pd > 0 && owner_base != 0) ||
      (dtype == 1 && sentinel != 0xFFFF) || (dtype == 2 && sentinel != 0x7FFF))
    return cudaErrorInvalidValue;
  ShardTable table = {};
  for (int s = 0; s < shards; ++s) {
    if (block_rows[s] < 0 || border_rows[s] < 0) return cudaErrorInvalidValue;
    table.shard[s] = {blocks[s], borders[s], block_rows[s], border_rows[s]};
  }
  int vec = 0, group = 0;
  if (!multi_layout(item, shards, blocks, borders, w, bw, q, &vec, &group))
    return cudaErrorInvalidValue;
  const MultiLaunch fn = pick_multi(dtype, mode, vec);
  if (fn == nullptr) return cudaErrorInvalidValue;
  int group_log2 = 0;
  while ((1 << group_log2) < group) ++group_log2;
  return fn(table, shards, owner_base, rows_pd, w, bw,
            static_cast<const int64_t*>(owner),
            static_cast<const int64_t*>(rs), static_cast<const int64_t*>(rt),
            q, group_log2, scale, static_cast<float*>(out),
            static_cast<cudaStream_t>(stream));
}

// The layout repro_label_join_multi picks for these arguments on the
// current device, as repro_label_join_layout reports it.
extern "C" int repro_label_join_multi_layout(int dtype, int shards,
                                             const void* const* blocks,
                                             const void* const* borders,
                                             int64_t w, int64_t bw, int64_t q,
                                             int* layout_out) {
  if (shards < 1 || shards > kMaxShards ||
      !multi_layout(dtype == 0 ? 4 : 2, shards, blocks, borders, w, bw, q,
                    layout_out, layout_out + 1))
    return cudaErrorInvalidValue;
  return 0;
}
