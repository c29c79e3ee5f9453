// Design variants of the sharded join's whole-batch kernel, float32 rows
// only, for tools/sharded_join_variants.py: the lane of
// multi_shard_join_kernel (label_join.cu, included so that the variants
// share its helpers) with three changes:
//   * 32-bit division for the row-sharded slice (in every variant);
//   * PACKED: (owner, rs, rt) read as one 16-byte int32 record;
//   * SMEM: the shard table staged in shared memory at block start, so
//     the owner's and the slice's entries are shared loads, not
//     divergent loads from the parameter bank.
#include "../src/repro_torch/kernels/label_join/csrc/label_join.cu"

namespace {

// shard_row with a 32-bit division for the row-sharded slice
template <typename VT>
__device__ __forceinline__ const VT* shard_row32(const ShardTable& table,
                                                 int shards,
                                                 const JoinShard& e,
                                                 int64_t r, int wvec,
                                                 int bvec, uint32_t rows_pd) {
  if (r < 0) return nullptr;
  if (r < e.block_rows) return static_cast<const VT*>(e.block) + r * wvec;
  int64_t v = r - e.block_rows;
  const JoinShard* src = &e;
  if (rows_pd > 0) {
    if (v >= 0xffffffffLL) return nullptr;
    const uint32_t j = static_cast<uint32_t>(v) / rows_pd;
    if (j >= static_cast<uint32_t>(shards)) return nullptr;
    src = &table.shard[j];
    v -= static_cast<int64_t>(j) * rows_pd;
  }
  return v < src->border_rows ? static_cast<const VT*>(src->border) + v * bvec
                              : nullptr;
}

template <int V, bool PACKED, bool SMEM>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const __grid_constant__ ShardTable table, int shards,
               uint32_t rows_pd, int64_t w, int64_t bw,
               const int64_t* __restrict__ owner,
               const int64_t* __restrict__ rs,
               const int64_t* __restrict__ rt,
               const int4* __restrict__ packed, int64_t q, int group_log2,
               float* __restrict__ out) {
  using VT = typename VecOf<V>::type;
  constexpr int kElems = V / 4;
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int wvec = static_cast<int>(w / kElems);
  const int bvec = static_cast<int>(bw / kElems);
  const int64_t query = (static_cast<int64_t>(blockIdx.x) * kThreads +
                         threadIdx.x) >> group_log2;
  const float inf = inf_f();
  float acc = inf, smin = inf, tmin = inf;
  __shared__ ShardTable s_table;
  if (SMEM) {
    if (threadIdx.x < shards)
      s_table.shard[threadIdx.x] = table.shard[threadIdx.x];
    __syncthreads();
  }
  const ShardTable& tab = SMEM ? s_table : table;
  if (query < q) {
    int64_t slot, r_s, r_t;
    if (PACKED) {
      const int4 rec = __ldg(packed + query);
      slot = rec.x;
      r_s = rec.y;
      r_t = rec.z;
    } else {
      slot = owner[query];
      r_s = rs[query];
      r_t = rt[query];
    }
    if (slot >= 0 && slot < shards) {
      const JoinShard& e = tab.shard[slot];
      const VT* srow = shard_row32<VT>(tab, shards, e, r_s, wvec, bvec,
                                       rows_pd);
      const VT* trow = shard_row32<VT>(tab, shards, e, r_t, wvec, bvec,
                                       rows_pd);
      if (srow != nullptr && trow != nullptr)
        fold_rows<float, false, V>(
            srow, trow,
            r_s < e.block_rows && r_t < e.block_rows ? wvec : bvec, lane,
            group, 1.0f, acc, smin, tmin);
    }
  }
  reduce_store<float, false, false>(acc, smin, tmin, group, lane, query, q,
                                    1.0f, out, nullptr);
}

template <int V, bool PACKED, bool SMEM>
cudaError_t variant_launch(const ShardTable& t, int shards, uint32_t rows_pd,
                           int64_t w, int64_t bw, const int64_t* o,
                           const int64_t* a, const int64_t* c, const int4* p,
                           int64_t q, int group_log2, float* out,
                           cudaStream_t s) {
  const int64_t per_block = kThreads >> group_log2;
  variant_kernel<V, PACKED, SMEM>
      <<<static_cast<unsigned>((q + per_block - 1) / per_block), kThreads, 0,
         s>>>(t, shards, rows_pd, w, bw, o, a, c, p, q, group_log2, out);
  return cudaGetLastError();
}

template <int V>
cudaError_t variant_pick(int flags, const ShardTable& t, int shards,
                         uint32_t rows_pd, int64_t w, int64_t bw,
                         const int64_t* o, const int64_t* a,
                         const int64_t* c, const int4* p, int64_t q, int g,
                         float* out, cudaStream_t s) {
  switch (flags) {
    case 0: return variant_launch<V, false, false>(t, shards, rows_pd, w, bw,
                                                   o, a, c, p, q, g, out, s);
    case 1: return variant_launch<V, true, false>(t, shards, rows_pd, w, bw,
                                                  o, a, c, p, q, g, out, s);
    case 2: return variant_launch<V, false, true>(t, shards, rows_pd, w, bw,
                                                  o, a, c, p, q, g, out, s);
    case 3: return variant_launch<V, true, true>(t, shards, rows_pd, w, bw,
                                                 o, a, c, p, q, g, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch of a variant: flags bit 0 = PACKED (rec: q int4 records
// (owner, rs, rt, 0)), bit 1 = SMEM; the other arguments as
// repro_label_join_multi's for float32 rows (vector widths 16 and 4).
extern "C" int repro_sharded_join_variant(
    int flags, int shards, const void* const* blocks,
    const int64_t* block_rows, const void* const* borders,
    const int64_t* border_rows, int64_t w, int64_t bw, int64_t rows_pd,
    const void* owner, const void* rs, const void* rt, const void* rec,
    int64_t q, void* out, void* stream) {
  if (q <= 0 || shards < 1 || shards > kMaxShards || bw > w ||
      rows_pd < 0 || rows_pd > 0xffffffffLL)
    return cudaErrorInvalidValue;
  ShardTable table = {};
  for (int s = 0; s < shards; ++s)
    table.shard[s] = {blocks[s], borders[s], block_rows[s], border_rows[s]};
  int vec = 0, group = 0;
  if (!multi_layout(4, shards, blocks, borders, w, bw, q, &vec, &group))
    return cudaErrorInvalidValue;
  int g = 0;
  while ((1 << g) < group) ++g;
  const auto o = static_cast<const int64_t*>(owner);
  const auto a = static_cast<const int64_t*>(rs);
  const auto c = static_cast<const int64_t*>(rt);
  const auto p = static_cast<const int4*>(rec);
  const auto f = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto rp = static_cast<uint32_t>(rows_pd);
  if (vec == 16)
    return variant_pick<16>(flags, table, shards, rp, w, bw, o, a, c, p, q,
                            g, f, st);
  if (vec == 4)
    return variant_pick<4>(flags, table, shards, rp, w, bw, o, a, c, p, q, g,
                           f, st);
  return cudaErrorInvalidValue;
}
