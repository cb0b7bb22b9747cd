// Row-group helpers of the register-resident paged decode kernels (K1 in
// paged_attention.cu; K4a, K7b and K7c in decode_variants.cu): a
// row group of D / RowVec<TK>::N lanes reads one token's slice of one kv
// head straight from HBM into registers, several tokens in flight (U), and
// computes G heads' scores of it or folds it into their online-softmax
// states. One copy of the paged-row addressing (token_row) and of the score
// reduction (head_scores) serves them all. Also shared by the decode
// kernels: warp reductions, the head sub-group rule of K1 / K4a / K7c, and
// merge_splits, the split-K merge of the split bodies (K1, K3a, K4a, K4b, K5).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dtt {

// The pool row of context row t of a sequence whose page table is pt.
__device__ __forceinline__ size_t token_row(const int* __restrict__ pt, int t, int page_size) {
  return (size_t)pt[t / page_size] * page_size + (t % page_size);
}

// The raw VEC-value slices at column `col` of the U rows t0 + row + u *
// stride of one sequence in one pool; rows at or past `end` are not read
// (zero, valid false). RV: the lane slice (RowVec<TK>, or LaneVec<TK, D>).
template <typename TK, int U, typename RV = RowVec<TK>>
__device__ __forceinline__ void load_slices(typename RV::Raw (&raw)[U], bool (&valid)[U],
                                            const TK* __restrict__ pool, const int* __restrict__ pt,
                                            int t0, int row, int stride, int end, int page_size,
                                            size_t token_stride, int col) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + row + u * stride;
    valid[u] = t < end;
    if (valid[u]) {
      raw[u] = load_row<TK, RV>(pool + token_row(pt, t, page_size) * token_stride + col);
    } else {
      raw[u] = zero_row<TK, RV>();
    }
  }
}

// G heads' scores q . k * scale of one K slice, each partial dot reduced
// over the LPR lanes of its row group. Every lane of the warp must call it
// (full-mask shuffles), valid row or not.
template <int G, int VEC, int LPR>
__device__ __forceinline__ void head_scores(const float (&qf)[G][VEC], const float* kf, float scale,
                                            float (&s)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) part = fmaf(qf[g][i], kf[i], part);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    s[g] = part * scale;
  }
}

// One token row slice of K and V: kr / vr raw loads, ks / vs the int8 row
// scales.
template <typename TK, int U, typename RV = RowVec<TK>>
struct RowLoads {
  typename RV::Raw kr[U], vr[U];
  float ks[U], vs[U];
  bool valid[U];
};

// Load the U rows t0 + row + u * stride (valid iff < end) of one sequence
// from both pools, and the rows' scales for int8. One pass, each row's pool
// address computed once for K, V and the scales: two load_slices passes
// re-read the page table and made K1 19-39% slower on an H100.
template <typename TK, int U, typename RV = RowVec<TK>>
__device__ __forceinline__ void load_rows(RowLoads<TK, U, RV>& r, const TK* __restrict__ k_pool,
                                          const TK* __restrict__ v_pool,
                                          const float* __restrict__ k_scale,
                                          const float* __restrict__ v_scale,
                                          const int* __restrict__ pt, int t0, int row, int stride,
                                          int end, int page_size, size_t token_stride, int col) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + row + u * stride;
    r.valid[u] = t < end;
    r.ks[u] = r.vs[u] = 0.f;
    if (r.valid[u]) {
      const size_t tok = token_row(pt, t, page_size);
      r.kr[u] = load_row<TK, RV>(k_pool + tok * token_stride + col);
      r.vr[u] = load_row<TK, RV>(v_pool + tok * token_stride + col);
      if constexpr (std::is_same<TK, int8_t>::value) {
        r.ks[u] = k_scale[tok];
        r.vs[u] = v_scale[tok];
      }
    } else {
      r.kr[u] = zero_row<TK, RV>();
      r.vr[u] = zero_row<TK, RV>();
    }
  }
}

// Online-softmax update of G heads' states with the U loaded rows. The
// score's partial dot is reduced over the LPH lanes of one head slice; every
// lane runs the shuffles, valid row or not.
template <typename TK, int U, int G, int LPH, typename RV = RowVec<TK>>
__device__ __forceinline__ void consume_rows(const RowLoads<TK, U, RV>& r, const float (&qf)[G][RV::N],
                                             float scale, float (&m)[G], float (&l)[G],
                                             float (&acc)[G][RV::N]) {
  constexpr int VEC = RV::N;
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float kf[VEC];
    to_float(r.kr[u], kf);
    float s[G];
    head_scores<G, VEC, LPH>(qf, kf, scale, s);
    if constexpr (kQuant) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] *= r.ks[u];
    }
    if (r.valid[u]) {
      float vf[VEC];
      to_float(r.vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float new_m = fmaxf(m[g], s[g]);
        const float corr = expf(m[g] - new_m);
        const float p = expf(s[g] - new_m);
        l[g] = l[g] * corr + p;
        const float pv = kQuant ? p * r.vs[u] : p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(pv, vf[i], acc[g][i] * corr);
        m[g] = new_m;
      }
    }
  }
}

__device__ __forceinline__ int decode_ctx(const int* positions, int b, int cap) {
  return min(max(positions[b] + 1, 1), cap);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The largest of cap..1 that divides G: the query heads a decode block of
// K1's f32 body, K4a / K4b / K7c's f32 chunk body holds (G <= cap: all of
// them). For G > cap the kv head's G / sub sub-groups go to blocks of their
// own, each of which re-reads the kv head's rows. The cap keeps a lane's
// query and accumulator registers (2 x sub x VEC) beside its rows in flight
// under 255 without spills (ptxas -v on an H100 build): 8 heads at 8 values
// a lane, 4 at 12 (D 384), 3 at 16 (D 512).
__host__ __device__ constexpr int subgroup_cap(int vec) { return vec <= 8 ? 8 : 48 / vec; }

__host__ __device__ inline int head_subgroup(int G, int cap = 8) {
  for (int sg = cap; sg > 1; --sg)
    if (G % sg == 0) return sg;
  return 1;
}

// F<SG>::run(args...) for SG = head_subgroup(G, Cap); the sub-groups past
// Cap are never instantiated.
template <int Cap, template <int> class F, typename... Args>
int with_head_subgroup(int G, Args&&... args) {
  switch (head_subgroup(G, Cap)) {
    case 1: return F<1>::run(args...);
    case 2: if constexpr (Cap >= 2) return F<2>::run(args...); break;
    case 3: if constexpr (Cap >= 3) return F<3>::run(args...); break;
    case 4: if constexpr (Cap >= 4) return F<4>::run(args...); break;
    case 5: if constexpr (Cap >= 5) return F<5>::run(args...); break;
    case 6: if constexpr (Cap >= 6) return F<6>::run(args...); break;
    case 7: if constexpr (Cap >= 7) return F<7>::run(args...); break;
    case 8: if constexpr (Cap >= 8) return F<8>::run(args...); break;
    default: break;
  }
  return (int)cudaErrorInvalidValue;
}

// The split-K merge of the decode kernels that split a sequence's context
// over blocks (K1's and K3a's split bodies, K4a / K4b, the wide body past
// head_dim 512; K5, with d_c for D): split s of sequence b wrote m (a log2-domain
// running max), l and acc [D] for every head to m_part, l_part [B, n_split,
// Hq] and acc_part [B, n_split, Hq, D]; the sequence's ceil(ctx /
// split_rows) splits combine as out = sum 2^(m_s - M) acc_s / max(sum 2^(m_s
// - M) l_s, 1e-20), M their max. Block (8 heads, sequence, column slice of
// 32 kMergeCols), one warp a head: lane j computes split s0 + j's weight
// once, and the lanes of a column take it by shuffle; the rows of four
// splits load together (their sums still taken in split order). Fixed
// loops, no atomics: two launches give the same bits.
constexpr int kMergeHeads = 8;
constexpr int kMergeCols = 4;  // output columns a lane: slices of 128 columns over the grid's z dimension

template <typename TQ>
__global__ void __launch_bounds__(32 * kMergeHeads)
merge_splits(const float* __restrict__ m_part, const float* __restrict__ l_part,
             const float* __restrict__ acc_part, const int* __restrict__ positions,
             TQ* __restrict__ out, int Hq, int D, int cap, int split_rows, int n_split) {
  const int h = blockIdx.x * kMergeHeads + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int d0 = blockIdx.z * 32 * kMergeCols + lane;  // this lane's columns d0 + 32 c
  if (h >= Hq) return;  // warp-uniform
  const int n = (decode_ctx(positions, b, cap) + split_rows - 1) / split_rows;
  const size_t base = (size_t)b * n_split;
  float mx = kNegInf;
  for (int s = lane; s < n; s += 32) mx = fmaxf(mx, m_part[(base + s) * Hq + h]);
  mx = warp_max(mx);
  float tot = 0.f, a[kMergeCols] = {};
  for (int s0 = 0; s0 < n; s0 += 32) {  // warp-uniform
    const int s = s0 + lane;
    const float w = s < n ? exp2f(m_part[(base + s) * Hq + h] - mx) : 0.f;
    if (s < n) tot = fmaf(l_part[(base + s) * Hq + h], w, tot);
    const int cnt = min(32, n - s0);
    for (int j = 0; j < cnt; j += 4) {  // warp-uniform
      float x[4][kMergeCols], wj[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wj[u] = __shfl_sync(0xffffffffu, w, min(j + u, cnt - 1));
        const float* row = acc_part + ((base + s0 + min(j + u, cnt - 1)) * Hq + h) * D;
#pragma unroll
        for (int c = 0; c < kMergeCols; ++c) x[u][c] = d0 + 32 * c < D ? row[d0 + 32 * c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j + u >= cnt) break;
#pragma unroll
        for (int c = 0; c < kMergeCols; ++c) a[c] = fmaf(x[u][c], wj[u], a[c]);
      }
    }
  }
  const float denom = fmaxf(warp_sum(tot), 1e-20f);
#pragma unroll
  for (int c = 0; c < kMergeCols; ++c) {
    const int d = d0 + 32 * c;
    if (d < D) store1(out + ((size_t)b * Hq + h) * D + d, a[c] / denom);
  }
}

// merge_splits over B sequences of Hq heads of D columns; returns
// cudaGetLastError().
template <typename TQ>
int launch_merge_splits(const float* m_part, const float* l_part, const float* acc_part, const int* positions,
                        TQ* out, int B, int Hq, int D, int cap, int split_rows, int n_split, cudaStream_t stream) {
  const dim3 grid((Hq + kMergeHeads - 1) / kMergeHeads, B, (D + 32 * kMergeCols - 1) / (32 * kMergeCols));
  merge_splits<TQ><<<grid, 32 * kMergeHeads, 0, stream>>>(m_part, l_part, acc_part, positions, out, Hq, D, cap,
                                                          split_rows, n_split);
  return (int)cudaGetLastError();
}

}  // namespace dtt
