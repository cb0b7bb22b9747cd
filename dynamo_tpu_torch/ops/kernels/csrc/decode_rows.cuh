// Row-group helpers of the register-resident paged decode kernels (K1 and
// K3a in paged_attention.cu; K4a, K4b, K7b and K7c in decode_variants.cu): a
// row group of D / RowVec<TK>::N lanes reads one token's slice of one kv
// head straight from HBM into registers, several tokens in flight (U), and
// computes G heads' scores of it or folds it into their online-softmax
// states. One copy of the paged-row addressing (token_row) and of the score
// reduction (head_scores) serves them all.
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
// (zero, valid false).
template <typename TK, int U>
__device__ __forceinline__ void load_slices(typename RowVec<TK>::Raw (&raw)[U], bool (&valid)[U],
                                            const TK* __restrict__ pool, const int* __restrict__ pt,
                                            int t0, int row, int stride, int end, int page_size,
                                            size_t token_stride, int col) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + row + u * stride;
    valid[u] = t < end;
    if (valid[u]) {
      raw[u] = load_row(pool + token_row(pt, t, page_size) * token_stride + col);
    } else {
      raw[u] = zero_row<TK>();
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
template <typename TK, int U>
struct RowLoads {
  typename RowVec<TK>::Raw kr[U], vr[U];
  float ks[U], vs[U];
  bool valid[U];
};

// Load the U rows t0 + row + u * stride (valid iff < end) of one sequence
// from both pools, and the rows' scales for int8. One pass, each row's pool
// address computed once for K, V and the scales: two load_slices passes
// re-read the page table and made K1 19-39% slower on an H100.
template <typename TK, int U>
__device__ __forceinline__ void load_rows(RowLoads<TK, U>& r, const TK* __restrict__ k_pool,
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
      r.kr[u] = load_row(k_pool + tok * token_stride + col);
      r.vr[u] = load_row(v_pool + tok * token_stride + col);
      if constexpr (std::is_same<TK, int8_t>::value) {
        r.ks[u] = k_scale[tok];
        r.vs[u] = v_scale[tok];
      }
    } else {
      r.kr[u] = zero_row<TK>();
      r.vr[u] = zero_row<TK>();
    }
  }
}

// Online-softmax update of G heads' states with the U loaded rows. The
// score's partial dot is reduced over the LPH lanes of one head slice; every
// lane runs the shuffles, valid row or not.
template <typename TK, int U, int G, int LPH>
__device__ __forceinline__ void consume_rows(const RowLoads<TK, U>& r, const float (&qf)[G][RowVec<TK>::N],
                                             float scale, float (&m)[G], float (&l)[G],
                                             float (&acc)[G][RowVec<TK>::N]) {
  constexpr int VEC = RowVec<TK>::N;
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

}  // namespace dtt
