// K4a, K4b, K7b and K7c: the decode variants of K1 for Hopper (sm_90a).
//
// K4a replaces dynamo_tpu/ops/pallas/paged_attention.py
// paged_decode_attention_pallas_chunked (_kernel_chunked): K1's function with
// the context walked in chunks of C * ps rows, C = max(1, min(max_pages,
// ceil(256 / ps))). K4b replaces paged_decode_attention_pallas_grouped
// (_kernel_grouped): Gq sequences a program, one page an iteration. K7c
// replaces tools/profile_attn.py make_perseq_variant (_perseq_variant_kernel):
// the reference perseq kernel's one-page-an-iteration schedule with its f32
// casts toggled. K7b replaces tools/profile_attn.py paged_decode_dmaonly
// (_null_kernel): K1's grid and page stream with no math, an instrument.
//
// Contract of K4a, K4b and K7c: K1's (paged_attention.cu) over f32 or bf16
// pools of q's dtype (no int8: the reference never routes an int8 cache
// here): q [B, Hq, D]; pools [P, ps, Hkv, D]; page_tables [B, max_pages]
// int32 (layer offset added); positions [B] int32; context j < min(max(pos +
// 1, 1), max_pages * ps). Scores q . k / sqrt(D) with f32 sums. Per chunk
// (K4a: C * ps rows; K4b and K7c: one page): m' = max(m, chunk max), corr =
// exp(m - m'), p = exp(s - m'), l = l * corr + sum(p), acc = acc * corr +
// round(p) . V with f32 sums, where round() takes p to the pool dtype and
// back (the reference's probs.astype(pool dtype) before P.V; K7c with
// cast_f32 keeps p in f32); out = acc / max(l, 1e-20) in q's dtype. In f32
// the rounding is the identity and all three compute K1's function. V rows
// past the length are never read (the reference zeroes them).
//
// K7b: out [B, Hq, D] f32, out[b, h, d] = sum over j < len of (K + V)[j,
// kv(h), d], len as above. The reference's twin writes 1e-6 x one lane of
// the last page, garbage by design; a load that nothing reads is deleted by
// nvcc, so this twin folds every value it loads into a checksum instead.
//
// What bounds all four on an H100: bytes, as K1: each sequence's pages of K
// and V are read once, at 4 FLOP an element (K7b: 1 add).
//
// K4a / K7c design (chunk_softmax_decode): one block per (sequence, kv head),
// K1's four warps and row groups of D / VEC lanes, so the G query heads of a
// GQA group share every K/V row the block loads. A 256-row chunk of bf16 K
// and V at D 128 is 128 KB, 256 KB double-buffered: more than the 227 KB a
// block can have, so a chunk is never staged whole. Per chunk: (1) the row
// groups stream its K rows from HBM into registers, kUnroll rows in flight,
// and write the G heads' scores to shared memory (G x chunk rows f32, 8 KB at
// G 8 and 256 rows); (2) warp w takes heads w, w + 4: the chunk max, each
// probability once (one exp a (head, row), where K1 repeats its softmax
// update on every lane of a row group), the sum, and the rounded
// probabilities back into shared memory; (3) the row groups rescale their
// accumulators once and stream the chunk's V rows into them. The row groups
// share the chunk's max, so at the end their accumulators merge by a plain
// sum (shuffles within a warp, shared memory across warps). The chunk
// boundary is the reference's: that is where the rounded probabilities take
// their running max. cp.async staging of V sub-tiles is later work.
//
// K4b design (grouped_decode_kernel): one block per (Gq sequences, kv head),
// one warp a sequence: its row groups walk the sequence's pages in the same
// three phases, with the page's scores in the warp's slice of shared memory
// and __syncwarp between the phases. The loop runs to the group's longest
// page count; a warp whose sequence has no page i skips it (its state would
// not move, as the reference's masked page leaves it). Gq is the reference's
// choice (8, 4 or 2 when it divides B and the group's score slices fit
// kSmemBudget, else 1): the reference's 8 MB VMEM page budget becomes the
// budget of what this design stages, the scores.
//
// K7b design (decode_load_twin): K1's block, row groups and load_rows; each
// row group sums its K + V slices in f32, the row groups merge by shuffles
// and shared memory, and every query head of the kv head gets the sum.

#include "decode_rows.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;
constexpr int kSmemBudget = 48 * 1024;  // the default dynamic shared memory of a block

// p rounded to the pool dtype TK and back (round to nearest even, as the
// reference's astype and torch's .to).
template <typename TK>
__device__ __forceinline__ float round_to(float p) {
  if constexpr (std::is_same<TK, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16_rn(p));
  } else {
    return p;
  }
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

// Sum each lane's N values over the row groups of its warp (lanes that
// differ in the bits at and above LPR); every lane ends with the sum.
template <int LPR, int N>
__device__ __forceinline__ void sum_row_groups(float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

template <typename TQ, int G, int VEC>
__device__ __forceinline__ void load_queries(float (&qf)[G][VEC], const TQ* __restrict__ q, size_t head0,
                                             int D, int d0) {
#pragma unroll
  for (int g = 0; g < G; ++g) dtt::load_floats<TQ, VEC>(q + (head0 + g) * D + d0, qf[g]);
}

// ---------------------------------------------------------------- K4a / K7c

size_t chunk_smem_bytes(int G, int D, int chunk_rows) {
  return ((size_t)G * chunk_rows + 3 * G + (size_t)kWarps * G * D) * sizeof(float);
}

template <typename TQ, typename TK, int D, int G, bool kRound>
__global__ void __launch_bounds__(kThreads)
chunk_softmax_decode(const TQ* __restrict__ q, const TK* __restrict__ k_pool,
                     const TK* __restrict__ v_pool, const int* __restrict__ page_tables,
                     const int* __restrict__ positions, TQ* __restrict__ out, int Hkv,
                     int page_size, int max_pages, int chunk_rows, float scale) {
  constexpr int VEC = dtt::RowVec<TK>::N;
  constexpr int LPR = D / VEC;  // lanes per K/V row
  static_assert(D % VEC == 0 && LPR <= 32 && 32 % LPR == 0, "unsupported head_dim");
  constexpr int RPW = 32 / LPR;        // row groups per warp
  constexpr int NROWS = kWarps * RPW;  // row groups per block

  extern __shared__ float smem[];
  float* s_p = smem;                  // [G][chunk_rows]: scores, then probabilities
  float* s_m = s_p + G * chunk_rows;  // [G] running max
  float* s_l = s_m + G;               // [G] running sum
  float* s_corr = s_l + G;            // [G] this chunk's rescale
  float* red = s_corr + G;            // [kWarps][G][D] the final merge

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int Hq = Hkv * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPR;
  const int row = warp * RPW + lane / LPR;
  const int d0 = sub * VEC;
  const int col = kvh * D + d0;
  const size_t token_stride = (size_t)Hkv * D;

  float qf[G][VEC];
  load_queries<TQ, G, VEC>(qf, q, (size_t)b * Hq + kvh * G, D, d0);
  const int ctx = dtt::decode_ctx(positions, b, max_pages * page_size);
  const int* pt = page_tables + (size_t)b * max_pages;

  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  if (threadIdx.x < G) {
    s_m[threadIdx.x] = dtt::kNegInf;
    s_l[threadIdx.x] = 0.f;
  }

  for (int c0 = 0; c0 < ctx; c0 += chunk_rows) {
    const int nv = min(chunk_rows, ctx - c0);  // the chunk's rows inside the context
    // (1) scores; the trip count is block-uniform (full-mask shuffles)
    for (int r0 = 0; r0 < nv; r0 += NROWS * kUnroll) {
      typename dtt::RowVec<TK>::Raw kr[kUnroll];
      bool valid[kUnroll];
      dtt::load_slices<TK, kUnroll>(kr, valid, k_pool, pt, c0 + r0, row, NROWS, c0 + nv, page_size,
                                    token_stride, col);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[VEC], s[G];
        dtt::to_float(kr[u], kf);
        dtt::head_scores<G, VEC, LPR>(qf, kf, scale, s);
        if (valid[u] && sub == 0) {
#pragma unroll
          for (int g = 0; g < G; ++g) s_p[g * chunk_rows + r0 + row + u * NROWS] = s[g];
        }
      }
    }
    __syncthreads();
    // (2) the chunk's max, probabilities and sum: warp w takes heads w, w + 4
    for (int g = warp; g < G; g += kWarps) {
      float* sp = s_p + g * chunk_rows;
      float mx = dtt::kNegInf;
      for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, sp[j]);
      mx = warp_max(mx);
      const float m_old = s_m[g];
      const float new_m = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nv; j += 32) {
        const float p = expf(sp[j] - new_m);
        sum += p;
        sp[j] = kRound ? round_to<TK>(p) : p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - new_m);
        s_corr[g] = corr;
        s_l[g] = s_l[g] * corr + sum;
        s_m[g] = new_m;
      }
    }
    __syncthreads();
    // (3) P.V: each row group streams its rows of the chunk's V
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float corr = s_corr[g];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= corr;
    }
    for (int r0 = 0; r0 < nv; r0 += NROWS * kUnroll) {
      typename dtt::RowVec<TK>::Raw vr[kUnroll];
      bool valid[kUnroll];
      dtt::load_slices<TK, kUnroll>(vr, valid, v_pool, pt, c0 + r0, row, NROWS, c0 + nv, page_size,
                                    token_stride, col);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!valid[u]) continue;
        float vf[VEC];
        dtt::to_float(vr[u], vf);
        const int j = r0 + row + u * NROWS;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = s_p[g * chunk_rows + j];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
        }
      }
    }
    __syncthreads();  // the next chunk's scores overwrite s_p
  }

  // merge the row groups: they share the block's max, so a plain sum
  sum_row_groups<LPR, G * VEC>(&acc[0][0]);
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < VEC; ++i) red[(warp * G + g) * D + d0 + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[(w * G + g) * D + d];
    dtt::store1(out + ((size_t)b * Hq + kvh * G + g) * D + d, a / fmaxf(s_l[g], 1e-20f));
  }
}

// ---------------------------------------------------------------- K4b

size_t grouped_smem_bytes(int group, int G, int page_size) {
  return (size_t)group * G * page_size * sizeof(float);
}

template <typename TQ, typename TK, int D, int G>
__global__ void __launch_bounds__(256)
grouped_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ k_pool,
                      const TK* __restrict__ v_pool, const int* __restrict__ page_tables,
                      const int* __restrict__ positions, TQ* __restrict__ out, int Hkv,
                      int page_size, int max_pages, int group, float scale) {
  constexpr int VEC = dtt::RowVec<TK>::N;
  constexpr int LPR = D / VEC;
  static_assert(D % VEC == 0 && LPR <= 32 && 32 % LPR == 0, "unsupported head_dim");
  constexpr int RPW = 32 / LPR;  // row groups of the warp

  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * group;
  const int b = b0 + warp;  // this warp's sequence
  const int Hq = Hkv * G;
  const int sub = lane % LPR;
  const int rg = lane / LPR;
  const int d0 = sub * VEC;
  const int col = kvh * D + d0;
  const size_t token_stride = (size_t)Hkv * D;
  float* s_p = smem + (size_t)warp * G * page_size;  // this warp's [G][page_size]

  float qf[G][VEC];
  load_queries<TQ, G, VEC>(qf, q, (size_t)b * Hq + kvh * G, D, d0);
  const int cap = max_pages * page_size;
  const int ctx = dtt::decode_ctx(positions, b, cap);
  const int n_pages = (ctx + page_size - 1) / page_size;
  int max_n = 0;
  for (int w = 0; w < group; ++w)
    max_n = max(max_n, (dtt::decode_ctx(positions, b0 + w, cap) + page_size - 1) / page_size);
  const int* pt = page_tables + (size_t)b * max_pages;

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = dtt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  for (int pg = 0; pg < max_n; ++pg) {
    if (pg >= n_pages) continue;  // warp-uniform: this sequence has no page pg
    const int p0 = pg * page_size;
    const int nv = min(page_size, ctx - p0);
    // (1) the page's scores
    for (int r0 = 0; r0 < nv; r0 += RPW * kUnroll) {
      typename dtt::RowVec<TK>::Raw kr[kUnroll];
      bool valid[kUnroll];
      dtt::load_slices<TK, kUnroll>(kr, valid, k_pool, pt, p0 + r0, rg, RPW, p0 + nv, page_size,
                                    token_stride, col);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[VEC], s[G];
        dtt::to_float(kr[u], kf);
        dtt::head_scores<G, VEC, LPR>(qf, kf, scale, s);
        if (valid[u] && sub == 0) {
#pragma unroll
          for (int g = 0; g < G; ++g) s_p[g * page_size + r0 + rg + u * RPW] = s[g];
        }
      }
    }
    __syncwarp();
    // (2) each head's page max, rounded probabilities and sum
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* sp = s_p + g * page_size;
      float mx = dtt::kNegInf;
      for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, sp[j]);
      const float new_m = fmaxf(m[g], warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < nv; j += 32) {
        const float p = expf(sp[j] - new_m);
        sum += p;
        sp[j] = round_to<TK>(p);
      }
      const float corr = expf(m[g] - new_m);
      l[g] = l[g] * corr + warp_sum(sum);
      m[g] = new_m;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= corr;
    }
    __syncwarp();
    // (3) P.V over the page's V rows
    for (int r0 = 0; r0 < nv; r0 += RPW * kUnroll) {
      typename dtt::RowVec<TK>::Raw vr[kUnroll];
      bool valid[kUnroll];
      dtt::load_slices<TK, kUnroll>(vr, valid, v_pool, pt, p0 + r0, rg, RPW, p0 + nv, page_size,
                                    token_stride, col);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!valid[u]) continue;
        float vf[VEC];
        dtt::to_float(vr[u], vf);
        const int j = r0 + rg + u * RPW;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = s_p[g * page_size + j];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
        }
      }
    }
    __syncwarp();  // the next page's scores overwrite s_p
  }

  sum_row_groups<LPR, G * VEC>(&acc[0][0]);
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float inv = 1.f / fmaxf(l[g], 1e-20f);
      TQ* dst = out + ((size_t)b * Hq + kvh * G + g) * D + d0;
#pragma unroll
      for (int i = 0; i < VEC; ++i) dtt::store1(dst + i, acc[g][i] * inv);
    }
  }
}

// ---------------------------------------------------------------- K7b

template <typename TK, int D>
__global__ void __launch_bounds__(kThreads)
decode_load_twin(const TK* __restrict__ k_pool, const TK* __restrict__ v_pool,
                 const int* __restrict__ page_tables, const int* __restrict__ positions,
                 float* __restrict__ out, int Hkv, int G, int page_size, int max_pages) {
  constexpr int VEC = dtt::RowVec<TK>::N;
  constexpr int LPR = D / VEC;
  static_assert(D % VEC == 0 && LPR <= 32 && 32 % LPR == 0, "unsupported head_dim");
  constexpr int RPW = 32 / LPR;
  constexpr int NROWS = kWarps * RPW;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPR;
  const int row = warp * RPW + lane / LPR;
  const int d0 = sub * VEC;
  const int ctx = dtt::decode_ctx(positions, b, max_pages * page_size);
  const int* pt = page_tables + (size_t)b * max_pages;

  float sum[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sum[i] = 0.f;
  for (int t0 = 0; t0 < ctx; t0 += NROWS * kUnroll) {
    dtt::RowLoads<TK, kUnroll> r;
    dtt::load_rows<TK, kUnroll>(r, k_pool, v_pool, nullptr, nullptr, pt, t0, row, NROWS, ctx,
                                page_size, (size_t)Hkv * D, kvh * D + d0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!r.valid[u]) continue;
      float kf[VEC], vf[VEC];
      dtt::to_float(r.kr[u], kf);
      dtt::to_float(r.vr[u], vf);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum[i] += kf[i] + vf[i];
    }
  }

  sum_row_groups<LPR, VEC>(sum);
  __shared__ float red[kWarps][D];
  if (lane < LPR) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[warp][d0 + i] = sum[i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[w][d];
    out[(((size_t)b * Hkv + kvh) * G + g) * D + d] = a;
  }
}

// ---------------------------------------------------------------- launch

struct VariantArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* pt;
  const int* pos;
  void* out;
  int B, Hq, Hkv, D, ps, max_pages;
  int arg;  // chunk rows (K4a, K7c) or the group size (K4b)
  bool round;
  cudaStream_t stream;
};

template <typename T, int D, int G>
struct ChunkLaunch {
  static int run(const VariantArgs& a) {
    // within the default 48 KB of dynamic shared memory: no attribute to raise
    const size_t smem = chunk_smem_bytes(G, D, a.arg);
    if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
    const dim3 grid(a.Hkv, a.B);
    const float scale = 1.0f / sqrtf((float)D);
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    T* out = static_cast<T*>(a.out);
    if (a.round) {
      chunk_softmax_decode<T, T, D, G, true><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, a.pt, a.pos, out, a.Hkv, a.ps, a.max_pages, a.arg, scale);
    } else {
      chunk_softmax_decode<T, T, D, G, false><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, a.pt, a.pos, out, a.Hkv, a.ps, a.max_pages, a.arg, scale);
    }
    return (int)cudaGetLastError();
  }
};

template <typename T, int D, int G>
struct GroupedLaunch {
  static int run(const VariantArgs& a) {
    const int group = a.arg;
    const size_t smem = grouped_smem_bytes(group, G, a.ps);
    if (group < 1 || group > 8 || a.B % group || smem > kSmemBudget) return (int)cudaErrorInvalidValue;
    grouped_decode_kernel<T, T, D, G><<<dim3(a.Hkv, a.B / group), 32 * group, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.pt,
        a.pos, static_cast<T*>(a.out), a.Hkv, a.ps, a.max_pages, group, 1.0f / sqrtf((float)D));
    return (int)cudaGetLastError();
  }
};

template <template <typename, int, int> class F, typename T, int D>
int with_group(const VariantArgs& a) {
  switch (a.Hq / a.Hkv) {
    case 1: return F<T, D, 1>::run(a);
    case 2: return F<T, D, 2>::run(a);
    case 4: return F<T, D, 4>::run(a);
    case 8: return F<T, D, 8>::run(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <template <typename, int, int> class F, typename T>
int with_head_dim(const VariantArgs& a) {
  switch (a.D) {
    case 64: return with_group<F, T, 64>(a);
    case 128: return with_group<F, T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (q and both pools)
template <template <typename, int, int> class F>
int with_dtype(int dtype, const VariantArgs& a) {
  if (dtype == 0) return with_head_dim<F, float>(a);
  if (dtype == 1) return with_head_dim<F, __nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
int launch_twin(const VariantArgs& a) {
  decode_load_twin<T, D><<<dim3(a.Hkv, a.B), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.pt, a.pos,
      static_cast<float*>(a.out), a.Hkv, a.Hq / a.Hkv, a.ps, a.max_pages);
  return (int)cudaGetLastError();
}

template <typename T>
int twin_head_dim(const VariantArgs& a) {
  switch (a.D) {
    case 64: return launch_twin<T, 64>(a);
    case 128: return launch_twin<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool shapes_ok(const VariantArgs& a) {
  return a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.ps > 0 && a.max_pages > 0;
}

}  // namespace

// K4a and K7c: chunks of chunk_rows context rows (K4a: C * ps; K7c: ps);
// round_probs = 1 rounds the probabilities to the pool dtype before P.V (K4a,
// K7c without cast_f32). Each entry point returns cudaGetLastError() after
// its launch (0 = launched); shapes the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int chunk_softmax_decode(const void* q, const void* k_pool, const void* v_pool,
                                    const void* page_tables, const void* positions, void* out,
                                    int B, int Hq, int Hkv, int D, int page_size, int max_pages,
                                    int chunk_rows, int round_probs, int dtype, void* stream) {
  const VariantArgs a{q, k_pool, v_pool, static_cast<const int*>(page_tables),
                      static_cast<const int*>(positions), out, B, Hq, Hkv, D, page_size, max_pages,
                      chunk_rows, round_probs != 0, static_cast<cudaStream_t>(stream)};
  if (B <= 0) return 0;
  if (!shapes_ok(a) || chunk_rows <= 0) return (int)cudaErrorInvalidValue;
  return with_dtype<ChunkLaunch>(dtype, a);
}

// K4b: groups of `group` sequences a block (group divides B, 1..8).
extern "C" int paged_decode_attention_grouped(const void* q, const void* k_pool,
                                              const void* v_pool, const void* page_tables,
                                              const void* positions, void* out, int B, int Hq,
                                              int Hkv, int D, int page_size, int max_pages,
                                              int group, int dtype, void* stream) {
  const VariantArgs a{q, k_pool, v_pool, static_cast<const int*>(page_tables),
                      static_cast<const int*>(positions), out, B, Hq, Hkv, D, page_size, max_pages,
                      group, true, static_cast<cudaStream_t>(stream)};
  if (B <= 0) return 0;
  if (!shapes_ok(a)) return (int)cudaErrorInvalidValue;
  return with_dtype<GroupedLaunch>(dtype, a);
}

// K7b: out [B, Hq, D] float32 checksums.
extern "C" int paged_decode_dmaonly(const void* k_pool, const void* v_pool,
                                    const void* page_tables, const void* positions, void* out,
                                    int B, int Hq, int Hkv, int D, int page_size, int max_pages,
                                    int dtype, void* stream) {
  const VariantArgs a{nullptr, k_pool, v_pool, static_cast<const int*>(page_tables),
                      static_cast<const int*>(positions), out, B, Hq, Hkv, D, page_size, max_pages,
                      0, false, static_cast<cudaStream_t>(stream)};
  if (B <= 0) return 0;
  if (!shapes_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return twin_head_dim<float>(a);
  if (dtype == 1) return twin_head_dim<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
