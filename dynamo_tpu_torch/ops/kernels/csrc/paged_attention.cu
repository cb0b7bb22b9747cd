// K1 and K3a: paged decode attention for Hopper (sm_90a).
//
// K1 replaces the TPU kernels dynamo_tpu/ops/pallas/paged_attention.py
// paged_decode_attention_pallas_lookahead (_kernel_lookahead) and
// paged_decode_attention_pallas (_kernel). Both compute the same function and
// differ only in how the TPU schedules its page DMAs (the lookahead variant
// prefetches the NEXT grid program's pages into scratch that persists across
// the serial TPU grid); one kernel here stands for both. Nothing carries
// between CUDA blocks, so no cross-block prefetch is attempted.
//
// K3a replaces paged_decode_attention_pallas_folded (_kernel_folded): the
// same function for head dims that are not a multiple of 128 (TinyLlama's
// 64), which the TPU reads from pools with the kv heads folded into the lane
// dim. Its zero-placed folded queries and one-hot output selection are a
// Mosaic lane workaround and are not carried over; see K3a below.
//
// Contract (both): q [B, Hq, D] f32 or bf16; k/v pools [P, ps, Hkv, D] (the
// folded [P, ps, Hkv*D] is the same memory) of q's dtype, or int8 with f32
// scale planes [P, ps], one scale per token row (the caller already added the
// layer offset to page_tables); page_tables [B, max_pages] int32; positions
// [B] int32. Each sequence attends over context indices
// j < min(max(pos + 1, 1), max_pages * ps) with an f32 online softmax, scale
// 1/sqrt(D), output divided by max(l, 1e-20), written in q's dtype. Int8
// pools apply the reference's per-column algebra: each score is multiplied
// by its key row's K scale, each probability (after the running sum took it)
// by its row's V scale before it weights the int8 V row.
//
// What bounds both on an H100: bytes. Every sequence reads its ceil(len/ps)
// pages of K and V once (int8: one byte a value plus 4 bytes of scale a row);
// the arithmetic is 4 FLOP per K/V element, far below the card's ~295
// FLOP/byte ridge.
//
// K1 design: one block per (sequence, kv head) so the G = Hq/Hkv query heads
// of a GQA group share every K/V row the block loads; each K/V row is read
// straight from HBM into registers by a group of lanes (16 bytes a lane for
// f32 and bf16, 8 int8 values a lane, so an int8 lane keeps as many query and
// accumulator registers as a bf16 lane: 16 values would need 256 of them at
// G = 8), several tokens in flight per row group (kUnroll) to keep loads
// outstanding; each row group keeps its own online-softmax state and the
// groups merge through shared memory at the end. Inactive slots (page tables
// of trash page 0, arbitrary positions) read only in-bounds pages and produce
// finite output. Later work: split-K over long contexts, cp.async/TMA staging.
//
// K3a design: a token's whole K (or V) row, Hkv * D values (TinyLlama: 256,
// 512 bytes in bf16, 256 in int8), is read once by Hkv * D / VEC consecutive
// lanes and serves all Hq heads: the lanes of kv head h's slice hold the
// queries of h's G heads. At the serve batch a block per sequence would leave
// most of the 132 SMs idle, so the context is split (split-K, as K5): block
// (split, sequence) covers split_rows context rows, its row groups merge in
// shared memory into one (m, l, acc) per head written to partial buffers, and
// a second launch merges the splits. Blocks past a sequence's context return
// at once. Every shuffle loop has a block-uniform trip count (a divergent one
// deadlocked K1 once: the lanes of a row group share warps).

#include <type_traits>

#include "decode_rows.cuh"

namespace {

using dtt::consume_rows;
using dtt::decode_ctx;
using dtt::load_rows;
using dtt::RowLoads;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;
constexpr int kFoldThreads = 128;
constexpr int kFoldUnroll = 2;
constexpr int kMergeThreads = 64;  // K3a merge: one thread a column, D <= 64

// ---------------------------------------------------------------- K1

template <typename TQ, typename TK, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ k_pool,
                    const TK* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ page_tables,
                    const int* __restrict__ positions, TQ* __restrict__ out, int Hkv,
                    int page_size, int max_pages, float scale) {
  constexpr int VEC = dtt::RowVec<TK>::N;
  constexpr int LPR = D / VEC;  // lanes per K/V row
  static_assert(D % VEC == 0 && LPR <= 32 && 32 % LPR == 0, "unsupported head_dim");
  constexpr int RPW = 32 / LPR;          // row groups per warp
  constexpr int NROWS = kWarps * RPW;    // row groups per block

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int Hq = Hkv * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPR;
  const int row = warp * RPW + lane / LPR;
  const int d0 = sub * VEC;

  float qf[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    dtt::load_floats<TQ, VEC>(q + ((size_t)b * Hq + kvh * G + g) * D + d0, qf[g]);
  }

  const int ctx = decode_ctx(positions, b, max_pages * page_size);
  const int* pt = page_tables + (size_t)b * max_pages;

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = dtt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  // the trip count is uniform across the block: row groups sharing a warp
  // must run the same iterations, or the full-mask shuffles deadlock
  for (int t0 = 0; t0 < ctx; t0 += NROWS * kUnroll) {
    RowLoads<TK, kUnroll> r;
    load_rows<TK, kUnroll>(r, k_pool, v_pool, k_scale, v_scale, pt, t0, row, NROWS, ctx, page_size,
                           (size_t)Hkv * D, kvh * D + d0);
    consume_rows<TK, kUnroll, G, LPR>(r, qf, scale, m, l, acc);
  }

  // merge the NROWS row groups' partial softmax states
  __shared__ float sm_m[NROWS][G];
  __shared__ float sm_l[NROWS][G];
  __shared__ float sm_acc[NROWS][G][D];
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[row][g] = m[g];
      sm_l[row][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[row][g][d0 + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = dtt::kNegInf;
#pragma unroll
    for (int r = 0; r < NROWS; ++r) mx = fmaxf(mx, sm_m[r][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < NROWS; ++r) {
      const float w = expf(sm_m[r][g] - mx);
      L = fmaf(sm_l[r][g], w, L);
      A = fmaf(sm_acc[r][g][d], w, A);
    }
    dtt::store1(out + ((size_t)b * Hq + kvh * G + g) * D + d, A / fmaxf(L, 1e-20f));
  }
}

// ---------------------------------------------------------------- K3a

// Pass 1: block (split, sequence) covers context rows [split * split_rows,
// min(+split_rows, ctx)) for all Hq heads. Thread t reads the VEC values at
// column (t % RL) * VEC of row group t / RL, RL = Hkv * D / VEC lanes a row
// (RL divides kFoldThreads; the launcher checks). Its head slice is kv head
// (t % RL) / LPH; it holds that kv head's G queries. Writes the block's (m,
// l, acc) per head to m_part, l_part [B, n_split, Hq] and acc_part [B,
// n_split, Hq, D].
template <typename TQ, typename TK, int D, int G>
__global__ void __launch_bounds__(kFoldThreads)
folded_decode_partial(const TQ* __restrict__ q, const TK* __restrict__ k_pool,
                      const TK* __restrict__ v_pool, const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale, const int* __restrict__ page_tables,
                      const int* __restrict__ positions, float* __restrict__ m_part,
                      float* __restrict__ l_part, float* __restrict__ acc_part, int Hkv,
                      int page_size, int max_pages, int split_rows, int n_split, float scale) {
  constexpr int VEC = dtt::RowVec<TK>::N;
  constexpr int LPH = D / VEC;  // lanes per head slice of a row
  static_assert(D % VEC == 0 && LPH <= 32 && 32 % LPH == 0, "unsupported head_dim");
  const int RL = Hkv * LPH;     // lanes per row
  const int NROWS = kFoldThreads / RL;
  const int Hq = Hkv * G;

  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int ctx = decode_ctx(positions, b, max_pages * page_size);
  const int r0 = split * split_rows;
  if (r0 >= ctx) return;  // block-uniform: this split holds no context
  const int r1 = min(r0 + split_rows, ctx);

  const int row = threadIdx.x / RL;
  const int rl = threadIdx.x % RL;
  const int kvh = rl / LPH;
  const int d0 = (rl % LPH) * VEC;
  const int* pt = page_tables + (size_t)b * max_pages;

  float qf[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    dtt::load_floats<TQ, VEC>(q + ((size_t)b * Hq + kvh * G + g) * D + d0, qf[g]);
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = dtt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  // block-uniform trip count (r0, r1 and NROWS are the block's)
  for (int t0 = r0; t0 < r1; t0 += NROWS * kFoldUnroll) {
    RowLoads<TK, kFoldUnroll> r;
    load_rows<TK, kFoldUnroll>(r, k_pool, v_pool, k_scale, v_scale, pt, t0, row, NROWS, r1,
                               page_size, (size_t)Hkv * D, rl * VEC);
    consume_rows<TK, kFoldUnroll, G, LPH>(r, qf, scale, m, l, acc);
  }

  // merge the row groups: sm_m, sm_l [NROWS][Hq], sm_acc [NROWS][Hq][D]
  extern __shared__ float smem[];
  float* sm_m = smem;
  float* sm_l = sm_m + NROWS * Hq;
  float* sm_acc = sm_l + NROWS * Hq;
  const int h0 = row * Hq + kvh * G;
  if (d0 == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[h0 + g] = m[g];
      sm_l[h0 + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[(size_t)(h0 + g) * D + d0 + i] = acc[g][i];
  }
  __syncthreads();
  const size_t part = (size_t)b * n_split + split;
  for (int idx = threadIdx.x; idx < Hq * D; idx += kFoldThreads) {
    const int h = idx / D;
    const int d = idx % D;
    float mx = dtt::kNegInf;
    for (int r = 0; r < NROWS; ++r) mx = fmaxf(mx, sm_m[r * Hq + h]);
    float L = 0.f, A = 0.f;
    for (int r = 0; r < NROWS; ++r) {
      const float w = expf(sm_m[r * Hq + h] - mx);
      L = fmaf(sm_l[r * Hq + h], w, L);
      A = fmaf(sm_acc[(size_t)(r * Hq + h) * D + d], w, A);
    }
    acc_part[(part * Hq + h) * D + d] = A;
    if (d == 0) {
      m_part[part * Hq + h] = mx;
      l_part[part * Hq + h] = L;
    }
  }
}

// Pass 2: block (head, sequence) merges the sequence's splits that hold
// context for that head, one output column a thread.
template <typename TQ>
__global__ void __launch_bounds__(kMergeThreads)
folded_decode_merge(const float* __restrict__ m_part, const float* __restrict__ l_part,
                    const float* __restrict__ acc_part, const int* __restrict__ positions,
                    TQ* __restrict__ out, int Hq, int D, int page_size, int max_pages,
                    int split_rows, int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ctx = decode_ctx(positions, b, max_pages * page_size);
  const int n = (ctx + split_rows - 1) / split_rows;
  const size_t base = (size_t)b * n_split;
  float mx = dtt::kNegInf;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, m_part[(base + s) * Hq + h]);
  float tot = 0.f;
  for (int s = 0; s < n; ++s) tot = fmaf(l_part[(base + s) * Hq + h], expf(m_part[(base + s) * Hq + h] - mx), tot);
  const float denom = fmaxf(tot, 1e-20f);
  for (int d = threadIdx.x; d < D; d += kMergeThreads) {
    float a = 0.f;
    for (int s = 0; s < n; ++s)
      a = fmaf(acc_part[((base + s) * Hq + h) * D + d], expf(m_part[(base + s) * Hq + h] - mx), a);
    dtt::store1(out + ((size_t)b * Hq + h) * D + d, a / denom);
  }
}

// ---------------------------------------------------------------- launch

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pt;
  const int* pos;
  void* out;
  int B, Hq, Hkv, D, ps, max_pages;
  cudaStream_t stream;
};

template <typename TQ, typename TK, int D, int G>
int launch_k1(const DecodeArgs& a) {
  paged_decode_kernel<TQ, TK, D, G><<<dim3(a.Hkv, a.B), kThreads, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks,
      a.vs, a.pt, a.pos, static_cast<TQ*>(a.out), a.Hkv, a.ps, a.max_pages,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename TQ, typename TK, int D, int G>
int launch_k3a(const DecodeArgs& a, float* m_part, float* l_part, float* acc_part, int split_rows,
               int n_split) {
  constexpr int VEC = dtt::RowVec<TK>::N;
  const int nrows = kFoldThreads / (a.Hkv * (D / VEC));
  const size_t smem = (size_t)nrows * a.Hq * (2 + D) * sizeof(float);
  folded_decode_partial<TQ, TK, D, G><<<dim3(n_split, a.B), kFoldThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks,
      a.vs, a.pt, a.pos, m_part, l_part, acc_part, a.Hkv, a.ps, a.max_pages, split_rows, n_split,
      1.0f / sqrtf((float)D));
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  folded_decode_merge<TQ><<<dim3(a.Hq, a.B), kMergeThreads, 0, a.stream>>>(
      m_part, l_part, acc_part, a.pos, static_cast<TQ*>(a.out), a.Hq, D, a.ps, a.max_pages,
      split_rows, n_split);
  return (int)cudaGetLastError();
}

// Dispatch on (D, G) to F<TQ, TK, D, G>::run; D in Ds, G in {1, 2, 4, 8}.
template <template <typename, typename, int, int> class F, typename TQ, typename TK, int D,
          typename... Args>
int with_group(int G, Args&&... args) {
  switch (G) {
    case 1: return F<TQ, TK, D, 1>::run(args...);
    case 2: return F<TQ, TK, D, 2>::run(args...);
    case 4: return F<TQ, TK, D, 4>::run(args...);
    case 8: return F<TQ, TK, D, 8>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TK, int D, int G>
struct K1Launch {
  static int run(const DecodeArgs& a) { return launch_k1<TQ, TK, D, G>(a); }
};

template <typename TQ, typename TK, int D, int G>
struct K3aLaunch {
  static int run(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
    return launch_k3a<TQ, TK, D, G>(a, m, l, acc, split_rows, n_split);
  }
};

template <typename TQ, typename TK>
int k1_types(const DecodeArgs& a) {
  const int G = a.Hq / a.Hkv;
  switch (a.D) {
    case 64: return with_group<K1Launch, TQ, TK, 64>(G, a);
    case 128: return with_group<K1Launch, TQ, TK, 128>(G, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TK>
int k3a_types(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
  constexpr int VEC = dtt::RowVec<TK>::N;
  const int G = a.Hq / a.Hkv;
  if (a.D % VEC) return (int)cudaErrorInvalidValue;
  const int rl = a.Hkv * (a.D / VEC);  // lanes per row: must divide the block
  if (rl > kFoldThreads || kFoldThreads % rl) return (int)cudaErrorInvalidValue;
  switch (a.D) {
    case 16: return with_group<K3aLaunch, TQ, TK, 16>(G, a, m, l, acc, split_rows, n_split);
    case 32: return with_group<K3aLaunch, TQ, TK, 32>(G, a, m, l, acc, split_rows, n_split);
    case 64: return with_group<K3aLaunch, TQ, TK, 64>(G, a, m, l, acc, split_rows, n_split);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 = bfloat16
// (both the same as q_dtype), 2 = int8 with scale planes.
template <template <typename, typename> class Call, typename... Args>
int with_types(int q_dtype, int kv_dtype, Args&&... args) {
  if (q_dtype == 0 && kv_dtype == 0) return Call<float, float>::run(args...);
  if (q_dtype == 1 && kv_dtype == 1) return Call<__nv_bfloat16, __nv_bfloat16>::run(args...);
  if (q_dtype == 0 && kv_dtype == 2) return Call<float, int8_t>::run(args...);
  if (q_dtype == 1 && kv_dtype == 2) return Call<__nv_bfloat16, int8_t>::run(args...);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TK>
struct K1Types {
  static int run(const DecodeArgs& a) { return k1_types<TQ, TK>(a); }
};

template <typename TQ, typename TK>
struct K3aTypes {
  static int run(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
    return k3a_types<TQ, TK>(a, m, l, acc, split_rows, n_split);
  }
};

bool decode_shapes_ok(const DecodeArgs& a, int kv_dtype) {
  return a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.ps > 0 && a.max_pages > 0 &&
         (kv_dtype != 2 || (a.ks != nullptr && a.vs != nullptr));
}

}  // namespace

// K1. Returns cudaGetLastError() after the launch (0 = launched); shapes the
// kernel does not take return cudaErrorInvalidValue without launching.
extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const void* page_tables, const void* positions, void* out,
                                      int B, int Hq, int Hkv, int D, int page_size, int max_pages,
                                      int q_dtype, int kv_dtype, void* stream) {
  const DecodeArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale), static_cast<const int*>(page_tables),
                     static_cast<const int*>(positions), out, B, Hq, Hkv, D, page_size, max_pages,
                     static_cast<cudaStream_t>(stream)};
  if (B <= 0) return 0;
  if (!decode_shapes_ok(a, kv_dtype)) return (int)cudaErrorInvalidValue;
  return with_types<K1Types>(q_dtype, kv_dtype, a);
}

// K3a. Partial buffers m_part, l_part [B, n_split, Hq] and acc_part [B,
// n_split, Hq, D] f32, n_split >= ceil(max_pages * page_size / split_rows).
extern "C" int paged_decode_attention_folded(const void* q, const void* k_pool,
                                             const void* v_pool, const void* k_scale,
                                             const void* v_scale, const void* page_tables,
                                             const void* positions, void* m_part, void* l_part,
                                             void* acc_part, void* out, int B, int Hq, int Hkv,
                                             int D, int page_size, int max_pages, int split_rows,
                                             int n_split, int q_dtype, int kv_dtype,
                                             void* stream) {
  const DecodeArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale), static_cast<const int*>(page_tables),
                     static_cast<const int*>(positions), out, B, Hq, Hkv, D, page_size, max_pages,
                     static_cast<cudaStream_t>(stream)};
  if (B <= 0) return 0;
  if (!decode_shapes_ok(a, kv_dtype) || split_rows <= 0 ||
      (long long)n_split * split_rows < (long long)max_pages * page_size)
    return (int)cudaErrorInvalidValue;
  return with_types<K3aTypes>(q_dtype, kv_dtype, a, static_cast<float*>(m_part),
                              static_cast<float*>(l_part), static_cast<float*>(acc_part),
                              split_rows, n_split);
}
