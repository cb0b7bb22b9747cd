// K2 and K3b: chunked-prefill flash attention over the paged KV pool, and
// K7a, K2's load-only twin, for Hopper (sm_90a).
//
// K2 replaces the TPU kernel dynamo_tpu/ops/pallas/prefill_attention.py
// paged_prefill_attention_pallas (_kernel_lookahead / _kernel, math in
// _flash_merge). K3b replaces paged_prefill_attention_pallas_folded
// (_kernel_folded), the same function for head dims that are not a multiple
// of 128 (TinyLlama's 64), which the TPU reads from pools with the kv heads
// folded into the lane dim through zero-placed folded queries (a Mosaic lane
// workaround, not carried over). The TPU variants differ only in DMA
// scheduling across the serial TPU grid; nothing carries between CUDA
// blocks, so neither schedule is copied.
//
// Contract (per lane n of N packed lanes; N = 1 is the single-chunk call):
// q [N*T, Hq, D] f32 or bf16; k/v pools [P, ps, Hkv, D] (the folded [P, ps,
// Hkv*D] is the same memory) of q's dtype, or int8 with f32 scale planes [P,
// ps], one scale a token row; page_tables [N, max_pages] int32 (layer offset
// already added); positions [N, T] int32, UNIT-STRIDE within a lane (row i
// sits at positions[n, 0] + i). A query block reads context up to its last
// row's position, never past max_pages * ps; a row at position p attends
// context j <= p. f32 scores and online softmax, scale 1/sqrt(D), output
// divided by max(l, 1e-20), written in q's dtype. Int8 pools: each score is
// multiplied by its key row's K scale and each probability, after the
// running sum took it, by the row's V scale (the reference's per-column
// algebra). The chunk's own K/V rows are already in the pool (the model
// scatters before attending).
//
// What bounds both on an H100: at prefill sizes, arithmetic (4 * Hq * D FLOP
// per causal (row, key) pair) rather than the context bytes. Both stage K/V
// tiles of 32 keys page by page from HBM into shared memory as f32 (16-byte
// loads: 4 f32, 8 bf16 or 16 int8 values; keys past the block's context
// bound are not read, so pad rows and pad lanes, whose page tables point at
// trash page 0, stay in bounds), keep their Q tile in shared memory for the
// whole loop, and run 256 threads (16 x 16) of f32 FMA micro-tiles. Tensor
// cores (wgmma), a TMA/cp.async pipeline and split-K are later work.
//
// K2 design: one block per (64 (query, head) rows, kv head, lane): the block
// covers 64/G query positions of the G = Hq/Hkv q heads of one kv head, so
// every K/V tile it stages (D columns) is shared by the GQA group; threads
// compute 4x2 score and 4x(D/16) output micro-tiles.
//
// K3b design: one block per (BQ query positions, lane) covering ALL Hq heads
// (Hq = 16 HJ, HJ in {1, 2, 4}; BQ = 16 / HJ), 256 (query, head) rows, so
// every staged tile of F = Hkv * D columns serves every head and no kv head's
// tile is staged twice. Thread (ty, tx) owns the 16 rows of heads ty + 16 j
// (j < HJ) at the BQ query positions and keys tx, tx + 16; its f32 output
// accumulators, 16 rows x D/16 columns (64 at D = 64), stay in registers:
// that register budget is what sizes the query tile. Shared memory holds the
// Q tile (256 x D f32), the K/V tiles (32 x F each) and the probabilities;
// at D = 64 that is 161 KB for F = 256 and 225 KB for F = 512, the most a
// block can have, so F is capped at 512.
//
// K7a replaces dynamo_tpu/ops/pallas/prefill_attention.py
// paged_prefill_dmaonly (_kernel_dmaonly), the null-hypothesis instrument of
// tools/profile_prefill.py: K2's grid (one block per (64 (query, head) rows,
// kv head, lane)), its causal tile bound and its tile staging (32-key tiles
// into shared memory, the same 16-byte loads and f32 conversion, int8 scales
// included) with no math. The reference's twin writes 1e-6 x one row of the
// last tile, garbage by design; a load that nothing reads is deleted by nvcc,
// so every row the block owns gets instead the f32 column sums over the
// block's context j < min(last row's position + 1, max_pages * ps) of (K +
// V)[j, kv head, :], int8 rows dequantized (code x row scale). Its time
// against K2's is the share of K2 that its load stream explains.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRows = 64;     // K2: (query, head) rows per block
constexpr int kKeys = 32;     // keys per context tile
constexpr int kThreads = 256; // 16 x 16: ty owns rows, tx keys tx and tx + 16
constexpr int kPStride = kKeys + 16;
constexpr int kFRows = 256;   // K3b: (query, head) rows per block
constexpr int kFRPT = 16;     // K3b: rows per thread
constexpr int kFPStride = kFRows + 4;
constexpr int kMaxFoldedWidth = 512;  // K3b: F = Hkv * D at most

template <int D>
constexpr int smem_floats() {
  return kRows * (D + 4) + kKeys * (D + 4) + kKeys * D + kRows * kPStride + 2 * kKeys;
}

constexpr size_t folded_smem_bytes(int D, int F) {
  return ((size_t)kFRows * D + (size_t)kKeys * (F + 4) + (size_t)kKeys * F +
          (size_t)kKeys * kFPStride + 2 * kKeys) * sizeof(float);
}

template <typename T>
__device__ __forceinline__ void load_row_f32(float* dst_row, const T* src_row, bool ok, int c) {
  using V16 = dtt::Vec16<T>;
  float f[V16::N];
  if (ok) {
    dtt::to_float(dtt::load16(src_row + c), f);
  } else {
#pragma unroll
    for (int i = 0; i < V16::N; ++i) f[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < V16::N; i += 4) dtt::store4(dst_row + c + i, f + i);
}

// Stage context keys [kt0, kt0 + kKeys) of one lane, F columns a row, into
// sK (row stride KS) and sV (row stride F) as f32, and for int8 the rows'
// scales into sKs / sVs; keys at or past n_ctx are zero and are not read.
template <typename TK>
__device__ __forceinline__ void stage_kv(float* sK, float* sV, float* sKs, float* sVs,
                                         const TK* __restrict__ k_pool,
                                         const TK* __restrict__ v_pool,
                                         const float* __restrict__ k_scale,
                                         const float* __restrict__ v_scale,
                                         const int* __restrict__ pt, int kt0, int n_ctx,
                                         int page_size, int F, int KS, size_t token_stride,
                                         int col0) {
  constexpr int VEC = dtt::Vec16<TK>::N;
  const int vpr = F / VEC;
  for (int idx = threadIdx.x; idx < kKeys * vpr; idx += kThreads) {
    const int kk = idx / vpr;
    const int c = (idx - kk * vpr) * VEC;
    const int j = kt0 + kk;
    const bool ok = j < n_ctx;
    size_t base = 0;
    if (ok) base = ((size_t)pt[j / page_size] * page_size + (j % page_size)) * token_stride + col0;
    load_row_f32<TK>(sK + kk * KS, k_pool + base, ok, c);
    load_row_f32<TK>(sV + kk * F, v_pool + base, ok, c);
  }
  if constexpr (std::is_same<TK, int8_t>::value) {
    if (threadIdx.x < kKeys) {
      const int j = kt0 + threadIdx.x;
      float ks = 0.f, vs = 0.f;
      if (j < n_ctx) {
        const size_t tok = (size_t)pt[j / page_size] * page_size + (j % page_size);
        ks = k_scale[tok];
        vs = v_scale[tok];
      }
      sKs[threadIdx.x] = ks;
      sVs[threadIdx.x] = vs;
    }
  }
}

// The online-softmax step of one row for keys tx and tx + 16: masks, scales
// (int8: by the key's K scale), reduces over the 16 tx lanes of the row's
// half-warp, writes the probabilities (int8: times the V scale) to sP_row
// and rescales the row's accumulators. Every thread runs it.
template <bool kQuant, int C>
__device__ __forceinline__ void softmax_step(float (&s)[2], int kt0, int qpos, int n_ctx,
                                             float scale, const float* sKs, const float* sVs,
                                             float* sP_row0, float* sP_row1, float& m, float& l,
                                             float (&o)[C]) {
  const int tx = threadIdx.x % 16;
  float rmax = dtt::kNegInf;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = kt0 + tx + 16 * jj;
    float v = s[jj] * scale;
    if constexpr (kQuant) v *= sKs[tx + 16 * jj];
    s[jj] = (j <= qpos && j < n_ctx) ? v : dtt::kNegInf;
    rmax = fmaxf(rmax, s[jj]);
  }
  // the 16 tx lanes of a row sit in one half-warp
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
  const float new_m = fmaxf(m, rmax);
  const float corr = expf(m - new_m);
  float rsum = 0.f;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const float p = expf(s[jj] - new_m);
    rsum += p;
    const float pv = kQuant ? p * sVs[tx + 16 * jj] : p;
    *(jj == 0 ? sP_row0 : sP_row1) = pv;
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
  l = l * corr + rsum;
  m = new_m;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] *= corr;
}

// ---------------------------------------------------------------- K2

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const TQ* __restrict__ q, const TK* __restrict__ k_pool,
                     const TK* __restrict__ v_pool, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int* __restrict__ page_tables,
                     const int* __restrict__ positions, TQ* __restrict__ out, int T_len, int Hq,
                     int Hkv, int page_size, int max_pages, float scale) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  constexpr int VECQ = dtt::Vec16<TQ>::N;
  constexpr int QS = D + 4;  // padded f32 row stride of the Q and K tiles
  constexpr int OC = D / 64; // float4 output column groups per thread
  static_assert(D % 64 == 0, "unsupported head_dim");

  extern __shared__ float4 smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kRows][QS]
  float* sK = sQ + kRows * QS;                     // [kKeys][QS]
  float* sV = sK + kKeys * QS;                     // [kKeys][D]
  float* sP = sV + kKeys * D;                      // [kRows][kPStride]
  float* sKs = sP + kRows * kPStride;              // [kKeys]
  float* sVs = sKs + kKeys;                        // [kKeys]

  const int G = Hq / Hkv;
  const int BQ = kRows / G;  // query positions per block
  const int qb = blockIdx.x;
  const int kvh = blockIdx.y;
  const int n = blockIdx.z;
  const int q_start = qb * BQ;
  const int n_q = min(BQ, T_len - q_start);
  const int* pos = positions + (size_t)n * T_len;
  const int* pt = page_tables + (size_t)n * max_pages;
  const int pos0 = pos[q_start];
  const int last_pos = pos[q_start + n_q - 1];
  const int n_ctx = min(last_pos + 1, max_pages * page_size);

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  // Q tile: row r = (head g = r / BQ, query qi = r % BQ)
  for (int idx = tid; idx < kRows * (D / VECQ); idx += kThreads) {
    const int r = idx / (D / VECQ);
    const int c = (idx % (D / VECQ)) * VECQ;
    const int g = r / BQ;
    const int qi = r % BQ;
    const TQ* src = q + (((size_t)n * T_len + q_start + qi) * Hq + (size_t)kvh * G + g) * D;
    load_row_f32<TQ>(sQ + r * QS, src, qi < n_q, c);
  }

  float m[4], l[4], o[4][OC * 4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = dtt::kNegInf;
    l[i] = 0.f;
    qpos[i] = pos0 + (ty + 16 * i) % BQ;
#pragma unroll
    for (int c = 0; c < OC * 4; ++c) o[i][c] = 0.f;
  }

  for (int kt0 = 0; kt0 < n_ctx; kt0 += kKeys) {
    __syncthreads();  // previous tile's readers are done with sK / sV / sP
    stage_kv<TK>(sK, sV, sKs, sVs, k_pool, v_pool, k_scale, v_scale, pt, kt0, n_ctx, page_size, D,
                 QS, (size_t)Hkv * D, kvh * D);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) kv[jj] = *reinterpret_cast<const float4*>(sK + (tx + 16 * jj) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = sP + (ty + 16 * i) * kPStride + tx;
      softmax_step<kQuant, OC * 4>(s[i], kt0, qpos[i], n_ctx, scale, sKs, sVs, row, row + 16, m[i],
                                   l[i], o[i]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + kk * D + tx * 4 + 64 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][4 * c] = fmaf(p[i], vv.x, o[i][4 * c]);
          o[i][4 * c + 1] = fmaf(p[i], vv.y, o[i][4 * c + 1]);
          o[i][4 * c + 2] = fmaf(p[i], vv.z, o[i][4 * c + 2]);
          o[i][4 * c + 3] = fmaf(p[i], vv.w, o[i][4 * c + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int g = r / BQ;
    const int qi = r % BQ;
    if (qi >= n_q) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    TQ* dst = out + (((size_t)n * T_len + q_start + qi) * Hq + (size_t)kvh * G + g) * D;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = o[i][4 * c + e] / denom;
      dtt::store4(dst + tx * 4 + 64 * c, f);
    }
  }
}

// ---------------------------------------------------------------- K3b

// Block (query tile, lane): BQ = kFRPT / HJ query positions x Hq = 16 HJ
// heads. Thread (ty, tx) owns rows i < kFRPT: head ty + 16 (i / BQ) at query
// qi = i % BQ, stored at sQ row ty * kFRPT + i; keys tx and tx + 16 of each
// tile; output columns tx * CW .. + CW of its rows.
template <typename TQ, typename TK, int D, int HJ>
__global__ void __launch_bounds__(kThreads)
folded_prefill_kernel(const TQ* __restrict__ q, const TK* __restrict__ k_pool,
                      const TK* __restrict__ v_pool, const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale, const int* __restrict__ page_tables,
                      const int* __restrict__ positions, TQ* __restrict__ out, int T_len, int Hkv,
                      int page_size, int max_pages, float scale) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  constexpr int BQ = kFRPT / HJ;  // query positions per block
  constexpr int CW = D / 16;      // output columns per thread
  constexpr int VECQ = dtt::Vec16<TQ>::N;
  static_assert(kFRPT % HJ == 0 && D % 16 == 0 && D % VECQ == 0, "unsupported shape");
  const int Hq = 16 * HJ;
  const int G = Hq / Hkv;
  const int F = Hkv * D;
  const int KS = F + 4;  // padded f32 row stride of the K tile

  extern __shared__ float4 smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kFRows][D]
  float* sK = sQ + kFRows * D;                     // [kKeys][KS]
  float* sV = sK + kKeys * KS;                     // [kKeys][F]
  float* sP = sV + kKeys * F;                      // [kKeys][kFPStride]
  float* sKs = sP + kKeys * kFPStride;             // [kKeys]
  float* sVs = sKs + kKeys;                        // [kKeys]

  const int qb = blockIdx.x;
  const int n = blockIdx.y;
  const int q_start = qb * BQ;
  const int n_q = min(BQ, T_len - q_start);
  const int* pos = positions + (size_t)n * T_len;
  const int* pt = page_tables + (size_t)n * max_pages;
  const int pos0 = pos[q_start];
  const int last_pos = pos[q_start + n_q - 1];
  const int n_ctx = min(last_pos + 1, max_pages * page_size);

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  for (int idx = tid; idx < kFRows * (D / VECQ); idx += kThreads) {
    const int r = idx / (D / VECQ);
    const int c = (idx % (D / VECQ)) * VECQ;
    const int i = r % kFRPT;
    const int h = r / kFRPT + 16 * (i / BQ);
    const int qi = i % BQ;
    const TQ* src = q + (((size_t)n * T_len + q_start + qi) * Hq + h) * D;
    load_row_f32<TQ>(sQ + r * D, src, qi < n_q, c);
  }

  int kcol[HJ];  // column of the kv head of head ty + 16 j in a K/V row
#pragma unroll
  for (int j = 0; j < HJ; ++j) kcol[j] = ((ty + 16 * j) / G) * D;

  float m[kFRPT], l[kFRPT], o[kFRPT][CW];
#pragma unroll
  for (int i = 0; i < kFRPT; ++i) {
    m[i] = dtt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) o[i][c] = 0.f;
  }
  const float* sQt = sQ + ty * kFRPT * D;

  for (int kt0 = 0; kt0 < n_ctx; kt0 += kKeys) {
    __syncthreads();  // previous tile's readers are done with sK / sV / sP
    stage_kv<TK>(sK, sV, sKs, sVs, k_pool, v_pool, k_scale, v_scale, pt, kt0, n_ctx, page_size, F,
                 KS, (size_t)F, 0);
    __syncthreads();

    float s[kFRPT][2];
#pragma unroll
    for (int i = 0; i < kFRPT; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[HJ][2];
#pragma unroll
      for (int j = 0; j < HJ; ++j)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          kv[j][jj] = *reinterpret_cast<const float4*>(sK + (tx + 16 * jj) * KS + kcol[j] + d);
#pragma unroll
      for (int i = 0; i < kFRPT; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(sQt + i * D + d);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float4 k = kv[i / BQ][jj];
          s[i][jj] = fmaf(qv.x, k.x, s[i][jj]);
          s[i][jj] = fmaf(qv.y, k.y, s[i][jj]);
          s[i][jj] = fmaf(qv.z, k.z, s[i][jj]);
          s[i][jj] = fmaf(qv.w, k.w, s[i][jj]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kFRPT; ++i) {
      float* p0 = sP + tx * kFPStride + ty * kFRPT + i;
      softmax_step<kQuant, CW>(s[i], kt0, pos0 + i % BQ, n_ctx, scale, sKs, sVs, p0,
                               p0 + 16 * kFPStride, m[i], l[i], o[i]);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kKeys; ++kk) {
      float p[kFRPT];
#pragma unroll
      for (int i = 0; i < kFRPT; i += 4) {
        const float4 pv = *reinterpret_cast<const float4*>(sP + kk * kFPStride + ty * kFRPT + i);
        p[i] = pv.x;
        p[i + 1] = pv.y;
        p[i + 2] = pv.z;
        p[i + 3] = pv.w;
      }
      float vv[HJ][CW];
#pragma unroll
      for (int j = 0; j < HJ; ++j)
#pragma unroll
        for (int c = 0; c < CW; ++c) vv[j][c] = sV[kk * F + kcol[j] + tx * CW + c];
#pragma unroll
      for (int i = 0; i < kFRPT; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) o[i][c] = fmaf(p[i], vv[i / BQ][c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kFRPT; ++i) {
    const int qi = i % BQ;
    if (qi >= n_q) continue;
    const int h = ty + 16 * (i / BQ);
    const float denom = fmaxf(l[i], 1e-20f);
    TQ* dst = out + (((size_t)n * T_len + q_start + qi) * Hq + h) * D + tx * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) dtt::store1(dst + c, o[i][c] / denom);
  }
}

// ---------------------------------------------------------------- K7a

template <int D>
constexpr int twin_smem_floats() {
  return kKeys * (D + 4) + kKeys * D + 2 * kKeys + kThreads;  // + [kThreads / D][D] sums
}

template <typename TK, int D>
__global__ void __launch_bounds__(kThreads)
prefill_load_twin(const TK* __restrict__ k_pool, const TK* __restrict__ v_pool,
                  const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                  const int* __restrict__ page_tables, const int* __restrict__ positions,
                  float* __restrict__ out, int T_len, int Hq, int Hkv, int page_size,
                  int max_pages) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  constexpr int KS = D + 4;            // K2's padded K-tile row stride
  constexpr int PARTS = kThreads / D;  // threads summing one column
  static_assert(kThreads % D == 0, "unsupported head_dim");

  extern __shared__ float4 smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [kKeys][KS]
  float* sV = sK + kKeys * KS;                     // [kKeys][D]
  float* sKs = sV + kKeys * D;                     // [kKeys]
  float* sVs = sKs + kKeys;                        // [kKeys]
  float* red = sVs + kKeys;                        // [PARTS][D]

  // K2's block partition
  const int G = Hq / Hkv;
  const int BQ = kRows / G;
  const int q_start = blockIdx.x * BQ;
  const int kvh = blockIdx.y;
  const int n = blockIdx.z;
  const int n_q = min(BQ, T_len - q_start);
  const int* pos = positions + (size_t)n * T_len;
  const int* pt = page_tables + (size_t)n * max_pages;
  const int n_ctx = min(pos[q_start + n_q - 1] + 1, max_pages * page_size);

  const int c = threadIdx.x % D;
  const int part = threadIdx.x / D;
  float sum = 0.f;
  for (int kt0 = 0; kt0 < n_ctx; kt0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    stage_kv<TK>(sK, sV, sKs, sVs, k_pool, v_pool, k_scale, v_scale, pt, kt0, n_ctx, page_size, D,
                 KS, (size_t)Hkv * D, kvh * D);
    __syncthreads();
    // keys at or past n_ctx were staged as zeros (int8: zero scales too)
    for (int kk = part; kk < kKeys; kk += PARTS) {
      if constexpr (kQuant) {
        sum += sK[kk * KS + c] * sKs[kk] + sV[kk * D + c] * sVs[kk];
      } else {
        sum += sK[kk * KS + c] + sV[kk * D + c];
      }
    }
  }
  red[part * D + c] = sum;
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int g = r / BQ;
    const int qi = r % BQ;
    if (qi >= n_q) continue;
    float a = 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) a += red[p * D + d];
    out[(((size_t)n * T_len + q_start + qi) * Hq + (size_t)kvh * G + g) * D + d] = a;
  }
}

// ---------------------------------------------------------------- launch

struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pt;
  const int* pos;
  void* out;
  int N, T_len, Hq, Hkv, D, ps, max_pages;
  cudaStream_t stream;
};

template <typename TQ, typename TK, int D>
int launch_k2(const PrefillArgs& a) {
  // the dynamic shared memory exceeds the 48 KiB default at D=128
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  const size_t smem = (size_t)smem_floats<D>() * sizeof(float);
  const cudaError_t err =
      dtt::raise_smem_limit_once(paged_prefill_kernel<TQ, TK, D>, smem_raised, smem);
  if (err != cudaSuccess) return (int)err;
  const int BQ = kRows / (a.Hq / a.Hkv);
  const dim3 grid((a.T_len + BQ - 1) / BQ, a.Hkv, a.N);
  paged_prefill_kernel<TQ, TK, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks,
      a.vs, a.pt, a.pos, static_cast<TQ*>(a.out), a.T_len, a.Hq, a.Hkv, a.ps, a.max_pages,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename TK, int D>
int launch_k7a(const PrefillArgs& a) {
  // within the default 48 KB of dynamic shared memory (34.5 KB at D = 128)
  const size_t smem = (size_t)twin_smem_floats<D>() * sizeof(float);
  const int BQ = kRows / (a.Hq / a.Hkv);
  const dim3 grid((a.T_len + BQ - 1) / BQ, a.Hkv, a.N);
  prefill_load_twin<TK, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks, a.vs, a.pt, a.pos,
      static_cast<float*>(a.out), a.T_len, a.Hq, a.Hkv, a.ps, a.max_pages);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TK, int D, int HJ>
int launch_k3b(const PrefillArgs& a) {
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  const cudaError_t err = dtt::raise_smem_limit_once(
      folded_prefill_kernel<TQ, TK, D, HJ>, smem_raised, folded_smem_bytes(D, kMaxFoldedWidth));
  if (err != cudaSuccess) return (int)err;
  constexpr int BQ = kFRPT / HJ;
  const dim3 grid((a.T_len + BQ - 1) / BQ, a.N);
  folded_prefill_kernel<TQ, TK, D, HJ><<<grid, kThreads, folded_smem_bytes(D, a.Hkv * D), a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks,
      a.vs, a.pt, a.pos, static_cast<TQ*>(a.out), a.T_len, a.Hkv, a.ps, a.max_pages,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename TQ, typename TK>
struct K2Types {
  static int run(const PrefillArgs& a) {
    if (kRows % (a.Hq / a.Hkv)) return (int)cudaErrorInvalidValue;
    switch (a.D) {
      case 64: return launch_k2<TQ, TK, 64>(a);
      case 128: return launch_k2<TQ, TK, 128>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
};

// K7a reads no queries: TQ only selects the pool mix, as for K2
template <typename TQ, typename TK>
struct K7aTypes {
  static int run(const PrefillArgs& a) {
    if (kRows % (a.Hq / a.Hkv)) return (int)cudaErrorInvalidValue;
    switch (a.D) {
      case 64: return launch_k7a<TK, 64>(a);
      case 128: return launch_k7a<TK, 128>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
};

template <typename TQ, typename TK, int D>
int k3b_heads(const PrefillArgs& a) {
  switch (a.Hq) {
    case 16: return launch_k3b<TQ, TK, D, 1>(a);
    case 32: return launch_k3b<TQ, TK, D, 2>(a);
    case 64: return launch_k3b<TQ, TK, D, 4>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TK>
struct K3bTypes {
  static int run(const PrefillArgs& a) {
    if (a.Hkv * a.D > kMaxFoldedWidth || (a.Hkv * a.D) % 16) return (int)cudaErrorInvalidValue;
    switch (a.D) {
      case 16: return k3b_heads<TQ, TK, 16>(a);
      case 32: return k3b_heads<TQ, TK, 32>(a);
      case 64: return k3b_heads<TQ, TK, 64>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
};

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 = bfloat16
// (both the same as q_dtype), 2 = int8 with scale planes.
template <template <typename, typename> class Call>
int with_types(int q_dtype, int kv_dtype, const PrefillArgs& a) {
  if (q_dtype == 0 && kv_dtype == 0) return Call<float, float>::run(a);
  if (q_dtype == 1 && kv_dtype == 1) return Call<__nv_bfloat16, __nv_bfloat16>::run(a);
  if (q_dtype == 0 && kv_dtype == 2) return Call<float, int8_t>::run(a);
  if (q_dtype == 1 && kv_dtype == 2) return Call<__nv_bfloat16, int8_t>::run(a);
  return (int)cudaErrorInvalidValue;
}

bool prefill_shapes_ok(const PrefillArgs& a, int kv_dtype) {
  return a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.ps > 0 && a.max_pages > 0 &&
         (kv_dtype != 2 || (a.ks != nullptr && a.vs != nullptr));
}

}  // namespace

// K2, K3b and K7a share one signature (K7a reads no q and writes float32
// checksums to out). Returns cudaGetLastError() after the
// launch (0 = launched); shapes the kernel does not take return
// cudaErrorInvalidValue without launching.
#define PREFILL_ENTRY(name, Call)                                                               \
  extern "C" int name(const void* q, const void* k_pool, const void* v_pool, const void* k_scale, \
                      const void* v_scale, const void* page_tables, const void* positions,      \
                      void* out, int N, int T_len, int Hq, int Hkv, int D, int page_size,       \
                      int max_pages, int q_dtype, int kv_dtype, void* stream) {                 \
    const PrefillArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),                  \
                        static_cast<const float*>(v_scale), static_cast<const int*>(page_tables), \
                        static_cast<const int*>(positions), out, N, T_len, Hq, Hkv, D,          \
                        page_size, max_pages, static_cast<cudaStream_t>(stream)};               \
    if (N <= 0 || T_len <= 0) return 0;                                                         \
    if (!prefill_shapes_ok(a, kv_dtype)) return (int)cudaErrorInvalidValue;                     \
    return with_types<Call>(q_dtype, kv_dtype, a);                                              \
  }

PREFILL_ENTRY(paged_prefill_attention, K2Types)
PREFILL_ENTRY(paged_prefill_attention_folded, K3bTypes)
PREFILL_ENTRY(paged_prefill_dmaonly, K7aTypes)
