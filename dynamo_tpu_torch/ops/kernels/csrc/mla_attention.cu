// K5 and K6: paged MLA (latent) attention for Hopper (sm_90a).
//
// K5 replaces the TPU kernels dynamo_tpu/ops/pallas/mla_attention.py
// paged_mla_decode_attention_pallas (_kernel, and _kernel_lookahead, which
// computes the same function with cross-program DMA prefetch). K6 replaces
// paged_mla_prefill_attention_pallas (_prefill_kernel).
//
// Contract (the Pallas kernels'): q_cat [.., H, L] f32, PRE-SCALED by
// 1/sqrt(d_n + d_r); pages [P, ps, L] f32 or bf16 (the flat latent pool, the
// caller already added the layer offset to the page tables); each pool row
// is [norm(latent) (d_c) ; rope(k_rope) (d_r)], L = d_c + d_r. The score of
// a (query, head) against a row is q_cat . row over all L columns; the output
// a_lat [.., H, d_c] f32 is the softmax-weighted sum of the rows' first d_c
// columns, divided by max(l, 1e-20).
//   K5 (decode): q_cat [B, H, L], page_tables [B, max_pages], positions [B];
//     sequence b attends rows j < min(max(pos + 1, 1), max_pages * ps) (a
//     position below 0 attends row 0 only, as K1 does).
//   K6 (prefill): q_cat [T, H, L], page_table [max_pages], positions [T]
//     UNIT-STRIDE; row t attends j <= positions[t], j < max_pages * ps. The
//     chunk's own rows are already in the pool.
//
// All H heads of a token share its latent row: this is MQA with L-wide keys
// and d_c-wide values. What bounds it on an H100: the f32 FMA work (2 * (L +
// d_c) FLOP per (row, head, key)) more than the bytes. Every head of a row
// reuses each latent row the block stages, so a decode step reads the pages
// once per head group instead of once per head, and the per-key work is
// (L + d_c) FMA per head against L * itemsize bytes shared by 16 heads.
//
// Design, right before fast (f32 FMA, no tensor cores yet):
//   - a block holds the f32 queries of 16 heads (K5: one sequence; K6: two
//     query positions, 32 (query, head) rows; any H: the last block's heads
//     past H are zero queries and write nothing) in shared memory, stages
//     32-row latent tiles from the pages into shared memory as f32 (16-byte
//     loads; rows past the block's last needed row are never read, so pad
//     rows and trash-page tables stay in bounds), computes the tile's scores
//     with 16 x 16 threads (thread (ty, tx): head ty, keys tx and tx + 16),
//     updates an f32 online softmax per row, and accumulates P . V over the
//     tile's first d_c columns in registers (thread (ty, tx) owns columns
//     tx * 4 + 64 j of its rows, up to d_c = 512);
//   - K5 splits each sequence's context over blocks of split_rows rows
//     (split-K, a multiple of 32 the launcher picks), so a batch of 16
//     sequences still spreads over the 132 SMs; each block writes its (m, l,
//     acc) and a second small launch merges them.
// Later work: tensor cores (wgmma), cp.async/TMA staging, bf16 tiles.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kHeads = 16;       // query heads per block; the last block's heads past H are masked
constexpr int kKeys = 32;        // latent rows per shared-memory tile
constexpr int kThreads = 256;    // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kMaxColGroups = 8; // float4 column groups per thread: d_c <= 512
constexpr int kPStride = kKeys + 1;
constexpr int kMaxLatent = 768;  // shared-memory budget: 64 f32 rows of L + 4
constexpr int kMergeThreads = 128;

__host__ __device__ constexpr int row_stride(int L) { return L + 4; }

size_t smem_bytes(int rows, int L) {
  return ((size_t)(rows + kKeys) * row_stride(L) + (size_t)rows * kPStride) * sizeof(float);
}

// Stage latent rows [k0, k0 + kKeys) of one sequence into sK as f32; rows at
// or past key_end are zero and are not read from the pool.
template <typename T>
__device__ __forceinline__ void load_tile(float* sK, const T* __restrict__ pages,
                                          const int* __restrict__ pt, int k0, int key_end,
                                          int page_size, int L) {
  using V16 = dtt::Vec16<T>;
  constexpr int VEC = V16::N;
  const int vpr = L / VEC;  // 16-byte vectors per row
  const int QS = row_stride(L);
  for (int idx = threadIdx.x; idx < kKeys * vpr; idx += kThreads) {
    const int kk = idx / vpr;
    const int c = (idx - kk * vpr) * VEC;
    const int j = k0 + kk;
    float f[VEC];
    if (j < key_end) {
      const T* src = pages + ((size_t)pt[j / page_size] * page_size + (j % page_size)) * L + c;
      dtt::to_float(dtt::load16(src), f);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; i += 4) dtt::store4(sK + kk * QS + c + i, f + i);
  }
}

// One staged tile for this thread's RPT rows (ty + 16 i of the block's rows):
// scores against keys k0 + tx and k0 + tx + 16 (valid iff j < key_end and
// j <= qpos[i]), the online-softmax update, then acc += P V over the tile's
// first d_c columns. Every thread of the block runs it (the shuffles and the
// barrier need the whole block).
template <int RPT>
__device__ __forceinline__ void tile_step(const float* sQ, const float* sK, float* sP, int L,
                                          int d_c, int k0, int key_end, const int (&qpos)[RPT],
                                          float (&m)[RPT], float (&l)[RPT],
                                          float (&acc)[RPT][kMaxColGroups][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int QS = row_stride(L);

  float s[RPT][2];
#pragma unroll
  for (int i = 0; i < RPT; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < L; d += 4) {
    const float4 k0v = *reinterpret_cast<const float4*>(sK + tx * QS + d);
    const float4 k1v = *reinterpret_cast<const float4*>(sK + (tx + 16) * QS + d);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * QS + d);
      s[i][0] = fmaf(qv.x, k0v.x, s[i][0]);
      s[i][0] = fmaf(qv.y, k0v.y, s[i][0]);
      s[i][0] = fmaf(qv.z, k0v.z, s[i][0]);
      s[i][0] = fmaf(qv.w, k0v.w, s[i][0]);
      s[i][1] = fmaf(qv.x, k1v.x, s[i][1]);
      s[i][1] = fmaf(qv.y, k1v.y, s[i][1]);
      s[i][1] = fmaf(qv.z, k1v.z, s[i][1]);
      s[i][1] = fmaf(qv.w, k1v.w, s[i][1]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float rmax = dtt::kNegInf;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = k0 + tx + 16 * jj;
      s[i][jj] = (j < key_end && j <= qpos[i]) ? s[i][jj] : dtt::kNegInf;
      rmax = fmaxf(rmax, s[i][jj]);
    }
    // the 16 tx lanes of a row sit in one half-warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    const float new_m = fmaxf(m[i], rmax);
    const float corr = expf(m[i] - new_m);
    float rsum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float p = expf(s[i][jj] - new_m);
      rsum += p;
      sP[(ty + 16 * i) * kPStride + tx + 16 * jj] = p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
    l[i] = l[i] * corr + rsum;
    m[i] = new_m;
#pragma unroll
    for (int c = 0; c < kMaxColGroups; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
  }
  __syncthreads();

#pragma unroll 2
  for (int kk = 0; kk < kKeys; ++kk) {
    float p[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) p[i] = sP[(ty + 16 * i) * kPStride + kk];
#pragma unroll
    for (int c = 0; c < kMaxColGroups; ++c) {
      const int col = tx * 4 + 64 * c;
      if (col < d_c) {
        const float4 vv = *reinterpret_cast<const float4*>(sK + kk * QS + col);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][c][0] = fmaf(p[i], vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(p[i], vv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(p[i], vv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(p[i], vv.w, acc[i][c][3]);
        }
      }
    }
  }
}

template <int RPT>
__device__ __forceinline__ void init_state(float (&m)[RPT], float (&l)[RPT],
                                           float (&acc)[RPT][kMaxColGroups][4]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = dtt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxColGroups; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
}

__device__ __forceinline__ int decode_ctx(const int* positions, int b, int cap) {
  return min(max(positions[b] + 1, 1), cap);
}

// K5, pass 1: block (split, head group, sequence) covers context rows
// [split * split_rows, min(+split_rows, ctx)) for 16 heads and writes its
// (m, l, acc) to the partial buffers [B, H, n_split(, d_c)].
template <typename T>
__global__ void __launch_bounds__(kThreads)
mla_decode_partial(const float* __restrict__ q, const T* __restrict__ pages,
                   const int* __restrict__ page_tables, const int* __restrict__ positions,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, int H, int L, int d_c, int page_size,
                   int max_pages, int split_rows, int n_split) {
  extern __shared__ float4 smem_raw[];
  const int QS = row_stride(L);
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kHeads][QS]
  float* sK = sQ + kHeads * QS;                    // [kKeys][QS]
  float* sP = sK + kKeys * QS;                     // [kHeads][kPStride]

  const int split = blockIdx.x;
  const int h0 = blockIdx.y * kHeads;
  const int b = blockIdx.z;
  const int ctx = decode_ctx(positions, b, max_pages * page_size);
  const int r0 = split * split_rows;
  if (r0 >= ctx) return;  // block-uniform: this split holds no context
  const int r1 = min(r0 + split_rows, ctx);
  const int* pt = page_tables + (size_t)b * max_pages;

  for (int idx = threadIdx.x; idx < kHeads * (L / 4); idx += kThreads) {
    const int r = idx / (L / 4);
    const int c = (idx - r * (L / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);  // heads past H: zero queries
    if (h0 + r < H) v = *reinterpret_cast<const float4*>(q + ((size_t)b * H + h0 + r) * L + c);
    *reinterpret_cast<float4*>(sQ + r * QS + c) = v;
  }

  float m[1], l[1], acc[1][kMaxColGroups][4];
  init_state<1>(m, l, acc);
  const int qpos[1] = {INT_MAX};
  for (int k0 = r0; k0 < r1; k0 += kKeys) {
    __syncthreads();  // sQ staged; the previous tile's readers are done
    load_tile<T>(sK, pages, pt, k0, r1, page_size, L);
    __syncthreads();
    tile_step<1>(sQ, sK, sP, L, d_c, k0, r1, qpos, m, l, acc);
  }

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  if (h0 + ty >= H) return;  // past the last block's heads: nothing to write
  const size_t part = ((size_t)b * H + h0 + ty) * n_split + split;
  if (tx == 0) {
    m_part[part] = m[0];
    l_part[part] = l[0];
  }
#pragma unroll
  for (int c = 0; c < kMaxColGroups; ++c) {
    const int col = tx * 4 + 64 * c;
    if (col < d_c) dtt::store4(acc_part + part * d_c + col, acc[0][c]);
  }
}

// K5, pass 2: block (head, sequence) merges the splits that hold context.
__global__ void __launch_bounds__(kMergeThreads)
mla_decode_merge(const float* __restrict__ m_part, const float* __restrict__ l_part,
                 const float* __restrict__ acc_part, const int* __restrict__ positions,
                 float* __restrict__ out, int H, int d_c, int page_size, int max_pages,
                 int split_rows, int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ctx = decode_ctx(positions, b, max_pages * page_size);
  const int n = (ctx + split_rows - 1) / split_rows;
  const size_t base = ((size_t)b * H + h) * n_split;
  float mx = dtt::kNegInf;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, m_part[base + s]);
  float tot = 0.f;
  for (int s = 0; s < n; ++s) tot = fmaf(l_part[base + s], expf(m_part[base + s] - mx), tot);
  const float denom = fmaxf(tot, 1e-20f);
  for (int col = threadIdx.x; col < d_c; col += kMergeThreads) {
    float a = 0.f;
    for (int s = 0; s < n; ++s) a = fmaf(acc_part[(base + s) * d_c + col], expf(m_part[base + s] - mx), a);
    out[((size_t)b * H + h) * d_c + col] = a / denom;
  }
}

// K6: block (pair of query positions, head group) covers 32 (query, head)
// rows, row r = query (r / 16), head (r % 16); thread (ty, tx) owns rows ty
// and ty + 16, i.e. head ty at both query positions.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mla_prefill(const float* __restrict__ q, const T* __restrict__ pages,
            const int* __restrict__ page_table, const int* __restrict__ positions,
            float* __restrict__ out, int T_len, int H, int L, int d_c, int page_size,
            int max_pages) {
  constexpr int RPT = 2;
  constexpr int kRows = 16 * RPT;
  extern __shared__ float4 smem_raw[];
  const int QS = row_stride(L);
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kRows][QS]
  float* sK = sQ + kRows * QS;                     // [kKeys][QS]
  float* sP = sK + kKeys * QS;                     // [kRows][kPStride]

  const int q_start = blockIdx.x * RPT;
  const int h0 = blockIdx.y * kHeads;
  const int n_q = min(RPT, T_len - q_start);
  const int pos0 = positions[q_start];
  const int last_pos = positions[q_start + n_q - 1];
  const int n_ctx = min(last_pos + 1, max_pages * page_size);

  for (int idx = threadIdx.x; idx < kRows * (L / 4); idx += kThreads) {
    const int r = idx / (L / 4);
    const int c = (idx - r * (L / 4)) * 4;
    const int qi = r / kHeads;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < n_q && h0 + r % kHeads < H) {
      v = *reinterpret_cast<const float4*>(
          q + ((size_t)(q_start + qi) * H + h0 + r % kHeads) * L + c);
    }
    *reinterpret_cast<float4*>(sQ + r * QS + c) = v;
  }

  float m[RPT], l[RPT], acc[RPT][kMaxColGroups][4];
  init_state<RPT>(m, l, acc);
  int qpos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) qpos[i] = pos0 + i;
  for (int k0 = 0; k0 < n_ctx; k0 += kKeys) {
    __syncthreads();
    load_tile<T>(sK, pages, page_table, k0, n_ctx, page_size, L);
    __syncthreads();
    tile_step<RPT>(sQ, sK, sP, L, d_c, k0, n_ctx, qpos, m, l, acc);
  }

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  if (h0 + ty >= H) return;  // past the last block's heads
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (i >= n_q) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    float* dst = out + ((size_t)(q_start + i) * H + h0 + ty) * d_c;
#pragma unroll
    for (int c = 0; c < kMaxColGroups; ++c) {
      const int col = tx * 4 + 64 * c;
      if (col < d_c) {
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] = acc[i][c][e] / denom;
        dtt::store4(dst + col, f);
      }
    }
  }
}

template <typename T>
int launch_decode(const float* q, const void* pages, const int* pt, const int* pos,
                  float* m_part, float* l_part, float* acc_part, float* out, int B, int H,
                  int L, int d_c, int ps, int max_pages, int split_rows, int n_split,
                  cudaStream_t stream) {
  // both kernels' dynamic shared memory exceeds the 48 KiB default; the
  // limit is raised to what kMaxLatent needs
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  const cudaError_t err = dtt::raise_smem_limit_once(mla_decode_partial<T>, smem_raised,
                                                     smem_bytes(kHeads, kMaxLatent));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_split, (H + kHeads - 1) / kHeads, B);
  mla_decode_partial<T><<<grid, kThreads, smem_bytes(kHeads, L), stream>>>(
      q, static_cast<const T*>(pages), pt, pos, m_part, l_part, acc_part, H, L, d_c, ps,
      max_pages, split_rows, n_split);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  mla_decode_merge<<<dim3(H, B), kMergeThreads, 0, stream>>>(m_part, l_part, acc_part, pos, out,
                                                            H, d_c, ps, max_pages, split_rows,
                                                            n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prefill(const float* q, const void* pages, const int* pt, const int* pos, float* out,
                   int T_len, int H, int L, int d_c, int ps, int max_pages, cudaStream_t stream) {
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  const cudaError_t err = dtt::raise_smem_limit_once(mla_prefill<T>, smem_raised,
                                                     smem_bytes(2 * kHeads, kMaxLatent));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + 1) / 2, (H + kHeads - 1) / kHeads);
  mla_prefill<T><<<grid, kThreads, smem_bytes(2 * kHeads, L), stream>>>(
      q, static_cast<const T*>(pages), pt, pos, out, T_len, H, L, d_c, ps, max_pages);
  return (int)cudaGetLastError();
}

bool shapes_ok(int H, int L, int d_c, int ps, int max_pages) {
  return H > 0 && L > 0 && L % 8 == 0 && L <= kMaxLatent && d_c > 0 &&
         d_c % 4 == 0 && d_c <= L && d_c <= 64 * kMaxColGroups && ps > 0 && max_pages > 0;
}

}  // namespace

// dtype: 0 = float32 pages, 1 = bfloat16 pages (q_cat and the output are
// float32). K5 gives each block split_rows context rows (a positive
// multiple of kKeys); its partial buffers m_part, l_part [B, H, n_split] and
// acc_part [B, H, n_split, d_c] need n_split >= ceil(max_pages * page_size /
// split_rows).
// Returns cudaGetLastError() after the launches (0 = launched);
// shapes the kernel does not take return cudaErrorInvalidValue without
// launching.
extern "C" int paged_mla_decode_attention(const void* q, const void* pages,
                                          const void* page_tables, const void* positions,
                                          void* m_part, void* l_part, void* acc_part, void* out,
                                          int B, int H, int L, int d_c, int page_size,
                                          int max_pages, int split_rows, int n_split, int dtype,
                                          void* stream) {
  if (B <= 0) return 0;
  if (!shapes_ok(H, L, d_c, page_size, max_pages) || split_rows <= 0 || split_rows % kKeys ||
      (long long)n_split * split_rows < (long long)max_pages * page_size)
    return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(q);
  const int* pt = static_cast<const int*>(page_tables);
  const int* pos = static_cast<const int*>(positions);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_decode<float>(qp, pages, pt, pos, mp, lp, ap, op, B, H, L, d_c, page_size,
                                max_pages, split_rows, n_split, s);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(qp, pages, pt, pos, mp, lp, ap, op, B, H, L, d_c,
                                        page_size, max_pages, split_rows, n_split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int paged_mla_prefill_attention(const void* q, const void* pages,
                                           const void* page_table, const void* positions,
                                           void* out, int T_len, int H, int L, int d_c,
                                           int page_size, int max_pages, int dtype,
                                           void* stream) {
  if (T_len <= 0) return 0;
  if (!shapes_ok(H, L, d_c, page_size, max_pages)) return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(q);
  const int* pt = static_cast<const int*>(page_table);
  const int* pos = static_cast<const int*>(positions);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_prefill<float>(qp, pages, pt, pos, op, T_len, H, L, d_c, page_size, max_pages, s);
  if (dtype == 1)
    return launch_prefill<__nv_bfloat16>(qp, pages, pt, pos, op, T_len, H, L, d_c, page_size,
                                         max_pages, s);
  return (int)cudaErrorInvalidValue;
}
