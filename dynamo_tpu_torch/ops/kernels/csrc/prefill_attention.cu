// K2: chunked-prefill flash attention over the paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/prefill_attention.py
// paged_prefill_attention_pallas (_kernel_lookahead / _kernel, math in
// _flash_merge). The TPU variants differ only in DMA scheduling across the
// serial TPU grid; nothing carries between CUDA blocks, so neither schedule
// is copied.
//
// Contract (per lane n of N packed lanes; N = 1 is the single-chunk call):
// q [N*T, Hq, D]; k/v pools [P, ps, Hkv, D]; page_tables [N, max_pages] int32
// (layer offset already added); positions [N, T] int32, UNIT-STRIDE within a
// lane (row i sits at positions[n, 0] + i). Query block b reads context up to
// its last row's position, never past max_pages * ps; a row at position p
// attends context j <= p. f32 scores and online softmax, scale 1/sqrt(D),
// output divided by max(l, 1e-20), written in q's dtype. The chunk's own K/V
// rows are already in the pool (the model scatters before attending).
//
// What bounds it on an H100: at prefill sizes, arithmetic (4 * Hq * D FLOP
// per causal (row, key) pair) rather than the context bytes. Design, right
// before fast: one block per (64 (query, head) rows, kv head, lane): the
// block covers 64/G query positions of all G = Hq/Hkv q heads of one kv
// head, so every K/V tile it stages is shared by the GQA group. K/V tiles of
// 32 keys go page by page from HBM into shared memory as f32 (16-byte
// loads; keys past the block's context bound are not read, so pad rows and
// pad lanes, whose page tables point at trash page 0, stay in bounds), the
// Q tile stays in shared memory for the whole loop, and 256 threads compute
// 4x2 score and 4x(D/16) output micro-tiles with f32 FMA. Tensor cores
// (wgmma), a TMA/cp.async pipeline and split-K are later work.

#include "common.cuh"

namespace {

constexpr int kRows = 64;     // (query, head) rows per block
constexpr int kKeys = 32;     // keys per context tile
constexpr int kThreads = 256; // 16 x 16: ty owns rows ty + 16i, tx keys tx + 16j
constexpr int kPStride = kKeys + 16;

template <int D>
constexpr int smem_floats() {
  return kRows * (D + 4) + kKeys * (D + 4) + kKeys * D + kRows * kPStride;
}

template <typename T, int D>
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool, const int* __restrict__ page_tables,
                     const int* __restrict__ positions, T* __restrict__ out, int T_len, int Hq,
                     int Hkv, int page_size, int max_pages, float scale) {
  using V16 = dtt::Vec16<T>;
  constexpr int VEC = V16::N;
  constexpr int QS = D + 4;  // padded f32 row stride of the Q and K tiles
  constexpr int OC = D / 64; // float4 output column groups per thread
  static_assert(D % 64 == 0, "unsupported head_dim");

  extern __shared__ float4 smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kRows][QS]
  float* sK = sQ + kRows * QS;                     // [kKeys][QS]
  float* sV = sK + kKeys * QS;                     // [kKeys][D]
  float* sP = sV + kKeys * D;                      // [kRows][kPStride]

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
  const int ctx_cap = max_pages * page_size;
  const int n_ctx = min(last_pos + 1, ctx_cap);

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const size_t token_stride = (size_t)Hkv * D;

  // Q tile: row r = (head g = r / BQ, query qi = r % BQ)
  for (int idx = tid; idx < kRows * (D / VEC); idx += kThreads) {
    const int r = idx / (D / VEC);
    const int c = (idx % (D / VEC)) * VEC;
    const int g = r / BQ;
    const int qi = r % BQ;
    const T* src = q + (((size_t)n * T_len + q_start + qi) * Hq + (size_t)kvh * G + g) * D;
    load_row_f32<T, D>(sQ + r * QS, src, qi < n_q, c);
  }

  float m[4], l[4], o[4][OC][4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = dtt::kNegInf;
    l[i] = 0.f;
    qpos[i] = pos0 + (ty + 16 * i) % BQ;
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
  }

  for (int kt0 = 0; kt0 < n_ctx; kt0 += kKeys) {
    __syncthreads();  // previous tile's readers are done with sK / sV / sP
    for (int idx = tid; idx < kKeys * (D / VEC); idx += kThreads) {
      const int kk = idx / (D / VEC);
      const int c = (idx % (D / VEC)) * VEC;
      const int j = kt0 + kk;
      const bool ok = j < n_ctx;
      size_t base = 0;
      if (ok) {
        base = ((size_t)pt[j / page_size] * page_size + (j % page_size)) * token_stride +
               (size_t)kvh * D;
      }
      load_row_f32<T, D>(sK + kk * QS, k_pool + base, ok, c);
      load_row_f32<T, D>(sV + kk * D, v_pool + base, ok, c);
    }
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
      float rmax = dtt::kNegInf;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = kt0 + tx + 16 * jj;
        const bool ok = (j <= qpos[i]) && (j < ctx_cap);
        s[i][jj] = ok ? s[i][jj] * scale : dtt::kNegInf;
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
      for (int c = 0; c < OC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] *= corr;
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
          o[i][c][0] = fmaf(p[i], vv.x, o[i][c][0]);
          o[i][c][1] = fmaf(p[i], vv.y, o[i][c][1]);
          o[i][c][2] = fmaf(p[i], vv.z, o[i][c][2]);
          o[i][c][3] = fmaf(p[i], vv.w, o[i][c][3]);
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
    T* dst = out + (((size_t)n * T_len + q_start + qi) * Hq + (size_t)kvh * G + g) * D;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = o[i][c][e] / denom;
      dtt::store4(dst + tx * 4 + 64 * c, f);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const int* pt, const int* pos,
             void* out, int N, int T_len, int Hq, int Hkv, int ps, int max_pages,
             cudaStream_t stream) {
  // the dynamic shared memory exceeds the 48 KiB default at D=128
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  const int G = Hq / Hkv;
  const int BQ = kRows / G;
  const size_t smem = (size_t)smem_floats<D>() * sizeof(float);
  const cudaError_t err = dtt::raise_smem_limit_once(paged_prefill_kernel<T, D>, smem_raised, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + BQ - 1) / BQ, Hkv, N);
  paged_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pt, pos,
      static_cast<T*>(out), T_len, Hq, Hkv, ps, max_pages, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const int* pt, const int* pos,
             void* out, int N, int T_len, int Hq, int Hkv, int D, int ps, int max_pages,
             cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_d<T, 64>(q, k, v, pt, pos, out, N, T_len, Hq, Hkv, ps, max_pages, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, pt, pos, out, N, T_len, Hq, Hkv, ps, max_pages, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched); shapes the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int paged_prefill_attention(const void* q, const void* k_pool, const void* v_pool,
                                       const void* page_tables, const void* positions, void* out,
                                       int N, int T_len, int Hq, int Hkv, int D, int page_size,
                                       int max_pages, int dtype, void* stream) {
  if (N <= 0 || T_len <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || kRows % (Hq / Hkv) != 0 || page_size <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_tables);
  const int* pos = static_cast<const int*>(positions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(q, k_pool, v_pool, pt, pos, out, N, T_len, Hq, Hkv, D, page_size, max_pages, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k_pool, v_pool, pt, pos, out, N, T_len, Hq, Hkv, D, page_size,
                                   max_pages, s);
  return (int)cudaErrorInvalidValue;
}
