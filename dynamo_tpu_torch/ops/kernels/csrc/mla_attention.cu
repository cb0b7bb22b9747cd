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
// and d_c-wide values, 2 * (L + d_c) FLOP per (row, head, key) against L *
// itemsize bytes a key shared by every head. What bounds it on an H100: over
// f32 pages the f32 arithmetic (at DeepSeek-V2-Lite's 16 heads, L 576, d_c
// 512: ~70 FLOP a byte, far above the 67 TFLOP/s f32 rate's ~20 FLOP/byte);
// over bf16 pages K5's page bytes (~34 FLOP a byte at 16 heads, below the
// bf16 tensor rate's ~295) and K6's operations (each position re-reads the
// chunk's context).
//
// K5 over bf16 pages, mla_decode_tc (the serve path), on the tensor cores.
// The FMA body it replaced read a float4 of shared memory for every 4 FMAs
// and reached 0.06 of the byte bound (PERF.md):
//   - a block is (split of split_rows context rows, group of 16 heads,
//     sequence): the 16 heads are one m16 tile (a sequence's heads share its
//     pages; sequences cannot share a tile), the last group's heads past H
//     zero queries that write nothing; the splits spread a batch's ragged
//     contexts over the 132 SMs.
//   - S = Q . K^T over all L columns by mma.sync m16n8k16 as Q_hi . K^T +
//     Q_lo . K^T (bf16 pages: K exact; q split into bf16 hi + lo, since one
//     rounding of q leaves TOL["f32"], tests/test_torch_mla_tc.py), the two
//     products in accumulators of their own. Q_hi and Q_lo sit in shared
//     memory (36,864 B at L 576, staged from q by cp.async through the
//     ring's second stage) and are read by ldmatrix.
//   - 64-row latent tiles through a two-stage cp.async ring, 8 threads a
//     row, K6's swizzle (chunk c of row r in slot c ^ (r % 8)); rows past
//     the split's end are zero-filled and never read, so trash-page tables
//     stay in bounds. Budget at L 576: 36,864 + 147,456 + 4,352 B of
//     exchange = 188,672 B, one block an SM.
//   - 4 warps: warp w scores keys 16 w .. 16 w + 15 of each tile; the warps
//     exchange row maxima (every warp forms the same tile max) and P_hi /
//     P_lo as bf16 fragments through shared memory, then warp w multiplies
//     P . V into output columns 128 w .. 128 w + 127 (64 f32 accumulators a
//     thread), V the staged tile's first d_c columns, so V is never loaded
//     twice: K6's exchange at M = 16.
//   - online softmax in registers, exp2 with log2(e) folded in; each split
//     writes (m in log2 units, l, acc) to one workspace, and merge_splits
//     (decode_rows.cuh) combines them in a fixed order with no atomics, so
//     two launches give the same bits.
//   The body takes L % 8 == 0 up to its budget (L 704), d_c % 8 == 0, d_c
//   <= 512; f32 pages and other shapes take the FMA body.
//
// K6 over bf16 pages, mla_prefill_tc (the serve path), on the tensor cores:
//   - a block is a 64-row M-tile of the chunk's (position, head) pairs
//     flattened position-major (row r = t * H + h), so any H (4, 16, 20 ..)
//     packs with no padded heads; every row masks keys past its own
//     position, and the tile reads context up to its last row's position.
//     Blocks run the longest contexts (the last tiles) first.
//   - S = Q . K^T over L by mma.sync m16n8k16 (bf16 in, f32 sums) as two
//     products, Q_hi . K^T + Q_lo . K^T with Q_hi = bf16(q), Q_lo = bf16(q -
//     Q_hi): the pages are bf16, so K is exact, and q keeps ~16 bits more
//     than one bf16 rounding, which alone leaves TOL["f32"]
//     (tests/test_torch_mla_tc.py). O += P . V takes V as the staged key
//     tile's first d_c columns (V is never loaded twice) with P split the
//     same way into bf16 hi + lo, so the probabilities stay f32-exact.
//   - Budget (L 576): Q_hi + Q_lo, 64 rows of 72 16-byte chunks =
//     147,456 B; a 32-key bf16 tile 36,864 B, two cp.async stages 73,728
//     B; 8,704 B for what the warp pairs exchange; 229,888 B of the 232,448
//     a block may have, so one block an SM. Chunk c of row r sits in slot c
//     ^ (r % 8) of its row (a swizzle: the 8 rows an ldmatrix reads fall in
//     8 bank groups, where an odd pitch would cost the 3 KB the exchange
//     needs). The 64 x 512 f32 accumulator is 32,768 registers: 8 warps,
//     warp w owns rows 16 (w % 4) .. + 15 and output columns 256 (w / 4) ..
//     + 255 (128 registers a thread, the partition of DeepSeek's FlashMLA
//     decode kernel).
//   - The two warps of a row block split S by keys (16 each), exchange
//     their rows' maxima and their bf16 P fragments through shared memory
//     (two barriers a tile), and each multiplies both k-steps of P . V into
//     its own columns; their row sums add at the end, so S is computed once
//     (not once a column half).
//   - Fragments of the next k-step (and the next V column pair) load while
//     the current one multiplies: asm volatile keeps program order, so the
//     order in the source is the schedule.
//   - Online softmax on the S fragments in registers (a row lives in 4
//     lanes), exp2 with log2(e) folded in.
//   The body takes L % 8 == 0 up to the shared-memory budget (576),
//   d_c % 8 == 0 and d_c <= 512; other shapes take the FMA body.
//
// FMA body (K5 and K6 over f32 pages and at shapes past the tensor-core
// bodies' budgets), f32 throughout:
//   - a block holds the f32 queries of 16 heads (K5: one sequence; K6: two
//     query positions, 32 (query, head) rows; any H: the last block's heads
//     past H are zero queries and write nothing) in shared memory, stages
//     32-row latent tiles from the pages into shared memory as f32 (16-byte
//     loads; rows that start off 16 bytes, an L that is no multiple of a
//     16-byte vector, an element at a time with the columns past L zero;
//     rows past the block's last needed row are never read, so pad rows and
//     trash-page tables stay in bounds), computes the tile's scores with 16 x
//     16 threads (thread (ty, tx): head ty, keys tx and tx + 16), updates an
//     f32 online softmax per row, and accumulates P . V in registers (thread
//     (ty, tx) owns columns tx * 4 + 64 j of its rows, a slice of up to 512
//     columns; a d_c that is no multiple of 4 is stored column by column);
//   - a latent row wider than kMaxLatent (768) is scored in column chunks of
//     kWideCols (512): each chunk stages its slice of the queries and of the
//     key tile, and the V columns are staged after the scores, so the staged
//     f32 rows stay within the shared-memory budget at any L;
//   - d_c above 512 is sliced over a grid dimension: each slice's block
//     recomputes the scores and accumulates its 512 columns, so the register
//     accumulator stays at kMaxColGroups float4s a row;
//   - K5 splits each sequence's context over blocks of split_rows rows
//     (split-K, a multiple of 64 the launcher picks) and merges them as the
//     tensor-core body does.

#include <climits>

#include "decode_rows.cuh"

namespace {

using dtt::decode_ctx;

constexpr int kHeads = 16;       // query heads per block; the last block's heads past H are masked
constexpr int kKeys = 32;        // latent rows per shared-memory tile
constexpr int kThreads = 256;    // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kMaxColGroups = 8; // float4 column groups per thread: a d_c slice of 512
constexpr int kSliceCols = 64 * kMaxColGroups;
constexpr int kPStride = kKeys + 1;
constexpr int kMaxLatent = 768;  // resident rows: (32 + 32) f32 rows of L + 4 fit the budget
constexpr int kWideCols = 512;   // column chunk of a wider row
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// A staged f32 row's stride: its columns rounded up to whole float4s, and
// one float4 more (the narrow staging zero-fills the columns past L).
__host__ __device__ constexpr int row_stride(int cols) { return round4(cols) + 4; }

// The f32 columns a staged row holds: all of L, or one chunk of a wider row.
__host__ __device__ constexpr int staged_cols(int L) { return L <= kMaxLatent ? L : kWideCols; }

size_t smem_bytes(int rows, int L) {
  return ((size_t)(rows + kKeys) * row_stride(staged_cols(L)) + (size_t)rows * kPStride) * sizeof(float);
}

// Stage columns [c0, c0 + w) of latent rows [k0, k0 + kKeys) of one sequence
// into sK (row stride QS) as f32; rows at or past key_end are zero and are not
// read from the pool. Rows that start on 16 bytes (L a multiple of a 16-byte
// vector of T; w a multiple of one) are read in 16-byte vectors; ``narrow``
// rows (any L) an element at a time, the columns past L up to the next float4
// zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* sK, const T* __restrict__ pages,
                                          const int* __restrict__ pt, int k0, int key_end,
                                          int page_size, int L, int c0, int w, int QS, bool narrow) {
  if (narrow) {
    const int w4 = round4(w);
    for (int idx = threadIdx.x; idx < kKeys * w4; idx += kThreads) {
      const int kk = idx / w4;
      const int c = idx - kk * w4;
      const int j = k0 + kk;
      float x = 0.f;
      if (j < key_end && c0 + c < L)
        x = dtt::to_f(pages[((size_t)pt[j / page_size] * page_size + (j % page_size)) * L + c0 + c]);
      sK[kk * QS + c] = x;
    }
    return;
  }
  using V16 = dtt::Vec16<T>;
  constexpr int VEC = V16::N;
  const int vpr = w / VEC;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < kKeys * vpr; idx += kThreads) {
    const int kk = idx / vpr;
    const int c = (idx - kk * vpr) * VEC;
    const int j = k0 + kk;
    float f[VEC];
    if (j < key_end) {
      const T* src = pages + ((size_t)pt[j / page_size] * page_size + (j % page_size)) * L + c0 + c;
      dtt::to_float(dtt::load16(src), f);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; i += 4) dtt::store4(sK + kk * QS + c + i, f + i);
  }
}

// The block's query rows: K5's 16 heads of one sequence, K6's 16 heads at
// two positions. row(r) is the f32 query of block row r, or null for a row
// that holds no (position, head).
struct DecodeRows {
  const float* q;
  int b, H, h0, L;
  __device__ const float* row(int r) const { return h0 + r < H ? q + ((size_t)b * H + h0 + r) * L : nullptr; }
};

struct PrefillRows {
  const float* q;
  int q_start, n_q, H, h0, L;
  __device__ const float* row(int r) const {
    const int qi = r / kHeads;
    const int h = h0 + r % kHeads;
    return qi < n_q && h < H ? q + ((size_t)(q_start + qi) * H + h) * L : nullptr;
  }
};

// Columns [c0, c0 + w) of the block's nrows query rows into sQ (stride QS):
// float4s, or (``narrow``: rows that start off 16 bytes) an element at a
// time, the columns past L up to the next float4 zero.
template <typename Rows>
__device__ __forceinline__ void stage_queries(float* sQ, const Rows& rows, int nrows, int c0, int w, int QS,
                                              bool narrow) {
  const int vpr = round4(w) / 4;
  for (int idx = threadIdx.x; idx < nrows * vpr; idx += kThreads) {
    const int r = idx / vpr;
    const int c = (idx - r * vpr) * 4;
    const float* src = rows.row(r);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src && !narrow) {
      v = *reinterpret_cast<const float4*>(src + c0 + c);
    } else if (src) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = c0 + c + e < rows.L ? src[c0 + c + e] : 0.f;
      v = make_float4(f[0], f[1], f[2], f[3]);
    }
    *reinterpret_cast<float4*>(sQ + r * QS + c) = v;
  }
}

// The shapes one FMA block walks: the latent row L, the staged columns a
// row (SC), the block's output slice [dc0, dc0 + dcw); narrow: rows start
// off 16 bytes (L no multiple of a 16-byte vector of the pages' type).
struct FmaShape {
  int L, SC, dc0, dcw;
  bool narrow;
};

// Columns [col, col + 4) of an f32 output row below ``n`` (one float4 when
// all four are below it and ``vec``: the row starts on 16 bytes).
__device__ __forceinline__ void store_cols(float* dst, const float* f, int col, int n, bool vec) {
  if (vec && col + 4 <= n) {
    dtt::store4(dst + col, f);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (col + e < n) dst[col + e] = f[e];
}

// One 32-key tile of this thread's RPT rows (ty + 16 i of the block's rows):
// scores against keys k0 + tx and k0 + tx + 16 (valid iff j < key_end and j
// <= qpos[i]) over all L columns, the online-softmax update, then acc += P V
// over the block's d_c slice. Rows of L <= kMaxLatent are staged whole
// (queries once, by the caller); wider rows in kWideCols chunks, the
// queries' chunk with each key chunk and the V slice after the scores.
// Every thread of the block runs it (the shuffles and the barriers need the
// whole block).
template <typename T, int RPT, typename Rows>
__device__ __forceinline__ void tile_step(float* sQ, float* sK, float* sP, const Rows& rows, const T* pages,
                                          const int* pt, int page_size, const FmaShape& sh, int k0,
                                          int key_end, const int (&qpos)[RPT], float (&m)[RPT],
                                          float (&l)[RPT], float (&acc)[RPT][kMaxColGroups][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int QS = row_stride(sh.SC);
  const bool resident = sh.SC == sh.L;

  float s[RPT][2];
#pragma unroll
  for (int i = 0; i < RPT; ++i) s[i][0] = s[i][1] = 0.f;
  for (int c0 = 0; c0 < sh.L; c0 += sh.SC) {
    const int w = min(sh.SC, sh.L - c0);
    __syncthreads();  // the previous readers of sK (and sQ) are done
    if (!resident) stage_queries(sQ, rows, 16 * RPT, c0, w, QS, sh.narrow);
    load_tile<T>(sK, pages, pt, k0, key_end, page_size, sh.L, c0, w, QS, sh.narrow);
    __syncthreads();
    const int w4 = round4(w);  // the columns past L are zero
#pragma unroll 4
    for (int d = 0; d < w4; d += 4) {
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
  // V: the slice's columns of the staged tile, or staged now (wide rows; the
  // width rounded up to whole 16-byte vectors stays inside a row that is not
  // narrow; a narrow one is read an element at a time). A float4 of V that
  // runs past the slice's last column reads staged columns below the next
  // float4 of L (zero past L) and is never stored.
  int vcol = sh.dc0;
  if (!resident) {
    __syncthreads();  // the score readers are done with sK
    constexpr int VEC = dtt::Vec16<T>::N;
    const int w = sh.narrow ? sh.dcw : (sh.dcw + VEC - 1) / VEC * VEC;
    load_tile<T>(sK, pages, pt, k0, key_end, page_size, sh.L, sh.dc0, w, QS, sh.narrow);
    vcol = 0;
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
      if (col < sh.dcw) {
        const float4 vv = *reinterpret_cast<const float4*>(sK + kk * QS + vcol + col);
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

template <typename T>
__device__ __forceinline__ FmaShape fma_shape(int L, int d_c, int slice) {
  const int dc0 = slice * kSliceCols;
  return FmaShape{L, staged_cols(L), dc0, min(kSliceCols, d_c - dc0), L % dtt::Vec16<T>::N != 0};
}

// K5, FMA body: block (split, head group x d_c slice, sequence) covers
// context rows [split * split_rows, min(+split_rows, ctx)) for 16 heads and
// writes its (m in log2 units, l) (slice 0) and its slice of acc to the
// partials merge_splits reads: m, l [B, n_split, H], acc [B, n_split, H, d_c].
template <typename T>
__global__ void __launch_bounds__(kThreads)
mla_decode_partial(const float* __restrict__ q, const T* __restrict__ pages,
                   const int* __restrict__ page_tables, const int* __restrict__ positions,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, int H, int L, int d_c, int page_size,
                   int max_pages, int split_rows, int n_split, int n_slices) {
  extern __shared__ float4 smem_raw[];
  const FmaShape sh = fma_shape<T>(L, d_c, blockIdx.y % n_slices);
  const int QS = row_stride(sh.SC);
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kHeads][QS]
  float* sK = sQ + kHeads * QS;                    // [kKeys][QS]
  float* sP = sK + kKeys * QS;                     // [kHeads][kPStride]

  const int split = blockIdx.x;
  const int h0 = blockIdx.y / n_slices * kHeads;
  const int b = blockIdx.z;
  const int ctx = decode_ctx(positions, b, max_pages * page_size);
  const int r0 = split * split_rows;
  if (r0 >= ctx) return;  // block-uniform: this split holds no context
  const int r1 = min(r0 + split_rows, ctx);
  const int* pt = page_tables + (size_t)b * max_pages;
  const DecodeRows rows{q, b, H, h0, L};
  if (sh.SC == L) stage_queries(sQ, rows, kHeads, 0, L, QS, sh.narrow);

  float m[1], l[1], acc[1][kMaxColGroups][4];
  init_state<1>(m, l, acc);
  const int qpos[1] = {INT_MAX};
  for (int k0 = r0; k0 < r1; k0 += kKeys)
    tile_step<T, 1>(sQ, sK, sP, rows, pages, pt, page_size, sh, k0, r1, qpos, m, l, acc);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  if (h0 + ty >= H) return;  // past the last block's heads: nothing to write
  const size_t part = ((size_t)b * n_split + split) * H + h0 + ty;
  if (tx == 0 && sh.dc0 == 0) {
    m_part[part] = m[0] * kLog2e;  // merge_splits takes log2 units
    l_part[part] = l[0];
  }
#pragma unroll
  for (int c = 0; c < kMaxColGroups; ++c)
    store_cols(acc_part + part * d_c + sh.dc0, acc[0][c], tx * 4 + 64 * c, sh.dcw, d_c % 4 == 0);
}

// K6, FMA body: block (pair of query positions, head group, d_c slice)
// covers 32 (query, head) rows, row r = query (r / 16), head (r % 16);
// thread (ty, tx) owns rows ty and ty + 16, i.e. head ty at both query
// positions.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mla_prefill(const float* __restrict__ q, const T* __restrict__ pages,
            const int* __restrict__ page_table, const int* __restrict__ positions,
            float* __restrict__ out, int T_len, int H, int L, int d_c, int page_size,
            int max_pages) {
  constexpr int RPT = 2;
  constexpr int kRows = 16 * RPT;
  extern __shared__ float4 smem_raw[];
  const FmaShape sh = fma_shape<T>(L, d_c, blockIdx.z);
  const int QS = row_stride(sh.SC);
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kRows][QS]
  float* sK = sQ + kRows * QS;                     // [kKeys][QS]
  float* sP = sK + kKeys * QS;                     // [kRows][kPStride]

  const int q_start = blockIdx.x * RPT;
  const int h0 = blockIdx.y * kHeads;
  const int n_q = min(RPT, T_len - q_start);
  const int pos0 = positions[q_start];
  const int last_pos = positions[q_start + n_q - 1];
  const int n_ctx = min(last_pos + 1, max_pages * page_size);
  const PrefillRows rows{q, q_start, n_q, H, h0, L};
  if (sh.SC == L) stage_queries(sQ, rows, kRows, 0, L, QS, sh.narrow);

  float m[RPT], l[RPT], acc[RPT][kMaxColGroups][4];
  init_state<RPT>(m, l, acc);
  int qpos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) qpos[i] = pos0 + i;
  for (int k0 = 0; k0 < n_ctx; k0 += kKeys)
    tile_step<T, RPT>(sQ, sK, sP, rows, pages, page_table, page_size, sh, k0, n_ctx, qpos, m, l, acc);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  if (h0 + ty >= H) return;  // past the last block's heads
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (i >= n_q) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    float* dst = out + ((size_t)(q_start + i) * H + h0 + ty) * d_c + sh.dc0;
#pragma unroll
    for (int c = 0; c < kMaxColGroups; ++c) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = acc[i][c][e] / denom;
      store_cols(dst, f, tx * 4 + 64 * c, sh.dcw, d_c % 4 == 0);
    }
  }
}

// ---------------------------------------------------------------- K6, tensor cores

constexpr int kTcRows = 64;      // (position, head) rows a block
constexpr int kTcKeys = 32;      // latent rows a ring stage
constexpr int kTcWarps = 8;      // warp w: rows 16 (w % 4) .., keys 16 (w / 4) .. of S, output columns 256 (w / 4) ..
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcStages = 2;
constexpr int kTcHalf = 256;     // output columns a warp
constexpr int kTcMaxDc = 2 * kTcHalf;
// exchanged between the two warps of a row block: their rows' maxima (at the
// end, their sums), and each warp's P fragments (8 words a lane)
constexpr int kTcXBytes = 2 * kTcRows * 4 + kTcThreads * 8 * 4;
constexpr size_t kTcSmemLimit = 227 * 1024;

// A row's pitch in 16-byte chunks: L / 8 rounded up to a multiple of 8, the
// chunks past L zero. Chunk c of row r sits in slot c ^ (r % 8) of the row,
// so the 8 rows an ldmatrix reads at one chunk fall in 8 different 16-byte
// bank groups (a swizzle, where a padded pitch would cost 3 KB).
__host__ __device__ constexpr int tc_pitch(int L) { return (L / 8 + 7) / 8 * 8; }

size_t tc_smem_bytes(int L) { return (size_t)(2 * kTcRows + kTcStages * kTcKeys) * tc_pitch(L) * 16 + kTcXBytes; }

bool tc_shapes_ok(int L, int d_c) {
  return L % 8 == 0 && d_c % 8 == 0 && d_c <= kTcMaxDc && tc_smem_bytes(L) <= kTcSmemLimit;
}

// Start the cp.async copies of latent rows [k0, k0 + kTcKeys) into a ring
// stage (rows at or past n_ctx, and the pad chunks, zero-filled).
__device__ __forceinline__ void tc_start_tile(uint32_t stage, const __nv_bfloat16* __restrict__ pages,
                                              const int* __restrict__ pt, int k0, int n_ctx, int page_size,
                                              int L, int pitch) {
  const int cpr = L / 8;  // 16-byte chunks of a pool row
  for (int idx = threadIdx.x; idx < kTcKeys * pitch; idx += kTcThreads) {
    const int r = idx / pitch;
    const int c = idx - r * pitch;
    const int j = k0 + r;
    const bool ok = j < n_ctx && c < cpr;
    const size_t off = ok ? ((size_t)pt[j / page_size] * page_size + j % page_size) * L + c * 8 : 0;
    dtt::cp_async16(stage + (r * pitch + (c ^ (r & 7))) * 16, pages + off, ok);
  }
}

// A lane's row in a swizzled tile: the row's address and its swizzle.
struct TcRow {
  uint32_t base;
  int x;
  __device__ uint32_t at(int c) const { return base + ((c ^ x) << 4); }
};

__device__ __forceinline__ TcRow tc_row(uint32_t tile, int pitch, int r) { return TcRow{tile + r * pitch * 16, r & 7}; }

// 8 f32 queries at src (null: zeros) as bf16 hi = bf16(x) and lo = bf16(x -
// hi) into chunk c of row r of the swizzled Q_hi and Q_lo tiles (slot c ^ (r
// % 8)).
__device__ __forceinline__ void stage_q_chunk(uint8_t* sQh, uint8_t* sQl, int pitch, int r, int c, const float* src) {
  float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (src) {
    dtt::to_float(*reinterpret_cast<const float4*>(src), f);
    dtt::to_float(*reinterpret_cast<const float4*>(src + 4), f + 4);
  }
  uint4 hi, lo;
  uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
  uint32_t* o = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    const float2 xf = __bfloat1622float2(x);
    h[e] = *reinterpret_cast<const uint32_t*>(&x);
    o[e] = dtt::pack_bf16(f[2 * e] - xf.x, f[2 * e + 1] - xf.y);
  }
  const int slot = r * pitch + (c ^ (r & 7));
  *reinterpret_cast<uint4*>(sQh + slot * 16) = hi;
  *reinterpret_cast<uint4*>(sQl + slot * 16) = lo;
}

// One k-step's fragments of this warp's S block: its 16 query rows, hi and
// lo (ldmatrix.x4 each), and its 16 keys (one ldmatrix.x4 of two 8-key
// blocks).
struct TcFrags {
  uint32_t qh[4], ql[4], k[4];
};

__device__ __forceinline__ void tc_load_frags(TcFrags& f, const TcRow& qh, const TcRow& ql, const TcRow& kr,
                                              int lane, int ks) {
  const int cq = 2 * ks + (lane >> 4);
  dtt::ldsm_x4(f.qh, qh.at(cq));
  dtt::ldsm_x4(f.ql, ql.at(cq));
  dtt::ldsm_x4(f.k, kr.at(2 * ks + ((lane >> 3) & 1)));
}

// s[b] += Q_hi . K_b^T, then s[b] += Q_lo . K_b^T for the 2 key blocks.
__device__ __forceinline__ void tc_score_mma(float (&s)[2][4], const TcFrags& f) {
#pragma unroll
  for (int b = 0; b < 2; ++b) dtt::mma_bf16_16816(s[b], f.qh, f.k[2 * b], f.k[2 * b + 1]);
#pragma unroll
  for (int b = 0; b < 2; ++b) dtt::mma_bf16_16816(s[b], f.ql, f.k[2 * b], f.k[2 * b + 1]);
}

__global__ void __launch_bounds__(kTcThreads, 1)
mla_prefill_tc(const float* __restrict__ q, const __nv_bfloat16* __restrict__ pages,
               const int* __restrict__ page_table, const int* __restrict__ positions,
               float* __restrict__ out, int T_len, int H, int L, int d_c, int page_size, int max_pages) {
  extern __shared__ __align__(16) uint8_t tc_smem[];
  const int pitch = tc_pitch(L);
  const int rb = pitch * 16;  // a row's bytes
  uint8_t* sQh = tc_smem;
  uint8_t* sQl = sQh + kTcRows * rb;
  const uint32_t ring = dtt::smem_u32(sQl + kTcRows * rb);
  const int stage_bytes = kTcKeys * rb;
  float* sX = reinterpret_cast<float*>(sQl + kTcRows * rb + kTcStages * stage_bytes);  // [2][kTcRows]
  uint32_t* sP = reinterpret_cast<uint32_t*>(sX + 2 * kTcRows);                        // [kTcThreads][8]

  const int n_rows = T_len * H;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // the longest contexts first
  const int last = min(row0 + kTcRows, n_rows) - 1;
  const int t0 = row0 / H;
  const int pos_t0 = positions[t0];
  const int n_ctx = min(pos_t0 + last / H - t0 + 1, max_pages * page_size);
  const int n_tiles = (n_ctx + kTcKeys - 1) / kTcKeys;

  tc_start_tile(ring, pages, page_table, 0, n_ctx, page_size, L, pitch);
  dtt::cp_async_commit();

  // Q_hi and Q_lo of the block's rows (rows past the chunk and columns past
  // L zero), converted while the first tile loads
  const int cpr = L / 8;
  for (int idx = threadIdx.x; idx < kTcRows * pitch; idx += kTcThreads) {
    const int r = idx / pitch;
    const int c = idx - r * pitch;
    stage_q_chunk(sQh, sQl, pitch, r, c, row0 + r < n_rows && c < cpr ? q + (size_t)(row0 + r) * L + c * 8 : nullptr);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp & 3;  // row block
  const int wc = warp >> 2;  // key half of S, and column half of the output
  const int c0 = wc * kTcHalf;  // this warp's first output column
  const int ks_n = (L + 15) / 16;  // k-steps of Q . K^T
  // this thread's rows g and g + 8 of the warp's 16: positions
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = pos_t0 + (row0 + 16 * wr + g + 8 * h) / H - t0;
  const TcRow qh = tc_row(dtt::smem_u32(sQh), pitch, 16 * wr + (lane & 15));
  const TcRow ql = tc_row(dtt::smem_u32(sQl), pitch, 16 * wr + (lane & 15));
  const int krow = 16 * wc + (lane & 7) + ((lane >> 4) << 3);  // this lane's key row of the S fragments

  float m[2] = {dtt::kNegInf, dtt::kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums over this warp's keys
  float acc[kTcHalf / 8][4];
#pragma unroll
  for (int n = 0; n < kTcHalf / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int ti = 0; ti < n_tiles; ++ti) {
    if (ti + 1 < n_tiles)
      tc_start_tile(ring + ((ti + 1) % kTcStages) * stage_bytes, pages, page_table, (ti + 1) * kTcKeys, n_ctx,
                    page_size, L, pitch);
    dtt::cp_async_commit();
    dtt::cp_async_wait<1>();
    __syncthreads();  // the tile (and, the first time, Q) is visible to every warp
    const uint32_t kt = ring + (ti % kTcStages) * stage_bytes;
    const int k0 = ti * kTcKeys;

    // this warp's S block, its 16 rows against its 16 keys: S = Q_hi . K^T
    // + Q_lo . K^T. The fragments of k-step ks + 1 load while k-step ks
    // multiplies (two register sets, the loop unrolled by two): asm
    // volatile keeps program order, so this order is the schedule.
    float s[2][4];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[b][i] = 0.f;
    const TcRow kr = tc_row(kt, pitch, krow);
    TcFrags f0, f1;
    tc_load_frags(f0, qh, ql, kr, lane, 0);
    int ks = 0;
    for (; ks + 1 < ks_n; ks += 2) {
      tc_load_frags(f1, qh, ql, kr, lane, ks + 1);
      tc_score_mma(s, f0);
      if (ks + 2 < ks_n) tc_load_frags(f0, qh, ql, kr, lane, ks + 2);
      tc_score_mma(s, f1);
    }
    if (ks < ks_n) tc_score_mma(s, f0);

    // online softmax; s[b][i] is (row g + 8 (i / 2), key k0 + 16 wc + 8 b +
    // 2t + i % 2). The row's max over the tile takes the other warp's half
    // through shared memory.
    float mx[2] = {dtt::kNegInf, dtt::kNegInf};
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = k0 + 16 * wc + b * 8 + 2 * t + (i & 1);
        const float v = (j <= qpos[i >> 1] && j < n_ctx) ? s[b][i] * kLog2e : dtt::kNegInf;
        s[b][i] = v;
        mx[i >> 1] = fmaxf(mx[i >> 1], v);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t == 0) sX[wc * kTcRows + 16 * wr + g + 8 * h] = mx[h];
    }
    __syncthreads();
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float M = fmaxf(m[h], fmaxf(mx[h], sX[(wc ^ 1) * kTcRows + 16 * wr + g + 8 * h]));
      corr[h] = exp2f(m[h] - M);
      m[h] = M;
      l[h] *= corr[h];
    }
    // P split into bf16 hi and lo, as the A fragments of this warp's k-step
    // (keys 16 wc ..); the other warp's k-step comes through shared memory
    uint32_t own[8];  // hi a0..a3, lo a0..a3
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(s[b][2 * h] - m[h]);
        const float p1 = exp2f(s[b][2 * h + 1] - m[h]);
        l[h] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        own[2 * b + h] = *reinterpret_cast<const uint32_t*>(&hi);
        own[4 + 2 * b + h] = dtt::pack_bf16(p0 - hf.x, p1 - hf.y);
      }
    }
    uint4* mine = reinterpret_cast<uint4*>(sP + threadIdx.x * 8);
    mine[0] = make_uint4(own[0], own[1], own[2], own[3]);
    mine[1] = make_uint4(own[4], own[5], own[6], own[7]);
#pragma unroll
    for (int n = 0; n < kTcHalf / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    __syncthreads();
    const uint4* theirs = reinterpret_cast<const uint4*>(sP + (threadIdx.x ^ 128) * 8);  // warp w ^ 4, this lane
    const uint4 th = theirs[0], tl = theirs[1];
    // O += P_hi . V + P_lo . V, V the tile's first d_c columns: this warp's
    // k-step, then the other's. V fragments two 8-column blocks an
    // ldmatrix.x4, the next pair loading while this pair multiplies; a pair
    // past d_c (warp-uniform) is neither read nor multiplied.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t ah[4] = {j ? th.x : own[0], j ? th.y : own[1], j ? th.z : own[2], j ? th.w : own[3]};
      const uint32_t al[4] = {j ? tl.x : own[4], j ? tl.y : own[5], j ? tl.z : own[6], j ? tl.w : own[7]};
      const TcRow vr = tc_row(kt, pitch, 16 * (wc ^ j) + (lane & 15));
      const int cv = c0 / 8 + (lane >> 4);
      uint32_t vb[2][4];
      if (c0 < d_c) dtt::ldsm_x4_trans(vb[0], vr.at(cv));
#pragma unroll
      for (int np = 0; np < kTcHalf / 16; ++np) {
        if (np + 1 < kTcHalf / 16 && c0 + 16 * (np + 1) < d_c) dtt::ldsm_x4_trans(vb[(np + 1) & 1], vr.at(cv + 2 * (np + 1)));
        if (c0 + 16 * np >= d_c) break;  // warp-uniform: past the output's columns
        const uint32_t(&b)[4] = vb[np & 1];
        dtt::mma_bf16_16816(acc[2 * np], ah, b[0], b[1]);
        dtt::mma_bf16_16816(acc[2 * np + 1], ah, b[2], b[3]);
        dtt::mma_bf16_16816(acc[2 * np], al, b[0], b[1]);
        dtt::mma_bf16_16816(acc[2 * np + 1], al, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage (and the exchange) before they are refilled
  }

  // the row sums: this warp's keys, then the other warp's
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (t == 0) sX[wc * kTcRows + 16 * wr + g + 8 * h] = l[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * wr + g + 8 * h;
    if (row >= n_rows) continue;
    const float denom = fmaxf(l[h] + sX[(wc ^ 1) * kTcRows + 16 * wr + g + 8 * h], 1e-20f);
    float* dst = out + (size_t)row * d_c + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kTcHalf / 8; ++n) {
      if (c0 + 8 * n >= d_c) break;
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------- K5, tensor cores

constexpr int kDcKeys = 64;     // latent rows a ring stage
constexpr int kDcWarps = 4;     // warp w: keys 16 w .. 16 w + 15 of each tile's S, output columns 128 w ..
constexpr int kDcThreads = 32 * kDcWarps;
constexpr int kDcStages = 2;
constexpr int kDcCols = 128;    // output columns a warp: 16 8-column blocks, 64 f32 accumulators a thread
constexpr int kDcMaxDc = kDcWarps * kDcCols;
constexpr int kDcBlocks = kDcKeys / 8;  // a tile's 8-key blocks
// the warps' row maxima (at the end, their row sums), then P_hi and P_lo: 2
// words (rows g, g + 8) a (8-key block, lane)
constexpr int kDcXBytes = kDcWarps * 16 * 4 + 2 * kDcBlocks * 32 * 8;

// mla_decode_tc's shared memory at latent width L: Q_hi and Q_lo (16 rows
// each), the ring, the exchange (188,672 B at L 576: one block an SM)
size_t dc_smem_bytes(int L) { return (size_t)(2 * 16 + kDcStages * kDcKeys) * tc_pitch(L) * 16 + kDcXBytes; }

// Start the cp.async copies of latent rows [k0, k0 + kDcKeys) of one sequence
// into a ring stage, 8 threads a row, chunk c of row r in slot c ^ (r % 8);
// rows at or past r1 (never looked up in the page table) and the pad chunks
// zero-filled. A thread looks up all its rows' pool addresses before its
// first copy, so the page-table loads overlap.
__device__ __forceinline__ void dc_start_tile(uint32_t stage, const __nv_bfloat16* __restrict__ pages,
                                              const int* __restrict__ pt, int k0, int r1, int page_size, int L,
                                              int pitch) {
  constexpr int RPT = kDcKeys / (kDcThreads / 8);  // rows a thread
  const int cpr = L / 8;
  const __nv_bfloat16* rows[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int j = k0 + (threadIdx.x >> 3) + i * (kDcThreads / 8);
    rows[i] = j < r1 ? pages + ((size_t)pt[j / page_size] * page_size + j % page_size) * L : nullptr;
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = (threadIdx.x >> 3) + i * (kDcThreads / 8);
    for (int c = threadIdx.x & 7; c < pitch; c += 8) {
      const bool ok = rows[i] != nullptr && c < cpr;
      dtt::cp_async16(stage + (r * pitch + (c ^ (r & 7))) * 16, ok ? rows[i] + c * 8 : pages, ok);
    }
  }
}

// One k-step's fragments of a warp's S block: the 16 heads' Q_hi and Q_lo
// and its two 8-key blocks (an ldmatrix.x4 each).
struct DcFrags {
  uint32_t qh[4], ql[4], k[4];
};

__device__ __forceinline__ void dc_load_frags(DcFrags& f, const TcRow& qh, const TcRow& ql, const TcRow& kr,
                                              int lane, int ks) {
  const int cq = 2 * ks + (lane >> 4);
  dtt::ldsm_x4(f.qh, qh.at(cq));
  dtt::ldsm_x4(f.ql, ql.at(cq));
  dtt::ldsm_x4(f.k, kr.at(2 * ks + ((lane >> 3) & 1)));
}

// sh[b] += Q_hi . K_b^T and sl[b] += Q_lo . K_b^T: four accumulator chains,
// so the dependent products of a k-step overlap.
__device__ __forceinline__ void dc_score_mma(float (&sh)[2][4], float (&sl)[2][4], const DcFrags& f) {
#pragma unroll
  for (int b = 0; b < 2; ++b) dtt::mma_bf16_16816(sh[b], f.qh, f.k[2 * b], f.k[2 * b + 1]);
#pragma unroll
  for (int b = 0; b < 2; ++b) dtt::mma_bf16_16816(sl[b], f.ql, f.k[2 * b], f.k[2 * b + 1]);
}

// Block (split, group of 16 heads, sequence): the split's rows [r0, r1) of
// heads 16 g .. (those past H zero queries that write nothing). Writes (m in
// log2 units, l, acc) of each head to the partials merge_splits reads: m, l
// [B, n_split, H], acc [B, n_split, H, d_c].
__global__ void __launch_bounds__(kDcThreads, 1)
mla_decode_tc(const float* __restrict__ q, const __nv_bfloat16* __restrict__ pages,
              const int* __restrict__ page_tables, const int* __restrict__ positions, float* __restrict__ m_part,
              float* __restrict__ l_part, float* __restrict__ acc_part, int H, int L, int d_c, int page_size,
              int max_pages, int split_rows, int n_split) {
  extern __shared__ __align__(16) uint8_t dc_smem[];
  const int split = blockIdx.x;
  const int h0 = blockIdx.y * 16;
  const int b = blockIdx.z;
  const int ctx = decode_ctx(positions, b, max_pages * page_size);
  const int r0 = split * split_rows;
  if (r0 >= ctx) return;  // block-uniform: this split holds no context
  const int r1 = min(r0 + split_rows, ctx);
  const int* pt = page_tables + (size_t)b * max_pages;
  const int pitch = tc_pitch(L);
  const int rb = pitch * 16;  // a row's bytes
  uint8_t* sQh = dc_smem;
  uint8_t* sQl = sQh + 16 * rb;
  const uint32_t ring = dtt::smem_u32(sQl + 16 * rb);
  const int stage_bytes = kDcKeys * rb;
  float* sX = reinterpret_cast<float*>(sQl + 16 * rb + kDcStages * stage_bytes);  // [kDcWarps][16]
  uint2* sPh = reinterpret_cast<uint2*>(sX + kDcWarps * 16);                     // [kDcBlocks][32]
  uint2* sPl = sPh + kDcBlocks * 32;                                             // [kDcBlocks][32]
  const int n_tiles = (r1 - r0 + kDcKeys - 1) / kDcKeys;

  // the group's f32 queries by cp.async into the second ring stage (their 32
  // (L / 8) 16-byte chunks fit its 64 rows of pitch chunks), then the first
  // tile; Q_hi and Q_lo are converted from shared memory while it loads
  const int cpr = L / 8;
  const uint32_t sq32 = ring + stage_bytes;
  for (int idx = threadIdx.x; idx < 16 * 2 * cpr; idx += kDcThreads) {  // 16-byte halves of the 8-value chunks
    const int r = idx / (2 * cpr);
    const int c = idx - r * 2 * cpr;
    const bool ok = h0 + r < H;
    dtt::cp_async16(sq32 + idx * 16, ok ? q + ((size_t)b * H + h0 + r) * L + c * 4 : q, ok);
  }
  dtt::cp_async_commit();
  dc_start_tile(ring, pages, pt, r0, r1, page_size, L, pitch);
  dtt::cp_async_commit();
  dtt::cp_async_wait<1>();
  __syncthreads();
  const float* q32 = reinterpret_cast<const float*>(sQl + 16 * rb + stage_bytes);  // [16][L]
  for (int idx = threadIdx.x; idx < 16 * pitch; idx += kDcThreads) {
    const int r = idx / pitch;
    const int c = idx - r * pitch;
    stage_q_chunk(sQh, sQl, pitch, r, c, c < cpr ? q32 + r * L + c * 8 : nullptr);
  }
  __syncthreads();  // the second stage is free for tile 1

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c0 = warp * kDcCols;   // this warp's first output column
  const int ks_n = (L + 15) / 16;  // k-steps of Q . K^T
  const TcRow qh = tc_row(dtt::smem_u32(sQh), pitch, lane & 15);
  const TcRow ql = tc_row(dtt::smem_u32(sQl), pitch, lane & 15);
  // this lane's key row of the S fragments (ldmatrix matrix i from lanes 8 i
  // ..: keys 8 (i / 2) .., chunk 2 ks + i % 2)
  const int krow = 16 * warp + (lane & 7) + ((lane >> 4) << 3);

  float m[2] = {dtt::kNegInf, dtt::kNegInf};  // the heads' running max (log2 units), the same in every warp
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums over this warp's keys
  float acc[kDcCols / 8][4];
#pragma unroll
  for (int n = 0; n < kDcCols / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int ti = 0; ti < n_tiles; ++ti) {
    if (ti + 1 < n_tiles)
      dc_start_tile(ring + ((ti + 1) % kDcStages) * stage_bytes, pages, pt, r0 + (ti + 1) * kDcKeys, r1, page_size,
                    L, pitch);
    dtt::cp_async_commit();
    dtt::cp_async_wait<1>();
    __syncthreads();  // the tile (and, the first time, Q) is visible to every warp
    const uint32_t kt = ring + (ti % kDcStages) * stage_bytes;
    const int k0 = r0 + ti * kDcKeys;

    // this warp's S block, the 16 heads against its keys: Q_hi . K^T + Q_lo .
    // K^T. The fragments of k-step ks + 1 load while k-step ks multiplies
    // (two register sets, the loop unrolled by two): asm volatile keeps
    // program order, so this order is the schedule.
    float sh[2][4], sl[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) sh[nb][i] = sl[nb][i] = 0.f;
    const TcRow kr = tc_row(kt, pitch, krow);
    DcFrags f0, f1;
    dc_load_frags(f0, qh, ql, kr, lane, 0);
    int ks = 0;
    for (; ks + 1 < ks_n; ks += 2) {
      dc_load_frags(f1, qh, ql, kr, lane, ks + 1);
      dc_score_mma(sh, sl, f0);
      if (ks + 2 < ks_n) dc_load_frags(f0, qh, ql, kr, lane, ks + 2);
      dc_score_mma(sh, sl, f1);
    }
    if (ks < ks_n) dc_score_mma(sh, sl, f0);

    // online softmax; s[nb][i] is (head g + 8 (i / 2), key k0 + 16 w + 8 nb +
    // 2t + i % 2). The tile's max takes the other warps' keys through
    // shared memory; every warp forms the same maximum.
    float s[2][4];
    float mx[2] = {dtt::kNegInf, dtt::kNegInf};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = k0 + 16 * warp + 8 * nb + 2 * t + (i & 1);
        s[nb][i] = j < r1 ? (sh[nb][i] + sl[nb][i]) * kLog2e : dtt::kNegInf;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nb][i]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t == 0) sX[warp * 16 + g + 8 * h] = mx[h];
    }
    __syncthreads();
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float M = m[h];
#pragma unroll
      for (int w = 0; w < kDcWarps; ++w) M = fmaxf(M, sX[w * 16 + g + 8 * h]);
      corr[h] = exp2f(m[h] - M);
      m[h] = M;
      l[h] *= corr[h];
    }
    // P split into bf16 hi and lo, this warp's key blocks to the exchange
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      uint32_t hi[2], lo[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(s[nb][2 * h] - m[h]);
        const float p1 = exp2f(s[nb][2 * h + 1] - m[h]);
        l[h] += p0 + p1;
        const __nv_bfloat162 x = __floats2bfloat162_rn(p0, p1);
        const float2 xf = __bfloat1622float2(x);
        hi[h] = *reinterpret_cast<const uint32_t*>(&x);
        lo[h] = dtt::pack_bf16(p0 - xf.x, p1 - xf.y);
      }
      sPh[(2 * warp + nb) * 32 + lane] = make_uint2(hi[0], hi[1]);
      sPl[(2 * warp + nb) * 32 + lane] = make_uint2(lo[0], lo[1]);
    }
#pragma unroll
    for (int n = 0; n < kDcCols / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    __syncthreads();
    // O += P_hi . V + P_lo . V over the tile's k-steps (k-step kk: key blocks
    // 2 kk and 2 kk + 1, the A fragment (g, 2t..), (g + 8, 2t..), (g, 8 +
    // 2t..), (g + 8, 8 + 2t..)); V is the tile's first d_c columns, this
    // warp's 128 of them, two 8-column blocks an ldmatrix.x4.trans, the next
    // pair loading while this pair multiplies; a pair past d_c (warp-uniform)
    // is neither read nor multiplied.
#pragma unroll
    for (int kk = 0; kk < kDcKeys / 16; ++kk) {
      const uint2 h0w = sPh[2 * kk * 32 + lane], h1w = sPh[(2 * kk + 1) * 32 + lane];
      const uint2 l0w = sPl[2 * kk * 32 + lane], l1w = sPl[(2 * kk + 1) * 32 + lane];
      const uint32_t ah[4] = {h0w.x, h0w.y, h1w.x, h1w.y};
      const uint32_t al[4] = {l0w.x, l0w.y, l1w.x, l1w.y};
      const TcRow vr = tc_row(kt, pitch, 16 * kk + (lane & 15));
      const int cv = c0 / 8 + (lane >> 4);
      uint32_t vb[2][4];
      if (c0 < d_c) dtt::ldsm_x4_trans(vb[0], vr.at(cv));
#pragma unroll
      for (int np = 0; np < kDcCols / 16; ++np) {
        if (np + 1 < kDcCols / 16 && c0 + 16 * (np + 1) < d_c) dtt::ldsm_x4_trans(vb[(np + 1) & 1], vr.at(cv + 2 * (np + 1)));
        if (c0 + 16 * np >= d_c) break;  // warp-uniform: past the output's columns
        const uint32_t(&bv)[4] = vb[np & 1];
        dtt::mma_bf16_16816(acc[2 * np], ah, bv[0], bv[1]);
        dtt::mma_bf16_16816(acc[2 * np + 1], ah, bv[2], bv[3]);
        dtt::mma_bf16_16816(acc[2 * np], al, bv[0], bv[1]);
        dtt::mma_bf16_16816(acc[2 * np + 1], al, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage and the exchange before they are refilled
  }

  // the row sums: this warp's keys, then the other warps', in a fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (t == 0) sX[warp * 16 + g + 8 * h] = l[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int head = h0 + g + 8 * h;
    if (head >= H) continue;
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kDcWarps; ++w) lsum += sX[w * 16 + g + 8 * h];
    const size_t part = ((size_t)b * n_split + split) * H + head;
    if (warp == 0 && t == 0) {
      m_part[part] = m[h];
      l_part[part] = lsum;
    }
    float* dst = acc_part + part * d_c + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kDcCols / 8; ++n) {
      if (c0 + 8 * n >= d_c) break;
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch

int n_slices(int d_c) { return (d_c + kSliceCols - 1) / kSliceCols; }

// A K5 launch's arguments.
struct DecodeCall {
  const float* q;
  const void* pages;
  const int* pt;
  const int* pos;
  float* m_part;
  float* l_part;
  float* acc_part;
  float* out;
  int B, H, L, d_c, ps, max_pages, split_rows, n_split;
  cudaStream_t stream;
};

bool dc_shapes_ok(int L, int d_c) {
  return L % 8 == 0 && d_c % 8 == 0 && d_c <= kDcMaxDc && dc_smem_bytes(L) <= kTcSmemLimit;
}

int launch_decode_tc(const DecodeCall& a) {
  static std::atomic<bool> raised[dtt::kMaxDevices];
  const cudaError_t err = dtt::raise_smem_limit_once(mla_decode_tc, raised, kTcSmemLimit);
  if (err != cudaSuccess) return (int)err;
  mla_decode_tc<<<dim3(a.n_split, (a.H + 15) / 16, a.B), kDcThreads, dc_smem_bytes(a.L), a.stream>>>(
      a.q, static_cast<const __nv_bfloat16*>(a.pages), a.pt, a.pos, a.m_part, a.l_part, a.acc_part, a.H, a.L,
      a.d_c, a.ps, a.max_pages, a.split_rows, a.n_split);
  return (int)cudaGetLastError();
}

// The split pass (bf16 pages within mla_decode_tc's budget: the tensor-core
// body; else the FMA body), then merge_splits.
template <typename T>
int launch_decode(const DecodeCall& a) {
  cudaError_t err = cudaSuccess;
  if (std::is_same<T, __nv_bfloat16>::value && dc_shapes_ok(a.L, a.d_c)) {
    err = (cudaError_t)launch_decode_tc(a);
  } else {
    // the dynamic shared memory exceeds the 48 KiB default; the limit is
    // raised to the most any L needs
    static std::atomic<bool> smem_raised[dtt::kMaxDevices];
    err = dtt::raise_smem_limit_once(mla_decode_partial<T>, smem_raised, smem_bytes(kHeads, kMaxLatent));
    if (err != cudaSuccess) return (int)err;
    const int ns = n_slices(a.d_c);
    mla_decode_partial<T><<<dim3(a.n_split, (a.H + kHeads - 1) / kHeads * ns, a.B), kThreads,
                            smem_bytes(kHeads, a.L), a.stream>>>(
        a.q, static_cast<const T*>(a.pages), a.pt, a.pos, a.m_part, a.l_part, a.acc_part, a.H, a.L, a.d_c, a.ps,
        a.max_pages, a.split_rows, a.n_split, ns);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  return dtt::launch_merge_splits(a.m_part, a.l_part, a.acc_part, a.pos, a.out, a.B, a.H, a.d_c,
                                  a.max_pages * a.ps, a.split_rows, a.n_split, a.stream);
}

template <typename T>
int launch_prefill(const float* q, const void* pages, const int* pt, const int* pos, float* out,
                   int T_len, int H, int L, int d_c, int ps, int max_pages, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tc_shapes_ok(L, d_c)) {
      static std::atomic<bool> tc_raised[dtt::kMaxDevices];
      const cudaError_t err = dtt::raise_smem_limit_once(mla_prefill_tc, tc_raised, kTcSmemLimit);
      if (err != cudaSuccess) return (int)err;
      const int blocks = (int)(((long long)T_len * H + kTcRows - 1) / kTcRows);
      mla_prefill_tc<<<blocks, kTcThreads, tc_smem_bytes(L), stream>>>(
          q, static_cast<const __nv_bfloat16*>(pages), pt, pos, out, T_len, H, L, d_c, ps, max_pages);
      return (int)cudaGetLastError();
    }
  }
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  const cudaError_t err = dtt::raise_smem_limit_once(mla_prefill<T>, smem_raised,
                                                     smem_bytes(2 * kHeads, kMaxLatent));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + 1) / 2, (H + kHeads - 1) / kHeads, n_slices(d_c));
  mla_prefill<T><<<grid, kThreads, smem_bytes(2 * kHeads, L), stream>>>(
      q, static_cast<const T*>(pages), pt, pos, out, T_len, H, L, d_c, ps, max_pages);
  return (int)cudaGetLastError();
}

bool shapes_ok(int H, int L, int d_c, int ps, int max_pages) {
  return H > 0 && L > 0 && d_c > 0 && d_c <= L && ps > 0 && max_pages > 0;
}

}  // namespace

// dtype: 0 = float32 pages, 1 = bfloat16 pages (q_cat and the output are
// float32). K5 gives each block split_rows context rows (a positive multiple
// of 64) and writes the splits' states to m_part, l_part [B, n_split, H] and
// acc_part [B, n_split, H, d_c] f32 (n_split >= ceil(max_pages * page_size /
// split_rows)), which merge_splits combines into out [B, H, d_c].
// Returns cudaGetLastError() after the launches (0 = launched); shapes the
// kernel does not take return cudaErrorInvalidValue without launching.
extern "C" int paged_mla_decode_attention(const void* q, const void* pages, const void* page_tables,
                                          const void* positions, void* m_part, void* l_part, void* acc_part,
                                          void* out, int B, int H, int L, int d_c, int page_size, int max_pages,
                                          int split_rows, int n_split, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (!shapes_ok(H, L, d_c, page_size, max_pages) || split_rows <= 0 || split_rows % kDcKeys ||
      (long long)n_split * split_rows < (long long)max_pages * page_size)
    return (int)cudaErrorInvalidValue;
  const DecodeCall a{static_cast<const float*>(q), pages, static_cast<const int*>(page_tables),
                     static_cast<const int*>(positions), static_cast<float*>(m_part), static_cast<float*>(l_part),
                     static_cast<float*>(acc_part), static_cast<float*>(out), B, H, L, d_c, page_size, max_pages,
                     split_rows, n_split, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_decode<float>(a);
  if (dtype == 1) return launch_decode<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

// 1 when paged_mla_decode_attention runs the tensor-core body at this latent
// width, d_c and page dtype (0 = float32, 1 = bfloat16), else 0.
extern "C" int mla_decode_on_tensor_cores(int L, int d_c, int dtype) {
  return dtype == 1 && L > 0 && d_c > 0 && d_c <= L && dc_shapes_ok(L, d_c);
}

// K6: bf16 pages whose tiles fit the shared-memory budget (L <= 576), L % 8
// == 0, d_c % 8 == 0, d_c <= 512
// take the tensor-core body; f32 pages and other shapes the FMA body.
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
