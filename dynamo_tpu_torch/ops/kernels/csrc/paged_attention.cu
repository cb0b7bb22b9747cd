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
// 64; here any head dim below 256 but 128), which the TPU reads from pools with
// the kv heads folded into the lane dim. Its zero-placed folded queries and
// one-hot output selection are a Mosaic lane workaround and are not carried
// over; see K3a below. The reference's folded kernel rounds its
// probabilities to the pool dtype before P.V; K3a keeps them f32, as K1 and
// the reference's plain version do.
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
// G = Hq / Hkv may be any value: a block holds sub = head_subgroup(G) <= 8
// of the kv head's query heads (all of them when G <= 8) and the G / sub
// sub-groups run as a third grid dimension; each re-reads the kv head's rows.
//
// K1 takes D 64, 128 and 256 (f32 rows of 256 in two 16-byte loads a lane,
// LaneVec). A wider row needs more than a warp's 32 lanes of 8 values (and
// 16 values a lane would need 256 query and accumulator registers at G 8).
//
// K3a design (bf16 queries over bf16 or int8 pools, any D that is a multiple
// of 8 below 128, any G and Hkv): bound by the live rows' bytes like K1. A
// warp a 512-byte TinyLlama row with an online-softmax update on every lane
// of every row, and a merge launch of B * Hq blocks, reach 0.7 TB/s on an
// H100; so:
// - Grid (context split, kv-head chunk, sequence): each block covers
//   split_rows context rows of one sequence for the kv heads of its chunk
//   (all Hkv when they fit: TinyLlama's whole folded row), so a staged row
//   serves every query head of those kv heads. One warp a (kv head, 16-head
//   tile) item, at most 8 items a block; G > 16 spreads a kv head's tiles
//   over blocks.
// - Staging: 32-row tiles of K and V (the chunk's slice of each token row,
//   padded to an odd number of 16-byte chunks so ldmatrix is conflict-free)
//   in a cp.async ring of 2-4 stages through the page table, the token
//   rows' pool offsets computed once a block; tile t + stages - 1 loads while
//   tile t is computed. Int8 codes land raw with their row scales (rows 16
//   bytes longer than the codes, so the fragment reads are conflict-free)
//   and become bf16 fragments in registers as they are read (exact); a
//   conversion pass through shared memory cost the int8 kernel twice the
//   bf16 one's time on an H100.
// - Scores on the tensor cores: S = Q . K^T by mma.sync m16n8k16 (bf16 in,
//   f32 sums: bf16 x bf16 products are exact), the G heads zero-padded to
//   16 rows and D to a multiple of 16 (zero query columns; a row's pad
//   chunk is zero-filled), K fragments by ldmatrix. One max / sum update
//   per head per tile instead of per row; exp2 with the scale folded in.
// - P . V by mma.sync with V fragments by ldmatrix.trans and P split into
//   bf16 hi + lo (two products, as K2 / K3b do), so the probabilities stay
//   f32-exact under TOL["bf16"] (one rounding of P leaves it). Int8: the K
//   scale multiplies S's columns, the V scale P after l took it.
// - Split-K as before (split_rows 128 fills the card at the serve batch);
//   the splits merge in merge_splits (decode_rows.cuh), a launch of B *
//   ceil(Hq / 8) blocks of 8 warps, one head a warp.
// f32 queries (f32 or int8 pools: the f32 parity phases and the checks),
// and bf16 queries at the head dims the tensor-core body does not take (D
// 136..248, and any D that is no multiple of 8, whose rows start off 16 and
// off 8 bytes: D 100 over 2 kv heads, which the reference runs in plain XLA,
// or D 20 over 4), take an FMA body in the same split partition: block
// (split, kv head, sequence), a warp a query head, a lane a row for the
// score and an output column for P . V, rows read an element at a time.
// Every shuffle loop has a warp-uniform trip count.

#include <algorithm>
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

// ---------------------------------------------------------------- K1

// Block (kv head, sequence, sub-group): the SG query heads kvh * G +
// blockIdx.z * SG + g, g < SG, of the kv head's G.
template <typename TQ, typename TK, int D, int SG>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ k_pool,
                    const TK* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ page_tables,
                    const int* __restrict__ positions, TQ* __restrict__ out, int Hkv, int G,
                    int page_size, int max_pages, float scale) {
  using RV = dtt::LaneVec<TK, D>;
  constexpr int VEC = RV::N;
  constexpr int LPR = D / VEC;  // lanes per K/V row
  static_assert(D % VEC == 0 && LPR <= 32 && 32 % LPR == 0, "unsupported head_dim");
  constexpr int RPW = 32 / LPR;          // row groups per warp
  constexpr int NROWS = kWarps * RPW;    // row groups per block

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int Hq = Hkv * G;
  const size_t head0 = (size_t)b * Hq + kvh * G + blockIdx.z * SG;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPR;
  const int row = warp * RPW + lane / LPR;
  const int d0 = sub * VEC;

  float qf[SG][VEC];
#pragma unroll
  for (int g = 0; g < SG; ++g) dtt::load_floats<TQ, VEC>(q + (head0 + g) * D + d0, qf[g]);

  const int ctx = decode_ctx(positions, b, max_pages * page_size);
  const int* pt = page_tables + (size_t)b * max_pages;

  float m[SG], l[SG], acc[SG][VEC];
#pragma unroll
  for (int g = 0; g < SG; ++g) {
    m[g] = dtt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  // the trip count is uniform across the block: row groups sharing a warp
  // must run the same iterations, or the full-mask shuffles deadlock
  for (int t0 = 0; t0 < ctx; t0 += NROWS * kUnroll) {
    RowLoads<TK, kUnroll, RV> r;
    load_rows<TK, kUnroll, RV>(r, k_pool, v_pool, k_scale, v_scale, pt, t0, row, NROWS, ctx, page_size,
                               (size_t)Hkv * D, kvh * D + d0);
    consume_rows<TK, kUnroll, SG, LPR, RV>(r, qf, scale, m, l, acc);
  }

  // merge the NROWS row groups' partial softmax states
  __shared__ float sm_m[NROWS][SG];
  __shared__ float sm_l[NROWS][SG];
  __shared__ float sm_acc[NROWS][SG][D];
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < SG; ++g) {
      sm_m[row][g] = m[g];
      sm_l[row][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < SG; ++g) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[row][g][d0 + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < SG * D; idx += kThreads) {
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
    dtt::store1(out + (head0 + g) * D + d, A / fmaxf(L, 1e-20f));
  }
}

// ---------------------------------------------------------------- K3a

constexpr int kFoldRows = 32;   // token rows a ring stage
constexpr int kFoldItems = 8;   // (kv head, 16-head tile) items a block at most: one warp each
constexpr int kFoldRing = 100 * 1024;  // the ring's budget: two blocks an SM
constexpr int kFoldFmaWarps = 4;
constexpr int kFoldMaxD = 256;  // the FMA body's head dims: below this

// A K3a launch's partition and shared-memory layout (host-computed).
struct FoldArgs {
  int Hkv, G, D, page_size, max_pages, split_rows, n_split;
  int n_ht;    // 16-head tiles of a kv head, ceil(G / 16)
  int hb;      // kv heads a block stages (n_ht == 1), else 1
  int tpb;     // head tiles a block (n_ht > 1)
  int rs;      // a bf16 tile row, in 16-byte chunks (odd: conflict-free ldmatrix)
  int rsr;     // an int8 raw row, in bytes (a multiple of 16)
  int stages;  // ring stages
  float scale_log2;  // log2(e) / sqrt(D)
};

// The block's kv heads [kv_lo, kv_lo + kv_n) and this warp's item (kvh, ht).
struct FoldItem {
  int kv_lo, kv_n, kvh, ht;
  bool active;
};

__device__ __forceinline__ FoldItem fold_item(const FoldArgs& f, int chunk, int warp) {
  FoldItem it;
  if (f.n_ht == 1) {
    it.kv_lo = chunk * f.hb;
    it.kv_n = min(f.hb, f.Hkv - it.kv_lo);
    it.kvh = it.kv_lo + warp;
    it.ht = 0;
    it.active = warp < it.kv_n;
  } else {
    const int bpk = (f.n_ht + f.tpb - 1) / f.tpb;
    it.kvh = chunk / bpk;
    it.kv_lo = it.kvh;
    it.kv_n = 1;
    it.ht = (chunk % bpk) * f.tpb + warp;
    it.active = it.ht < f.n_ht;
  }
  return it;
}

template <typename TK>
__host__ __device__ inline int fold_stage_bytes(const FoldArgs& f) {
  return std::is_same<TK, int8_t>::value ? 2 * kFoldRows * f.rsr + 2 * kFoldRows * 4
                                         : 2 * kFoldRows * f.rs * 16;
}

// Start the cp.async copies of context rows [t0, t0 + kFoldRows) (rows at or
// past r1 zero-filled) of the block's kv heads into a ring stage: K then V
// (bf16: tiles of f.rs chunks a row, pad chunks zero; int8: raw rows of
// f.rsr bytes, then the K and V row scales). tok[] holds the split's rows'
// pool rows.
template <typename TK>
__device__ __forceinline__ void fold_start_tile(uint8_t* stage, const TK* __restrict__ k_pool,
                                                const TK* __restrict__ v_pool,
                                                const float* __restrict__ k_scale,
                                                const float* __restrict__ v_scale, const int* tok,
                                                int t0, int r0, int r1, int W, size_t token_stride,
                                                size_t col0, const FoldArgs& f) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const uint32_t s = dtt::smem_u32(stage);
  if constexpr (std::is_same<TK, int8_t>::value) {
    const int half = f.rsr * kFoldRows;  // the V rows follow the K rows
    // 16-byte copies where every row piece starts on 16 bytes, else 8-byte
    // ones (W, the token stride and col0 are multiples of 8)
    const bool wide = W % 16 == 0 && token_stride % 16 == 0 && col0 % 16 == 0;
    const int units = wide ? W / 16 : W / 8;
    for (int r = warp; r < kFoldRows; r += nw) {
      const int j = t0 + r;
      const bool ok = j < r1;
      const size_t off = ok ? (size_t)tok[j - r0] * token_stride + col0 : 0;
      for (int u = lane; u < units; u += 32) {
        if (wide) {
          dtt::cp_async16(s + r * f.rsr + u * 16, k_pool + off + u * 16, ok);
          dtt::cp_async16(s + half + r * f.rsr + u * 16, v_pool + off + u * 16, ok);
        } else {
          dtt::cp_async8(s + r * f.rsr + u * 8, k_pool + off + u * 8, ok);
          dtt::cp_async8(s + half + r * f.rsr + u * 8, v_pool + off + u * 8, ok);
        }
      }
    }
    if (threadIdx.x < 2 * kFoldRows) {
      const int r = threadIdx.x % kFoldRows;
      const int j = t0 + r;
      const bool ok = j < r1;
      const float* src = threadIdx.x < kFoldRows ? k_scale : v_scale;
      dtt::cp_async4(s + 2 * half + threadIdx.x * 4, src + (ok ? tok[j - r0] : 0), ok);
    }
  } else {
    const int half = f.rs * 16 * kFoldRows;
    for (int r = warp; r < kFoldRows; r += nw) {
      const int j = t0 + r;
      const size_t off = j < r1 ? (size_t)tok[j - r0] * token_stride + col0 : 0;
      for (int c = lane; c < f.rs; c += 32) {
        const bool ok = j < r1 && c * 8 < W;
        dtt::cp_async16(s + (r * f.rs + c) * 16, k_pool + off + c * 8, ok);
        dtt::cp_async16(s + half + (r * f.rs + c) * 16, v_pool + off + c * 8, ok);
      }
    }
  }
}

// Int8: two codes as a bf16 pair (exact: |code| <= 127).
__device__ __forceinline__ uint32_t codes_bf16(int lo, int hi) { return dtt::pack_bf16((float)lo, (float)hi); }

template <typename TK, int DP>
__global__ void __launch_bounds__(32 * kFoldItems, 1)
folded_decode_tc(const __nv_bfloat16* __restrict__ q, const TK* __restrict__ k_pool,
                 const TK* __restrict__ v_pool, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int* __restrict__ page_tables,
                 const int* __restrict__ positions, float* __restrict__ m_part,
                 float* __restrict__ l_part, float* __restrict__ acc_part, const FoldArgs f) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  constexpr int KS = DP / 16;  // k-steps of Q . K^T
  constexpr int NB = DP / 8;   // 8-column blocks of the output
  static_assert(DP % 16 == 0 && DP <= 128, "unsupported head_dim");
  extern __shared__ __align__(16) uint8_t smem[];

  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int ctx = decode_ctx(positions, b, f.max_pages * f.page_size);
  const int r0 = split * f.split_rows;
  if (r0 >= ctx) return;  // block-uniform: this split holds no context
  const int r1 = min(r0 + f.split_rows, ctx);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int Hq = f.Hkv * f.G;
  const FoldItem it = fold_item(f, blockIdx.y, warp);
  const int W = it.kv_n * f.D;  // staged values of a row
  const size_t token_stride = (size_t)f.Hkv * f.D;

  const int stage_bytes = fold_stage_bytes<TK>(f);
  int* tok = reinterpret_cast<int*>(smem + f.stages * stage_bytes);  // [split_rows]
  const int* pt = page_tables + (size_t)b * f.max_pages;
  for (int j = r0 + threadIdx.x; j < r1; j += blockDim.x) tok[j - r0] = (int)dtt::token_row(pt, j, f.page_size);
  __syncthreads();

  const int n_tiles = (r1 - r0 + kFoldRows - 1) / kFoldRows;
  for (int st = 0; st < f.stages - 1; ++st) {
    if (st < n_tiles)
      fold_start_tile<TK>(smem + st * stage_bytes, k_pool, v_pool, k_scale, v_scale, tok, r0 + st * kFoldRows,
                          r0, r1, W, token_stride, (size_t)it.kv_lo * f.D, f);
    dtt::cp_async_commit();
  }

  // this warp's query fragments: heads ht * 16 + g and + 8 of kv head kvh
  // (zero past G), columns past D zero
  const int hA = it.ht * 16 + g;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = hA + 8 * (i & 1);
      const int col = 16 * ks + 2 * t + 8 * (i >> 1);
      qa[ks][i] = 0u;
      if (it.active && h < f.G && col < f.D)
        qa[ks][i] = *reinterpret_cast<const uint32_t*>(q + ((size_t)b * Hq + it.kvh * f.G + h) * f.D + col);
    }
  }
  float m[2] = {dtt::kNegInf, dtt::kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const uint32_t kofs = (uint32_t)(it.kvh - it.kv_lo) * f.D * 2;  // this kv head's bytes into a bf16 row
  const uint32_t row_bytes = f.rs * 16;

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int nxt = ti + f.stages - 1;
    if (nxt < n_tiles)
      fold_start_tile<TK>(smem + (nxt % f.stages) * stage_bytes, k_pool, v_pool, k_scale, v_scale, tok,
                          r0 + nxt * kFoldRows, r0, r1, W, token_stride, (size_t)it.kv_lo * f.D, f);
    dtt::cp_async_commit();
    dtt::cp_async_wait_upto(f.stages - 1);
    __syncthreads();
    const uint8_t* stage = smem + (ti % f.stages) * stage_bytes;
    // int8: the raw codes, converted to bf16 fragments in registers
    const int8_t* kc = reinterpret_cast<const int8_t*>(stage) + (it.kvh - it.kv_lo) * f.D;
    const int8_t* vc = kc + kFoldRows * f.rsr;
    const float* sKs = reinterpret_cast<const float*>(stage + 2 * kFoldRows * f.rsr);
    const float* sVs = sKs + kFoldRows;
    const int t0 = r0 + ti * kFoldRows;
    if (it.active) {  // warp-uniform
      const uint32_t kt = dtt::smem_u32(stage) + kofs;
      const uint32_t vt = kt + kFoldRows * row_bytes;
      // S = Q . K^T over the tile's 4 blocks of 8 rows
      float s[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b0, b1;
          if constexpr (kQuant) {
            const int8_t* r = kc + (nb * 8 + g) * f.rsr + 16 * ks + 2 * t;
            const char2 x = *reinterpret_cast<const char2*>(r);
            const char2 y = *reinterpret_cast<const char2*>(r + 8);
            b0 = codes_bf16(x.x, x.y);
            b1 = codes_bf16(y.x, y.y);
          } else {
            dtt::ldsm_x2(b0, b1, kt + (nb * 8 + (lane & 7)) * row_bytes + ks * 32 + ((lane >> 3) & 1) * 16);
          }
          dtt::mma_bf16_16816(s[nb], qa[ks], b0, b1);
        }
      }
      // online softmax; s[nb][i] is (head row g + 8 (i / 2), tile row 8 nb + 2t + i % 2)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = nb * 8 + 2 * t + (i & 1);
          float v = s[nb][i] * f.scale_log2;
          if constexpr (kQuant) v *= sKs[r];
          if (t0 + r >= r1) v = dtt::kNegInf;
          s[nb][i] = v;
          mx[i >> 1] = fmaxf(mx[i >> 1], v);
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
      uint32_t ph[4][2], pl[4][2];  // P split into bf16 hi and lo: (block nb, head row g / g + 8)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p0 = exp2f(s[nb][2 * h] - m[h]);
          float p1 = exp2f(s[nb][2 * h + 1] - m[h]);
          l[h] += p0 + p1;
          if constexpr (kQuant) {
            p0 *= sVs[nb * 8 + 2 * t];
            p1 *= sVs[nb * 8 + 2 * t + 1];
          }
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          ph[nb][h] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[nb][h] = dtt::pack_bf16(p0 - hf.x, p1 - hf.y);
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // O += P_hi . V + P_lo . V; k-step kk takes tile rows 16 kk .. 16 kk + 15
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t ah[4] = {ph[2 * kk][0], ph[2 * kk][1], ph[2 * kk + 1][0], ph[2 * kk + 1][1]};
        const uint32_t al[4] = {pl[2 * kk][0], pl[2 * kk][1], pl[2 * kk + 1][0], pl[2 * kk + 1][1]};
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if (n * 8 >= f.D) break;  // the pad columns' block: never written
          uint32_t b0, b1;
          if constexpr (kQuant) {
            const int8_t* c = vc + (16 * kk + 2 * t) * f.rsr + 8 * n + g;
            b0 = codes_bf16(c[0], c[f.rsr]);
            b1 = codes_bf16(c[8 * f.rsr], c[9 * f.rsr]);
          } else {
            dtt::ldsm_x2_trans(b0, b1, vt + (16 * kk + (lane & 15)) * row_bytes + n * 16);
          }
          dtt::mma_bf16_16816(acc[n], ah, b0, b1);
          dtt::mma_bf16_16816(acc[n], al, b0, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (!it.active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t part = (size_t)b * f.n_split + split;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int head = hA + 8 * h;
    if (head >= f.G) continue;
    const size_t hq = part * Hq + (size_t)it.kvh * f.G + head;
    if (t == 0) {
      m_part[hq] = m[h];
      l_part[hq] = l[h];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if (n * 8 >= f.D) break;
      *reinterpret_cast<float2*>(acc_part + hq * f.D + n * 8 + 2 * t) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// The FMA body: f32 queries over f32 or int8 pools, and bf16 queries at
// the head dims the tensor-core body does not take (no multiple of 8, or
// above 128), over bf16 or int8 pools. Block (split, kv head, sequence);
// warp w takes the kv head's query heads w, w + 4, ...; lane j scores row j
// of each 32-row step against the head's query (in shared memory) and owns
// output columns lane + 32 i. Rows are read an element at a time, so a row
// may start at any offset (D 100 over 2 kv heads, D 20 over 4).
template <typename TQ, typename TK>
__global__ void __launch_bounds__(32 * kFoldFmaWarps)
folded_decode_fma(const TQ* __restrict__ q, const TK* __restrict__ k_pool, const TK* __restrict__ v_pool,
                  const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                  const int* __restrict__ page_tables, const int* __restrict__ positions,
                  float* __restrict__ m_part, float* __restrict__ l_part, float* __restrict__ acc_part,
                  const FoldArgs f) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  constexpr int kCols = kFoldMaxD / 32;  // output columns a lane
  __shared__ float sq[kFoldFmaWarps][kFoldMaxD];
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int ctx = decode_ctx(positions, b, f.max_pages * f.page_size);
  const int r0 = split * f.split_rows;
  if (r0 >= ctx) return;
  const int r1 = min(r0 + f.split_rows, ctx);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Hq = f.Hkv * f.G;
  const size_t token_stride = (size_t)f.Hkv * f.D;
  const int* pt = page_tables + (size_t)b * f.max_pages;
  const size_t part = (size_t)b * f.n_split + split;

  for (int h = warp; h < f.G; h += kFoldFmaWarps) {  // warp-uniform
    const size_t hq = (size_t)kvh * f.G + h;
    for (int d = lane; d < f.D; d += 32) sq[warp][d] = dtt::to_f(q[((size_t)b * Hq + hq) * f.D + d]);
    __syncwarp();
    float m = dtt::kNegInf, l = 0.f, acc[kCols] = {};
    for (int j0 = r0; j0 < r1; j0 += 32) {
      const int j = j0 + lane;
      long long tk = 0;
      float s = dtt::kNegInf;
      if (j < r1) {
        tk = (long long)dtt::token_row(pt, j, f.page_size);
        const TK* kr = k_pool + tk * token_stride + (size_t)kvh * f.D;
        float dot = 0.f;
        for (int d = 0; d < f.D; ++d) dot = fmaf(sq[warp][d], dtt::to_f(kr[d]), dot);
        s = dot * f.scale_log2;
        if constexpr (kQuant) s *= k_scale[tk];
      }
      const float new_m = fmaxf(m, dtt::warp_max(s));
      const float corr = exp2f(m - new_m);
      float p = j < r1 ? exp2f(s - new_m) : 0.f;
      l = l * corr + dtt::warp_sum(p);
      m = new_m;
      if constexpr (kQuant) {
        if (j < r1) p *= v_scale[tk];
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] *= corr;
      const int n = min(32, r1 - j0);
      for (int r = 0; r < n; ++r) {  // warp-uniform
        const float pr = __shfl_sync(0xffffffffu, p, r);
        const long long tr = __shfl_sync(0xffffffffu, tk, r);
        const TK* vr = v_pool + tr * token_stride + (size_t)kvh * f.D;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int d = lane + 32 * i;
          if (d < f.D) acc[i] = fmaf(pr, dtt::to_f(vr[d]), acc[i]);
        }
      }
    }
    if (lane == 0) {
      m_part[part * Hq + hq] = m;
      l_part[part * Hq + hq] = l;
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane + 32 * i;
      if (d < f.D) acc_part[(part * Hq + hq) * f.D + d] = acc[i];
    }
    __syncwarp();  // sq is rewritten for the next head
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

template <typename TQ, typename TK, int D, int SG>
struct K1Launch {
  static int run(const DecodeArgs& a) {
    const int G = a.Hq / a.Hkv;
    paged_decode_kernel<TQ, TK, D, SG><<<dim3(a.Hkv, a.B, G / SG), kThreads, 0, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks,
        a.vs, a.pt, a.pos, static_cast<TQ*>(a.out), a.Hkv, G, a.ps, a.max_pages, 1.0f / sqrtf((float)D));
    return (int)cudaGetLastError();
  }
};

// Dispatch on the sub-group size head_subgroup(G) to F<TQ, TK, D, SG>::run.
template <template <typename, typename, int, int> class F, typename TQ, typename TK, int D>
int with_subgroup(const DecodeArgs& a) {
  switch (dtt::head_subgroup(a.Hq / a.Hkv)) {
    case 1: return F<TQ, TK, D, 1>::run(a);
    case 2: return F<TQ, TK, D, 2>::run(a);
    case 3: return F<TQ, TK, D, 3>::run(a);
    case 4: return F<TQ, TK, D, 4>::run(a);
    case 5: return F<TQ, TK, D, 5>::run(a);
    case 6: return F<TQ, TK, D, 6>::run(a);
    case 7: return F<TQ, TK, D, 7>::run(a);
    case 8: return F<TQ, TK, D, 8>::run(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TK>
struct K1Types {
  static int run(const DecodeArgs& a) {
    switch (a.D) {
      case 64: return with_subgroup<K1Launch, TQ, TK, 64>(a);
      case 128: return with_subgroup<K1Launch, TQ, TK, 128>(a);
      case 256: return with_subgroup<K1Launch, TQ, TK, 256>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
};

// K3a's partition: the kv heads a block stages (as many as fit the ring's
// budget at two stages, at most kFoldItems), the ring's stages and the
// dynamic shared memory (ring, int8 conversion tiles, the split's pool rows).
template <typename TK>
FoldArgs fold_plan(const DecodeArgs& a, int split_rows, int n_split, size_t* smem, int* warps, int* chunks) {
  FoldArgs f{};
  f.Hkv = a.Hkv;
  f.G = a.Hq / a.Hkv;
  f.D = a.D;
  f.page_size = a.ps;
  f.max_pages = a.max_pages;
  f.split_rows = split_rows;
  f.n_split = n_split;
  f.scale_log2 = 1.4426950408889634f / sqrtf((float)a.D);
  f.n_ht = (f.G + 15) / 16;
  f.tpb = std::min(f.n_ht, kFoldItems);
  for (f.hb = f.n_ht == 1 ? std::min(a.Hkv, kFoldItems) : 1;; --f.hb) {
    const int W = f.hb * a.D;
    f.rs = W / 8 + (a.D % 16 ? 1 : 0);  // a pad chunk when D is no multiple of 16
    f.rs |= 1;
    // int8 rows: 16 bytes past the codes, so consecutive rows fall 4 banks
    // apart for the fragment loads
    f.rsr = (W + 15) / 16 * 16 + 16;
    if (f.hb == 1 || 2 * fold_stage_bytes<TK>(f) <= kFoldRing) break;
  }
  const int stage = fold_stage_bytes<TK>(f);
  f.stages = std::max(2, std::min(4, kFoldRing / stage));
  *smem = (size_t)f.stages * stage + split_rows * sizeof(int);
  *warps = f.n_ht == 1 ? f.hb : f.tpb;
  *chunks = f.n_ht == 1 ? (a.Hkv + f.hb - 1) / f.hb : a.Hkv * ((f.n_ht + f.tpb - 1) / f.tpb);
  return f;
}

template <typename TQ>
int launch_merge(const DecodeArgs& a, const float* m, const float* l, const float* acc, int split_rows,
                 int n_split) {
  dtt::merge_splits<TQ><<<dim3((a.Hq + dtt::kMergeHeads - 1) / dtt::kMergeHeads, a.B), 32 * dtt::kMergeHeads, 0,
                          a.stream>>>(m, l, acc, a.pos, static_cast<TQ*>(a.out), a.Hq, a.D, a.max_pages * a.ps,
                                      split_rows, n_split);
  return (int)cudaGetLastError();
}

template <typename TK, int DP>
int launch_fold_tc(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  size_t smem;
  int warps, chunks;
  const FoldArgs f = fold_plan<TK>(a, split_rows, n_split, &smem, &warps, &chunks);
  const cudaError_t err = dtt::raise_smem_limit_once(folded_decode_tc<TK, DP>, smem_raised, 227 * 1024);
  if (err != cudaSuccess) return (int)err;
  folded_decode_tc<TK, DP><<<dim3(n_split, chunks, a.B), 32 * warps, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks, a.vs,
      a.pt, a.pos, m, l, acc, f);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  return launch_merge<__nv_bfloat16>(a, m, l, acc, split_rows, n_split);
}

template <typename TQ, typename TK>
int launch_fold_fma(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
  FoldArgs f{};
  f.Hkv = a.Hkv;
  f.G = a.Hq / a.Hkv;
  f.D = a.D;
  f.page_size = a.ps;
  f.max_pages = a.max_pages;
  f.split_rows = split_rows;
  f.n_split = n_split;
  f.scale_log2 = 1.4426950408889634f / sqrtf((float)a.D);
  folded_decode_fma<TQ, TK><<<dim3(n_split, a.Hkv, a.B), 32 * kFoldFmaWarps, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks, a.vs, a.pt,
      a.pos, m, l, acc, f);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  return launch_merge<TQ>(a, m, l, acc, split_rows, n_split);
}

template <typename TK>
int fold_tc_dim(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
  switch ((a.D + 15) / 16) {  // D padded to a multiple of 16
    case 1: return launch_fold_tc<TK, 16>(a, m, l, acc, split_rows, n_split);
    case 2: return launch_fold_tc<TK, 32>(a, m, l, acc, split_rows, n_split);
    case 3: return launch_fold_tc<TK, 48>(a, m, l, acc, split_rows, n_split);
    case 4: return launch_fold_tc<TK, 64>(a, m, l, acc, split_rows, n_split);
    case 5: return launch_fold_tc<TK, 80>(a, m, l, acc, split_rows, n_split);
    case 6: return launch_fold_tc<TK, 96>(a, m, l, acc, split_rows, n_split);
    case 7: return launch_fold_tc<TK, 112>(a, m, l, acc, split_rows, n_split);
    case 8: return launch_fold_tc<TK, 128>(a, m, l, acc, split_rows, n_split);
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

// bf16 queries at a head dim that is a multiple of 8 below 128 take the
// tensor-core body; f32 queries, and bf16 queries at other head dims (no
// multiple of 8, or 136..248), the FMA body
template <typename TQ, typename TK>
struct K3aTypes {
  static int run(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
    if constexpr (std::is_same<TQ, __nv_bfloat16>::value) {
      if (a.D % 8 == 0 && a.D < 128) return fold_tc_dim<TK>(a, m, l, acc, split_rows, n_split);
    }
    return launch_fold_fma<TQ, TK>(a, m, l, acc, split_rows, n_split);
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

// K3a: head_dim 0 < D < 256, any Hq a multiple of Hkv.
// Partial buffers m_part, l_part [B, n_split, Hq] and acc_part [B, n_split,
// Hq, D] f32, n_split >= ceil(max_pages * page_size / split_rows).
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
  if (!decode_shapes_ok(a, kv_dtype) || D <= 0 || D >= kFoldMaxD || split_rows <= 0 ||
      split_rows % kFoldRows || (long long)n_split * split_rows < (long long)max_pages * page_size)
    return (int)cudaErrorInvalidValue;
  return with_types<K3aTypes>(q_dtype, kv_dtype, a, static_cast<float*>(m_part),
                              static_cast<float*>(l_part), static_cast<float*>(acc_part),
                              split_rows, n_split);
}
