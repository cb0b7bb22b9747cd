// K1 and K3a: paged decode attention for Hopper (sm_90a).
//
// K1 replaces the TPU kernels dynamo_tpu/ops/pallas/paged_attention.py:536
// paged_decode_attention_pallas_lookahead (_kernel_lookahead, pallas_call at
// :587) and :952 paged_decode_attention_pallas (_kernel, pallas_call at
// :988). Both compute the same function and differ only in how the TPU
// schedules its page DMAs (the lookahead variant prefetches the NEXT grid
// program's pages into scratch that persists across the serial TPU grid);
// one kernel here stands for both. Nothing carries between CUDA blocks, so
// no cross-block prefetch is attempted.
//
// K3a replaces paged_decode_attention_pallas_folded (_kernel_folded): the
// same function for head dims that are not a multiple of 128 (TinyLlama's
// 64; here any head dim that is no multiple of 128), which the TPU
// reads from pools with the kv heads folded into the lane dim. Its
// zero-placed folded queries and one-hot output selection are a Mosaic lane
// workaround and are not carried over; see K3a below. The reference's folded
// kernel rounds its probabilities to the pool dtype before P.V; K3a keeps
// them f32, as K1 and the reference's plain version do.
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
// FLOP/byte ridge. At the serve batch (B 64, contexts 1..2048, Llama-3-8B's
// 8 kv heads of D 128) that is ~0.07 ms of bytes (int8 ~0.04).
//
// K1 design, bf16 queries over bf16 or int8 pools (paged_decode_tc; D 64,
// 128, 256, 384 and 512, and K3a's multiples of 16 below 128). A first K1
// gave each (sequence, kv head) one block that streamed its rows from HBM
// into registers, row groups of lanes doing an online-softmax update on
// every lane for every row and head: its longest sequences set the tail, its loads did not overlap its math, and it reached
// 0.39 of the byte bound. So:
// - The context splits over blocks in fixed units of split_rows rows (the
//   launcher's k1_split_rows: 512 at the serve batches of 64 and 16):
//   grid (split, kv head x 16-head tile x column slice, sequence), so the
//   (sequence, split) items of a batch of ragged contexts balance over the
//   132 SMs. The splits merge in merge_splits
//   (decode_rows.cuh), a second launch with fixed loops: two launches give
//   the same bits.
// - K and V rows of the block's kv head reach shared memory through a
//   cp.async ring (3 stages of 64 rows at D <= 128, 32 rows above), the
//   split's pool rows computed once; tile t + stages - 1 loads while tile t
//   is computed. Rows are an odd number of 16-byte chunks (conflict-free
//   ldmatrix); rows past the context are zero-filled. Int8 codes land raw
//   with their row scales and become bf16 fragments in registers (exact:
//   |code| <= 127).
// - S = Q . K^T and P . V by mma.sync m16n8k16, bf16 in, f32 sums: the G
//   heads zero-padded to 16 rows (G > 16 in tiles of 16 over blocks), Q
//   staged once in shared memory and read by ldmatrix. Warp w takes rows 16 w
//   .. 16 w + 15 of every stage with a softmax state of its own (exp2, the
//   scale folded into log2(e) / sqrt(D)), so each probability is formed once;
//   the warps' states merge in the freed ring at the end. P is split into
//   bf16 hi + lo (two products), so the probabilities stay f32-exact under
//   TOL["bf16"]: one rounding of P leaves it. Int8: the K scale multiplies
//   S's columns, the V scale P after l took it.
// - Head dims past 256: a block holds the output columns of one slice of D /
//   2 (an accumulator of 128 registers a thread at 512), the column slices
//   over blocks: each reads the kv head's whole K rows and its slice of V.
// f32 queries (f32 or int8 pools: the f32 parity phases and the checks)
// keep an FMA body (paged_decode_kernel): one block per (kv head, sequence,
// head sub-group), the K/V rows read straight into registers by row groups
// of lanes (16 bytes a lane, 8 int8 values; past a RowVec a lane, D / 32
// values in 4- to 16-byte pieces, LaneVec), kUnroll rows in flight; a block
// holds head_subgroup(G, cap) query heads, the cap keeping a lane's query,
// accumulator and in-flight row registers under 255 (8 heads up to D 256, 4
// at 384, 3 at 512), the rest of G over a third grid dimension.
//
// K3a design. Its function is K1's over the same unfolded memory, so bf16
// queries over bf16 or int8 pools at a head dim that is a multiple of 16
// below 128 (TinyLlama's 64) run K1's body above, paged_decode_tc<TK, D>,
// with K1's split rows. (A body of K3a's own, which staged several kv heads'
// rows a block with a warp a kv head, was slower at TinyLlama's shape than
// K1's body on an H100, and went.) f32 queries (f32 or int8 pools: the f32
// parity phases and the checks), and bf16 queries at the head dims K1's
// body does not take (D 136..504, and any D that is no multiple of 16: rows
// that start off 16 bytes, as D 100 over 2 kv heads, which the reference
// runs in plain XLA, or D 20 over 4), take an FMA body in the same split
// partition: block (split, kv head, sequence), a warp a query head, a lane
// a row for the score and up to 16 output columns for P . V (D below 512),
// rows read an element at a time. Every shuffle loop has a warp-uniform
// trip count.
//
// Past head_dim 512 (K1 in every mix and K3a, and K4a, K4b and K7c, whose
// launchers route here): one runtime-D body, right and simple rather than
// fast (its times stand in PERF.md), two passes and merge_splits over splits
// of whole pages. wide_scores: warp w scores the kv head's query heads w, w
// + 4, .. against lane j's row, over D an element at a time (no compiled
// cap), into global scratch, then each page's max. wide_pv: each block owns
// a column slice of 512 (16 a lane) over the grid's y dimension and
// recomputes the split's weights: page i's rounding point M_i is the prefix
// max of the page maxima through the end of its unit of unit_pages pages, M
// the split's last page's, and row j weighs e^(M_i - M) R(e^(s - M_i)), R the
// variant's rounding (none for K1 and K3a; bf16 at each page for K4b and K7c,
// at a unit of C pages for K4a: where their TPU kernels round). At f32 P this
// is K1's function with another max; the rounded sums are K4b's split
// algebra (decode_variants.cu) a row at a time.

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

// ---------------------------------------------------------------- K1, f32 queries

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

// Int8: two codes as a bf16 pair (exact: |code| <= 127).
__device__ __forceinline__ uint32_t codes_bf16(int lo, int hi) { return dtt::pack_bf16((float)lo, (float)hi); }

// ---------------------------------------------------------------- K1, bf16 queries

// A K1 tensor-core launch's shapes (host-computed).
struct SplitArgs {
  int Hkv, G, page_size, max_pages, split_rows, n_split;
  int n_ht;          // 16-head tiles of a kv head, ceil(G / 16)
  float scale_log2;  // log2(e) / sqrt(D)
};

// paged_decode_tc's layout at head dim D (a multiple of 16; bytes).
template <typename TK, int D>
struct SplitTc {
  static constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  static constexpr int kRows = D <= 128 ? 64 : 32;  // context rows a ring stage
  static constexpr int kWarps = kRows / 16;         // warp w: rows 16 w .. 16 w + 15 of each stage
  static constexpr int DO = D <= 256 ? D : D / 2;   // output columns a block (a column slice)
  static constexpr int kSlices = D / DO;
  static constexpr int kQRow = (D / 8 + 1) * 16;  // an odd number of 16-byte chunks: conflict-free ldmatrix
  // int8 raw rows 16 bytes past the codes, so consecutive rows fall 4 banks
  // apart for the fragment reads
  static constexpr int kKRow = kQuant ? D + 16 : (D / 8 + 1) * 16;
  static constexpr int kVRow = kQuant ? DO + 16 : (DO / 8 + 1) * 16;
  static constexpr int kStage = kRows * (kKRow + kVRow) + (kQuant ? 2 * kRows * 4 : 0);  // K, V, (scales)
  static constexpr int kStages = 3 * kStage <= 112 * 1024 ? 3 : 2;
  static constexpr int kMerge = kWarps * 16 * (DO + 2) * 4;  // the warps' states, merged in the ring
  static constexpr int kRing = kStages * kStage > kMerge ? kStages * kStage : kMerge;
  static constexpr int kQBytes = 16 * kQRow;
  static size_t smem(int split_rows) { return (size_t)kRing + kQBytes + (size_t)split_rows * 4; }
};

// Block (split, (kv head, 16-head tile ht, column slice cs), sequence): the
// split's rows [r0, r1) of the heads 16 ht .. 16 ht + Gt - 1 of kv head kvh,
// output columns cs * DO .. cs * DO + DO - 1. Writes (M in log2 units, l,
// acc) of each head to the partials merge_splits reads.
template <typename TK, int D>
__global__ void __launch_bounds__(32 * SplitTc<TK, D>::kWarps, 1)
paged_decode_tc(const __nv_bfloat16* __restrict__ q, const TK* __restrict__ k_pool,
                const TK* __restrict__ v_pool, const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, const int* __restrict__ page_tables,
                const int* __restrict__ positions, float* __restrict__ m_part, float* __restrict__ l_part,
                float* __restrict__ acc_part, const SplitArgs f) {
  using L = SplitTc<TK, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr int DO = L::DO;
  constexpr int KS = D / 16;    // k-steps of Q . K^T
  constexpr int NB = DO / 8;    // 8-column blocks of the block's output slice
  constexpr int kThr = 32 * L::kWarps;
  constexpr int EPC = 16 / sizeof(TK);              // pool values a 16-byte chunk
  constexpr int KC = D / EPC, VC = DO / EPC;         // chunks of a K row, of a V slice row
  static_assert(D % 16 == 0 && NB % 2 == 0, "unsupported head_dim");
  extern __shared__ __align__(16) uint8_t smem[];

  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int cs = blockIdx.y % L::kSlices;
  const int ht = (blockIdx.y / L::kSlices) % f.n_ht;
  const int kvh = blockIdx.y / (L::kSlices * f.n_ht);
  const int ctx = decode_ctx(positions, b, f.max_pages * f.page_size);
  const int r0 = split * f.split_rows;
  if (r0 >= ctx) return;  // block-uniform: this split holds no context
  const int r1 = min(r0 + f.split_rows, ctx);
  const int Gt = min(16, f.G - 16 * ht);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int Hq = f.Hkv * f.G;
  const size_t head0 = (size_t)b * Hq + (size_t)kvh * f.G + 16 * ht;
  const size_t token_stride = (size_t)f.Hkv * D;
  const size_t kcol = (size_t)kvh * D;
  const size_t vcol = kcol + (size_t)cs * DO;

  uint8_t* ring = smem;
  uint8_t* sq = smem + L::kRing;                             // [16][kQRow] bf16, head rows past Gt zero
  int* tok = reinterpret_cast<int*>(sq + L::kQBytes);        // [split_rows] the split's pool rows
  const int* pt = page_tables + (size_t)b * f.max_pages;
  for (int j = r0 + threadIdx.x; j < r1; j += kThr) tok[j - r0] = (int)dtt::token_row(pt, j, f.page_size);
  for (int idx = threadIdx.x; idx < 16 * (D / 8); idx += kThr) {
    const int h = idx / (D / 8);
    const int c = idx % (D / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (h < Gt) x = *reinterpret_cast<const uint4*>(q + (head0 + h) * D + c * 8);
    *reinterpret_cast<uint4*>(sq + h * L::kQRow + c * 16) = x;
  }
  __syncthreads();

  // cp.async copies of the split's rows [t0, t0 + kRows) into a stage: K
  // rows, V slice rows, then (int8) the K and V row scales; rows at or past
  // r1 zero-filled
  const int n_tiles = (r1 - r0 + L::kRows - 1) / L::kRows;
  auto start = [&](int ti) {
    const uint32_t s = dtt::smem_u32(ring + (ti % L::kStages) * L::kStage);
    const int t0 = r0 + ti * L::kRows;
    for (int idx = threadIdx.x; idx < L::kRows * (KC + VC); idx += kThr) {
      const int r = idx / (KC + VC);
      const int c = idx % (KC + VC);
      const int j = t0 + r;
      const bool ok = j < r1;
      const size_t row = ok ? (size_t)tok[j - r0] * token_stride : 0;
      if (c < KC) {
        dtt::cp_async16(s + r * L::kKRow + c * 16, k_pool + row + kcol + c * EPC, ok);
      } else {
        dtt::cp_async16(s + L::kRows * L::kKRow + r * L::kVRow + (c - KC) * 16, v_pool + row + vcol + (c - KC) * EPC,
                        ok);
      }
    }
    if constexpr (kQuant) {
      for (int idx = threadIdx.x; idx < 2 * L::kRows; idx += kThr) {
        const int r = idx % L::kRows;
        const int j = t0 + r;
        const bool ok = j < r1;
        const float* src = idx < L::kRows ? k_scale : v_scale;
        dtt::cp_async4(s + L::kRows * (L::kKRow + L::kVRow) + idx * 4, src + (ok ? tok[j - r0] : 0), ok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < L::kStages - 1; ++st) {
    if (st < n_tiles) start(st);
    dtt::cp_async_commit();
  }

  float m[2] = {dtt::kNegInf, dtt::kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // Q's A fragment of k-step ks: rows lane % 16, column chunk 2 ks + lane / 16
  const uint32_t q_addr = dtt::smem_u32(sq) + (lane & 15) * L::kQRow + (lane >> 4) * 16;

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int nxt = ti + L::kStages - 1;
    if (nxt < n_tiles) start(nxt);
    dtt::cp_async_commit();
    dtt::cp_async_wait<L::kStages - 1>();
    __syncthreads();
    const uint8_t* st = ring + (ti % L::kStages) * L::kStage;
    const int lo = r0 + ti * L::kRows + 16 * warp;  // this warp's first row
    if (lo < r1) {  // warp-uniform
      const uint32_t kt = dtt::smem_u32(st) + 16 * warp * L::kKRow;
      const uint32_t vt = dtt::smem_u32(st) + L::kRows * L::kKRow + 16 * warp * L::kVRow;
      const int8_t* kc = reinterpret_cast<const int8_t*>(st) + 16 * warp * L::kKRow;
      const int8_t* vc = reinterpret_cast<const int8_t*>(st) + L::kRows * L::kKRow + 16 * warp * L::kVRow;
      const float* sKs = reinterpret_cast<const float*>(st + L::kRows * (L::kKRow + L::kVRow)) + 16 * warp;
      const float* sVs = sKs + L::kRows;
      // S = Q . K^T over the warp's 16 rows (two blocks of 8)
      float s[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        dtt::ldsm_x4(a, q_addr + ks * 32);
        if constexpr (kQuant) {
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            const int8_t* r = kc + (nb * 8 + g) * L::kKRow + 16 * ks + 2 * t;
            const char2 x = *reinterpret_cast<const char2*>(r);
            const char2 y = *reinterpret_cast<const char2*>(r + 8);
            dtt::mma_bf16_16816(s[nb], a, codes_bf16(x.x, x.y), codes_bf16(y.x, y.y));
          }
        } else {
          // matrices: rows 0-7 / 8-15 of the warp's rows (lane / 16) x column
          // chunks 2 ks, 2 ks + 1 ((lane / 8) % 2)
          uint32_t bk[4];
          dtt::ldsm_x4(bk, kt + ((lane >> 4) * 8 + (lane & 7)) * L::kKRow + ks * 32 + ((lane >> 3) & 1) * 16);
          dtt::mma_bf16_16816(s[0], a, bk[0], bk[1]);
          dtt::mma_bf16_16816(s[1], a, bk[2], bk[3]);
        }
      }
      // online softmax; s[nb][i] is (head row g + 8 (i / 2), row lo + 8 nb + 2t + i % 2)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = nb * 8 + 2 * t + (i & 1);
          float v = s[nb][i] * f.scale_log2;
          if constexpr (kQuant) v *= sKs[r];
          if (lo + r >= r1) v = dtt::kNegInf;
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
      uint32_t ph[2][2], pl[2][2];  // P split into bf16 hi and lo: (block nb, head row g / g + 8)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
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
      // O += P_hi . V + P_lo . V over the warp's 16 rows, two 8-column blocks a step
      const uint32_t ah[4] = {ph[0][0], ph[0][1], ph[1][0], ph[1][1]};
      const uint32_t al[4] = {pl[0][0], pl[0][1], pl[1][0], pl[1][1]};
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bv[4];
        if constexpr (kQuant) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int8_t* c = vc + 2 * t * L::kVRow + 8 * (n + j) + g;
            bv[2 * j] = codes_bf16(c[0], c[L::kVRow]);
            bv[2 * j + 1] = codes_bf16(c[8 * L::kVRow], c[9 * L::kVRow]);
          }
        } else {
          dtt::ldsm_x4_trans(bv, vt + (lane & 15) * L::kVRow + (n + (lane >> 4)) * 16);
        }
        dtt::mma_bf16_16816(acc[n], ah, bv[0], bv[1]);
        dtt::mma_bf16_16816(acc[n], al, bv[0], bv[1]);
        dtt::mma_bf16_16816(acc[n + 1], ah, bv[2], bv[3]);
        dtt::mma_bf16_16816(acc[n + 1], al, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // merge the warps' states in the freed ring, in a fixed order
  dtt::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* red_m = reinterpret_cast<float*>(ring);  // [kWarps][16]
  float* red_l = red_m + L::kWarps * 16;          // [kWarps][16]
  float* red_acc = red_l + L::kWarps * 16;        // [kWarps][16][DO]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if (t == 0) {
      red_m[warp * 16 + row] = m[h];
      red_l[warp * 16 + row] = l[h];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(red_acc + (warp * 16 + row) * DO + n * 8 + 2 * t) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
  __syncthreads();
  const size_t part = (size_t)b * f.n_split + split;
  for (int idx = threadIdx.x; idx < Gt * DO; idx += kThr) {
    const int row = idx / DO;
    const int d = idx % DO;
    float M = dtt::kNegInf;
#pragma unroll
    for (int w = 0; w < L::kWarps; ++w) M = fmaxf(M, red_m[w * 16 + row]);
    float A = 0.f, Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < L::kWarps; ++w) {
      const float wt = exp2f(red_m[w * 16 + row] - M);
      A = fmaf(red_acc[(w * 16 + row) * DO + d], wt, A);
      Lsum = fmaf(red_l[w * 16 + row], wt, Lsum);
    }
    const size_t hq = part * Hq + (size_t)kvh * f.G + 16 * ht + row;
    acc_part[hq * D + (size_t)cs * DO + d] = A;
    if (cs == 0 && d == 0) {
      m_part[hq] = M;
      l_part[hq] = Lsum;
    }
  }
}

// ---------------------------------------------------------------- K3a

constexpr int kFoldFmaWarps = 4;
constexpr int kFoldMaxD = 512;  // the FMA body's head dims: below this

// A K3a launch's shapes (host-computed).
struct FoldArgs {
  int Hkv, G, D, page_size, max_pages, split_rows, n_split;
  float scale_log2;  // log2(e) / sqrt(D)
};

// The FMA body: f32 queries over f32 or int8 pools, and bf16 queries at
// the head dims K1's tensor-core body does not take (no multiple of 16, or
// above 128; below 512), over bf16 or int8 pools. Block (split, kv head, sequence);
// warp w takes the kv head's query heads w, w + 4, ...; lane j scores row j
// of each 32-row step against the head's query (in shared memory) and owns
// output columns lane + 32 i. Rows are read an element at a time, so a row
// may start at any offset (D 100 over 2 kv heads, D 20 over 4).
template <typename TQ, typename TK, int kCols>
__global__ void __launch_bounds__(32 * kFoldFmaWarps)
folded_decode_fma(const TQ* __restrict__ q, const TK* __restrict__ k_pool, const TK* __restrict__ v_pool,
                  const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                  const int* __restrict__ page_tables, const int* __restrict__ positions,
                  float* __restrict__ m_part, float* __restrict__ l_part, float* __restrict__ acc_part,
                  const FoldArgs f) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  static_assert(32 * kCols <= kFoldMaxD, "kCols output columns a lane: D <= 32 kCols");
  __shared__ float sq[kFoldFmaWarps][32 * kCols];
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

// ---------------------------------------------------------------- head dims past 512

constexpr int kWideWarps = 4;
constexpr int kWideCols = 16;                 // output columns a lane
constexpr int kWideSlice = 32 * kWideCols;    // a block's column slice

// A wide launch's shapes (host-computed).
struct WideArgs {
  int Hkv, G, D, page_size, max_pages, split_rows, n_split, s_pad, n_cs;
  int unit_pages;  // the rounding unit in pages (K4a: chunk_pages; K4b, K7c: 1; K1, K3a: 1, nothing rounded)
  float scale;     // 1 / sqrt(D): natural units, as the plain versions
};

// Pass 1: block (split of whole pages, kv head, sequence); warp w takes the
// kv head's query heads w, w + 4, ...; lane j scores row j of each 32-row
// step over all D columns, an element at a time (rows at any offset), s = q
// . k / sqrt(D) (int8: times the row's K scale), into scores [B, Hq, s_pad];
// then each page's max over the split to pmax [B, Hq, max_pages].
template <typename TQ, typename TK>
__global__ void __launch_bounds__(32 * kWideWarps)
wide_scores(const TQ* __restrict__ q, const TK* __restrict__ k_pool, const float* __restrict__ k_scale,
            const int* __restrict__ page_tables, const int* __restrict__ positions, float* __restrict__ scores,
            float* __restrict__ pmax, const WideArgs f) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int ctx = decode_ctx(positions, b, f.max_pages * f.page_size);
  const int r0 = split * f.split_rows;
  if (r0 >= ctx) return;  // block-uniform: this split holds no context
  const int r1 = min(r0 + f.split_rows, ctx);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t token_stride = (size_t)f.Hkv * f.D;
  const int* pt = page_tables + (size_t)b * f.max_pages;
  for (int h = warp; h < f.G; h += kWideWarps) {  // warp-uniform
    const size_t hq = ((size_t)b * f.Hkv + kvh) * f.G + h;
    const TQ* qr = q + hq * f.D;
    float* srow = scores + hq * f.s_pad;
    for (int j = r0 + lane; j < r1; j += 32) {
      const size_t tk = dtt::token_row(pt, j, f.page_size);
      const TK* kr = k_pool + tk * token_stride + (size_t)kvh * f.D;
      float dot = 0.f;
      for (int d = 0; d < f.D; ++d) dot = fmaf(dtt::to_f(qr[d]), dtt::to_f(kr[d]), dot);
      float sc = dot * f.scale;
      if constexpr (std::is_same<TK, int8_t>::value) sc *= k_scale[tk];
      srow[j] = sc;
    }
    __syncwarp();  // the lanes' scores are visible to the warp
    for (int p = r0 / f.page_size; p * f.page_size < r1; ++p) {  // warp-uniform
      float mx = dtt::kNegInf;
      for (int j = p * f.page_size + lane; j < min((p + 1) * f.page_size, r1); j += 32) mx = fmaxf(mx, srow[j]);
      mx = dtt::warp_max(mx);
      if (lane == 0) pmax[hq * f.max_pages + p] = mx;
    }
  }
}

// Pass 2: block (split, kv head x column slice, sequence); warp w takes
// heads w, w + 4, ...: page i's rounding point M_i is the max of the page
// maxima through the last page of its unit of unit_pages pages (clipped to
// the context; an inclusive scan into shared memory), M the split's last
// page's. Lane j weighs row j of each 32-row step by e^(M_i - M) R(e^(s -
// M_i)), R rounding to bf16 (kRound: K4a, K4b, K7c over bf16 pools, where
// their TPU kernels round) or none, int8 rows times their V scale, after l
// took e^(M_i - M) e^(s - M_i); every lane folds the step's rows into its 16
// columns of the slice, rows read an element at a time. Writes (M in log2
// units, l, acc of the slice) to the partials merge_splits reads.
template <typename TK, bool kRound>
__global__ void __launch_bounds__(32 * kWideWarps)
wide_pv(const TK* __restrict__ v_pool, const float* __restrict__ v_scale, const int* __restrict__ page_tables,
        const int* __restrict__ positions, const float* __restrict__ scores, const float* __restrict__ pmax,
        float* __restrict__ m_part, float* __restrict__ l_part, float* __restrict__ acc_part, const WideArgs f) {
  extern __shared__ float wide_smem[];  // [kWideWarps][split pages + unit_pages]: the rounding points
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / f.n_cs;
  const int c0 = blockIdx.y % f.n_cs * kWideSlice;
  const int b = blockIdx.z;
  const int ps = f.page_size;
  const int ctx = decode_ctx(positions, b, f.max_pages * ps);
  const int r0 = split * f.split_rows;
  if (r0 >= ctx) return;
  const int r1 = min(r0 + f.split_rows, ctx);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int U = f.unit_pages;
  const int npc = (ctx + ps - 1) / ps;  // the context's pages
  const int p0 = r0 / ps;
  const int ns = min(((r1 - 1) / ps / U + 1) * U, npc) - p0;  // pages through the end of the last page's unit
  float* sM = wide_smem + warp * (f.split_rows / ps + U);
  const size_t token_stride = (size_t)f.Hkv * f.D;
  const int* pt = page_tables + (size_t)b * f.max_pages;
  for (int h = warp; h < f.G; h += kWideWarps) {  // warp-uniform
    const size_t hq = ((size_t)b * f.Hkv + kvh) * f.G + h;
    const float* pm = pmax + hq * f.max_pages;
    float run = dtt::kNegInf;  // the max before the split
    for (int p = lane; p < p0; p += 32) run = fmaxf(run, pm[p]);
    run = dtt::warp_max(run);
    for (int i0 = 0; i0 < ns; i0 += 32) {  // warp-uniform: inclusive max-scans, 32 pages a step
      float v = i0 + lane < ns ? pm[p0 + i0 + lane] : dtt::kNegInf;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v = fmaxf(v, u);
      }
      v = fmaxf(v, run);
      if (i0 + lane < ns) sM[i0 + lane] = v;
      run = __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();
    const float M = sM[ns - 1];
    const float* srow = scores + hq * f.s_pad;
    float l = 0.f, acc[kWideCols] = {};
    for (int j0 = r0; j0 < r1; j0 += 32) {  // warp-uniform
      const int j = j0 + lane;
      float c = 0.f;
      long long tk = 0;
      if (j < r1) {
        const int p = j / ps;
        const float Mi = sM[min((p / U + 1) * U, npc) - 1 - p0];
        const float e = expf(srow[j] - Mi);
        const float w = expf(Mi - M);
        l = fmaf(w, e, l);
        c = w * (kRound ? __bfloat162float(__float2bfloat16_rn(e)) : e);
        tk = (long long)dtt::token_row(pt, j, ps);
        if constexpr (std::is_same<TK, int8_t>::value) c *= v_scale[tk];
      }
      const int n = min(32, r1 - j0);
      for (int r = 0; r < n; ++r) {  // warp-uniform
        const float cr = __shfl_sync(0xffffffffu, c, r);
        const long long tr = __shfl_sync(0xffffffffu, tk, r);
        const TK* vr = v_pool + tr * token_stride + (size_t)kvh * f.D + c0;
#pragma unroll
        for (int i = 0; i < kWideCols; ++i) {
          const int d = lane + 32 * i;
          if (c0 + d < f.D) acc[i] = fmaf(cr, dtt::to_f(vr[d]), acc[i]);
        }
      }
    }
    l = dtt::warp_sum(l);
    const size_t part = ((size_t)b * f.n_split + split) * f.Hkv * f.G + (size_t)kvh * f.G + h;
    if (lane == 0 && c0 == 0) {
      m_part[part] = M * 1.4426950408889634f;  // merge_splits takes log2 units
      l_part[part] = l;
    }
#pragma unroll
    for (int i = 0; i < kWideCols; ++i) {
      const int d = lane + 32 * i;
      if (c0 + d < f.D) acc_part[part * f.D + c0 + d] = acc[i];
    }
    __syncwarp();  // sM is rewritten for the warp's next head
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

// K1's f32-query body at head dim D, head sub-groups of SG.
template <typename TK, int D>
struct K1Fma {
  template <int SG>
  struct Launch {
    static int run(const DecodeArgs& a) {
      const int G = a.Hq / a.Hkv;
      paged_decode_kernel<float, TK, D, SG><<<dim3(a.Hkv, a.B, G / SG), kThreads, 0, a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks, a.vs,
          a.pt, a.pos, static_cast<float*>(a.out), a.Hkv, G, a.ps, a.max_pages, 1.0f / sqrtf((float)D));
      return (int)cudaGetLastError();
    }
  };
  static int run(const DecodeArgs& a) {
    constexpr int kCap = dtt::subgroup_cap(dtt::LaneVec<TK, D>::N);
    return dtt::with_head_subgroup<kCap, Launch>(a.Hq / a.Hkv, a);
  }
};

// K1's tensor-core body and the merge.
template <typename TK, int D>
int launch_split_tc(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
  using L = SplitTc<TK, D>;
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  const size_t smem = L::smem(split_rows);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const cudaError_t err = dtt::raise_smem_limit_once(paged_decode_tc<TK, D>, smem_raised, 227 * 1024);
  if (err != cudaSuccess) return (int)err;
  const int G = a.Hq / a.Hkv;
  const SplitArgs f{a.Hkv, G, a.ps, a.max_pages, split_rows, n_split, (G + 15) / 16,
                    1.4426950408889634f / sqrtf((float)D)};
  paged_decode_tc<TK, D><<<dim3(n_split, a.Hkv * f.n_ht * L::kSlices, a.B), 32 * L::kWarps, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks, a.vs,
      a.pt, a.pos, m, l, acc, f);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  return dtt::launch_merge_splits(m, l, acc, a.pos, static_cast<__nv_bfloat16*>(a.out), a.B, a.Hq, a.D,
                                  a.max_pages * a.ps, split_rows, n_split, a.stream);
}

// f32 queries take the FMA body, bf16 queries the tensor-core split body
template <typename TQ, typename TK>
struct K1Types {
  template <int D>
  static int at(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
    if constexpr (std::is_same<TQ, float>::value) {
      return K1Fma<TK, D>::run(a);
    } else {
      return launch_split_tc<TK, D>(a, m, l, acc, split_rows, n_split);
    }
  }
  static int run(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
    switch (a.D) {
      case 64: return at<64>(a, m, l, acc, split_rows, n_split);
      case 128: return at<128>(a, m, l, acc, split_rows, n_split);
      case 256: return at<256>(a, m, l, acc, split_rows, n_split);
      case 384: return at<384>(a, m, l, acc, split_rows, n_split);
      case 512: return at<512>(a, m, l, acc, split_rows, n_split);
      default: return (int)cudaErrorInvalidValue;
    }
  }
};

template <typename TQ>
int launch_merge(const DecodeArgs& a, const float* m, const float* l, const float* acc, int split_rows,
                 int n_split) {
  return dtt::launch_merge_splits(m, l, acc, a.pos, static_cast<TQ*>(a.out), a.B, a.Hq, a.D, a.max_pages * a.ps,
                                  split_rows, n_split, a.stream);
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
  const dim3 grid(n_split, a.Hkv, a.B);
  const auto* q = static_cast<const TQ*>(a.q);
  const auto* k = static_cast<const TK*>(a.k);
  const auto* v = static_cast<const TK*>(a.v);
  if (a.D <= 256) {  // 8 output columns a lane, 16 past 256
    folded_decode_fma<TQ, TK, 8><<<grid, 32 * kFoldFmaWarps, 0, a.stream>>>(q, k, v, a.ks, a.vs, a.pt, a.pos, m, l,
                                                                            acc, f);
  } else {
    folded_decode_fma<TQ, TK, 16><<<grid, 32 * kFoldFmaWarps, 0, a.stream>>>(q, k, v, a.ks, a.vs, a.pt, a.pos, m,
                                                                             l, acc, f);
  }
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  return launch_merge<TQ>(a, m, l, acc, split_rows, n_split);
}

// The wide body's scratch: scores [B, Hq, s_pad], page maxima [B, Hq,
// max_pages] and the partials.
struct WideBufs {
  float *scores, *pmax, *m, *l, *acc;
  int split_rows, n_split, s_pad, unit_pages;
  bool round;
};

// Past head_dim 512, every mix and variant: wide_scores, wide_pv, the merge.
template <typename TQ, typename TK>
struct WideTypes {
  static int run(const DecodeArgs& a, const WideBufs& w) {
    const WideArgs f{a.Hkv, a.Hq / a.Hkv, a.D, a.ps, a.max_pages, w.split_rows, w.n_split, w.s_pad,
                     (a.D + kWideSlice - 1) / kWideSlice, w.unit_pages, (float)(1.0 / sqrt((double)a.D))};
    const dim3 grid(w.n_split, a.Hkv, a.B);
    wide_scores<TQ, TK><<<grid, 32 * kWideWarps, 0, a.stream>>>(static_cast<const TQ*>(a.q),
                                                                 static_cast<const TK*>(a.k), a.ks, a.pt, a.pos,
                                                                 w.scores, w.pmax, f);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)kWideWarps * (w.split_rows / a.ps + w.unit_pages) * sizeof(float);
    const dim3 grid2(w.n_split, a.Hkv * f.n_cs, a.B);
    const auto* v = static_cast<const TK*>(a.v);
    if constexpr (std::is_same<TK, __nv_bfloat16>::value) {
      if (w.round) {
        wide_pv<TK, true><<<grid2, 32 * kWideWarps, smem, a.stream>>>(v, a.vs, a.pt, a.pos, w.scores, w.pmax, w.m,
                                                                       w.l, w.acc, f);
      } else {
        wide_pv<TK, false><<<grid2, 32 * kWideWarps, smem, a.stream>>>(v, a.vs, a.pt, a.pos, w.scores, w.pmax, w.m,
                                                                        w.l, w.acc, f);
      }
    } else {
      wide_pv<TK, false><<<grid2, 32 * kWideWarps, smem, a.stream>>>(v, a.vs, a.pt, a.pos, w.scores, w.pmax, w.m,
                                                                      w.l, w.acc, f);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_merge<TQ>(a, w.m, w.l, w.acc, w.split_rows, w.n_split);
  }
};

// K3a's head dims on K1's tensor-core body: multiples of 16 below 128
template <typename TK>
int fold_tc_dim(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
  switch (a.D) {
    case 16: return launch_split_tc<TK, 16>(a, m, l, acc, split_rows, n_split);
    case 32: return launch_split_tc<TK, 32>(a, m, l, acc, split_rows, n_split);
    case 48: return launch_split_tc<TK, 48>(a, m, l, acc, split_rows, n_split);
    case 64: return launch_split_tc<TK, 64>(a, m, l, acc, split_rows, n_split);
    case 80: return launch_split_tc<TK, 80>(a, m, l, acc, split_rows, n_split);
    case 96: return launch_split_tc<TK, 96>(a, m, l, acc, split_rows, n_split);
    case 112: return launch_split_tc<TK, 112>(a, m, l, acc, split_rows, n_split);
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

// bf16 queries at a head dim that is a multiple of 16 below 128 take K1's
// tensor-core body; f32 queries, and bf16 queries at other head dims (no
// multiple of 16, or 136..504), the FMA body
template <typename TQ, typename TK>
struct K3aTypes {
  static int run(const DecodeArgs& a, float* m, float* l, float* acc, int split_rows, int n_split) {
    if constexpr (std::is_same<TQ, __nv_bfloat16>::value) {
      if (a.D % 16 == 0 && a.D < 128) return fold_tc_dim<TK>(a, m, l, acc, split_rows, n_split);
    }
    return launch_fold_fma<TQ, TK>(a, m, l, acc, split_rows, n_split);
  }
};

bool decode_shapes_ok(const DecodeArgs& a, int kv_dtype) {
  return a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.ps > 0 && a.max_pages > 0 &&
         (kv_dtype != 2 || (a.ks != nullptr && a.vs != nullptr));
}

}  // namespace

// K1: head_dim 64, 128, 256, 384 or 512 (the launcher sends larger
// multiples of 128 to paged_decode_attention_wide), any Hq a multiple of Hkv. bf16
// queries write split partials m_part, l_part [B, n_split, Hq] and acc_part
// [B, n_split, Hq, D] f32 (n_split >= ceil(max_pages * page_size /
// split_rows), split_rows a positive multiple of 64); f32 queries read none
// of them. Returns cudaGetLastError() after the launches (0 = launched);
// shapes the kernel does not take return cudaErrorInvalidValue without
// launching.
extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const void* page_tables, const void* positions, void* m_part,
                                      void* l_part, void* acc_part, void* out, int B, int Hq, int Hkv, int D,
                                      int page_size, int max_pages, int split_rows, int n_split,
                                      int q_dtype, int kv_dtype, void* stream) {
  const DecodeArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale), static_cast<const int*>(page_tables),
                     static_cast<const int*>(positions), out, B, Hq, Hkv, D, page_size, max_pages,
                     static_cast<cudaStream_t>(stream)};
  if (B <= 0) return 0;
  if (!decode_shapes_ok(a, kv_dtype)) return (int)cudaErrorInvalidValue;
  if (q_dtype == 1 && (split_rows <= 0 || split_rows % 64 ||
                       (long long)n_split * split_rows < (long long)max_pages * page_size))
    return (int)cudaErrorInvalidValue;
  return with_types<K1Types>(q_dtype, kv_dtype, a, static_cast<float*>(m_part), static_cast<float*>(l_part),
                             static_cast<float*>(acc_part), split_rows, n_split);
}

// K3a: head_dim 0 < D < 512 (the launcher sends larger ones to
// paged_decode_attention_wide), any Hq a multiple of Hkv.
// Partial buffers m_part, l_part [B, n_split, Hq] and acc_part [B, n_split,
// Hq, D] f32, n_split >= ceil(max_pages * page_size / split_rows),
// split_rows a positive multiple of 64.
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
      split_rows % 64 || (long long)n_split * split_rows < (long long)max_pages * page_size)
    return (int)cudaErrorInvalidValue;
  return with_types<K3aTypes>(q_dtype, kv_dtype, a, static_cast<float*>(m_part),
                              static_cast<float*>(l_part), static_cast<float*>(acc_part),
                              split_rows, n_split);
}

// Past head_dim 512 (K1 and K4a, K4b, K7c at D % 128 == 0, K3a at any other
// D): scores [B, Hq, s_pad] and pmax [B, Hq, max_pages] scratch (s_pad >=
// max_pages * page_size), the partials as paged_decode_attention's, splits
// of split_rows rows (a multiple of page_size, n_split >= ceil(max_pages *
// page_size / split_rows)); unit_pages the rounding unit, round 1 to round
// the probabilities to bf16 over bf16 pools (K4a, K4b, K7c), 0 for f32
// probabilities (K1, K3a; and every f32 or int8 pool).
extern "C" int paged_decode_attention_wide(const void* q, const void* k_pool, const void* v_pool,
                                           const void* k_scale, const void* v_scale, const void* page_tables,
                                           const void* positions, void* scores, void* pmax, void* m_part,
                                           void* l_part, void* acc_part, void* out, int B, int Hq, int Hkv, int D,
                                           int page_size, int max_pages, int split_rows, int n_split, int s_pad,
                                           int unit_pages, int round, int q_dtype, int kv_dtype, void* stream) {
  const DecodeArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale), static_cast<const int*>(page_tables),
                     static_cast<const int*>(positions), out, B, Hq, Hkv, D, page_size, max_pages,
                     static_cast<cudaStream_t>(stream)};
  if (B <= 0) return 0;
  if (!decode_shapes_ok(a, kv_dtype) || D <= 0 || split_rows <= 0 || split_rows % page_size || unit_pages <= 0 ||
      (long long)s_pad < (long long)max_pages * page_size ||
      (long long)n_split * split_rows < (long long)max_pages * page_size)
    return (int)cudaErrorInvalidValue;
  const WideBufs w{static_cast<float*>(scores), static_cast<float*>(pmax), static_cast<float*>(m_part),
                   static_cast<float*>(l_part), static_cast<float*>(acc_part), split_rows, n_split, s_pad,
                   unit_pages, round != 0};
  return with_types<WideTypes>(q_dtype, kv_dtype, a, w);
}
