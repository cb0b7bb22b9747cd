// K4a, K4b, K7b and K7c: the decode variants of K1 for Hopper (sm_90a).
//
// K4a replaces dynamo_tpu/ops/pallas/paged_attention.py
// paged_decode_attention_pallas_chunked (_kernel_chunked): K1's function with
// the context walked in chunks of C * ps rows, C = max(1, min(max_pages,
// ceil(256 / ps))), on K4b's passes with a rounding unit of C pages. K4b replaces paged_decode_attention_pallas_grouped
// (_kernel_grouped): Gq sequences a program, one page an iteration, the
// probabilities rounded per page; see its design below. K7c
// replaces tools/profile_attn.py make_perseq_variant (_perseq_variant_kernel):
// the reference perseq kernel's one-page-an-iteration schedule with its f32
// casts toggled; each toggle computes a function another body here already
// computes, so the launcher routes it there (paged_attention.py): without
// cast_f32, K4b's launch at one page a unit (over f32 pools, where rounding
// is the identity, the chunk body below); with it, K1's. K7b replaces tools/profile_attn.py paged_decode_dmaonly
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
// The chunk body, K4a / K4b (and so K7c) over f32 pools (chunk_softmax_decode;
// the rounding is the identity there): one
// block per (sequence, kv head), K1's four warps and row groups of D / VEC
// lanes, so the G query heads of a GQA group share every K/V row the block
// loads. A 256-row chunk of bf16 K and V at D 128 is 128 KB, 256 KB
// double-buffered: more than the 227 KB a block can have, so a chunk is never
// staged whole. Per chunk: (1) the row groups stream its K rows from HBM into
// registers, kUnroll rows in flight, and write the G heads' scores to shared
// memory (G x chunk rows f32, 8 KB at G 8 and 256 rows); (2) warp w takes
// heads w, w + 4: the chunk max, each probability once (one exp a (head,
// row), where K1 repeats its softmax update on every lane of a row group),
// the sum, and the probabilities back into shared memory; (3) the
// row groups rescale their accumulators once and stream the chunk's V rows
// into them. The row groups share the chunk's max, so at the end their
// accumulators merge by a plain sum (shuffles within a warp, shared memory
// across warps). The chunk boundary is the reference's: that is where the
// rounded probabilities take their running max. As in K1's f32 body, a
// block holds head_subgroup(G, cap) of the G query heads (8 up to D 256, 4
// at 384, 3 at 512), the rest of a larger G in blocks of their own along a
// third grid dimension.
//
// K4b and K4a over bf16 pools (grouped_scores, grouped_pv, merge_splits):
// an exact split over the context. The reference groups sequences per
// program (K4b) or walks chunks of C pages (K4a), TPU VMEM schedules; the
// function each computes fixes only where the probabilities are rounded:
// unit i's (one page for K4b, C pages for K4a) at the running max after
// that unit, M_i. So with M_n the sequence's last, out = sum_i e^(M_i - M_n)
// round(e^(s - M_i)) . V_i / sum_i e^(M_i - M_n) sum e^(s - M_i), and once
// the page maxima are known every page's share is independent: splits of
// whole pages differ from the sequential walk only in f32 summation order,
// and the context splits over blocks: a warp that walks a sequence's pages,
// three dependent phases a page, is latency bound (70 GB/s on an H100).
// - Pass 1, grouped_scores: block (split of whole pages, kv head x 16-head
//   tile, sequence). K rows through a cp.async ring of 64-row tiles; S = Q .
//   K^T by mma.sync m16n8k16 (bf16 in, f32 sums; the G heads zero-padded to
//   16 rows); the split's scores to global memory and one max a (page, head).
//   Scores and exponentials are in natural units, as in the plain version,
//   so that the f32 probabilities the kernel rounds differ from the plain
//   version's only by the dot products' summation order.
// - Pass 2, grouped_pv: the same blocks. Each forms the prefix maxima of
//   its pages and of the pages through the end of its last page's unit from
//   the page maxima (a warp scan over at most max_pages floats); a unit's
//   max is the max of its pages' maxima, so page p's rounding point is the
//   prefix max through the last page of p's unit. Splits need not fall on
//   unit edges. It streams its scores and V rows through the ring, and walks
//   its pages in order: at a page whose rounding point rose it rescales its
//   state, then P = round(e^(s - M_i)) in bf16 is exactly the function's
//   operand, so one bf16 mma.sync P . V is exact, and l takes the unrounded
//   values. A 16-row k-step that spans pages (page size not a multiple of
//   16) runs once a page with the other rows' P zero.
// - merge_splits (decode_rows.cuh) combines the splits' (M_end, l, acc),
//   M_end handed over in log2 units:
//   fixed loops, no atomics, so two launches give the same bits.
// f32 pools (the checks and the f32 parity phases) take chunk_softmax_decode
// at one unit a chunk: rounding to f32 is the identity.
//
// Head dims: 64, 128, 256, 384 and 512 (past 512 the launchers of K4a, K4b
// and K7c take the runtime-D body of paged_attention.cu, and K7b the twin
// below). The register-resident bodies give a
// lane D / 32 values past a RowVec a lane (LaneVec: f32 rows of 256 in two
// 16-byte loads, of 512 in four). Pass 1 holds the 16 head rows' query
// fragments in registers (128 at D 512); pass 2 holds an accumulator of D / 2
// registers a thread up to D 256 and, past it, one column slice of D / 2
// (128 registers at 512), the slices over blocks (each reads its slice of V
// and all of the split's scores).

// K7b design (decode_load_twin): K1's block, row groups and load_rows; each
// row group sums its K + V slices in f32, the row groups merge by shuffles
// and shared memory, and every query head of the kv head gets the sum. Past
// head_dim 512, decode_load_twin_wide: the runtime-D body's pages, each
// value read once, in column slices of 512 over the grid.

#include <algorithm>
#include <climits>

#include "decode_rows.cuh"

namespace {

using dtt::warp_max;
using dtt::warp_sum;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;
constexpr int kSmemBudget = 227 * 1024;  // the dynamic shared memory a block may have

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

// ---------------------------------------------------------------- f32 chunk body

size_t chunk_smem_bytes(int SG, int D, int chunk_rows) {
  return ((size_t)SG * chunk_rows + 3 * SG + (size_t)kWarps * SG * D) * sizeof(float);
}

// Block (kv head, sequence, sub-group): the SG query heads kvh * G +
// blockIdx.z * SG + g of the kv head's G.
template <int D, int SG>
__global__ void __launch_bounds__(kThreads)
chunk_softmax_decode(const float* __restrict__ q, const float* __restrict__ k_pool,
                     const float* __restrict__ v_pool, const int* __restrict__ page_tables,
                     const int* __restrict__ positions, float* __restrict__ out, int Hkv, int G,
                     int page_size, int max_pages, int chunk_rows, float scale) {
  using TQ = float;
  using TK = float;
  using RV = dtt::LaneVec<TK, D>;
  constexpr int VEC = RV::N;
  constexpr int LPR = D / VEC;  // lanes per K/V row
  static_assert(D % VEC == 0 && LPR <= 32 && 32 % LPR == 0, "unsupported head_dim");
  constexpr int RPW = 32 / LPR;        // row groups per warp
  constexpr int NROWS = kWarps * RPW;  // row groups per block

  extern __shared__ float smem[];
  float* s_p = smem;                   // [SG][chunk_rows]: scores, then probabilities
  float* s_m = s_p + SG * chunk_rows;  // [SG] running max
  float* s_l = s_m + SG;               // [SG] running sum
  float* s_corr = s_l + SG;            // [SG] this chunk's rescale
  float* red = s_corr + SG;            // [kWarps][SG][D] the final merge

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int Hq = Hkv * G;
  const size_t head0 = (size_t)b * Hq + kvh * G + blockIdx.z * SG;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPR;
  const int row = warp * RPW + lane / LPR;
  const int d0 = sub * VEC;
  const int col = kvh * D + d0;
  const size_t token_stride = (size_t)Hkv * D;

  float qf[SG][VEC];
  load_queries<TQ, SG, VEC>(qf, q, head0, D, d0);
  const int ctx = dtt::decode_ctx(positions, b, max_pages * page_size);
  const int* pt = page_tables + (size_t)b * max_pages;

  float acc[SG][VEC];
#pragma unroll
  for (int g = 0; g < SG; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  if (threadIdx.x < SG) {
    s_m[threadIdx.x] = dtt::kNegInf;
    s_l[threadIdx.x] = 0.f;
  }

  for (int c0 = 0; c0 < ctx; c0 += chunk_rows) {
    const int nv = min(chunk_rows, ctx - c0);  // the chunk's rows inside the context
    // (1) scores; the trip count is block-uniform (full-mask shuffles)
    for (int r0 = 0; r0 < nv; r0 += NROWS * kUnroll) {
      typename RV::Raw kr[kUnroll];
      bool valid[kUnroll];
      dtt::load_slices<TK, kUnroll, RV>(kr, valid, k_pool, pt, c0 + r0, row, NROWS, c0 + nv, page_size,
                                    token_stride, col);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[VEC], s[SG];
        dtt::to_float(kr[u], kf);
        dtt::head_scores<SG, VEC, LPR>(qf, kf, scale, s);
        if (valid[u] && sub == 0) {
#pragma unroll
          for (int g = 0; g < SG; ++g) s_p[g * chunk_rows + r0 + row + u * NROWS] = s[g];
        }
      }
    }
    __syncthreads();
    // (2) the chunk's max, probabilities and sum: warp w takes heads w, w + 4
    for (int g = warp; g < SG; g += kWarps) {
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
        sp[j] = p;
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
    for (int g = 0; g < SG; ++g) {
      const float corr = s_corr[g];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= corr;
    }
    for (int r0 = 0; r0 < nv; r0 += NROWS * kUnroll) {
      typename RV::Raw vr[kUnroll];
      bool valid[kUnroll];
      dtt::load_slices<TK, kUnroll, RV>(vr, valid, v_pool, pt, c0 + r0, row, NROWS, c0 + nv, page_size,
                                    token_stride, col);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!valid[u]) continue;
        float vf[VEC];
        dtt::to_float(vr[u], vf);
        const int j = r0 + row + u * NROWS;
#pragma unroll
        for (int g = 0; g < SG; ++g) {
          const float p = s_p[g * chunk_rows + j];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
        }
      }
    }
    __syncthreads();  // the next chunk's scores overwrite s_p
  }

  // merge the row groups: they share the block's max, so a plain sum
  sum_row_groups<LPR, SG * VEC>(&acc[0][0]);
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < SG; ++g)
#pragma unroll
      for (int i = 0; i < VEC; ++i) red[(warp * SG + g) * D + d0 + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < SG * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[(w * SG + g) * D + d];
    dtt::store1(out + (head0 + g) * D + d, a / fmaxf(s_l[g], 1e-20f));
  }
}

// ---------------------------------------------------------------- K4b

constexpr int kGrpTile = 64;        // context rows a ring stage
constexpr int kGrpStages = 3;
constexpr int kGrpSplitRows = 256;  // a split holds whole pages, about this many rows
constexpr int kScoreStride = kGrpTile + 8;  // pass 2's score tile row (floats): conflict-free float2 reads

// A K4b launch's shapes (host-computed).
struct GroupedArgs {
  int Hkv, G, page_size, max_pages, split_rows, n_split, n_ht, s_pad;
  int n_cs;        // pass 2's column slices (pass 1: 1)
  int unit_pages;  // the rounding unit: K4b 1 page, K4a chunk_pages(ps, max_pages)
  float scale;     // 1 / sqrt(D)
};

// Pass 1's and pass 2's shared memory: the ring, the split's pool rows, and
// pass 1's scores of the split (16 x split_rows f32) or pass 2's prefix
// maxima (16 x the pages through the end of the split's last unit).
template <int D>
struct GrpSmem {
  static constexpr int DO = D <= 256 ? D : D / 2;       // pass 2's output columns a block (a column slice)
  static constexpr int kSlices = D / DO;
  static constexpr int kRowBytes = (D / 8 + 1) * 16;    // an odd number of 16-byte chunks
  static constexpr int kVRowBytes = (DO / 8 + 1) * 16;  // pass 2's V slice rows
  static constexpr int kKTile = kGrpTile * kRowBytes;
  static constexpr int kVTile = kGrpTile * kVRowBytes;
  static constexpr int kScoreTile = 16 * kScoreStride * 4;
  static size_t scores(int split_rows) { return (size_t)kGrpStages * kKTile + split_rows * 4 + 16 * (split_rows + 4) * 4; }
  static size_t pv(int split_rows, int page_size, int unit_pages) {
    return (size_t)kGrpStages * (kVTile + kScoreTile) + split_rows * 4 +
           16 * ((split_rows + page_size - 1) / page_size + unit_pages + 1) * 4;
  }
};

// The block's item: kv head kvh, 16-head tile ht (heads ht * 16 .. of its G),
// Gt of those heads real, column slice cs (pass 2); the split's rows [r0,
// r1); npc, the pages of the sequence's context.
struct GrpBlock {
  int b, split, kvh, ht, cs, Gt, r0, r1, npc;
};

__device__ __forceinline__ bool grp_block(GrpBlock& k, const GroupedArgs& f, const int* positions) {
  k.split = blockIdx.x;
  k.cs = blockIdx.y % f.n_cs;
  k.kvh = blockIdx.y / f.n_cs / f.n_ht;
  k.ht = blockIdx.y / f.n_cs % f.n_ht;
  k.b = blockIdx.z;
  k.Gt = min(16, f.G - 16 * k.ht);
  const int ctx = dtt::decode_ctx(positions, k.b, f.max_pages * f.page_size);
  k.r0 = k.split * f.split_rows;
  k.r1 = min(k.r0 + f.split_rows, ctx);
  k.npc = (ctx + f.page_size - 1) / f.page_size;
  return k.r0 < ctx;
}

// The split's context rows' pool rows into tok[], then a barrier.
__device__ __forceinline__ void grp_rows(int* tok, const GrpBlock& k, const int* page_tables, const GroupedArgs& f) {
  const int* pt = page_tables + (size_t)k.b * f.max_pages;
  for (int j = k.r0 + threadIdx.x; j < k.r1; j += kThreads) tok[j - k.r0] = (int)dtt::token_row(pt, j, f.page_size);
  __syncthreads();
}

// cp.async copies of columns [col0, col0 + W) of context rows [t0, t0 +
// kGrpTile) of kv head kvh (rows at or past r1, and each row's pad chunk,
// zero-filled) into a tile of (W / 8 + 1) 16-byte chunks a row.
template <int D, int W = D>
__device__ __forceinline__ void grp_rows_tile(uint32_t dst, const __nv_bfloat16* __restrict__ pool, const int* tok,
                                              int t0, const GrpBlock& k, const GroupedArgs& f, int col0 = 0) {
  constexpr int RC = W / 8 + 1;
  for (int idx = threadIdx.x; idx < kGrpTile * RC; idx += kThreads) {
    const int r = idx / RC;
    const int c = idx % RC;
    const int j = t0 + r;
    const bool ok = j < k.r1 && c < W / 8;
    const size_t off = ok ? ((size_t)tok[j - k.r0] * f.Hkv + k.kvh) * D + col0 + c * 8 : 0;
    dtt::cp_async16(dst + idx * 16, pool + off, ok);
  }
}

// This warp's query fragments: the block's 16 head rows (zero past Gt) over D.
template <int D>
__device__ __forceinline__ void grp_queries(uint32_t (&qa)[D / 16][4], const __nv_bfloat16* __restrict__ q,
                                            const GrpBlock& k, const GroupedArgs& f) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t head0 = (size_t)k.b * f.Hkv * f.G + (size_t)k.kvh * f.G + 16 * k.ht;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = g + 8 * (i & 1);
      const int col = 16 * ks + 2 * t + 8 * (i >> 1);
      qa[ks][i] = h < k.Gt ? *reinterpret_cast<const uint32_t*>(q + (head0 + h) * D + col) : 0u;
    }
  }
}

// Pass 1: the split's scores s = q . k / sqrt(D) of its context
// rows to scores [B, Hq, s_pad] and each page's max over them to pmax [B,
// Hq, max_pages]. Warp w computes tile rows 16 w .. 16 w + 15.
template <int D>
__global__ void __launch_bounds__(kThreads)
grouped_scores(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
               const int* __restrict__ page_tables, const int* __restrict__ positions, float* __restrict__ scores,
               float* __restrict__ pmax, const GroupedArgs f) {
  using L = GrpSmem<D>;
  extern __shared__ __align__(16) uint8_t grp_smem[];
  GrpBlock k;
  if (!grp_block(k, f, positions)) return;  // block-uniform: this split holds no context
  int* tok = reinterpret_cast<int*>(grp_smem + kGrpStages * L::kKTile);
  float* sS = reinterpret_cast<float*>(tok + f.split_rows);  // [16][split_rows + 4]
  const int sstride = f.split_rows + 4;
  grp_rows(tok, k, page_tables, f);

  const int n_tiles = (k.r1 - k.r0 + kGrpTile - 1) / kGrpTile;
  const uint32_t ring = dtt::smem_u32(grp_smem);
#pragma unroll
  for (int st = 0; st < kGrpStages - 1; ++st) {
    if (st < n_tiles) grp_rows_tile<D>(ring + st * L::kKTile, k_pool, tok, k.r0 + st * kGrpTile, k, f);
    dtt::cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  uint32_t qa[D / 16][4];
  grp_queries<D>(qa, q, k, f);

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int nxt = ti + kGrpStages - 1;
    if (nxt < n_tiles)
      grp_rows_tile<D>(ring + (nxt % kGrpStages) * L::kKTile, k_pool, tok, k.r0 + nxt * kGrpTile, k, f);
    dtt::cp_async_commit();
    dtt::cp_async_wait<kGrpStages - 1>();
    __syncthreads();
    const uint32_t kt = ring + (ti % kGrpStages) * L::kKTile;
    const int base = ti * kGrpTile + warp * 16;  // split-relative row of this warp's first
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t b0, b1;
        dtt::ldsm_x2(b0, b1, kt + (warp * 16 + nb * 8 + (lane & 7)) * L::kRowBytes + ks * 32 + ((lane >> 3) & 1) * 16);
        dtt::mma_bf16_16816(s, qa[ks], b0, b1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = base + nb * 8 + 2 * t + (i & 1);
        if (k.r0 + r < k.r1) sS[(g + 8 * (i >> 1)) * sstride + r] = s[i] * f.scale;
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // page maxima: warp w takes (head, page) items w, w + 4, ...
  const int p0 = k.r0 / f.page_size;
  const int np = (k.r1 - k.r0 + f.page_size - 1) / f.page_size;
  const size_t head0 = (size_t)k.b * f.Hkv * f.G + (size_t)k.kvh * f.G + 16 * k.ht;
  for (int item = warp; item < k.Gt * np; item += kWarps) {
    const int h = item / np;
    const int p = item % np;
    const int lo = p * f.page_size;
    const int hi = min(lo + f.page_size, k.r1 - k.r0);
    float mx = dtt::kNegInf;
    for (int r = lo + lane; r < hi; r += 32) mx = fmaxf(mx, sS[h * sstride + r]);
    mx = warp_max(mx);
    if (lane == 0) pmax[(head0 + h) * f.max_pages + p0 + p] = mx;
  }
  for (int idx = threadIdx.x; idx < k.Gt * (k.r1 - k.r0); idx += kThreads) {
    const int h = idx / (k.r1 - k.r0);
    const int r = idx % (k.r1 - k.r0);
    scores[(head0 + h) * f.s_pad + k.r0 + r] = sS[h * sstride + r];
  }
}

// Pass 2: the split's pages in order, each at its unit's prefix max M_i (the
// max over every page through the end of the unit of unit_pages pages that
// holds it); warp w takes rows 16 w .. 16 w + 15 of every 64-row tile, so
// each probability is formed once, and the warps' states merge at the end.
// Writes (M of the split's last page, l, acc of its column slice) to the
// partials.
template <int D>
__global__ void __launch_bounds__(kThreads)
grouped_pv(const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ page_tables,
           const int* __restrict__ positions, const float* __restrict__ scores, const float* __restrict__ pmax,
           float* __restrict__ m_part, float* __restrict__ l_part, float* __restrict__ acc_part,
           const GroupedArgs f) {
  using L = GrpSmem<D>;
  constexpr int DO = L::DO;
  constexpr int NB = DO / 8;  // 8-column blocks of the block's output slice
  constexpr int kStage = L::kVTile + L::kScoreTile;
  static_assert(kGrpStages * kStage >= (2 + DO) * kWarps * 16 * 4, "the warps' merge reuses the ring");
  extern __shared__ __align__(16) uint8_t grp_smem[];
  GrpBlock k;
  if (!grp_block(k, f, positions)) return;
  int* tok = reinterpret_cast<int*>(grp_smem + kGrpStages * kStage);
  const int p0 = k.r0 / f.page_size;
  const int np = (k.r1 - k.r0 + f.page_size - 1) / f.page_size;
  const int U = f.unit_pages;
  // pages scanned: through the end of the unit of the split's last page, or
  // of the context; a split need not end on a unit's edge
  const int ns = min(((p0 + np - 1) / U + 1) * U, k.npc) - p0;
  float* sM = reinterpret_cast<float*>(tok + f.split_rows);  // [16][ns + 1]: M before the split, then through each page
  const int mstride = ns + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t head0 = (size_t)k.b * f.Hkv * f.G + (size_t)k.kvh * f.G + 16 * k.ht;

  grp_rows(tok, k, page_tables, f);
  const int n_tiles = (k.r1 - k.r0 + kGrpTile - 1) / kGrpTile;
  const uint32_t ring = dtt::smem_u32(grp_smem);
  auto start = [&](int ti) {
    const uint32_t st = ring + (ti % kGrpStages) * kStage;
    const int t0 = k.r0 + ti * kGrpTile;
    grp_rows_tile<D, DO>(st, v_pool, tok, t0, k, f, k.cs * DO);
    for (int idx = threadIdx.x; idx < 16 * kGrpTile; idx += kThreads) {
      const int h = idx / kGrpTile;
      const int r = idx % kGrpTile;
      const bool ok = h < k.Gt && t0 + r < k.r1;
      dtt::cp_async4(st + L::kVTile + (h * kScoreStride + r) * 4, scores + (ok ? (head0 + h) * f.s_pad + t0 + r : 0),
                     ok);
    }
  };
#pragma unroll
  for (int st = 0; st < kGrpStages - 1; ++st) {
    if (st < n_tiles) start(st);
    dtt::cp_async_commit();
  }

  // while the first tiles load: the prefix maxima. Warp w takes heads 4 w ..
  // 4 w + 3 together (their loads in flight at once); heads past Gt get 0.
  constexpr int HPW = 16 / kWarps;
  const int hw = warp * HPW;
  float run[HPW];
#pragma unroll
  for (int i = 0; i < HPW; ++i) run[i] = dtt::kNegInf;
  for (int p = lane; p < p0; p += 32) {
#pragma unroll
    for (int i = 0; i < HPW; ++i)
      if (hw + i < k.Gt) run[i] = fmaxf(run[i], pmax[(head0 + hw + i) * f.max_pages + p]);
  }
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    run[i] = hw + i < k.Gt ? warp_max(run[i]) : 0.f;
    if (lane == 0) sM[(hw + i) * mstride] = run[i];
  }
  for (int c0 = 0; c0 < ns; c0 += 32) {  // inclusive max-scans, 32 pages a step
    float v[HPW];
#pragma unroll
    for (int i = 0; i < HPW; ++i)
      v[i] = (hw + i < k.Gt && c0 + lane < ns) ? pmax[(head0 + hw + i) * f.max_pages + p0 + c0 + lane] : 0.f;
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v[i], o);
        if (lane >= o) v[i] = fmaxf(v[i], u);
      }
      v[i] = fmaxf(v[i], run[i]);
      if (c0 + lane < ns) sM[(hw + i) * mstride + 1 + c0 + lane] = v[i];
      run[i] = __shfl_sync(0xffffffffu, v[i], 31);
    }
  }
  __syncthreads();  // sM published

  // warp w takes k-step w (tile rows 16 w .. 16 w + 15) of every tile, with
  // a state of its own (relative to the prefix max of the last page it saw)
  float m[2] = {sM[g * mstride], sM[(g + 8) * mstride]};
  float l[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  int page = p0 - 1;  // the page this warp's state is at
  const bool upper = k.Gt > 8;  // head rows g + 8 hold heads

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int nxt = ti + kGrpStages - 1;
    if (nxt < n_tiles) start(nxt);
    dtt::cp_async_commit();
    dtt::cp_async_wait<kGrpStages - 1>();
    __syncthreads();
    const uint8_t* st = grp_smem + (ti % kGrpStages) * kStage;
    const int lo = k.r0 + ti * kGrpTile + 16 * warp;
    if (lo < k.r1) {  // warp-uniform
      const uint32_t vt = dtt::smem_u32(st) + 16 * warp * L::kVRowBytes;
      const float* sc = reinterpret_cast<const float*>(st + L::kVTile) + 16 * warp + 2 * t;
      float sv[2][4];  // (head row g / g + 8) x rows 2t, 2t + 1, 2t + 8, 2t + 9 of the k-step
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = *reinterpret_cast<const float2*>(sc + (g + 8 * h) * kScoreStride);
        const float2 y = *reinterpret_cast<const float2*>(sc + (g + 8 * h) * kScoreStride + 8);
        sv[h][0] = x.x;
        sv[h][1] = x.y;
        sv[h][2] = y.x;
        sv[h][3] = y.y;
      }
      const int hi = min(lo + 16, k.r1);
      const int pa = lo / f.page_size;
      const int pb = (hi - 1) / f.page_size;
      for (int p = pa; p <= pb; ++p) {  // warp-uniform: one page unless the k-step spans pages
        if (p > page) {  // a new page: move the state to its unit's prefix max (the same within a unit)
          const int pu = min((p / U + 1) * U, k.npc) - 1;  // the last page of p's unit
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float M = sM[(g + 8 * h) * mstride + 1 + pu - p0];
            const float corr = expf(m[h] - M);
            m[h] = M;
            l[h] *= corr;
#pragma unroll
            for (int n = 0; n < NB; ++n) {
              acc[n][2 * h] *= corr;
              acc[n][2 * h + 1] *= corr;
            }
          }
          page = p;
        }
        // this page's rows of the k-step (all of them when it lies in one page)
        const int plo = pa == pb ? lo : max(lo, p * f.page_size);
        const int phi = pa == pb ? hi : min(hi, (p + 1) * f.page_size);
        uint32_t a[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1 && !upper) break;  // warp-uniform: no heads in rows g + 8
          float pr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = lo + 2 * t + (i & 1) + 8 * (i >> 1);
            pr[i] = (j >= plo && j < phi) ? expf(sv[h][i] - m[h]) : 0.f;
            l[h] += pr[i];
          }
          a[h] = dtt::pack_bf16(pr[0], pr[1]);
          a[2 + h] = dtt::pack_bf16(pr[2], pr[3]);
        }
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          uint32_t b0, b1;
          dtt::ldsm_x2_trans(b0, b1, vt + (lane & 15) * L::kVRowBytes + n * 16);
          dtt::mma_bf16_16816(acc[n], a, b0, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // merge the warps' states in shared memory (the ring is free), in a fixed
  // order, at the split's last prefix max
  dtt::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* red_m = reinterpret_cast<float*>(grp_smem);  // [kWarps][16]
  float* red_l = red_m + kWarps * 16;                  // [kWarps][16]
  float* red_acc = red_l + kWarps * 16;                // [kWarps][16][DO]
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
  const size_t Hq = (size_t)f.Hkv * f.G;
  const size_t part = (size_t)k.b * f.n_split + k.split;
  for (int idx = threadIdx.x; idx < k.Gt * DO; idx += kThreads) {
    const int row = idx / DO;
    const int d = idx % DO;
    float M = dtt::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w * 16 + row]);
    float A = 0.f, Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(red_m[w * 16 + row] - M);
      A = fmaf(red_acc[(w * 16 + row) * DO + d], wt, A);
      Lsum = fmaf(red_l[w * 16 + row], wt, Lsum);
    }
    const size_t hq = part * Hq + (size_t)k.kvh * f.G + 16 * k.ht + row;
    acc_part[hq * D + k.cs * DO + d] = A;
    if (k.cs == 0 && d == 0) {
      m_part[hq] = M * 1.4426950408889634f;  // merge_splits takes log2 units
      l_part[hq] = Lsum;
    }
  }
}

// ---------------------------------------------------------------- K7b

template <typename TK, int D>
__global__ void __launch_bounds__(kThreads)
decode_load_twin(const TK* __restrict__ k_pool, const TK* __restrict__ v_pool,
                 const int* __restrict__ page_tables, const int* __restrict__ positions,
                 float* __restrict__ out, int Hkv, int G, int page_size, int max_pages) {
  using RV = dtt::LaneVec<TK, D>;
  constexpr int VEC = RV::N;
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
    dtt::RowLoads<TK, kUnroll, RV> r;
    dtt::load_rows<TK, kUnroll, RV>(r, k_pool, v_pool, nullptr, nullptr, pt, t0, row, NROWS, ctx,
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

// K7b past head_dim 512: the wide body's pages (decode_attention_wide in
// paged_attention.cu), each K and V value of the context read once, a kv
// head's row in column slices of kTwinSlice over the grid's x dimension;
// thread c sums columns c, c + kThreads, .. of its slice over the rows.
constexpr int kTwinSlice = 512;

template <typename TK>
__global__ void __launch_bounds__(kThreads)
decode_load_twin_wide(const TK* __restrict__ k_pool, const TK* __restrict__ v_pool,
                      const int* __restrict__ page_tables, const int* __restrict__ positions,
                      float* __restrict__ out, int Hkv, int G, int D, int page_size, int max_pages, int n_cs) {
  constexpr int kCols = kTwinSlice / kThreads;
  const int kvh = blockIdx.x / n_cs;
  const int c0 = blockIdx.x % n_cs * kTwinSlice;
  const int b = blockIdx.y;
  const int ctx = dtt::decode_ctx(positions, b, max_pages * page_size);
  const int* pt = page_tables + (size_t)b * max_pages;
  float sum[kCols] = {};
  for (int j = 0; j < ctx; ++j) {
    const size_t row = dtt::token_row(pt, j, page_size) * Hkv * D + (size_t)kvh * D + c0;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = threadIdx.x + kThreads * i;
      if (c0 + c < D) sum[i] += dtt::to_f(k_pool[row + c]) + dtt::to_f(v_pool[row + c]);
    }
  }
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = threadIdx.x + kThreads * i;
      if (c0 + c < D) out[(((size_t)b * Hkv + kvh) * G + g) * D + c0 + c] = sum[i];
    }
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
  int chunk_rows;  // the f32 chunk body: unit_pages * ps
  cudaStream_t stream;
};

template <int D>
struct ChunkLaunch {
  template <int SG>
  struct At {
    static int run(const VariantArgs& a) {
      const size_t smem = chunk_smem_bytes(SG, D, a.chunk_rows);
      if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
      static std::atomic<bool> raised[dtt::kMaxDevices];
      const cudaError_t err = dtt::raise_smem_limit_once(chunk_softmax_decode<D, SG>, raised, kSmemBudget);
      if (err != cudaSuccess) return (int)err;
      const int G = a.Hq / a.Hkv;
      chunk_softmax_decode<D, SG><<<dim3(a.Hkv, a.B, G / SG), kThreads, smem, a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v), a.pt,
          a.pos, static_cast<float*>(a.out), a.Hkv, G, a.ps, a.max_pages, a.chunk_rows,
          (float)(1.0 / sqrt((double)D)));  // the plain version's f32 scale
      return (int)cudaGetLastError();
    }
  };
  static int run(const VariantArgs& a) {
    constexpr int kCap = dtt::subgroup_cap(dtt::LaneVec<float, D>::N);
    return dtt::with_head_subgroup<kCap, At>(a.Hq / a.Hkv, a);
  }
};

int chunk_head_dim(const VariantArgs& a) {
  switch (a.D) {
    case 64: return ChunkLaunch<64>::run(a);
    case 128: return ChunkLaunch<128>::run(a);
    case 256: return ChunkLaunch<256>::run(a);
    case 384: return ChunkLaunch<384>::run(a);
    case 512: return ChunkLaunch<512>::run(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4b over bf16 pools: pass 1, pass 2 and the merge.
template <int D>
int launch_grouped(const VariantArgs& a, float* scores, float* pmax, float* m_part, float* l_part, float* acc_part,
                   int split_rows, int n_split, int s_pad, int unit_pages) {
  using L = GrpSmem<D>;
  static std::atomic<bool> raised_scores[dtt::kMaxDevices], raised_pv[dtt::kMaxDevices];
  // the plain version's scale: 1 / sqrt(D) in double, rounded once to f32
  GroupedArgs f{a.Hkv, a.Hq / a.Hkv, a.ps, a.max_pages, split_rows, n_split, 0, s_pad, 1, unit_pages,
                (float)(1.0 / sqrt((double)D))};
  f.n_ht = (f.G + 15) / 16;
  const size_t smem1 = L::scores(split_rows);
  const size_t smem2 = L::pv(split_rows, a.ps, unit_pages);
  if (std::max(smem1, smem2) > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = dtt::raise_smem_limit_once(grouped_scores<D>, raised_scores, 227 * 1024);
  if (err == cudaSuccess) err = dtt::raise_smem_limit_once(grouped_pv<D>, raised_pv, 227 * 1024);
  if (err != cudaSuccess) return (int)err;
  const auto* q = static_cast<const __nv_bfloat16*>(a.q);
  grouped_scores<D><<<dim3(n_split, a.Hkv * f.n_ht, a.B), kThreads, smem1, a.stream>>>(
      q, static_cast<const __nv_bfloat16*>(a.k), a.pt, a.pos, scores, pmax, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  f.n_cs = L::kSlices;
  grouped_pv<D><<<dim3(n_split, a.Hkv * f.n_ht * f.n_cs, a.B), kThreads, smem2, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.v), a.pt, a.pos, scores, pmax, m_part, l_part, acc_part, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return dtt::launch_merge_splits(m_part, l_part, acc_part, a.pos, static_cast<__nv_bfloat16*>(a.out), a.B, a.Hq, D,
                                  a.max_pages * a.ps, split_rows, n_split, a.stream);
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
    case 256: return launch_twin<T, 256>(a);
    case 384: return launch_twin<T, 384>(a);
    case 512: return launch_twin<T, 512>(a);
    default: break;
  }
  if (a.D % 128 || a.D < 512) return (int)cudaErrorInvalidValue;
  const int n_cs = (a.D + kTwinSlice - 1) / kTwinSlice;
  decode_load_twin_wide<T><<<dim3(a.Hkv * n_cs, a.B), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.pt, a.pos, static_cast<float*>(a.out), a.Hkv,
      a.Hq / a.Hkv, a.D, a.ps, a.max_pages, n_cs);
  return (int)cudaGetLastError();
}

bool shapes_ok(const VariantArgs& a) {
  return a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.ps > 0 && a.max_pages > 0;
}

}  // namespace

// K4b (unit_pages 1) and K4a (unit_pages = its chunk's pages): the
// probabilities rounded at the running max after each unit of unit_pages
// pages. bf16: scratch scores [B, Hq, s_pad] (s_pad >= max_pages * ps, a
// multiple of 4), pmax [B, Hq, max_pages] and the partials m_part, l_part
// [B, n_split, Hq], acc_part [B, n_split, Hq, D] f32, splits of split_rows
// rows (a multiple of ps), n_split >= ceil(max_pages * ps / split_rows).
// f32: the chunk body at a unit a chunk (the scratch is not read). Each
// entry point returns cudaGetLastError() after its launches (0 = launched);
// shapes the kernel does not take return cudaErrorInvalidValue without
// launching.
extern "C" int paged_decode_attention_grouped(const void* q, const void* k_pool, const void* v_pool,
                                              const void* page_tables, const void* positions, void* out, int B,
                                              int Hq, int Hkv, int D, int page_size, int max_pages, void* scores,
                                              void* pmax, void* m_part, void* l_part, void* acc_part,
                                              int split_rows, int n_split, int s_pad, int unit_pages, int dtype,
                                              void* stream) {
  if (B <= 0) return 0;
  if (unit_pages <= 0 || (long long)unit_pages * page_size > INT_MAX) return (int)cudaErrorInvalidValue;
  const VariantArgs a{q, k_pool, v_pool, static_cast<const int*>(page_tables),
                      static_cast<const int*>(positions), out, B, Hq, Hkv, D, page_size, max_pages,
                      unit_pages * page_size, static_cast<cudaStream_t>(stream)};
  if (!shapes_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return chunk_head_dim(a);
  if (dtype != 1 || split_rows <= 0 || split_rows % page_size || s_pad % 4 ||
      (long long)s_pad < (long long)max_pages * page_size ||
      (long long)n_split * split_rows < (long long)max_pages * page_size)
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scores);
  float* pm = static_cast<float*>(pmax);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  switch (D) {
    case 64: return launch_grouped<64>(a, sc, pm, mp, lp, ap, split_rows, n_split, s_pad, unit_pages);
    case 128: return launch_grouped<128>(a, sc, pm, mp, lp, ap, split_rows, n_split, s_pad, unit_pages);
    case 256: return launch_grouped<256>(a, sc, pm, mp, lp, ap, split_rows, n_split, s_pad, unit_pages);
    case 384: return launch_grouped<384>(a, sc, pm, mp, lp, ap, split_rows, n_split, s_pad, unit_pages);
    case 512: return launch_grouped<512>(a, sc, pm, mp, lp, ap, split_rows, n_split, s_pad, unit_pages);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7b: out [B, Hq, D] float32 checksums.
extern "C" int paged_decode_dmaonly(const void* k_pool, const void* v_pool,
                                    const void* page_tables, const void* positions, void* out,
                                    int B, int Hq, int Hkv, int D, int page_size, int max_pages,
                                    int dtype, void* stream) {
  const VariantArgs a{nullptr, k_pool, v_pool, static_cast<const int*>(page_tables),
                      static_cast<const int*>(positions), out, B, Hq, Hkv, D, page_size, max_pages,
                      0, static_cast<cudaStream_t>(stream)};
  if (B <= 0) return 0;
  if (!shapes_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return twin_head_dim<float>(a);
  if (dtype == 1) return twin_head_dim<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
