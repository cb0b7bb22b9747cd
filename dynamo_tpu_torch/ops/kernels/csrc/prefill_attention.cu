// K2 and K3b: chunked-prefill flash attention over the paged KV pool, and
// K7a, K2's load-only twin, for Hopper (sm_90a).
//
// K2 replaces the TPU kernel dynamo_tpu/ops/pallas/prefill_attention.py:686
// paged_prefill_attention_pallas (pallas_call at :783; _kernel_lookahead /
// _kernel, math in _flash_merge). K3b replaces :615
// paged_prefill_attention_pallas_folded (pallas_call at :662,
// _kernel_folded), the same function for head dims that are not a multiple
// of 128 (TinyLlama's 64; here any such head dim), which the TPU reads from pools with the kv heads
// folded into the lane dim through zero-placed folded queries (a Mosaic lane
// workaround, not carried over). The reference's folded kernel rounds its
// probabilities to the pool dtype before P.V (:572); the port keeps f32
// probabilities for both, as the reference's _flash_merge and plain version
// do (see the split below). The TPU variants differ only in DMA scheduling
// across the serial TPU grid; nothing carries between CUDA blocks, so
// neither schedule is copied.
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
// What bounds them on an H100: the work is arithmetic, 4 * Hq * D FLOP per
// causal (row, key) pair, against context bytes read once; the first version
// (f32 FMA micro-tiles, 32-key tiles staged synchronously as f32) reached
// 13-25 TFLOP/s of the card's 67 f32 and 989 bf16 tensor-core TFLOP/s. With
// the design below, bf16 K2 reaches ~100 TFLOP/s at its check shape and
// is held by its load stream (K7a, the same loads with no math, takes 60-75%
// of K2's time: every query block re-reads its context through the page
// table, 16-byte copies whose addresses each thread computes) and by the
// serial S -> softmax -> P.V chain of each warpgroup, at one block an SM at D
// 128 (~185 registers a thread). A deeper ring (3 or 4 stages) measured no
// faster.
//
// Design (bf16 queries over bf16 or int8 pools, K2 at D 64 / 128 / 256 and
// K3b at any D that is a multiple of 8 below 256, one body:
// tc_prefill_kernel<TK, DP>, DP = D rounded up to 16 below 128 and 256 above
// it (K3b's D 136..248 run K2's D 256 instance): the tiles hold DP columns,
// those past D zero, and the output's pad columns are never written. At DP
// 256 the bf16 Q tile and two ring stages take 192 KB and the 64 x 256 f32
// output accumulator 128 registers a thread):
// - Block = 128 (query, head) rows of one kv head's GQA group, two consumer
//   warpgroups of 64: row r is query position r / G, head r % G, so a block
//   covers BQ = floor(128 / G) positions (any G up to 128; the rows from BQ *
//   G on are zero queries and write nothing) and every staged K/V tile
//   serves all G heads. Grid (q-blocks, Hkv, lanes), the blocks with the
//   longest context first.
// - Both products on the tensor cores. S = Q.K^T: wgmma m64n64k16, bf16 in,
//   f32 accumulate, Q and K from shared memory (K-major, as the pool stores
//   rows). O += P.V: wgmma m64nDPk16 with A from registers (the f32 S
//   accumulator fragment maps onto the bf16 A fragment thread for thread)
//   and V from shared memory through a transposed (MN-major) descriptor; a
//   width with no instruction (48, 80, 96, 112) is pieces of 64, 32 and 16.
// - P stays f32-exact: rounding P once to bf16 puts short rows' small
//   outputs outside TOL["bf16"] (tests/test_torch_prefill_tc.py), so P (int8:
//   times the V row scale) is split as bf16(P) + bf16(P - bf16(P)) and goes
//   through two products: the tensor-core work grows by half.
// - Shared memory holds tiles in the no-swizzle (interleaved) core-matrix
//   layout for every DP: 16-byte chunk (row j, column chunk c) at chunk index
//   ((j / 8) * (DP / 8) + c) * 8 + j % 8, so 8 consecutive threads fill one
//   128-byte core matrix and the same tile is the K-major B of Q.K^T and the
//   MN-major B of P.V. The descriptors read that layout.
// - K/V tiles of 64 keys are held in bf16 in a ring of 2 (D 128) or 3
//   stages filled by cp.async 16-byte copies through the page table (a tile
//   spans 4 pages at page size 16, half a page at 128); tile t + stages - 1
//   loads while tile t is computed. Keys at or past the block's context
//   bound are zero-filled, never read, so pad rows and pad lanes (tables of
//   trash page 0) stay in bounds. Int8 codes land raw in the ring with their
//   row scales and are converted to bf16 (exact: |code| <= 127) in shared
//   memory just before their tile's products (at D % 16 == 8 a row's last 8
//   codes arrive as an 8-byte copy beside 8 zero bytes); scores take the K
//   scale after Q.K^T.
// - Online softmax in registers on the accumulator fragments (a row lives in
//   4 threads: max reduced across them, sums at the end), exp2 with the
//   scale folded into log2(e)/sqrt(D); the causal and n_ctx masks only on
//   tiles that cross the diagonal or the context end.
// f32 queries (f32 or int8 pools: the f32 greedy-parity phases and the
// checks) keep an f32 FMA body, fma_prefill_kernel, in the same block
// partition: TF32 tensor cores would break TOL["f32"]. Its narrow form
// stages Q, K and V an element at a time with the columns past D zero, for
// rows at any offset: K3b's head dims that are no multiple of 8 (D 100 over
// 2 kv heads, which the reference runs in plain XLA; D 20 over 4), in every
// mix, and its f32 queries above 128.
// Head dims past 256 (K2 at every multiple of 128 from 384, K3b at every
// other head dim from 257), every mix:
// wide_prefill_kernel, a simple FMA body in the same block partition that
// holds neither a whole Q row tile (bf16 128 KB at D 512, f32 256 KB) nor a
// 64 x D accumulator. A block owns one slice of 128 output columns (the
// slices over the grid's y dimension, beside the kv head); each 32-key tile
// scores Q . K^T in 64-column chunks of Q and K staged as f32 an element at
// a time (rows at any offset), then stages the tile's V slice. Each slice
// recomputes the scores and re-reads K and Q: at these shapes the body is
// right and simple, not fast (its times stand in PERF.md).
// Next steps, not done here: TMA loads (no per-thread address work),
// warp specialisation (a producer warp, ping-pong consumer warpgroups so one
// warpgroup's softmax overlaps the other's products), persistent blocks,
// split-K over long contexts, a swizzled layout.
//
// K7a replaces dynamo_tpu/ops/pallas/prefill_attention.py:797
// paged_prefill_dmaonly (pallas_call at :840, _kernel_dmaonly), the
// null-hypothesis instrument of tools/profile_prefill.py: K2's grid, causal
// tile bound and load stream (bf16 / int8: the cp.async ring and the int8
// conversion; f32: the FMA body's staging, each K/V row of the block's
// context read once; past D 256, prefill_load_twin_wide: the wide FMA body's
// grid and staging, K in 64-column chunks and V in 128-column slices) with
// no math. The reference's
// twin writes 1e-6 x one row of the last tile, garbage by design; a load
// that nothing reads is deleted by nvcc, so every row the block owns gets
// instead the f32 column sums over the block's context j < min(last row's
// position + 1, max_pages * ps) of (K + V)[j, kv head, :], int8 rows
// dequantized (code x row scale), summed from whole 16-byte chunks of the
// tiles so that the sums cost little beside the loads. Its time against
// K2's is the share of K2 that its load stream explains.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRows = 128;    // (query, head) rows per block, both bodies
constexpr int kThreads = 256; // two warpgroups (tensor-core body); 16 x 16 (FMA body)
constexpr int kTile = 64;     // tensor-core body: keys per context tile
constexpr int kFmaKeys = 32;  // FMA body: keys per context tile
constexpr int kFmaRPT = kRows / 16;  // FMA body: rows per thread
constexpr int kPStride = kFmaKeys + 16;

// ------------------------------------------------------------- PTX helpers

using dtt::cp_async16;
using dtt::cp_async4;
using dtt::cp_async8;
using dtt::cp_async_commit;
using dtt::cp_async_wait;
using dtt::pack_bf16;
using dtt::smem_u32;

// generic-proxy writes (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// pins registers an asynchronous wgmma reads or writes to their place in
// the instruction stream
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, no swizzle (layout type 0): start
// address, leading byte offset (between core matrices along K) and stride
// byte offset (between core matrices along M / N), all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// S [64 x 64] (+)= A [64 x 16] . B [16 x 64]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}
// O [64 x N] += A [64 x 16] . B [16 x N], A from registers (4 x bf16x2), B
// MN-major in shared memory
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
        : "memory");
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
        : "memory");
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
        : "memory");
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
        : "memory");
  }
};

// ------------------------------------------------------------- the block

struct Block {
  int q_start, n_q, pos0, n_ctx, G, BQ;
};

// The block's query range and context bound; blockIdx.x runs the longest
// contexts (the last query blocks) first.
__device__ __forceinline__ Block block_of(const int* __restrict__ positions, int T_len, int Hq, int Hkv,
                                          int page_size, int max_pages) {
  Block b;
  b.G = Hq / Hkv;
  b.BQ = kRows / b.G;
  const int qb = gridDim.x - 1 - blockIdx.x;
  b.q_start = qb * b.BQ;
  b.n_q = min(b.BQ, T_len - b.q_start);
  const int* pos = positions + (size_t)blockIdx.z * T_len;
  b.pos0 = pos[b.q_start];
  b.n_ctx = min(pos[b.q_start + b.n_q - 1] + 1, max_pages * page_size);
  return b;
}

// ------------------------------------------------------------- the ring

// DP: the head dim padded to a multiple of 16 (the tiles' width in shared
// memory; the pad columns are zero)
template <typename TK, int DP>
struct Ring {
  static constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  static constexpr int kStages = DP >= 128 ? 2 : 3;
  static constexpr int kEPC = 16 / sizeof(TK);          // pool elements a 16-byte chunk
  static constexpr int kRaw = kTile * DP * sizeof(TK);   // one K or V tile as stored in the ring
  static constexpr int kStage = 2 * kRaw + (kQuant ? 2 * kTile * 4 : 0);
  static constexpr int kBf16Tile = kTile * DP * 2;       // one K or V tile in bf16
  static constexpr int kQBytes = kRows * DP * 2;
  // Q, the ring, and (int8) the bf16 K and V tiles converted from it
  static constexpr int kSmem = kQBytes + kStages * kStage + (kQuant ? 2 * kBf16Tile : 0);
  // blocks an SM holds: two (128 registers a thread) where the body fits
  // them without spilling, one at D 128 (~185 registers) and int8 from D 64
  // (~160; at 128 it spills)
  static constexpr int kMinBlocks = DP <= 32 || (DP <= 64 && !kQuant) ? 2 : 1;
};

// Start the cp.async copies of context keys [kt0, kt0 + kTile) of kv head
// column col0 into a ring stage: K then V in the interleaved chunk layout
// (int8: raw codes, 16 a chunk, then the K and V row scales). Keys at or
// past n_ctx, and the columns from D to DP, are zero-filled (int8 at D % 16
// == 8, where a kv head's row need not start on 16 bytes: 8-byte copies, the
// last chunk's second half zero).
template <typename TK, int DP>
__device__ __forceinline__ void start_tile(uint8_t* stage, const TK* __restrict__ k_pool,
                                           const TK* __restrict__ v_pool, const float* __restrict__ k_scale,
                                           const float* __restrict__ v_scale, const int* __restrict__ pt,
                                           int kt0, int n_ctx, int page_size, size_t token_stride, int col0, int D) {
  using R = Ring<TK, DP>;
  constexpr int CPR = DP / R::kEPC;  // chunks a key row
  const uint32_t s = smem_u32(stage);
  for (int idx = threadIdx.x; idx < kTile * CPR; idx += kThreads) {
    const int rest = idx / 8;
    const int c = rest % CPR;
    const int key = kt0 + (rest / CPR) * 8 + idx % 8;
    const int e0 = c * R::kEPC;  // the chunk's first column
    const bool ok = key < n_ctx && e0 < D;
    size_t off = 0;
    if (ok) off = ((size_t)pt[key / page_size] * page_size + key % page_size) * token_stride + col0 + e0;
    if (!R::kQuant || D % 16 == 0) {
      cp_async16(s + idx * 16, k_pool + off, ok);
      cp_async16(s + R::kRaw + idx * 16, v_pool + off, ok);
    } else {
      const bool hi = ok && e0 + 8 < D;
      cp_async8(s + idx * 16, k_pool + off, ok);
      cp_async8(s + idx * 16 + 8, k_pool + off + (hi ? 8 : 0), hi);
      cp_async8(s + R::kRaw + idx * 16, v_pool + off, ok);
      cp_async8(s + R::kRaw + idx * 16 + 8, v_pool + off + (hi ? 8 : 0), hi);
    }
  }
  if constexpr (R::kQuant) {
    if (threadIdx.x < 2 * kTile) {
      const int j = threadIdx.x % kTile;
      const int key = kt0 + j;
      const bool ok = key < n_ctx;
      size_t tok = 0;
      if (ok) tok = (size_t)pt[key / page_size] * page_size + key % page_size;
      const float* src = threadIdx.x < kTile ? k_scale : v_scale;
      cp_async4(s + 2 * R::kRaw + threadIdx.x * 4, src + tok, ok);
    }
  }
}

// Int8: the raw K and V codes of a ring stage to bf16 tiles (dst: K then V)
// in the interleaved layout of DP / 8 chunks a row.
template <int DP>
__device__ __forceinline__ void convert_tile(uint8_t* dst, const uint8_t* stage) {
  constexpr int CPR16 = DP / 16;
  constexpr int RCH = kTile * CPR16;  // raw chunks a tile
  for (int idx = threadIdx.x; idx < 2 * RCH; idx += kThreads) {
    const int which = idx / RCH;
    const int ridx = idx % RCH;
    const int rest = ridx / 8;
    const int c16 = rest % CPR16;
    const int j = (rest / CPR16) * 8 + ridx % 8;
    const int4 raw = *reinterpret_cast<const int4*>(stage + which * kTile * DP + ridx * 16);
    float f[16];
    dtt::to_float(raw, f);
    uint4 a, b;
    a.x = pack_bf16(f[0], f[1]);
    a.y = pack_bf16(f[2], f[3]);
    a.z = pack_bf16(f[4], f[5]);
    a.w = pack_bf16(f[6], f[7]);
    b.x = pack_bf16(f[8], f[9]);
    b.y = pack_bf16(f[10], f[11]);
    b.z = pack_bf16(f[12], f[13]);
    b.w = pack_bf16(f[14], f[15]);
    const int b0 = ((j / 8) * (DP / 8) + 2 * c16) * 8 + j % 8;
    uint8_t* t = dst + which * kTile * DP * 2;
    *reinterpret_cast<uint4*>(t + b0 * 16) = a;
    *reinterpret_cast<uint4*>(t + (b0 + 8) * 16) = b;
  }
}

// Wait for the oldest tile in flight (all but the kStages - 1 newest cp.async
// groups), make it visible to the tensor cores and to every thread, and
// return its bf16 K tile (V follows it): the stage itself, or for int8 the
// tiles converted into `conv`.
template <typename TK, int DP>
__device__ __forceinline__ const uint8_t* land_tile(const uint8_t* stage, uint8_t* conv) {
  using R = Ring<TK, DP>;
  cp_async_wait<R::kStages - 1>();
  fence_proxy_async();
  __syncthreads();
  if constexpr (R::kQuant) {
    convert_tile<DP>(conv, stage);
    fence_proxy_async();
    __syncthreads();
    return conv;
  } else {
    return stage;
  }
}

// ---------------------------------------------------------------- K2 / K3b (bf16 queries)

// O [64 x DP] += A [64 x 16] . V [16 x DP] for DP a multiple of 16 up to
// 256: one wgmma of width DP where the instruction exists here (16, 32, 64,
// 128), else pieces of 128, 64, 32 and 16 columns (v_addr: the V tile's
// first column; the interleaved layout puts column chunk c at 128 c bytes).
template <int DP>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2], const uint32_t (&a)[4], uint32_t v_addr,
                                           uint32_t lbo) {
  if constexpr (DP == 16 || DP == 32 || DP == 64 || DP == 128) {
    WgmmaRS<DP>::run(o, a, smem_desc(v_addr, lbo, 128));
  } else {
    constexpr int N = DP >= 128 ? 128 : (DP >= 64 ? 64 : (DP >= 32 ? 32 : 16));
    WgmmaRS<N>::run(*reinterpret_cast<float(*)[N / 2]>(&o[0]), a, smem_desc(v_addr, lbo, 128));
    pv_product<DP - N>(*reinterpret_cast<float(*)[(DP - N) / 2]>(&o[N / 2]), a, v_addr + N * 16, lbo);
  }
}

template <typename TK, int DP>
__global__ void __launch_bounds__(kThreads, Ring<TK, DP>::kMinBlocks)
tc_prefill_kernel(const __nv_bfloat16* __restrict__ q, const TK* __restrict__ k_pool,
                  const TK* __restrict__ v_pool, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ page_tables,
                  const int* __restrict__ positions, __nv_bfloat16* __restrict__ out, int T_len, int Hq,
                  int Hkv, int D, int page_size, int max_pages, float scale_log2) {
  using R = Ring<TK, DP>;
  constexpr int CPR = DP / 8;  // bf16 chunks a row
  constexpr int NO = DP / 2;   // output accumulators a thread (64 rows x DP over 128 threads)
  static_assert(DP % 16 == 0 && DP <= 256, "unsupported head_dim");

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sQ = smem;
  uint8_t* ring = sQ + R::kQBytes;
  uint8_t* conv = ring + R::kStages * R::kStage;

  const Block b = block_of(positions, T_len, Hq, Hkv, page_size, max_pages);
  const int kvh = blockIdx.y;
  const int n = blockIdx.z;
  const int* pt = page_tables + (size_t)n * max_pages;
  const size_t token_stride = (size_t)Hkv * D;

  // Q tile, row r = (position r / G, head r % G); rows past the block and
  // columns past D are zeros
  {
    const uint32_t s = smem_u32(sQ);
    for (int idx = threadIdx.x; idx < kRows * CPR; idx += kThreads) {
      const int rest = idx / 8;
      const int c = rest % CPR;
      const int r = (rest / CPR) * 8 + idx % 8;
      const int qi = r / b.G;
      const bool ok = qi < b.n_q && c * 8 < D;
      size_t off = 0;
      if (ok) off = (((size_t)n * T_len + b.q_start + qi) * Hq + (size_t)kvh * b.G + r % b.G) * D + c * 8;
      cp_async16(s + idx * 16, q + off, ok);
    }
  }
  const int n_tiles = (b.n_ctx + kTile - 1) / kTile;
#pragma unroll
  for (int st = 0; st < R::kStages - 1; ++st) {
    if (st < n_tiles)
      start_tile<TK, DP>(ring + st * R::kStage, k_pool, v_pool, k_scale, v_scale, pt, st * kTile, b.n_ctx,
                         page_size, token_stride, kvh * D, D);
    cp_async_commit();  // the first group carries Q too
  }

  // this thread's two rows (a, a + 8) of its warpgroup's 64, and its columns
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int row_a = wg * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
  const int qpos[2] = {b.pos0 + row_a / b.G, b.pos0 + (row_a + 8) / b.G};
  const int cq = 2 * (lane % 4);

  float m[2] = {dtt::kNegInf, dtt::kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  const uint32_t q_base = smem_u32(sQ) + wg * 64 * DP * 2;

  for (int t = 0; t < n_tiles; ++t) {
    const int nxt = t + R::kStages - 1;
    if (nxt < n_tiles)
      start_tile<TK, DP>(ring + (nxt % R::kStages) * R::kStage, k_pool, v_pool, k_scale, v_scale, pt,
                         nxt * kTile, b.n_ctx, page_size, token_stride, kvh * D, D);
    cp_async_commit();
    const uint8_t* stage = ring + (t % R::kStages) * R::kStage;
    const uint8_t* tk = land_tile<TK, DP>(stage, conv);
    const uint32_t k_base = smem_u32(tk);
    const uint32_t v_base = k_base + R::kBf16Tile;
    const float* sKs = reinterpret_cast<const float*>(stage + 2 * R::kRaw);
    const float* sVs = sKs + kTile;
    const int kt0 = t * kTile;

    // S = Q . K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_m64n64k16(s, smem_desc(q_base + kk * 256, 128, 16 * DP), smem_desc(k_base + kk * 256, 128, 16 * DP),
                         1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // online softmax; s[i] is (row a + 8 * ((i / 2) % 2), key 8 * (i / 4) + cq + i % 2)
    const bool edge = kt0 + kTile - 1 > b.pos0 || kt0 + kTile > b.n_ctx;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      const int col = 8 * (i / 4) + cq + i % 2;
      float v = s[i] * (R::kQuant ? sKs[col] * scale_log2 : scale_log2);
      if (edge && (kt0 + col > qpos[h] || kt0 + col >= b.n_ctx)) v = dtt::kNegInf;
      s[i] = v;
      mx[h] = fmaxf(mx[h], v);
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
    uint32_t ph[16], pl[16];  // P split into bf16 hi and lo, as A fragments
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i / 2) % 2;
      const int col = 8 * (i / 4) + cq;
      float p0 = exp2f(s[i] - m[h]);
      float p1 = exp2f(s[i + 1] - m[h]);
      l[h] += p0 + p1;
      if constexpr (R::kQuant) {
        p0 *= sVs[col];
        p1 *= sVs[col + 1];
      }
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      ph[i / 2] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[i / 2] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i / 2) % 2];

    // O += P_hi . V + P_lo . V; k-step kk takes keys 16 kk .. 16 kk + 15
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t va = v_base + kk * 32 * DP;
      const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3]};
      const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3]};
      pv_product<DP>(o, ah, va, 16 * DP);
      pv_product<DP>(o, al, va, 16 * DP);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_a + 8 * h;
    const int qi = r / b.G;
    if (qi >= b.n_q) continue;
    const float denom = fmaxf(l[h], 1e-20f);
    __nv_bfloat16* dst = out + (((size_t)n * T_len + b.q_start + qi) * Hq + (size_t)kvh * b.G + r % b.G) * D + cq;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= D) break;  // the pad columns are never written
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] / denom, o[4 * j + 2 * h + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------- K2 / K3b (f32 queries)

// The FMA bodies' loads: 4 f32 values (16 bytes) or 8 int8 codes (8 bytes,
// so any D that is a multiple of 8 is whole vectors).
template <typename T>
__device__ __forceinline__ void load_row_f32(float* dst_row, const T* src_row, bool ok, int c) {
  using V = dtt::RowVec<T>;
  float f[V::N];
  if (ok) {
    dtt::to_float(dtt::load_row(src_row + c), f);
  } else {
#pragma unroll
    for (int i = 0; i < V::N; ++i) f[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < V::N; i += 4) dtt::store4(dst_row + c + i, f + i);
}

// Stage context keys [kt0, kt0 + kFmaKeys) of kv head column col0, D
// columns, into sK (row stride KS) and sV (row stride VS) as f32, and for
// int8 the rows' scales into sKs / sVs; keys at or past n_ctx are zero and
// are not read.
// kNarrow: element at a time, columns D .. DP zero (rows at any offset).
template <typename TK, int DP = 0, bool kNarrow = false>
__device__ __forceinline__ void stage_kv(float* sK, float* sV, float* sKs, float* sVs,
                                         const TK* __restrict__ k_pool, const TK* __restrict__ v_pool,
                                         const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                                         const int* __restrict__ pt, int kt0, int n_ctx, int page_size, int KS,
                                         int VS, size_t token_stride, int col0, int D) {
  if constexpr (kNarrow) {
    for (int idx = threadIdx.x; idx < kFmaKeys * DP; idx += kThreads) {
      const int kk = idx / DP;
      const int c = idx - kk * DP;
      const int j = kt0 + kk;
      float kv = 0.f, vv = 0.f;
      if (j < n_ctx && c < D) {
        const size_t at = ((size_t)pt[j / page_size] * page_size + (j % page_size)) * token_stride + col0 + c;
        kv = dtt::to_f(k_pool[at]);
        vv = dtt::to_f(v_pool[at]);
      }
      sK[kk * KS + c] = kv;
      sV[kk * VS + c] = vv;
    }
  } else {
    constexpr int VEC = dtt::RowVec<TK>::N;
    const int vpr = D / VEC;
    for (int idx = threadIdx.x; idx < kFmaKeys * vpr; idx += kThreads) {
      const int kk = idx / vpr;
      const int c = (idx - kk * vpr) * VEC;
      const int j = kt0 + kk;
      const bool ok = j < n_ctx;
      size_t base = 0;
      if (ok) base = ((size_t)pt[j / page_size] * page_size + (j % page_size)) * token_stride + col0;
      load_row_f32<TK>(sK + kk * KS, k_pool + base, ok, c);
      load_row_f32<TK>(sV + kk * VS, v_pool + base, ok, c);
    }
  }
  if constexpr (std::is_same<TK, int8_t>::value) {
    if (threadIdx.x < kFmaKeys) {
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

template <int DP>
constexpr size_t fma_smem_bytes() {
  return ((size_t)kRows * (DP + 4) + kFmaKeys * (DP + 4) + kFmaKeys * DP + kRows * kPStride + 2 * kFmaKeys) *
         sizeof(float);
}

// Thread (ty, tx) owns rows ty + 16 i (i < kFmaRPT), row r = (head r / BQ,
// position r % BQ; rows from G * BQ on hold no head); keys tx and tx + 16 of
// each tile; output columns tx + 16 c below D (DP: D rounded up to 16).
// kNarrow (any D below DP, f32 or bf16 queries, rows at any offset: the
// folded head dims that are no multiple of 8, and K3b's f32 queries above
// 128): Q, K and V staged an element at a time, the columns past D zero.
template <typename TQ, typename TK, int DP, bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1)
fma_prefill_kernel(const TQ* __restrict__ q, const TK* __restrict__ k_pool, const TK* __restrict__ v_pool,
                   const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                   const int* __restrict__ page_tables, const int* __restrict__ positions, TQ* __restrict__ out,
                   int T_len, int Hq, int Hkv, int D, int page_size, int max_pages, float scale) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  constexpr int QS = DP + 4;   // padded row stride of the Q and K tiles
  constexpr int CW = DP / 16;  // output columns a thread
  static_assert(DP % 16 == 0, "unsupported head_dim");

  extern __shared__ float4 smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kRows][QS]
  float* sK = sQ + kRows * QS;                     // [kFmaKeys][QS]
  float* sV = sK + kFmaKeys * QS;                  // [kFmaKeys][DP]
  float* sP = sV + kFmaKeys * DP;                  // [kRows][kPStride]
  float* sKs = sP + kRows * kPStride;              // [kFmaKeys]
  float* sVs = sKs + kFmaKeys;                     // [kFmaKeys]

  const Block b = block_of(positions, T_len, Hq, Hkv, page_size, max_pages);
  const int kvh = blockIdx.y;
  const int n = blockIdx.z;
  const int* pt = page_tables + (size_t)n * max_pages;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  if constexpr (kNarrow) {
    for (int idx = tid; idx < kRows * DP; idx += kThreads) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      const int qi = r % b.BQ;
      float x = 0.f;
      if (qi < b.n_q && r / b.BQ < b.G && c < D)
        x = dtt::to_f(q[(((size_t)n * T_len + b.q_start + qi) * Hq + (size_t)kvh * b.G + r / b.BQ) * D + c]);
      sQ[r * QS + c] = x;
    }
  } else {
    static_assert(kNarrow || std::is_same<TQ, float>::value, "the 16-byte staging takes f32 queries");
    for (int idx = tid; idx < kRows * (D / 4); idx += kThreads) {
      const int r = idx / (D / 4);
      const int c = (idx % (D / 4)) * 4;
      const int qi = r % b.BQ;
      const TQ* src = q + (((size_t)n * T_len + b.q_start + qi) * Hq + (size_t)kvh * b.G + r / b.BQ) * D;
      load_row_f32<TQ>(sQ + r * QS, src, qi < b.n_q && r / b.BQ < b.G, c);
    }
  }
  const int Dq = kNarrow ? (D + 3) / 4 * 4 : D;  // the score's columns (narrow: the pad is zero)

  float m[kFmaRPT], l[kFmaRPT], o[kFmaRPT][CW];
  int qpos[kFmaRPT];
#pragma unroll
  for (int i = 0; i < kFmaRPT; ++i) {
    m[i] = dtt::kNegInf;
    l[i] = 0.f;
    qpos[i] = b.pos0 + (ty + 16 * i) % b.BQ;
#pragma unroll
    for (int c = 0; c < CW; ++c) o[i][c] = 0.f;
  }

  for (int kt0 = 0; kt0 < b.n_ctx; kt0 += kFmaKeys) {
    __syncthreads();  // previous tile's readers are done with sK / sV / sP
    stage_kv<TK, DP, kNarrow>(sK, sV, sKs, sVs, k_pool, v_pool, k_scale, v_scale, pt, kt0, b.n_ctx, page_size,
                              QS, DP, (size_t)Hkv * D, kvh * D, D);
    __syncthreads();

    float s[kFmaRPT][2];
#pragma unroll
    for (int i = 0; i < kFmaRPT; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dq; d += 4) {
      float4 kv[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) kv[jj] = *reinterpret_cast<const float4*>(sK + (tx + 16 * jj) * QS + d);
#pragma unroll
      for (int i = 0; i < kFmaRPT; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * QS + d);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          s[i][jj] = fmaf(qv.x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv.y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv.z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv.w, kv[jj].w, s[i][jj]);
        }
      }
    }

    // online softmax for keys tx, tx + 16 of each row; a row's 16 tx lanes
    // sit in one half-warp
#pragma unroll
    for (int i = 0; i < kFmaRPT; ++i) {
      float rmax = dtt::kNegInf;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = kt0 + tx + 16 * jj;
        float v = s[i][jj] * scale;
        if constexpr (kQuant) v *= sKs[tx + 16 * jj];
        s[i][jj] = (j <= qpos[i] && j < b.n_ctx) ? v : dtt::kNegInf;
        rmax = fmaxf(rmax, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float new_m = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - new_m);
      float rsum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float p = expf(s[i][jj] - new_m);
        rsum += p;
        sP[(ty + 16 * i) * kPStride + tx + 16 * jj] = kQuant ? p * sVs[tx + 16 * jj] : p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = new_m;
#pragma unroll
      for (int c = 0; c < CW; ++c) o[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kFmaKeys; ++kk) {
      float vv[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) vv[c] = sV[kk * DP + tx + 16 * c];  // past D: unread pad
#pragma unroll
      for (int i = 0; i < kFmaRPT; ++i) {
        const float p = sP[(ty + 16 * i) * kPStride + kk];
#pragma unroll
        for (int c = 0; c < CW; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kFmaRPT; ++i) {
    const int r = ty + 16 * i;
    const int qi = r % b.BQ;
    if (qi >= b.n_q || r / b.BQ >= b.G) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    TQ* dst = out + (((size_t)n * T_len + b.q_start + qi) * Hq + (size_t)kvh * b.G + r / b.BQ) * D + tx;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (tx + 16 * c < D) dtt::store1(dst + 16 * c, o[i][c] / denom);
  }
}

// ---------------------------------------------------------------- wide head dims

constexpr int kWideChunk = 64;   // score columns of Q and K staged at a time
constexpr int kWideSlice = 128;  // output columns a block
constexpr int kWideQS = kWideChunk + 4;

constexpr size_t wide_smem_bytes() {
  return ((size_t)kRows * kWideQS + kFmaKeys * kWideQS + kFmaKeys * kWideSlice + kRows * kPStride + 2 * kFmaKeys) *
         sizeof(float);
}

__device__ __forceinline__ size_t wide_row(const int* __restrict__ pt, int j, int page_size) {
  return (size_t)pt[j / page_size] * page_size + (j % page_size);
}

// The FMA body's partition and thread map (thread (ty, tx): rows ty + 16 i,
// keys tx and tx + 16 of each tile, output columns c0 + tx + 16 c of the
// block's slice), for any D: blockIdx.y = kv head * n_cs + column slice.
template <typename TQ, typename TK>
__global__ void __launch_bounds__(kThreads, 1)
wide_prefill_kernel(const TQ* __restrict__ q, const TK* __restrict__ k_pool, const TK* __restrict__ v_pool,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const int* __restrict__ page_tables, const int* __restrict__ positions, TQ* __restrict__ out,
                    int T_len, int Hq, int Hkv, int D, int page_size, int max_pages, int n_cs, float scale) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  constexpr int CW = kWideSlice / 16;  // output columns a thread
  extern __shared__ float4 smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kRows][kWideQS]: a chunk of Q
  float* sK = sQ + kRows * kWideQS;                // [kFmaKeys][kWideQS]: a chunk of K
  float* sV = sK + kFmaKeys * kWideQS;             // [kFmaKeys][kWideSlice]: the tile's V slice
  float* sP = sV + kFmaKeys * kWideSlice;          // [kRows][kPStride]
  float* sKs = sP + kRows * kPStride;              // [kFmaKeys]
  float* sVs = sKs + kFmaKeys;                     // [kFmaKeys]

  const Block b = block_of(positions, T_len, Hq, Hkv, page_size, max_pages);
  const int kvh = blockIdx.y / n_cs;
  const int c0 = (blockIdx.y % n_cs) * kWideSlice;
  const int n = blockIdx.z;
  const int* pt = page_tables + (size_t)n * max_pages;
  const size_t token_stride = (size_t)Hkv * D;
  const size_t col0 = (size_t)kvh * D;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float m[kFmaRPT], l[kFmaRPT], o[kFmaRPT][CW];
  int qpos[kFmaRPT];
#pragma unroll
  for (int i = 0; i < kFmaRPT; ++i) {
    m[i] = dtt::kNegInf;
    l[i] = 0.f;
    qpos[i] = b.pos0 + (ty + 16 * i) % b.BQ;
#pragma unroll
    for (int c = 0; c < CW; ++c) o[i][c] = 0.f;
  }

  for (int kt0 = 0; kt0 < b.n_ctx; kt0 += kFmaKeys) {
    float s[kFmaRPT][2];
#pragma unroll
    for (int i = 0; i < kFmaRPT; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kWideChunk) {
      __syncthreads();  // the previous readers of sQ, sK (and the last tile's of sV, sP) are done
      for (int idx = tid; idx < kRows * kWideChunk; idx += kThreads) {
        const int r = idx / kWideChunk;
        const int c = idx % kWideChunk;
        const int qi = r % b.BQ;
        float x = 0.f;
        if (qi < b.n_q && r / b.BQ < b.G && d0 + c < D)
          x = dtt::to_f(q[(((size_t)n * T_len + b.q_start + qi) * Hq + (size_t)kvh * b.G + r / b.BQ) * D + d0 + c]);
        sQ[r * kWideQS + c] = x;
      }
      for (int idx = tid; idx < kFmaKeys * kWideChunk; idx += kThreads) {
        const int kk = idx / kWideChunk;
        const int c = idx % kWideChunk;
        const int j = kt0 + kk;
        float x = 0.f;
        if (j < b.n_ctx && d0 + c < D)
          x = dtt::to_f(k_pool[wide_row(pt, j, page_size) * token_stride + col0 + d0 + c]);
        sK[kk * kWideQS + c] = x;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kWideChunk; d += 4) {
        float4 kv[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) kv[jj] = *reinterpret_cast<const float4*>(sK + (tx + 16 * jj) * kWideQS + d);
#pragma unroll
        for (int i = 0; i < kFmaRPT; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * kWideQS + d);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            s[i][jj] = fmaf(qv.x, kv[jj].x, s[i][jj]);
            s[i][jj] = fmaf(qv.y, kv[jj].y, s[i][jj]);
            s[i][jj] = fmaf(qv.z, kv[jj].z, s[i][jj]);
            s[i][jj] = fmaf(qv.w, kv[jj].w, s[i][jj]);
          }
        }
      }
    }
    // the tile's V slice and (int8) row scales; keys at or past n_ctx zero
    for (int idx = tid; idx < kFmaKeys * kWideSlice; idx += kThreads) {
      const int kk = idx / kWideSlice;
      const int c = idx % kWideSlice;
      const int j = kt0 + kk;
      float x = 0.f;
      if (j < b.n_ctx && c0 + c < D)
        x = dtt::to_f(v_pool[wide_row(pt, j, page_size) * token_stride + col0 + c0 + c]);
      sV[kk * kWideSlice + c] = x;
    }
    if constexpr (kQuant) {
      if (tid < kFmaKeys) {
        const int j = kt0 + tid;
        float ks = 0.f, vs = 0.f;
        if (j < b.n_ctx) {
          const size_t tok = wide_row(pt, j, page_size);
          ks = k_scale[tok];
          vs = v_scale[tok];
        }
        sKs[tid] = ks;
        sVs[tid] = vs;
      }
    }
    __syncthreads();

    // online softmax for keys tx, tx + 16 of each row (a row's 16 tx lanes
    // sit in one half-warp), as the FMA body
#pragma unroll
    for (int i = 0; i < kFmaRPT; ++i) {
      float rmax = dtt::kNegInf;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = kt0 + tx + 16 * jj;
        float v = s[i][jj] * scale;
        if constexpr (kQuant) v *= sKs[tx + 16 * jj];
        s[i][jj] = (j <= qpos[i] && j < b.n_ctx) ? v : dtt::kNegInf;
        rmax = fmaxf(rmax, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float new_m = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - new_m);
      float rsum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float p = expf(s[i][jj] - new_m);
        rsum += p;
        sP[(ty + 16 * i) * kPStride + tx + 16 * jj] = kQuant ? p * sVs[tx + 16 * jj] : p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = new_m;
#pragma unroll
      for (int c = 0; c < CW; ++c) o[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kFmaKeys; ++kk) {
      float vv[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) vv[c] = sV[kk * kWideSlice + tx + 16 * c];  // past D: zero
#pragma unroll
      for (int i = 0; i < kFmaRPT; ++i) {
        const float p = sP[(ty + 16 * i) * kPStride + kk];
#pragma unroll
        for (int c = 0; c < CW; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kFmaRPT; ++i) {
    const int r = ty + 16 * i;
    const int qi = r % b.BQ;
    if (qi >= b.n_q || r / b.BQ >= b.G) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    TQ* dst = out + (((size_t)n * T_len + b.q_start + qi) * Hq + (size_t)kvh * b.G + r / b.BQ) * D + c0 + tx;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (c0 + tx + 16 * c < D) dtt::store1(dst + 16 * c, o[i][c] / denom);
  }
}

// ---------------------------------------------------------------- K7a

// K2's load stream with no math up to D 256 (prefill_load_twin_wide takes
// the wider rows): bf16 / int8 pools through the tensor-core body's ring
// (int8 converted as there), f32 pools through the FMA body's staging; every
// row of the block gets the column sums of its context.
template <typename TK, int D>
struct Twin {
  static_assert(D <= kThreads && kThreads % D == 0, "up to D 256");
  static constexpr bool kStaged = std::is_same<TK, float>::value;
  // partial column sums reduced at the end: staged, kThreads / D threads a
  // column; the ring, one a (key in a group of 8, key group) of a chunk
  // column, read as the tile's 16-byte chunks
  static constexpr int kPartials = kStaged ? kThreads / D : kThreads / (D / 8);
  static constexpr size_t kSmem =
      (kStaged ? ((size_t)kFmaKeys * (D + 4) + kFmaKeys * D + 2 * kFmaKeys) * sizeof(float)
               : (size_t)Ring<TK, D>::kStages * Ring<TK, D>::kStage + (Ring<TK, D>::kQuant ? 2 * Ring<TK, D>::kBf16Tile : 0)) +
      (size_t)kPartials * D * sizeof(float);
};

template <typename TK, int D>
__global__ void __launch_bounds__(kThreads)
prefill_load_twin(const TK* __restrict__ k_pool, const TK* __restrict__ v_pool, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ page_tables,
                  const int* __restrict__ positions, float* __restrict__ out, int T_len, int Hq, int Hkv,
                  int page_size, int max_pages) {
  using R = Ring<TK, D>;

  extern __shared__ __align__(128) uint8_t smem[];
  const Block b = block_of(positions, T_len, Hq, Hkv, page_size, max_pages);
  const int kvh = blockIdx.y;
  const int n = blockIdx.z;
  const int* pt = page_tables + (size_t)n * max_pages;
  const size_t token_stride = (size_t)Hkv * D;
  float* red;

  if constexpr (Twin<TK, D>::kStaged) {
    using T = Twin<TK, D>;
    constexpr int KS = D + 4;  // the FMA body's K-tile row stride
    float* sK = reinterpret_cast<float*>(smem);  // [kFmaKeys][KS]
    float* sV = sK + kFmaKeys * KS;              // [kFmaKeys][D]
    float* sKs = sV + kFmaKeys * D;              // [kFmaKeys] (int8)
    float* sVs = sKs + kFmaKeys;                 // [kFmaKeys]
    red = sVs + kFmaKeys;                        // [kPartials][D]
    const int part = threadIdx.x / D;
    const int c = threadIdx.x % D;  // this thread's column
    float sum = 0.f;
    for (int kt0 = 0; kt0 < b.n_ctx; kt0 += kFmaKeys) {
      __syncthreads();  // the previous tile's readers are done
      stage_kv<TK>(sK, sV, sKs, sVs, k_pool, v_pool, k_scale, v_scale, pt, kt0, b.n_ctx, page_size, KS, D,
                   token_stride, kvh * D, D);
      __syncthreads();
      for (int kk = part; kk < kFmaKeys; kk += T::kPartials) sum += sK[kk * KS + c] + sV[kk * D + c];
    }
    red[part * D + c] = sum;
  } else {
    constexpr int CPR = D / 8;                      // bf16 chunks a row
    constexpr int GROUPS = kThreads / (8 * CPR);    // key groups summed side by side
    uint8_t* ring = smem;
    uint8_t* conv = ring + R::kStages * R::kStage;
    red = reinterpret_cast<float*>(conv + (R::kQuant ? 2 * R::kBf16Tile : 0));
    const int jl = threadIdx.x % 8;
    const int cc = (threadIdx.x / 8) % CPR;
    const int jg0 = threadIdx.x / (8 * CPR);
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    const int n_tiles = (b.n_ctx + kTile - 1) / kTile;
#pragma unroll
    for (int st = 0; st < R::kStages - 1; ++st) {
      if (st < n_tiles)
        start_tile<TK, D>(ring + st * R::kStage, k_pool, v_pool, k_scale, v_scale, pt, st * kTile, b.n_ctx,
                          page_size, token_stride, kvh * D, D);
      cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int nxt = t + R::kStages - 1;
      if (nxt < n_tiles)
        start_tile<TK, D>(ring + (nxt % R::kStages) * R::kStage, k_pool, v_pool, k_scale, v_scale, pt,
                          nxt * kTile, b.n_ctx, page_size, token_stride, kvh * D, D);
      cp_async_commit();
      const uint8_t* stage = ring + (t % R::kStages) * R::kStage;
      const uint8_t* tk = land_tile<TK, D>(stage, conv);
      const float* sKs = reinterpret_cast<const float*>(stage + 2 * R::kRaw);
      // keys at or past n_ctx were zero-filled (int8: zero scales too)
      for (int jg = jg0; jg < kTile / 8; jg += GROUPS) {
        const int chunk = (jg * CPR + cc) * 8 + jl;
        float kf[8], vf[8];
        dtt::to_float(*reinterpret_cast<const uint4*>(tk + chunk * 16), kf);
        dtt::to_float(*reinterpret_cast<const uint4*>(tk + R::kBf16Tile + chunk * 16), vf);
        float ks = 1.f, vs = 1.f;
        if constexpr (R::kQuant) {
          ks = sKs[jg * 8 + jl];
          vs = sKs[kTile + jg * 8 + jl];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += kf[e] * ks + vf[e] * vs;
      }
      __syncthreads();  // this stage's readers are done before it is refilled
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(jg0 * 8 + jl) * D + cc * 8 + e] = acc[e];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {  // column d: this thread alone
    float a = 0.f;
#pragma unroll
    for (int p = 0; p < Twin<TK, D>::kPartials; ++p) a += red[p * D + d];
    red[d] = a;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int qi = r / b.G;
    if (qi >= b.n_q) continue;
    out[(((size_t)n * T_len + b.q_start + qi) * Hq + (size_t)kvh * b.G + r % b.G) * D + idx % D] = red[idx % D];
  }
}

// K7a past head_dim 256: wide_prefill_kernel's grid (kv head x column
// slice), context bound and loads (per 32-key tile, K in kWideChunk-column
// chunks of the whole row, then the tile's V slice, staged as f32 an element
// at a time, int8 with the rows' scales) with no math but the sums: thread c
// of a half of the block sums slice column c of the K chunk that holds it
// and of V over its keys (half, half + 2, ..), int8 rows dequantized; every
// row of the block gets the slice's column sums.
constexpr size_t wide_twin_smem_bytes() {
  return ((size_t)kFmaKeys * kWideQS + kFmaKeys * kWideSlice + 2 * kFmaKeys + 2 * kWideSlice) * sizeof(float);
}

template <typename TK>
__global__ void __launch_bounds__(kThreads)
prefill_load_twin_wide(const TK* __restrict__ k_pool, const TK* __restrict__ v_pool,
                       const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                       const int* __restrict__ page_tables, const int* __restrict__ positions, float* __restrict__ out,
                       int T_len, int Hq, int Hkv, int D, int page_size, int max_pages, int n_cs) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  static_assert(kThreads == 2 * kWideSlice, "two threads a slice column");
  extern __shared__ float4 smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [kFmaKeys][kWideQS]: a chunk of K
  float* sV = sK + kFmaKeys * kWideQS;             // [kFmaKeys][kWideSlice]: the tile's V slice
  float* sKs = sV + kFmaKeys * kWideSlice;         // [kFmaKeys]
  float* sVs = sKs + kFmaKeys;                     // [kFmaKeys]
  float* red = sVs + kFmaKeys;                     // [2][kWideSlice]

  const Block b = block_of(positions, T_len, Hq, Hkv, page_size, max_pages);
  const int kvh = blockIdx.y / n_cs;
  const int c0 = (blockIdx.y % n_cs) * kWideSlice;
  const int n = blockIdx.z;
  const int* pt = page_tables + (size_t)n * max_pages;
  const size_t token_stride = (size_t)Hkv * D;
  const size_t col0 = (size_t)kvh * D;
  const int tid = threadIdx.x;
  const int c = tid % kWideSlice;  // this thread's slice column
  const int half = tid / kWideSlice;
  float sum = 0.f;
  for (int kt0 = 0; kt0 < b.n_ctx; kt0 += kFmaKeys) {
    for (int d0 = 0; d0 < D; d0 += kWideChunk) {
      __syncthreads();  // the previous readers of sK (and the last tile's of sV) are done
      for (int idx = tid; idx < kFmaKeys * kWideChunk; idx += kThreads) {
        const int kk = idx / kWideChunk;
        const int cc = idx % kWideChunk;
        const int j = kt0 + kk;
        float x = 0.f;
        if (j < b.n_ctx && d0 + cc < D)
          x = dtt::to_f(k_pool[wide_row(pt, j, page_size) * token_stride + col0 + d0 + cc]);
        sK[kk * kWideQS + cc] = x;
      }
      if (kQuant && d0 == 0 && tid < kFmaKeys) {
        const int j = kt0 + tid;
        const size_t tok = j < b.n_ctx ? wide_row(pt, j, page_size) : 0;
        sKs[tid] = j < b.n_ctx ? k_scale[tok] : 0.f;
        sVs[tid] = j < b.n_ctx ? v_scale[tok] : 0.f;
      }
      __syncthreads();
      const int cc = c0 + c - d0;  // this thread's column in the chunk
      if (cc >= 0 && cc < kWideChunk && c0 + c < D) {
        for (int kk = half; kk < kFmaKeys; kk += 2) sum += kQuant ? sK[kk * kWideQS + cc] * sKs[kk] : sK[kk * kWideQS + cc];
      }
    }
    for (int idx = tid; idx < kFmaKeys * kWideSlice; idx += kThreads) {
      const int kk = idx / kWideSlice;
      const int cc = idx % kWideSlice;
      const int j = kt0 + kk;
      float x = 0.f;
      if (j < b.n_ctx && c0 + cc < D)
        x = dtt::to_f(v_pool[wide_row(pt, j, page_size) * token_stride + col0 + c0 + cc]);
      sV[kk * kWideSlice + cc] = x;
    }
    __syncthreads();
    for (int kk = half; kk < kFmaKeys; kk += 2) sum += kQuant ? sV[kk * kWideSlice + c] * sVs[kk] : sV[kk * kWideSlice + c];
  }
  red[half * kWideSlice + c] = sum;
  __syncthreads();
  for (int idx = tid; idx < kRows * kWideSlice; idx += kThreads) {
    const int r = idx / kWideSlice;
    const int cc = idx % kWideSlice;
    const int qi = r / b.G;
    if (qi >= b.n_q || c0 + cc >= D) continue;
    out[(((size_t)n * T_len + b.q_start + qi) * Hq + (size_t)kvh * b.G + r % b.G) * D + c0 + cc] =
        red[cc] + red[kWideSlice + cc];
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

dim3 prefill_grid(const PrefillArgs& a) {
  const int BQ = kRows / (a.Hq / a.Hkv);
  return dim3((a.T_len + BQ - 1) / BQ, a.Hkv, a.N);
}

// DP: a.D rounded up to a multiple of 16
template <typename TQ, typename TK, int DP>
int launch_attention(const PrefillArgs& a) {
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  if constexpr (std::is_same<TQ, float>::value) {
    constexpr size_t smem = fma_smem_bytes<DP>();
    const cudaError_t err = dtt::raise_smem_limit_once(fma_prefill_kernel<float, TK, DP, false>, smem_raised, smem);
    if (err != cudaSuccess) return (int)err;
    fma_prefill_kernel<float, TK, DP, false><<<prefill_grid(a), kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks, a.vs,
        a.pt, a.pos, static_cast<float*>(a.out), a.T_len, a.Hq, a.Hkv, a.D, a.ps, a.max_pages,
        1.0f / sqrtf((float)a.D));
  } else {
    constexpr size_t smem = Ring<TK, DP>::kSmem;
    const cudaError_t err = dtt::raise_smem_limit_once(tc_prefill_kernel<TK, DP>, smem_raised, smem);
    if (err != cudaSuccess) return (int)err;
    tc_prefill_kernel<TK, DP><<<prefill_grid(a), kThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks,
        a.vs, a.pt, a.pos, static_cast<__nv_bfloat16*>(a.out), a.T_len, a.Hq, a.Hkv, a.D, a.ps, a.max_pages,
        1.4426950408889634f / sqrtf((float)a.D));
  }
  return (int)cudaGetLastError();
}

// The FMA body at any D below DP, rows read an element at a time.
template <typename TQ, typename TK, int DP>
int launch_narrow(const PrefillArgs& a) {
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  constexpr size_t smem = fma_smem_bytes<DP>();
  const cudaError_t err = dtt::raise_smem_limit_once(fma_prefill_kernel<TQ, TK, DP, true>, smem_raised, smem);
  if (err != cudaSuccess) return (int)err;
  fma_prefill_kernel<TQ, TK, DP, true><<<prefill_grid(a), kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks, a.vs, a.pt,
      a.pos, static_cast<TQ*>(a.out), a.T_len, a.Hq, a.Hkv, a.D, a.ps, a.max_pages, 1.0f / sqrtf((float)a.D));
  return (int)cudaGetLastError();
}

// Head dims past 256, every mix: the wide FMA body, slices of kWideSlice
// output columns over the grid's y dimension beside the kv head.
template <typename TQ, typename TK>
int launch_wide(const PrefillArgs& a) {
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  constexpr size_t smem = wide_smem_bytes();
  const cudaError_t err = dtt::raise_smem_limit_once(wide_prefill_kernel<TQ, TK>, smem_raised, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_cs = (a.D + kWideSlice - 1) / kWideSlice;
  dim3 grid = prefill_grid(a);
  grid.y *= n_cs;
  wide_prefill_kernel<TQ, TK><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks, a.vs, a.pt,
      a.pos, static_cast<TQ*>(a.out), a.T_len, a.Hq, a.Hkv, a.D, a.ps, a.max_pages, n_cs, 1.0f / sqrtf((float)a.D));
  return (int)cudaGetLastError();
}

template <typename TK, int D>
int launch_k7a(const PrefillArgs& a) {
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  constexpr size_t smem = Twin<TK, D>::kSmem;
  const cudaError_t err = dtt::raise_smem_limit_once(prefill_load_twin<TK, D>, smem_raised, smem);
  if (err != cudaSuccess) return (int)err;
  prefill_load_twin<TK, D><<<prefill_grid(a), kThreads, smem, a.stream>>>(
      static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks, a.vs, a.pt, a.pos,
      static_cast<float*>(a.out), a.T_len, a.Hq, a.Hkv, a.ps, a.max_pages);
  return (int)cudaGetLastError();
}

template <typename TK>
int launch_k7a_wide(const PrefillArgs& a) {
  static std::atomic<bool> smem_raised[dtt::kMaxDevices];
  constexpr size_t smem = wide_twin_smem_bytes();
  const cudaError_t err = dtt::raise_smem_limit_once(prefill_load_twin_wide<TK>, smem_raised, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_cs = (a.D + kWideSlice - 1) / kWideSlice;
  dim3 grid = prefill_grid(a);
  grid.y *= n_cs;
  prefill_load_twin_wide<TK><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.ks, a.vs, a.pt, a.pos, static_cast<float*>(a.out),
      a.T_len, a.Hq, a.Hkv, a.D, a.ps, a.max_pages, n_cs);
  return (int)cudaGetLastError();
}

// K2: 64, 128 and 256 on the bodies of their mix; any larger multiple of
// 128 on the wide FMA body.
template <typename TQ, typename TK>
struct K2Types {
  static int run(const PrefillArgs& a) {
    switch (a.D) {
      case 64: return launch_attention<TQ, TK, 64>(a);
      case 128: return launch_attention<TQ, TK, 128>(a);
      case 256: return launch_attention<TQ, TK, 256>(a);
      default: break;
    }
    if (a.D % 128 || a.D < 384) return (int)cudaErrorInvalidValue;
    return launch_wide<TQ, TK>(a);
  }
};

// K3b: any D > 0. A multiple of 8 below 128: the body of its mix in
// tiles padded to 16; a multiple of 8 above 128: bf16 queries the
// tensor-core body at 256 (K2's instance, the pad columns zero), f32 queries
// the narrow FMA body; no multiple of 8: the narrow FMA body; past 256: the
// wide FMA body.
template <typename TQ, typename TK>
struct K3bTypes {
  static int run(const PrefillArgs& a) {
    if (a.D <= 0) return (int)cudaErrorInvalidValue;
    if (a.D > 256) return launch_wide<TQ, TK>(a);
    constexpr bool kBf16 = std::is_same<TQ, __nv_bfloat16>::value;
    if (a.D % 8 || (a.D > 128 && !kBf16))
      return a.D < 128 ? launch_narrow<TQ, TK, 128>(a) : launch_narrow<TQ, TK, 256>(a);
    if (a.D > 128) return launch_attention<TQ, TK, 256>(a);
    switch ((a.D + 15) / 16) {
      case 1: return launch_attention<TQ, TK, 16>(a);
      case 2: return launch_attention<TQ, TK, 32>(a);
      case 3: return launch_attention<TQ, TK, 48>(a);
      case 4: return launch_attention<TQ, TK, 64>(a);
      case 5: return launch_attention<TQ, TK, 80>(a);
      case 6: return launch_attention<TQ, TK, 96>(a);
      case 7: return launch_attention<TQ, TK, 112>(a);
      case 8: return launch_attention<TQ, TK, 128>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
};

// K7a reads no queries: TQ only selects the pool mix, as for K2. Past D 256
// it shadows the wide FMA body.
template <typename TQ, typename TK>
struct K7aTypes {
  static int run(const PrefillArgs& a) {
    switch (a.D) {
      case 64: return launch_k7a<TK, 64>(a);
      case 128: return launch_k7a<TK, 128>(a);
      case 256: return launch_k7a<TK, 256>(a);
      default: break;
    }
    if (a.D % 128 || a.D < 384) return (int)cudaErrorInvalidValue;
    return launch_k7a_wide<TK>(a);
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
  return a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.Hq / a.Hkv <= kRows && a.ps > 0 && a.max_pages > 0 &&
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
