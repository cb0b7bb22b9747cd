// K8: the weight-only int8 linear (W8A16) for Hopper (sm_90a).
//
// It computes the function of dynamo_tpu/quant/int8.py qlinear and
// qlinear_expert: y = ((h @ q) accumulated in f32) * s, cast to h's dtype,
// with h [E, T, K] (bf16, or f32 for the parity runs), q int8 [E, K, N] (the
// reference's [.., in, out] layout), s f32 [E, N] per output channel; E = 1
// for a plain linear, the expert count for an MoE bank. On the TPU this is
// no Pallas kernel: XLA fuses the int8 -> bf16 convert into the dot's
// operand read, so HBM carries the int8 bytes.
//
// What bounds it on an H100: at decode sizes (T <= 64 rows) the weight
// stream, 1 byte a weight (Llama-3-8B's wq at T 16: 17.1 MB, 5.1 us at 3.35
// TB/s, where a bf16 weight would read 2 bytes); at prefill sizes the bf16
// tensor-core rate (2 T K N operations).
//
// Two bodies; the launcher picks one from h's dtype and N alone.
//
// w8a16_wgmma (bf16 h, N % 16 == 0: every served shape). Each output tile
// is computed transposed, Y^T = Q^T . h^T, so that the int8 weight is
// wgmma's A operand, the only one that can come from registers, and the
// tokens are its N (any multiple of 8: T 16 runs m64n16k16):
//   - a block is two consumer warpgroups and a producer (a warpgroup whose
//     registers setmaxnreg moves to the consumers at prefill sizes, one
//     warp at decode sizes). One producer thread keeps a ring of 64-deep K
//     stages filled by TMA, full and empty mbarriers a stage: the int8 box
//     is 64 k rows x 128 output bytes of the [K, N] tensor, the h box BT
//     token rows x 64 bf16, both in 128-byte swizzle. Loads past an edge
//     fill zeros (T, N and K tails).
//   - a consumer warpgroup owns 128 output channels as two 64-row M tiles.
//     Thread (warp w, g = lane / 4, t = lane % 4) reads the 32-bit word at
//     channels 32 w + 4 g .. + 3 of k rows 2t, 2t + 1, 2t + 8, 2t + 9 of a
//     k16 slice (the swizzle's XOR in every address: the four rows' words of
//     a warp fall in distinct banks) and spreads its four bytes over the A
//     fragments' rows: byte 2 j + half is M tile j's row 16 w + g + 8 half.
//     The bytes become bf16 in registers by byte permutes and one f32 add a
//     value (exact for |q| <= 127), and the epilogue puts the channels back
//     in order: each thread then holds 4 consecutive channels a token.
//   - h is B, read by wgmma from the swizzled K-major box (descriptor layout
//     type 1); a width with no instruction (24, 40, 48, 56, 96) is pieces of
//     128, 64, 32, 16 and 8. A's registers are double-buffered over k16
//     slices: the next slice converts while this one's wgmma runs (and the
//     other warpgroup's conversion overlaps this one's products).
//   - tiles by T: T <= 64 ("deep"): BT = T rounded up to 8, a block owns 128
//     channels and its two warpgroups take alternate stages (twice the
//     blocks of a 256-channel tile, for the weight stream); T > 64: BT 96 or
//     128, a block owns 256 channels, each warpgroup 128 of every stage.
//   - split-K inside a thread-block cluster: when the tiles leave the 132
//     SMs idle, the 2 to 8 blocks of a cluster take consecutive K ranges.
//     Each block writes its f32 partials to its own shared memory; after a
//     cluster barrier every block sums one slice of the tile over the
//     cluster's blocks (distributed shared memory, rank order, then
//     warpgroup order), applies the scale and stores. No second launch, no
//     workspace, no atomics: two launches give the same bits.
//
// w8a16_kernel (the mma body: f32 h, the 2-layer parity runs, and N % 16 !=
// 0, which TMA's 16-byte strides refuse):
//   - a block owns a BM x 128 output tile (BM = 16 MF rows of h, MF 1, 2, 4
//     or 8 by T) and a range of K; 4 warps, warp w owns output columns
//     32 w .. 32 w + 31 (four n8 fragments) of every row. Column j of
//     fragment nf is output column 32 w + 4 j + nf, so a thread's four
//     fragments take their q bytes from one 32-bit word a k row, and its
//     accumulators hold 8 consecutive output columns a row.
//   - K in 64-deep tiles through a three-stage cp.async ring: the h tile
//     (rows padded to keep the fragment loads free of bank conflicts) and the
//     int8 q tile (64 rows of 128 bytes, 16-byte copies, or 4-byte copies
//     when N is no multiple of 16); rows and columns past the edges are
//     zero-filled, so any T, K % 8 == 0 and N % 4 == 0 launch.
//   - thread (g, t) reads the words of k rows 2t, 2t + 1, 2t + 8, 2t + 9 at
//     its 4 columns (conflict-free) and builds the bf16 B fragments in
//     registers as the wgmma body does; h's fragments come by ldmatrix; S +=
//     h . q by mma.sync m16n8k16 in f32 accumulators. f32 activations split
//     into bf16 hi + lo (two products), which keeps them f32-accurate.
//   - the per-channel scale is applied in the epilogue. When T is small K is
//     split over blocks: each split writes its f32 partial tile to a
//     workspace and w8a16_reduce sums the splits in a fixed order, applies
//     the scale and casts.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace dtt;

constexpr int kBN = 128;  // output columns a block
constexpr int kBK = 64;   // K a stage
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kBRow = kBN + 16;  // int8 q tile row bytes (padded: conflict-free byte reads)

template <typename TA>
struct ATile {
  // h tile row bytes, padded so the fragment loads of 8 rows x 4 threads
  // fall in distinct banks (bf16: 32-bit loads, f32: 64-bit loads)
  static constexpr int kRow = kBK * (int)sizeof(TA) + (sizeof(TA) == 4 ? 32 : 16);
};

template <typename TA, int MF>
struct Smem {
  static constexpr int kA = 16 * MF * ATile<TA>::kRow;
  static constexpr int kStage = kA + kBK * kBRow;
  static constexpr int kBytes = kStages * kStage;
};

struct Call {
  const void* h;
  const int8_t* q;
  const float* s;
  void* out;
  float* ws;
  int E, T, K, N, n_split, k_per_split;
};

// Byte `b` of a word of int8 codes already XORed with 0x80808080 (u = q +
// 128): 0x4B0000uu is the f32 2^23 + u, so subtracting 2^23 + 128 gives q
// exactly.
__device__ __forceinline__ float q_value(uint32_t x, int b) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | b)) - 8388736.f;
}

// Two small integers' floats as a bf16 pair (lo in the low half): their
// upper halves, exact for integers of up to 8 significant bits.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The A fragment of the 16 x 16 tile at row r0, column c0 of the bf16 h
// stage, by ldmatrix (row lane % 16, 8-column chunk lane / 16).
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const unsigned char* tile, int r0, int c0, int lane) {
  constexpr int R = ATile<__nv_bfloat16>::kRow;
  ldsm_x4(a, smem_u32(tile + (r0 + lane % 16) * R + (c0 + (lane / 16) * 8) * 2));
}

// The same fragment of an f32 tile, split into bf16 hi and lo.
__device__ __forceinline__ void a_frag_split(uint32_t (&hi)[4], uint32_t (&lo)[4], const unsigned char* tile, int r0,
                                             int c0, int g, int t) {
  constexpr int R = ATile<float>::kRow;
  const unsigned char* p = tile + (r0 + g) * R + (c0 + 2 * t) * 4;
  const float2 v[4] = {*reinterpret_cast<const float2*>(p), *reinterpret_cast<const float2*>(p + 8 * R),
                       *reinterpret_cast<const float2*>(p + 32), *reinterpret_cast<const float2*>(p + 8 * R + 32)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat16 hx = __float2bfloat16_rn(v[i].x), hy = __float2bfloat16_rn(v[i].y);
    hi[i] = pack_bf16(__bfloat162float(hx), __bfloat162float(hy));
    lo[i] = pack_bf16(v[i].x - __bfloat162float(hx), v[i].y - __bfloat162float(hy));
  }
}

template <typename TA, int MF>
__device__ __forceinline__ void load_stage(const Call& c, unsigned char* stage, int e, int m0, int n0, int k0,
                                           int k_end) {
  constexpr int BM = 16 * MF;
  constexpr int R = ATile<TA>::kRow;
  constexpr int kPerChunk = 16 / (int)sizeof(TA);
  constexpr int kChunksA = kBK / kPerChunk;  // 16-byte chunks of an h row
  const TA* h = static_cast<const TA*>(c.h) + (size_t)e * c.T * c.K;
  for (int i = threadIdx.x; i < BM * kChunksA; i += kThreads) {
    const int r = i / kChunksA, ch = i % kChunksA;
    const int row = m0 + r, col = k0 + ch * kPerChunk;
    const bool ok = row < c.T && col < k_end;
    cp_async16(smem_u32(stage + r * R + ch * 16), ok ? h + (size_t)row * c.K + col : h, ok);
  }
  const int8_t* q = c.q + (size_t)e * c.K * c.N;
  unsigned char* b = stage + Smem<TA, MF>::kA;
  if (c.N % 16 == 0) {
    for (int i = threadIdx.x; i < kBK * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), ch = i % (kBN / 16);
      const int row = k0 + r, col = n0 + ch * 16;
      const bool ok = row < k_end && col < c.N;
      cp_async16(smem_u32(b + r * kBRow + ch * 16), ok ? q + (size_t)row * c.N + col : q, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4), ch = i % (kBN / 4);
      const int row = k0 + r, col = n0 + ch * 4;
      const bool ok = row < k_end && col < c.N;
      cp_async4(smem_u32(b + r * kBRow + ch * 4), ok ? q + (size_t)row * c.N + col : q, ok);
    }
  }
}

// The first n of 8 consecutive values of a row: one or two 16-byte
// stores where all 8 are in bounds and aligned, else one at a time.
__device__ __forceinline__ void store_row8(float* p, const float (&v)[8], int n) {
  if (n == 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int j = 0; j < n; ++j) p[j] = v[j];
  }
}

__device__ __forceinline__ void store_row8(__nv_bfloat16* p, const float (&v)[8], int n) {
  if (n == 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                                              pack_bf16(v[6], v[7]));
  } else {
    for (int j = 0; j < n; ++j) p[j] = __float2bfloat16_rn(v[j]);
  }
}

// grid (N tiles, T tiles, E x n_split)
template <typename TA, int MF>
__global__ void __launch_bounds__(kThreads) w8a16_kernel(Call c) {
  constexpr int BM = 16 * MF;
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = blockIdx.z / c.n_split, split = blockIdx.z % c.n_split;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_begin = split * c.k_per_split;
  const int k_end = min(c.K, k_begin + c.k_per_split);
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  float acc[MF][4][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      load_stage<TA, MF>(c, smem + st * Smem<TA, MF>::kStage, e, m0, n0, k_begin + st * kBK, k_end);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed for every thread; every warp is done with tile kt - 1
    const int next = kt + kStages - 1;
    if (next < n_tiles)
      load_stage<TA, MF>(c, smem + (next % kStages) * Smem<TA, MF>::kStage, e, m0, n0, k_begin + next * kBK,
                         k_end);
    cp_async_commit();
    const unsigned char* a_tile = smem + (kt % kStages) * Smem<TA, MF>::kStage;
    const int8_t* b_tile = reinterpret_cast<const int8_t*>(a_tile + Smem<TA, MF>::kA);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // fragment nf's column g is output column 32 warp + 4 g + nf: byte nf
      // of the word at this thread's 4 columns, in each of its 4 k rows
      const int8_t* p = b_tile + (kk + 2 * t) * kBRow + warp * 32 + 4 * g;
      const uint32_t w[4] = {*reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u,
                             *reinterpret_cast<const uint32_t*>(p + kBRow) ^ 0x80808080u,
                             *reinterpret_cast<const uint32_t*>(p + 8 * kBRow) ^ 0x80808080u,
                             *reinterpret_cast<const uint32_t*>(p + 9 * kBRow) ^ 0x80808080u};
      uint32_t b[4][2];
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        b[nf][0] = bf16_pair(q_value(w[0], nf), q_value(w[1], nf));
        b[nf][1] = bf16_pair(q_value(w[2], nf), q_value(w[3], nf));
      }
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        if constexpr (sizeof(TA) == 2) {
          uint32_t a[4];
          a_frag(a, a_tile, mf * 16, kk, lane);
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) mma_bf16_16816(acc[mf][nf], a, b[nf][0], b[nf][1]);
        } else {
          uint32_t hi[4], lo[4];
          a_frag_split(hi, lo, a_tile, mf * 16, kk, g, t);
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) {
            mma_bf16_16816(acc[mf][nf], hi, b[nf][0], b[nf][1]);
            mma_bf16_16816(acc[mf][nf], lo, b[nf][0], b[nf][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: thread (g, t) holds rows g, g + 8 of each row fragment at
  // output columns 32 warp + 8 t + j, j = 0..7: fragment j % 4's value at
  // its column 2t (j < 4) or 2t + 1
  const float* s = c.s + (size_t)e * c.N;
  const int col = n0 + warp * 32 + 8 * t;
  const int n_valid = min(8, c.N - col);
  if (n_valid <= 0) return;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + mf * 16 + g + 8 * half;
      if (row >= c.T) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = acc[mf][j % 4][2 * half + j / 4];
      if (c.n_split == 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] *= j < n_valid ? s[col + j] : 0.f;
        store_row8(static_cast<TA*>(c.out) + ((size_t)e * c.T + row) * c.N + col, v, n_valid);
      } else {
        store_row8(c.ws + (((size_t)split * c.E + e) * c.T + row) * c.N + col, v, n_valid);
      }
    }
}

// out[e, t, n] = cast((sum over splits, in order, of ws[split, e, t, n]) * s[e, n])
template <typename TA>
__global__ void w8a16_reduce(Call c) {
  const size_t total = (size_t)c.E * c.T * c.N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int sp = 0; sp < c.n_split; ++sp) sum += c.ws[(size_t)sp * total + i];
    const size_t e = i / ((size_t)c.T * c.N);
    store1(static_cast<TA*>(c.out) + i, sum * c.s[e * c.N + i % c.N]);
  }
}

template <typename TA, int MF>
int launch(const Call& c, cudaStream_t stream) {
  static std::atomic<bool> raised[kMaxDevices];
  constexpr int smem = Smem<TA, MF>::kBytes;
  cudaError_t err = raise_smem_limit_once(w8a16_kernel<TA, MF>, raised, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c.N + kBN - 1) / kBN, (c.T + 16 * MF - 1) / (16 * MF), c.E * c.n_split);
  w8a16_kernel<TA, MF><<<grid, kThreads, smem, stream>>>(c);
  if (c.n_split > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t total = (size_t)c.E * c.T * c.N;
    const int blocks = (int)std::min<size_t>((total + 255) / 256, 132 * 8);
    w8a16_reduce<TA><<<blocks, 256, 0, stream>>>(c);
  }
  return (int)cudaGetLastError();
}

// f32 activations stop at 64-row tiles: their hi + lo fragments at 128 rows
// exceed the register file
template <typename TA>
int launch_mf(const Call& c, int mf, cudaStream_t stream) {
  switch (mf) {
    case 1: return launch<TA, 1>(c, stream);
    case 2: return launch<TA, 2>(c, stream);
    case 4: return launch<TA, 4>(c, stream);
    case 8:
      if constexpr (sizeof(TA) == 2) return launch<TA, 8>(c, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------- the wgmma body

namespace wg {

using namespace dtt::hop;

constexpr int kBK = 64;               // K rows a stage
constexpr int kCols = 128;            // output channels a consumer warpgroup
constexpr int kQBox = kBK * kCols;    // one int8 box: 64 k rows x 128 channels, 8 KiB
constexpr int kRingBytes = 200 * 1024;

// BT token rows a tile; DEEP: the block's two warpgroups share 128 channels
// and take alternate stages, else each owns 128 of 256 and takes every stage
template <int BT, bool DEEP>
struct Cfg {
  static_assert(BT % 8 == 0 && BT <= 128, "BT is a multiple of 8 up to 128");
  // consumer warpgroups 0 and 1, then the producer: at prefill sizes a
  // whole warpgroup, so that setmaxnreg can hand its registers to the
  // consumers' 128 accumulators a thread; at decode sizes one warp (the
  // consumers need few registers, and the block's fixed costs count)
  static constexpr int kThreads = DEEP ? 288 : 384;
  static constexpr int kBlockCols = DEEP ? kCols : 2 * kCols;
  static constexpr int kQBytes = DEEP ? kQBox : 2 * kQBox;
  static constexpr int kStage = kQBytes + BT * 128;  // + the h box: BT rows of 64 bf16
  static constexpr int kStages = kRingBytes / kStage < 16 ? kRingBytes / kStage : 16;
  static constexpr int kPartial = 2 * BT * 128 * 4;  // both warpgroups' f32 accumulators
  static constexpr int kRing = kStages * kStage > kPartial ? kStages * kStage : kPartial;
  static constexpr int kSmem = 1024 + kRing + 2 * kStages * 8;  // alignment slack, ring, full + empty barriers
};

struct Call {
  const float* s;
  void* out;
  int T, K, N, n_split, k_per_split;
  uint32_t magic;  // 0x4B000000, the f32 2^23 (q_byte)
};

// d [BT / 2] += A . h rows R.. of the tile at `h` (its k16 slice's address):
// one wgmma a piece of 128, 64, 32, 16 or 8 rows
template <int BT, int R = 0>
__device__ __forceinline__ void mma_rows(float (&d)[BT / 2], const uint32_t (&a)[4], uint32_t h) {
  constexpr int left = BT - R;
  if constexpr (left >= 128) {
    wgmma_rs_n128<R / 2>(d, a, desc_k_sw128(h + R * 128));
    mma_rows<BT, R + 128>(d, a, h);
  } else if constexpr (left >= 64) {
    wgmma_rs_n64<R / 2>(d, a, desc_k_sw128(h + R * 128));
    mma_rows<BT, R + 64>(d, a, h);
  } else if constexpr (left >= 32) {
    wgmma_rs_n32<R / 2>(d, a, desc_k_sw128(h + R * 128));
    mma_rows<BT, R + 32>(d, a, h);
  } else if constexpr (left >= 16) {
    wgmma_rs_n16<R / 2>(d, a, desc_k_sw128(h + R * 128));
    mma_rows<BT, R + 16>(d, a, h);
  } else if constexpr (left >= 8) {
    wgmma_rs_n8<R / 2>(d, a, desc_k_sw128(h + R * 128));
  }
}

__device__ __forceinline__ void store_quad(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// q_value with the byte's selector an immediate and 2^23's bits a kernel
// parameter, which the byte permute reads from the parameter bank: no
// register holds either, where four selectors would compete with the 128
// accumulators of a prefill tile (and were rematerialised every slice)
template <int B>
__device__ __forceinline__ float q_byte(uint32_t x, uint32_t magic) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(x), "r"(magic), "n"(0x7440 | B));
  return __uint_as_float(r) - 8388736.f;
}

template <int J>
__device__ __forceinline__ void tile_a(uint32_t (&a)[4], const uint32_t (&u)[4], uint32_t magic) {
  a[0] = bf16_pair(q_byte<2 * J>(u[0], magic), q_byte<2 * J>(u[1], magic));
  a[1] = bf16_pair(q_byte<2 * J + 1>(u[0], magic), q_byte<2 * J + 1>(u[1], magic));
  a[2] = bf16_pair(q_byte<2 * J>(u[2], magic), q_byte<2 * J>(u[3], magic));
  a[3] = bf16_pair(q_byte<2 * J + 1>(u[2], magic), q_byte<2 * J + 1>(u[3], magic));
}

// A's fragments of one k16 slice for both M tiles, from the int8 stage at
// p: this thread's words at k rows 2t, 2t + 1, 2t + 8, 2t + 9 (byte
// offsets off0 / off1 in rows 0 and 1, swizzle included); byte 2 j + half
// is M tile j's row g + 8 half
__device__ __forceinline__ void slice_a(uint32_t (&a)[2][4], const unsigned char* p, int off0, int off1,
                                        uint32_t magic) {
  const uint32_t u[4] = {*reinterpret_cast<const uint32_t*>(p + off0) ^ 0x80808080u,
                         *reinterpret_cast<const uint32_t*>(p + off1) ^ 0x80808080u,
                         *reinterpret_cast<const uint32_t*>(p + 8 * 128 + off0) ^ 0x80808080u,
                         *reinterpret_cast<const uint32_t*>(p + 8 * 128 + off1) ^ 0x80808080u};
  tile_a<0>(a[0], u, magic);
  tile_a<1>(a[1], u, magic);
}

// the scaled, cast tile from registers: this thread's channels ch .. ch + 3
// (M tile j, row half: channel ch + 2 j + half) at tokens t0 + 8 nb + 2 t + cc
template <int BT>
__device__ __forceinline__ void store_tile(const float (&acc)[2][BT / 2], int ch, int tok0, const Call& c,
                                           const float* s, __nv_bfloat16* out) {
  if (ch >= c.N) return;
  const float4 sc = *reinterpret_cast<const float4*>(s + ch);
#pragma unroll
  for (int nb = 0; nb < BT / 8; ++nb)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int tok = tok0 + 8 * nb + cc;
      if (tok < c.T) {
        const float y[4] = {acc[0][4 * nb + cc] * sc.x, acc[0][4 * nb + 2 + cc] * sc.y, acc[1][4 * nb + cc] * sc.z,
                            acc[1][4 * nb + 2 + cc] * sc.w};
        store_quad(out + (size_t)tok * c.N + ch, y);
      }
    }
}

// grid (T tiles x n_split, N tiles, E); clusters of n_split blocks along x
template <int BT, bool DEEP>
__global__ void __launch_bounds__(Cfg<BT, DEEP>::kThreads, 1)
    w8a16_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap th, Call c) {
  using C = Cfg<BT, DEEP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle: boxes start 1024-byte aligned
  unsigned char* ring = smem_raw + (base - raw);
  const uint32_t full = base + C::kRing, empty = full + 8 * C::kStages;
  const int rank = blockIdx.x % c.n_split;  // the cluster's rank: clusters run along x
  const int t0 = blockIdx.x / c.n_split * BT, n0 = blockIdx.y * C::kBlockCols, e = blockIdx.z;
  const int k_begin = rank * c.k_per_split;
  const int k_end = min(c.K, k_begin + c.k_per_split);
  const int n_stages = (k_end - k_begin + kBK - 1) / kBK;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, DEEP ? 4 : 8);  // one arrival a consumer warp that reads the stage
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wgi == 2) {
    // ---- producer: one thread keeps the ring full
    if constexpr (!DEEP) setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&th);
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % C::kStages;
        if (s >= C::kStages) mbar_wait(empty + 8 * slot, (s / C::kStages - 1) & 1);
        const uint32_t st = base + slot * C::kStage, bar = full + 8 * slot;
        const int k = k_begin + s * kBK;
        mbar_expect_tx(bar, C::kStage);
        tma_load_3d(st, &tq, bar, n0, k, e);
        if (!DEEP) tma_load_3d(st + kQBox, &tq, bar, n0 + kCols, k, e);
        tma_load_3d(st + C::kQBytes, &th, bar, k, t0, e);
      }
    }
    __syncwarp();
    if (c.n_split > 1) {
      cluster_sync();  // the partials are written
      cluster_sync();  // and read
    }
  } else {
    // ---- consumers
    if constexpr (!DEEP) setmaxnreg_inc<232>();
    const int x = threadIdx.x % 128, warp = x / 32, lane = x % 32, g = lane / 4, t = lane % 4;
    float acc[2][BT / 2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) acc[j][i] = 0.f;
    // this thread's word (channels 32 warp + 4 g ..) in k rows 2t (and 2t + 8)
    // and 2t + 1 (2t + 9) of a k16 slice, 16-byte chunks XORed by row % 8
    const int chunk = 2 * warp + g / 4, within = 4 * (g % 4);
    const int off0 = 2 * t * 128 + ((chunk ^ (2 * t)) << 4) + within;
    const int off1 = (2 * t + 1) * 128 + ((chunk ^ (2 * t + 1)) << 4) + within;
    const int q_off = DEEP ? 0 : wgi * kQBox;
    int prev = -1;  // the slot of this warpgroup's previous stage, released once its last wgmma is done
    // A's fragments, double-buffered over k16 slices: a slice's registers are
    // written while the previous slice's wgmma may still read the other pair
    uint32_t a[2][2][4] = {};
    for (int s = DEEP ? wgi : 0; s < n_stages; s += DEEP ? 2 : 1) {
      const int slot = s % C::kStages;
      mbar_wait(full + 8 * slot, (s / C::kStages) & 1);
      const unsigned char* qt = ring + slot * C::kStage + q_off;
      const uint32_t ht = base + slot * C::kStage + C::kQBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t (&ak)[2][4] = a[kk % 2];
        slice_a(ak, qt + kk * 16 * 128, off0, off1, c.magic);
        fence_regs(ak);
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
        mma_rows<BT>(acc[0], ak[0], ht + kk * 32);
        mma_rows<BT>(acc[1], ak[1], ht + kk * 32);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's products are done
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        fence_regs(a[(kk + 1) % 2]);  // its A registers stay untouched until here
        if (kk == 0 && prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = slot;
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);

    const float* s = c.s + (size_t)e * c.N;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(c.out) + (size_t)e * c.T * c.N;
    bar_sync(1, 256);  // both warpgroups are done with the ring
    if (c.n_split == 1) {
      // ---- epilogue of an unsplit K: from registers (DEEP: warpgroup 1's
      // accumulators added to warpgroup 0's through shared memory)
      if (DEEP) {
        float* part = reinterpret_cast<float*>(ring);  // [tile j][register i][thread x]
        if (wgi == 1) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < BT / 2; ++i) part[(j * (BT / 2) + i) * 128 + x] = acc[j][i];
        }
        bar_sync(1, 256);
        if (wgi == 1) return;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < BT / 2; ++i) acc[j][i] += part[(j * (BT / 2) + i) * 128 + x];
      }
      store_tile<BT>(acc, n0 + (DEEP ? 0 : wgi * kCols) + 32 * warp + 4 * g, t0 + 2 * t, c, s, out);
      return;
    }
    // ---- epilogue of a split K: partials through shared memory, summed over
    // the cluster. A unit is 4 consecutive channels of one token: thread x's
    // registers (tile j, row half) of accumulator column v, one float4
    // [warpgroup][v][x] in each block's ring.
    float4* part4 = reinterpret_cast<float4*>(ring);
#pragma unroll
    for (int v = 0; v < BT / 4; ++v) {
      const int i = 4 * (v / 2) + v % 2;
      part4[(wgi * (BT / 4) + v) * 128 + x] = make_float4(acc[0][i], acc[0][i + 2], acc[1][i], acc[1][i + 2]);
    }
    cluster_sync();
    constexpr int kGroups = DEEP ? 1 : 2;  // channel groups of 128 a block
    constexpr int kUnits = kGroups * (BT / 4) * 128;
    const int per = (kUnits + c.n_split - 1) / c.n_split;  // each block sums a slice of the units
    const int u_end = min(kUnits, (rank + 1) * per);
    for (int u = rank * per + (int)threadIdx.x; u < u_end; u += 256) {
      const int xx = u % 128, v = (u / 128) % (BT / 4), grp = u / (128 * (BT / 4));
      const int tok = t0 + 8 * (v / 2) + 2 * (xx % 4) + v % 2;
      const int ch = n0 + grp * kCols + 32 * (xx / 32) + 4 * ((xx % 32) / 4);
      // every block's partials in flight at once, then summed in rank order
      // (and warpgroup order): the same bits every launch
      float4 got[8][DEEP ? 2 : 1];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int w2 = 0; w2 < (DEEP ? 2 : 1); ++w2)
          if (r < c.n_split)
            got[r][w2] = ld_cluster_v4(map_rank(base + 16 * (((DEEP ? w2 : grp) * (BT / 4) + v) * 128 + xx), r));
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int w2 = 0; w2 < (DEEP ? 2 : 1); ++w2)
          if (r < c.n_split) {
            sum.x += got[r][w2].x;
            sum.y += got[r][w2].y;
            sum.z += got[r][w2].z;
            sum.w += got[r][w2].w;
          }
      if (tok < c.T && ch < c.N) {
        const float4 sc = *reinterpret_cast<const float4*>(s + ch);
        const float y[4] = {sum.x * sc.x, sum.y * sc.y, sum.z * sc.z, sum.w * sc.w};
        store_quad(out + (size_t)tok * c.N + ch, y);
      }
    }
    cluster_sync();  // no block leaves while another reads its partials
  }
}

template <int BT, bool DEEP>
int launch(const CUtensorMap& tq, const CUtensorMap& th, const Call& c, int E, cudaStream_t stream) {
  using C = Cfg<BT, DEEP>;
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = raise_smem_limit_once(w8a16_wgmma<BT, DEEP>, raised, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c.T + BT - 1) / BT * c.n_split, (c.N + C::kBlockCols - 1) / C::kBlockCols, E);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, w8a16_wgmma<BT, DEEP>, tq, th, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// clusters of n_split blocks of this body that can be resident at once
template <int BT, bool DEEP>
int max_clusters(int n_split) {
  using C = Cfg<BT, DEEP>;
  static std::atomic<bool> raised[kMaxDevices];
  if (raise_smem_limit_once(w8a16_wgmma<BT, DEEP>, raised, C::kSmem) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, 1, 1);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, w8a16_wgmma<BT, DEEP>, &cfg) == cudaSuccess ? n : -1;
}

int launch_bt(const CUtensorMap& tq, const CUtensorMap& th, const Call& c, int E, int bt, cudaStream_t stream) {
  switch (bt) {
    case 8: return launch<8, true>(tq, th, c, E, stream);
    case 16: return launch<16, true>(tq, th, c, E, stream);
    case 24: return launch<24, true>(tq, th, c, E, stream);
    case 32: return launch<32, true>(tq, th, c, E, stream);
    case 40: return launch<40, true>(tq, th, c, E, stream);
    case 48: return launch<48, true>(tq, th, c, E, stream);
    case 56: return launch<56, true>(tq, th, c, E, stream);
    case 64: return launch<64, true>(tq, th, c, E, stream);
    case 96: return launch<96, false>(tq, th, c, E, stream);
    case 128: return launch<128, false>(tq, th, c, E, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace wg

}  // namespace

// y [E, T, N] = cast((h [E, T, K] @ q [E, K, N]) * s [E, N]); a_dtype 0 =
// float32, 1 = bfloat16 (h and y); mf: row fragments a block (1, 2, 4, 8;
// float32 up to 4);
// K split over n_split blocks of k_per_split rows (a multiple of 64), their
// f32 partials in ws [n_split, E, T, N] (unused when n_split is 1).
// Refuses (cudaErrorInvalidValue, nothing launched) K % 8 != 0, N % 4 != 0
// and splits that do not cover K.
extern "C" int w8a16_linear(const void* h, const void* q, const void* s, void* out, void* ws, int E, int T, int K,
                            int N, int n_split, int k_per_split, int mf, int a_dtype, void* stream) {
  if (E <= 0 || T <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || N % 4 || n_split <= 0 || k_per_split <= 0 || k_per_split % kBK ||
      (long long)n_split * k_per_split < K || (long long)(n_split - 1) * k_per_split >= K ||
      (n_split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const Call c{h, static_cast<const int8_t*>(q), static_cast<const float*>(s), out, static_cast<float*>(ws),
               E, T, K, N, n_split, k_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0) return launch_mf<float>(c, mf, st);
  if (a_dtype == 1) return launch_mf<__nv_bfloat16>(c, mf, st);
  return (int)cudaErrorInvalidValue;
}

// The wgmma body (bf16 h and y): y [E, T, N] = cast((h [E, T, K] @ q [E, K,
// N]) * s [E, N]) in tiles of bt token rows (8, 16, .. 64: 128-channel
// blocks, warpgroups on alternate stages; 96 or 128: 256-channel blocks),
// K split over clusters of n_split blocks (1 to 8) of k_per_split rows (a
// multiple of 64). Refuses (cudaErrorInvalidValue, nothing launched) K % 8
// != 0, N % 16 != 0, another bt or n_split, and splits that do not cover K
// or leave a block without rows; cudaErrorNotSupported when no tensor map can
// be encoded.
extern "C" int w8a16_wgmma_linear(const void* h, const void* q, const void* s, void* out, int E, int T, int K, int N,
                                  int bt, int n_split, int k_per_split, void* stream) {
  if (E <= 0 || T <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || N % 16 || n_split < 1 || n_split > 8 ||
      k_per_split <= 0 || k_per_split % wg::kBK || (long long)n_split * k_per_split < K ||
      (long long)(n_split - 1) * k_per_split >= K)
    return (int)cudaErrorInvalidValue;
  if (bt != 8 && bt != 16 && bt != 24 && bt != 32 && bt != 40 && bt != 48 && bt != 56 && bt != 64 && bt != 96 &&
      bt != 128)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, th;
  if (!dtt::hop::tensor_map_3d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, E, (uint64_t)N, (uint64_t)K * N,
                               wg::kCols, wg::kBK) ||
      !dtt::hop::tensor_map_3d(&th, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, h, K, T, E, (uint64_t)K * 2,
                               (uint64_t)T * K * 2, wg::kBK, bt))
    return (int)cudaErrorNotSupported;
  const wg::Call c{static_cast<const float*>(s), out, T, K, N, n_split, k_per_split, 0x4B000000u};
  return wg::launch_bt(tq, th, c, E, bt, static_cast<cudaStream_t>(stream));
}

// How many clusters of n_split blocks of the wgmma body at bt rows (8, 16,
// 64: the decode tiles; 128: the prefill tiles) fit on the device at once
// (cudaOccupancyMaxActiveClusters), which int8_linear.py's CLUSTER_BLOCKS
// records for an H100; -1 on an error.
extern "C" int w8a16_wgmma_max_clusters(int bt, int n_split) {
  switch (bt) {
    case 8: return wg::max_clusters<8, true>(n_split);
    case 16: return wg::max_clusters<16, true>(n_split);
    case 64: return wg::max_clusters<64, true>(n_split);
    case 128: return wg::max_clusters<128, false>(n_split);
  }
  return -1;
}
