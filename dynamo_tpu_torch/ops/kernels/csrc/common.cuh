// Shared helpers for the port's hand-written Hopper kernels: vector loads of
// f32 / bf16 / int8 rows converted to f32 registers, stores back, cp.async
// copies, the mma.sync / ldmatrix fragments of the decode kernels, and the
// one-time raise of a kernel's dynamic shared-memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace dtt {

constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF mask value

// One 16-byte vector of T: N elements.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  using Raw = float4;
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
};
template <> struct Vec16<int8_t> {
  static constexpr int N = 16;
  using Raw = int4;
};

// One lane's slice of a K/V row in the register-resident decode kernels: 16
// bytes of f32 or bf16, 8 bytes (8 values) of int8, so an int8 lane holds as
// many values, and as many query and accumulator registers, as a bf16 lane.
template <typename T> struct RowVec;
template <> struct RowVec<float> {
  static constexpr int N = 4;
  using Raw = float4;
};
template <> struct RowVec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
};
template <> struct RowVec<int8_t> {
  static constexpr int N = 8;
  using Raw = int2;
};

// Rows wider than one RowVec a lane fits in a warp's 32 lanes (f32 past 128
// values, bf16 and int8 past 256): D / 32 values a lane, in C pieces of 4
// or 8 values (f32 D 256: two 16-byte loads; bf16 D 384: three 8-byte
// loads; int8 D 384: three 4-byte loads), so a row still fits a warp.
template <typename Piece> struct PieceN;  // values a piece
template <> struct PieceN<float4> { static constexpr int N = 4; };
template <> struct PieceN<uint4> { static constexpr int N = 8; };  // bf16
template <> struct PieceN<uint2> { static constexpr int N = 4; };  // bf16
template <> struct PieceN<int2> { static constexpr int N = 8; };   // int8
template <> struct PieceN<char4> { static constexpr int N = 4; };  // int8

template <typename Piece, int C>
struct Pack {
  Piece v[C];
};

template <typename Piece, int C>
struct RowPack {
  static constexpr int N = C * PieceN<Piece>::N;
  using Raw = Pack<Piece, C>;
};

template <typename T, int D>
struct LaneVecSel {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool kWide = D > (kF32 ? 128 : 256);
  using Piece = typename std::conditional<
      kF32, float4,
      typename std::conditional<kBf16, typename std::conditional<D % 256 == 0, uint4, uint2>::type,
                                typename std::conditional<D % 256 == 0, int2, char4>::type>::type>::type;
  static constexpr int C = D / 32 / PieceN<Piece>::N > 0 ? D / 32 / PieceN<Piece>::N : 1;
  using type = typename std::conditional<kWide, RowPack<Piece, C>, RowVec<T>>::type;
};

// The lane slice of a D-value row of T in the register-resident decode
// kernels (K1's f32 body, K4a / K4b / K7c's f32 chunk body, K7b).
template <typename T, int D>
using LaneVec = typename LaneVecSel<T, D>::type;

__device__ __forceinline__ void to_float(const float4& r, float* f) {
  f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}

__device__ __forceinline__ void to_float(const uint4& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void to_float(const int4& r, float* f) {
  const char4* c = reinterpret_cast<const char4*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[4 * i] = c[i].x;
    f[4 * i + 1] = c[i].y;
    f[4 * i + 2] = c[i].z;
    f[4 * i + 3] = c[i].w;
  }
}

__device__ __forceinline__ void to_float(const int2& r, float* f) {
  const char4* c = reinterpret_cast<const char4*>(&r);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = c[i].x;
    f[4 * i + 1] = c[i].y;
    f[4 * i + 2] = c[i].z;
    f[4 * i + 3] = c[i].w;
  }
}

__device__ __forceinline__ void to_float(const uint2& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void to_float(const char4& c, float* f) {
  f[0] = c.x;
  f[1] = c.y;
  f[2] = c.z;
  f[3] = c.w;
}

template <typename Piece, int C>
__device__ __forceinline__ void to_float(const Pack<Piece, C>& r, float* f) {
#pragma unroll
  for (int c = 0; c < C; ++c) to_float(r.v[c], f + c * PieceN<Piece>::N);
}

template <typename T, typename RV = RowVec<T>>
__device__ __forceinline__ typename RV::Raw load_row(const T* p) {
  return *reinterpret_cast<const typename RV::Raw*>(p);
}

// N elements of T starting at p (16-byte aligned, N * sizeof(T) a multiple
// of 16) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float* f) {
  constexpr int V = Vec16<T>::N;
  static_assert(N % V == 0, "load_floats reads whole 16-byte vectors");
#pragma unroll
  for (int i = 0; i < N; i += V) to_float(*reinterpret_cast<const typename Vec16<T>::Raw*>(p + i), f + i);
}

template <typename T>
__device__ __forceinline__ typename Vec16<T>::Raw load16(const T* p) {
  return *reinterpret_cast<const typename Vec16<T>::Raw*>(p);
}

template <typename T>
__device__ __forceinline__ typename Vec16<T>::Raw zero16() {
  typename Vec16<T>::Raw r;
  memset(&r, 0, sizeof(r));
  return r;
}

template <typename T, typename RV = RowVec<T>>
__device__ __forceinline__ typename RV::Raw zero_row() {
  typename RV::Raw r;
  memset(&r, 0, sizeof(r));
  return r;
}

// One element of a pool or query row as f32 (the scalar loads of the
// bodies that take rows at any alignment).
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// Store 4 floats as 4 elements of T (16 bytes of f32, 8 bytes of bf16).
__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&lo);
  r.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = r;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ------------------------------------------------------------- async copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; nothing read and zeros written when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------- mma.sync

// D (16 x 8 f32) += A (16 x 16 bf16, row) . B (16 x 8 bf16, col). Thread
// (g = lane / 4, t = lane % 4) holds a = {(g, 2t..2t+1), (g + 8, 2t..),
// (g, 2t + 8..), (g + 8, 2t + 8..)}, b = {(2t..2t+1, g), (2t + 8.., g)} and
// d = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8 x 8 bf16 matrices from shared memory: lanes 0-7 give the row
// addresses of the first, lanes 8-15 of the second (16 bytes each). Plain:
// thread (g, t) gets (row g, columns 2t, 2t + 1) of each, the B fragment of
// a product whose k runs along the rows' columns (K . Q^T: rows are keys).
// .trans: (rows 2t, 2t + 1, column g), the B fragment where k runs down the
// rows (P . V: rows are keys, columns output columns).
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r0), "=r"(r1) : "r"(addr));
}

// Four 8 x 8 bf16 matrices (lanes 8i .. 8i + 7 give the rows of matrix i):
// with row = lane % 16 and column chunk lane / 16 over a row-major 16 x 16
// tile, the A fragment of mma_bf16_16816.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// ldsm_x4's transposed form: with row = lane % 16 over 16 key rows and
// column chunk lane / 16, the B fragments of two 8-column blocks of P . V
// (r[0], r[1] the first block's, r[2], r[3] the second's).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

constexpr int kMaxDevices = 64;

// A kernel whose dynamic shared memory exceeds the 48 KiB default needs its
// limit raised before its first launch on each device; done[dev] (one flag
// array per kernel) records that it was, so later launches skip the call.
template <typename Kernel>
cudaError_t raise_smem_limit_once(Kernel kernel, std::atomic<bool>* done, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace dtt
