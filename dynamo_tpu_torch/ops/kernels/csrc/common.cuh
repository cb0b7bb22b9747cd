// Shared helpers for the port's hand-written Hopper kernels: 16-byte vector
// loads of bf16 / f32 rows converted to f32 registers, stores back, and the
// one-time raise of a kernel's dynamic shared-memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
