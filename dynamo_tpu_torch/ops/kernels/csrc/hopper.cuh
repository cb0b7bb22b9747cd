// Hopper (sm_90a) building blocks for the port's kernels that load through
// the Tensor Memory Accelerator (TMA) into mbarrier rings, multiply with
// wgmma and reduce across a thread-block cluster: the mbarrier operations,
// 3-D TMA tile loads and the host-side encoding of their tensor maps,
// wgmma with A from registers and B from a 128-byte-swizzled K-major tile,
// setmaxnreg, and the cluster's barrier and distributed shared-memory
// loads. K8's wgmma body (int8_linear.cu) uses them.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime, no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt {
namespace hop {

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA) and the cluster
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also sets the bytes the barrier's phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ------------------------------------------------------------- TMA

// the box at coordinates (c0, c1, c2) of a 3-D tensor map into shared memory
// at dst; its bytes complete a transaction on the mbarrier at bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime's entry points
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 3-D tensor map over `base` (dims innermost first, strides in bytes of
// dims 1 and 2), boxes of b0 x b1 x 1 elements in 128-byte swizzle (b0 x
// the element size must be 128 bytes or fewer); loads past an edge fill
// zeros. False when the encoder refuses it.
inline bool tensor_map_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t d0, uint64_t d1,
                          uint64_t d2, uint64_t stride1, uint64_t stride2, uint32_t b0, uint32_t b1) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {stride1, stride2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(base), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins registers an asynchronous wgmma reads or writes to their place in
// the instruction stream
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The descriptor of a K-major bf16 operand tile in shared memory written by
// a 128-byte-swizzled TMA box: rows of 64 values (128 bytes), 8-row core
// groups 1024 bytes apart (the stride byte offset), the leading byte offset
// unused by this layout (1), layout type 1 (128-byte swizzle) in bits
// 62-63. The box starts 1024-byte aligned; `addr` may step 32 bytes (16
// values) into it for each k16 slice.
__device__ __forceinline__ uint64_t desc_k_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D [64 x n] += A [64 x 16] . B [16 x n]: A bf16 from registers (the
// mma.sync m16n8k16 A fragment of each warp's 16 rows), B a K-major bf16
// tile in shared memory (desc_k_sw128), D f32 in d[O .. O + n / 2).

template <int O, int M>
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[M], const uint32_t (&a)[4], uint64_t desc_b) {
  static_assert(O + 4 <= M, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

template <int O, int M>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[M], const uint32_t (&a)[4], uint64_t desc_b) {
  static_assert(O + 8 <= M, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]),
        "+f"(d[O + 6]), "+f"(d[O + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

template <int O, int M>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[M], const uint32_t (&a)[4], uint64_t desc_b) {
  static_assert(O + 16 <= M, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]),
        "+f"(d[O + 6]), "+f"(d[O + 7]), "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

template <int O, int M>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[M], const uint32_t (&a)[4], uint64_t desc_b) {
  static_assert(O + 32 <= M, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]),
        "+f"(d[O + 6]), "+f"(d[O + 7]), "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]), "+f"(d[O + 16]), "+f"(d[O + 17]),
        "+f"(d[O + 18]), "+f"(d[O + 19]), "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]),
        "+f"(d[O + 30]), "+f"(d[O + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

template <int O, int M>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[M], const uint32_t (&a)[4], uint64_t desc_b) {
  static_assert(O + 64 <= M, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]),
        "+f"(d[O + 6]), "+f"(d[O + 7]), "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]), "+f"(d[O + 16]), "+f"(d[O + 17]),
        "+f"(d[O + 18]), "+f"(d[O + 19]), "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]),
        "+f"(d[O + 30]), "+f"(d[O + 31]), "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]),
        "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]), "+f"(d[O + 40]), "+f"(d[O + 41]),
        "+f"(d[O + 42]), "+f"(d[O + 43]), "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]), "+f"(d[O + 52]), "+f"(d[O + 53]),
        "+f"(d[O + 54]), "+f"(d[O + 55]), "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]),
        "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// ------------------------------------------------------------- registers

// move registers between warpgroups: producers give theirs up, consumers take them
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// named barrier `id` over `count` threads (whole warps)
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------- clusters

// every thread of every block of the cluster arrives; shared-memory writes
// before it are visible to every block's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// the shared::cluster address of this block's shared address `addr` in the
// block of cluster rank `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

}  // namespace hop
}  // namespace dtt
