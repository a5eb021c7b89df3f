// Helpers shared by the port's kernels: dtype conversion, vector loads,
// cp.async copies, the tensor-core fragments (ldmatrix, mma.sync, the bf16
// hi/lo split), 2^x and the status code the C entry points return.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// The finite "minus infinity" of the reference kernels: the running max
// starts here, so a query that every key masks ends with l == 0, acc == 0.
constexpr float NEG_INF = -1e30f;

// dtype codes shared with the Python wrappers (kernels/build.py)
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Load N contiguous elements of T (N * sizeof(T) bytes, aligned to that
// size) as the widest loads that fit, and widen them to f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ src, float (&dst)[N]) {
  constexpr int BYTES = N * int(sizeof(T));
  alignas(16) unsigned char raw[BYTES < 16 ? 16 : BYTES];
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(raw)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(raw) = __ldg(reinterpret_cast<const uint2*>(src));
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<unsigned int*>(raw) = __ldg(reinterpret_cast<const unsigned int*>(src));
  } else {
    static_assert(BYTES == 2, "unsupported vector width");
    *reinterpret_cast<unsigned short*>(raw) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
  }
  const T* t = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int n = 0; n < N; ++n) dst[n] = to_float(t[n]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; the bytes past `src_bytes`
// (all 16 for 0) are zero-filled and not read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix: four 8 x 8 bf16 matrices from shared memory, as mma fragments
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// 2^x (ex2.approx: relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Raise the dynamic shared-memory cap of `kernel` to `bytes` when it is above
// the 48 KB default; returns the CUDA status.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace repro_torch
