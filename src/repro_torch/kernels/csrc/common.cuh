// Helpers shared by the port's attention kernels: dtype conversion, vector
// loads and the status code the C entry points return.
#pragma once

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

// Raise the dynamic shared-memory cap of `kernel` to `bytes` when it is above
// the 48 KB default; returns the CUDA status.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace repro_torch
