// Symmetric int8 quantisation of KV rows for Hopper (sm_90a): the write side
// of the int8 storage tier.
//
// Replaces the Pallas kernel `kv_quant` of the JAX package
// (src/repro/kernels/kv_quant.py).  Each row is one (layer, slot, token, kv
// head) vector of hd values; per row,
//
//   scale = max(amax(|x|), 1e-8) / 127        (f32)
//   q     = clamp(rint(x / scale), -127, 127)  (int8)
//
// which is `ref.kv_quant_ref` bit for bit: the division is IEEE (this file is
// built without --use_fast_math, so `/` is not __fdividef and not a product
// with the reciprocal), and rintf rounds half to even as torch.round does.
// A row holding a NaN is outside the contract (the plain version's amax
// propagates it, fmaxf here drops it).
//
// What bounds it on the H100: bytes.  It reads each input row once from
// device memory and writes hd int8 values and one f32 scale per row, no
// arithmetic worth counting (a 2,032-token llama-7b context is 2,080,768
// rows of 128 per leaf: ~807 MB moved, ~0.24 ms at 3.35 TB/s).  What its
// design does: one warp per row, lane j taking elements j, j + 32, ..., so
// each warp-wide load touches consecutive addresses; the amax is a
// warp-shuffle max; the second pass over the row re-reads it from L1, where
// the first pass left it.  Any hd >= 1 (guarded tails).  Wider loads and
// several rows per warp at small hd are later work.
//
// Layouts (all contiguous): x [rows, hd] f32 or bf16; q [rows, hd] int8;
// scale [rows] f32.  Grid ceil(rows / 8), 256 threads.

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace kvq {
namespace {

constexpr int WARPS = 8;  // rows per block

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
             long long rows, int hd) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const T* xr = x + row * hd;
  float amax = 0.f;
  for (int j = lane; j < hd; j += 32) amax = fmaxf(amax, fabsf(to_float(xr[j])));
  amax = warp_max(amax);
  const float s = fmaxf(amax, 1e-8f) / 127.0f;
  int8_t* qr = q + row * hd;
  for (int j = lane; j < hd; j += 32) {
    const float v = fminf(fmaxf(rintf(to_float(xr[j]) / s), -127.f), 127.f);
    qr[j] = static_cast<int8_t>(__float2int_rn(v));
  }
  if (lane == 0) scale[row] = s;
}

template <typename T>
int launch(const void* x, void* q, void* scale, long long rows, int hd, cudaStream_t stream) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  quant_kernel<T><<<dim3(unsigned(blocks)), 32 * WARPS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), rows, hd);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace kvq
}  // namespace repro_torch

extern "C" int kv_quant_launch(const void* x, void* q, void* scale, long long rows, int hd,
                               int dtype, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || hd <= 0 || (rows + kvq::WARPS - 1) / kvq::WARPS > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return kvq::launch<float>(x, q, scale, rows, hd, s);
  if (dtype == DTYPE_BF16) return kvq::launch<__nv_bfloat16>(x, q, scale, rows, hd, s);
  return int(cudaErrorInvalidValue);
}
