// Int8 KV dequantisation for Hopper (sm_90a): the read side of the int8
// storage tier, run on the card after a fetch copies the int8 rows and their
// scales to it.
//
// Replaces the Pallas kernel `kv_dequant` of the JAX package
// (src/repro/kernels/kv_quant.py).  out[r, j] = q[r, j] * scale[r] in f32,
// rounded to the output type (to nearest even for bf16): `ref.kv_dequant_ref`
// bit for bit, since it is one f32 product and one rounding.
//
// What bounds it on the H100: bytes (hd int8 values and one f32 scale read,
// hd outputs written per row; ~807 MB for one bf16 leaf of a 2,032-token
// llama-7b context, ~0.24 ms at 3.35 TB/s).  What its design does: one warp
// per row, lane j taking elements j, j + 32, ..., so each warp-wide load and
// store touches consecutive addresses, and the row's scale is read once per
// lane.  Any hd >= 1 (guarded tails).  Wider loads, and fusing the dequant
// into the landing of fetched rows in the block pool, are later work.
//
// Layouts (all contiguous): q [rows, hd] int8; scale [rows] f32; out [rows,
// hd] f32 or bf16.  Grid ceil(rows / 8), 256 threads.

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace kvdq {
namespace {

constexpr int WARPS = 8;  // rows per block

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               T* __restrict__ out, long long rows, int hd) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const float s = scale[row];
  const int8_t* qr = q + row * hd;
  T* o = out + row * hd;
  for (int j = lane; j < hd; j += 32) o[j] = from_float<T>(float(qr[j]) * s);
}

template <typename T>
int launch(const void* q, const void* scale, void* out, long long rows, int hd,
           cudaStream_t stream) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  dequant_kernel<T><<<dim3(unsigned(blocks)), 32 * WARPS, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), static_cast<T*>(out),
      rows, hd);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace kvdq
}  // namespace repro_torch

extern "C" int kv_dequant_launch(const void* q, const void* scale, void* out, long long rows,
                                 int hd, int dtype, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || hd <= 0 || (rows + kvdq::WARPS - 1) / kvdq::WARPS > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return kvdq::launch<float>(q, scale, out, rows, hd, s);
  if (dtype == DTYPE_BF16) return kvdq::launch<__nv_bfloat16>(q, scale, out, rows, hd, s);
  return int(cudaErrorInvalidValue);
}
