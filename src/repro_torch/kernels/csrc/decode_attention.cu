// Dense-cache decode attention for Hopper (sm_90a): one query token per
// sequence against the slotted cache.
//
// Replaces the Pallas kernel `decode_attention` of the JAX package
// (src/repro/kernels/decode_attention.py).  A cache row is kept for the query
// at position p iff kv_pos >= 0, kv_pos <= p, (with a window) kv_pos >
// p - window, and (when given) kv_valid; a query that every row masks
// outputs zeros.
//
// The body is decode_block.cuh's (one block per (sequence, kv head, tile of
// up to 8 of its G query heads), the tile's heads sharing each row; its header says what bounds it, bytes, and what
// the design does about it).  This kernel's row source reads the int32
// positions first and loads only the rows the mask keeps, so a slot that has
// filled 2,000 of 4,096 cache rows streams 2,000 rows.
//
// Layouts (all contiguous): q, out [B, 1, H, hd]; k, v [B, L, KV, hd];
// q_pos [B, 1] int32; kv_pos [B, L] int32; kv_valid [B, L] bool or null.
// Grid (KV, B, ceil(G / 8)), 256 threads.

#include "decode_block.cuh"

namespace repro_torch {
namespace decode {
namespace {

// Row j of one sequence's slotted cache, kept by position and kv_valid.
struct DenseRows {
  const int* kv_pos;  // this sequence's [L]
  const unsigned char* kv_valid;  // this sequence's [L], or null
  size_t base;  // element offset of row 0 of this sequence and kv head
  size_t stride;  // elements between rows (KV * hd)
  int qp, has_window, window;

  __device__ __forceinline__ bool keep(int j) const {
    const int kp = kv_pos[j];
    bool kk = kp >= 0 && kp <= qp;
    kk = kk && (!has_window || (long long)kp > (long long)qp - window);
    return kk && (kv_valid == nullptr || kv_valid[j] != 0);
  }
  __device__ __forceinline__ size_t offset(int j) const { return base + size_t(j) * stride; }
};

template <typename T, int EPL, int GM, bool FULL>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
              const unsigned char* __restrict__ kv_valid, T* __restrict__ out, int L, int H,
              int KV, int hd_arg, int has_window, int window, float scale) {
  const int hd = FULL ? 32 * EPL : hd_arg;  // FULL: the bucket's own head_dim
  extern __shared__ float sm[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const size_t stride = size_t(KV) * hd;
  const DenseRows rows{kv_pos + size_t(b) * L,
                       kv_valid ? kv_valid + size_t(b) * L : nullptr,
                       size_t(b) * L * stride + size_t(kvh) * hd,
                       stride,
                       q_pos[b],
                       has_window,
                       window};
  const size_t qo = (size_t(b) * H + size_t(kvh) * G + tile_first()) * hd;
  attend<T, EPL, GM>(q + qo, k, v, out + qo, rows, 0, L, tile_count(G), hd, scale, sm);
}

// One launch's arguments; `run` launches the instantiation `dispatch` picks.
struct DenseLaunch {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  const unsigned char* kv_valid;
  void* out;
  int B, L, H, KV, hd, has_window, window;
  float scale;
  cudaStream_t stream;

  template <typename T, int EPL, int GM>
  int run() const {
    const size_t smem = smem_bytes(H / KV, EPL);
    auto kernel = hd == 32 * EPL ? decode_kernel<T, EPL, GM, true>
                                 : decode_kernel<T, EPL, GM, false>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    kernel<<<dim3(KV, B, g_tiles(H / KV)), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
        kv_pos, kv_valid, static_cast<T*>(out), L, H, KV, hd, has_window, window, scale);
    return int(cudaGetLastError());
  }
};

}  // namespace
}  // namespace decode
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* q_pos, const int* kv_pos,
                                       const unsigned char* kv_valid, void* out, int B, int L,
                                       int H, int KV, int hd, int dtype, int has_window,
                                       int window, float scale, void* stream) {
  using namespace repro_torch::decode;
  if (KV <= 0 || H % KV != 0 || L <= 0 || B <= 0) return int(cudaErrorInvalidValue);
  const DenseLaunch l{q, k, v, q_pos, kv_pos, kv_valid, out, B, L, H, KV, hd, has_window,
                      window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(l, dtype, hd, H / KV);
}
