// Dense-cache decode attention for Hopper (sm_90a): one query token per
// sequence against the slotted cache.
//
// Replaces the Pallas kernel `decode_attention` of the JAX package
// (src/repro/kernels/decode_attention.py).  A cache row is kept for the query
// at position p iff kv_pos >= 0, kv_pos <= p, (with a window) kv_pos >
// p - window, and (when given) kv_valid; a query that every row masks
// outputs zeros.
//
// The body is decode_block.cuh's: its header says what bounds the kernel,
// bytes, and what the design does about it (fixed position parts over the
// grid, cp.async row tiles, one reduction per tile, an ordered combine).
// This kernel's prologue reads the int32 positions (and kv_valid) of its
// part's PART rows at once, one coalesced load, into a keep mask in shared
// memory: a part that keeps no row exits at once, and the tiles then copy
// only the kept rows, so a slot that has filled 2,000 of 4,096 cache rows
// streams 2,000 rows and an idle slot none.
//
// Layouts (all contiguous): q, out [B, 1, H, hd]; k, v [B, L, KV, hd];
// q_pos [B, 1] int32; kv_pos [B, L] int32; kv_valid [B, L] bool or null;
// scratch part_ml [parts, B, H] (m, l) f32 and part_acc [parts, B, H, hd] f32
// (unused with one part).  Grid (KV * ceil(G / 8), B, parts), 128 threads;
// then, with more than one part, the combine.

#include "decode_block.cuh"

namespace repro_torch {
namespace decode {
namespace {

// Row j of one sequence's slotted cache, kept by the part's keep mask.
struct DenseRows {
  const unsigned* keep;  // the part's PART bits, in shared memory
  int part0;
  size_t base;  // element offset of row 0 of this sequence and kv head
  size_t stride;  // elements between rows (KV * hd)

  __device__ __forceinline__ unsigned mask(int j0) const {
    const int i = j0 - part0;  // a multiple of T = 16
    return (keep[i >> 5] >> (i & 31)) & 0xffffu;
  }
  __device__ __forceinline__ size_t offset(int j) const { return base + size_t(j) * stride; }
};

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
              const unsigned char* __restrict__ kv_valid, T* __restrict__ out,
              float* __restrict__ part_acc, float2* __restrict__ part_ml, int B, int L, int H,
              int KV, int hd, int has_window, int window, float scale_log2) {
  using Ly = Layout<T, HD, GM>;
  extern __shared__ __align__(16) unsigned char sm[];
  const int n_gt = g_tiles(H / KV);
  const int kvh = blockIdx.x / n_gt, gt = blockIdx.x % n_gt, b = blockIdx.y;
  const int part = blockIdx.z, parts = gridDim.z;
  const int G = min(GT, H / KV - gt * GT);  // this block's heads
  const int h0 = kvh * (H / KV) + gt * GT;
  const size_t row0 = size_t(b) * H + h0;  // this block's first (sequence, head) row
  const size_t prow = size_t(part) * B * H + row0;  // the same row of this part's partials
  const Dest<T> dest{out + row0 * hd, parts > 1 ? part_ml + prow : nullptr,
                     parts > 1 ? part_acc + prow * hd : nullptr};
  load_q<T, HD>(q + row0 * hd, reinterpret_cast<float*>(sm + Ly::Q), G, hd);

  // ---- the keep mask of the part's rows
  const long long qp = q_pos[b];
  const int part0 = part * PART;
  unsigned* keep = reinterpret_cast<unsigned*>(sm + Ly::INTS);
  int any = 0;
  for (int i = threadIdx.x; i < PART; i += THREADS) {
    const int j = part0 + i;
    bool kk = false;
    if (j < L) {
      const size_t at = size_t(b) * L + j;
      const long long kp = __ldg(kv_pos + at);
      kk = kp >= 0 && kp <= qp && (!has_window || kp > qp - window) &&
           (kv_valid == nullptr || __ldg(kv_valid + at) != 0);
    }
    const unsigned bits = __ballot_sync(ALL, kk);
    if ((threadIdx.x & 31) == 0) keep[i >> 5] = bits;
    any |= kk;
  }
  if (!__syncthreads_or(any)) {
    write_empty(dest, G, hd);
    return;
  }
  const size_t stride = size_t(KV) * hd;
  const DenseRows rows{keep, part0, size_t(b) * L * stride + size_t(kvh) * hd, stride};
  attend<T, HD, GM>(k, v, rows, part0, dest, G, hd, scale_log2, sm);
}

// One launch's arguments; `run` launches the instantiation `dispatch` picks.
struct DenseLaunch {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  const unsigned char* kv_valid;
  void* out;
  float* part_acc;
  float2* part_ml;
  int B, L, H, KV, hd, has_window, window, parts;
  float scale_log2;
  cudaStream_t stream;

  template <typename T, int HD, int GM>
  int run() const {
    const size_t smem = Layout<T, HD, GM>::BYTES;
    auto kernel = decode_kernel<T, HD, GM>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    kernel<<<dim3(KV * g_tiles(H / KV), B, parts), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
        kv_pos, kv_valid, static_cast<T*>(out), part_acc, part_ml, B, L, H, KV, hd,
        has_window, window, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess || parts == 1) return int(err);
    return launch_combine<T>(part_ml, part_acc, out, B * H, parts, hd, stream);
  }
};

}  // namespace
}  // namespace decode
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  `parts` is the wrapper's
// ceil(L / PART), for which it sized the scratch part_acc / part_ml (null
// with one part).  Returns the CUDA status of the launches: 0 on success,
// cudaErrorInvalidValue for an unsupported head_dim, dtype or head
// grouping, bad sizes, or a part count other than the kernel's.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* q_pos, const int* kv_pos,
                                       const unsigned char* kv_valid, void* out,
                                       void* part_acc, void* part_ml, int B, int L, int H,
                                       int KV, int hd, int dtype, int has_window, int window,
                                       int parts, float scale, void* stream) {
  using namespace repro_torch::decode;
  if (!launch_ok(B, H, KV, L, parts, part_acc, part_ml)) return int(cudaErrorInvalidValue);
  const DenseLaunch l{q, k, v, q_pos, kv_pos, kv_valid, out, static_cast<float*>(part_acc),
                      static_cast<float2*>(part_ml), B, L, H, KV, hd, has_window, window, parts,
                      scale * 1.4426950408889634f,  // scores in base 2
                      static_cast<cudaStream_t>(stream)};
  return dispatch(l, dtype, hd, H / KV);
}
