// Paged decode attention for Hopper (sm_90a): one query token per sequence
// against the shared KV block pool, through each sequence's block table.
//
// Replaces the Pallas kernel `paged_decode_attention` of the JAX package
// (src/repro/kernels/paged_decode.py).  Row r of table entry j holds
// sequence position j*block + r; the query at position p keeps every such
// row with j*block + r <= p and, with a window, j*block + r > p - window.
// The result is `ref.paged_decode_ref`: attention over the rows the table
// names, in table order.
//
// The body is decode_block.cuh's: its header says what bounds the kernel,
// bytes, and what the design does about it (fixed position parts over the
// grid, cp.async row tiles, one reduction per tile, an ordered combine).
// On the TPU the table is a scalar-prefetch operand and the grid (B, KV, nb)
// streams every table entry, the dump-block padding included.  Validity is
// positional, so here a block keeps the positions [max(0, p - window + 1),
// p] that fall in its part: a part outside them exits at once (with a
// window, the first part visited is the one that holds p - window + 1), and
// the prologue reads the table entries the part's kept positions reach into
// shared memory; each 16-byte chunk of row j is then copied straight from
// the pool at table[b, j / block] * block + j % block, so a pool block that
// straddles two parts or two tiles is gathered chunk by chunk, with no
// gathered copy.  The parts are those of the dense decode kernel over the
// same positions, with the same code inside each, so over the same rows
// both kernels give the same bits.  A freed slot (zeroed table, p = 0) reads
// row 0 of the dump block only, as the plain version.  A visited table
// entry outside [0, n_blocks) traps (the plain version's indexing would fail
// there too).
//
// Layouts (all contiguous): q, out [B, 1, H, hd]; k_pool, v_pool
// [n_blocks * block, KV, hd]; block_table [B, nb] int32; q_pos [B, 1] int32;
// scratch part_ml [parts, B, H] (m, l) f32 and part_acc [parts, B, H, hd] f32
// (unused with one part).  Grid (KV * ceil(G / 8), B, parts), 128 threads;
// then, with more than one part, the combine.

#include "decode_block.cuh"

namespace repro_torch {
namespace decode {
namespace {

// Position j of one sequence, kept on [lo, hi), found through the part's
// table entries e0, e0 + 1, ... (in shared memory).
struct PagedRows {
  const int* bid;  // pool block of table entry e0 + i
  int e0, block, lo, hi;
  size_t head;  // element offset of this kv head within a pool row
  size_t stride;  // elements between pool rows (KV * hd)

  __device__ __forceinline__ unsigned mask(int j0) const {
    const int a = max(lo - j0, 0), z = min(hi - j0, TILE);
    return a >= z ? 0u : ((1u << z) - 1u) & ~((1u << a) - 1u);
  }
  __device__ __forceinline__ size_t offset(int j) const {
    return (size_t(bid[j / block - e0]) * block + j % block) * stride + head;
  }
};

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ block_table,
                    const int* __restrict__ q_pos, T* __restrict__ out,
                    float* __restrict__ part_acc, float2* __restrict__ part_ml, int B, int nb,
                    int n_blocks, int block, int H, int KV, int hd, int has_window,
                    int window, float scale_log2) {
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

  // ---- the kept positions of this part: [max(lo, part0), min(end, part0 + PART))
  const long long qp = q_pos[b];
  const long long last = min(qp, (long long)nb * block - 1);  // the last the table reaches
  const long long lo = has_window ? max(qp - window + 1, 0LL) : 0LL;
  const int part0 = part * PART;
  const long long a = max(lo, (long long)part0), z = min(last + 1, (long long)part0 + PART);
  if (a >= z) {
    write_empty(dest, G, hd);
    return;
  }
  load_q<T, HD>(q + row0 * hd, reinterpret_cast<float*>(sm + Ly::Q), G, hd);
  // ---- the table entries those positions reach
  int* bid = reinterpret_cast<int*>(sm + Ly::INTS);
  const int e0 = int(a / block), n_e = int((z - 1) / block) - e0 + 1;
  for (int i = threadIdx.x; i < n_e; i += THREADS) {
    const int id = __ldg(block_table + size_t(b) * nb + e0 + i);
    if (id < 0 || id >= n_blocks) __trap();
    bid[i] = id;
  }
  __syncthreads();
  const PagedRows rows{bid, e0, block, int(a), int(z), size_t(kvh) * hd, size_t(KV) * hd};
  attend<T, HD, GM>(k_pool, v_pool, rows, part0, dest, G, hd, scale_log2, sm);
}

// One launch's arguments; `run` launches the instantiation `dispatch` picks.
struct PagedLaunch {
  const void *q, *k_pool, *v_pool;
  const int *block_table, *q_pos;
  void* out;
  float* part_acc;
  float2* part_ml;
  int B, nb, n_blocks, block, H, KV, hd, has_window, window, parts;
  float scale_log2;
  cudaStream_t stream;

  template <typename T, int HD, int GM>
  int run() const {
    const size_t smem = Layout<T, HD, GM>::BYTES;
    auto kernel = paged_decode_kernel<T, HD, GM>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    kernel<<<dim3(KV * g_tiles(H / KV), B, parts), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), block_table, q_pos, static_cast<T*>(out), part_acc,
        part_ml, B, nb, n_blocks, block, H, KV, hd, has_window, window, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess || parts == 1) return int(err);
    return launch_combine<T>(part_ml, part_acc, out, B * H, parts, hd, stream);
  }
};

}  // namespace
}  // namespace decode
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  `parts` is the wrapper's
// ceil(nb * block / PART), for which it sized the scratch part_acc /
// part_ml (null with one part).  Returns the CUDA status of the launches: 0
// on success, cudaErrorInvalidValue for an unsupported head_dim, dtype or
// head grouping, bad sizes, or a part count other than the kernel's.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const int* block_table,
                                             const int* q_pos, void* out, void* part_acc,
                                             void* part_ml, int B, int nb, int n_blocks,
                                             int block, int H, int KV, int hd, int dtype,
                                             int has_window, int window, int parts,
                                             float scale, void* stream) {
  using namespace repro_torch::decode;
  if (nb <= 0 || n_blocks <= 0 || block <= 0 ||
      !launch_ok(B, H, KV, (long long)nb * block, parts, part_acc, part_ml))
    return int(cudaErrorInvalidValue);
  const PagedLaunch l{q, k_pool, v_pool, block_table, q_pos, out,
                      static_cast<float*>(part_acc), static_cast<float2*>(part_ml), B, nb,
                      n_blocks, block, H, KV, hd, has_window, window, parts,
                      scale * 1.4426950408889634f,  // scores in base 2
                      static_cast<cudaStream_t>(stream)};
  return dispatch(l, dtype, hd, H / KV);
}
