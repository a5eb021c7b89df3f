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
// The body is decode_block.cuh's (one block per (sequence, kv head, tile of
// up to 8 of its G query heads), the tile's heads sharing each row; its header says what bounds it, bytes, and what
// the design does about it).  On the TPU the table is a scalar-prefetch
// operand and the grid (B, KV, nb) streams every table entry, the dump-block
// padding included.  Validity is positional, so this kernel's row source
// visits only positions [max(0, p - window + 1), p]: the table entries up
// to p / block (and, with a window, from (p - window + 1) / block), each row
// read straight from the pool at table[b, j] * block + r with no gathered
// copy.  Warp w takes the same rows as in the dense decode kernel, so over
// the same rows both kernels give the same bits.  A freed slot (zeroed
// table, p = 0) reads row 0 of the dump block only, as the plain version.
// A visited table entry outside [0, n_blocks) traps (the plain version's
// indexing would fail there too).
//
// Layouts (all contiguous): q, out [B, 1, H, hd]; k_pool, v_pool
// [n_blocks * block, KV, hd]; block_table [B, nb] int32; q_pos [B, 1] int32.
// Grid (KV, B, ceil(G / 8)), 256 threads.

#include "decode_block.cuh"

namespace repro_torch {
namespace decode {
namespace {

// Row j (sequence position) of one sequence, found through its table.
struct PagedRows {
  const int* table;  // this sequence's [nb]
  size_t head;  // element offset of this kv head within a pool row
  size_t stride;  // elements between pool rows (KV * hd)
  int block, n_blocks, lo;

  __device__ __forceinline__ bool keep(int j) const { return j >= lo; }
  __device__ __forceinline__ size_t offset(int j) const {
    const int bid = __ldg(table + j / block);
    if (bid < 0 || bid >= n_blocks) __trap();
    return (size_t(bid) * block + j % block) * stride + head;
  }
};

template <typename T, int EPL, int GM, bool FULL>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ block_table,
                    const int* __restrict__ q_pos, T* __restrict__ out, int nb, int n_blocks,
                    int block, int H, int KV, int hd_arg, int has_window, int window,
                    float scale) {
  const int hd = FULL ? 32 * EPL : hd_arg;  // FULL: the bucket's own head_dim
  extern __shared__ float sm[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const long long qp = q_pos[b];
  // the last position the table reaches, and the first the window keeps
  const long long last = qp < (long long)nb * block ? qp : (long long)nb * block - 1;
  long long lo = has_window ? qp - window + 1 : 0;
  if (lo < 0) lo = 0;
  const int end = last < 0 ? 0 : int(last + 1);
  const int first = lo > last ? end : int(lo);
  const int begin = first - first % (NW * R);  // warp chunks aligned as in dense decode
  const PagedRows rows{block_table + size_t(b) * nb, size_t(kvh) * hd, size_t(KV) * hd,
                       block, n_blocks, first};
  const size_t qo = (size_t(b) * H + size_t(kvh) * G + tile_first()) * hd;
  attend<T, EPL, GM>(q + qo, k_pool, v_pool, out + qo, rows, begin, end, tile_count(G), hd,
                     scale, sm);
}

// One launch's arguments; `run` launches the instantiation `dispatch` picks.
struct PagedLaunch {
  const void *q, *k_pool, *v_pool;
  const int *block_table, *q_pos;
  void* out;
  int B, nb, n_blocks, block, H, KV, hd, has_window, window;
  float scale;
  cudaStream_t stream;

  template <typename T, int EPL, int GM>
  int run() const {
    const size_t smem = smem_bytes(H / KV, EPL);
    auto kernel = hd == 32 * EPL ? paged_decode_kernel<T, EPL, GM, true>
                                 : paged_decode_kernel<T, EPL, GM, false>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    kernel<<<dim3(KV, B, g_tiles(H / KV)), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), block_table, q_pos, static_cast<T*>(out), nb, n_blocks,
        block, H, KV, hd, has_window, window, scale);
    return int(cudaGetLastError());
  }
};

}  // namespace
}  // namespace decode
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping, or bad sizes.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const int* block_table,
                                             const int* q_pos, void* out, int B, int nb,
                                             int n_blocks, int block, int H, int KV, int hd,
                                             int dtype, int has_window, int window,
                                             float scale, void* stream) {
  using namespace repro_torch::decode;
  if (KV <= 0 || H % KV != 0 || B <= 0 || nb <= 0 || n_blocks <= 0 || block <= 0)
    return int(cudaErrorInvalidValue);
  const PagedLaunch l{q,     k_pool,     v_pool, block_table, q_pos, out,
                      B,     nb,         n_blocks, block,     H,     KV,
                      hd,    has_window, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(l, dtype, hd, H / KV);
}
