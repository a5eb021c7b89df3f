// Chunked-prefill attention for Hopper (sm_90a): up to C query tokens per
// sequence against the shared KV block pool, through each sequence's block
// table -- the unified continuous-batching launch, whose rows mix decode
// tokens, prefill chunks and idle padding.
//
// Replaces the Pallas kernel `chunked_prefill_attention` of the JAX package
// (src/repro/kernels/chunked_prefill.py).  Row r of table entry j holds
// sequence position j*block + r; the query at position p keeps every such
// row with j*block + r <= p and, with a window, j*block + r > p - window.
// A padding query (q_pos -2^30) keeps none and outputs zeros.  The result is
// `ref.chunked_prefill_ref`: attention over the rows the table names, in
// table order.
//
// The kernel is the paged instantiation of the tile kernel in
// flash_tile.cuh (64 queries x 32 kv rows per tile, f32 online softmax).
// What bounds it on the H100 at the serving path's shapes (B 4, C 128, 32
// heads, hd 128, ~2,000-row contexts): operations, for a launch that carries
// a whole 128-token chunk; bytes, for one that carries only decode rows.
// On the TPU the grid (B, KV, nb) streams every table entry, dump-block
// padding included, with the table as a scalar-prefetch operand.  Here a
// query tile reads the table itself and visits only the positions its
// valid queries can reach, [max(0, min_q - window + 1), min(max_q, nb*block
// - 1)], reading each row straight from the pool at table[b, j / block] *
// block + j % block with no gathered copy.  So the dump block is never
// read, no padding query's q row is read, and the second query tile of a
// decode row (all padding) and every tile of an idle row write zeros and
// exit.  A decode row's first tile
// still runs 64 query rows for its one valid query; splitting decode rows
// away from the 64-row tile, and wgmma / TMA tiles, are later work.  A
// visited table entry outside [0, n_blocks) traps.
//
// Layouts (all contiguous): q, out [B, C, H, hd]; k_pool, v_pool
// [n_blocks * block, KV, hd]; block_table [B, nb] int32; q_pos [B, C] int32.

#include "flash_tile.cuh"

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping, or bad sizes.
extern "C" int chunked_prefill_attention_launch(const void* q, const void* k_pool,
                                                const void* v_pool, const int* block_table,
                                                const int* q_pos, void* out, int B, int C,
                                                int nb, int n_blocks, int block, int H, int KV,
                                                int hd, int dtype, int has_window, int window,
                                                float scale, void* stream) {
  using namespace repro_torch::flash;
  if (nb <= 0 || n_blocks <= 0 || block <= 0) return int(cudaErrorInvalidValue);
  const Args a{q,          k_pool, v_pool,   q_pos,  nullptr,     nullptr,
               nullptr,    nullptr, out,     B,      C,           nb * block,
               H,          KV,     1,        has_window, window,   scale,
               static_cast<cudaStream_t>(stream), block_table, nb, n_blocks, block};
  return dispatch<ROWS_PAGED>(dtype, hd, a);
}
