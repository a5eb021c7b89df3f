// Selective-recompute (CacheBlend-style) fused prefill attention for Hopper
// (sm_90a): the recompute tokens of a fused reuse admission against the
// assembled KV buffer.
//
// Replaces the Pallas kernel `fused_flash_attention` of the JAX package
// (src/repro/kernels/fused_prefill.py).  The queries are only the tokens
// chosen for recompute (plus the prompt): a gappy, ascending subset of
// positions q_pos, with -2^30 for padding.  K and V are the assembled buffer
// whose row j sits at position kv_pos[j] (0..total-1, -1 past total).  Key
// j is kept for query i iff kv_pos[j] >= 0, kv_pos[j] <= q_pos[i] and, with
// a window, kv_pos[j] > q_pos[i] - window; a query that every key masks
// (padding among them) outputs zeros.  The result is
// `ref.fused_prefill_ref`.
//
// The kernel is the fused instantiation of the tile kernel in
// flash_tile.cuh (64 queries x 32 kv rows per tile, f32 online softmax).
// What bounds it on the H100 at the serving path's shapes (a few hundred
// recompute queries over ~2,000 valid rows, 32 heads, hd 128): operations
// over the kept (query, key) pairs, though with so few query tiles per head
// the launch is latency-bound in practice.  What its design does:
//
//   * a query tile takes its position range over its valid (>= 0) queries
//     only, so a padding -2^30 neither widens the range nor disables the
//     window skip (the gappy queries already make the range wide);
//   * no padding query's q row is read, and a tile whose queries are all
//     padding writes zeros and exits, reading neither q nor k/v;
//   * a kv tile whose smallest valid position lies above the tile's largest
//     query position is skipped whole (the TPU kernel's early-out), as is a
//     tile with no valid row (the assembled buffer's bucket tail past
//     total) or, with a window, one that lies wholly before it.
//
// On the TPU the grid (B, H, nQ, nKV) streams every 128x128 tile and carries
// (m, l, acc) in scratch across the sequential kv axis; here the kv loop
// runs inside one block, so no carry crosses blocks.  Tensor-core (wgmma)
// tiles and TMA loads are later work.
//
// Layouts (all contiguous): q, out [B, Sq, H, hd]; k, v [B, Skv, KV, hd];
// q_pos [B, Sq] int32; kv_pos [B, Skv] int32.

#include "flash_tile.cuh"

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping.
extern "C" int fused_flash_attention_launch(const void* q, const void* k, const void* v,
                                            const int* q_pos, const int* kv_pos, void* out,
                                            int B, int Sq, int Skv, int H, int KV, int hd,
                                            int dtype, int has_window, int window, float scale,
                                            void* stream) {
  using namespace repro_torch::flash;
  const Args a{q,     k,   v,  q_pos, kv_pos, nullptr, nullptr,    nullptr,
               out,   B,   Sq, Skv,   H,      KV,      1,          has_window,
               window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<ROWS_FUSED>(dtype, hd, a);
}
