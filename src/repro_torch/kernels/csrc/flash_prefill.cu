// Position-masked GQA flash attention for Hopper (sm_90a): the per-request
// (suffix-)prefill of `lm.prefill`.
//
// Replaces the Pallas kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_prefill.py).  A key row is kept for a query iff
// kv_pos >= 0, kv_valid (when given), kv_pos <= q_pos (causal; off for
// cross-attention) and, with a window, kv_pos > q_pos - window.  Queries that
// every key masks output zeros.
//
// The kernel is the unsegmented instantiation of the tile kernel in
// flash_tile.cuh, whose header says what bounds it (operations) and how the
// design answers that.  `lm.prefill` attends the whole max_len cache with
// every row past offset+S invalid; the Pallas grid (B, H, nQ, nKV) streams
// every one of those kv blocks, while this kernel skips each kv tile that
// holds no valid row or lies causally beyond the query tile, so a 2,032-token
// prefill into a 4,096-row cache does the work of the causal triangle only.
// The suffix prefill after a load (32 queries over 2,000 stored rows) is
// bound by bytes instead, and its one block per head leaves most of the 132
// SMs idle; splitting the kv axis over blocks for short query runs is later
// work.
//
// Layouts (all contiguous): q, out [B, Sq, H, hd]; k, v [B, Skv, KV, hd];
// q_pos [B, Sq] int32; kv_pos [B, Skv] int32; kv_valid [B, Skv] bool or null.

#include "flash_tile.cuh"

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const int* q_pos, const int* kv_pos,
                                      const unsigned char* kv_valid, void* out, int B, int Sq,
                                      int Skv, int H, int KV, int hd, int dtype, int causal,
                                      int has_window, int window, float scale, void* stream) {
  using namespace repro_torch::flash;
  const Args a{q,     k,   v,  q_pos, kv_pos, nullptr, nullptr,    kv_valid,
               out,   B,   Sq, Skv,   H,      KV,      causal,     has_window,
               window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<ROWS_DENSE>(dtype, hd, a);
}
