// Packed ragged suffix-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `packed_flash_attention` of the JAX package
// (src/repro/kernels/packed_prefill.py): GQA flash attention over several
// requests' token runs packed into one sequence.  A key row is kept for a
// query iff kv_pos >= 0, q_seg == kv_seg, kv_pos <= q_pos (causal, at
// segment-local positions) and, with a window, kv_pos > q_pos - window.
// Queries that every key masks output zeros.
//
// The kernel is the segmented instantiation of the tile kernel in
// flash_tile.cuh, whose header says what bounds it (operations) and how the
// design answers that: besides the causal and window tests, a kv tile whose
// segment-id range cannot meet the query tile's is skipped whole, so the
// work follows the segment-diagonal causal blocks.
//
// Layouts (all contiguous): q, out [B, Sq, H, hd]; k, v [B, Skv, KV, hd];
// q_pos, q_seg [B, Sq] int32; kv_pos, kv_seg [B, Skv] int32.

#include "flash_tile.cuh"

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping.
extern "C" int packed_flash_attention_launch(
    const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
    const int* q_seg, const int* kv_seg, void* out, int B, int Sq, int Skv, int H, int KV,
    int hd, int dtype, int causal, int has_window, int window, float scale, void* stream) {
  using namespace repro_torch::flash;
  const Args a{q,     k,   v,  q_pos, kv_pos, q_seg,  kv_seg,     nullptr,
               out,   B,   Sq, Skv,   H,      KV,     causal,     has_window,
               window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<ROWS_SEGMENTED>(dtype, hd, a);
}
