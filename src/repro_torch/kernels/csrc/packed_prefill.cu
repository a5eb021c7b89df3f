// Packed ragged suffix-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `packed_flash_attention` of the JAX package
// (src/repro/kernels/packed_prefill.py): GQA flash attention over several
// requests' token runs packed into one sequence.  A key row is kept for a
// query iff kv_pos >= 0, q_seg == kv_seg, kv_pos <= q_pos (causal, at
// segment-local positions) and, with a window, kv_pos > q_pos - window.
// Queries that every key masks output zeros.
//
// Which tile runs, by dtype: bf16 on the tensor-core tile of flash_mma.cuh
// (the serving path's dtype), f32 on the CUDA-core tile of flash_tile.cuh
// (the dtype the tests hold the algorithm in at atol 2e-5, which neither
// TF32 nor bf16 operands meet).  Both are the segmented row source
// ROWS_SEGMENTED.  The bf16 launch runs on the same tile as the flash,
// chunked and fused kernels so that a sequence's prefill gives the same bits
// through any of them (flash_mma.cuh says how).
//
// What bounds it on the H100: operations (a packed batch of thousands of
// queries, 32 heads, hd 128).  Besides the causal and window tests, both
// tiles skip a kv tile whose segment-id range cannot meet the query tile's,
// so the work follows the segment-diagonal causal blocks; the bf16 tile runs
// the products on the tensor cores.
//
// Layouts (all contiguous): q, out [B, Sq, H, hd]; k, v [B, Skv, KV, hd];
// q_pos, q_seg [B, Sq] int32; kv_pos, kv_seg [B, Skv] int32; bf16 with S >
// 1: part_acc [S, B, Sq, H, hd] f32, part_ml [S, B, Sq, H, 2] f32 (scratch,
// from the wrapper; null otherwise).

#include "flash_mma.cuh"
#include "flash_tile.cuh"

// The split S of a launch's kv tiles (1 in f32, which never splits): the
// wrapper sizes the bf16 scratch from it, and the launch below recomputes it.
extern "C" int packed_flash_attention_splits(int Skv, int hd, int dtype) {
  if (dtype != repro_torch::DTYPE_BF16) return 1;
  return repro_torch::flash_mma::split_parts(Skv, hd).splits;
}

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping, or a bf16 launch with S > 1 and no scratch.
extern "C" int packed_flash_attention_launch(
    const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
    const int* q_seg, const int* kv_seg, void* out, void* part_acc, void* part_ml, int B,
    int Sq, int Skv, int H, int KV, int hd, int dtype, int causal, int has_window, int window,
    float scale, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) {
    using flash_mma::bf16;
    flash_mma::Params p{};
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.q_pos = q_pos;
    p.kv_pos = kv_pos;
    p.q_seg = q_seg;
    p.kv_seg = kv_seg;
    p.out = static_cast<bf16*>(out);
    p.part_acc = static_cast<float*>(part_acc);
    p.part_ml = static_cast<float2*>(part_ml);
    p.B = B;
    p.Sq = Sq;
    p.Skv = Skv;
    p.H = H;
    p.KV = KV;
    p.hd = hd;
    p.causal = causal;
    p.has_window = has_window;
    p.window = window;
    p.scale = scale;
    return flash_mma::dispatch<flash_mma::ROWS_SEGMENTED>(p, s);
  }
  if (dtype != DTYPE_F32) return int(cudaErrorInvalidValue);
  const flash::Args a{q,     k,   v,  q_pos, kv_pos, q_seg,  kv_seg,     nullptr,
                      out,   B,   Sq, Skv,   H,      KV,     causal,     has_window,
                      window, scale, s};
  return flash::dispatch_as<float, flash::ROWS_SEGMENTED>(hd, a);
}
