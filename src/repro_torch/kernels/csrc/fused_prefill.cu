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
// Which tile runs, by dtype: bf16 on the tensor-core tile of flash_mma.cuh
// (the serving path's dtype), f32 on the CUDA-core tile of flash_tile.cuh
// (the dtype the tests hold the algorithm in at atol 2e-5, which neither
// TF32 nor bf16 operands meet).  Both are the fused row source ROWS_FUSED.
// The bf16 launch runs on the same tile as the packed, flash and chunked
// kernels, so that a fused admission at r = 1 gives the bits of a plain
// prefill of the same sequence (flash_mma.cuh says how).
//
// What bounds it on the H100 at the serving path's shapes (a few hundred
// recompute queries over ~2,000 valid rows, 32 heads, hd 128): bytes and
// latency.  The gappy queries spread each 64-query tile over a wide
// position range, so every live tile walks most of the valid rows: on the
// CUDA-core tile 288 live blocks each walked up to 65 kv tiles in series,
// with a memory round trip on each, at 80x the bound.  What both tiles do:
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
// The bf16 tile adds tensor-core products, per-warp skipping of kv tiles
// that none of a warp's 16 queries keeps, cp.async K/V tiles kept one ahead
// of the products, and a split of the kv tiles into fixed parts across up
// to 8 blocks (by the buffer's length), whose partials a second kernel of
// this launch combines in split order.  On the TPU the grid (B, H, nQ, nKV)
// streams every 128x128 tile and carries (m, l, acc) in scratch across the
// sequential kv axis; here no carry crosses blocks except through that
// combine.
//
// Layouts (all contiguous): q, out [B, Sq, H, hd]; k, v [B, Skv, KV, hd];
// q_pos [B, Sq] int32; kv_pos [B, Skv] int32; bf16 with S > 1: part_acc
// [S, B, Sq, H, hd] f32, part_ml [S, B, Sq, H, 2] f32 (scratch, from the
// wrapper; null otherwise).

#include "flash_mma.cuh"
#include "flash_tile.cuh"

// The split S of a launch's kv tiles (1 in f32, which never splits): the
// wrapper sizes the bf16 scratch from it, and the launch below recomputes it.
extern "C" int fused_flash_attention_splits(int Skv, int hd, int dtype) {
  if (dtype != repro_torch::DTYPE_BF16) return 1;
  return repro_torch::flash_mma::split_parts(Skv, hd).splits;
}

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping, or a bf16 launch with S > 1 and no scratch.
extern "C" int fused_flash_attention_launch(const void* q, const void* k, const void* v,
                                            const int* q_pos, const int* kv_pos, void* out,
                                            void* part_acc, void* part_ml, int B, int Sq,
                                            int Skv, int H, int KV, int hd, int dtype,
                                            int has_window, int window, float scale,
                                            void* stream) {
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
    p.out = static_cast<bf16*>(out);
    p.part_acc = static_cast<float*>(part_acc);
    p.part_ml = static_cast<float2*>(part_ml);
    p.B = B;
    p.Sq = Sq;
    p.Skv = Skv;
    p.H = H;
    p.KV = KV;
    p.hd = hd;
    p.has_window = has_window;
    p.window = window;
    p.causal = 1;
    p.scale = scale;
    return flash_mma::dispatch<flash_mma::ROWS_FUSED>(p, s);
  }
  if (dtype != DTYPE_F32) return int(cudaErrorInvalidValue);
  const flash::Args a{q,     k,   v,  q_pos, kv_pos, nullptr, nullptr,    nullptr,
                      out,   B,   Sq, Skv,   H,      KV,      1,          has_window,
                      window, scale, s};
  return flash::dispatch_as<float, flash::ROWS_FUSED>(hd, a);
}
