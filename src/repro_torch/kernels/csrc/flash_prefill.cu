// Position-masked GQA flash attention for Hopper (sm_90a): the per-request
// (suffix-)prefill of `lm.prefill`.
//
// Replaces the Pallas kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_prefill.py).  A key row is kept for a query iff
// kv_pos >= 0, kv_valid (when given), kv_pos <= q_pos (causal; off for
// cross-attention) and, with a window, kv_pos > q_pos - window.  Queries that
// every key masks output zeros.
//
// Which tile runs, by dtype: bf16 on the tensor-core tile of flash_mma.cuh
// (the serving path's dtype), f32 on the CUDA-core tile of flash_tile.cuh
// (the dtype the tests hold the algorithm in at atol 2e-5, which neither
// TF32 nor bf16 operands meet).  Both are the unsegmented row source
// ROWS_DENSE.  The bf16 launch runs on the same tile as the packed, chunked
// and fused kernels so that a sequence's prefill gives the same bits through
// any of them (flash_mma.cuh says how).
//
// What bounds it on the H100: operations for a full prefill (2,032 queries
// into a 4,096-row cache), bytes for the suffix prefill after a load (32
// queries over 2,000 stored rows).  `lm.prefill` attends the whole max_len
// cache with every row past offset+S invalid; the Pallas grid (B, H, nQ,
// nKV) streams every one of those kv blocks, while both tiles skip each kv
// tile that holds no valid row or lies causally beyond the query tile, so a
// prefill does the work of the causal triangle only.  The bf16 tile runs the
// products on the tensor cores and splits the kv tiles over up to 8 blocks,
// which also spreads the suffix prefill's few query tiles over the SMs.
//
// Layouts (all contiguous): q, out [B, Sq, H, hd]; k, v [B, Skv, KV, hd];
// q_pos [B, Sq] int32; kv_pos [B, Skv] int32; kv_valid [B, Skv] bool or
// null; bf16 with S > 1: part_acc [S, B, Sq, H, hd] f32, part_ml [S, B, Sq,
// H, 2] f32 (scratch, from the wrapper; null otherwise).

#include "flash_mma.cuh"
#include "flash_tile.cuh"

// The split S of a launch's kv tiles (1 in f32, which never splits): the
// wrapper sizes the bf16 scratch from it, and the launch below recomputes it.
extern "C" int flash_attention_splits(int Skv, int hd, int dtype) {
  if (dtype != repro_torch::DTYPE_BF16) return 1;
  return repro_torch::flash_mma::split_parts(Skv, hd).splits;
}

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping, or a bf16 launch with S > 1 and no scratch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const int* q_pos, const int* kv_pos,
                                      const unsigned char* kv_valid, void* out, void* part_acc,
                                      void* part_ml, int B, int Sq, int Skv, int H, int KV,
                                      int hd, int dtype, int causal, int has_window, int window,
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
    p.kv_valid = kv_valid;
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
    return flash_mma::dispatch<flash_mma::ROWS_DENSE>(p, s);
  }
  if (dtype != DTYPE_F32) return int(cudaErrorInvalidValue);
  const flash::Args a{q,     k,   v,  q_pos, kv_pos, nullptr, nullptr,    kv_valid,
                      out,   B,   Sq, Skv,   H,      KV,      causal,     has_window,
                      window, scale, s};
  return flash::dispatch_as<float, flash::ROWS_DENSE>(hd, a);
}
