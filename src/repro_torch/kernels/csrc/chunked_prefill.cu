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
// Which tile runs, by dtype: bf16 on the tensor-core tile of flash_mma.cuh
// (the serving path's dtype), f32 on the CUDA-core tile of flash_tile.cuh
// (the dtype the tests hold the algorithm in at atol 2e-5, which neither
// TF32 nor bf16 operands meet).  Both are the paged row source ROWS_PAGED.
// The bf16 launch runs on the same tile as the packed, flash and fused
// kernels, so that the unified step's chunks give a sequence the same bits
// as those kernels' prefill of it (flash_mma.cuh says how).
//
// What bounds it on the H100 at the serving path's shapes (B 4, C 128, 32
// heads, hd 128, ~2,000-row contexts, one 128-token chunk beside decode
// rows): bytes and latency, ~45 MB of K/V for 129 valid queries.  On the
// CUDA-core tile the launch took 60x that bound: f32 products, a memory
// round trip on every 32-row kv tile, 64 query rows run for a decode row's
// one query, and ~96 live blocks each walking up to ~65 kv tiles.  The bf16
// tile runs the products on the tensor cores, skips the warps of a tile
// whose 16 rows hold no valid query (a decode row is one warp's work),
// keeps the next K/V tile's cp.async copies in flight during the current
// tile's products, and splits the kv tiles into fixed parts across up to 8
// blocks (by the table's length, nb * block; the partials are combined in
// split order by a second kernel of this launch), so a decode row's ~33 kv
// tiles are walked by ~5 blocks.
//
// On the TPU the grid (B, KV, nb) streams every table entry, dump-block
// padding included, with the table as a scalar-prefetch operand.  Here a
// query tile reads the table itself and visits only the positions its
// valid queries can reach, [max(0, min_q - window + 1), min(max_q, nb*block
// - 1)], reading each row straight from the pool at table[b, j / block] *
// block + j % block with no gathered copy.  So the dump block is never
// read, no padding query's q row is read, and an all-padding query tile
// (a decode row's second tile, every tile of an idle row) writes zeros and
// exits.  A visited table entry outside [0, n_blocks) traps.
//
// Layouts (all contiguous): q, out [B, C, H, hd]; k_pool, v_pool
// [n_blocks * block, KV, hd]; block_table [B, nb] int32; q_pos [B, C] int32;
// bf16 with S > 1: part_acc [S, B, C, H, hd] f32, part_ml [S, B, C, H, 2]
// f32 (scratch, from the wrapper; null otherwise).

#include "flash_mma.cuh"
#include "flash_tile.cuh"

// The split S of a launch's kv tiles (1 in f32, which never splits): the
// wrapper sizes the bf16 scratch from it, and the launch below recomputes it.
extern "C" int chunked_prefill_attention_splits(int nb, int block, int hd, int dtype) {
  if (dtype != repro_torch::DTYPE_BF16) return 1;
  return repro_torch::flash_mma::split_parts((long long)nb * block, hd).splits;
}

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping, bad sizes, or a bf16 launch with S > 1 and no
// scratch.
extern "C" int chunked_prefill_attention_launch(const void* q, const void* k_pool,
                                                const void* v_pool, const int* block_table,
                                                const int* q_pos, void* out, void* part_acc,
                                                void* part_ml, int B, int C, int nb,
                                                int n_blocks, int block, int H, int KV, int hd,
                                                int dtype, int has_window, int window,
                                                float scale, void* stream) {
  using namespace repro_torch;
  if (nb <= 0 || n_blocks <= 0 || block <= 0 || (long long)nb * block > INT_MAX)
    return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) {
    using flash_mma::bf16;
    flash_mma::Params p{};
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k_pool);
    p.v = static_cast<const bf16*>(v_pool);
    p.q_pos = q_pos;
    p.table = block_table;
    p.out = static_cast<bf16*>(out);
    p.part_acc = static_cast<float*>(part_acc);
    p.part_ml = static_cast<float2*>(part_ml);
    p.B = B;
    p.Sq = C;
    p.Skv = nb * block;
    p.H = H;
    p.KV = KV;
    p.hd = hd;
    p.has_window = has_window;
    p.window = window;
    p.scale = scale;
    p.causal = 1;
    p.nb = nb;
    p.n_blocks = n_blocks;
    p.block = block;
    return flash_mma::dispatch<flash_mma::ROWS_PAGED>(p, s);
  }
  if (dtype != DTYPE_F32) return int(cudaErrorInvalidValue);
  const flash::Args a{q,          k_pool, v_pool,   q_pos,  nullptr,     nullptr,
                      nullptr,    nullptr, out,     B,      C,           nb * block,
                      H,          KV,     1,        has_window, window,   scale,
                      s,          block_table, nb,  n_blocks, block};
  return flash::dispatch_as<float, flash::ROWS_PAGED>(hd, a);
}
