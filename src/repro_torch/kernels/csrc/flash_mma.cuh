// The tensor-core flash-attention tile for bf16 on Hopper (sm_90a), shared
// by the bf16 launches of the four prefill attention kernels:
// `flash_attention` (flash_prefill.cu, ROWS_DENSE), `packed_flash_attention`
// (packed_prefill.cu, ROWS_SEGMENTED), `chunked_prefill_attention`
// (chunked_prefill.cu, ROWS_PAGED) and `fused_flash_attention`
// (fused_prefill.cu, ROWS_FUSED).  Their f32 launches stay on the CUDA-core
// tile of flash_tile.cuh: its f32 products are what the tests hold the
// algorithm to at atol 2e-5, which neither TF32 nor bf16 operands meet.
//
// What it computes is what flash_tile.cuh computes for the same source.  A
// key row j of position kp (ROWS_PAGED: j itself, on [lo_row, kv_end); the
// others: kv_pos[j], invalid when negative or, where given, !kv_valid[j]) is
// kept for a query i iff it is valid, q_seg[i] == kv_seg[j]
// (ROWS_SEGMENTED), kp <= q_pos[i] (causal) and, with a window, kp >
// q_pos[i] - window.  ROWS_PAGED and ROWS_FUSED treat a query at q_pos < 0
// as padding: it keeps nothing, outputs exact zeros and its q row is never
// read.  GQA reads kv head h / (H / KV).  The paged source visits only the
// positions [max(0, min_q - window + 1), min(max_q, nb * block - 1)] of the
// tile's valid queries, row j from the pool at table[b, j / block] * block
// + j % block, and traps on a visited table entry outside [0, n_blocks).
// The other sources skip every kv tile with no valid row, whose smallest
// position lies above the tile's largest query (causal), that lies wholly
// before the window, or whose segments miss the tile's.
//
// The same query over the same kv rows (the same positions, values and
// tiles) gives the same bits from every kernel and launch shape: each
// query's arithmetic depends only on its own row, the kv tiles hold BKV rows
// from row 0, and the kv range is split at fixed tiles (below).  So the
// unified step's chunked launches, the packed batches, the fused launches
// and the per-request prefill agree bit for bit on the same sequence, as
// they did when all four ran on flash_tile.cuh, and a serve's logits do not
// depend on which of them it ran.
//
// What bounds these launches on the H100: latency and bytes for the chunked
// and fused launches (129 valid queries over ~2,700 kept rows, or a few
// hundred gappy queries over ~2,000 rows: ~45 MB of K/V), operations for
// the packed and flash ones (thousands of queries).  The CUDA-core tile ran
// them at 60-80x their bound: f32 products from shared memory, a full round
// trip to device memory on every kv tile, and one block walking its tile's
// whole kv range in series.  What this design does about it:
//
//   * QK^T and PV run on the tensor cores, mma.sync m16n8k16 (bf16 in,
//     f32 accumulate), operands from shared memory through ldmatrix, rows
//     padded by 16 bytes so that the eight rows of a matrix hit distinct
//     banks.  Four warps each own 16 rows of the 64-query tile; the scores,
//     the probabilities and the online softmax (m, l, in base 2) stay in
//     registers (quad shuffles), with no shared score tile and no barrier
//     between QK^T, softmax and PV.  A warp skips the products of a kv tile
//     that none of its 16 queries keeps a row of (every tile, for a warp
//     that holds no valid query: a decode row is one warp's work), and
//     masks nothing on a tile that all its queries keep whole.
//   * P goes into PV as two bf16 halves, P_hi = bf16(P) and P_lo = bf16(P -
//     P_hi), accumulated by two mma's: P carries ~16 bits, so the output
//     agrees with the f32 plain version as the CUDA-core tile did (a
//     single bf16 P moves values by up to 2^-9 |v| and flips bf16
//     roundings).  QK^T needs no split: bf16 x bf16 products are exact in
//     f32.
//   * K/V tiles of BKV rows (64; 32 at the hd-256 bucket, where a warp's
//     16 x 256 f32 accumulator fills the registers) arrive by 16-byte
//     cp.async into a ring of two stages: the next tile's copies are issued
//     before the current tile's products.  Paged rows are gathered row by
//     row through the block table, so a tile may straddle pool blocks of
//     any size (this per-row gather is why the copies are cp.async and not
//     TMA).
//   * The kv tiles are split into S parts of PART fixed tiles each, part s
//     holding tiles [s * PART, (s + 1) * PART): grid (query tiles, H, B *
//     S), block s taking the part's tiles within its query tile's kv range
//     (computed on the device from the tile's valid queries).  With S > 1
//     each block writes its partial (m, l, acc) in f32 to scratch the
//     wrapper allocated, and a second kernel combines the parts in split
//     order; with S = 1 the tile writes the output.  PART and S come from
//     the kv length alone (split_parts): at most MAX_SPLITS parts of at
//     least PART_TILES tiles, so up to 4,096 kv rows (hd <= 128) every
//     launch splits at the same tiles.  No atomics enter any sum: the same
//     inputs give the same bits on every launch.
//
// Any head_dim hd in [1, 256] runs on the instantiation of the smallest
// bucket HD in {32, 64, 128, 256} that holds it, with zeros in the shared
// columns past hd; at hd == HD the FULL instantiation runs with hd the
// constant HD.  Rows are copied by cp.async when hd is a multiple of 8 (16-
// byte aligned rows) and element by element otherwise.
//
// Layouts (all contiguous): q, out [B, Sq, H, hd] bf16; k, v [B, Skv, KV,
// hd] (paged: the pool [n_blocks * block, KV, hd]); q_pos, q_seg [B, Sq]
// int32; kv_pos, kv_seg [B, Skv] int32; kv_valid [B, Skv] bool or null;
// table [B, nb] int32; scratch part_ml [S, B, Sq, H] (m, l) f32 and
// part_acc [S, B, Sq, H, hd] f32.
#pragma once

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace flash_mma {
namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;  // K/V tiles in flight
constexpr unsigned ALL = 0xffffffffu;

// kv row sources, with flash_tile.cuh's codes
constexpr int ROWS_DENSE = 0;
constexpr int ROWS_SEGMENTED = 1;
constexpr int ROWS_PAGED = 2;
constexpr int ROWS_FUSED = 3;

// The split of the kv tiles into parts: at most MAX_SPLITS parts of at least
// PART_TILES tiles.  Constants of the build, not settings.
constexpr int MAX_SPLITS = 8;
constexpr int PART_TILES = 8;

template <int HD>
struct Tile {
  static constexpr int BKV = HD == 256 ? 32 : 64;  // kv rows per tile
  static constexpr int LD = HD + 8;  // shared row stride (bf16): +16 bytes against bank conflicts
  static constexpr int CPR = HD / 8;  // 16-byte chunks per row
};

inline int bucket(int hd) { return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256; }

// The split of kv_rows rows (Skv, or nb * block) at head_dim hd: the tiles
// of a part and the number of parts S.
struct Split {
  int part_tiles, splits;
};
inline Split split_parts(long long kv_rows, int hd) {
  const long long bkv = bucket(hd) == 256 ? 32 : 64;
  const long long tiles = kv_rows < 1 ? 1 : (kv_rows + bkv - 1) / bkv;
  long long part = (tiles + MAX_SPLITS - 1) / MAX_SPLITS;
  if (part < PART_TILES) part = PART_TILES;
  return {int(part), int((tiles + part - 1) / part)};
}

struct Params {
  const bf16 *q, *k, *v;
  const int* q_pos;
  const int* kv_pos;               // not ROWS_PAGED
  const int *q_seg, *kv_seg;       // ROWS_SEGMENTED
  const unsigned char* kv_valid;   // ROWS_DENSE: [B, Skv] or null
  const int* table;                // ROWS_PAGED: [B, nb]
  bf16* out;
  float* part_acc;  // S > 1: [S, B, Sq, H, hd]
  float2* part_ml;  // S > 1: [S, B, Sq, H]
  int B, Sq, Skv, H, KV, hd, causal, has_window, window;
  float scale;
  int nb, n_blocks, block;  // ROWS_PAGED
  int splits, part_tiles;
  int words;  // 32-bit words of a part's visited-tile mask
};

template <int HD>
constexpr size_t smem_bytes_fixed() {
  using T = Tile<HD>;
  return sizeof(bf16) * (size_t(BQ) * T::LD + 2 * size_t(STAGES) * T::BKV * T::LD) +
         sizeof(int) * (2 * size_t(STAGES) * T::BKV + 3 * BQ);
}


// Columns [8c, 8c + 8) of the row at `src` (null: zeros) into shared `dst`:
// one cp.async when rows are 16-byte aligned (hd % 8 == 0), else element by
// element.  Columns past hd are zeros.
template <bool FULL>
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src, int c, int hd, bool vec,
                                           const bf16* any) {
  if (FULL || vec) {
    const bool read = src != nullptr && (FULL || 8 * c < hd);
    cp_async16(smem_u32(dst), read ? src + 8 * c : any, read ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = 8 * c + e;
      dst[e] = src != nullptr && d < hd ? src[d] : __float2bfloat16(0.f);
    }
  }
}

template <int HD, int SRC, bool FULL>
__global__ void __launch_bounds__(THREADS) attn_kernel(const Params p) {
  using T = Tile<HD>;
  constexpr int BKV = T::BKV, LD = T::LD, CPR = T::CPR;
  constexpr int NB = BKV / 8;  // score fragments (8 kv rows each) a warp holds
  constexpr int ND = HD / 8;   // output fragments (8 columns each)
  constexpr bool PAGED = SRC == ROWS_PAGED;
  constexpr bool SEG = SRC == ROWS_SEGMENTED;
  constexpr bool QPAD = PAGED || SRC == ROWS_FUSED;  // q_pos < 0 marks padding
  static_assert(HD % 16 == 0 && BKV % 16 == 0, "tiles are whole mma steps");
  const int hd = FULL ? HD : p.hd;
  const bool vec = FULL || hd % 8 == 0;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);         // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                          // [STAGES][BKV][LD]
  bf16* Vs = Ks + STAGES * BKV * LD;                // [STAGES][BKV][LD]
  int* kp_s = reinterpret_cast<int*>(Vs + STAGES * BKV * LD);  // [STAGES][BKV] (-1: invalid)
  int* ks_s = kp_s + STAGES * BKV;                  // [STAGES][BKV] segments
  int* qp_s = ks_s + STAGES * BKV;                  // [BQ]
  int* qs_s = qp_s + BQ;                            // [BQ] segments
  int* qv_s = qs_s + BQ;                            // [BQ] 1: a valid query
  unsigned* visit = reinterpret_cast<unsigned*>(qv_s + BQ);  // the part's visited tiles
  __shared__ int info[4];  // the valid queries' min, max position and segment

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int b = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int kvh = h / (p.H / p.KV);

  if (tid < BQ) {
    const int qi = q0 + tid;
    const int qp = qi < p.Sq ? __ldg(p.q_pos + size_t(b) * p.Sq + qi) : INT_MIN;
    qp_s[tid] = qp;
    qs_s[tid] = SEG && qi < p.Sq ? __ldg(p.q_seg + size_t(b) * p.Sq + qi) : 0;
    // rows past Sq are never written; padding of a paged or fused tile is
    // written as zeros and read nowhere
    qv_s[tid] = qi < p.Sq && (!QPAD || qp >= 0);
  }
  if constexpr (!PAGED)
    for (int i = tid; i < p.words; i += THREADS) visit[i] = 0u;
  __syncthreads();

  // this thread's rows of the warp's 16: g and g + 8 (the mma fragment rows)
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const bool v0 = qv_s[r0], v1 = qv_s[r1];
  const int qp0 = qp_s[r0], qp1 = qp_s[r1];
  const int qs0 = qs_s[r0], qs1 = qs_s[r1];
  // a kept key's position lies in [lo, hi]; an invalid query keeps none
  // (hi < 0 <= lo)
  const int hi0 = !v0 ? -1 : p.causal ? qp0 : INT_MAX;
  const int hi1 = !v1 ? -1 : p.causal ? qp1 : INT_MAX;
  int lo0 = 0, lo1 = 0;
  if (p.has_window) {
    lo0 = int(min(max(0LL, (long long)qp0 - p.window + 1), (long long)INT_MAX));
    lo1 = int(min(max(0LL, (long long)qp1 - p.window + 1), (long long)INT_MAX));
  }
  // the warp's valid queries keep positions in [wlo, whi] and segments in
  // [wsl, wsh] at most; a warp with none (whi < 0) skips every product
  const int whi = __reduce_max_sync(ALL, max(hi0, hi1));
  const int wlo = __reduce_min_sync(ALL, min(v0 ? lo0 : INT_MAX, v1 ? lo1 : INT_MAX));
  const int wsl = __reduce_min_sync(ALL, min(v0 ? qs0 : INT_MAX, v1 ? qs1 : INT_MAX));
  const int wsh = __reduce_max_sync(ALL, max(v0 ? qs0 : INT_MIN, v1 ? qs1 : INT_MIN));
  // a warp whose 16 queries are all valid, of one segment, needs no mask on
  // a kv tile whose rows are all valid, of that segment, and lie in
  // [wlo_max, whi_min]: every query keeps every row
  const bool full = __all_sync(ALL, v0 && v1) && wsl == wsh;
  const int whi_min = __reduce_min_sync(ALL, min(hi0, hi1));
  const int wlo_max = __reduce_max_sync(ALL, max(lo0, lo1));
  // scores go to the base-2 domain: p = 2^(s * scale * log2(e) - m)
  const float c = p.scale * 1.4426950408889634f;
  if (warp == 0) {
    int plo = INT_MAX, phi = INT_MIN, slo = INT_MAX, shi = INT_MIN;
    for (int r = lane; r < BQ; r += 32)
      if (qv_s[r]) {
        plo = min(plo, qp_s[r]);
        phi = max(phi, qp_s[r]);
        slo = min(slo, qs_s[r]);
        shi = max(shi, qs_s[r]);
      }
    plo = __reduce_min_sync(ALL, plo);
    phi = __reduce_max_sync(ALL, phi);
    slo = __reduce_min_sync(ALL, slo);
    shi = __reduce_max_sync(ALL, shi);
    if (lane == 0) {
      info[0] = plo;
      info[1] = phi;
      info[2] = slo;
      info[3] = shi;
    }
  }
  __syncthreads();
  const int plo = info[0], phi = info[1], slo = info[2], shi = info[3];
  const bool any_valid = slo != INT_MAX;

  // ---- an all-padding tile: zeros (S = 1; with S > 1 the combine writes them)
  if (!any_valid) {
    if (p.splits == 1)
      for (int i = tid; i < BQ * hd; i += THREADS) {
        const int r = i / hd, qi = q0 + r;
        if (qi < p.Sq)
          p.out[((size_t(b) * p.Sq + qi) * p.H + h) * hd + i % hd] = __float2bfloat16(0.f);
      }
    return;
  }

  // ---- this block's kv tiles: its part's, within the query tile's kv range
  const int n_tiles = (p.Skv + BKV - 1) / BKV;
  int t_begin = split * p.part_tiles;
  int t_end = min(t_begin + p.part_tiles, n_tiles);
  int lo_row = 0, kv_end = 0;  // paged: the visited rows
  if constexpr (PAGED) {
    const long long lo = p.has_window ? max(0LL, (long long)plo - p.window + 1) : 0LL;
    const long long last = min((long long)phi, (long long)p.nb * p.block - 1);
    if (lo > last) {
      t_end = t_begin;
    } else {
      lo_row = int(lo);
      kv_end = int(last) + 1;
      t_begin = max(t_begin, lo_row / BKV);
      t_end = min(t_end, (kv_end + BKV - 1) / BKV);
    }
  } else {
    // mark the part's kv tiles that the tile's valid queries can meet; a
    // warp reads the rows of SCAN tiles before it reduces them, so one round
    // trip to memory covers them all
    constexpr int SCAN = 8, PER = BKV / 32;
    for (int t0 = t_begin + warp; t0 < t_end; t0 += WARPS * SCAN) {
      int kp[SCAN][PER], ks[SCAN][PER];
#pragma unroll
      for (int u = 0; u < SCAN; ++u)
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int t = t0 + u * WARPS, j = t * BKV + lane + 32 * i;
          const size_t at = size_t(b) * p.Skv + j;
          const bool in = t < t_end && j < p.Skv &&
                          (p.kv_valid == nullptr || __ldg(p.kv_valid + at) != 0);
          kp[u][i] = in ? __ldg(p.kv_pos + at) : -1;
          ks[u][i] = SEG && in ? __ldg(p.kv_seg + at) : 0;
        }
#pragma unroll
      for (int u = 0; u < SCAN; ++u) {
        int klo = INT_MAX, khi = INT_MIN, kslo = INT_MAX, kshi = INT_MIN;
#pragma unroll
        for (int i = 0; i < PER; ++i)
          if (kp[u][i] >= 0) {
            klo = min(klo, kp[u][i]);
            khi = max(khi, kp[u][i]);
            kslo = min(kslo, ks[u][i]);
            kshi = max(kshi, ks[u][i]);
          }
        klo = __reduce_min_sync(ALL, klo);
        khi = __reduce_max_sync(ALL, khi);
        kslo = __reduce_min_sync(ALL, kslo);
        kshi = __reduce_max_sync(ALL, kshi);
        const int t = t0 + u * WARPS;
        bool meets = klo != INT_MAX;  // a valid row (a tile past the part has none)
        meets = meets && (!SEG || (kshi >= slo && kslo <= shi));
        meets = meets && (!p.causal || klo <= phi);
        meets = meets && (!p.has_window || (long long)khi > (long long)plo - p.window);
        if (lane == 0 && meets)
          atomicOr(visit + ((t - t_begin) >> 5), 1u << ((t - t_begin) & 31));
      }
    }
    __syncthreads();
  }
  auto next_tile = [&](int t) {
    if constexpr (!PAGED)
      while (t < t_end && !((visit[(t - t_begin) >> 5] >> ((t - t_begin) & 31)) & 1u)) ++t;
    return t;
  };

  auto load_q = [&]() {
    for (int i = tid; i < BQ * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR, qi = q0 + r;
      const bf16* src = qv_s[r] ? p.q + ((size_t(b) * p.Sq + qi) * p.H + h) * hd : nullptr;
      copy_chunk<FULL>(Qs + r * LD + 8 * c, src, c, hd, vec, p.q);
    }
  };
  auto load_kv = [&](int t, int st) {
    const int j0 = t * BKV;
    if (tid < BKV) {  // the rows' positions (and segments): -1 for an invalid row
      const int j = j0 + tid;
      const size_t at = size_t(b) * p.Skv + j;
      int* kp = kp_s + st * BKV + tid;
      if constexpr (PAGED) {
        *kp = j >= lo_row && j < kv_end ? j : -1;
      } else if (j >= p.Skv) {
        *kp = -1;
      } else if (p.kv_valid != nullptr) {
        *kp = __ldg(p.kv_valid + at) != 0 ? __ldg(p.kv_pos + at) : -1;
      } else {
        cp_async4(smem_u32(kp), p.kv_pos + at);
      }
      if constexpr (SEG)
        if (j < p.Skv) cp_async4(smem_u32(ks_s + st * BKV + tid), p.kv_seg + at);
    }
    for (int i = tid; i < BKV * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR, j = j0 + r;
      size_t off = 0;
      bool read = false;
      if constexpr (PAGED) {
        if (j >= lo_row && j < kv_end) {
          const int bid = __ldg(p.table + size_t(b) * p.nb + j / p.block);
          if (bid < 0 || bid >= p.n_blocks) __trap();
          off = ((size_t(bid) * p.block + j % p.block) * p.KV + kvh) * hd;
          read = true;
        }
      } else if (j < p.Skv) {
        off = ((size_t(b) * p.Skv + j) * p.KV + kvh) * hd;
        read = true;
      }
      const int row = (st * BKV + r) * LD + 8 * c;
      copy_chunk<FULL>(Ks + row, read ? p.k + off : nullptr, c, hd, vec, p.k);
      copy_chunk<FULL>(Vs + row, read ? p.v + off : nullptr, c, hd, vec, p.v);
    }
  };

  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // ldmatrix lane addresses: Q as the A operand (rows of the warp, 8-column
  // halves by lane / 16), K as B (kv rows by lane % 8 and lane / 16, column
  // halves by (lane / 8) & 1), V as B transposed (kv rows by lane % 8 and
  // (lane / 8) & 1, column halves by lane / 16)
  const uint32_t q_addr = smem_u32(Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t k_addr =
      smem_u32(Ks + ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8);
  const uint32_t v_addr =
      smem_u32(Vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8);
  constexpr uint32_t STAGE_BYTES = BKV * LD * sizeof(bf16);
  constexpr uint32_t ROW_BYTES = LD * sizeof(bf16);

  int t = next_tile(t_begin);
  if (t < t_end) {
    load_q();
    load_kv(t, 0);
    cp_commit();
    int st = 0;
    while (t < t_end) {
      const int tn = next_tile(t + 1);
      if (tn < t_end) load_kv(tn, st ^ 1);
      cp_commit();
      cp_wait<1>();  // this tile's copies (and Q's) have landed
      __syncthreads();
      // the tile's valid rows span positions [kmin, kmax] and segments
      // [ksl, ksh]: a warp none of whose queries meets them skips its products
      const int* kps = kp_s + st * BKV;
      const int* kss = ks_s + st * BKV;
      int kmin = INT_MAX, kmax = -1, ksl = INT_MAX, ksh = INT_MIN;
      bool all_valid = true;
#pragma unroll
      for (int i = lane; i < BKV; i += 32) {
        const int kp = kps[i];
        if (kp >= 0) {
          kmin = min(kmin, kp);
          kmax = max(kmax, kp);
          if constexpr (SEG) {
            ksl = min(ksl, kss[i]);
            ksh = max(ksh, kss[i]);
          }
        } else {
          all_valid = false;
        }
      }
      kmin = __reduce_min_sync(ALL, kmin);
      kmax = __reduce_max_sync(ALL, kmax);
      all_valid = __all_sync(ALL, all_valid);
      bool meets = kmin <= whi && kmax >= wlo;
      bool whole = full && all_valid && kmax <= whi_min && kmin >= wlo_max;
      if constexpr (SEG) {
        ksl = __reduce_min_sync(ALL, ksl);
        ksh = __reduce_max_sync(ALL, ksh);
        meets = meets && ksh >= wsl && ksl <= wsh;
        whole = whole && ksl == wsl && ksh == wsl;
      }
      if (meets) {
        // ---- S = Q K^T: 16 rows x BKV kv rows a warp
        float s[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, q_addr + kk * 32);
#pragma unroll
          for (int n2 = 0; n2 < NB / 2; ++n2) {
            uint32_t bk[4];
            ldsm_x4(bk, k_addr + st * STAGE_BYTES + n2 * 16 * ROW_BYTES + kk * 32);
            mma_bf16(s[2 * n2], a, bk[0], bk[1]);
            mma_bf16(s[2 * n2 + 1], a, bk[2], bk[3]);
          }
        }
        // ---- mask, online softmax (rows g and g + 8, quad shuffles)
        if (!whole) {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const int col = nb * 8 + 2 * qd;
            const int2 kp = *reinterpret_cast<const int2*>(kps + col);
            int2 ks = make_int2(0, 0);
            if constexpr (SEG) ks = *reinterpret_cast<const int2*>(kss + col);
            if (!(kp.x >= lo0 && kp.x <= hi0 && ks.x == qs0)) s[nb][0] = -INFINITY;
            if (!(kp.y >= lo0 && kp.y <= hi0 && ks.y == qs0)) s[nb][1] = -INFINITY;
            if (!(kp.x >= lo1 && kp.x <= hi1 && ks.x == qs1)) s[nb][2] = -INFINITY;
            if (!(kp.y >= lo1 && kp.y <= hi1 && ks.y == qs1)) s[nb][3] = -INFINITY;
          }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
          mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(ALL, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(ALL, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(ALL, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(ALL, mx1, 2));
        // m is kept in the base-2 domain; a masked score is -inf, so 2^-inf = 0
        const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          s[nb][0] = ex2(fmaf(s[nb][0], c, -mn0));
          s[nb][1] = ex2(fmaf(s[nb][1], c, -mn0));
          s[nb][2] = ex2(fmaf(s[nb][2], c, -mn1));
          s[nb][3] = ex2(fmaf(s[nb][3], c, -mn1));
          sum0 += s[nb][0] + s[nb][1];
          sum1 += s[nb][2] + s[nb][3];
        }
        sum0 += __shfl_xor_sync(ALL, sum0, 1);
        sum0 += __shfl_xor_sync(ALL, sum0, 2);
        sum1 += __shfl_xor_sync(ALL, sum1, 1);
        sum1 += __shfl_xor_sync(ALL, sum1, 2);
        const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          acc[d][0] *= alpha0;
          acc[d][1] *= alpha0;
          acc[d][2] *= alpha1;
          acc[d][3] *= alpha1;
        }
        // ---- acc += P_hi V + P_lo V: the score fragments are the A operand
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          uint32_t ph[4], pl[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int d2 = 0; d2 < ND / 2; ++d2) {
            uint32_t bv[4];
            ldsm_x4_t(bv, v_addr + st * STAGE_BYTES + kk * 16 * ROW_BYTES + d2 * 32);
            mma_bf16(acc[2 * d2], ph, bv[0], bv[1]);
            mma_bf16(acc[2 * d2], pl, bv[0], bv[1]);
            mma_bf16(acc[2 * d2 + 1], ph, bv[2], bv[3]);
            mma_bf16(acc[2 * d2 + 1], pl, bv[2], bv[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
      t = tn;
      st ^= 1;
    }
  }

  // ---- the output (S = 1) or this part's (m, l, acc) (S > 1)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + (half ? r1 : r0);
    const float m = half ? m1 : m0, l = half ? l1 : l0;
    if (qi >= p.Sq) continue;
    const size_t row = (size_t(b) * p.Sq + qi) * p.H + h;
    if (p.splits == 1) {
      // padding and queries that keep nothing have acc == 0: exact zeros
      const float ll = fmaxf(l, 1e-30f);
      bf16* o = p.out + row * hd;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int col = d * 8 + 2 * qd;
        const float x0 = acc[d][2 * half] / ll, x1 = acc[d][2 * half + 1] / ll;
        if (FULL) {
          *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < hd) o[col] = __float2bfloat16(x0);
          if (col + 1 < hd) o[col + 1] = __float2bfloat16(x1);
        }
      }
    } else if (half ? v1 : v0) {
      const size_t prow = size_t(split) * p.B * p.Sq * p.H + row;
      if (qd == 0) p.part_ml[prow] = make_float2(m, l);
      if (l > 0.f) {  // the combine reads acc only where l > 0
        float* a = p.part_acc + prow * hd;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const int col = d * 8 + 2 * qd;
          if (FULL) {
            *reinterpret_cast<float2*>(a + col) =
                make_float2(acc[d][2 * half], acc[d][2 * half + 1]);
          } else {
            if (col < hd) a[col] = acc[d][2 * half];
            if (col + 1 < hd) a[col + 1] = acc[d][2 * half + 1];
          }
        }
      }
    }
  }
}

// out = sum_s w_s acc_s / sum_s w_s l_s with w_s = 2^(m_s - max_s m_s), in
// split order; one warp per (b, query, head) row, exact zeros for the
// padding of a paged or fused launch (QPAD).
template <bool QPAD>
__global__ void __launch_bounds__(256) combine_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rows = size_t(p.B) * p.Sq * p.H;
  const size_t row = size_t(blockIdx.x) * 8 + warp;
  if (row >= rows) return;
  const bool pad = QPAD && __ldg(p.q_pos + row / p.H) < 0;
  float w[MAX_SPLITS], l[MAX_SPLITS];
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s) {
    // read beside q_pos; a padding row's (never written) values are unused
    const float2 ml = s < p.splits ? p.part_ml[s * rows + row] : make_float2(NEG_INF, 0.f);
    w[s] = ml.x;
    l[s] = ml.y;
  }
  bf16* o = p.out + row * p.hd;
  if (pad) {
    for (int d = lane; d < p.hd; d += 32) o[d] = __float2bfloat16(0.f);
    return;
  }
  float mx = NEG_INF;
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s) mx = fmaxf(mx, w[s]);
  float den = 0.f;
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s) {
    w[s] = l[s] > 0.f ? ex2(w[s] - mx) : 0.f;  // m_s -> w_s
    den += l[s] * w[s];
  }
  den = fmaxf(den, 1e-30f);
  if (p.hd % 4 == 0) {  // four columns a lane: 16-byte loads
    for (int d = 4 * lane; d < p.hd; d += 128) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s)
        if (l[s] > 0.f) {
          const float4 a =
              __ldg(reinterpret_cast<const float4*>(p.part_acc + (s * rows + row) * p.hd + d));
          x.x += a.x * w[s];
          x.y += a.y * w[s];
          x.z += a.z * w[s];
          x.w += a.w * w[s];
        }
      *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(x.x / den, x.y / den);
      *reinterpret_cast<__nv_bfloat162*>(o + d + 2) =
          __floats2bfloat162_rn(x.z / den, x.w / den);
    }
  } else {
    for (int d = lane; d < p.hd; d += 32) {
      float x = 0.f;
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s)
        if (l[s] > 0.f) x += p.part_acc[(s * rows + row) * p.hd + d] * w[s];
      o[d] = __float2bfloat16(x / den);
    }
  }
}

template <int HD, int SRC>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes_fixed<HD>() + sizeof(unsigned) * size_t(p.words);
  auto kernel = p.hd == HD ? attn_kernel<HD, SRC, true> : attn_kernel<HD, SRC, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B * p.splits);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return int(err);
  const size_t rows = size_t(p.B) * p.Sq * p.H;
  constexpr bool QPAD = SRC == ROWS_PAGED || SRC == ROWS_FUSED;
  combine_kernel<QPAD><<<unsigned((rows + 7) / 8), 256, 0, stream>>>(p);
  return int(cudaGetLastError());
}

// Check the shapes and the scratch, split the kv tiles, pick the head_dim
// bucket and launch (the tile kernel, then the combine when S > 1).  p.Skv
// is the kv length (paged: nb * block).  Returns the CUDA status:
// cudaErrorInvalidValue for a head_dim outside [1, 256], a head grouping or
// sizes it does not take, or S > 1 without scratch.
template <int SRC>
int dispatch(Params p, cudaStream_t stream) {
  if (p.KV <= 0 || p.H % p.KV != 0 || p.Sq <= 0 || p.Skv <= 0 || p.B <= 0)
    return int(cudaErrorInvalidValue);
  if (p.hd < 1 || p.hd > 256) return int(cudaErrorInvalidValue);
  const Split sp = split_parts(p.Skv, p.hd);
  p.splits = sp.splits;
  p.part_tiles = sp.part_tiles;
  p.words = SRC == ROWS_PAGED ? 0 : (sp.part_tiles + 31) / 32;
  if ((long long)p.B * p.splits > 65535 || p.H > 65535) return int(cudaErrorInvalidValue);
  if (p.splits > 1 && (p.part_acc == nullptr || p.part_ml == nullptr))
    return int(cudaErrorInvalidValue);
  switch (bucket(p.hd)) {
    case 32: return launch<32, SRC>(p, stream);
    case 64: return launch<64, SRC>(p, stream);
    case 128: return launch<128, SRC>(p, stream);
    default: return launch<256, SRC>(p, stream);
  }
}

}  // namespace
}  // namespace flash_mma
}  // namespace repro_torch
