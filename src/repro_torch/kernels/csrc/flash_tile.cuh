// The tiled flash-attention kernel on the CUDA cores, shared by the f32
// launches of the four prefill attention kernels: `flash_attention`
// (flash_prefill.cu), `packed_flash_attention` (packed_prefill.cu),
// `chunked_prefill_attention` (chunked_prefill.cu) and
// `fused_flash_attention` (fused_prefill.cu).  Their bf16 launches run on
// the tensor-core tile of flash_mma.cuh; f32 stays here because the tests
// hold the algorithm to the plain versions in f32 at atol 2e-5, which
// neither TF32 nor bf16 tensor-core operands meet.  The four differ only in
// where kv row j comes from and which queries are padding (the SRC template
// argument):
//
//   ROWS_DENSE      row j of the sequence's own k/v, at position kv_pos[j];
//   ROWS_SEGMENTED  the same, plus a segment id kv_seg[j] (packed batches);
//   ROWS_PAGED      position j itself, read from the shared block pool at
//                   row table[b, j / block] * block + j % block;
//   ROWS_FUSED      as ROWS_DENSE, with queries at q_pos < 0 treated as
//                   padding (the gappy recompute queries of fused reuse).
//
// A key row j is kept for a query i iff kv_pos[j] >= 0, kv_valid[j] (when
// given), q_seg[i] == kv_seg[j] (segmented only), kv_pos[j] <= q_pos[i]
// (causal) and, with a window, kv_pos[j] > q_pos[i] - window.  Queries that
// every key masks output zeros.
//
// What bounds these launches on the H100: operations for the flash and
// packed launches (thousands of queries, 32 heads, hd 128: the QK^T and PV
// products over the tiles the mask leaves take longer at the card's f32
// rate than reading q, k, v once and writing the output at its memory
// rate); bytes and latency for the chunked and fused ones (a few hundred
// valid queries).  This tile runs them at 10-60x their f32 bound: f32
// products from shared memory, a round trip to device memory on every kv
// tile, one block walking its whole kv range in series.  flash_mma.cuh is
// the redesign for bf16 (tensor cores, cp.async tiles, a split kv range).
//
// What this design does about it: it skips every kv tile that cannot meet
// the query tile — no valid row, disjoint segment-id ranges (SEG), a
// smallest kv position above the tile's largest query position (causal), or
// a largest kv position at or below the smallest query position minus the
// window — so the work follows the causal (and segment-diagonal) blocks
// instead of the full Sq x Skv rectangle; a per-request prefill against a
// max_len cache whose rows past offset+S are invalid skips that tail whole.
// Inside a tile, the products run on the CUDA cores in f32 from f32 copies
// in shared memory (register-tiled 4x2 for QK^T and 4x(hd/16) for PV) with
// an online softmax (m, l, acc) in f32.
//
// The paged and fused sources treat a query at q_pos < 0 as padding: it
// sets none of the tile's position bounds (so a -2^30 neither widens the
// range nor disables the window skip), its q row is not read, and a tile
// whose queries are all padding writes zeros without touching q or k/v.
// The paged source reads no kv_pos: a query tile loops over positions
// [max(0, min_q - window + 1), min(max_q, nb * block - 1)] only, where min_q
// and max_q are its smallest and largest valid query positions, so table
// padding on the dump block is never read.  A table entry outside
// [0, n_blocks) on that range traps.
//
// Any head_dim hd in [1, 256] runs, on the instantiation of the smallest
// bucket HD in {32, 64, 128, 256} that holds it: global offsets use the true
// hd, loads past it read zeros into shared memory (adding nothing to q.k or
// p.v) and stores past it are skipped.  At hd == HD the FULL instantiation
// runs, whose hd is the constant HD: the code of a kernel built for hd
// alone, with no bounds test left in it.
//
// Layouts (all contiguous): q, out [B, Sq, H, hd]; k, v [B, Skv, KV, hd]
// (paged: the pool [n_blocks * block, KV, hd]); q_pos [B, Sq] int32; kv_pos
// [B, Skv] int32; q_seg [B, Sq], kv_seg [B, Skv] int32 (segmented only);
// kv_valid [B, Skv] bool or null; table [B, nb] int32 (paged only); lse
// [B, Sq, H] f32 or null (dense only: the training forward's log-sum-exp of
// each row, written beside the output row and nowhere else).
// Grid (ceil(Sq / BQ), H, B), 256 threads.
#pragma once

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace flash {
namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 32;   // kv rows per tile (one per lane of warp 0)
constexpr int SP = BKV + 1;  // padded row stride of the score tile
constexpr int THREADS = 256;

// kv row sources (see the header)
constexpr int ROWS_DENSE = 0;
constexpr int ROWS_SEGMENTED = 1;
constexpr int ROWS_PAGED = 2;
constexpr int ROWS_FUSED = 3;

template <int HD>
constexpr size_t smem_bytes() {
  // the int arrays end on an 8-byte boundary (HD is a multiple of 16), so
  // the paged row offsets that follow them are aligned
  return sizeof(float) * (size_t(BQ) * HD + size_t(BKV) * (HD + 1) + size_t(BKV) * HD +
                          size_t(BQ) * SP + 3 * BQ) +
         sizeof(int) * (2 * BQ + 2 * BKV) + sizeof(long long) * BKV;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// SRC: the kv row source; q_seg/kv_seg are read only for ROWS_SEGMENTED,
// table/nb/n_blocks/block only for ROWS_PAGED, kv_pos/kv_valid never then.
// HD is the head_dim bucket the shared tiles are sized for, hd_arg <= HD the
// true head_dim of the tensors (FULL: hd_arg == HD, known when compiling).
template <typename T, int HD, int SRC, bool FULL>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
            const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
            const unsigned char* __restrict__ kv_valid, const int* __restrict__ table,
            T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int H, int KV,
            int hd_arg, int causal, int has_window, int window, float scale, int nb,
            int n_blocks, int block) {
  const int hd = FULL ? HD : hd_arg;
  static_assert(HD % 16 == 0, "the head_dim bucket must be a multiple of 16");
  constexpr bool SEG = SRC == ROWS_SEGMENTED;
  constexpr bool PAGED = SRC == ROWS_PAGED;
  constexpr bool QPAD = PAGED || SRC == ROWS_FUSED;  // q_pos < 0 marks padding
  constexpr int CT = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][HD]
  float* Ks = Qs + BQ * HD;           // [BKV][HD + 1]
  float* Vs = Ks + BKV * (HD + 1);    // [BKV][HD]
  float* S = Vs + BKV * HD;           // [BQ][SP] scores, then probabilities
  float* m_s = S + BQ * SP;           // [BQ] running max
  float* l_s = m_s + BQ;              // [BQ] running denominator
  float* a_s = l_s + BQ;              // [BQ] this tile's rescale factor
  int* qp_s = reinterpret_cast<int*>(a_s + BQ);  // [BQ]
  int* qs_s = qp_s + BQ;              // [BQ]
  int* kp_s = qs_s + BQ;              // [BKV] (-1 = invalid row)
  int* ks_s = kp_s + BKV;             // [BKV]
  long long* ko_s = reinterpret_cast<long long*>(ks_s + BKV);  // [BKV] pool offsets (paged)
  __shared__ int q_info[4];           // seg_lo, seg_hi, pos_lo, pos_hi
  __shared__ int tile_skip;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  if (tid < BQ) {
    const int qi = q0 + tid;
    // rows past Sq are never written; INT_MIN keeps them out of every segment
    qp_s[tid] = qi < Sq ? q_pos[size_t(b) * Sq + qi] : INT_MIN;
    qs_s[tid] = !SEG ? 0 : qi < Sq ? q_seg[size_t(b) * Sq + qi] : INT_MIN;
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    int slo = INT_MAX, shi = INT_MIN, plo = INT_MAX, phi = INT_MIN;
    for (int r = tid; r < BQ; r += 32) {
      // padding queries (q_pos < 0) of a paged or fused tile set no bounds
      if (q0 + r < Sq && (!QPAD || qp_s[r] >= 0)) {
        slo = min(slo, qs_s[r]);
        shi = max(shi, qs_s[r]);
        plo = min(plo, qp_s[r]);
        phi = max(phi, qp_s[r]);
      }
    }
    slo = warp_min(slo);
    shi = warp_max(shi);
    plo = warp_min(plo);
    phi = warp_max(phi);
    if (tid == 0) {
      q_info[0] = slo;
      q_info[1] = shi;
      q_info[2] = plo;
      q_info[3] = phi;
    }
  }

  __syncthreads();  // q_info is read by every thread below

  if constexpr (QPAD) {
    if (q_info[3] == INT_MIN) {  // all padding: zeros, q and k/v unread
      for (int i = tid; i < BQ * hd; i += THREADS) {
        const int r = i / hd, d = i % hd, qi = q0 + r;
        if (qi < Sq) out[((size_t(b) * Sq + qi) * H + h) * hd + d] = from_float<T>(0.f);
      }
      return;
    }
  }

  // the kv rows this query tile visits: every row, or (paged) the positions
  // its valid queries can reach; rows of [kv_begin, lo_row) stay masked
  int kv_begin = 0, kv_end = Skv, lo_row = 0;
  if constexpr (PAGED) {
    long long lo = has_window ? (long long)q_info[2] - window + 1 : 0;
    if (lo < 0) lo = 0;
    const long long last = min((long long)q_info[3], (long long)nb * block - 1);
    lo_row = lo > last ? int(last) + 1 : int(lo);
    kv_end = int(last) + 1;
    kv_begin = lo_row - lo_row % BKV;
  }

  // the tile's queries (a paged or fused tile reads no padding query's
  // row); the kv loop's first barrier orders these writes before their
  // first use
  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    const bool read = qi < Sq && d < hd && (!QPAD || qp_s[r] >= 0);
    Qs[i] = read ? to_float(q[((size_t(b) * Sq + qi) * H + h) * hd + d]) : 0.f;
  }

  const int rg = tid >> 4;  // rows rg*4 .. rg*4+3 of the QK^T and PV tiles
  const int cg = tid & 15;
  float acc[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < CT; ++t) acc[i][t] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BKV) {
    // ---- tile metadata and the skip test (warp 0, one kv row per lane)
    if (tid < 32) {
      const int j = kv0 + tid;
      int kp = -1, ks = 0;
      if constexpr (PAGED) {
        if (j >= lo_row && j < kv_end) {
          const int bid = __ldg(table + size_t(b) * nb + j / block);
          if (bid < 0 || bid >= n_blocks) __trap();
          kp = j;
          ko_s[tid] = ((long long)bid * block + j % block) * KV * hd + (long long)kvh * hd;
        }
      } else if (j < Skv) {
        kp = kv_pos[size_t(b) * Skv + j];
        if (kv_valid != nullptr && kv_valid[size_t(b) * Skv + j] == 0) kp = -1;
        if (SEG) ks = kv_seg[size_t(b) * Skv + j];
      }
      const bool valid = kp >= 0;
      kp_s[tid] = valid ? kp : -1;
      ks_s[tid] = ks;
      const int slo = warp_min(valid ? ks : INT_MAX);
      const int shi = warp_max(valid ? ks : INT_MIN);
      const int plo = warp_min(valid ? kp : INT_MAX);
      const int phi = warp_max(valid ? kp : INT_MIN);
      if (tid == 0) {
        bool skip = plo == INT_MAX || shi < q_info[0] || slo > q_info[1];
        skip = skip || (causal && plo > q_info[3]);
        skip = skip || (has_window && (long long)phi <= (long long)q_info[2] - window);
        tile_skip = skip;
      }
    }
    __syncthreads();
    const bool skip = tile_skip;
    __syncthreads();  // every thread has read the flag before warp 0 rewrites it
    if (skip) continue;

    for (int i = tid; i < BKV * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, j = kv0 + r;
      float kk = 0.f, vv = 0.f;
      if (d >= hd) {
        // padded columns stay zero
      } else if constexpr (PAGED) {
        if (kp_s[r] >= 0) {
          const size_t off = size_t(ko_s[r]) + d;
          kk = to_float(k[off]);
          vv = to_float(v[off]);
        }
      } else if (j < Skv) {
        const size_t off = ((size_t(b) * Skv + j) * KV + kvh) * hd + d;
        kk = to_float(k[off]);
        vv = to_float(v[off]);
      }
      Ks[r * (HD + 1) + d] = kk;
      Vs[r * HD + d] = vv;
    }
    __syncthreads();

    // ---- scores: each thread a 4 (query) x 2 (kv) micro-tile
    {
      float sc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
      const float* k0 = Ks + (cg * 2) * (HD + 1);
      const float* k1 = k0 + (HD + 1);
      const float* qr = Qs + (rg * 4) * HD;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float a0 = k0[d], a1 = k1[d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qv = qr[i * HD + d];
          sc[i][0] = fmaf(qv, a0, sc[i][0]);
          sc[i][1] = fmaf(qv, a1, sc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
        const int qp = qp_s[r], qs = qs_s[r];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = cg * 2 + c;
          const int kp = kp_s[j];
          bool keep = kp >= 0 && (!SEG || qs == ks_s[j]);
          keep = keep && (!causal || kp <= qp);
          keep = keep && (!has_window || (long long)kp > (long long)qp - window);
          S[r * SP + j] = keep ? sc[i][c] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // ---- online softmax: four threads per query row, eight columns each
    {
      const int r = tid >> 2, sub = tid & 3;
      float* row = S + r * SP + sub * 8;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float s = row[c];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (sub == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + P V: rows rg*4.., columns cg + 16 t
    {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float alpha = a_s[rg * 4 + i];
#pragma unroll
        for (int t = 0; t < CT; ++t) acc[i][t] *= alpha;
      }
      for (int j = 0; j < BKV; ++j) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = S[(rg * 4 + i) * SP + j];
        const float* vr = Vs + j * HD + cg;
#pragma unroll
        for (int t = 0; t < CT; ++t) {
          const float vv = vr[16 * t];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][t] = fmaf(p[i], vv, acc[i][t]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i, qi = q0 + r;
    if (qi >= Sq) continue;
    // the row's log-sum-exp of the scaled scores (-inf when it keeps no key)
    if (lse != nullptr && cg == 0)
      lse[(size_t(b) * Sq + qi) * H + h] = l_s[r] > 0.f ? m_s[r] + logf(l_s[r]) : -INFINITY;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* o = out + ((size_t(b) * Sq + qi) * H + h) * hd + cg;
#pragma unroll
    for (int t = 0; t < CT; ++t)
      if (cg + 16 * t < hd) o[16 * t] = from_float<T>(acc[i][t] / l);
  }
}

// Everything one launch needs besides the tensors' element type and head_dim.
// The paged fields follow the rest, so the other sources' initializers leave
// them zero.
struct Args {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos, *q_seg, *kv_seg;
  const unsigned char* kv_valid;
  void* out;
  int B, Sq, Skv, H, KV, causal, has_window, window;
  float scale;
  cudaStream_t stream;
  const int* table;  // ROWS_PAGED: [B, nb] pool block per sequence block
  int nb, n_blocks, block;
  float* lse;  // ROWS_DENSE under training: [B, Sq, H] f32, or null
};

template <typename T, int HD, int SRC>
int launch(const Args& a, int hd) {
  const size_t smem = smem_bytes<HD>();
  auto kernel = hd == HD ? tile_kernel<T, HD, SRC, true> : tile_kernel<T, HD, SRC, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.q_pos, a.kv_pos, a.q_seg, a.kv_seg, a.kv_valid, a.table, static_cast<T*>(a.out), a.lse,
      a.Sq, a.Skv, a.H, a.KV, hd, a.causal, a.has_window, a.window, a.scale, a.nb, a.n_blocks,
      a.block);
  return int(cudaGetLastError());
}

// Check the shapes, pick the instantiation for the element type T and the
// head_dim bucket, and launch.  Returns the CUDA status:
// cudaErrorInvalidValue for a head_dim outside [1, 256] or an unsupported
// head grouping.
template <typename T, int SRC>
int dispatch_as(int hd, const Args& a) {
  if (a.KV <= 0 || a.H % a.KV != 0 || a.Sq <= 0 || a.Skv <= 0 || a.B <= 0)
    return int(cudaErrorInvalidValue);
  if (hd < 1 || hd > 256) return int(cudaErrorInvalidValue);
  if (hd <= 32) return launch<T, 32, SRC>(a, hd);
  if (hd <= 64) return launch<T, 64, SRC>(a, hd);
  if (hd <= 128) return launch<T, 128, SRC>(a, hd);
  return launch<T, 256, SRC>(a, hd);
}

}  // namespace
}  // namespace flash
}  // namespace repro_torch
