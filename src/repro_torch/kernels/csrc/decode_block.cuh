// The body shared by the decode kernels `decode_attention`
// (decode_attention.cu, dense slotted cache) and `paged_decode_attention`
// (paged_decode.cu, shared block pool): one query token per sequence.
//
// What bounds both on the H100: bytes.  Each kept cache row is read once and
// feeds 4 * G * hd operations for 4 * hd bytes of K and V (bf16), far below
// the ~295 operations a byte at which the card's arithmetic becomes the
// limit, so the time is the K/V bytes over the memory rate.  Reaching that
// rate takes every SM streaming with many bytes in flight.
//
// What the design does about it:
//   * Fixed position parts.  Each sequence's rows are split into parts of
//     PART positions counted from 0 (the dense kernel's ceil(L / PART)
//     parts, the paged kernel's ceil(nb * block / PART)).  A block takes one
//     (kv head, tile of up to GT of its query heads, sequence, part):
//     grid (KV * ceil(G / GT), B, parts), so a launch of a few sequences
//     still puts blocks on every SM.  With more than one part each block
//     writes its partial softmax state (m, l, acc) to the scratch, and a
//     combine kernel reads each (sequence, head)'s parts in part order: no
//     atomics, and a part that keeps no row writes (NEG_INF, 0), which the
//     combine weighs 0 (its acc, never written, is replaced by 0), so it is
//     an exact no-op.
//   * Bytes in flight.  A block's four warps each stream their own tiles of
//     TILE = 16 rows (warp w takes tiles w, w + 4, ... of the part) through a
//     ring of STAGES (2) tiles in shared memory, K and V rows copied by
//     cp.async in 16-byte chunks, each copy instruction reading whole rows;
//     the warp waits only for the tile it is about to use.  Rows the mask
//     drops are zero-filled and not read; a tile that keeps no row is
//     neither loaded nor computed.
//   * One reduction per tile.  Two lanes take a row (half its columns each)
//     and run the q.k dot product from shared memory, q broadcast from an
//     f32 copy; one shuffle joins the halves, and one max over the tile's 16
//     rows (4 shuffles) updates the running max.  The running sum l stays
//     per lane (summed once at the end), and P.V reads P from shared memory,
//     a lane owning hd / 32 output columns.  Scores are in base 2 (the scale
//     times log2 e folded into one multiply) and exponentiated with ex2; the
//     softmax state is f32 throughout.
// The warps' states merge in warp order at the end of the block.
//
// A `Rows` source says which rows of a 16-row tile the query keeps (a bit
// mask) and where row j lives; the two kernels differ only in that source
// and in the prologue that fills it, so over the same rows (dense row j
// holding position j) they do the same arithmetic in the same order and
// give the same bits.  f32 and bf16 run the same body.
//
// Any head_dim hd in [1, 256] runs, on the instantiation of the smallest
// bucket HD in {32, 64, 128, 256} that holds it, the columns past hd being
// zeros: the loops run over HD, and hd only bounds the copies and the
// output.  Rows whose bytes are a multiple of 16 are copied by cp.async;
// other rows (an hd that is not a multiple of 8 in bf16 or 4 in f32)
// element by element.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace decode {
namespace {

constexpr int NW = 4;              // warps of a block, each with its own ring
constexpr int THREADS = 32 * NW;
constexpr int TILE = 16;           // rows of a warp's tile: two lanes a row
constexpr int GT = 8;              // query heads a block takes (a tile of one kv head's G)
constexpr int PART = 256;          // positions of a part; kernels/decode_attention.py PART
constexpr int TPW = PART / (TILE * NW);  // tiles of a part each warp takes
constexpr unsigned ALL = 0xffffffffu;
static_assert(PART % (TILE * NW) == 0 && PART % 32 == 0, "a part is whole tiles of every warp");

// The blocks of one kv head (grid axis x, with the kv head) and the heads
// one block holds.
__host__ __device__ inline int g_tiles(int G) { return (G + GT - 1) / GT; }
inline int tile_heads(int G) { return G < GT ? G : GT; }
// The parts of `rows` positions: the length alone decides the split.
inline long long part_count(long long rows) { return rows < 1 ? 1 : (rows + PART - 1) / PART; }

// The shared-memory layout of one instantiation: per warp a ring of STAGES
// tiles, each K then V, TILE rows of LD elements (16 bytes of padding keep
// the rows of a tile on distinct banks); then q in f32 [GM][HD], P [NW][GM][TILE]
// and PART + 1 ints of the row source (keep bits or table entries).  After
// the tiles, the ring holds the warps' states for the merge.
template <typename TT, int HD, int GM>
struct Layout {
  static constexpr int EL = 16 / int(sizeof(TT));  // elements of a 16-byte chunk
  static constexpr int CPR = HD / EL;              // chunks of a row
  static constexpr int LD = HD + EL;
  static constexpr int EPL = HD / 32;              // output columns of a lane
  static constexpr int ROW_BYTES = HD * int(sizeof(TT));
  // two tiles a warp: at hd 128 in bf16 three blocks then fit on an SM,
  // which ran faster on the H100 than two blocks with three tiles a warp
  static constexpr int STAGES = ROW_BYTES <= 512 ? 2 : 1;
  static constexpr int STAGE = 2 * TILE * LD;      // elements of one tile (K and V)
  static constexpr size_t RING = sizeof(TT) * size_t(NW) * STAGES * STAGE;
  static constexpr size_t Q = RING;
  static constexpr size_t P = Q + sizeof(float) * size_t(GM) * HD;
  static constexpr size_t INTS = P + sizeof(float) * size_t(NW) * GM * TILE;
  static constexpr size_t BYTES = INTS + sizeof(int) * size_t(PART + 1);
  static_assert(CPR % 2 == 0, "two lanes split a row's chunks");
  static_assert(sizeof(float) * size_t(NW) * GM * (HD + 2) <= RING, "the merge fits the ring");
};

// N contiguous elements of TT in shared memory, widened to f32.
template <typename TT, int N>
__device__ __forceinline__ void lds_f32(const TT* src, float (&dst)[N]) {
  constexpr int BYTES = N * int(sizeof(TT));
  alignas(16) unsigned char raw[BYTES < 16 ? 16 : BYTES];
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(raw)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(raw) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<unsigned*>(raw) = *reinterpret_cast<const unsigned*>(src);
  } else {
    static_assert(BYTES == 2, "unsupported width");
    *reinterpret_cast<unsigned short*>(raw) = *reinterpret_cast<const unsigned short*>(src);
  }
  const TT* t = reinterpret_cast<const TT*>(raw);
#pragma unroll
  for (int n = 0; n < N; ++n) dst[n] = to_float(t[n]);
}

// Where one block writes: the output rows of its heads ([G][hd]) when the
// launch has one part, else its part's (m, l) per head and acc ([G][hd]).
template <typename TT>
struct Dest {
  TT* out;
  float2* ml;  // null: one part, write `out`
  float* acc;
};

// A part that keeps no row: (NEG_INF, 0), whose acc the combine weighs 0
// unread, or, with one part, the zeros of a query that every row masks.
template <typename TT>
__device__ __forceinline__ void write_empty(const Dest<TT>& d, int G, int hd) {
  if (d.ml != nullptr) {
    for (int g = threadIdx.x; g < G; g += THREADS) d.ml[g] = make_float2(NEG_INF, 0.f);
  } else {
    for (int t = threadIdx.x; t < G * hd; t += THREADS) d.out[t] = from_float<TT>(0.f);
  }
}

// q's G heads ([G][hd] from global) into the f32 copy [GM][HD], zeros past
// hd.  Call before the block's first __syncthreads.
template <typename TT, int HD>
__device__ __forceinline__ void load_q(const TT* __restrict__ q, float* q_s, int G, int hd) {
  for (int t = threadIdx.x; t < G * HD; t += THREADS) {
    const int g = t / HD, c = t % HD;
    q_s[t] = c < hd ? to_float(q[size_t(g) * hd + c]) : 0.f;
  }
}

// Attend the rows of one part: tiles of TILE rows from `part0`, the rows of
// each tile that `rows.mask(j0)` keeps, the K/V row of position j at element
// `rows.offset(j)` of k and v.  q_s holds the block's G heads (load_q) and
// a __syncthreads has passed since.  sm is the block's Layout<TT, HD, GM>.
template <typename TT, int HD, int GM, typename Rows>
__device__ __forceinline__ void attend(const TT* __restrict__ k, const TT* __restrict__ v,
                                       const Rows& rows, int part0, const Dest<TT>& dest,
                                       int G, int hd, float scale_log2, unsigned char* sm) {
  using Ly = Layout<TT, HD, GM>;
  constexpr int EL = Ly::EL, CPR = Ly::CPR, LD = Ly::LD, EPL = Ly::EPL, STAGES = Ly::STAGES;
  const bool vec = (hd * int(sizeof(TT))) % 16 == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane & (TILE - 1), h = lane >> 4;  // this lane's row of a tile, and its half
  TT* ring = reinterpret_cast<TT*>(sm) + size_t(warp) * STAGES * Ly::STAGE;
  const float* q_s = reinterpret_cast<const float*>(sm + Ly::Q);
  float* p_s = reinterpret_cast<float*>(sm + Ly::P) + warp * GM * TILE;

  // The first row of this warp's tile i, and the rows of it the query keeps.
  auto first = [&](int i) { return part0 + (warp + NW * i) * TILE; };

  // Tile i (kept rows `mask`) into stage st: the lane copies chunks lane,
  // lane + 32, ... of the tile's TILE * CPR chunks of K and of V, so one copy
  // instruction reads whole rows; lane r finds row r (lanes r and r + 16
  // alike) and hands its place to the lanes that copy it.
  auto load = [&](int i, unsigned mask, int st) {
    const unsigned long long at =
        (mask >> r) & 1u ? (unsigned long long)rows.offset(first(i) + r) : 0ull;
    TT* ks = ring + st * Ly::STAGE;
    TT* vs = ks + TILE * LD;
#pragma unroll
    for (int n = 0; n < CPR / 2; ++n) {
      const int idx = 32 * n + lane, row = idx / CPR, c = idx % CPR;
      const bool keep = (mask >> row) & 1u;
      const size_t off = size_t(__shfl_sync(ALL, at, row));
      TT* kd = ks + row * LD + c * EL;
      TT* vd = vs + row * LD + c * EL;
      if (vec) {
        const bool read = keep && c * EL < hd;
        cp_async16(smem_u32(kd), read ? k + off + c * EL : k, read ? 16 : 0);
        cp_async16(smem_u32(vd), read ? v + off + c * EL : v, read ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          const int d = c * EL + e;
          const bool read = keep && d < hd;
          kd[e] = read ? k[off + d] : from_float<TT>(0.f);
          vd[e] = read ? v[off + d] : from_float<TT>(0.f);
        }
      }
    }
  };

  float acc[GM][EPL], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < TPW) {
      const unsigned mask = rows.mask(first(i));
      if (mask != 0u) load(i, mask, i);
    }
    cp_commit();
  }
#pragma unroll 1
  for (int i = 0; i < TPW; ++i) {
    const int next = i + STAGES - 1;
    if (next < TPW) {
      const unsigned mask = rows.mask(first(next));
      if (mask != 0u) load(next, mask, next % STAGES);
    }
    cp_commit();
    cp_wait<STAGES - 1>();
    __syncwarp();
    const unsigned mask = rows.mask(first(i));
    if (mask != 0u) {
      const TT* ks = ring + (i % STAGES) * Ly::STAGE;
      const TT* vs = ks + TILE * LD;
      // ---- scores: lane (r, h) takes the chunks h, h + 2, ... of row r
      float dot[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) dot[g] = 0.f;
#pragma unroll
      for (int n = 0; n < CPR / 2; ++n) {
        const int c = 2 * n + h;
        float kf[EL];
        lds_f32<TT, EL>(ks + r * LD + c * EL, kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          const float4* qv = reinterpret_cast<const float4*>(q_s + g * HD + c * EL);
#pragma unroll
          for (int e4 = 0; e4 < EL / 4; ++e4) {
            const float4 x = qv[e4];
            dot[g] = fmaf(x.x, kf[4 * e4], dot[g]);
            dot[g] = fmaf(x.y, kf[4 * e4 + 1], dot[g]);
            dot[g] = fmaf(x.z, kf[4 * e4 + 2], dot[g]);
            dot[g] = fmaf(x.w, kf[4 * e4 + 3], dot[g]);
          }
        }
      }
      const bool kept = (mask >> r) & 1u;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float both = dot[g] + __shfl_xor_sync(ALL, dot[g], 16);  // the row's two halves
        const float s = kept ? both * scale_log2 : -INFINITY;
        float mx = s;
#pragma unroll
        for (int o = TILE / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(ALL, mx, o));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = ex2(m[g] - m_new);
        const float p = ex2(s - m_new);
        l[g] = fmaf(l[g], alpha, p);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
        if (h == 0) p_s[g * TILE + r] = p;
      }
      __syncwarp();
      // ---- P.V: lane owns columns [lane * EPL, lane * EPL + EPL), rows in order
#pragma unroll
      for (int r4 = 0; r4 < TILE; r4 += 4) {
        float vf[4][EPL];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) lds_f32<TT, EPL>(vs + (r4 + rr) * LD + lane * EPL, vf[rr]);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          const float4 pp = *reinterpret_cast<const float4*>(p_s + g * TILE + r4);
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            acc[g][e] = fmaf(pp.x, vf[0][e], acc[g][e]);
            acc[g][e] = fmaf(pp.y, vf[1][e], acc[g][e]);
            acc[g][e] = fmaf(pp.z, vf[2][e], acc[g][e]);
            acc[g][e] = fmaf(pp.w, vf[3][e], acc[g][e]);
          }
        }
      }
    }
    __syncwarp();
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with its ring: it now holds the merge

  // ---- merge the warps' states in warp order
  float* sm_m = reinterpret_cast<float*>(sm);  // [NW][GM]
  float* sm_l = sm_m + NW * GM;                 // [NW][GM]
  float* sm_acc = sm_l + NW * GM;               // [NW][GM][HD]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    float lt = l[g];  // lanes r and r + 16 hold the same rows' sums
#pragma unroll
    for (int o = TILE / 2; o > 0; o >>= 1) lt += __shfl_xor_sync(ALL, lt, o);
    if (lane == 0) {
      sm_m[warp * GM + g] = m[g];
      sm_l[warp * GM + g] = lt;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[(warp * GM + g) * HD + lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * HD; t += THREADS) {
    const int g = t / HD, c = t % HD;
    if (c >= hd) continue;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w * GM + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float lw = sm_l[w * GM + g];
      const float wt = lw > 0.f ? ex2(sm_m[w * GM + g] - M) : 0.f;
      den = fmaf(lw, wt, den);
      num = fmaf(sm_acc[(w * GM + g) * HD + c], wt, num);
    }
    if (dest.ml == nullptr) {
      dest.out[size_t(g) * hd + c] = from_float<TT>(num / fmaxf(den, 1e-30f));
    } else {
      dest.acc[size_t(g) * hd + c] = num;
      if (c == 0) dest.ml[g] = make_float2(M, den);
    }
  }
}

// out = sum_s w_s acc_s / sum_s w_s l_s over the parts s in part order, with
// w_s = 2^(m_s - max_s m_s) for a part with l_s > 0 and 0 for an empty one,
// whose (never written) acc is read but replaced by 0: an empty part adds
// exact zeros.  One warp per (sequence, head) row and 32 of its columns, a
// lane per column: lane s reads part s's (m, l) and the weights reach the
// other lanes by shuffles, so the parts' loads are independent and in
// flight together.  A row whose every part is empty outputs zeros.  With
// one part the sums are the part's own (m, l, acc), so the output is what
// the block would have written.
template <typename TT>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float2* __restrict__ part_ml, const float* __restrict__ part_acc,
                      TT* __restrict__ out, int rows, int parts, int hd) {
  const int chunks = (hd + 31) / 32, lane = threadIdx.x & 31;
  const size_t wid = size_t(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (wid >= size_t(rows) * chunks) return;
  const int row = int(wid / chunks), d = int(wid % chunks) * 32 + lane;
  float mx = NEG_INF;
  for (int s = lane; s < parts; s += 32) mx = fmaxf(mx, part_ml[size_t(s) * rows + row].x);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(ALL, mx, o));
  float x = 0.f, den = 0.f;
  for (int s0 = 0; s0 < parts; s0 += 32) {
    const float2 ml = s0 + lane < parts ? part_ml[size_t(s0 + lane) * rows + row]
                                        : make_float2(NEG_INF, 0.f);
    const float w_lane = ml.y > 0.f ? ex2(ml.x - mx) : 0.f;
    const int n = min(32, parts - s0);
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float w = __shfl_sync(ALL, w_lane, i), l = __shfl_sync(ALL, ml.y, i);
      const float a = d < hd ? part_acc[(size_t(s0 + i) * rows + row) * hd + d] : 0.f;
      den = fmaf(l, w, den);
      x = fmaf(l > 0.f ? a : 0.f, w, x);
    }
  }
  if (d < hd) out[size_t(row) * hd + d] = from_float<TT>(x / fmaxf(den, 1e-30f));
}

// Launch the combine of `parts` > 1 partials over rows = B * H output rows.
template <typename TT>
int launch_combine(const float2* part_ml, const float* part_acc, void* out, int rows,
                   int parts, int hd, cudaStream_t stream) {
  const long long warps = (long long)rows * ((hd + 31) / 32);
  decode_combine_kernel<TT><<<unsigned((warps + 3) / 4), 128, 0, stream>>>(
      part_ml, part_acc, static_cast<TT*>(out), rows, parts, hd);
  return int(cudaGetLastError());
}

// Call `l.run<TT, HD, GM>()` for the element type of `dtype`, the head_dim
// bucket HD that holds hd, and the smallest GM of 1, 2, 4, 8 that holds a
// block's tile_heads(G); cudaErrorInvalidValue for anything else (a dtype
// other than f32/bf16, a head_dim outside [1, 256], or G < 1).
template <typename L, typename TT, int HD>
int dispatch_g(const L& l, int G) {
  if (G < 1) return int(cudaErrorInvalidValue);
  const int Gt = tile_heads(G);
  if (Gt <= 1) return l.template run<TT, HD, 1>();
  if (Gt <= 2) return l.template run<TT, HD, 2>();
  if (Gt <= 4) return l.template run<TT, HD, 4>();
  return l.template run<TT, HD, GT>();
}

template <typename L, typename TT>
int dispatch_hd(const L& l, int hd, int G) {
  if (hd < 1 || hd > 256) return int(cudaErrorInvalidValue);
  if (hd <= 32) return dispatch_g<L, TT, 32>(l, G);
  if (hd <= 64) return dispatch_g<L, TT, 64>(l, G);
  if (hd <= 128) return dispatch_g<L, TT, 128>(l, G);
  return dispatch_g<L, TT, 256>(l, G);
}

template <typename L>
int dispatch(const L& l, int dtype, int hd, int G) {
  if (dtype == DTYPE_F32) return dispatch_hd<L, float>(l, hd, G);
  if (dtype == DTYPE_BF16) return dispatch_hd<L, __nv_bfloat16>(l, hd, G);
  return int(cudaErrorInvalidValue);
}

// The checks both launchers share: a grid the card takes, the part count the
// wrapper sized its scratch for, and scratch when there is more than one part.
inline bool launch_ok(int B, int H, int KV, long long rows, int parts, const void* part_acc,
                      const void* part_ml) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || B > 65535 || rows <= 0) return false;
  if (parts != part_count(rows) || parts > 65535) return false;
  return parts == 1 || (part_acc != nullptr && part_ml != nullptr);
}

}  // namespace
}  // namespace decode
}  // namespace repro_torch
