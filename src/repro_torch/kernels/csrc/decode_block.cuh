// The body shared by the decode kernels `decode_attention`
// (decode_attention.cu, dense slotted cache) and `paged_decode_attention`
// (paged_decode.cu, shared block pool): one query token per sequence, one
// block per (sequence, kv head, tile of up to GT of its query heads).
//
// What bounds both on the H100: bytes.  Each kept cache row is read once and
// feeds only 4 * G * hd FLOPs, far below the card's operations-per-byte
// balance, so the time is the KV bytes over the memory rate.
//
// What the design does about it: the G = H / KV query heads of a kv head
// share every K and V row read from memory, and only rows the mask keeps are
// loaded.  Each warp takes R rows at a time with vector loads (a lane holds
// hd/32 contiguous elements), keeping several rows in flight; the warps'
// partial (m, l, acc) are merged through shared memory at the end.  A
// `Rows` source says where row j lives and whether the query keeps it; the
// two kernels differ only in that source, so over the same rows they do the
// same arithmetic in the same order.  A block holds at most GT = 8 query
// heads in registers; a kv head with more (granite-34b's 48 on one kv head)
// is split over blockIdx.z into tiles of GT heads, each re-reading the kv
// head's rows.  For G <= GT there is one tile, and the arithmetic is that of
// one block per kv head.  Splitting one sequence's cache over several blocks
// (split-K) is later work.
//
// Any head_dim hd in [1, 256] runs, on the instantiation of the smallest
// bucket HD = 32 * EPL in {32, 64, 128, 256} that holds it: rows are hd
// elements apart, a lane's elements past hd read as zeros (adding nothing to
// q.k or p.v) and are not stored.  At hd == HD the kernels run their FULL
// instantiation, whose hd is the constant HD: each lane loads its EPL
// elements as vectors, the code of a kernel built for hd alone.  At any
// other hd a lane loads its elements one by one, since a row's start need
// not be vector-aligned.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace decode {
namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int R = 4;  // cache rows a warp keeps in flight
constexpr int GT = 8;  // query heads a block takes (a tile of one kv head's G)

// The blocks of one kv head (grid axis z) and the heads one block holds.
inline int g_tiles(int G) { return (G + GT - 1) / GT; }
inline int tile_heads(int G) { return G < GT ? G : GT; }

// Lane `lane`'s EPL elements of one hd-element row, widened to f32: vector
// loads at hd == 32 * EPL, element loads (zeros past hd) otherwise.
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int lane, int hd,
                                         float (&dst)[EPL]) {
  if (hd == 32 * EPL) {
    load_f32<T, EPL>(row + lane * EPL, dst);
    return;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane * EPL + e;
    dst[e] = d < hd ? to_float(row[d]) : 0.f;
  }
}

inline size_t smem_bytes(int G, int epl) {
  return sizeof(float) * size_t(NW) * tile_heads(G) * (2 + 32 * epl);
}

// The first of this block's query heads within its kv head, and their count.
__device__ __forceinline__ int tile_first() { return int(blockIdx.z) * GT; }
__device__ __forceinline__ int tile_count(int G) { return min(GT, G - int(blockIdx.z) * GT); }

// Attend the rows j in [begin, end) that `rows.keep(j)` keeps; the K/V row of
// j starts at element `rows.offset(j)` of k and v (kv head included).  Warp w
// takes the chunks starting at begin + w*R + i*NW*R, so `begin` must be a
// multiple of NW*R for two sources to split the same rows alike.  q and out
// point at the block's G heads ([G, hd] contiguous); sm holds
// smem_bytes(G, EPL) bytes.
template <typename T, int EPL, int GM, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, T* __restrict__ out,
                                       const Rows& rows, int begin, int end, int G, int hd,
                                       float scale, float* sm) {
  constexpr int HD = 32 * EPL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float qr[GM][EPL], acc[GM][EPL], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = qr[g][e] = 0.f;
    if (g < G) load_row<T, EPL>(q + size_t(g) * hd, lane, hd, qr[g]);
  }

  for (int j0 = begin + warp * R; j0 < end; j0 += NW * R) {
    bool keep[R];
    bool any = false;
    float kr[R][EPL], vr[R][EPL];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = j0 + i;
      const bool kk = j < end && rows.keep(j);
      keep[i] = kk;  // the same on every lane: the branches below are uniform
      any = any || kk;
      if (kk) {
        const size_t off = rows.offset(j);
        load_row<T, EPL>(k + off, lane, hd, kr[i]);
        load_row<T, EPL>(v + off, lane, hd, vr[i]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[i][e] = vr[i][e] = 0.f;
      }
    }
    if (!any) continue;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float s[R];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s[i] = -INFINITY;
        if (keep[i]) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kr[i][e], part);
          s[i] = warp_sum(part) * scale;
        }
        mx = fmaxf(mx, s[i]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!keep[i]) continue;
        const float p = expf(s[i] - m_new);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[i][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }

  // ---- merge the warps' partial softmax states
  float* sm_m = sm;              // [NW][G]
  float* sm_l = sm_m + NW * G;   // [NW][G]
  float* sm_acc = sm_l + NW * G; // [NW][G][HD]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[(warp * G + g) * HD + lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * HD; t += THREADS) {
    const int g = t / HD, c = t % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w * G + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float sc = expf(sm_m[w * G + g] - M);
      den = fmaf(sm_l[w * G + g], sc, den);
      num = fmaf(sm_acc[(w * G + g) * HD + c], sc, num);
    }
    if (c < hd) out[size_t(g) * hd + c] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

// Call `l.run<T, EPL, GM>()` for the element type of `dtype`, EPL = HD / 32
// for the head_dim bucket HD that holds hd, and the smallest GM of 1, 2, 4, 8
// that holds a block's tile_heads(G); cudaErrorInvalidValue for anything else
// (a dtype other than f32/bf16, a head_dim outside [1, 256], or G < 1).
template <typename L, typename T, int EPL>
int dispatch_g(const L& l, int G) {
  if (G < 1) return int(cudaErrorInvalidValue);
  const int Gt = tile_heads(G);
  if (Gt <= 1) return l.template run<T, EPL, 1>();
  if (Gt <= 2) return l.template run<T, EPL, 2>();
  if (Gt <= 4) return l.template run<T, EPL, 4>();
  return l.template run<T, EPL, GT>();
}

template <typename L, typename T>
int dispatch_hd(const L& l, int hd, int G) {
  if (hd < 1 || hd > 256) return int(cudaErrorInvalidValue);
  if (hd <= 32) return dispatch_g<L, T, 1>(l, G);
  if (hd <= 64) return dispatch_g<L, T, 2>(l, G);
  if (hd <= 128) return dispatch_g<L, T, 4>(l, G);
  return dispatch_g<L, T, 8>(l, G);
}

template <typename L>
int dispatch(const L& l, int dtype, int hd, int G) {
  if (dtype == DTYPE_F32) return dispatch_hd<L, float>(l, hd, G);
  if (dtype == DTYPE_BF16) return dispatch_hd<L, __nv_bfloat16>(l, hd, G);
  return int(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace decode
}  // namespace repro_torch
