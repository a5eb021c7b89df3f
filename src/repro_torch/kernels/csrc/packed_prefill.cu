// Packed ragged suffix-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `packed_flash_attention` of the JAX package
// (src/repro/kernels/packed_prefill.py): GQA flash attention over several
// requests' token runs packed into one sequence.  A key row is kept for a
// query iff kv_pos >= 0, q_seg == kv_seg, kv_pos <= q_pos (causal, at
// segment-local positions) and, with a window, kv_pos > q_pos - window.
// Queries that every key masks output zeros.
//
// What bounds it on the H100: operations.  At the serving path's shapes
// (thousands of packed queries, 32 heads, hd 128) the QK^T and PV products
// over the tiles the mask leaves take longer at the card's peak rate than
// reading q, k, v once and writing the output at its memory rate.
//
// What this design does about it: it skips every kv tile that cannot meet
// the query tile — no valid row, disjoint segment-id ranges, or (causal) a
// smallest kv position above the tile's largest query position — so the
// work follows the causal, segment-diagonal blocks instead of the full
// Sq x Skv rectangle.  Inside a tile, the products run on the CUDA cores in
// f32 from f32 copies in shared memory (register-tiled 4x2 for QK^T and
// 4x(hd/16) for PV) with an online softmax (m, l, acc) in f32.  Tensor-core
// (wgmma) tiles, TMA loads and warp specialisation are later work.
//
// Layouts (all contiguous): q, out [B, Sq, H, hd]; k, v [B, Skv, KV, hd];
// q_pos, q_seg [B, Sq] int32; kv_pos, kv_seg [B, Skv] int32.
// Grid (ceil(Sq / BQ), H, B), 256 threads.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 32;   // kv rows per tile (one per lane of warp 0)
constexpr int SP = BKV + 1;  // padded row stride of the score tile
constexpr int THREADS = 256;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * HD + size_t(BKV) * (HD + 1) + size_t(BKV) * HD +
                          size_t(BQ) * SP + 3 * BQ) +
         sizeof(int) * (2 * BQ + 2 * BKV);
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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
packed_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, T* __restrict__ out, int Sq, int Skv,
                    int H, int KV, int causal, int has_window, int window, float scale) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
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
  __shared__ int q_info[4];           // seg_lo, seg_hi, pos_lo, pos_hi
  __shared__ int tile_skip;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    Qs[i] = qi < Sq ? to_float(q[((size_t(b) * Sq + qi) * H + h) * HD + d]) : 0.f;
  }
  if (tid < BQ) {
    const int qi = q0 + tid;
    // rows past Sq are never written; INT_MIN keeps them out of every segment
    qp_s[tid] = qi < Sq ? q_pos[size_t(b) * Sq + qi] : INT_MIN;
    qs_s[tid] = qi < Sq ? q_seg[size_t(b) * Sq + qi] : INT_MIN;
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    int slo = INT_MAX, shi = INT_MIN, plo = INT_MAX, phi = INT_MIN;
    for (int r = tid; r < BQ; r += 32) {
      if (q0 + r < Sq) {
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

  const int rg = tid >> 4;  // rows rg*4 .. rg*4+3 of the QK^T and PV tiles
  const int cg = tid & 15;
  float acc[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < CT; ++t) acc[i][t] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    // ---- tile metadata and the skip test (warp 0, one kv row per lane)
    if (tid < 32) {
      const int j = kv0 + tid;
      int kp = -1, ks = 0;
      if (j < Skv) {
        kp = kv_pos[size_t(b) * Skv + j];
        ks = kv_seg[size_t(b) * Skv + j];
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
      if (j < Skv) {
        const size_t off = ((size_t(b) * Skv + j) * KV + kvh) * HD + d;
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
          bool keep = kp >= 0 && qs == ks_s[j];
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
    const float l = fmaxf(l_s[r], 1e-30f);
    T* o = out + ((size_t(b) * Sq + qi) * H + h) * HD + cg;
#pragma unroll
    for (int t = 0; t < CT; ++t) o[16 * t] = from_float<T>(acc[i][t] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
           const int* q_seg, const int* kv_seg, void* out, int B, int Sq, int Skv, int H,
           int KV, int causal, int has_window, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  auto kernel = packed_flash_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      kv_pos, q_seg, kv_seg, static_cast<T*>(out), Sq, Skv, H, KV, causal, has_window, window,
      scale);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const int* q_pos,
                const int* kv_pos, const int* q_seg, const int* kv_seg, void* out, int B,
                int Sq, int Skv, int H, int KV, int causal, int has_window, int window,
                float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, q_pos, kv_pos, q_seg, kv_seg, out, B, Sq, Skv, H, KV,
                           causal, has_window, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, q_pos, kv_pos, q_seg, kv_seg, out, B, Sq, Skv, H, KV,
                           causal, has_window, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, q_pos, kv_pos, q_seg, kv_seg, out, B, Sq, Skv, H, KV,
                            causal, has_window, window, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, q_pos, kv_pos, q_seg, kv_seg, out, B, Sq, Skv, H, KV,
                            causal, has_window, window, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping.
extern "C" int packed_flash_attention_launch(
    const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
    const int* q_seg, const int* kv_seg, void* out, int B, int Sq, int Skv, int H, int KV,
    int hd, int dtype, int causal, int has_window, int window, float scale, void* stream) {
  using namespace repro_torch;
  if (KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return dispatch_hd<float>(hd, q, k, v, q_pos, kv_pos, q_seg, kv_seg, out, B, Sq, Skv, H,
                              KV, causal, has_window, window, scale, s);
  if (dtype == DTYPE_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, q_pos, kv_pos, q_seg, kv_seg, out, B, Sq,
                                      Skv, H, KV, causal, has_window, window, scale, s);
  return int(cudaErrorInvalidValue);
}
