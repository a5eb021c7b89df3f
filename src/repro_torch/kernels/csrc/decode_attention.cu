// Dense-cache decode attention for Hopper (sm_90a): one query token per
// sequence against the slotted cache.
//
// Replaces the Pallas kernel `decode_attention` of the JAX package
// (src/repro/kernels/decode_attention.py).  A cache row is kept for the query
// at position p iff kv_pos >= 0, kv_pos <= p, (with a window) kv_pos >
// p - window, and (when given) kv_valid; a query that every row masks
// outputs zeros.
//
// What bounds it on the H100: bytes.  Each kept cache row is read once and
// feeds only 4 * G * hd FLOPs, far below the card's operations-per-byte
// balance, so the time is the KV bytes over the memory rate.
//
// What this design does about it: one block per (sequence, kv head), so the
// G = H / KV query heads of a kv head share every K and V row read from
// memory.  The block reads the int32 positions first and loads only the
// rows the mask keeps, so a slot that has filled 2,000 of 4,096 cache rows
// streams 2,000 rows.  Each warp takes R rows at a time with 16-byte loads
// (a lane holds hd/32 contiguous elements), keeping several rows in flight;
// the warps' partial (m, l, acc) are merged through shared memory at the
// end.  Splitting the cache of one sequence over several blocks (split-K)
// is later work.
//
// Layouts (all contiguous): q, out [B, 1, H, hd]; k, v [B, L, KV, hd];
// q_pos [B, 1] int32; kv_pos [B, L] int32; kv_valid [B, L] bool or null.
// Grid (KV, B), 256 threads.

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int R = 4;  // cache rows a warp keeps in flight

template <typename T, int EPL, int GM>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
              const unsigned char* __restrict__ kv_valid, T* __restrict__ out, int L, int H,
              int KV, int has_window, int window, float scale) {
  constexpr int HD = 32 * EPL;
  extern __shared__ float sm[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float qr[GM][EPL], acc[GM][EPL], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = qr[g][e] = 0.f;
    if (g < G) load_f32<T, EPL>(q + (size_t(b) * H + kvh * G + g) * HD + lane * EPL, qr[g]);
  }

  const int qp = q_pos[b];
  const size_t stride = size_t(KV) * HD;
  const T* kb = k + size_t(b) * L * stride + size_t(kvh) * HD + lane * EPL;
  const T* vb = v + size_t(b) * L * stride + size_t(kvh) * HD + lane * EPL;
  const int* kpb = kv_pos + size_t(b) * L;
  const unsigned char* vab = kv_valid ? kv_valid + size_t(b) * L : nullptr;

  for (int j0 = warp * R; j0 < L; j0 += NW * R) {
    bool keep[R];
    bool any = false;
    float kr[R][EPL], vr[R][EPL];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = j0 + i;
      bool kk = false;
      if (j < L) {
        const int kp = kpb[j];
        kk = kp >= 0 && kp <= qp;
        kk = kk && (!has_window || (long long)kp > (long long)qp - window);
        kk = kk && (vab == nullptr || vab[j] != 0);
      }
      keep[i] = kk;  // the same on every lane: the branches below are uniform
      any = any || kk;
      if (kk) {
        load_f32<T, EPL>(kb + size_t(j) * stride, kr[i]);
        load_f32<T, EPL>(vb + size_t(j) * stride, vr[i]);
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
    out[(size_t(b) * H + kvh * G + g) * HD + c] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int EPL, int GM>
int launch(const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
           const unsigned char* kv_valid, void* out, int B, int L, int H, int KV,
           int has_window, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * size_t(NW) * (H / KV) * (2 + 32 * EPL);
  auto kernel = decode_kernel<T, EPL, GM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  dim3 grid(KV, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      kv_pos, kv_valid, static_cast<T*>(out), L, H, KV, has_window, window, scale);
  return int(cudaGetLastError());
}

template <typename T, int EPL>
int dispatch_g(const void* q, const void* k, const void* v, const int* q_pos,
               const int* kv_pos, const unsigned char* kv_valid, void* out, int B, int L,
               int H, int KV, int has_window, int window, float scale, cudaStream_t s) {
  const int G = H / KV;
  if (G <= 1)
    return launch<T, EPL, 1>(q, k, v, q_pos, kv_pos, kv_valid, out, B, L, H, KV, has_window,
                             window, scale, s);
  if (G <= 2)
    return launch<T, EPL, 2>(q, k, v, q_pos, kv_pos, kv_valid, out, B, L, H, KV, has_window,
                             window, scale, s);
  if (G <= 4)
    return launch<T, EPL, 4>(q, k, v, q_pos, kv_pos, kv_valid, out, B, L, H, KV, has_window,
                             window, scale, s);
  if (G <= 8)
    return launch<T, EPL, 8>(q, k, v, q_pos, kv_pos, kv_valid, out, B, L, H, KV, has_window,
                             window, scale, s);
  return int(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const int* q_pos,
                const int* kv_pos, const unsigned char* kv_valid, void* out, int B, int L,
                int H, int KV, int has_window, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return dispatch_g<T, 1>(q, k, v, q_pos, kv_pos, kv_valid, out, B, L, H, KV, has_window,
                              window, scale, s);
    case 64:
      return dispatch_g<T, 2>(q, k, v, q_pos, kv_pos, kv_valid, out, B, L, H, KV, has_window,
                              window, scale, s);
    case 128:
      return dispatch_g<T, 4>(q, k, v, q_pos, kv_pos, kv_valid, out, B, L, H, KV, has_window,
                              window, scale, s);
    case 256:
      return dispatch_g<T, 8>(q, k, v, q_pos, kv_pos, kv_valid, out, B, L, H, KV, has_window,
                              window, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launch: 0 on success, cudaErrorInvalidValue for an unsupported head_dim,
// dtype or head grouping (G = H / KV must be at most 8).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* q_pos, const int* kv_pos,
                                       const unsigned char* kv_valid, void* out, int B, int L,
                                       int H, int KV, int hd, int dtype, int has_window,
                                       int window, float scale, void* stream) {
  using namespace repro_torch;
  if (KV <= 0 || H % KV != 0 || L <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return dispatch_hd<float>(hd, q, k, v, q_pos, kv_pos, kv_valid, out, B, L, H, KV,
                              has_window, window, scale, s);
  if (dtype == DTYPE_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, q_pos, kv_pos, kv_valid, out, B, L, H, KV,
                                      has_window, window, scale, s);
  return int(cudaErrorInvalidValue);
}
