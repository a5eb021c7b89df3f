// The backward of the position-masked GQA flash attention of
// flash_prefill.cu, for Hopper (sm_90a): dQ, dK and dV of one training
// launch.
//
// Replaces no Pallas kernel.  The JAX package differentiates through its
// flash_attention call (src/repro/kernels/flash_prefill.py:91) and has no
// backward kernel of its own.  The port's forward kernel has no gradient,
// so the training forward (kernels/ops.py's FlashAttentionFn) needs this
// one: a CUDA tensor never falls back to the plain backward.
//
// What it computes, for the forward's mask (a key row j of position kp is
// kept for a query i iff kp >= 0, kv_valid[j] where given, kp <= q_pos[i]
// when causal and kp > q_pos[i] - window with a window), with S = Q K^T,
// lse the forward's log-sum-exp of the scaled scores and scale = hd^-0.5:
//
//   P  = exp(S * scale - lse) on kept pairs, 0 elsewhere
//   D  = rowsum(dO * O)
//   dS = P * (dO V^T - D) * scale
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO
//
// GQA: dK and dV of kv head h / G sum over its G query heads.
//
// Three kernels, no atomics, so the same inputs give the same bits on every
// launch: the pre-pass writes D (one warp a row, f32); the dK/dV kernel
// owns (b, kv head, a tile of R kv rows) and loops over the query tiles and
// the group's heads, accumulating its rows of dK and dV in registers; the
// dQ kernel owns (b, head, a tile of R query rows) and loops over the kv
// tiles, accumulating its rows of dQ.  Each sum runs in a fixed order in
// one thread.
//
// What bounds it on the H100: operations.  At qwen2-0.5b's training shape
// (B 4, S 2048, H 14, KV 2, hd 64, causal) the five products over the
// causal half are about 7.5e10 operations a layer (0.076 ms at 989 TFLOP/s)
// against about 67 MB of traffic (0.02 ms).  This first design runs every
// product on the CUDA cores in f32 (bf16 operands widened as they land in
// shared memory), register-tiled from padded shared tiles, for both dtypes:
// one code path, and gradients that agree with the f32 plain version to
// f32 rounding.  It recomputes S and dP in both kernels (seven products in
// all).  What it does about its bound: it skips every (query tile, kv tile)
// pair that the mask leaves empty (the causal upper triangle, rows wholly
// outside the window, tiles without a valid kv row), so the work follows
// the kept pairs.  The tensor cores (mma.sync, wgmma) are later work.
//
// Any head_dim hd in [1, 256] runs on the instantiation of the smallest
// bucket HD in {32, 64, 128, 256} that holds it (tiles of R = 64 rows, 32 at
// HD 256), with zeros in the shared columns past hd; at hd == HD the FULL
// instantiation runs with hd the constant HD.
//
// Layouts (all contiguous): q, out, dout, dq [B, Sq, H, hd]; k, v, dk, dv
// [B, Skv, KV, hd] (bf16 or f32, all one dtype); q_pos [B, Sq] int32;
// kv_pos [B, Skv] int32; kv_valid [B, Skv] bool or null; lse [B, Sq, H]
// f32; D [B, Sq, H] f32 scratch from the wrapper.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace flash_bwd {
namespace {

constexpr int THREADS = 256;  // 16 row groups x 16 column groups

template <int HD>
struct Tile {
  static constexpr int R = HD == 256 ? 32 : 64;  // query rows and kv rows of a tile
  static constexpr int LD = HD + 1;              // padded f32 row stride
  static constexpr int PL = R + 1;               // padded stride of the R x R tiles
  static constexpr int RPT = R / 16;             // rows a thread owns in a product
  static constexpr int SC = R / 16;              // score columns a thread owns
  static constexpr int CT = HD / 16;             // head-dim columns a thread owns
};

template <int HD>
constexpr size_t smem_bytes() {
  using T = Tile<HD>;
  // Q, dO, K, V tiles; P and dS tiles; lse and D; query and kv positions
  return sizeof(float) * (4 * size_t(T::R) * T::LD + 2 * size_t(T::R) * T::PL + 2 * T::R) +
         sizeof(int) * 2 * T::R;
}

struct Args {
  const void *q, *k, *v, *out, *dout;
  const int *q_pos, *kv_pos;
  const unsigned char* kv_valid;
  const float* lse;
  float* D;
  void *dq, *dk, *dv;
  int B, Sq, Skv, H, KV, hd, causal, has_window, window;
  float scale;
};

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

// D = rowsum(dO * O) in f32: one warp a (b, query, head) row
template <typename T>
__global__ void __launch_bounds__(256) dot_kernel(const Args a) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(a.out) + row * a.hd;
  const T* g = static_cast<const T*>(a.dout) + row * a.hd;
  float s = 0.f;
  for (int d = lane; d < a.hd; d += 32) s = fmaf(to_float(g[d]), to_float(o[d]), s);
  s = warp_sum(s);
  if (lane == 0) a.D[row] = s;
}

// R rows of a [rows, heads, hd] tensor (row stride heads * hd, head `h`),
// from row r0, as f32 into shared `dst` [R][LD]; rows past n and columns
// past hd are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int n, int heads,
                                          int h, int hd) {
  using Tl = Tile<HD>;
  for (int i = threadIdx.x; i < Tl::R * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (r < n && d < hd) x = to_float(src[((size_t(r0) + r) * heads + h) * hd + d]);
    dst[r * Tl::LD + d] = x;
  }
}

// Whether query position qp keeps key position kp (kp < 0: an invalid row)
__device__ __forceinline__ bool kept(int kp, int qp, const Args& a) {
  return kp >= 0 && (!a.causal || kp <= qp) &&
         (!a.has_window || (long long)kp > (long long)qp - a.window);
}

// P and dS of a query tile (rows i: Qs, Os) against a kv tile (columns j:
// Ks, Vs) into shared Ps and Ss [R][PL]; query rows at or past nq keep
// nothing.  A thread owns rows rg * RPT + r and columns cg + 16 c.
template <int HD, bool WRITE_P>
__device__ __forceinline__ void probs(const float* Qs, const float* Os, const float* Ks,
                                      const float* Vs, const int* qp_s, const int* kp_s,
                                      const float* lse_s, const float* D_s, int nq, float* Ps,
                                      float* Ss, const Args& a) {
  using Tl = Tile<HD>;
  constexpr int LD = Tl::LD, PL = Tl::PL, RPT = Tl::RPT, SC = Tl::SC;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float s[RPT][SC], dp[RPT][SC];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < SC; ++c) s[r][c] = dp[r][c] = 0.f;
  const float* qr = Qs + rg * RPT * LD;
  const float* orow = Os + rg * RPT * LD;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float kk[SC], vv[SC];
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      kk[c] = Ks[(cg + 16 * c) * LD + d];
      vv[c] = Vs[(cg + 16 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float qv = qr[r * LD + d], ov = orow[r * LD + d];
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        s[r][c] = fmaf(qv, kk[c], s[r][c]);
        dp[r][c] = fmaf(ov, vv[c], dp[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = rg * RPT + r;
    const int qp = qp_s[i];
    const float l = lse_s[i], dd = D_s[i];
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int j = cg + 16 * c;
      const float p = i < nq && kept(kp_s[j], qp, a) ? expf(fmaf(s[r][c], a.scale, -l)) : 0.f;
      if (WRITE_P) Ps[i * PL + j] = p;
      Ss[i * PL + j] = p * (dp[r][c] - dd) * a.scale;
    }
  }
}

// The kv tile's valid positions (kv_pos >= 0 and kv_valid) into kp_s (-1
// for an invalid row or one past Skv); info[0], info[1] = their min and max
// (INT_MAX, INT_MIN when none).  Ends with a barrier.
__device__ __forceinline__ void kv_positions(int* kp_s, int j0, int b, int R, int* info,
                                             const Args& a) {
  if (threadIdx.x < R) {
    const int j = j0 + threadIdx.x;
    int kp = -1;
    if (j < a.Skv) {
      const size_t at = size_t(b) * a.Skv + j;
      kp = a.kv_pos[at];
      if (kp < 0 || (a.kv_valid != nullptr && a.kv_valid[at] == 0)) kp = -1;
    }
    kp_s[threadIdx.x] = kp;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = threadIdx.x; r < R; r += 32)
      if (kp_s[r] >= 0) {
        lo = min(lo, kp_s[r]);
        hi = max(hi, kp_s[r]);
      }
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (threadIdx.x == 0) {
      info[0] = lo;
      info[1] = hi;
    }
  }
  __syncthreads();
}

// The query tile's positions into qp_s (rows past Sq: 0, never kept);
// info[2], info[3] = the min and max of its nq rows.  Ends with a barrier.
__device__ __forceinline__ void q_positions(int* qp_s, int i0, int nq, int b, int R, int* info,
                                            const Args& a) {
  if (threadIdx.x < R)
    qp_s[threadIdx.x] = threadIdx.x < nq ? a.q_pos[size_t(b) * a.Sq + i0 + threadIdx.x] : 0;
  __syncthreads();
  if (threadIdx.x < 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = threadIdx.x; r < nq; r += 32) {
      lo = min(lo, qp_s[r]);
      hi = max(hi, qp_s[r]);
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (threadIdx.x == 0) {
      info[2] = lo;
      info[3] = hi;
    }
  }
  __syncthreads();
}

// Whether a query tile with positions [qlo, qhi] and a kv tile with valid
// positions [klo, khi] (klo == INT_MAX: none) keep any pair
__device__ __forceinline__ bool tiles_meet(int qlo, int qhi, int klo, int khi, const Args& a) {
  return klo != INT_MAX && (!a.causal || klo <= qhi) &&
         (!a.has_window || (long long)khi > (long long)qlo - a.window);
}

// dK and dV of R kv rows of one kv head: grid (kv tiles, KV, B)
template <typename T, int HD, bool FULL>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(const Args a) {
  using Tl = Tile<HD>;
  constexpr int R = Tl::R, LD = Tl::LD, PL = Tl::PL, RPT = Tl::RPT, CT = Tl::CT;
  const int hd = FULL ? HD : a.hd;
  extern __shared__ float smem[];
  float* Ks = smem;              // [R][LD]
  float* Vs = Ks + R * LD;       // [R][LD]
  float* Qs = Vs + R * LD;       // [R][LD] the query tile of one head
  float* Os = Qs + R * LD;       // [R][LD] its dO
  float* Ps = Os + R * LD;       // [R][PL] P (query i, kv j)
  float* Ss = Ps + R * PL;       // [R][PL] dS
  float* lse_s = Ss + R * PL;    // [R]
  float* D_s = lse_s + R;        // [R]
  int* qp_s = reinterpret_cast<int*>(D_s + R);  // [R]
  int* kp_s = qp_s + R;          // [R] (-1: invalid)
  __shared__ int info[4];

  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int j0 = blockIdx.x * R, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int nk = min(R, a.Skv - j0);
  const T* q = static_cast<const T*>(a.q) + size_t(b) * a.Sq * a.H * hd;
  const T* go = static_cast<const T*>(a.dout) + size_t(b) * a.Sq * a.H * hd;

  kv_positions(kp_s, j0, b, R, info, a);
  const int klo = info[0], khi = info[1];
  load_rows<T, HD>(Ks, static_cast<const T*>(a.k) + size_t(b) * a.Skv * a.KV * hd, j0, nk,
                   a.KV, kvh, hd);
  load_rows<T, HD>(Vs, static_cast<const T*>(a.v) + size_t(b) * a.Skv * a.KV * hd, j0, nk,
                   a.KV, kvh, hd);

  float dk[RPT][CT], dv[RPT][CT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int t = 0; t < CT; ++t) dk[r][t] = dv[r][t] = 0.f;

  if (klo != INT_MAX) {
    for (int i0 = 0; i0 < a.Sq; i0 += R) {
      const int nq = min(R, a.Sq - i0);
      __syncthreads();  // the last head's readers of qp_s and the tiles are done
      q_positions(qp_s, i0, nq, b, R, info, a);
      if (!tiles_meet(info[2], info[3], klo, khi, a)) continue;
      for (int h = kvh * G; h < (kvh + 1) * G; ++h) {
        load_rows<T, HD>(Qs, q, i0, nq, a.H, h, hd);
        load_rows<T, HD>(Os, go, i0, nq, a.H, h, hd);
        if (threadIdx.x < R) {
          const int r = threadIdx.x;
          const size_t at = (size_t(b) * a.Sq + i0 + r) * a.H + h;
          lse_s[r] = r < nq ? a.lse[at] : 0.f;
          D_s[r] = r < nq ? a.D[at] : 0.f;
        }
        __syncthreads();
        probs<HD, true>(Qs, Os, Ks, Vs, qp_s, kp_s, lse_s, D_s, nq, Ps, Ss, a);
        __syncthreads();
        // dV += P^T dO and dK += dS^T Q: rows rg * RPT + r (kv), columns cg + 16 t
        for (int i = 0; i < R; ++i) {
          float p[RPT], ds[RPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            p[r] = Ps[i * PL + rg * RPT + r];
            ds[r] = Ss[i * PL + rg * RPT + r];
          }
#pragma unroll
          for (int t = 0; t < CT; ++t) {
            const float o = Os[i * LD + cg + 16 * t], qv = Qs[i * LD + cg + 16 * t];
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              dv[r][t] = fmaf(p[r], o, dv[r][t]);
              dk[r][t] = fmaf(ds[r], qv, dk[r][t]);
            }
          }
        }
        __syncthreads();  // before the next head's loads overwrite the tiles
      }
    }
  }

  // every row of the tile is written: zeros where no query keeps it
  T* gk = static_cast<T*>(a.dk);
  T* gv = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int j = j0 + rg * RPT + r;
    if (j >= a.Skv) continue;
    const size_t row = (size_t(b) * a.Skv + j) * a.KV + kvh;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int d = cg + 16 * t;
      if (FULL || d < hd) {
        gk[row * hd + d] = from_float<T>(dk[r][t]);
        gv[row * hd + d] = from_float<T>(dv[r][t]);
      }
    }
  }
}

// dQ of R query rows of one head: grid (query tiles, H, B)
template <typename T, int HD, bool FULL>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Args a) {
  using Tl = Tile<HD>;
  constexpr int R = Tl::R, LD = Tl::LD, PL = Tl::PL, RPT = Tl::RPT, CT = Tl::CT;
  const int hd = FULL ? HD : a.hd;
  extern __shared__ float smem[];
  float* Ks = smem;              // [R][LD]
  float* Vs = Ks + R * LD;       // [R][LD]
  float* Qs = Vs + R * LD;       // [R][LD]
  float* Os = Qs + R * LD;       // [R][LD] dO
  float* Ss = Os + R * LD;       // [R][PL] dS (query i, kv j)
  float* lse_s = Ss + 2 * R * PL;  // [R] (the layout of dkdv_kernel's)
  float* D_s = lse_s + R;        // [R]
  int* qp_s = reinterpret_cast<int*>(D_s + R);  // [R]
  int* kp_s = qp_s + R;          // [R] (-1: invalid)
  __shared__ int info[4];

  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int i0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int nq = min(R, a.Sq - i0);
  const T* k = static_cast<const T*>(a.k) + size_t(b) * a.Skv * a.KV * hd;
  const T* v = static_cast<const T*>(a.v) + size_t(b) * a.Skv * a.KV * hd;

  load_rows<T, HD>(Qs, static_cast<const T*>(a.q) + size_t(b) * a.Sq * a.H * hd, i0, nq, a.H,
                   h, hd);
  load_rows<T, HD>(Os, static_cast<const T*>(a.dout) + size_t(b) * a.Sq * a.H * hd, i0, nq,
                   a.H, h, hd);
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    const size_t at = (size_t(b) * a.Sq + i0 + r) * a.H + h;
    lse_s[r] = r < nq ? a.lse[at] : 0.f;
    D_s[r] = r < nq ? a.D[at] : 0.f;
  }
  q_positions(qp_s, i0, nq, b, R, info, a);
  const int qlo = info[2], qhi = info[3];

  float dq[RPT][CT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int t = 0; t < CT; ++t) dq[r][t] = 0.f;

  for (int j0 = 0; j0 < a.Skv; j0 += R) {
    const int nk = min(R, a.Skv - j0);
    __syncthreads();  // the last tile's readers of kp_s, Ks and Ss are done
    kv_positions(kp_s, j0, b, R, info, a);
    if (!tiles_meet(qlo, qhi, info[0], info[1], a)) continue;
    load_rows<T, HD>(Ks, k, j0, nk, a.KV, kvh, hd);
    load_rows<T, HD>(Vs, v, j0, nk, a.KV, kvh, hd);
    __syncthreads();
    probs<HD, false>(Qs, Os, Ks, Vs, qp_s, kp_s, lse_s, D_s, nq, nullptr, Ss, a);
    __syncthreads();
    // dQ += dS K: rows rg * RPT + r (queries), columns cg + 16 t
    for (int j = 0; j < R; ++j) {
      float ds[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) ds[r] = Ss[(rg * RPT + r) * PL + j];
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const float kk = Ks[j * LD + cg + 16 * t];
#pragma unroll
        for (int r = 0; r < RPT; ++r) dq[r][t] = fmaf(ds[r], kk, dq[r][t]);
      }
    }
  }

  T* g = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = rg * RPT + r;
    if (i >= nq) continue;
    const size_t row = (size_t(b) * a.Sq + i0 + i) * a.H + h;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int d = cg + 16 * t;
      if (FULL || d < hd) g[row * hd + d] = from_float<T>(dq[r][t]);
    }
  }
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int R = Tile<HD>::R;
  const long long rows = (long long)a.B * a.Sq * a.H;
  dot_kernel<T><<<unsigned((rows + 7) / 8), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t smem = smem_bytes<HD>();
  const bool full = a.hd == HD;
  auto kv_kernel = full ? dkdv_kernel<T, HD, true> : dkdv_kernel<T, HD, false>;
  auto q_kernel = full ? dq_kernel<T, HD, true> : dq_kernel<T, HD, false>;
  err = allow_smem(kv_kernel, smem);
  if (err != cudaSuccess) return int(err);
  err = allow_smem(q_kernel, smem);
  if (err != cudaSuccess) return int(err);
  kv_kernel<<<dim3((a.Skv + R - 1) / R, a.KV, a.B), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  q_kernel<<<dim3((a.Sq + R - 1) / R, a.H, a.B), THREADS, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_as(const Args& a, cudaStream_t stream) {
  if (a.hd <= 32) return launch<T, 32>(a, stream);
  if (a.hd <= 64) return launch<T, 64>(a, stream);
  if (a.hd <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

}  // namespace
}  // namespace flash_bwd
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// three launches: 0 on success, cudaErrorInvalidValue for an unsupported
// head_dim, dtype, head grouping or size.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const int* q_pos,
                                          const int* kv_pos, const unsigned char* kv_valid,
                                          const float* lse, float* D, void* dq, void* dk,
                                          void* dv, int B, int Sq, int Skv, int H, int KV,
                                          int hd, int dtype, int causal, int has_window,
                                          int window, float scale, void* stream) {
  using namespace repro_torch;
  if (KV <= 0 || H % KV != 0 || B <= 0 || Sq <= 0 || Skv <= 0 || hd < 1 || hd > 256 ||
      H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  const flash_bwd::Args a{q,  k,  v,  out, dout, q_pos, kv_pos, kv_valid, lse, D,
                          dq, dk, dv, B,   Sq,   Skv,   H,      KV,       hd,  causal,
                          has_window, window, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) return flash_bwd::dispatch_as<__nv_bfloat16>(a, s);
  if (dtype == DTYPE_F32) return flash_bwd::dispatch_as<float>(a, s);
  return int(cudaErrorInvalidValue);
}
