// The backward of the position-masked GQA flash attention of
// flash_prefill.cu, for Hopper (sm_90a): dQ, dK and dV of one training
// launch.
//
// Replaces no Pallas kernel: it is the gradient of the prefill kernel
// (src/repro/kernels/flash_prefill.py:91 `flash_attention`, the port's
// flash_prefill.cu), which the JAX package differentiates through and has
// no backward kernel for.  The port's forward kernel has no gradient, so
// the training forward (kernels/ops.py's FlashAttentionFn) needs this one:
// a CUDA tensor never falls back to the plain backward.
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
// What bounds it on the H100: operations.  At qwen2-0.5b's training shape
// (B 4, S 2048, H 14, KV 2, hd 64, causal) the five products over the
// causal half are about 7.5e10 operations a layer (0.076 ms at 989 TFLOP/s)
// against about 67 MB of traffic (0.02 ms).
//
// The first design ran every product on the CUDA cores in f32 (67 TFLOP/s
// where the bf16 tensor cores give 989), from padded f32 shared tiles filled
// one element a thread a step, on a dK/dV grid of (kv tiles, KV, B) whose
// blocks walked every query tile for each of the group's G heads in series
// (256 blocks at the training shape, the first 32x longer than the last),
// and it recomputed S and dP in both kernels: 6.8 ms, 90x its bound.  The
// bf16 launches now run on the tensor cores:
//
//   * Every product is mma.sync m16n8k16 (bf16 in, f32 accumulate) from
//     shared tiles through ldmatrix (Q^T, dO^T and K^T as transposed
//     loads), rows padded by 16 bytes, as flash_mma.cuh's forward.  Four
//     warps each own 16 rows of a 64-row tile; S^T or S, P, dP and dS stay
//     in registers, and P and dS feed the next product as A fragments
//     straight from the accumulator layout.  A warp skips a tile that the
//     mask leaves empty for its 16 rows and masks nothing on one that its
//     rows keep whole.
//   * P and dS enter their products as bf16 pairs hi = bf16(x), lo =
//     bf16(x - hi), two mma's each, as the forward's P: a single bf16 P or
//     dS moves the gradients by up to 6e-3 of their largest magnitude,
//     too close to the 1e-2 they are held to (tests/
//     test_torch_flash_bwd_numerics.py emulates both).  So ten product
//     passes: S^T, dP^T, dV x2 and dK x2 in the dK/dV kernel; S, dP, dQ x2
//     in the dQ kernel.
//   * Q/dO tiles (dK/dV kernel) and K/V tiles (dQ kernel) arrive by 16-byte
//     cp.async into a ring of two stages, with their positions, lse and D:
//     the next tile's copies are issued before the current tile's products.
//     A pre-scan marks the tiles whose positions can meet the block's, so
//     the loop visits only those (the causal triangle, a window).
//   * dK/dV is split over (kv tile, query head): 1,792 blocks at the
//     training shape where there were 256.  With G > 1 each block writes
//     its head's partial dK and dV in f32 to scratch [B, Skv, H, hd] from
//     the wrapper, and dkdv_reduce_kernel sums each kv head's G partials in
//     head order; with G = 1 the block writes dK and dV.  Both grids start
//     the longest blocks under the causal mask first (kv tile 0 for dK/dV,
//     the last query tile for dQ).  No sum uses atomics: the same inputs
//     give the same bits on every launch.
//   * At the hd-256 bucket a warp's two 16 x 256 f32 accumulators do not
//     fit in registers: a dK/dV block accumulates half of the columns (two
//     blocks a kv tile and head, each recomputing S^T and dP^T), and the
//     dQ kernel takes kv tiles of 32 rows, as the forward does.
//
// The f32 launches keep the first design (dkdv_kernel, dq_kernel), for the
// reason the forward's f32 stays on flash_tile.cuh: the tests hold f32 to
// atol 2e-5 and the card's f32 train step to the CPU's at 1e-4, which
// neither TF32 nor bf16 operands meet.  Each of their sums runs in a fixed
// order in one thread.
//
// Any head_dim hd in [1, 256] runs on the instantiation of the smallest
// bucket HD in {32, 64, 128, 256} that holds it, with zeros in the shared
// columns past hd; at hd == HD the FULL instantiation runs with hd the
// constant HD.  bf16 rows are copied by cp.async when hd is a multiple of 8
// and element by element otherwise.
//
// Layouts (all contiguous): q, out, dout, dq [B, Sq, H, hd]; k, v, dk, dv
// [B, Skv, KV, hd] (bf16 or f32, all one dtype); q_pos [B, Sq] int32;
// kv_pos [B, Skv] int32; kv_valid [B, Skv] bool or null; lse [B, Sq, H]
// f32; D [B, Sq, H] f32 scratch from the wrapper; dk_part, dv_part [B, Skv,
// H, hd] f32 scratch from the wrapper (bf16 with G > 1; else null).

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "flash_mma.cuh"

namespace repro_torch {
namespace flash_bwd {
namespace {

// ---- f32: the CUDA-core kernels -------------------------------------------

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
  float *dk_part, *dv_part;  // bf16 with G > 1: [B, Skv, H, hd]
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

// R rows of an f32 [rows, heads, hd] tensor (row stride heads * hd, head `h`),
// from row r0, into shared `dst` [R][LD]; rows past n and columns
// past hd are zeros
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int n, int heads,
                                          int h, int hd) {
  using Tl = Tile<HD>;
  for (int i = threadIdx.x; i < Tl::R * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (r < n && d < hd) x = src[((size_t(r0) + r) * heads + h) * hd + d];
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
template <int HD, bool FULL>
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
  const float* q = static_cast<const float*>(a.q) + size_t(b) * a.Sq * a.H * hd;
  const float* go = static_cast<const float*>(a.dout) + size_t(b) * a.Sq * a.H * hd;

  kv_positions(kp_s, j0, b, R, info, a);
  const int klo = info[0], khi = info[1];
  load_rows<HD>(Ks, static_cast<const float*>(a.k) + size_t(b) * a.Skv * a.KV * hd, j0, nk,
                   a.KV, kvh, hd);
  load_rows<HD>(Vs, static_cast<const float*>(a.v) + size_t(b) * a.Skv * a.KV * hd, j0, nk,
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
        load_rows<HD>(Qs, q, i0, nq, a.H, h, hd);
        load_rows<HD>(Os, go, i0, nq, a.H, h, hd);
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
  float* gk = static_cast<float*>(a.dk);
  float* gv = static_cast<float*>(a.dv);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int j = j0 + rg * RPT + r;
    if (j >= a.Skv) continue;
    const size_t row = (size_t(b) * a.Skv + j) * a.KV + kvh;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int d = cg + 16 * t;
      if (FULL || d < hd) {
        gk[row * hd + d] = dk[r][t];
        gv[row * hd + d] = dv[r][t];
      }
    }
  }
}

// dQ of R query rows of one head: grid (query tiles, H, B)
template <int HD, bool FULL>
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
  const float* k = static_cast<const float*>(a.k) + size_t(b) * a.Skv * a.KV * hd;
  const float* v = static_cast<const float*>(a.v) + size_t(b) * a.Skv * a.KV * hd;

  load_rows<HD>(Qs, static_cast<const float*>(a.q) + size_t(b) * a.Sq * a.H * hd, i0, nq, a.H,
                   h, hd);
  load_rows<HD>(Os, static_cast<const float*>(a.dout) + size_t(b) * a.Sq * a.H * hd, i0, nq,
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
    load_rows<HD>(Ks, k, j0, nk, a.KV, kvh, hd);
    load_rows<HD>(Vs, v, j0, nk, a.KV, kvh, hd);
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

  float* g = static_cast<float*>(a.dq);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = rg * RPT + r;
    if (i >= nq) continue;
    const size_t row = (size_t(b) * a.Sq + i0 + i) * a.H + h;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int d = cg + 16 * t;
      if (FULL || d < hd) g[row * hd + d] = dq[r][t];
    }
  }
}

// ---- bf16: the tensor-core kernels ---------------------------------------

using bf16 = __nv_bfloat16;
using flash_mma::copy_chunk;

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int BKV = 64;  // kv rows of a dK/dV block, 16 a warp
constexpr int BQ = 64;   // query rows of a dQ block, 16 a warp
constexpr unsigned ALL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Mma {
  static constexpr int QT = HD <= 64 ? 64 : 32;    // query rows of a dK/dV step
  static constexpr int KT = HD == 256 ? 32 : 64;   // kv rows of a dQ step
  static constexpr int DC = HD == 256 ? 128 : HD;  // dK/dV columns a block accumulates
  static constexpr int LD = HD + 8;  // shared row stride (bf16): +16 bytes against bank conflicts
  static constexpr int CPR = HD / 8;  // 16-byte chunks per row
};

// shared bytes before the visited-tile mask: K, V; two stages of Q, dO and
// of the queries' positions, lse and D; the kv rows' positions
template <int HD>
constexpr size_t dkdv_smem() {
  using M = Mma<HD>;
  return sizeof(bf16) * (2 * size_t(BKV) * M::LD + 2 * 2 * size_t(M::QT) * M::LD) +
         sizeof(int) * (BKV + 3 * 2 * M::QT);
}
// Q, dO; two stages of K, V and of the kv rows' positions
template <int HD>
constexpr size_t dq_smem() {
  using M = Mma<HD>;
  return sizeof(bf16) * (2 * size_t(BQ) * M::LD + 2 * 2 * size_t(M::KT) * M::LD) +
         sizeof(int) * 2 * M::KT;
}

// The key positions [lo, hi] that a query at position qp keeps (a kept key
// is also valid, kp >= 0 <= lo)
__device__ __forceinline__ void key_range(int qp, const Args& a, int& lo, int& hi) {
  hi = a.causal ? qp : INT_MAX;
  lo = a.has_window ? int(min(max(0LL, (long long)qp - a.window + 1), (long long)INT_MAX)) : 0;
}

// Mark in `visit` (zeroed) the tiles of R rows that can keep a pair with
// the block's own rows: query tiles (rows of q_pos) against the block's kv
// positions [lo, hi], or (KV) kv tiles (valid rows of kv_pos) against the
// block's query positions [lo, hi].  A warp reads SCAN tiles' rows before
// it reduces them, so one round trip to memory covers them all.
template <int R, bool KV>
__device__ __forceinline__ void mark_tiles(unsigned* visit, int n_tiles, int b, int lo, int hi,
                                           const Args& a) {
  constexpr int SCAN = 4, PER = R / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rows = KV ? a.Skv : a.Sq;
  for (int t0 = warp; t0 < n_tiles; t0 += MMA_WARPS * SCAN) {
    int pos[SCAN][PER];
    bool in[SCAN][PER];
#pragma unroll
    for (int u = 0; u < SCAN; ++u)
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int t = t0 + u * MMA_WARPS, r = t * R + lane + 32 * i;
        const size_t at = size_t(b) * n_rows + r;
        in[u][i] = t < n_tiles && r < n_rows;
        if (KV) in[u][i] = in[u][i] && (a.kv_valid == nullptr || __ldg(a.kv_valid + at) != 0);
        pos[u][i] = in[u][i] ? __ldg((KV ? a.kv_pos : a.q_pos) + at) : 0;
        if (KV) in[u][i] = in[u][i] && pos[u][i] >= 0;
      }
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (in[u][i]) {
          mn = min(mn, pos[u][i]);
          mx = max(mx, pos[u][i]);
        }
      mn = __reduce_min_sync(ALL, mn);
      mx = __reduce_max_sync(ALL, mx);
      const int t = t0 + u * MMA_WARPS;
      const bool meets = KV ? tiles_meet(lo, hi, mn, mx, a)
                            : mn != INT_MAX && tiles_meet(mn, mx, lo, hi, a);
      if (lane == 0 && meets) atomicOr(visit + (t >> 5), 1u << (t & 31));
    }
  }
}

__device__ __forceinline__ int next_marked(const unsigned* visit, int t, int n_tiles) {
  while (t < n_tiles && !((visit[t >> 5] >> (t & 31)) & 1u)) ++t;
  return t;
}

// dK and dV of BKV kv rows from one query head (DC of its columns, from
// column c0): grid (B * H * HD / DC, kv tiles).  A warp owns 16 kv rows and
// walks the marked query tiles: S^T = K Q^T and dP^T = V dO^T, then dV +=
// P^T dO and dK += dS^T Q.
template <int HD, bool FULL>
__global__ void __launch_bounds__(MMA_THREADS) dkdv_mma_kernel(const Args a) {
  using M = Mma<HD>;
  constexpr int QT = M::QT, LD = M::LD, CPR = M::CPR, DC = M::DC;
  constexpr int NQ = QT / 8;   // score fragments (8 queries each) a warp holds
  constexpr int ND = DC / 8;   // dK and dV fragments (8 columns each)
  constexpr int CP = HD / DC;  // column parts of a (kv tile, head)
  static_assert(HD % 16 == 0 && QT % 16 == 0 && DC % 16 == 0, "tiles are whole mma steps");
  const int hd = FULL ? HD : a.hd;
  const bool vec = FULL || hd % 8 == 0;

  extern __shared__ __align__(16) unsigned char tiles[];
  bf16* Ks = reinterpret_cast<bf16*>(tiles);  // [BKV][LD]
  bf16* Vs = Ks + BKV * LD;                  // [BKV][LD]
  bf16* Qs = Vs + BKV * LD;                  // [2][QT][LD]
  bf16* Os = Qs + 2 * QT * LD;               // [2][QT][LD] dO
  int* kp_s = reinterpret_cast<int*>(Os + 2 * QT * LD);  // [BKV] (-1: invalid)
  int* qp_s = kp_s + BKV;                                 // [2][QT]
  float* lse_s = reinterpret_cast<float*>(qp_s + 2 * QT);  // [2][QT]
  float* D_s = lse_s + 2 * QT;                             // [2][QT]
  unsigned* visit = reinterpret_cast<unsigned*>(D_s + 2 * QT);  // the marked query tiles
  __shared__ int info[2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.x / CP, c0 = (blockIdx.x % CP) * DC;
  const int h = bh % a.H, b = bh / a.H;
  const int G = a.H / a.KV, kvh = h / G;
  const int j0 = blockIdx.y * BKV;
  const int n_tiles = (a.Sq + QT - 1) / QT;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* go = static_cast<const bf16*>(a.dout);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  if (tid < BKV) {
    const int j = j0 + tid;
    int kp = -1;
    if (j < a.Skv) {
      const size_t at = size_t(b) * a.Skv + j;
      kp = __ldg(a.kv_pos + at);
      if (kp < 0 || (a.kv_valid != nullptr && __ldg(a.kv_valid + at) == 0)) kp = -1;
    }
    kp_s[tid] = kp;
  }
  for (int i = tid; i < (n_tiles + 31) / 32; i += MMA_THREADS) visit[i] = 0u;
  __syncthreads();
  if (warp == 0) {  // the block's valid kv positions
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int r = lane; r < BKV; r += 32)
      if (kp_s[r] >= 0) {
        lo = min(lo, kp_s[r]);
        hi = max(hi, kp_s[r]);
      }
    lo = __reduce_min_sync(ALL, lo);
    hi = __reduce_max_sync(ALL, hi);
    if (lane == 0) {
      info[0] = lo;
      info[1] = hi;
    }
  }
  __syncthreads();
  const int klo = info[0], khi = info[1];
  if (klo != INT_MAX) mark_tiles<QT, false>(visit, n_tiles, b, klo, khi, a);
  __syncthreads();

  // this thread's kv rows g and g + 8 of the warp's 16; the warp's valid
  // positions span [wklo, wkhi] (wkhi < 0: none)
  const int kp0 = kp_s[warp * 16 + g], kp1 = kp_s[warp * 16 + g + 8];
  const int wklo = __reduce_min_sync(ALL, min(kp0 >= 0 ? kp0 : INT_MAX, kp1 >= 0 ? kp1 : INT_MAX));
  const int wkhi = __reduce_max_sync(ALL, max(kp0, kp1));
  const bool wall = __all_sync(ALL, kp0 >= 0 && kp1 >= 0);
  // scores go to the base-2 domain: p = 2^(s * scale * log2(e) - lse * log2(e))
  const float c = a.scale * LOG2E;

  auto load_kv = [&]() {
    for (int i = tid; i < BKV * CPR; i += MMA_THREADS) {
      const int r = i / CPR, cc = i % CPR, j = j0 + r;
      const size_t off = ((size_t(b) * a.Skv + j) * a.KV + kvh) * hd;
      const bool read = j < a.Skv;
      copy_chunk<FULL>(Ks + r * LD + 8 * cc, read ? k + off : nullptr, cc, hd, vec, k);
      copy_chunk<FULL>(Vs + r * LD + 8 * cc, read ? v + off : nullptr, cc, hd, vec, v);
    }
  };
  auto load_q = [&](int t, int st) {
    const int i0 = t * QT;
    if (tid < QT) {  // rows past Sq: zeros, never kept
      const int i = i0 + tid, slot = st * QT + tid;
      const size_t at = size_t(b) * a.Sq + i;
      if (i < a.Sq) {
        cp_async4(smem_u32(qp_s + slot), a.q_pos + at);
        cp_async4(smem_u32(lse_s + slot), a.lse + at * a.H + h);
        cp_async4(smem_u32(D_s + slot), a.D + at * a.H + h);
      } else {
        qp_s[slot] = 0;
        lse_s[slot] = D_s[slot] = 0.f;
      }
    }
    for (int i = tid; i < QT * CPR; i += MMA_THREADS) {
      const int r = i / CPR, cc = i % CPR, qi = i0 + r;
      const size_t off = ((size_t(b) * a.Sq + qi) * a.H + h) * hd;
      const bool read = qi < a.Sq;
      const int row = (st * QT + r) * LD + 8 * cc;
      copy_chunk<FULL>(Qs + row, read ? q + off : nullptr, cc, hd, vec, q);
      copy_chunk<FULL>(Os + row, read ? go + off : nullptr, cc, hd, vec, go);
    }
  };

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  // ldmatrix lane addresses (flash_mma.cuh's): K and V rows of the warp as
  // A; a stage's Q and dO rows as B of S^T and dP^T and, transposed, as B
  // of dK and dV (their columns from c0)
  const uint32_t ka = smem_u32(Ks + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t va = smem_u32(Vs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const int brow = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const int trow = (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8 + c0;
  const uint32_t qb = smem_u32(Qs + brow), ob = smem_u32(Os + brow);
  const uint32_t qtb = smem_u32(Qs + trow), otb = smem_u32(Os + trow);
  constexpr uint32_t STAGE_BYTES = QT * LD * sizeof(bf16);
  constexpr uint32_t ROW_BYTES = LD * sizeof(bf16);

  int t = klo == INT_MAX ? n_tiles : next_marked(visit, 0, n_tiles);
  if (t < n_tiles) {
    load_kv();
    load_q(t, 0);
    cp_commit();
    int st = 0;
    while (t < n_tiles) {
      const int tn = next_marked(visit, t + 1, n_tiles);
      if (tn < n_tiles) load_q(tn, st ^ 1);
      cp_commit();
      cp_wait<1>();  // this tile's copies (and K's and V's) have landed
      __syncthreads();
      // the tile's queries keep positions in [tlo, thi] at most and
      // [tlo_max, thi_min] all of them
      const int nq = min(QT, a.Sq - t * QT);
      const int* qps = qp_s + st * QT;
      const float* ls = lse_s + st * QT;
      const float* Ds = D_s + st * QT;
      int tlo = INT_MAX, thi = INT_MIN, tlo_max = INT_MIN, thi_min = INT_MAX;
#pragma unroll
      for (int i = lane; i < QT; i += 32)
        if (i < nq) {
          int lo, hi;
          key_range(qps[i], a, lo, hi);
          tlo = min(tlo, lo);
          thi = max(thi, hi);
          tlo_max = max(tlo_max, lo);
          thi_min = min(thi_min, hi);
        }
      tlo = __reduce_min_sync(ALL, tlo);
      thi = __reduce_max_sync(ALL, thi);
      tlo_max = __reduce_max_sync(ALL, tlo_max);
      thi_min = __reduce_min_sync(ALL, thi_min);
      const bool meets = wkhi >= 0 && wklo <= thi && wkhi >= tlo;
      const bool whole = wall && nq == QT && wkhi <= thi_min && wklo >= tlo_max;
      if (meets) {
        // ---- S^T = K Q^T and dP^T = V dO^T: 16 kv rows x QT queries a warp
        float s[NQ][4], dp[NQ][4];
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t ak[4], av[4];
          ldsm_x4(ak, ka + kk * 32);
          ldsm_x4(av, va + kk * 32);
#pragma unroll
          for (int n2 = 0; n2 < NQ / 2; ++n2) {
            uint32_t bq[4], bo[4];
            const uint32_t at = st * STAGE_BYTES + n2 * 16 * ROW_BYTES + kk * 32;
            ldsm_x4(bq, qb + at);
            ldsm_x4(bo, ob + at);
            mma_bf16(s[2 * n2], ak, bq[0], bq[1]);
            mma_bf16(s[2 * n2 + 1], ak, bq[2], bq[3]);
            mma_bf16(dp[2 * n2], av, bo[0], bo[1]);
            mma_bf16(dp[2 * n2 + 1], av, bo[2], bo[3]);
          }
        }
        // ---- P^T and dS^T: rows kp0, kp1 (kv), columns the queries col, col + 1
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const int col = n * 8 + 2 * qd;
          const float2 l = *reinterpret_cast<const float2*>(ls + col);
          const float2 dd = *reinterpret_cast<const float2*>(Ds + col);
          bool k00 = true, k01 = true, k10 = true, k11 = true;
          if (!whole) {
            const int2 qp = *reinterpret_cast<const int2*>(qps + col);
            int lo_x, hi_x, lo_y, hi_y;
            key_range(qp.x, a, lo_x, hi_x);
            key_range(qp.y, a, lo_y, hi_y);
            if (col >= nq) hi_x = -1;
            if (col + 1 >= nq) hi_y = -1;
            k00 = kp0 >= lo_x && kp0 <= hi_x;
            k01 = kp0 >= lo_y && kp0 <= hi_y;
            k10 = kp1 >= lo_x && kp1 <= hi_x;
            k11 = kp1 >= lo_y && kp1 <= hi_y;
          }
          const float lx = l.x * LOG2E, ly = l.y * LOG2E;
          const float p0 = k00 ? ex2(fmaf(s[n][0], c, -lx)) : 0.f;
          const float p1 = k01 ? ex2(fmaf(s[n][1], c, -ly)) : 0.f;
          const float p2 = k10 ? ex2(fmaf(s[n][2], c, -lx)) : 0.f;
          const float p3 = k11 ? ex2(fmaf(s[n][3], c, -ly)) : 0.f;
          dp[n][0] = p0 * (dp[n][0] - dd.x) * a.scale;
          dp[n][1] = p1 * (dp[n][1] - dd.y) * a.scale;
          dp[n][2] = p2 * (dp[n][2] - dd.x) * a.scale;
          dp[n][3] = p3 * (dp[n][3] - dd.y) * a.scale;
          s[n][0] = p0;
          s[n][1] = p1;
          s[n][2] = p2;
          s[n][3] = p3;
        }
        // ---- dV += P^T dO and dK += dS^T Q, P and dS as hi + lo
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) {
          uint32_t ph[4], pl[4], sh[4], sl[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
          split_bf16(dp[2 * kk][0], dp[2 * kk][1], sh[0], sl[0]);
          split_bf16(dp[2 * kk][2], dp[2 * kk][3], sh[1], sl[1]);
          split_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1], sh[2], sl[2]);
          split_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3], sh[3], sl[3]);
#pragma unroll
          for (int d2 = 0; d2 < ND / 2; ++d2) {
            uint32_t bo[4], bq[4];
            const uint32_t at = st * STAGE_BYTES + kk * 16 * ROW_BYTES + d2 * 32;
            ldsm_x4_t(bo, otb + at);
            mma_bf16(dv[2 * d2], ph, bo[0], bo[1]);
            mma_bf16(dv[2 * d2], pl, bo[0], bo[1]);
            mma_bf16(dv[2 * d2 + 1], ph, bo[2], bo[3]);
            mma_bf16(dv[2 * d2 + 1], pl, bo[2], bo[3]);
            ldsm_x4_t(bq, qtb + at);
            mma_bf16(dk[2 * d2], sh, bq[0], bq[1]);
            mma_bf16(dk[2 * d2], sl, bq[0], bq[1]);
            mma_bf16(dk[2 * d2 + 1], sh, bq[2], bq[3]);
            mma_bf16(dk[2 * d2 + 1], sl, bq[2], bq[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
      t = tn;
      st ^= 1;
    }
  }

  // ---- every row of the tile: dK and dV (G == 1) or this head's partials;
  // zeros where no query keeps a row
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + warp * 16 + g + 8 * half;
    if (j >= a.Skv) continue;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int col = c0 + d * 8 + 2 * qd;
      const float k0 = dk[d][2 * half], k1 = dk[d][2 * half + 1];
      const float v0 = dv[d][2 * half], v1 = dv[d][2 * half + 1];
      if (G == 1) {
        const size_t at = ((size_t(b) * a.Skv + j) * a.KV + kvh) * hd + col;
        bf16* gk = static_cast<bf16*>(a.dk) + at;
        bf16* gv = static_cast<bf16*>(a.dv) + at;
        if (FULL) {
          *reinterpret_cast<__nv_bfloat162*>(gk) = __floats2bfloat162_rn(k0, k1);
          *reinterpret_cast<__nv_bfloat162*>(gv) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < hd) {
            gk[0] = __float2bfloat16(k0);
            gv[0] = __float2bfloat16(v0);
          }
          if (col + 1 < hd) {
            gk[1] = __float2bfloat16(k1);
            gv[1] = __float2bfloat16(v1);
          }
        }
      } else {
        const size_t at = ((size_t(b) * a.Skv + j) * a.H + h) * hd + col;
        float* pk = a.dk_part + at;
        float* pv = a.dv_part + at;
        if (FULL) {
          *reinterpret_cast<float2*>(pk) = make_float2(k0, k1);
          *reinterpret_cast<float2*>(pv) = make_float2(v0, v1);
        } else {
          if (col < hd) {
            pk[0] = k0;
            pv[0] = v0;
          }
          if (col + 1 < hd) {
            pk[1] = k1;
            pv[1] = v1;
          }
        }
      }
    }
  }
}

// dK and dV of each kv head: its G query heads' partials summed in head
// order, cast to bf16; VEC columns a thread
template <int VEC>
__global__ void __launch_bounds__(256) dkdv_reduce_kernel(const Args a) {
  const int G = a.H / a.KV;
  const size_t n = size_t(a.B) * a.Skv * a.KV * a.hd / VEC;
  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
  for (size_t e = size_t(blockIdx.x) * 256 + threadIdx.x; e < n; e += size_t(gridDim.x) * 256) {
    // output row (b * Skv + j) * KV + kvh reads partial rows
    // (b * Skv + j) * H + kvh * G + g
    const size_t row = e * VEC / a.hd, col = e * VEC % a.hd;
    const size_t base = row * G * a.hd + col;
    float sk[VEC], sv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) sk[i] = sv[i] = 0.f;
    for (int g = 0; g < G; ++g) {
      const size_t at = base + size_t(g) * a.hd;
      if constexpr (VEC == 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(a.dk_part + at));
        const float4 y = __ldg(reinterpret_cast<const float4*>(a.dv_part + at));
        sk[0] += x.x, sk[1] += x.y, sk[2] += x.z, sk[3] += x.w;
        sv[0] += y.x, sv[1] += y.y, sv[2] += y.z, sv[3] += y.w;
      } else {
        sk[0] += __ldg(a.dk_part + at);
        sv[0] += __ldg(a.dv_part + at);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      dk[e * VEC + i] = __float2bfloat16(sk[i]);
      dv[e * VEC + i] = __float2bfloat16(sv[i]);
    }
  }
}

// dQ of BQ query rows of one head: grid (B * H, query tiles), the last
// query tile first.  A warp owns 16 query rows and walks the marked kv
// tiles: S = Q K^T and dP = dO V^T, then dQ += dS K.
template <int HD, bool FULL>
__global__ void __launch_bounds__(MMA_THREADS) dq_mma_kernel(const Args a) {
  using M = Mma<HD>;
  constexpr int KT = M::KT, LD = M::LD, CPR = M::CPR;
  constexpr int NK = KT / 8;  // score fragments (8 kv rows each) a warp holds
  constexpr int ND = HD / 8;  // dQ fragments (8 columns each)
  static_assert(HD % 16 == 0 && KT % 16 == 0, "tiles are whole mma steps");
  const int hd = FULL ? HD : a.hd;
  const bool vec = FULL || hd % 8 == 0;

  extern __shared__ __align__(16) unsigned char tiles[];
  bf16* Qs = reinterpret_cast<bf16*>(tiles);  // [BQ][LD]
  bf16* Os = Qs + BQ * LD;                   // [BQ][LD] dO
  bf16* Ks = Os + BQ * LD;                   // [2][KT][LD]
  bf16* Vs = Ks + 2 * KT * LD;               // [2][KT][LD]
  int* kp_s = reinterpret_cast<int*>(Vs + 2 * KT * LD);  // [2][KT] (-1: invalid)
  unsigned* visit = reinterpret_cast<unsigned*>(kp_s + 2 * KT);  // the marked kv tiles
  __shared__ int wmin[MMA_WARPS], wmax[MMA_WARPS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int h = blockIdx.x % a.H, b = blockIdx.x / a.H;
  const int kvh = h / (a.H / a.KV);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int n_tiles = (a.Skv + KT - 1) / KT;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* go = static_cast<const bf16*>(a.dout);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  // this thread's query rows g and g + 8 of the warp's 16: position, lse
  // (base 2; 0 where not finite, as the plain version), D and kept range
  int qp[2], lo[2], hi[2];
  float l2[2], dd[2];
  bool valid[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + warp * 16 + g + 8 * half;
    valid[half] = i < a.Sq;
    const size_t at = (size_t(b) * a.Sq + i) * a.H + h;
    qp[half] = valid[half] ? __ldg(a.q_pos + size_t(b) * a.Sq + i) : 0;
    const float l = valid[half] ? __ldg(a.lse + at) : 0.f;
    l2[half] = isfinite(l) ? l * LOG2E : 0.f;
    dd[half] = valid[half] ? __ldg(a.D + at) : 0.f;
    key_range(qp[half], a, lo[half], hi[half]);
    if (!valid[half]) hi[half] = -1;
  }
  // the warp's queries keep positions in [wlo, whi] at most (whi < 0: none)
  // and [wlo_max, whi_min] all of them
  const int whi = __reduce_max_sync(ALL, max(hi[0], hi[1]));
  const int wlo = __reduce_min_sync(ALL, min(valid[0] ? lo[0] : INT_MAX,
                                             valid[1] ? lo[1] : INT_MAX));
  const bool wall = __all_sync(ALL, valid[0] && valid[1]);
  const int whi_min = __reduce_min_sync(ALL, min(hi[0], hi[1]));
  const int wlo_max = __reduce_max_sync(ALL, max(lo[0], lo[1]));
  {  // the block's valid query positions
    const int mn = __reduce_min_sync(ALL, min(valid[0] ? qp[0] : INT_MAX,
                                              valid[1] ? qp[1] : INT_MAX));
    const int mx = __reduce_max_sync(ALL, max(valid[0] ? qp[0] : INT_MIN,
                                              valid[1] ? qp[1] : INT_MIN));
    if (lane == 0) {
      wmin[warp] = mn;
      wmax[warp] = mx;
    }
  }
  for (int i = tid; i < (n_tiles + 31) / 32; i += MMA_THREADS) visit[i] = 0u;
  __syncthreads();
  int qlo = INT_MAX, qhi = INT_MIN;
#pragma unroll
  for (int w = 0; w < MMA_WARPS; ++w) {
    qlo = min(qlo, wmin[w]);
    qhi = max(qhi, wmax[w]);
  }
  if (qlo != INT_MAX) mark_tiles<KT, true>(visit, n_tiles, b, qlo, qhi, a);
  __syncthreads();
  const float c = a.scale * LOG2E;

  auto load_q = [&]() {
    for (int i = tid; i < BQ * CPR; i += MMA_THREADS) {
      const int r = i / CPR, cc = i % CPR, qi = i0 + r;
      const size_t off = ((size_t(b) * a.Sq + qi) * a.H + h) * hd;
      const bool read = qi < a.Sq;
      copy_chunk<FULL>(Qs + r * LD + 8 * cc, read ? q + off : nullptr, cc, hd, vec, q);
      copy_chunk<FULL>(Os + r * LD + 8 * cc, read ? go + off : nullptr, cc, hd, vec, go);
    }
  };
  auto load_kv = [&](int t, int st) {
    const int j0 = t * KT;
    if (tid < KT) {  // the rows' positions: -1 for an invalid row
      const int j = j0 + tid;
      const size_t at = size_t(b) * a.Skv + j;
      int* kp = kp_s + st * KT + tid;
      if (j >= a.Skv) {
        *kp = -1;
      } else if (a.kv_valid != nullptr) {
        *kp = __ldg(a.kv_valid + at) != 0 ? __ldg(a.kv_pos + at) : -1;
      } else {
        cp_async4(smem_u32(kp), a.kv_pos + at);
      }
    }
    for (int i = tid; i < KT * CPR; i += MMA_THREADS) {
      const int r = i / CPR, cc = i % CPR, j = j0 + r;
      const size_t off = ((size_t(b) * a.Skv + j) * a.KV + kvh) * hd;
      const bool read = j < a.Skv;
      const int row = (st * KT + r) * LD + 8 * cc;
      copy_chunk<FULL>(Ks + row, read ? k + off : nullptr, cc, hd, vec, k);
      copy_chunk<FULL>(Vs + row, read ? v + off : nullptr, cc, hd, vec, v);
    }
  };

  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  // ldmatrix lane addresses (flash_mma.cuh's): Q and dO rows of the warp as
  // A; a stage's K and V rows as B of S and dP and K, transposed, as B of dQ
  const uint32_t qa = smem_u32(Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t oa = smem_u32(Os + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const int brow = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const uint32_t kb = smem_u32(Ks + brow), vb = smem_u32(Vs + brow);
  const uint32_t ktb = smem_u32(Ks + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8);
  constexpr uint32_t STAGE_BYTES = KT * LD * sizeof(bf16);
  constexpr uint32_t ROW_BYTES = LD * sizeof(bf16);

  int t = qlo == INT_MAX ? n_tiles : next_marked(visit, 0, n_tiles);
  if (t < n_tiles) {
    load_q();
    load_kv(t, 0);
    cp_commit();
    int st = 0;
    while (t < n_tiles) {
      const int tn = next_marked(visit, t + 1, n_tiles);
      if (tn < n_tiles) load_kv(tn, st ^ 1);
      cp_commit();
      cp_wait<1>();  // this tile's copies (and Q's and dO's) have landed
      __syncthreads();
      const int* kps = kp_s + st * KT;
      int kmin = INT_MAX, kmax = -1;
      bool all_valid = true;
#pragma unroll
      for (int i = lane; i < KT; i += 32) {
        const int kp = kps[i];
        if (kp >= 0) {
          kmin = min(kmin, kp);
          kmax = max(kmax, kp);
        } else {
          all_valid = false;
        }
      }
      kmin = __reduce_min_sync(ALL, kmin);
      kmax = __reduce_max_sync(ALL, kmax);
      all_valid = __all_sync(ALL, all_valid);
      const bool meets = kmin <= whi && kmax >= wlo;
      const bool whole = wall && all_valid && kmax <= whi_min && kmin >= wlo_max;
      if (meets) {
        // ---- S = Q K^T and dP = dO V^T: 16 query rows x KT kv rows a warp
        float s[NK][4], dp[NK][4];
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t aq[4], ao[4];
          ldsm_x4(aq, qa + kk * 32);
          ldsm_x4(ao, oa + kk * 32);
#pragma unroll
          for (int n2 = 0; n2 < NK / 2; ++n2) {
            uint32_t bk[4], bv[4];
            const uint32_t at = st * STAGE_BYTES + n2 * 16 * ROW_BYTES + kk * 32;
            ldsm_x4(bk, kb + at);
            ldsm_x4(bv, vb + at);
            mma_bf16(s[2 * n2], aq, bk[0], bk[1]);
            mma_bf16(s[2 * n2 + 1], aq, bk[2], bk[3]);
            mma_bf16(dp[2 * n2], ao, bv[0], bv[1]);
            mma_bf16(dp[2 * n2 + 1], ao, bv[2], bv[3]);
          }
        }
        // ---- P and dS: rows g, g + 8 (queries), columns the kv rows col, col + 1
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int col = n * 8 + 2 * qd;
          bool k00 = true, k01 = true, k10 = true, k11 = true;
          if (!whole) {
            const int2 kp = *reinterpret_cast<const int2*>(kps + col);
            k00 = kp.x >= lo[0] && kp.x <= hi[0];
            k01 = kp.y >= lo[0] && kp.y <= hi[0];
            k10 = kp.x >= lo[1] && kp.x <= hi[1];
            k11 = kp.y >= lo[1] && kp.y <= hi[1];
          }
          const float p0 = k00 ? ex2(fmaf(s[n][0], c, -l2[0])) : 0.f;
          const float p1 = k01 ? ex2(fmaf(s[n][1], c, -l2[0])) : 0.f;
          const float p2 = k10 ? ex2(fmaf(s[n][2], c, -l2[1])) : 0.f;
          const float p3 = k11 ? ex2(fmaf(s[n][3], c, -l2[1])) : 0.f;
          s[n][0] = p0 * (dp[n][0] - dd[0]) * a.scale;
          s[n][1] = p1 * (dp[n][1] - dd[0]) * a.scale;
          s[n][2] = p2 * (dp[n][2] - dd[1]) * a.scale;
          s[n][3] = p3 * (dp[n][3] - dd[1]) * a.scale;
        }
        // ---- dQ += dS K, dS as hi + lo
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          uint32_t sh[4], sl[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], sh[0], sl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], sh[1], sl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], sh[2], sl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], sh[3], sl[3]);
#pragma unroll
          for (int d2 = 0; d2 < ND / 2; ++d2) {
            uint32_t bk[4];
            ldsm_x4_t(bk, ktb + st * STAGE_BYTES + kk * 16 * ROW_BYTES + d2 * 32);
            mma_bf16(acc[2 * d2], sh, bk[0], bk[1]);
            mma_bf16(acc[2 * d2], sl, bk[0], bk[1]);
            mma_bf16(acc[2 * d2 + 1], sh, bk[2], bk[3]);
            mma_bf16(acc[2 * d2 + 1], sl, bk[2], bk[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
      t = tn;
      st ^= 1;
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!valid[half]) continue;
    const int i = i0 + warp * 16 + g + 8 * half;
    bf16* o = static_cast<bf16*>(a.dq) + ((size_t(b) * a.Sq + i) * a.H + h) * hd;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int col = d * 8 + 2 * qd;
      const float x0 = acc[d][2 * half], x1 = acc[d][2 * half + 1];
      if (FULL) {
        *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < hd) o[col] = __float2bfloat16(x0);
        if (col + 1 < hd) o[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// f32: the rowsum, then the CUDA-core dK/dV and dQ kernels
template <int HD>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int R = Tile<HD>::R;
  const long long rows = (long long)a.B * a.Sq * a.H;
  dot_kernel<float><<<unsigned((rows + 7) / 8), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t smem = smem_bytes<HD>();
  const bool full = a.hd == HD;
  auto kv_kernel = full ? dkdv_kernel<HD, true> : dkdv_kernel<HD, false>;
  auto q_kernel = full ? dq_kernel<HD, true> : dq_kernel<HD, false>;
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

// bf16: the rowsum, the dK/dV kernel (and the reduce when G > 1), the dQ
// kernel
template <int HD>
int launch_mma(const Args& a, cudaStream_t stream) {
  using M = Mma<HD>;
  const int G = a.H / a.KV;
  const long long kv_tiles = (a.Skv + BKV - 1) / BKV, q_tiles = (a.Sq + BQ - 1) / BQ;
  if (kv_tiles > 65535 || q_tiles > 65535 || (long long)a.B * a.H * (HD / M::DC) > INT_MAX)
    return int(cudaErrorInvalidValue);
  if (G > 1 && (a.dk_part == nullptr || a.dv_part == nullptr)) return int(cudaErrorInvalidValue);
  const long long rows = (long long)a.B * a.Sq * a.H;
  dot_kernel<bf16><<<unsigned((rows + 7) / 8), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const bool full = a.hd == HD;
  auto kv_kernel = full ? dkdv_mma_kernel<HD, true> : dkdv_mma_kernel<HD, false>;
  auto q_kernel = full ? dq_mma_kernel<HD, true> : dq_mma_kernel<HD, false>;
  const long long q_marks = ((a.Sq + M::QT - 1) / M::QT + 31) / 32;
  const long long kv_marks = ((a.Skv + M::KT - 1) / M::KT + 31) / 32;
  const size_t kv_smem = dkdv_smem<HD>() + sizeof(unsigned) * q_marks;
  const size_t q_smem = dq_smem<HD>() + sizeof(unsigned) * kv_marks;
  err = allow_smem(kv_kernel, kv_smem);
  if (err != cudaSuccess) return int(err);
  err = allow_smem(q_kernel, q_smem);
  if (err != cudaSuccess) return int(err);
  kv_kernel<<<dim3(unsigned(a.B * a.H * (HD / M::DC)), unsigned(kv_tiles)), MMA_THREADS, kv_smem,
              stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (G > 1) {
    const bool v4 = a.hd % 4 == 0;
    const size_t n = size_t(a.B) * a.Skv * a.KV * a.hd / (v4 ? 4 : 1);
    const unsigned blocks = unsigned((n + 255) / 256 < (1u << 20) ? (n + 255) / 256 : 1u << 20);
    if (v4)
      dkdv_reduce_kernel<4><<<blocks, 256, 0, stream>>>(a);
    else
      dkdv_reduce_kernel<1><<<blocks, 256, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  q_kernel<<<dim3(unsigned(a.B * a.H), unsigned(q_tiles)), MMA_THREADS, q_smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <bool MMA>
int dispatch(const Args& a, cudaStream_t stream) {
  const int bucket = flash_mma::bucket(a.hd);
  if constexpr (MMA) {
    switch (bucket) {
      case 32: return launch_mma<32>(a, stream);
      case 64: return launch_mma<64>(a, stream);
      case 128: return launch_mma<128>(a, stream);
      default: return launch_mma<256>(a, stream);
    }
  }
  switch (bucket) {
    case 32: return launch_f32<32>(a, stream);
    case 64: return launch_f32<64>(a, stream);
    case 128: return launch_f32<128>(a, stream);
    default: return launch_f32<256>(a, stream);
  }
}

}  // namespace
}  // namespace flash_bwd
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Returns the CUDA status of the
// launches: 0 on success, cudaErrorInvalidValue for an unsupported
// head_dim, dtype, head grouping or size, or a bf16 launch with G > 1
// without its partials' scratch.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const int* q_pos,
                                          const int* kv_pos, const unsigned char* kv_valid,
                                          const float* lse, float* D, void* dq, void* dk,
                                          void* dv, float* dk_part, float* dv_part, int B,
                                          int Sq, int Skv, int H, int KV, int hd, int dtype,
                                          int causal, int has_window, int window, float scale,
                                          void* stream) {
  using namespace repro_torch;
  if (KV <= 0 || H % KV != 0 || B <= 0 || Sq <= 0 || Skv <= 0 || hd < 1 || hd > 256 ||
      H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  const flash_bwd::Args a{q,  k,  v,  out,     dout,    q_pos, kv_pos, kv_valid, lse,
                          D,  dq, dk, dv,      dk_part, dv_part, B,    Sq,       Skv,
                          H,  KV, hd, causal,  has_window, window, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) return flash_bwd::dispatch<true>(a, s);
  if (dtype == DTYPE_F32) return flash_bwd::dispatch<false>(a, s);
  return int(cudaErrorInvalidValue);
}
