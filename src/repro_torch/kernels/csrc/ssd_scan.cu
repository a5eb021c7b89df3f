// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel `ssd_chunked` of the JAX package
// (src/repro/kernels/ssd_scan.py).  Per head h (group g = h / (H / G)) it
// runs the state-space-dual form of the selective scan
//
//   h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t ⊗ B_t,      y_t = h_t · C_t
//
// chunk by chunk: with cum the inclusive cumsum of dt·A_h inside a chunk,
//
//   y     = ((C Bᵀ) ⊙ exp(cum_t - cum_s)[s <= t] ⊙ dt_s) X + exp(cum_t) (C h_in)
//   h_out = exp(cum_last) h_in + Σ_s exp(cum_last - cum_s) dt_s x_s ⊗ B_s
//
// all in f32, whatever the input type.  The decay exponent is taken only
// where s <= t (as the reference masks before exp), so nothing overflows.
//
// What bounds it on the H100: bytes.  A layer of a 2,000-token mamba2-1.3b
// prefill reads x, B, C, dt and h0 once and writes y and hT once (~38 MB,
// ~0.012 ms at 3.35 TB/s); its ~5 GFLOP at the bf16 tensor-core peak take
// ~0.005 ms.  This first kernel is far from that bound: it computes on the
// CUDA cores from shared memory.  What its design does:
//
//  - The Pallas grid (B, H, n_chunks) carried the [P, S] state in VMEM from
//    one chunk step to the next.  CUDA blocks run in no order, so one block
//    owns (b, h, a tile of PT = 32 rows of P) and loops over the chunks
//    itself, the state tile resident in shared memory.  y[:, p] and h[p, :]
//    depend only on x[:, p], so splitting P is exact; each block recomputes
//    the chunk's C Bᵀ (shared by the P tiles and by the heads of a group).
//  - Pallas held a whole 256-token chunk (~0.6 MB of VMEM; the 256 x 256 f32
//    score alone is 256 KB, more than a block's 227 KB).  Here a chunk is at
//    most TQ = 64 tokens (min(chunk, 64)): the SSD form is exact for any
//    chunk length, and a shorter one does fewer operations in its quadratic
//    part.  Shared memory per block: B and C tiles [64][S4 + 4], the score
//    [64][68], the x tile [64][32], the state [32][S4 + 4], f32 (S4 = S
//    rounded up to 4): ~111 KB at S = 128, ~193 KB at S = 256.
//  - Padding: the last chunk's missing tokens load as x = B = C = dt = 0,
//    so they neither decay nor update the state, and their y is not
//    written.
//  - Register tiles (4 x 4 scores, 4 x 2 outputs, 4 x 4 state values per
//    thread) over float4 shared-memory reads whose row strides keep a warp's
//    lanes on distinct banks.  Tensor cores (mma/wgmma) and TMA are later
//    work.
//
// Layouts (all contiguous): x [B, L, H, P] f32 or bf16; dt [B, L, H] f32;
// A [H] f32; Bm, Cm [B, L, G, S] x's type; h0 (optional), hT [B, H, P, S] f32;
// y [B, L, H, P] x's type.  P <= 256, S <= 256, H % G == 0, L >= 1.
// Grid (ceil(P / 32), H, B), 256 threads.

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace ssd {
namespace {

constexpr int TQ = 64;       // tokens of a chunk tile (the kernel's chunk, at most)
constexpr int PT = 32;       // rows of P per block
constexpr int THREADS = 256;
constexpr int LDM = TQ + 4;  // row stride of the score tile

struct Smem {
  int lds;  // row stride of the B, C and state tiles: S4 + 4
  float *b, *c, *m, *x, *h, *cum, *dts, *e, *w;
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

__host__ inline size_t smem_bytes(int S) {
  const int lds = round4(S) + 4;
  return sizeof(float) * (size_t(2 * TQ * lds) + TQ * LDM + TQ * PT + PT * lds + 4 * TQ);
}

__device__ inline Smem carve(float* base, int S) {
  Smem s;
  s.lds = round4(S) + 4;
  s.b = base;
  s.c = s.b + TQ * s.lds;
  s.m = s.c + TQ * s.lds;
  s.x = s.m + TQ * LDM;
  s.h = s.x + TQ * PT;
  s.cum = s.h + PT * s.lds;
  s.dts = s.cum + TQ;
  s.e = s.dts + TQ;
  s.w = s.e + TQ;
  return s;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ hT, int L, int H, int P, int G, int S, int q) {
  extern __shared__ __align__(16) float smem_raw[];
  const Smem sm = carve(smem_raw, S);
  const int lds = sm.lds, S4 = round4(S);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const float Ah = A[h];

  // the state tile, resident across chunks: h[p][k], rows past P zero
  for (int i = tid; i < PT * S4; i += THREADS) {
    const int p = i / S4, k = i % S4;
    float v = 0.f;
    if (h0 != nullptr && p0 + p < P && k < S) v = h0[((long long)(b * H + h) * P + p0 + p) * S + k];
    sm.h[p * lds + k] = v;
  }

  for (int t0 = 0; t0 < L; t0 += q) {
    const int n = min(q, L - t0);  // valid tokens of this chunk
    // ---- load: B, C, x, dt of the chunk as f32; padding as zeros ---------
    for (int i = tid; i < TQ * S4; i += THREADS) {
      const int t = i / S4, k = i % S4;
      float bv = 0.f, cv = 0.f;
      if (t < n && k < S) {
        const long long off = ((long long)(b * L + t0 + t) * G + g) * S + k;
        bv = to_float(Bm[off]);
        cv = to_float(Cm[off]);
      }
      sm.b[t * lds + k] = bv;
      sm.c[t * lds + k] = cv;
    }
    for (int i = tid; i < TQ * PT; i += THREADS) {
      const int t = i / PT, p = i % PT;
      float v = 0.f;
      if (t < n && p0 + p < P) v = to_float(x[((long long)(b * L + t0 + t) * H + h) * P + p0 + p]);
      sm.x[i] = v;
    }
    if (tid < TQ) sm.dts[tid] = tid < n ? dt[(long long)(b * L + t0 + tid) * H + h] : 0.f;
    __syncthreads();

    // ---- cum: inclusive cumsum of dt·A over the chunk (one warp) ---------
    if (warp == 0) {
      const float a0 = sm.dts[2 * lane] * Ah, a1 = sm.dts[2 * lane + 1] * Ah;
      float s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += up;
      }
      const float before = s - (a0 + a1);
      sm.cum[2 * lane] = before + a0;
      sm.cum[2 * lane + 1] = before + a0 + a1;
    }
    __syncthreads();
    const float last = sm.cum[q - 1];  // padding adds 0: the chunk's total
    if (tid < TQ) {
      sm.e[tid] = expf(sm.cum[tid]);
      sm.w[tid] = expf(last - sm.cum[tid]) * sm.dts[tid];
    }

    // ---- score: m[t][s] = (C_t · B_s) exp(cum_t - cum_s) dt_s, s <= t ----
    {
      const int tg = tid / 16, sg = tid % 16;  // t = 4 tg + i, s = sg + 16 j
      const int t_hi = 4 * tg + 3;
      float acc[4][4] = {};
      for (int k = 0; 4 * tg < q && k < S4; k += 4) {
        float4 c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          c[i] = *reinterpret_cast<const float4*>(&sm.c[(4 * tg + i) * lds + k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (sg + 16 * j > t_hi) continue;  // above the diagonal
          const float4 bb = *reinterpret_cast<const float4*>(&sm.b[(sg + 16 * j) * lds + k]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += dot4(c[i], bb);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tg + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = sg + 16 * j;
          float v = 0.f;
          if (s <= t && t < q) v = acc[i][j] * expf(sm.cum[t] - sm.cum[s]) * sm.dts[s];
          sm.m[t * LDM + s] = v;
        }
      }
    }
    __syncthreads();

    // ---- y = m X + exp(cum_t) (C h_in) -----------------------------------
    {
      const int tg = tid / 16, pg = tid % 16;  // t = 4 tg + i, p = pg + 16 j
      if (4 * tg < n) {
        float acc[4][2] = {};
        for (int k = 0; k < S4; k += 4) {
          float4 c[4], hv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            c[i] = *reinterpret_cast<const float4*>(&sm.c[(4 * tg + i) * lds + k]);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            hv[j] = *reinterpret_cast<const float4*>(&sm.h[(pg + 16 * j) * lds + k]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) acc[i][j] += dot4(c[i], hv[j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][j] *= sm.e[4 * tg + i];
        for (int s = 0; s < 4 * tg + 4; s += 4) {
          float4 m[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            m[i] = *reinterpret_cast<const float4*>(&sm.m[(4 * tg + i) * LDM + s]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float4 xv = make_float4(
                sm.x[(s + 0) * PT + pg + 16 * j], sm.x[(s + 1) * PT + pg + 16 * j],
                sm.x[(s + 2) * PT + pg + 16 * j], sm.x[(s + 3) * PT + pg + 16 * j]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] += dot4(m[i], xv);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * tg + i;
          if (t >= n) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = p0 + pg + 16 * j;
            if (p < P) y[((long long)(b * L + t0 + t) * H + h) * P + p] = from_float<T>(acc[i][j]);
          }
        }
      }
    }
    __syncthreads();

    // ---- h_out = exp(cum_last) h_in + Σ_s w_s x_s ⊗ B_s ------------------
    {
      const float total = expf(last);
      const int pg = warp;  // p = pg + 8 i; k = kb + 4 lane + (0..3)
      for (int kb = 0; kb < S4; kb += 128) {
        const int k = kb + 4 * lane;
        if (k >= S4) break;
        float4 acc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 hv = *reinterpret_cast<const float4*>(&sm.h[(pg + 8 * i) * lds + k]);
          acc[i] = make_float4(total * hv.x, total * hv.y, total * hv.z, total * hv.w);
        }
        for (int s = 0; s < n; ++s) {
          const float4 bb = *reinterpret_cast<const float4*>(&sm.b[s * lds + k]);
          const float ws = sm.w[s];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xv = ws * sm.x[s * PT + pg + 8 * i];
            acc[i].x += xv * bb.x;
            acc[i].y += xv * bb.y;
            acc[i].z += xv * bb.z;
            acc[i].w += xv * bb.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(&sm.h[(pg + 8 * i) * lds + k]) = acc[i];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < PT * S; i += THREADS) {
    const int p = i / S, k = i % S;
    if (p0 + p < P) hT[((long long)(b * H + h) * P + p0 + p) * S + k] = sm.h[p * lds + k];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* h0, void* y, void* hT, int Bsz, int L, int H, int P, int G, int S, int q,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(S);
  cudaError_t err = allow_smem(ssd_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + PT - 1) / PT, H, Bsz);
  ssd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hT), L, H, P, G, S, q);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace ssd
}  // namespace repro_torch

// h0 may be null (a zero initial state).  chunk is the reference's chunk
// length; the kernel's chunk is min(chunk, 64).
extern "C" int ssd_chunked_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                  const void* Cm, const void* h0, void* y, void* hT, int Bsz,
                                  int L, int H, int P, int G, int S, int chunk, int dtype,
                                  void* stream) {
  using namespace repro_torch;
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > 256 || S <= 0 ||
      S > 256 || chunk <= 0 || H > 65535 || Bsz > 65535)
    return int(cudaErrorInvalidValue);
  const int q = chunk < ssd::TQ ? chunk : ssd::TQ;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return ssd::launch<float>(x, dt, A, Bm, Cm, h0, y, hT, Bsz, L, H, P, G, S, q, s);
  if (dtype == DTYPE_BF16)
    return ssd::launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, hT, Bsz, L, H, P, G, S, q, s);
  return int(cudaErrorInvalidValue);
}
