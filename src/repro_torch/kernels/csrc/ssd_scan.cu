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
// prefill (H 64, P 64, S 128, G 1) reads x, B, C, dt once and writes y and
// the final state once (~36 MB, ~0.011 ms at 3.35 TB/s); the chunked form at
// the reference's chunk of 256 is ~6 GFLOP (~0.006 ms at the bf16
// tensor-core peak).  The Pallas grid (B, H, chunks) carried the [P, S] state
// in VMEM from one chunk step to the next, so its chunks ran in series; a
// block that walks the chunks so (the f32 body below) leaves most of the 132
// SMs idle at the serve's shape and waits on every chunk's loads.
//
// bf16 runs three kernels, the plain version's own three steps, with the
// parallel work over chunks of CHUNK tokens (fixed from the launch's token
// 0, so the same inputs give the same bits on every launch; no atomics):
//
//  1. chunk_state_kernel, grid (chunks x P tiles x S tiles, H, B), 4 warps:
//     the chunk's cumsum (one warp scan), w_s = exp(cum_last - cum_s) dt_s and
//     states_c = (X ⊙ w)ᵀ B on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate), 64-token tiles arriving by cp.async into a ring of
//     two; writes states_c and the chunk's decay exp(cum_last).
//  2. state_pass_kernel, grid (P·S elements / 256, H, B): elementwise f32 in
//     chunk order from the initial state (or zeros), h <- exp(cum_last_c) h +
//     states_c, replacing states_c in place by the state before chunk c
//     (eight chunks' loads in flight); writes the final state.
//  3. chunk_output_kernel, grid (chunks x 64-token row blocks x P tiles, H,
//     B), 4 warps: y = exp(cum_t) (C h_inᵀ) + M X.  C h_inᵀ first, each warp
//     taking 16 columns of P over the 64 rows with its h_in rows read from
//     the scratch straight into fragments (each value split once, no h_in
//     tile in shared memory); the result reaches the warps of the rows
//     through an f32 tile that the first B/x tile then overwrites.  Then per
//     64-column tile at or below the row block, C Bᵀ, M = C Bᵀ ⊙ exp(cum_t -
//     cum_s) ⊙ dt_s in registers (no Q x Q score is held whole) and M X.
//     One stage (~45 KB at S 128) and ~116 registers: four blocks an SM,
//     which overlap one block's tile loads with another's products.
//
// CHUNK (128) trades the scratch's four passes (chunks x H x P x S16 x 4
// bytes each) against the quadratic work and the tile loads of step 3, which
// grow with it; PERF.md has the card's times of 64, 128 and 256 behind the
// choice.
//
// Why three parts: the products' f32 operands (X ⊙ w, M, h_in) go into the
// tensor cores as three bf16 parts, hi = bf16(v), mid = bf16(v - hi) and lo
// = bf16(v - hi - mid), accumulated by three mma's (the prefill tile takes
// two for P, flash_mma.cuh).  v rounded once to bf16 errs by ~2^-9 |v|: over
// 2,000 tokens of an O(1) state far above the 5e-5 the final state is held
// to.  Two parts (~2^-17 |v|) still move a near-zero bf16 y by up to ~4e-5
// against the 5e-5 it is held to beyond one ulp, through M and h_in
// (scripts/ssd_split_emulation.py redoes this arithmetic on the CPU); three
// (~2^-26 |v|) keep f32 accuracy.  x, B and C are bf16 already, so C Bᵀ and
// the products with x are exact in f32.  The decay in M is ex2.approx of the
// difference scaled to base 2 (relative error ~2^-22), the others expf.
//
// Scratch (f32, allocated by the wrapper, its size a function of the shapes
// and CHUNK alone; S16 is S rounded up to 16, the pad columns zero): the
// states [B, H, chunks, P, S16], then the decays [B, H, chunks].
//
// f32 runs the first kernel's CUDA-core body (ssd_kernel): one block per
// (32 rows of P, head, batch) over chunks of min(chunk, 64) tokens, the
// state tile resident in shared memory.  Its f32 products are what the
// tests hold it to against the f64 scan; the serve runs bf16.
//
// Layouts (all contiguous): x [B, L, H, P] f32 or bf16; dt [B, L, H] f32;
// A [H] f32; Bm, Cm [B, L, G, S] x's type; h0 (optional), hT [B, H, P, S] f32;
// y [B, L, H, P] x's type.  P <= 256, S <= 256, H % G == 0, L >= 1.

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace ssd {
namespace {

// --------------------------------------------------------------------------
// f32: the CUDA-core body
// --------------------------------------------------------------------------

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

__global__ void __launch_bounds__(THREADS)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           const float* __restrict__ h0, float* __restrict__ y, float* __restrict__ hT, int L,
           int H, int P, int G, int S, int q) {
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
    // ---- load: B, C, x, dt of the chunk; padding as zeros ----------------
    for (int i = tid; i < TQ * S4; i += THREADS) {
      const int t = i / S4, k = i % S4;
      float bv = 0.f, cv = 0.f;
      if (t < n && k < S) {
        const long long off = ((long long)(b * L + t0 + t) * G + g) * S + k;
        bv = Bm[off];
        cv = Cm[off];
      }
      sm.b[t * lds + k] = bv;
      sm.c[t * lds + k] = cv;
    }
    for (int i = tid; i < TQ * PT; i += THREADS) {
      const int t = i / PT, p = i % PT;
      float v = 0.f;
      if (t < n && p0 + p < P) v = x[((long long)(b * L + t0 + t) * H + h) * P + p0 + p];
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
            if (p < P) y[((long long)(b * L + t0 + t) * H + h) * P + p] = acc[i][j];
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

int launch_f32(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
               const float* h0, float* y, float* hT, int Bsz, int L, int H, int P, int G, int S,
               int q, cudaStream_t stream) {
  const size_t smem = smem_bytes(S);
  cudaError_t err = allow_smem(ssd_kernel, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + PT - 1) / PT, H, Bsz);
  ssd_kernel<<<grid, THREADS, smem, stream>>>(x, dt, A, Bm, Cm, h0, y, hT, L, H, P, G, S, q);
  return int(cudaGetLastError());
}

// --------------------------------------------------------------------------
// bf16: chunk states, the state pass and chunk outputs on the tensor cores
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// tokens of a chunk: the wrapper's CHUNK, which the launcher checks through
// the chunk count and the scratch size it is given
constexpr int CHUNK = 128;
constexpr int ROWS = 64;  // tokens of a tile (16 a warp in chunk_output_kernel)
constexpr int PW = 64;    // columns of P a block owns
constexpr int SW = 128;   // columns of S a chunk_state_kernel block owns
constexpr int STATE_THREADS = 128;  // chunk_state_kernel: 4 warps of 16 x 128 outputs
constexpr int OUTPUT_THREADS = 128;  // chunk_output_kernel: 4 warps of 16 rows
constexpr int PASS_THREADS = 256;
constexpr int STAGES = CHUNK > ROWS ? 2 : 1;  // chunk_state_kernel's token tiles in flight
constexpr int LDP = PW + 8;  // row strides (bf16) of shared tiles: +16 bytes against bank conflicts
constexpr int LDW = SW + 8;
constexpr int LDY = PW + 8;  // row stride (f32) of chunk_output_kernel's C h_inᵀ tile
constexpr unsigned ALL = 0xffffffffu;

struct Args {
  const bf16 *x, *Bm, *Cm;
  const float *dt, *A, *h0;
  bf16* y;
  float* hT;
  float* states;  // [B, H, nc, P, S16]: each chunk's, then the state before it
  float* decay;   // [B, H, nc]: exp(cum_last) of each chunk
  int L, H, P, G, S, S16, nc;
  int x_vec, bc_vec;  // rows of x / of B and C are 16-byte aligned
};

__host__ __device__ constexpr size_t state_smem_bytes() {
  return sizeof(bf16) * size_t(STAGES) * ROWS * (LDP + LDW) + sizeof(float) * 3 * CHUNK;
}
// chunk_output_kernel: C, then one B and x stage or (before the first tile
// is loaded) the f32 tile of exp(cum_t) C h_inᵀ, then cum and dt
__host__ __device__ inline size_t output_stage_bytes(int S16) {
  const size_t stage = sizeof(bf16) * ROWS * (S16 + 8 + LDP), ys = sizeof(float) * ROWS * LDY;
  return stage > ys ? stage : ys;
}
__host__ __device__ inline size_t output_smem_bytes(int S16) {
  return sizeof(bf16) * ROWS * (S16 + 8) + output_stage_bytes(S16) + sizeof(float) * 2 * CHUNK;
}

// Rows [0, ROWS) and columns [0, width) (width a multiple of 16 bytes) of a
// matrix of T into the shared tile `dst` (row stride ld): row r from src + r
// * stride, zeros past `rows` rows and `cols` columns.  16-byte cp.async
// copies when `vec` (rows 16-byte aligned, cols a multiple of 16 bytes), else
// element by element.  Row 0 of src is always a valid address.
template <int THREADS_, typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long stride, int rows,
                                          int cols, int width, bool vec, int tid) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte copy
  const int cpr = width / E;
  for (int i = tid; i < ROWS * cpr; i += THREADS_) {
    const int r = i / cpr, c = E * (i % cpr);
    T* d = dst + r * ld + c;
    const int n = r < rows ? min(max(cols - c, 0), E) : 0;
    const T* s = src + r * stride + c;
    if (vec) {
      cp_async16(smem_u32(d), n > 0 ? s : src, n * int(sizeof(T)));
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = e < n ? s[e] : from_float<T>(0.f);
    }
  }
}

// One warp: cum[t] = Σ_{u <= t} dt_u A and dts[t] = dt_t over the chunk's
// CHUNK tokens from `dt` (stride H), zeros past n tokens.  Lane l sums its
// tokens [E l, E l + E) in order, then the lanes' totals are scanned: both
// kernels that need the cumsum get the same bits from it.
__device__ __forceinline__ void chunk_cumsum(const float* dt, int H, int n, float A, float* cum,
                                             float* dts, int lane) {
  constexpr int E = CHUNK / 32;
  float run[E];
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = E * lane + e;
    const float d = t < n ? dt[(long long)t * H] : 0.f;
    dts[t] = d;
    s += d * A;
    run[e] = s;
  }
  float scan = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(ALL, scan, o);
    if (lane >= o) scan += up;
  }
  const float up = __shfl_up_sync(ALL, scan, 1);
  const float before = lane > 0 ? up : 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) cum[E * lane + e] = before + run[e];
}

// (x0, x1) as bf16 pairs hi = bf16(x), mid = bf16(x - hi) and lo = bf16(x -
// hi - mid): the differences are exact in f32, so hi + mid + lo is x to ~2^-26
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m)));
}

// An A operand (16x16) in three parts, part[0] hi, part[1] mid, part[2] lo.
// The products loop over the parts outside the accumulators: the mma's that
// a warp issues back to back go to different accumulators, so none waits on
// the one before it.
struct Split3 {
  uint32_t part[3][4];
};

// (x0, x1), two bf16 in one register, times (w.x, w.y) in f32, split in three
__device__ __forceinline__ void scale_split3(uint32_t xs, float2 w, Split3& a, int i) {
  const float x0 = __uint_as_float(xs << 16), x1 = __uint_as_float(xs & 0xffff0000u);
  split3(x0 * w.x, x1 * w.y, a.part[0][i], a.part[1][i], a.part[2][i]);
}

// ---- 1. chunk states: states_c[p][s] = Σ_t x_t[p] w_t B_t[s] --------------
// LOCAL (the backward, ssd_backward.cu): the same product with the weight
// e_t = exp(cum_t) in place of w_t, over the operands the caller puts in x
// (dy), Bm (C) and states (its local dh terms); in place of the decay it
// writes the chunk's cum and dt to decay as [B, H, nc, 2, CHUNK].
template <bool LOCAL>
__global__ void __launch_bounds__(STATE_THREADS) chunk_state_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);  // [STAGES][ROWS][LDP]: x, tokens by columns of P
  bf16* Bs = Xs + STAGES * ROWS * LDP;       // [STAGES][ROWS][LDW]: B, tokens by columns of S
  float* cum = reinterpret_cast<float*>(Bs + STAGES * ROWS * LDW);  // [CHUNK]
  float* dts = cum + CHUNK;                                          // [CHUNK]
  float* w = dts + CHUNK;                                            // [CHUNK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int PB = (a.P + PW - 1) / PW, SB = (a.S16 + SW - 1) / SW;
  const int c = blockIdx.x / (PB * SB), pb = blockIdx.x / SB % PB, sb = blockIdx.x % SB;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (a.H / a.G);
  const int p0 = pb * PW, s0 = sb * SW, c0 = c * CHUNK;
  const int n = min(CHUNK, a.L - c0);  // valid tokens of the chunk
  const int tiles = (n + ROWS - 1) / ROWS;
  const int pw = min(PW, (a.P - p0 + 15) / 16 * 16), sw = min(SW, a.S16 - s0);
  const long long xs = (long long)a.H * a.P, bs = (long long)a.G * a.S;
  const bf16* x0 = a.x + ((long long)(b * a.L + c0) * a.H + h) * a.P + p0;
  const bf16* b0 = a.Bm + ((long long)(b * a.L + c0) * a.G + g) * a.S + s0;
  auto load = [&](int i, int st) {
    load_tile<STATE_THREADS>(Xs + st * ROWS * LDP, LDP, x0 + i * ROWS * xs, xs, n - i * ROWS,
                             a.P - p0, pw, a.x_vec, tid);
    load_tile<STATE_THREADS>(Bs + st * ROWS * LDW, LDW, b0 + i * ROWS * bs, bs, n - i * ROWS,
                             a.S - s0, sw, a.bc_vec, tid);
  };
  load(0, 0);
  cp_commit();
  if (warp == 0)
    chunk_cumsum(a.dt + (long long)(b * a.L + c0) * a.H + h, a.H, n, a.A[h], cum, dts, lane);
  __syncthreads();
  const float last = cum[CHUNK - 1];  // padding adds 0: the chunk's total
  for (int t = tid; t < CHUNK; t += STATE_THREADS)
    w[t] = LOCAL ? expf(cum[t]) : expf(last - cum[t]) * dts[t];
  if (!LOCAL && pb == 0 && sb == 0 && tid == 0)
    a.decay[(long long)(b * a.H + h) * a.nc + c] = expf(last);
  if (LOCAL && pb == 0 && sb == 0)
    for (int t = tid; t < CHUNK; t += STATE_THREADS) {
      float* cd = a.decay + ((long long)(b * a.H + h) * a.nc + c) * 2 * CHUNK;
      cd[t] = cum[t];
      cd[CHUNK + t] = dts[t];
    }

  // warp: rows [16 warp, 16 warp + 16) of the block's P columns by all its S
  // columns (16 n-tiles of 8); X ⊙ w is the A operand (X read transposed)
  float acc[SW / 8][4] = {};
  const int pairs = sw / 16;
  const bool active = p0 + 16 * warp < a.P;
  const int q2 = 2 * (lane & 3);
  const uint32_t xa =
      smem_u32(Xs + ((lane >> 4) * 8 + (lane & 7)) * LDP + 16 * warp + ((lane >> 3) & 1) * 8);
  const uint32_t ba = smem_u32(Bs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDW + (lane >> 4) * 8);
  constexpr uint32_t XST = ROWS * LDP * sizeof(bf16), BST = ROWS * LDW * sizeof(bf16);
  for (int i = 0; i < tiles; ++i) {
    const int st = STAGES > 1 ? (i & 1) : 0;
    if (STAGES > 1 && i + 1 < tiles) load(i + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();  // tile i has landed
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
        uint32_t xr[4];
        Split3 xw;
        ldsm_x4_t(xr, xa + st * XST + kk * 16 * LDP * sizeof(bf16));
        const int t = i * ROWS + kk * 16 + q2;
        const float2 w0 = *reinterpret_cast<const float2*>(w + t);
        const float2 w1 = *reinterpret_cast<const float2*>(w + t + 8);
        scale_split3(xr[0], w0, xw, 0);
        scale_split3(xr[1], w0, xw, 1);
        scale_split3(xr[2], w1, xw, 2);
        scale_split3(xr[3], w1, xw, 3);
#pragma unroll
        for (int j = 0; j < SW / 16; ++j) {
          if (j >= pairs) break;
          uint32_t bv[4];
          ldsm_x4_t(bv, ba + st * BST + kk * 16 * LDW * sizeof(bf16) + j * 32);
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            mma_bf16(acc[2 * j], xw.part[part], bv[0], bv[1]);
            mma_bf16(acc[2 * j + 1], xw.part[part], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  if (!active) return;
  float* out = a.states + (long long)((b * a.H + h) * a.nc + c) * a.P * a.S16 + s0;
  const int p = p0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int nt = 0; nt < SW / 8; ++nt) {
    if (nt >= 2 * pairs) break;
    const int col = 8 * nt + q2;
    if (p < a.P)
      *reinterpret_cast<float2*>(out + (long long)p * a.S16 + col) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (p + 8 < a.P)
      *reinterpret_cast<float2*>(out + (long long)(p + 8) * a.S16 + col) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- 2. the state pass: h <- exp(cum_last_c) h + states_c, chunk by chunk --
__global__ void __launch_bounds__(PASS_THREADS)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                  const float* __restrict__ h0, float* __restrict__ hT, int H, int P, int S,
                  int S16, int nc) {
  const long long ps = (long long)P * S16;
  const int i = blockIdx.x * PASS_THREADS + threadIdx.x;  // element [p][k] of [P, S16]
  if (i >= ps) return;
  const int p = i / S16, k = i % S16;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  float h = h0 != nullptr && k < S ? h0[(bh * P + p) * S + k] : 0.f;
  float* st = states + bh * nc * ps + i;
  const float* dec = decay + bh * nc;
  // eight chunks' loads in flight at a time: the stores in place keep the
  // compiler from moving a load above them
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = c0 + u < nc ? st[(c0 + u) * ps] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u >= nc) break;
      st[(c0 + u) * ps] = h;  // the state before chunk c0 + u
      h = __fadd_rn(__fmul_rn(h, dec[c0 + u]), v[u]);  // h * decay + state, as plain rounds
    }
  }
  if (k < S) hT[(bh * P + p) * S + k] = h;
}

// ---- 3. chunk outputs: y = exp(cum_t) (C h_inᵀ) + M X ---------------------
__global__ void __launch_bounds__(OUTPUT_THREADS) chunk_output_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lds = a.S16 + 8;  // row stride (bf16) of the C and B tiles
  const uint32_t row_bytes = lds * sizeof(bf16);
  bf16* Cs = reinterpret_cast<bf16*>(smem);  // [ROWS][lds]: C of the row block
  bf16* Bs = Cs + ROWS * lds;                // [ROWS][lds]: B of a column tile
  bf16* Xs = Bs + ROWS * lds;                // [ROWS][LDP]: x of a column tile
  float* Ys = reinterpret_cast<float*>(Bs);  // [ROWS][LDY]: before the first column tile
  float* cum = reinterpret_cast<float*>(smem + output_smem_bytes(a.S16)) - 2 * CHUNK;
  float* dts = cum + CHUNK;

  constexpr int RB = CHUNK / ROWS;  // row blocks of a chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int PB = (a.P + PW - 1) / PW;
  const int c = blockIdx.x / (RB * PB), j = blockIdx.x / PB % RB, pb = blockIdx.x % PB;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (a.H / a.G);
  const int c0 = c * CHUNK, r0 = c0 + j * ROWS, p0 = pb * PW;
  if (r0 >= a.L) return;
  const int n = min(CHUNK, a.L - c0);  // valid tokens of the chunk
  const int pw = min(PW, (a.P - p0 + 15) / 16 * 16);
  const long long xs = (long long)a.H * a.P, bs = (long long)a.G * a.S;
  const bf16* x0 = a.x + ((long long)(b * a.L + c0) * a.H + h) * a.P + p0;
  const bf16* b0 = a.Bm + ((long long)(b * a.L + c0) * a.G + g) * a.S;
  load_tile<OUTPUT_THREADS>(Cs, lds, a.Cm + ((long long)(b * a.L + r0) * a.G + g) * a.S, bs,
                            a.L - r0, a.S, a.S16, a.bc_vec, tid);
  cp_commit();
  if (warp == 0)
    chunk_cumsum(a.dt + (long long)(b * a.L + c0) * a.H + h, a.H, n, a.A[h], cum, dts, lane);

  const int q2 = 2 * (lane & 3), ksteps = a.S16 / 16, dpairs = pw / 16;
  // ---- C h_inᵀ: warp w takes columns [16 w, 16 w + 16) of P over the 64
  // rows, its h_in rows straight from the scratch as f32 B fragments, split
  // in three once; exp(cum_t) C h_inᵀ goes to Ys for the warps of the rows.
  // The first four k-steps' fragments load while C lands.
  const float* hg = a.states +
                    ((long long)((b * a.H + h) * a.nc + c) * a.P + p0 + 16 * warp + (lane >> 2)) *
                        a.S16 + q2;
  const bool row_ok[2] = {p0 + 16 * warp + (lane >> 2) < a.P,
                          p0 + 16 * warp + 8 + (lane >> 2) < a.P};
  float2 hv[4][2][2];  // [k-step][n-tile][k half]: loads all in flight together
  auto load_h = [&](int k0) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          hv[kk][u][e] = k0 + kk < ksteps && row_ok[u]
                             ? __ldg(reinterpret_cast<const float2*>(
                                   hg + 8LL * u * a.S16 + 16 * (k0 + kk) + 8 * e))
                             : make_float2(0.f, 0.f);
  };
  if (warp < dpairs) load_h(0);
  cp_wait<0>();  // C has landed
  __syncthreads();  // and the cumsum is written
  if (warp < dpairs) {
    float ya[ROWS / 16][2][4] = {};
    const uint32_t ca = smem_u32(Cs + (lane & 15) * lds + (lane >> 4) * 8);
    for (int k0 = 0; k0 < ksteps; k0 += 4) {
      if (k0 > 0) load_h(k0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (k0 + kk >= ksteps) break;
        uint32_t ar[ROWS / 16][4], hb[2][3][2];
#pragma unroll
        for (int mt = 0; mt < ROWS / 16; ++mt)
          ldsm_x4(ar[mt], ca + mt * 16 * row_bytes + (k0 + kk) * 32);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            split3(hv[kk][u][e].x, hv[kk][u][e].y, hb[u][0][e], hb[u][1][e], hb[u][2][e]);
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int mt = 0; mt < ROWS / 16; ++mt)
#pragma unroll
            for (int u = 0; u < 2; ++u) mma_bf16(ya[mt][u], ar[mt], hb[u][part][0], hb[u][part][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < ROWS / 16; ++mt) {
      const int r = 16 * mt + (lane >> 2);
      const float e0 = expf(cum[j * ROWS + r]), e1 = expf(cum[j * ROWS + r + 8]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float* y0 = Ys + r * LDY + 16 * warp + 8 * u + q2;
        *reinterpret_cast<float2*>(y0) = make_float2(ya[mt][u][0] * e0, ya[mt][u][1] * e0);
        *reinterpret_cast<float2*>(y0 + 8 * LDY) =
            make_float2(ya[mt][u][2] * e1, ya[mt][u][3] * e1);
      }
    }
  }
  __syncthreads();
  // warp: rows [16 warp, 16 warp + 16) of the row block, the block's P columns
  float acc[PW / 8][4];
  const int ta = j * ROWS + 16 * warp + (lane >> 2), tb = ta + 8;  // this thread's rows
  {
    const float* yr = Ys + (16 * warp + (lane >> 2)) * LDY + q2;
#pragma unroll
    for (int nt = 0; nt < PW / 8; ++nt) {
      float2 v0 = make_float2(0.f, 0.f), v1 = v0;
      if (nt < 2 * dpairs) {
        v0 = *reinterpret_cast<const float2*>(yr + 8 * nt);
        v1 = *reinterpret_cast<const float2*>(yr + 8 * LDY + 8 * nt);
      }
      acc[nt][0] = v0.x;
      acc[nt][1] = v0.y;
      acc[nt][2] = v1.x;
      acc[nt][3] = v1.y;
    }
  }
  __syncthreads();  // Ys is read before the first column tile is loaded over it

  // ldmatrix lane addresses: C as A (rows of the warp), B as B ([n][k]
  // rows), x as B transposed ([k][n] rows)
  const uint32_t ca = smem_u32(Cs + (16 * warp + (lane & 15)) * lds + (lane >> 4) * 8);
  const uint32_t ba =
      smem_u32(Bs) + ((lane >> 4) * 8 + (lane & 7)) * row_bytes + ((lane >> 3) & 1) * 16;
  const uint32_t xa = smem_u32(Xs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDP + (lane >> 4) * 8);

  // one stage: four blocks an SM overlap one block's loads with another's
  // products (a second stage measured slower, at three blocks an SM)
  for (int i = 0; i <= j; ++i) {  // column tile i: tokens [64 i, 64 i + 64) of the chunk
    load_tile<OUTPUT_THREADS>(Bs, lds, b0 + i * ROWS * bs, bs, n - i * ROWS, a.S, a.S16,
                              a.bc_vec, tid);
    load_tile<OUTPUT_THREADS>(Xs, LDP, x0 + i * ROWS * xs, xs, n - i * ROWS, a.P - p0, pw,
                              a.x_vec, tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // C Bᵀ over the column tile's n-tiles at or below the warp's rows
    const int nb_max = i < j ? ROWS / 8 : 2 * warp + 2;
    float cb[ROWS / 8][4] = {};
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t ar[4];
      ldsm_x4(ar, ca + kk * 32);
#pragma unroll
      for (int n2 = 0; n2 < ROWS / 16; ++n2) {
        if (2 * n2 >= nb_max) break;
        uint32_t bk[4];
        ldsm_x4(bk, ba + n2 * 16 * row_bytes + kk * 32);
        mma_bf16(cb[2 * n2], ar, bk[0], bk[1]);
        mma_bf16(cb[2 * n2 + 1], ar, bk[2], bk[3]);
      }
    }
    // M = C Bᵀ exp(cum_t - cum_s) dt_s for s <= t (masked before the exp; the
    // difference is taken before it is scaled to base 2), as A operands in
    // three parts; acc += M X
    constexpr float LOG2E = 1.4426950408889634f;
    const float cta = cum[ta], ctb = cum[tb];
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) {
      if (2 * kk >= nb_max) break;
      float m[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = i * ROWS + 16 * kk + 8 * u + q2;
        const float2 cs = *reinterpret_cast<const float2*>(cum + s);
        const float2 ds = *reinterpret_cast<const float2*>(dts + s);
        m[u][0] = s <= ta ? cb[2 * kk + u][0] * ex2((cta - cs.x) * LOG2E) * ds.x : 0.f;
        m[u][1] = s + 1 <= ta ? cb[2 * kk + u][1] * ex2((cta - cs.y) * LOG2E) * ds.y : 0.f;
        m[u][2] = s <= tb ? cb[2 * kk + u][2] * ex2((ctb - cs.x) * LOG2E) * ds.x : 0.f;
        m[u][3] = s + 1 <= tb ? cb[2 * kk + u][3] * ex2((ctb - cs.y) * LOG2E) * ds.y : 0.f;
      }
      Split3 ms;
      split3(m[0][0], m[0][1], ms.part[0][0], ms.part[1][0], ms.part[2][0]);
      split3(m[0][2], m[0][3], ms.part[0][1], ms.part[1][1], ms.part[2][1]);
      split3(m[1][0], m[1][1], ms.part[0][2], ms.part[1][2], ms.part[2][2]);
      split3(m[1][2], m[1][3], ms.part[0][3], ms.part[1][3], ms.part[2][3]);
#pragma unroll
      for (int d2 = 0; d2 < PW / 16; ++d2) {
        if (d2 >= dpairs) break;
        uint32_t bv[4];
        ldsm_x4_t(bv, xa + kk * 16 * LDP * sizeof(bf16) + d2 * 32);
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          mma_bf16(acc[2 * d2], ms.part[part], bv[0], bv[1]);
          mma_bf16(acc[2 * d2 + 1], ms.part[part], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the tile before it is refilled
  }

  // y rows ta and tb (chunk-relative), columns p0 + 8 nt + q2 (+ 1)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tok = c0 + (half ? tb : ta);
    if (tok >= a.L) continue;
    bf16* yr = a.y + ((long long)(b * a.L + tok) * a.H + h) * a.P;
#pragma unroll
    for (int nt = 0; nt < PW / 8; ++nt) {
      if (nt >= 2 * dpairs) break;
      const int p = p0 + 8 * nt + q2;
      const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
      if (a.P % 2 == 0) {
        if (p < a.P) *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (p < a.P) yr[p] = __float2bfloat16(v0);
        if (p + 1 < a.P) yr[p + 1] = __float2bfloat16(v1);
      }
    }
  }
}

int launch_bf16(const Args& a, int Bsz, cudaStream_t stream) {
  const size_t s1 = state_smem_bytes(), s3 = output_smem_bytes(a.S16);
  cudaError_t err = allow_smem(chunk_state_kernel<false>, s1);
  if (err == cudaSuccess) err = allow_smem(chunk_output_kernel, s3);
  if (err != cudaSuccess) return int(err);
  const int PB = (a.P + PW - 1) / PW, SB = (a.S16 + SW - 1) / SW;
  chunk_state_kernel<false><<<dim3(a.nc * PB * SB, a.H, Bsz), STATE_THREADS, s1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const long long ps = (long long)a.P * a.S16;
  state_pass_kernel<<<dim3(unsigned((ps + PASS_THREADS - 1) / PASS_THREADS), a.H, Bsz),
                      PASS_THREADS, 0, stream>>>(a.states, a.decay, a.h0, a.hT, a.H, a.P, a.S,
                                                 a.S16, a.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  chunk_output_kernel<<<dim3(a.nc * (CHUNK / ROWS) * PB, a.H, Bsz), OUTPUT_THREADS, s3,
                        stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace ssd
}  // namespace repro_torch

// h0 may be null (a zero initial state).  chunk is the reference's chunk
// length: the f32 body's chunk is min(chunk, 64).  bf16 runs in chunks of
// ssd::CHUNK tokens whatever `chunk` is, and needs the wrapper's scratch of
// scratch_floats floats, B x H x n_chunks x (P S16 + 1) with n_chunks =
// ceil(L / ssd::CHUNK); a launch whose counts differ is refused.
extern "C" int ssd_chunked_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                  const void* Cm, const void* h0, void* y, void* hT,
                                  void* scratch, long long scratch_floats, int Bsz, int L, int H,
                                  int P, int G, int S, int chunk, int n_chunks, int dtype,
                                  void* stream) {
  using namespace repro_torch;
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > 256 || S <= 0 ||
      S > 256 || chunk <= 0 || H > 65535 || Bsz > 65535)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    const int q = chunk < ssd::TQ ? chunk : ssd::TQ;
    return ssd::launch_f32(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<const float*>(h0), static_cast<float*>(y),
        static_cast<float*>(hT), Bsz, L, H, P, G, S, q, s);
  }
  if (dtype != DTYPE_BF16) return int(cudaErrorInvalidValue);
  const int nc = (L + ssd::CHUNK - 1) / ssd::CHUNK, S16 = (S + 15) / 16 * 16;
  const long long chunk_elems = (long long)Bsz * H * nc * P * S16;
  if (scratch == nullptr || n_chunks != nc ||
      scratch_floats != chunk_elems + (long long)Bsz * H * nc)
    return int(cudaErrorInvalidValue);
  ssd::Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.Bm = static_cast<const __nv_bfloat16*>(Bm);
  a.Cm = static_cast<const __nv_bfloat16*>(Cm);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.hT = static_cast<float*>(hT);
  a.states = static_cast<float*>(scratch);
  a.decay = a.states + chunk_elems;
  a.L = L;
  a.H = H;
  a.P = P;
  a.G = G;
  a.S = S;
  a.S16 = S16;
  a.nc = nc;
  a.x_vec = P % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.bc_vec = S % 8 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  return ssd::launch_bf16(a, Bsz, s);
}
