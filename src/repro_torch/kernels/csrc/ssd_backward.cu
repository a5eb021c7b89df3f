// The backward of the Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// It belongs to the Pallas kernel `ssd_chunked` of the JAX package
// (src/repro/kernels/ssd_scan.py:91) but replaces no Pallas kernel: the JAX
// package differentiates through its scan and has no backward kernel.  Per
// (batch b, head h, chunk c of CHUNK tokens from token 0), with cum the
// inclusive cumsum of a = dt A_h in the chunk, L[t,s] = exp(cum_t - cum_s)
// for s <= t, e_t = exp(cum_t), w_s = exp(cum_last - cum_s), h_in the state
// before the chunk and dh_out the gradient of the state after it:
//
//   dh_in = exp(cum_last) dh_out + Σ_t e_t dy_t ⊗ C_t       (reverse chunk order)
//   dx_s  = dt_s [Σ_t (C_t·B_s) L[t,s] dy_t + w_s dh_out B_s]
//   dC_t  = Σ_s L[t,s] dt_s (dy_t·x_s) B_s + e_t dy_tᵀ h_in   (summed over a group's heads)
//   dB_s  = dt_s [Σ_t L[t,s] (dy_t·x_s) C_t + w_s dh_outᵀ x_s] (summed over a group's heads)
//   d dt_s = Σ_t (C_t·B_s) L[t,s] (dy_t·x_s) + w_s x_s·(dh_out B_s) + da_s A_h
//
// where da is the reverse cumsum in the chunk of dcum: rowsum(W) - colsum(W)
// (W = dM ⊙ M, M[t,s] = (C_t·B_s) L[t,s] dt_s, dM[t,s] = dy_t·x_s), plus
// dy_t·y_off_t (y_off_t = e_t h_in C_t), minus u_s = w_s dt_s x_s·(dh_out
// B_s) at s, plus Σ_s u_s + exp(cum_last) <dh_out, h_in> at the last token;
// dA_h = Σ da ⊙ dt over the batch and the tokens.  The plain version
// (ssd_scan.ssd_chunked_bwd_plain) writes the same equations in PyTorch.
//
// What bounds it on the H100: operations.  At mamba2-1.3b's training shape
// in chip_smoke.py (B 2, L 2,048, H 64, P 64, S 128, G 1) it reads x, dy, B,
// C, dt once and writes dx, dB, dC, d dt once (~3 MB of bf16 a layer, ~0.001
// ms at 3.35 TB/s), but the chunked backward at CHUNK = 128 is ~34.5 GFLOP
// (the causal half of C Bᵀ, and of dY Xᵀ, Mᵀ dY, dM B and dMᵀ C per head, a
// chunk; five [P, S] products a token and head: the rebuilt state, the local
// dh term, dh_out B, dY h_in and X dh_out; dy_t·y_off_t needs no sixth, as
// it equals C_t·(e_t dy_tᵀ h_in), the dC term's product): ~0.035 ms at the
// bf16 tensor-core peak, ~0.52 ms at the f32 CUDA-core peak.  This kernel
// still forms y_off itself (one more [P, S] product a token).  This first
// version runs every product on the CUDA cores in f32 (both dtypes), which
// keeps it simple and exact to f32 rounding; its own chunk products come to
// ~12.6 M multiply-adds a (batch, head, chunk).
// A tensor-core version is later work (ROADMAP queue B).
//
// Kernels, in stream order (no atomics, so two launches give the same bits):
//
//  1. The states before each chunk, rebuilt rather than saved by the
//     forward (saving would hold B x H x chunks x P x S16 f32 a layer, ~134
//     MB at the training shape, through the whole forward): bf16 runs the
//     forward's own chunk_state_kernel (tensor cores) and state_pass_kernel
//     (ssd_scan.cu, included below); f32 runs chunk_state_f32 (CUDA cores)
//     and the same state pass.
//  2. dlocal_kernel, grid (chunks x P tiles x S tiles, H, B): each chunk's
//     Σ_t e_t dy_t ⊗ C_t into a second [P, S16] scratch per chunk.
//  3. reverse_pass_kernel, grid (P·S16 / 256, H, B): elementwise in reverse
//     chunk order from dhT (or zero), replacing each chunk's local term by
//     its dh_out in place and writing dh0, the first chunk's dh_in.
//  4. chunk_grad_kernel, grid (chunks, H, B): the chunk's C Bᵀ and dY Xᵀ by
//     64 x 64 tiles at or below the diagonal, with M's and dM's masked,
//     decayed values written to scratch (the dx and dB/dC products read them
//     back), rowsum/colsum of W and the direct d dt sum reduced in smem in
//     tile order; then y_off's dot with dy, dx (its two products) and
//     x·(dh_out B); then <dh_out, h_in>, the chunk's dcum, its reverse
//     cumsum (one warp), d dt and the chunk's dA term.
//  5. dbdc_kernel, grid (chunks x 2 row tiles x S tiles x {dB, dC}, G, B):
//     one block walks its group's heads in head order, so dB and dC need no
//     per-head partials and no atomics.  The other choice, f32 per-head
//     partials [B, L, H, S] and a reduce (as flash_backward.cu's dK/dV), would
//     write and read 2 x 134 MB at mamba2's training shape (G 1, 64 heads);
//     walking the heads costs nothing but parallelism, and the grid still
//     holds 256 blocks there (jamba's H 128, P 128, S 16, G 1 at B 2 x
//     2,048: 64).
//  6. dA_reduce_kernel: each head's chunk terms summed in (batch, chunk)
//     order.
//
// Every product is a 64 x 64 output tile on 256 threads (4 x 4 outputs a
// thread) over k-steps of 16 staged in shared memory, the next step's
// operands loaded into registers while the current one is multiplied; the
// operands come through small loaders that widen bf16 to f32 and fold in
// the per-token factors (dt, e, w), zero past the valid tokens and widths.
// chunk_grad_kernel and dbdc_kernel are held to 128 registers (two blocks
// an SM; left alone they took 222 and 177, one block an SM): at mamba2's
// heads, B 2 x 2,048, the launch fell from 5.04 to 3.62 ms with the same
// bits (a few bytes of spills), at jamba's it moved from 7.38 to 7.53.
//
// Scratch (f32, allocated by the wrapper, its size a function of the shapes
// alone; n = chunks, S16 = S rounded up to 16): states [B, H, n, P, S16],
// decay [B, H, n], dstates [B, H, n, P, S16], M [B, H, n, CHUNK, CHUNK], dM
// [B, H, n, CHUNK, CHUNK], e and w [B, H, n, 2, CHUNK], the dA terms [H, B,
// n]: ~0.40 GB at mamba2's training shape, freed after the launch.
//
// Layouts (all contiguous): x, dy, dx [B, L, H, P] and Bm, Cm, dB, dC [B, L,
// G, S] f32 or bf16 (one type); dt, ddt [B, L, H], A, dA [H], h0, dhT, dh0
// [B, H, P, S] f32.  h0 and dhT may be null (zero).  P <= 256, S <= 256,
// H % G == 0, L >= 1.

#include "ssd_scan.cu"

namespace repro_torch {
namespace ssd_bwd {
namespace {

using ssd::CHUNK;
using ssd::chunk_cumsum;

constexpr int TILE = 64;  // rows and columns of an output tile
constexpr int KS = 16;    // k-step of the tile products
constexpr int THREADS = 256;
constexpr int LDT = TILE + 4;  // row stride of the staged operands
constexpr int PER = TILE * KS / THREADS;  // operand elements a thread stages a step (4)
constexpr int RT = CHUNK / TILE;          // row tiles of a chunk
constexpr int PASS_THREADS = 256;
constexpr unsigned ALL = 0xffffffffu;

struct Stage {
  float a[KS][LDT];  // a[k][r]: A(r, k)
  float b[KS][LDT];  // b[k][c]: B(k, c)
};

// The staged coordinates of element e of this thread: (row or column, k),
// k fastest when the operand is contiguous along k.
template <bool K_FAST>
__device__ __forceinline__ void coord(int e, int& rc, int& k) {
  const int i = threadIdx.x + THREADS * e;
  if (K_FAST) {
    k = i % KS;
    rc = i / KS;
  } else {
    rc = i % TILE;
    k = i / TILE;
  }
}

// acc[i][j] += Σ_{k in [k0, k1)} A(4 ty + i, k) B(k, 4 tx + j), ty = tid / 16,
// tx = tid % 16; la(r, k) and lb(k, c) return the operands (zero where they
// do not exist).  Every thread of the block calls it.
template <bool A_K_FAST, bool B_K_FAST, class LA, class LB>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], int k0, int k1, LA la, LB lb,
                                             Stage& st) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float ra[PER], rb[PER];
  auto fetch = [&](int kb) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      int r, k, c, kk;
      coord<A_K_FAST>(e, r, k);
      coord<B_K_FAST>(e, c, kk);
      ra[e] = kb + k < k1 ? la(r, kb + k) : 0.f;
      rb[e] = kb + kk < k1 ? lb(kb + kk, c) : 0.f;
    }
  };
  if (k0 < k1) fetch(k0);
  for (int kb = k0; kb < k1; kb += KS) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      int r, k, c, kk;
      coord<A_K_FAST>(e, r, k);
      coord<B_K_FAST>(e, c, kk);
      st.a[k][r] = ra[e];
      st.b[kk][c] = rb[e];
    }
    __syncthreads();
    if (kb + KS < k1) fetch(kb + KS);  // in flight while this step multiplies
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&st.a[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&st.b[k][4 * tx]);
      const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// The sum of x over the 16 threads of a tile row (lanes that share tid / 16),
// in a fixed order
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(ALL, x, o);
  return x;
}

struct Args {
  const void *x, *Bm, *Cm, *dy;
  const float *dt, *A, *h0, *dhT;
  void *dx, *dB, *dC;
  float *ddt, *dA, *dh0;
  float *states, *decay, *dstates, *M, *dM, *ew, *dA_part;
  int Bsz, L, H, P, G, S, S16, nc;
};

// ---- 1 (f32). chunk states: states_c[p][s] = Σ_t x_t[p] w_t dt_t B_t[s] -----
template <typename T>
__global__ void __launch_bounds__(THREADS) chunk_state_f32(const Args a) {
  __shared__ __align__(16) Stage st;
  __shared__ float cum[CHUNK], dts[CHUNK], wt[CHUNK];
  const int tid = threadIdx.x, lane = tid & 31;
  const int PB = (a.P + TILE - 1) / TILE, KB = (a.S16 + TILE - 1) / TILE;
  const int c = blockIdx.x / (PB * KB), p0 = blockIdx.x / KB % PB * TILE,
            s0 = blockIdx.x % KB * TILE;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (a.H / a.G), c0 = c * CHUNK;
  const int n = min(CHUNK, a.L - c0);
  if (tid < 32)
    chunk_cumsum(a.dt + (long long)(b * a.L + c0) * a.H + h, a.H, n, a.A[h], cum, dts, lane);
  __syncthreads();
  const float last = cum[CHUNK - 1];
  for (int t = tid; t < CHUNK; t += THREADS) wt[t] = expf(last - cum[t]) * dts[t];
  const long long bh = (long long)b * a.H + h;
  if (p0 == 0 && s0 == 0 && tid == 0) a.decay[bh * a.nc + c] = expf(last);
  __syncthreads();
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  float acc[4][4];
  zero(acc);
  tile_product<false, false>(
      acc, 0, n,
      [&](int r, int t) {
        return p0 + r < a.P
                   ? to_float(x[((long long)(b * a.L + c0 + t) * a.H + h) * a.P + p0 + r]) * wt[t]
                   : 0.f;
      },
      [&](int t, int cc) {
        return s0 + cc < a.S ? to_float(Bm[((long long)(b * a.L + c0 + t) * a.G + g) * a.S + s0 + cc])
                             : 0.f;
      },
      st);
  float* out = a.states + (bh * a.nc + c) * a.P * a.S16;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + 4 * ty + i, s = s0 + 4 * tx + j;
      if (p < a.P && s < a.S16) out[(long long)p * a.S16 + s] = acc[i][j];
    }
}

// ---- 2. each chunk's local dh_in term: Σ_t e_t dy_t ⊗ C_t --------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) dlocal_kernel(const Args a) {
  __shared__ __align__(16) Stage st;
  __shared__ float cum[CHUNK], dts[CHUNK], et[CHUNK];
  const int tid = threadIdx.x, lane = tid & 31;
  const int PB = (a.P + TILE - 1) / TILE, KB = (a.S16 + TILE - 1) / TILE;
  const int c = blockIdx.x / (PB * KB), p0 = blockIdx.x / KB % PB * TILE,
            s0 = blockIdx.x % KB * TILE;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (a.H / a.G), c0 = c * CHUNK;
  const int n = min(CHUNK, a.L - c0);
  if (tid < 32)
    chunk_cumsum(a.dt + (long long)(b * a.L + c0) * a.H + h, a.H, n, a.A[h], cum, dts, lane);
  __syncthreads();
  for (int t = tid; t < CHUNK; t += THREADS) et[t] = expf(cum[t]);
  __syncthreads();
  const T* dy = static_cast<const T*>(a.dy);
  const T* Cm = static_cast<const T*>(a.Cm);
  float acc[4][4];
  zero(acc);
  tile_product<false, false>(
      acc, 0, n,
      [&](int r, int t) {
        return p0 + r < a.P
                   ? to_float(dy[((long long)(b * a.L + c0 + t) * a.H + h) * a.P + p0 + r]) * et[t]
                   : 0.f;
      },
      [&](int t, int cc) {
        return s0 + cc < a.S ? to_float(Cm[((long long)(b * a.L + c0 + t) * a.G + g) * a.S + s0 + cc])
                             : 0.f;
      },
      st);
  float* out = a.dstates + (((long long)b * a.H + h) * a.nc + c) * a.P * a.S16;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + 4 * ty + i, s = s0 + 4 * tx + j;
      if (p < a.P && s < a.S16) out[(long long)p * a.S16 + s] = acc[i][j];
    }
}

// ---- 3. the reverse state pass: dh_out_c in place of the local terms ---------
__global__ void __launch_bounds__(PASS_THREADS) reverse_pass_kernel(const Args a) {
  const long long ps = (long long)a.P * a.S16;
  const int i = blockIdx.x * PASS_THREADS + threadIdx.x;  // element [p][k] of [P, S16]
  if (i >= ps) return;
  const int p = i / a.S16, k = i % a.S16;
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  float g = a.dhT != nullptr && k < a.S ? a.dhT[(bh * a.P + p) * a.S + k] : 0.f;
  float* ds = a.dstates + bh * a.nc * ps + i;
  const float* dec = a.decay + bh * a.nc;
  for (int c1 = a.nc; c1 > 0; c1 -= 8) {  // eight chunks' loads in flight
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = c1 - 1 - u >= 0 ? ds[(c1 - 1 - u) * ps] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c1 - 1 - u;
      if (c < 0) break;
      ds[c * ps] = g;  // the gradient of the state after chunk c
      g = __fadd_rn(__fmul_rn(g, dec[c]), v[u]);
    }
  }
  if (k < a.S) a.dh0[(bh * a.P + p) * a.S + k] = g;
}

// ---- 4. a chunk's gradients of x, dt and its dA term ------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) chunk_grad_kernel(const Args a) {
  __shared__ __align__(16) Stage st;
  __shared__ float cum[CHUNK], dts[CHUNK], et[CHUNK], wt[CHUNK];
  __shared__ float rs[CHUNK], cs[CHUNK], qs[CHUNK], ro[CHUNK], vs[CHUNK];
  __shared__ float red[2][16][TILE];
  __shared__ float warp_part[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid / 16, tx = tid % 16;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / (a.H / a.G);
  const int c0 = c * CHUNK, n = min(CHUNK, a.L - c0);
  const long long bh = (long long)b * a.H + h, bhc = bh * a.nc + c;
  if (tid < 32)
    chunk_cumsum(a.dt + (long long)(b * a.L + c0) * a.H + h, a.H, n, a.A[h], cum, dts, lane);
  __syncthreads();
  const float last = cum[CHUNK - 1];
  for (int t = tid; t < CHUNK; t += THREADS) {
    et[t] = expf(cum[t]);
    wt[t] = expf(last - cum[t]);
    rs[t] = cs[t] = qs[t] = ro[t] = vs[t] = 0.f;
    a.ew[bhc * 2 * CHUNK + t] = et[t];
    a.ew[bhc * 2 * CHUNK + CHUNK + t] = wt[t];
  }
  __syncthreads();

  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  auto xat = [&](int t, int p) {  // x of token t of the chunk, column p (t < n, p < P)
    return to_float(x[((long long)(b * a.L + c0 + t) * a.H + h) * a.P + p]);
  };
  auto dyat = [&](int t, int p) {
    return to_float(dy[((long long)(b * a.L + c0 + t) * a.H + h) * a.P + p]);
  };
  auto bat = [&](int t, int k) {
    return to_float(Bm[((long long)(b * a.L + c0 + t) * a.G + g) * a.S + k]);
  };
  auto cat = [&](int t, int k) {
    return to_float(Cm[((long long)(b * a.L + c0 + t) * a.G + g) * a.S + k]);
  };
  float* M = a.M + bhc * CHUNK * CHUNK;
  float* dM = a.dM + bhc * CHUNK * CHUNK;
  const float* hin = a.states + bhc * a.P * a.S16;
  const float* dhout = a.dstates + bhc * a.P * a.S16;
  const int PB = (a.P + TILE - 1) / TILE;

  // ---- C Bᵀ and dY Xᵀ by tiles at or below the diagonal -----------------
  for (int i = 0; i < RT; ++i) {
    if (i * TILE >= n) break;
    for (int j = 0; j <= i; ++j) {
      float cb[4][4], dm[4][4];
      zero(cb);
      zero(dm);
      tile_product<true, true>(
          cb, 0, a.S,
          [&](int r, int k) { return i * TILE + r < n ? cat(i * TILE + r, k) : 0.f; },
          [&](int k, int cc) { return j * TILE + cc < n ? bat(j * TILE + cc, k) : 0.f; }, st);
      tile_product<true, true>(
          dm, 0, a.P,
          [&](int r, int k) { return i * TILE + r < n ? dyat(i * TILE + r, k) : 0.f; },
          [&](int k, int cc) { return j * TILE + cc < n ? xat(j * TILE + cc, k) : 0.f; }, st);
      float rsum[4] = {}, csum[4] = {}, qsum[4] = {};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int t = i * TILE + 4 * ty + ii, s = j * TILE + 4 * tx + jj;
          const bool keep = s <= t && t < n;
          const float l = keep ? expf(cum[t] - cum[s]) : 0.f;
          const float mv = cb[ii][jj] * l;  // (C_t·B_s) L[t,s]
          const float qv = dm[ii][jj] * mv;
          const float wv = qv * dts[s];  // W[t,s]
          M[t * CHUNK + s] = mv;
          dM[t * CHUNK + s] = dm[ii][jj] * l;
          rsum[ii] += wv;
          csum[jj] += wv;
          qsum[jj] += qv;
        }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float v = row_sum16(rsum[ii]);
        if (tx == 0) rs[i * TILE + 4 * ty + ii] += v;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        red[0][ty][4 * tx + jj] = csum[jj];
        red[1][ty][4 * tx + jj] = qsum[jj];
      }
      __syncthreads();
      if (tid < TILE) {
        float sc = 0.f, sq = 0.f;
        for (int y = 0; y < 16; ++y) {
          sc += red[0][y][tid];
          sq += red[1][y][tid];
        }
        cs[j * TILE + tid] += sc;
        qs[j * TILE + tid] += sq;
      }
      __syncthreads();
    }
  }

  // ---- dy_t · (C_t h_inᵀ) -------------------------------------------------
  for (int i = 0; i < RT; ++i) {
    if (i * TILE >= n) break;
    for (int pb = 0; pb < PB; ++pb) {
      const int p0 = pb * TILE;
      float acc[4][4];
      zero(acc);
      tile_product<true, true>(
          acc, 0, a.S,
          [&](int r, int k) { return i * TILE + r < n ? cat(i * TILE + r, k) : 0.f; },
          [&](int k, int cc) {
            return p0 + cc < a.P ? hin[(long long)(p0 + cc) * a.S16 + k] : 0.f;
          },
          st);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int t = i * TILE + 4 * ty + ii;
        float d = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int p = p0 + 4 * tx + jj;
          if (t < n && p < a.P) d += acc[ii][jj] * dyat(t, p);
        }
        d = row_sum16(d);
        if (tx == 0) ro[t] += d;
      }
    }
  }
  __syncthreads();  // M and dM are written (global, read back by this block)

  // ---- dx = dt_s (Mᵀ dY + w_s B dh_outᵀ), and x_s · (w_s dh_out B_s) ------
  T* dx = static_cast<T*>(a.dx);
  for (int j = 0; j < RT; ++j) {
    if (j * TILE >= n) break;
    for (int pb = 0; pb < PB; ++pb) {
      const int p0 = pb * TILE;
      float acc[4][4], z[4][4];
      zero(acc);
      zero(z);
      tile_product<false, false>(
          acc, j * TILE, n, [&](int r, int t) { return M[t * CHUNK + j * TILE + r]; },
          [&](int t, int cc) { return p0 + cc < a.P ? dyat(t, p0 + cc) : 0.f; }, st);
      tile_product<true, true>(
          z, 0, a.S,
          [&](int r, int k) { return j * TILE + r < n ? bat(j * TILE + r, k) : 0.f; },
          [&](int k, int cc) {
            return p0 + cc < a.P ? dhout[(long long)(p0 + cc) * a.S16 + k] : 0.f;
          },
          st);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int s = j * TILE + 4 * ty + ii;
        float d = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int p = p0 + 4 * tx + jj;
          if (s < n && p < a.P) {
            const float zv = wt[s] * z[ii][jj];
            dx[((long long)(b * a.L + c0 + s) * a.H + h) * a.P + p] =
                from_float<T>(dts[s] * (acc[ii][jj] + zv));
            d += xat(s, p) * zv;
          }
        }
        d = row_sum16(d);
        if (tx == 0) vs[s] += d;
      }
    }
  }

  // ---- <dh_out, h_in> ---------------------------------------------------
  float hd = 0.f;
  for (long long e = tid; e < (long long)a.P * a.S16; e += THREADS) hd += dhout[e] * hin[e];
  hd = warp_sum(hd);
  if (lane == 0) warp_part[warp] = hd;
  __syncthreads();

  // ---- dcum, its reverse cumsum in the chunk, d dt and the dA term (warp 0)
  if (warp == 0) {
    float tot = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) tot += warp_part[w];
    constexpr int E = CHUNK / 32;
    float u[E], dc[E];
    float usum = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = E * lane + e;
      u[e] = dts[t] * vs[t];
      dc[e] = rs[t] - cs[t] + et[t] * ro[t] - u[e];
      usum += u[e];
    }
    usum = warp_sum(usum);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (E * lane + e == n - 1) dc[e] += usum + expf(last) * tot;
    // da_t = Σ_{t' >= t} dcum_t': the lane's own suffix, then the lanes above
    float run[E], s = 0.f;
#pragma unroll
    for (int e = E - 1; e >= 0; --e) {
      s += dc[e];
      run[e] = s;
    }
    float scan = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float dn = __shfl_down_sync(ALL, scan, o);
      if (lane + o < 32) scan += dn;
    }
    const float dn = __shfl_down_sync(ALL, scan, 1);
    const float after = lane < 31 ? dn : 0.f;
    const float Ah = a.A[h];
    float da_dt = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = E * lane + e;
      const float da = after + run[e];
      if (t < n) a.ddt[(long long)(b * a.L + c0 + t) * a.H + h] = qs[t] + vs[t] + da * Ah;
      da_dt += da * dts[t];
    }
    da_dt = warp_sum(da_dt);
    if (lane == 0) a.dA_part[((long long)h * a.Bsz + b) * a.nc + c] = da_dt;
  }
}

// ---- 5. dB and dC, summed over the group's heads in head order --------------
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) dbdc_kernel(const Args a) {
  __shared__ __align__(16) Stage st;
  __shared__ float dts[CHUNK], et[CHUNK], wt[CHUNK];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int KB = (a.S16 + TILE - 1) / TILE;
  const int which = blockIdx.x % 2;  // 0: dC (rows t), 1: dB (rows s)
  const int kb = blockIdx.x / 2 % KB, i = blockIdx.x / (2 * KB) % RT, c = blockIdx.x / (2 * KB * RT);
  const int g = blockIdx.y, b = blockIdx.z, rep = a.H / a.G;
  const int c0 = c * CHUNK, n = min(CHUNK, a.L - c0), k0 = kb * TILE, r0 = i * TILE;
  if (r0 >= n) return;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  float acc[4][4];
  zero(acc);
  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    const long long bhc = ((long long)b * a.H + h) * a.nc + c;
    __syncthreads();  // the previous head's vectors are read
    for (int t = tid; t < CHUNK; t += THREADS) {
      dts[t] = t < n ? a.dt[(long long)(b * a.L + c0 + t) * a.H + h] : 0.f;
      et[t] = a.ew[bhc * 2 * CHUNK + t];
      wt[t] = a.ew[bhc * 2 * CHUNK + CHUNK + t];
    }
    __syncthreads();
    const float* M = a.dM + bhc * CHUNK * CHUNK;  // dM ⊙ L
    const float* hin = a.states + bhc * a.P * a.S16;
    const float* dhout = a.dstates + bhc * a.P * a.S16;
    auto gcol = [&](const T* m, int t, int cc) {  // B or C of token t, column k0 + cc
      return k0 + cc < a.S ? to_float(m[((long long)(b * a.L + c0 + t) * a.G + g) * a.S + k0 + cc])
                           : 0.f;
    };
    if (which == 0) {
      // dC_t = Σ_s (dM ⊙ L)[t,s] dt_s B_s + e_t dy_tᵀ h_in
      tile_product<true, false>(
          acc, 0, min(r0 + TILE, n),
          [&](int r, int s) { return r0 + r < n ? M[(r0 + r) * CHUNK + s] * dts[s] : 0.f; },
          [&](int s, int cc) { return gcol(Bm, s, cc); }, st);
      tile_product<true, false>(
          acc, 0, a.P,
          [&](int r, int p) {
            const int t = r0 + r;
            return t < n ? to_float(dy[((long long)(b * a.L + c0 + t) * a.H + h) * a.P + p]) * et[t]
                         : 0.f;
          },
          [&](int p, int cc) { return k0 + cc < a.S16 ? hin[(long long)p * a.S16 + k0 + cc] : 0.f; },
          st);
    } else {
      // dB_s = dt_s [Σ_t (dM ⊙ L)[t,s] C_t + w_s dh_outᵀ x_s]
      tile_product<false, false>(
          acc, r0, n, [&](int r, int t) { return dts[r0 + r] * M[t * CHUNK + r0 + r]; },
          [&](int t, int cc) { return gcol(Cm, t, cc); }, st);
      tile_product<true, false>(
          acc, 0, a.P,
          [&](int r, int p) {
            const int s = r0 + r;
            return s < n ? to_float(x[((long long)(b * a.L + c0 + s) * a.H + h) * a.P + p]) *
                               dts[s] * wt[s]
                         : 0.f;
          },
          [&](int p, int cc) {
            return k0 + cc < a.S16 ? dhout[(long long)p * a.S16 + k0 + cc] : 0.f;
          },
          st);
    }
  }
  T* out = static_cast<T*>(which == 0 ? a.dC : a.dB);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int t = r0 + 4 * ty + ii, k = k0 + 4 * tx + jj;
      if (t < n && k < a.S)
        out[((long long)(b * a.L + c0 + t) * a.G + g) * a.S + k] = from_float<T>(acc[ii][jj]);
    }
}

// ---- 6. dA_h = Σ over (batch, chunk) of the chunks' terms, in order ---------
__global__ void dA_reduce_kernel(const Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  float s = 0.f;
  const float* part = a.dA_part + (long long)h * a.Bsz * a.nc;
  for (long long i = 0; i < (long long)a.Bsz * a.nc; ++i) s += part[i];
  a.dA[h] = s;
}

template <typename T>
int launch_rest(const Args& a, cudaStream_t stream) {
  const int PB = (a.P + TILE - 1) / TILE, KB = (a.S16 + TILE - 1) / TILE;
  cudaError_t err;
  dlocal_kernel<T><<<dim3(a.nc * PB * KB, a.H, a.Bsz), THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const long long ps = (long long)a.P * a.S16;
  reverse_pass_kernel<<<dim3(unsigned((ps + PASS_THREADS - 1) / PASS_THREADS), a.H, a.Bsz),
                        PASS_THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  chunk_grad_kernel<T><<<dim3(a.nc, a.H, a.Bsz), THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  dbdc_kernel<T><<<dim3(a.nc * RT * KB * 2, a.G, a.Bsz), THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  dA_reduce_kernel<<<(a.H + 127) / 128, 128, 0, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace ssd_bwd
}  // namespace repro_torch

// h0 and dhT may be null (zero).  The scratch holds scratch_floats floats
// (ssd_backward.scratch_floats: the layout in the header) for n_chunks =
// ceil(L / ssd::CHUNK); a launch whose counts differ is refused.  dh0 is
// written whether or not h0 is given.
extern "C" int ssd_chunked_bwd_launch(const void* x, const void* dt, const void* A,
                                      const void* Bm, const void* Cm, const void* h0,
                                      const void* dy, const void* dhT, void* dx, void* ddt,
                                      void* dA, void* dB, void* dC, void* dh0, void* scratch,
                                      long long scratch_floats, int Bsz, int L, int H, int P,
                                      int G, int S, int n_chunks, int dtype, void* stream) {
  using namespace repro_torch;
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > 256 || S <= 0 ||
      S > 256 || H > 65535 || Bsz > 65535 || scratch == nullptr)
    return int(cudaErrorInvalidValue);
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return int(cudaErrorInvalidValue);
  const int nc = (L + ssd::CHUNK - 1) / ssd::CHUNK, S16 = (S + 15) / 16 * 16;
  const long long bhn = (long long)Bsz * H * nc, ce = bhn * P * S16,
                  qq = bhn * ssd::CHUNK * ssd::CHUNK;
  if (n_chunks != nc || scratch_floats != 2 * ce + 2 * qq + bhn * (2 * ssd::CHUNK + 2))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_bwd::Args a;
  a.x = x;
  a.Bm = Bm;
  a.Cm = Cm;
  a.dy = dy;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.h0 = static_cast<const float*>(h0);
  a.dhT = static_cast<const float*>(dhT);
  a.dx = dx;
  a.dB = dB;
  a.dC = dC;
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dh0 = static_cast<float*>(dh0);
  float* f = static_cast<float*>(scratch);
  a.states = f;
  a.decay = a.states + ce;
  a.dstates = a.decay + bhn;
  a.M = a.dstates + ce;
  a.dM = a.M + qq;
  a.ew = a.dM + qq;
  a.dA_part = a.ew + bhn * 2 * ssd::CHUNK;
  a.Bsz = Bsz;
  a.L = L;
  a.H = H;
  a.P = P;
  a.G = G;
  a.S = S;
  a.S16 = S16;
  a.nc = nc;

  // 1. the states before each chunk; the state pass's final state goes to
  // dh0, which the reverse pass overwrites later in stream order
  const int PB = (P + ssd_bwd::TILE - 1) / ssd_bwd::TILE;
  const int KB = (S16 + ssd_bwd::TILE - 1) / ssd_bwd::TILE;
  cudaError_t err;
  if (dtype == DTYPE_BF16) {
    ssd::Args f1;
    f1.x = static_cast<const __nv_bfloat16*>(x);
    f1.Bm = static_cast<const __nv_bfloat16*>(Bm);
    f1.Cm = static_cast<const __nv_bfloat16*>(Cm);
    f1.dt = a.dt;
    f1.A = a.A;
    f1.h0 = a.h0;
    f1.y = nullptr;
    f1.hT = a.dh0;
    f1.states = a.states;
    f1.decay = a.decay;
    f1.L = L;
    f1.H = H;
    f1.P = P;
    f1.G = G;
    f1.S = S;
    f1.S16 = S16;
    f1.nc = nc;
    f1.x_vec = P % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    f1.bc_vec = S % 8 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
    const size_t s1 = ssd::state_smem_bytes();
    if ((err = allow_smem(ssd::chunk_state_kernel, s1)) != cudaSuccess) return int(err);
    const int FPB = (P + ssd::PW - 1) / ssd::PW, FSB = (S16 + ssd::SW - 1) / ssd::SW;
    ssd::chunk_state_kernel<<<dim3(nc * FPB * FSB, H, Bsz), ssd::STATE_THREADS, s1, s>>>(f1);
  } else {
    ssd_bwd::chunk_state_f32<float><<<dim3(nc * PB * KB, H, Bsz), ssd_bwd::THREADS, 0, s>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const long long ps = (long long)P * S16;
  ssd::state_pass_kernel<<<dim3(unsigned((ps + ssd::PASS_THREADS - 1) / ssd::PASS_THREADS), H,
                                Bsz),
                           ssd::PASS_THREADS, 0, s>>>(a.states, a.decay, a.h0, a.dh0, H, P, S,
                                                      S16, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  return dtype == DTYPE_BF16 ? ssd_bwd::launch_rest<__nv_bfloat16>(a, s)
                             : ssd_bwd::launch_rest<float>(a, s);
}
