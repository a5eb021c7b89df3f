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
// bf16 tensor-core peak, ~0.52 ms at the f32 CUDA-core peak.
//
// The first version ran every product on the CUDA cores in f32 (an f32
// launch still does: below), 3.62-3.67 ms at that shape, 105x the bound: 64
// x 64 tiles on 256 threads whose operands came one widened scalar at a
// time, the masked, decayed M and dM written to ~268 MB of f32 scratch and
// read back for dx, dB and dC, a sixth product for y_off, and dB/dC blocks
// (chunk, row tile, column tile, group) that each walked all of a group's
// heads: 256 blocks at G 1, 64 at jamba's heads.
//
// A bf16 launch runs every chunk product on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate, operands through ldmatrix from shared
// tiles that arrive by cp.async), with the fragment layouts of the
// forward's chunk_output_kernel.  x, dy, B and C are bf16, so C Bᵀ and dY
// Xᵀ are exact products summed in f32.  The f32 operands enter as two bf16
// parts, hi = bf16(v) and lo = bf16(v - hi) (~2^-17 |v|): the masked,
// decayed scores (the A operand of dx's, dB's and dC's products, taken from
// the score accumulators in registers) and the states h_in, dh_out (split
// once per block into shared tiles of both parts, read by ldmatrix).  Two
// parts, not the forward's three: tests/test_torch_ssd_bwd_numerics.py
// redoes this arithmetic on the CPU and holds it within half of the card's
// gates (bf16 dx, dB, dC within 2^-7 of max|·|, every f32 output within
// 1e-4); one part for the scores moves dx, dB and dC past that half, one
// for the states moves d dt (whose terms cancel) past it ten times over.
// The local dh term runs through the forward's chunk_state_kernel with
// three parts.  M and dM never leave the chip: each kernel recomputes the
// scores it needs (C Bᵀ and dY Xᵀ cost 2·CHUNK²·(S + P)/2 operations a chunk
// and head, far less than the 268 MB they replace).  The sixth product is
// gone: the dB/dC blocks, which form dy_tᵀ h_in for dC anyway, also take
// its dot with C_t.  At the training shape the launch reads 0.82 ms on the
// H100 (PERF.md row 11): the scores' 16 x 16 blocks, their two-part
// products and the loads between them keep it at ~23x the bound.
//
// Kernels of a bf16 launch, in stream order (no atomics, so two launches
// give the same bits):
//
//  1. The states before each chunk, rebuilt rather than saved by the
//     forward (saving would hold B x H x chunks x P x S16 f32 a layer, ~134
//     MB at the training shape, through the whole forward): the forward's
//     own chunk_state_kernel and state_pass_kernel (ssd_scan.cu, included
//     below).
//  2. chunk_state_kernel<LOCAL>: each chunk's Σ_t e_t dy_t ⊗ C_t, and the
//     chunk's cum and dt for the kernels below.
//  3. reverse_pass_kernel, grid (P·S16 / 256, H, B): elementwise in reverse
//     chunk order from dhT (or zero), replacing each chunk's local term by
//     its dh_out in place and writing dh0, the first chunk's dh_in.
//  4. x_grad_kernel, grid (chunks x 2 row blocks of 64 tokens s x P tiles
//     of 64, H, B), 4 warps of 16 rows: dh_out B_s (the P tile's dh_out split
//     in shared memory first), then per 64-token column tile at or after the
//     row block, (C Bᵀ)ᵀ (and, in the first P tile's blocks, (dY Xᵀ)ᵀ) by
//     16 x 16 blocks at or above the diagonal, M'ᵀ = (C Bᵀ)ᵀ ⊙ L in
//     registers and dx += M'ᵀ dY; writes dx, and the d dt terms q_s = Σ_t
//     M'[t,s] dM[t,s], v_s (per P tile), W's row sums (per row block) and
//     <dh_out, h_in> (per P tile) to the scratch.
//  5. bc_grad_kernel, grid (chunks x S tiles of 64, G x slices of HEADS
//     heads, B), 8 warps: a block walks its slice's heads in order; warp w
//     takes rows [16 w, 16 w + 16) of the chunk both as dB's tokens s (score
//     blocks of t >= s: 8 - w) and as dC's tokens t (blocks of s <= t: w +
//     1), nine a warp whatever w; per head the init terms (dB: X dh_out, dC:
//     dY h_in, the states split in shared memory once for the block) and the
//     scores ((dY Xᵀ)ᵀ ⊙ L ⊙ dt_s and dY Xᵀ ⊙ L ⊙ dt_s) times the tiles of C
//     and B, summed into registers; writes the slice's partial f32 sums,
//     and dy_t·y_off_t per (head, S tile).  Slices give dB and dC the
//     parallelism of H / G / HEADS heads at small G (a chunk and batch row
//     get 2 S tiles x 8 slices at mamba2's training shape, 1 x 16 at
//     jamba's) with no atomics and no per-head partials; at S 16 a tile is
//     one 16-column pair.
//  6. dt_grad_kernel, grid (chunks, H, B), one warp: the chunk's dcum from
//     the terms, its reverse cumsum, d dt and the dA term.
//  7. bc_reduce_kernel: dB and dC, the slices summed in slice order.
//  8. dA_reduce_kernel: each head's chunk terms summed in (batch, chunk)
//     order.
//
// An f32 launch keeps the first version's CUDA-core kernels and their bits
// (chunk_state_f32, dlocal_kernel, reverse_pass_kernel, chunk_grad_kernel,
// dbdc_kernel, dA_reduce_kernel): every product a 64 x 64 output tile on
// 256 threads (4 x 4 outputs a thread) over k-steps of 16 staged in shared
// memory, M and dM through the scratch, dB and dC blocks walking all of a
// group's heads.  chunk_grad_kernel and dbdc_kernel are held to 128
// registers (two blocks an SM).
//
// Scratch (f32, allocated by the wrapper, its size a function of the shapes
// and the dtype alone; n = chunks, S16 = S rounded up to 16, P16 = P rounded
// up to 16).  bf16: states [B, H, n, P, S16], dstates [B, H, n, P, S16], cum
// and dt [B, H, n, 2, CHUNK], the d dt terms [B, H, n, 4 + P16/64 + S16/64,
// CHUNK], the slices' dB and dC partials [slices, B, L, G, S] each, decay [B,
// H, n], the dA terms [H, B, n]: 0.176 GB at mamba2's training shape (8
// slices).  f32: states, decay, dstates, M [B, H, n, CHUNK, CHUNK], dM
// [B, H, n, CHUNK, CHUNK], e and w [B, H, n, 2, CHUNK], the dA terms: 0.405
// GB there.  Freed after the launch.
//
// Layouts (all contiguous): x, dy, dx [B, L, H, P] and Bm, Cm, dB, dC [B, L,
// G, S] f32 or bf16 (one type); dt, ddt [B, L, H], A, dA [H], h0, dhT, dh0
// [B, H, P, S] f32.  h0 and dhT may be null (zero).  P <= 256, S <= 256,
// H % G == 0, L >= 1.

#include "ssd_scan.cu"

namespace repro_torch {
namespace ssd_bwd {
namespace {

// --------------------------------------------------------------------------
// f32: the CUDA-core kernels
// --------------------------------------------------------------------------

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
  // bf16 only: cum and dt, the d dt terms, the slices' dB and dC partials
  float *cd, *terms, *bpart, *cpart;
  int P16, PB, KT, nsl, n_terms;
  int x_vec, dy_vec, bc_vec;  // rows of x / dy / B and C are 16-byte aligned
};

// ---- 1 (f32). chunk states: states_c[p][s] = Σ_t x_t[p] w_t dt_t B_t[s] -----
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
  const float* x = static_cast<const float*>(a.x);
  const float* Bm = static_cast<const float*>(a.Bm);
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

// ---- 2 (f32). each chunk's local dh_in term: Σ_t e_t dy_t ⊗ C_t --------------
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
  const float* dy = static_cast<const float*>(a.dy);
  const float* Cm = static_cast<const float*>(a.Cm);
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

// ---- 3 (both). the reverse state pass: dh_out_c in place of the local terms --
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

// ---- 4 (f32). a chunk's gradients of x, dt and its dA term ------------------
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

  const float* x = static_cast<const float*>(a.x);
  const float* dy = static_cast<const float*>(a.dy);
  const float* Bm = static_cast<const float*>(a.Bm);
  const float* Cm = static_cast<const float*>(a.Cm);
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
  float* dx = static_cast<float*>(a.dx);
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
                (dts[s] * (acc[ii][jj] + zv));
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

// ---- 5 (f32). dB and dC, summed over the group's heads in head order --------
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
  const float* x = static_cast<const float*>(a.x);
  const float* dy = static_cast<const float*>(a.dy);
  const float* Bm = static_cast<const float*>(a.Bm);
  const float* Cm = static_cast<const float*>(a.Cm);
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
    auto gcol = [&](const float* m, int t, int cc) {  // B or C of token t, column k0 + cc
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
  float* out = static_cast<float*>(which == 0 ? a.dC : a.dB);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int t = r0 + 4 * ty + ii, k = k0 + 4 * tx + jj;
      if (t < n && k < a.S)
        out[((long long)(b * a.L + c0 + t) * a.G + g) * a.S + k] = (acc[ii][jj]);
    }
}

// ---- dA_h = Σ over (batch, chunk) of the chunks' terms, in order (both dtypes)
__global__ void dA_reduce_kernel(const Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  float s = 0.f;
  const float* part = a.dA_part + (long long)h * a.Bsz * a.nc;
  for (long long i = 0; i < (long long)a.Bsz * a.nc; ++i) s += part[i];
  a.dA[h] = s;
}

// 2-6 of an f32 launch
int launch_f32(const Args& a, cudaStream_t stream) {
  const int PB = (a.P + TILE - 1) / TILE, KB = (a.S16 + TILE - 1) / TILE;
  cudaError_t err;
  dlocal_kernel<<<dim3(a.nc * PB * KB, a.H, a.Bsz), THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const long long ps = (long long)a.P * a.S16;
  reverse_pass_kernel<<<dim3(unsigned((ps + PASS_THREADS - 1) / PASS_THREADS), a.H, a.Bsz),
                        PASS_THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  chunk_grad_kernel<<<dim3(a.nc, a.H, a.Bsz), THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  dbdc_kernel<<<dim3(a.nc * RT * KB * 2, a.G, a.Bsz), THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  dA_reduce_kernel<<<(a.H + 127) / 128, 128, 0, stream>>>(a);
  return int(cudaGetLastError());
}


// --------------------------------------------------------------------------
// bf16: the chunk products on the tensor cores
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using ssd::load_tile;
using ssd::PW;    // columns of P an x_grad_kernel block owns (64)
using ssd::ROWS;  // tokens of a row block or column tile (64)
constexpr int KW = 64;           // columns of S a bc_grad_kernel block owns
constexpr int IC = 32;           // ... of which its init term takes at a time
constexpr int PC = 64;           // rows of P of the state tile it splits at a time
constexpr int BB = 4;            // ... its float4 loads in flight a thread
constexpr int HEADS = 8;         // heads of a slice (ssd_backward.SLICE_HEADS)
constexpr int XG_THREADS = 128;  // x_grad_kernel: 4 warps of 16 rows
constexpr int BC_THREADS = 256;  // bc_grad_kernel: 8 warps of 16 rows
constexpr float LOG2E = 1.4426950408889634f;
// the d dt terms of a (batch, head, chunk), CHUNK floats each: W's row sums
// from row blocks 0 and 1, q, <dh_out, h_in> per P tile (in its first PB
// floats), then v per P tile, then dy·y_off per S tile
constexpr int T_ROWW = 0, T_Q = 2, T_HD = 3, T_V = 4;

// The A operand (16 x 16) of a score block held as two 16 x 8 accumulators,
// in two bf16 parts (rows r and r + 8 of the accumulators are a[0]/a[2] and
// a[1]/a[3] of the fragment)
struct Split2 {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ void score_operand(const float (&m)[2][4], Split2& a) {
  split_bf16(m[0][0], m[0][1], a.hi[0], a.lo[0]);
  split_bf16(m[0][2], m[0][3], a.hi[1], a.lo[1]);
  split_bf16(m[1][0], m[1][1], a.hi[2], a.lo[2]);
  split_bf16(m[1][2], m[1][3], a.hi[3], a.lo[3]);
}

// acc[2 d2 + (0, 1)] += A · (the two n-tiles of pair d2), both parts; the
// mma's issued back to back go to different accumulators
__device__ __forceinline__ void mma_parts(float (&a0)[4], float (&a1)[4], const Split2& a,
                                          const uint32_t (&bv)[4]) {
  mma_bf16(a0, a.hi, bv[0], bv[1]);
  mma_bf16(a1, a.hi, bv[2], bv[3]);
  mma_bf16(a0, a.lo, bv[0], bv[1]);
  mma_bf16(a1, a.lo, bv[2], bv[3]);
}

// v in two bf16 parts at hi[0..3] and lo[0..3] (8-byte aligned)
__device__ __forceinline__ void store_parts(float4 v, bf16* hi, bf16* lo) {
  uint2 h, l;
  split_bf16(v.x, v.y, h.x, l.x);
  split_bf16(v.z, v.w, h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

// Rows [0, CHUNK) of a chunk's matrix into `dst` as two load_tile calls;
// zeros past `rows` rows (row 0 of src is always a valid address)
template <int THREADS_>
__device__ __forceinline__ void load_chunk(bf16* dst, int ld, const bf16* src, long long stride,
                                           int rows, int cols, int width, bool vec, int tid) {
  load_tile<THREADS_>(dst, ld, src, stride, rows, cols, width, vec, tid);
  load_tile<THREADS_>(dst + ROWS * ld, ld, rows > ROWS ? src + ROWS * stride : src, stride,
                      rows - ROWS, cols, width, vec, tid);
}

// x_grad_kernel: B and x of the row block, then the C and dy tiles of the
// tokens t or (before them) the P tile's dh_out in two parts, then cum, dt
// and the warps' column sums
__host__ __device__ inline size_t xg_union_bytes(int S16, int P16) {
  const int lds = S16 + 8, ldx = P16 + 8;
  return sizeof(bf16) * size_t(ROWS) * (lds + ldx > 2 * lds ? lds + ldx : 2 * lds);
}
__host__ inline size_t xg_smem_bytes(int S16, int P16) {
  return sizeof(bf16) * size_t(ROWS) * (S16 + 8 + P16 + 8) + xg_union_bytes(S16, P16) +
         sizeof(float) * (2 * CHUNK + (XG_THREADS / 32) * ROWS);
}
// bc_grad_kernel: the tiles of C and B [CHUNK][kw + 8] each, the two states'
// tiles in two parts [2][2][PC][kw + 8], then a head's stage: x, dy
// [CHUNK][P16 + 8], cum, dt.  One stage: at the models' shapes a second
// would leave one block an SM, and a layout that let the next head's stage
// share the states' room measured slower (PERF.md).
__host__ __device__ inline size_t bc_fixed_bytes(int kw) {
  return sizeof(bf16) * size_t(2 * CHUNK + 4 * PC) * (kw + 8);
}
__host__ inline size_t bc_smem_bytes(int P16, int kw) {
  return bc_fixed_bytes(kw) + sizeof(bf16) * size_t(2 * CHUNK) * (P16 + 8) +
         sizeof(float) * 2 * CHUNK;
}

// ---- 4. dx and the d dt terms of a row block's tokens s ---------------------
__global__ void __launch_bounds__(XG_THREADS) x_grad_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lds = a.S16 + 8, ldx = a.P16 + 8;
  bf16* Bs = reinterpret_cast<bf16*>(smem);  // [ROWS][lds]: B of the row block's tokens s
  bf16* Xs = Bs + ROWS * lds;                // [ROWS][ldx]: x of the tokens s
  bf16* Cs = Xs + ROWS * ldx;                // [ROWS][lds]: C of a column tile's tokens t
  bf16* Ys = Cs + ROWS * lds;                // [ROWS][ldx]: dy of the tokens t
  bf16* Hs = Cs;  // [2][PW][lds]: before the tiles, the P tile's dh_out in two parts
  float* cum = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Cs) +
                                        xg_union_bytes(a.S16, a.P16));  // [CHUNK]
  float* dts = cum + CHUNK;                                // [CHUNK]
  float* red = dts + CHUNK;  // [warps][ROWS]: each warp's column sums of W

  constexpr int RB = CHUNK / ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q2 = 2 * (lane & 3);
  const int c = blockIdx.x / (RB * a.PB), j = blockIdx.x / a.PB % RB, pb = blockIdx.x % a.PB;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (a.H / a.G);
  const int c0 = c * CHUNK, s0 = j * ROWS, p0 = pb * PW;
  if (c0 + s0 >= a.L) return;
  const int n = min(CHUNK, a.L - c0);  // valid tokens of the chunk
  const int dpairs = min(PW, a.P16 - p0) / 16;
  const bool first = pb == 0;  // the first P tile's blocks also take dY Xᵀ and the d dt sums
  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  const long long xs = (long long)a.H * a.P, bs = (long long)a.G * a.S;
  const bf16* x0 = static_cast<const bf16*>(a.x) + ((long long)(b * a.L + c0) * a.H + h) * a.P;
  const bf16* dy0 = static_cast<const bf16*>(a.dy) + ((long long)(b * a.L + c0) * a.H + h) * a.P;
  const bf16* b0 = static_cast<const bf16*>(a.Bm) + ((long long)(b * a.L + c0) * a.G + g) * a.S;
  const bf16* cc0 = static_cast<const bf16*>(a.Cm) + ((long long)(b * a.L + c0) * a.G + g) * a.S;
  load_tile<XG_THREADS>(Bs, lds, b0 + s0 * bs, bs, n - s0, a.S, a.S16, a.bc_vec, tid);
  load_tile<XG_THREADS>(Xs, ldx, x0 + s0 * xs, xs, n - s0, a.P, a.P16, a.x_vec, tid);
  for (int i = tid; i < CHUNK / 2; i += XG_THREADS)  // cum and dt (chunk_state_kernel<true>'s)
    cp_async16(smem_u32(cum + 4 * i), a.cd + bhc * 2 * CHUNK + 4 * i, 16);
  cp_commit();
  const int ra = 16 * warp + (lane >> 2), rb = ra + 8;  // this thread's rows of the row block
  const int sa = s0 + ra, sb = s0 + rb;                 // ... as tokens of the chunk
  const uint32_t row_bytes = lds * sizeof(bf16), xrow_bytes = ldx * sizeof(bf16);
  // ldmatrix lane addresses: B and x rows of the warp as A; C and dy rows t
  // as B ([n][k] rows); dy as B transposed ([k][n] rows, the P tile's columns)
  const uint32_t bA = smem_u32(Bs + (16 * warp + (lane & 15)) * lds + (lane >> 4) * 8);
  const uint32_t xA = smem_u32(Xs + (16 * warp + (lane & 15)) * ldx + (lane >> 4) * 8);
  const uint32_t cB = smem_u32(Cs) + ((lane >> 4) * 8 + (lane & 7)) * row_bytes + ((lane >> 3) & 1) * 16;
  const uint32_t yB = smem_u32(Ys) + ((lane >> 4) * 8 + (lane & 7)) * xrow_bytes + ((lane >> 3) & 1) * 16;
  const uint32_t yT = smem_u32(Ys + (((lane >> 3) & 1) * 8 + (lane & 7)) * ldx + (lane >> 4) * 8 + p0);

  // ---- the P tile's rows of dh_out in two parts (zero past P), split once
  // for the block (XB float4 loads in flight a thread); the first row
  // block also sums <dh_out, h_in> over them
  {
    constexpr int XB = 8;
    const float* dh = a.dstates + (bhc * a.P + p0) * a.S16;
    const float* hin = a.states + (bhc * a.P + p0) * a.S16;
    const int q4 = a.S16 / 4, rows = min(PW, a.P - p0);
    float hd = 0.f;
    for (int i0 = 0; i0 < PW * q4; i0 += XB * XG_THREADS) {
      float4 v[XB], u[XB];
#pragma unroll
      for (int e = 0; e < XB; ++e) {
        const int i = i0 + e * XG_THREADS + tid, r = i / q4, k = 4 * (i % q4);
        const bool ok = i < PW * q4 && r < rows;
        v[e] = ok ? __ldg(reinterpret_cast<const float4*>(dh + (long long)r * a.S16 + k))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        u[e] = ok && j == 0 ? __ldg(reinterpret_cast<const float4*>(hin + (long long)r * a.S16 + k))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int e = 0; e < XB; ++e) {
        const int i = i0 + e * XG_THREADS + tid, r = i / q4, k = 4 * (i % q4);
        if (i >= PW * q4) break;
        hd += v[e].x * u[e].x + v[e].y * u[e].y + v[e].z * u[e].z + v[e].w * u[e].w;
        store_parts(v[e], Hs + r * lds + k, Hs + (PW + r) * lds + k);
      }
    }
    if (j == 0) {
      hd = warp_sum(hd);
      if (lane == 0) red[warp] = hd;
    }
    cp_wait<0>();  // B, x, cum and dt have landed
    __syncthreads();
    if (j == 0 && tid == 0) {
      float t = 0.f;
      for (int w = 0; w < XG_THREADS / 32; ++w) t += red[w];
      a.terms[(bhc * a.n_terms + T_HD) * CHUNK + pb] = t;
    }
  }
  // ---- Z = B_s dh_outᵀ over the P tile
  float acc[PW / 8][4] = {};
  {
    const uint32_t hB = smem_u32(Hs) + ((lane >> 4) * 8 + (lane & 7)) * row_bytes + ((lane >> 3) & 1) * 16;
    const uint32_t lo = PW * row_bytes;  // the lo part's offset
    for (int kk = 0; kk < a.S16 / 16; ++kk) {
      uint32_t ar[4];
      ldsm_x4(ar, bA + kk * 32);
#pragma unroll
      for (int d2 = 0; d2 < PW / 16; ++d2) {
        if (d2 >= dpairs) break;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, hB + d2 * 16 * row_bytes + kk * 32);
        ldsm_x4(bl, hB + lo + d2 * 16 * row_bytes + kk * 32);
        mma_bf16(acc[2 * d2], ar, bh[0], bh[1]);
        mma_bf16(acc[2 * d2 + 1], ar, bh[2], bh[3]);
        mma_bf16(acc[2 * d2], ar, bl[0], bl[1]);
        mma_bf16(acc[2 * d2 + 1], ar, bl[2], bl[3]);
      }
    }
  }
  // ---- v_s = w_s x_s·Z_s over the tile (the tiles' sums added later); then
  // w_s Z_s starts dx's sum
  const float last = cum[CHUNK - 1];
  const float cum_a = cum[sa], cum_b = cum[sb], dta = dts[sa], dtb = dts[sb];
  {
    const float wa = expf(last - cum_a), wb = expf(last - cum_b);
    float va = 0.f, vb = 0.f;
#pragma unroll
    for (int nt = 0; nt < PW / 8; ++nt) {
      if (nt >= 2 * dpairs) break;
      const int col = p0 + 8 * nt + q2;
      const float2 xa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xs + ra * ldx + col));
      const float2 xb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xs + rb * ldx + col));
      va += xa.x * acc[nt][0] + xa.y * acc[nt][1];
      vb += xb.x * acc[nt][2] + xb.y * acc[nt][3];
      acc[nt][0] *= wa;
      acc[nt][1] *= wa;
      acc[nt][2] *= wb;
      acc[nt][3] *= wb;
    }
    va += __shfl_xor_sync(ALL, va, 1);
    va += __shfl_xor_sync(ALL, va, 2);
    vb += __shfl_xor_sync(ALL, vb, 1);
    vb += __shfl_xor_sync(ALL, vb, 2);
    float* v = a.terms + (bhc * a.n_terms + T_V + pb) * CHUNK;
    if ((lane & 3) == 0) {
      v[sa] = wa * va;
      v[sb] = wb * vb;
    }
  }
  __syncthreads();  // every warp is done with Hs before the tiles are loaded over it

  // ---- per column tile of tokens t at or after the row block: the scores by
  // 16 x 16 blocks at or above the diagonal, dx += M'ᵀ dY
  float qa = 0.f, qb = 0.f;
  for (int i = j; i < CHUNK / ROWS; ++i) {
    const int t0 = i * ROWS;
    if (t0 >= n) break;
    load_tile<XG_THREADS>(Cs, lds, cc0 + t0 * bs, bs, n - t0, a.S, a.S16, a.bc_vec, tid);
    load_tile<XG_THREADS>(Ys, ldx, dy0 + t0 * xs, xs, n - t0, a.P, a.P16, a.dy_vec, tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    for (int kt = 0; kt < ROWS / 16; ++kt) {
      float rw[2][2] = {};  // W's column sums over this thread's two rows
      if (i > j || kt >= warp) {
        float cb[2][4] = {}, dm[2][4] = {};  // (C Bᵀ)ᵀ, (dY Xᵀ)ᵀ: rows s, tokens t
        {  // over even and odd k-steps in two sums: two chains of mma's in flight
          float c2[2][4] = {};
          for (int kk = 0; kk < a.S16 / 16; kk += 2) {
            uint32_t ar[4], bk[4], ar2[4], bk2[4];
            ldsm_x4(ar, bA + kk * 32);
            ldsm_x4(bk, cB + kt * 16 * row_bytes + kk * 32);
            const bool two = kk + 1 < a.S16 / 16;
            if (two) {
              ldsm_x4(ar2, bA + (kk + 1) * 32);
              ldsm_x4(bk2, cB + kt * 16 * row_bytes + (kk + 1) * 32);
            }
            mma_bf16(cb[0], ar, bk[0], bk[1]);
            mma_bf16(cb[1], ar, bk[2], bk[3]);
            if (two) {
              mma_bf16(c2[0], ar2, bk2[0], bk2[1]);
              mma_bf16(c2[1], ar2, bk2[2], bk2[3]);
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) cb[u][e] += c2[u][e];
        }
        if (first)
          for (int kk = 0; kk < a.P16 / 16; ++kk) {
            uint32_t ar[4], bk[4];
            ldsm_x4(ar, xA + kk * 32);
            ldsm_x4(bk, yB + kt * 16 * xrow_bytes + kk * 32);
            mma_bf16(dm[0], ar, bk[0], bk[1]);
            mma_bf16(dm[1], ar, bk[2], bk[3]);
          }
        // M'ᵀ[s,t] = (C_t·B_s) L[t,s] for s <= t < n (masked before the exp;
        // the difference taken before it is scaled to base 2)
        float m[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = t0 + 16 * kt + 8 * u + q2 + (e & 1), s = e < 2 ? sa : sb;
            const float l = t >= s && t < n ? ex2((cum[t] - (e < 2 ? cum_a : cum_b)) * LOG2E) : 0.f;
            m[u][e] = cb[u][e] * l;
            const float qv = m[u][e] * dm[u][e];
            if (e < 2)
              qa += qv;
            else
              qb += qv;
            rw[u][e & 1] += qv * (e < 2 ? dta : dtb);
          }
        Split2 ms;
        score_operand(m, ms);
#pragma unroll
        for (int d2 = 0; d2 < PW / 16; ++d2) {
          if (d2 >= dpairs) break;
          uint32_t bv[4];
          ldsm_x4_t(bv, yT + kt * 16 * xrow_bytes + d2 * 32);
          mma_parts(acc[2 * d2], acc[2 * d2 + 1], ms, bv);
        }
      }
      if (first) {
        // over the warp's 16 rows: the lanes of one lane & 3 share columns
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = rw[u][e];
            v += __shfl_xor_sync(ALL, v, 4);
            v += __shfl_xor_sync(ALL, v, 8);
            v += __shfl_xor_sync(ALL, v, 16);
            if (lane < 4) red[warp * ROWS + 16 * kt + 8 * u + q2 + e] = v;
          }
      }
    }
    if (first) {
      __syncthreads();
      if (tid < ROWS) {
        float v = 0.f;
        for (int w = 0; w < XG_THREADS / 32; ++w) v += red[w * ROWS + tid];
        a.terms[(bhc * a.n_terms + T_ROWW + j) * CHUNK + t0 + tid] = v;
      }
    }
    __syncthreads();  // every warp is done with the tile before it is refilled
  }
  if (first) {
    qa += __shfl_xor_sync(ALL, qa, 1);
    qa += __shfl_xor_sync(ALL, qa, 2);
    qb += __shfl_xor_sync(ALL, qb, 1);
    qb += __shfl_xor_sync(ALL, qb, 2);
    float* q = a.terms + (bhc * a.n_terms + T_Q) * CHUNK;
    if ((lane & 3) == 0) {
      q[sa] = qa;
      q[sb] = qb;
    }
  }

  // ---- dx_s = dt_s (w_s Z_s + Σ_t M'[t,s] dy_t), rows sa and sb, columns
  // p0 + 8 nt + q2 (+ 1)
  bf16* dx = static_cast<bf16*>(a.dx);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = half ? sb : sa;
    if (s >= n) continue;
    const float d = half ? dtb : dta;
    bf16* xr = dx + ((long long)(b * a.L + c0 + s) * a.H + h) * a.P;
#pragma unroll
    for (int nt = 0; nt < PW / 8; ++nt) {
      if (nt >= 2 * dpairs) break;
      const int p = p0 + 8 * nt + q2;
      const float v0 = d * acc[nt][2 * half], v1 = d * acc[nt][2 * half + 1];
      if (a.P % 2 == 0) {
        if (p < a.P) *reinterpret_cast<__nv_bfloat162*>(xr + p) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (p < a.P) xr[p] = __float2bfloat16(v0);
        if (p + 1 < a.P) xr[p + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// ---- 5. one S tile of dB and dC over a slice of a group's heads ------------

// The init term of one output for the warp's rows, PC rows of P at a time: T
// = R state[p0:p0 + pr, tile] (the state's parts at hT, lo bytes apart), IC
// columns at a time; acc += f_row T.  YO (dC) also sums T's dot with C's
// tile (Gc) into ya, yb.
template <bool YO>
__device__ __forceinline__ void init_term(float (&acc)[KW / 8][4], uint32_t rA, uint32_t hT,
                                          uint32_t lo, uint32_t row_bytes, int p0, int pr,
                                          int kpairs, float fa, float fb, const bf16* Gc, int ldk,
                                          int ra, int rb, int q2, float& ya, float& yb) {
#pragma unroll
  for (int ic = 0; ic < KW / IC; ++ic) {
    if (ic * IC >= 16 * kpairs) break;
    float tmp[IC / 8][4] = {};
    for (int kk = 0; kk < pr / 16; ++kk) {
      uint32_t ar[4];
      ldsm_x4(ar, rA + (p0 / 16 + kk) * 32);
#pragma unroll
      for (int d2 = 0; d2 < IC / 16; ++d2) {
        if (ic * IC / 16 + d2 >= kpairs) break;
        uint32_t bh[4], bl[4];
        const uint32_t at = hT + kk * 16 * row_bytes + (ic * IC / 16 + d2) * 32;
        ldsm_x4_t(bh, at);
        ldsm_x4_t(bl, at + lo);
        mma_bf16(tmp[2 * d2], ar, bh[0], bh[1]);
        mma_bf16(tmp[2 * d2 + 1], ar, bh[2], bh[3]);
        mma_bf16(tmp[2 * d2], ar, bl[0], bl[1]);
        mma_bf16(tmp[2 * d2 + 1], ar, bl[2], bl[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < IC / 8; ++i) {
      const int nt = ic * IC / 8 + i;
      if (nt >= 2 * kpairs) break;
      acc[nt][0] += fa * tmp[i][0];
      acc[nt][1] += fa * tmp[i][1];
      acc[nt][2] += fb * tmp[i][2];
      acc[nt][3] += fb * tmp[i][3];
      if (YO) {
        const int col = 8 * nt + q2;
        const float2 ca = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Gc + ra * ldk + col));
        const float2 cb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Gc + rb * ldk + col));
        ya += ca.x * tmp[i][0] + ca.y * tmp[i][1];
        yb += cb.x * tmp[i][2] + cb.y * tmp[i][3];
      }
    }
  }
}

// Score blocks of 16 x 16 on the causal side of the warp's rows, times a
// tile: dB (rows s; blocks of tokens t >= s) acc += ((dY Xᵀ)ᵀ ⊙ L ⊙ dt_s) C,
// dC (rows t; blocks of s <= t) acc += (dY Xᵀ ⊙ L ⊙ dt_s) B.  rA: the rows'
// A operand (dB x, dC dy), qB: the other side as B, gT: the tile (C or B)
// as B transposed.
template <bool DB>
__device__ __forceinline__ void score_products(float (&acc)[KW / 8][4], uint32_t rA, uint32_t qB,
                                               uint32_t gT, uint32_t xrow_bytes,
                                               uint32_t row_bytes, int ksteps, int kpairs,
                                               const float* cum, const float* dts, int warp,
                                               int ra, int rb, int q2, int n) {
  const float cum_a = cum[ra], cum_b = cum[rb], dt_a = dts[ra], dt_b = dts[rb];
  for (int blk = DB ? warp : 0; blk < (DB ? CHUNK / 16 : warp + 1); ++blk) {
    if (16 * blk >= n) break;
    float sc[2][4] = {};
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t ar[4], bk[4];
      ldsm_x4(ar, rA + kk * 32);
      ldsm_x4(bk, qB + blk * 16 * xrow_bytes + kk * 32);
      mma_bf16(sc[0], ar, bk[0], bk[1]);
      mma_bf16(sc[1], ar, bk[2], bk[3]);
    }
    float m[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = 16 * blk + 8 * u + q2;
      const float2 cc = *reinterpret_cast<const float2*>(cum + col);
      const float2 dc = *reinterpret_cast<const float2*>(dts + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? ra : rb, cl = col + (e & 1);
        const float cr = e < 2 ? cum_a : cum_b, ccl = e & 1 ? cc.y : cc.x;
        // dB: s = r, t = cl; dC: t = r, s = cl
        const bool keep = DB ? r <= cl && cl < n : cl <= r && r < n;
        const float l = keep ? ex2((DB ? ccl - cr : cr - ccl) * LOG2E) : 0.f;
        m[u][e] = sc[u][e] * l * (DB ? (e < 2 ? dt_a : dt_b) : (e & 1 ? dc.y : dc.x));
      }
    }
    Split2 ms;
    score_operand(m, ms);
#pragma unroll
    for (int d2 = 0; d2 < KW / 16; ++d2) {
      if (d2 >= kpairs) break;
      uint32_t bv[4];
      ldsm_x4_t(bv, gT + blk * 16 * row_bytes + d2 * 32);
      mma_parts(acc[2 * d2], acc[2 * d2 + 1], ms, bv);
    }
  }
}

// Grid (chunks x S tiles, G x slices, B), 8 warps: warp w takes rows [16 w,
// 16 w + 16) of the chunk as dB's tokens s (score blocks w..7) and as dC's
// tokens t (blocks 0..w), nine blocks a warp.
__global__ void __launch_bounds__(BC_THREADS, 2) bc_grad_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q2 = 2 * (lane & 3);
  const int c = blockIdx.x / a.KT, kt = blockIdx.x % a.KT;
  const int g = blockIdx.y / a.nsl, sl = blockIdx.y % a.nsl, b = blockIdx.z;
  const int rep = a.H / a.G, h_lo = g * rep + sl * HEADS, h_hi = min(h_lo + HEADS, g * rep + rep);
  const int c0 = c * CHUNK, n = min(CHUNK, a.L - c0);
  const int k0 = kt * KW, kw = min(KW, a.S16 - k0), kpairs = kw / 16;
  const int ldk = kw + 8, ldx = a.P16 + 8;
  bf16* Gc = reinterpret_cast<bf16*>(smem);  // [CHUNK][ldk]: C's tile (dB's product, y_off)
  bf16* Gb = Gc + CHUNK * ldk;               // [CHUNK][ldk]: B's tile (dC's product)
  bf16* Hd = Gb + CHUNK * ldk;   // [2][PC][ldk]: PC rows of dh_out's tile in two parts
  bf16* Hh = Hd + 2 * PC * ldk;  // [2][PC][ldk]: ... of h_in's
  bf16* Xs = reinterpret_cast<bf16*>(smem + bc_fixed_bytes(kw));  // [CHUNK][ldx]: the head's x
  bf16* Ys = Xs + CHUNK * ldx;                                       // [CHUNK][ldx]: its dy
  float* cum = reinterpret_cast<float*>(Ys + CHUNK * ldx);           // [CHUNK]: its cum, dt
  const float* dts = cum + CHUNK;
  const long long xs = (long long)a.H * a.P, bs = (long long)a.G * a.S;
  const long long tok0 = (long long)b * a.L + c0;
  load_chunk<BC_THREADS>(Gc, ldk, static_cast<const bf16*>(a.Cm) + (tok0 * a.G + g) * a.S + k0, bs,
                         n, a.S - k0, kw, a.bc_vec, tid);
  load_chunk<BC_THREADS>(Gb, ldk, static_cast<const bf16*>(a.Bm) + (tok0 * a.G + g) * a.S + k0, bs,
                         n, a.S - k0, kw, a.bc_vec, tid);
  auto load_head = [&](int h) {
    load_chunk<BC_THREADS>(Xs, ldx, static_cast<const bf16*>(a.x) + (tok0 * a.H + h) * a.P, xs, n,
                           a.P, a.P16, a.x_vec, tid);
    load_chunk<BC_THREADS>(Ys, ldx, static_cast<const bf16*>(a.dy) + (tok0 * a.H + h) * a.P, xs,
                           n, a.P, a.P16, a.dy_vec, tid);
    const float* src = a.cd + (((long long)b * a.H + h) * a.nc + c) * 2 * CHUNK;
    for (int i = tid; i < CHUNK / 2; i += BC_THREADS) cp_async16(smem_u32(cum + 4 * i), src + 4 * i, 16);
    cp_commit();
  };
  load_head(h_lo);

  float accb[KW / 8][4] = {}, accc[KW / 8][4] = {};  // the slice's dB (rows s), dC (rows t)
  const int ra = 16 * warp + (lane >> 2), rb = ra + 8;  // this thread's rows of the chunk
  const bool live = 16 * warp < n;                       // the warp has valid rows
  const uint32_t row_bytes = ldk * sizeof(bf16), xrow_bytes = ldx * sizeof(bf16);
  // B transposed ([k][n] rows): the tiles of C and B (tokens by columns) and
  // the states' tiles (rows of P by columns)
  const uint32_t lane_t = ((((lane >> 3) & 1) * 8 + (lane & 7)) * ldk + (lane >> 4) * 8) * 2;
  const uint32_t cT = smem_u32(Gc) + lane_t, bT = smem_u32(Gb) + lane_t;
  const uint32_t dT = smem_u32(Hd) + lane_t, hT = smem_u32(Hh) + lane_t;
  const uint32_t lo = PC * row_bytes;  // the lo part's offset
  // the warp's rows of x and dy as A; x and dy as B ([n][k] rows)
  const uint32_t xA = smem_u32(Xs + (16 * warp + (lane & 15)) * ldx + (lane >> 4) * 8);
  const uint32_t yA = smem_u32(Ys + (16 * warp + (lane & 15)) * ldx + (lane >> 4) * 8);
  const uint32_t lane_b = ((lane >> 4) * 8 + (lane & 7)) * xrow_bytes + ((lane >> 3) & 1) * 16;
  const uint32_t xB = smem_u32(Xs) + lane_b, yB = smem_u32(Ys) + lane_b;
  for (int h = h_lo; h < h_hi; ++h) {
    cp_wait<0>();  // this head's stage has landed
    __syncthreads();
    const long long bhc = ((long long)b * a.H + h) * a.nc + c;
    const float last = cum[CHUNK - 1];
    // the init terms' row factors: dB dt_s w_s, dC e_t
    const float fba = dts[ra] * expf(last - cum[ra]), fbb = dts[rb] * expf(last - cum[rb]);
    const float fca = expf(cum[ra]), fcb = expf(cum[rb]);

    // ---- the init terms X dh_out (dB) and dY h_in (dC), PC rows of the states
    // at a time split in two parts once for the block (BB float4 loads in
    // flight a thread); dC also takes dy_t·y_off_t = e_t C_t·(dy_tᵀ h_in)
    const float* sd = a.dstates + bhc * a.P * a.S16 + k0;
    const float* sh = a.states + bhc * a.P * a.S16 + k0;
    float ya = 0.f, yb = 0.f, unused = 0.f;
    for (int p0 = 0; p0 < a.P16; p0 += PC) {
      const int pr = min(PC, a.P16 - p0), q4 = kw / 4, per = pr * q4;
      if (p0 > 0) __syncthreads();  // every warp is done with the previous rows
      for (int i0 = 0; i0 < 2 * per; i0 += BB * BC_THREADS) {
        float4 v[BB];
#pragma unroll
        for (int e = 0; e < BB; ++e) {
          const int i = i0 + e * BC_THREADS + tid, hh = i >= per, j = i - hh * per;
          const int r = j / q4, k = 4 * (j % q4);
          v[e] = i < 2 * per && p0 + r < a.P
                     ? __ldg(reinterpret_cast<const float4*>((hh ? sh : sd) +
                                                             (long long)(p0 + r) * a.S16 + k))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int e = 0; e < BB; ++e) {
          const int i = i0 + e * BC_THREADS + tid, hh = i >= per, j = i - hh * per;
          const int r = j / q4, k = 4 * (j % q4);
          if (i >= 2 * per) break;
          bf16* hp = hh ? Hh : Hd;
          store_parts(v[e], hp + r * ldk + k, hp + (PC + r) * ldk + k);
        }
      }
      __syncthreads();
      if (!live) continue;
      init_term<false>(accb, xA, dT, lo, row_bytes, p0, pr, kpairs, fba, fbb, Gc, ldk, ra, rb, q2,
                       unused, unused);
      init_term<true>(accc, yA, hT, lo, row_bytes, p0, pr, kpairs, fca, fcb, Gc, ldk, ra, rb, q2,
                      ya, yb);
    }
    if (live) {
      ya += __shfl_xor_sync(ALL, ya, 1);
      ya += __shfl_xor_sync(ALL, ya, 2);
      yb += __shfl_xor_sync(ALL, yb, 1);
      yb += __shfl_xor_sync(ALL, yb, 2);
      float* yo = a.terms + (bhc * a.n_terms + T_V + a.PB + kt) * CHUNK;
      if ((lane & 3) == 0) {
        yo[ra] = fca * ya;
        yo[rb] = fcb * yb;
      }
      score_products<true>(accb, xA, yB, cT, xrow_bytes, row_bytes, a.P16 / 16, kpairs, cum, dts,
                           warp, ra, rb, q2, n);
      score_products<false>(accc, yA, xB, bT, xrow_bytes, row_bytes, a.P16 / 16, kpairs, cum, dts,
                            warp, ra, rb, q2, n);
    }
    __syncthreads();  // every warp is done with the stage before it is refilled
    if (h + 1 < h_hi) load_head(h + 1);
  }

  // the slice's partial sums [slice, B, L, G, S], rows < n, columns < S
  if (!live) return;
  const long long base = ((long long)(sl * a.Bsz + b) * a.L + c0) * bs + g * a.S + k0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= n) continue;
#pragma unroll
    for (int nt = 0; nt < KW / 8; ++nt) {
      if (nt >= 2 * kpairs) break;
      const int col = 8 * nt + q2;
      const long long o = base + r * bs + col;
      if (k0 + col < a.S) {
        a.bpart[o] = accb[nt][2 * half];
        a.cpart[o] = accc[nt][2 * half];
      }
      if (k0 + col + 1 < a.S) {
        a.bpart[o + 1] = accb[nt][2 * half + 1];
        a.cpart[o + 1] = accc[nt][2 * half + 1];
      }
    }
  }
}

// ---- 6. a chunk's d dt and its dA term from the terms ------------------------
__global__ void __launch_bounds__(32) dt_grad_kernel(const Args a) {
  const int lane = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = min(CHUNK, a.L - c * CHUNK);
  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  const float* tm = a.terms + bhc * a.n_terms * CHUNK;
  float tot = 0.f;  // <dh_out, h_in>
  for (int pb = 0; pb < a.PB; ++pb) tot += tm[T_HD * CHUNK + pb];
  const float* cum = a.cd + bhc * 2 * CHUNK;
  const float* dts = cum + CHUNK;
  constexpr int E = CHUNK / 32;
  float q[E], v[E], dc[E], dt[E];
  float usum = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = E * lane + e;
    dt[e] = dts[t];
    q[e] = v[e] = dc[e] = 0.f;
    if (t < n) {
      q[e] = tm[T_Q * CHUNK + t];
      for (int pb = 0; pb < a.PB; ++pb) v[e] += tm[(T_V + pb) * CHUNK + t];
      float yo = 0.f;
      for (int k = 0; k < a.KT; ++k) yo += tm[(T_V + a.PB + k) * CHUNK + t];
      float rw = tm[T_ROWW * CHUNK + t];
      if (t >= ROWS) rw += tm[(T_ROWW + 1) * CHUNK + t];
      const float u = dt[e] * v[e];
      dc[e] = rw - dt[e] * q[e] + yo - u;  // W's column sum at t is dt_t q_t
      usum += u;
    }
  }
  usum = warp_sum(usum);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (E * lane + e == n - 1) dc[e] += usum + expf(cum[CHUNK - 1]) * tot;
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
    if (t < n) a.ddt[(long long)(b * a.L + c * CHUNK + t) * a.H + h] = q[e] + v[e] + da * Ah;
    da_dt += da * dt[e];
  }
  da_dt = warp_sum(da_dt);
  if (lane == 0) a.dA_part[((long long)h * a.Bsz + b) * a.nc + c] = da_dt;
}

// ---- 7. dB and dC: the slices' partial sums in slice order -------------------
__global__ void __launch_bounds__(256) bc_reduce_kernel(const Args a) {
  const long long N = (long long)a.Bsz * a.L * a.G * a.S;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= N) return;
  float sb = 0.f, sc = 0.f;
  for (int sl = 0; sl < a.nsl; ++sl) {
    sb += a.bpart[sl * N + i];
    sc += a.cpart[sl * N + i];
  }
  static_cast<bf16*>(a.dB)[i] = __float2bfloat16(sb);
  static_cast<bf16*>(a.dC)[i] = __float2bfloat16(sc);
}

int launch_bf16(const Args& a, cudaStream_t stream) {
  // 2. each chunk's local dh term: the chunk-state product over dy and C
  ssd::Args f;
  f.x = static_cast<const bf16*>(a.dy);
  f.Bm = static_cast<const bf16*>(a.Cm);
  f.Cm = nullptr;
  f.dt = a.dt;
  f.A = a.A;
  f.h0 = nullptr;
  f.y = nullptr;
  f.hT = nullptr;
  f.states = a.dstates;
  f.decay = a.cd;  // LOCAL writes each chunk's cum and dt there
  f.L = a.L;
  f.H = a.H;
  f.P = a.P;
  f.G = a.G;
  f.S = a.S;
  f.S16 = a.S16;
  f.nc = a.nc;
  f.x_vec = a.dy_vec;
  f.bc_vec = a.bc_vec;
  const size_t s1 = ssd::state_smem_bytes(), s4 = xg_smem_bytes(a.S16, a.P16),
               s5 = bc_smem_bytes(a.P16, min(KW, a.S16));
  cudaError_t err = allow_smem(ssd::chunk_state_kernel<true>, s1);
  if (err == cudaSuccess) err = allow_smem(x_grad_kernel, s4);
  if (err == cudaSuccess) err = allow_smem(bc_grad_kernel, s5);
  if (err != cudaSuccess) return int(err);
  const int FPB = (a.P + ssd::PW - 1) / ssd::PW, FSB = (a.S16 + ssd::SW - 1) / ssd::SW;
  ssd::chunk_state_kernel<true><<<dim3(a.nc * FPB * FSB, a.H, a.Bsz), ssd::STATE_THREADS, s1,
                                   stream>>>(f);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  // 3. the reverse state pass
  const long long ps = (long long)a.P * a.S16;
  reverse_pass_kernel<<<dim3(unsigned((ps + PASS_THREADS - 1) / PASS_THREADS), a.H, a.Bsz),
                        PASS_THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  // 4-8
  x_grad_kernel<<<dim3(a.nc * (CHUNK / ROWS) * a.PB, a.H, a.Bsz), XG_THREADS, s4, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bc_grad_kernel<<<dim3(a.nc * a.KT, a.G * a.nsl, a.Bsz), BC_THREADS, s5, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  dt_grad_kernel<<<dim3(a.nc, a.H, a.Bsz), 32, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const long long N = (long long)a.Bsz * a.L * a.G * a.S;
  bc_reduce_kernel<<<unsigned((N + 255) / 256), 256, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  dA_reduce_kernel<<<(a.H + 127) / 128, 128, 0, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace ssd_bwd
}  // namespace repro_torch

// h0 and dhT may be null (zero).  The scratch holds scratch_floats floats
// (ssd_backward.scratch_floats: the layouts in the header) for n_chunks =
// ceil(L / ssd::CHUNK); a launch whose counts differ is refused.  dh0 is
// written whether or not h0 is given.
extern "C" int ssd_chunked_bwd_launch(const void* x, const void* dt, const void* A,
                                      const void* Bm, const void* Cm, const void* h0,
                                      const void* dy, const void* dhT, void* dx, void* ddt,
                                      void* dA, void* dB, void* dC, void* dh0, void* scratch,
                                      long long scratch_floats, int Bsz, int L, int H, int P,
                                      int G, int S, int n_chunks, int dtype, void* stream) {
  using namespace repro_torch;
  using ssd_bwd::CHUNK;
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > 256 || S <= 0 ||
      S > 256 || H > 65535 || Bsz > 65535 || scratch == nullptr)
    return int(cudaErrorInvalidValue);
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return int(cudaErrorInvalidValue);
  const bool bf = dtype == DTYPE_BF16;
  const int nc = (L + CHUNK - 1) / CHUNK, S16 = (S + 15) / 16 * 16, P16 = (P + 15) / 16 * 16;
  const int PB = (P16 + ssd_bwd::PW - 1) / ssd_bwd::PW, KT = (S16 + ssd_bwd::KW - 1) / ssd_bwd::KW;
  const int nsl = (H / G + ssd_bwd::HEADS - 1) / ssd_bwd::HEADS, n_terms = 4 + PB + KT;
  const long long bhn = (long long)Bsz * H * nc, ce = bhn * P * S16, qq = bhn * CHUNK * CHUNK,
                  bc = (long long)nsl * Bsz * L * G * S;
  const long long want = bf ? 2 * ce + bhn * (2 + (2 + n_terms) * CHUNK) + 2 * bc
                            : 2 * ce + 2 * qq + bhn * (2 * CHUNK + 2);
  if (n_chunks != nc || scratch_floats != want) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_bwd::Args a = {};
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
  if (bf) {
    a.states = f;
    a.dstates = a.states + ce;
    a.cd = a.dstates + ce;
    a.terms = a.cd + bhn * 2 * CHUNK;
    a.bpart = a.terms + bhn * n_terms * CHUNK;
    a.cpart = a.bpart + bc;
    a.decay = a.cpart + bc;
    a.dA_part = a.decay + bhn;
  } else {
    a.states = f;
    a.decay = a.states + ce;
    a.dstates = a.decay + bhn;
    a.M = a.dstates + ce;
    a.dM = a.M + qq;
    a.ew = a.dM + qq;
    a.dA_part = a.ew + bhn * 2 * CHUNK;
  }
  a.Bsz = Bsz;
  a.L = L;
  a.H = H;
  a.P = P;
  a.G = G;
  a.S = S;
  a.S16 = S16;
  a.nc = nc;
  a.P16 = P16;
  a.PB = PB;
  a.KT = KT;
  a.nsl = nsl;
  a.n_terms = n_terms;
  a.x_vec = P % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.dy_vec = P % 8 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  a.bc_vec = S % 8 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(Cm) % 16 == 0;

  // 1. the states before each chunk; the state pass's final state goes to
  // dh0, which the reverse pass overwrites later in stream order
  const int PBT = (P + ssd_bwd::TILE - 1) / ssd_bwd::TILE;
  const int KBT = (S16 + ssd_bwd::TILE - 1) / ssd_bwd::TILE;
  cudaError_t err;
  if (bf) {
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
    f1.x_vec = a.x_vec;
    f1.bc_vec = a.bc_vec;
    const size_t s1 = ssd::state_smem_bytes();
    if ((err = allow_smem(ssd::chunk_state_kernel<false>, s1)) != cudaSuccess) return int(err);
    const int FPB = (P + ssd::PW - 1) / ssd::PW, FSB = (S16 + ssd::SW - 1) / ssd::SW;
    ssd::chunk_state_kernel<false>
        <<<dim3(nc * FPB * FSB, H, Bsz), ssd::STATE_THREADS, s1, s>>>(f1);
  } else {
    ssd_bwd::chunk_state_f32<<<dim3(nc * PBT * KBT, H, Bsz), ssd_bwd::THREADS, 0, s>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const long long ps = (long long)P * S16;
  ssd::state_pass_kernel<<<dim3(unsigned((ps + ssd::PASS_THREADS - 1) / ssd::PASS_THREADS), H,
                                Bsz),
                           ssd::PASS_THREADS, 0, s>>>(a.states, a.decay, a.h0, a.dh0, H, P, S,
                                                      S16, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  return bf ? ssd_bwd::launch_bf16(a, s) : ssd_bwd::launch_f32(a, s);
}
