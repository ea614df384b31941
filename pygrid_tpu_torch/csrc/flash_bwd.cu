// Flash-attention backward for Hopper (sm_90a): the dK/dV pass and the dQ
// pass, two kernels off the forward's saved per-row log-sum-exp.
//
// Replace the TPU kernels `_bwd_dkv_kernel` and `_bwd_dq_kernel` in
// pygrid_tpu/parallel/pallas_attention.py (the two pl.pallas_call sites in
// `_flash_bwd`). Both recompute P = exp(min(s - lse, 0)) tile by tile;
// Delta = rowsum(dO * O) arrives precomputed (a plain torch op in the
// wrapper, as on the TPU path). The two-pass layout keeps each gradient tile
// on chip for a whole sweep and writes it once -- no atomics, so results
// are the same from run to run -- and recomputes P instead of reading an
// L x L tensor. Causal tile pairs entirely above the diagonal are skipped.
//
// What bounds them on the card: at the federated transformer's shape
// ([32, 512, 4, 128] bf16, causal) dK/dV is ~17 GFLOP against ~100 MB and
// dQ ~13 GFLOP against ~84 MB, so on the tensor cores both are bound by
// bytes (~30 us and ~25 us); mma.sync at half the dense bf16 rate does
// dK/dV's products in ~35 us, so data movement and occupancy, not the
// instruction, stand between a kernel and its bound.
//
// dK/dV in bf16 (the main path), flash_bwd_dkv_tc_kernel, in the
// FlashAttention-2 shape: one block of 4 warps per (b*h, 64-key tile), each
// warp owning 16 keys, looping over the query tiles (from the diagonal on,
// when causal). K and V are copied once; the Q, dO, lse and Delta tiles are
// double-buffered in shared memory by cp.async, bf16 tiles with a 16-byte
// row pad. S^T = K Q^T and dP^T = V dO^T run as m16n8k16 mma.sync (Q and dO
// as B fragments by ldmatrix); P^T = exp(min(S^T scale - lse, 0)) and
// dS^T = P^T (dP^T - Delta) scale are formed in f32 registers, masked only
// on the diagonal and ragged tiles; bf16(P^T) and bf16(dS^T) go from the C
// fragments straight to A fragments (the reference's rounding points) for
// dV += P^T dO and dK += dS^T Q, with dO and Q as B through ldmatrix.trans.
// dK and dV stay in f32 registers for the whole loop and are written once,
// staged through shared memory, with 16-byte stores.
// Register budget at D = 128: dK and dV take 128 f32 registers a thread,
// S^T and dP^T 4 * TC_BQ / 8 more; K and V are re-read by ldmatrix for
// every query tile rather than held as fragments, which would cost 64 more.
// The query tile is 32 wide, which ptxas fits in 254 registers without
// spills at D = 128 (a 64-wide tile takes all 255 and ran slower; PERF.md
// has both). chip_smoke.py's build phase prints the registers and spills
// and fails on a spill. The shared memory is 70 KB a block at D = 128, so
// registers, not shared memory, hold it to 2 blocks an SM.
//
// dQ in bf16 (the main path), flash_bwd_dq_tc_kernel, the mirror image:
// one block of 4 warps per (b*h, 64-query tile), each warp owning 16
// queries, looping over the 64-key tiles (up to the diagonal, when causal;
// the query tiles launch in reverse order so the longest causal rows start
// first). dQ is bound by bytes (84.4 MB, 25 us at 3.35 TB/s); the f32 FMA
// kernel it replaces widened its bf16 tiles to f32 in shared memory (twice
// the bytes) and never reached the tensor cores. Here Q and dO are copied
// once by cp.async and K and V are double-buffered as bf16, so the next key
// tile's copy runs under this tile's math; lse and Delta are per query row
// and live in registers (each thread holds rows g and g + 8). S = Q K^T and
// dP = dO V^T run as m16n8k16 mma.sync with Q and dO as A fragments
// (re-read by ldmatrix for each key tile: holding them would cost 128
// registers at D = 128) and K and V as B fragments by non-transposed
// ldmatrix; P and dS are formed in f32 registers; bf16(dS) goes from the C
// fragments straight to the A fragment of dQ += dS K (the reference's
// ds.astype(k.dtype)), with K as B through ldmatrix.trans. dQ stays in f32
// registers (64 a thread at D = 128) and is written once, staged through
// shared memory, with 16-byte stores: no atomics, so it is bit-identical
// from launch to launch. 102 KB of shared memory a block at D = 128.
//
// The f32 dK/dV and dQ kernels (the f32 parity checks, held at 1e-4, which
// neither bf16 nor TF32 tensor cores give) are f32 FMA on the CUDA cores
// from f32 tiles in shared memory, 64-row tiles, 256 threads with a 4x4
// register tile each.
//
// With a band (BAND = 1: a sliding window W, or K/V at H / group heads), the
// dQ kernel starts its key loop where the band starts, as the forward does;
// a dK/dV block owns (b, K/V head, key tile) and walks its group's query
// heads x the query tiles the band reaches ([k0 / BQ, tile of k0 + BK - 2 +
// W]) as one double-buffered loop, so dK and dV are summed over the group
// in registers and written once at the K/V heads: no per-query-head dK/dV.
//
// Next steps: wgmma fed by TMA with a producer warp, and a persistent
// schedule over the tiles.
//
// The TPU's sequential "arbitrary" grid axis (q innermost for dK/dV, k
// innermost for dQ) becomes the loop over tiles inside one thread block.
// Pad queries are masked as well as pad keys: their lse and Delta load as 0,
// and exp(s - 0) is finite but wrong, so query validity is in the mask.
#include "flash_common.cuh"
#include "tc_common.cuh"

namespace pgt {

// grid (ceil(Lk / TILE), B*H, n_chunks(D, DC)): one block per (64-key tile,
// b*h, DC-wide slice of the output columns), looping over the query tiles;
// dK and dV stay in registers for the whole loop. Where D > DC, the
// contractions stream K, V, Q and dO through shared memory chunk by chunk,
// the block's own slice last, so that the products read it where it lies.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int Lq, int Lk,
                     int D, int q_sb, int q_sl, int q_sh, int o_sb, int o_sl, int o_sh, int k_sb,
                     int k_sl, int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal) {
  extern __shared__ float smem[];
  const int pitch = pitch_of(imin(D, DC));
  float* sK = smem;                    // [TILE][pitch]
  float* sV = sK + TILE * pitch;       // [TILE][pitch]
  float* sQ = sV + TILE * pitch;       // [TILE][pitch]
  float* sO = sQ + TILE * pitch;       // [TILE][pitch] dO
  float* sP = sO + TILE * pitch;       // [TILE keys][SPITCH queries] P^T
  float* sS = sP + TILE * SPITCH;      // [TILE keys][SPITCH queries] dS^T
  float* sLse = sS + TILE * SPITCH;    // [TILE]
  float* sDelta = sLse + TILE;         // [TILE]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kt = blockIdx.x;
  const int k0 = kt * TILE;
  const int n_c = n_chunks(D, DC);
  const int z = blockIdx.z;
  const int d0 = z * DC;  // this block's output columns [d0, d0 + dw)
  const int dw = imin(DC, D - d0);
  const float* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const float* ob = dout + (long long)b * o_sb + (long long)h * o_sh;
  const float* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const float* vb = v + (long long)b * v_sb + (long long)h * v_sh;
  const float* lse_b = lse + (long long)bh * Lq;
  const float* delta_b = delta + (long long)bh * Lq;

  const int tx = threadIdx.x & 15;  // query columns tx + 16 j / head dims
  const int ty = threadIdx.x >> 4;  // key rows 4 ty + i

  if (n_c == 1) {
    load_tile(sK, pitch, kb, k_sl, k0, Lk, D);
    load_tile(sV, pitch, vb, v_sl, k0, Lk, D);
  }

  float acc_dk[4][JD], acc_dv[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  const int n_q = (Lq + TILE - 1) / TILE;
  // causal: a query tile whose last query precedes the tile's first key is
  // all masked (qt * TILE + TILE - 1 < k0 <=> qt < kt) and is skipped
  const int q_first = causal ? kt : 0;
  for (int qt = q_first; qt < n_q; ++qt) {
    const int q0 = qt * TILE;
    // S^T = K Q^T and dP^T = V dO^T for keys 4ty+i, queries tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int i_c = 0; i_c < n_c; ++i_c) {
      const int c0 = ((z + 1 + i_c) % n_c) * DC;  // chunk z comes last
      const int dc = imin(DC, D - c0);
      __syncthreads();  // the previous step is done with the tiles
      if (n_c > 1) {
        load_tile(sK, pitch, kb + c0, k_sl, k0, Lk, dc);
        load_tile(sV, pitch, vb + c0, v_sl, k0, Lk, dc);
      }
      load_tile(sQ, pitch, qb + c0, q_sl, q0, Lq, dc);
      load_tile(sO, pitch, ob + c0, o_sl, q0, Lq, dc);
      if (i_c == n_c - 1) {
        load_rows(sLse, lse_b, q0, Lq);
        load_rows(sDelta, delta_b, q0, Lq);
      }
      __syncthreads();
      for (int d = 0; d < dc; ++d) {
        float ka[4], va[4], qa[4], oa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = sK[(4 * ty + i) * pitch + d];
          va[i] = sV[(4 * ty + i) * pitch + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qa[j] = sQ[(tx + 16 * j) * pitch + d];
          oa[j] = sO[(tx + 16 * j) * pitch + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(ka[i], qa[j], s[i][j]);
            dp[i][j] = fmaf(va[i], oa[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int kpos = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qpos = q0 + c;
        const bool valid = qpos < Lq && kpos < Lk && (!causal || qpos >= kpos);
        // exp(s - lse) <= 1 on live lanes; the clamp keeps dead lanes
        // from overflowing before the select
        const float p = valid ? expf(fminf(s[i][j] * scale - sLse[c], 0.f)) : 0.f;
        const float ds = p * (dp[i][j] - sDelta[c]) * scale;
        sP[r * SPITCH + c] = p;
        sS[r * SPITCH + c] = ds;
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q (sQ and sO hold the block's slice)
    for (int qq = 0; qq < TILE; ++qq) {
      float p[4], ds[4], ov[JD], qv[JD];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = sP[(4 * ty + i) * SPITCH + qq];
        ds[i] = sS[(4 * ty + i) * SPITCH + qq];
      }
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const int c = tx + 16 * j;
        ov[j] = c < dw ? sO[qq * pitch + c] : 0.f;
        qv[j] = c < dw ? sQ[qq * pitch + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JD; ++j) {
          acc_dv[i][j] = fmaf(p[i], ov[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(ds[i], qv[j], acc_dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + 4 * ty + i;
    if (kpos >= Lk) continue;
    const long long row = (((long long)b * Lk + kpos) * H + h) * D + d0;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int c = tx + 16 * j;
      if (c < dw) {
        dk[row + c] = acc_dk[i][j];
        dv[row + c] = acc_dv[i][j];
      }
    }
  }
}

// grid (ceil(Lq / TILE), B*H, n_chunks(D, DC)): one block per (64-query tile,
// b*h, DC-wide slice of the output columns), looping over the key tiles;
// dQ stays in registers for the whole loop. Where D > DC, Q, dO, K and V
// stream chunk by chunk, the block's own slice last.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ dq, int H, int Lq, int Lk, int D, int q_sb, int q_sl,
                    int q_sh, int o_sb, int o_sl, int o_sh, int k_sb, int k_sl, int k_sh,
                    int v_sb, int v_sl, int v_sh, float scale, int causal) {
  extern __shared__ float smem[];
  const int pitch = pitch_of(imin(D, DC));
  float* sQ = smem;                    // [TILE][pitch]
  float* sO = sQ + TILE * pitch;       // [TILE][pitch] dO
  float* sK = sO + TILE * pitch;       // [TILE][pitch]
  float* sV = sK + TILE * pitch;       // [TILE][pitch]
  float* sS = sV + TILE * pitch;       // [TILE queries][SPITCH keys] dS
  float* sLse = sS + TILE * SPITCH;    // [TILE]
  float* sDelta = sLse + TILE;         // [TILE]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = blockIdx.x;
  const int q0 = qt * TILE;
  const int n_c = n_chunks(D, DC);
  const int z = blockIdx.z;
  const int d0 = z * DC;  // this block's output columns [d0, d0 + dw)
  const int dw = imin(DC, D - d0);
  const float* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const float* ob = dout + (long long)b * o_sb + (long long)h * o_sh;
  const float* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const float* vb = v + (long long)b * v_sb + (long long)h * v_sh;

  const int tx = threadIdx.x & 15;  // key columns tx + 16 j / head dims
  const int ty = threadIdx.x >> 4;  // query rows 4 ty + i

  if (n_c == 1) {
    load_tile(sQ, pitch, qb, q_sl, q0, Lq, D);
    load_tile(sO, pitch, ob, o_sl, q0, Lq, D);
  }
  load_rows(sLse, lse + (long long)bh * Lq, q0, Lq);
  load_rows(sDelta, delta + (long long)bh * Lq, q0, Lq);

  float acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;

  int n_k = (Lk + TILE - 1) / TILE;
  if (causal && n_k > qt + 1) n_k = qt + 1;  // same skip as the forward
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * TILE;
    // S = Q K^T and dP = dO V^T for queries 4ty+i, keys tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int i_c = 0; i_c < n_c; ++i_c) {
      const int c0 = ((z + 1 + i_c) % n_c) * DC;  // chunk z comes last
      const int dc = imin(DC, D - c0);
      __syncthreads();  // the previous step is done with the tiles
      if (n_c > 1) {
        load_tile(sQ, pitch, qb + c0, q_sl, q0, Lq, dc);
        load_tile(sO, pitch, ob + c0, o_sl, q0, Lq, dc);
      }
      load_tile(sK, pitch, kb + c0, k_sl, k0, Lk, dc);
      load_tile(sV, pitch, vb + c0, v_sl, k0, Lk, dc);
      __syncthreads();
      for (int d = 0; d < dc; ++d) {
        float qa[4], oa[4], ka[4], va[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = sQ[(4 * ty + i) * pitch + d];
          oa[i] = sO[(4 * ty + i) * pitch + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ka[j] = sK[(tx + 16 * j) * pitch + d];
          va[j] = sV[(tx + 16 * j) * pitch + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
            dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool valid = qpos < Lq && kpos < Lk && (!causal || qpos >= kpos);
        const float p = valid ? expf(fminf(s[i][j] * scale - sLse[r], 0.f)) : 0.f;
        sS[r * SPITCH + c] = p * (dp[i][j] - sDelta[r]) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K (sK holds the block's slice)
    for (int kk = 0; kk < TILE; ++kk) {
      float ds[4], kv[JD];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sS[(4 * ty + i) * SPITCH + kk];
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const int c = tx + 16 * j;
        kv[j] = c < dw ? sK[kk * pitch + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JD; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= Lq) continue;
    float* row = dq + (((long long)b * Lq + qpos) * H + h) * D + d0;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int c = tx + 16 * j;
      if (c < dw) row[c] = acc[i][j];
    }
  }
}

int launch_dkv(const void* q, const void* dout, const void* lse, const void* delta,
               const void* k, const void* v, void* dk, void* dv, int B, int H, int Lq, int Lk,
               int D, int q_sb, int q_sl, int q_sh, int o_sb, int o_sl, int o_sh, int k_sb,
               int k_sl, int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * TILE * pitch_of(imin(D, DC)) + 2 * TILE * SPITCH + 2 * TILE);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lk + TILE - 1) / TILE, B * H, n_chunks(D, DC));
  flash_bwd_dkv_kernel<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)dout, (const float*)lse, (const float*)delta,
      (const float*)k, (const float*)v, (float*)dk, (float*)dv, H, Lq, Lk, D, q_sb, q_sl, q_sh,
      o_sb, o_sl, o_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal);
  return (int)cudaGetLastError();
}

int launch_dq(const void* q, const void* dout, const void* lse, const void* delta,
              const void* k, const void* v, void* dq, int B, int H, int Lq, int Lk, int D,
              int q_sb, int q_sl, int q_sh, int o_sb, int o_sl, int o_sh, int k_sb, int k_sl,
              int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal,
              cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * TILE * pitch_of(imin(D, DC)) + TILE * SPITCH + 2 * TILE);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + TILE - 1) / TILE, B * H, n_chunks(D, DC));
  flash_bwd_dq_kernel<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)dout, (const float*)lse, (const float*)delta,
      (const float*)k, (const float*)v, (float*)dq, H, Lq, Lk, D, q_sb, q_sl, q_sh, o_sb, o_sl,
      o_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal);
  return (int)cudaGetLastError();
}

// ---- bf16 dK/dV: tensor cores -------------------------------------------

constexpr int TC_BK = 64;        // keys per block, 16 per warp
constexpr int TC_BQ = 32;        // queries per Q/dO tile
constexpr int TC_THREADS = 128;  // 4 warps

template <int DP, int BAND>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk, int D, int q_sb,
                        int q_sl, int q_sh, int o_sb, int o_sl, int o_sh, int k_sb, int k_sl,
                        int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal,
                        int group, int window) {
  using namespace tc;
  constexpr int P = DP + PAD;  // row pitch of every shared tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][P], then dK
  __nv_bfloat16* sV = sK + TC_BK * P;                                // [BK][P], then dV
  __nv_bfloat16* sQ = sV + TC_BK * P;                                // [2][BQ][P]
  __nv_bfloat16* sO = sQ + 2 * TC_BQ * P;                            // [2][BQ][P] dO
  float* sLse = reinterpret_cast<float*>(sO + 2 * TC_BQ * P);        // [2][BQ]
  float* sDelta = sLse + 2 * TC_BQ;                                  // [2][BQ]

  // a block owns (b, K/V head hk, key tile); with a band it loops over the
  // group's query heads h0 .. h0 + G - 1 (BAND = 0: G = 1, the one head h0)
  const int G = BAND ? group : 1;
  const int Hk = H / G;
  const int bh = blockIdx.x;
  const int b = bh / Hk;
  const int hk = bh - b * Hk;
  const int h0 = hk * G;
  const int k0 = blockIdx.y * TC_BK;  // low key tiles see the most queries: they start first
  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)h0 * q_sh;
  const __nv_bfloat16* ob = dout + (long long)b * o_sb + (long long)h0 * o_sh;
  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)hk * k_sh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)hk * v_sh;
  const float* lse_b = lse + ((long long)b * H + h0) * Lq;
  const float* delta_b = delta + ((long long)b * H + h0) * Lq;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8): keys
  const int t = lane & 3;   // fragment column pair: queries
  const int wrow = warp * 16;

  const int n_q = (Lq + TC_BQ - 1) / TC_BQ;
  // causal: a query tile whose last query precedes the first key is all
  // masked (qt * BQ + BQ - 1 < k0) and is skipped; a band ends at the tile
  // of query k0 + BK - 1 + W - 1, the last that sees the tile's last key
  const int q_first = causal ? k0 / TC_BQ : 0;
  const int W = band_width(window);
  const int q_end = BAND ? imin(n_q, (int)(((long long)k0 + TC_BK - 2 + W) / TC_BQ) + 1) : n_q;
  const int n_qb = q_end - q_first;  // query tiles a head takes
  const int n_it = G * n_qb;          // step it: head it / n_qb, tile q_first + it % n_qb

  // step it's Q, dO, lse and Delta tiles into buffer `buf`
  auto load_q_tile = [&](int it, int buf) {
    const int j = BAND ? it / n_qb : 0;
    const int q0 = (q_first + (BAND ? it - j * n_qb : it)) * TC_BQ;
    load_tile_async<TC_BQ, DP, TC_THREADS>(sQ + buf * TC_BQ * P, qb + (long long)j * q_sh, q_sl,
                                           q0, Lq, D);
    load_tile_async<TC_BQ, DP, TC_THREADS>(sO + buf * TC_BQ * P, ob + (long long)j * o_sh, o_sl,
                                           q0, Lq, D);
    for (int i = threadIdx.x; i < 2 * TC_BQ; i += TC_THREADS) {
      const int r = i % TC_BQ;
      const bool in = q0 + r < Lq;
      const float* src = (i < TC_BQ ? lse_b : delta_b) + (long long)j * Lq;
      cp_async_4((i < TC_BQ ? sLse : sDelta) + buf * TC_BQ + r, in ? src + q0 + r : src, in);
    }
  };

  load_tile_async<TC_BK, DP, TC_THREADS>(sK, kb, k_sl, k0, Lk, D);
  load_tile_async<TC_BK, DP, TC_THREADS>(sV, vb, v_sl, k0, Lk, D);
  if (n_it > 0) load_q_tile(0, 0);
  cp_async_commit();

  const float sl2 = scale * 1.4426950408889634f;  // log2 units
  float acc_dk[DP / 8][4], acc_dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[n][c] = acc_dv[n][c] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int cur = it & 1;
    const int qt = q_first + (BAND ? it % n_qb : it);
    if (it + 1 < n_it) {  // the next tile's copy runs under this tile's math
      load_q_tile(it + 1, cur ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile qt (and at the first step, K and V) has landed
    const __nv_bfloat16* Qt = sQ + cur * TC_BQ * P;
    const __nv_bfloat16* Ot = sO + cur * TC_BQ * P;
    const float* Lt = sLse + cur * TC_BQ;
    const float* Dt = sDelta + cur * TC_BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp
    float s[TC_BQ / 8][4], dp[TC_BQ / 8][4];
#pragma unroll
    for (int j = 0; j < TC_BQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, sK + (wrow + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4(va, sV + (wrow + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < TC_BQ / 16; ++np) {
        const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + ks * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t qf[4], of[4];  // B fragments of query tiles 2np and 2np+1
        ldmatrix_x4(qf, Qt + off);
        ldmatrix_x4(of, Ot + off);
        mma_bf16(s[2 * np], ka, qf[0], qf[1]);
        mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
        mma_bf16(dp[2 * np], va, of[0], of[1]);
        mma_bf16(dp[2 * np + 1], va, of[2], of[3]);
      }
    }

    // P^T = exp(min(S^T scale - lse, 0)) and dS^T = P^T (dP^T - Delta) scale,
    // f32; invalid pairs (pad query, pad key, causal, past the band) only on
    // the diagonal, ragged and band-edge tiles, where they become 0
    const int q0 = qt * TC_BQ;
    const bool need_mask = (causal && q0 < k0 + TC_BK - 1) || q0 + TC_BQ > Lq ||
                           k0 + TC_BK > Lk || (BAND && q0 + TC_BQ - 1 - k0 >= W);
#pragma unroll
    for (int j = 0; j < TC_BQ / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = 8 * j + 2 * t + (c & 1);
        // exp(s - lse) <= 1 on live lanes; the clamp keeps dead lanes from
        // overflowing before the select
        float p = exp2f(fminf(s[j][c] * sl2 - Lt[qc] * 1.4426950408889634f, 0.f));
        if (need_mask) {
          const int qpos = q0 + qc;
          const int kpos = k0 + wrow + g + (c >> 1) * 8;
          if (qpos >= Lq || kpos >= Lk || (causal && qpos < kpos) || (BAND && qpos - kpos >= W))
            p = 0.f;
        }
        s[j][c] = p;
        dp[j][c] = p * (dp[j][c] - Dt[qc]) * scale;
      }
    }

    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q: the C fragments of query
    // tiles 2kk, 2kk+1 are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < TC_BQ / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {
          pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
          pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + np * 16 +
                        (lane >> 4) * 8;
        uint32_t of[4], qf[4];  // B fragments of head-dim tiles 2np and 2np+1
        ldmatrix_x4_trans(of, Ot + off);
        ldmatrix_x4_trans(qf, Qt + off);
        mma_bf16(acc_dv[2 * np], pa, of[0], of[1]);
        mma_bf16(acc_dv[2 * np + 1], pa, of[2], of[3]);
        mma_bf16(acc_dk[2 * np], da, qf[0], qf[1]);
        mma_bf16(acc_dk[2 * np + 1], da, qf[2], qf[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `cur` before it is refilled
  }

  // stage dK and dV as bf16 over K and V, then store them coalesced
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = wrow + g + 8 * hh;
      *reinterpret_cast<uint32_t*>(sK + row * P + col) =
          pack_bf16(acc_dk[n][2 * hh], acc_dk[n][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(sV + row * P + col) =
          pack_bf16(acc_dv[n][2 * hh], acc_dv[n][2 * hh + 1]);
    }
  }
  __syncthreads();
  const long long out0 = ((long long)b * Lk * Hk + hk) * D;
  store_tile<TC_BK, DP, TC_THREADS>(dk + out0, (long long)Hk * D, sK, k0, Lk, D);
  store_tile<TC_BK, DP, TC_THREADS>(dv + out0, (long long)Hk * D, sV, k0, Lk, D);
}

template <int DP, int BAND>
int launch_dkv_tc(const void* q, const void* dout, const void* lse, const void* delta,
                  const void* k, const void* v, void* dk, void* dv, int B, int H, int Lq, int Lk,
                  int D, int q_sb, int q_sl, int q_sh, int o_sb, int o_sl, int o_sh, int k_sb,
                  int k_sl, int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal,
                  int group, int window, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (2 * TC_BK + 4 * TC_BQ) * (DP + tc::PAD) +
                      sizeof(float) * 4 * TC_BQ;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<DP, BAND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * (H / group), (Lk + TC_BK - 1) / TC_BK);  // one block a (b, K/V head)
  flash_bwd_dkv_tc_kernel<DP, BAND><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, Lq, Lk, D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh,
      k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal, group, window);
  return (int)cudaGetLastError();
}

// ---- bf16 dQ: tensor cores -----------------------------------------------

constexpr int TC_DQ_BQ = 64;  // queries per block, 16 per warp
constexpr int TC_DQ_BK = 64;  // keys per K/V tile

template <int DP, int BAND>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ dq,
                       int H, int Lq, int Lk, int D, int q_sb, int q_sl, int q_sh, int o_sb,
                       int o_sl, int o_sh, int k_sb, int k_sl, int k_sh, int v_sb, int v_sl,
                       int v_sh, float scale, int causal, int group, int window) {
  using namespace tc;
  constexpr int P = DP + PAD;  // row pitch of every shared tile
  constexpr int BQ = TC_DQ_BQ, BK = TC_DQ_BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][P], then dQ
  __nv_bfloat16* sO = sQ + BQ * P;                                   // [BQ][P] dO
  __nv_bfloat16* sK = sO + BQ * P;                                   // [2][BK][P]
  __nv_bfloat16* sV = sK + 2 * BK * P;                               // [2][BK][P]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * BQ;
  const int hk = BAND ? h / group : h;  // the K/V head this query head reads
  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const __nv_bfloat16* ob = dout + (long long)b * o_sb + (long long)h * o_sh;
  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)hk * k_sh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)hk * v_sh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8): queries
  const int t = lane & 3;   // fragment column pair: keys
  const int wrow = warp * 16;

  int n_k = (Lk + BK - 1) / BK;
  // causal: a K tile whose first key is past the block's last query is all
  // masked (kt * BK > q0 + BQ - 1) and is skipped
  if (causal && n_k > (q0 + BQ - 1) / BK + 1) n_k = (q0 + BQ - 1) / BK + 1;
  // a band: the K tiles wholly before it (kt < kt0) are skipped too
  const int W = band_width(window);
  const int kt0 = BAND ? band_first(q0, W, BK) : 0;

  load_tile_async<BQ, DP, TC_THREADS>(sQ, qb, q_sl, q0, Lq, D);
  load_tile_async<BQ, DP, TC_THREADS>(sO, ob, o_sl, q0, Lq, D);
  load_tile_async<BK, DP, TC_THREADS>(sK, kb, k_sl, kt0 * BK, Lk, D);
  load_tile_async<BK, DP, TC_THREADS>(sV, vb, v_sl, kt0 * BK, Lk, D);
  cp_async_commit();

  // lse (log2 units) and Delta of rows g and g + 8, in registers; pad
  // queries read 0 and are masked below
  const float sl2 = scale * 1.4426950408889634f;
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qpos = q0 + wrow + g + 8 * hh;
    const bool in = qpos < Lq;
    lse2[hh] = in ? lse[(long long)bh * Lq + qpos] * 1.4426950408889634f : 0.f;
    dlt[hh] = in ? delta[(long long)bh * Lq + qpos] : 0.f;
  }

  float acc[DP / 8][4];  // dQ, f32, for the whole loop
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int kt = kt0; kt < n_k; ++kt) {
    const int cur = (kt - kt0) & 1;
    if (kt + 1 < n_k) {  // the next tile's copy runs under this tile's math
      const int nk0 = (kt + 1) * BK;
      load_tile_async<BK, DP, TC_THREADS>(sK + (cur ^ 1) * BK * P, kb, k_sl, nk0, Lk, D);
      load_tile_async<BK, DP, TC_THREADS>(sV + (cur ^ 1) * BK * P, vb, v_sl, nk0, Lk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and at kt = kt0, Q and dO) has landed
    const __nv_bfloat16* Kt = sK + cur * BK * P;
    const __nv_bfloat16* Vt = sV + cur * BK * P;

    // S = Q K^T and dP = dO V^T: 16 queries x BK keys per warp; Q and dO
    // are A fragments re-read by ldmatrix for each key tile, K and V B
    // fragments by non-transposed ldmatrix (a [key][d] row is the .col layout)
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t qf[4], of[4];
      ldmatrix_x4(qf, sQ + (wrow + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4(of, sO + (wrow + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + ks * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t kf[4], vf[4];  // B fragments of key tiles 2np and 2np+1
        ldmatrix_x4(kf, Kt + off);
        ldmatrix_x4(vf, Vt + off);
        mma_bf16(s[2 * np], qf, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
        mma_bf16(dp[2 * np], of, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], of, vf[2], vf[3]);
      }
    }

    // P = exp(min(S scale - lse, 0)) and dS = P (dP - Delta) scale, f32;
    // invalid pairs (pad query, pad key, causal, past the band) only on the
    // diagonal, ragged and band-edge tiles, where they become 0
    const int k0 = kt * BK;
    const bool need_mask = (causal && k0 + BK - 1 > q0) || q0 + BQ > Lq || k0 + BK > Lk ||
                           (BAND && q0 + BQ - 1 - k0 >= W);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hh = c >> 1;
        // exp(s - lse) <= 1 on live lanes; the clamp keeps dead lanes from
        // overflowing before the select
        float p = exp2f(fminf(s[j][c] * sl2 - lse2[hh], 0.f));
        if (need_mask) {
          const int qpos = q0 + wrow + g + 8 * hh;
          const int kpos = k0 + 8 * j + 2 * t + (c & 1);
          if (qpos >= Lq || kpos >= Lk || (causal && qpos < kpos) || (BAND && qpos - kpos >= W))
            p = 0.f;
        }
        dp[j][c] = p * (dp[j][c] - dlt[hh]) * scale;
      }
    }

    // dQ += bf16(dS) K: the C fragments of key tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk; K is the B operand through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t da[4] = {
          pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
          pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t kf[4];  // B fragments of head-dim tiles 2np and 2np+1
        ldmatrix_x4_trans(kf, Kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                  np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], da, kf[0], kf[1]);
        mma_bf16(acc[2 * np + 1], da, kf[2], kf[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `cur` before it is refilled
  }

  // stage dQ as bf16 over Q (the loop ended on a barrier), then store it
  // coalesced
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sQ + (wrow + g) * P + col) = pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(sQ + (wrow + g + 8) * P + col) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  store_tile<BQ, DP, TC_THREADS>(dq + ((long long)b * Lq * H + h) * D, (long long)H * D, sQ, q0,
                                 Lq, D);
}

template <int DP, int BAND>
int launch_dq_tc(const void* q, const void* dout, const void* lse, const void* delta,
                 const void* k, const void* v, void* dq, int B, int H, int Lq, int Lk, int D,
                 int q_sb, int q_sl, int q_sh, int o_sb, int o_sl, int o_sh, int k_sb, int k_sl,
                 int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal, int group,
                 int window, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (2 * TC_DQ_BQ + 4 * TC_DQ_BK) * (DP + tc::PAD);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<DP, BAND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Lq + TC_DQ_BQ - 1) / TC_DQ_BQ);
  flash_bwd_dq_tc_kernel<DP, BAND><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)dq,
      H, Lq, Lk, D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
      causal, group, window);
  return (int)cudaGetLastError();
}

// ---- bf16, D > 128: tensor cores, and a grid axis over the output slices ----
//
// The two kernels above for a query/key width D past DC = 128 (up to MAX_D)
// and a value width Dv of its own, templated on CW, the width of the Q and K
// chunks and of a block's dK or dQ slice. Each block owns one slice z of its
// outputs: dK's columns [z CW, z CW + CW) and dV's [z CW, z CW + DC) (dQ's
// [z CW, z CW + CW)), with their f32 accumulators in registers. The
// contractions that need the full widths (S = Q K^T over D, dP = dO V^T over
// Dv) stream chunk by chunk: the block's own operands stay in shared memory
// as n = ceil(D / CW) chunks (Q and K CW wide, dO and V DC wide), the other
// side's tiles pass through a double-buffered ring one chunk per stage, and
// the chunks are taken in the order that puts the block's own slice last, so
// the gradient products read that slice from the ring slot where it already
// lies. On the narrow-V path the contractions run as many k-steps as the
// chunk's real widths need (S and dP together over D_v's, then S alone;
// tc::k_loop, fully unrolled for a whole chunk), so none runs over columns
// of zeros; the slice path, where D = Dv, runs every chunk at its 128
// columns in loops of its own, one pitch for all four tiles (the general
// form, at the same registers, ran its dK/dV kernel 2 % slower). The streamed
// tiles are narrower than at D = 128 (16 queries for dK/dV, 32 keys for dQ),
// which keeps S and dP at 16 and 32 registers a thread beside the
// accumulators. Dv is the kernels' last parameter, so that the slice path
// loads the others as a one-width signature does. Two instantiations:
// - CW = DC (D = Dv > 128): n slices, each recomputing S and dP (2x the
//   QK^T and dO V^T work at D = 256). ptxas gives the kernels 216 and 177
//   registers and no spills (254 and 255 at D = 128). Shared memory at
//   D = 512: 153 KB (dK/dV) and 170 KB (dQ), one block an SM.
// - CW = NV_DQK = 192, the narrow-V path (Dv <= 128 < D <= 192, multi-head
//   latent attention's 192/128): one slice and one chunk, so S and dP are
//   formed once per tile pair and each block owns dK at D and dV at Dv (160
//   f32 accumulators a thread), or dQ at D (96). 63 KB (dK/dV) and 84 KB
//   (dQ) of shared memory; ptxas gives both 255 registers and no spills.

constexpr int TCW_BQ = 16;  // queries per ring stage of the wide dK/dV kernel
constexpr int TCW_BK = 32;  // keys per ring stage of the wide dQ kernel

template <int CW>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkv_tc_wide_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk, int D,
                             int q_sb, int q_sl, int q_sh, int o_sb, int o_sl, int o_sh,
                             int k_sb, int k_sl, int k_sh, int v_sb, int v_sl, int v_sh,
                             float scale, int causal, int Dv) {
  using namespace tc;
  constexpr int PQ = CW + PAD;  // row pitch of the Q and K tiles (and staged dK)
  constexpr int PV = DC + PAD;  // row pitch of the dO and V tiles (and staged dV)
  constexpr int BQ = TCW_BQ;
  constexpr int SLOT = BQ * (PQ + PV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_c = n_chunks(D, CW);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [n_c][BK][PQ], then dK
  __nv_bfloat16* sV = sK + n_c * TC_BK * PQ;                         // [n_c][BK][PV], then dV
  __nv_bfloat16* sR = sV + n_c * TC_BK * PV;  // ring [2][Q chunk [BQ][PQ], dO chunk [BQ][PV]]
  float* sLse = reinterpret_cast<float*>(sR + 2 * SLOT);  // [2][BQ]
  float* sDelta = sLse + 2 * BQ;                           // [2][BQ]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * TC_BK;
  const int z = blockIdx.z;
  const int d0 = z * CW;  // this block's first dK and dV column (0 on the narrow-V path)
  if (CW == DC) Dv = D;   // the slice path: one width
  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const __nv_bfloat16* ob = dout + (long long)b * o_sb + (long long)h * o_sh;
  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)h * v_sh;
  const float* lse_b = lse + (long long)bh * Lq;
  const float* delta_b = delta + (long long)bh * Lq;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // keys
  const int t = lane & 3;   // queries
  const int wrow = warp * 16;

  const int n_q = (Lq + BQ - 1) / BQ;
  const int q_first = causal ? k0 / BQ : 0;
  const int n_st = (n_q - q_first) * n_c;  // stage st: query tile q_first + st / n_c

  // stage st's Q and dO chunk (and, for the last chunk, lse and Delta) into
  // ring slot st & 1; chunk i of a query tile is chunk (z + 1 + i) % n_c
  auto issue = [&](int st) {
    const int i = st % n_c;
    const int q0 = (q_first + st / n_c) * BQ;
    const int c = (z + 1 + i) % n_c;
    const int buf = st & 1;
    __nv_bfloat16* dst = sR + buf * SLOT;
    load_tile_async<BQ, CW, TC_THREADS>(dst, qb + c * CW, q_sl, q0, Lq, D - c * CW);
    load_tile_async<BQ, DC, TC_THREADS>(dst + BQ * PQ, ob + c * DC, o_sl, q0, Lq, Dv - c * DC);
    if (i == n_c - 1) {
      for (int r = threadIdx.x; r < 2 * BQ; r += TC_THREADS) {
        const int rr = r % BQ;
        const bool in = q0 + rr < Lq;
        const float* src = r < BQ ? lse_b : delta_b;
        cp_async_4((r < BQ ? sLse : sDelta) + buf * BQ + rr, in ? src + q0 + rr : src, in);
      }
    }
  };
  for (int c = 0; c < n_c; ++c) {
    load_tile_async<TC_BK, CW, TC_THREADS>(sK + c * TC_BK * PQ, kb + c * CW, k_sl, k0, Lk,
                                           D - c * CW);
    load_tile_async<TC_BK, DC, TC_THREADS>(sV + c * TC_BK * PV, vb + c * DC, v_sl, k0, Lk,
                                           Dv - c * DC);
  }
  if (n_st > 0) issue(0);
  cp_async_commit();

  const float sl2 = scale * 1.4426950408889634f;
  float acc_dk[CW / 8][4], acc_dv[DC / 8][4];
#pragma unroll
  for (int n = 0; n < CW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_dk[n][e] = 0.f;
      if (n < DC / 8) acc_dv[n][e] = 0.f;
    }
  float s[BQ / 8][4], dp[BQ / 8][4];

  for (int st = 0; st < n_st; ++st) {
    const int i = st % n_c;
    const int c = (z + 1 + i) % n_c;
    const int buf = st & 1;
    if (st + 1 < n_st) {
      issue(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st (and at st = 0, K and V) has landed
    const __nv_bfloat16* Qt = sR + buf * SLOT;
    const __nv_bfloat16* Ot = Qt + BQ * PQ;
    const __nv_bfloat16* Kc = sK + c * TC_BK * PQ;
    const __nv_bfloat16* Vc = sV + c * TC_BK * PV;

    if (i == 0) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    if constexpr (CW == DC) {  // the slice path: S^T += K_c Q_c^T and dP^T += V_c dO_c^T
#pragma unroll
      for (int ks = 0; ks < DC / 16; ++ks) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, Kc + (wrow + (lane & 15)) * PQ + ks * 16 + (lane >> 4) * 8);
        ldmatrix_x4(va, Vc + (wrow + (lane & 15)) * PQ + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < BQ / 16; ++np) {
          const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * PQ + ks * 16 +
                          ((lane >> 3) & 1) * 8;
          uint32_t qf[4], of[4];
          ldmatrix_x4(qf, Qt + off);
          ldmatrix_x4(of, Ot + off);
          mma_bf16(s[2 * np], ka, qf[0], qf[1]);
          mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
          mma_bf16(dp[2 * np], va, of[0], of[1]);
          mma_bf16(dp[2 * np + 1], va, of[2], of[3]);
        }
      }
    } else {
      // the narrow-V path, as many k-steps as the chunk's real widths need:
      // S^T += K_c Q_c^T and dP^T += V_c dO_c^T together over D_v's, then
      // S^T alone over the rest of D_qk
      const int nq = k_steps(D - c * CW, CW), nv = k_steps(Dv - c * DC, DC);
      const int a_row = wrow + (lane & 15), a_col = (lane >> 4) * 8;  // A: this warp's keys
      const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
      k_loop<DC / 16>(0, nv, [&](int ks) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, Kc + a_row * PQ + ks * 16 + a_col);
        ldmatrix_x4(va, Vc + a_row * PV + ks * 16 + a_col);
#pragma unroll
        for (int np = 0; np < BQ / 16; ++np) {
          uint32_t qf[4], of[4];
          ldmatrix_x4(qf, Qt + (np * 16 + b_row) * PQ + ks * 16 + b_col);
          ldmatrix_x4(of, Ot + (np * 16 + b_row) * PV + ks * 16 + b_col);
          mma_bf16(s[2 * np], ka, qf[0], qf[1]);
          mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
          mma_bf16(dp[2 * np], va, of[0], of[1]);
          mma_bf16(dp[2 * np + 1], va, of[2], of[3]);
        }
      });
      k_loop<(CW - DC) / 16, CW / 16>(nv, nq, [&](int ks) {
        uint32_t ka[4];
        ldmatrix_x4(ka, Kc + a_row * PQ + ks * 16 + a_col);
#pragma unroll
        for (int np = 0; np < BQ / 16; ++np) {
          uint32_t qf[4];
          ldmatrix_x4(qf, Qt + (np * 16 + b_row) * PQ + ks * 16 + b_col);
          mma_bf16(s[2 * np], ka, qf[0], qf[1]);
          mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
        }
      });
    }

    if (i == n_c - 1) {  // S^T and dP^T are complete; the slot holds slice z
      const float* Lt = sLse + buf * BQ;
      const float* Dt = sDelta + buf * BQ;
      const int q0 = (q_first + st / n_c) * BQ;
      const bool need_mask = (causal && q0 < k0 + TC_BK - 1) || q0 + BQ > Lq || k0 + TC_BK > Lk;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          float p = exp2f(fminf(s[j][e] * sl2 - Lt[qc] * 1.4426950408889634f, 0.f));
          if (need_mask) {
            const int qpos = q0 + qc;
            const int kpos = k0 + wrow + g + (e >> 1) * 8;
            if (qpos >= Lq || kpos >= Lk || (causal && qpos < kpos)) p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Dt[qc]) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const int row = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8);
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
        // dV += bf16(P^T) dO_z and dK += bf16(dS^T) Q_z, together over dV's
        // columns, then dK alone over the rest of D_qk (columns past D_v and
        // D_qk: zeros, never written)
#pragma unroll
        for (int np = 0; np < DC / 16; ++np) {
          uint32_t of[4], qf[4];
          if constexpr (CW == DC) {  // the slice path: one pitch, one offset
            const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PQ + np * 16 +
                            (lane >> 4) * 8;
            ldmatrix_x4_trans(of, Ot + off);
            ldmatrix_x4_trans(qf, Qt + off);
          } else {
            ldmatrix_x4_trans(of, Ot + row * PV + np * 16 + (lane >> 4) * 8);
            ldmatrix_x4_trans(qf, Qt + row * PQ + np * 16 + (lane >> 4) * 8);
          }
          mma_bf16(acc_dv[2 * np], pa, of[0], of[1]);
          mma_bf16(acc_dv[2 * np + 1], pa, of[2], of[3]);
          mma_bf16(acc_dk[2 * np], da, qf[0], qf[1]);
          mma_bf16(acc_dk[2 * np + 1], da, qf[2], qf[3]);
        }
#pragma unroll
        for (int np = DC / 16; np < CW / 16; ++np) {
          uint32_t qf[4];
          ldmatrix_x4_trans(qf, Qt + row * PQ + np * 16 + (lane >> 4) * 8);
          mma_bf16(acc_dk[2 * np], da, qf[0], qf[1]);
          mma_bf16(acc_dk[2 * np + 1], da, qf[2], qf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with ring slot `buf` before it is refilled
  }

  // stage dK and dV as bf16 over the first K and V chunks, store them coalesced
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int n = 0; n < CW / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = wrow + g + 8 * hh;
      *reinterpret_cast<uint32_t*>(sK + row * PQ + col) =
          pack_bf16(acc_dk[n][2 * hh], acc_dk[n][2 * hh + 1]);
      if (n < DC / 8)
        *reinterpret_cast<uint32_t*>(sV + row * PV + col) =
            pack_bf16(acc_dv[n][2 * hh], acc_dv[n][2 * hh + 1]);
    }
  }
  __syncthreads();
  store_tile<TC_BK, CW, TC_THREADS>(dk + ((long long)b * Lk * H + h) * D + d0, (long long)H * D,
                                    sK, k0, Lk, D - d0);
  store_tile<TC_BK, DC, TC_THREADS>(dv + ((long long)b * Lk * H + h) * Dv + d0,
                                    (long long)H * Dv, sV, k0, Lk, Dv - d0);
}

template <int CW>
int launch_dkv_tc_wide(const void* q, const void* dout, const void* lse, const void* delta,
                       const void* k, const void* v, void* dk, void* dv, int B, int H, int Lq,
                       int Lk, int D, int Dv, int q_sb, int q_sl, int q_sh, int o_sb, int o_sl,
                       int o_sh, int k_sb, int k_sl, int k_sh, int v_sb, int v_sl, int v_sh,
                       float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (n_chunks(D, CW) * TC_BK + 2 * TCW_BQ) *
                          (CW + tc::PAD + DC + tc::PAD) +
                      sizeof(float) * 4 * TCW_BQ;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_wide_kernel<CW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Lk + TC_BK - 1) / TC_BK, n_chunks(D, CW));
  flash_bwd_dkv_tc_wide_kernel<CW><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, Lq, Lk, D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh,
      k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal, Dv);
  return (int)cudaGetLastError();
}

template <int CW>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_tc_wide_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ dq,
                            int H, int Lq, int Lk, int D, int q_sb, int q_sl, int q_sh,
                            int o_sb, int o_sl, int o_sh, int k_sb, int k_sl, int k_sh,
                            int v_sb, int v_sl, int v_sh, float scale, int causal, int Dv) {
  using namespace tc;
  constexpr int PQ = CW + PAD;  // row pitch of the Q and K tiles (and staged dQ)
  constexpr int PV = DC + PAD;  // row pitch of the dO and V tiles
  constexpr int BQ = TC_DQ_BQ, BK = TCW_BK;
  constexpr int SLOT = BK * (PQ + PV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_c = n_chunks(D, CW);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [n_c][BQ][PQ], then dQ
  __nv_bfloat16* sO = sQ + n_c * BQ * PQ;                            // [n_c][BQ][PV] dO
  __nv_bfloat16* sR = sO + n_c * BQ * PV;  // ring [2][K chunk [BK][PQ], V chunk [BK][PV]]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * BQ;
  const int z = blockIdx.z;
  const int d0 = z * CW;
  if (CW == DC) Dv = D;  // the slice path: one width
  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const __nv_bfloat16* ob = dout + (long long)b * o_sb + (long long)h * o_sh;
  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)h * v_sh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // queries
  const int t = lane & 3;   // keys
  const int wrow = warp * 16;

  int n_k = (Lk + BK - 1) / BK;
  if (causal && n_k > (q0 + BQ - 1) / BK + 1) n_k = (q0 + BQ - 1) / BK + 1;
  const int n_st = n_k * n_c;  // stage st: key tile st / n_c

  // stage st's K and V chunk into ring slot st & 1; chunk i of a key tile
  // is chunk (z + 1 + i) % n_c
  auto issue = [&](int st) {
    const int k0 = (st / n_c) * BK;
    const int c = (z + 1 + st % n_c) % n_c;
    __nv_bfloat16* dst = sR + (st & 1) * SLOT;
    load_tile_async<BK, CW, TC_THREADS>(dst, kb + c * CW, k_sl, k0, Lk, D - c * CW);
    load_tile_async<BK, DC, TC_THREADS>(dst + BK * PQ, vb + c * DC, v_sl, k0, Lk, Dv - c * DC);
  };
  for (int c = 0; c < n_c; ++c) {
    load_tile_async<BQ, CW, TC_THREADS>(sQ + c * BQ * PQ, qb + c * CW, q_sl, q0, Lq, D - c * CW);
    load_tile_async<BQ, DC, TC_THREADS>(sO + c * BQ * PV, ob + c * DC, o_sl, q0, Lq,
                                        Dv - c * DC);
  }
  issue(0);
  cp_async_commit();

  const float sl2 = scale * 1.4426950408889634f;
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qpos = q0 + wrow + g + 8 * hh;
    const bool in = qpos < Lq;
    lse2[hh] = in ? lse[(long long)bh * Lq + qpos] * 1.4426950408889634f : 0.f;
    dlt[hh] = in ? delta[(long long)bh * Lq + qpos] : 0.f;
  }

  float acc[CW / 8][4];
#pragma unroll
  for (int n = 0; n < CW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float s[BK / 8][4], dp[BK / 8][4];

  for (int st = 0; st < n_st; ++st) {
    const int i = st % n_c;
    const int c = (z + 1 + i) % n_c;
    if (st + 1 < n_st) {
      issue(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st (and at st = 0, Q and dO) has landed
    const __nv_bfloat16* Kt = sR + (st & 1) * SLOT;
    const __nv_bfloat16* Vt = Kt + BK * PQ;
    const __nv_bfloat16* Qc = sQ + c * BQ * PQ;
    const __nv_bfloat16* Oc = sO + c * BQ * PV;

    if (i == 0) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    if constexpr (CW == DC) {  // the slice path: S += Q_c K_c^T and dP += dO_c V_c^T
#pragma unroll
      for (int ks = 0; ks < DC / 16; ++ks) {
        uint32_t qf[4], of[4];
        ldmatrix_x4(qf, Qc + (wrow + (lane & 15)) * PQ + ks * 16 + (lane >> 4) * 8);
        ldmatrix_x4(of, Oc + (wrow + (lane & 15)) * PQ + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * PQ + ks * 16 +
                          ((lane >> 3) & 1) * 8;
          uint32_t kf[4], vf[4];
          ldmatrix_x4(kf, Kt + off);
          ldmatrix_x4(vf, Vt + off);
          mma_bf16(s[2 * np], qf, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
          mma_bf16(dp[2 * np], of, vf[0], vf[1]);
          mma_bf16(dp[2 * np + 1], of, vf[2], vf[3]);
        }
      }
    } else {
      // the narrow-V path, as many k-steps as the chunk's real widths need:
      // S += Q_c K_c^T and dP += dO_c V_c^T together over D_v's, then S
      // alone over the rest of D_qk
      const int nq = k_steps(D - c * CW, CW), nv = k_steps(Dv - c * DC, DC);
      const int a_row = wrow + (lane & 15), a_col = (lane >> 4) * 8;
      const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
      k_loop<DC / 16>(0, nv, [&](int ks) {
        uint32_t qf[4], of[4];
        ldmatrix_x4(qf, Qc + a_row * PQ + ks * 16 + a_col);
        ldmatrix_x4(of, Oc + a_row * PV + ks * 16 + a_col);
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t kf[4], vf[4];
          ldmatrix_x4(kf, Kt + (np * 16 + b_row) * PQ + ks * 16 + b_col);
          ldmatrix_x4(vf, Vt + (np * 16 + b_row) * PV + ks * 16 + b_col);
          mma_bf16(s[2 * np], qf, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
          mma_bf16(dp[2 * np], of, vf[0], vf[1]);
          mma_bf16(dp[2 * np + 1], of, vf[2], vf[3]);
        }
      });
      k_loop<(CW - DC) / 16, CW / 16>(nv, nq, [&](int ks) {
        uint32_t qf[4];
        ldmatrix_x4(qf, Qc + a_row * PQ + ks * 16 + a_col);
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, Kt + (np * 16 + b_row) * PQ + ks * 16 + b_col);
          mma_bf16(s[2 * np], qf, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
        }
      });
    }

    if (i == n_c - 1) {  // S and dP are complete; the slot holds K's slice z
      const int k0 = (st / n_c) * BK;
      const bool need_mask = (causal && k0 + BK - 1 > q0) || q0 + BQ > Lq || k0 + BK > Lk;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          float p = exp2f(fminf(s[j][e] * sl2 - lse2[hh], 0.f));
          if (need_mask) {
            const int qpos = q0 + wrow + g + 8 * hh;
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            if (qpos >= Lq || kpos >= Lk || (causal && qpos < kpos)) p = 0.f;
          }
          dp[j][e] = p * (dp[j][e] - dlt[hh]) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t da[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < CW / 16; ++np) {  // columns past D_qk: zeros, never written
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, Kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PQ +
                                    np * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], da, kf[0], kf[1]);
          mma_bf16(acc[2 * np + 1], da, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with ring slot st & 1 before it is refilled
  }

  // stage dQ as bf16 over Q's first chunk, store it coalesced
#pragma unroll
  for (int n = 0; n < CW / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sQ + (wrow + g) * PQ + col) = pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(sQ + (wrow + g + 8) * PQ + col) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  store_tile<BQ, CW, TC_THREADS>(dq + ((long long)b * Lq * H + h) * D + d0, (long long)H * D,
                                 sQ, q0, Lq, D - d0);
}

template <int CW>
int launch_dq_tc_wide(const void* q, const void* dout, const void* lse, const void* delta,
                      const void* k, const void* v, void* dq, int B, int H, int Lq, int Lk, int D,
                      int Dv, int q_sb, int q_sl, int q_sh, int o_sb, int o_sl, int o_sh,
                      int k_sb, int k_sl, int k_sh, int v_sb, int v_sl, int v_sh, float scale,
                      int causal, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (n_chunks(D, CW) * TC_DQ_BQ + 2 * TCW_BK) *
                      (CW + tc::PAD + DC + tc::PAD);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_wide_kernel<CW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Lq + TC_DQ_BQ - 1) / TC_DQ_BQ, n_chunks(D, CW));
  flash_bwd_dq_tc_wide_kernel<CW><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)dq,
      H, Lq, Lk, D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
      causal, Dv);
  return (int)cudaGetLastError();
}

}  // namespace pgt

// dk: contiguous [B, Lk, Hkv, D] and dv [B, Lk, Hkv, Dv] in the input dtype;
// D is the query/key width, 1 <= D <= MAX_D, and Dv the value width: Dv ==
// D, or in bf16 the narrow-V shape Dv <= DC < D <= NV_DQK. lse, delta:
// contiguous f32 [B*H, Lq]. bf16 runs on the tensor cores and needs D and
// Dv % 8 == 0, strides that are multiples of 8 elements and 16-byte-aligned
// q, dO, k, v (the wrapper makes a padded copy where a view is not so).
// k and v hold Hkv heads (H % Hkv == 0; query head h reads K/V head
// h / (H / Hkv)), and window > 0 keeps the pairs 0 <= i - j < window; both
// only in bf16 at D == Dv <= DC (the band instantiations), where each dK/dV
// block sums its group's query heads.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int pgt_flash_bwd_dkv(const void* q, const void* dout, const void* lse,
                                 const void* delta, const void* k, const void* v, void* dk,
                                 void* dv, int B, int H, int Lq, int Lk, int D, int Dv, int q_sb,
                                 int q_sl, int q_sh, int o_sb, int o_sl, int o_sh, int k_sb,
                                 int k_sl, int k_sh, int v_sb, int v_sl, int v_sh, float scale,
                                 int causal, int is_bf16, int Hkv, int window, void* stream) {
  if (pgt::bad_shape(B, H, Lq, Lk, D, Dv, is_bf16, Hkv, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    using pgt::tc::layout_ok;
    if (!layout_ok(q, D, q_sb, q_sl, q_sh) || !layout_ok(dout, Dv, o_sb, o_sl, o_sh) ||
        !layout_ok(k, D, k_sb, k_sl, k_sh) || !layout_ok(v, Dv, v_sb, v_sl, v_sh))
      return (int)cudaErrorInvalidValue;
    if (Dv != D)
      return pgt::launch_dkv_tc_wide<pgt::NV_DQK>(q, dout, lse, delta, k, v, dk, dv, B, H, Lq,
                                                  Lk, D, Dv, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh,
                                                  k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
                                                  causal, s);
    if (D > pgt::DC)
      return pgt::launch_dkv_tc_wide<pgt::DC>(q, dout, lse, delta, k, v, dk, dv, B, H, Lq, Lk,
                                              D, D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb,
                                              k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal, s);
    // a band (a window, or fewer K/V heads than query heads) takes the
    // kernels' BAND instantiation; without one they run as they always have
    const bool band = window != 0 || Hkv != H;
    const int group = H / Hkv;
    switch (pgt::tc::padded_d(D)) {
      case 48:
        return band ? pgt::launch_dkv_tc<48, 1>(q, dout, lse, delta, k, v, dk, dv, B, H, Lq, Lk,
                                                D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl,
                                                k_sh, v_sb, v_sl, v_sh, scale, causal, group,
                                                window, s)
                    : pgt::launch_dkv_tc<48, 0>(q, dout, lse, delta, k, v, dk, dv, B, H, Lq, Lk,
                                                D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl,
                                                k_sh, v_sb, v_sl, v_sh, scale, causal, 1, 0, s);
      case 64:
        return band ? pgt::launch_dkv_tc<64, 1>(q, dout, lse, delta, k, v, dk, dv, B, H, Lq, Lk,
                                                D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl,
                                                k_sh, v_sb, v_sl, v_sh, scale, causal, group,
                                                window, s)
                    : pgt::launch_dkv_tc<64, 0>(q, dout, lse, delta, k, v, dk, dv, B, H, Lq, Lk,
                                                D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl,
                                                k_sh, v_sb, v_sl, v_sh, scale, causal, 1, 0, s);
      default:
        return band ? pgt::launch_dkv_tc<128, 1>(q, dout, lse, delta, k, v, dk, dv, B, H, Lq, Lk,
                                                 D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb,
                                                 k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal,
                                                 group, window, s)
                    : pgt::launch_dkv_tc<128, 0>(q, dout, lse, delta, k, v, dk, dv, B, H, Lq, Lk,
                                                 D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb,
                                                 k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal, 1,
                                                 0, s);
    }
  }
  return pgt::launch_dkv(q, dout, lse, delta, k, v, dk, dv, B, H, Lq, Lk, D, q_sb, q_sl,
                                q_sh, o_sb, o_sl, o_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                                scale, causal, s);
}

// dq: contiguous [B, Lq, H, D] in the input dtype. The shapes and the bf16
// layout preconditions are pgt_flash_bwd_dkv's.
extern "C" int pgt_flash_bwd_dq(const void* q, const void* dout, const void* lse,
                                const void* delta, const void* k, const void* v, void* dq, int B,
                                int H, int Lq, int Lk, int D, int Dv, int q_sb, int q_sl,
                                int q_sh, int o_sb, int o_sl, int o_sh, int k_sb, int k_sl,
                                int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal,
                                int is_bf16, int Hkv, int window, void* stream) {
  if (pgt::bad_shape(B, H, Lq, Lk, D, Dv, is_bf16, Hkv, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    using pgt::tc::layout_ok;
    if (!layout_ok(q, D, q_sb, q_sl, q_sh) || !layout_ok(dout, Dv, o_sb, o_sl, o_sh) ||
        !layout_ok(k, D, k_sb, k_sl, k_sh) || !layout_ok(v, Dv, v_sb, v_sl, v_sh))
      return (int)cudaErrorInvalidValue;
    if (Dv != D)
      return pgt::launch_dq_tc_wide<pgt::NV_DQK>(q, dout, lse, delta, k, v, dq, B, H, Lq, Lk, D,
                                                 Dv, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb,
                                                 k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal, s);
    if (D > pgt::DC)
      return pgt::launch_dq_tc_wide<pgt::DC>(q, dout, lse, delta, k, v, dq, B, H, Lq, Lk, D, D,
                                             q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl, k_sh,
                                             v_sb, v_sl, v_sh, scale, causal, s);
    const bool band = window != 0 || Hkv != H;
    const int group = H / Hkv;
    switch (pgt::tc::padded_d(D)) {
      case 48:
        return band ? pgt::launch_dq_tc<48, 1>(q, dout, lse, delta, k, v, dq, B, H, Lq, Lk, D,
                                               q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl,
                                               k_sh, v_sb, v_sl, v_sh, scale, causal, group,
                                               window, s)
                    : pgt::launch_dq_tc<48, 0>(q, dout, lse, delta, k, v, dq, B, H, Lq, Lk, D,
                                               q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl,
                                               k_sh, v_sb, v_sl, v_sh, scale, causal, 1, 0, s);
      case 64:
        return band ? pgt::launch_dq_tc<64, 1>(q, dout, lse, delta, k, v, dq, B, H, Lq, Lk, D,
                                               q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl,
                                               k_sh, v_sb, v_sl, v_sh, scale, causal, group,
                                               window, s)
                    : pgt::launch_dq_tc<64, 0>(q, dout, lse, delta, k, v, dq, B, H, Lq, Lk, D,
                                               q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl,
                                               k_sh, v_sb, v_sl, v_sh, scale, causal, 1, 0, s);
      default:
        return band ? pgt::launch_dq_tc<128, 1>(q, dout, lse, delta, k, v, dq, B, H, Lq, Lk, D,
                                                q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl,
                                                k_sh, v_sb, v_sl, v_sh, scale, causal, group,
                                                window, s)
                    : pgt::launch_dq_tc<128, 0>(q, dout, lse, delta, k, v, dq, B, H, Lq, Lk, D,
                                                q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl,
                                                k_sh, v_sb, v_sl, v_sh, scale, causal, 1, 0, s);
    }
  }
  return pgt::launch_dq(q, dout, lse, delta, k, v, dq, B, H, Lq, Lk, D, q_sb, q_sl, q_sh,
                               o_sb, o_sl, o_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
                               causal, s);
}
