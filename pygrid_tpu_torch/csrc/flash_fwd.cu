// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` in
// pygrid_tpu/parallel/pallas_attention.py (pl.pallas_call in `_fwd_impl`):
// softmax(q k^T * scale) v with an online softmax, f32 accumulation, and the
// per-row log-sum-exp the backward kernels recompute P from.
//
// What bounds it on the card: at the federated transformer's shape
// ([32, 512, 4, 128] bf16, causal) the work is ~8.6 GFLOP against ~67 MB of
// traffic, so on the tensor cores it is bound by bytes (~20 us); even
// mma.sync at half the dense bf16 rate does the products in ~17 us. What
// stands between a kernel and that bound is data movement and occupancy.
//
// bf16 (the main path), flash_fwd_tc_kernel, in the FlashAttention-2 shape:
// one block of 4 warps per (b*h, 64-query tile), each warp owning 16 query
// rows. Q is copied once with cp.async and held in registers as ldmatrix A
// fragments; the 64-key K and V tiles are double-buffered in shared memory
// as bf16 (the copy of tile kt+1 is issued before the math of tile kt).
// S = Q K^T and O += P V run as m16n8k16 mma.sync with f32 accumulators in
// registers (V through ldmatrix.trans); the online softmax runs in registers
// in the log2 domain (scores pre-multiplied by scale * log2(e), row max and
// sum reduced across the 4 lanes of a quad), and P, rounded to bf16 as the
// reference's p.astype(v.dtype), goes from the C fragments of S straight to
// the A fragments of the PV product. l is summed from the f32 p. Masks apply
// only on the diagonal tile and the ragged last tile. O is normalised,
// staged through shared memory and stored with 16-byte writes; lse is
// written in natural log (m + log l), as the backward reads it. Causal K
// tiles above the diagonal are skipped, and the query tiles launch in
// reverse order so the longest rows of the causal triangle start first.
// At D = 128 a block takes 85 KB of shared memory and ptxas gives it 236
// registers without spills, so 2 blocks (8 warps) share an SM.
// chip_smoke.py's build phase prints the registers and spills and fails on
// a spill.
//
// f32 (the f32 parity checks, held at 1e-4, which neither bf16 nor TF32
// tensor cores give), flash_fwd_kernel: f32 FMA on the CUDA cores from f32
// tiles in shared memory, 64-row tiles, 256 threads with a 4x4 register
// tile each.
//
// With a band (BAND = 1: a sliding window W, or K/V at H / group heads), a
// query head reads K/V head h / group, the key loop starts at the first tile
// the band meets (band_first) and a tile that straddles the band's far edge
// is masked too; at W = 2,048 and L = 8,192 a block visits 45 % of the
// causal tile pairs.
//
// Next step: wgmma fed by TMA with a producer warp, and a persistent
// schedule over (b*h, query tile) pairs.
//
// The TPU's sequential "arbitrary" grid axis over K blocks becomes the loop
// over K tiles inside one thread block.
#include "flash_common.cuh"
#include "tc_common.cuh"

namespace pgt {

// grid (ceil(Lq / TILE), B*H, n_chunks(D, DC)): one block per (64-query tile,
// b*h, DC-wide slice of the output columns). Where D > DC, Q and K stream
// through shared memory in DC-wide chunks for the scores, and V's slice
// rides with the last chunk.
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Lq, int Lk, int D, int q_sb, int q_sl,
                 int q_sh, int k_sb, int k_sl, int k_sh, int v_sb, int v_sl, int v_sh,
                 float scale, int causal) {
  extern __shared__ float smem[];
  const int pitch = pitch_of(imin(D, DC));
  float* sQ = smem;                    // [TILE][pitch]
  float* sK = sQ + TILE * pitch;       // [TILE][pitch]
  float* sV = sK + TILE * pitch;       // [TILE][pitch]
  float* sP = sV + TILE * pitch;       // [TILE][SPITCH] scores, then P
  float* sAlpha = sP + TILE * SPITCH;  // [TILE] rescale of this step
  float* sL = sAlpha + TILE;           // [TILE] final row sums
  float* sM = sL + TILE;               // [TILE] final row maxima

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = blockIdx.x;
  const int q0 = qt * TILE;
  const int n_c = n_chunks(D, DC);
  const int d0 = blockIdx.z * DC;  // this block's output columns [d0, d0 + dv)
  const int dv = imin(DC, D - d0);
  const float* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const float* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const float* vb = v + (long long)b * v_sb + (long long)h * v_sh;

  const int tx = threadIdx.x & 15;  // columns tx + 16 j
  const int ty = threadIdx.x >> 4;  // rows 4 ty + i
  const int srow = threadIdx.x >> 2;  // softmax: 4 threads per row
  const int sl4 = threadIdx.x & 3;

  if (n_c == 1) load_tile(sQ, pitch, qb, q_sl, q0, Lq, D);

  float m_run = NEG;  // running max and sum of row `srow`
  float l_run = 0.f;
  float acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;

  int n_k = (Lk + TILE - 1) / TILE;
  // causal: a K tile whose first key is past the tile's last query is all
  // masked (kt * TILE > q0 + TILE - 1 <=> kt > qt) and is skipped
  if (causal && n_k > qt + 1) n_k = qt + 1;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * TILE;
    // scores S = Q K^T * scale for rows 4ty+i, keys tx+16j, chunk by chunk
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < n_c; ++c) {
      const int c0 = c * DC;
      const int dc = imin(DC, D - c0);
      __syncthreads();  // the previous step is done with sQ, sK, sV and sP
      if (n_c > 1) load_tile(sQ, pitch, qb + c0, q_sl, q0, Lq, dc);
      load_tile(sK, pitch, kb + c0, k_sl, k0, Lk, dc);
      if (c == n_c - 1) load_tile(sV, pitch, vb + d0, v_sl, k0, Lk, dv);
      __syncthreads();
      for (int d = 0; d < dc; ++d) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sQ[(4 * ty + i) * pitch + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * pitch + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
    }
    // masked lanes hold -inf: they never raise the max above its finite
    // start NEG, and exp(-inf - m) is exactly 0, so a row with every lane
    // masked so far keeps l = 0 instead of faking a uniform distribution
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool valid = kpos < Lk && (!causal || q0 + r >= kpos);
        sP[r * SPITCH + c] = valid ? s[i][j] * scale : neg_inf();
      }
    }
    __syncthreads();

    // online softmax of row `srow`, 4 threads per row
    {
      float* prow = sP + srow * SPITCH;
      float mx = NEG;
      for (int c = sl4; c < TILE; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      for (int c = sl4; c < TILE; c += 4) {
        const float p = expf(prow[c] - m_new);
        sum += p;
        prow[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (sl4 == 0) sAlpha[srow] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = sAlpha[4 * ty + i];
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] *= al;
    }
    for (int kk = 0; kk < TILE; ++kk) {
      float p[4], vv[JD];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(4 * ty + i) * SPITCH + kk];
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < dv ? sV[kk * pitch + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JD; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  if (sl4 == 0) {
    sL[srow] = l_run;
    sM[srow] = m_run;
  }
  __syncthreads();

  // normalise (rows with l = 0 are pad queries: guarded, never written)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int qpos = q0 + r;
    if (qpos >= Lq) continue;
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
    float* orow = out + (((long long)b * Lq + qpos) * H + h) * D + d0;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int c = tx + 16 * j;
      if (c < dv) orow[c] = acc[i][j] * inv;
    }
  }
  if (blockIdx.z == 0) {
    for (int r = threadIdx.x; r < TILE; r += THREADS) {
      const int qpos = q0 + r;
      if (qpos < Lq) lse[(long long)bh * Lq + qpos] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
    }
  }
}

int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
               int Lq, int Lk, int D, int q_sb, int q_sl, int q_sh, int k_sb, int k_sl,
               int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * TILE * pitch_of(imin(D, DC)) + TILE * SPITCH + 3 * TILE);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + TILE - 1) / TILE, B * H, n_chunks(D, DC));
  flash_fwd_kernel<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, H, Lq, Lk, D,
      q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores -------------------------------------------------

constexpr int TC_BM = 64;        // queries per block, 16 per warp
constexpr int TC_BN = 64;        // keys per K/V tile
constexpr int TC_THREADS = 128;  // 4 warps

template <int DP, int BAND>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int H, int Lq, int Lk, int D, int q_sb, int q_sl,
                    int q_sh, int k_sb, int k_sl, int k_sh, int v_sb, int v_sl, int v_sh,
                    float scale, int causal, int group, int window) {
  using namespace tc;
  constexpr int P = DP + PAD;  // row pitch of every shared tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][P], then O
  __nv_bfloat16* sK = sQ + TC_BM * P;                                // [2][BN][P]
  __nv_bfloat16* sV = sK + 2 * TC_BN * P;                            // [2][BN][P]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * TC_BM;
  const int hk = BAND ? h / group : h;  // the K/V head this query head reads
  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)hk * k_sh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)hk * v_sh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int wrow = warp * 16;

  int n_k = (Lk + TC_BN - 1) / TC_BN;
  // causal: a K tile whose first key is past the tile's last query is all
  // masked (kt > qt) and is skipped
  if (causal && n_k > qt + 1) n_k = qt + 1;
  // a band: the K tiles wholly before it (kt < kt0) are skipped too
  const int W = band_width(window);
  const int kt0 = BAND ? band_first(q0, W, TC_BN) : 0;

  load_tile_async<TC_BM, DP, TC_THREADS>(sQ, qb, q_sl, q0, Lq, D);
  load_tile_async<TC_BN, DP, TC_THREADS>(sK, kb, k_sl, kt0 * TC_BN, Lk, D);
  load_tile_async<TC_BN, DP, TC_THREADS>(sV, vb, v_sl, kt0 * TC_BN, Lk, D);
  cp_async_commit();

  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  uint32_t qf[DP / 16][4];                        // Q as A fragments
  float o[DP / 8][4];                             // O accumulators
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  // running max (log2 units) and this thread's partial sum of rows g, g+8
  float m_run[2] = {NEG, NEG};
  float l_run[2] = {0.f, 0.f};

  for (int kt = kt0; kt < n_k; ++kt) {
    const int cur = (kt - kt0) & 1;
    if (kt + 1 < n_k) {  // the next tile's copy runs under this tile's math
      const int nk0 = (kt + 1) * TC_BN;
      load_tile_async<TC_BN, DP, TC_THREADS>(sK + (cur ^ 1) * TC_BN * P, kb, k_sl, nk0, Lk, D);
      load_tile_async<TC_BN, DP, TC_THREADS>(sV + (cur ^ 1) * TC_BN * P, vb, v_sl, nk0, Lk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and at kt = kt0, Q) is in shared memory
    if (kt == kt0) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        ldmatrix_x4(qf[ks], sQ + (wrow + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = sK + cur * TC_BN * P;
    const __nv_bfloat16* Vt = sV + cur * TC_BN * P;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n8 tiles
    float s[TC_BN / 8][4];
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < TC_BN / 16; ++np) {
        uint32_t kf[4];  // B fragments of key tiles 2np and 2np+1
        ldmatrix_x4(kf, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale, then mask: only the diagonal tile, the ragged last tile and a
    // tile that straddles the band's far edge hold invalid lanes, which
    // become -inf (never above the finite start NEG of the running max, and
    // exp2(-inf) is exactly 0)
    const int k0 = kt * TC_BN;
    const bool need_mask = (causal && kt == qt) || k0 + TC_BN > Lk ||
                           (BAND && q0 + TC_BM - 1 - k0 >= W);
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[j][c] * sl2;
        if (need_mask) {
          const int kpos = k0 + 8 * j + 2 * t + (c & 1);
          const int qpos = q0 + wrow + g + (c >> 1) * 8;
          if (kpos >= Lk || (causal && qpos < kpos) || (BAND && qpos - kpos >= W)) x = neg_inf();
        }
        s[j][c] = x;
      }
    }

    // online softmax of rows g (c = 0, 1) and g + 8 (c = 2, 3)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hh], mx);
      const float alpha = exp2f(m_run[hh] - m_new);
      m_run[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * hh + e] - m_new);
          s[j][2 * hh + e] = p;
          sum += p;
        }
      }
      l_run[hh] = l_run[hh] * alpha + sum;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][2 * hh] *= alpha;
        o[n][2 * hh + 1] *= alpha;
      }
    }

    // O += bf16(P) V: the C fragments of key tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < TC_BN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t vf[4];  // B fragments of head-dim tiles 2np and 2np+1
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                  np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `cur` before it is refilled
  }

  // full row sums; normalise, stage O as bf16 in sQ (the Q fragments are in
  // registers and the loop ended on a barrier), then store it coalesced
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_run[hh] = fmaxf(l, 1e-30f);
  }
  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sQ + (wrow + g) * P + col) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(sQ + (wrow + g + 8) * P + col) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  if (t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qpos = q0 + wrow + g + 8 * hh;
      // natural log: m (log2 units) * ln 2 + log l
      if (qpos < Lq)
        lse[(long long)bh * Lq + qpos] = m_run[hh] * 0.6931471805599453f + logf(l_run[hh]);
    }
  }
  __syncthreads();
  store_tile<TC_BM, DP, TC_THREADS>(out + ((long long)b * Lq * H + h) * D, (long long)H * D, sQ,
                                    q0, Lq, D);
}

template <int DP, int BAND>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                  int H, int Lq, int Lk, int D, int q_sb, int q_sl, int q_sh, int k_sb, int k_sl,
                  int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal, int group,
                  int window, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (TC_BM + 4 * TC_BN) * (DP + tc::PAD);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<DP, BAND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Lq + TC_BM - 1) / TC_BM);
  flash_fwd_tc_kernel<DP, BAND><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, (float*)lse, H, Lq, Lk, D, q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb,
      v_sl, v_sh, scale, causal, group, window);
  return (int)cudaGetLastError();
}

// ---- bf16, D > 128: tensor cores, and a grid axis over V's slices --------
//
// flash_fwd_tc_wide_kernel<CW>: the tensor-core forward above for a query/key
// width D past DC = 128 (up to MAX_D) and a value width Dv of its own. The
// scores need all of D, so the 64-query Q tile stays in shared memory as
// n = ceil(D / CW) chunks CW columns wide (loaded once), K streams through a
// double-buffered ring one chunk a stage, and V's DC-wide output slice
// rides with K's last chunk; Q's A fragments are re-read by ldmatrix for
// every k-step, as the dQ kernel re-reads Q. On the narrow-V path the
// contraction runs as many k-steps as the chunk's real width needs
// (tc::k_loop: fully unrolled for a whole chunk), so none runs over columns
// of zeros; the slice path runs every chunk at its 128 columns. The grid's
// slice axis runs over Dv in DC-wide slices, each with the O accumulators
// of the D = 128 kernel; slice 0 writes lse. Dv is the last parameter, as in
// flash_bwd.cu's wide kernels.
// Two instantiations:
// - CW = DC (D = Dv > 128): every slice recomputes S, so the QK^T work
//   grows with the number of slices (2x at D = 256). 17 KB a Q chunk plus
//   68 KB of ring, 136 KB at D = 512; without Q's fragments in registers
//   ptxas gives it 178 registers and no spills (the D = 128 kernel: 236).
// - CW = NV_DQK = 192, the narrow-V path (Dv <= 128 < D <= 192, multi-head
//   latent attention's 192/128): one slice and one chunk, so S is formed
//   once per tile pair over D and O at Dv; Q 25 KB, ring 84 KB (two blocks
//   an SM), 233 registers and no spills.

template <int CW>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_wide_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int H, int Lq, int Lk, int D, int q_sb,
                         int q_sl, int q_sh, int k_sb, int k_sl, int k_sh, int v_sb, int v_sl,
                         int v_sh, float scale, int causal, int Dv) {
  using namespace tc;
  constexpr int PQ = CW + PAD;  // row pitch of the Q and K tiles
  constexpr int PV = DC + PAD;  // row pitch of the V tiles and the staged O
  constexpr int SLOT = TC_BN * (PQ + PV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_c = n_chunks(D, CW);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [n_c][BM][PQ], then O
  __nv_bfloat16* sR = sQ + n_c * TC_BM * PQ;  // ring [2][K chunk [BN][PQ], V slice [BN][PV]]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * TC_BM;
  const int d0 = blockIdx.z * DC;  // this block's output columns
  if (CW == DC) Dv = D;             // the slice path: one width
  const int dw = imin(DC, Dv - d0);
  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)h * v_sh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16;

  int n_k = (Lk + TC_BN - 1) / TC_BN;
  if (causal && n_k > qt + 1) n_k = qt + 1;
  const int n_st = n_k * n_c;  // stage st: K tile st / n_c, chunk st % n_c

  // stage st's K chunk (and, for the last chunk, V's slice) into ring slot st & 1
  auto issue = [&](int st) {
    const int kt = st / n_c, c = st - (st / n_c) * n_c;
    __nv_bfloat16* dst = sR + (st & 1) * SLOT;
    load_tile_async<TC_BN, CW, TC_THREADS>(dst, kb + c * CW, k_sl, kt * TC_BN, Lk, D - c * CW);
    if (c == n_c - 1)
      load_tile_async<TC_BN, DC, TC_THREADS>(dst + TC_BN * PQ, vb + d0, v_sl, kt * TC_BN, Lk, dw);
  };
  for (int c = 0; c < n_c; ++c)
    load_tile_async<TC_BM, CW, TC_THREADS>(sQ + c * TC_BM * PQ, qb + c * CW, q_sl, q0, Lq,
                                           D - c * CW);
  issue(0);
  cp_async_commit();

  const float sl2 = scale * 1.4426950408889634f;
  float o[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m_run[2] = {NEG, NEG};
  float l_run[2] = {0.f, 0.f};
  float s[TC_BN / 8][4];

  for (int st = 0; st < n_st; ++st) {
    const int kt = st / n_c, c = st - kt * n_c;
    if (st + 1 < n_st) {  // the next stage's copy runs under this stage's math
      issue(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st (and at st = 0, Q) is in shared memory
    const __nv_bfloat16* Kt = sR + (st & 1) * SLOT;
    const __nv_bfloat16* Qc = sQ + c * TC_BM * PQ;
    // the chunk's k-steps: the slice path's whole 128 columns (zeros past D
    // add nothing), the narrow-V path's to the real width
    const int nks = CW == DC ? CW / 16 : k_steps(D - c * CW, CW);

    if (c == 0) {
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    // S += Q_c K_c^T
    k_loop<CW / 16>(0, nks, [&](int ks) {
      uint32_t qf[4];
      ldmatrix_x4(qf, Qc + (wrow + (lane & 15)) * PQ + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < TC_BN / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * PQ + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
      }
    });

    if (c == n_c - 1) {  // S is complete: mask, online softmax, O += P V
      const __nv_bfloat16* Vt = Kt + TC_BN * PQ;
      const int k0 = kt * TC_BN;
      const bool need_mask = (causal && kt == qt) || k0 + TC_BN > Lk;
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * sl2;
          if (need_mask) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = q0 + wrow + g + (e >> 1) * 8;
            if (kpos >= Lk || (causal && qpos < kpos)) x = neg_inf();
          }
          s[j][e] = x;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < TC_BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hh], mx);
        const float alpha = exp2f(m_run[hh] - m_new);
        m_run[hh] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < TC_BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[j][2 * hh + e] - m_new);
            s[j][2 * hh + e] = p;
            sum += p;
          }
        }
        l_run[hh] = l_run[hh] * alpha + sum;
#pragma unroll
        for (int n = 0; n < DC / 8; ++n) {
          o[n][2 * hh] *= alpha;
          o[n][2 * hh + 1] *= alpha;
        }
      }
#pragma unroll
      for (int kk = 0; kk < TC_BN / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < DC / 16; ++np) {  // columns past Dv: zeros, never written
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PV +
                                    np * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * np], pa, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with ring slot st & 1 before it is refilled
  }

  // normalise, stage O as bf16 over Q's first chunk, store it coalesced
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_run[hh] = fmaxf(l, 1e-30f);
  }
  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sQ + (wrow + g) * PV + col) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(sQ + (wrow + g + 8) * PV + col) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  if (t == 0 && blockIdx.z == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qpos = q0 + wrow + g + 8 * hh;
      if (qpos < Lq)
        lse[(long long)bh * Lq + qpos] = m_run[hh] * 0.6931471805599453f + logf(l_run[hh]);
    }
  }
  __syncthreads();
  store_tile<TC_BM, DC, TC_THREADS>(out + ((long long)b * Lq * H + h) * Dv + d0,
                                    (long long)H * Dv, sQ, q0, Lq, dw);
}

template <int CW>
int launch_fwd_tc_wide(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                       int H, int Lq, int Lk, int D, int Dv, int q_sb, int q_sl, int q_sh,
                       int k_sb, int k_sl, int k_sh, int v_sb, int v_sl, int v_sh, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * ((n_chunks(D, CW) * TC_BM + 2 * TC_BN) *
                                                   (CW + tc::PAD) +
                                               2 * TC_BN * (DC + tc::PAD));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_wide_kernel<CW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Lq + TC_BM - 1) / TC_BM, n_chunks(Dv, DC));
  flash_fwd_tc_wide_kernel<CW><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, (float*)lse, H, Lq, Lk, D, q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb,
      v_sl, v_sh, scale, causal, Dv);
  return (int)cudaGetLastError();
}

}  // namespace pgt

// out: contiguous [B, Lq, H, Dv] in the input dtype; lse: contiguous f32
// [B*H, Lq]; D is the query/key width, 1 <= D <= MAX_D, and Dv the value
// width: Dv == D, or in bf16 the narrow-V shape Dv <= DC < D <= NV_DQK. bf16
// runs on the tensor cores and needs D and Dv % 8 == 0, strides that are
// multiples of 8 elements and 16-byte-aligned q, k, v (the wrapper makes a
// padded copy where a view is not so); D > DC takes the wide kernel. k and v
// hold Hkv heads (H % Hkv == 0; query head h reads K/V head h / (H / Hkv)),
// and window > 0 keeps the pairs 0 <= i - j < window: both only in bf16 at
// D == Dv <= DC, the tensor-core kernel's band instantiation.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int pgt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int H, int Lq, int Lk, int D, int Dv, int q_sb, int q_sl,
                             int q_sh, int k_sb, int k_sl, int k_sh, int v_sb, int v_sl, int v_sh,
                             float scale, int causal, int is_bf16, int Hkv, int window,
                             void* stream) {
  if (pgt::bad_shape(B, H, Lq, Lk, D, Dv, is_bf16, Hkv, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (!pgt::tc::layout_ok(q, D, q_sb, q_sl, q_sh) || !pgt::tc::layout_ok(k, D, k_sb, k_sl, k_sh) ||
        !pgt::tc::layout_ok(v, Dv, v_sb, v_sl, v_sh))
      return (int)cudaErrorInvalidValue;
    if (Dv != D)
      return pgt::launch_fwd_tc_wide<pgt::NV_DQK>(q, k, v, out, lse, B, H, Lq, Lk, D, Dv, q_sb,
                                                  q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                                                  scale, causal, s);
    if (D > pgt::DC)
      return pgt::launch_fwd_tc_wide<pgt::DC>(q, k, v, out, lse, B, H, Lq, Lk, D, D, q_sb, q_sl,
                                              q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
                                              causal, s);
    // a band (a window, or fewer K/V heads than query heads) takes the
    // kernels' BAND instantiation; without one they run as they always have
    const bool band = window != 0 || Hkv != H;
    const int group = H / Hkv;
    switch (pgt::tc::padded_d(D)) {
      case 48:
        return band ? pgt::launch_fwd_tc<48, 1>(q, k, v, out, lse, B, H, Lq, Lk, D, q_sb, q_sl,
                                                q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
                                                causal, group, window, s)
                    : pgt::launch_fwd_tc<48, 0>(q, k, v, out, lse, B, H, Lq, Lk, D, q_sb, q_sl,
                                                q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
                                                causal, 1, 0, s);
      case 64:
        return band ? pgt::launch_fwd_tc<64, 1>(q, k, v, out, lse, B, H, Lq, Lk, D, q_sb, q_sl,
                                                q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
                                                causal, group, window, s)
                    : pgt::launch_fwd_tc<64, 0>(q, k, v, out, lse, B, H, Lq, Lk, D, q_sb, q_sl,
                                                q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
                                                causal, 1, 0, s);
      default:
        return band ? pgt::launch_fwd_tc<128, 1>(q, k, v, out, lse, B, H, Lq, Lk, D, q_sb, q_sl,
                                                 q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
                                                 causal, group, window, s)
                    : pgt::launch_fwd_tc<128, 0>(q, k, v, out, lse, B, H, Lq, Lk, D, q_sb, q_sl,
                                                 q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
                                                 causal, 1, 0, s);
    }
  }
  return pgt::launch_fwd(q, k, v, out, lse, B, H, Lq, Lk, D, q_sb, q_sl, q_sh, k_sb,
                                k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal, s);
}
