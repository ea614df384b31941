// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` in
// pygrid_tpu/parallel/pallas_attention.py (pl.pallas_call in `_fwd_impl`):
// softmax(q k^T * scale) v with an online softmax, f32 accumulation, and the
// per-row log-sum-exp the backward kernels recompute P from.
//
// What bounds it on the card: at the federated transformer's shape
// ([32, 512, 4, 128] bf16, causal) the work is ~8.6 GFLOP against ~67 MB of
// traffic, so a tensor-core kernel would be bound by bytes (~20 us). This
// first version does its products with f32 FMA on the CUDA cores (67 TFLOP/s
// peak, fed from shared memory), so it is bound by operations: the shared
// memory reads of the 4x4 register tiles and the FMA rate. What the design
// does about the bytes: each (b*h, 64-query tile) block reads its Q tile
// once and streams each K/V tile once through shared memory, keeps the
// running max, sum and the output accumulator on chip, and writes O and lse
// once; the L x L scores never reach device memory. Causal K tiles entirely
// above the diagonal are skipped (about half the work at L = 512).
// The next step is mma.sync / wgmma for the two products.
//
// The TPU's sequential "arbitrary" grid axis over K blocks becomes the loop
// over K tiles inside one thread block.
#include "flash_common.cuh"

namespace pgt {

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk, int D,
                 int q_sb, int q_sl, int q_sh, int k_sb, int k_sl, int k_sh, int v_sb,
                 int v_sl, int v_sh, float scale, int causal) {
  extern __shared__ float smem[];
  const int pitch = pitch_of(D);
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
  const T* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const T* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)h * v_sh;

  const int tx = threadIdx.x & 15;  // columns tx + 16 j
  const int ty = threadIdx.x >> 4;  // rows 4 ty + i
  const int srow = threadIdx.x >> 2;  // softmax: 4 threads per row
  const int sl4 = threadIdx.x & 3;

  load_tile(sQ, pitch, qb, q_sl, q0, Lq, D);

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
    __syncthreads();  // the previous step is done with sK, sV and sP
    load_tile(sK, pitch, kb, k_sl, k0, Lk, D);
    load_tile(sV, pitch, vb, v_sl, k0, Lk, D);
    __syncthreads();

    // scores S = Q K^T * scale for rows 4ty+i, keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
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
        prow[c] = round_to<T>(p);
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
        vv[j] = c < D ? sV[kk * pitch + c] : 0.f;
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
    T* orow = out + (((long long)b * Lq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int c = tx + 16 * j;
      if (c < D) orow[c] = from_f<T>(acc[i][j] * inv);
    }
  }
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const int qpos = q0 + r;
    if (qpos < Lq) lse[(long long)bh * Lq + qpos] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
               int Lq, int Lk, int D, int q_sb, int q_sl, int q_sh, int k_sb, int k_sl,
               int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * TILE * pitch_of(D) + TILE * SPITCH + 3 * TILE);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + TILE - 1) / TILE, B * H);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, H, Lq, Lk, D, q_sb, q_sl,
      q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace pgt

// out: contiguous [B, Lq, H, D] in the input dtype; lse: contiguous f32
// [B*H, Lq]. Returns the cudaError_t of the launch (0 = launched).
extern "C" int pgt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int H, int Lq, int Lk, int D, int q_sb, int q_sl, int q_sh,
                             int k_sb, int k_sl, int k_sh, int v_sb, int v_sl, int v_sh,
                             float scale, int causal, int is_bf16, void* stream) {
  if (D < 1 || D > pgt::MAX_D || Lq < 1 || Lk < 1 || B * H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return pgt::launch_fwd<__nv_bfloat16>(q, k, v, out, lse, B, H, Lq, Lk, D, q_sb, q_sl, q_sh,
                                          k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal, s);
  return pgt::launch_fwd<float>(q, k, v, out, lse, B, H, Lq, Lk, D, q_sb, q_sl, q_sh, k_sb,
                                k_sl, k_sh, v_sb, v_sl, v_sh, scale, causal, s);
}
