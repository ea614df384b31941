// Flash-attention backward for Hopper (sm_90a): the dK/dV pass and the dQ
// pass, two kernels off the forward's saved per-row log-sum-exp.
//
// Replace the TPU kernels `_bwd_dkv_kernel` and `_bwd_dq_kernel` in
// pygrid_tpu/parallel/pallas_attention.py (the two pl.pallas_call sites in
// `_flash_bwd`). Both recompute P = exp(min(s - lse, 0)) tile by tile;
// Delta = rowsum(dO * O) arrives precomputed (a plain torch op in the
// wrapper, as on the TPU path).
//
// What bounds them on the card: at the federated transformer's shape
// ([32, 512, 4, 128] bf16, causal) dK/dV is ~17 GFLOP against ~100 MB and
// dQ ~13 GFLOP against ~84 MB, so tensor-core kernels would be bound by
// bytes (~30 us and ~25 us). This first version runs all products as f32
// FMA on the CUDA cores from shared memory and is bound by operations.
// What the design does about the bytes: the two-pass layout keeps each
// gradient tile in registers for a whole sweep and writes it once -- no
// atomics, so results are the same from run to run -- and recomputes P
// instead of reading an L x L tensor. Causal tile pairs entirely above the
// diagonal are skipped. The next step is mma.sync / wgmma for the products.
//
// The TPU's sequential "arbitrary" grid axis (q innermost for dK/dV, k
// innermost for dQ) becomes the loop over tiles inside one thread block.
// Pad queries are masked as well as pad keys: their lse and Delta load as 0,
// and exp(s - 0) is finite but wrong, so query validity is in the mask.
#include "flash_common.cuh"

namespace pgt {

// grid (ceil(Lk / TILE), B*H): one block per (b*h, 64-key tile), looping
// over the query tiles; dK and dV stay in registers for the whole loop.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Lq, int Lk, int D, int q_sb, int q_sl,
                     int q_sh, int o_sb, int o_sl, int o_sh, int k_sb, int k_sl, int k_sh,
                     int v_sb, int v_sl, int v_sh, float scale, int causal) {
  extern __shared__ float smem[];
  const int pitch = pitch_of(D);
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
  const T* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const T* ob = dout + (long long)b * o_sb + (long long)h * o_sh;
  const T* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)h * v_sh;
  const float* lse_b = lse + (long long)bh * Lq;
  const float* delta_b = delta + (long long)bh * Lq;

  const int tx = threadIdx.x & 15;  // query columns tx + 16 j / head dims
  const int ty = threadIdx.x >> 4;  // key rows 4 ty + i

  load_tile(sK, pitch, kb, k_sl, k0, Lk, D);
  load_tile(sV, pitch, vb, v_sl, k0, Lk, D);

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
    __syncthreads();  // the previous step is done with sQ, sO, sP and sS
    load_tile(sQ, pitch, qb, q_sl, q0, Lq, D);
    load_tile(sO, pitch, ob, o_sl, q0, Lq, D);
    load_rows(sLse, lse_b, q0, Lq);
    load_rows(sDelta, delta_b, q0, Lq);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for keys 4ty+i, queries tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
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
        sP[r * SPITCH + c] = round_to<T>(p);
        sS[r * SPITCH + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q
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
        ov[j] = c < D ? sO[qq * pitch + c] : 0.f;
        qv[j] = c < D ? sQ[qq * pitch + c] : 0.f;
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
    const long long row = (((long long)b * Lk + kpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        dk[row + c] = from_f<T>(acc_dk[i][j]);
        dv[row + c] = from_f<T>(acc_dv[i][j]);
      }
    }
  }
}

// grid (ceil(Lq / TILE), B*H): one block per (b*h, 64-query tile), looping
// over the key tiles; dQ stays in registers for the whole loop.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ dq, int H,
                    int Lq, int Lk, int D, int q_sb, int q_sl, int q_sh, int o_sb, int o_sl,
                    int o_sh, int k_sb, int k_sl, int k_sh, int v_sb, int v_sl, int v_sh,
                    float scale, int causal) {
  extern __shared__ float smem[];
  const int pitch = pitch_of(D);
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
  const T* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const T* ob = dout + (long long)b * o_sb + (long long)h * o_sh;
  const T* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)h * v_sh;

  const int tx = threadIdx.x & 15;  // key columns tx + 16 j / head dims
  const int ty = threadIdx.x >> 4;  // query rows 4 ty + i

  load_tile(sQ, pitch, qb, q_sl, q0, Lq, D);
  load_tile(sO, pitch, ob, o_sl, q0, Lq, D);
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
    __syncthreads();  // the previous step is done with sK, sV and sS
    load_tile(sK, pitch, kb, k_sl, k0, Lk, D);
    load_tile(sV, pitch, vb, v_sl, k0, Lk, D);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for queries 4ty+i, keys tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
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
        sS[r * SPITCH + c] = round_to<T>(p * (dp[i][j] - sDelta[r]) * scale);
      }
    }
    __syncthreads();

    // dQ += dS K
    for (int kk = 0; kk < TILE; ++kk) {
      float ds[4], kv[JD];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sS[(4 * ty + i) * SPITCH + kk];
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const int c = tx + 16 * j;
        kv[j] = c < D ? sK[kk * pitch + c] : 0.f;
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
    T* row = dq + (((long long)b * Lq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int c = tx + 16 * j;
      if (c < D) row[c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_dkv(const void* q, const void* dout, const void* lse, const void* delta,
               const void* k, const void* v, void* dk, void* dv, int B, int H, int Lq, int Lk,
               int D, int q_sb, int q_sl, int q_sh, int o_sb, int o_sl, int o_sh, int k_sb,
               int k_sl, int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * TILE * pitch_of(D) + 2 * TILE * SPITCH + 2 * TILE);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lk + TILE - 1) / TILE, B * H);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)dout, (const float*)lse, (const float*)delta, (const T*)k,
      (const T*)v, (T*)dk, (T*)dv, H, Lq, Lk, D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl,
      k_sh, v_sb, v_sl, v_sh, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* dout, const void* lse, const void* delta,
              const void* k, const void* v, void* dq, int B, int H, int Lq, int Lk, int D,
              int q_sb, int q_sl, int q_sh, int o_sb, int o_sl, int o_sh, int k_sb, int k_sl,
              int k_sh, int v_sb, int v_sl, int v_sh, float scale, int causal,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * TILE * pitch_of(D) + TILE * SPITCH + 2 * TILE);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + TILE - 1) / TILE, B * H);
  flash_bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)dout, (const float*)lse, (const float*)delta, (const T*)k,
      (const T*)v, (T*)dq, H, Lq, Lk, D, q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl, k_sh,
      v_sb, v_sl, v_sh, scale, causal);
  return (int)cudaGetLastError();
}

inline bool bad_shape(int B, int H, int Lq, int Lk, int D) {
  return D < 1 || D > MAX_D || Lq < 1 || Lk < 1 || B * H < 1 || B * H > 65535;
}

}  // namespace pgt

// dk, dv: contiguous [B, Lk, H, D] in the input dtype. lse, delta: contiguous
// f32 [B*H, Lq]. Returns the cudaError_t of the launch (0 = launched).
extern "C" int pgt_flash_bwd_dkv(const void* q, const void* dout, const void* lse,
                                 const void* delta, const void* k, const void* v, void* dk,
                                 void* dv, int B, int H, int Lq, int Lk, int D, int q_sb,
                                 int q_sl, int q_sh, int o_sb, int o_sl, int o_sh, int k_sb,
                                 int k_sl, int k_sh, int v_sb, int v_sl, int v_sh, float scale,
                                 int causal, int is_bf16, void* stream) {
  if (pgt::bad_shape(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return pgt::launch_dkv<__nv_bfloat16>(q, dout, lse, delta, k, v, dk, dv, B, H, Lq, Lk, D,
                                          q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl, k_sh,
                                          v_sb, v_sl, v_sh, scale, causal, s);
  return pgt::launch_dkv<float>(q, dout, lse, delta, k, v, dk, dv, B, H, Lq, Lk, D, q_sb, q_sl,
                                q_sh, o_sb, o_sl, o_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                                scale, causal, s);
}

// dq: contiguous [B, Lq, H, D] in the input dtype.
extern "C" int pgt_flash_bwd_dq(const void* q, const void* dout, const void* lse,
                                const void* delta, const void* k, const void* v, void* dq, int B,
                                int H, int Lq, int Lk, int D, int q_sb, int q_sl, int q_sh,
                                int o_sb, int o_sl, int o_sh, int k_sb, int k_sl, int k_sh,
                                int v_sb, int v_sl, int v_sh, float scale, int causal,
                                int is_bf16, void* stream) {
  if (pgt::bad_shape(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return pgt::launch_dq<__nv_bfloat16>(q, dout, lse, delta, k, v, dq, B, H, Lq, Lk, D, q_sb,
                                         q_sl, q_sh, o_sb, o_sl, o_sh, k_sb, k_sl, k_sh, v_sb,
                                         v_sl, v_sh, scale, causal, s);
  return pgt::launch_dq<float>(q, dout, lse, delta, k, v, dq, B, H, Lq, Lk, D, q_sb, q_sl, q_sh,
                               o_sb, o_sl, o_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
                               causal, s);
}
