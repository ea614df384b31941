// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout contract with the Python wrappers (pygrid_tpu_torch/parallel/
// flash_attention.py): q, k, v and dO are [B, L, H, D] views whose last
// dimension is contiguous; the wrapper passes the batch, sequence and head
// strides in elements, so the [B, L, H, D] -> [B*H, L, D] transpose copy of
// the TPU path never happens. Outputs (out, dq, dk, dv) are freshly
// allocated contiguous [B, L, H, D]; the per-row statistics (lse, delta)
// are contiguous f32 [B*H, Lq].
//
// The f32 kernels are FMA on the CUDA cores from tiles in shared memory,
// loaded by the helpers below; the bf16 forward, dK/dV and dQ kernels run on
// the tensor cores from bf16 tiles (tc_common.cuh). Ragged edges are handled
// by masking inside the kernels: rows past L load as zero and are never
// written, columns past D are never written, so nothing is padded in device
// memory -- except that the
// tensor-core kernels' 16-byte copies need D and the strides in multiples
// of 8 elements, and the wrapper pads a view that does not meet that.
//
// Head dims wider than DC = 128 columns (up to MAX_D = 512) run with a
// D-slice grid axis: each block owns DC output columns and keeps the
// accumulators of a D <= 128 block for them, while the full-D contractions
// (S = Q K^T, dP = dO V^T) stream D in DC-wide chunks through shared memory.
// The values may be narrower than the queries and keys (multi-head latent
// attention: D = 192, Dv = 128). Where Dv <= DC < D <= NV_DQK, the bf16
// kernels take the narrow-V path: the same wide kernels with 192-wide
// chunks, so that one block owns all of its outputs (O and dV at Dv, dK and
// dQ at D), S is formed once per tile pair over D and dP over Dv, and no
// slice axis recomputes them. The f32 kernels take one D.
//
// A band -- a sliding window W (query i sees key j where 0 <= i - j < W) or
// k and v at Hkv < H heads (grouped-query attention) -- runs in the bf16
// D <= DC kernels' BAND = 1 instantiations; BAND = 0 compiles the code
// without either, so an unbanded launch runs as it did before bands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pgt {

constexpr int TILE = 64;       // query rows and key rows per tile
constexpr int DC = 128;        // head-dim columns a block owns; contraction chunk width
constexpr int MAX_D = 512;     // widest head dim: the wide kernels' shared memory
constexpr int NV_DQK = 192;    // widest query/key dim of the narrow-V path: dK's registers
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int JD = DC / 16;    // head-dim columns per thread
constexpr int SPITCH = TILE + 1;  // row pitch of a [TILE, TILE] score tile
constexpr float NEG = -1e30f;  // finite "-inf" of the running max

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// W-wide chunks (and output slices) of a head dim D: W = DC, or a wide
// kernel's chunk width CW
__host__ __device__ __forceinline__ int n_chunks(int D, int W) { return (D + W - 1) / W; }

// 16-wide k-steps of a contraction over the first `width` columns of a
// tile `cap` columns wide: none runs over a whole 16 columns of zeros.
__host__ __device__ __forceinline__ int k_steps(int width, int cap) {
  return (imin(width, cap) + 15) / 16;
}

// Shapes no kernel takes: D is the query/key width and Dv the value width,
// which only the bf16 narrow-V path lets differ from D. Hkv is the number of
// K/V heads (a divisor of H: query head h reads K/V head h / (H / Hkv)) and
// window the band's width (0: none); only the bf16 D <= DC kernels take a
// band, that is a window or Hkv < H.
inline bool bad_shape(int B, int H, int Lq, int Lk, int D, int Dv, int is_bf16, int Hkv,
                      int window) {
  const bool narrow_v = is_bf16 && Dv >= 1 && Dv <= DC && DC < D && D <= NV_DQK;
  const bool band = window != 0 || Hkv != H;
  return D < 1 || D > MAX_D || (Dv != D && !narrow_v) || Lq < 1 || Lk < 1 || B * H < 1 ||
         B * H > 65535 || Hkv < 1 || H % Hkv != 0 || window < 0 ||
         (band && (!is_bf16 || D > DC || Dv != D));
}

// The band of a sliding window W: query i sees key j where 0 <= i - j < W.
// A kernel with a band takes W from its argument, 0 meaning no window, which
// is a band wider than any sequence.
__host__ __device__ __forceinline__ int band_width(int window) {
  return window > 0 ? window : (1 << 30);
}

// The first T-wide key tile that a query tile starting at q0 meets in a band
// of width W: the tile of key q0 - W + 1, or 0.
__host__ __device__ __forceinline__ int band_first(int q0, int W, int T) {
  return q0 >= W ? (q0 - W + 1) / T : 0;
}

// Row pitch of a [TILE, D] tile in shared memory: the +1 puts neighbouring
// rows in neighbouring banks for the column-wise reads of the products.
__host__ __device__ __forceinline__ int pitch_of(int D) { return D + 1; }

// Copy rows [row0, row0 + TILE) of one (b, h) slice into shared memory as
// f32; rows at or past L read as zero.
__device__ __forceinline__ void load_tile(float* dst, int pitch, const float* src,
                                          long long row_stride, int row0, int L, int D) {
  for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = row0 + r;
    dst[r * pitch + c] = row < L ? src[(long long)row * row_stride + c] : 0.f;
  }
}

// rows [row0, row0 + TILE) of a contiguous f32 [L] vector; past L reads 0
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int L) {
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    dst[i] = row0 + i < L ? src[row0 + i] : 0.f;
  }
}

}  // namespace pgt
