// Exact matrix product over Z_2^64 for Hopper (sm_90a).
//
// Replaces the TPU kernel `_matmul_kernel` in pygrid_tpu/smpc/pallas_kernels.py
// (pl.pallas_call in `pallas_ring_matmul`): C = A B mod 2^64 for the SMPC
// plane's Beaver rounds and triple dealing. The TPU has no 64-bit integer
// unit, so the reference splits each operand into eight 8-bit limbs and runs
// 36 exact f32 MXU dots per K chunk, then folds them back with carries. The
// CUDA cores multiply 64-bit integers directly (a few 32-bit IMADs each), and
// unsigned arithmetic wraps mod 2^64 by definition, so this first kernel is a
// plain tiled multiply-accumulate in `unsigned long long`: the int64 operands
// are reinterpreted as unsigned (signed overflow is undefined in C++).
//
// What bounds it on the card: the least work this repo knows for the
// function is the 36 u8 limb products on the int8 tensor cores (36 * 2 * M N K
// operations at 1,979 TOPS) against 8 (MK + KN + MN) bytes per batch element
// at 3.35 TB/s; at the main path's [8, 512, 512]^3 that is ~39 us (operations)
// and at [512, 64, 64]^3 ~15 us (bytes). This kernel runs on the CUDA cores'
// integer pipes instead, so it is bound by their IMAD rate. What the design
// does about the bytes: each 64x64 output tile keeps its 16 sums in registers
// per thread across the whole K loop, A and B stream once per tile through
// shared memory in 16-deep slices, and C is written once.
// The next step is u8 limbs on the int8 tensor cores (mma.sync, then wgmma),
// with K chunked so that no s32 partial sum overflows.
//
// Grid: x over N tiles, y over M tiles, z over the batch (B1 * B2). Every
// operand is read through four strides (two batch axes, rows, columns), so a
// stride-0 batch axis (an operand broadcast with `expand`) costs no copy;
// ragged M, N and K are masked, not padded.
#include <cuda_runtime.h>

namespace pgt {

typedef unsigned long long u64;

constexpr int TM = 64;  // output tile rows
constexpr int TN = 64;  // output tile columns
constexpr int TK = 16;  // K slice staged in shared memory
constexpr int THREADS = 256;
constexpr int MAX_GRID_YZ = 65535;  // the grid's y and z limit

__global__ void __launch_bounds__(THREADS)
ring_matmul_kernel(const u64* __restrict__ a, const u64* __restrict__ b, u64* __restrict__ c,
                   int B2, int M, int N, int K, long long a_s1, long long a_s2,
                   long long a_sm, long long a_sk, long long b_s1, long long b_s2,
                   long long b_sk, long long b_sn, long long c_s1, long long c_s2,
                   long long c_sm, long long c_sn) {
  // sA row pitch TK + 1: the two rows a warp reads at once fall in other banks
  __shared__ u64 sA[TM][TK + 1];
  __shared__ u64 sB[TK][TN];

  const int tx = threadIdx.x & 15;  // columns tx + 16 j
  const int ty = threadIdx.x >> 4;  // rows ty + 16 i
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;

  const int z1 = blockIdx.z / B2;
  const int z2 = blockIdx.z - z1 * B2;
  const u64* ab = a + z1 * a_s1 + z2 * a_s2;
  const u64* bb = b + z1 * b_s1 + z2 * b_s2;

  u64 acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0ull;

  for (int k0 = 0; k0 < K; k0 += TK) {
    __syncthreads();  // the previous slice is consumed
    for (int e = threadIdx.x; e < TM * TK; e += THREADS) {
      const int r = e / TK, kk = e - r * TK;
      const int m = m0 + r, k = k0 + kk;
      sA[r][kk] = (m < M && k < K) ? ab[m * a_sm + k * a_sk] : 0ull;
    }
    for (int e = threadIdx.x; e < TK * TN; e += THREADS) {
      const int kk = e / TN, cc = e - kk * TN;
      const int k = k0 + kk, n = n0 + cc;
      sB[kk][cc] = (k < K && n < N) ? bb[k * b_sk + n * b_sn] : 0ull;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      u64 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];  // wraps mod 2^64
    }
  }

  u64* cb = c + z1 * c_s1 + z2 * c_s2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) cb[m * c_sm + n * c_sn] = acc[i][j];
    }
  }
}

}  // namespace pgt

// a: [B1, B2, M, K], b: [B1, B2, K, N], c: [B1, B2, M, N], all int64 read as
// u64 through the given element strides. Returns the cudaError_t of the
// launch (0 = launched); cudaErrorInvalidValue for an empty shape or one past
// the grid's limits (B1 * B2 or the M tiles above 65535).
extern "C" int pgt_ring_matmul(const void* a, const void* b, void* c, int B1, int B2, int M,
                               int N, int K, long long a_s1, long long a_s2, long long a_sm,
                               long long a_sk, long long b_s1, long long b_s2, long long b_sk,
                               long long b_sn, long long c_s1, long long c_s2, long long c_sm,
                               long long c_sn, void* stream) {
  const long long batch = (long long)B1 * B2;
  const long long tiles_m = ((long long)M + pgt::TM - 1) / pgt::TM;
  if (B1 < 1 || B2 < 1 || M < 1 || N < 1 || K < 1 || batch > pgt::MAX_GRID_YZ ||
      tiles_m > pgt::MAX_GRID_YZ)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + pgt::TN - 1) / pgt::TN, (unsigned)tiles_m, (unsigned)batch);
  pgt::ring_matmul_kernel<<<grid, pgt::THREADS, 0, (cudaStream_t)stream>>>(
      (const pgt::u64*)a, (const pgt::u64*)b, (pgt::u64*)c, B2, M, N, K, a_s1, a_s2, a_sm, a_sk,
      b_s1, b_s2, b_sk, b_sn, c_s1, c_s2, c_sm, c_sn);
  return (int)cudaGetLastError();
}
