// Exact matrix product over Z_2^64 for Hopper (sm_90a), on the int8 tensor
// cores.
//
// Replaces the TPU kernel `_matmul_kernel` in pygrid_tpu/smpc/pallas_kernels.py
// (pl.pallas_call in `pallas_ring_matmul`): C = A B mod 2^64 for the SMPC
// plane's Beaver rounds and triple dealing. The scheme is the reference's:
// each u64 operand splits into eight 8-bit limbs, a_i and b_j, and
//   A B = sum_{i + j < 8} (A_i B_j) << 8 (i + j)   (mod 2^64),
// because limb pairs with i + j >= 8 shift past bit 63. The reference runs
// the 36 limb products as exact f32 MXU dots; here they are
// mma.sync.m16n8k32 u8 x u8 -> s32 (mma_u8 in tc_common.cuh), whose integer
// products and sums are exact.
//
// What bounds it on the card: 36 u8 limb products are 36 * 2 * M N K
// operations at 1,979 TOPS dense int8, against 8 (MK + KN + MN) bytes per
// batch element at 3.35 TB/s: at the main path's [8, 512, 512]^3 that is
// 39 us (operations), at [512, 64, 64]^3 15 us (bytes). The u64 CUDA-core
// kernel this replaces ran on the integer pipes at about 10x the bound.
//
// Design. One block of 8 warps per 64 x 64 output tile (grid x over N
// tiles, y over M tiles, z over the batch B1 * B2); each warp owns 16 rows x
// 32 columns. K runs in 32-deep slices (one m16n8k32 step) in two stages,
// each double-buffered in shared memory:
//  - copy: every u64 element of the A slice [64 m][32 k] and of the B slice,
//    transposed to [64 n][32 k], by one 8-byte cp.async, through the four
//    strides each operand is given (two batch axes, rows, columns), so a
//    stride-0 broadcast batch and a transposed operand cost no copy; ragged
//    M, N and K are zero-filled (zero limbs add nothing);
//  - split: a slice that landed becomes eight u8 limb planes [8][128
//    rows][32 k], k contiguous (for B that is the .col layout), four
//    elements a thread at a time by byte permutes.
// With one barrier a slice, a warp copies slice k + 2, splits slice k + 1
// and multiplies slice k, so copies run under the products; the two warps
// of each SM sub-partition split and multiply in opposite orders, so one's
// split runs beside the other's mma (7.5% faster than one order for all;
// PERF.md). Every byte of A and B is read from device memory once per tile
// and no limb plane ever goes to device memory. A warp holds the A
// fragments of all eight limbs (32 registers) and loads the B fragments of
// one limb at a time: 24 ldmatrix for 144 mma a slice. 164 KB of shared
// memory and about 248 registers a thread, so one block (8 warps) an SM.
// What stands between it and the bound: mma.sync, not wgmma, and the split
// and copy instructions beside the products (PERF.md section 6).
//
// Exactness. The products accumulate in one s32 partial per output shift
// s = i + j (8 partial sets, 128 registers a thread). A k adds at most
// (s + 1) * 255^2 <= 8 * 255^2 = 520,200 to a partial, so over KC = 4096
// values of k a partial stays below 4096 * 520,200 = 2,130,739,200 < 2^31:
// it never wraps, and it is the exact non-negative sum. Every KC of K, and
// at the end, each partial folds into the output as (u64)(u32)part << 8s,
// added mod 2^64 (the first fold writes C, later ones add to it: the block
// owns its tile, so nothing races), and restarts at 0. Exactness does not
// rest on how the tensor cores treat an s32 overflow: there is none.
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace pgt {

typedef unsigned long long u64;

constexpr int TM = 64;       // output tile rows
constexpr int TN = 64;       // output tile columns
constexpr int TK = 32;       // K slice: one m16n8k32 step
constexpr int KC = 4096;     // K between folds of the s32 partials
constexpr int THREADS = 256; // 8 warps: 4 over M x 2 over N, 16 x 32 each
constexpr int ROWS = TM + TN;  // rows of a staged slice: A's, then B's
constexpr int RP = TK + 2;     // u64 pitch of a staged row: 16-byte aligned,
                               // and the reads below hit every bank once
constexpr int LP = TK + 16;    // byte pitch of a limb-plane row (the 8 rows of
                               // an ldmatrix in 8 different 16-byte bank groups)
constexpr int PLANE = ROWS * LP;              // bytes of one limb plane
constexpr int RAW = sizeof(u64) * ROWS * RP;  // bytes of one staged slice
constexpr int LIMBS = 8 * PLANE;              // bytes of one slice's limb planes
constexpr int MAX_GRID_YZ = 65535;            // the grid's y and z limit
constexpr size_t SMEM = 2 * RAW + 2 * LIMBS;  // both stages double-buffered

static_assert(KC % TK == 0, "a fold falls on a slice boundary");
static_assert(RAW % 16 == 0 && LIMBS % 16 == 0, "limb planes start 16-byte aligned");
static_assert(TM * TK == 8 * THREADS && TN * TK == 8 * THREADS, "8 copies a thread");

// Copy one operand's slice into a staged buffer, 8 copies a thread, one
// u64 each: FAST consecutive threads take consecutive elements of the
// operand's contiguous axis (src stride s_fast, dst stride d_fast), the
// others step along its other axis. Elements at or past fast_n / slow_n
// are zero-filled.
template <int FAST>
__device__ __forceinline__ void copy_operand(u64* dst, int d_fast, int d_slow, const u64* src,
                                             long long s_fast, long long s_slow, int fast0,
                                             int fast_n, int slow0, int slow_n) {
  constexpr int STEP = THREADS / FAST;
  const int f = threadIdx.x % FAST;
  const int sl = threadIdx.x / FAST;
  const bool f_in = fast0 + f < fast_n;
  const u64* p = src + (fast0 + f) * s_fast + (slow0 + sl) * s_slow;
  dst += f * d_fast + sl * d_slow;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const bool in = f_in && slow0 + sl + it * STEP < slow_n;
    tc::cp_async_8(dst + it * STEP * d_slow, in ? p + it * STEP * s_slow : src, in);
  }
}

__global__ void __launch_bounds__(THREADS)
ring_matmul_tc_kernel(const u64* __restrict__ a, const u64* __restrict__ b, u64* __restrict__ c,
                      int B2, int M, int N, int K, long long a_s1, long long a_s2,
                      long long a_sm, long long a_sk, long long b_s1, long long b_s2,
                      long long b_sk, long long b_sn, long long c_s1, long long c_s2,
                      long long c_sm, long long c_sn) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [2][ROWS][RP] u64 staged slices (A as [m][k], B as [n][k]), then
  // [2][8][ROWS][LP] u8 limb planes
  u64* sRaw = reinterpret_cast<u64*>(smem_raw);
  unsigned char* sL = smem_raw + 2 * RAW;

  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int z1 = blockIdx.z / B2;
  const int z2 = blockIdx.z - z1 * B2;
  const u64* ab = a + z1 * a_s1 + z2 * a_s2;
  const u64* bb = b + z1 * b_s1 + z2 * b_s2;
  u64* cb = c + z1 * c_s1 + z2 * c_s2;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp & 3) * 16;   // the warp's rows in the tile
  const int wn = (warp >> 2) * 32;  // its columns
  const int n_slices = (K + TK - 1) / TK;

  // slice ks into staged buffer `buf`, read along whichever axis of each
  // operand is contiguous (k, unless only the other one is)
  const bool a_m_fast = a_sm == 1 && a_sk != 1;
  const bool b_n_fast = b_sn == 1 && b_sk != 1;
  auto copy_slice = [&](int ks, int buf) {
    u64* dA = sRaw + buf * (ROWS * RP);
    u64* dB = dA + TM * RP;
    const int k0 = ks * TK;
    if (a_m_fast)
      copy_operand<TM>(dA, RP, 1, ab, a_sm, a_sk, m0, M, k0, K);
    else
      copy_operand<TK>(dA, 1, RP, ab, a_sk, a_sm, k0, K, m0, M);
    if (b_n_fast)
      copy_operand<TN>(dB, RP, 1, bb, b_sn, b_sk, n0, N, k0, K);
    else
      copy_operand<TK>(dB, 1, RP, bb, b_sk, b_sn, k0, K, n0, N);
    cp_async_commit();
  };

  // staged buffer `buf` -> limb planes `buf`. A warp's task is 8 rows x 4
  // groups of 4 consecutive k, so its 16-byte reads of the staged slice and
  // its 4-byte writes to a limb plane are free of bank conflicts
  auto split = [&](int buf) {
    const u64* raw = sRaw + buf * (ROWS * RP);
    unsigned char* planes = sL + buf * LIMBS;
#pragma unroll
    for (int i = 0; i < ROWS * (TK / 4) / THREADS; ++i) {
      const int blk = i * 8 + warp;  // 16 blocks of 8 rows x 2 blocks of 4 groups
      const int r = (blk & 15) * 8 + (lane & 7);
      const int k4 = ((blk >> 4) * 4 + (lane >> 3)) * 4;
      const u64* src = raw + r * RP + k4;
      const ulonglong2 v01 = *reinterpret_cast<const ulonglong2*>(src);
      const ulonglong2 v23 = *reinterpret_cast<const ulonglong2*>(src + 2);
      const u64 w0 = v01.x, w1 = v01.y, w2 = v23.x, w3 = v23.y;
      unsigned char* dst = planes + r * LP + k4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // limbs 0-3 from the low words, 4-7 high
        const uint32_t x0 = (uint32_t)(half ? w0 >> 32 : w0);
        const uint32_t x1 = (uint32_t)(half ? w1 >> 32 : w1);
        const uint32_t x2 = (uint32_t)(half ? w2 >> 32 : w2);
        const uint32_t x3 = (uint32_t)(half ? w3 >> 32 : w3);
        // 4x4 byte transpose: limb l of the four elements, element 0 lowest
        const uint32_t t01 = __byte_perm(x0, x1, 0x5140), t23 = __byte_perm(x2, x3, 0x5140);
        const uint32_t u01 = __byte_perm(x0, x1, 0x7362), u23 = __byte_perm(x2, x3, 0x7362);
        const int l0 = 4 * half;
        *reinterpret_cast<uint32_t*>(dst + (l0 + 0) * PLANE) = __byte_perm(t01, t23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + (l0 + 1) * PLANE) = __byte_perm(t01, t23, 0x7632);
        *reinterpret_cast<uint32_t*>(dst + (l0 + 2) * PLANE) = __byte_perm(u01, u23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + (l0 + 3) * PLANE) = __byte_perm(u01, u23, 0x7632);
      }
    }
  };

  uint32_t part[8][4][4];  // [shift s][n8 tile][C fragment]
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[s][nt][e] = 0u;

  // Pipeline, one barrier a slice. Before the barrier of iteration ks, a
  // thread waits for its copy of slice ks + 1; after it, slice ks's limbs
  // and slice ks + 1's staged copy are complete, and every warp is done with
  // what iteration ks - 1 read (staged buffer ks & 1, limb planes ks + 1 & 1).
  // So a warp copies slice ks + 2, splits slice ks + 1 and multiplies slice
  // ks with no barrier between them.
  copy_slice(0, 0);
  if (n_slices > 1) copy_slice(1, 1);
  if (n_slices > 1) cp_async_wait<1>(); else cp_async_wait<0>();
  __syncthreads();
  split(0);
  bool first_fold = true;
  for (int ks = 0; ks < n_slices; ++ks) {
    const int cur = ks & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (ks + 2 < n_slices) copy_slice(ks + 2, cur);
    // the two warps of an SM sub-partition (w and w + 4) split and multiply
    // in opposite orders, so one's split runs beside the other's products
#pragma unroll 1
    for (int step = 0; step < 2; ++step) {
      if ((step == 0) == (warp < 4)) {
        if (ks + 1 < n_slices) split(cur ^ 1);
        continue;
      }
      const unsigned char* planes = sL + cur * LIMBS;
      uint32_t af[8][4];  // A fragments of the eight limbs
#pragma unroll
      for (int l = 0; l < 8; ++l)
        ldmatrix_x4(af[l], planes + l * PLANE + (wm + (lane & 15)) * LP + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bf[2][4];  // B fragments of limb j: n8 tiles 2np and 2np+1
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4(bf[np], planes + j * PLANE +
                                  (TM + wn + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LP +
                                  ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int i = 0; i < 8 - j; ++i)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_u8(part[i + j][nt], af[i], bf[nt >> 1][2 * (nt & 1)],
                   bf[nt >> 1][2 * (nt & 1) + 1]);
      }
    }

    if ((ks + 1) * TK % KC == 0 || ks + 1 == n_slices) {  // fold: see "Exactness" above
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          u64 val = 0;
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            val += (u64)part[s][nt][e] << (8 * s);
            part[s][nt][e] = 0u;
          }
          const int m = m0 + wm + g + 8 * (e >> 1);
          const int n = n0 + wn + nt * 8 + 2 * t + (e & 1);
          if (m < M && n < N) {
            u64* out = cb + m * c_sm + n * c_sn;
            *out = first_fold ? val : *out + val;  // wraps mod 2^64
          }
        }
      first_fold = false;
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
  cudaError_t err = cudaFuncSetAttribute(pgt::ring_matmul_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pgt::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + pgt::TN - 1) / pgt::TN, (unsigned)tiles_m, (unsigned)batch);
  pgt::ring_matmul_tc_kernel<<<grid, pgt::THREADS, pgt::SMEM, (cudaStream_t)stream>>>(
      (const pgt::u64*)a, (const pgt::u64*)b, (pgt::u64*)c, B2, M, N, K, a_s1, a_s2, a_sm, a_sk,
      b_s1, b_s2, b_sk, b_sn, c_s1, c_s2, c_sm, c_sn);
  return (int)cudaGetLastError();
}
