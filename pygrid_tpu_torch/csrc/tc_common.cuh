// Tensor-core building blocks of the bf16 flash kernels (flash_fwd.cu,
// flash_bwd.cu) and the int8 ring matmul (ring_matmul.cu) for sm_90a, as
// inline PTX: ldmatrix fragments, the m16n8k16 bf16 mma.sync with f32
// accumulation, the m16n8k32 u8 mma.sync with s32 accumulation, cp.async
// copies with commit/wait groups, and bf16x2 packing.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 (row g, cols 2t..2t+1), a1 (row g+8, the same
//     cols), a2 (row g, cols 2t+8..2t+9), a3 (row g+8, cols 2t+8..2t+9);
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g);
//   C (16 x 8, f32):        c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the C fragments of two neighbouring n8 tiles are, packed to bf16, the
// A fragment of one k16 step: that is how P and dS feed the second product
// without passing through shared memory.
//
// mma.m16n8k32 on u8 holds four bytes (k, k+1, k+2, k+3) in a register:
//   A (16 x 32, row-major): a0 (row g, k 4t..4t+3), a1 (row g+8, the same k),
//     a2 (row g, k 4t+16..4t+19), a3 (row g+8, k 4t+16..4t+19);
//   B (32 x 8, k x n):      b0 (k 4t..4t+3, col g), b1 (k 4t+16..4t+19, col g);
//   C (16 x 8, s32):        as the bf16 product's.
// An 8x8 b16 ldmatrix is 8 rows x 16 bytes, so ldmatrix on a u8 tile with k
// contiguous gives exactly these A and B fragments, addressed as for bf16.
//
// Shared-memory tiles are bf16 [rows][DP + PAD]: the 16-byte pad puts the
// eight 16-byte rows of every 8x8 ldmatrix in eight different bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pgt {
namespace tc {

constexpr int PAD = 8;  // bf16 elements of padding per shared-memory row

// ---- PTX primitives (tests/cuda_emu emulates this block on the CPU) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of lane l holds row l/4, cols 2(l%4)..2(l%4)+1 of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed: register i of lane l holds rows
// 2(l%4)..2(l%4)+1, col l/4 of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b on the tensor cores: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on the tensor cores: u8 operands, s32 accumulators (exact: the
// products and sums are integers, and the callers keep them below 2^31)
__device__ __forceinline__ void mma_u8(uint32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, bypassing L1; with in_bounds false nothing is
// read and the 16 bytes are zero-filled (src must still be a valid address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool in_bounds) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in_bounds ? 16 : 0));
}

// 4 bytes global -> shared (the f32 per-row statistics, which are only
// 4-byte aligned); zero-filled when in_bounds is false
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool in_bounds) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in_bounds ? 4 : 0));
}

// 8 bytes global -> shared (one u64 ring element through arbitrary
// strides); zero-filled when in_bounds is false
__device__ __forceinline__ void cp_async_8(void* dst, const void* src, bool in_bounds) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in_bounds ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- end of PTX primitives ----

// (lo, hi) -> bf16x2, each rounded to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + ROWS) x cols [0, DP) of one (b, h) slice into a
// bf16 shared tile of pitch DP + PAD, 16 bytes per cp.async. Rows at or past
// L and columns at or past D are zero-filled (D % 8 == 0, so a 16-byte chunk
// is either wholly inside D or wholly outside).
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int row_stride, int row0, int L, int D) {
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < (ROWS * CHUNKS + THREADS - 1) / THREADS; ++i) {
    const int idx = i * THREADS + threadIdx.x;
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    const int row = row0 + r;
    const bool in = row < L && c < D;
    const __nv_bfloat16* g = in ? src + (long long)row * row_stride + c : src;
    if (idx < ROWS * CHUNKS) cp_async_16(dst + r * (DP + PAD) + c, g, in);
  }
}

// Store a bf16 shared tile (pitch DP + PAD) to rows [row0, row0 + ROWS) of a
// contiguous [*, D]-row output with row pitch `row_stride`, 16 bytes per
// store; rows at or past L and columns at or past D are not written.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, long long row_stride,
                                           const __nv_bfloat16* src, int row0, int L, int D) {
  constexpr int CHUNKS = DP / 8;
#pragma unroll
  for (int i = 0; i < (ROWS * CHUNKS + THREADS - 1) / THREADS; ++i) {
    const int idx = i * THREADS + threadIdx.x;
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    if (idx < ROWS * CHUNKS && row0 + r < L && c < D)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(src + r * (DP + PAD) + c);
  }
}

// The padded width DP a head dim D runs at: D is zero-filled in shared
// memory up to the smallest instantiated multiple of 16 that holds it.
__host__ __device__ constexpr int padded_d(int D) { return D <= 48 ? 48 : D <= 64 ? 64 : 128; }

// What the 16-byte copies need of a [B, L, H, D] view: D and every stride a
// multiple of 8 elements and a 16-byte-aligned base, so every row starts on
// a 16-byte boundary.
inline bool layout_ok(const void* p, int D, int sb, int sl, int sh) {
  return D % 8 == 0 && sb % 8 == 0 && sl % 8 == 0 && sh % 8 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace tc
}  // namespace pgt
