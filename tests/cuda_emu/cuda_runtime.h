// A CPU stand-in for the parts of the CUDA runtime and of PTX that the port's
// kernels use, so that g++ can build pygrid_tpu_torch/csrc/*.cu into a host
// library and tests/test_torch_flash_emulated.py and
// tests/test_torch_ring_emulated.py can run the kernels' own index
// arithmetic on the CPU.
//
// Every CUDA thread of a block is a std::thread; blocks run one after
// another. __syncthreads is a barrier over the block; the warp-level
// primitives (shuffles, ldmatrix, mma.sync) exchange values through a
// per-warp table between two barriers over the warp. cp.async copies are
// queued per thread and land only at the cp.async.wait_group that retires
// their group, so a read before the wait and the barrier after it sees the
// poison the block's shared memory starts with. A barrier that waits more
// than a minute aborts the process (the test runs it in a subprocess).
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __align__(n)
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 {
  unsigned x, y, z, w;
};
struct ulonglong2 {
  unsigned long long x, y;
};

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchOutOfResources = 7,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
};
constexpr size_t EMU_SMEM_LIMIT = 232448;  // an H100 block's shared memory
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > (int)EMU_SMEM_LIMIT ? cudaErrorInvalidValue : cudaSuccess;
}
inline thread_local cudaError_t emu_last_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  cudaError_t e = emu_last_error;
  emu_last_error = cudaSuccess;
  return e;
}
inline float __int_as_float(int x) {
  float f;
  memcpy(&f, &x, 4);
  return f;
}
inline int __float_as_int(float f) {
  int x;
  memcpy(&x, &f, 4);
  return x;
}

// byte n of the result is byte (s >> 4n) & 7 of the 8 bytes {y, x}, x lowest
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n) r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}

struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0;
  long gen = 0;
  void init(int k) { n = k, count = 0, gen = 0; }
  void wait() {
    std::unique_lock<std::mutex> l(m);
    const long g = gen;
    if (++count == n) {
      count = 0, ++gen;
      cv.notify_all();
    } else if (!cv.wait_for(l, std::chrono::seconds(60), [&] { return gen != g; })) {
      fprintf(stderr, "emulator: a barrier waited over a minute (threads diverged)\n");
      abort();
    }
  }
};
inline EmuBarrier emu_block_bar, emu_warp_bar[32];
inline float emu_xf[32][32];
inline int emu_warp() { return threadIdx.x / 32; }
inline int emu_lane() { return threadIdx.x % 32; }

inline void __syncthreads() { emu_block_bar.wait(); }
inline float __shfl_xor_sync(unsigned, float x, int m) {
  const int w = emu_warp(), l = emu_lane();
  emu_xf[w][l] = x;
  emu_warp_bar[w].wait();
  const float r = emu_xf[w][l ^ m];
  emu_warp_bar[w].wait();
  return r;
}

// a block's dynamic shared memory (the kernels name it smem or smem_raw)
namespace pgt {
alignas(128) inline unsigned char smem_raw[EMU_SMEM_LIMIT];
alignas(128) inline float smem[EMU_SMEM_LIMIT / 4];
}  // namespace pgt
inline size_t emu_smem_bytes = 0;

// kernel<<<grid, threads, smem_bytes, stream>>>(args...) is rewritten to
// emu_launch(kernel, grid, threads, smem_bytes, stream, args...)
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem_bytes, cudaStream_t, A... args) {
  if (smem_bytes > EMU_SMEM_LIMIT || threads > 1024 || threads % 32) {
    emu_last_error = cudaErrorLaunchOutOfResources;
    return;
  }
  emu_smem_bytes = smem_bytes;
  gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = dim3(x, y, z);
        memset(pgt::smem_raw, 0xff, smem_bytes);  // bf16 and f32 NaN
        memset(pgt::smem, 0xff, smem_bytes);
        emu_block_bar.init(threads);
        for (int w = 0; w < threads / 32; ++w) emu_warp_bar[w].init(32);
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([=] {
            threadIdx = dim3(t);
            kernel(args...);
          });
        for (auto& t : ts) t.join();
      }
}
