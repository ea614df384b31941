// The row passes of the held experts' layer for Hopper (sm_90a): the
// gather, the SwiGLU and the weighted combine around the grouped products
// of models/moe.py:_HeldExperts, in both directions.
//
// Replaces no Pallas kernel: the dropless top-k expert layer has no
// counterpart in the JAX package (its top-1 layer routes by capacity into
// dense one-hot products). These kernels were added because the layer's
// elementwise and gather passes, written in plain PyTorch, ran over every
// row of the dispatch buffer: T * min(k, held) rows, the most the held
// experts can receive without a host sync, where the held assignments are
// about an eighth of them in an 8-of-64 expert share.
//
// What bounds them on the card: bytes. Each reads and writes rows of d or
// 2f values with a few operations an element (a silu, a product, a sum of
// at most k rows), far below the ~295 operations a byte at which the
// tensor cores would be the limit.
//
// Design. Each row kernel loads the held count n = offs[held - 1] from
// device memory at entry (no host sync sizes anything) and walks the rows
// r < n only; the rows past n of its buffers are never read or written
// (the wrapper allocates them with torch.empty, and the grouped products
// stop at offs[held - 1] as well). A kernel is a persistent grid of a few
// blocks an SM (the wrapper's grid), each warp owning one row at a time in
// a grid-stride loop over rows. A row moves as 16-byte vectors, lane by
// lane, where every row the warp touches starts 16-byte aligned and its
// width is a whole number of vectors (the C entry checks the pointers and
// widths); else it runs element by element (the tests' odd widths). Maths
// is f32 in registers; each tensor is stored in the dtype the plain path
// gives it: the rows (xs, a, do, dh) and the outputs y and dx in x's dtype,
// the router-weight gradients dws and dw in f32. The combines are one
// token to a warp over its own k slots, summed in f32 in slot order j = 0
// .. k - 1, so their sums are deterministic and need no atomics.
//
// Layout contract with the wrappers in models/moe.py: every tensor is
// contiguous; order and pos are int64, offs int32, the combines' mask the
// plan's held [T, k] as bools (one byte each), w and dws f32. Rows are [M, d] (xs, o, do, dxs), [M, 2f]
// gate|up (h, dh) or [M, f] (a, da); x, y, gy and dx are [T, d].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace pgt {

constexpr int ROW_THREADS = 256;  // 8 warps a block
constexpr int ROW_WARPS = ROW_THREADS / 32;

// the rows' type: bf16 where BF16 is 1, else f32
template <int BF16>
using Elem = std::conditional_t<BF16 != 0, __nv_bfloat16, float>;

// f32 <-> the stored type, one element
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T, unpacked to N floats and packed back
template <class T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& v, float (&f)[N]) {
    f[0] = __int_as_float((int)v.x), f[1] = __int_as_float((int)v.y);
    f[2] = __int_as_float((int)v.z), f[3] = __int_as_float((int)v.w);
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return {(unsigned)__float_as_int(f[0]), (unsigned)__float_as_int(f[1]),
            (unsigned)__float_as_int(f[2]), (unsigned)__float_as_int(f[3])};
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& v, float (&f)[N]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __int_as_float((int)(w[i] << 16));
      f[2 * i + 1] = __int_as_float((int)(w[i] & 0xffff0000u));
    }
  }
  // each pair rounded to nearest even, the lower element in the low half
  __device__ static unsigned pair(float lo, float hi) {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&p);
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return {pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]), pair(f[6], f[7])};
  }
};

template <class T>
__device__ __forceinline__ uint4 load16(const T* row, int v) {
  return reinterpret_cast<const uint4*>(row)[v];
}
template <class T>
__device__ __forceinline__ void store16(T* row, int v, const uint4& x) {
  reinterpret_cast<uint4*>(row)[v] = x;
}

// this warp's first row, the rows between its turns, and its lane: the
// grid-stride walk every kernel makes
struct Walk {
  long long first, step;
  int lane;
};
__device__ __forceinline__ Walk walk() {
  return {(long long)blockIdx.x * ROW_WARPS + threadIdx.x / 32, (long long)gridDim.x * ROW_WARPS,
          (int)(threadIdx.x % 32)};
}

__device__ __forceinline__ float sigmoid(float g) { return 1.f / (1.f + expf(-g)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// xs[r] = x[order[r] / k], r < n
template <int BF16>
__global__ void __launch_bounds__(ROW_THREADS)
moe_gather_kernel(const Elem<BF16>* __restrict__ x, const long long* __restrict__ order,
                  const int* __restrict__ offs, Elem<BF16>* __restrict__ xs, int held, int k,
                  int d, int vec) {
  using T = Elem<BF16>;
  const int n = offs[held - 1];
  const Walk w = walk();
  const int nv = d / Vec<T>::N;
  for (long long r = w.first; r < n; r += w.step) {
    const T* src = x + order[r] / k * d;
    T* dst = xs + r * d;
    if (vec) {
#pragma unroll 4
      for (int v = w.lane; v < nv; v += 32) store16(dst, v, load16(src, v));
    } else {
      for (int c = w.lane; c < d; c += 32) dst[c] = src[c];
    }
  }
}

// a[r] = silu(h[r, :f]) * h[r, f:], r < n
template <int BF16>
__global__ void __launch_bounds__(ROW_THREADS)
moe_swiglu_fwd_kernel(const Elem<BF16>* __restrict__ h, const int* __restrict__ offs,
                      Elem<BF16>* __restrict__ a, int held, int f, int vec) {
  using T = Elem<BF16>;
  constexpr int N = Vec<T>::N;
  const int n = offs[held - 1];
  const Walk w = walk();
  const int nv = f / N;
  for (long long r = w.first; r < n; r += w.step) {
    const T* hg = h + r * 2 * f;
    const T* hu = hg + f;
    T* ar = a + r * f;
    if (vec) {
#pragma unroll 2
      for (int v = w.lane; v < nv; v += 32) {
        float g[N], u[N];
        Vec<T>::unpack(load16(hg, v), g);
        Vec<T>::unpack(load16(hu, v), u);
#pragma unroll
        for (int i = 0; i < N; ++i) g[i] = g[i] * sigmoid(g[i]) * u[i];
        store16(ar, v, Vec<T>::pack(g));
      }
    } else {
      for (int c = w.lane; c < f; c += 32) {
        const float g = to_f(hg[c]);
        ar[c] = from_f<T>(g * sigmoid(g) * to_f(hu[c]));
      }
    }
  }
}

// y[t] = sum over the held slots j of w[t, j] * o[pos[t, j]], t < T
template <int BF16>
__global__ void __launch_bounds__(ROW_THREADS)
moe_combine_fwd_kernel(const Elem<BF16>* __restrict__ o, const float* __restrict__ wt,
                       const long long* __restrict__ pos, const unsigned char* __restrict__ mask,
                       Elem<BF16>* __restrict__ y, int tokens, int k, int d, int vec) {
  using T = Elem<BF16>;
  constexpr int N = Vec<T>::N;
  const Walk w = walk();
  const int nv = d / N;
  for (long long t = w.first; t < tokens; t += w.step) {
    const long long* pt = pos + t * k;
    const unsigned char* ht = mask + t * k;
    const float* wj = wt + t * k;
    T* yt = y + t * d;
    if (vec) {
      for (int v = w.lane; v < nv; v += 32) {
        float acc[N] = {};
        for (int j = 0; j < k; ++j) {
          if (!ht[j]) continue;
          float x[N];
          Vec<T>::unpack(load16(o + pt[j] * d, v), x);
#pragma unroll
          for (int i = 0; i < N; ++i) acc[i] += wj[j] * x[i];
        }
        store16(yt, v, Vec<T>::pack(acc));
      }
    } else {
      for (int c = w.lane; c < d; c += 32) {
        float acc = 0.f;
        for (int j = 0; j < k; ++j)
          if (ht[j]) acc += wj[j] * to_f(o[pt[j] * d + c]);
        yt[c] = from_f<T>(acc);
      }
    }
  }
}

// for r < n, with a = order[r] and gy's row t = a / k:
// dws[r] = <gy[t], o[r]> (f32) and do[r] = gy[t] * w.flat[a]
template <int BF16>
__global__ void __launch_bounds__(ROW_THREADS)
moe_rows_bwd_kernel(const Elem<BF16>* __restrict__ gy, const Elem<BF16>* __restrict__ o,
                    const float* __restrict__ wt, const long long* __restrict__ order,
                    const int* __restrict__ offs, float* __restrict__ dws,
                    Elem<BF16>* __restrict__ dout, int held, int k, int d, int vec) {
  using T = Elem<BF16>;
  constexpr int N = Vec<T>::N;
  const int n = offs[held - 1];
  const Walk w = walk();
  const int nv = d / N;
  for (long long r = w.first; r < n; r += w.step) {
    const long long a = order[r];
    const T* g = gy + a / k * d;
    const T* orow = o + r * d;
    T* drow = dout + r * d;
    const float wa = wt[a];
    float dot = 0.f;
    if (vec) {
#pragma unroll 2
      for (int v = w.lane; v < nv; v += 32) {
        float gv[N], ov[N];
        Vec<T>::unpack(load16(g, v), gv);
        Vec<T>::unpack(load16(orow, v), ov);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          dot += gv[i] * ov[i];
          gv[i] *= wa;
        }
        store16(drow, v, Vec<T>::pack(gv));
      }
    } else {
      for (int c = w.lane; c < d; c += 32) {
        const float gc = to_f(g[c]);
        dot += gc * to_f(orow[c]);
        drow[c] = from_f<T>(gc * wa);
      }
    }
    dot = warp_sum(dot);
    if (w.lane == 0) dws[r] = dot;
  }
}

// dh[r] = (da * h_u * silu'(h_g), da * silu(h_g)), r < n
template <int BF16>
__global__ void __launch_bounds__(ROW_THREADS)
moe_swiglu_bwd_kernel(const Elem<BF16>* __restrict__ h, const Elem<BF16>* __restrict__ da,
                      const int* __restrict__ offs, Elem<BF16>* __restrict__ dh, int held, int f,
                      int vec) {
  using T = Elem<BF16>;
  constexpr int N = Vec<T>::N;
  const int n = offs[held - 1];
  const Walk w = walk();
  const int nv = f / N;
  for (long long r = w.first; r < n; r += w.step) {
    const T* hg = h + r * 2 * f;
    const T* hu = hg + f;
    const T* dar = da + r * f;
    T* dg = dh + r * 2 * f;
    T* du = dg + f;
    if (vec) {
      for (int v = w.lane; v < nv; v += 32) {
        float g[N], u[N], e[N];
        Vec<T>::unpack(load16(hg, v), g);
        Vec<T>::unpack(load16(hu, v), u);
        Vec<T>::unpack(load16(dar, v), e);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float gi = g[i], s = sigmoid(gi);
          g[i] = e[i] * u[i] * s * (1.f + gi * (1.f - s));
          u[i] = e[i] * gi * s;
        }
        store16(dg, v, Vec<T>::pack(g));
        store16(du, v, Vec<T>::pack(u));
      }
    } else {
      for (int c = w.lane; c < f; c += 32) {
        const float g = to_f(hg[c]), u = to_f(hu[c]), e = to_f(dar[c]);
        const float s = sigmoid(g);
        dg[c] = from_f<T>(e * u * s * (1.f + g * (1.f - s)));
        du[c] = from_f<T>(e * g * s);
      }
    }
  }
}

// for t < T: dx[t] = sum over the held slots j of dxs[pos[t, j]] (f32, in
// slot order), and dw[t, j] = dws[pos[t, j]] where held, else 0
template <int BF16>
__global__ void __launch_bounds__(ROW_THREADS)
moe_combine_bwd_kernel(const Elem<BF16>* __restrict__ dxs, const float* __restrict__ dws,
                       const long long* __restrict__ pos, const unsigned char* __restrict__ mask,
                       Elem<BF16>* __restrict__ dx, float* __restrict__ dw, int tokens, int k,
                       int d, int vec) {
  using T = Elem<BF16>;
  constexpr int N = Vec<T>::N;
  const Walk w = walk();
  const int nv = d / N;
  for (long long t = w.first; t < tokens; t += w.step) {
    const long long* pt = pos + t * k;
    const unsigned char* ht = mask + t * k;
    T* xt = dx + t * d;
    for (int j = w.lane; j < k; j += 32) dw[t * k + j] = ht[j] ? dws[pt[j]] : 0.f;
    if (vec) {
      for (int v = w.lane; v < nv; v += 32) {
        float acc[N] = {};
        for (int j = 0; j < k; ++j) {
          if (!ht[j]) continue;
          float x[N];
          Vec<T>::unpack(load16(dxs + pt[j] * d, v), x);
#pragma unroll
          for (int i = 0; i < N; ++i) acc[i] += x[i];
        }
        store16(xt, v, Vec<T>::pack(acc));
      }
    } else {
      for (int c = w.lane; c < d; c += 32) {
        float acc = 0.f;
        for (int j = 0; j < k; ++j)
          if (ht[j]) acc += to_f(dxs[pt[j] * d + c]);
        xt[c] = from_f<T>(acc);
      }
    }
  }
}

// 1 where rows of `width` elements of `size` bytes from each base move as
// whole 16-byte vectors, else 0
inline int vec_ok(int width, int size, std::initializer_list<const void*> bases) {
  if (width * size % 16) return 0;
  for (const void* p : bases)
    if ((uintptr_t)p % 16) return 0;
  return 1;
}

template <int BF16>
int moe_gather(const void* x, const void* order, const void* offs, void* xs, int held, int k,
               int d, int grid, cudaStream_t s) {
  using T = Elem<BF16>;
  moe_gather_kernel<BF16><<<grid, ROW_THREADS, 0, s>>>(
      (const T*)x, (const long long*)order, (const int*)offs, (T*)xs, held, k, d,
      vec_ok(d, sizeof(T), {x, xs}));
  return (int)cudaGetLastError();
}

template <int BF16>
int moe_swiglu_fwd(const void* h, const void* offs, void* a, int held, int f, int grid,
                   cudaStream_t s) {
  using T = Elem<BF16>;
  moe_swiglu_fwd_kernel<BF16><<<grid, ROW_THREADS, 0, s>>>(
      (const T*)h, (const int*)offs, (T*)a, held, f, vec_ok(f, sizeof(T), {h, a}));
  return (int)cudaGetLastError();
}

template <int BF16>
int moe_combine_fwd(const void* o, const void* w, const void* pos, const void* mask, void* y,
                    int tokens, int k, int d, int grid, cudaStream_t s) {
  using T = Elem<BF16>;
  moe_combine_fwd_kernel<BF16><<<grid, ROW_THREADS, 0, s>>>(
      (const T*)o, (const float*)w, (const long long*)pos, (const unsigned char*)mask, (T*)y,
      tokens, k, d, vec_ok(d, sizeof(T), {o, y}));
  return (int)cudaGetLastError();
}

template <int BF16>
int moe_rows_bwd(const void* gy, const void* o, const void* w, const void* order,
                 const void* offs, void* dws, void* dout, int held, int k, int d, int grid,
                 cudaStream_t s) {
  using T = Elem<BF16>;
  moe_rows_bwd_kernel<BF16><<<grid, ROW_THREADS, 0, s>>>(
      (const T*)gy, (const T*)o, (const float*)w, (const long long*)order, (const int*)offs,
      (float*)dws, (T*)dout, held, k, d, vec_ok(d, sizeof(T), {gy, o, dout}));
  return (int)cudaGetLastError();
}

template <int BF16>
int moe_swiglu_bwd(const void* h, const void* da, const void* offs, void* dh, int held, int f,
                   int grid, cudaStream_t s) {
  using T = Elem<BF16>;
  moe_swiglu_bwd_kernel<BF16><<<grid, ROW_THREADS, 0, s>>>(
      (const T*)h, (const T*)da, (const int*)offs, (T*)dh, held, f,
      vec_ok(f, sizeof(T), {h, da, dh}));
  return (int)cudaGetLastError();
}

template <int BF16>
int moe_combine_bwd(const void* dxs, const void* dws, const void* pos, const void* mask,
                    void* dx, void* dw, int tokens, int k, int d, int grid, cudaStream_t s) {
  using T = Elem<BF16>;
  moe_combine_bwd_kernel<BF16><<<grid, ROW_THREADS, 0, s>>>(
      (const T*)dxs, (const float*)dws, (const long long*)pos, (const unsigned char*)mask,
      (T*)dx, (float*)dw, tokens, k, d, vec_ok(d, sizeof(T), {dxs, dx}));
  return (int)cudaGetLastError();
}

}  // namespace pgt

// Each entry launches on `stream` and returns the launch's cudaError_t
// (cudaErrorInvalidValue, with no launch, for a size below 1). is_bf16
// picks the rows' type: bf16, else f32.
static bool pgt_moe_bad(std::initializer_list<int> sizes) {
  for (int s : sizes)
    if (s < 1) return true;
  return false;
}

extern "C" int pgt_moe_gather(const void* x, const void* order, const void* offs, void* xs,
                              int held, int k, int d, int is_bf16, int grid, void* stream) {
  if (pgt_moe_bad({held, k, d, grid})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? pgt::moe_gather<1>(x, order, offs, xs, held, k, d, grid, s)
                 : pgt::moe_gather<0>(x, order, offs, xs, held, k, d, grid, s);
}

extern "C" int pgt_moe_swiglu_fwd(const void* h, const void* offs, void* a, int held, int f,
                                  int is_bf16, int grid, void* stream) {
  if (pgt_moe_bad({held, f, grid})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? pgt::moe_swiglu_fwd<1>(h, offs, a, held, f, grid, s)
                 : pgt::moe_swiglu_fwd<0>(h, offs, a, held, f, grid, s);
}

extern "C" int pgt_moe_combine_fwd(const void* o, const void* w, const void* pos,
                                   const void* mask, void* y, int tokens, int k, int d,
                                   int is_bf16, int grid, void* stream) {
  if (pgt_moe_bad({tokens, k, d, grid})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? pgt::moe_combine_fwd<1>(o, w, pos, mask, y, tokens, k, d, grid, s)
                 : pgt::moe_combine_fwd<0>(o, w, pos, mask, y, tokens, k, d, grid, s);
}

extern "C" int pgt_moe_rows_bwd(const void* gy, const void* o, const void* w, const void* order,
                                const void* offs, void* dws, void* dout, int held, int k, int d,
                                int is_bf16, int grid, void* stream) {
  if (pgt_moe_bad({held, k, d, grid})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? pgt::moe_rows_bwd<1>(gy, o, w, order, offs, dws, dout, held, k, d, grid, s)
                 : pgt::moe_rows_bwd<0>(gy, o, w, order, offs, dws, dout, held, k, d, grid, s);
}

extern "C" int pgt_moe_swiglu_bwd(const void* h, const void* da, const void* offs, void* dh,
                                  int held, int f, int is_bf16, int grid, void* stream) {
  if (pgt_moe_bad({held, f, grid})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? pgt::moe_swiglu_bwd<1>(h, da, offs, dh, held, f, grid, s)
                 : pgt::moe_swiglu_bwd<0>(h, da, offs, dh, held, f, grid, s);
}

extern "C" int pgt_moe_combine_bwd(const void* dxs, const void* dws, const void* pos,
                                   const void* mask, void* dx, void* dw, int tokens, int k, int d,
                                   int is_bf16, int grid, void* stream) {
  if (pgt_moe_bad({tokens, k, d, grid})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? pgt::moe_combine_bwd<1>(dxs, dws, pos, mask, dx, dw, tokens, k, d, grid, s)
                 : pgt::moe_combine_bwd<0>(dxs, dws, pos, mask, dx, dw, tokens, k, d, grid, s);
}
