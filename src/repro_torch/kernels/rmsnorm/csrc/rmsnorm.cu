// RMSNorm forward for Hopper (sm_90a), bound with ctypes (plain C ABI).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py:_kernel / rmsnorm_pallas
// (row-blocked RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w in fp32, cast
// back to x's type).
//
// Bound on this card: bytes. Every element is read once and written once
// with ~3 flops in between, far below the ~295 flop/byte at which an H100
// stops being memory bound. At (2048, 2048) bf16 the call moves 16.8 MB:
// about 5 us at the H100 SXM's 3.35 TB/s. At decode (4 rows) it moves
// 40 KB, and the time is one launch plus the latency of one round trip to
// memory, so that is what the design keeps short.
//
// Design: one block per row, its thread count fitted to the row count on
// the host (ops.py `plan`): V being the elements of one 16-byte vector,
// about D / V threads at few rows (decode: 4 rows, so each thread moves one
// vector of x and the block finishes in one round trip to memory), and
// about D / 2V at many rows (prefill: 2048 rows, so each thread moves two
// vectors and more rows' blocks fit on an SM at once, whose loads overlap
// the stores of those ahead of them). A thread issues its loads of x and
// of the matching w together, before the reduction, so a row costs one
// round trip, and w is never re-read after it. The fp32 sum of squares is
// reduced with warp shuffles, then once through shared memory (every
// thread sums the warps' partials in the same order). A thread keeps up to
// 16 vectors of its row in registers; a row wider than that re-reads its
// tail (from L1/L2) in the second pass. Any row count and any D % 8 == 0
// is taken (the wrapper checks D and the 16-byte alignment).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // a row's block at most

// 16 bytes of T as they lie in memory, and <-> float[16 / sizeof(T)]
template <typename T> struct Raw;
template <> struct Raw<float> { using type = float4; };
template <> struct Raw<__nv_bfloat16> { using type = uint4; };

__device__ __forceinline__ void widen(float4 u, float* v) {
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void widen(uint4 u, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T>
__device__ __forceinline__ typename Raw<T>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw<T>::type*>(p);
}

// y[0:V] = (v * r) * w[0:V], the reference's order of operations
template <typename T>
__device__ __forceinline__ void normalize_store(typename Raw<T>::type u,
                                                const float* wv, T* y, float r) {
  constexpr int V = 16 / sizeof(T);
  float v[V];
  widen(u, v);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = (v[i] * r) * wv[i];
  store_vec(y, v);
}

template <typename T>
__device__ __forceinline__ float vec_sum_sq(typename Raw<T>::type u) {
  constexpr int V = 16 / sizeof(T);
  float v[V];
  widen(u, v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s += v[i] * v[i];
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  using R = typename Raw<T>::type;
  __shared__ float partial[32];
  const int step = blockDim.x * V;          // elements per block-wide access
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;

  R xv[NV];
  float wv[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k) {            // x and w in one round trip
    const int c = threadIdx.x * V + k * step;
    if (c < d) {
      xv[k] = load_raw(xr + c);
#pragma unroll
      for (int i = 0; i < V; i += 4) widen(load_raw(w + c + i), wv[k] + i);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (threadIdx.x * V + k * step < d) ss += vec_sum_sq<T>(xv[k]);
  for (int c = threadIdx.x * V + NV * step; c < d; c += step)
    ss += vec_sum_sq<T>(load_raw(xr + c));

  ss = warp_sum(ss);
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) partial[warp] = ss;
  __syncthreads();
  ss = 0.f;
  for (int i = 0; i < n_warps; ++i) ss += partial[i];
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = threadIdx.x * V + k * step;
    if (c < d) normalize_store<T>(xv[k], wv[k], yr + c, r);
  }
  for (int c = threadIdx.x * V + NV * step; c < d; c += step) {
    float t[V];
#pragma unroll
    for (int i = 0; i < V; i += 4) widen(load_raw(w + c + i), t + i);
    normalize_store<T>(load_raw(xr + c), t, yr + c, r);
  }
}

template <typename T, int NV>
int launch_nv(const void* x, const void* w, void* y, int n_rows, int d,
              float eps, int threads, cudaStream_t stream) {
  rmsnorm_kernel<T, NV><<<n_rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), d, eps);
  return static_cast<int>(cudaGetLastError());
}

// NV: the smallest of 1, 2, 4, 8, 16 vectors a thread that covers the row
// (16 at most: a wider row re-reads its tail)
template <typename T>
int launch(const void* x, const void* w, void* y, int n_rows, int d,
           float eps, int threads, cudaStream_t stream) {
  const int vecs = d / (16 / static_cast<int>(sizeof(T)));
  const int per_thread = (vecs + threads - 1) / threads;
  if (per_thread <= 1) return launch_nv<T, 1>(x, w, y, n_rows, d, eps, threads, stream);
  if (per_thread <= 2) return launch_nv<T, 2>(x, w, y, n_rows, d, eps, threads, stream);
  if (per_thread <= 4) return launch_nv<T, 4>(x, w, y, n_rows, d, eps, threads, stream);
  if (per_thread <= 8) return launch_nv<T, 8>(x, w, y, n_rows, d, eps, threads, stream);
  return launch_nv<T, 16>(x, w, y, n_rows, d, eps, threads, stream);
}

}  // namespace

extern "C" {

// x, y: (n_rows, d) contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// w: (d,) fp32; `threads` a row (a multiple of 32, at most 512), which the
// wrapper picks (ops.py `plan`). Returns the launch's cudaError_t (0 =
// launched).
int rmsnorm_fwd(const void* x, const void* w, void* y, int n_rows, int d,
                float eps, int is_bf16, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, y, n_rows, d, eps, threads, s)
                 : launch<float>(x, w, y, n_rows, d, eps, threads, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
