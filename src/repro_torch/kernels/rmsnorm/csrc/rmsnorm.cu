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
//
// Backward (rmsnorm_bwd; the JAX package never wrote one: it trains through
// the jnp rmsnorm of src/repro/models/layers.py:27 and differentiates it by
// autodiff). With r = rsqrt(mean(x^2) + eps) and g = dy * w, in fp32:
//   dx = r * (g - x * r^2 * mean(g * x)),   dw = sum over rows of dy * x * r.
// r is recomputed from x, so the forward saves nothing extra. Bound: bytes
// (x and dy read, dx written: 25.2 MB at (2048, 2048) bf16, ~7.5 us at
// 3.35 TB/s). Each block takes a stripe of rows, walks them one at a time
// with the next row's x and dy loads in flight, reduces sum(x^2) and
// sum(g x) through warp shuffles and one double-buffered shared array (one
// barrier a row), and keeps its columns' share of dw in registers; at the
// end it writes an fp32 partial row of dw (n_blocks, D). A second kernel
// sums the partials over the blocks in a fixed order, so dw has the same
// bits on every run (no atomics). A thread holds up to 8 vectors of a row.
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


// ---------------------------------------------------------------- backward
constexpr int kMaxBwdVecs = 8;     // 16-byte vectors of a row a thread holds
constexpr int kColTile = 32;       // dw reduce: columns a block
constexpr int kRowSlices = 8;      // dw reduce: partial rows summed in parallel

template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ dw_partial, int n_rows, int d,
                   int rows_per_block, float eps) {
  constexpr int V = 16 / sizeof(T);
  using R = typename Raw<T>::type;
  __shared__ float partial[2][2][32];       // [row parity][sum x^2, sum g x][warp]
  const int step = blockDim.x * V;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, n_rows);
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;

  float wv[NV][V], acc[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = threadIdx.x * V + k * step;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
    if (c < d) {
#pragma unroll
      for (int i = 0; i < V; i += 4) widen(load_raw(w + c + i), wv[k] + i);
    }
  }

  R xv[NV], gv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = threadIdx.x * V + k * step;
    if (r0 < r1 && c < d) {
      xv[k] = load_raw(x + static_cast<size_t>(r0) * d + c);
      gv[k] = load_raw(dy + static_cast<size_t>(r0) * d + c);
    }
  }
  for (int row = r0; row < r1; ++row) {
    const size_t base = static_cast<size_t>(row) * d;
    R xn[NV], gn[NV];                       // the next row, in flight
    const bool more = row + 1 < r1;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = threadIdx.x * V + k * step;
      if (more && c < d) {
        xn[k] = load_raw(x + base + d + c);
        gn[k] = load_raw(dy + base + d + c);
      }
    }
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (threadIdx.x * V + k * step < d) {
        float xf[V], df[V];
        widen(xv[k], xf);
        widen(gv[k], df);
        float s = 0.f, t = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s += xf[i] * xf[i];
          t += (df[i] * wv[k][i]) * xf[i];
        }
        ss += s;
        sg += t;
      }
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    const int par = (row - r0) & 1;
    if ((threadIdx.x & 31) == 0) {
      partial[par][0][warp] = ss;
      partial[par][1][warp] = sg;
    }
    __syncthreads();
    ss = 0.f;
    sg = 0.f;
    for (int i = 0; i < n_warps; ++i) {
      ss += partial[par][0][i];
      sg += partial[par][1][i];
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float rr = r * r, mgx = sg / static_cast<float>(d);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = threadIdx.x * V + k * step;
      if (c < d) {
        float xf[V], df[V], o[V];
        widen(xv[k], xf);
        widen(gv[k], df);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          o[i] = r * (df[i] * wv[k][i] - (xf[i] * rr) * mgx);
          acc[k][i] += df[i] * (xf[i] * r);
        }
        store_vec(dx + base + c, o);
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      xv[k] = xn[k];
      gv[k] = gn[k];
    }
  }
  float* pr = dw_partial + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = threadIdx.x * V + k * step;
    if (c < d) {
#pragma unroll
      for (int i = 0; i < V; i += 4) store_vec(pr + c + i, acc[k] + i);
    }
  }
}

// dw[c] = sum over the partial rows j of partial[j, c], in a fixed order:
// slice s sums rows s, s + kRowSlices, ..., then slice 0 adds the slices.
__global__ void __launch_bounds__(kColTile * kRowSlices)
rmsnorm_dw_reduce(const float* __restrict__ partial, float* __restrict__ dw,
                  int n_parts, int d) {
  __shared__ float part[kRowSlices][kColTile];
  const int col = blockIdx.x * kColTile + threadIdx.x;
  float s = 0.f;
  if (col < d)
    for (int j = threadIdx.y; j < n_parts; j += kRowSlices)
      s += partial[static_cast<size_t>(j) * d + col];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kRowSlices; ++i) t += part[i][threadIdx.x];
    dw[col] = t;
  }
}

template <typename T, int NV>
int launch_bwd_nv(const void* x, const void* w, const void* dy, void* dx,
                  void* dw_partial, void* dw, int n_rows, int d, float eps,
                  int threads, int rows_per_block, cudaStream_t stream) {
  const int n_parts = (n_rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_bwd_kernel<T, NV><<<n_parts, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dw_partial), n_rows, d, rows_per_block, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_dw_reduce<<<(d + kColTile - 1) / kColTile, dim3(kColTile, kRowSlices),
                      0, stream>>>(static_cast<const float*>(dw_partial),
                                   static_cast<float*>(dw), n_parts, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               void* dw_partial, void* dw, int n_rows, int d, float eps,
               int threads, int rows_per_block, cudaStream_t stream) {
  const int vecs = d / (16 / static_cast<int>(sizeof(T)));
  const int per_thread = (vecs + threads - 1) / threads;
#define RMSNORM_BWD(NV) launch_bwd_nv<T, NV>(x, w, dy, dx, dw_partial, dw, \
    n_rows, d, eps, threads, rows_per_block, stream)
  if (per_thread <= 1) return RMSNORM_BWD(1);
  if (per_thread <= 2) return RMSNORM_BWD(2);
  if (per_thread <= 4) return RMSNORM_BWD(4);
  if (per_thread <= kMaxBwdVecs) return RMSNORM_BWD(8);
#undef RMSNORM_BWD
  return static_cast<int>(cudaErrorInvalidValue);
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

// x, dy, dx: (n_rows, d) contiguous, fp32 (is_bf16 = 0) or bf16 (1); w:
// (d,) fp32; dw: (d,) fp32; dw_partial: fp32 scratch of
// ceil(n_rows / rows_per_block) rows of d, which the wrapper allocates.
// `threads` a block (a multiple of 32, at most 512, holding a row in at
// most 8 vectors a thread) and `rows_per_block` come from ops.py
// `plan_bwd`. Launches the row kernel, then the dw reduction, on `stream`.
// Returns the first launch error (0 = both launched).
int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                void* dw_partial, void* dw, int n_rows, int d, float eps,
                int is_bf16, int threads, int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      rows_per_block < 1 || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw_partial, dw,
                                             n_rows, d, eps, threads,
                                             rows_per_block, s)
                 : launch_bwd<float>(x, w, dy, dx, dw_partial, dw, n_rows, d,
                                     eps, threads, rows_per_block, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
