// RMSNorm forward for Hopper (sm_90a), bound with ctypes (plain C ABI).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py:_kernel / rmsnorm_pallas
// (row-blocked RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w in fp32, cast
// back to x's type).
//
// Bound on this card: bytes. Every element is read once and written once
// with ~3 flops in between, far below the ~295 flop/byte at which an H100
// stops being memory bound. At (2048, 2048) bf16 the call moves 16.8 MB:
// about 5 us at the H100 SXM's 3.35 TB/s.
//
// Design: one warp per row, rows packed four to a 128-thread block. Each
// lane moves 16 bytes per access (8 bf16 or 4 fp32), neighbouring lanes on
// neighbouring addresses, so a warp reads 512 contiguous bytes per step.
// A row of up to 2048 bf16 (1024 fp32) is held in registers, its loads all
// issued at once, so it is read from device memory once with enough bytes
// in flight; a longer row re-reads its tail from L1/L2. The fp32 sum of
// squares is reduced with warp shuffles only (no shared memory, no
// __syncthreads). Any row count and any D % 8 == 0 is taken (the wrapper
// checks D and the 16-byte alignment).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kCachedVecs = 8;   // 16-byte vectors per lane held in registers

// 16 bytes of T <-> float[16 / sizeof(T)]
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
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

// y[0:V] = (v * r) * w[0:V], the reference's order of operations
template <typename T, int V>
__device__ __forceinline__ void normalize_store(float (&v)[V], const float* w,
                                                T* y, float r) {
  float wv[V];
#pragma unroll
  for (int i = 0; i < V; i += 4) load_vec(w + i, wv + i);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = (v[i] * r) * wv[i];
  store_vec(y, v);
}

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int n_rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);      // elements per 16-byte vector
  constexpr int kStep = 32 * V;          // elements per warp-wide access
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warp leaves together
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = y + static_cast<size_t>(row) * d;

  // The first kCachedVecs vectors of each lane stay in registers: all their
  // loads are issued before the first use, so a lane has up to 128 bytes in
  // flight, and the row is read from device memory once. Longer rows loop
  // over the rest and re-read it (from L1/L2) in the second pass.
  float v[kCachedVecs][V];
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < kCachedVecs; ++u) {
    const int c = lane * V + u * kStep;
    if (c < d) load_vec(xr + c, v[u]);
  }
#pragma unroll
  for (int u = 0; u < kCachedVecs; ++u) {
    const int c = lane * V + u * kStep;
    if (c < d) {
#pragma unroll
      for (int i = 0; i < V; ++i) ss += v[u][i] * v[u][i];
    }
  }
  for (int c = lane * V + kCachedVecs * kStep; c < d; c += kStep) {
    float t[V];
    load_vec(xr + c, t);
#pragma unroll
    for (int i = 0; i < V; ++i) ss += t[i] * t[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int u = 0; u < kCachedVecs; ++u) {
    const int c = lane * V + u * kStep;
    if (c < d) normalize_store(v[u], w + c, yr + c, r);
  }
  for (int c = lane * V + kCachedVecs * kStep; c < d; c += kStep) {
    float t[V];
    load_vec(xr + c, t);
    normalize_store(t, w + c, yr + c, r);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int n_rows, int d,
           float eps, cudaStream_t stream) {
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), n_rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: (n_rows, d) contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// w: (d,) fp32. Returns the launch's cudaError_t (0 = launched).
int rmsnorm_fwd(const void* x, const void* w, void* y, int n_rows, int d,
                float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, y, n_rows, d, eps, s)
                 : launch<float>(x, w, y, n_rows, d, eps, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
