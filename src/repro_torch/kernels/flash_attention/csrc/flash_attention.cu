// FlashAttention forward for Hopper (sm_90a), bound with ctypes (plain C ABI).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:_kernel /
// flash_attention_pallas (online-softmax GQA attention with an fp32 running
// max, running sum and accumulator; causal mask, sliding window, a query
// position offset; kv blocks wholly outside the mask are skipped).
//
// Bound on this card: bytes, at the serving path's shapes. At the prefill
// shape q (4, 512, 16, 128), k/v (4, 544, 8, 128) bf16 the call must move
// about 26 MB (q, k, v read once, out written once) against about 4.3 GFLOP
// of causal products: ~7.7 us at 3.35 TB/s vs ~4.4 us at 989 TFLOP/s bf16
// on an H100 SXM. A kernel that reaches that bound needs the tensor cores
// (wgmma) fed by TMA; that is later work.
//
// Design (right and simple first): the products run on the CUDA cores in
// fp32, so the kernel is bounded in practice by shared-memory traffic and
// fp32 issue rate, not by device memory. What it does keep from the TPU
// kernel is the part that saves bytes and work: K/V are read tile by tile
// into shared memory and never re-read from device memory by the block,
// the (Sq x Sk) score matrix never leaves registers, and tiles wholly
// outside the causal/window mask are never loaded.
//  * One block per (q tile of 32 rows, q head, batch row); 4 warps, each
//    owning 8 query rows and their fp32 state (m, l, acc) in registers.
//  * GQA: q head h reads kv head h / (H / KV).
//  * Per kv tile of 32 keys: lane j scores key j against the warp's 8 rows
//    (K rows padded to D + 1 floats, so the 32 lanes hit 32 banks); the
//    running max and sum are warp-shuffle reductions; P·V broadcasts each
//    p_j by shuffle while lane l accumulates dims l, l + 32, ...
//  * q_offset is per batch row (B,) int32, read on the device.
//  * Ragged edges are masked here: query rows >= Sq are neither computed
//    into the output nor stored, keys >= Sk get p = 0 and zero-filled K/V
//    rows. There is no tiling constraint on Sq or Sk.
// Masked-but-existing keys get the score -1e30, exactly as in the TPU
// kernel, so a row matches the oracle whenever it has one unmasked key.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

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
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [row0, row0 + n_rows) of a (rows, D) slab with row stride
// `src_stride` elements, into fp32 shared memory with row stride
// `dst_stride`; rows at or past `n_valid` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const T* src, size_t src_stride,
                                          int row0, int n_valid, int n_rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVecPerRow = D / V;
  for (int i = threadIdx.x; i < n_rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * V;
    float vals[V];
    if (row0 + r < n_valid) {
      load_vec(src + static_cast<size_t>(row0 + r) * src_stride + c, vals);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) dst[r * dst_stride + c + j] = vals[j];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_offset,
                 T* __restrict__ out, int Sq, int Sk, int H, int KV,
                 int causal, int window, float scale) {
  constexpr int DL = D / 32;  // accumulator dims per lane
  extern __shared__ float smem[];
  float* sQ = smem;                  // kBQ x D
  float* sK = sQ + kBQ * D;          // kBK x (D + 1), padded against bank conflicts
  float* sV = sK + kBK * (D + 1);    // kBK x D

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qoff = q_offset[b];

  const size_t q_stride = static_cast<size_t>(H) * D;   // between q rows
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * KV + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * KV + hk) * D;
  load_rows<T, D>(sQ, D, qb, q_stride, q0, Sq, kBQ);

  // kv tiles that hold at least one unmasked key for some row of the block
  const int n_tiles = (Sk + kBK - 1) / kBK;
  const int q_lo = qoff + q0;
  const int q_hi = qoff + min(q0 + kBQ, Sq) - 1;
  int t_end = n_tiles;
  if (causal) t_end = q_hi < 0 ? 0 : min(n_tiles, q_hi / kBK + 1);
  const int t_begin = window > 0 ? max(0, q_lo - window + 1) / kBK : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }
  const float* myQ = sQ + warp * kRowsPerWarp * D;

  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();  // the previous tile (and, first time, nothing) is consumed
    load_rows<T, D>(sK, D + 1, kb, kv_stride, t * kBK, Sk, kBK);
    load_rows<T, D>(sV, D, vb, kv_stride, t * kBK, Sk, kBK);
    __syncthreads();

    // s[r] = q_r . k_lane
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* myK = sK + lane * (D + 1);
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      const float k0 = myK[dd], k1 = myK[dd + 1], k2 = myK[dd + 2], k3 = myK[dd + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(myQ + r * D + dd);
        s[r] += qv.x * k0;
        s[r] += qv.y * k1;
        s[r] += qv.z * k2;
        s[r] += qv.w * k3;
      }
    }

    // online softmax, one row at a time across the warp's 32 keys
    const int kk = t * kBK + lane;
    const bool exists = kk < Sk;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qp = qoff + q0 + warp * kRowsPerWarp + r;
      bool keep = exists;
      if (causal) keep = keep && kk <= qp;
      if (window > 0) keep = keep && qp - kk < window;
      const float sv = keep ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      p[r] = exists ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= alpha;
    }

    // acc[r][:] += sum_j p_j v_j
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) vv[i] = sV[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] += pj * vv[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * Sq + qi) * q_stride
               + static_cast<size_t>(h) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) store_one(o + lane + 32 * i, acc[r][i] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* q_offset,
           void* out, int B, int Sq, int Sk, int H, int KV, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_offset),
      static_cast<T*>(out), Sq, Sk, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* q_offset,
             void* out, int B, int Sq, int Sk, int H, int KV, int D,
             int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, out: (B, Sq, H, D); k, v: (B, Sk, KV, D), all contiguous, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); q_offset: (B,) int32 on the device.
// window <= 0 means global. D in {32, 64, 128}. Returns the launch's
// cudaError_t (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* q_offset, void* out, int B, int Sq, int Sk,
                        int H, int KV, int D, int causal, int window,
                        int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_d<__nv_bfloat16>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, D, causal, window, scale, s)
      : launch_d<float>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, D, causal, window, scale, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
