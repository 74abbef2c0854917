// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a), bound with ctypes
// (plain C ABI).
//
// Replaces: src/repro/kernels/ssd/ssd.py:_kernel / ssd_chunk_pallas. For
// each (batch, chunk, head) cell of chunk length L it computes, in fp32,
//     y_intra = ((C B^T) o causal exp(cs_i - cs_j) o dt_j) X       (L x P)
//     state   = B^T (X o dt o exp(cs_end - cs))                    (N x P)
// from x (L x P), dt and cs (L), and B, C (L x N), which all heads of a
// chunk share (n_groups = 1).
//
// Bound on this card: bytes. At the mamba2-130m serving shape (b 4, S 512,
// H 24, P 64, N 128, L 128, bf16 x/B/C) the call must move ~33 MB (x, dt,
// cs, B, C read once; y and the states written once in fp32): ~9.8 us at
// 3.35 TB/s, against 2.0 GFLOP of products (the causal halves of C B^T and
// W X, and B^T X), ~2 us at the bf16 tensor peak. The products here run
// on the CUDA cores in fp32 (the tolerance against the plain version is
// 1e-4 of max|y|, which bf16 or TF32 tensor cores do not hold), so ~30 us
// at the 67 TFLOP/s fp32 peak is this design's floor.
// Tensor cores (3xTF32 or split bf16) and computing C B^T once per chunk
// for all heads are its speed work.
//
// Design (right and simple first): one block of 256 threads per cell, the
// TPU grid (b, nc, H) as (H, nc, b). Everything the cell reads lives in
// shared memory as fp32 (dynamic shared memory, opted in above 48 KB):
//   Bt  N x (L+4)   B transposed, so a thread loads 4 consecutive j at once
//   X   L x (P+4)
//   Ct  N x (T+4)   the C rows of one row tile of T = min(L, 64) rows i
//   Wt  L x (T+4)   that tile's weights W[i][j], transposed (j rows)
//   dt, cs, dt*exp(cs_end - cs)   L each
// At L = N = P = 128 that is 206 KB; at the serving shape 174 KB. Each
// product is an outer-product loop over 4 x 4 register tiles of the output
// with 16-byte shared-memory loads (+4 floats of padding per row keeps
// them aligned); lanes of a warp share one operand (a broadcast) and read
// consecutive addresses of the other.
//   1. state = Bt . (X o dte), k over the L rows, stored to (b,nc,H,N,P).
//   2. per row tile: W[i][j] = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i;
//      register tiles wholly above the diagonal are never computed, and
//      exp(cs_i - cs_j) is evaluated only for j <= i: for j > i it is
//      exp(+large) = inf in fp32, and inf * 0 would be NaN.
//   3. y rows of the tile = W . X, k over j only up to the tile's last row.
// Takes L, N, P each a multiple of 4 and at most 128 (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 64;   // rows i of C B^T held in shared memory at once
constexpr int kPad = 4;        // floats of padding per shared-memory row

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[a][q] += u[a] * v[q]
__device__ __forceinline__ void outer(float (&acc)[4][4], float4 u, float4 v) {
  const float uu[4] = {u.x, u.y, u.z, u.w};
  const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(uu[a], vv[q], acc[a][q]);
}

__host__ __device__ inline int row_tile(int L) { return L < kRowTile ? L : kRowTile; }

inline size_t smem_floats(int L, int N, int P) {
  const int T = row_tile(L);
  return static_cast<size_t>(N) * (L + kPad) + static_cast<size_t>(L) * (P + kPad) +
         static_cast<size_t>(N) * (T + kPad) + static_cast<size_t>(L) * (T + kPad) +
         3 * static_cast<size_t>(L);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cs, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ st, int S, int H, int P, int N, int L) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = S / L;
  const int TR = row_tile(L);
  const int ldbt = L + kPad, ldx = P + kPad, ldt = TR + kPad;
  float* const sBt = smem;                       // N x ldbt
  float* const sX = sBt + N * ldbt;              // L x ldx
  float* const sCt = sX + L * ldx;               // N x ldt
  float* const sWt = sCt + N * ldt;              // L x ldt
  float* const sDt = sWt + L * ldt;
  float* const sCs = sDt + L;
  float* const sDte = sCs + L;
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;

  for (int l = tid; l < L; l += kThreads) {
    const size_t i = (row0 + l) * H + h;
    sDt[l] = dt[i];
    sCs[l] = cs[i];
  }
  for (int e = tid; e < L * N; e += kThreads) {
    const int l = e / N, n = e - l * N;
    sBt[n * ldbt + l] = to_float(Bm[(row0 + l) * N + n]);
  }
  for (int e = tid; e < L * P; e += kThreads) {
    const int l = e / P, p = e - l * P;
    sX[l * ldx + p] = to_float(x[((row0 + l) * H + h) * P + p]);
  }
  __syncthreads();
  const float cs_end = sCs[L - 1];
  for (int l = tid; l < L; l += kThreads) sDte[l] = sDt[l] * expf(cs_end - sCs[l]);
  __syncthreads();

  // 1. the chunk state (N x P): lanes share n0 and read consecutive p0
  const int tp = P / 4;
  for (int t = tid; t < (N / 4) * tp; t += kThreads) {
    const int n0 = (t / tp) * 4, p0 = (t % tp) * 4;
    float acc[4][4] = {};
    for (int j = 0; j < L; ++j) {
      const float d = sDte[j];
      const float4 bv = make_float4(sBt[n0 * ldbt + j], sBt[(n0 + 1) * ldbt + j],
                                    sBt[(n0 + 2) * ldbt + j], sBt[(n0 + 3) * ldbt + j]);
      const float4 xv = ld4(sX + j * ldx + p0);
      outer(acc, bv, make_float4(xv.x * d, xv.y * d, xv.z * d, xv.w * d));
    }
    float* out = st + ((((static_cast<size_t>(b) * nc + c) * H + h) * N) + n0) * P + p0;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(out + a * P) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }

  for (int i0 = 0; i0 < L; i0 += TR) {
    const int rows = min(TR, L - i0);
    const int tr = rows / 4;
    for (int e = tid; e < rows * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      sCt[n * ldt + r] = to_float(Cm[(row0 + i0 + r) * N + n]);
    }
    __syncthreads();

    // 2. Wt[j][r] = W[i0 + r][j], j < i0 + rows; lanes share j0, read
    //    consecutive r0. Tiles with j0 > i (every entry masked) are skipped.
    const int tj = (i0 + rows) / 4;
    for (int t = tid; t < tr * tj; t += kThreads) {
      const int r0 = (t % tr) * 4, j0 = (t / tr) * 4;
      if (j0 > i0 + r0) continue;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n)
        outer(acc, ld4(sCt + n * ldt + r0), ld4(sBt + n * ldbt + j0));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;
        float w[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + r0 + a;
          w[a] = 0.f;
          if (j <= i) w[a] = acc[a][q] * expf(sCs[i] - sCs[j]) * sDt[j];
        }
        *reinterpret_cast<float4*>(sWt + j * ldt + r0) = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncthreads();

    // 3. y rows i0 + r = sum over j <= i of W[i][j] X[j]; lanes share r0
    for (int t = tid; t < tr * tp; t += kThreads) {
      const int r0 = (t / tp) * 4, p0 = (t % tp) * 4;
      const int jend = i0 + r0 + 4;   // W[i][j] = 0 past the tile's last row
      float acc[4][4] = {};
      for (int j = 0; j < jend; ++j)
        outer(acc, ld4(sWt + j * ldt + r0), ld4(sX + j * ldx + p0));
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float* out = y + ((row0 + i0 + r0 + a) * H + h) * P + p0;
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    }
    __syncthreads();   // Ct and Wt are overwritten by the next row tile
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* cs, const void* B,
           const void* C, void* y, void* st, int batch, int S, int H, int P,
           int N, int L, cudaStream_t stream) {
  const size_t bytes = smem_floats(L, N, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, S / L, batch);
  ssd_chunk_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cs), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(st), S, H, P, N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (batch, S, H, P); B, C: (batch, S, N), all fp32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1); dt, cs: (batch, S, H) fp32; y: (batch, S, H, P)
// fp32; st: (batch, S / L, H, N, P) fp32. All contiguous; S % L == 0;
// L, N, P multiples of 4, at most 128. Returns the launch's cudaError_t
// (0 = launched).
int ssd_chunk_fwd(const void* x, const void* dt, const void* cs,
                  const void* B, const void* C, void* y, void* st, int batch,
                  int S, int H, int P, int N, int L, int is_bf16,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(x, dt, cs, B, C, y, st, batch, S, H, P, N, L, s)
      : launch<float>(x, dt, cs, B, C, y, st, batch, S, H, P, N, L, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
