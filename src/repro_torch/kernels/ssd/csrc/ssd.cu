// Mamba-2 SSD intra-chunk kernels for Hopper (sm_90a), bound with ctypes
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
// W X, and B^T X), ~2 us at the bf16 tensor peak, ~30 us at the fp32
// non-tensor peak. The tolerance against the plain version is 1e-4 of
// max|y| (and of max(max|h|, 1)), which plain bf16 (2^-9) or TF32 products
// do not hold.
//
// Two kernels, chosen by the wrapper (ops.py `route`) by dtype and shape:
//
// bf16 at L in {64, 128}, N and P multiples of 16: the tensor-core kernel
// (tc::ssd_chunk_tc).
//  * One block per (group of heads, chunk, batch row): C B^T, the largest
//    product (L x L x N) and the same for every head, is computed once per
//    block and applied to each of its heads. The wrapper sizes the group so
//    that the grid is about one wave (serving: 3 heads, 128 blocks).
//  * One warpgroup per 64 rows i (wgmma's M); no producer warp, which at
//    L = 128 would cut every thread's register budget to 168. Thread 0
//    TMA-loads C and B once (128-byte swizzle, 64-column blocks; N pads to
//    64 or 128 with zeros) and each head's X tile into a 2-stage mbarrier
//    ring (a 4-D map over (P, H, S, b); P pads likewise): head g + 1's
//    tile is requested once every thread is done with head g - 1, so it
//    arrives while head g computes.
//  * C B^T: wgmma m64n64k16, both from shared memory K-major (n contiguous,
//    as stored); the rows 0-63 warpgroup computes only keys j < 64. Each
//    warpgroup keeps its 64 x (64 (w + 1)) slice as the fp32 accumulator in
//    registers for all heads. bf16 x bf16 products are exact in fp32, so it
//    is as exact as an fp32 loop.
//  * Per head, W = C B^T o exp(cs_i - cs_j) o dt_j is formed on that
//    fragment; exp (the fast ex2-based one: its relative error, at most
//    ~5e-6, is far inside the tolerance) is evaluated only for j <= i (the argument
//    is selected before it: for j > i it is +large, exp overflows, and
//    inf * 0 is NaN).
//    W is split into W_hi + W_lo, both bf16 (the residual is ~2^-18 of W),
//    packed as wgmma's register A operand, and y += W_hi X + W_lo X runs as
//    RS wgmma against X from shared memory (MN-major, like V in flash).
//  * The state, state = B^T Xd with Xd = X o dte in fp32: the threads
//    write Xd split into bf16 hi and lo halves to shared memory in X's
//    swizzled layout, and state = B^T Xd_hi + B^T Xd_lo runs as SS wgmma
//    with B^T the MN-major A operand (B as stored) and Xd the MN-major B
//    operand; each 64-row tile of n goes to one warpgroup, alternating by
//    head.
//  * y and the states leave in fp32 as 16-byte stores: a pair of
//    neighbouring threads swap halves so each holds 4 consecutive columns.
//
// fp32, or any other shape: the CUDA-core kernel (simt::ssd_chunk_kernel),
// whose fp32 products hold the tolerance from fp32 input (the tensor cores
// would need 3xTF32). No serving path runs it.
//
// The backward has the same two routes: bwd:: (CUDA cores, fp32 or bf16)
// and tcb:: (bf16 on the tensor cores, the split scheme above); their
// notes are at each namespace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../include/hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

// ====================================================== fp32, CUDA cores
// One block of 256 threads per (batch, chunk, head) cell, the TPU grid
// (b, nc, H) as (H, nc, b). Everything the cell reads lives in shared
// memory as fp32 (dynamic shared memory, opted in above 48 KB):
//   Bt  N x (L+4)   B transposed, so a thread loads 4 consecutive j at once
//   X   L x (P+4)
//   Ct  N x (T+4)   the C rows of one row tile of T = min(L, 64) rows i
//   Wt  L x (T+4)   that tile's weights W[i][j], transposed (j rows)
//   dt, cs, dt*exp(cs_end - cs)   L each
// At L = N = P = 128 that is 206 KB. Each product is an outer-product loop
// over 4 x 4 register tiles of the output with 16-byte shared-memory loads
// (+4 floats of padding per row keeps them aligned); lanes of a warp share
// one operand (a broadcast) and read consecutive addresses of the other.
//   1. state = Bt . (X o dte), k over the L rows, stored to (b,nc,H,N,P).
//   2. per row tile: W[i][j] = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i;
//      register tiles wholly above the diagonal are never computed, and
//      exp(cs_i - cs_j) is evaluated only for j <= i.
//   3. y rows of the tile = W . X, k over j only up to the tile's last row.
// Takes L, N, P each a multiple of 4 and at most 128 (the wrapper checks).
namespace simt {

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

}  // namespace simt

// ================================================ backward, CUDA cores
// The backward of the chunk function above, for fp32 or bf16 x, B, C
// (dt, cs, the cotangents and every output fp32). The TPU package has no
// kernel here: the reference differentiates its plain chunked scan
// (src/repro/models/ssd.py ssd_scan_reference) by autodiff. For each
// (batch, chunk, head) cell, with E_ij = exp(cs_i - cs_j) for i >= j (the
// exponent of the masked half is never taken), cb = C B^T, w = cb o E o
// dt_j, seg_l = exp(cs_end - cs_l), dte = dt o seg, and the cotangents dy
// (L x P) and dst (N x P):
//     dx    = w^T dy + dte o (B dst)
//     q     = (dy x^T) o cb o E  on i >= j
//     ddt_j = sum_i q_ij + ddte_j seg_j,    ddte_l = x_l . (B dst)_l
//     dcs_i = sum_j q_ij dt_j - dt_i sum_k q_ki - ddte_i dte_i
//             (+ sum_l ddte_l dte_l at the chunk's last row)
//     dC    = dcb B,  dB = dcb^T C + sum_h (x o dte) dst^T,
//     dcb   = sum_h (dy x^T) o E o dt_j  on i >= j
// (kernels/ssd/ref.py ssd_chunk_bwd_ref). B and C are shared by the heads
// (n_groups = 1), so dB and dC sum over them: in a second launch, in head
// order, with no atomics, so two calls give the same bits.
//
// Bound on this card: bytes. At mamba2-130m's train shape (b 4, S 512, H
// 24, P 64, N 128, L 128, bf16 x/B/C) the call must read x, dt, cs, B, C,
// dy and dst and write dx, ddt, dcs, dB, dC once: ~48 MB, ~14 us at 3.35
// TB/s, against ~2.5 GFLOP of products (~2.5 us at the bf16 tensor peak).
// These kernels run on the CUDA cores in fp32 and also write and read each
// head's share of dcb (the causal half) and of dB's state term through a
// workspace (~38 MB more at that shape). They take fp32, and the bf16
// shapes the tensor-core backward (namespace tcb) does not.
//
// Launch 1, one block of 256 threads per cell (grid (H, nc, b)), in two
// phases over panels of TP = min(32, L) rows, products as 4 x 4 register
// tiles (the forward's `outer`):
//   A. the state term, per panel of rows l: B dst, then ddte and dte o
//      (B dst) (dx's first part, to dx), and (x o dte) dst^T (to the dB
//      workspace); dst (N x P) stays in shared memory.
//   B. the quadratic term, per panel of columns j, over rows i >= j: cb
//      and dy x^T on the same register tile, then w and q to shared
//      memory and dW o E o dt_j to the dcb workspace; column sums of q
//      (ddt_j, and dcs_j's second term), row sums of q o dt (dcs_i's
//      first, added panel by panel by the thread of row i), and the
//      panel's rows of dx += w^T dy. C and dy (L x N, L x P) stay in
//      shared memory.
//   Shared memory at L = N = P = 128: ~207 KB, at mamba2's P = 64 ~166 KB.
// Launch 2, one block per 16 rows r of a chunk (grid (L / 16, nc, b)):
// the rows r of dcb and its columns r, each summed over the heads in
// order, then dC rows r = dcb[r] B and dB rows r = dcb[:, r]^T C plus the
// heads' state terms, in order.
namespace bwd {

using simt::kPad;
using simt::kThreads;
using simt::ld4;
using simt::outer;
using simt::to_float;

constexpr int kPanel = 32;   // rows (phase A) or columns (phase B) a panel
constexpr int kSumRows = 16; // rows r a block of the head sum

// element k of each of four rows, as one float4 (k unrolled to a constant)
__device__ __forceinline__ float4 column(const float4 (&v)[4], int k) {
  auto at = [k](const float4& u) { return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w; };
  return make_float4(at(v[0]), at(v[1]), at(v[2]), at(v[3]));
}

__host__ __device__ inline int panel(int L) { return L < kPanel ? L : kPanel; }
__host__ __device__ inline int sum_rows(int L) { return L < kSumRows ? L : kSumRows; }

// shared floats of launch 1: 7 vectors of L, the panels' B^T and x^T,
// then phase A's dst and B dst panel or phase B's C, dy, w and q
inline size_t cell_floats(int L, int N, int P) {
  const size_t T = panel(L) + kPad;
  const size_t common = 7 * static_cast<size_t>(L) + (N + P) * T;
  const size_t a = static_cast<size_t>(N) * (P + kPad) + panel(L) * static_cast<size_t>(P + kPad);
  const size_t b = static_cast<size_t>(L) * (N + kPad) + static_cast<size_t>(L) * (P + kPad) +
                   2 * static_cast<size_t>(L) * T;
  return common + (a > b ? a : b);
}

inline size_t sum_floats(int L, int N) {
  return 2 * static_cast<size_t>(L) * (N + kPad) + 2 * static_cast<size_t>(sum_rows(L)) * (L + kPad);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cell(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ cs, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const float* __restrict__ dy,
             const float* __restrict__ dst, float* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ dcs,
             float* __restrict__ ws_cb, float* __restrict__ ws_b, int S, int H,
             int P, int N, int L) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = S / L;
  const int TP = panel(L);
  const int ldt = TP + kPad, ldp = P + kPad, ldn = N + kPad;
  float* const sDt = smem;
  float* const sCs = sDt + L;
  float* const sSeg = sCs + L;
  float* const sDte = sSeg + L;
  float* const sDdte = sDte + L;
  float* const sRow = sDdte + L;     // sum_j q_ij dt_j, panel by panel
  float* const sCol = sRow + L;      // sum_i q_ij
  float* const sBt = sCol + L;       // N x ldt: the panel's rows of B, transposed
  float* const sXt = sBt + N * ldt;  // P x ldt: the panel's rows of x, transposed
  float* const sDst = sXt + P * ldt; // phase A: N x ldp
  float* const sBd = sDst + N * ldp; //          TP x ldp: B dst of the panel
  float* const sC = sXt + P * ldt;   // phase B: L x ldn
  float* const sDy = sC + L * ldn;   //          L x ldp
  float* const sW = sDy + L * ldp;   //          L x ldt: w[i][j] of the panel's j
  float* const sQ = sW + L * ldt;    //          L x ldt: q[i][j]
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const size_t cell = (static_cast<size_t>(b) * nc + c) * H + h;
  float* const wcb = ws_cb + cell * L * L;
  float* const wb = ws_b + cell * L * N;

  for (int l = tid; l < L; l += kThreads) {
    const size_t i = (row0 + l) * H + h;
    sDt[l] = dt[i];
    sCs[l] = cs[i];
    sRow[l] = 0.f;
  }
  for (int e = tid; e < N * P; e += kThreads) {
    const int n = e / P, p = e - n * P;
    sDst[n * ldp + p] = dst[cell * N * P + e];
  }
  __syncthreads();
  const float cs_end = sCs[L - 1];
  for (int l = tid; l < L; l += kThreads) {
    sSeg[l] = expf(cs_end - sCs[l]);
    sDte[l] = sDt[l] * sSeg[l];
  }

  // the panel's rows (phase A) or columns (phase B) of B and x, transposed
  auto load_panel = [&](int r0, int rows) {
    for (int e = tid; e < rows * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      sBt[n * ldt + r] = to_float(Bm[(row0 + r0 + r) * N + n]);
    }
    for (int e = tid; e < rows * P; e += kThreads) {
      const int r = e / P, p = e - r * P;
      sXt[p * ldt + r] = to_float(x[((row0 + r0 + r) * H + h) * P + p]);
    }
  };

  // ---- A. the state term, a panel of rows l at a time
  const int tp = P / 4, tn = N / 4;
  for (int l0 = 0; l0 < L; l0 += TP) {
    const int rows = min(TP, L - l0), tr = rows / 4;
    __syncthreads();   // the previous panel is done with sBt, sXt, sBd
    load_panel(l0, rows);
    __syncthreads();
    for (int t = tid; t < tr * (tp + tn); t += kThreads) {
      float acc[4][4] = {};
      if (t < tr * tp) {           // B dst (rows x P), k over n
        const int r0 = (t / tp) * 4, p0 = (t % tp) * 4;
        for (int n = 0; n < N; ++n)
          outer(acc, ld4(sBt + n * ldt + r0), ld4(sDst + n * ldp + p0));
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(sBd + (r0 + a) * ldp + p0) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      } else {                     // (x o dte) dst^T (rows x N), k over p
        const int u = t - tr * tp;
        const int r0 = (u / tn) * 4, n0 = (u % tn) * 4;
        for (int p = 0; p < P; ++p)
          outer(acc, ld4(sXt + p * ldt + r0),
                make_float4(sDst[n0 * ldp + p], sDst[(n0 + 1) * ldp + p],
                            sDst[(n0 + 2) * ldp + p], sDst[(n0 + 3) * ldp + p]));
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float d = sDte[l0 + r0 + a];
          *reinterpret_cast<float4*>(wb + static_cast<size_t>(l0 + r0 + a) * N + n0) =
              make_float4(acc[a][0] * d, acc[a][1] * d, acc[a][2] * d, acc[a][3] * d);
        }
      }
    }
    __syncthreads();
    // ddte_l = x_l . (B dst)_l, one thread a row; dx = dte o (B dst)
    for (int r = tid; r < rows; r += kThreads) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s = fmaf(sXt[p * ldt + r], sBd[r * ldp + p], s);
      sDdte[l0 + r] = s;
    }
    for (int e = tid; e < rows * tp; e += kThreads) {
      const int r = e / tp, p0 = (e % tp) * 4;
      const float d = sDte[l0 + r];
      const float4 v = ld4(sBd + r * ldp + p0);
      *reinterpret_cast<float4*>(dx + ((row0 + l0 + r) * H + h) * P + p0) =
          make_float4(v.x * d, v.y * d, v.z * d, v.w * d);
    }
  }
  __syncthreads();   // phase B's C and dy take the place of dst and B dst

  // ---- B. the quadratic term, a panel of columns j at a time
  for (int e = tid; e < L * N; e += kThreads) {
    const int i = e / N, n = e - i * N;
    sC[i * ldn + n] = to_float(Cm[(row0 + i) * N + n]);
  }
  for (int e = tid; e < L * P; e += kThreads) {
    const int i = e / P, p = e - i * P;
    sDy[i * ldp + p] = dy[((row0 + i) * H + h) * P + p];
  }
  for (int j0 = 0; j0 < L; j0 += TP) {
    const int cols = min(TP, L - j0), tcol = cols / 4;
    const int ti = (L - j0) / 4;   // row tiles i >= j0
    __syncthreads();   // the previous panel is done with sBt, sXt, sW, sQ
    load_panel(j0, cols);
    __syncthreads();
    // B1. cb and dW on one 4 x 4 tile (rows i0.., columns j0 + c0..);
    //     tiles wholly above the diagonal are skipped (never read)
    for (int t = tid; t < ti * tcol; t += kThreads) {
      const int i0 = j0 + (t / tcol) * 4, c0 = (t % tcol) * 4;
      if (j0 + c0 > i0 + 3) continue;
      float cb[4][4] = {}, dw[4][4] = {};
      for (int n = 0; n < N; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = ld4(sC + (i0 + a) * ldn + n);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          outer(cb, column(cv, k), ld4(sBt + (n + k) * ldt + c0));
      }
      for (int p = 0; p < P; p += 4) {
        float4 yv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = ld4(sDy + (i0 + a) * ldp + p);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          outer(dw, column(yv, k), ld4(sXt + (p + k) * ldt + c0));
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + a;
        float w[4], q[4], g[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + c0 + u;
          w[u] = q[u] = g[u] = 0.f;
          if (j <= i) {
            const float e = expf(sCs[i] - sCs[j]);
            const float cbe = cb[a][u] * e;
            w[u] = cbe * sDt[j];
            q[u] = dw[a][u] * cbe;
            g[u] = dw[a][u] * e * sDt[j];
          }
        }
        *reinterpret_cast<float4*>(sW + i * ldt + c0) = make_float4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<float4*>(sQ + i * ldt + c0) = make_float4(q[0], q[1], q[2], q[3]);
        *reinterpret_cast<float4*>(wcb + static_cast<size_t>(i) * L + j0 + c0) =
            make_float4(g[0], g[1], g[2], g[3]);
      }
    }
    __syncthreads();
    // B2. column sums of q (ddt), row sums of q o dt (dcs), and the
    //     panel's rows of dx += w^T dy over i >= j
    const int rows = L - j0;
    for (int t = tid; t < cols + rows + tcol * tp; t += kThreads) {
      if (t < cols) {
        const int j = j0 + t;
        float s = 0.f;
        for (int i = j; i < L; ++i) s += sQ[i * ldt + t];
        sCol[j] = s;
        ddt[(row0 + j) * H + h] = s + sDdte[j] * sSeg[j];
      } else if (t < cols + rows) {
        const int i = j0 + t - cols;
        const int cend = min(cols, i - j0 + 1);
        float s = 0.f;
        for (int u = 0; u < cend; ++u) s = fmaf(sQ[i * ldt + u], sDt[j0 + u], s);
        sRow[i] += s;
      } else {
        const int u = t - cols - rows;
        const int c0 = (u / tp) * 4, p0 = (u % tp) * 4;
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 v = ld4(dx + ((row0 + j0 + c0 + a) * H + h) * P + p0);
          acc[a][0] = v.x; acc[a][1] = v.y; acc[a][2] = v.z; acc[a][3] = v.w;
        }
        float part[4][4] = {};
        for (int i = j0 + c0; i < L; ++i)
          outer(part, ld4(sW + i * ldt + c0), ld4(sDy + i * ldp + p0));
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(dx + ((row0 + j0 + c0 + a) * H + h) * P + p0) =
              make_float4(part[a][0] + acc[a][0], part[a][1] + acc[a][1],
                          part[a][2] + acc[a][2], part[a][3] + acc[a][3]);
      }
    }
  }
  __syncthreads();
  // dcs: the row sums, the column sums, the state term, and at the last
  // row the chunk end's share of every row's state term
  for (int l = tid; l < L; l += kThreads) {
    float v = sRow[l] - sDt[l] * sCol[l] - sDdte[l] * sDte[l];
    if (l == L - 1) {
      float s = 0.f;
      for (int m = 0; m < L; ++m) s = fmaf(sDdte[m], sDte[m], s);
      v += s;
    }
    dcs[(row0 + l) * H + h] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum(const T* __restrict__ Bm, const T* __restrict__ Cm,
            const float* __restrict__ ws_cb, const float* __restrict__ ws_b,
            float* __restrict__ dB, float* __restrict__ dC, int S, int H,
            int N, int L) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int TR = sum_rows(L);
  const int r0 = blockIdx.x * TR, c = blockIdx.y, b = blockIdx.z;
  const int nc = S / L;
  const int rows = min(TR, L - r0);
  const int ldn = N + kPad, ldl = L + kPad;
  float* const sB = smem;              // L x ldn
  float* const sC = sB + L * ldn;      // L x ldn
  float* const sR = sC + L * ldn;      // TR x ldl: dcb[r][j], j <= r
  float* const sK = sR + TR * ldl;     // TR x ldl: dcb[i][r], i >= r
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const size_t cell0 = (static_cast<size_t>(b) * nc + c) * H;   // head 0's cell
  const size_t hs_cb = static_cast<size_t>(L) * L, hs_b = static_cast<size_t>(L) * N;

  for (int e = tid; e < L * N; e += kThreads) {
    const int l = e / N, n = e - l * N;
    sB[l * ldn + n] = to_float(Bm[(row0 + l) * N + n]);
    sC[l * ldn + n] = to_float(Cm[(row0 + l) * N + n]);
  }
  const float* const wcb = ws_cb + cell0 * hs_cb;
  for (int e = tid; e < rows * L; e += kThreads) {
    const int rr = e / L, j = e - rr * L, r = r0 + rr;
    float s = 0.f;
    if (j <= r)
      for (int hh = 0; hh < H; ++hh) s += wcb[hh * hs_cb + static_cast<size_t>(r) * L + j];
    sR[rr * ldl + j] = s;
  }
  for (int e = tid; e < L * rows; e += kThreads) {
    const int i = e / rows, rr = e - i * rows, r = r0 + rr;
    float s = 0.f;
    if (i >= r)
      for (int hh = 0; hh < H; ++hh) s += wcb[hh * hs_cb + static_cast<size_t>(i) * L + r];
    sK[rr * ldl + i] = s;
  }
  __syncthreads();
  const int tr = rows / 4, tn = N / 4;
  const float* const wb = ws_b + cell0 * hs_b;
  for (int t = tid; t < 2 * tr * tn; t += kThreads) {
    const bool is_c = t < tr * tn;
    const int u = is_c ? t : t - tr * tn;
    const int rr0 = (u / tn) * 4, n0 = (u % tn) * 4;
    float acc[4][4] = {};
    if (is_c) {   // dC[r] = sum_{j <= r} dcb[r][j] B[j]
      const int jend = r0 + rr0 + 4;
      for (int j = 0; j < jend; ++j)
        outer(acc, make_float4(sR[rr0 * ldl + j], sR[(rr0 + 1) * ldl + j],
                               sR[(rr0 + 2) * ldl + j], sR[(rr0 + 3) * ldl + j]),
              ld4(sB + j * ldn + n0));
    } else {      // dB[r] = sum_{i >= r} dcb[i][r] C[i] + the heads' state terms
      for (int i = r0 + rr0; i < L; ++i)
        outer(acc, make_float4(sK[rr0 * ldl + i], sK[(rr0 + 1) * ldl + i],
                               sK[(rr0 + 2) * ldl + i], sK[(rr0 + 3) * ldl + i]),
              ld4(sC + i * ldn + n0));
#pragma unroll
      for (int a = 0; a < 4; ++a)
        for (int hh = 0; hh < H; ++hh) {
          const float4 v = ld4(wb + hh * hs_b + static_cast<size_t>(r0 + rr0 + a) * N + n0);
          acc[a][0] += v.x; acc[a][1] += v.y; acc[a][2] += v.z; acc[a][3] += v.w;
        }
    }
    float* out = (is_c ? dC : dB) + (row0 + r0 + rr0) * N + n0;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(out + a * N) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* cs, const void* B,
           const void* C, const void* dy, const void* dst, void* dx, void* ddt,
           void* dcs, void* dB, void* dC, void* ws_cb, void* ws_b, int batch,
           int S, int H, int P, int N, int L, cudaStream_t stream) {
  const size_t bytes1 = cell_floats(L, N, P) * sizeof(float);
  const size_t bytes2 = sum_floats(L, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cell<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      ssd_bwd_sum<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes2));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_cell<T><<<dim3(H, S / L, batch), kThreads, bytes1, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cs), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(dy),
      static_cast<const float*>(dst), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dcs),
      static_cast<float*>(ws_cb), static_cast<float*>(ws_b), S, H, P, N, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int TR = sum_rows(L);
  ssd_bwd_sum<T><<<dim3((L + TR - 1) / TR, S / L, batch), kThreads, bytes2, stream>>>(
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(ws_cb), static_cast<const float*>(ws_b),
      static_cast<float*>(dB), static_cast<float*>(dC), S, H, N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

// ================================================ bf16, tensor cores
namespace tc {

using namespace hopper;

constexpr int kMaxGroup = 8;   // heads a block takes at most
constexpr int kStages = 2;     // depth of the X ring

// Shared memory at chunk L, d_state padded to NB and head_dim to PB (64 or
// 128). Every tile is column blocks of 64 bf16 by L rows (kBlock bytes
// each), 128-byte swizzled, from a 1024-byte aligned base.
template <int L, int NB, int PB>
struct Geom {
  static constexpr int kWG = L / 64;                 // warpgroups
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kBlock = L * 128;
  static constexpr int kCBytes = NB / 64 * kBlock;   // C, and B, of the chunk
  static constexpr int kXBytes = PB / 64 * kBlock;   // one head's X; each half of Xd
  static constexpr int kVecFloats = kMaxGroup * L;   // cs, dt, dte of the heads
  static constexpr int kBarBytes = 8 * (1 + kStages);
  static constexpr int kSmem = 1024 + 2 * kCBytes + kStages * kXBytes + 2 * kXBytes
                               + 3 * kVecFloats * 4 + kBarBytes;
  static_assert(L == 64 || L == 128, "chunk");
  static_assert((NB == 64 || NB == 128) && (PB == 64 || PB == 128), "widths");
};

__device__ __forceinline__ void widen8(uint4 u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// a = hi + lo, both bf16, for a pair of floats; returns (hi, lo) packed
__device__ __forceinline__ uint2 split_bf16(float a0, float a1) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a0, a1);
  const float2 h = __bfloat1622float2(hi);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a0 - h.x, a1 - h.y);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&hi),
                    *reinterpret_cast<const uint32_t*>(&lo));
}

// Store a warpgroup's 64 x PB fp32 accumulator to rows of stride `ld`
// floats: rows >= `rows` and columns >= `cols` are left out. Neighbouring
// threads (lane ^ 1) swap halves, so each stores 4 consecutive columns.
template <int PB>
__device__ __forceinline__ void store_tile(const float (&a)[PB / 2], float* out,
                                           size_t ld, int rows, int cols) {
  const int lane = threadIdx.x % 32;
  const int r = 16 * (threadIdx.x / 32 % 4) + lane / 4;
  const bool odd = lane & 1;
#pragma unroll
  for (int j = 0; j < PB / 8; ++j) {
    const float a0 = a[4 * j], a1 = a[4 * j + 1], b0 = a[4 * j + 2], b1 = a[4 * j + 3];
    const float s0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
    const float s1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
    const int row = odd ? r + 8 : r;
    const int col = 8 * j + 2 * (lane % 4) - (odd ? 2 : 0);
    if (row < rows && col < cols)
      *reinterpret_cast<float4*>(out + row * ld + col) =
          odd ? make_float4(s0, s1, b0, b1) : make_float4(a0, a1, s0, s1);
  }
}

template <int L, int NB, int PB>
__global__ void __launch_bounds__(Geom<L, NB, PB>::kThreads, 1)
ssd_chunk_tc(const __grid_constant__ CUtensorMap tm_x,
             const __grid_constant__ CUtensorMap tm_b,
             const __grid_constant__ CUtensorMap tm_c,
             const float* __restrict__ dt, const float* __restrict__ cs,
             float* __restrict__ y, float* __restrict__ st, int S, int H,
             int P, int N, int group) {
  using G = Geom<L, NB, PB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);   // the same bytes, generic
  const uint32_t sC = base;
  const uint32_t sB = sC + G::kCBytes;
  const uint32_t sX = sB + G::kCBytes;               // kStages tiles
  const uint32_t sXhi = sX + kStages * G::kXBytes;
  const uint32_t sXlo = sXhi + G::kXBytes;
  float* const sCs = reinterpret_cast<float*>(gbase + (sXlo + G::kXBytes - base));
  float* const sDt = sCs + G::kVecFloats;
  float* const sDte = sDt + G::kVecFloats;
  const uint32_t bc_bar = smem_u32(sDte + G::kVecFloats);
  const uint32_t x_bar = bc_bar + 8;                   // kStages barriers

  const int h0 = blockIdx.x * group;
  const int nh = min(group, H - h0);
  const int c = blockIdx.y, b = blockIdx.z;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;

  // head g's X tile into stage g % kStages (thread 0 issues every TMA load)
  auto load_x = [&](int g) {
    const int s = g % kStages;
    mbar_expect_tx(x_bar + 8 * s, G::kXBytes);
#pragma unroll
    for (int k = 0; k < PB / 64; ++k)
      tma_load(sX + s * G::kXBytes + k * G::kBlock, &tm_x, x_bar + 8 * s,
               64 * k, h0 + g, c * L, b);
  };
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bc_bar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(x_bar + 8 * s, 1);
    mbar_init_fence();
    mbar_expect_tx(bc_bar, 2 * G::kCBytes);
#pragma unroll
    for (int k = 0; k < NB / 64; ++k) {
      tma_load(sC + k * G::kBlock, &tm_c, bc_bar, 64 * k, c * L, b);
      tma_load(sB + k * G::kBlock, &tm_b, bc_bar, 64 * k, c * L, b);
    }
    load_x(0);
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wg = tid / 128;                     // rows i 64 wg .. 64 wg + 63
  const int r_a = 64 * wg + 16 * (warp % 4) + lane / 4;   // this thread's rows
  const int r_b = r_a + 8;
  const int col = 2 * (lane % 4);               // + 8 j (+ 1)

  // cs and dt of the block's heads, then dte = dt exp(cs_end - cs)
  for (int e = tid; e < nh * L; e += G::kThreads) {
    const int l = e / nh, g = e - l * nh;       // neighbours read neighbouring heads
    const size_t i = (row0 + l) * H + h0 + g;
    sCs[g * L + l] = cs[i];
    sDt[g * L + l] = dt[i];
  }
  __syncthreads();
  for (int e = tid; e < nh * L; e += G::kThreads)
    sDte[e] = sDt[e] * __expf(sCs[e / L * L + L - 1] - sCs[e]);
  // (the barrier before the first head's Xd orders these for every thread)

  // C Bᵀ once for all heads: key tiles kt <= wg of this warpgroup's rows
  float cb[G::kWG][32];
  mbar_wait(bc_bar, 0);
#pragma unroll
  for (int kt = 0; kt < G::kWG; ++kt) fence_regs(cb[kt]);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < G::kWG; ++kt) {
    if (kt > wg) continue;
    for (int ks = 0; ks < N / 16; ++ks) {
      const uint32_t k_off = ks / 4 * G::kBlock + 32 * (ks % 4);
      wgmma_ss<64, 0, 0>(cb[kt], make_desc(sC + k_off + 64 * wg * 128, 16, 1024, 1),
                         make_desc(sB + k_off + 64 * kt * 128, 16, 1024, 1), ks > 0);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int kt = 0; kt < G::kWG; ++kt) fence_regs(cb[kt]);

  const float kNegInf = -__int_as_float(0x7f800000);
  for (int g = 0; g < nh; ++g) {
    const int s = g % kStages, h = h0 + g;
    const float* cs_h = sCs + g * L;
    const float* dt_h = sDt + g * L;
    const float* dte_h = sDte + g * L;
    // every thread is done with head g - 1: its X stage, read by the
    // products and by Xd, takes head g + 1, and Xd may be rewritten
    __syncthreads();
    if (tid == 0 && g + 1 < nh) load_x(g + 1);
    mbar_wait(x_bar + 8 * s, (g / kStages) & 1);
    const uint32_t x_tile = sX + s * G::kXBytes;

    // 1. Xd = X o dte as bf16 hi + lo in X's layout
    for (int e = tid; e < L * (PB / 8); e += G::kThreads) {
      const int j = e / (PB / 8), k = e % (PB / 8);
      const uint32_t off = k / 8 * G::kBlock + j * 128 + ((k % 8 ^ j % 8) << 4);
      float v[8];
      widen8(*reinterpret_cast<const uint4*>(gbase + (x_tile - base) + off), v);
      const float d = dte_h[j];
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint2 p = split_bf16(v[2 * i] * d, v[2 * i + 1] * d);
        hi[i] = p.x;
        lo[i] = p.y;
      }
      *reinterpret_cast<uint4*>(gbase + (sXhi - base) + off) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(gbase + (sXlo - base) + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_proxy_async();

    // 2. y rows of this warpgroup: W on the C Bᵀ fragment, split, and
    //    y = W_hi X + W_lo X over key tiles kt <= wg
    float acc[PB / 2];
#pragma unroll
    for (int i = 0; i < PB / 2; ++i) acc[i] = 0.f;
    const float cs_a = cs_h[r_a], cs_b = cs_h[r_b];
    uint32_t w_hi[G::kWG][4][4], w_lo[G::kWG][4][4];
#pragma unroll
    for (int kt = 0; kt < G::kWG; ++kt) {
      if (kt > wg) continue;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int j = 64 * kt + 8 * (e / 4) + col;
        const bool upper = e % 4 < 2;
        const int i = upper ? r_a : r_b;
        const float cs_i = upper ? cs_a : cs_b;
        float w[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float arg = j + u <= i ? cs_i - cs_h[j + u] : kNegInf;
          w[u] = cb[kt][e + u] * __expf(arg) * dt_h[j + u];
        }
        const uint2 p = split_bf16(w[0], w[1]);
        w_hi[kt][e / 8][e % 8 / 2] = p.x;
        w_lo[kt][e / 8][e % 8 / 2] = p.y;
      }
      // every fragment is formed before the fence, not sunk between wgmmas
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(w_hi[kt][kk]);
        fence_regs(w_lo[kt][kk]);
      }
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < G::kWG; ++kt) {
      if (kt > wg) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = make_desc(x_tile + (64 * kt + 16 * kk) * 128, G::kBlock, 1024, 1);
        wgmma_rs<PB>(acc, w_hi[kt][kk], dx);
        wgmma_rs<PB>(acc, w_lo[kt][kk], dx);
      }
    }
    wgmma_commit();

    // 3. the state's 64-row tiles of n this warpgroup owns at this head,
    //    state = Bᵀ Xd_hi + Bᵀ Xd_lo; y is stored while the first runs
    __syncthreads();                            // every thread's Xd is written
    const size_t cell = (static_cast<size_t>(b) * (S / L) + c) * H + h;
    bool y_done = false;
    auto finish_y = [&]() {
      fence_regs(acc);
      store_tile<PB>(acc, y + ((row0 + 64 * wg) * H + h) * P,
                     static_cast<size_t>(H) * P, 64, P);
      y_done = true;
    };
#pragma unroll
    for (int t = 0; t < NB / 64; ++t) {
      if ((t + g) % G::kWG != wg) continue;
      float sacc[PB / 2];
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < L / 16; ++ks) {
        const uint64_t db = make_desc(sB + t * G::kBlock + 16 * ks * 128, G::kBlock, 1024, 1);
        wgmma_ss<PB, 1, 1>(sacc, db,
                           make_desc(sXhi + 16 * ks * 128, G::kBlock, 1024, 1), ks > 0);
        wgmma_ss<PB, 1, 1>(sacc, db,
                           make_desc(sXlo + 16 * ks * 128, G::kBlock, 1024, 1), 1);
      }
      wgmma_commit();
      if (!y_done) {
        wgmma_wait<1>();
        finish_y();
      }
      wgmma_wait<0>();
      fence_regs(sacc);
      store_tile<PB>(sacc, st + (cell * N + 64 * t) * P, P, N - 64 * t, P);
    }
    if (!y_done) {
      wgmma_wait<0>();
      finish_y();
    }
  }
}

template <int L, int NB, int PB>
int launch(const void* x, const void* dt, const void* cs, const void* B,
           const void* C, void* y, void* st, int batch, int S, int H, int P,
           int N, int group, cudaStream_t stream) {
  using G = Geom<L, NB, PB>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_tc<L, NB, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  // x: (P, H, S, batch) innermost first, boxes of (64, 1 head, L rows, 1);
  // B, C: (N, S, batch), boxes of (64, L rows, 1). Columns past P or N
  // read as zeros.
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(P), static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(batch)};
  const cuuint64_t x_strides[3] = {2ull * P, 2ull * P * H, 2ull * P * H * S};
  const cuuint32_t x_box[4] = {64u, 1u, static_cast<cuuint32_t>(L), 1u};
  const cuuint64_t bc_dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(S),
                                 static_cast<cuuint64_t>(batch)};
  const cuuint64_t bc_strides[2] = {2ull * N, 2ull * N * S};
  const cuuint32_t bc_box[3] = {64u, static_cast<cuuint32_t>(L), 1u};
  CUtensorMap tm_x, tm_b, tm_c;
  if (!encode_bf16(&tm_x, x, 4, x_dims, x_strides, x_box)
      || !encode_bf16(&tm_b, B, 3, bc_dims, bc_strides, bc_box)
      || !encode_bf16(&tm_c, C, 3, bc_dims, bc_strides, bc_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H + group - 1) / group, S / L, batch);
  ssd_chunk_tc<L, NB, PB><<<grid, G::kThreads, G::kSmem, stream>>>(
      tm_x, tm_b, tm_c, static_cast<const float*>(dt), static_cast<const float*>(cs),
      static_cast<float*>(y), static_cast<float*>(st), S, H, P, N, group);
  return static_cast<int>(cudaGetLastError());
}

// N and P pad to 64 or 128
template <int L>
int launch_at(const void* x, const void* dt, const void* cs, const void* B,
              const void* C, void* y, void* st, int batch, int S, int H,
              int P, int N, int group, cudaStream_t stream) {
  if (N > 64)
    return P > 64 ? launch<L, 128, 128>(x, dt, cs, B, C, y, st, batch, S, H, P, N, group, stream)
                  : launch<L, 128, 64>(x, dt, cs, B, C, y, st, batch, S, H, P, N, group, stream);
  return P > 64 ? launch<L, 64, 128>(x, dt, cs, B, C, y, st, batch, S, H, P, N, group, stream)
                : launch<L, 64, 64>(x, dt, cs, B, C, y, st, batch, S, H, P, N, group, stream);
}

}  // namespace tc

// ============================================ backward, bf16, tensor cores
// The backward of the chunk function (the formulas of namespace bwd, with
// the exponent masked before the exp) for bf16 x, B, C at L 64 or 128, N
// and P multiples of 16, N <= 128, and P <= 64 at L = 128 (P <= 128 at
// L = 64); ops.py `bwd_route` sends those calls here. Like namespace bwd
// it replaces no TPU kernel: the reference differentiates its plain
// chunked scan (src/repro/models/ssd.py ssd_scan_reference) by autodiff.
//
// Bound on this card: bytes. At mamba2-130m's train shape (b 4, S 512, H
// 24, P 64, N 128, L 128) the call must move ~48 MB (x, dt, cs, B, C, dy,
// dst read once; dx, ddt, dcs, dB, dC written once): ~14.3 us at 3.35
// TB/s, against ~6 GFLOP of split products (~6 us at the bf16 tensor peak).
//
// What the design does about it:
//  * One block per (group of heads, chunk, batch row), `group` as the
//    forward's (ops.py head_group: 3 at mamba2's train shape, 128 blocks,
//    one wave). One warpgroup per 64 rows j; every L x L matrix is held
//    transposed (rows j, columns i >= j), so that w^T, the A operand of
//    dx = w^T dy, is formed in registers on the accumulator it came from.
//  * B C^T (= (C B^T)^T) once a block, by wgmma from TMA-loaded B and C
//    (exact: bf16 products in fp32), kept in shared memory in fragment
//    order (each thread reads back its own 32 floats of a tile as float4s).
//  * Per head, on the tensor cores with the forward's split-bf16 scheme
//    (an fp32 operand is hi + lo in bf16, lo.lo dropped; x, B, C are exact):
//    B dst (into dx's accumulator, then scaled by dte row by row), dW^T =
//    x dy^T on the causal 64 x 64 tiles, dx += w^T dy (register A operand),
//    and the state term x dst^T, scaled by dte after the product and added
//    to dB's accumulator, which stays in registers across the block's heads.
//    dy and dst arrive in fp32 as 32-byte loads and are split once into hi
//    and lo halves in wgmma's swizzled layout; x by TMA.
//  * On the fragments: q^T = dW^T o bc o E, w^T = bc o E o dt_j and g^T =
//    dW^T o E o dt_j, exp taken only for i >= j (argument selected first);
//    row sums by quad shuffles, column sums by shuffles over the 8 rows of
//    a warp then per warp through shared memory, summed in warp order;
//    g^T summed over the block's heads in head order in shared memory
//    (fragment order). dx is written once.
//  * After the last head: dcb^T as hi + lo bf16 in shared memory, dB +=
//    dcb^T C and dC = dcb B on the tensor cores, and the block's partial dB
//    and dC (L x N each, fp32) to a workspace of b nc groups L N 2 floats
//    (16.8 MB at mamba2's train shape); a second launch sums the groups of
//    each chunk in group order (no atomics: two calls give the same bits).
//    That workspace is written and read once, ~34 MB beside the 48 MB.
// Shared memory at L = N = 128, P = 64: ~216 KB, one block an SM.
namespace tcb {

using namespace hopper;
using tc::split_bf16;
using tc::store_tile;

template <int L, int NB, int PB>
struct Geom {
  static constexpr int kWG = L / 64;                      // warpgroups: rows j
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kTiles = kWG * (kWG + 1) / 2;      // causal 64 x 64 tiles
  static constexpr int kRows = L * 128;                   // a column block of L rows
  static constexpr int kBBytes = NB / 64 * kRows;         // B, and C, of the chunk
  static constexpr int kFragBytes = kTiles * 64 * 64 * 4; // an L x L fp32 matrix
  static constexpr int kXBytes = PB / 64 * kRows;         // x; each half of dy
  static constexpr int kDstBytes = PB / 64 * NB * 128;    // each half of dst
  static constexpr int kOpBytes = 3 * kXBytes + 2 * kDstBytes;
  // cs, dt, seg, dte of two heads; ddte and the row sums of q^T; per warp
  // column sums of q^T o dt_j, and sums of ddte o dte
  static constexpr int kVecFloats = 10 * L + 4 * kWG * (L + 1);
  static constexpr int kSmem = 1024 + kBBytes + 2 * kFragBytes + kOpBytes
                               + 4 * kVecFloats + 3 * 8;
  static_assert(L == 64 || L == 128, "chunk");
  static_assert((NB == 64 || NB == 128) && (PB == 64 || PB == 128), "widths");
  static_assert(L == 64 || PB == 64, "P <= 64 at L = 128");
  static_assert(kBBytes <= kOpBytes && kBBytes <= kFragBytes, "C's places");
  static_assert(4 * L * L <= kOpBytes, "dcb^T hi/lo in the operand region");
  static_assert(kSmem <= 232448, "shared memory");
};

// index of tile (row band jb, column tile it >= jb) of an L x L matrix
template <int kWG>
__device__ __forceinline__ int tile_id(int jb, int it) {
  return jb * kWG - jb * (jb - 1) / 2 + (it - jb);
}

// byte offset of element (r, c) in a tile of column blocks of 64 bf16 by
// `block` / 128 rows, 128-byte swizzled
__device__ __forceinline__ uint32_t swz(int r, int c, int block) {
  return (c / 64) * block + r * 128 + ((((c % 64) / 8) ^ (r % 8)) << 4) + (c % 8) * 2;
}

// A head's dy (kRowsA = L rows) and dst (kRowsB = NB rows), each rows x
// cols fp32 with row stride ld floats, into bf16 hi and lo tiles of kCols
// columns (padded rows and columns zeros), in units of 8 floats, each
// thread with up to 4 units in flight
template <int kRowsA, int kRowsB, int kCols, int kThreads>
__device__ __forceinline__ void split_two(const float* __restrict__ a, size_t lda, int rows_a,
                                          uint8_t* hi_a, uint8_t* lo_a,
                                          const float* __restrict__ b, size_t ldb, int rows_b,
                                          uint8_t* hi_b, uint8_t* lo_b, int cols, int tid) {
  constexpr int kPerRow = kCols / 8;
  constexpr int kUnitsA = kRowsA * kPerRow;
  constexpr int kUnits = kUnitsA + kRowsB * kPerRow;
  constexpr int kBatch = 4;
#pragma unroll 1
  for (int u0 = tid; u0 < kUnits; u0 += kThreads * kBatch) {
    float4 v[kBatch][2];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int u = u0 + k * kThreads;
      const bool in_a = u < kUnitsA;
      const int w = in_a ? u : u - kUnitsA;
      const int r = w / kPerRow, c = w % kPerRow * 8;
      v[k][0] = v[k][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (u < kUnits && r < (in_a ? rows_a : rows_b) && c < cols) {
        const float4* p = reinterpret_cast<const float4*>(in_a ? a + r * lda + c
                                                               : b + r * ldb + c);
        v[k][0] = __ldg(p);
        v[k][1] = __ldg(p + 1);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int u = u0 + k * kThreads;
      if (u >= kUnits) continue;
      const bool in_a = u < kUnitsA;
      const int w = in_a ? u : u - kUnitsA;
      const int r = w / kPerRow, c = w % kPerRow * 8;
      const uint2 p0 = split_bf16(v[k][0].x, v[k][0].y);
      const uint2 p1 = split_bf16(v[k][0].z, v[k][0].w);
      const uint2 p2 = split_bf16(v[k][1].x, v[k][1].y);
      const uint2 p3 = split_bf16(v[k][1].z, v[k][1].w);
      const uint32_t off = swz(r, c, (in_a ? kRowsA : kRowsB) * 128);
      *reinterpret_cast<uint4*>((in_a ? hi_a : hi_b) + off) = make_uint4(p0.x, p1.x, p2.x, p3.x);
      *reinterpret_cast<uint4*>((in_a ? lo_a : lo_b) + off) = make_uint4(p0.y, p1.y, p2.y, p3.y);
    }
  }
}

// dW^T = x dy^T on causal tile (wg, it): x rows 64 wg.. and dy rows 64 it..
// (both K-major, K = p), dy as hi + lo; issued and committed
template <int kRows>
__device__ __forceinline__ void issue_dw(float (&dw)[32], uint32_t sX, uint32_t sDyHi,
                                         uint32_t sDyLo, int wg, int it, int P) {
  for (int ks = 0; ks < P / 16; ++ks) {
    const uint32_t k_off = ks / 4 * kRows + 32 * (ks % 4);
    const uint64_t da = make_desc(sX + k_off + 64 * wg * 128, 16, 1024, 1);
    wgmma_ss<64, 0, 0>(dw, da, make_desc(sDyHi + k_off + 64 * it * 128, 16, 1024, 1), ks > 0);
    wgmma_ss<64, 0, 0>(dw, da, make_desc(sDyLo + k_off + 64 * it * 128, 16, 1024, 1), 1);
  }
  wgmma_commit();
}

template <int L, int NB, int PB>
__global__ void __launch_bounds__(Geom<L, NB, PB>::kThreads, 1)
ssd_bwd_tc(const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_b,
           const __grid_constant__ CUtensorMap tm_c,
           const float* __restrict__ dt, const float* __restrict__ cs,
           const float* __restrict__ dy, const float* __restrict__ dst,
           float* __restrict__ dx, float* __restrict__ ddt,
           float* __restrict__ dcs, float* __restrict__ ws, int S, int H,
           int P, int N, int group) {
  using G = Geom<L, NB, PB>;
  constexpr int kWG = G::kWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);   // the same bytes, generic
  auto gp = [&](uint32_t a) { return gbase + (a - base); };
  const uint32_t sB = base;
  const uint32_t sBC = sB + G::kBBytes;       // B C^T in fragment order; C at the end
  const uint32_t sDcb = sBC + G::kFragBytes;  // sum over heads of g^T, fragment order
  const uint32_t sOp = sDcb + G::kFragBytes;  // C at the start; then per head:
  const uint32_t sX = sOp;                    //   x
  const uint32_t sDyHi = sX + G::kXBytes;     //   dy, hi and lo
  const uint32_t sDyLo = sDyHi + G::kXBytes;
  const uint32_t sDstHi = sDyLo + G::kXBytes; //   dst, hi and lo
  const uint32_t sDstLo = sDstHi + G::kDstBytes;
  const uint32_t sDh = sOp;                   // at the end: dcb^T hi and lo
  const uint32_t sDl = sOp + 2 * L * L;
  float* const sVec = reinterpret_cast<float*>(gp(sOp + G::kOpBytes));
  // head g's cs, dt, seg, dte at sVec + 4 L (g % 2), L each
  float* const sDdte = sVec + 8 * L;
  float* const sRowQ = sDdte + L;
  float* const sCol = sRowQ + L;              // (4 kWG warps) x L
  float* const sWarp = sCol + 4 * kWG * L;    // 4 kWG warps
  const uint32_t bc_bar = smem_u32(sVec + G::kVecFloats);
  const uint32_t x_bar = bc_bar + 8;
  const uint32_t c_bar = x_bar + 8;
  float4* const frag_bc = reinterpret_cast<float4*>(gp(sBC));
  float4* const frag_dcb = reinterpret_cast<float4*>(gp(sDcb));

  const int h0 = blockIdx.x * group;
  const int nh = min(group, H - h0);
  const int c = blockIdx.y, b = blockIdx.z;
  const int nc = S / L;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = tid / 128, t = tid % 128;     // rows j 64 wg .. 64 wg + 63
  const int r_a = 64 * wg + 16 * (warp % 4) + lane / 4;   // this thread's rows
  const int r_b = r_a + 8;
  const int col = 2 * (lane % 4);              // + 8 k (+ 1)

  if (tid == 0) {
    mbar_init(bc_bar, 1);
    mbar_init(x_bar, 1);
    mbar_init(c_bar, 1);
    mbar_init_fence();
    mbar_expect_tx(bc_bar, 2 * G::kBBytes);
#pragma unroll
    for (int k = 0; k < NB / 64; ++k) {
      tma_load(sB + k * G::kRows, &tm_b, bc_bar, 64 * k, c * L, b);
      tma_load(sOp + k * G::kRows, &tm_c, bc_bar, 64 * k, c * L, b);
    }
  }
  __syncthreads();

  // B C^T: this warpgroup's tiles (rows j of B, columns i of C), K = n
  mbar_wait(bc_bar, 0);
  for (int it = wg; it < kWG; ++it) {
    float acc[32];
    fence_regs(acc);
    wgmma_fence();
    for (int ks = 0; ks < N / 16; ++ks) {
      const uint32_t k_off = ks / 4 * G::kRows + 32 * (ks % 4);
      wgmma_ss<64, 0, 0>(acc, make_desc(sB + k_off + 64 * wg * 128, 16, 1024, 1),
                         make_desc(sOp + k_off + 64 * it * 128, 16, 1024, 1), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    float4* f = frag_bc + tile_id<kWG>(wg, it) * 8 * 128 + t;
#pragma unroll
    for (int r4 = 0; r4 < 8; ++r4)
      f[r4 * 128] = make_float4(acc[4 * r4], acc[4 * r4 + 1], acc[4 * r4 + 2], acc[4 * r4 + 3]);
  }

  float st[NB / 2];   // dB rows j: the heads' state terms, then + dcb^T C
#pragma unroll
  for (int k = 0; k < NB / 2; ++k) st[k] = 0.f;
  const float kNegInf = -__int_as_float(0x7f800000);

  // head g's x (TMA), its cs, dt, seg and dte, its dy and dst split
  auto load_head = [&](int g) {
    const int h = h0 + g;
    const size_t cell = (static_cast<size_t>(b) * nc + c) * H + h;
    if (tid == 0) {
      mbar_expect_tx(x_bar, G::kXBytes);
#pragma unroll
      for (int k = 0; k < PB / 64; ++k)
        tma_load(sX + k * G::kRows, &tm_x, x_bar, 64 * k, h, c * L, b);
    }
    float* const v = sVec + 4 * L * (g % 2);
    for (int l = tid; l < L; l += G::kThreads) {
      const float cl = cs[(row0 + l) * H + h];
      const float dl = dt[(row0 + l) * H + h];
      const float sg = __expf(cs[(row0 + L - 1) * H + h] - cl);
      v[l] = cl;
      v[L + l] = dl;
      v[2 * L + l] = sg;
      v[3 * L + l] = dl * sg;
    }
    split_two<L, NB, PB, G::kThreads>(
        dy + (row0 * H + h) * P, static_cast<size_t>(H) * P, L, gp(sDyHi), gp(sDyLo),
        dst + cell * N * P, P, N, gp(sDstHi), gp(sDstLo), P, tid);
  };
  __syncthreads();   // every warpgroup's B C^T is done with C
  load_head(0);
  fence_proxy_async();
  __syncthreads();

  for (int g = 0; g < nh; ++g) {
    const int h = h0 + g;
    const float* const sCs = sVec + 4 * L * (g % 2);
    const float* const sDt = sCs + L;
    const float* const sSeg = sDt + L;
    const float* const sDte = sSeg + L;
    mbar_wait(x_bar, g & 1);

    // 1. dx = dte o (B dst) on this warpgroup's rows; ddte = x . (B dst)
    float dxa[PB / 2];
    fence_regs(dxa);
    wgmma_fence();
    for (int ks = 0; ks < N / 16; ++ks) {
      const uint32_t k_off = ks / 4 * G::kRows + 32 * (ks % 4);
      const uint64_t da = make_desc(sB + k_off + 64 * wg * 128, 16, 1024, 1);
      wgmma_ss<PB, 0, 1>(dxa, da, make_desc(sDstHi + 16 * ks * 128, NB * 128, 1024, 1), ks > 0);
      wgmma_ss<PB, 0, 1>(dxa, da, make_desc(sDstLo + 16 * ks * 128, NB * 128, 1024, 1), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dxa);
    {
      float s_a = 0.f, s_b = 0.f;
#pragma unroll
      for (int k = 0; k < PB / 8; ++k) {
        const int p = 8 * k + col;
        const float2 xa = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(gp(sX) + swz(r_a, p, G::kRows)));
        const float2 xb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(gp(sX) + swz(r_b, p, G::kRows)));
        s_a = fmaf(dxa[4 * k], xa.x, fmaf(dxa[4 * k + 1], xa.y, s_a));
        s_b = fmaf(dxa[4 * k + 2], xb.x, fmaf(dxa[4 * k + 3], xb.y, s_b));
      }
      s_a += __shfl_xor_sync(0xffffffffu, s_a, 1);
      s_a += __shfl_xor_sync(0xffffffffu, s_a, 2);
      s_b += __shfl_xor_sync(0xffffffffu, s_b, 1);
      s_b += __shfl_xor_sync(0xffffffffu, s_b, 2);
      const float de_a = sDte[r_a], de_b = sDte[r_b];
      // this warp's share of sum_l ddte_l dte_l (the chunk end's dcs term)
      float e = fmaf(s_a, de_a, s_b * de_b);
#pragma unroll
      for (int m = 4; m < 32; m *= 2) e += __shfl_xor_sync(0xffffffffu, e, m);
      if (lane % 4 == 0) {
        sDdte[r_a] = s_a;
        sDdte[r_b] = s_b;
      }
      if (lane == 0) sWarp[warp] = e;
#pragma unroll
      for (int k = 0; k < PB / 8; ++k) {
        dxa[4 * k] *= de_a;
        dxa[4 * k + 1] *= de_a;
        dxa[4 * k + 2] *= de_b;
        dxa[4 * k + 3] *= de_b;
      }
    }

    // 2. per causal tile (rows j of this warpgroup, columns i >= j):
    //    dW^T = x dy^T, then q^T, w^T, g^T on the fragment, dx += w^T dy
    const float cs_a = sCs[r_a], cs_b = sCs[r_b];
    const float dt_a = sDt[r_a], dt_b = sDt[r_b];
    float rq_a = 0.f, rq_b = 0.f;   // row sums of q^T
    for (int it = wg; it < kWG; ++it) {
      float dw[32];
      fence_regs(dw);
      wgmma_fence();
      issue_dw<G::kRows>(dw, sX, sDyHi, sDyLo, wg, it, P);
      wgmma_wait_all();
      fence_regs(dw);

      const int tile = tile_id<kWG>(wg, it);
      const float4* fbc = frag_bc + tile * 8 * 128 + t;
      float4* fdcb = frag_dcb + tile * 8 * 128 + t;
      uint32_t w_hi[4][4], w_lo[4][4];
#pragma unroll
      for (int r4 = 0; r4 < 8; ++r4) {
        const float4 b4 = fbc[r4 * 128];
        const float bc[4] = {b4.x, b4.y, b4.z, b4.w};
        const int i0 = 64 * it + 8 * r4 + col;
        const float cs_i[2] = {sCs[i0], sCs[i0 + 1]};
        float w[4], gg[4], qd[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool upper = k < 2;        // row r_a, else r_b
          const int j = upper ? r_a : r_b;
          const int i = i0 + (k & 1);
          const float dtj = upper ? dt_a : dt_b;
          const float arg = i >= j ? cs_i[k & 1] - (upper ? cs_a : cs_b) : kNegInf;
          const float e = __expf(arg);
          const float bce = bc[k] * e;
          const float q = dw[4 * r4 + k] * bce;
          w[k] = bce * dtj;
          gg[k] = dw[4 * r4 + k] * e * dtj;
          qd[k] = q * dtj;
          if (upper) rq_a += q;
          else rq_b += q;
        }
        // column sums of q^T o dt_j over this warp's 16 rows j
        float c0 = qd[0] + qd[2], c1 = qd[1] + qd[3];
#pragma unroll
        for (int m = 4; m < 32; m *= 2) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, m);
          c1 += __shfl_xor_sync(0xffffffffu, c1, m);
        }
        if (lane < 4) {
          sCol[warp * L + i0] = c0;
          sCol[warp * L + i0 + 1] = c1;
        }
        const float4 d4 = g == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : fdcb[r4 * 128];
        fdcb[r4 * 128] = make_float4(d4.x + gg[0], d4.y + gg[1], d4.z + gg[2], d4.w + gg[3]);
        const uint2 pa = split_bf16(w[0], w[1]), pb = split_bf16(w[2], w[3]);
        w_hi[r4 / 2][2 * (r4 % 2)] = pa.x;
        w_hi[r4 / 2][2 * (r4 % 2) + 1] = pb.x;
        w_lo[r4 / 2][2 * (r4 % 2)] = pa.y;
        w_lo[r4 / 2][2 * (r4 % 2) + 1] = pb.y;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(w_hi[kk]);
        fence_regs(w_lo[kk]);
      }
      fence_regs(dxa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = (64 * it + 16 * kk) * 128;
        const uint64_t dh = make_desc(sDyHi + off, G::kRows, 1024, 1);
        const uint64_t dl = make_desc(sDyLo + off, G::kRows, 1024, 1);
        wgmma_rs<PB>(dxa, w_hi[kk], dh);
        wgmma_rs<PB>(dxa, w_hi[kk], dl);
        wgmma_rs<PB>(dxa, w_lo[kk], dh);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dxa);
    }

    // 3. the state term (x o dte) dst^T = diag(dte) x dst^T into dB's rows,
    //    issued before dx is stored
    float sa[NB / 2];
    fence_regs(sa);
    wgmma_fence();
    for (int ks = 0; ks < P / 16; ++ks) {
      const uint64_t da = make_desc(sX + ks / 4 * G::kRows + 32 * (ks % 4) + 64 * wg * 128,
                                    16, 1024, 1);
      const uint32_t d_off = ks / 4 * (NB * 128) + 32 * (ks % 4);
      wgmma_ss<NB, 0, 0>(sa, da, make_desc(sDstHi + d_off, 16, 1024, 1), ks > 0);
      wgmma_ss<NB, 0, 0>(sa, da, make_desc(sDstLo + d_off, 16, 1024, 1), 1);
    }
    wgmma_commit();
    rq_a += __shfl_xor_sync(0xffffffffu, rq_a, 1);
    rq_a += __shfl_xor_sync(0xffffffffu, rq_a, 2);
    rq_b += __shfl_xor_sync(0xffffffffu, rq_b, 1);
    rq_b += __shfl_xor_sync(0xffffffffu, rq_b, 2);
    if (lane % 4 == 0) {
      sRowQ[r_a] = rq_a;
      sRowQ[r_b] = rq_b;
    }
    store_tile<PB>(dxa, dx + ((row0 + 64 * wg) * H + h) * P, static_cast<size_t>(H) * P,
                   64, P);
    wgmma_wait<0>();
    fence_regs(sa);
    {
      const float de_a = sDte[r_a], de_b = sDte[r_b];
#pragma unroll
      for (int k = 0; k < NB / 8; ++k) {
        st[4 * k] = fmaf(sa[4 * k], de_a, st[4 * k]);
        st[4 * k + 1] = fmaf(sa[4 * k + 1], de_a, st[4 * k + 1]);
        st[4 * k + 2] = fmaf(sa[4 * k + 2], de_b, st[4 * k + 2]);
        st[4 * k + 3] = fmaf(sa[4 * k + 3], de_b, st[4 * k + 3]);
      }
    }

    // 4. the next head's operands, then this head's ddt and dcs, a thread
    //    a row
    fence_proxy_async();
    __syncthreads();   // every row and column sum is in; x, dy, dst are free
    if (g + 1 < nh) load_head(g + 1);
    for (int l = tid; l < L; l += G::kThreads) {
      float cols = 0.f;                          // warps of bands <= l's tile
      for (int w = 0; w < 4 * (l / 64 + 1); ++w) cols += sCol[w * L + l];
      const float rq = sRowQ[l], dd = sDdte[l];
      ddt[(row0 + l) * H + h] = rq + dd * sSeg[l];
      float v = cols - sDt[l] * rq - dd * sDte[l];
      if (l == L - 1)                            // the chunk end's share
        for (int w = 0; w < 4 * kWG; ++w) v += sWarp[w];
      dcs[(row0 + l) * H + h] = v;
    }
    fence_proxy_async();
    __syncthreads();   // the sums are read; the next head's operands are in
  }

  // 5. dcb^T as bf16 hi + lo (rows j, columns i); C into B C^T's place
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(c_bar, G::kBBytes);
#pragma unroll
    for (int k = 0; k < NB / 64; ++k)
      tma_load(sBC + k * G::kRows, &tm_c, c_bar, 64 * k, c * L, b);
  }
  for (int it = wg; it < kWG; ++it) {
    const float4* f = frag_dcb + tile_id<kWG>(wg, it) * 8 * 128 + t;
#pragma unroll
    for (int r4 = 0; r4 < 8; ++r4) {
      const float4 v = f[r4 * 128];
      const int i = 64 * it + 8 * r4 + col;
      const uint2 pa = split_bf16(v.x, v.y), pb = split_bf16(v.z, v.w);
      *reinterpret_cast<uint32_t*>(gp(sDh) + swz(r_a, i, G::kRows)) = pa.x;
      *reinterpret_cast<uint32_t*>(gp(sDl) + swz(r_a, i, G::kRows)) = pa.y;
      *reinterpret_cast<uint32_t*>(gp(sDh) + swz(r_b, i, G::kRows)) = pb.x;
      *reinterpret_cast<uint32_t*>(gp(sDl) + swz(r_b, i, G::kRows)) = pb.y;
    }
  }
  fence_proxy_async();
  __syncthreads();
  mbar_wait(c_bar, 0);

  // 6. dB rows j += dcb^T C (K = i >= 64 wg); dC rows i = dcb B (K = j <= i)
  fence_regs(st);
  wgmma_fence();
  for (int ks = 4 * wg; ks < L / 16; ++ks) {
    const uint32_t k_off = ks / 4 * G::kRows + 32 * (ks % 4) + 64 * wg * 128;
    const uint64_t dc = make_desc(sBC + 16 * ks * 128, G::kRows, 1024, 1);
    wgmma_ss<NB, 0, 1>(st, make_desc(sDh + k_off, 16, 1024, 1), dc, 1);
    wgmma_ss<NB, 0, 1>(st, make_desc(sDl + k_off, 16, 1024, 1), dc, 1);
  }
  wgmma_commit();
  float dca[NB / 2];
  fence_regs(dca);
  wgmma_fence();
  for (int ks = 0; ks < 4 * (wg + 1); ++ks) {
    const uint32_t a_off = wg * G::kRows + 16 * ks * 128;
    const uint64_t db = make_desc(sB + 16 * ks * 128, G::kRows, 1024, 1);
    wgmma_ss<NB, 1, 1>(dca, make_desc(sDh + a_off, G::kRows, 1024, 1), db, ks > 0);
    wgmma_ss<NB, 1, 1>(dca, make_desc(sDl + a_off, G::kRows, 1024, 1), db, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(st);
  fence_regs(dca);
  // the block's partials: ws (2, b, nc, groups, L, N)
  const size_t slab = (static_cast<size_t>(b) * nc + c) * gridDim.x + blockIdx.x;
  const size_t half = static_cast<size_t>(gridDim.z) * nc * gridDim.x * L * N;
  store_tile<NB>(st, ws + (slab * L + 64 * wg) * N, N, 64, N);
  store_tile<NB>(dca, ws + half + (slab * L + 64 * wg) * N, N, 64, N);
}

// dB and dC: each chunk's group partials summed in group order, 4 floats
// a thread
__global__ void __launch_bounds__(256)
ssd_bwd_tc_sum(const float4* __restrict__ ws, float4* __restrict__ dB,
               float4* __restrict__ dC, int batch, int S, int N, int L, int groups) {
  const size_t n4 = N / 4;
  const size_t total = static_cast<size_t>(batch) * S * n4;   // float4s an output
  const size_t half = total * groups;
  const size_t stride = static_cast<size_t>(L) * n4;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < 2 * total;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const bool is_c = e >= total;
    const size_t u = is_c ? e - total : e;
    const size_t row = u / n4, q = u % n4;       // row = b S + s
    const size_t bb = row / S, s = row % S;
    const size_t chunk = bb * (S / L) + s / L;
    const float4* src = ws + (is_c ? half : 0) + (chunk * groups * L + s % L) * n4 + q;
    float4 acc = src[0];
    for (int g = 1; g < groups; ++g) {
      const float4 v = src[g * stride];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    (is_c ? dC : dB)[u] = acc;
  }
}

template <int L, int NB, int PB>
int launch(const void* x, const void* dt, const void* cs, const void* B,
           const void* C, const void* dy, const void* dst, void* dx, void* ddt,
           void* dcs, void* dB, void* dC, void* ws, int batch, int S, int H,
           int P, int N, int group, cudaStream_t stream) {
  using G = Geom<L, NB, PB>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_tc<L, NB, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  // the forward's maps: x (P, H, S, batch), boxes of (64, 1, L, 1); B, C
  // (N, S, batch), boxes of (64, L, 1); columns past P or N read as zeros
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(P), static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(batch)};
  const cuuint64_t x_strides[3] = {2ull * P, 2ull * P * H, 2ull * P * H * S};
  const cuuint32_t x_box[4] = {64u, 1u, static_cast<cuuint32_t>(L), 1u};
  const cuuint64_t bc_dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(S),
                                 static_cast<cuuint64_t>(batch)};
  const cuuint64_t bc_strides[2] = {2ull * N, 2ull * N * S};
  const cuuint32_t bc_box[3] = {64u, static_cast<cuuint32_t>(L), 1u};
  CUtensorMap tm_x, tm_b, tm_c;
  if (!encode_bf16(&tm_x, x, 4, x_dims, x_strides, x_box)
      || !encode_bf16(&tm_b, B, 3, bc_dims, bc_strides, bc_box)
      || !encode_bf16(&tm_c, C, 3, bc_dims, bc_strides, bc_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (H + group - 1) / group;
  ssd_bwd_tc<L, NB, PB><<<dim3(groups, S / L, batch), G::kThreads, G::kSmem, stream>>>(
      tm_x, tm_b, tm_c, static_cast<const float*>(dt), static_cast<const float*>(cs),
      static_cast<const float*>(dy), static_cast<const float*>(dst),
      static_cast<float*>(dx), static_cast<float*>(ddt), static_cast<float*>(dcs),
      static_cast<float*>(ws), S, H, P, N, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t vecs = 2ull * batch * S * (N / 4);
  const int blocks = static_cast<int>(vecs > 4096 * 256 ? 4096 : (vecs + 255) / 256);
  ssd_bwd_tc_sum<<<blocks, 256, 0, stream>>>(
      static_cast<const float4*>(ws), static_cast<float4*>(dB), static_cast<float4*>(dC),
      batch, S, N, L, groups);
  return static_cast<int>(cudaGetLastError());
}

// N pads to 64 or 128; P to 64, or to 128 at L = 64
template <int L>
int launch_at(const void* x, const void* dt, const void* cs, const void* B,
              const void* C, const void* dy, const void* dst, void* dx, void* ddt,
              void* dcs, void* dB, void* dC, void* ws, int batch, int S, int H,
              int P, int N, int group, cudaStream_t stream) {
#define SSD_BWD_TC_ARGS x, dt, cs, B, C, dy, dst, dx, ddt, dcs, dB, dC, ws, batch, S, H, P, N, group, stream
  if constexpr (L == 64) {
    if (P > 64)
      return N > 64 ? launch<L, 128, 128>(SSD_BWD_TC_ARGS) : launch<L, 64, 128>(SSD_BWD_TC_ARGS);
  } else {
    if (P > 64) return static_cast<int>(cudaErrorInvalidValue);
  }
  return N > 64 ? launch<L, 128, 64>(SSD_BWD_TC_ARGS) : launch<L, 64, 64>(SSD_BWD_TC_ARGS);
#undef SSD_BWD_TC_ARGS
}

}  // namespace tcb

}  // namespace

extern "C" {

// x: (batch, S, H, P); B, C: (batch, S, N); dt, cs: (batch, S, H) fp32;
// y: (batch, S, H, P) fp32; st: (batch, S / L, H, N, P) fp32. All
// contiguous; S % L == 0. Each returns the launch's cudaError_t (0 =
// launched).

// The CUDA-core kernel: x, B, C all fp32 (is_bf16 = 0) or bf16 (is_bf16 =
// 1); L, N, P multiples of 4, at most 128.
int ssd_chunk_fwd(const void* x, const void* dt, const void* cs,
                  const void* B, const void* C, void* y, void* st, int batch,
                  int S, int H, int P, int N, int L, int is_bf16,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? simt::launch<__nv_bfloat16>(x, dt, cs, B, C, y, st, batch, S, H, P, N, L, s)
      : simt::launch<float>(x, dt, cs, B, C, y, st, batch, S, H, P, N, L, s);
}

// The tensor-core kernel: x, B, C bf16, 16-byte aligned; L 64 or 128; N
// and P multiples of 16, at most 128; `group` heads a block (1 to 8).
int ssd_chunk_fwd_tc(const void* x, const void* dt, const void* cs,
                     const void* B, const void* C, void* y, void* st,
                     int batch, int S, int H, int P, int N, int L, int group,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || group > tc::kMaxGroup || N % 16 || P % 16 || N > 128 || P > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (L) {
    case 64: return tc::launch_at<64>(x, dt, cs, B, C, y, st, batch, S, H, P, N, group, s);
    case 128: return tc::launch_at<128>(x, dt, cs, B, C, y, st, batch, S, H, P, N, group, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward (the CUDA-core kernels of namespace bwd): x, B, C fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); dt, cs, dy (batch, S, H, P), dst
// (batch, S / L, H, N, P) and the outputs dx (batch, S, H, P), ddt, dcs
// (batch, S, H), dB, dC (batch, S, N) fp32; the workspaces ws_cb (batch,
// S / L, H, L, L) and ws_b (batch, S / L, H, L, N) fp32. Two launches on
// `stream`; L, N, P multiples of 4, at most 128.
int ssd_chunk_bwd(const void* x, const void* dt, const void* cs,
                  const void* B, const void* C, const void* dy,
                  const void* dst, void* dx, void* ddt, void* dcs, void* dB,
                  void* dC, void* ws_cb, void* ws_b, int batch, int S, int H,
                  int P, int N, int L, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L % 4 || N % 4 || P % 4 || L < 4 || N < 4 || P < 4 || L > 128 || N > 128 || P > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16
      ? bwd::launch<__nv_bfloat16>(x, dt, cs, B, C, dy, dst, dx, ddt, dcs, dB, dC,
                                   ws_cb, ws_b, batch, S, H, P, N, L, s)
      : bwd::launch<float>(x, dt, cs, B, C, dy, dst, dx, ddt, dcs, dB, dC, ws_cb,
                           ws_b, batch, S, H, P, N, L, s);
}

// The tensor-core backward (namespace tcb): x, B, C bf16 and x, B, C, dy,
// dst 16-byte aligned; L 64 or 128; N and P multiples of 16, N at most
// 128, P at most 64 at L = 128 and 128 at L = 64; `group` heads a block;
// ws: (2, batch, S / L, ceil(H / group), L, N) fp32, the groups' partial
// dB and dC. Two launches on `stream`: the blocks, then the group sum.
int ssd_chunk_bwd_tc(const void* x, const void* dt, const void* cs,
                     const void* B, const void* C, const void* dy,
                     const void* dst, void* dx, void* ddt, void* dcs, void* dB,
                     void* dC, void* ws, int batch, int S, int H, int P, int N,
                     int L, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || N % 16 || P % 16 || N > 128 || P > (L == 64 ? 128 : 64))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (L) {
    case 64: return tcb::launch_at<64>(x, dt, cs, B, C, dy, dst, dx, ddt, dcs, dB, dC, ws,
                                       batch, S, H, P, N, group, s);
    case 128: return tcb::launch_at<128>(x, dt, cs, B, C, dy, dst, dx, ddt, dcs, dB, dC, ws,
                                         batch, S, H, P, N, group, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
