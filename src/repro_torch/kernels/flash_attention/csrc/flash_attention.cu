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
// on an H100 SXM. Reaching either needs the products on the tensor cores
// and the loads off the threads' critical path.
//
// Two kernels, chosen by the input type (the wrapper dispatches on it):
//
// bf16: the tensor-core kernel (flash_fwd_tc). Both products are wgmma,
// K/V tiles come in by TMA, nothing is widened in shared memory.
//  * One block per (q tile of 64 rows, q head, batch row): one consumer
//    warpgroup (wgmma's M = 64) and one producer warp. The q tiles are
//    launched last first, so the longest causal rows start first.
//  * The producer loads the Q tile once and then K/V tiles of 64 keys into
//    a 2-stage ring, by TMA with 128-byte swizzle (64-byte at head_dim 32);
//    a head_dim 128 row is two boxes of 64 dims. "full" mbarriers carry the
//    TMA byte counts, "empty" ones the consumers' release of a stage.
//  * S = Q Kᵀ: wgmma m64n64k16, A = Q and B = K from shared memory, both
//    K-major (d contiguous) as they are stored.
//  * Online softmax on the fp32 accumulator fragment: a row's 64 scores lie
//    in a quad of threads (shfl_xor 1, 2); exp2 with log2(e) folded into
//    the scale; each thread keeps its share of the running sum, reduced
//    once at the end.
//  * O += P V: P is rounded to bf16 in registers, where the S fragment is
//    already wgmma's register A layout; V is the MN-major (transposed) B
//    operand from shared memory. O stays in fp32 registers. The running
//    sum is of the fp32 p; P's rounding moves an output by at most
//    2^-9 max|v| before the bf16 store, inside the bf16 tolerance.
//  * Epilogue: O / max(l, 1e-30) in bf16, rows >= Sq not stored.
//  * GQA: q head h reads kv head h / (H / KV); q_offset is per batch row
//    (B,) int32, read on the device.
//  * Ragged edges: TMA zero-fills rows past Sq and Sk inside each batch row
//    (4-D maps over (D, heads, rows, batch)); keys >= Sk get p = 0 in the
//    kernel as well, query rows >= Sq are not stored. There is no tiling
//    constraint on Sq or Sk. Tiles wholly outside the causal/window mask
//    are never loaded (the loop bounds); the per-element mask runs only on
//    tiles that cross a mask edge.
//
// head_dim 256 (gemma3-4b), bf16: the same kernel, one consumer warpgroup
// of 64 query rows and the producer warp. What changes:
//  * shared memory: Q 32 KB + 2 stages x (K + V) of 32 KB + 1 KB of
//    alignment, ~165 KB: one block an SM, so the instantiation is bounded
//    __launch_bounds__(160, 1) (D <= 128 keep (160, 2)), which lets a
//    thread hold up to 255 registers;
//  * registers: the fp32 O accumulator is 64 x 256 / 128 = 128 registers a
//    thread, beside S (32) and P (16) — under the 255 cap, so O stays in
//    one warpgroup's registers, and the split of O over two consumer
//    warpgroups of 128 dims each is not needed: ptxas for sm_90a reports
//    202 registers and no spill (chip_smoke.py phase 2 prints it);
//  * O += P V is one wgmma m64n256k16 a k16 step (hopper::wgmma_rs_n256),
//    V's four column blocks of 64 dims one leading byte offset apart;
//  * a 256-dim row of Q, K or V is four 64-dim boxes of 128-byte swizzle.
//
// fp32: the CUDA-core kernel (flash_fwd_fp32). The tensor cores cannot hold
// the fp32 tolerance (2e-5), so fp32 inputs keep plain fp32 FMAs: one block
// per (q tile of 32 rows, q head, batch row), 4 warps of 8 query rows, K/V
// tiles of 32 keys in shared memory (K rows padded to D + 1 floats against
// bank conflicts; 98,432 bytes at D = 256), warp-shuffle softmax, P·V
// broadcast by shuffle. No serving path runs it: the models serve in bf16.
//
// Masked-but-existing keys get the score -1e30 in both kernels, exactly as
// in the TPU kernel, so a row matches the oracle whenever it has one
// unmasked key.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../include/hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr float kNegInf = -1e30f;

// ====================================================== fp32, CUDA cores
namespace simt {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr int kThreads = 32 * kWarps;

// Rows [row0, row0 + n_rows) of a (rows, D) slab with row stride
// `src_stride` elements, into shared memory with row stride `dst_stride`;
// rows at or past `n_valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const float* src, size_t src_stride,
                                          int row0, int n_valid, int n_rows) {
  constexpr int kVecPerRow = D / 4;
  for (int i = threadIdx.x; i < n_rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_valid)
      u = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * src_stride + c);
    float* d = dst + r * dst_stride + c;
    d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ q_offset,
               float* __restrict__ out, int Sq, int Sk, int H, int KV,
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
  const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * KV + hk) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * KV + hk) * D;
  load_rows<D>(sQ, D, qb, q_stride, q0, Sq, kBQ);

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
    load_rows<D>(sK, D + 1, kb, kv_stride, t * kBK, Sk, kBK);
    load_rows<D>(sV, D, vb, kv_stride, t * kBK, Sk, kBK);
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
    float* o = out + (static_cast<size_t>(b) * Sq + qi) * q_stride
                   + static_cast<size_t>(h) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) o[lane + 32 * i] = acc[r][i] * inv;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* q_offset,
           void* out, int B, int Sq, int Sk, int H, int KV, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_fp32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_offset),
      static_cast<float*>(out), Sq, Sk, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ================================================ bf16, tensor cores
namespace tc {

using namespace hopper;

constexpr int kBQ = 64;          // query rows per block: wgmma's M
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kStages = 2;       // depth of the K/V ring
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry at head_dim D. A tile is stored as TMA writes it:
// column blocks of kCB dims, each (rows x kCB) with kCB * 2 bytes a row,
// swizzled (128 B rows: 128-byte swizzle; 64 B rows at D = 32: 64-byte).
template <int D>
struct Geom {
  static constexpr int kCB = D < 64 ? D : 64;
  static constexpr int kRowBytes = kCB * 2;
  static constexpr int kAtomBytes = 8 * kRowBytes;       // 8 rows: one swizzle atom
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;  // descriptor: 128B / 64B swizzle
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;          // one K or V tile
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  // + 1 KB to align the base to the 1024-byte swizzle period
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes + kBarBytes;
  // blocks an SM the launch bounds ask for: two up to D = 128; at D = 256
  // the shared memory allows one, and O needs 128 registers a thread
  static constexpr int kMinBlocks = D <= 128 ? 2 : 1;
  static_assert(D % 16 == 0 && D % kCB == 0 && D <= 256, "head_dim");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// (wgmma's fragment layout: include/hopper.cuh)
template <int D>
__global__ void __launch_bounds__(kThreads, Geom<D>::kMinBlocks)
flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const int* __restrict__ q_offset, __nv_bfloat16* __restrict__ out,
             int Sq, int Sk, int H, int KV, int causal, int window,
             float scale_log2) {
  using G = Geom<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + G::kQBytes;                 // kStages tiles
  const uint32_t sV = sK + kStages * G::kTileBytes;    // kStages tiles
  const uint32_t q_bar = sV + kStages * G::kTileBytes;
  const uint32_t full_bar = q_bar + 8;                 // kStages barriers
  const uint32_t empty_bar = full_bar + 8 * kStages;   // kStages barriers

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // longest rows first
  const int hk = h / (H / KV);
  const int qoff = q_offset[b];

  // kv tiles that hold at least one unmasked key for some row of the block
  const int n_tiles = (Sk + kBK - 1) / kBK;
  const int q_lo = qoff + q0;
  const int q_hi = qoff + min(q0 + kBQ, Sq) - 1;
  int t_end = n_tiles;
  if (causal) t_end = q_hi < 0 ? 0 : min(n_tiles, q_hi / kBK + 1);
  const int t_begin = window > 0 ? max(0, q_lo - window + 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      mbar_expect_tx(q_bar, G::kQBytes);
#pragma unroll
      for (int c = 0; c < D / G::kCB; ++c)
        tma_load(sQ + c * kBQ * G::kRowBytes, &tm_q, q_bar, c * G::kCB, h, q0, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(empty_bar + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, 2 * G::kTileBytes);
#pragma unroll
        for (int c = 0; c < D / G::kCB; ++c) {
          const uint32_t off = s * G::kTileBytes + c * kBK * G::kRowBytes;
          tma_load(sK + off, &tm_k, full_bar + 8 * s, c * G::kCB, hk, t * kBK, b);
          tma_load(sV + off, &tm_v, full_bar + 8 * s, c * G::kCB, hk, t * kBK, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int row = 16 * warp + lane / 4;    // and row + 8
  const int qp_a = qoff + q0 + row;        // query positions of the two rows
  const int qp_b = qp_a + 8;
  const int col = 2 * (lane % 4);          // + 8 j (+ 1)

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int s = i % kStages;
    mbar_wait(full_bar + 8 * s, (i / kStages) & 1);
    const uint32_t k_tile = sK + s * G::kTileBytes;
    const uint32_t v_tile = sV + s * G::kTileBytes;

    // S = Q Kᵀ: D / 16 steps of k16; a step moves 32 bytes along a swizzled
    // row, and to the next column block after kCB / 16 steps
    float sc[kBK / 2];
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk / (G::kCB / 16), w = kk % (G::kCB / 16);
      const uint64_t da = make_desc(sQ + cb * kBQ * G::kRowBytes + 32 * w, 16,
                                    G::kAtomBytes, G::kLayout);
      const uint64_t db = make_desc(k_tile + cb * kBK * G::kRowBytes + 32 * w, 16,
                                    G::kAtomBytes, G::kLayout);
      wgmma_ss<64, 0, 0>(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scores in log2 units; the mask only on tiles that cross an edge
    const int k0 = t * kBK;
    const bool inside = k0 + kBK <= Sk && (!causal || k0 + kBK - 1 <= q_lo)
                        && (window <= 0 || q_hi - k0 < window);
    if (inside) {
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) sc[j] *= scale_log2;
    } else {
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        const int key = k0 + 8 * (j / 4) + col + (j % 2);
        const int qp = (j % 4) < 2 ? qp_a : qp_b;
        bool keep = key < Sk;
        if (causal) keep = keep && key <= qp;
        if (window > 0) keep = keep && qp - key < window;
        sc[j] = keep ? sc[j] * scale_log2 : kNegInf;
      }
    }
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 2; j += 4) {
      mx_a = fmaxf(mx_a, fmaxf(sc[j], sc[j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[j + 2], sc[j + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const bool is_a = (j % 4) < 2;
      float p = exp2f(sc[j] - (is_a ? mn_a : mn_b));
      if (!inside && k0 + 8 * (j / 4) + col + (j % 2) >= Sk) p = 0.f;
      sc[j] = p;
      if (is_a) sum_a += p; else sum_b += p;
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int j = 0; j < D / 2; j += 4) {
      o[j] *= alpha_a;
      o[j + 1] *= alpha_a;
      o[j + 2] *= alpha_b;
      o[j + 3] *= alpha_b;
    }

    // P in bf16: the accumulator fragment of keys 16 kk .. 16 kk + 15 is
    // wgmma's register A fragment of the k16 step kk
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // O += P V: V is MN-major; a k16 step is 16 key rows, the next column
    // block of kCB dims lies kBK rows on (the leading byte offset); one
    // wgmma of N = D a step (n256 at D = 256)
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk],
                  make_desc(v_tile + 16 * kk * G::kRowBytes, kBK * G::kRowBytes,
                            G::kAtomBytes, G::kLayout));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(empty_bar + 8 * s);   // the stage may be refilled
  }

  // epilogue: each row's sum lies in its quad
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  const size_t row_stride = static_cast<size_t>(H) * D;
  __nv_bfloat16* out_a = out + (static_cast<size_t>(b) * Sq + q0 + row) * row_stride
                             + static_cast<size_t>(h) * D + col;
  __nv_bfloat16* out_b = out_a + 8 * row_stride;
  const bool store_a = q0 + row < Sq, store_b = q0 + row + 8 < Sq;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (store_a)
      *reinterpret_cast<__nv_bfloat162*>(out_a + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    if (store_b)
      *reinterpret_cast<__nv_bfloat162*>(out_b + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

// A 4-D map over a contiguous bf16 (batch, rows, heads, D) tensor, dims
// innermost first, with a (kCB dims, 1 head, box_rows rows, 1 batch) box.
// Rows past `rows` read as zeros within each batch row.
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int batch, int rows, int heads,
            int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads, 2ull * D * heads * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Geom<D>::kCB), 1u,
                             static_cast<cuuint32_t>(box_rows), 1u};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* q_offset,
           void* out, int B, int Sq, int Sk, int H, int KV, int causal,
           int window, float scale, cudaStream_t stream) {
  using G = Geom<D>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode<D>(&tm_q, q, B, Sq, H, kBQ) || !encode<D>(&tm_k, k, B, Sk, KV, kBK)
      || !encode<D>(&tm_v, v, B, Sk, KV, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_fwd_tc<D><<<grid, kThreads, G::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const int*>(q_offset),
      static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, causal, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// q, out: (B, Sq, H, D); k, v: (B, Sk, KV, D), all contiguous, 16-byte
// aligned; q_offset: (B,) int32 on the device. window <= 0 means global.
// D in {32, 64, 128, 256}. Each returns the launch's cudaError_t (0 =
// launched).

// bf16: the tensor-core kernel
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* q_offset, void* out, int B, int Sq,
                             int Sk, int H, int KV, int D, int causal,
                             int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return tc::launch<32>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    case 64: return tc::launch<64>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    case 128: return tc::launch<128>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    case 256: return tc::launch<256>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fp32: the CUDA-core kernel
int flash_attention_fwd_fp32(const void* q, const void* k, const void* v,
                             const void* q_offset, void* out, int B, int Sq,
                             int Sk, int H, int KV, int D, int causal,
                             int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return simt::launch<32>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    case 64: return simt::launch<64>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    case 128: return simt::launch<128>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    case 256: return simt::launch<256>(q, k, v, q_offset, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
