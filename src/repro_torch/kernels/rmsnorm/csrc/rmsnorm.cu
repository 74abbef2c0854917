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
// 3.35 TB/s). One cooperative launch does it all, with no fill: a
// persistent grid (as many blocks as can be resident, at most the plan's)
// walks the rows, each block writes one fp32 partial row of dw, the grid
// syncs, and each block sums a slice of dw's columns over the partial rows
// in a fixed order, so dw has the same bits on every run of one plan (no
// atomics). Two routes of the walk, picked on the host (ops.py `plan_bwd`):
//  * ring (D <= 16384 in bf16, 8192 in fp32; every train path): a group of
//    warps owns a row, at most 4 vectors a lane, so w and the lane's share
//    of dw stay in registers; rows of x and dy reach shared memory through
//    bulk copies (cp.async.bulk on an mbarrier) into a ring of slots that
//    each group refills ahead (a slot's first row goes out when the slot
//    before it has landed, so an SM's rows arrive one after another and
//    its compute is not all left to the end). A one-warp group reduces the
//    row sums through shuffles alone; a larger one adds one named barrier
//    of the group a row; no block barrier a row. At (2048, 2048) bf16: 4
//    groups of 2 warps a block, 2 slots a group, up to 64 KB of rows in
//    flight an SM;
//  * stripe (wider rows, 8 vectors a thread): a block owns a row in
//    registers, the next row's loads in flight, one barrier a row.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../include/hopper.cuh"

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
namespace cg = cooperative_groups;

constexpr int kRouteRing = 0;      // ops.py ROUTES
constexpr int kRouteStripe = 1;
constexpr int kRingVecs = 4;       // ring route: 16-byte vectors of a row a lane holds
constexpr int kMaxBwdVecs = 8;     // stripe route: 16-byte vectors a thread holds

struct BwdArgs {
  const void* x;
  const float* w;
  const void* dy;
  void* dx;
  float* partial;    // (gridDim.x, d) fp32: one partial row of dw a block
  float* dw;
  int n_rows;
  int d;
  int group;         // ring route: warps a row (a power of two, at most 16)
  int stages;        // ring route: rows of x and dy a group has staged
  float eps;
};

__device__ __forceinline__ void add4(float4& s, float4 t) {
  s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
}

// Once every block has written its partial row (after the grid sync):
// dw[c] = the sum over the partial rows j of partial[j, c], in a fixed
// order. Block b takes the b-th slice of the columns, 4 at a time. Within
// a warp, `lanes` lanes (a power of two, at most 32, no more than the
// partial rows need) share a group of 4 columns: lane i of them adds the
// partial rows i, i + lanes, ... in order (their loads issued 8 at a time,
// so up to 8 x 32 partial rows cost one round trip to L2), then a shuffle
// tree adds the lanes' sums; the warp's other lanes take the next groups
// of columns.
__device__ void sum_partials(const float* __restrict__ partial,
                             float* __restrict__ dw, int d) {
  const int quads = d / 4, parts = gridDim.x;
  const int per = (quads + parts - 1) / parts;
  const int q0 = blockIdx.x * per, q1 = min(q0 + per, quads);
  int lanes = 1;
  while (lanes < parts && lanes < 32) lanes <<= 1;
  const int lane = threadIdx.x & 31, sub = lane % lanes;
  const int step = (blockDim.x >> 5) * (32 / lanes);  // column groups a block-wide pass
  const float4* p = reinterpret_cast<const float4*>(partial);
  for (int qb = q0 + (threadIdx.x >> 5) * (32 / lanes); qb < q1; qb += step) {
    const int q = qb + lane / lanes;        // warp-uniform loop: every lane shuffles
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = sub; q < q1 && j0 < parts; j0 += 8 * lanes) {
      float4 t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = j0 + i * lanes;
        t[i] = j < parts ? __ldcg(p + static_cast<size_t>(j) * quads + q)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) add4(s, t[i]);
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
      s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
      s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
    }
    if (q < q1 && sub == 0) reinterpret_cast<float4*>(dw)[q] = s;
  }
}

// Waits until the `threads` threads of named barrier `id` have arrived.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// The ring route (rows of up to 16 x 4 x 32 vectors: D <= 16384 in bf16,
// 8192 in fp32). A group of `group` warps owns a row: lane l of warp k of
// it holds the vectors (32 k + l) + 32 group j, j < NV <= kRingVecs, of
// the row, their w and their share of dw in registers (w read once). Group
// g of the grid takes rows g, g + G, g + 2G, ... (G groups in the grid).
// Each group has a ring of `stages` slots in shared memory, each holding
// one row of x and one of dy; the group's first lane fills a slot with two
// bulk copies completing on the slot's `full` mbarrier (the first slot at
// once, each further one when the slot before it has landed), and refills
// it with the group's row `stages` ahead once every warp of the group has
// arrived on the slot's `empty` mbarrier. Both passes over a row read it
// from the slot. A warp reduces the row sums through shuffles; a group of
// more than one warp adds its warps' sums through shared memory (double
// buffered by row parity) after one named barrier of the group. At the
// end each group writes its dw share into its slots, the block sums the
// groups' shares in group order into its partial row, the grid syncs, and
// sum_partials adds the partial rows.
// Smem: [groups x stages slots of 2 rows][full mbarriers][empty mbarriers]
// [row sums: a warp's 2 parities x 2 floats] (ops.py `_ring_smem`).
template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads, 1)
rmsnorm_bwd_ring(BwdArgs a) {
  constexpr int V = 16 / sizeof(T);
  using R = typename Raw<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = a.d, n_rows = a.n_rows, S = a.stages, G = a.group;
  const int vecs = d / V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_groups = (blockDim.x >> 5) / G, grp = warp / G, k = warp % G;
  const uint32_t row_bytes = static_cast<uint32_t>(d) * sizeof(T);
  const uint32_t slot = 2u * row_bytes, group_bytes = S * slot;
  unsigned char* ring = smem + grp * group_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + n_groups * group_bytes);
  uint64_t* full = bars + grp * S;
  uint64_t* empty = bars + (n_groups + grp) * S;
  float* sums = reinterpret_cast<float*>(bars + 2 * n_groups * S);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  const int first = blockIdx.x * n_groups + grp;
  const int stride = gridDim.x * n_groups;
  const bool leader = k == 0 && lane == 0;

  auto fetch = [&](int s, int row) {         // the leader: the row into slot s
    const uint32_t b = hopper::smem_u32(full + s);
    const uint32_t dst = hopper::smem_u32(ring + s * slot);
    const size_t off = static_cast<size_t>(row) * d;
    hopper::mbar_expect_tx(b, slot);
    hopper::bulk_load(dst, x + off, row_bytes, b);
    hopper::bulk_load(dst + row_bytes, dy + off, row_bytes, b);
  };
  if (leader) {                              // the first row goes out first
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(hopper::smem_u32(full + s), 1);
      hopper::mbar_init(hopper::smem_u32(empty + s), G);
    }
    hopper::mbar_init_fence();
    if (first < n_rows) fetch(0, first);
  }
  float wv[NV][V], acc[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = 32 * k + lane + 32 * G * j;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
    if (v < vecs) {
#pragma unroll
      for (int i = 0; i < V; i += 4) widen(load_raw(a.w + v * V + i), wv[j] + i);
    }
  }
  __syncthreads();                           // the mbarriers are initialised

  int it = 0;
  for (int row = first; row < n_rows; row += stride, ++it) {
    const int s = it % S;
    const uint32_t phase = (it / S) & 1;
    hopper::mbar_wait(hopper::smem_u32(full + s), phase);
    // the next slot's first row goes out once this one has landed: an
    // SM's rows then arrive one after another and its compute starts
    // early, instead of every row landing, and being computed, at the end
    if (leader && it + 1 < S && row + stride < n_rows) fetch(it + 1, row + stride);
    const R* xs = reinterpret_cast<const R*>(ring + s * slot);
    const R* gs = reinterpret_cast<const R*>(ring + s * slot + row_bytes);
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = 32 * k + lane + 32 * G * j;
      if (v < vecs) {
        float xf[V], df[V];
        widen(xs[v], xf);
        widen(gs[v], df);
        float p = 0.f, t = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          p += xf[i] * xf[i];
          t += (df[i] * wv[j][i]) * xf[i];
        }
        ss += p;
        sg += t;
      }
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    if (G > 1) {                             // the group's warps, in order
      float* mine = sums + 4 * warp + 2 * (it & 1);
      if (lane == 0) {
        mine[0] = ss;
        mine[1] = sg;
      }
      named_sync(1 + grp, 32 * G);
      const float* all = sums + 4 * grp * G + 2 * (it & 1);
      ss = 0.f;
      sg = 0.f;
      for (int i = 0; i < G; ++i) {
        ss += all[4 * i];
        sg += all[4 * i + 1];
      }
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + a.eps);
    const float rr = r * r, mgx = sg / static_cast<float>(d);
    T* dxr = dx + static_cast<size_t>(row) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = 32 * k + lane + 32 * G * j;
      if (v < vecs) {
        float xf[V], df[V], o[V];
        widen(xs[v], xf);
        widen(gs[v], df);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          o[i] = r * (df[i] * wv[j][i] - (xf[i] * rr) * mgx);
          acc[j][i] += df[i] * (xf[i] * r);
        }
        store_vec(dxr + v * V, o);
      }
    }
    __syncwarp();                            // every lane is done with slot s
    if (lane == 0) hopper::mbar_arrive(hopper::smem_u32(empty + s));
    const int next = row + S * stride;
    if (leader && next < n_rows) {
      hopper::mbar_wait(hopper::smem_u32(empty + s), phase);
      hopper::fence_proxy_async();
      fetch(s, next);
    }
  }

  // The group's dw share into its slots (d fp32 fit in one slot), then the
  // block's partial row: the groups' shares summed in group order.
  __syncthreads();                           // every slot has been read
  float* share = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = 32 * k + lane + 32 * G * j;
    if (v < vecs) {
#pragma unroll
      for (int i = 0; i < V; i += 4) store_vec(share + v * V + i, acc[j] + i);
    }
  }
  __syncthreads();
  float* part = a.partial + static_cast<size_t>(blockIdx.x) * d;
  for (int c = threadIdx.x * 4; c < d; c += blockDim.x * 4) {
    float4 t = *reinterpret_cast<const float4*>(smem + c * 4);
    for (int g = 1; g < n_groups; ++g)
      add4(t, *reinterpret_cast<const float4*>(smem + g * group_bytes + c * 4));
    *reinterpret_cast<float4*>(part + c) = t;
  }
  cg::this_grid().sync();
  sum_partials(a.partial, a.dw, d);
}

// The stripe route (wider rows): a block owns a row, a thread kMaxBwdVecs
// vectors of it in registers; block b takes rows b, b + grid, ..., with
// the next row's loads in flight, one barrier a row for the block-wide
// sums, and writes its partial row from registers; then the grid syncs and
// sum_partials adds the partial rows.
template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_stripe(BwdArgs a) {
  constexpr int V = 16 / sizeof(T);
  using R = typename Raw<T>::type;
  __shared__ float partial[2][2][32];       // [row parity][sum x^2, sum g x][warp]
  const int d = a.d, n_rows = a.n_rows;
  const int step = blockDim.x * V;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);

  float wv[NV][V], acc[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = threadIdx.x * V + k * step;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
    if (c < d) {
#pragma unroll
      for (int i = 0; i < V; i += 4) widen(load_raw(a.w + c + i), wv[k] + i);
    }
  }

  R xv[NV], gv[NV];
  const int r0 = blockIdx.x;                 // the grid is never wider than n_rows
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = threadIdx.x * V + k * step;
    if (r0 < n_rows && c < d) {
      xv[k] = load_raw(x + static_cast<size_t>(r0) * d + c);
      gv[k] = load_raw(dy + static_cast<size_t>(r0) * d + c);
    }
  }
  int par = 0;
  for (int row = r0; row < n_rows; row += gridDim.x, par ^= 1) {
    const size_t base = static_cast<size_t>(row) * d;
    const size_t nbase = static_cast<size_t>(row + gridDim.x) * d;
    R xn[NV], gn[NV];                       // the next row, in flight
    const bool more = row + static_cast<int>(gridDim.x) < n_rows;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = threadIdx.x * V + k * step;
      if (more && c < d) {
        xn[k] = load_raw(x + nbase + c);
        gn[k] = load_raw(dy + nbase + c);
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
    const float r = rsqrtf(ss / static_cast<float>(d) + a.eps);
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
  float* pr = a.partial + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = threadIdx.x * V + k * step;
    if (c < d) {
#pragma unroll
      for (int i = 0; i < V; i += 4) store_vec(pr + c + i, acc[k] + i);
    }
  }
  cg::this_grid().sync();
  sum_partials(a.partial, a.dw, d);
}

using BwdKernel = void (*)(BwdArgs);

// The kernel of a route at NV vectors a thread; null for a pair that is
// not built (ring: NV <= kRingVecs; stripe: NV == kMaxBwdVecs, the only
// count a row too wide for the ring gives).
template <typename T>
BwdKernel bwd_kernel(int route, int nv) {
  if (route == kRouteRing) {
    switch (nv) {
      case 1: return rmsnorm_bwd_ring<T, 1>;
      case 2: return rmsnorm_bwd_ring<T, 2>;
      case kRingVecs: return rmsnorm_bwd_ring<T, kRingVecs>;
    }
  } else if (route == kRouteStripe && nv == kMaxBwdVecs) {
    return rmsnorm_bwd_stripe<T, kMaxBwdVecs>;
  }
  return nullptr;
}

BwdKernel bwd_kernel(int is_bf16, int route, int nv) {
  return is_bf16 ? bwd_kernel<__nv_bfloat16>(route, nv)
                 : bwd_kernel<float>(route, nv);
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

// Blocks of the backward kernel of (is_bf16, route, nv) that can be
// resident on one SM at `threads` threads and `smem` bytes of dynamic
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), after
// letting the kernel use the device's opt-in shared memory; the wrapper
// asks once per plan, before the plan's first launch, and sizes the grid
// from it. Returns -(cudaError_t) on an error.
int rmsnorm_bwd_blocks_per_sm(int is_bf16, int route, int nv, int threads,
                              int smem) {
  const BwdKernel k = bwd_kernel(is_bf16, route, nv);
  if (!k) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0, blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, k);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(e);
  }
  return blocks;
}

// x, dy, dx: (n_rows, d) contiguous, fp32 (is_bf16 = 0) or bf16 (1); w:
// (d,) fp32; dw: (d,) fp32, every column written; partial: fp32 scratch of
// `grid` rows of d. The geometry (route, nv, threads, group, stages, smem,
// grid) is ops.py `plan_bwd`'s, the grid at most what
// rmsnorm_bwd_blocks_per_sm allows: one cooperative launch on `stream`
// (the dw sum syncs the grid). Returns the launch's cudaError_t (0 =
// launched).
int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                void* partial, void* dw, int n_rows, int d, float eps,
                int is_bf16, int route, int nv, int threads, int group,
                int stages, int smem, int grid, void* stream) {
  const BwdKernel k = bwd_kernel(is_bf16, route, nv);
  const bool ring = route == kRouteRing;
  if (!k || threads < 32 || threads > kMaxThreads || threads % 32 ||
      grid < 1 || n_rows < 1 ||
      (ring && (stages < 1 || group < 1 || (threads / 32) % group)))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{x, static_cast<const float*>(w), dy, dx,
            static_cast<float*>(partial), static_cast<float*>(dw), n_rows, d,
            group, stages, eps};
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k), dim3(grid), dim3(threads), args,
      static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
