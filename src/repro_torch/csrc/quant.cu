// Int8 wire quantize / dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/quant/kernel.py::quantize_fwd and
// ::dequantize_fwd. Both are bound by device memory: per element they do a
// handful of flops against 4 bytes read (x; 2 at bf16 and f16) and 1
// written (the payload). On the serving path a launch holds 8 to 132 rows,
// so what costs is latency: dependent loads, a second pass over the row,
// and per-element index arithmetic. x may be f32, bf16 or f16 (widened on
// load, exactly, as the TPU kernel's astype(f32)); the dequantized output
// is f32, bf16 or f16 (one round to nearest even of the f32 product, as
// astype(dtype)), so both stay bit-equal to the plain version at every
// dtype.
//
// quantize: the row is read once, into registers (at most 32 values a
//   thread), in 16-byte loads where the row pointer and row stride allow
//   (4 f32 or 8 bf16/f16 a load; a row stride of 0, the backward's
//   broadcast gradient, qualifies), else one value a load. max|x| is
//   reduced across the row's threads, then the payload is computed from the
//   same registers and stored packed (4 or 8 int8 a store). The launch plan
//   comes from the host (kernels/quant/kernel.py::quantize_plan):
//     warp    (D <= 1024)  8 rows a 256-thread block, a warp a row, the
//                          max by shuffles alone;
//     block   (D <= 8192)  a block a row, the max by shuffles and one
//                          shared-memory step;
//     cluster (D <= 65536) C blocks a row launched as a thread-block
//                          cluster, each over a contiguous 1/C of it; the
//                          C partial maxima meet in distributed shared
//                          memory.
//   The noise u comes by value (the serving path's 0.5: no tensor, no fill
//   launch), as a (0, 0)-strided tensor (loaded once a thread), dense
//   (16-byte loads) or through any strides (one value a load).
//   Arithmetic is the plain version's, operation for operation, in IEEE
//   fp32 (no fast math): scale = max(amax * f32(1/127), 1e-8) — the
//   multiply by the rounded reciprocal that XLA compiles the JAX
//   reference's amax / 127 into — then q = floor(x / scale + u) with a true
//   division, clamp to [-127, 127], cast; so the payload is bit-equal.
// dequantize: a 2-D grid, rows from blockIdx.y, 16-value column tiles from
//   blockIdx.x. A thread reads its row's scale once and 16 int8 values in
//   one 16-byte load, and writes 16 outputs in 16-byte stores (four at
//   f32, two at bf16/f16), each store instruction over 512 contiguous
//   bytes of the warp's tile: the values reach the lane that stores them
//   by shuffles (a lane storing its own 16 values, 64 bytes from its
//   neighbour's, was slower at f32 than the one-value-a-thread loop it
//   replaced; PERF.md). The values before a row's first 16-byte boundary
//   and after its last (D % 16 != 0), and every value of an unaligned
//   base, go one at a time.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "dtype.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sfp;

constexpr int kRowValues = 32;    // values of a row one thread holds
constexpr int kMaxThreads = 256;  // a block, in every layout
constexpr int kMaxCluster = 8;    // the portable cluster size

constexpr int kWarp = 0, kBlock = 1, kCluster = 2;  // quantize layouts
// how u reaches the kernel: by value; a pointer read once (strides (0,
// 0)); through its strides; dense rows of 16-byte loads
constexpr int kUValue = 0, kUScalar = 1, kUStrided = 2, kUDense = 3;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The max of v over the block, in every thread.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float part[kMaxThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_max(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  return warp_max(lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// V values of x at p, widened: one 16-byte load (V = kPer16<T>), or one
// value (V = 1).
template <class T, int V>
__device__ __forceinline__ void load_x(const T* p, float (&f)[V]) {
  if constexpr (V == 1)
    f[0] = to_f32(p[0]);
  else
    load16(p, f);
}

// V dense f32 noise values at p (16-byte aligned): V / 4 16-byte loads.
template <int V>
__device__ __forceinline__ void load_u(const float* p, float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p + i));
    f[i] = w.x;
    f[i + 1] = w.y;
    f[i + 2] = w.z;
    f[i + 3] = w.w;
  }
}

__device__ __forceinline__ uint32_t byte_of(float q, int k) {
  return (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * k);
}

// V payload values (integral floats in [-127, 127]) at p as int8: one
// byte, or packed into one 4- or 8-byte store.
template <int V>
__device__ __forceinline__ void store_q(int8_t* p, const float (&q)[V]) {
  if constexpr (V == 1) {
    *p = static_cast<int8_t>(q[0]);
  } else {
    uint32_t w[V / 4];
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      w[i] = byte_of(q[4 * i], 0) | byte_of(q[4 * i + 1], 1) |
             byte_of(q[4 * i + 2], 2) | byte_of(q[4 * i + 3], 3);
    if constexpr (V == 4)
      *reinterpret_cast<uint32_t*>(p) = w[0];
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// The plain version's arithmetic: floor(x / scale + u), clamped.
__device__ __forceinline__ float quant1(float x, float scale, float u) {
  const float q = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  return fminf(fmaxf(q, -127.f), 127.f);
}

// One row per warp (kWarp), block (kBlock) or cluster (kCluster); groups
// of V values, V = kPer16<T> (16-byte loads) or 1. V divides d.
template <class T, int V, int L>
__global__ void __launch_bounds__(kMaxThreads)
quantize_kernel(const T* __restrict__ x, long long x_rs,
                const float* __restrict__ u, long long u_rs, long long u_cs,
                float u_value, int u_mode, int8_t* __restrict__ values,
                float* __restrict__ scales, int n, int d) {
  constexpr int G = kRowValues / V;  // groups a thread holds
  const int ng = d / V;              // groups in the row
  long long row;
  int t, P, g0 = 0, g1 = ng, rank = 0;
  if constexpr (L == kWarp) {
    row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= n) return;  // no barrier below: the warp alone
    t = threadIdx.x & 31;
    P = 32;
  } else if constexpr (L == kBlock) {
    row = blockIdx.x;
    t = threadIdx.x;
    P = blockDim.x;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    rank = (int)cluster.block_rank();
    row = blockIdx.x / C;
    const int per = (ng + C - 1) / C;  // a block's contiguous share
    g0 = min(ng, rank * per);
    g1 = min(ng, g0 + per);
    t = threadIdx.x;
    P = blockDim.x;
  }

  // the row's values (and noise) into registers, one pass
  const T* xr = x + row * x_rs;
  float xv[G][V], uv[G][V];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int g = g0 + t + k * P;
    if (g < g1) {
      load_x<T, V>(xr + g * V, xv[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(xv[k][j]));
    }
  }
  float us = u_value;
  if (u_mode == kUScalar) {
    us = __ldg(u);
  } else if (u_mode != kUValue) {
    const float* ur = u + row * u_rs;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int g = g0 + t + k * P;
      if (g < g1) {
        if constexpr (V > 1) {
          if (u_mode == kUDense) {
            load_u<V>(ur + g * V, uv[k]);
            continue;
          }
        }
#pragma unroll
        for (int j = 0; j < V; ++j)
          uv[k][j] = __ldg(ur + (long long)(g * V + j) * u_cs);
      }
    }
  }

  // max|x| over the row
  if constexpr (L == kWarp) {
    amax = warp_max(amax);
  } else {
    amax = block_max(amax);
  }
  if constexpr (L == kCluster) {
    __shared__ float cta_max;
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) cta_max = amax;
    cluster.sync();
    const int lane = threadIdx.x & 31;
    amax = warp_max(lane < (int)cluster.num_blocks()
                        ? *cluster.map_shared_rank(&cta_max, lane)
                        : 0.f);
    // done reading the other blocks' shared memory; the matching wait
    // keeps this block's alive until every block has read it
    asm volatile("barrier.cluster.arrive;" ::: "memory");
  }

  const float scale = fmaxf(__fmul_rn(amax, 1.f / 127.f), 1e-8f);
  int8_t* vr = values + row * d;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int g = g0 + t + k * P;
    if (g < g1) {
      float q[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        q[j] = quant1(xv[k][j], scale, u_mode >= kUStrided ? uv[k][j] : us);
      store_q<V>(vr + g * V, q);
    }
  }
  if (t == 0 && rank == 0) scales[row] = scale;
  if constexpr (L == kCluster) asm volatile("barrier.cluster.wait;" ::: "memory");
}

template <class T, int V>
cudaError_t launch_quantize(const T* x, long long x_rs, const float* u,
                            long long u_rs, long long u_cs, float u_value,
                            int u_mode, int8_t* values, float* scales, int n,
                            int d, int layout, int cluster, int threads,
                            cudaStream_t st) {
  if (layout == kWarp) {
    const int rows = threads / 32;
    quantize_kernel<T, V, kWarp><<<(n + rows - 1) / rows, threads, 0, st>>>(
        x, x_rs, u, u_rs, u_cs, u_value, u_mode, values, scales, n, d);
  } else if (layout == kBlock) {
    quantize_kernel<T, V, kBlock><<<n, threads, 0, st>>>(
        x, x_rs, u, u_rs, u_cs, u_value, u_mode, values, scales, n, d);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)n * (unsigned)cluster);
    cfg.blockDim = dim3(threads);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, quantize_kernel<T, V, kCluster>, x, x_rs, u, u_rs, u_cs,
        u_value, u_mode, values, scales, n, d);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

__device__ __forceinline__ float i8(uint32_t w, int k) {
  return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * k)) >> 24);
}

__device__ __forceinline__ uint32_t pack2(float a, float b, bf16) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
             << 16;
}
__device__ __forceinline__ uint32_t pack2(float a, float b, f16) {
  return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(a))) |
         static_cast<uint32_t>(__half_as_ushort(__float2half_rn(b))) << 16;
}

// Word k (0-3) of 16 bytes held by lane `src`, to every lane: four
// shuffles, then each lane keeps the word it asked for.
__device__ __forceinline__ uint32_t word_of(uint4 w, int src, int k) {
  const uint32_t a = __shfl_sync(0xffffffffu, w.x, src);
  const uint32_t b = __shfl_sync(0xffffffffu, w.y, src);
  const uint32_t c = __shfl_sync(0xffffffffu, w.z, src);
  const uint32_t e = __shfl_sync(0xffffffffu, w.w, src);
  return k == 0 ? a : k == 1 ? b : k == 2 ? c : e;
}

// A warp's 512 values of a row: lane j loaded values [16 j, 16 j + 16)
// of the tile in one 16-byte load (w); the warp writes them times s in
// 16-byte stores, each store instruction over 512 contiguous bytes:
// lane j writes 4 f32 (or 8 bf16/f16) values at 4 j (8 j) of each 128
// (256) of the tile, fetched from the lane that loaded them by shuffles.
// Only stores that end at or before `end` (tile-relative) are made.
template <class T>
__device__ __forceinline__ void store_tile(T* o, uint4 w, float s, int lane,
                                           int end) {
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t v = word_of(w, 8 * q + (lane >> 2), lane & 3);
      const int col = 128 * q + 4 * lane;
      if (col + 4 <= end)
        *reinterpret_cast<float4*>(o + col) = make_float4(
            __fmul_rn(i8(v, 0), s), __fmul_rn(i8(v, 1), s),
            __fmul_rn(i8(v, 2), s), __fmul_rn(i8(v, 3), s));
    }
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int src = 16 * q + (lane >> 1), k = 2 * (lane & 1);
      const uint32_t v0 = word_of(w, src, k), v1 = word_of(w, src, k + 1);
      const int col = 256 * q + 8 * lane;
      if (col + 8 <= end)
        *reinterpret_cast<uint4*>(o + col) = make_uint4(
            pack2(__fmul_rn(i8(v0, 0), s), __fmul_rn(i8(v0, 1), s), T{}),
            pack2(__fmul_rn(i8(v0, 2), s), __fmul_rn(i8(v0, 3), s), T{}),
            pack2(__fmul_rn(i8(v1, 0), s), __fmul_rn(i8(v1, 1), s), T{}),
            pack2(__fmul_rn(i8(v1, 2), s), __fmul_rn(i8(v1, 3), s), T{}));
    }
  }
}

// Rows from blockIdx.y (blockDim.y a block), 16-value tiles of a row from
// the x index; blockDim.x is a multiple of 32, so a warp holds 32
// consecutive tiles (512 values) of one row. kVec: values and out 16-byte
// aligned; a row's values before its first 16-byte boundary and after its
// last go one at a time. Otherwise every value goes one at a time, each
// warp over its 512 values in 16 coalesced passes.
template <class T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
dequantize_kernel(const int8_t* __restrict__ values,
                  const float* __restrict__ scales, T* __restrict__ out,
                  int n, int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // a 16-value tile
  const int lane = threadIdx.x & 31;
  for (long long row = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       row < n; row += (long long)gridDim.y * blockDim.y) {
    const int8_t* vr = values + row * d;
    T* orow = out + row * d;
    const float s = __ldg(scales + row);
    if constexpr (kVec) {
      const int head = min(
          d, (int)((16 - (reinterpret_cast<uintptr_t>(vr) & 15)) & 15));
      const int end = head + ((d - head) & ~15);  // the 16-byte-aligned run
      const int c0 = head + 16 * i, tile = c0 - 16 * lane;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (c0 + 16 <= end) w = __ldg(reinterpret_cast<const uint4*>(vr + c0));
      store_tile(orow + tile, w, s, lane, end - tile);
      if (i < head) put(orow + i, __fmul_rn(static_cast<float>(vr[i]), s));
      if (end + i < d)
        put(orow + end + i, __fmul_rn(static_cast<float>(vr[end + i]), s));
    } else {
      const int tile = 16 * (i - lane);
#pragma unroll 4
      for (int c = tile + lane; c < min(d, tile + 512); c += 32)
        put(orow + c, __fmul_rn(static_cast<float>(vr[c]), s));
    }
  }
}

}  // namespace

// x of dtype x_dtype (kF32, kBF16 or kF16), row stride x_rs, unit column
// stride; u f32 through strides (u_rs, u_cs), or null for u_value; the
// plan (layout kWarp / kBlock / kCluster, blocks a row, threads a block)
// from quantize_plan. Returns cudaErrorInvalidValue for a plan that
// cannot hold a row of d values.
extern "C" int sfp_quantize_int8(const void* x, int x_dtype, long long x_rs,
                                 const float* u, long long u_rs,
                                 long long u_cs, float u_value,
                                 int8_t* values, float* scales, int n, int d,
                                 int layout, int cluster, int threads,
                                 void* stream) {
  const long long cap =
      (long long)kRowValues *
      (layout == kWarp ? 32 : threads * (layout == kCluster ? cluster : 1));
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      layout < kWarp || layout > kCluster || d < 0 || d > cap ||
      (layout == kCluster && (cluster < 2 || cluster > kMaxCluster)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  with_dtype(x_dtype, [&](auto as) {
    using T = typename decltype(as)::type;
    constexpr int V = kPer16<T>;
    const bool vec = d % V == 0 && aligned16(x) &&
                     (x_rs * (long long)sizeof(T)) % 16 == 0;
    const int u_mode =
        u == nullptr                 ? kUValue
        : (u_rs == 0 && u_cs == 0)   ? kUScalar
        : (vec && u_cs == 1 && aligned16(u) && (u_rs * 4) % 16 == 0)
            ? kUDense
            : kUStrided;
    const T* xt = static_cast<const T*>(x);
    err = vec ? launch_quantize<T, V>(xt, x_rs, u, u_rs, u_cs, u_value,
                                      u_mode, values, scales, n, d, layout,
                                      cluster, threads, st)
              : launch_quantize<T, 1>(xt, x_rs, u, u_rs, u_cs, u_value,
                                      u_mode, values, scales, n, d, layout,
                                      cluster, threads, st);
  });
  return (int)err;
}

// values (n, d) int8 contiguous, scales (n,) f32; out of dtype out_dtype
// (kF32, kBF16 or kF16), contiguous.
extern "C" int sfp_dequantize_int8(const int8_t* values, const float* scales,
                                   void* out, int out_dtype, int n, int d,
                                   void* stream) {
  if (n > 0 && d > 0) {
    // 16-value tiles of a row over tx threads (a multiple of 32), 256 / tx
    // rows a block where a row needs fewer than 256 threads
    const int tiles = (d + 15) / 16;
    const int bx = (tiles + kMaxThreads - 1) / kMaxThreads;
    const int tx = ((tiles + bx - 1) / bx + 31) / 32 * 32;
    const int ty = kMaxThreads / tx > 0 ? kMaxThreads / tx : 1;
    const long long by = ((long long)n + ty - 1) / ty;
    const dim3 grid(bx, (unsigned)(by < 65535 ? by : 65535)), block(tx, ty);
    const cudaStream_t st = (cudaStream_t)stream;
    with_dtype(out_dtype, [&](auto as) {
      using T = typename decltype(as)::type;
      T* o = static_cast<T*>(out);
      if (aligned16(values) && aligned16(out))
        dequantize_kernel<T, true><<<grid, block, 0, st>>>(values, scales, o,
                                                           n, d);
      else
        dequantize_kernel<T, false><<<grid, block, 0, st>>>(values, scales,
                                                            o, n, d);
    });
  }
  return (int)cudaGetLastError();
}
