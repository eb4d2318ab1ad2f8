// Int8 wire quantize / dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/quant/kernel.py::quantize_fwd and
// ::dequantize_fwd. Both are bound by device memory: per element they do a
// handful of flops against 4 bytes read (x; 2 at bf16 and f16) and 1
// written (the payload), so the design goal is one coalesced pass each way
// and nothing else. x may be f32, bf16 or f16 (widened on load, exactly, as
// the TPU kernel's astype(f32)); the dequantized output is f32, bf16 or f16
// (one round to nearest even of the f32 product, as astype(dtype)), so both
// stay bit-equal to the plain version at every dtype.
//
// quantize: one block per row (a token of the smashed tensor). The block
//   reduces max|x| across its threads, then rewrites the row; the second
//   read of the row hits L1/L2 (a 5120-wide fp32 row is 20 KB). The noise u
//   comes in with row and column strides, so the serving path's broadcast
//   scalar 0.5 (both strides 0) is never materialized as an (N, D) tensor.
//   Arithmetic is the plain version's, operation for operation, in IEEE
//   fp32 (no fast math): scale = max(amax * f32(1/127), 1e-8) — the multiply
//   by the rounded reciprocal that XLA compiles the JAX reference's
//   amax / 127 into — then q = floor(x / scale + u) with a true division,
//   clamp to [-127, 127], cast; so the payload is bit-equal.
// dequantize: elementwise v * scale over a flat grid-stride loop.

#include <cstdint>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using namespace sfp;

constexpr int kQuantThreads = 256;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <class T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const T* __restrict__ x, long long x_rs,
                const float* __restrict__ u, long long u_rs, long long u_cs,
                int8_t* __restrict__ values, float* __restrict__ scales,
                int d) {
  __shared__ float warp_amax[kQuantThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * x_rs;
  const float* ur = u + row * u_rs;

  float amax = 0.f;
  for (int j = threadIdx.x; j < d; j += kQuantThreads)
    amax = fmaxf(amax, fabsf(to_f32(xr[j])));
  amax = warp_max(amax);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_amax[warp] = amax;
  __syncthreads();
  amax = lane < kQuantThreads / 32 ? warp_amax[lane] : 0.f;
  amax = warp_max(amax);

  const float scale = fmaxf(amax * (1.f / 127.f), 1e-8f);
  int8_t* vr = values + row * d;
  for (int j = threadIdx.x; j < d; j += kQuantThreads) {
    float q = floorf(to_f32(xr[j]) / scale + ur[j * u_cs]);
    q = fminf(fmaxf(q, -127.f), 127.f);
    vr[j] = static_cast<int8_t>(q);
  }
  if (threadIdx.x == 0) scales[row] = scale;
}

template <class T>
__global__ void dequantize_kernel(const int8_t* __restrict__ values,
                                  const float* __restrict__ scales,
                                  T* __restrict__ out, long long total,
                                  int d) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x)
    put(out + i, static_cast<float>(values[i]) * scales[i / d]);
}

}  // namespace

// x of dtype x_dtype (kF32, kBF16 or kF16); u, scales f32.
extern "C" int sfp_quantize_int8(const void* x, int x_dtype, long long x_rs,
                                 const float* u, long long u_rs,
                                 long long u_cs, int8_t* values,
                                 float* scales, int n, int d, void* stream) {
  if (n > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    with_dtype(x_dtype, [&](auto as) {
      using T = typename decltype(as)::type;
      quantize_kernel<<<n, kQuantThreads, 0, st>>>(
          static_cast<const T*>(x), x_rs, u, u_rs, u_cs, values, scales, d);
    });
  }
  return (int)cudaGetLastError();
}

// out of dtype out_dtype (kF32, kBF16 or kF16).
extern "C" int sfp_dequantize_int8(const int8_t* values, const float* scales,
                                   void* out, int out_dtype, int n, int d,
                                   void* stream) {
  const long long total = (long long)n * d;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    const cudaStream_t st = (cudaStream_t)stream;
    with_dtype(out_dtype, [&](auto as) {
      using T = typename decltype(as)::type;
      dequantize_kernel<<<(int)blocks, threads, 0, st>>>(
          values, scales, static_cast<T*>(out), total, d);
    });
  }
  return (int)cudaGetLastError();
}
