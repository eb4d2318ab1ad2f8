// Helpers the two recurrent-scan kernels share (mamba2_scan.cu,
// rwkv6_scan.cu): staging inputs into shared memory as f32, the 3xTF32
// fragments and product of mma_tf32.cuh over f32 tiles in shared memory,
// and the step kernels' four-column loads of the state and of inputs.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "dtype.cuh"
#include "mma_tf32.cuh"

namespace sfp {

// Stage one value into shared memory as f32: an asynchronous 4-byte copy
// for f32 (zero-filled where !in; `base` is any valid address), a widening
// load for bf16 and f16.
__device__ __forceinline__ void stage(float* dst, const float* src, bool in,
                                      const float* base) {
  cp_async4(dst, in ? src : base, in ? 4 : 0);
}
template <class T16>
__device__ __forceinline__ void stage(float* dst, const T16* src, bool in,
                                      const T16*) {
  *dst = in ? to_f32(*src) : 0.f;
}

// The same for element i of a tensor: of the element type T (kTyped), or
// of dtype `code` (uniform over the launch).
template <bool kTyped, class T>
__device__ __forceinline__ void stage_elem(float* dst, const void* base,
                                         int code, long long i, bool in) {
  if constexpr (kTyped) {
    const T* t = static_cast<const T*>(base);
    stage(dst, t + i, in, t);
  } else if (code == kF32) {
    const float* f = static_cast<const float*>(base);
    stage(dst, f + i, in, f);
  } else {
    *dst = in ? load_f32(base, code, i) : 0.f;
  }
}

// a (16 x 8 row-major at p, row stride ld) -> TF32 halves
__device__ __forceinline__ void frag_a(const float* p, int ld,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * ld], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * ld + 4], big[3], small[3]);
}

// b0 at p, b1 at p + off -> TF32 halves
__device__ __forceinline__ void frag_b(const float* p, int off,
                                       uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[off], big[1], small[1]);
}

// acc += a . b in 3xTF32 (small terms first) on a fresh accumulator: the
// three products of one k-step depend only on each other, so successive
// k-steps overlap, and the sum over k-steps is f32 adds rounded to
// nearest rather than the tensor core's accumulation
__device__ __forceinline__ void mma3(float (&acc)[4],
                                     const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// Four consecutive state values at q (n of them live; vec: one aligned
// vector load), widened. Plain loads: the state may be the output itself.
__device__ __forceinline__ float4 state4(const float* q, int n, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(q);
  return make_float4(n > 0 ? q[0] : 0.f, n > 1 ? q[1] : 0.f,
                     n > 2 ? q[2] : 0.f, n > 3 ? q[3] : 0.f);
}
template <class T16>
__device__ __forceinline__ float4 state4(const T16* q, int n, bool vec) {
  if (vec) return widen4(*reinterpret_cast<const uint2*>(q), T16{});
  return make_float4(n > 0 ? to_f32(q[0]) : 0.f, n > 1 ? to_f32(q[1]) : 0.f,
                     n > 2 ? to_f32(q[2]) : 0.f, n > 3 ? to_f32(q[3]) : 0.f);
}

// The same at element i of the state: f32 (kTyped), or of dtype `code`
// (uniform over the launch).
template <bool kTyped>
__device__ __forceinline__ float4 state4_of(const void* h0, int code,
                                            long long i, int n, bool vec) {
  if (!kTyped && code == kBF16)
    return state4(static_cast<const bf16*>(h0) + i, n, vec);
  if (!kTyped && code == kF16)
    return state4(static_cast<const f16*>(h0) + i, n, vec);
  return state4(static_cast<const float*>(h0) + i, n, vec);
}

// Four consecutive values at q (n of them live), widened; then at element
// i of a tensor: of the element type T (kTyped), or of dtype `code`
// (uniform over the launch).
template <class T>
__device__ __forceinline__ float4 four(const T* q, int n) {
  return make_float4(n > 0 ? to_f32(q[0]) : 0.f, n > 1 ? to_f32(q[1]) : 0.f,
                     n > 2 ? to_f32(q[2]) : 0.f, n > 3 ? to_f32(q[3]) : 0.f);
}
template <bool kTyped, class T>
__device__ __forceinline__ float4 four_of(const void* base, int code,
                                          long long i, int n) {
  if (kTyped) return four(static_cast<const T*>(base) + i, n);
  if (code == kBF16) return four(static_cast<const bf16*>(base) + i, n);
  if (code == kF16) return four(static_cast<const f16*>(base) + i, n);
  return four(static_cast<const float*>(base) + i, n);
}

}  // namespace sfp
