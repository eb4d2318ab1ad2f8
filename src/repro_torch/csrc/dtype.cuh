// The floating dtypes the kernels read and write: f32, bf16 and f16, as
// the JAX kernels they replace take them (each reads its inputs with
// .astype(f32) and writes its output in the input's dtype). A kernel reads
// bf16 and f16 from device memory itself and widens them to f32 on load —
// exact: a bf16 is the top half of an f32, and every f16 value (11
// significant bits, exponents -24 to 15) is an f32 value — computes in
// f32, and rounds an output to bf16 or f16 once, to nearest even
// (__float2bfloat16_rn, __float2half_rn: the rounding of PyTorch's
// .to(torch.bfloat16) and .to(torch.float16)).
//
// Each entry point takes a dtype code per floating tensor (kF32, kBF16,
// kF16; the wrappers refuse every other dtype). A kernel either is
// templated on the element type (float, bf16 or f16; `with_dtype` picks
// the instantiation from the code) or branches on the code, which is
// uniform over the launch.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace sfp {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(f16 v) { return __half2float(v); }

// Write v to *p in p's type (bf16, f16: round to nearest even).
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(f16* p, float v) {
  *p = __float2half_rn(v);
}

// Element i of a tensor of dtype `code`, widened to f32.
__device__ __forceinline__ float load_f32(const void* p, int code,
                                          long long i) {
  if (code == kBF16) return __bfloat162float(static_cast<const bf16*>(p)[i]);
  if (code == kF16) return __half2float(static_cast<const f16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// Write v as element i of a tensor of dtype `code`.
__device__ __forceinline__ void store_f32(void* p, int code, long long i,
                                          float v) {
  if (code == kBF16)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else if (code == kF16)
    static_cast<f16*>(p)[i] = __float2half_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// Call f(As<T>{}) with T the element type of dtype `code` (float, bf16 or
// f16): the host side's one switch from a code to a kernel's template
// argument.
template <class T>
struct As {
  using type = T;
};
template <class F>
decltype(auto) with_dtype(int code, F&& f) {
  if (code == kBF16) return f(As<bf16>{});
  if (code == kF16) return f(As<f16>{});
  return f(As<float>{});
}

// The two bf16 of a 32-bit word, widened: the lower-addressed value is the
// low half (little-endian).
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The two f16 of a 32-bit word, widened (exact), low half first.
__device__ __forceinline__ float f16_lo(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
}
__device__ __forceinline__ float f16_hi(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

// Values of a type in one 16-byte load.
template <class T>
constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));

// One 16-byte load at p (16-byte aligned), widened: 4 f32 or 8 bf16 or
// f16.
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&f)[8]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  f[0] = bf16_lo(w.x);
  f[1] = bf16_hi(w.x);
  f[2] = bf16_lo(w.y);
  f[3] = bf16_hi(w.y);
  f[4] = bf16_lo(w.z);
  f[5] = bf16_hi(w.z);
  f[6] = bf16_lo(w.w);
  f[7] = bf16_hi(w.w);
}
__device__ __forceinline__ void load16(const f16* p, float (&f)[8]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  f[0] = f16_lo(w.x);
  f[1] = f16_hi(w.x);
  f[2] = f16_lo(w.y);
  f[3] = f16_hi(w.y);
  f[4] = f16_lo(w.z);
  f[5] = f16_hi(w.z);
  f[6] = f16_lo(w.w);
  f[7] = f16_hi(w.w);
}

// The four 16-bit values of a uint2 (lowest address first), widened.
__device__ __forceinline__ float4 widen4(uint2 w, bf16) {
  return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y),
                     bf16_hi(w.y));
}
__device__ __forceinline__ float4 widen4(uint2 w, f16) {
  return make_float4(f16_lo(w.x), f16_hi(w.x), f16_lo(w.y), f16_hi(w.y));
}

// Four consecutive values at p, widened: one 16-byte load of f32 or one
// 8-byte load of bf16 or f16 (p aligned to that).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  return widen4(__ldg(reinterpret_cast<const uint2*>(p)), bf16{});
}
__device__ __forceinline__ float4 load4(const f16* p) {
  return widen4(__ldg(reinterpret_cast<const uint2*>(p)), f16{});
}

}  // namespace sfp
