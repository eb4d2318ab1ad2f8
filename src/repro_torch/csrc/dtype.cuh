// The floating dtypes the kernels read and write: f32 and bf16, as the
// JAX kernels they replace take them (each reads its inputs with
// .astype(f32) and writes its output in the input's dtype). A kernel reads
// bf16 from device memory itself and widens it to f32 on load — exact:
// the 16 bits are the top half of the f32 — computes in f32, and rounds
// an output to bf16 once, to nearest even (__float2bfloat16_rn, the
// rounding of PyTorch's .to(torch.bfloat16)).
//
// Each entry point takes a dtype code per floating tensor (kF32, kBF16;
// the wrappers refuse every other dtype). A kernel either is templated on
// the element type (float or bf16) or branches on the code, which is
// uniform over the launch.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace sfp {

using bf16 = __nv_bfloat16;

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Write v to *p in p's type (bf16: round to nearest even).
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Element i of a tensor of dtype `code`, widened to f32.
__device__ __forceinline__ float load_f32(const void* p, int code,
                                          long long i) {
  return code == kBF16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                       : static_cast<const float*>(p)[i];
}

// Write v as element i of a tensor of dtype `code`.
__device__ __forceinline__ void store_f32(void* p, int code, long long i,
                                          float v) {
  if (code == kBF16)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// The two bf16 of a 32-bit word, widened: the lower-addressed value is the
// low half (little-endian).
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Values of a type in one 16-byte load.
template <class T>
constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));

// One 16-byte load at p (16-byte aligned), widened: 4 f32 or 8 bf16.
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

// Four consecutive values at p, widened: one 16-byte load of f32 or one
// 8-byte load of bf16 (p aligned to that).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y),
                     bf16_hi(w.y));
}

}  // namespace sfp
