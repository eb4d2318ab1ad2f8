// Fused fixed-point encode + pairwise-mask fold, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/secure_mask/kernel.py::
// masked_encode_fwd. One client's secure upload, in the uint32 ring:
//
//   out[i] = encode(x[i]) + sum_j sign_j * PRG(seed_j)[i]     (mod 2^32)
//   encode(v) = two's complement of clamp(rint(v * scale), -SAT, SAT)
//
// with the mask bits generated in registers and never written to memory.
// A null x encodes zero: that is the server's dropout-recovery stream
// (ops.summed_mask), with no zero tensor allocated for it.
//
// The PRG is the JAX reference's, not a new one: element i of
// jax.random.bits(PRNGKey(seed), (n,), uint32) is a ^ b with
// (a, b) = threefry2x32-20(key (0, seed), counter (i >> 32, i & 0xffffffff)).
// So the uploads equal the JAX reference's bit for bit, and the stream of
// an element depends on its index alone, not on the launch geometry (the
// TPU kernel seeds its on-core PRNG by (seed, block) instead, a stream that
// exists only on a TPU).
//
// Bound: 8 bytes of traffic per element against one threefry per element
// and pair (20 rounds of add, rotate, xor plus 5 key injections: about 75
// instructions in the compiled loop, which chip_smoke.py counts in the
// SASS), so it is bound by instruction issue and the INT32 ALU pipe, not by
// device memory; the compiler moves the adds onto IMAD, which runs on the
// FMA pipe beside the ALU's rotates and xors. The design keeps that
// work dense: each thread owns four consecutive elements (one 16-byte load
// of x and one 16-byte store), the pair loop is innermost with a pair of
// sign 0 skipped, rotations are single funnel shifts, and the accumulator
// is uint32_t, whose wraparound is the ring's. Later work: split a
// client's pairs across blocks, fuse the K uploads of a round into one
// launch.
//
// x may be f32, bf16 or f16 (the TPU kernel's astype(f32)): a thread's
// four values are one 16-byte load of f32 or one 8-byte load of bf16 or
// f16, widened exactly, so a 16-bit upload encodes the same words as its
// f32 widening.
//
// rintf rounds half to even, as jnp.round; no fast math.

#include <cstdint>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using namespace sfp;

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define SFP_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r) ^ x0;
#define SFP_ROUNDS_A SFP_ROUND(13) SFP_ROUND(15) SFP_ROUND(26) SFP_ROUND(6)
#define SFP_ROUNDS_B SFP_ROUND(17) SFP_ROUND(29) SFP_ROUND(16) SFP_ROUND(24)

// a ^ b of threefry2x32-20 under key (0, k1) at counter (hi, lo).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t hi,
                                                  uint32_t lo) {
  const uint32_t k0 = 0u, k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = hi + k0, x1 = lo + k1;
  SFP_ROUNDS_A
  x0 += k1; x1 += k2 + 1u;
  SFP_ROUNDS_B
  x0 += k2; x1 += k0 + 2u;
  SFP_ROUNDS_A
  x0 += k0; x1 += k1 + 3u;
  SFP_ROUNDS_B
  x0 += k1; x1 += k2 + 4u;
  SFP_ROUNDS_A
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef SFP_ROUNDS_B
#undef SFP_ROUNDS_A
#undef SFP_ROUND

__device__ __forceinline__ uint32_t encode(float v, float scale) {
  const float sat = 2147483520.f;   // 2^31 - 128, exact in f32
  const float q = fminf(fmaxf(rintf(v * scale), -sat), sat);
  return (uint32_t)(int32_t)q;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
masked_encode_kernel(const T* __restrict__ x,
                     const uint32_t* __restrict__ seeds,
                     const int* __restrict__ signs, int n_pairs, float scale,
                     uint4* __restrict__ out, long long n4) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n4;
       t += stride) {
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    if (x != nullptr) {
      const float4 v = load4(x + 4 * t);
      acc = make_uint4(encode(v.x, scale), encode(v.y, scale),
                       encode(v.z, scale), encode(v.w, scale));
    }
    const unsigned long long i0 = 4ull * (unsigned long long)t;
    const uint32_t hi = (uint32_t)(i0 >> 32), lo = (uint32_t)i0;
    // lo is a multiple of 4, so lo + 3 never carries into hi. One pair per
    // iteration (no unroll): four threefry chains already give the SM
    // independent work, and the SASS of one iteration is what
    // chip_smoke.py counts.
#pragma unroll 1
    for (int j = 0; j < n_pairs; ++j) {
      const int sign = __ldg(signs + j);
      if (sign == 0) continue;
      const uint32_t k1 = __ldg(seeds + j);
      const uint32_t m0 = threefry_bits(k1, hi, lo);
      const uint32_t m1 = threefry_bits(k1, hi, lo + 1u);
      const uint32_t m2 = threefry_bits(k1, hi, lo + 2u);
      const uint32_t m3 = threefry_bits(k1, hi, lo + 3u);
      if (sign > 0) {
        acc.x += m0; acc.y += m1; acc.z += m2; acc.w += m3;
      } else {
        acc.x -= m0; acc.y -= m1; acc.z -= m2; acc.w -= m3;
      }
    }
    out[t] = acc;
  }
}

}  // namespace

// x: (n,) of dtype x_dtype (kF32, kBF16 or kF16), or null (encode zero); seeds
// (n_pairs,) uint32; signs (n_pairs,) int32 in {-1, 0, 1}; out (n,)
// uint32. n % 4 == 0, out 16-byte aligned and x aligned to four of its
// values (the wrapper checks both).
extern "C" int sfp_masked_encode(const void* x, int x_dtype,
                                 const uint32_t* seeds, const int* signs,
                                 int n_pairs, float scale, uint32_t* out,
                                 long long n, void* stream) {
  const long long n4 = n / 4;
  if (n4 > 0) {
    long long blocks = (n4 + kThreads - 1) / kThreads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
    const cudaStream_t st = (cudaStream_t)stream;
    uint4* o = reinterpret_cast<uint4*>(out);
    with_dtype(x_dtype, [&](auto as) {
      using T = typename decltype(as)::type;
      masked_encode_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
          static_cast<const T*>(x), seeds, signs, n_pairs, scale, o, n4);
    });
  }
  return (int)cudaGetLastError();
}
