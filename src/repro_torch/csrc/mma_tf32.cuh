// Tensor-core and asynchronous-copy helpers for Hopper (sm_90a) kernels
// that must keep fp32 accuracy.
//
// 3xTF32: an fp32 operand x is split into big = rna_tf32(x) and
// small = rna_tf32(x - big); x - big is exact in fp32, so big + small
// carries 22 of x's 24 significand bits. A product a.b is then summed as
// small_a.big_b + big_a.small_b + big_a.big_b on `mma.sync` m16n8k8 TF32,
// small terms first; small_a.small_b (below 2^-22 relative) is dropped.
// An operand is rounded before it reaches the mma: the hardware truncates
// the 13 low bits it ignores, and a truncated `big` would not be the value
// whose exact remainder `small` is. A product's latency is several times
// its issue interval, so callers keep several independent accumulators.
//
// Fragments of mma.m16n8k8.row.col (g = lane >> 2, t = lane & 3):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace sfp {

// x -> (big, small), TF32 halves with big + small ~= x to 2^-22. Both are
// rounded to nearest, ties away from zero: the values cvt.rna.tf32.f32
// gives, in the 19 bits the mma reads. sm_90 has no instruction for that
// cvt (ptxas wraps an add of 0x1000 in an infinity test and a select), so
// the add is done here on the integer pipe; `small` keeps 13 low bits that
// the mma ignores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d += a . b on one m16n8k8 TF32 tensor-core product.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous global -> shared copies. `src_bytes` of the source are read
// and the rest of the destination is zero-filled (0 fills it all; `src`
// must still be a valid address). The 16-byte form needs both addresses
// 16-byte aligned; the 4-byte form only 4-byte alignment.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `N` of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace sfp
