// Rate probe of the tensor-core product the prefill kernel is built on
// (mma.sync m16n8k8 TF32, mma_tf32.cuh). It computes nothing the port
// uses: `chip_smoke.py` times it to state the card's TF32 rate through
// mma.sync beside the prefill kernel's bound, which is set by wgmma's.
//
// Each warp keeps kChains independent accumulators and issues `iters`
// rounds of one product on each; the sums are written only if they hit a
// value they never take, so the products cannot be dropped.

#include "mma_tf32.cuh"

namespace {

constexpr int kChains = 8;

__global__ void mma_probe_kernel(float* out, int iters) {
  float d[kChains][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b[2] = {threadIdx.x * 3u, threadIdx.x * 5u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) sfp::mma_tf32(d[j], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (s == 1234.5f) out[0] = s;
}

}  // namespace

// blocks x warps warps, each issuing iters x kChains products of
// 16 x 8 x 8 (2048 flops)
extern "C" int sfp_mma_probe(float* out, int blocks, int warps, int iters,
                             void* stream) {
  mma_probe_kernel<<<blocks, 32 * warps, 0, (cudaStream_t)stream>>>(out,
                                                                    iters);
  return (int)cudaGetLastError();
}
