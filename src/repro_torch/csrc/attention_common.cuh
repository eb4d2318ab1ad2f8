// Shared pieces of the attention kernels: the tile and block sizes, the
// mask value, the warp sum and the softcap. The two decode kernels'
// common parts are in decode_common.cuh.
//
// A block streams keys and values through shared memory in tiles of kBK,
// folding each into the online-softmax state (m, l, acc) of its query rows
// held in registers. That state lives across the block's loop over kv
// tiles — the loop that stands in for the TPU kernels' sequential kv grid
// axis.
//
// Masked scores take the finite value kMask = -2^30, exactly as the plain
// versions do, so a fully masked row averages every key it visited and
// comes out finite. Keys outside the tile range are ABSENT: they take no
// part in the max and add nothing (p = 0).
#pragma once

#include <cuda_runtime.h>

namespace sfp {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 32;                 // keys per tile: one per lane
constexpr int kDMax = 256;              // largest head_dim the kernels take
constexpr float kMask = -1073741824.f;  // -2^30

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float cap(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

}  // namespace sfp
