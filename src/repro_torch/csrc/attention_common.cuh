// Shared pieces of the two attention kernels (prefill and decode).
//
// A block is four warps. Each warp owns a few query rows; the block stages
// one tile of kBK keys and values in shared memory, every lane scores one
// key of the tile against each of its warp's rows, and the rows fold the
// tile into their online-softmax state (m, l, acc) held in registers. That
// state lives across the block's loop over kv tiles — the loop that stands
// in for the TPU kernels' sequential kv grid axis.
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
constexpr int kDMax = 128;              // largest head_dim the kernels take
constexpr int kDPerLane = kDMax / 32;   // output columns owned by a lane
constexpr float kMask = -1073741824.f;  // -2^30

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int RW>
struct RowState {
  float m[RW];
  float l[RW];
  float acc[RW][kDPerLane];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      m[i] = kMask;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) acc[i][c] = 0.f;
    }
  }

  // Fold one tile into the rows. s[i] is this lane's (already masked)
  // score for key `lane` of the tile and row i; `present` is false for a
  // lane past the tile's n_keys keys. vs is the tile's values, row-major
  // with row stride kDMax.
  __device__ __forceinline__ void update(const float (&s)[RW], bool present,
                                         const float* vs, int n_keys, int dv,
                                         int lane) {
    float p[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float m_new = fmaxf(m[i], warp_max(present ? s[i] : -INFINITY));
      const float alpha = expf(m[i] - m_new);
      p[i] = present ? expf(s[i] - m_new) : 0.f;
      l[i] = alpha * l[i] + warp_sum(p[i]);
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    for (int j = 0; j < n_keys; ++j) {
      float pj[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) pj[i] = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) {
        const int d = lane + 32 * c;
        if (d < dv) {
          const float vv = vs[j * kDMax + d];
#pragma unroll
          for (int i = 0; i < RW; ++i) acc[i][c] += pj[i] * vv;
        }
      }
    }
  }

  __device__ __forceinline__ float out(int i, int c) const {
    return acc[i][c] / fmaxf(l[i], 1e-30f);
  }
};

// Score of this lane's key against RW query rows held in shared memory
// (row stride kDMax); ks has row stride kDMax + 1 so the 32 lanes, each on
// its own key row, read 32 distinct banks.
template <int RW>
__device__ __forceinline__ void tile_dots(float (&dot)[RW], const float* qs,
                                          const float* ks, int dh, int lane) {
#pragma unroll
  for (int i = 0; i < RW; ++i) dot[i] = 0.f;
  const float* kr = ks + lane * (kDMax + 1);
  for (int d = 0; d < dh; ++d) {
    const float kd = kr[d];
#pragma unroll
    for (int i = 0; i < RW; ++i) dot[i] = fmaf(qs[i * kDMax + d], kd, dot[i]);
  }
}

__device__ __forceinline__ float cap(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

}  // namespace sfp
