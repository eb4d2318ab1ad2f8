// Fused EL2N score + cross-entropy per row, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/el2n/kernel.py::el2n_fwd. For each
// row of logits l (length V) and its label y it computes, in ONE streaming
// pass over the row and without materializing probabilities:
//
//   m  = max l,   Z = sum exp(l - m),   S2 = sum exp(2 (l - m))
//   z  = max(Z, 1e-30)
//   EL2N = sqrt(max(S2 / z^2 - 2 exp(l_y - m) / z + 1, 0))   = ||p - onehot||
//   CE   = m + log z - l_y
//
// finalized exactly as the TPU kernel does (kernel.py:68-77). What differs
// from it is the structure, not the function: the TPU grid walks vocab
// tiles in order and carries (m, Z, S2, l_y) in VMEM scratch; here one
// block owns one row, its threads stride over the row with 16-byte loads
// and keep a private (m, Z, S2), and the triples are merged by warp
// shuffles and then through shared memory with the rescale
//   Z = Za e^(ma - m) + Zb e^(mb - m),  S2 = S2a e^(2(ma - m)) + S2b e^(2(mb - m)).
// l_y is read directly at the label's column instead of max-reducing a hit
// mask over every tile. The logits are read through a row stride (an LM
// logits view needs no copy) and V needs no padding: a row whose pointer is
// not 16-byte aligned takes scalar loads up to the first 16-byte boundary,
// then 16-byte loads (4 f32 or 8 bf16 or f16), then a scalar tail. bf16
// and f16 logits are widened on load, exactly, as the TPU kernel's
// astype(f32): no separate widening pass; the outputs are f32 at every
// dtype.
//
// Bound: one read of N*V*4 bytes (N*V*2 at bf16 and f16) and a few flops per
// element, so at LM vocabularies it is bound by device memory; at the ViT
// classifier's (16, 100) it is bound by the launch. With few rows it
// under-fills the 132 SMs (one block a row); splitting V across blocks is
// later work.
//
// IEEE expf/logf (no fast math). A label outside [0, V) gives NaN in both
// outputs rather than reading outside the row.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using namespace sfp;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Stats {
  float m, z, s2;
};

// Fold b into a. An empty side has m = -inf and z = s2 = 0.
__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;
  const float ea = expf(a.m - m), eb = expf(b.m - m);
  return {m, a.z * ea + b.z * eb, a.s2 * (ea * ea) + b.s2 * (eb * eb)};
}

// Fold one group of values whose max is gm into the running stats.
__device__ __forceinline__ void rescale_to(Stats& s, float gm) {
  if (gm > s.m) {
    const float a = expf(s.m - gm);   // 0 while s is empty (s.m = -inf)
    s.z *= a;
    s.s2 *= a * a;
    s.m = gm;
  }
}

__device__ __forceinline__ void add(Stats& s, float x) {
  const float e = expf(x - s.m);
  s.z += e;
  s.s2 += e * e;
}

__device__ __forceinline__ Stats warp_merge(Stats s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o{__shfl_xor_sync(0xffffffffu, s.m, off),
            __shfl_xor_sync(0xffffffffu, s.z, off),
            __shfl_xor_sync(0xffffffffu, s.s2, off)};
    s = merge(s, o);
  }
  return s;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
el2n_kernel(const T* __restrict__ logits, long long row_stride,
            const int* __restrict__ labels, int v, float* __restrict__ el2n,
            float* __restrict__ ce) {
  __shared__ Stats warp_stats[kWarps];
  constexpr int kVec = kPer16<T>;  // values a 16-byte load
  const long long row = blockIdx.x;
  const T* p = logits + row * row_stride;
  Stats s{-INFINITY, 0.f, 0.f};

  // scalar head up to the first 16-byte boundary, 16-byte body, scalar tail
  int head = (int)(((16u - ((uintptr_t)p & 15u)) & 15u) / sizeof(T));
  if (head > v) head = v;
  const int nv = (v - head) / kVec;
  const int tail = head + kVec * nv;
  for (int j = threadIdx.x; j < head; j += kThreads) {
    const float x = to_f32(p[j]);
    rescale_to(s, x);
    add(s, x);
  }
#pragma unroll 4
  for (int j = threadIdx.x; j < nv; j += kThreads) {
    float x[kVec];
    load16(p + head + kVec * j, x);
    float gm = x[0];
#pragma unroll
    for (int e = 1; e < kVec; ++e) gm = fmaxf(gm, x[e]);
    rescale_to(s, gm);
#pragma unroll
    for (int e = 0; e < kVec; ++e) add(s, x[e]);
  }
  for (int j = tail + threadIdx.x; j < v; j += kThreads) {
    const float x = to_f32(p[j]);
    rescale_to(s, x);
    add(s, x);
  }

  s = warp_merge(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_stats[warp] = s;
  __syncthreads();
  if (warp != 0) return;
  s = lane < kWarps ? warp_stats[lane] : Stats{-INFINITY, 0.f, 0.f};
  s = warp_merge(s);
  if (lane != 0) return;

  const int y = labels[row];
  if (y < 0 || y >= v) {
    el2n[row] = NAN;
    ce[row] = NAN;
    return;
  }
  const float ly = to_f32(p[y]);
  const float z = fmaxf(s.z, 1e-30f);
  const float py = expf(ly - s.m) / z;
  const float sq = fmaxf(s.s2 / (z * z) - 2.f * py + 1.f, 0.f);
  el2n[row] = sqrtf(sq);
  ce[row] = s.m + logf(z) - ly;
}

}  // namespace

// logits of dtype logits_dtype (kF32, kBF16 or kF16); el2n, ce f32.
extern "C" int sfp_el2n_fwd(const void* logits, int logits_dtype,
                            long long row_stride, const int* labels,
                            float* el2n, float* ce, int n, int v,
                            void* stream) {
  if (n > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    with_dtype(logits_dtype, [&](auto as) {
      using T = typename decltype(as)::type;
      el2n_kernel<<<n, kThreads, 0, st>>>(static_cast<const T*>(logits),
                                          row_stride, labels, v, el2n, ce);
    });
  }
  return (int)cudaGetLastError();
}
