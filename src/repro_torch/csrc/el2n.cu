// Fused EL2N score + cross-entropy per row, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/el2n/kernel.py::el2n_fwd. For each
// row of logits l (length V) and its label y it computes, in ONE pass over
// the row and without materializing probabilities:
//
//   m  = max l,   Z = sum exp(l - m),   S2 = sum exp(2 (l - m))
//   z  = max(Z, 1e-30)
//   EL2N = sqrt(max(S2 / z^2 - 2 exp(l_y - m) / z + 1, 0))   = ||p - onehot||
//   CE   = m + log z - l_y
//
// finalized exactly as the TPU kernel does (kernel.py:68-77). The TPU grid
// walks vocab tiles in order and carries (m, Z, S2, l_y) in VMEM scratch;
// here the row is cut by the host's plan (kernels/el2n/kernel.py::
// el2n_plan) into one of two layouts, each one launch:
//
//   warp    (V <= 1024)  a warp a row, 4 rows a 128-thread block. Every
//                        lane issues its loads of the row (at most 32
//                        values, 16-byte loads where every row is 16-byte
//                        aligned) and the broadcast load of labels[row]
//                        together: one trip to device memory. Then, in
//                        registers, a warp max by fmaxf shuffles (l_y rides
//                        along: the lane holding column y selects it, the
//                        others hold -inf, as the TPU kernel max-reduces
//                        its hit mask), one expf a value, and warp sums of
//                        Z and S2. No shared memory, no barrier, no expf in
//                        the merge.
//   block   a block a row (256 threads from 132 rows on, 512 below, where
//                        each block is alone on its SM), streaming: thread
//                        0 issues labels[row] and then l_y before the
//                        stream, so both overlap it; each thread issues its
//                        next batch of four 16-byte loads before it folds
//                        the current one into a private online (m, Z, S2)
//                        (the batch's max first: one rescale a batch at
//                        most; at 16 bits by packed maxima), so its loads
//                        stay in flight while it computes; the block merges
//                        the triples by a max, one rescale expf(m_t - M) a
//                        thread, and sums.
//
// Rows are read through a row stride (an LM logits view needs no copy) and
// need no padding: a streamed row whose pointer is not 16-byte aligned
// takes scalar loads up to the first 16-byte boundary, then 16-byte loads
// (4 f32 or 8 bf16 or f16), then a scalar tail; the warp layout takes
// 16-byte loads only when the base and the row stride keep every row
// aligned, else one value a load. V has no limit in the block layout.
// bf16 and f16 logits are widened on load, exactly, as the TPU kernel's
// astype(f32); the outputs are f32 at every dtype.
//
// Bound: one read of N*V*4 bytes (N*V*2 at bf16 and f16) and a few flops a
// value, so at LM vocabularies it is bound by device memory, provided the
// card has enough bytes in flight and the IEEE expf (most of a value's dozen
// instructions) hides under the loads: with one block a row, N < 132 rows
// keep only N SMs busy (splitting a row across blocks waits for a path
// that scores few rows of a large vocabulary). At the ViT classifier's
// (16, 100) it is bound by latency: one trip to device memory is what the
// warp layout spends.
//
// IEEE expf/logf (no fast math). A label outside [0, V) gives NaN in both
// outputs rather than reading outside the row. A streamed thread starts its
// running max at -FLT_MAX rather than -inf, so a -inf logit adds exp(-inf)
// = 0 and never exp(-inf - -inf); a row of -inf alone (Z = 0) gives NaN in
// both outputs in either layout, as the plain form's exp(-inf - -inf).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using namespace sfp;

constexpr int kRowValues = 32;    // values of a row one lane holds (warp)
constexpr int kMaxThreads = 512;  // a block, in every layout
constexpr int kUnroll = 4;        // 16-byte loads of a streaming thread's
//                                   batch (two batches in flight)
constexpr int kWarp = 0, kBlock = 1;  // layouts

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

// Writes the row's outputs from its reduced statistics, as the TPU kernel's
// _finalize. z is 0 (block) or NaN (warp) only for a row of -inf alone.
__device__ __forceinline__ void finalize(long long row, int y, int v,
                                         float m, float z, float s2,
                                         float ly, float* el2n, float* ce) {
  if (y < 0 || y >= v || !(z > 0.f)) {
    el2n[row] = NAN;
    ce[row] = NAN;
    return;
  }
  z = fmaxf(z, 1e-30f);
  const float py = expf(ly - m) / z;
  const float sq = fmaxf(s2 / (z * z) - 2.f * py + 1.f, 0.f);
  el2n[row] = sqrtf(sq);
  ce[row] = m + logf(z) - ly;
}

// ------------------------------------------------------------------ warp
// A warp a row, the row in registers: groups of VEC values (VEC =
// kPer16<T>, one 16-byte load, or 1), group g = lane + 32 k at columns
// [g VEC, g VEC + VEC). Columns past V hold -inf (exp gives 0).
template <class T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
el2n_warp_kernel(const T* __restrict__ logits, long long row_stride,
                 const int* __restrict__ labels, int n, int v,
                 float* __restrict__ el2n, float* __restrict__ ce) {
  constexpr int G = kRowValues / VEC;  // groups a lane holds
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;  // no barrier below: the warp alone
  const int lane = threadIdx.x & 31;
  const T* p = logits + row * row_stride;

  // every load of the row and the label issued before any is used
  const int y = __ldg(labels + row);
  float x[G][VEC];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int c0 = (lane + 32 * k) * VEC;
    if constexpr (VEC > 1) {
      if (c0 + VEC <= v) {
        load16(p + c0, x[k]);
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      x[k][j] = c0 + j < v ? to_f32(p[c0 + j]) : -INFINITY;
  }

  // the max and l_y (a select on the column, no second read), one set of
  // shuffles
  float m = -INFINITY, ly = -INFINITY;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (32 * k * VEC >= v) break;  // warp-uniform: groups past the row
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m = fmaxf(m, x[k][j]);
      if ((lane + 32 * k) * VEC + j == y) ly = x[k][j];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    ly = fmaxf(ly, __shfl_xor_sync(0xffffffffu, ly, off));
  }

  float z = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (32 * k * VEC >= v) break;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float e = expf(x[k][j] - m);
      z += e;
      s2 = fmaf(e, e, s2);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    z += __shfl_xor_sync(0xffffffffu, z, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if (lane == 0) finalize(row, y, v, m, z, s2, ly, el2n, ce);
}

// ------------------------------------------------------------- streaming
// Value e (0 .. kPer16<T> - 1) of 16 bytes w, widened.
__device__ __forceinline__ uint32_t word(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}
__device__ __forceinline__ float elem(const uint4& w, int e, float) {
  return __uint_as_float(word(w, e));
}
__device__ __forceinline__ float elem(const uint4& w, int e, bf16) {
  return e & 1 ? bf16_hi(word(w, e >> 1)) : bf16_lo(word(w, e >> 1));
}
__device__ __forceinline__ float elem(const uint4& w, int e, f16) {
  return e & 1 ? f16_hi(word(w, e >> 1)) : f16_lo(word(w, e >> 1));
}

// The largest of the values of 16 bytes w, widened: at 16 bits by three
// packed maxima (exact, as fmaxf on the widened values).
__device__ __forceinline__ float group_max(const uint4& w, float) {
  return fmaxf(fmaxf(__uint_as_float(w.x), __uint_as_float(w.y)),
               fmaxf(__uint_as_float(w.z), __uint_as_float(w.w)));
}
template <class H2>
__device__ __forceinline__ float packed_max(const uint4& w) {
  H2 h[4];
  memcpy(h, &w, sizeof(h));
  const H2 m = __hmax2(__hmax2(h[0], h[1]), __hmax2(h[2], h[3]));
  return fmaxf(__low2float(m), __high2float(m));
}
__device__ __forceinline__ float group_max(const uint4& w, bf16) {
  return packed_max<__nv_bfloat162>(w);
}
__device__ __forceinline__ float group_max(const uint4& w, f16) {
  return packed_max<__half2>(w);
}

// A thread's online statistics: (m, z, s2) with z, s2 relative to m.
struct Stats {
  float m = -FLT_MAX, z = 0.f, s2 = 0.f;

  // rescale to a new max gm if it is larger
  __device__ __forceinline__ void raise_to(float gm) {
    if (gm > m) {
      const float a = expf(m - gm);
      z *= a;
      s2 *= a * a;
      m = gm;
    }
  }
  __device__ __forceinline__ void add(float x) {
    const float e = expf(x - m);
    z += e;
    s2 = fmaf(e, e, s2);
  }
  __device__ __forceinline__ void fold(float x) {
    raise_to(x);
    add(x);
  }
};

// The block's (m, z, s2) in warp 0 (every lane): a warp max, each thread's
// sums rescaled to it once, warp sums; then the same over the warps'
// triples through shared memory.
__device__ __forceinline__ Stats block_stats(Stats s) {
  __shared__ float part[3][kMaxThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float wm = warp_max(s.m);
  const float a = expf(s.m - wm);
  const float wz = warp_sum(s.z * a), ws2 = warp_sum(s.s2 * (a * a));
  if (lane == 0) {
    part[0][warp] = wm;
    part[1][warp] = wz;
    part[2][warp] = ws2;
  }
  __syncthreads();
  Stats out;
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    const float m = lane < nw ? part[0][lane] : -FLT_MAX;
    out.m = warp_max(m);
    const float b = expf(m - out.m);
    out.z = warp_sum(lane < nw ? part[1][lane] * b : 0.f);
    out.s2 = warp_sum(lane < nw ? part[2][lane] * (b * b) : 0.f);
  }
  return out;
}

// The 16-byte groups g, g + P, ... (kUnroll of them, those below g1) of a
// streamed row into w.
template <class T>
__device__ __forceinline__ void load_batch(uint4 (&w)[kUnroll], const T* body,
                                           int g, int P, int g1) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (g + u * P < g1)
      w[u] = __ldg(reinterpret_cast<const uint4*>(
          body + (long long)(g + u * P) * kPer16<T>));
}

// Fold the groups load_batch loaded: their max first, so s rescales at
// most once a batch, then one expf a value.
template <class T>
__device__ __forceinline__ void fold_batch(Stats& s, const uint4 (&w)[kUnroll],
                                           int g, int P, int g1) {
  float gm = -FLT_MAX;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (g + u * P < g1) gm = fmaxf(gm, group_max(w[u], T{}));
  s.raise_to(gm);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (g + u * P < g1)
#pragma unroll
      for (int e = 0; e < kPer16<T>; ++e) s.add(elem(w[u], e, T{}));
}

// A row a block.
template <class T>
__global__ void __launch_bounds__(kMaxThreads)
el2n_stream_kernel(const T* __restrict__ logits, long long row_stride,
                   const int* __restrict__ labels, int v,
                   float* __restrict__ el2n, float* __restrict__ ce) {
  constexpr int kVec = kPer16<T>;  // values a 16-byte load
  const long long row = blockIdx.x;
  const T* p = logits + row * row_stride;
  const int t = threadIdx.x, P = blockDim.x;

  // the label and its logit first, so both loads overlap the stream
  int y = -1;
  float ly = 0.f;
  if (t == 0) {
    y = __ldg(labels + row);
    if (y >= 0 && y < v) ly = to_f32(p[y]);
  }

  // scalar head up to the first 16-byte boundary, 16-byte body, scalar tail
  int head = (int)(((16u - ((uintptr_t)p & 15u)) & 15u) / sizeof(T));
  if (head > v) head = v;
  const int g1 = (v - head) / kVec;
  const int tail = head + kVec * g1;
  Stats s;
  for (int j = t; j < head; j += P) s.fold(to_f32(p[j]));
  for (int j = tail + t; j < v; j += P) s.fold(to_f32(p[j]));
  // two batches of kUnroll 16-byte loads a thread, in turn: the next
  // batch's loads are issued before the current one is folded, so the
  // loads of every thread stay in flight while it computes
  const T* body = p + head;
  const int step = kUnroll * P;
  uint4 a[kUnroll], b[kUnroll];
  int g = t;
  load_batch<T>(a, body, g, P, g1);
  while (g < g1) {
    load_batch<T>(b, body, g + step, P, g1);
    fold_batch<T>(s, a, g, P, g1);
    g += step;
    if (g >= g1) break;
    load_batch<T>(a, body, g + step, P, g1);
    fold_batch<T>(s, b, g, P, g1);
    g += step;
  }

  s = block_stats(s);
  if (t == 0) finalize(row, y, v, s.m, s.z, s.s2, ly, el2n, ce);
}

template <class T>
cudaError_t launch(const T* x, long long row_stride, const int* labels,
                   float* el2n, float* ce, int n, int v, int layout,
                   int threads, cudaStream_t st) {
  if (layout == kWarp) {
    const int rows = threads / 32;
    const unsigned grid = (unsigned)((n + rows - 1) / rows);
    const bool vec = ((uintptr_t)x & 15u) == 0 &&
                     (row_stride * (long long)sizeof(T)) % 16 == 0;
    if (vec)
      el2n_warp_kernel<T, kPer16<T>><<<grid, threads, 0, st>>>(
          x, row_stride, labels, n, v, el2n, ce);
    else
      el2n_warp_kernel<T, 1><<<grid, threads, 0, st>>>(x, row_stride, labels,
                                                       n, v, el2n, ce);
  } else if (layout == kBlock) {
    el2n_stream_kernel<T><<<n, threads, 0, st>>>(x, row_stride, labels, v,
                                                 el2n, ce);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// logits of dtype logits_dtype (kF32, kBF16 or kF16); el2n, ce f32. The
// plan (layout, threads a block) comes from kernels/el2n/kernel.py::
// el2n_plan.
extern "C" int sfp_el2n_fwd(const void* logits, int logits_dtype,
                            long long row_stride, const int* labels,
                            float* el2n, float* ce, int n, int v, int layout,
                            int threads, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)with_dtype(logits_dtype, [&](auto as) {
    using T = typename decltype(as)::type;
    return launch(static_cast<const T*>(logits), row_stride, labels, el2n, ce,
                  n, v, layout, threads, st);
  });
}
