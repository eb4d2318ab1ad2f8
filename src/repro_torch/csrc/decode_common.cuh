// What the two decode attention kernels share: the slot-cache kernel
// (decode_attention.cu) and the page-pool kernel (paged_decode_attention.cu)
// differ only in where key w of a slot lives and in how each treats a row
// with no valid key. Both:
//
// - flag the 32-key tiles that hold a valid key (one key a lane, a
//   __ballot_sync a tile, the masks kept in shared memory) and list them in
//   order (list_valid_tiles);
// - split each (slot, kv head) row S ways over its listed tiles, so a block
//   takes a contiguous share in rank order; a split writes its unnormalized
//   (m, l, acc) rows to a (B, Hq, S, Dv + 2) workspace and
//   decode_combine_kernel merges them (with S = 1 the block writes the
//   output itself);
// - stream the tiles through two shared-memory stages with cp.async, the
//   next tile's rows in flight while the current one is folded (walk_tiles);
// - fold a tile as four warps of kR query rows (G = Hq / Hkv <= 4 kR), one
//   lane scoring one key on the fp32 SIMT pipe in four partial sums a row,
//   the weights through shared memory, each lane owning four output columns
//   of every 128 (DecodeRows).
//
// q and the output share one dtype, f32, bf16 or f16 (the TPU kernels
// write q's dtype); K and V share another, independently: the serving
// engines hold f32 caches under 16-bit activations. bf16 and f16 values
// are widened to f32 on load — exact — so the tiles, the fold and the
// combine are the f32 kernel's. f32 K/V tiles stream through cp.async;
// 16-bit tiles are read with synchronous 8-byte loads (4 values a lane)
// into the same f32 stages, and 16-bit query rows likewise. Only the last
// writer (the block at S = 1, else the combine) rounds the output, once,
// to nearest even.
//
// Each kernel is instantiated per shape (DecodeShape): the widest head dim
// it takes, kD = 128 or 256, and the query rows a warp, kR = 2 (G <= 8) or
// 4 (G <= 16); the entry points pick one by Dh, Dv and G. At kD 256 a lane
// copies two 16-byte chunks of a row and owns eight output columns. Shared
// rows have stride kD + 4 floats: copies stay 16-byte aligned and each
// lane's float4 read of its own key row hits distinct banks in every
// quarter warp. Shared memory is dynamic. A block takes 72.7 KB at (128,
// 2), so three stay resident on an SM (the serving paths of Qwen2.5-14B
// and zamba2); 77.8 KB at (128, 4), two; 142.3 KB at (256, 2) and 151.6 KB
// at (256, 4), one. The wrapper's `decode_blocks_per_sm` computes the same
// from the same sizes and sets the split count by it.
#pragma once

#include "attention_common.cuh"
#include "dtype.cuh"
#include "mma_tf32.cuh"  // the cp.async helpers

#include <type_traits>

namespace sfp {

constexpr int kMaxSplits = 8;
constexpr int kStages = 2;           // K/V tiles in shared memory
constexpr int kDecodeMaxGroup = 16;  // the largest G of any instantiation

// A decode kernel's shape: kD the widest head dim it takes (a multiple of
// 128), kR the query rows a warp.
template <int kD, int kR>
struct DecodeShape {
  static constexpr int kMaxGroup = kWarps * kR;
  static constexpr int kLD = kD + 4;  // shared row stride of a K or V tile
  static constexpr int kStage = kBK * kLD;
  static constexpr int kChunks = kD / 128;  // 16-byte chunks of a row a lane
  static constexpr size_t kFixedSmem =
      (kMaxGroup * (kD + kBK) + 2 * kStages * kStage) * sizeof(float);
  static_assert(kD % 128 == 0 && kMaxGroup <= kDecodeMaxGroup, "shape");
};

// Dynamic shared memory of a decode block over n_tiles tiles of keys.
template <int kD, int kR>
inline size_t decode_smem_bytes(int n_tiles) {
  return DecodeShape<kD, kR>::kFixedSmem + n_tiles * 2 * sizeof(int);
}

// The carving of a decode block's dynamic shared memory.
template <int kD, int kR>
struct DecodeSmem {
  using Sh = DecodeShape<kD, kR>;
  float* qs;        // kMaxGroup query rows of kD
  float* ks;        // kStages tiles of kBK rows of kLD
  float* vs;
  float* ps;        // a tile's weights, by warp row
  unsigned* vmask;  // per tile: its valid-key mask (bit j: key j)
  int* tl;          // the tiles holding a valid key, in order

  __device__ DecodeSmem(float* smem, int n_tiles)
      : qs(smem),
        ks(qs + Sh::kMaxGroup * kD),
        vs(ks + kStages * Sh::kStage),
        ps(vs + kStages * Sh::kStage),
        vmask(reinterpret_cast<unsigned*>(ps + Sh::kMaxGroup * kBK)),
        tl(reinterpret_cast<int*>(vmask + n_tiles)) {}
};

// The plain version's mask: position kp counts for a query at qp.
__device__ __forceinline__ bool key_valid(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

// Copy one row of n floats to shared memory as `chunks` (<= 32 kC)
// 16-byte chunks, chunk lane + 32 i by lane in step i of kC, zero-filling
// past n. No loop over the row: a loop here, inlined for every key of every
// tile copy, swelled the kernel's code several times over and slowed it;
// the kC steps are unrolled.
template <bool kVec16, int kC = 1>
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n,
                                         int chunks, int lane) {
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int ch = lane + 32 * i;
    if (ch >= chunks) return;
    const int c = 4 * ch;
    if (kVec16) {
      const int left = min(max(n - c, 0), 4);
      cp_async16(dst + c, left ? src + c : src, 4 * left);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(dst + c + e, c + e < n ? src + c + e : src,
                  c + e < n ? 4 : 0);
    }
  }
}

// The same copy from a bf16 or f16 row, widened to f32 on the way: one
// 8-byte load of 4 values a chunk (kVec: src aligned to 8 bytes) or 4
// single loads, then one 16-byte shared store. Synchronous: the stage is
// visible to the block after the walk's next __syncthreads, as a cp.async
// stage is after its wait. (For a float row the overload above, the more
// specialised template, is the one called.)
template <bool kVec, int kC = 1, class T16>
__device__ __forceinline__ void copy_row(float* dst, const T16* src, int n,
                                         int chunks, int lane) {
  static_assert(sizeof(T16) == 2, "16-bit rows only");
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int ch = lane + 32 * i;
    if (ch >= chunks) return;
    const int c = 4 * ch;
    float4 f;
    if (kVec && n - c >= 4) {
      f = load4(src + c);
    } else {
      f.x = c < n ? to_f32(src[c]) : 0.f;
      f.y = c + 1 < n ? to_f32(src[c + 1]) : 0.f;
      f.z = c + 2 < n ? to_f32(src[c + 2]) : 0.f;
      f.w = c + 3 < n ? to_f32(src[c + 3]) : 0.f;
    }
    *reinterpret_cast<float4*>(dst + c) = f;
  }
}

// Start the copy of the group's G query rows (element qo of q, of dtype
// q_dtype; row stride q_sh) into qs (rows of kD), zero past G and Dh so
// dots read whole float4s. f32 rows go by cp.async, committed as their own
// group, landing with the first tile; bf16 and f16 rows are widened by
// plain loads and stores. Either way the rows are visible after the flag
// pass's __syncthreads.
template <int kD, int kR, class T16>
__device__ __forceinline__ void widen_queries(float* qs, const T16* qb,
                                              long long q_sh, int G, int Dh,
                                              int tid) {
  constexpr int kMaxGroup = DecodeShape<kD, kR>::kMaxGroup;
  for (int idx = tid; idx < kMaxGroup * kD; idx += kThreads) {
    const int g = idx / kD, d = idx % kD;
    qs[idx] = g < G && d < Dh ? to_f32(qb[g * q_sh + d]) : 0.f;
  }
}

template <int kD, int kR>
__device__ __forceinline__ void load_queries(float* qs, const void* q,
                                             int q_dtype, long long qo,
                                             long long q_sh, int G, int Dh,
                                             int tid) {
  constexpr int kMaxGroup = DecodeShape<kD, kR>::kMaxGroup;
  if (q_dtype == kBF16) {
    widen_queries<kD, kR>(qs, static_cast<const bf16*>(q) + qo, q_sh, G, Dh,
                          tid);
  } else if (q_dtype == kF16) {
    widen_queries<kD, kR>(qs, static_cast<const f16*>(q) + qo, q_sh, G, Dh,
                          tid);
  } else {
    const float* qb = static_cast<const float*>(q) + qo;
    for (int idx = tid; idx < kMaxGroup * kD; idx += kThreads) {
      const int g = idx / kD, d = idx % kD;
      const bool in = g < G && d < Dh;
      cp_async4(qs + idx, in ? qb + g * q_sh + d : qb, in ? 4 : 0);
    }
  }
  cp_async_commit();
}

// Warp 0 lists the tiles whose valid-key mask is not 0 (vmask), in order,
// into tl, and stores their count in *count.
__device__ __forceinline__ void list_valid_tiles(const unsigned* vmask,
                                                 int* tl, int n_tiles,
                                                 int* count, int warp,
                                                 int lane) {
  if (warp != 0) return;
  int n = 0;
  for (int base = 0; base < n_tiles; base += 32) {
    const int t = base + lane;
    const bool f = t < n_tiles && vmask[t] != 0u;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (f) tl[n + __popc(m & ((1u << lane) - 1u))] = t;
    n += __popc(m);
  }
  if (lane == 0) *count = n;
}

// Walk tiles [lo, hi) of a row: issue(r, stage) starts the copy of the
// r-th tile into `stage`, fold(r, stage) folds it in once it has landed for
// every thread. kStages - 1 tiles are in flight ahead of the one folded.
template <class Issue, class Fold>
__device__ __forceinline__ void walk_tiles(int lo, int hi, Issue issue,
                                           Fold fold) {
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (lo + i < hi) issue(lo + i, i);
    cp_async_commit();
  }
  for (int r = lo; r < hi; ++r) {
    const int stage = (r - lo) % kStages;
    if (r + kStages - 1 < hi)
      issue(r + kStages - 1, (r - lo + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile r has landed for this thread ...
    __syncthreads();               // ... and for every thread
    fold(r, stage);
    __syncthreads();  // the stage is read before the next copy lands in it
  }
  cp_async_wait<0>();
}

// Where a decode launch writes: the output (B, Hq, Dv) of dtype o_dtype
// through its (b, h) strides, or with S > 1 the splits' f32 workspace
// (B, Hq, S, Dv + 2).
struct DecodeOut {
  void* o;
  float* ws;
  int B, Hq, S, Dv;
  long long o_sb, o_sh;
  int o_dtype;
};

// The online-softmax state of a warp's kR query rows g0 .. g0 + kR - 1:
// m and l are the row's, acc this lane's four output columns 128 c +
// 4 lane + e of each 128-column chunk c.
template <int kD, int kR>
struct DecodeRows {
  static constexpr int kLD = DecodeShape<kD, kR>::kLD;
  static constexpr int kC = kD / 128;
  float m[kR], l[kR], acc[kR][kC][4];

  __device__ __forceinline__ DecodeRows() {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      m[i] = kMask;
      l[i] = 0.f;  // this lane's share of the row sum, reduced in store()
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    }
  }

  // Fold one tile in: kt and vt its K and V rows (stride kLD), `bits` its
  // valid-key mask, `present` whether this lane's key lies inside the
  // row's width. With no valid key in the tile every present key scores
  // kMask whatever K holds, so the dots are skipped and K is not read.
  __device__ __forceinline__ void fold(const float* qs, const float* kt,
                                       const float* vt, float* ps,
                                       unsigned bits, bool present, int dh4,
                                       int dv4, float scale, float softcap,
                                       int warp, int lane) {
    const int g0 = warp * kR;
    const bool valid = (bits >> lane) & 1u;
    // this lane's key against the warp's rows, four partial sums a row
    float s[kR][4] = {};
    if (bits != 0u) {
      const float* kr = kt + lane * kLD;
      for (int c = 0; c < dh4; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * c);
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + (g0 + i) * kD + 4 * c);
          s[i][0] = fmaf(qv.x, kv.x, s[i][0]);
          s[i][1] = fmaf(qv.y, kv.y, s[i][1]);
          s[i][2] = fmaf(qv.z, kv.z, s[i][2]);
          s[i][3] = fmaf(qv.w, kv.w, s[i][3]);
        }
      }
    }
    float sc[kR], mx[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float dot = (s[i][0] + s[i][1]) + (s[i][2] + s[i][3]);
      sc[i] = valid ? cap(dot * scale, softcap) : kMask;
      mx[i] = present ? sc[i] : -INFINITY;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < kR; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
    float* pw = ps + warp * kR * kBK;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      const float alpha = expf(m[i] - m_new);
      const float pr = present ? expf(sc[i] - m_new) : 0.f;
      l[i] = alpha * l[i] + pr;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
      m[i] = m_new;
      pw[i * kBK + lane] = pr;
    }
    __syncwarp();
    // the values: each lane owns four columns of every 128, the weights
    // are read four keys at a time from shared memory
    if (lane < dv4) {
      const float* vc = vt + 4 * lane;
#pragma unroll
      for (int j = 0; j < kBK; j += 4) {
        float4 pj[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i)
          pj[i] = *reinterpret_cast<const float4*>(pw + i * kBK + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            if (c > 0 && lane + 32 * c >= dv4) continue;
            const float4 vv = *reinterpret_cast<const float4*>(
                vc + 128 * c + (j + u) * kLD);
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              const float pu = u == 0   ? pj[i].x
                               : u == 1 ? pj[i].y
                               : u == 2 ? pj[i].z
                                        : pj[i].w;
              acc[i][c][0] = fmaf(pu, vv.x, acc[i][c][0]);
              acc[i][c][1] = fmaf(pu, vv.y, acc[i][c][1]);
              acc[i][c][2] = fmaf(pu, vv.z, acc[i][c][2]);
              acc[i][c][3] = fmaf(pu, vv.w, acc[i][c][3]);
            }
          }
        }
      }
    }
  }

  // Write rows hk * G + g0 + i of slot b: normalized into the output with
  // S = 1, else unnormalized into split `split` of the workspace.
  __device__ __forceinline__ void store(const DecodeOut& out, int b, int hk,
                                        int G, int split, int warp,
                                        int lane) const {
    const int g0 = warp * kR;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int g = g0 + i;
      const float li = warp_sum(l[i]);
      if (g >= G) continue;
      const int h = hk * G + g;
      if (out.S == 1) {
        const long long ob = b * out.o_sb + h * out.o_sh;
        const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 128 * c + 4 * lane + e;
            if (d < out.Dv)
              store_f32(out.o, out.o_dtype, ob + d, acc[i][c][e] * inv);
          }
      } else {
        float* wb = out.ws + ((static_cast<long long>(b) * out.Hq + h) *
                                  out.S + split) * (out.Dv + 2);
        if (lane == 0) {
          wb[0] = m[i];
          wb[1] = li;
        }
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 128 * c + 4 * lane + e;
            if (d < out.Dv) wb[2 + d] = acc[i][c][e];
          }
      }
    }
  }
};

// Merge the S splits of each (slot, query head) row: one warp a row, lanes
// over the value columns. A split with l = 0 visited no tile. Static: each
// kernel's object has its own copy.
static __global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(DecodeOut p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= p.B * p.Hq) return;
  const int b = row / p.Hq, h = row - b * p.Hq;
  const float* wb = p.ws + static_cast<long long>(row) * p.S * (p.Dv + 2);
  float mx = -INFINITY;
  for (int s = 0; s < p.S; ++s)
    if (wb[s * (p.Dv + 2) + 1] > 0.f) mx = fmaxf(mx, wb[s * (p.Dv + 2)]);
  float f[kMaxSplits];
  float l = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    const float ls = s < p.S ? wb[s * (p.Dv + 2) + 1] : 0.f;
    f[s] = ls > 0.f ? expf(wb[s * (p.Dv + 2)] - mx) : 0.f;
    l += f[s] * ls;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const long long ob = b * p.o_sb + h * p.o_sh;
  for (int d = lane; d < p.Dv; d += 32) {
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (f[s] > 0.f) a = fmaf(f[s], wb[s * (p.Dv + 2) + 2 + d], a);
    store_f32(p.o, p.o_dtype, ob + d, a * inv);
  }
}

// Launch a decode kernel of shape (kD, kR) on grid (Hkv, B, S) over
// n_tiles tiles, then, with S > 1, the combine on the same stream.
template <int kD, int kR, class Params>
cudaError_t launch_decode(void (*kernel)(Params), const Params& p, int Hkv,
                          int n_tiles, const DecodeOut& out,
                          cudaStream_t stream) {
  const size_t bytes = decode_smem_bytes<kD, kR>(n_tiles);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hkv, out.B, out.S), kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || out.S == 1) return err;
  decode_combine_kernel<<<(out.B * out.Hq + kWarps - 1) / kWarps, kThreads,
                          0, stream>>>(out);
  return cudaGetLastError();
}

// Launch the instantiation of a decode kernel (Kernel<kD, kR, kVec16,
// TKV>::fn() is its function: a class template stands for the kernel
// template) that takes Dh and Dv
// (kD 128 up to 128, else 256) and G (kR 2 up to 8, else 4), with vector
// or single copies and f32, bf16 or f16 K/V (kv_dtype).
template <template <int, int, bool, class> class Kernel, class Params>
cudaError_t launch_decode_shape(const Params& p, int Dh, int Dv, int G,
                                bool vec, int kv_dtype, int Hkv, int n_tiles,
                                const DecodeOut& out, cudaStream_t stream) {
  auto go = [&](auto d, auto r) {
    constexpr int kD = decltype(d)::value, kR = decltype(r)::value;
    return with_dtype(kv_dtype, [&](auto as) {
      using TKV = typename decltype(as)::type;
      auto* kernel = vec ? Kernel<kD, kR, true, TKV>::fn()
                         : Kernel<kD, kR, false, TKV>::fn();
      return launch_decode<kD, kR>(kernel, p, Hkv, n_tiles, out, stream);
    });
  };
  using D128 = std::integral_constant<int, 128>;
  using D256 = std::integral_constant<int, 256>;
  using R2 = std::integral_constant<int, 2>;
  using R4 = std::integral_constant<int, 4>;
  const bool wide = Dh > 128 || Dv > 128, big = G > 8;
  if (wide) return big ? go(D256{}, R4{}) : go(D256{}, R2{});
  return big ? go(D128{}, R4{}) : go(D128{}, R2{});
}

}  // namespace sfp
