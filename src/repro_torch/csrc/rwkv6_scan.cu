// RWKV-6 time-mix recurrence (fp32) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan/kernel.py::rwkv6_fwd.
// Per (batch b, head h), with the (K, V) state S and data-dependent
// log-decay w_t < 0:
//
//   y_t[v]    = sum_k r_t[k] S[k, v] + (sum_k r_t[k] u[k] k_t[k]) v_t[v]
//   S[k, v]  <- exp(w_t[k]) S[k, v] + k_t[k] v_t[v]
//
// stepped exactly, in order, from the carried state (or zeros): there is no
// exp(-cumsum) factor, so strong decays (w <= -12) stay finite and exact, as
// in the TPU kernel, which steps each chunk exactly with the state in VMEM.
// Its wrapper's moveaxis to (BH, T, .), its padding of T to a multiple of
// the chunk (zero k and w rows) and its sequential chunk grid axis are TPU
// layout only.
//
// Design: grid (H, B), one block per (b, h) with one thread per column v of
// the state (V threads, rounded up to whole warps); thread v keeps S[:, v],
// K values, in registers for the whole run. The block loops over T in tiles
// of up to kTile steps: it stages r_t, k_t, exp(w_t) (computed once a step,
// not once a thread) and v_t in shared memory, and each warp reduces the
// bonus sum_k r u k of some steps of the tile with shuffles. Then, step by
// step, every thread forms y_t[v] from its column (four partial sums, so
// the K products do not form one dependent chain) and updates the column.
// r, k, v and w are read in the op's (B, T, H, .) layout through strides;
// y and the final state (f32) are written contiguous.
//
// Bound on this card: each input read once, y written once, the state read
// once and written once, and 5 flops per state entry per step (r S and its
// sum; exp(w) S, k v and the add). Decode (8 slots, T 1, H 40, K = V = 64)
// is all state traffic, 2 x 8*40*64*64*4 B = 10.5 MB, about 3.1 us at
// 3.35 TB/s; prefill (batch 1, T 132) reads r, k, v and w once (5.4 MB),
// writes y and the state (2.0 MB), about 2.2 us, against 1.6 us of
// operations at 67 TFLOP/s. This simple kernel is far from both: it is
// latency bound by T dependent steps, and at batch 1 it fills 40 of the 132
// SMs with one two-warp block each. The chunked form on tensor cores, more blocks than
// (b, h) and writing the state in place of the cache are later work
// (ROADMAP).
//
// Each of r, k, v, w, u and s0 may be f32, bf16 or f16 (the TPU kernel
// reads each with astype(f32)): a dtype code per input, uniform over the
// launch, picks the load, which widens exactly. The staging writes f32 to
// shared memory, so the step loop is the same at every dtype. y is written
// in r's dtype (one round to nearest even), the final state in f32.
//
// IEEE expf (no fast math). Sums run in another order than the plain
// version's einsum, so the two agree to f32 rounding, not bit for bit.

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using namespace sfp;

constexpr int kMaxK = 64;                     // state rows a thread holds
constexpr int kTile = 32;                     // most steps staged at a time
constexpr int kSmemFloats = 48 * 1024 / 4;    // static-launch shared limit

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const void* u;
  const void* s0;    // null: zero initial state
  void* y;           // in r's dtype
  float* s_out;
  int r_dt, k_dt, v_dt, w_dt, u_dt, s0_dt;  // dtype codes
  int B, T, H, K, V, tile;
  long long r_sb, r_st, r_sh, k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh, w_sb, w_st, w_sh;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void rwkv6_scan_kernel(Params p) {
  extern __shared__ float smem[];
  float* r_s = smem;                          // (tile, K)
  float* k_s = r_s + p.tile * p.K;            // (tile, K)
  float* e_s = k_s + p.tile * p.K;            // (tile, K)  exp(w)
  float* v_s = e_s + p.tile * p.K;            // (tile, V)
  float* bonus_s = v_s + p.tile * p.V;        // (tile,)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const bool live = tid < p.V;

  const long long sbase = ((long long)b * p.H + h) * p.K * p.V + tid;
  float S[kMaxK];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i)
    S[i] = (live && i < p.K && p.s0 != nullptr)
               ? load_f32(p.s0, p.s0_dt, sbase + (long long)i * p.V)
               : 0.f;

  // element offsets of this (b, h) in each input and in y
  const long long ro = b * p.r_sb + h * p.r_sh;
  const long long ko = b * p.k_sb + h * p.k_sh;
  const long long vo = b * p.v_sb + h * p.v_sh;
  const long long wo = b * p.w_sb + h * p.w_sh;
  const long long uo = (long long)h * p.K;
  const long long yo = ((long long)b * p.T * p.H + h) * p.V + tid;
  const long long y_st = (long long)p.H * p.V;

  for (int t0 = 0; t0 < p.T; t0 += p.tile) {
    const int nt = min(p.tile, p.T - t0);
    __syncthreads();   // every thread is done with the previous tile
    for (int idx = tid; idx < nt * p.K; idx += blockDim.x) {
      const int s = idx / p.K, i = idx - s * p.K;
      r_s[idx] = load_f32(p.r, p.r_dt, ro + (t0 + s) * p.r_st + i);
      k_s[idx] = load_f32(p.k, p.k_dt, ko + (t0 + s) * p.k_st + i);
      e_s[idx] = expf(load_f32(p.w, p.w_dt, wo + (t0 + s) * p.w_st + i));
    }
    for (int idx = tid; idx < nt * p.V; idx += blockDim.x) {
      const int s = idx / p.V, c = idx - s * p.V;
      v_s[idx] = load_f32(p.v, p.v_dt, vo + (t0 + s) * p.v_st + c);
    }
    __syncthreads();
    for (int s = warp; s < nt; s += n_warps) {
      float acc = 0.f;
      for (int i = lane; i < p.K; i += 32)
        acc += r_s[s * p.K + i] * load_f32(p.u, p.u_dt, uo + i) *
               k_s[s * p.K + i];
      acc = warp_sum(acc);
      if (lane == 0) bonus_s[s] = acc;
    }
    __syncthreads();

    for (int s = 0; s < nt; ++s) {
      const float vv = live ? v_s[s * p.V + tid] : 0.f;
      const float* rs = r_s + s * p.K;
      const float* ks = k_s + s * p.K;
      const float* es = e_s + s * p.K;
      float y4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kMaxK; ++i) {
        if (i < p.K) {
          y4[i & 3] += rs[i] * S[i];
          S[i] = es[i] * S[i] + ks[i] * vv;
        }
      }
      if (live)
        store_f32(p.y, p.r_dt, yo + (t0 + s) * y_st,
                  ((y4[0] + y4[1]) + (y4[2] + y4[3])) + bonus_s[s] * vv);
    }
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < kMaxK; ++i)
    if (i < p.K) p.s_out[sbase + (long long)i * p.V] = S[i];
}

}  // namespace

// Each input with its dtype code (kF32, kBF16 or kF16); s0 may be null.
// y is written in r's dtype, s_out in f32.
extern "C" int sfp_rwkv6_scan_fwd(
    const void* r, int r_dt, const void* k, int k_dt, const void* v,
    int v_dt, const void* w, int w_dt, const void* u, int u_dt,
    const void* s0, int s0_dt, void* y, float* s_out, int B, int T,
    int H, int K, int V, long long r_sb, long long r_st, long long r_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long w_sb, long long w_st,
    long long w_sh, void* stream) {
  const int per_step = 3 * K + V + 1;
  int tile = kSmemFloats / per_step;
  if (tile > kTile) tile = kTile;
  const int threads = (V + 31) / 32 * 32;
  if (tile < 1 || K < 1 || K > kMaxK || V < 1 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  Params p{r,    k,    v,    w,    u,     s0,    y,    s_out,
           r_dt, k_dt, v_dt, w_dt, u_dt,  s0_dt, B,    T,
           H,    K,    V,    tile, r_sb,  r_st,  r_sh, k_sb,
           k_st, k_sh, v_sb, v_st, v_sh,  w_sb,  w_st, w_sh};
  if (B > 0 && H > 0) {
    dim3 grid(H, B);
    rwkv6_scan_kernel<<<grid, threads, tile * per_step * sizeof(float),
                        (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
