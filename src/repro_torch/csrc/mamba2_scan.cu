// Mamba-2 SSD scan (fp32) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mamba2_scan/kernel.py::mamba2_fwd.
// Per (batch b, head h), with the scalar decay a_t = exp(dt_t * A_h) and the
// head's group g = h / (H / G) of B and C:
//
//   h_t[p, n] = a_t h_{t-1}[p, n] + (dt_t x_t[p]) B_t[n]
//   y_t[p]    = sum_n h_t[p, n] C_t[n]
//
// stepped exactly, in order, from the carried state h0 (or zeros). The TPU
// kernel computes the same function as chunked matmuls with the (P, N)
// state in VMEM; its wrapper's moveaxis to (BH, T, .), its padding of T to
// a multiple of the chunk (zero dt rows) and its sequential chunk grid axis
// are TPU layout only. Here:
//
// Design: grid (H, B), one block per (b, h). The (P, N) state lives in
// registers for the whole run: thread t owns row p = t / tpp and the
// columns n = j + tpp * i (j = t % tpp, i < kPer), tpp the least power of
// two that leaves a thread at most kPer columns (4 threads a row at N 64).
// The block loops over T in tiles of up to kTile steps: it stages a_t =
// exp(dt_t A) once a step, dt_t x_t[p], B_t and C_t of the group in shared
// memory, then every thread updates its columns and sums its share of y_t[p];
// the tpp threads of a row reduce by warp shuffles and one writes y_t[p].
// x, dt, B and C are read in the op's (B, T, H|G, .) layout through strides;
// y and the final state (f32) are written contiguous.
//
// Bound on this card: each input read once, y written once, the state read
// once and written once, and 5 flops per state entry per step (a h, (dt x)
// B, the add; the product with C and its sum). Decode (8 slots, T 1, H 80,
// P = N = 64) is all state traffic, 2 x 8*80*64*64*4 B = 21 MB, about 6.3
// us at 3.35 TB/s; prefill (batch 1, T 132) is bound by operations, about
// 3.2 us at 67 TFLOP/s. This simple kernel is far from both: it is latency
// bound by T dependent steps (a shared-memory round and a shuffle reduction
// each), and at batch 1 it fills 80 of the 132 SMs with one block each. The
// chunked form on tensor cores, split-state blocks and writing the state in
// place of the cache are later work (ROADMAP).
//
// Each of x, dt, A, B, C and h0 may be f32 or bf16 (the TPU kernel reads
// each with astype(f32); the layer passes x, B and C in the activation
// dtype and dt in f32): a dtype code per input, uniform over the launch,
// picks the load, which widens exactly. The staging writes f32 to shared
// memory, so the step loop is the same at every dtype. y is written in x's
// dtype (one round to nearest even), the final state in f32.
//
// IEEE expf (no fast math). Sums run in another order than the plain
// version's einsum, so the two agree to f32 rounding, not bit for bit.

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using namespace sfp;

constexpr int kPer = 16;                      // state columns a thread holds
constexpr int kTile = 32;                     // most steps staged at a time
constexpr int kSmemFloats = 48 * 1024 / 4;    // static-launch shared limit

struct Params {
  const void* x;
  const void* dt;
  const void* A;
  const void* Bm;
  const void* Cm;
  const void* h0;    // null: zero initial state
  void* y;           // in x's dtype
  float* h_out;
  int x_dt, dt_dt, a_dt, b_dt, c_dt, h0_dt;  // dtype codes
  int B, T, H, G, P, N, tpp, tile;
  long long x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh;
  long long b_sb, b_st, b_sg, c_sb, c_st, c_sg;
};

__global__ void mamba2_scan_kernel(Params p) {
  extern __shared__ float smem[];
  float* a_s = smem;                          // (tile,)
  float* dtx_s = a_s + p.tile;                // (tile, P)
  float* b_s = dtx_s + p.tile * p.P;          // (tile, N)
  float* c_s = b_s + p.tile * p.N;            // (tile, N)

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  const int row = tid / p.tpp;
  const int j = tid - row * p.tpp;
  const bool live = row < p.P;
  const float A = load_f32(p.A, p.a_dt, h);

  const long long sbase = ((long long)b * p.H + h) * p.P * p.N
                          + (long long)row * p.N;
  float st[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int n = j + p.tpp * i;
    st[i] = (live && n < p.N && p.h0 != nullptr)
                ? load_f32(p.h0, p.h0_dt, sbase + n) : 0.f;
  }

  // element offsets of this (b, h) in each input and in y
  const long long xo = b * p.x_sb + h * p.x_sh;
  const long long dto = b * p.dt_sb + h * p.dt_sh;
  const long long bo = b * p.b_sb + g * p.b_sg;
  const long long co = b * p.c_sb + g * p.c_sg;
  const long long yo = ((long long)b * p.T * p.H + h) * p.P + row;
  const long long y_st = (long long)p.H * p.P;

  for (int t0 = 0; t0 < p.T; t0 += p.tile) {
    const int nt = min(p.tile, p.T - t0);
    __syncthreads();   // every thread is done with the previous tile
    for (int s = tid; s < nt; s += blockDim.x)
      a_s[s] = expf(load_f32(p.dt, p.dt_dt, dto + (t0 + s) * p.dt_st) * A);
    for (int idx = tid; idx < nt * p.P; idx += blockDim.x) {
      const int s = idx / p.P, q = idx - s * p.P;
      dtx_s[idx] = load_f32(p.dt, p.dt_dt, dto + (t0 + s) * p.dt_st) *
                   load_f32(p.x, p.x_dt, xo + (t0 + s) * p.x_st + q);
    }
    for (int idx = tid; idx < nt * p.N; idx += blockDim.x) {
      const int s = idx / p.N, n = idx - s * p.N;
      b_s[idx] = load_f32(p.Bm, p.b_dt, bo + (t0 + s) * p.b_st + n);
      c_s[idx] = load_f32(p.Cm, p.c_dt, co + (t0 + s) * p.c_st + n);
    }
    __syncthreads();

    for (int s = 0; s < nt; ++s) {
      const float a = a_s[s];
      const float xd = live ? dtx_s[s * p.P + row] : 0.f;
      const float* bs = b_s + s * p.N;
      const float* cs = c_s + s * p.N;
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int n = j + p.tpp * i;
        if (n < p.N) {
          st[i] = a * st[i] + xd * bs[n];
          if (i & 1)
            acc1 += st[i] * cs[n];
          else
            acc0 += st[i] * cs[n];
        }
      }
      float acc = acc0 + acc1;
      // the tpp threads of a row are consecutive lanes of one warp
      for (int off = p.tpp >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (live && j == 0)
        store_f32(p.y, p.x_dt, yo + (t0 + s) * y_st, acc);
    }
  }

  if (!live) return;
  float* ho = p.h_out + sbase;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int n = j + p.tpp * i;
    if (n < p.N) ho[n] = st[i];
  }
}

}  // namespace

// Each input with its dtype code (kF32 or kBF16); h0 may be null. y is
// written in x's dtype, h_out in f32.
extern "C" int sfp_mamba2_scan_fwd(
    const void* x, int x_dt, const void* dt, int dt_dt, const void* A,
    int a_dt, const void* Bm, int b_dt, const void* Cm, int c_dt,
    const void* h0, int h0_dt, void* y, float* h_out, int B, int T,
    int H, int G, int P, int N, int tpp, long long x_sb, long long x_st,
    long long x_sh, long long dt_sb, long long dt_st, long long dt_sh,
    long long b_sb, long long b_st, long long b_sg, long long c_sb,
    long long c_st, long long c_sg, void* stream) {
  const int per_step = 1 + P + 2 * N;
  int tile = kSmemFloats / per_step;
  if (tile > kTile) tile = kTile;
  const int threads = (P * tpp + 31) / 32 * 32;
  if (tile < 1 || tpp < 1 || tpp > 32 || (tpp & (tpp - 1)) ||
      tpp * kPer < N || threads > 1024 || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  Params p{x,    dt,    A,    Bm,   Cm,    h0,    y,     h_out,
           x_dt, dt_dt, a_dt, b_dt, c_dt,  h0_dt, B,     T,
           H,    G,     P,    N,    tpp,   tile,  x_sb,  x_st,
           x_sh, dt_sb, dt_st, dt_sh, b_sb, b_st, b_sg,  c_sb,
           c_st, c_sg};
  if (B > 0 && H > 0) {
    dim3 grid(H, B);
    mamba2_scan_kernel<<<grid, threads, tile * per_step * sizeof(float),
                         (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
