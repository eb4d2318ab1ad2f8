// Slot-cache decode attention (fp32) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/decode.py::
// decode_attention_fwd. One query token per slot attends to that slot's
// ring-buffer cache: per (slot, kv head) the kernel reads W keys and values
// once and does about 4 * G * W * Dh flops, so it is bound by device memory
// (the KV cache) by a wide margin.
//
// Design: grid (Hkv, B), one block per (slot, kv head). The block serves
// all G query heads of its group (G = Hq / Hkv, 5 for Qwen2.5 — not a power
// of two; up to 8 here, two rows per warp), so each kv head's tile is read
// from device memory once for the whole group. It reads the cache in the
// model's (B, W, Hkv, Dh) layout through strides — no moveaxis, no pad —
// and streams W in 32-key tiles through shared memory with an online
// softmax. Validity is pure data, as in the plain version: a cache entry
// counts when its position is >= 0 (empty slots are all -1), at or before
// the slot's query position (ring wraparound needs nothing else), and
// inside the sliding window; softcap applies before the mask.
//
// B * Hkv blocks is 64 at 8 slots and 8 kv heads, under half of the card's
// 132 SMs; splitting W across blocks (split-K) is later work.

#include "attention_common.cuh"

namespace {

using namespace sfp;

constexpr int kRowsPerWarp = 2;
constexpr int kMaxGroup = kWarps * kRowsPerWarp;

struct DecParams {
  const float* q;
  const float* k;
  const float* v;
  const int* q_pos;
  const int* kv_pos;
  float* o;
  int B, W, Hq, Hkv, Dh, Dv;
  long long q_sb, q_sh, k_sb, k_sw, k_sh, v_sb, v_sw, v_sh;
  long long qp_sb, kvp_sb, kvp_sw, o_sb, o_sh;
  int window;
  float softcap, scale;
};

__global__ void __launch_bounds__(kThreads) decode_kernel(DecParams p) {
  __shared__ float qs[kMaxGroup * kDMax];
  __shared__ float ks[kBK * (kDMax + 1)];
  __shared__ float vs[kBK * kDMax];
  __shared__ int kvps[kBK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = p.Hq / p.Hkv;

  const float* qb = p.q + b * p.q_sb + hk * G * p.q_sh;
  for (int idx = tid; idx < kMaxGroup * p.Dh; idx += kThreads) {
    const int g = idx / p.Dh, d = idx - g * p.Dh;
    qs[g * kDMax + d] = g < G ? qb[g * p.q_sh + d] : 0.f;
  }
  const int qp = p.q_pos[b * p.qp_sb];

  const float* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const int* pb = p.kv_pos + b * p.kvp_sb;
  const int g0 = warp * kRowsPerWarp;
  RowState<kRowsPerWarp> st;
  st.init();

  for (int kt = 0; kt < p.W; kt += kBK) {
    const int n_keys = min(kBK, p.W - kt);
    __syncthreads();
    for (int idx = tid; idx < n_keys * p.Dh; idx += kThreads) {
      const int j = idx / p.Dh, d = idx - j * p.Dh;
      ks[j * (kDMax + 1) + d] = kb[(kt + j) * p.k_sw + d];
    }
    for (int idx = tid; idx < n_keys * p.Dv; idx += kThreads) {
      const int j = idx / p.Dv, d = idx - j * p.Dv;
      vs[j * kDMax + d] = vb[(kt + j) * p.v_sw + d];
    }
    if (tid < n_keys) kvps[tid] = pb[(kt + tid) * p.kvp_sw];
    __syncthreads();
    if (g0 >= G) continue;  // a warp with no query head of this group

    const bool present = lane < n_keys;
    const int kp = present ? kvps[lane] : -1;
    const bool valid = kp >= 0 && kp <= qp &&
                       (p.window <= 0 || kp > qp - p.window);
    float s[kRowsPerWarp];
    tile_dots<kRowsPerWarp>(s, qs + g0 * kDMax, ks, present ? p.Dh : 0,
                            lane);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      s[i] = valid ? cap(s[i] * p.scale, p.softcap) : kMask;
    st.update(s, present, vs, n_keys, p.Dv, lane);
  }

  float* ob = p.o + b * p.o_sb + hk * G * p.o_sh;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int g = g0 + i;
    if (g >= G) continue;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < p.Dv) ob[g * p.o_sh + d] = st.out(i, c);
    }
  }
}

}  // namespace

extern "C" int sfp_decode_attention_fwd(
    const float* q, const float* k, const float* v, const int* q_pos,
    const int* kv_pos, float* o, int B, int W, int Hq, int Hkv, int Dh,
    int Dv, long long q_sb, long long q_sh, long long k_sb, long long k_sw,
    long long k_sh, long long v_sb, long long v_sw, long long v_sh,
    long long qp_sb, long long kvp_sb, long long kvp_sw, long long o_sb,
    long long o_sh, int window, float softcap, float scale, void* stream) {
  DecParams p{q,    k,    v,    q_pos, kv_pos, o,    B,      W,      Hq,
              Hkv,  Dh,   Dv,   q_sb,  q_sh,   k_sb, k_sw,   k_sh,   v_sb,
              v_sw, v_sh, qp_sb, kvp_sb, kvp_sw, o_sb, o_sh, window,
              softcap, scale};
  if (B > 0 && W > 0) {
    dim3 grid(Hkv, B);
    decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
