// Causal GQA prefill attention (fp32) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd. At the serving path's prefill shapes (one request,
// S up to a few hundred tokens, 40 query heads, head_dim 128) the work is
// about S^2 * Hq * Dh * 2 flops against S * (Hq + 2 Hkv) * Dh * 4 bytes, so
// it is bound by arithmetic: by the fp32 pipes, since this first version
// uses no tensor cores (TF32 would not hold the 2e-5 tolerance).
//
// Design: grid (ceil(Sq / 16), Hq, B); a block of four warps owns 16 query
// rows of one head, four per warp. It reads q, k and v in the model's own
// (B, S, H, Dh) layout through strides — no transpose, reshape or pad copy
// — and maps query head h to kv head h / (Hq / Hkv). The block loops over
// 32-key tiles from the first key any of its rows can see (sliding window)
// to the last (causal limit, kv_len), staging each tile in shared memory;
// dead tiles are never loaded. Causal, window, softcap and kv_len masks are
// applied per element with the finite mask -2^30.
//
// A row that every key masks (a sliding window that ends before kv_len)
// gets the plain version's answer, the mean of v over all kv_len keys: a
// block holding such a row visits every tile.

#include "attention_common.cuh"

namespace {

using namespace sfp;

constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;

struct FaParams {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, Sq, Skv, Hq, Hkv, Dh, Dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float softcap, scale;
  int kv_len;
};

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FaParams p) {
  __shared__ float qs[kBQ * kDMax];
  __shared__ float ks[kBK * (kDMax + 1)];
  __shared__ float vs[kBK * kDMax];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (p.Hq / p.Hkv);

  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  for (int idx = tid; idx < kBQ * p.Dh; idx += kThreads) {
    const int r = idx / p.Dh, d = idx - r * p.Dh;
    qs[r * kDMax + d] = q0 + r < p.Sq ? qb[(q0 + r) * p.q_ss + d] : 0.f;
  }

  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  int kv_end = p.causal ? min(p.kv_len, q_last + 1) : p.kv_len;
  if (p.window > 0 && q_last >= p.kv_len + p.window - 1) {
    kv_begin = 0;  // some row is fully masked: it averages every key
    kv_end = p.kv_len;
  }

  const float* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const int row0 = q0 + warp * kRowsPerWarp;
  RowState<kRowsPerWarp> st;
  st.init();

  for (int kt = kv_begin; kt < kv_end; kt += kBK) {
    const int n_keys = min(kBK, kv_end - kt);
    __syncthreads();
    for (int idx = tid; idx < n_keys * p.Dh; idx += kThreads) {
      const int j = idx / p.Dh, d = idx - j * p.Dh;
      ks[j * (kDMax + 1) + d] = kb[(kt + j) * p.k_ss + d];
    }
    for (int idx = tid; idx < n_keys * p.Dv; idx += kThreads) {
      const int j = idx / p.Dv, d = idx - j * p.Dv;
      vs[j * kDMax + d] = vb[(kt + j) * p.v_ss + d];
    }
    __syncthreads();

    const bool present = lane < n_keys;
    const int key = kt + lane;
    float s[kRowsPerWarp];
    tile_dots<kRowsPerWarp>(s, qs + warp * kRowsPerWarp * kDMax, ks,
                            present ? p.Dh : 0, lane);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = row0 + i;
      const bool valid = (!p.causal || key <= row) &&
                         (p.window <= 0 || key > row - p.window);
      s[i] = valid ? cap(s[i] * p.scale, p.softcap) : kMask;
    }
    st.update(s, present, vs, n_keys, p.Dv, lane);
  }

  float* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < p.Dv) ob[row * p.o_ss + d] = st.out(i, c);
    }
  }
}

}  // namespace

extern "C" int sfp_flash_attention_fwd(
    const float* q, const float* k, const float* v, float* o, int B, int Sq,
    int Skv, int Hq, int Hkv, int Dh, int Dv, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float softcap,
    float scale, int kv_len, void* stream) {
  FaParams p{q,    k,    v,    o,    B,    Sq,   Skv,  Hq,   Hkv,
             Dh,   Dv,   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
             v_ss, v_sh, o_sb, o_ss, o_sh, causal, window, softcap,
             scale, kv_len};
  if (B > 0 && Sq > 0) {
    dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
    flash_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
