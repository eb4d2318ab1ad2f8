// Paged decode attention (fp32) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/decode.py::
// paged_decode_attention_fwd. One query token per slot attends to that
// slot's keys, which live in a shared PAGE POOL: logical width index w of
// slot b sits at offset w % page of physical page block_tables[b, w / page].
// Per (slot, kv head) the kernel reads the slot's nb * page keys and values
// once and does about 4 * G * nb * page * Dh flops, so it is bound by
// device memory (the pages holding the slot's valid keys) by a wide margin.
//
// On the TPU the block table and the query positions are scalar-prefetch
// operands and the BlockSpec index maps pick each grid step's page. Here
// the block resolves its own pages: grid (Hkv, B), one block per (slot, kv
// head) serving the whole GQA group (G = Hq / Hkv, 5 for Qwen2.5; up to 8,
// two rows per warp), so each page tile is read once per group. It streams
// the slot's logical keys in kBK-key tiles; for every key of a tile one
// thread looks up its page in the table and computes the key's row offsets
// from the pool's strides, so any page_size >= 1 works (a page need not fill
// or align with a tile). The pool is read in the model's (P, page, Hkv, Dh)
// layout through strides: no moveaxis, no gather, no pad copy.
//
// Validity is pure data, as in the plain version (gather, then the dense
// grouped decode): a key counts when its position is >= 0, at or before
// the slot's query position and inside the sliding window; softcap applies
// before the mask, and masked scores take the finite -2^30. Unallocated
// table entries point at the NULL page, whose positions stay -1; idle slots'
// rows point every block at the SCRATCH page, whose output the engine
// discards but which stays finite. The kernel visits every block of the
// table, as the plain version does, so fully masked rows agree with it;
// stopping at q_pos / page is later work.
//
// The table's values index the pool and are not range-checked here (that
// would need a device sync in the wrapper): the paged engine only ever
// writes page ids it allocated from a pool of P pages.
//
// B * Hkv blocks is 128 at 16 slots and 8 kv heads, under one block per SM
// of the card's 132; split-K over the table is later work. On the H100 this
// design takes 2.35x the dense decode kernel on the same data gathered
// (PERF.md): each tile waits on its lookup (table, then positions, one warp
// working) before its K/V loads start. Prefetching the next tile's rows is
// the first thing to try.

#include "attention_common.cuh"

namespace {

using namespace sfp;

constexpr int kRowsPerWarp = 2;
constexpr int kMaxGroup = kWarps * kRowsPerWarp;

struct PagedParams {
  const float* q;
  const float* k;
  const float* v;
  const int* tables;
  const int* q_pos;
  const int* kv_pos;
  float* o;
  int B, nb, page, Hq, Hkv, Dh, Dv;
  long long q_sb, q_sh;
  long long k_sp, k_so, k_sh, v_sp, v_so, v_sh;
  long long bt_sb, bt_sn, qp_sb, kvp_sp, kvp_so, o_sb, o_sh;
  int window;
  float softcap, scale;
};

__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(PagedParams p) {
  __shared__ float qs[kMaxGroup * kDMax];
  __shared__ float ks[kBK * (kDMax + 1)];
  __shared__ float vs[kBK * kDMax];
  __shared__ long long krow[kBK];
  __shared__ long long vrow[kBK];
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
  const int* bt = p.tables + b * p.bt_sb;
  const int width = p.nb * p.page;
  const int g0 = warp * kRowsPerWarp;
  RowState<kRowsPerWarp> st;
  st.init();

  for (int kt = 0; kt < width; kt += kBK) {
    const int n_keys = min(kBK, width - kt);
    __syncthreads();
    if (tid < n_keys) {
      const int w = kt + tid;
      const int blk = w / p.page, off = w - blk * p.page;
      const long long pid = bt[blk * p.bt_sn];
      krow[tid] = pid * p.k_sp + off * p.k_so + hk * p.k_sh;
      vrow[tid] = pid * p.v_sp + off * p.v_so + hk * p.v_sh;
      kvps[tid] = p.kv_pos[pid * p.kvp_sp + off * p.kvp_so];
    }
    __syncthreads();
    for (int idx = tid; idx < n_keys * p.Dh; idx += kThreads) {
      const int j = idx / p.Dh, d = idx - j * p.Dh;
      ks[j * (kDMax + 1) + d] = p.k[krow[j] + d];
    }
    for (int idx = tid; idx < n_keys * p.Dv; idx += kThreads) {
      const int j = idx / p.Dv, d = idx - j * p.Dv;
      vs[j * kDMax + d] = p.v[vrow[j] + d];
    }
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

extern "C" int sfp_paged_decode_attention_fwd(
    const float* q, const float* k, const float* v, const int* tables,
    const int* q_pos, const int* kv_pos, float* o, int B, int nb, int page,
    int Hq, int Hkv, int Dh, int Dv, long long q_sb, long long q_sh,
    long long k_sp, long long k_so, long long k_sh, long long v_sp,
    long long v_so, long long v_sh, long long bt_sb, long long bt_sn,
    long long qp_sb, long long kvp_sp, long long kvp_so, long long o_sb,
    long long o_sh, int window, float softcap, float scale, void* stream) {
  PagedParams p{q,     k,     v,     tables, q_pos,  kv_pos, o,
                B,     nb,    page,  Hq,     Hkv,    Dh,     Dv,
                q_sb,  q_sh,  k_sp,  k_so,   k_sh,   v_sp,   v_so,
                v_sh,  bt_sb, bt_sn, qp_sb,  kvp_sp, kvp_so, o_sb,
                o_sh,  window, softcap, scale};
  if (B > 0 && nb > 0 && page > 0) {
    dim3 grid(Hkv, B);
    paged_decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
