// Paged decode attention (fp32) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/decode.py::
// paged_decode_attention_fwd. One query token per slot attends to that
// slot's keys, which live in a shared PAGE POOL: logical width index w of
// slot b sits at offset w % page of physical page block_tables[b, w / page].
// The pool is read in the model's (P, page, Hkv, Dh) layout through
// strides (no moveaxis, no gather, no pad copy), and any page >= 1 works:
// a page need not fill or align with a tile.
//
// What bounds it: per (slot, kv head) the work is about 4 * G * Dh flops a
// key against 2 * Dh * 4 bytes of K and V, so it is bound by the bytes of
// the keys that count (Qwen2.5-14B at 16 slots: 16.8 MB of valid tiles, 5
// us at 3.35 TB/s) and, with so little work, by the latency of the longest
// row's chain of tiles. The design does three things about that.
//
// 1. Tiles with no valid key are skipped, decided by data. A key is valid
//    when its position kp satisfies kp >= 0, kp <= q_pos and, with a
//    window, kp > q_pos - window. A block first reads the positions of all
//    of its row's keys through the table (int32, 1/256 of the row's K/V
//    bytes at Dh 128), one key a lane; a __ballot_sync gives each 32-key
//    tile its valid-key mask, kept in shared memory (so no position is read
//    again), and warp 0 lists the tiles whose mask is not 0, in order.
//    Nothing is assumed about where valid keys lie, so ring order, stale
//    positions and windows stay correct. Skipping is exact: a masked score
//    is the finite -2^30 of the plain version, and once a row's max is a
//    real score exp(-2^30 - m) is 0 in fp32, so a tile whose keys are all
//    masked adds nothing (inside a visited tile, masked keys still take
//    -2^30, as in plain). A row with NO valid key anywhere (all its pages
//    NULL, say) is the one case skipping would change: there the plain
//    version's max is -2^30 itself and it returns the mean of every value
//    of the table. Such a row walks every tile, in split 0 alone, exactly
//    as plain does, and returns that mean.
// 2. Balanced split-K. Grid (Hkv, B, S): block (hk, b, s) takes the s-th
//    contiguous share, in rank order, of row b's VALID tiles (not of its
//    width: the engine's rows are short in a wide table, so equal width
//    ranges would leave one split with all the work). S is a function of
//    shapes only (the wrapper's `paged_splits`: the smallest S giving every
//    SM the three blocks its shared memory holds, at most kMaxSplits and
//    the tile count), so no device sync is needed. A block writes its
//    unnormalized (m, l, acc[Dv]) per query row to the wrapper's workspace
//    (B, Hq, S, Dv + 2), and paged_decode_combine_kernel, launched next on
//    the same stream from the same entry point, merges the splits; a split
//    with no tiles writes l = 0 and is ignored. With S = 1 the block writes
//    the output itself and no combine is launched.
// 3. cp.async double-buffered K/V tiles. While a tile's scores and values
//    are folded in, the next valid tile's K and V rows are already in
//    flight: warp w copies keys w, w + 4, ..., its lane i resolving the
//    page of the i-th of them from the table (__ldg) and the warp sharing
//    it by shuffles, then issuing each row as one 16-byte cp.async a lane.
//    The query rows arrive the same way, during the flag pass. Shared rows
//    have stride kDMax + 4 floats: copies stay 16-byte aligned and each
//    lane's float4 read of its own key row hits distinct banks in every
//    quarter warp. Two stages of K and V are 67.6 KB (72.7 KB a block in
//    all), so shared memory is dynamic. A pool whose base or strides are
//    not multiples of 4 floats takes a 4-byte-copy instantiation instead;
//    the entry point picks, and the host never falls back.
//
// Inside a tile one lane scores one key against its warp's query rows (a
// block is four warps of two rows each, G = Hq / Hkv <= 8, so each tile is
// read once per GQA group) on the fp32 SIMT pipe, in four partial sums a
// row; the weights go through shared memory, and each lane owns four
// output columns of the value sum. Softcap applies before the mask. Keys
// past the table's width are ABSENT: p = 0 and out of the max.
//
// On the H100 a block's time is a fixed cost (launch, the flag pass's two
// dependent reads, the first tile's copy) plus, a tile, its copy and its
// fold, which overlap little: deeper pipelines (3 or 4 stages), eight
// warps a block and a producer warp issuing every copy measured no faster,
// so the long rows' chains are cut by splitting instead (PERF.md).
//
// The table's values index the pool and are not range-checked here (that
// would need a device sync in the wrapper): the paged engine only ever
// writes page ids it allocated from a pool of P pages.

#include "attention_common.cuh"
#include "mma_tf32.cuh"  // the cp.async helpers

namespace {

using namespace sfp;

constexpr int kRowsPerWarp = 2;
constexpr int kMaxGroup = kWarps * kRowsPerWarp;
constexpr int kMaxSplits = 8;
constexpr int kLD = kDMax + 4;  // shared row stride of a K or V tile
constexpr int kStage = kBK * kLD;
constexpr int kStages = 2;      // K/V tiles in shared memory
constexpr size_t kFixedSmem =
    (kMaxGroup * (kDMax + kBK) + 2 * kStages * kStage) * sizeof(float);

struct PagedParams {
  const float* q;
  const float* k;
  const float* v;
  const int* tables;
  const int* q_pos;
  const int* kv_pos;
  float* o;
  float* ws;
  int B, nb, page, Hq, Hkv, Dh, Dv, S, n_tiles;
  long long q_sb, q_sh;
  long long k_sp, k_so, k_sh, v_sp, v_so, v_sh;
  long long bt_sb, bt_sn, qp_sb, kvp_sp, kvp_so, o_sb, o_sh;
  int window;
  float softcap, scale;
};

__device__ __forceinline__ bool key_valid(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

// Copy one row of n floats to shared memory as `chunks` (<= 32) 16-byte
// chunks, one a lane, zero-filling past n. No loop: a loop here, inlined
// for every key of every tile copy, swelled the kernel's code several
// times over and slowed it.
template <bool kVec16>
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n,
                                         int chunks, int lane) {
  if (lane >= chunks) return;
  const int c = 4 * lane;
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

template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(PagedParams p) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // kMaxGroup rows of kDMax
  float* ks = qs + kMaxGroup * kDMax;  // kStages tiles of kBK rows of kLD
  float* vs = ks + kStages * kStage;
  float* ps = vs + kStages * kStage;   // a tile's weights, by warp row
  // per tile of the table: the valid-key mask (bit j: key j), and the
  // list of tiles holding a valid key
  unsigned* vmask = reinterpret_cast<unsigned*>(ps + kMaxGroup * kBK);
  int* tl = reinterpret_cast<int*>(vmask + p.n_tiles);
  __shared__ int n_valid_tiles;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int width = p.nb * p.page;
  const int* bt = p.tables + b * p.bt_sb;
  const int qp = p.q_pos[b * p.qp_sb];

  // the group's query rows, zero past Dh so dots read whole float4s; the
  // copy is in flight during the flag pass and lands with the first tile
  const float* qb = p.q + b * p.q_sb + hk * G * p.q_sh;
  for (int idx = tid; idx < kMaxGroup * kDMax; idx += kThreads) {
    const int g = idx / kDMax, d = idx % kDMax;
    const bool in = g < G && d < p.Dh;
    cp_async4(qs + idx, in ? qb + g * p.q_sh + d : qb, in ? 4 : 0);
  }
  cp_async_commit();

  // 1. flag every tile that holds a valid key, one key a lane
#pragma unroll 4
  for (int t = warp; t < p.n_tiles; t += kWarps) {
    const int w = t * kBK + lane;
    bool valid = false;
    if (w < width) {
      const int blk = w / p.page, off = w - blk * p.page;
      const long long pid = __ldg(bt + blk * p.bt_sn);
      valid = key_valid(__ldg(p.kv_pos + pid * p.kvp_sp + off * p.kvp_so),
                        qp, p.window);
    }
    const unsigned bits = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) vmask[t] = bits;
  }
  __syncthreads();
  // ... and list the tiles that hold one, in order
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < p.n_tiles; base += 32) {
      const int t = base + lane;
      const bool f = t < p.n_tiles && vmask[t] != 0u;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) tl[count + __popc(m & ((1u << lane) - 1u))] = t;
      count += __popc(m);
    }
    if (lane == 0) n_valid_tiles = count;
  }
  __syncthreads();

  // 2. this split's share of the valid tiles; a row with none walks every
  // tile in split 0, as the plain version does
  const bool walk_all = n_valid_tiles == 0;
  const int n = walk_all ? p.n_tiles : n_valid_tiles;
  const int lo = walk_all ? 0 : n * split / p.S;
  const int hi = walk_all ? (split == 0 ? n : 0) : n * (split + 1) / p.S;

  // 3. the copy of the r-th tile of the walk into `stage`: warp w takes
  // keys w, w + 4, ...; its lane i resolves the page of the i-th of them,
  // and the warp copies each key's rows, one 16-byte chunk a lane
  const int dh4 = (p.Dh + 3) / 4, dv4 = (p.Dv + 3) / 4;
  auto issue = [&](int r, int stage) {
    constexpr int kKeys = kBK / kWarps;
    const int t = walk_all ? r : tl[r];
    int pid = 0, off = -1;  // off -1: the key lies past the table's width
    if (lane < kKeys) {
      const int w = t * kBK + warp + kWarps * lane;
      if (w < width) {
        const int blk = w / p.page;
        off = w - blk * p.page;
        pid = __ldg(bt + blk * p.bt_sn);
      }
    }
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int j = warp + kWarps * i;
      const long long pk = __shfl_sync(0xffffffffu, pid, i);
      const int ok = __shfl_sync(0xffffffffu, off, i);
      const bool present = ok >= 0;
      const long long o = present ? ok : 0;
      copy_row<kVec16>(ks + stage * kStage + j * kLD,
                       p.k + pk * p.k_sp + o * p.k_so + hk * p.k_sh,
                       present ? p.Dh : 0, dh4, lane);
      copy_row<kVec16>(vs + stage * kStage + j * kLD,
                       p.v + pk * p.v_sp + o * p.v_so + hk * p.v_sh,
                       present ? p.Dv : 0, dv4, lane);
    }
  };

  const int g0 = warp * kRowsPerWarp;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kMask;
    l[i] = 0.f;  // this lane's share of the row sum, reduced at the end
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  // kStages - 1 tiles in flight ahead of the one being folded in
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
    if (g0 < G) {
      const int t = walk_all ? r : tl[r];
      const float* kt = ks + stage * kStage;
      const float* vt = vs + stage * kStage;
      const bool present = t * kBK + lane < width;
      const bool valid = (vmask[t] >> lane) & 1u;
      // this lane's key against the warp's rows, four partial sums a row
      float s[kRowsPerWarp][4] = {};
      const float* kr = kt + lane * kLD;
      for (int c = 0; c < dh4; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * c);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + (g0 + i) * kDMax + 4 * c);
          s[i][0] = fmaf(qv.x, kv.x, s[i][0]);
          s[i][1] = fmaf(qv.y, kv.y, s[i][1]);
          s[i][2] = fmaf(qv.z, kv.z, s[i][2]);
          s[i][3] = fmaf(qv.w, kv.w, s[i][3]);
        }
      }
      float sc[kRowsPerWarp], mx[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float dot = (s[i][0] + s[i][1]) + (s[i][2] + s[i][3]);
        sc[i] = valid ? cap(dot * p.scale, p.softcap) : kMask;
        mx[i] = present ? sc[i] : -INFINITY;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
      float* pw = ps + warp * kRowsPerWarp * kBK;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float m_new = fmaxf(m[i], mx[i]);
        const float alpha = expf(m[i] - m_new);
        const float pr = present ? expf(sc[i] - m_new) : 0.f;
        l[i] = alpha * l[i] + pr;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
        m[i] = m_new;
        pw[i * kBK + lane] = pr;
      }
      __syncwarp();
      // the values: each lane owns four columns, the weights are read
      // four keys at a time from shared memory
      if (lane < dv4) {
        const float* vc = vt + 4 * lane;
#pragma unroll
        for (int j = 0; j < kBK; j += 4) {
          float4 pj[kRowsPerWarp];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            pj[i] = *reinterpret_cast<const float4*>(pw + i * kBK + j);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 vv =
                *reinterpret_cast<const float4*>(vc + (j + u) * kLD);
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
              const float pu = u == 0   ? pj[i].x
                               : u == 1 ? pj[i].y
                               : u == 2 ? pj[i].z
                                        : pj[i].w;
              acc[i][0] = fmaf(pu, vv.x, acc[i][0]);
              acc[i][1] = fmaf(pu, vv.y, acc[i][1]);
              acc[i][2] = fmaf(pu, vv.z, acc[i][2]);
              acc[i][3] = fmaf(pu, vv.w, acc[i][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is read before the next copy lands in it
  }
  cp_async_wait<0>();

  if (g0 >= G) return;  // a warp with no query head of this group
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int g = g0 + i;
    const float li = warp_sum(l[i]);
    if (g >= G) continue;
    const int h = hk * G + g;
    if (p.S == 1) {
      float* ob = p.o + b * p.o_sb + h * p.o_sh;
      const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * lane + e;
        if (d < p.Dv) ob[d] = acc[i][e] * inv;
      }
    } else {
      float* wb = p.ws + ((static_cast<long long>(b) * p.Hq + h) * p.S +
                          split) * (p.Dv + 2);
      if (lane == 0) {
        wb[0] = m[i];
        wb[1] = li;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * lane + e;
        if (d < p.Dv) wb[2 + d] = acc[i][e];
      }
    }
  }
}

// Merge the S splits of each (slot, query head) row: one warp a row, lanes
// over the value columns. A split with l = 0 visited no tile.
__global__ void __launch_bounds__(kThreads)
    paged_decode_combine_kernel(PagedParams p) {
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
  float* ob = p.o + b * p.o_sb + h * p.o_sh;
  for (int d = lane; d < p.Dv; d += 32) {
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (f[s] > 0.f) a = fmaf(f[s], wb[s * (p.Dv + 2) + 2 + d], a);
    ob[d] = a * inv;
  }
}

template <bool kVec16>
cudaError_t launch(const PagedParams& p, cudaStream_t stream) {
  const size_t bytes = kFixedSmem + p.n_tiles * 2 * sizeof(int);
  auto* kernel = paged_decode_kernel<kVec16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.Hkv, p.B, p.S), kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.S == 1) return err;
  paged_decode_combine_kernel<<<(p.B * p.Hq + kWarps - 1) / kWarps, kThreads,
                                0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sfp_paged_decode_attention_fwd(
    const float* q, const float* k, const float* v, const int* tables,
    const int* q_pos, const int* kv_pos, float* o, float* ws, int B, int nb,
    int page, int Hq, int Hkv, int Dh, int Dv, int S, long long q_sb,
    long long q_sh, long long k_sp, long long k_so, long long k_sh,
    long long v_sp, long long v_so, long long v_sh, long long bt_sb,
    long long bt_sn, long long qp_sb, long long kvp_sp, long long kvp_so,
    long long o_sb, long long o_sh, int window, float softcap, float scale,
    void* stream) {
  if (Dh > kDMax || Dv > kDMax || Hkv <= 0 || Hq % Hkv ||
      Hq / Hkv > kMaxGroup || S < 1 || S > kMaxSplits ||
      (S > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || nb <= 0 || page <= 0) return (int)cudaGetLastError();
  const int n_tiles = (nb * page + kBK - 1) / kBK;
  PagedParams p{q,      k,      v,      tables, q_pos,  kv_pos, o,
                ws,     B,      nb,     page,   Hq,     Hkv,    Dh,
                Dv,     S,      n_tiles, q_sb,  q_sh,   k_sp,   k_so,
                k_sh,   v_sp,   v_so,   v_sh,   bt_sb,  bt_sn,  qp_sb,
                kvp_sp, kvp_so, o_sb,   o_sh,   window, softcap, scale};
  // 16-byte copies need every K and V row to start 16-byte aligned
  const unsigned long long addr = reinterpret_cast<unsigned long long>(k) |
                                  reinterpret_cast<unsigned long long>(v);
  const long long strides = k_sp | k_so | k_sh | v_sp | v_so | v_sh;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(addr % 16 == 0 && strides % 4 == 0 ? launch<true>(p, st)
                                                  : launch<false>(p, st));
}
