// Paged decode attention (f32, bf16 or f16 in, fp32 math) for Hopper (sm_90a).
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
//    shapes only (the wrapper's `decode_splits`: the smallest S giving every
//    SM the blocks its shared memory holds, three at head dims up to 128
//    and groups up to 8, at most kMaxSplits and the tile count), so no
//    device sync is needed. A block writes its
//    unnormalized (m, l, acc[Dv]) per query row to the wrapper's workspace
//    (B, Hq, S, Dv + 2), and decode_combine_kernel, launched next on
//    the same stream from the same entry point, merges the splits; a split
//    with no tiles writes l = 0 and is ignored. With S = 1 the block writes
//    the output itself and no combine is launched.
// 3. cp.async double-buffered K/V tiles. While a tile's scores and values
//    are folded in, the next valid tile's K and V rows are already in
//    flight: warp w copies keys w, w + 4, ..., its lane i resolving the
//    page of the i-th of them from the table (__ldg) and the warp sharing
//    it by shuffles, then issuing each row as one 16-byte cp.async a lane
//    (two at head dims above 128). The query rows arrive the same way,
//    during the flag pass. Shared rows have stride kD + 4 floats: copies
//    stay 16-byte aligned and each lane's float4 read of its own key row
//    hits distinct banks in every quarter warp. Two stages of K and V are
//    67.6 KB at kD 128 (72.7 KB a block in all), so shared memory is
//    dynamic (decode_common.cuh has every shape's). A pool whose base or
//    strides are
//    not multiples of 4 floats takes a 4-byte-copy instantiation instead;
//    the entry point picks, and the host never falls back.
//
// q (and the output) and the pool may each be f32, bf16 or f16 (see
// decode_common.cuh): the kernel is instantiated per pool dtype, the query
// load and the output store branch on q's. Each tensor's strides are in
// its own elements: the engines pair a bf16 q with an f32 pool.
//
// Inside a tile one lane scores one key against its warp's query rows (a
// block is four warps of two rows each for G = Hq / Hkv <= 8, of four for
// G <= 16, so each tile is read once per GQA group) on the fp32 SIMT pipe,
// in four partial sums a row; the weights go through shared memory, and
// each lane owns four output columns of every 128 of the value sum (head
// dims up to 256: the shapes of decode_common.cuh). Softcap applies before the mask. Keys
// past the table's width are ABSENT: p = 0 and out of the max.
//
// On the H100 a block's time is a fixed cost (launch, the flag pass's two
// dependent reads, the first tile's copy) plus, a tile, its copy and its
// fold, which overlap little: deeper pipelines (3 or 4 stages), eight
// warps a block and a producer warp issuing every copy measured no faster,
// so the long rows' chains are cut by splitting instead (PERF.md).
//
// The parts both decode kernels share are in decode_common.cuh.
//
// The table's values index the pool and are not range-checked here (that
// would need a device sync in the wrapper): the paged engine only ever
// writes page ids it allocated from a pool of P pages.

#include "decode_common.cuh"

namespace {

using namespace sfp;

struct PagedParams {
  const void* q;     // of dtype out.o_dtype, as the output
  const void* k;     // of the kernel's pool type
  const void* v;
  const int* tables;
  const int* q_pos;
  const int* kv_pos;
  DecodeOut out;
  int nb, page, Hkv, Dh, n_tiles;
  long long q_sb, q_sh;
  long long k_sp, k_so, k_sh, v_sp, v_so, v_sh;
  long long bt_sb, bt_sn, qp_sb, kvp_sp, kvp_so;
  int window;
  float softcap, scale;
};

template <int kD, int kR, bool kVec16, class TKV>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(PagedParams p) {
  using Sh = DecodeShape<kD, kR>;
  extern __shared__ __align__(16) float smem[];
  const DecodeSmem<kD, kR> sm(smem, p.n_tiles);
  __shared__ int n_valid_tiles;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = p.out.Hq / p.Hkv;
  const int width = p.nb * p.page;
  const int* bt = p.tables + b * p.bt_sb;
  const int qp = p.q_pos[b * p.qp_sb];

  // the group's query rows arrive during the flag pass
  load_queries<kD, kR>(sm.qs, p.q, p.out.o_dtype,
                       b * p.q_sb + hk * G * p.q_sh, p.q_sh, G, p.Dh, tid);

  // 1. flag every tile that holds a valid key, one key a lane, and list
  // them
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
    if (lane == 0) sm.vmask[t] = bits;
  }
  __syncthreads();
  list_valid_tiles(sm.vmask, sm.tl, p.n_tiles, &n_valid_tiles, warp, lane);
  __syncthreads();

  // 2. this split's share of the valid tiles; a row with none walks every
  // tile in split 0, as the plain version does
  const bool walk_all = n_valid_tiles == 0;
  const int n = walk_all ? p.n_tiles : n_valid_tiles;
  const int lo = walk_all ? 0 : n * split / p.out.S;
  const int hi = walk_all ? (split == 0 ? n : 0) : n * (split + 1) / p.out.S;

  // 3. the copy of the r-th tile of the walk into `stage`: warp w takes
  // keys w, w + 4, ...; its lane i resolves the page of the i-th of them,
  // and the warp copies each key's rows, one 16-byte chunk a lane of
  // every 128 columns
  const int dh4 = (p.Dh + 3) / 4, dv4 = (p.out.Dv + 3) / 4;
  const TKV* kp = static_cast<const TKV*>(p.k);
  const TKV* vp = static_cast<const TKV*>(p.v);
  auto issue = [&](int r, int stage) {
    constexpr int kKeys = kBK / kWarps;
    const int t = walk_all ? r : sm.tl[r];
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
      copy_row<kVec16, Sh::kChunks>(
          sm.ks + stage * Sh::kStage + j * Sh::kLD,
          kp + pk * p.k_sp + o * p.k_so + hk * p.k_sh, present ? p.Dh : 0,
          dh4, lane);
      copy_row<kVec16, Sh::kChunks>(
          sm.vs + stage * Sh::kStage + j * Sh::kLD,
          vp + pk * p.v_sp + o * p.v_so + hk * p.v_sh,
          present ? p.out.Dv : 0, dv4, lane);
    }
  };

  DecodeRows<kD, kR> rows;
  const bool active = warp * kR < G;  // a warp with a query head
  walk_tiles(lo, hi, issue, [&](int r, int stage) {
    if (!active) return;
    const int t = walk_all ? r : sm.tl[r];
    rows.fold(sm.qs, sm.ks + stage * Sh::kStage, sm.vs + stage * Sh::kStage,
              sm.ps, sm.vmask[t], t * kBK + lane < width, dh4, dv4, p.scale,
              p.softcap, warp, lane);
  });
  if (active) rows.store(p.out, b, hk, G, split, warp, lane);
}

template <int kD, int kR, bool kVec16, class TKV>
struct PagedKernel {
  static auto fn() { return paged_decode_kernel<kD, kR, kVec16, TKV>; }
};

}  // namespace

// q and o of dtype q_dtype, the pools of dtype kv_dtype (kF32, kBF16
// or kF16);
// strides in elements of each tensor's own dtype.
extern "C" int sfp_paged_decode_attention_fwd(
    const void* q, int q_dtype, const void* k, const void* v, int kv_dtype,
    const int* tables, const int* q_pos, const int* kv_pos, void* o,
    float* ws, int B, int nb, int page, int Hq, int Hkv, int Dh, int Dv,
    int S, long long q_sb, long long q_sh, long long k_sp, long long k_so,
    long long k_sh, long long v_sp, long long v_so, long long v_sh, long long bt_sb,
    long long bt_sn, long long qp_sb, long long kvp_sp, long long kvp_so,
    long long o_sb, long long o_sh, int window, float softcap, float scale,
    void* stream) {
  if (Dh > kDMax || Dv > kDMax || Hkv <= 0 || Hq % Hkv ||
      Hq / Hkv > kDecodeMaxGroup || S < 1 || S > kMaxSplits ||
      (S > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || nb <= 0 || page <= 0) return (int)cudaGetLastError();
  const int n_tiles = (nb * page + kBK - 1) / kBK;
  const DecodeOut out{o, ws, B, Hq, S, Dv, o_sb, o_sh, q_dtype};
  PagedParams p{q,    k,    v,      tables, q_pos,  kv_pos, out,
                nb,   page, Hkv,    Dh,     n_tiles, q_sb,  q_sh,
                k_sp, k_so, k_sh,   v_sp,   v_so,   v_sh,   bt_sb,
                bt_sn, qp_sb, kvp_sp, kvp_so, window, softcap, scale};
  // Vector copies need every K and V row aligned to one: 16 bytes (4 f32)
  // or 8 bytes (4 bf16 or f16), the bases and the strides in units of 4
  // values
  const unsigned long long addr = reinterpret_cast<unsigned long long>(k) |
                                  reinterpret_cast<unsigned long long>(v);
  const long long strides = k_sp | k_so | k_sh | v_sp | v_so | v_sh;
  const bool vec =
      addr % (kv_dtype == kF32 ? 16 : 8) == 0 && strides % 4 == 0;
  return (int)launch_decode_shape<PagedKernel>(
      p, Dh, Dv, Hq / Hkv, vec, kv_dtype, Hkv, n_tiles, out,
      (cudaStream_t)stream);
}
