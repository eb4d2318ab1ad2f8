// Slot-cache decode attention (f32, bf16 or f16 in, fp32 math) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/decode.py::
// decode_attention_fwd. One query token per slot attends to that slot's
// ring-buffer cache of W entries: key w of slot b and kv head hk is read
// at k + b * k_sb + w * k_sw + hk * k_sh, in the model's (B, W, Hkv, Dh)
// layout through strides (no moveaxis, no pad copy).
//
// What bounds it: per (slot, kv head) the work is about 4 * G * Dh flops a
// key against 2 * Dh * 4 bytes of K and V, so it is bound by the bytes of
// the keys that count (Qwen2.5-14B at 8 slots of 512, the lengths of
// chip_smoke.py: 53 of 128 (slot, tile) pairs valid, 13.9 MB, 4.1 us at
// 3.35 TB/s) and, with so little work, by the latency of the longest
// row's chain of tiles. The design is the paged kernel's (the parts both
// share are in decode_common.cuh), without a page table:
//
// 1. Tiles with no valid key are skipped, decided by data. A key is valid
//    when its position kp satisfies kp >= 0, kp <= q_pos and, with a
//    window, kp > q_pos - window. A block first reads its slot's W
//    positions straight from kv_pos[b, :], one key a lane; a
//    __ballot_sync gives each 32-key tile its valid-key mask in shared
//    memory, and warp 0 lists the tiles whose mask is not 0, in ring order.
//    Nothing is assumed about where valid keys lie: a wrapped ring, or a
//    window across the ring's seam, flags whichever tiles hold them.
//    Skipping is exact: a masked score is the finite -2^30 of the plain
//    version, and once a row's max is a real score exp(-2^30 - m) is 0 in
//    fp32, so a tile whose keys are all masked adds nothing (inside a
//    visited tile, masked keys still take -2^30, as in plain).
// 2. A row with NO valid key (a slot unused since the cache was made, its
//    positions all -1): there every score is -2^30, the plain version's
//    max is -2^30 itself and every key gets weight exp(0) = 1, so its
//    answer is the mean of the slot's W values, whatever K holds. Such a
//    row takes all W / 32 tiles, balanced over the splits like any other
//    row, and copies and folds V only: no score is computed and no K is
//    read, which halves its bytes and keeps it off the launch's longest
//    chain. Each split returns m = -2^30 and the count of its keys as l,
//    and the combine's weights exp(m_s - max m) are all 1, so the merged
//    answer is that mean to fp32 rounding.
// 3. Balanced split-K. Grid (Hkv, B, S): block (hk, b, s) takes the s-th
//    contiguous share, in rank order, of row b's listed tiles. S is a
//    function of shapes only (the wrapper's `decode_splits`: the smallest S
//    giving every SM the blocks its shared memory holds, three at head dims
//    up to 128 and groups up to 8, at most kMaxSplits and the tile count;
//    7 at 8 slots x 8 kv heads, 2 at 8 x 32), so no device sync is
//    needed. With S > 1 a block writes its
//    unnormalized (m, l, acc[Dv]) per query row to the wrapper's workspace
//    (B, Hq, S, Dv + 2) and decode_combine_kernel, launched next on the
//    same stream, merges the splits; a split with no tiles writes l = 0
//    and is ignored. With S = 1 the block writes the output itself.
// 4. cp.async double-buffered K/V tiles: while a tile is folded, the next
//    listed tile's rows are in flight, warp w copying keys w, w + 4, ...,
//    one 16-byte chunk a lane (two at head dims above 128). The query
//    rows arrive the same way during
//    the flag pass. A cache whose base or strides are not multiples of 4
//    floats takes a 4-byte-copy instantiation; the entry point picks, and
//    the host never falls back.
//
// q (and the output) and the cache may each be f32, bf16 or f16 (see
// decode_common.cuh): the kernel is instantiated per cache dtype, the
// query load and the output store branch on q's.
//
// Inside a tile one lane scores one key against its warp's query rows on
// the fp32 SIMT pipe (four warps of two rows for G = Hq / Hkv <= 8, of
// four for G <= 16, so each tile is read once per GQA group). Head dims up
// to 256: the shapes of decode_common.cuh. Softcap applies before the
// mask. Keys past W are ABSENT: p = 0 and out of the max.

#include "decode_common.cuh"

namespace {

using namespace sfp;

struct DecParams {
  const void* q;     // of dtype q_dtype, as the output (out.o_dtype)
  const void* k;     // of the kernel's cache type
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  DecodeOut out;
  int W, Hkv, Dh, n_tiles;
  long long q_sb, q_sh, k_sb, k_sw, k_sh, v_sb, v_sw, v_sh;
  long long qp_sb, kvp_sb, kvp_sw;
  int window;
  float softcap, scale;
};

template <int kD, int kR, bool kVec16, class TKV>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecParams p) {
  using Sh = DecodeShape<kD, kR>;
  extern __shared__ __align__(16) float smem[];
  const DecodeSmem<kD, kR> sm(smem, p.n_tiles);
  __shared__ int n_valid_tiles;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = p.out.Hq / p.Hkv;
  const int qp = p.q_pos[b * p.qp_sb];

  // the group's query rows arrive during the flag pass
  load_queries<kD, kR>(sm.qs, p.q, p.out.o_dtype,
                       b * p.q_sb + hk * G * p.q_sh, p.q_sh, G, p.Dh, tid);

  // 1. flag every tile that holds a valid key, one key a lane, and list
  // them
  const int* pb = p.kv_pos + b * p.kvp_sb;
#pragma unroll 4
  for (int t = warp; t < p.n_tiles; t += kWarps) {
    const int w = t * kBK + lane;
    const bool valid =
        w < p.W && key_valid(__ldg(pb + w * p.kvp_sw), qp, p.window);
    const unsigned bits = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) sm.vmask[t] = bits;
  }
  __syncthreads();
  list_valid_tiles(sm.vmask, sm.tl, p.n_tiles, &n_valid_tiles, warp, lane);
  __syncthreads();

  // 2. this split's share of the listed tiles; a row with none takes every
  // tile, V only
  const bool idle = n_valid_tiles == 0;
  const int n = idle ? p.n_tiles : n_valid_tiles;
  const int lo = n * split / p.out.S, hi = n * (split + 1) / p.out.S;

  // 3. the copy of the r-th tile of the walk into `stage`: warp w takes
  // keys w, w + 4, ..., one 16-byte chunk a lane of every 128 columns
  const TKV* kb = static_cast<const TKV*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const TKV* vb = static_cast<const TKV*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int dh4 = (p.Dh + 3) / 4, dv4 = (p.out.Dv + 3) / 4;
  auto issue = [&](int r, int stage) {
    const int t = idle ? r : sm.tl[r];
#pragma unroll
    for (int i = 0; i < kBK / kWarps; ++i) {
      const int j = warp + kWarps * i, w = t * kBK + j;
      const bool present = w < p.W;
      const long long o = present ? w : 0;
      if (!idle)
        copy_row<kVec16, Sh::kChunks>(sm.ks + stage * Sh::kStage +
                                          j * Sh::kLD,
                                      kb + o * p.k_sw, present ? p.Dh : 0,
                                      dh4, lane);
      copy_row<kVec16, Sh::kChunks>(sm.vs + stage * Sh::kStage + j * Sh::kLD,
                                    vb + o * p.v_sw, present ? p.out.Dv : 0,
                                    dv4, lane);
    }
  };

  DecodeRows<kD, kR> rows;
  const bool active = warp * kR < G;  // a warp with a query head
  walk_tiles(lo, hi, issue, [&](int r, int stage) {
    if (!active) return;
    const int t = idle ? r : sm.tl[r];
    rows.fold(sm.qs, sm.ks + stage * Sh::kStage, sm.vs + stage * Sh::kStage,
              sm.ps, sm.vmask[t], t * kBK + lane < p.W, dh4, dv4, p.scale,
              p.softcap, warp, lane);
  });
  if (active) rows.store(p.out, b, hk, G, split, warp, lane);
}

template <int kD, int kR, bool kVec16, class TKV>
struct DecodeKernel {
  static auto fn() { return decode_kernel<kD, kR, kVec16, TKV>; }
};

}  // namespace

// q and o of dtype q_dtype, k and v of dtype kv_dtype (kF32, kBF16
// or kF16);
// strides in elements of each tensor's own dtype.
extern "C" int sfp_decode_attention_fwd(
    const void* q, int q_dtype, const void* k, const void* v, int kv_dtype,
    const int* q_pos, const int* kv_pos, void* o, float* ws, int B, int W,
    int Hq, int Hkv, int Dh, int Dv, int S, long long q_sb, long long q_sh,
    long long k_sb,
    long long k_sw, long long k_sh, long long v_sb, long long v_sw,
    long long v_sh, long long qp_sb, long long kvp_sb, long long kvp_sw,
    long long o_sb, long long o_sh, int window, float softcap, float scale,
    void* stream) {
  if (Dh > kDMax || Dv > kDMax || Hkv <= 0 || Hq % Hkv ||
      Hq / Hkv > kDecodeMaxGroup || S < 1 || S > kMaxSplits ||
      (S > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || W <= 0) return (int)cudaGetLastError();
  const int n_tiles = (W + kBK - 1) / kBK;
  const DecodeOut out{o, ws, B, Hq, S, Dv, o_sb, o_sh, q_dtype};
  DecParams p{q,    k,    v,    q_pos, kv_pos, out,  W,      Hkv,
              Dh,   n_tiles,    q_sb,  q_sh,   k_sb, k_sw,   k_sh,
              v_sb, v_sw, v_sh, qp_sb, kvp_sb, kvp_sw, window, softcap,
              scale};
  // Vector copies need every K and V row aligned to one: 16 bytes (4 f32)
  // or 8 bytes (4 bf16 or f16), the bases and the strides in units of 4
  // values
  const unsigned long long addr = reinterpret_cast<unsigned long long>(k) |
                                  reinterpret_cast<unsigned long long>(v);
  const long long strides = k_sb | k_sw | k_sh | v_sb | v_sw | v_sh;
  const bool vec =
      addr % (kv_dtype == kF32 ? 16 : 8) == 0 && strides % 4 == 0;
  return (int)launch_decode_shape<DecodeKernel>(
      p, Dh, Dv, Hq / Hkv, vec, kv_dtype, Hkv, n_tiles, out,
      (cudaStream_t)stream);
}
