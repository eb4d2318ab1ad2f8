// GQA prefill attention (f32 in, fp32 accuracy) for Hopper (sm_90a), on
// the tensor cores through 3xTF32 mma.sync; the C entry point below also
// takes bf16 and f16, for flash_attention_16.cu's kernel.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd: causal or not, GQA, sliding window, softcap and a
// kv_len past which keys are absent, over q (B, Sq, Hq, Dh) and k, v
// (B, Skv, Hkv, Dh / Dv) read in place through their strides.
//
// Bounds on an H100 SXM (3.35 TB/s; 495 TFLOP/s dense TF32, so 165 TFLOP/s
// for fp32-accurate products in three TF32 passes):
//   Qwen2.5-14B (1, 132, 40 / 8 x 128), causal: 0.180 GFLOP, 6.49 MB
//     -> 0.00194 ms, bytes;
//   ViT-Base (16, 213, 12 x 64), non-causal:    2.230 GFLOP, 41.9 MB
//     -> 0.0135 ms, operations;
//   whisper-base cross-attention, Sq 1 over 1500 frames (4 x 8 x 64):
//     24.6 MB -> 0.00734 ms, bytes;
//   whisper-base encoder (4, 1500, 8 x 64): 18.4 GFLOP -> 0.1117 ms,
//     operations;
//   zamba2 (1, 132, 32 x 80), causal:           0.090 GFLOP, 5.41 MB
//     -> 0.00161 ms, bytes;
//   gemma2-9b (1, 132, 16 / 8 x 256), causal:  0.144 GFLOP, 6.49 MB
//     -> 0.00194 ms, bytes;
//   stablelm-12b (1, 132, 32 / 8 x 160):       0.180 GFLOP, 6.76 MB
//     -> 0.00202 ms, bytes;
//   nemotron-4-340b (1, 132, 96 / 8 x 192):    0.647 GFLOP, 21.1 MB
//     -> 0.00629 ms, bytes.
// The 495 TFLOP/s is wgmma's; the mma.sync this kernel issues is slower
// on the card (csrc/mma_probe.cu, timed by chip_smoke.py phase 3), so its
// own ceiling is a third of that probe's rate.
//
// Common to both f32 layouts: QK^T and PV run on mma.sync.m16n8k8 TF32
// with the 3xTF32 split (mma_tf32.cuh), so fp32 accuracy is kept (against
// the plain version the output moves by a few 1e-6, inside the tests'
// 2e-5). Fragments are 16-byte loads: QK^T takes the head dims of a
// 16-column pair in a permuted k order (k = t <-> dims 4t and 4t + 2, k =
// t + 4 <-> 4t + 1 and 4t + 3, for A and B alike), so one load serves two
// k-steps; Q and K rows are XOR-swizzled (16-byte chunk c of an odd row at
// c ^ 4) so no load conflicts. P never leaves registers: QK^T leaves
// thread (g, t) holding keys 2t and 2t + 1 of rows g and g + 8, and PV
// reads them as its A fragment by taking k = t as key 2t and k = t + 4 as
// key 2t + 1, the same permutation applied to V's rows, which leaves the
// sum over keys unchanged. The online softmax runs on the accumulator
// fragments with two quad shuffles a row and tile; row sums are reduced
// once, at the end. K/V tiles of 32 keys stream through a ring of
// shared-memory buffers by cp.async, the next tiles in flight while one
// folds (16-byte copies when every base pointer and stride is a multiple
// of 4 floats, else 4-byte copies; the entry point chooses). Q is split
// into its TF32 halves once; K and V stay plain f32 in shared memory and
// are split in registers as they are loaded. The loops run a width class's
// whole width (zero columns past Dh and Dv, zero rows past the tile's keys),
// with no branch inside, so ptxas interleaves their independent products.
//
// The narrow layout (flash_narrow_kernel<ND>, head widths up to 160 in
// five classes of ND 8-column steps: 4, 8, 10, 16 and 20). A block holds
// `rows` rows (16, 32 or 64, prefill_plan's choice; 4 x rows threads);
// each 16-row tile has two warps, one for each 16-key half of every tile,
// whose softmax states merge at the end. What the design does about the
// limits of the 64-row layout it replaced (one grid of (ceil(Sq / 64), Hq,
// B) for every call):
//  1. A plan that fills the card. prefill_plan takes 64, 32 or 16 rows by
//     the shapes (a short prompt's heads: fewer rows, more blocks), and a
//     key split where the blocks still do not fill the SMs while the keys
//     run to many tiles (whisper's cross-attention: 1 or 64 queries of 32
//     (b, h) rows over 1500 frames). Split s of S walks the s-th
//     contiguous share of the block's tiles and writes its rows'
//     unnormalised (m, l, acc) to a (B, Sq, Hq, S, Dv + 2) workspace,
//     which the decode kernels' decode_combine_kernel (decode_common.cuh)
//     merges, launched next on the stream, rows (b, s) standing for its
//     slots.
//  2. K/V read once a GQA group. A block may take `group` query heads of
//     one kv head (the plan's choice: all G of a group): row m of the
//     block is query position q0 + m / group of head h0 + m % group, so
//     the G heads' rows stack in the M dimension and each K/V tile is
//     copied and split once for all of them, not once a head. A row tile
//     then spans 16 / G positions, so a causal block's diagonal wastes
//     less.
//  3. Q's TF32 halves in registers (ND up to 16: 2 x ND registers a
//     thread), split once as the wide layout does; no small-half tiles in
//     shared memory. A block is Q's rows and two K and V buffers: 82,944
//     bytes at ND 16 and 32 rows, so two blocks share an SM. At ND 20
//     (stablelm-12b's 160) Q's halves and o[20][4] would pass 255
//     registers: Q's halves stay in shared memory there, split once by the
//     block. Up to ND 10 the block holds three K/V buffers, two tiles in
//     flight (1-3% faster than two at whisper's and ViT's head dim 64),
//     and QK^T sums each n8 tile in two accumulators, even and odd
//     16-column pairs, so four chains of products are in flight (1-6%).
// A causal grid runs its query blocks last-first, the longest first.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/time_prefill.py --only
// f32narrow, parent and change in turns), device ms, the 64-row layout's in
// brackets, f32 SDPA's after: whisper-base cross-attention, Sq 1 over 1500
// frames, 0.0167 (0.1234), 0.1731; Sq 64, 0.0344 (0.1501), 0.1735; its
// encoder (4, 1500, 8 x 64) 0.5175 (0.5966), 0.5841; qwen2-vl-72b (2, 132,
// 64 / 8 x 128) 0.0413 (0.0758), 0.0604; Qwen2.5-14B 0.0205 (0.0262),
// 0.0240; ViT-Base (16, 213, 12 x 64) 0.0855 (0.1076), 0.1071.
//
// The wide layout (flash_wide_kernel<ND, NV>: keys of class ND 24 for head
// dim 192 or 32 for 256, values of class NV, ND or 16 for MLA's 192 / 128).
// The narrow layout does not fit there (o[ND][4] alone 128 registers at
// ND 32). What the design does about the three limits of the wide kernel
// it replaced (8 warps over 64 rows, both warps of a row tile scoring all
// 32 keys):
//  1. QK^T once a row tile. Each 16-row tile has four warps, and they
//     split the head dims: warp w takes the 16-column pairs w, w + 4, ...
//     (a quarter of Dh) for all 32 keys of a tile, so the four partial
//     16 x 32 score tiles sum to QK^T. They meet in shared memory under a
//     named barrier of the row tile's 128 threads: warp w sums the four
//     partials of n8 key tile w in a fixed order and finishes them (scale,
//     softcap, masks on edge tiles), and after a second barrier every warp
//     reads all four finished tiles, so the four run the same online
//     softmax (bitwise the same m and l). PV splits V's columns: warp w
//     takes the 16-column groups w, w + 4, ... (n8 tile 2i + j takes V
//     column 16m + 2c + j as its column c: one 8-byte load of each of two
//     rows holds both tiles' B fragments). Splitting the head dims rather
//     than the keys keeps each warp's Q in registers: a key split makes
//     every warp read all of Q's halves a tile (32 KB a warp at ND 32).
//     The exchange (10 KB a row tile) reuses the row tile's Q rows once Q
//     is in registers.
//  2. TF32 splits once. Q is split into its halves once, into registers
//     (2 x 8 x ND / 8 registers: 48 at ND 24, 64 at ND 32). K and V stay
//     plain f32 in shared memory and are split in registers as loaded; in
//     a row tile each K and V value is loaded by one warp only, so at 16
//     rows every value is split once a block. Splitting by the block into
//     small-half tiles would cost 49,664 (ND 24) to 66,048 (ND 32) more
//     bytes and the second block an SM, for nothing at 16 rows. P is split
//     by each warp (all 32 keys feed its columns).
//  3. A plan that fills the card. prefill_plan gives 16 rows (8 x rows
//     threads, two K/V cp.async buffers of 32 keys: 95,232 bytes at ND 24
//     / NV 16, 111,616 at 24 / 24, 148,480 at 32 / 32; two blocks an SM
//     at ND 24), or 32 rows for longer prompts whose 32-row grid still
//     fills the card. The grid is (Hq, ceil(Sq / rows), B): a causal call
//     starts the longest query blocks of every head first. The loops run
//     the classes' whole widths (zero columns past Dh and Dv, zero rows
//     past the tile's keys), with no branch inside, so ptxas interleaves
//     their independent products (a first build with a branch a pair, n8
//     tile and column group took 1.34-1.41x these times).
// Bounds at S 132, causal (bytes at 4 B a value over 3.35 TB/s; the
// 3xTF32 products at 165 TFLOP/s take less): deepseek-v3 MLA (1, 132, 64 x
// 192 / 128) 21.6 MB -> 0.00646 ms, at 128 heads 43.3 MB -> 0.0129 ms,
// gemma2-9b 0.00194 ms, nemotron-4-340b 0.00629 ms. Measured (NVIDIA H100
// 80GB HBM3, 700.00 W; tools/time_prefill.py, parent, change, change,
// parent in one run), device ms at S 132, the replaced wide kernel's in
// brackets, f32 SDPA's after: gemma2-9b 0.0182-0.0183 (0.0530-0.0531),
// 0.0344-0.0353; MLA at 64 heads 0.0289 (0.0674-0.0675), 0.0389-0.0396;
// nemotron-4-340b 0.0481-0.0483 (0.0940-0.0942), 0.0709-0.0735; MLA at
// 128 heads 0.0533-0.0535 (0.1027-0.1033), 0.0607-0.0619. Where the time
// goes (tools/prefill_wide_phase_clocks.py, gemma2-9b, the longest block,
// ~5,300 cycles a tile): issuing the next tile's cp.async copies ~2,060
// (a warp issues some 11 bytes a cycle), QK^T ~1,240 and PV ~1,060 (about
// half the mma.sync pipe's rate), the exchange and the softmax ~830. Tried
// and not kept: per-row bulk copies (cp.async.bulk on an mbarrier, issued
// by one warp: 3,770 cycles a tile), a copy warp (one warp issues at a
// third of four warps' rate), copies spread through QK^T (they stall its
// products).
//
// q, k and v are all f32 here. bf16 and f16 q, k and v take the 16-bit
// kernel of flash_attention_16.cu behind the same entry point (16-bit
// tiles by cp.async, QK^T on m16n8k16, P as three bf16 or two f16 terms
// against V on m16n8k16): the entry point dispatches on the dtype code.
//
// Masks use the finite -2^30 of the plain version. A masked key (causal,
// window) scores -2^30 and takes part in the max; an absent key (at or
// past kv_len, or past the tile's end) gets p = 0 and stays out of it.
// Tiles that straddle no edge skip the mask work. Dead tiles are never
// visited, except that a block holding a row every key masks (a sliding
// window that ends before kv_len) visits every tile: that row gets the
// plain version's answer, the mean of v over all kv_len keys (with a key
// split, each split's mean weighted by its count in the combine).

#include "attention_common.cuh"
#include "decode_common.cuh"  // decode_combine_kernel, kMaxSplits
#include "dtype.cuh"
#include "flash_attention_16.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace sfp;

// q, k, v and o (f32), and the narrow layout's key split and GQA group
struct FaParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, Hq, Hkv, Dh, Dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float softcap, scale;
  int kv_len;
  int splits;  // narrow: S key shares a block row (1: no split)
  int group;   // narrow: query heads a block (a divisor of Hq / Hkv)
  float* ws;   // narrow, S > 1: the (B, Sq, Hq, S, Dv + 2) workspace
};

// e^x of a score's difference from its row max (x <= 0, or -inf)
__device__ __forceinline__ float ex(float x) {
  return exp2f(x * 1.4426950408889634f);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Split the four floats of v into TF32 halves.
__device__ __forceinline__ void split4(const float4& v, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split_tf32(v.x, big[0], small[0]);
  split_tf32(v.y, big[1], small[1]);
  split_tf32(v.z, big[2], small[2]);
  split_tf32(v.w, big[3], small[3]);
}

// Copy `rows` rows of `width` floats (a multiple of 4) from src (row
// stride ss) into dst (row stride LD) asynchronously, with `nthr` threads:
// rows at or past n_rows and columns at or past d are zero-filled. kSwz
// stores the 16-byte chunk c of an odd row at c ^ 4 (see the kernels). A
// row takes min(width / unit, nthr) threads, and each steps along the row
// by that many copies, so a row wider than the block's threads (4-byte
// copies) is still covered.
template <int LD, bool kSwz, bool kVec16>
__device__ __forceinline__ void load_rows_n(float* dst, const float* src,
                                            long long ss, int n_rows,
                                            int rows, int d, int width,
                                            int tid, int nthr) {
  constexpr int kUnit = kVec16 ? 4 : 1;  // floats a copy
  const int per_row = width / kUnit, lanes = min(per_row, nthr);
  const int step = nthr / lanes;  // rows a pass
  const int r0 = tid / lanes, c0 = (tid - r0 * lanes) * kUnit;
  if (r0 >= step) return;
  for (int c = c0; c < width; c += lanes * kUnit) {
    const int left = d - c;  // values of the copy below d, as comparisons
    const int bytes = left >= kUnit ? 4 * kUnit : (left > 0 ? 4 * left : 0);
    const float* s = src + r0 * ss + c;
    for (int r = r0; r < rows; r += step, s += step * ss) {
      const int n = r < n_rows ? bytes : 0;
      const int pcol = kSwz ? c ^ ((r & 1) << 4) : c;  // chunk c / 4 ^ 4
      if constexpr (kVec16)
        cp_async16(dst + r * LD + pcol, n ? s : src, n);
      else
        cp_async4(dst + r * LD + pcol, n ? s : src, n);
    }
  }
}

// The narrow layout (see the note at the top): a block of `rows` rows
// (16, 32 or 64; 4 x rows threads), two warps a 16-row tile.
constexpr int kNarrowThr = 256;  // threads of a 64-row block, the largest
// Q's TF32 halves in registers up to this width class; at ND 20 they stay
// in shared memory (see the note at the top).
constexpr int kQRegND = 16;
// K/V stages of the narrow kernel: three up to this width class (two
// tiles in flight while one folds), two above it.
constexpr int kStages3ND = 10;
template <int ND>
constexpr int kNarrowStages = ND <= kStages3ND ? 3 : 2;

// Copy a narrow block's Q rows as load_rows_n does: row r is query
// position q0 + r / group of head h0 + r % group (its own address); rows at
// or past M or Sq and columns at or past Dh are zero-filled.
template <int LD, bool kSwz, bool kVec16>
__device__ __forceinline__ void load_q_rows(float* dst, const float* qb,
                                            const FaParams& p, int q0,
                                            int h0, int M, int rows,
                                            int width, int tid, int nthr) {
  constexpr int kUnit = kVec16 ? 4 : 1;  // floats a copy
  const int per_row = width / kUnit, lanes = min(per_row, nthr);
  const int step = nthr / lanes;  // rows a pass
  const int r0 = tid / lanes, c0 = (tid - r0 * lanes) * kUnit;
  if (r0 >= step) return;
  for (int r = r0; r < rows; r += step) {
    const int i = r / p.group, pos = q0 + i;
    const bool live = r < M && pos < p.Sq;
    const float* s = qb + pos * p.q_ss + (h0 + r - i * p.group) * p.q_sh;
    for (int c = c0; c < width; c += lanes * kUnit) {
      const int left = p.Dh - c;
      const int n =
          !live ? 0 : (left >= kUnit ? 4 * kUnit : (left > 0 ? 4 * left : 0));
      const int pcol = kSwz ? c ^ ((r & 1) << 4) : c;
      if constexpr (kVec16)
        cp_async16(dst + r * LD + pcol, n ? s + c : qb, n);
      else
        cp_async4(dst + r * LD + pcol, n ? s + c : qb, n);
    }
  }
}

// Split n4 float4s of buf into TF32 halves with `nthr` threads: big halves
// in place, small halves to `small` (same layout).
__device__ __forceinline__ void split_rows(float* buf, float* small, int n4,
                                           int tid, int nthr) {
  for (int idx = tid; idx < n4; idx += nthr) {
    uint32_t big[4], sm[4];
    split4(lds4(buf + 4 * idx), big, sm);
    *reinterpret_cast<uint4*>(buf + 4 * idx) =
        make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(small + 4 * idx) =
        make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

// ND: the width class of Q, K and V (8-column steps). Grid (ceil(Sq /
// (rows / group)), Hq / group, B x splits).
template <int ND, bool kVec16>
__global__ void __launch_bounds__(kNarrowThr, 1)
    flash_narrow_kernel(FaParams p) {
  // Q and K rows hold 8 ND floats, their 16-byte chunks XOR-swizzled on odd
  // rows where a row is a multiple of 32 banks (ND % 4 == 0; at ND 10 a row
  // is 20 chunks and odd rows already start 4 chunks over); V rows are
  // padded to 8 ND + 4.
  constexpr int LDK = 8 * ND, LDV = 8 * ND + 4;
  constexpr bool kSwz = ND % 4 == 0;
  constexpr int NP = ND / 2;           // 16-column pairs of k-steps in QK^T
  constexpr int NG = ND / 4;           // 32-column groups of V (4 n8 tiles)
  constexpr bool kHalf = ND % 4 != 0;  // and a last 16-column group (2 tiles)
  constexpr bool kQReg = ND <= kQRegND;
  constexpr int NS = kNarrowStages<ND>;  // K/V buffers
  extern __shared__ __align__(16) float smem[];
  const int nthr = blockDim.x, rows = nthr >> 2;
  float* qs = smem;                 // rows x LDK: Q (its big halves at ND 20)
  float* qsm = qs + rows * LDK;     // rows x LDK: Q's small halves (ND 20)
  float* ks = qs + (kQReg ? 1 : 2) * rows * LDK;  // NS buffers x kBK x LDK
  float* vs = ks + NS * kBK * LDK;                // NS buffers x kBK x LDV

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Warp w runs on scheduler w % 4. The two halves of a row tile go to
  // two schedulers, and in a 64-row block each scheduler holds row tiles 0
  // and 3 or 1 and 2, which a causal block's diagonal loads about evenly.
  const int rg = warp < 4 ? warp >> 1 : 5 - (warp >> 1);
  const int k0 = 16 * (warp & 1);  // first key of this warp's half
  const int QR = rows / p.group;   // query positions a block
  const int M = QR * p.group;      // rows in use
  const int b = blockIdx.z / p.splits, split = blockIdx.z - b * p.splits;
  const int qblk = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qblk * QR, h0 = blockIdx.y * p.group;
  const int hk = h0 / (p.Hq / p.Hkv);

  const int q_last = min(q0 + QR, p.Sq) - 1;
  int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  int kv_end = p.causal ? min(p.kv_len, q_last + 1) : p.kv_len;
  if (p.window > 0 && q_last >= p.kv_len + p.window - 1) {
    kv_begin = 0;  // some row is fully masked: it averages every key
    kv_end = p.kv_len;
  }
  // this split's share of the block's tiles
  const int n_all = (kv_end - kv_begin + kBK - 1) / kBK;
  const int t_lo = split * n_all / p.splits;
  const int t_hi = (split + 1) * n_all / p.splits;

  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  // tile `it` into buffer it % NS
  auto load_kv = [&](int it) {
    const int kt = kv_begin + it * kBK, n_keys = min(kBK, kv_end - kt);
    const int buf = it % NS;
    load_rows_n<LDK, kSwz, kVec16>(ks + buf * kBK * LDK, kb + kt * p.k_ss,
                                   p.k_ss, n_keys, kBK, p.Dh, LDK, tid,
                                   nthr);
    load_rows_n<LDV, false, kVec16>(vs + buf * kBK * LDV, vb + kt * p.v_ss,
                                    p.v_ss, n_keys, kBK, p.Dv, 8 * ND, tid,
                                    nthr);
  };
  load_q_rows<LDK, kSwz, kVec16>(
      qs, static_cast<const float*>(p.q) + b * p.q_sb, p, q0, h0, M, rows,
      LDK, tid, nthr);
  cp_async_commit();
  // the first NS - 1 tiles, a commit group each (empty past t_hi, so the
  // groups in flight keep one count)
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (t_lo + j < t_hi) load_kv(t_lo + j);
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();  // Q has landed; the tiles may be in flight
  __syncthreads();

  // This thread's rows of the warp's m16 tile: m_a = 16 rg + g (C c0/c1)
  // and m_b = m_a + 8 (c2/c3), query positions pos_a and pos_b. A
  // fragment of a 16-column pair p is one 16-byte load of chunk 4p + t; Q
  // rows m_a and m_b and key rows k0 + 8n + g all have g's parity, so one
  // swizzle offset serves them all.
  const int m_a = 16 * rg + g, m_b = m_a + 8;
  const int pos_a = q0 + m_a / p.group, pos_b = q0 + m_b / p.group;
  const bool live_a = m_a < M && pos_a < p.Sq;
  const bool live_b = m_b < M && pos_b < p.Sq;
  // the row tile's first and last query positions
  const int w_lo = q0 + 16 * rg / p.group;
  const int w_hi = q0 + min(16 * rg + 15, M - 1) / p.group;
  const bool active = 16 * rg < M && w_lo < p.Sq;  // else padding rows only
  const int swz = kSwz ? 16 * (g & 1) : 0;
  const int off_even = 4 * t + swz, off_odd = 4 * t - swz;  // chunk 4p + t
  const float* qa = qs + m_a * LDK;
  const float* qm = qsm + m_a * LDK;
  // Q's TF32 halves of pair i: [i][k] holds the float4 of row m_a (k < 4)
  // and of row m_b (k >= 4)
  uint32_t qbig[kQReg ? NP : 1][8], qsmall[kQReg ? NP : 1][8];
  if constexpr (kQReg) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int off = 16 * i + (i & 1 ? off_odd : off_even);
      uint32_t b0[4], m0[4], b8[4], m8[4];
      split4(lds4(qa + off), b0, m0);
      split4(lds4(qa + 8 * LDK + off), b8, m8);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        qbig[i][k] = b0[k];
        qsmall[i][k] = m0[k];
        qbig[i][4 + k] = b8[k];
        qsmall[i][4 + k] = m8[k];
      }
    }
  } else {
    split_rows(qs, qsm, rows * LDK / 4, tid, nthr);  // Q serves every tile
  }
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_ra = kMask, m_rb = kMask, l_a = 0.f, l_b = 0.f;  // l: this lane's
  //                                                          share of the sum
  const float inv_cap = p.softcap > 0.f ? 1.f / p.softcap : 0.f;

  for (int it = t_lo; it < t_hi; ++it) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + NS - 1 < t_hi) load_kv(it + NS - 1);  // where it - 1 was
    cp_async_commit();
    const int kt = kv_begin + it * kBK, n_keys = min(kBK, kv_end - kt);
    // Keys k0 .. k0 + 15 of the tile are this warp's. A half with no
    // present key adds nothing; a causal half past the warp's last row
    // holds only masked keys, which add exactly 0 once a row has seen a
    // key of its own (in this split, or, through the combine, in another).
    if (!active || k0 >= n_keys || (p.causal && kt + k0 > w_hi)) continue;
    const int buf = it % NS;
    const float* kt_s = ks + buf * kBK * LDK + k0 * LDK;
    const float* vt_s = vs + buf * kBK * LDV + k0 * LDV;

    // S = Q K^T: 16 rows x 16 keys, two n8 tiles, each summed in two
    // accumulators (even and odd pairs) so four chains of products are in
    // flight, not two
    float sa[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[h][n][e] = 0.f;
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      const int off = 16 * pp + (pp & 1 ? off_odd : off_even);
      uint32_t a[8], am[8];  // rows m_a (0-3) and m_b (4-7), big and small
      if constexpr (kQReg) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          a[k] = qbig[pp][k];
          am[k] = qsmall[pp][k];
        }
      } else {
        const uint4 x0 = *reinterpret_cast<const uint4*>(qa + off);
        const uint4 x8 = *reinterpret_cast<const uint4*>(qa + 8 * LDK + off);
        const uint4 y0 = *reinterpret_cast<const uint4*>(qm + off);
        const uint4 y8 = *reinterpret_cast<const uint4*>(qm + 8 * LDK + off);
        const uint32_t xa[8] = {x0.x, x0.y, x0.z, x0.w,
                                x8.x, x8.y, x8.z, x8.w};
        const uint32_t ya[8] = {y0.x, y0.y, y0.z, y0.w,
                                y8.x, y8.y, y8.z, y8.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          a[k] = xa[k];
          am[k] = ya[k];
        }
      }
      uint32_t kbig[2][4], ksmall[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        split4(lds4(kt_s + (8 * n + g) * LDK + off), kbig[n], ksmall[n]);
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const uint32_t ab[4] = {a[2 * st], a[4 + 2 * st], a[2 * st + 1],
                                a[5 + 2 * st]};
        const uint32_t as[4] = {am[2 * st], am[4 + 2 * st], am[2 * st + 1],
                                am[5 + 2 * st]};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint32_t bb[2] = {kbig[n][2 * st], kbig[n][2 * st + 1]};
          const uint32_t bs[2] = {ksmall[n][2 * st], ksmall[n][2 * st + 1]};
          mma_tf32(sa[pp & 1][n], as, bb);
          mma_tf32(sa[pp & 1][n], ab, bs);
          mma_tf32(sa[pp & 1][n], ab, bb);
        }
      }
    }

    // scale, softcap and (on edge tiles only) masks; the tile's row max
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = (sa[0][n][e] + sa[1][n][e]) * p.scale;
    if (p.softcap > 0.f) {  // one branch: tanhf only where it is used
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = p.softcap * tanhf(s[n][e] * inv_cap);
    }
    const bool edge = k0 + 16 > n_keys || (p.causal && kt + k0 + 15 > w_lo) ||
                      (p.window > 0 && kt + k0 <= w_hi - p.window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 8 * n + 2 * t + (e & 1), key = kt + j;
          const int row = e < 2 ? pos_a : pos_b;
          if (j >= n_keys)
            s[n][e] = -INFINITY;  // absent
          else if ((p.causal && key > row) ||
                   (p.window > 0 && key <= row - p.window))
            s[n][e] = kMask;      // masked
        }
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }

    // online softmax on the fragments
    const float mn_a = fmaxf(m_ra, mx_a), mn_b = fmaxf(m_rb, mx_b);
    const float alpha_a = ex(m_ra - mn_a), alpha_b = ex(m_rb - mn_b);
    m_ra = mn_a;
    m_rb = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] = ex(s[n][0] - m_ra);
      s[n][1] = ex(s[n][1] - m_ra);
      s[n][2] = ex(s[n][2] - m_rb);
      s[n][3] = ex(s[n][3] - m_rb);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = alpha_a * l_a + sum_a;
    l_b = alpha_b * l_b + sum_b;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }

    // O += P V. P's A fragment is S's C fragment read with k = t as key 2t
    // and k = t + 4 as key 2t + 1; V's B fragment reads its rows in that
    // order. n8 tile 4m + i of a 32-column group m takes V column
    // 32m + 4j + i as its column j, so a thread's B fragments of the four
    // tiles are one 16-byte load from each of rows 2t and 2t + 1, split
    // into TF32 halves as loaded, and its C fragments hold columns
    // 32m + 8t + i (c0, c2) and 32m + 8t + 4 + i (c1, c3). A last 16-column
    // group (ND 10) does the same with 2 tiles.
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ab[4], as[4];
      split_tf32(s[kk][0], ab[0], as[0]);
      split_tf32(s[kk][2], ab[1], as[1]);
      split_tf32(s[kk][1], ab[2], as[2]);
      split_tf32(s[kk][3], ab[3], as[3]);
      const float* vr = vt_s + (8 * kk + 2 * t) * LDV;
#pragma unroll
      for (int m = 0; m < NG; ++m) {
        const int c = 32 * m + 4 * g;
        uint32_t xb[4], xs[4], yb[4], ys[4];
        split4(lds4(vr + c), xb, xs);
        split4(lds4(vr + LDV + c), yb, ys);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t bb[2] = {xb[i], yb[i]};
          mma_tf32(o[4 * m + i], as, bb);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t bs[2] = {xs[i], ys[i]};
          mma_tf32(o[4 * m + i], ab, bs);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t bb[2] = {xb[i], yb[i]};
          mma_tf32(o[4 * m + i], ab, bb);
        }
      }
      if constexpr (kHalf) {
        const int c = 32 * NG + 2 * g;
        const float2 x2 = *reinterpret_cast<const float2*>(vr + c);
        const float2 y2 = *reinterpret_cast<const float2*>(vr + LDV + c);
        uint32_t xb[2], xs[2], yb[2], ys[2];
        split_tf32(x2.x, xb[0], xs[0]);
        split_tf32(x2.y, xb[1], xs[1]);
        split_tf32(y2.x, yb[0], ys[0]);
        split_tf32(y2.y, yb[1], ys[1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t bb[2] = {xb[i], yb[i]};
          mma_tf32(o[4 * NG + i], as, bb);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t bs[2] = {xs[i], ys[i]};
          mma_tf32(o[4 * NG + i], ab, bs);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t bb[2] = {xb[i], yb[i]};
          mma_tf32(o[4 * NG + i], ab, bb);
        }
      }
    }
  }

  // The two key halves of a row tile meet in the spent K and V buffers:
  // the second half's (m, l, O) fragments go to shared memory, laid out by
  // lane, and the first half folds them into its own.
  cp_async_wait<0>();
  __syncthreads();
  float4* mo = reinterpret_cast<float4*>(ks);  // [rg][n][lane]: 512 ND
  float4* ml = reinterpret_cast<float4*>(vs);  // [rg][lane]: m, m, l, l
  if (active && k0) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
      mo[(rg * ND + n) * 32 + lane] =
          make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
    ml[rg * 32 + lane] = make_float4(m_ra, m_rb, l_a, l_b);
  }
  __syncthreads();
  if (!active || k0) return;
  const float4 other = ml[rg * 32 + lane];
  const float mn_a = fmaxf(m_ra, other.x), mn_b = fmaxf(m_rb, other.y);
  const float fa = ex(m_ra - mn_a), fb = ex(m_rb - mn_b);
  const float ga = ex(other.x - mn_a), gb = ex(other.y - mn_b);
  m_ra = mn_a;
  m_rb = mn_b;
  l_a = fa * l_a + ga * other.z;
  l_b = fb * l_b + gb * other.w;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float4 x = mo[(rg * ND + n) * 32 + lane];
    o[n][0] = fa * o[n][0] + ga * x.x;
    o[n][1] = fa * o[n][1] + ga * x.y;
    o[n][2] = fb * o[n][2] + gb * x.z;
    o[n][3] = fb * o[n][3] + gb * x.w;
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  // Without a split the rows are normalised into the output; with one,
  // row (b, pos, head)'s split goes unnormalised to the workspace:
  // m, l, then acc.
  const int head_a = h0 + m_a - (m_a / p.group) * p.group;
  const int head_b = h0 + m_b - (m_b / p.group) * p.group;
  float *da, *db;
  float sa = 1.f, sb = 1.f;
  if (p.splits == 1) {
    float* ob = static_cast<float*>(p.o) + b * p.o_sb;
    da = ob + pos_a * p.o_ss + head_a * p.o_sh;
    db = ob + pos_b * p.o_ss + head_b * p.o_sh;
    sa = 1.f / fmaxf(l_a, 1e-30f);
    sb = 1.f / fmaxf(l_b, 1e-30f);
  } else {
    const long long ra =
        ((static_cast<long long>(b) * p.Sq + pos_a) * p.Hq + head_a) *
            p.splits + split;
    const long long rb =
        ((static_cast<long long>(b) * p.Sq + pos_b) * p.Hq + head_b) *
            p.splits + split;
    da = p.ws + ra * (p.Dv + 2);
    db = p.ws + rb * (p.Dv + 2);
    if (t == 0) {
      if (live_a) {
        da[0] = m_ra;
        da[1] = l_a;
      }
      if (live_b) {
        db[0] = m_rb;
        db[1] = l_b;
      }
    }
    da += 2;
    db += 2;
  }
  auto put_out = [&](int col, int n, int c) {
    if (col >= p.Dv) return;
    if (live_a) da[col] = o[n][c] * sa;
    if (live_b) db[col] = o[n][c + 2] * sb;
  };
#pragma unroll
  for (int m = 0; m < NG; ++m) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      put_out(32 * m + 8 * t + i, 4 * m + i, 0);
      put_out(32 * m + 8 * t + 4 + i, 4 * m + i, 1);
    }
  }
  if constexpr (kHalf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      put_out(32 * NG + 4 * t + i, 4 * NG + i, 0);
      put_out(32 * NG + 4 * t + 2 + i, 4 * NG + i, 1);
    }
  }
}

// The wide layout (see the note at the top): a block of `rows` query rows
// (16 or 32, prefill_plan's choice; 8 x rows threads), four warps a 16-row
// tile. Warp w of a row tile takes the 16-column pairs w, w + 4, ... of
// QK^T, with its Q values' TF32 halves in registers, and the 16-column
// groups w, w + 4, ... of V in PV.
constexpr int kWideWarps = 4;  // warps a 16-row tile
constexpr int kWideThr = 256;  // threads of a 32-row block, the largest

// Wait on a barrier that only the 128 threads of one row tile use.
__device__ __forceinline__ void row_tile_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// ND: the width class of the keys (and of Q); NV: V's (ND, or 16 where
// values of at most 128 sit under keys of class 24, as MLA's). The loops
// run the classes' whole widths, over zero columns past Dh and Dv and zero
// rows past the tile's keys, so no branch splits them and ptxas can
// interleave their independent products.
template <int ND, int NV, bool kVec16>
__global__ void __launch_bounds__(kWideThr, 1)
    flash_wide_kernel(FaParams p) {
  static_assert(ND % (2 * kWideWarps) == 0 && NV % (2 * kWideWarps) == 0,
                "16-column pairs and groups split evenly over four warps");
  constexpr int LDK = 8 * ND, LDV = 8 * NV + 4;
  constexpr int NPW = ND / 8;  // 16-column pairs of QK^T a warp
  constexpr int NGW = NV / 8;  // 16-column groups of V a warp
  // a row tile's exchange: 4 x 4 partial n8 score tiles, then 4 finished
  // ones, as float4s by lane
  constexpr int kExchange = (16 + 4) * 32 * 4;
  static_assert(kExchange <= 16 * LDK, "the exchange fits the Q rows");
  extern __shared__ __align__(16) float smem[];
  const int nthr = blockDim.x, rows = nthr >> 3;
  float* xq = smem;                // rows x LDK: Q, then the exchanges
  float* ks = xq + rows * LDK;     // 2 buffers x kBK x LDK (swizzled)
  float* vs = ks + 2 * kBK * LDK;  // 2 buffers x kBK x LDV

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // row tile rg's four warps run on the four schedulers
  const int rg = warp / kWideWarps, w = warp % kWideWarps;
  // heads on x and query blocks on y, so a causal call starts the longest
  // query blocks (the last) of every head first
  const int h = blockIdx.x, b = blockIdx.z;
  const int qblk = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qblk * rows;
  const int hk = h / (p.Hq / p.Hkv);

  const int q_last = min(q0 + rows, p.Sq) - 1;
  int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  int kv_end = p.causal ? min(p.kv_len, q_last + 1) : p.kv_len;
  if (p.window > 0 && q_last >= p.kv_len + p.window - 1) {
    kv_begin = 0;  // some row is fully masked: it averages every key
    kv_end = p.kv_len;
  }
  const int n_tiles = (kv_end - kv_begin + kBK - 1) / kBK;

  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto load_kv = [&](int it) {
    const int kt = kv_begin + it * kBK, n_keys = min(kBK, kv_end - kt);
    load_rows_n<LDK, true, kVec16>(ks + (it & 1) * kBK * LDK,
                                   kb + kt * p.k_ss, p.k_ss, n_keys, kBK,
                                   p.Dh, 8 * ND, tid, nthr);
    load_rows_n<LDV, false, kVec16>(vs + (it & 1) * kBK * LDV,
                                    vb + kt * p.v_ss, p.v_ss, n_keys, kBK,
                                    p.Dv, 8 * NV, tid, nthr);
  };
  load_rows_n<LDK, true, kVec16>(
      xq,
      static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss,
      p.q_ss, p.Sq - q0, rows, p.Dh, 8 * ND, tid, nthr);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; tile 0 may be in flight
  __syncthreads();

  // rows g and g + 8 of the row tile; fragments as in the narrow kernel
  // (chunk 4p + t of a 16-column pair p, one swizzle offset)
  const int w_lo = q0 + 16 * rg, w_hi = w_lo + 15;
  const int row_a = w_lo + g, row_b = row_a + 8;
  const bool active = w_lo < p.Sq;  // a row tile of padding rows only loads
  const int swz = 16 * (g & 1);
  const int off_even = 4 * t + swz, off_odd = 4 * t - swz;
  // Q's TF32 halves of this warp's pairs w + 4i, split once: [i][k] holds
  // the float4 of row g (k < 4) and of row g + 8 (k >= 4)
  uint32_t qb[NPW][8], qm[NPW][8];
  {
    const float* qa = xq + (16 * rg + g) * LDK;
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      const int pp = w + kWideWarps * i;
      const int off = 16 * pp + (pp & 1 ? off_odd : off_even);
      uint32_t b0[4], m0[4], b8[4], m8[4];
      split4(lds4(qa + off), b0, m0);
      split4(lds4(qa + 8 * LDK + off), b8, m8);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        qb[i][k] = b0[k];
        qm[i][k] = m0[k];
        qb[i][4 + k] = b8[k];
        qm[i][4 + k] = m8[k];
      }
    }
  }
  float o[2 * NGW][4];
#pragma unroll
  for (int n = 0; n < 2 * NGW; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kMask, m_b = kMask, l_a = 0.f, l_b = 0.f;  // l: this lane's
  //                                                        share of the sum
  // the row tile's exchange, in its Q rows (Q is in registers by now)
  float4* part = reinterpret_cast<float4*>(xq + rg * 16 * LDK);  // [w][n][lane]
  float4* fin = part + 16 * 32;                                   // [n][lane]

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    // tile `it` has landed; every warp is done with tile it - 1 and with
    // its exchange
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_kv(it + 1);  // into the buffer tile it - 1 used
      cp_async_commit();
    }
    const int kt = kv_begin + it * kBK, n_keys = min(kBK, kv_end - kt);
    // a causal tile past the row tile's last row holds only masked keys,
    // which add exactly 0 once a row has seen a key of its own; the four
    // warps decide together (they meet at barriers)
    if (!active || (p.causal && kt > w_hi)) continue;
    const float* kt_s = ks + (it & 1) * kBK * LDK;
    const float* vt_s = vs + (it & 1) * kBK * LDV;

    // this warp's share of S = Q K^T: its pairs, all 32 keys (four n8
    // tiles)
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      const int pp = w + kWideWarps * i;
      const int off = 16 * pp + (pp & 1 ? off_odd : off_even);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t kbig[4], ksmall[4];
        split4(lds4(kt_s + (8 * n + g) * LDK + off), kbig, ksmall);
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const uint32_t ab[4] = {qb[i][2 * st], qb[i][4 + 2 * st],
                                  qb[i][2 * st + 1], qb[i][5 + 2 * st]};
          const uint32_t as[4] = {qm[i][2 * st], qm[i][4 + 2 * st],
                                  qm[i][2 * st + 1], qm[i][5 + 2 * st]};
          const uint32_t bb[2] = {kbig[2 * st], kbig[2 * st + 1]};
          const uint32_t bs[2] = {ksmall[2 * st], ksmall[2 * st + 1]};
          mma_tf32(s[n], as, bb);
          mma_tf32(s[n], ab, bs);
          mma_tf32(s[n], ab, bb);
        }
      }
    }

    // The partials meet: warp w sums the four of n8 tile w (keys 8w ..
    // 8w + 7) in a fixed order and finishes them (scale, softcap and, on
    // edge tiles only, masks); the finished tiles meet, so every warp
    // holds the same scores.
#pragma unroll
    for (int n = 0; n < 4; ++n)
      part[(w * 4 + n) * 32 + lane] =
          make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    row_tile_sync(1 + rg);
    float4 x = part[w * 32 + lane];
#pragma unroll
    for (int u = 1; u < kWideWarps; ++u) {
      const float4 y = part[(u * 4 + w) * 32 + lane];
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    float f[4] = {x.x * p.scale, x.y * p.scale, x.z * p.scale, x.w * p.scale};
    if (p.softcap > 0.f) {  // one branch: tanhf only where it is used
      const float inv_cap = 1.f / p.softcap;  // a product, not a division
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = p.softcap * tanhf(f[e] * inv_cap);
    }
    const int j0 = 8 * w;  // this warp's n8 tile of keys
    const bool edge = j0 + 8 > n_keys || (p.causal && kt + j0 + 7 > w_lo) ||
                      (p.window > 0 && kt + j0 <= w_hi - p.window);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 2 * t + (e & 1), key = kt + j;
        const int row = e < 2 ? row_a : row_b;
        if (j >= n_keys)
          f[e] = -INFINITY;  // absent
        else if ((p.causal && key > row) ||
                 (p.window > 0 && key <= row - p.window))
          f[e] = kMask;      // masked
      }
    }
    fin[w * 32 + lane] = make_float4(f[0], f[1], f[2], f[3]);
    row_tile_sync(1 + rg);
    float sc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 y = fin[n * 32 + lane];
      sc[n][0] = y.x;
      sc[n][1] = y.y;
      sc[n][2] = y.z;
      sc[n][3] = y.w;
    }

    // online softmax on the fragments (the same in the four warps)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(sc[n][0], sc[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = ex(m_a - mn_a), alpha_b = ex(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      sc[n][0] = ex(sc[n][0] - m_a);
      sc[n][1] = ex(sc[n][1] - m_a);
      sc[n][2] = ex(sc[n][2] - m_b);
      sc[n][3] = ex(sc[n][3] - m_b);
      sum_a += sc[n][0] + sc[n][1];
      sum_b += sc[n][2] + sc[n][3];
    }
    l_a = alpha_a * l_a + sum_a;
    l_b = alpha_b * l_b + sum_b;
#pragma unroll
    for (int n = 0; n < 2 * NGW; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }

    // O += P V over this warp's groups m = w + 4i of V, each k8 step of
    // keys as in the narrow kernel (P's A fragment from S's C fragment,
    // V's rows 2t and 2t + 1); n8 tile 2i + j takes V column 16m + 2c + j
    // as its column c, so a thread's B fragments of both tiles are one
    // 8-byte load from each of the two rows
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ab[4], as[4];
      split_tf32(sc[kk][0], ab[0], as[0]);
      split_tf32(sc[kk][2], ab[1], as[1]);
      split_tf32(sc[kk][1], ab[2], as[2]);
      split_tf32(sc[kk][3], ab[3], as[3]);
      const float* vr = vt_s + (8 * kk + 2 * t) * LDV;
#pragma unroll
      for (int i = 0; i < NGW; ++i) {
        const int c = 16 * (w + kWideWarps * i) + 2 * g;
        const float2 x2 = *reinterpret_cast<const float2*>(vr + c);
        const float2 y2 = *reinterpret_cast<const float2*>(vr + LDV + c);
        uint32_t xb[2], xs[2], yb[2], ys[2];
        split_tf32(x2.x, xb[0], xs[0]);
        split_tf32(x2.y, xb[1], xs[1]);
        split_tf32(y2.x, yb[0], ys[0]);
        split_tf32(y2.y, yb[1], ys[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t bb[2] = {xb[j], yb[j]};
          mma_tf32(o[2 * i + j], as, bb);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t bs[2] = {xs[j], ys[j]};
          mma_tf32(o[2 * i + j], ab, bs);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t bb[2] = {xb[j], yb[j]};
          mma_tf32(o[2 * i + j], ab, bb);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  auto put_out = [&](int col, int n, int c) {
    if (col >= p.Dv) return;
    if (row_a < p.Sq) put(ob + row_a * p.o_ss + col, o[n][c] * inv_a);
    if (row_b < p.Sq) put(ob + row_b * p.o_ss + col, o[n][c + 2] * inv_b);
  };
#pragma unroll
  for (int i = 0; i < NGW; ++i) {
    const int m = w + kWideWarps * i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      put_out(16 * m + 4 * t + j, 2 * i + j, 0);
      put_out(16 * m + 4 * t + 2 + j, 2 * i + j, 1);
    }
  }
}

// Widths from this ND up take the wide layout.
constexpr int kWideND = 24;

// Dynamic shared memory of a narrow block of width class ND and `rows`
// rows (see the note at the top): Q's rows (plain, or its two halves at ND
// 20) and kNarrowStages<ND> K and V buffers.
template <int ND>
constexpr int narrow_bytes32(int rows) {
  return ((ND <= kQRegND ? 1 : 2) * rows * 8 * ND +
          kNarrowStages<ND> * kBK * (8 * ND + 8 * ND + 4)) *
         static_cast<int>(sizeof(float));
}

// Dynamic shared memory of a wide block of `rows` query rows, keys of
// class ND and values of class NV: Q (whose rows then hold the row tiles'
// exchanges) and two K and V buffers.
template <int ND, int NV>
constexpr int wide_bytes32(int rows) {
  return (rows * 8 * ND + 2 * kBK * (8 * ND + 8 * NV + 4)) *
         static_cast<int>(sizeof(float));
}

// The bytes prefill_plan (kernels/flash_attention/kernel.py) computes for
// each width class and row count at 4 B a value;
// tests/test_torch_prefill_plan.py reads these lines.
static_assert(narrow_bytes32<4>(64) == 34304, "ND 4, 64 rows");
static_assert(narrow_bytes32<4>(32) == 30208, "ND 4, 32 rows");
static_assert(narrow_bytes32<4>(16) == 28160, "ND 4, 16 rows");
static_assert(narrow_bytes32<8>(64) == 67072, "ND 8, 64 rows");
static_assert(narrow_bytes32<8>(32) == 58880, "ND 8, 32 rows");
static_assert(narrow_bytes32<8>(16) == 54784, "ND 8, 16 rows");
static_assert(narrow_bytes32<10>(64) == 83456, "ND 10, 64 rows");
static_assert(narrow_bytes32<10>(32) == 73216, "ND 10, 32 rows");
static_assert(narrow_bytes32<10>(16) == 68096, "ND 10, 16 rows");
static_assert(narrow_bytes32<16>(64) == 99328, "ND 16, 64 rows");
static_assert(narrow_bytes32<16>(32) == 82944, "ND 16, 32 rows");
static_assert(narrow_bytes32<16>(16) == 74752, "ND 16, 16 rows");
static_assert(narrow_bytes32<20>(64) == 164864, "ND 20, 64 rows");
static_assert(narrow_bytes32<20>(32) == 123904, "ND 20, 32 rows");
static_assert(narrow_bytes32<20>(16) == 103424, "ND 20, 16 rows");
static_assert(wide_bytes32<24, 16>(16) == 95232, "ND 24, NV 16, 16 rows");
static_assert(wide_bytes32<24, 16>(32) == 107520, "ND 24, NV 16, 32 rows");
static_assert(wide_bytes32<24, 24>(16) == 111616, "ND 24, 16 rows");
static_assert(wide_bytes32<24, 24>(32) == 123904, "ND 24, 32 rows");
static_assert(wide_bytes32<32, 32>(16) == 148480, "ND 32, 16 rows");
static_assert(wide_bytes32<32, 32>(32) == 164864, "ND 32, 32 rows");

// The narrow kernel, `rows` (16, 32 or 64) rows a block of 4 x rows
// threads, `group` query heads a block; grid (ceil(Sq / (rows / group)),
// Hq / group, B x splits). With splits > 1 the combine follows on the
// stream, reading the workspace as (B Sq, Hq) rows of S splits.
template <int ND, bool kVec16>
cudaError_t launch_narrow(const FaParams& p, int rows, cudaStream_t stream) {
  static_assert(narrow_bytes32<ND>(kNarrowThr / 4) <= 232448,
                "over the shared memory a block may have");
  const int bytes = narrow_bytes32<ND>(rows);
  void (*kernel)(FaParams) = flash_narrow_kernel<ND, kVec16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  // all of the SM's 228 KB as shared memory, so several blocks fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int qr = rows / p.group;
  const dim3 grid((p.Sq + qr - 1) / qr, p.Hq / p.group, p.B * p.splits);
  kernel<<<grid, 4 * rows, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const DecodeOut out{p.o,        p.ws,   p.B * p.Sq, p.Hq, p.splits,
                      p.Dv,       p.o_ss, p.o_sh,     kF32};
  decode_combine_kernel<<<(p.B * p.Sq * p.Hq + kWarps - 1) / kWarps,
                          kThreads, 0, stream>>>(out);
  return cudaGetLastError();
}

// The wide kernel, `rows` (16 or 32) query rows a block of 8 x rows
// threads; grid (Hq, ceil(Sq / rows), B).
template <int ND, int NV, bool kVec16>
cudaError_t launch_wide(const FaParams& p, int rows, cudaStream_t stream) {
  static_assert(wide_bytes32<ND, NV>(kWideThr / 8) <= 232448,
                "over the shared memory a block may have");
  const int bytes = wide_bytes32<ND, NV>(rows);
  void (*kernel)(FaParams) = flash_wide_kernel<ND, NV, kVec16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hq, (p.Sq + rows - 1) / rows, p.B);
  kernel<<<grid, 8 * rows, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool kVec16>
cudaError_t launch_width(const FaParams& p, int rows, cudaStream_t stream) {
  const int d8 = (max(p.Dh, p.Dv) + 7) / 8;
  if (d8 > 20) {  // the wide layout: width classes kWideND and 32
    if (rows != 16 && rows != 32) return cudaErrorInvalidValue;
    if (d8 > kWideND)  // gemma2's 256
      return launch_wide<32, 32, kVec16>(p, rows, stream);
    if (p.Dv <= 128)  // MLA's 192 / 128
      return launch_wide<24, 16, kVec16>(p, rows, stream);
    return launch_wide<24, 24, kVec16>(p, rows, stream);  // nemotron's
  }
  // the narrow plan: 16, 32 or 64 rows, a group dividing G and at most
  // the rows, 1 to kMaxSplits splits (a workspace and a contiguous output
  // past one)
  const int G = p.Hq / p.Hkv;
  if ((rows != 16 && rows != 32 && rows != 64) || p.group < 1 ||
      G % p.group || rows < p.group || p.splits < 1 ||
      p.splits > kMaxSplits ||
      (p.splits > 1 &&
       (!p.ws || p.o_sb != static_cast<long long>(p.Sq) * p.o_ss)))
    return cudaErrorInvalidValue;
  if (d8 <= 4) return launch_narrow<4, kVec16>(p, rows, stream);
  if (d8 <= 8) return launch_narrow<8, kVec16>(p, rows, stream);
  if (d8 <= 10) return launch_narrow<10, kVec16>(p, rows, stream);  // 80
  if (d8 <= 16) return launch_narrow<16, kVec16>(p, rows, stream);
  return launch_narrow<20, kVec16>(p, rows, stream);  // stablelm's 160
}

}  // namespace

// q, k, v and o all of dtype `dtype` (kF32, kBF16 or kF16); strides in
// elements; `rows` the rows a block (prefill_plan's choice: at f32 64, 32
// or 16 below width class kWideND and 32 or 16 from it, at 16 bits 64, 32
// or 16); narrow f32 only: `splits` key shares a block row (workspace
// `ws` of (B, Sq, Hq, splits, Dv + 2) floats past 1) and `group` query
// heads a block.
extern "C" int sfp_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int Hq, int Hkv, int Dh, int Dv, long long q_sb,
    long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float softcap,
    float scale, int kv_len, int rows, int splits, int group, void* ws,
    void* stream) {
  if (Dh > kDMax || Dv > kDMax) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
  // 16-byte copies need every row of q, k and v to start 16-byte aligned:
  // the bases, and the strides in 16-byte units (4 f32, or 8 bf16 or f16)
  const unsigned long long addr = reinterpret_cast<unsigned long long>(q) |
                                  reinterpret_cast<unsigned long long>(k) |
                                  reinterpret_cast<unsigned long long>(v);
  const long long strides = q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb |
                            v_ss | v_sh;
  const bool vec =
      addr % 16 == 0 && strides % (dtype == kF32 ? 4 : 8) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype != kF32) {
    const Prefill16Params p16{
        q,    k,    v,    o,    B,    Sq,   Skv,  Hq,     Hkv,    Dh,
        Dv,   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   v_ss,   v_sh,
        o_sb, o_ss, o_sh, causal, window, softcap, scale, kv_len, rows};
    return (int)flash16_fwd(p16, dtype, vec, st);
  }
  FaParams p{q,      k,     v,      o,    B,    Sq,     Skv,   Hq,
             Hkv,    Dh,    Dv,     q_sb, q_ss, q_sh,   k_sb,  k_ss,
             k_sh,   v_sb,  v_ss,   v_sh, o_sb, o_ss,   o_sh,  causal,
             window, softcap, scale, kv_len, splits, group,
             static_cast<float*>(ws)};
  return (int)(vec ? launch_width<true>(p, rows, st)
                   : launch_width<false>(p, rows, st));
}
