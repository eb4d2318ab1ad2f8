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
// What the design does about the four limits of the SIMT kernel it
// replaced:
//  1. No tensor cores -> QK^T and PV run on mma.sync.m16n8k8 TF32 with the
//     3xTF32 split (mma_tf32.cuh), so fp32 accuracy is kept: against the
//     plain version the output moves by a few 1e-6 at the serving shapes,
//     inside the 2e-5 tolerance of the tests.
//  2. Shared-memory and shuffle issue -> every operand is split into TF32
//     halves once: Q when it lands, each K and V tile by the whole block
//     when it lands (big halves in place, small halves beside them), P in
//     registers. Fragments are 16-byte loads: QK^T takes the head dims of a
//     16-column pair in a permuted k order, and PV permutes V's columns, so
//     one load serves two k-steps or four n8 tiles; rows are XOR-swizzled
//     or padded so no load conflicts. The online softmax runs on the
//     accumulator fragments with two quad shuffles a row and tile; row sums
//     are reduced once, at the end. P never leaves registers: QK^T leaves
//     thread (g, t) holding keys 2t and 2t + 1 of rows g and g + 8, and PV
//     reads them as its A fragment by taking k = t as key 2t and k = t + 4
//     as key 2t + 1, the same permutation applied to V's rows, which leaves
//     the sum over keys unchanged.
//  3. Synchronous loads -> K/V tiles of 32 keys are double-buffered in
//     shared memory with cp.async: tile j + 1 is in flight while tile j
//     computes. 16-byte copies when every base pointer and stride is a
//     multiple of 4 floats, else 4-byte copies (the entry point chooses).
//  4. 16 query rows a block -> 64 rows, so K and V are read 4x less often.
//     A block is 8 warps: each m16 row tile has two, one for each 16-key
//     half of every tile, and the halves' softmax states are merged at the
//     end. That doubles the warps an SM holds at the batch-1 serving
//     shapes (120 and 96 blocks, under one wave) and halves the longest
//     warp's chain of tiles. Grid (ceil(Sq / 64), Hq, B); in a causal call
//     the query blocks run last-first, the longest first.
//
// Head widths up to 160 in five instantiations of ND = 8-column steps
// (4, 8, 10, 16 and 20) take the layout above; tiles are zero-padded
// (cp.async zero-fill) to a multiple of 16 columns for QK^T and of 32 (16
// at ND 10) for PV, as are the tile rows past the tile's keys, so no stale
// shared value reaches an mma. Dynamic shared memory: Q's two halves (2 x
// 64 rows), K and V (two buffers and one small-half tile each), 165,376
// bytes at ND 16 and 206,336 at ND 20 (stablelm-12b's head_dim 160), one
// block an SM.
//
// The wide layout (flash_wide_kernel<ND, NV>: keys of class ND 24 for head
// dim 192 or 32 for 256, values of class NV, ND or 16 for MLA's 192 / 128).
// The layout above does not fit there (247,296 and 329,216 bytes, over the
// 232,448 a block may have; o[ND][4] alone 128 registers at ND 32). What
// the design does about the three limits of the wide kernel it replaced
// (8 warps over 64 rows, both warps of a row tile scoring all 32 keys):
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
// plain version's answer, the mean of v over all kv_len keys.

#include "attention_common.cuh"
#include "dtype.cuh"
#include "flash_attention_16.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace sfp;

// A block is 8 warps over 64 query rows: each m16 row tile has two warps,
// one for each 16-key half of every 32-key tile (see the kernel).
constexpr int kBQ = 64;
constexpr int kThr = 256;

// q, k, v and o of one dtype (the kernel's T: float, the one instantiated)
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
};

// Copy `rows` rows of `width` floats (a multiple of 4) from src (row
// stride ss) into dst (row stride LD) asynchronously: rows at or past
// n_rows and columns at or past d are zero-filled. kSwz stores the 16-byte
// chunk c of an odd row at c ^ 4 (see the kernel). A thread keeps one
// column and steps down the rows, so the division and the column's byte
// count are worked out once a call.
template <int LD, bool kSwz, bool kVec16>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ss, int n_rows, int rows,
                                          int d, int width, int tid) {
  constexpr int kUnit = kVec16 ? 4 : 1;  // floats a copy
  const int per_row = width / kUnit, step = kThr / per_row;  // rows a pass
  const int r0 = tid / per_row, col = (tid - r0 * per_row) * kUnit;
  if (r0 >= step) return;
  const int bytes = 4 * max(0, min(kUnit, d - col));
  const float* s = src + r0 * ss + col;
  for (int r = r0; r < rows; r += step, s += step * ss) {
    const int n = r < n_rows ? bytes : 0;
    const int pcol = kSwz ? col ^ ((r & 1) << 4) : col;  // chunk c ^ 4
    if constexpr (kVec16)
      cp_async16(dst + r * LD + pcol, n ? s : src, n);
    else
      cp_async4(dst + r * LD + pcol, n ? s : src, n);
  }
}

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

// Split n4 float4s of buf into TF32 halves: big halves in place, small
// halves to `small` (same layout).
__device__ __forceinline__ void split_rows(float* buf, float* small, int n4,
                                           int tid) {
  for (int idx = tid; idx < n4; idx += kThr) {
    uint32_t big[4], sm[4];
    split4(lds4(buf + 4 * idx), big, sm);
    *reinterpret_cast<uint4*>(buf + 4 * idx) =
        make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(small + 4 * idx) =
        make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

// Up to head width 64 two blocks share an SM (ptxas caps registers at 128
// for that); wider, the shared memory (or, at 80, the registers without
// spilling) holds one.
template <int ND, bool kVec16, class T>
__global__ void __launch_bounds__(kThr, ND <= 8 ? 2 : 1)
    flash_fwd_kernel(FaParams p) {
  // Q and K rows hold 8 ND floats, their 16-byte chunks XOR-swizzled on odd
  // rows where a row is a multiple of 32 banks (ND % 4 == 0; at ND 10 a row
  // is 20 chunks and odd rows already start 4 chunks over); V rows are
  // padded to 8 ND + 4.
  constexpr int LDK = 8 * ND, LDV = 8 * ND + 4;
  constexpr bool kSwz = ND % 4 == 0;
  constexpr int NP = ND / 2;           // 16-column pairs of k-steps in QK^T
  constexpr int NG = ND / 4;           // 32-column groups of V (4 n8 tiles)
  constexpr bool kHalf = ND % 4 != 0;  // and a last 16-column group (2 tiles)
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // kBQ x LDK: Q's big halves (as bits)
  float* qsm = qs + kBQ * LDK;      // kBQ x LDK: Q's small halves
  float* ks = qsm + kBQ * LDK;      // 2 buffers x kBK x LDK (big halves)
  float* vs = ks + 2 * kBK * LDK;   // 2 buffers x kBK x LDV (big halves)
  float* ksm = vs + 2 * kBK * LDV;  // kBK x LDK: small halves of K's tile
  float* vsm = ksm + kBK * LDK;     // kBK x LDV: small halves of V's tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Warp w runs on scheduler w % 4. The two halves of a row tile go to
  // two schedulers, and each scheduler holds row tiles 0 and 3 or 1 and 2,
  // which a causal block's diagonal loads about evenly.
  const int rg = warp < 4 ? warp >> 1 : 5 - (warp >> 1);
  const int k0 = 16 * (warp & 1);  // first key of this warp's half
  const int qblk = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, q0 = qblk * kBQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int dh16 = (p.Dh + 15) >> 4;
  const int v_width = min(8 * ND, (p.Dv + 31) & ~31);

  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  int kv_end = p.causal ? min(p.kv_len, q_last + 1) : p.kv_len;
  if (p.window > 0 && q_last >= p.kv_len + p.window - 1) {
    kv_begin = 0;  // some row is fully masked: it averages every key
    kv_end = p.kv_len;
  }
  const int n_tiles = (kv_end - kv_begin + kBK - 1) / kBK;

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto load_kv = [&](int it) {
    const int kt = kv_begin + it * kBK, n_keys = min(kBK, kv_end - kt);
    load_rows<LDK, kSwz, kVec16>(ks + (it & 1) * kBK * LDK, kb + kt * p.k_ss,
                                 p.k_ss, n_keys, kBK, p.Dh, 16 * dh16, tid);
    load_rows<LDV, false, kVec16>(vs + (it & 1) * kBK * LDV, vb + kt * p.v_ss,
                                  p.v_ss, n_keys, kBK, p.Dv, v_width, tid);
  };
  load_rows<LDK, kSwz, kVec16>(
      qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss,
      p.q_ss, p.Sq - q0, kBQ, p.Dh, 16 * dh16, tid);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_rows(qs, qsm, kBQ * LDK / 4, tid);  // Q serves every tile

  // This thread's rows of the warp's m16 tile: g (C c0/c1) and g + 8
  // (c2/c3). QK^T takes the head dims of a 16-column pair p as two k-steps
  // with k = t <-> dims 4t and 4t + 2 and k = t + 4 <-> 4t + 1 and 4t + 3
  // (A and B alike), so each fragment is one 16-byte load of chunk 4p + t;
  // q rows 16 rg + g (+ 8) and key rows k0 + 8n + g all have g's parity,
  // so one swizzle offset serves them all.
  const int w_lo = q0 + 16 * rg, w_hi = w_lo + 15;
  const int row_a = w_lo + g, row_b = row_a + 8;
  const bool active = w_lo < p.Sq;  // a warp of padding rows only loads
  const int swz = kSwz ? 16 * (g & 1) : 0;
  const int off_even = 4 * t + swz, off_odd = 4 * t - swz;  // chunk 4p + t
  const float* qa = qs + (16 * rg + g) * LDK;
  const float* qm = qsm + (16 * rg + g) * LDK;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kMask, m_b = kMask, l_a = 0.f, l_b = 0.f;  // l: this lane's
  //                                                        share of the sum

  for (int it = 0; it < n_tiles; ++it) {
    if (it > 0) cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) {
      load_kv(it + 1);  // into the buffer tile it - 1 used
      cp_async_commit();
    }
    // each K and V value is split into TF32 halves once, by one thread
    split_rows(ks + (it & 1) * kBK * LDK, ksm, kBK * LDK / 4, tid);
    split_rows(vs + (it & 1) * kBK * LDV, vsm, kBK * LDV / 4, tid);
    __syncthreads();
    const int kt = kv_begin + it * kBK, n_keys = min(kBK, kv_end - kt);
    // Keys k0 .. k0 + 15 of the tile are this warp's. A half with no
    // present key adds nothing; a causal half past the warp's last row
    // holds only masked keys, which add exactly 0 once a row has seen a
    // key of its own (a tile before this one).
    if (!active || k0 >= n_keys || (p.causal && kt + k0 > w_hi)) continue;
    const float* kt_s = ks + (it & 1) * kBK * LDK + k0 * LDK;
    const float* kt_m = ksm + k0 * LDK;
    const float* vt_s = vs + (it & 1) * kBK * LDV + k0 * LDV;
    const float* vt_m = vsm + k0 * LDV;

    // S = Q K^T: 16 rows x 16 keys, two n8 tiles
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      if (pp < dh16) {
        const int off = 16 * pp + (pp & 1 ? off_odd : off_even);
        const uint4 qb0 = *reinterpret_cast<const uint4*>(qa + off);
        const uint4 qb8 = *reinterpret_cast<const uint4*>(qa + 8 * LDK + off);
        const uint4 qs0 = *reinterpret_cast<const uint4*>(qm + off);
        const uint4 qs8 = *reinterpret_cast<const uint4*>(qm + 8 * LDK + off);
        uint4 kbig[2], ksmall[2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          kbig[n] = *reinterpret_cast<const uint4*>(kt_s + (8 * n + g) * LDK +
                                                    off);
          ksmall[n] = *reinterpret_cast<const uint4*>(
              kt_m + (8 * n + g) * LDK + off);
        }
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const uint32_t ab[4] = {st ? qb0.z : qb0.x, st ? qb8.z : qb8.x,
                                  st ? qb0.w : qb0.y, st ? qb8.w : qb8.y};
          const uint32_t as[4] = {st ? qs0.z : qs0.x, st ? qs8.z : qs8.x,
                                  st ? qs0.w : qs0.y, st ? qs8.w : qs8.y};
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const uint32_t bb[2] = {st ? kbig[n].z : kbig[n].x,
                                    st ? kbig[n].w : kbig[n].y};
            const uint32_t bs[2] = {st ? ksmall[n].z : ksmall[n].x,
                                    st ? ksmall[n].w : ksmall[n].y};
            mma_tf32(s[n], as, bb);
            mma_tf32(s[n], ab, bs);
            mma_tf32(s[n], ab, bb);
          }
        }
      }
    }

    // scale, softcap and (on edge tiles only) masks; the tile's row max
    const bool edge = k0 + 16 > n_keys || (p.causal && kt + k0 + 15 > w_lo) ||
                      (p.window > 0 && kt + k0 <= w_hi - p.window);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = cap(s[n][e] * p.scale, p.softcap);
        if (edge) {
          const int j = k0 + 8 * n + 2 * t + (e & 1), key = kt + j;
          const int row = e < 2 ? row_a : row_b;
          if (j >= n_keys)
            x = -INFINITY;  // absent
          else if ((p.causal && key > row) ||
                   (p.window > 0 && key <= row - p.window))
            x = kMask;      // masked
        }
        s[n][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }

    // online softmax on the fragments
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = ex(m_a - mn_a), alpha_b = ex(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] = ex(s[n][0] - m_a);
      s[n][1] = ex(s[n][1] - m_a);
      s[n][2] = ex(s[n][2] - m_b);
      s[n][3] = ex(s[n][3] - m_b);
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
    // tiles are one 16-byte load from each of rows 2t and 2t + 1, and its
    // C fragments hold columns 32m + 8t + i (c0, c2) and 32m + 8t + 4 + i
    // (c1, c3). A last 16-column group (ND 10) does the same with 2 tiles.
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (k0 + 8 * kk < n_keys) {
        uint32_t ab[4], as[4];
        split_tf32(s[kk][0], ab[0], as[0]);
        split_tf32(s[kk][2], ab[1], as[1]);
        split_tf32(s[kk][1], ab[2], as[2]);
        split_tf32(s[kk][3], ab[3], as[3]);
        const float* vr = vt_s + (8 * kk + 2 * t) * LDV;
        const float* vm = vt_m + (8 * kk + 2 * t) * LDV;
#pragma unroll
        for (int m = 0; m < NG; ++m) {
          if (32 * m < p.Dv) {
            const int c = 32 * m + 4 * g;
            const uint4 xb = *reinterpret_cast<const uint4*>(vr + c);
            const uint4 yb = *reinterpret_cast<const uint4*>(vr + LDV + c);
            const uint4 xs = *reinterpret_cast<const uint4*>(vm + c);
            const uint4 ys = *reinterpret_cast<const uint4*>(vm + LDV + c);
            const uint32_t bb[4][2] = {
                {xb.x, yb.x}, {xb.y, yb.y}, {xb.z, yb.z}, {xb.w, yb.w}};
            const uint32_t bs[4][2] = {
                {xs.x, ys.x}, {xs.y, ys.y}, {xs.z, ys.z}, {xs.w, ys.w}};
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_tf32(o[4 * m + i], as, bb[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_tf32(o[4 * m + i], ab, bs[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_tf32(o[4 * m + i], ab, bb[i]);
          }
        }
        if constexpr (kHalf) {
          if (32 * NG < p.Dv) {
            const int c = 32 * NG + 2 * g;
            const uint2 xb = *reinterpret_cast<const uint2*>(vr + c);
            const uint2 yb = *reinterpret_cast<const uint2*>(vr + LDV + c);
            const uint2 xs = *reinterpret_cast<const uint2*>(vm + c);
            const uint2 ys = *reinterpret_cast<const uint2*>(vm + LDV + c);
            const uint32_t bb[2][2] = {{xb.x, yb.x}, {xb.y, yb.y}};
            const uint32_t bs[2][2] = {{xs.x, ys.x}, {xs.y, ys.y}};
#pragma unroll
            for (int i = 0; i < 2; ++i) mma_tf32(o[4 * NG + i], as, bb[i]);
#pragma unroll
            for (int i = 0; i < 2; ++i) mma_tf32(o[4 * NG + i], ab, bs[i]);
#pragma unroll
            for (int i = 0; i < 2; ++i) mma_tf32(o[4 * NG + i], ab, bb[i]);
          }
        }
      }
    }
  }

  // The two key halves of a row tile meet in the spent K buffers: the
  // second half's (m, l, O) fragments go to shared memory, laid out by
  // lane, and the first half folds them into its own.
  __syncthreads();
  float4* mo = reinterpret_cast<float4*>(ks);   // [rg][n][lane]: 512 ND
  float4* ml = reinterpret_cast<float4*>(ksm);  // [rg][lane]: m, m, l, l
  if (active && k0) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
      mo[(rg * ND + n) * 32 + lane] =
          make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
    ml[rg * 32 + lane] = make_float4(m_a, m_b, l_a, l_b);
  }
  __syncthreads();
  if (!active || k0) return;
  const float4 other = ml[rg * 32 + lane];
  const float mn_a = fmaxf(m_a, other.x), mn_b = fmaxf(m_b, other.y);
  const float fa = ex(m_a - mn_a), fb = ex(m_b - mn_b);
  const float ga = ex(other.x - mn_a), gb = ex(other.y - mn_b);
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
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  auto put_out = [&](int col, int n, int c) {
    if (col >= p.Dv) return;
    if (row_a < p.Sq) put(ob + row_a * p.o_ss + col, o[n][c] * inv_a);
    if (row_b < p.Sq) put(ob + row_b * p.o_ss + col, o[n][c + 2] * inv_b);
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

// Copy `rows` rows of `width` floats (a multiple of 4) as load_rows does,
// with `nthr` threads: a row takes min(width / unit, nthr) threads, and
// each steps along the row by that many copies, so a row wider than the
// block's threads (4-byte copies) is still covered.
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

// Wait on a barrier that only the 128 threads of one row tile use.
__device__ __forceinline__ void row_tile_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// ND: the width class of the keys (and of Q); NV: V's (ND, or 16 where
// values of at most 128 sit under keys of class 24, as MLA's). The loops
// run the classes' whole widths, over zero columns past Dh and Dv and zero
// rows past the tile's keys, so no branch splits them and ptxas can
// interleave their independent products.
template <int ND, int NV, bool kVec16, class T>
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

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
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
      xq, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss,
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
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
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

// Dynamic shared memory of a narrow block of width class ND (see the note
// at the top): Q's halves, two K and V buffers and their small halves.
template <int ND>
constexpr int block_bytes32() {
  constexpr int LDK = 8 * ND, LDV = 8 * ND + 4;
  return (2 * kBQ * LDK + 3 * kBK * (LDK + LDV)) *
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
// each width class at 4 B a value (and, wide, each row count);
// tests/test_torch_prefill_plan.py reads these lines.
static_assert(block_bytes32<4>() == 42496, "ND 4");
static_assert(block_bytes32<8>() == 83456, "ND 8");
static_assert(block_bytes32<10>() == 103936, "ND 10");
static_assert(block_bytes32<16>() == 165376, "ND 16");
static_assert(block_bytes32<20>() == 206336, "ND 20");
static_assert(wide_bytes32<24, 16>(16) == 95232, "ND 24, NV 16, 16 rows");
static_assert(wide_bytes32<24, 16>(32) == 107520, "ND 24, NV 16, 32 rows");
static_assert(wide_bytes32<24, 24>(16) == 111616, "ND 24, 16 rows");
static_assert(wide_bytes32<24, 24>(32) == 123904, "ND 24, 32 rows");
static_assert(wide_bytes32<32, 32>(16) == 148480, "ND 32, 16 rows");
static_assert(wide_bytes32<32, 32>(32) == 164864, "ND 32, 32 rows");

template <int ND, bool kVec16, class T>
cudaError_t launch(const FaParams& p, cudaStream_t stream) {
  constexpr int bytes = block_bytes32<ND>();
  static_assert(bytes <= 232448, "over the shared memory a block may have");
  void (*kernel)(FaParams) = flash_fwd_kernel<ND, kVec16, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  // all of the SM's 228 KB as shared memory, so several blocks fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, p.B);
  kernel<<<grid, kThr, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The wide kernel, `rows` (16 or 32) query rows a block of 8 x rows
// threads; grid (Hq, ceil(Sq / rows), B).
template <int ND, int NV, bool kVec16, class T>
cudaError_t launch_wide(const FaParams& p, int rows, cudaStream_t stream) {
  static_assert(wide_bytes32<ND, NV>(kWideThr / 8) <= 232448,
                "over the shared memory a block may have");
  const int bytes = wide_bytes32<ND, NV>(rows);
  void (*kernel)(FaParams) = flash_wide_kernel<ND, NV, kVec16, T>;
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

template <bool kVec16, class T>
cudaError_t launch_width(const FaParams& p, int rows, cudaStream_t stream) {
  const int d8 = (max(p.Dh, p.Dv) + 7) / 8;
  if (d8 > 20) {  // the wide layout: width classes kWideND and 32
    if (rows != 16 && rows != 32) return cudaErrorInvalidValue;
    if (d8 > kWideND)  // gemma2's 256
      return launch_wide<32, 32, kVec16, T>(p, rows, stream);
    if (p.Dv <= 128)  // MLA's 192 / 128
      return launch_wide<24, 16, kVec16, T>(p, rows, stream);
    return launch_wide<24, 24, kVec16, T>(p, rows, stream);  // nemotron's
  }
  if (rows != kBQ) return cudaErrorInvalidValue;
  if (d8 <= 4) return launch<4, kVec16, T>(p, stream);
  if (d8 <= 8) return launch<8, kVec16, T>(p, stream);
  if (d8 <= 10) return launch<10, kVec16, T>(p, stream);  // zamba2's 80
  if (d8 <= 16) return launch<16, kVec16, T>(p, stream);
  return launch<20, kVec16, T>(p, stream);                // stablelm's 160
}

}  // namespace

// q, k, v and o all of dtype `dtype` (kF32, kBF16 or kF16); strides in
// elements; `rows` the query rows a block (prefill_plan's choice: at f32
// 64 below width class kWideND and 32 or 16 from it, at 16 bits 64, 32 or
// 16).
extern "C" int sfp_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int Hq, int Hkv, int Dh, int Dv, long long q_sb,
    long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float softcap,
    float scale, int kv_len, int rows, void* stream) {
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
  FaParams p{q,    k,    v,    o,    B,    Sq,   Skv,  Hq,   Hkv,
             Dh,   Dv,   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
             v_ss, v_sh, o_sb, o_ss, o_sh, causal, window, softcap,
             scale, kv_len};
  return (int)(vec ? launch_width<true, float>(p, rows, st)
                   : launch_width<false, float>(p, rows, st));
}
