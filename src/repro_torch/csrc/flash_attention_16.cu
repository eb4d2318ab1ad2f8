// GQA prefill attention for bf16 and f16 q, k and v on Hopper (sm_90a):
// 16-bit tiles by cp.async, QK^T and PV on m16n8k16 16-bit tensor cores,
// with P kept to fp32 accuracy as a sum of 16-bit terms.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd at 16 bits (flash_attention.cu holds the f32 kernel
// behind the same entry point). The TPU kernel widens q, k and v with
// astype(f32), takes QK^T and p V in f32 and rounds the output to q's
// dtype once; this kernel computes that function:
//  - QK^T: a product of two bf16 or two f16 values is exact in f32, so
//    mma.sync.m16n8k16 with f32 accumulation takes the f32 scores' exact
//    products, 16 head dims an instruction.
//  - PV: P is an f32 softmax weight and stays one: it is split into
//    16-bit terms, each the rounded residual of the ones before (three
//    bf16 terms, |p - sum| <= 2^-27 p; two f16 terms, <= 2^-23 p + 2^-25,
//    below the f32 p's own 2^-24 p plus 2^-25 / l with l >= 1), and each
//    term runs against V on m16n8k16, products exact, sums in f32. P is
//    never rounded once to 16 bits, which would cost up to 2^-9 (bf16) of
//    every weight. (Splitting P into two TF32 halves against V widened in
//    registers, 2 x m16n8k8, takes 4 products for 16 keys and 8 columns,
//    against 3 bf16 or 2 f16 here, and measured no faster.)
//  - The output is o / l rounded once to bf16 or f16, to nearest even.
//
// What the design does about the limits of the f32 kernel's 16-bit path
// (which widened 16-bit tiles to f32 at load and ran the f32 kernel's
// 3xTF32 design unchanged):
//  1. 16-bit tiles by cp.async. Q, K and V stay 16-bit in shared memory.
//     Q and each K/V tile are copied with 16-byte cp.async (zero fill past
//     the head dim and past the tile's keys) into a ring of kStages tiles
//     (2 of 64 keys up to head dim 128, 3 of 32 to 192, 2 of 32 at 256):
//     tile j + kStages - 1 is requested while tile j computes. That needs
//     every base and stride a multiple of 8 values (the entry point's
//     `vec`); other layouts (a value off 16 bytes, head dims not a
//     multiple of 8) are loaded synchronously, one value a load, into the
//     same layout. Rows are padded to an odd number of 16-byte chunks (8 ND
//     + 8 values), so the eight rows an ldmatrix phase reads fall in eight
//     different bank groups: no conflict for Q, K or V. Q and K are zero
//     past Dh up to the class's width, so every loop has a fixed count.
//  2. Tensor cores at 16 bits. Fragments are read with ldmatrix.x4 (Q as
//     A, K rows as B) and ldmatrix.x4.trans (V, which leaves thread (g, t)
//     keys 2t, 2t + 1, 2t + 8 and 2t + 9 of column g: the m16n8k16 B
//     fragment), from shared-space addresses worked out once. QK^T issues
//     one m16n8k16 for each 16 head dims and 8 keys (the f32 kernel issued
//     three m16n8k8 for 8); P's A fragments are packed from the QK^T
//     accumulator in place, so P never leaves registers.
//  3. One layout up to head dim 256. At 2 B a value a 64-row Q block at
//     256 is 33 KB and a 32-key K+V tile 33 KB, so two stages and Q fit
//     two blocks on an SM (109,568 bytes at ND 32). Up to head dim 128
//     (ND <= 16) each 16-row tile has two warps, one for each 32-key half
//     of every 64-key tile, each with its own online softmax and all of
//     V's columns, merged once at the end. From ND 20 on, o over all
//     columns would be 80-128 registers a thread, so the two warps split
//     V's columns instead: each computes QK^T for its 16 keys of a 32-key
//     tile, the two exchange their scores through shared memory (2 KB a
//     pair, a named barrier of 64 threads), both run the same online
//     softmax on all 32 keys (bitwise the same m and l), and each
//     multiplies P by its half of V's columns. QK^T is computed once for
//     every key, not twice as in the f32 wide layout.
//  4. Filling the card. The wrapper's prefill_plan picks the query rows a
//     block (64, 32 or 16; 4 x rows threads) so that a batch-1 serving
//     prefill launches at least one block an SM where its rows allow
//     (Qwen2.5-14B's 40 heads at S 132: 32 rows, 200 blocks; gemma2-9b's
//     16: 16 rows, 144), and the entry point takes that choice. Grid
//     (ceil(Sq / rows), Hq, B); a causal call runs the query blocks last
//     first, the longest first.
//
// Kept from the f32 kernel: the finite -2^30 mask (a masked key scores
// -2^30 and takes part in the max; an absent key, at or past kv_len or
// the tile's end, gets p = 0), mask work on edge tiles only, dead tiles
// and dead key halves skipped, and a block holding a row that every key
// masks (a window ending before kv_len) visiting every tile, so that row
// gets the plain version's mean of v over all kv_len keys.
//
// Bounds on an H100 SXM (3.35 TB/s; 989 TFLOP/s dense bf16/f16): every
// batch-1 serving prefill is bound by its bytes at 2 B a value, e.g.
// Qwen2.5-14B (1, 132, 40 / 8 x 128), causal: 3.24 MB -> 0.00097 ms.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/time_prefill.py, the
// parent build in the same run; PERF.md §6 has every shape, SDPA and the
// registers): at S 132, bf16 (f16), against the f32 kernel's 16-bit path
// in brackets: Qwen2.5-14B 0.0125-0.0128 (0.0124) [0.0306-0.0308],
// zamba2 0.0092-0.0093 (0.0091-0.0092) [0.0261], stablelm-12b 0.0141-
// 0.0142 (0.0137-0.0138) [0.0389-0.0392], gemma2-9b 0.0180-0.0181
// (0.0164-0.0165) [0.0531], nemotron-4-340b 0.0302 (0.0274-0.0281)
// [0.1101-0.1106] ms; bf16 SDPA 0.0088, 0.0085, 0.0100, 0.0115, 0.0163-
// 0.0166 ms: 9.6-18.6 x the byte bound (0.00081-0.00315 ms).
// What holds it back, read from clock64() stamps of the longest block
// (tools/prefill16_phase_clocks.py; PERF.md §6): issuing each tile's
// cp.async copies (the SM's copy throughput), then QK^T's and PV's chains
// of dependent mma.sync, and a fixed cost a call that SDPA's kernel pays
// too at S 1 to 32.

#include "attention_common.cuh"
#include "dtype.cuh"
#include "flash_attention_16.cuh"
#include "mma_tf32.cuh"  // cp_async_commit, cp_async_wait

#include <type_traits>

namespace {

using namespace sfp;

// Per width class ND (8-column steps of max(Dh, Dv), as the f32 kernel's):
// the row length in shared memory (values), the ring's stages and whether
// the two warps of a row tile split V's columns (kWide) or its keys.
template <int ND>
struct Shape16 {
  static_assert(ND % 2 == 0, "rows of whole 16-value ldmatrix steps");
  static constexpr int kLd = 8 * ND + 8;  // ND + 1 chunks: odd
  static constexpr bool kWide = ND >= 20;
  static constexpr int kKeys = kWide ? 32 : 64;  // keys a K/V tile
  static constexpr int kWarpKeys = kKeys / 2;    // of which a warp scores
  static constexpr int kStages = kWide ? (ND <= 24 ? 3 : 2) : 2;
  static constexpr int kNV = kWide ? ND / 2 : ND;  // o's n8 tiles a warp
  // blocks of 256 threads an SM must hold (__launch_bounds__): 2 caps a
  // thread at 128 registers; the narrow split at head dims 80 and 128,
  // and the synchronous f16 path at 256, spill under that cap, so those
  // classes take 1 (at most 255 registers)
  static constexpr int kMinBlocks = ND == 10 || ND == 16 || ND == 32 ? 1 : 2;
};

// Dynamic shared memory of a block of `rows` query rows: Q, the K and V
// rings (16-bit), and in the wide split the pairs' score exchange (8
// floats a lane, two warps a pair, rows / 16 pairs).
template <int ND>
constexpr int block_bytes16(int rows) {
  using S = Shape16<ND>;
  return 2 * (rows * S::kLd + S::kStages * 2 * S::kKeys * S::kLd) +
         (S::kWide ? (rows / 16) * 2 * 8 * 32 * 4 : 0);
}

// The narrow split's end merge (o, then m and l, of every pair's second
// warp as float4s by lane) reuses the K and V rings.
template <int ND>
constexpr bool merge_fits() {
  using S = Shape16<ND>;
  return (64 / 16) * (ND + 1) * 32 * 16 <=
         2 * S::kStages * S::kKeys * S::kLd * 2;
}

// The bytes prefill_plan (kernels/flash_attention/kernel.py) computes for
// each width class at 64, 32 and 16 rows; tests/test_torch_prefill_plan.py
// reads these lines.
static_assert(block_bytes16<4>(64) == 25600, "ND 4, 64 rows");
static_assert(block_bytes16<4>(32) == 23040, "ND 4, 32 rows");
static_assert(block_bytes16<4>(16) == 21760, "ND 4, 16 rows");
static_assert(block_bytes16<8>(64) == 46080, "ND 8, 64 rows");
static_assert(block_bytes16<8>(32) == 41472, "ND 8, 32 rows");
static_assert(block_bytes16<8>(16) == 39168, "ND 8, 16 rows");
static_assert(block_bytes16<10>(64) == 56320, "ND 10, 64 rows");
static_assert(block_bytes16<10>(32) == 50688, "ND 10, 32 rows");
static_assert(block_bytes16<10>(16) == 47872, "ND 10, 16 rows");
static_assert(block_bytes16<16>(64) == 87040, "ND 16, 64 rows");
static_assert(block_bytes16<16>(32) == 78336, "ND 16, 32 rows");
static_assert(block_bytes16<16>(16) == 73984, "ND 16, 16 rows");
static_assert(block_bytes16<20>(64) == 94208, "ND 20, 64 rows");
static_assert(block_bytes16<20>(32) == 79360, "ND 20, 32 rows");
static_assert(block_bytes16<20>(16) == 71936, "ND 20, 16 rows");
static_assert(block_bytes16<24>(64) == 110592, "ND 24, 64 rows");
static_assert(block_bytes16<24>(32) == 93696, "ND 24, 32 rows");
static_assert(block_bytes16<24>(16) == 85248, "ND 24, 16 rows");
static_assert(block_bytes16<32>(64) == 109568, "ND 32, 64 rows");
static_assert(block_bytes16<32>(32) == 88576, "ND 32, 32 rows");
static_assert(block_bytes16<32>(16) == 78080, "ND 32, 16 rows");

// e^x of a score's difference from its row max (x <= 0, or -inf)
__device__ __forceinline__ float ex(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// d += a . b on one m16n8k16 product of bf16 (f16) operands, f32 sums.
// Fragments (g = lane >> 2, t = lane & 3; two values a register, the
// lower column first): A a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g,
// 2t + 8..), a3 (g + 8, 2t + 8..); B b0 (k 2t..2t+1, n g), b1 (k
// 2t + 8..2t + 9, n g); C as m16n8k8's (mma_tf32.cuh).
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1, bf16) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1, f16) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit values from shared memory (`s`: a
// shared-space byte address): lanes 8i to 8i + 7 give the row addresses of
// matrix i, and register i holds row lane >> 2, columns 2 (lane & 3) and
// + 1 of it (.trans: column lane >> 2, rows 2 (lane & 3) and + 1).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16 bytes from global `src` to shared-space address `dst`, asynchronously:
// `src_bytes` read, the rest zero-filled (0 fills all; src stays valid).
__device__ __forceinline__ void cp_async16s(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16s(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// A 16-byte store to shared-space address `dst`.
__device__ __forceinline__ void sts16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// A softmax weight p (an f32) as the sum of kTerms 16-bit values, so that
// P V runs on m16n8k16 with exact products and P keeps f32 accuracy: each
// term is the residual left by the terms before it, rounded to nearest
// (the residual is exact in f32). bf16 (8 significant bits): three terms,
// |p - sum| <= 2^-27 p. f16 (11 bits; below 2^-14 its steps are 2^-24):
// two terms, |p - sum| <= 2^-23 p + 2^-25, and l >= 1, so a weight's error
// is at most that of the f32 p itself (2^-24 relative) plus 2^-25 / l.
template <class T>
constexpr int kTerms = std::is_same<T, bf16>::value ? 3 : 2;

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi, bf16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi, f16) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The two 16-bit values of w (lower address first), widened (exact).
__device__ __forceinline__ float2 unpack(uint32_t w, bf16) {
  return make_float2(bf16_lo(w), bf16_hi(w));
}
__device__ __forceinline__ float2 unpack(uint32_t w, f16) {
  return make_float2(f16_lo(w), f16_hi(w));
}

// The kTerms 16-bit pairs of two weights (lo the lower key), term i into
// w[i][kSlot]: A fragment register kSlot of each term's m16n8k16.
template <class T, int kSlot>
__device__ __forceinline__ void split_p(float lo, float hi,
                                        uint32_t (&w)[kTerms<T>][4]) {
#pragma unroll
  for (int i = 0; i < kTerms<T>; ++i) {
    w[i][kSlot] = pack_rn(lo, hi, T{});
    if (i + 1 < kTerms<T>) {
      const float2 f = unpack(w[i][kSlot], T{});
      lo -= f.x;
      hi -= f.y;
    }
  }
}

// Wait on a barrier that only the 64 threads of one warp pair use.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// Where a thread copies in a tile of rows of ND 16-byte chunks (8 values
// each: the width class's whole row) with `nthr` threads: chunk c / 8 of
// rows r0, r0 + step, ...; a thread past the last whole row's worth of
// chunks copies nothing.
template <int ND>
struct TileMap {
  int r0, c, step;
  __device__ TileMap(int tid, int nthr)
      : r0(tid / ND), c(8 * (tid % ND)), step(nthr / ND) {}
};

// Copy `rows` rows from src (row stride ss values) to shared-space address
// dst (row stride LD values) by the thread's TileMap: values at or past
// column d, and every value of a row at or past n_rows, are zero. kVec: by
// 16-byte cp.async (src and ss multiples of 8 values), visible after the
// group's wait and the next __syncthreads; else one value a plain load,
// visible after the next __syncthreads. The count of a chunk's values is
// written as comparisons: the f32 kernel's 16-bit loader, built by nvcc
// 12.9 from max(0, min(8, d - col)), loaded the chunk at col == d.
template <int LD, bool kVec, int ND, class T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src,
                                          long long ss, int n_rows, int rows,
                                          int d, const TileMap<ND>& m) {
  if (m.r0 >= m.step) return;
  const int left = d - m.c;
  const int full = left >= 8 ? 8 : (left > 0 ? left : 0);
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src) + m.r0 * ss + m.c;
  const long long s_step = m.step * ss;
  const uint32_t d_step = 2 * m.step * LD;
  dst += 2 * (m.r0 * LD + m.c);
  if constexpr (kVec) {
    if (full == 8 && n_rows >= rows) {  // every row and value present
#pragma unroll 4
      for (int r = m.r0; r < rows; r += m.step, s += s_step, dst += d_step)
        cp_async16s(dst, s);
      return;
    }
  }
  for (int r = m.r0; r < rows; r += m.step, s += s_step, dst += d_step) {
    const int n = r < n_rows ? full : 0;
    if constexpr (kVec) {
      cp_async16s(dst, n ? static_cast<const void*>(s) : src, 2 * n);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = 2 * e < n ? s[2 * e] : 0u;
        const uint32_t hi = 2 * e + 1 < n ? s[2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      sts16(dst, make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
}

// One block: `rows` query rows (p.rows / 16 row tiles, two warps each) of
// head blockIdx.y, batch blockIdx.z. T is bf16 or f16.
template <int ND, bool kVec, class T>
__global__ void __launch_bounds__(256, Shape16<ND>::kMinBlocks)
    flash16_kernel(Prefill16Params p) {
  using S = Shape16<ND>;
  constexpr int LD = S::kLd, NST = S::kStages, NV = S::kNV;
  constexpr int BK = S::kKeys, KW = S::kWarpKeys, NS = KW / 8;
  extern __shared__ __align__(16) uint16_t sm16[];
  const int rows = p.rows, nthr = blockDim.x;
  uint16_t* qs = sm16;                 // rows x LD
  uint16_t* ks = qs + rows * LD;      // NST tiles x BK x LD
  uint16_t* vs = ks + NST * BK * LD;  // NST tiles x BK x LD
  float* xs = reinterpret_cast<float*>(vs + NST * BK * LD);  // wide only

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Warp w runs on scheduler w % 4: the two warps of a row tile go to two
  // schedulers, and at 8 warps each scheduler holds row tiles 0 and 3 or
  // 1 and 2, which a causal block's diagonal loads about evenly.
  const int rg = warp < 4 ? warp >> 1 : 5 - (warp >> 1);
  const int half = warp & 1, k0 = KW * half;  // this warp's keys a tile
  const int qblk = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, q0 = qblk * rows;
  const int hk = h / (p.Hq / p.Hkv);

  const int q_last = min(q0 + rows, p.Sq) - 1;
  int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  int kv_end = p.causal ? min(p.kv_len, q_last + 1) : p.kv_len;
  if (p.window > 0 && q_last >= p.kv_len + p.window - 1) {
    kv_begin = 0;  // some row is fully masked: it averages every key
    kv_end = p.kv_len;
  }
  const int n_tiles = (kv_end - kv_begin + BK - 1) / BK;

  const T* qb =
      static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  // shared-space byte addresses of Q and of the K and V rings
  const uint32_t q_sa = static_cast<uint32_t>(__cvta_generic_to_shared(qs));
  const uint32_t k_sa = q_sa + 2 * rows * LD;
  const uint32_t v_sa = k_sa + 2 * NST * BK * LD;
  const TileMap<ND> map(tid, nthr);
  auto load_kv = [&](int it) {
    const int kt = kv_begin + it * BK, n_keys = min(BK, kv_end - kt);
    const int slot = it % NST;
    load_tile<LD, kVec>(k_sa + 2 * slot * BK * LD, kb + kt * p.k_ss, p.k_ss,
                        n_keys, BK, p.Dh, map);
    load_tile<LD, kVec>(v_sa + 2 * slot * BK * LD, vb + kt * p.v_ss, p.v_ss,
                        n_keys, BK, p.Dv, map);
  };
  load_tile<LD, kVec>(q_sa, qb, p.q_ss, p.Sq - q0, rows, p.Dh, map);
  // tiles 0 .. NST - 2 in flight (Q lands with tile 0); one group a tile,
  // empty past the last, so a wait on NST - 2 groups means tile `it` is in
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_async_commit();
  }

  // rows g and g + 8 of the warp's 16-row tile
  const int w_lo = q0 + 16 * rg, w_hi = w_lo + 15;
  const int row_a = w_lo + g, row_b = row_a + 8;
  const bool active = w_lo < p.Sq;  // a warp of padding rows only loads
  // ldmatrix row addresses: lane l gives row l & 7 of matrix l >> 3. Q
  // (A of QK^T): matrices rows 0-7 / 8-15 x head dims 0-7 / 8-15 of a
  // 16-dim step; K (B): keys 0-7 x dims 0-7, 8-15, then keys 8-15; V
  // (B of PV, .trans): keys 0-7 / 8-15 x columns 0-7, then 8-15.
  const int lr = lane & 7, lm = lane >> 3;
  const uint32_t qa =
      q_sa + 2 * ((16 * rg + lr + 8 * (lm & 1)) * LD + 8 * (lm >> 1));
  const uint32_t k_off = 2 * ((k0 + lr + 8 * (lm >> 1)) * LD + 8 * (lm & 1));
  const uint32_t v_off = 2 * ((lr + 8 * (lm & 1)) * LD + 8 * (lm >> 1));
  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kMask, m_b = kMask, l_a = 0.f, l_b = 0.f;  // l: this lane's
  //                                                        share of the sum

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + NST - 1 < n_tiles) load_kv(it + NST - 1);  // into it - 1's slot
    cp_async_commit();
    const int kt = kv_begin + it * BK, n_keys = min(BK, kv_end - kt);
    const uint32_t kt_s = k_sa + 2 * (it % NST) * BK * LD;
    const uint32_t vt_s = v_sa + 2 * (it % NST) * BK * LD;
    // Narrow: keys k0 .. k0 + 31 are this warp's; a half with no present
    // key adds nothing, and a causal half past the warp's last row holds
    // only masked keys, which add exactly 0 once a row has seen a key of
    // its own. Wide: the pair decides together (it meets at a barrier).
    if constexpr (S::kWide) {
      if (!active || (p.causal && kt > w_hi)) continue;
    } else {
      if (!active || k0 >= n_keys || (p.causal && kt + k0 > w_hi)) continue;
    }

    // S = Q K^T over this warp's KW keys: NS n8 tiles, over the class's
    // whole width (columns past Dh are zero in Q and K); at NS 2 the even
    // and odd 16-dim steps in two sets of sums (four independent chains)
    constexpr int kSets = NS == 2 ? 2 : 1;
    float s[NS][4], s2[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND / 2; ++kk) {
      uint32_t a[4];
      ldsm4(a, qa + 32 * kk);
#pragma unroll
      for (int q = 0; q < NS / 2; ++q) {
        uint32_t bk[4];
        ldsm4(bk, kt_s + k_off + 2 * 16 * q * LD + 32 * kk);
        if (kSets == 2 && (kk & 1)) {
          mma16(s2[2 * q], a, bk[0], bk[1], T{});
          mma16(s2[2 * q + 1], a, bk[2], bk[3], T{});
        } else {
          mma16(s[2 * q], a, bk[0], bk[1], T{});
          mma16(s[2 * q + 1], a, bk[2], bk[3], T{});
        }
      }
    }
    if constexpr (kSets == 2) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += s2[n][e];
    }

    // scale, softcap and (on edge halves only) masks
    const bool edge = k0 + KW > n_keys ||
                      (p.causal && kt + k0 + KW - 1 > w_lo) ||
                      (p.window > 0 && kt + k0 <= w_hi - p.window);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= p.scale;
    if (p.softcap > 0.f) {  // one branch a tile: tanhf only where it is used
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = p.softcap * tanhf(s[n][e] / p.softcap);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
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
      }
    }

    // The keys this warp's softmax and PV take: its own 32 (narrow) or
    // all 32 of the tile, the partner's 16 read from the exchange.
    constexpr int NK = 4;  // n8 key tiles
    float sc[NK][4];
    if constexpr (S::kWide) {
      float* mine = xs + (2 * rg + half) * 256;
      const float* other = xs + (2 * rg + (half ^ 1)) * 256;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32 + lane] = s[n][e];
      pair_sync(1 + rg);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // selects: no runtime register index
          const float x = other[(4 * n + e) * 32 + lane];
          sc[n][e] = half ? x : s[n][e];
          sc[2 + n][e] = half ? s[n][e] : x;
        }
    } else {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = s[n][e];
    }

    // online softmax on the fragments
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
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
    for (int n = 0; n < NK; ++n) {
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
    for (int n = 0; n < NV; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }

    // O += P V, 16 keys at a time (this warp's 32 keys, or the tile's 32):
    // P's kTerms 16-bit terms as m16n8k16 A fragments, packed from its f32
    // fragments (a0 row g keys 2t, 2t + 1; a1 row g + 8; a2, a3 keys
    // 2t + 8, 2t + 9), V's columns 16 at a time by one ldmatrix.x4.trans
    // (the B fragments of n8 tiles 2j and 2j + 1), kGroup steps together
    // (2: four sums side by side; 1 in the narrow split and where o fills
    // the registers, so that nothing spills), small terms first.
    constexpr int KT = kTerms<T>;
    constexpr int kGroup = S::kWide && NV < 16 ? 2 : 1;
    const int kb0 = S::kWide ? 0 : k0;  // the tile's first key of sc[0]
    const int j0 = S::kWide ? half * (NV / 2) : 0;  // first 16-column step
#pragma unroll
    for (int kb = 0; kb < NK / 2; ++kb) {
      if (kb0 + 16 * kb >= n_keys) continue;  // all absent: p = 0
      uint32_t pa[KT][4];
      split_p<T, 0>(sc[2 * kb][0], sc[2 * kb][1], pa);
      split_p<T, 1>(sc[2 * kb][2], sc[2 * kb][3], pa);
      split_p<T, 2>(sc[2 * kb + 1][0], sc[2 * kb + 1][1], pa);
      split_p<T, 3>(sc[2 * kb + 1][2], sc[2 * kb + 1][3], pa);
      const uint32_t vr = vt_s + 2 * (kb0 + 16 * kb) * LD + v_off;
#pragma unroll
      for (int j = 0; j < NV / 2; j += kGroup) {
        const bool two = kGroup == 2 && j + 1 < NV / 2;
        uint32_t r[kGroup][4];
        ldsm4t(r[0], vr + 32 * (j0 + j));
        if (two) ldsm4t(r[kGroup - 1], vr + 32 * (j0 + j + 1));
#pragma unroll
        for (int term = KT - 1; term >= 0; --term) {
          mma16(o[2 * j], pa[term], r[0][0], r[0][1], T{});
          mma16(o[2 * j + 1], pa[term], r[0][2], r[0][3], T{});
          if (two) {
            mma16(o[2 * j + 2], pa[term], r[kGroup - 1][0],
                  r[kGroup - 1][1], T{});
            mma16(o[2 * j + 3], pa[term], r[kGroup - 1][2],
                  r[kGroup - 1][3], T{});
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (!S::kWide) {
    // The two key halves of a row tile meet in the spent rings: the
    // second half's (m, l, O) fragments go to shared memory by lane, and
    // the first half folds them into its own.
    __syncthreads();
    float4* mo = reinterpret_cast<float4*>(ks);  // [rg][n][lane]
    float4* ml = mo + (rows / 16) * ND * 32;     // [rg][lane]: m, m, l, l
    if (active && half) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mo[(rg * ND + n) * 32 + lane] =
            make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
      ml[rg * 32 + lane] = make_float4(m_a, m_b, l_a, l_b);
    }
    __syncthreads();
    if (!active || half) return;
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
  } else {
    if (!active) return;
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int c0 = S::kWide ? 8 * half * NV : 0;  // this warp's first column
#pragma unroll
  for (int n = 0; n < NV; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * n + 2 * t + e;
      if (col >= p.Dv) continue;
      if (row_a < p.Sq) put(ob + row_a * p.o_ss + col, o[n][e] * inv_a);
      if (row_b < p.Sq) put(ob + row_b * p.o_ss + col, o[n][e + 2] * inv_b);
    }
  }
}

template <int ND, bool kVec, class T>
cudaError_t launch16(const Prefill16Params& p, cudaStream_t stream) {
  static_assert(block_bytes16<ND>(64) <= 232448,
                "over the shared memory a block may have");
  static_assert(Shape16<ND>::kWide || merge_fits<ND>(),
                "the narrow split's end merge fits the rings");
  const int bytes = block_bytes16<ND>(p.rows);
  void (*kernel)(Prefill16Params) = flash16_kernel<ND, kVec, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  // all of the SM's 228 KB as shared memory, so several blocks fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + p.rows - 1) / p.rows, p.Hq, p.B);
  kernel<<<grid, 4 * p.rows, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool kVec, class T>
cudaError_t launch16_width(const Prefill16Params& p, cudaStream_t stream) {
  const int d8 = (max(p.Dh, p.Dv) + 7) / 8;
  if (d8 <= 4) return launch16<4, kVec, T>(p, stream);
  if (d8 <= 8) return launch16<8, kVec, T>(p, stream);
  if (d8 <= 10) return launch16<10, kVec, T>(p, stream);  // zamba2's 80
  if (d8 <= 16) return launch16<16, kVec, T>(p, stream);
  if (d8 <= 20) return launch16<20, kVec, T>(p, stream);  // stablelm's 160
  if (d8 <= 24) return launch16<24, kVec, T>(p, stream);  // nemotron's 192
  return launch16<32, kVec, T>(p, stream);                // gemma2's 256
}

}  // namespace

namespace sfp {

cudaError_t flash16_fwd(const Prefill16Params& p, int dtype, bool vec,
                        cudaStream_t stream) {
  if ((p.rows != 16 && p.rows != 32 && p.rows != 64) ||
      (dtype != kBF16 && dtype != kF16))
    return cudaErrorInvalidValue;
  if (dtype == kBF16)
    return vec ? launch16_width<true, bf16>(p, stream)
               : launch16_width<false, bf16>(p, stream);
  return vec ? launch16_width<true, f16>(p, stream)
             : launch16_width<false, f16>(p, stream);
}

}  // namespace sfp
