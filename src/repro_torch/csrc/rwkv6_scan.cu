// RWKV-6 time-mix scan for Hopper (sm_90a): a sub-chunk-stabilised chunked
// kernel on 3xTF32 tensor cores for prefill and a bandwidth-shaped step
// kernel for decode, behind the one entry point sfp_rwkv6_scan_fwd.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan/kernel.py::rwkv6_fwd
// (def at line 69). Per (batch b, head h), with the (K, V) state S and the
// per-channel data-dependent log-decay w_t <= 0:
//
//   y_t[v]    = sum_k r_t[k] S[k, v] + (sum_k r_t[k] u[k] k_t[k]) v_t[v]
//   S[k, v]  <- exp(w_t[k]) S[k, v] + k_t[k] v_t[v]
//
// from the carried state (or zeros). The TPU wrapper's moveaxis to (BH, T,
// .), its padding of T to a multiple of the chunk (zero k and w rows) and
// its sequential chunk grid axis are TPU layout only: both kernels read r,
// k, v and w in the op's (B, T, H, .) layout through strides and treat
// steps past T as that padding would (r, k, v 0 and w 0: no input, a decay
// of 1; their y is not written).
//
// rwkv6_chunk_kernel (T above the crossover): the chunked form the TPU
// kernel's docstring names as its next step. Grid (ceil(V / NV), H, B): a
// block owns NV columns of the head's state (columns evolve independently,
// so the split is exact), keeps them in shared memory across the chunks,
// reads them once and writes them once. Per chunk of kC steps, in
// sub-chunks of 16 (i, j: sub-chunks; P_t the sum of w over the steps of
// t's sub-chunk before t, Q_s the sum over those after s, tot_i the sum
// over sub-chunk i, all restarted at each sub-chunk boundary):
//
//   y_t  = (r_t o exp(P_t + sum_{m < i} tot_m))^T S             (inter)
//        + sum_{s in j < i} (r~_t . k~_s o exp(sum_{j < m < i} tot_m)) v_s
//        + sum_{s < t in i} (sum_k r_t k_s prod_{s < q < t} exp(w_q)) v_s
//        + (r_t . (u o k_t)) v_t
//   S   <- exp(sum_m tot_m) o S + sum_s (k_s o exp(Q_s + sum_{m > j} tot_m))
//          v_s^T
//
// with r~_t = r_t o exp(P_t) and k~_s = k_s o exp(Q_s). Every exponent is a
// sum of w's over its interval, all of one sign, put together from sums
// restarted at sub-chunk boundaries and whole sub-chunk totals, never the
// difference of two cumsums: the GLA form's exp(-cumsum) overflows f32 at w
// = -12 within a few steps, and a difference of chunk-level cumsums carries
// their rounding (hundreds at strong decays) into exp's argument. Both
// factors of the off-diagonal product are <= 1. The diagonal sub-blocks
// (s < t within one sub-chunk) run on CUDA cores in f32, their decay the
// running product of exp(w) the sequential recurrence applies; the bonus
// goes on the diagonal. Everything else (the inter-chunk term, the
// off-diagonal blocks, A v and the state update) runs on mma.sync m16n8k8
// TF32 in the 3xTF32 split of mma_tf32.cuh, which keeps f32 accuracy, each
// k-step's products on a fresh accumulator added in f32. The next chunk's
// r, k, w and v are staged while this one computes (cp.async for f32, a
// widening load for bf16 and f16). Shared row strides: K + 4 for
// row-major operands, K + 8 for the k-major one (the state update's A) and
// NV + 8 for v and S, so fragment loads hit distinct banks. At rwkv6-3b's
// K = V = 64 with kC 32 and NV 32 a block of 16 warps takes 104 KB of
// shared memory; batch-1 prefill (H 40) makes 80 blocks. The phases are
// short and dependent (a chunk has five barriers), so 16 warps a block
// hide more of their latency than 8.
//
// rwkv6_step_kernel (T up to the crossover, every decode step): grid
// (ceil(V / 64), H, B), 256 threads. Each thread owns four contiguous
// columns of up to four rows: one 16-byte load and store of f32 state a
// row (8 bytes at bf16 or f16), all its loads in flight before the first
// use, the state in registers over the steps. Each step the block stages
// its r, k, exp(w) (one expf a row) and v in shared memory, one value a
// thread; y_t[v] = sum_k r[k] S[k, v] is reduced over a warp's row groups
// by shuffles and over the warps through shared memory; warp 0 forms the
// bonus once a step.
//
// Bound on this card, at rwkv6-3b's heads (H 40, K = V = 64): decode (8
// slots, T 1) is all state traffic, 2 x 8*40*64*64*4 B = 10.5 MB read and
// written once, 3.1 us at 3.35 TB/s. Prefill (batch 1, T 132) reads r, k,
// v and w once and writes y and the state, 2.41 us of traffic against 1.6
// us of operations (the recurrence's 5 flops a state entry a step at the
// fp32 pipe's 67 TFLOP/s). The chunked kernel does more flops than that
// (the kC x kC intra-chunk products, three TF32 passes each) but replaces
// T dependent steps by T / kC chunks of products.
//
// The final state goes to a caller-given f32 buffer, which may be the
// input state itself: the serving caches update in place and no copy of
// the state follows the launch. Aliasing is safe in both kernels: a chunk
// block reads its columns before the first chunk and writes them after the
// last, and no other block touches them; a step thread reads and writes the
// same elements, and no other thread touches them. The state loads are not
// marked read-only (no __ldg) for that reason.
//
// Crossover: the wrapper (kernels/rwkv6_scan/kernel.py, STEP_MAX_T) picks
// the step kernel for T <= STEP_MAX_T and the chunked kernel above it, from
// chip_smoke.py's sweep of both kernels' device times over T 1-16 at 8
// slots and at 1. Both are hand-written kernels: this is dispatch by shape.
//
// r (the kernels' TX: f32, bf16 or f16), k, v, w, u and s0 each have their
// own dtype code, as the TPU kernel reads each with astype(f32). The
// chunked kernel is built twice per TX, picked at the entry: typed, for
// the serving path's mix (k and v of r's dtype, w f32), and coded, which
// widens k, v and w through their codes (a branch uniform over the launch)
// and takes any other mix. The step kernel reads every input but r through
// its code: it stages one value a thread a step. u and the state are read
// once, through their codes. y is written in r's dtype (one round to
// nearest even), the state in f32. IEEE expf (no fast math). Sums run in
// another order than the plain sequential version's, so the two agree to
// f32 rounding, not bit for bit.

#include <cuda_runtime.h>

#include "dtype.cuh"
#include "mma_tf32.cuh"
#include "scan_common.cuh"

namespace {

using namespace sfp;

constexpr int kChunkThreads = 512;  // 16 warps: the chunk's phases are
constexpr int kChunkWarps = kChunkThreads / 32;  // latency-bound
constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kMaxK = 64;         // state rows (a chunk block's K padding)
constexpr int kSub = 16;          // steps a sub-chunk: one m16 row tile
constexpr int kStepRows = 4;      // state rows a step thread holds
constexpr int kStepCols = 64;     // state columns a step block
constexpr int kSmemMax = 232448;
// the chunk kernel's shape the serving path runs: sub-chunks a chunk and
// state columns a block (chip_smoke.py's sweep); the other shapes are
// built for f32 inputs only, for that sweep
constexpr int kDefNS = 2;
constexpr int kDefNV = 32;

struct Params {
  const void* r;     // of the kernels' element type TX
  const void* k;
  const void* v;
  const void* w;
  const void* u;
  const void* s0;    // null: zero initial state
  void* y;           // in TX
  float* s_out;      // may be s0
  int k_dt, v_dt, w_dt, u_dt, s0_dt;  // dtype codes
  int B, T, H, K, V;
  long long r_sb, r_st, r_sh, k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh, w_sb, w_st, w_sh;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One stage of transpose_sum16: a lane keeps H of its 2H partial sums (the
// upper H where bit 2H of its lane is set), adds its partner's copies of
// them and hands the partner the other H.
template <int H>
__device__ __forceinline__ void keep_half(float (&v)[16], int lane) {
  const bool upper = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float mine = upper ? v[H + i] : v[i];
    const float other = upper ? v[i] : v[H + i];
    v[i] = mine + __shfl_xor_sync(0xffffffffu, other, 2 * H);
  }
}

// v[j] summed over the warp's lanes for all 16 j at once, in 16 shuffles
// (a butterfly that halves the values a lane holds at each stage): returns
// the sum of v[lane >> 1], in lanes 2j and 2j + 1. v is clobbered.
__device__ __forceinline__ float transpose_sum16(float (&v)[16], int lane) {
  keep_half<8>(v, lane);
  keep_half<4>(v, lane);
  keep_half<2>(v, lane);
  keep_half<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// Shared floats of one stage of a chunk's inputs, for K padded to Kp (a
// multiple of 16): r, k and w (kC x (Kp + 4)) and v (kC x (NV + 8)).
__host__ __device__ constexpr int chunk_stage_floats(int kC, int Kp,
                                                     int NV) {
  return 3 * kC * (Kp + 4) + kC * (NV + 8);
}

// Shared floats of a chunk block: two stages, the state columns (Kp x (NV
// + 8)), r~ and k~ (kC x (Kp + 4)), the state update's k (kC x (Kp + 8)),
// A (kC x (kC + 4)), the sub-chunk totals and exp of the sums before each
// sub-chunk (NS x Kp each), exp of the chunk's sum, u, and exp of the sums
// between non-adjacent sub-chunks (3 x Kp; NS 4).
__host__ __device__ constexpr int chunk_smem_floats(int NS, int NV,
                                                    int Kp) {
  return 2 * chunk_stage_floats(kSub * NS, Kp, NV) + Kp * (NV + 8) +
         2 * kSub * NS * (Kp + 4) + kSub * NS * (Kp + 8) +
         kSub * NS * (kSub * NS + 4) + 2 * NS * Kp + 5 * Kp;
}

// a (16 x 8 row-major at p, row stride ld), column j of the tile scaled by
// f0 (j < 4) or f1 (j >= 4) -> TF32 halves
__device__ __forceinline__ void frag_a_scaled(const float* p, int ld,
                                              float f0, float f1,
                                              uint32_t (&big)[4],
                                              uint32_t (&small)[4]) {
  split_tf32(p[0] * f0, big[0], small[0]);
  split_tf32(p[8 * ld] * f0, big[1], small[1]);
  split_tf32(p[4] * f1, big[2], small[2]);
  split_tf32(p[8 * ld + 4] * f1, big[3], small[3]);
}

// kTyped: k and v of r's element type TX, w f32 (the serving path's mix);
// otherwise k, v and w are read through their dtype codes. kNS sub-chunks
// of 16 steps a chunk, kNV state columns a block.
template <class TX, bool kTyped, int kNS, int kNV>
__global__ void __launch_bounds__(kChunkThreads)
rwkv6_chunk_kernel(Params p) {
  constexpr int kC = kSub * kNS;
  constexpr int ldv = kNV + 8;
  constexpr int ldA = kC + 4;
  constexpr int kNT = kNV / 8;                  // n8 column tiles
  constexpr int kYTiles = kNS * kNT;            // y's m16n8 tiles a chunk
  constexpr int kYT = (kYTiles + kChunkWarps - 1) / kChunkWarps;
  constexpr int kPairs = kNS * (kNS - 1) / 2;   // off-diagonal sub-blocks
  extern __shared__ __align__(16) float smem[];
  const int Kp = (p.K + 15) & ~15, ldk = Kp + 4, ldks = Kp + 8;
  const int sf = chunk_stage_floats(kC, Kp, kNV);
  auto stage_at = [&](int c) { return smem + (c & 1) * sf; };
  float* Ss = smem + 2 * sf;        // the block's state columns (Kp, ldv)
  float* rt = Ss + Kp * ldv;        // r~ (kC, ldk); first P
  float* kt = rt + kC * ldk;        // k~ (kC, ldk); first Q
  float* kS = kt + kC * ldk;        // k o exp(sum w over (s, chunk end])
  float* As = kS + kC * ldks;       // A (kC, ldA)
  float* tot = As + kC * ldA;       // [i][k]: sum w over sub-chunk i
  float* eb = tot + kNS * Kp;       // [i][k]: exp(sum over the sub-chunks
  //                                   before i)
  float* ed = eb + kNS * Kp;        // exp(sum w over the chunk)
  float* us = ed + Kp;              // u
  float* em = us + Kp;              // exp(sum over the sub-chunks strictly
  //                                   between j and i): (0,2), (0,3), (1,3)

  const int v0 = blockIdx.x * kNV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row, column in quad
  const int ncols = min(kNV, p.V - v0);
  const int n_chunks = (p.T + kC - 1) / kC;
  const TX* rb = static_cast<const TX*>(p.r) + b * p.r_sb + h * p.r_sh;
  const long long ko = b * p.k_sb + h * p.k_sh;
  const long long vo = b * p.v_sb + h * p.v_sh + v0;
  const long long wo = b * p.w_sb + h * p.w_sh;
  const long long sbase =
      ((long long)b * p.H + h) * p.K * (long long)p.V + v0;

  // Start chunk c's copies into its stage (zero past T, K and V).
  auto issue = [&](int c) {
    float* rs = stage_at(c);
    float* ks = rs + kC * ldk;
    float* ws = ks + kC * ldk;
    float* vs = ws + kC * ldk;
    const int t0 = c * kC, nt = min(kC, p.T - t0);
    const int q = tid & (kMaxK - 1);  // a channel; 4 steps a pass
#pragma unroll
    for (int it = 0; it < kC * kMaxK / kChunkThreads; ++it) {
      const int s = (tid >> 6) + (kChunkThreads / kMaxK) * it;
      if (q >= Kp) continue;
      const bool in = s < nt && q < p.K;
      const long long t = t0 + s;
      stage(rs + s * ldk + q, rb + t * p.r_st + q, in, rb);
      stage_elem<kTyped, TX>(ks + s * ldk + q, p.k, p.k_dt,
                             ko + t * p.k_st + q, in);
      stage_elem<kTyped, float>(ws + s * ldk + q, p.w, p.w_dt,
                                wo + t * p.w_st + q, in);
    }
#pragma unroll
    for (int it = 0; it < kC * kNV / kChunkThreads; ++it) {
      const int i = tid + kChunkThreads * it, s = i / kNV, cq = i % kNV;
      stage_elem<kTyped, TX>(vs + s * ldv + cq, p.v, p.v_dt,
                             vo + (long long)(t0 + s) * p.v_st + cq,
                             s < nt && cq < ncols);
    }
    cp_async_commit();
  };

  if (n_chunks > 0) issue(0);
  // the block's columns of s0 and u, zero past K and V (the pads stay
  // zero); every load issued before the first store
  {
    constexpr int kPer = kMaxK * kNV / kChunkThreads;
    float sv[kPer];
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int i = tid + kChunkThreads * it, q = i / kNV, c = i % kNV;
      sv[it] = q < p.K && c < ncols && p.s0 != nullptr
                   ? load_f32(p.s0, p.s0_dt, sbase + (long long)q * p.V + c)
                   : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int i = tid + kChunkThreads * it, q = i / kNV, c = i % kNV;
      if (q < Kp) Ss[q * ldv + c] = sv[it];
    }
  }
  for (int i = tid; i < Kp; i += kChunkThreads)
    us[i] = i < p.K ? load_f32(p.u, p.u_dt, (long long)h * p.K + i) : 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kC, nt = min(kC, p.T - t0);
    float* rs = stage_at(c);
    float* ks = rs + kC * ldk;
    float* ws = ks + kC * ldk;
    float* vs = ws + kC * ldk;
    // 1. the next chunk's copies start; this chunk's have landed
    if (c + 1 < n_chunks) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 2a. Per (sub-chunk i, channel q): P (the sum of w over the steps of
    //     the sub-chunk before t) into rt, Q (over those after s) into kt,
    //     and the sub-chunk's total, each summed in step order from 0.
    if (tid < kNS * Kp) {
      const int i = tid / Kp, q = tid - i * Kp;
      const float* wc = ws + i * kSub * ldk + q;
      float wv[kSub];
#pragma unroll
      for (int s = 0; s < kSub; ++s) wv[s] = wc[s * ldk];
      float run = 0.f;
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        rt[(i * kSub + s) * ldk + q] = run;
        run += wv[s];
      }
      tot[i * Kp + q] = run;
      float suf = 0.f;
#pragma unroll
      for (int s = kSub - 1; s >= 0; --s) {
        kt[(i * kSub + s) * ldk + q] = suf;
        suf += wv[s];
      }
    }
    __syncthreads();

    // 2b. The factors: exp of each sum of w the products need, each
    //     exponent a sum of partial sums and whole sub-chunk totals (one
    //     sign); exp(w) in place of w for the diagonal blocks.
    if (tid < kNS * Kp) {
      const int i = tid / Kp, q = tid - i * Kp;
      float before = 0.f;
      for (int m = 0; m < i; ++m) before += tot[m * Kp + q];
      eb[i * Kp + q] = expf(before);
      if (i == 0) {
        float all = 0.f;
#pragma unroll
        for (int m = 0; m < kNS; ++m) all += tot[m * Kp + q];
        ed[q] = expf(all);
        if constexpr (kNS == 4) {
          em[q] = expf(tot[Kp + q]);
          em[Kp + q] = expf(tot[Kp + q] + tot[2 * Kp + q]);
          em[2 * Kp + q] = expf(tot[2 * Kp + q]);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kC * kMaxK / kChunkThreads; ++it) {
      const int s = (tid >> 6) + (kChunkThreads / kMaxK) * it;
      const int q = tid & (kMaxK - 1), i = s / kSub;
      if (q >= Kp) continue;
      float after = 0.f;
      for (int m = i + 1; m < kNS; ++m) after += tot[m * Kp + q];
      const int o = s * ldk + q;
      const float P = rt[o], Q = kt[o], kv = ks[o];
      rt[o] = rs[o] * expf(P);
      kt[o] = kv * expf(Q);
      kS[s * ldks + q] = kv * expf(Q + after);
      ws[o] = expf(ws[o]);
    }
    __syncthreads();

    // 3. (a) each warp's y tiles: the inter-chunk term, kept in registers
    //    across the barrier; (b) A's off-diagonal sub-blocks on tensor
    //    cores; (c) its diagonal sub-blocks on CUDA cores
    float acc[kYT][4];
#pragma unroll
    for (int jt = 0; jt < kYT; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jt][e] = 0.f;
      const int tile = warp + kChunkWarps * jt;
      if (tile >= kYTiles) continue;  // uniform over the warp
      const int mi = tile / kNT, n0 = 8 * (tile - mi * kNT);
      const float* ebi = eb + mi * Kp;
#pragma unroll 4
      for (int k0 = 0; k0 < Kp; k0 += 8) {
        uint32_t ab[4], as[4], b2[2], s2[2];
        frag_a_scaled(rt + (kSub * mi + gr) * ldk + k0 + tq, ldk,
                      ebi[k0 + tq], ebi[k0 + tq + 4], ab, as);
        frag_b(Ss + (k0 + tq) * ldv + n0 + gr, 4 * ldv, b2, s2);
        mma3(acc[jt], ab, as, b2, s2);
      }
    }
    // (the last warps, which hold no y tile at 32 steps a chunk)
    for (int job = kChunkWarps - 1 - warp; job < 2 * kPairs;
         job += kChunkWarps) {
      int j = job >> 1, i = 1;
      while (j >= i) {
        j -= i;
        ++i;
      }
      const int r0 = kSub * i, c0 = kSub * j + 8 * (job & 1);
      // the sub-chunks strictly between j and i, as exp of their sum
      const float* mid = i - j == 3 ? em + Kp
                         : i - j == 2 ? em + (j == 0 ? 0 : 2 * Kp)
                                      : nullptr;
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int k0 = 0; k0 < Kp; k0 += 8) {
        uint32_t ab[4], as[4], b2[2], s2[2];
        frag_a(rt + (r0 + gr) * ldk + k0 + tq, ldk, ab, as);
        const float* kp = kt + (c0 + gr) * ldk + k0 + tq;
        const float f0 = mid ? mid[k0 + tq] : 1.f;
        const float f1 = mid ? mid[k0 + tq + 4] : 1.f;
        split_tf32(kp[0] * f0, b2[0], s2[0]);
        split_tf32(kp[4] * f1, b2[1], s2[1]);
        mma3(a4, ab, as, b2, s2);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        As[(r0 + gr + (e >> 1) * 8) * ldA + c0 + 2 * tq + (e & 1)] = a4[e];
    }
    {
      // rows qa and 15 - qa of sub-chunk i: the 15 entries below the
      // diagonal between them and row qa's bonus, each a sum over the
      // channels (lanes k and k + 32), formed in registers and reduced
      // together; then row 15 - qa's bonus and zeros above the diagonal
      const bool hi = Kp > 32;
      const int k0 = lane, k1 = lane + 32;
      const bool l0 = k0 < Kp, l1 = hi && k1 < Kp;
      for (int pp = warp; pp < kNS * 8; pp += kChunkWarps) {
        const int i = pp >> 3, qa = pp & 7;
        const int ta = kSub * i + qa, tb = kSub * i + (kSub - 1 - qa);
        const float ra0 = l0 ? rs[ta * ldk + k0] : 0.f;
        const float ra1 = l1 ? rs[ta * ldk + k1] : 0.f;
        const float rb0 = l0 ? rs[tb * ldk + k0] : 0.f;
        const float rb1 = l1 ? rs[tb * ldk + k1] : 0.f;
        float vals[16];
        float d0 = 1.f, d1 = 1.f;
#pragma unroll
        for (int m = 0; m < kSub - 1; ++m) {
          const bool on_a = m < qa;
          const int s = on_a ? ta - 1 - m : tb - 1 - (m - qa);
          if (m == qa) d0 = d1 = 1.f;
          const float x0 = on_a ? ra0 : rb0, x1 = on_a ? ra1 : rb1;
          float a = l0 ? x0 * ks[s * ldk + k0] * d0 : 0.f;
          if (l1) a += x1 * ks[s * ldk + k1] * d1;
          vals[m] = a;
          if (l0) d0 *= ws[s * ldk + k0];
          if (l1) d1 *= ws[s * ldk + k1];
        }
        vals[kSub - 1] =
            (l0 ? ra0 * us[k0] * ks[ta * ldk + k0] : 0.f) +
            (l1 ? ra1 * us[k1] * ks[ta * ldk + k1] : 0.f);
        float bonus_b = (l0 ? rb0 * us[k0] * ks[tb * ldk + k0] : 0.f) +
                        (l1 ? rb1 * us[k1] * ks[tb * ldk + k1] : 0.f);
        const float sum = transpose_sum16(vals, lane);
        bonus_b = warp_sum(bonus_b);
        if (!(lane & 1)) {
          const int m = lane >> 1;
          if (m == kSub - 1) {
            As[ta * ldA + ta] = sum;
          } else {
            const bool on_a = m < qa;
            const int t = on_a ? ta : tb;
            const int s2 = on_a ? ta - 1 - m : tb - 1 - (m - qa);
            As[t * ldA + s2] = sum;
          }
        }
        if (lane == 0) As[tb * ldA + tb] = bonus_b;
        if (lane < kSub - 1 - qa) As[ta * ldA + ta + 1 + lane] = 0.f;
        if (lane < qa) As[tb * ldA + tb + 1 + lane] = 0.f;
      }
    }
    __syncthreads();

    // 4. (d) y += A v, y written; (e) S <- exp(sum w) o S + kS^T v
    TX* yb = static_cast<TX*>(p.y);
#pragma unroll
    for (int jt = 0; jt < kYT; ++jt) {
      const int tile = warp + kChunkWarps * jt;
      if (tile >= kYTiles) continue;
      const int mi = tile / kNT, n0 = 8 * (tile - mi * kNT), r0 = kSub * mi;
#pragma unroll
      for (int k0 = 0; k0 < kC; k0 += 8) {
        if (k0 >= r0 + kSub) break;  // A is 0 past the row tile's last step
        uint32_t ab[4], as[4], b2[2], s2[2];
        frag_a(As + (r0 + gr) * ldA + k0 + tq, ldA, ab, as);
        frag_b(vs + (k0 + tq) * ldv + n0 + gr, 4 * ldv, b2, s2);
        mma3(acc[jt], ab, as, b2, s2);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + gr + (e >> 1) * 8, col = n0 + 2 * tq + (e & 1);
        if (r < nt && col < ncols)
          put(yb + (((long long)b * p.T + t0 + r) * p.H + h) * p.V + v0 +
                  col,
              acc[jt][e]);
      }
    }
    for (int tile = warp; tile < (Kp / 16) * kNT; tile += kChunkWarps) {
      const int mi = tile / kNT, m0 = 16 * mi, n0 = 8 * (tile - mi * kNT);
      float a4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + gr + (e >> 1) * 8;
        a4[e] = ed[row] * Ss[row * ldv + n0 + 2 * tq + (e & 1)];
      }
#pragma unroll
      for (int k0 = 0; k0 < kC; k0 += 8) {
        // A[k][s] = kS[s][k]: a0 (k, s), a1 (k + 8, s), a2 (k, s + 4)
        uint32_t ab[4], as[4], b2[2], s2[2];
        const float* ap = kS + (k0 + tq) * ldks + m0 + gr;
        split_tf32(ap[0], ab[0], as[0]);
        split_tf32(ap[8], ab[1], as[1]);
        split_tf32(ap[4 * ldks], ab[2], as[2]);
        split_tf32(ap[4 * ldks + 8], ab[3], as[3]);
        frag_b(vs + (k0 + tq) * ldv + n0 + gr, 4 * ldv, b2, s2);
        mma3(a4, ab, as, b2, s2);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Ss[(m0 + gr + (e >> 1) * 8) * ldv + n0 + 2 * tq + (e & 1)] = a4[e];
    }
    __syncthreads();
  }

  // the block's columns of the final state
  if (n_chunks == 0) __syncthreads();
  for (int i = tid; i < p.K * ncols; i += kChunkThreads) {
    const int q = i / ncols, c = i - q * ncols;
    p.s_out[sbase + (long long)q * p.V + c] = Ss[q * ldv + c];
  }
}

// lanes: a row's lanes, the least power of two with 4 lanes >= min(V, 64);
// vec: V % 4 == 0 and s0 and s_out aligned for vector accesses.
template <class TX>
__global__ void __launch_bounds__(kStepThreads)
rwkv6_step_kernel(Params p, int lanes, bool vec) {
  static_assert(3 * kMaxK + kStepCols == kStepThreads,
                "one staged input value a thread");
  __shared__ float red[2][kStepWarps][kStepCols];  // per-warp partial y
  __shared__ float in_s[2][kStepThreads];  // r, k, exp(w) (at 0, 64, 128),
  //                                          v
  __shared__ float us[kMaxK];
  __shared__ float bonus_s[2];
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = tid & (lanes - 1), rg = tid / lanes;
  const int n_rg = kStepThreads / lanes;       // >= 16: K <= 64 rows fit
  const int cb = blockIdx.x * 4 * lanes;       // the block's first column
  const int c0 = cb + 4 * j, nn = p.V - c0;    // this thread's columns
  const TX* rb = static_cast<const TX*>(p.r) + b * p.r_sb + h * p.r_sh;
  const long long ko = b * p.k_sb + h * p.k_sh;
  const long long vo = b * p.v_sb + h * p.v_sh + cb;
  const long long wo = b * p.w_sb + h * p.w_sh;
  const long long sbase = ((long long)b * p.H + h) * p.K * (long long)p.V;
  TX* yb = static_cast<TX*>(p.y);

  float4 st[kStepRows];
#pragma unroll
  for (int u = 0; u < kStepRows; ++u) {
    const int row = rg + n_rg * u;
    st[u] = row < p.K && nn > 0 && p.s0 != nullptr
                ? state4_of<false>(p.s0, p.s0_dt,
                                   sbase + (long long)row * p.V + c0, nn,
                                   vec)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid < kMaxK)
    us[tid] = tid < p.K ? load_f32(p.u, p.u_dt, (long long)h * p.K + tid)
                        : 0.f;
  for (int t = 0; t < p.T; ++t) {
    // the step's inputs, one value a thread: r, k and exp(w) by row, v by
    // the block's column
    float* in = in_s[t & 1];
    {
      const int q = tid & (kMaxK - 1), part = tid / kMaxK;
      float x = 0.f;
      if (part == 0 && q < p.K)
        x = to_f32(rb[t * p.r_st + q]);
      else if (part == 1 && q < p.K)
        x = load_f32(p.k, p.k_dt, ko + t * p.k_st + q);
      else if (part == 2 && q < p.K)
        x = expf(load_f32(p.w, p.w_dt, wo + t * p.w_st + q));
      else if (part == 3 && cb + q < p.V)
        x = load_f32(p.v, p.v_dt, vo + t * p.v_st + q);
      in[tid] = x;
    }
    __syncthreads();
    if (warp == 0) {
      float bs = 0.f;
      for (int q = lane; q < p.K; q += 32)
        bs += in[q] * us[q] * in[kMaxK + q];
      bs = warp_sum(bs);
      if (lane == 0) bonus_s[t & 1] = bs;
    }
    const float* vv = in + 3 * kMaxK + 4 * j;
    float4 yp = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kStepRows; ++u) {
      const int row = rg + n_rg * u;
      if (row >= p.K) continue;
      const float rr = in[row], kk = in[kMaxK + row], e = in[2 * kMaxK + row];
      float4& s = st[u];
      yp.x += rr * s.x;
      yp.y += rr * s.y;
      yp.z += rr * s.z;
      yp.w += rr * s.w;
      s.x = e * s.x + kk * vv[0];
      s.y = e * s.y + kk * vv[1];
      s.z = e * s.z + kk * vv[2];
      s.w = e * s.w + kk * vv[3];
    }
    // the warp's row groups (lanes lanes apart), then the warps
    for (int off = lanes; off < 32; off <<= 1) {
      yp.x += __shfl_xor_sync(0xffffffffu, yp.x, off);
      yp.y += __shfl_xor_sync(0xffffffffu, yp.y, off);
      yp.z += __shfl_xor_sync(0xffffffffu, yp.z, off);
      yp.w += __shfl_xor_sync(0xffffffffu, yp.w, off);
    }
    if (lane < lanes) {
      float* rp = red[t & 1][warp] + 4 * j;
      rp[0] = yp.x;
      rp[1] = yp.y;
      rp[2] = yp.z;
      rp[3] = yp.w;
    }
    __syncthreads();
    const int col = cb + tid;
    if (tid < 4 * lanes && col < p.V) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kStepWarps; ++w) acc += red[t & 1][w][tid];
      acc += bonus_s[t & 1] * in[3 * kMaxK + tid];
      put(yb + (((long long)b * p.T + t) * p.H + h) * p.V + col, acc);
    }
  }
#pragma unroll
  for (int u = 0; u < kStepRows; ++u) {
    const int row = rg + n_rg * u;
    if (row >= p.K || nn <= 0) continue;
    float* q = p.s_out + sbase + (long long)row * p.V + c0;
    if (vec) {
      *reinterpret_cast<float4*>(q) = st[u];
    } else {
      q[0] = st[u].x;
      if (nn > 1) q[1] = st[u].y;
      if (nn > 2) q[2] = st[u].z;
      if (nn > 3) q[3] = st[u].w;
    }
  }
}

template <class TX, bool kTyped, int kNS, int kNV>
int launch_chunk(const Params& p, cudaStream_t st) {
  const int Kp = (p.K + 15) & ~15;
  const int bytes = chunk_smem_floats(kNS, kNV, Kp) * 4;
  void (*kernel)(Params) = &rwkv6_chunk_kernel<TX, kTyped, kNS, kNV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((p.V + kNV - 1) / kNV, p.H, p.B), kChunkThreads, bytes,
           st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, u and s0 (may be null) each with its own dtype code (kF32,
// kBF16 or kF16). y is written in r's dtype, the final state to s_out (f32;
// may be s0 itself). step: the step kernel, else the chunked one with
// `chunk` steps a chunk (32 or 64) and `cols` state columns a block (16 or
// 32); shapes other than the default take f32 inputs only.
extern "C" int sfp_rwkv6_scan_fwd(
    const void* r, int r_dt, const void* k, int k_dt, const void* v,
    int v_dt, const void* w, int w_dt, const void* u, int u_dt,
    const void* s0, int s0_dt, void* y, float* s_out, int B, int T,
    int H, int K, int V, int step, int chunk, int cols, long long r_sb,
    long long r_st, long long r_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long w_sb, long long w_st, long long w_sh, void* stream) {
  if (K < 1 || K > kMaxK || V < 1 || T < 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  const Params p{r,    k,    v,    w,    u,    s0,   y,    s_out,
                 k_dt, v_dt, w_dt, u_dt, s0_dt, B,   T,    H,
                 K,    V,    r_sb, r_st, r_sh, k_sb, k_st, k_sh,
                 v_sb, v_st, v_sh, w_sb, w_st, w_sh};
  const cudaStream_t st = (cudaStream_t)stream;
  if (step) {
    int lanes = 1;
    while (4 * lanes < V && 4 * lanes < kStepCols) lanes *= 2;
    const int align = s0_dt == kF32 ? 16 : 8;
    const bool vec = V % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(s_out) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(s0) % align == 0;
    const dim3 grid((V + 4 * lanes - 1) / (4 * lanes), H, B);
    return with_dtype(r_dt, [&](auto ar) {
      using TX = typename decltype(ar)::type;
      rwkv6_step_kernel<TX><<<grid, kStepThreads, 0, st>>>(p, lanes, vec);
      return (int)cudaGetLastError();
    });
  }
  // k and v of r's dtype and w f32: the chunked kernel's typed
  // instantiation, the serving path's; any other mix reads them through
  // their codes
  const bool typed = k_dt == r_dt && v_dt == r_dt && w_dt == kF32;
  if (chunk != kSub * kDefNS || cols != kDefNV) {
    if (!(typed && r_dt == kF32)) return (int)cudaErrorInvalidValue;
    if (chunk == 32 && cols == 16)
      return launch_chunk<float, true, 2, 16>(p, st);
    if (chunk == 64 && cols == 16)
      return launch_chunk<float, true, 4, 16>(p, st);
    if (chunk == 64 && cols == 32)
      return launch_chunk<float, true, 4, 32>(p, st);
    return (int)cudaErrorInvalidValue;
  }
  return with_dtype(r_dt, [&](auto ar) {
    using TX = typename decltype(ar)::type;
    return typed ? launch_chunk<TX, true, kDefNS, kDefNV>(p, st)
                 : launch_chunk<TX, false, kDefNS, kDefNV>(p, st);
  });
}
