// Mamba-2 SSD scan for Hopper (sm_90a): a chunked kernel on 3xTF32 tensor
// cores for prefill and a bandwidth-shaped step kernel for decode, behind
// the one entry point sfp_mamba2_scan_fwd.
//
// Replaces the TPU kernel repro/kernels/mamba2_scan/kernel.py::mamba2_fwd
// (def at line 83). Per (batch b, head h), with the scalar decay
// a_t = exp(dt_t A_h) and the head's group g = h / (H / G) of B and C:
//
//   h_t[p, n] = a_t h_{t-1}[p, n] + (dt_t x_t[p]) B_t[n]
//   y_t[p]    = sum_n h_t[p, n] C_t[n]
//
// from the carried state h0 (or zeros). The TPU wrapper's moveaxis to
// (BH, T, .) and its padding of T to a multiple of the chunk are TPU layout
// only: both kernels read x, dt, B and C in the op's (B, T, H|G, .) layout
// through strides, and treat steps past T as the padding would (dt 0: a
// decay of 1 and no input; their y is not written).
//
// mamba2_chunk_kernel (T above the crossover): the SSD chunked form the TPU
// kernel computes. Grid (ceil(P / 32), H, B): a block owns 32 rows p of
// the head's state (rows evolve independently, so the split is exact;
// batch-1 prefill at zamba2's H 80, P 64 makes 160 blocks), keeps them in
// shared memory across the chunks, reads them once and writes them once.
// Per chunk of kC = 32 steps it stages x[:, its 32 rows], B and C of the
// group in shared memory as f32 (cp.async for f32, a widening load for
// bf16 and f16; N and the rows padded to multiples of 8 with zeros), two
// stages deep up to N 328: the next chunk's copies (and its dt, held in a
// register) are in flight while this one computes. Above N 328 two stages
// pass the 227 KB of shared memory a block may have, and one stage is
// refilled after each chunk (up to N 568, 226 KB). With la = dt A,
// acum_t = sum la over [0, t] and L[t, s] = exp(sum la over (s, t]) for
// s <= t, else 0:
//
//   M  = L o (C B^T)                              (kC x kC, depth N)
//   Y  = exp(acum_t) (C h^T) + M (dt x)           (kC x 32, depth N + kC)
//   h <- exp(acum_last) h + (dt x)^T (B o exp(sum la over (s, kC)))
//                                                 (32 x N, depth kC)
//
// The TPU kernel takes L's argument as acum_t - acum_s; here every
// argument is a sum of la's, which share one sign, put together from sums
// within and between groups of 8 steps, so no f32 cancellation enters
// exp (step 2 of the kernel says why it matters).
//
// All products run on mma.sync m16n8k8 TF32 in the 3xTF32 split of
// mma_tf32.cuh, which keeps f32 accuracy; each k-step's three products go
// to a fresh accumulator that is added to the running sum in f32, so the
// k-steps overlap and the long sums round to nearest. M is computed on
// its lower-triangular tiles only, and Y's intra-chunk depth only up to
// each row tile's last step. Shared row strides are N + 4 (kC + 4 for M)
// and 40 for dt x, so fragment loads hit distinct banks (the second use
// of B, as a k-major operand, is 2-way). 60 KB of shared memory at N 64:
// three blocks an SM. A chunk of 64 ran slower at zamba2's prefill: its
// intra-chunk products grow with kC^2, and with two stages a block would
// take 120 KB, one an SM.
//
// mamba2_step_kernel (T up to the crossover, every decode step): grid
// (H, B), 256 threads. Each thread owns four contiguous state columns of
// two rows a pass: one 16-byte load and store of f32 state each (8 bytes
// at bf16 or f16), neighbouring lanes on neighbouring addresses, both
// loads in flight before the first use. The state stays in registers over
// the steps; one warp-shuffle reduction over a row's lanes gives y[p].
// N <= 128 (32 lanes of 4 columns a row).
//
// Bound on this card, at zamba2's heads (H 80, P = N = 64): decode (8
// slots, T 1) is all state traffic, 2 x 8*80*64*64*4 B = 21 MB read and
// written once, 6.3 us at 3.35 TB/s; the step kernel is shaped for it.
// Prefill (batch 1, T 132) is bound by operations, counted as the
// sequential recurrence's 5 flops a state entry a step at the fp32 pipe's
// 67 TFLOP/s: 3.2 us. The chunked kernel does more flops than that (the
// kC x kC intra-chunk products, three TF32 passes each) but on tensor
// cores, and replaces T dependent steps by T / kC chunks of products.
//
// The final state goes to a caller-given f32 buffer, which may be the
// input state itself: the serving caches update in place and no copy of
// the state follows the launch. Aliasing is safe in both kernels: a chunk
// block reads its own rows before the first chunk and writes them after
// the last, and no other block touches them; a step thread reads and
// writes the same elements, and no other thread touches them. The loads
// of the state are not marked read-only (no __ldg) for that reason.
//
// Crossover: the wrapper (kernels/mamba2_scan/kernel.py, STEP_MAX_T = 4)
// picks the step kernel for T <= 4 and N <= 128, the chunked kernel
// otherwise: chip_smoke.py's sweep over T 1-16 at zamba2's heads put the
// two level at T 4 for one slot and at T 8-16 for eight. Both are
// hand-written kernels: this is dispatch by shape.
//
// x (the kernels' TX: f32, bf16 or f16), B, C, dt, A and h0 each have
// their own dtype code, as the TPU kernel reads each with astype(f32).
// Each kernel is built twice per TX, picked once at the entry: typed, for
// the serving path's mix (B and C of x's dtype; an f32 state for the step
// kernel, two stages for the chunked one), and coded, which widens B, C
// and h0 through their codes (a branch uniform over the launch) and takes
// any other mix; the coded reads cost 5-6% of the device time at
// zamba2's shapes (tools/time_mamba2.py). dt and A are read by load_f32.
// y is written in x's dtype (one round to nearest even), the state in
// f32. IEEE expf (no fast math). Sums run in another order than the plain
// sequential version's, so the two agree to f32 rounding, not bit for
// bit.

#include <cuda_runtime.h>

#include "dtype.cuh"
#include "mma_tf32.cuh"
#include "scan_common.cuh"

namespace {

using namespace sfp;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPb = 32;          // state rows a chunk block
constexpr int kLDX = kPb + 8;    // shared row stride of dt x
constexpr int kStepRows = 2;     // rows a step thread holds (the fastest
                                 // of 1, 2 and 4 at zamba2's decode)
constexpr int kSmemMax = 232448;

struct Params {
  const void* x;     // of the kernel's element type TX
  const void* Bm;
  const void* Cm;
  const void* dt;
  const void* A;
  const void* h0;    // null: zero initial state
  void* y;           // in TX
  float* h_out;      // may be h0
  int b_dt, c_dt, dt_dt, a_dt, h0_dt;  // dtype codes
  int B, T, H, G, P, N;
  long long x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh;
  long long b_sb, b_st, b_sg, c_sb, c_st, c_sg;
};

constexpr int kC = 32;           // steps a chunk (32 measured faster than 64)
constexpr int kNG = kC / 8;      // groups of 8 steps a chunk

// Shared floats of one stage of a chunk's inputs, for Np = N rounded up
// to 8: C and B (kC x (Np + 4)), x / dt x (kC x 40) and dt (kC).
__host__ __device__ constexpr int chunk_stage_floats(int Np) {
  return 2 * kC * (Np + 4) + kC * kLDX + kC;
}

// Shared floats of a chunk block: `stages` stages, the state rows (32 x
// (Np + 4)), M (kC x (kC + 4)), exp(acum), the state weights and the
// in-group sums lc and rc (kC each), the same-group exponents (kC x 8)
// and the sums between groups (kNG^2).
constexpr int chunk_smem_floats(int Np, int stages) {
  return stages * chunk_stage_floats(Np) + kPb * (Np + 4) + kC * (kC + 4) +
         12 * kC + kNG * kNG;
}

// kTyped: B and C of x's element type TX and two stages of inputs, both
// known at compile time (the serving path's instantiation). Otherwise B
// and C are read through their dtype codes, and two_stages says whether
// two stages fit (else one, refilled after each chunk).
template <class TX, bool kTyped>
__global__ void __launch_bounds__(kThreads)
mamba2_chunk_kernel(Params p, bool two_stages) {
  const bool two = kTyped || two_stages;
  static_assert(kPb == 32, "a warp's lanes stage one step's 32 rows of x");
  constexpr int kMT = kC / 16;              // row tiles of a chunk
  constexpr int kTri = kMT * (kMT + 1);     // M's lower-triangular n8 tiles
  constexpr int kQ = 4 * kMT / kWarps;      // Y's n8 tiles a warp
  constexpr int kPL = kC / 32;              // steps a lane of the scan
  constexpr int kLDM = kC + 4;
  extern __shared__ __align__(16) float smem[];
  const int Np = (p.N + 7) & ~7, ldn = Np + 4;
  const int sf = chunk_stage_floats(Np);
  // stage c & 1 of chunk c: C (kC, ldn), B (kC, ldn; then B o w), x (kC,
  // kLDX; then dt x), dt (kC)
  auto stage_of = [&](int c) { return smem + (two ? c & 1 : 0) * sf; };
  float* hs = smem + (two ? 2 : 1) * sf;  // the block's state rows (32, ldn)
  float* ms = hs + kPb * ldn;       // M (kC, kLDM)
  float* ea = ms + kC * kLDM;       // exp(acum), acum_t = sum la over [0, t]
  float* ws = ea + kC;              // exp(sum la over (s, kC))
  float* lc = ws + kC;              // sum la over [8 (t / 8), t]
  float* rc = lc + kC;              // sum la over (s, 8 (s / 8) + 7]
  float* seg = rc + kC;             // [t][j]: sum la over (8 (t / 8) + j, t]
  float* mid = seg + kC * 8;        // [ks][kt]: sum la over the groups
  //                                   strictly between ks and kt

  const int p0 = blockIdx.x * kPb, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row, column in quad
  const int rows = min(kPb, p.P - p0);
  const int n_chunks = (p.T + kC - 1) / kC;
  const float A = load_f32(p.A, p.a_dt, h);
  const TX* xb = static_cast<const TX*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const long long bo = b * p.b_sb + g * p.b_sg, co = b * p.c_sb + g * p.c_sg;
  const long long dto = b * p.dt_sb + h * p.dt_sh;
  const long long sbase =
      (((long long)b * p.H + h) * p.P + p0) * (long long)p.N;

  // Start chunk c's copies into its stage (x, B, C zero past T, P and N)
  // and return this thread's dt of it (thread s < kC: step s; 0 past T),
  // stored into the stage later, so the load's latency is not waited on
  // here.
  auto issue = [&](int c) {
    float* st = stage_of(c);
    const int t0 = c * kC, nt = min(kC, p.T - t0);
    for (int s = warp; s < kC; s += kWarps) {
      const bool live = s < nt;
      const long long t = t0 + s;
      stage(st + 2 * kC * ldn + s * kLDX + lane, xb + t * p.x_st + lane,
            live && lane < rows, xb);
      for (int n = lane; n < Np; n += 32) {
        const bool in = live && n < p.N;
        stage_elem<kTyped, TX>(st + kC * ldn + s * ldn + n, p.Bm, p.b_dt,
                             bo + t * p.b_st + n, in);
        stage_elem<kTyped, TX>(st + s * ldn + n, p.Cm, p.c_dt,
                             co + t * p.c_st + n, in);
      }
    }
    cp_async_commit();
    return tid < nt ? load_f32(p.dt, p.dt_dt, dto + (t0 + tid) * p.dt_st)
                    : 0.f;
  };
  auto dts_of = [&](int c) { return stage_of(c) + 2 * kC * ldn + kC * kLDX; };

  float dt_next = n_chunks > 0 ? issue(0) : 0.f;
  // the block's rows of h0, zero past P and N (the pads stay zero)
  for (int r = warp; r < kPb; r += kWarps)
    for (int n = lane; n < Np; n += 32)
      hs[r * ldn + n] = r < rows && n < p.N && p.h0 != nullptr
                            ? load_f32(p.h0, p.h0_dt,
                                       sbase + (long long)r * p.N + n)
                            : 0.f;
  if (n_chunks > 0 && tid < kC) dts_of(0)[tid] = dt_next;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kC, nt = min(kC, p.T - t0);
    float* cs = stage_of(c);
    float* bs = cs + kC * ldn;
    float* dtx = bs + kC * ldn;
    const float* dts = dts_of(c);
    // 1. the next chunk's copies start (two stages); this chunk's have
    //    landed
    if (two && c + 1 < n_chunks) {
      dt_next = issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 2. The decays, la = dt A. Every exponent is a sum of la's, all of
    //    one sign, and never the difference of two cumsums: acum reaches
    //    hundreds within a chunk at zamba2's decays, and acum_t - acum_s
    //    would carry f32 rounding of that size into exp's argument (the
    //    TPU kernel's form; at chunk 64 its f32 y is 8e-5 from an f64
    //    reference, the sequential recurrence's 2e-6). Warp 0: exp of the
    //    inclusive prefix and of the exclusive suffix; the others: the
    //    in-group and between-group sums that make up exp's argument in
    //    M, and dt x.
    if (warp == 0) {
      float la[kPL], pre[kPL], run = 0.f;
#pragma unroll
      for (int i = 0; i < kPL; ++i) {
        la[i] = dts[lane * kPL + i] * A;
        run += la[i];
        pre[i] = run;
      }
      float inc = run, sinc = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, off);
        const float w = __shfl_down_sync(0xffffffffu, sinc, off);
        if (lane >= off) inc += v;
        if (lane + off < 32) sinc += w;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      float suf = __shfl_down_sync(0xffffffffu, sinc, 1);
      if (lane == 0) excl = 0.f;
      if (lane == 31) suf = 0.f;
#pragma unroll
      for (int i = kPL - 1; i >= 0; --i) {
        const int s = lane * kPL + i;
        ea[s] = expf(excl + pre[i]);
        ws[s] = expf(suf);
        suf += la[i];
      }
    } else {
      // each sum a fixed, unrolled count of masked terms, so its loads
      // issue together
      const int u = tid - 32, nu = kThreads - 32;
      for (int t = u; t < kC; t += nu) {
        const int k0 = t & ~7;
        float a = 0.f, e = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float v = dts[k0 + q] * A;
          if (k0 + q <= t) a += v; else e += v;
        }
        lc[t] = a;
        rc[t] = e;
      }
      for (int i = u; i < kC * 8; i += nu) {
        const int t = i >> 3, j = i & 7, k0 = t & ~7;
        if (j > (t & 7)) continue;
        float e = 0.f;
#pragma unroll
        for (int q = 1; q < 8; ++q)
          if (j + q <= (t & 7)) e += dts[k0 + j + q] * A;
        seg[i] = e;
      }
      for (int i = u; i < kNG * kNG; i += nu) {
        const int ks = i / kNG, kt = i - ks * kNG;
        float m = 0.f;
#pragma unroll
        for (int r = 8; r < kC - 8; ++r)
          if (r >= 8 * (ks + 1) && r < 8 * kt) m += dts[r] * A;
        mid[i] = m;
      }
      for (int i = u; i < kC * kPb; i += nu) {
        const int s = i / kPb, q = i - s * kPb;
        dtx[s * kLDX + q] *= dts[s];
      }
    }
    __syncthreads();

    // 3. M = L o (C B^T) on the tiles at or below the diagonal
    for (int tile = warp; tile < kTri; tile += kWarps) {
      int i = 0;
      while ((i + 1) * (i + 2) <= tile) ++i;
      const int r0 = 16 * i, c0 = 8 * (tile - i * (i + 1));
      float acc[4] = {};
#pragma unroll 4
      for (int k0 = 0; k0 < Np; k0 += 8) {
        uint32_t ab[4], as[4], b2[2], s2[2];
        frag_a(cs + (r0 + gr) * ldn + k0 + tq, ldn, ab, as);
        frag_b(bs + (c0 + gr) * ldn + k0 + tq, 4, b2, s2);
        mma3(acc, ab, as, b2, s2);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + gr + (e >> 1) * 8, s = c0 + 2 * tq + (e & 1);
        const int kt = r >> 3, ks = s >> 3;
        ms[r * kLDM + s] =
            s <= r ? expf(kt == ks ? seg[r * 8 + (s & 7)]
                                   : (rc[s] + lc[r]) + mid[ks * kNG + kt]) *
                         acc[e]
                   : 0.f;
      }
    }
    __syncthreads();

    // 4. Y = exp(acum_t) (C h^T) + M (dt x); then B o w for step 5
    {
      const int i = warp % kMT, q0 = (warp / kMT) * kQ, r0 = 16 * i;
      float acc[kQ][4] = {};
#pragma unroll 4
      for (int k0 = 0; k0 < Np; k0 += 8) {
        uint32_t ab[4], as[4];
        frag_a(cs + (r0 + gr) * ldn + k0 + tq, ldn, ab, as);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          uint32_t b2[2], s2[2];
          frag_b(hs + (8 * (q0 + q) + gr) * ldn + k0 + tq, 4, b2, s2);
          mma3(acc[q], ab, as, b2, s2);
        }
      }
      const float e0 = ea[r0 + gr], e1 = ea[r0 + gr + 8];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        acc[q][0] *= e0;
        acc[q][1] *= e0;
        acc[q][2] *= e1;
        acc[q][3] *= e1;
      }
#pragma unroll
      for (int k0 = 0; k0 < kC; k0 += 8) {
        if (k0 >= r0 + 16) break;  // M is 0 past the row tile's last step
        uint32_t ab[4], as[4];
        frag_a(ms + (r0 + gr) * kLDM + k0 + tq, kLDM, ab, as);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          uint32_t b2[2], s2[2];
          frag_b(dtx + (k0 + tq) * kLDX + 8 * (q0 + q) + gr, 4 * kLDX, b2,
                 s2);
          mma3(acc[q], ab, as, b2, s2);
        }
      }
      TX* yb = static_cast<TX*>(p.y);
#pragma unroll
      for (int q = 0; q < kQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + gr + (e >> 1) * 8;
          const int col = 8 * (q0 + q) + 2 * tq + (e & 1);
          if (r < nt && col < rows)
            put(yb + (((long long)b * p.T + t0 + r) * p.H + h) * p.P + p0 +
                    col,
                acc[q][e]);
        }
    }
    for (int s = warp; s < kC; s += kWarps) {
      const float w = ws[s];
      for (int n = lane; n < Np; n += 32) bs[s * ldn + n] *= w;
    }
    __syncthreads();

    // 5. h <- exp(acum_last) h + (dt x)^T (B o w)
    {
      const float etot = ea[kC - 1];
      const int m0 = 16 * (warp & 1), nt8 = Np / 8;
      for (int jp = 2 * (warp >> 1); jp < nt8; jp += 8) {
        float acc[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* hp = hs + (m0 + gr + (e >> 1) * 8) * ldn +
                              8 * (jp + jj) + 2 * tq + (e & 1);
            acc[jj][e] = jp + jj < nt8 ? etot * *hp : 0.f;
          }
#pragma unroll
        for (int k0 = 0; k0 < kC; k0 += 8) {
          // A[p][s] = dt x[s][p]: a0 (p, s), a1 (p + 8, s), a2 (p, s + 4)
          uint32_t ab[4], as[4];
          const float* ap = dtx + (k0 + tq) * kLDX + m0 + gr;
          split_tf32(ap[0], ab[0], as[0]);
          split_tf32(ap[8], ab[1], as[1]);
          split_tf32(ap[4 * kLDX], ab[2], as[2]);
          split_tf32(ap[4 * kLDX + 8], ab[3], as[3]);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            if (jp + jj >= nt8) continue;  // uniform over the warp
            uint32_t b2[2], s2[2];
            frag_b(bs + (k0 + tq) * ldn + 8 * (jp + jj) + gr, 4 * ldn, b2,
                   s2);
            mma3(acc[jj], ab, as, b2, s2);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          if (jp + jj >= nt8) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hs[(m0 + gr + (e >> 1) * 8) * ldn + 8 * (jp + jj) + 2 * tq +
               (e & 1)] = acc[jj][e];
        }
      }
    }
    if (two && c + 1 < n_chunks && tid < kC) dts_of(c + 1)[tid] = dt_next;
    __syncthreads();
    // one stage: the next chunk's copies start once this one is consumed
    if (!two && c + 1 < n_chunks) {
      dt_next = issue(c + 1);
      if (tid < kC) dts_of(c + 1)[tid] = dt_next;
    }
  }

  // the block's rows of the final state (each thread the elements it
  // initialised, or, after a chunk, past the last __syncthreads)
  for (int r = warp; r < rows; r += kWarps)
    for (int n = lane; n < p.N; n += 32)
      p.h_out[sbase + (long long)r * p.N + n] = hs[r * ldn + n];
}

// lanes: a row's lanes, the least power of two >= ceil(N / 4) (<= 32);
// vec: N % 4 == 0 and h0 and h_out aligned for vector accesses.
template <class TX, bool kTyped>
__global__ void __launch_bounds__(kThreads)
mamba2_step_kernel(Params p, int lanes, bool vec) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  const int j = tid & (lanes - 1), r = tid / lanes;
  const int rows_a_pass = kThreads / lanes;
  const int n0 = 4 * j, nn = p.N - n0;  // this thread's columns, live ones
  const float A = load_f32(p.A, p.a_dt, h);
  const TX* xb = static_cast<const TX*>(p.x) + b * p.x_sb + h * p.x_sh;
  const long long bo = b * p.b_sb + g * p.b_sg + n0;
  const long long co = b * p.c_sb + g * p.c_sg + n0;
  const long long dto = b * p.dt_sb + h * p.dt_sh;
  const long long sbase = ((long long)b * p.H + h) * p.P * (long long)p.N;
  TX* yb = static_cast<TX*>(p.y);

  // every thread runs every pass (the shuffles take whole warps)
  for (int pass = 0; pass < p.P; pass += rows_a_pass * kStepRows) {
    float4 st[kStepRows];
#pragma unroll
    for (int u = 0; u < kStepRows; ++u) {
      const int row = pass + r + rows_a_pass * u;
      st[u] = row < p.P && nn > 0 && p.h0 != nullptr
                  ? state4_of<kTyped>(p.h0, p.h0_dt,
                              sbase + (long long)row * p.N + n0, nn, vec)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int t = 0; t < p.T; ++t) {
      const float dtt = load_f32(p.dt, p.dt_dt, dto + t * p.dt_st);
      const float a = expf(dtt * A);
      const float4 bv = four_of<kTyped, TX>(p.Bm, p.b_dt, bo + t * p.b_st,
                                            nn);
      const float4 cv = four_of<kTyped, TX>(p.Cm, p.c_dt, co + t * p.c_st,
                                            nn);
#pragma unroll
      for (int u = 0; u < kStepRows; ++u) {
        const int row = pass + r + rows_a_pass * u;
        const float xd =
            row < p.P ? dtt * to_f32(xb[t * p.x_st + row]) : 0.f;
        float4& s = st[u];
        s.x = a * s.x + xd * bv.x;
        s.y = a * s.y + xd * bv.y;
        s.z = a * s.z + xd * bv.z;
        s.w = a * s.w + xd * bv.w;
        float acc = (s.x * cv.x + s.y * cv.y) + (s.z * cv.z + s.w * cv.w);
        for (int off = lanes >> 1; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (j == 0 && row < p.P)
          put(yb + (((long long)b * p.T + t) * p.H + h) * p.P + row, acc);
      }
    }
#pragma unroll
    for (int u = 0; u < kStepRows; ++u) {
      const int row = pass + r + rows_a_pass * u;
      if (row >= p.P || nn <= 0) continue;
      float* q = p.h_out + sbase + (long long)row * p.N + n0;
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
}

}  // namespace

// x, Bm, Cm, dt, A and h0 (may be null) each with its own dtype code
// (kF32, kBF16 or kF16). y is written in x's dtype, the final state to
// h_out (f32; may be h0 itself). step: the step kernel (N <= 128), else
// the chunked one (N <= 568).
extern "C" int sfp_mamba2_scan_fwd(
    const void* x, int x_dt, const void* Bm, int b_dt, const void* Cm,
    int c_dt, const void* dt, int dt_dt, const void* A, int a_dt,
    const void* h0, int h0_dt, void* y,
    float* h_out, int B, int T, int H, int G, int P, int N, int step,
    long long x_sb, long long x_st, long long x_sh, long long dt_sb,
    long long dt_st, long long dt_sh, long long b_sb, long long b_st,
    long long b_sg, long long c_sb, long long c_st, long long c_sg,
    void* stream) {
  if (G < 1 || H % G || P < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  const Params p{x,     Bm,    Cm,    dt,    A,    h0,    y,     h_out,
                 b_dt,  c_dt,  dt_dt, a_dt,  h0_dt, B,    T,     H,
                 G,     P,     N,     x_sb,  x_st, x_sh,  dt_sb, dt_st,
                 dt_sh, b_sb,  b_st,  b_sg,  c_sb, c_st,  c_sg};
  const cudaStream_t st = (cudaStream_t)stream;
  // B and C of x's dtype (and an f32 state for the step kernel, two stages
  // for the chunked one): the typed instantiation, the serving path's; any
  // other mix reads B, C and the state through their codes, which costs
  // the path 5-6% of its device time at zamba2's shapes
  const bool typed = b_dt == x_dt && c_dt == x_dt;
  if (step) {
    int lanes = 1;
    while (4 * lanes < N) lanes *= 2;
    if (lanes > 32) return (int)cudaErrorInvalidValue;
    const int align = h0_dt == kF32 ? 16 : 8;
    const bool vec = N % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(h_out) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(h0) % align == 0;
    return with_dtype(x_dt, [&](auto ax) {
      using TX = typename decltype(ax)::type;
      if (typed && h0_dt == kF32)
        mamba2_step_kernel<TX, true><<<dim3(H, B), kThreads, 0, st>>>(
            p, lanes, vec);
      else
        mamba2_step_kernel<TX, false><<<dim3(H, B), kThreads, 0, st>>>(
            p, lanes, vec);
      return (int)cudaGetLastError();
    });
  }
  const int Np = (N + 7) & ~7;
  const bool two = chunk_smem_floats(Np, 2) * 4 <= kSmemMax;
  const int bytes = chunk_smem_floats(Np, two ? 2 : 1) * 4;
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  return with_dtype(x_dt, [&](auto ax) {
    using TX = typename decltype(ax)::type;
    void (*kernel)(Params, bool) = typed && two
                                       ? &mamba2_chunk_kernel<TX, true>
                                       : &mamba2_chunk_kernel<TX, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((P + kPb - 1) / kPb, H, B), kThreads, bytes, st>>>(p,
                                                                     two);
    return (int)cudaGetLastError();
  });
}
