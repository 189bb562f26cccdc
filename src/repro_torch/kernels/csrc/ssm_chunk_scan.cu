// Mamba2 SSD chunked scan for Hopper (sm_90a): per (batch, head), the
// selective state-space recurrence
//     h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t (x) B_t      (P x N, fp32)
//     y_t = C_t . h_t
// computed chunk-parallel as the SSD algorithm does: a causal,
// attention-like quadratic term inside each chunk of Lc positions, plus
// the state carried in from the chunks before.  Returns fp32 y and the
// fp32 final state (the model adds D * x in fp32 before its cast).
//
// Replaces: the Pallas TPU kernel repro/kernels/ssm_scan.py
// (ssm_chunk_scan_kernel), the kernel form of
// repro/models/ssm.py::ssd_chunked, which every Mamba2 block's prefill
// (mamba2_fwd) runs once.
//
// Layouts (strides in elements; the last axis of each is contiguous):
//   x       (B, S, H, P)   f32 or bf16, read through batch/seq/head strides
//   dt      (B, S, H)      f32, contiguous, post-softplus
//   A       (H,)           f32, negative
//   Bm, Cm  (B, S, G, N)   x's type, G groups: head h reads group
//                          h / (H / G) (G == H is the repeated layout)
//   y       (B, S, H, P)   f32, contiguous
//   h_out   (B, H, P, N)   f32, contiguous
//   work    (B, H, nc, P, N) chunk states, then (B, H, nc) chunk decays
// P and N multiples of 16 up to 128; Lc = the chunk up to 1024 with
// S % Lc == 0 (the reference's contract).  bf16 x/B/C also need 16-byte
// aligned rows (data pointers % 16, strides % 8): their tiles are copied
// with cp.async.
//
// The TPU kernel walks each (batch, head)'s chunks in order on one core,
// carrying the state in VMEM.  Here that would be 112 CTAs for 132 SMs,
// so the work is cut in three launches that are each parallel over
// chunks:
//   1. chunk_state: one CTA per (b, h, chunk) computes the chunk's local
//      end state sum_s exp(l_L - l_s) dt_s x_s (x) B_s and its decay
//      exp(l_L), where l is the chunk's cumsum of dt * A.
//   2. state_scan: one thread per (b, h, p, n) runs the short sequential
//      recurrence h <- exp(l_L) h + hc over the chunks, leaving in the
//      workspace the state that enters each chunk and writing the final
//      state.
//   3. chunk_output: one CTA per (b, h, chunk, 64 rows t) computes
//      y_t = exp(l_t) C_t . h_in  +  sum_{s <= t} (C_t . B_s)
//            exp(l_t - l_s) dt_s x_s,
//      the intra-chunk term tiled like causal attention without softmax:
//      64 x 64 tiles of s, tiles above the diagonal never visited.  The
//      Lc x Lc weight matrix (256 KB at Lc = 256) never exists whole.
// The decay exp(l_t - l_s) is computed only for s <= t: l falls along
// the chunk, so for s > t it can overflow to inf, and inf * 0 is NaN.
// The chunk cumsum is one deterministic block scan that both kernels
// call; nothing uses atomics, so a launch repeats its bits.
//
// What bounds it: at the main shape (B = 4, S = 512, H = 112, P = N =
// 64, Lc = 256) the function moves ~97 MB (x/B/C read once, fp32 y and
// state written) and does ~10.4 GFLOP: 0.029 ms of bytes against 0.011
// ms of bf16 tensor-core operations, so bytes, if the products run on
// the tensor cores.  Each type gets its own design:
//
// bf16 x/B/C (every serve path): the tensor cores, warp-level mma.sync
// (mma_sm90.cuh), 4 warps a CTA; x, B and C tiles of 64 rows stay bf16
// in shared memory (rows padded by 16 bytes), loaded with cp.async into
// two-stage rings (tile j+1 in flight while tile j is computed).
//   * Scores C_t . B_s: m16n8k16 bf16 MMAs, C's A fragments loaded once
//     per CTA, B as the col-major operand.  A bf16 x bf16 product is
//     exact in fp32, so only the order of the sums differs from the
//     plain version, as it did with FMAs.
//   * W x, the chunk states and C . h_in have one fp32 operand: W (the
//     decay- and dt-weighted scores), w_s x_s, or the carried state.  The
//     other operand is bf16, which TF32 holds exactly.  The fp32 operand
//     is split into TF32 hi + lo (lo = tf32(v - hi)) and two m16n8k8
//     TF32 MMAs are issued, a product error of at most 2^-22 relative:
//     fp32-grade.  A single TF32 rounding of W (the lo half dropped)
//     errs 0.0896 in y at the main shape against atol 1e-3 + rtol 1e-4
//     (|y| ~250, cancelling terms; H100), so the split stays.
//   * W's register layout: the m16n8k16 accumulator layout of W is not
//     the TF32 A layout, so k is permuted inside every 8-block on both
//     operands (k = tig <-> 2tig, tig+4 <-> 2tig+1; see mma_sm90.cuh):
//     W's accumulators are then the A fragment as they stand, and x's B
//     fragment is one ldmatrix.trans of its row-major tile.  Nothing is
//     staged through shared memory.  The state kernel uses the same
//     permutation for w_s x_s (A, from ldmatrix.trans of x) and B_s.
//   * W x is summed per 16 columns of s into a fresh accumulator and
//     added to y's in fp32, so the tensor cores' own accumulation never
//     carries a sum of ~250 across a whole chunk.
//   * The decay is exp2((l_t - l_s) log2 e) on the SFU (ex2.approx.ftz):
//     the difference is taken first, in fp32, so the error is relative
//     to |l_t - l_s| (~1e-7 where the weight matters), not to |l_t| (up
//     to ~300 at the end of a chunk).  Only the diagonal tile (or rows
//     past Lc) tests s <= t.
//   * On the diagonal tile, warp w (rows 16w .. 16w+15) stops at s =
//     16w + 15: the blocks past it are all zero.
//
// fp32 x/B/C (the fp32 cross-checks and tests only): the CUDA cores,
// fp32 FMAs.  Those checks want full fp32 products, which TF32 would not
// give.  256 threads as 16 x 16, each a 4 x 4 (scores) or 4 x P/16
// (output) register tile from fp32 tiles in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;             // fp32 kernels: 16 x 16 threads
constexpr int kTcThreads = 128;           // tensor-core kernels: 4 warps
constexpr int kTile = 64;                 // rows t per CTA, columns s per tile
constexpr int kMaxWidth = 128;            // P and N
constexpr int kMaxChunk = 1024;
constexpr int kMaxJ = kMaxWidth / 16;     // 16-wide column groups
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  float* y;
  float* h_out;
  float* states;                          // (B, H, nc, P, N)
  float* decay;                           // (B, H, nc)
  long long xs[3], bs[3], cs[3];          // (batch, seq, head or group)
  int S, H, G, P, N, Lc, nc;
};

// The chunk's dt (dts) and inclusive cumsum of dt * A (cum), positions
// [0, Lc), by a block of NT threads: every thread takes kPerThread
// consecutive positions, then a warp scan and a scan of the warps'
// totals.  Deterministic, so the two kernels that call it see the same l
// (both kernels of a type run with the same NT).
template <int NT>
__device__ void chunk_cumsum(const float* __restrict__ dt, long long stride,
                             float A, int Lc, float* cum, float* dts) {
  constexpr int kPerThread = kMaxChunk / NT;
  __shared__ float warp_total[NT / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float part[kPerThread];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int s = tid * kPerThread + i;
    const float d = s < Lc ? dt[s * stride] : 0.f;
    if (s < Lc) dts[s] = d;
    run += d * A;
    part[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  float base = incl - run;
  for (int w = 0; w < warp; ++w) base += warp_total[w];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int s = tid * kPerThread + i;
    if (s < Lc) cum[s] = base + part[i];
  }
  __syncthreads();
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int round64(int n) { return (n + 63) & ~63; }

// ---- fp32, 1. chunk-local end states ---------------------------------------

__global__ void __launch_bounds__(kThreads)
chunk_state_f32_kernel(Params p) {
  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, g = h / (p.H / p.G);
  const int P = p.P, N = p.N, Lc = p.Lc;
  const int mi = P / 16, mj = N / 16;
  extern __shared__ float smem[];
  float* cum = smem;
  float* dts = cum + round4(Lc);
  float* xw = dts + round4(Lc);            // kTile x P: x_s * w_s
  float* bsm = xw + kTile * P;             // kTile x N
  const long long s0 = (long long)c * Lc;
  chunk_cumsum<kThreads>(p.dt + ((long long)b * p.S + s0) * p.H + h, p.H,
                         p.A[h], Lc, cum, dts);
  const float l_end = cum[Lc - 1];
  const float* x = (const float*)p.x + b * p.xs[0] + s0 * p.xs[1] +
                   h * p.xs[2];
  const float* Bm = (const float*)p.Bm + b * p.bs[0] + s0 * p.bs[1] +
                    g * p.bs[2];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[kMaxJ][kMaxJ];                 // rows p = ty + 16 i, cols n = tx + 16 j
#pragma unroll
  for (int i = 0; i < kMaxJ; ++i)
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Lc; k0 += kTile) {
    const int nk = min(kTile, Lc - k0);
    for (int e = threadIdx.x; e < kTile * P; e += kThreads) {
      const int r = e / P, col = e - r * P;
      float v = 0.f;
      if (r < nk) {
        const int s = k0 + r;
        v = x[s * p.xs[1] + col] * (expf(l_end - cum[s]) * dts[s]);
      }
      xw[e] = v;
    }
    for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
      const int r = e / N, col = e - r * N;
      bsm[e] = r < nk ? Bm[(k0 + r) * p.bs[1] + col] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < nk; ++r) {
      float xv[kMaxJ], bv[kMaxJ];
#pragma unroll
      for (int i = 0; i < kMaxJ; ++i)
        if (i < mi) xv[i] = xw[r * P + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < mj) bv[j] = bsm[r * N + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMaxJ; ++i)
        if (i < mi)
#pragma unroll
          for (int j = 0; j < kMaxJ; ++j)
            if (j < mj) acc[i][j] += xv[i] * bv[j];
    }
    __syncthreads();
  }
  float* st = p.states + ((long long)bh * p.nc + c) * P * N;
#pragma unroll
  for (int i = 0; i < kMaxJ; ++i)
    if (i < mi)
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < mj) st[(ty + 16 * i) * N + tx + 16 * j] = acc[i][j];
  if (threadIdx.x == 0) p.decay[(long long)bh * p.nc + c] = expf(l_end);
}

// ---- 2. the recurrence across chunks (both types) --------------------------

__global__ void __launch_bounds__(kThreads) state_scan_kernel(Params p) {
  const int PN = p.P * p.N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= PN) return;
  float* st = p.states + (long long)bh * p.nc * PN + e;
  const float* dec = p.decay + (long long)bh * p.nc;
  float h = 0.f;
  for (int c = 0; c < p.nc; ++c) {
    const float local = st[(long long)c * PN];
    st[(long long)c * PN] = h;             // the state entering chunk c
    h = h * dec[c] + local;
  }
  p.h_out[(long long)bh * PN + e] = h;
}

// ---- fp32, 3. outputs: carried state plus the intra-chunk term -------------

__global__ void __launch_bounds__(kThreads)
chunk_output_f32_kernel(Params p) {
  const int qt = blockIdx.x;
  const int c = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / p.H, h = bh % p.H, g = h / (p.H / p.G);
  const int P = p.P, N = p.N, Lc = p.Lc, ldn = N + 1;
  const int mp = P / 16;
  extern __shared__ float smem[];
  float* cum = smem;
  float* dts = cum + round4(Lc);
  float* cq = dts + round4(Lc);            // kTile x ldn: C rows t
  float* kb = cq + kTile * ldn;            // max(kTile, P) x ldn: B rows / state
  float* xsm = kb + max(kTile, P) * ldn;   // kTile x P
  float* w = xsm + kTile * P;              // kTile x (kTile + 1)
  const long long s0 = (long long)c * Lc;
  chunk_cumsum<kThreads>(p.dt + ((long long)b * p.S + s0) * p.H + h, p.H,
                         p.A[h], Lc, cum, dts);
  const int t0 = qt * kTile;
  const int nq = min(kTile, Lc - t0);
  const float* x = (const float*)p.x + b * p.xs[0] + s0 * p.xs[1] +
                   h * p.xs[2];
  const float* Bm = (const float*)p.Bm + b * p.bs[0] + s0 * p.bs[1] +
                    g * p.bs[2];
  const float* Cm = (const float*)p.Cm + b * p.cs[0] + s0 * p.cs[1] +
                    g * p.cs[2];
  for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
    const int r = e / N, col = e - r * N;
    cq[r * ldn + col] = r < nq ? Cm[(t0 + r) * p.cs[1] + col] : 0.f;
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][kMaxJ];                     // rows t0 + ty + 16 i, cols tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) acc[i][j] = 0.f;

  if (c > 0) {                             // chunk 0 enters with h = 0
    const float* hin = p.states + ((long long)bh * p.nc + c) * P * N;
    for (int e = threadIdx.x; e < P * N; e += kThreads) {
      const int r = e / N, col = e - r * N;
      kb[r * ldn + col] = hin[e];
    }
    __syncthreads();
    for (int n = 0; n < N; ++n) {
      float cv[4], hv[kMaxJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cq[(ty + 16 * i) * ldn + n];
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < mp) hv[j] = kb[(tx + 16 * j) * ldn + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j)
          if (j < mp) acc[i][j] += cv[i] * hv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      const float e = t < Lc ? expf(cum[t]) : 0.f;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) acc[i][j] *= e;
    }
    __syncthreads();                       // kb is reused for B below
  }

  const int t_last = t0 + nq - 1;
  for (int k0 = 0; k0 <= t_last; k0 += kTile) {
    const int nk = min(kTile, Lc - k0);
    for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
      const int r = e / N, col = e - r * N;
      kb[r * ldn + col] = r < nk ? Bm[(k0 + r) * p.bs[1] + col] : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * P; e += kThreads) {
      const int r = e / P, col = e - r * P;
      xsm[e] = r < nk ? x[(k0 + r) * p.xs[1] + col] : 0.f;
    }
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cq[(ty + 16 * i) * ldn + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = kb[(tx + 16 * j) * ldn + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tl = ty + 16 * i, t = t0 + tl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sl = tx + 16 * j, s = k0 + sl;
        float wv = 0.f;
        if (s <= t && t < Lc)              // decay only where s <= t
          wv = sc[i][j] * expf(cum[t] - cum[s]) * dts[s];
        w[tl * (kTile + 1) + sl] = wv;
      }
    }
    __syncthreads();
    for (int sl = 0; sl < nk; ++sl) {
      float wv[4], xv[kMaxJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = w[(ty + 16 * i) * (kTile + 1) + sl];
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < mp) xv[j] = xsm[sl * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j)
          if (j < mp) acc[i][j] += wv[i] * xv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= Lc) continue;
    float* yrow = p.y + (((long long)b * p.S + s0 + t) * p.H + h) * P;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < mp) yrow[tx + 16 * j] = acc[i][j];
  }
}

size_t state_smem_f32(const Params& p) {
  return (2 * (size_t)round4(p.Lc) + (size_t)kTile * (p.P + p.N)) *
         sizeof(float);
}

size_t output_smem_f32(const Params& p) {
  const size_t ldn = p.N + 1;
  return (2 * (size_t)round4(p.Lc) + kTile * ldn +
          (size_t)(p.P > kTile ? p.P : kTile) * ldn + (size_t)kTile * p.P +
          (size_t)kTile * (kTile + 1)) *
         sizeof(float);
}

// ---- bf16: tensor cores ------------------------------------------------------

// Copies rows [r0, r0 + kTile) of a chunk's (rows, W) bf16 slab, row
// stride `ld` elements in device memory, into a [kTile][W + 8] tile;
// rows at or past `rows` are zero-filled.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int r0, int rows,
                                          int W) {
  const int ch = W / 8, lds = W + 8;
  for (int e = threadIdx.x; e < kTile * ch; e += kTcThreads) {
    const int r = e / ch, c = e - r * ch;
    const bool ok = r0 + r < rows;
    mma::cp_async16(dst + r * lds + c * 8, ok ? src + (r0 + r) * ld + c * 8
                                              : src, ok);
  }
}

// 1. chunk-local end states, (P x N) = (w x)^T B over the chunk's s.
// Warp w owns p rows 16 (w + 4 m), m < MT (P <= 64 MT), and all n tiles
// (N <= 8 NT).  A = w_s x_s (fp32, split), B = B_s (bf16, exact), k = s
// permuted inside each 8-block.
template <int MT, int NT>
__global__ void __launch_bounds__(kTcThreads)
chunk_state_tc_kernel(Params p) {
  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, g = h / (p.H / p.G);
  const int P = p.P, N = p.N, Lc = p.Lc;
  const int LX = P + 8, LB = N + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);
  float* dts = cum + round4(Lc);
  float* wsm = dts + round4(Lc);           // exp(l_L - l_s) dt_s, 0 past Lc
  bf16* xs = reinterpret_cast<bf16*>(wsm + round64(Lc));   // [2][kTile][LX]
  bf16* bs = xs + 2 * kTile * LX;                          // [2][kTile][LB]
  const long long s0 = (long long)c * Lc;
  const bf16* x = (const bf16*)p.x + b * p.xs[0] + s0 * p.xs[1] + h * p.xs[2];
  const bf16* Bm = (const bf16*)p.Bm + b * p.bs[0] + s0 * p.bs[1] +
                   g * p.bs[2];
  const int n_kt = (Lc + kTile - 1) / kTile;
  load_rows(xs, x, p.xs[1], 0, Lc, P);
  load_rows(bs, Bm, p.bs[1], 0, Lc, N);
  mma::cp_async_commit();
  chunk_cumsum<kTcThreads>(p.dt + ((long long)b * p.S + s0) * p.H + h, p.H,
                           p.A[h], Lc, cum, dts);
  const float l_end = cum[Lc - 1];
  for (int s = threadIdx.x; s < n_kt * kTile; s += kTcThreads)
    wsm[s] = s < Lc ? expf(l_end - cum[s]) * dts[s] : 0.f;
  // the first tile's __syncthreads below publishes wsm

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kTile, st = it & 1;
    if (it + 1 < n_kt) {
      load_rows(xs + (st ^ 1) * kTile * LX, x, p.xs[1], k0 + kTile, Lc, P);
      load_rows(bs + (st ^ 1) * kTile * LB, Bm, p.bs[1], k0 + kTile, Lc, N);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* xt = xs + st * kTile * LX;
    const bf16* bt = bs + st * kTile * LB;
#pragma unroll
    for (int ks = 0; ks < kTile; ks += 16) {     // two 8-blocks of s
      const float* w = wsm + k0 + ks + 2 * tig;
      const float w00 = w[0], w01 = w[1], w10 = w[8], w11 = w[9];
      uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int pr = (warp + 4 * m) * 16;
        if (pr >= P) continue;
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, xt + (ks + (lane & 7) + ((lane >> 4) << 3)) * LX + pr +
                   ((lane >> 3) & 1) * 8);
        const float a[2][4] = {
            {__uint_as_float(mma::bf16_lo(r[0])) * w00,
             __uint_as_float(mma::bf16_lo(r[1])) * w00,
             __uint_as_float(mma::bf16_hi(r[0])) * w01,
             __uint_as_float(mma::bf16_hi(r[1])) * w01},
            {__uint_as_float(mma::bf16_lo(r[2])) * w10,
             __uint_as_float(mma::bf16_lo(r[3])) * w10,
             __uint_as_float(mma::bf16_hi(r[2])) * w11,
             __uint_as_float(mma::bf16_hi(r[3])) * w11}};
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mma::split_tf32(a[k][e], ah[m][k][e], al[m][k][e]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (np * 16 >= N) break;
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, bt + (ks + (lane & 7) + ((lane >> 4) << 3)) * LB + np * 16 +
                   ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if ((warp + 4 * m) * 16 >= P) continue;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
#pragma unroll
            for (int n2 = 0; n2 < 2; ++n2) {
              const uint32_t bv = r[2 * k + n2];
              mma::mma_tf32(acc[m][2 * np + n2], al[m][k], mma::bf16_lo(bv),
                            mma::bf16_hi(bv));
              mma::mma_tf32(acc[m][2 * np + n2], ah[m][k], mma::bf16_lo(bv),
                            mma::bf16_hi(bv));
            }
          }
        }
      }
    }
    __syncthreads();                       // stage st is refilled next
  }
  float* stt = p.states + ((long long)bh * p.nc + c) * P * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int pr = (warp + 4 * m) * 16 + gid;
    if (pr >= P) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n * 8 >= N) break;
      const int col = n * 8 + 2 * tig;
      *reinterpret_cast<float2*>(stt + pr * N + col) =
          make_float2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<float2*>(stt + (pr + 8) * N + col) =
          make_float2(acc[m][n][2], acc[m][n][3]);
    }
  }
  if (threadIdx.x == 0) p.decay[(long long)bh * p.nc + c] = expf(l_end);
}

// 3. outputs for 64 rows t of one (b, h, chunk).  Warp w owns rows t0 +
// 16w .. +15 and all P columns (P <= 8 PT); C's A fragments cover N <=
// 16 NK.  At P, N <= 64 registers are capped at 168, so 3 CTAs share
// an SM (uncapped: 199, 2 CTAs).  The wider instances, on no serve
// path, use 232-255 and one CTA an SM; at P = N = 128 ptxas spills 20
// bytes.
template <int PT, int NK>
__global__ void __launch_bounds__(kTcThreads, PT == 8 && NK == 4 ? 3 : 1)
chunk_output_tc_kernel(Params p) {
  const int qt = blockIdx.x;
  const int c = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / p.H, h = bh % p.H, g = h / (p.H / p.G);
  const int P = p.P, N = p.N, Lc = p.Lc;
  const int LX = P + 8, LB = N + 8, LH = N + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);
  float* dts = cum + round4(Lc);
  float* hin = dts + round4(Lc);           // [P][LH] state entering chunk c
  bf16* cq = reinterpret_cast<bf16*>(hin + P * LH);   // [kTile][LB] C rows t
  bf16* bs = cq + kTile * LB;                         // [2][kTile][LB]
  bf16* xs = bs + 2 * kTile * LB;                     // [2][kTile][LX]
  const long long s0 = (long long)c * Lc;
  const int t0 = qt * kTile;
  const bf16* x = (const bf16*)p.x + b * p.xs[0] + s0 * p.xs[1] + h * p.xs[2];
  const bf16* Bm = (const bf16*)p.Bm + b * p.bs[0] + s0 * p.bs[1] +
                   g * p.bs[2];
  const bf16* Cm = (const bf16*)p.Cm + b * p.cs[0] + s0 * p.cs[1] +
                   g * p.cs[2];
  load_rows(cq, Cm, p.cs[1], t0, Lc, N);
  if (c > 0) {                             // chunk 0 enters with h = 0
    const float* src = p.states + ((long long)bh * p.nc + c) * P * N;
    const int ch = N / 4;
    for (int e = threadIdx.x; e < P * ch; e += kTcThreads) {
      const int r = e / ch, col = e - r * ch;
      mma::cp_async16(hin + r * LH + col * 4, src + r * N + col * 4, true);
    }
  }
  mma::cp_async_commit();
  const int n_kt = qt + 1;                 // s tiles up to the diagonal
  load_rows(bs, Bm, p.bs[1], 0, Lc, N);
  load_rows(xs, x, p.xs[1], 0, Lc, P);
  mma::cp_async_commit();
  chunk_cumsum<kTcThreads>(p.dt + ((long long)b * p.S + s0) * p.H + h, p.H,
                           p.A[h], Lc, cum, dts);
  mma::cp_async_wait<1>();                 // C rows and h_in
  __syncthreads();

  uint32_t cf[NK][4];
#pragma unroll
  for (int kd = 0; kd < NK; ++kd)
    if (kd * 16 < N)
      mma::ldmatrix_x4(cf[kd], cq + (warp * 16 + (lane & 15)) * LB + kd * 16 +
                                   (lane >> 4) * 8);
  const int ta = t0 + warp * 16 + gid, tb = ta + 8;   // chunk-local rows
  const float la = ta < Lc ? cum[ta] : 0.f, lb = tb < Lc ? cum[tb] : 0.f;
  const bool full = t0 + kTile <= Lc;     // every row t of the CTA valid
  float acc[PT][4];
#pragma unroll
  for (int n = 0; n < PT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (c > 0) {                             // exp(l_t) C_t . h_in
#pragma unroll
    for (int kd = 0; kd < NK; ++kd) {
      if (kd * 16 >= N) break;
#pragma unroll
      for (int k8 = 0; k8 < 2; ++k8) {
        const uint32_t a[4] = {mma::bf16_lo(cf[kd][2 * k8]),
                               mma::bf16_lo(cf[kd][2 * k8 + 1]),
                               mma::bf16_hi(cf[kd][2 * k8]),
                               mma::bf16_hi(cf[kd][2 * k8 + 1])};
        const int n0 = kd * 16 + k8 * 8 + 2 * tig;
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) {
          if (pt * 8 >= P) break;
          const float2 hv =
              *reinterpret_cast<const float2*>(hin + (pt * 8 + gid) * LH + n0);
          uint32_t h0, l0, h1, l1;
          mma::split_tf32(hv.x, h0, l0);
          mma::split_tf32(hv.y, h1, l1);
          mma::mma_tf32(acc[pt], a, l0, l1);
          mma::mma_tf32(acc[pt], a, h0, h1);
        }
      }
    }
    const float ea = ta < Lc ? expf(la) : 0.f;
    const float eb = tb < Lc ? expf(lb) : 0.f;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      acc[pt][0] *= ea;
      acc[pt][1] *= ea;
      acc[pt][2] *= eb;
      acc[pt][3] *= eb;
    }
  }

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kTile, st = it & 1;
    if (it + 1 < n_kt) {
      load_rows(bs + (st ^ 1) * kTile * LB, Bm, p.bs[1], k0 + kTile, Lc, N);
      load_rows(xs + (st ^ 1) * kTile * LX, x, p.xs[1], k0 + kTile, Lc, P);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* bt = bs + st * kTile * LB;
    const bf16* xt = xs + st * kTile * LX;
    // 16-column blocks of s this warp needs: all, or up to its own rows
    const int nb = it == qt ? warp + 1 : 4;
    // below the diagonal every s < t: no mask (unless rows pass Lc)
    const bool masked = it == qt || !full;

    float sc[8][4];                        // C_t . B_s, then W
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < NK; ++kd) {
      if (kd * 16 >= N) break;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np >= nb) break;
        uint32_t kb[4];
        mma::ldmatrix_x4(kb, bt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      LB + kd * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(sc[2 * np], cf[kd], kb[0], kb[1]);
        mma::mma_bf16(sc[2 * np + 1], cf[kd], kb[2], kb[3]);
      }
    }

#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np >= nb) break;
      // W = (C_t . B_s) exp(l_t - l_s) dt_s, the decay only where s <= t
#pragma unroll
      for (int n = 2 * np; n < 2 * np + 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? ta : tb;
          const int s = k0 + n * 8 + 2 * tig + (e & 1);
          if (masked && !(s <= t && t < Lc)) {
            sc[n][e] = 0.f;
          } else {
            const float d = (e < 2 ? la : lb) - cum[s];
            sc[n][e] = sc[n][e] * mma::ex2(d * kLog2e) * dts[s];
          }
        }
      // W as two TF32 A fragments (k permuted: a = c0, c2, c1, c3), split
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        mma::split_tf32(sc[2 * np + k][0], ah[k][0], al[k][0]);
        mma::split_tf32(sc[2 * np + k][2], ah[k][1], al[k][1]);
        mma::split_tf32(sc[2 * np + k][1], ah[k][2], al[k][2]);
        mma::split_tf32(sc[2 * np + k][3], ah[k][3], al[k][3]);
      }
      float part[PT][4];
#pragma unroll
      for (int n = 0; n < PT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
      for (int pp = 0; pp < PT / 2; ++pp) {
        if (pp * 16 >= P) break;
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, xt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LX +
                   pp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int n2 = 0; n2 < 2; ++n2) {
            const uint32_t bv = r[2 * k + n2];
            mma::mma_tf32(part[2 * pp + n2], al[k], mma::bf16_lo(bv),
                          mma::bf16_hi(bv));
            mma::mma_tf32(part[2 * pp + n2], ah[k], mma::bf16_lo(bv),
                          mma::bf16_hi(bv));
          }
      }
#pragma unroll
      for (int n = 0; n < PT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
    }
    __syncthreads();                       // stage st is refilled next
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? tb : ta;
    if (t >= Lc) continue;
    float* yrow = p.y + (((long long)b * p.S + s0 + t) * p.H + h) * P;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      if (pt * 8 >= P) break;
      *reinterpret_cast<float2*>(yrow + pt * 8 + 2 * tig) =
          make_float2(acc[pt][2 * half], acc[pt][2 * half + 1]);
    }
  }
}

size_t state_smem_tc(const Params& p) {
  return (2 * (size_t)round4(p.Lc) + round64(p.Lc)) * sizeof(float) +
         (size_t)2 * kTile * (p.P + 8 + p.N + 8) * sizeof(bf16);
}

size_t output_smem_tc(const Params& p) {
  return (2 * (size_t)round4(p.Lc) + (size_t)p.P * (p.N + 8)) *
             sizeof(float) +
         (size_t)kTile * (3 * (p.N + 8) + 2 * (p.P + 8)) * sizeof(bf16);
}

// The three launches, in order on one stream.
int launch_all(const Params& p, int B, cudaStream_t st, void (*state_k)(Params),
               size_t smem_a, void (*output_k)(Params), size_t smem_c,
               int threads) {
  cudaError_t err = cudaFuncSetAttribute(
      state_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      output_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * p.H;
  state_k<<<dim3(p.nc, BH), threads, smem_a, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int PN = p.P * p.N;
  state_scan_kernel<<<dim3((PN + kThreads - 1) / kThreads, BH), kThreads, 0,
                      st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  output_k<<<dim3((p.Lc + kTile - 1) / kTile, p.nc, BH), threads, smem_c,
             st>>>(p);
  return (int)cudaGetLastError();
}

int launch_f32(const Params& p, int B, cudaStream_t st) {
  return launch_all(p, B, st, chunk_state_f32_kernel, state_smem_f32(p),
                    chunk_output_f32_kernel, output_smem_f32(p), kThreads);
}

// Register tiles sized for widths up to 64 where they fit, else 128.
template <int W64P, int W64N>
int launch_tc_sized(const Params& p, int B, cudaStream_t st) {
  constexpr int MT = W64P ? 1 : 2, PT = W64P ? 8 : 16;
  constexpr int NT = W64N ? 8 : 16, NK = W64N ? 4 : 8;
  return launch_all(p, B, st, chunk_state_tc_kernel<MT, NT>, state_smem_tc(p),
                    chunk_output_tc_kernel<PT, NK>, output_smem_tc(p),
                    kTcThreads);
}

int launch_tc(const Params& p, int B, cudaStream_t st) {
  const bool sp = p.P <= 64, sn = p.N <= 64;
  if (sp && sn) return launch_tc_sized<1, 1>(p, B, st);
  if (sp) return launch_tc_sized<1, 0>(p, B, st);
  if (sn) return launch_tc_sized<0, 1>(p, B, st);
  return launch_tc_sized<0, 0>(p, B, st);
}

}  // namespace

extern "C" {

// Floats of workspace the call needs: the chunk states and decays.
size_t ssm_chunk_scan_workspace(int B, int H, int nc, int P, int N) {
  return (size_t)B * H * nc * ((size_t)P * N + 1);
}

// Strides are in elements, for the batch, sequence and head (group) axes
// of x, Bm and Cm.  dtype: 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores; pointers 16-byte aligned, strides multiples of 8) of x,
// Bm and Cm; dt and A are float32.  Returns the launches' cudaError_t (0
// on success); cudaErrorInvalidValue for sizes or layouts the kernel
// does not take.
int ssm_chunk_scan(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* h_out,
                   void* work, long long x_sb, long long x_ss, long long x_sh,
                   long long b_sb, long long b_ss, long long b_sg,
                   long long c_sb, long long c_ss, long long c_sg, int B,
                   int S, int H, int G, int P, int N, int Lc, int dtype,
                   void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || Lc < 1 ||
      Lc > kMaxChunk || S % Lc != 0 || P < 16 || P > kMaxWidth ||
      P % 16 != 0 || N < 16 || N > kMaxWidth || N % 16 != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = (const float*)dt; p.A = (const float*)A;
  p.Bm = Bm; p.Cm = Cm;
  p.y = (float*)y; p.h_out = (float*)h_out;
  p.nc = S / Lc;
  p.states = (float*)work;
  p.decay = p.states + (size_t)B * H * p.nc * P * N;
  p.xs[0] = x_sb; p.xs[1] = x_ss; p.xs[2] = x_sh;
  p.bs[0] = b_sb; p.bs[1] = b_ss; p.bs[2] = b_sg;
  p.cs[0] = c_sb; p.cs[1] = c_ss; p.cs[2] = c_sg;
  p.S = S; p.H = H; p.G = G; p.P = P; p.N = N; p.Lc = Lc;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_f32(p, B, st);
  bool ok = (uintptr_t)x % 16 == 0 && (uintptr_t)Bm % 16 == 0 &&
            (uintptr_t)Cm % 16 == 0;
  for (int i = 0; i < 3; ++i)
    ok = ok && p.xs[i] % 8 == 0 && p.bs[i] % 8 == 0 && p.cs[i] % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  return launch_tc(p, B, st);
}

}  // extern "C"
