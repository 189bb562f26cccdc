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
// S % Lc == 0 (the reference's contract), any Lc otherwise.
//
// What bounds it: operations.  At the main shape (B = 1, S = 512, H =
// 112, P = N = 64, Lc = 256) the function reads ~7.5 MB and writes ~16
// MB but does ~2.6 GFLOP, ~100 operations per byte.  The TPU kernel walks
// each (batch, head)'s chunks in order on one core, carrying the state in
// VMEM.  Here that would be 112 CTAs for 132 SMs, so the work is cut in
// three launches that are each parallel over chunks:
//   1. chunk_state: one CTA per (b, h, chunk) computes the chunk's local
//      end state sum_s exp(l_L - l_s) dt_s x_s (x) B_s (P x N in
//      registers, x and B staged in shared memory 64 rows at a time) and
//      its decay exp(l_L), where l is the chunk's cumsum of dt * A.
//   2. state_scan: one thread per (b, h, p, n) runs the short sequential
//      recurrence h <- exp(l_L) h + hc over the chunks, leaving in the
//      workspace the state that enters each chunk and writing the final
//      state.
//   3. chunk_output: one CTA per (b, h, chunk, 64 rows t) computes
//      y_t = exp(l_t) C_t . h_in  +  sum_{s <= t} (C_t . B_s)
//            exp(l_t - l_s) dt_s x_s,
//      the intra-chunk term tiled like causal attention without softmax:
//      64 x 64 score tiles (16 x 16 threads, 4 x 4 each) from C and B in
//      shared memory, tiles above the diagonal never visited, and the
//      weighted scores multiplied into the 64 x P output held in
//      registers.  The Lc x Lc weight matrix (256 KB at Lc = 256) never
//      exists whole.
// The decay exp(l_t - l_s) is computed only for s <= t: l falls along
// the chunk, so for s > t it can overflow to inf, and inf * 0 is NaN.
// The products are fp32 FMAs on the CUDA cores; tensor cores are a later
// change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                 // rows t per CTA, columns s per tile
constexpr int kMaxWidth = 128;            // P and N
constexpr int kMaxChunk = 1024;
constexpr int kPerThread = kMaxChunk / kThreads;
constexpr int kMaxJ = kMaxWidth / 16;     // 16-wide column groups

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
// [0, Lc); every thread takes kPerThread consecutive positions, then a
// warp scan and a scan of the warps' totals.  Deterministic, so the two
// kernels that call it see the same l.
__device__ void chunk_cumsum(const float* __restrict__ dt, long long stride,
                             float A, int Lc, float* cum, float* dts) {
  __shared__ float warp_total[kThreads / 32];
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

// ---- 1. chunk-local end states ---------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(Params p) {
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
  chunk_cumsum(p.dt + ((long long)b * p.S + s0) * p.H + h, p.H, p.A[h], Lc,
               cum, dts);
  const float l_end = cum[Lc - 1];
  const T* x = (const T*)p.x + b * p.xs[0] + s0 * p.xs[1] + h * p.xs[2];
  const T* Bm = (const T*)p.Bm + b * p.bs[0] + s0 * p.bs[1] + g * p.bs[2];
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
        v = to_f32(x[s * p.xs[1] + col]) * (expf(l_end - cum[s]) * dts[s]);
      }
      xw[e] = v;
    }
    for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
      const int r = e / N, col = e - r * N;
      bsm[e] = r < nk ? to_f32(Bm[(k0 + r) * p.bs[1] + col]) : 0.f;
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

// ---- 2. the recurrence across chunks ---------------------------------------

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

// ---- 3. outputs: carried state plus the intra-chunk quadratic term --------

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_output_kernel(Params p) {
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
  chunk_cumsum(p.dt + ((long long)b * p.S + s0) * p.H + h, p.H, p.A[h], Lc,
               cum, dts);
  const int t0 = qt * kTile;
  const int nq = min(kTile, Lc - t0);
  const T* x = (const T*)p.x + b * p.xs[0] + s0 * p.xs[1] + h * p.xs[2];
  const T* Bm = (const T*)p.Bm + b * p.bs[0] + s0 * p.bs[1] + g * p.bs[2];
  const T* Cm = (const T*)p.Cm + b * p.cs[0] + s0 * p.cs[1] + g * p.cs[2];
  for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
    const int r = e / N, col = e - r * N;
    cq[r * ldn + col] = r < nq ? to_f32(Cm[(t0 + r) * p.cs[1] + col]) : 0.f;
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
      kb[r * ldn + col] = r < nk ? to_f32(Bm[(k0 + r) * p.bs[1] + col]) : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * P; e += kThreads) {
      const int r = e / P, col = e - r * P;
      xsm[e] = r < nk ? to_f32(x[(k0 + r) * p.xs[1] + col]) : 0.f;
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

size_t state_smem(const Params& p) {
  return (2 * (size_t)round4(p.Lc) + (size_t)kTile * (p.P + p.N)) *
         sizeof(float);
}

size_t output_smem(const Params& p) {
  const size_t ldn = p.N + 1;
  return (2 * (size_t)round4(p.Lc) + kTile * ldn +
          (size_t)(p.P > kTile ? p.P : kTile) * ldn + (size_t)kTile * p.P +
          (size_t)kTile * (kTile + 1)) *
         sizeof(float);
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t st) {
  const size_t smem_a = state_smem(p), smem_c = output_smem(p);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(chunk_output_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * p.H;
  chunk_state_kernel<T><<<dim3(p.nc, BH), kThreads, smem_a, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int PN = p.P * p.N;
  state_scan_kernel<<<dim3((PN + kThreads - 1) / kThreads, BH), kThreads, 0,
                      st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_output_kernel<T><<<dim3((p.Lc + kTile - 1) / kTile, p.nc, BH),
                           kThreads, smem_c, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace the call needs: the chunk states and decays.
size_t ssm_chunk_scan_workspace(int B, int H, int nc, int P, int N) {
  return (size_t)B * H * nc * ((size_t)P * N + 1);
}

// Strides are in elements, for the batch, sequence and head (group) axes
// of x, Bm and Cm.  dtype: 0 = float32, 1 = bfloat16 (of x, Bm and Cm;
// dt and A are float32).  Returns the launches' cudaError_t (0 on
// success); cudaErrorInvalidValue for sizes the kernel does not take.
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
  if (dtype == 0) return launch<float>(p, B, st);
  return launch<__nv_bfloat16>(p, B, st);
}

}  // extern "C"
