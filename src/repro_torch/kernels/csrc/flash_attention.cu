// Flash attention forward for Hopper (sm_90a): FlashAttention-2's online
// softmax over KV tiles, GQA by h // g, causal and sliding-window masks,
// fp32 accumulation, output in q's type.
//
// Replaces: the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_kernel), the TPU twin of repro/models/flash.py, which
// every monolithic prefill (repro/models/attention.py::attention_fwd,
// mode="flash") runs once per layer.
//
// Layouts: q (B, S, H, D), k/v (B, S, Hkv, D) and out (B, S, H, D), read
// and written in place through their batch, sequence and head strides
// (elements; the last axis is contiguous): no transposed copies.  f32 or
// bf16, one type for all four.  D a multiple of 8 up to 128, g = H/Hkv up
// to 8, any S (ragged edges masked, nothing padded).
//
// Where the products run: QK^T and PV are fp32 FMAs on the CUDA cores,
// from fp32 tiles in shared memory.  This is the simple version: the
// tensor cores (mma.sync or wgmma, with TMA loads) are a later change.
//
// What bounds it: operations.  At the prefill shapes (S = 1024, D = 64,
// g = 3) a KV tile of 64 positions read once serves 64 query rows, about
// 64 operations per byte in bf16 even before the q rows are counted; on
// the CUDA cores (67 TFLOP/s fp32) the card is compute-bound from ~20
// operations per byte.  So the design spends its effort on keeping the
// FMA units fed from shared memory:
//   * The TPU grid carries m, l and the accumulator in VMEM across a
//     sequential kv axis.  Here one CTA owns a block of bq = 64 / g query
//     positions of one (batch, KV head): its 64 rows are the (position,
//     head) pairs of all g query heads of that KV head, so every K/V tile
//     loaded into shared memory serves all g heads.  The CTA loops over
//     the KV tiles itself, with m and l in shared memory and its part of
//     the output accumulator in registers.
//   * Causal tiles above the diagonal and sliding-window tiles below
//     q0 - window + 1 are never loaded.
//   * S = QK^T: 16 x 16 threads, each a 4 x 4 register tile, reading q
//     and k as float4 from transposed tiles (two 16-byte loads for 16
//     FMAs).  O += PV: threads own TM rows x 8 columns of the output
//     (TM = 2 for D <= 64, 4 above), reading p as a float2/float4 and v
//     as two float4 per key.
//   * Masked scores are -1e30 (not -inf) and l is clamped at 1e-30, as in
//     the TPU kernel; a tile in which a row has no valid key adds weight
//     that the rescale exp(-1e30 - m) = 0 removes once a valid key comes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                 // query rows (position, head) per CTA
constexpr int kBK = 64;                   // key positions per tile
constexpr int kPad = 68;                  // row stride of the transposed tiles
constexpr int kMaxD = 128;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];   // (batch, seq, head) strides
  int S, H, Hkv, D, g, bq, causal, window;
  float scale;
};

// Floats of dynamic shared memory for head size D.
size_t smem_floats(int D) {
  return (size_t)2 * D * kPad             // q^T, k^T
         + (size_t)kBK * D                // v
         + (size_t)kBK * kPad             // scores / probabilities, by key
         + 3 * kRows                      // m, l, rescale
         + 8 * kRows;                     // two (4, kRows) reductions
}

template <typename T, int TM>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int g = p.g, D = p.D, S = p.S;
  const int q0 = blockIdx.x * p.bq;
  const int nq = min(p.bq, S - q0);        // valid positions in the block
  const int R = p.bq * g;                  // rows in use (<= kRows)
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* qt = smem;                        // [D][kPad]  q * scale, by dim
  float* kt = qt + (size_t)D * kPad;       // [D][kPad]  k tile, by dim
  float* vt = kt + (size_t)D * kPad;       // [kBK][D]   v tile
  float* st = vt + (size_t)kBK * D;        // [kBK][kPad] scores, by key
  float* m_s = st + kBK * kPad;            // [kRows] running max
  float* l_s = m_s + kRows;                // [kRows] running denominator
  float* c_s = l_s + kRows;                // [kRows] this tile's rescale
  float* red = c_s + kRows;                // [4][kRows] partial maxima
  float* red2 = red + 4 * kRows;           // [4][kRows] partial sums

  // rows r = qi * g + gi: the g heads of position q0 + qi are contiguous
  const T* q_b = q + b * p.qs[0] + (size_t)h * g * p.qs[2];
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int qi = r / g, gi = r - qi * g;
    float x = 0.f;
    if (r < R && qi < nq)
      x = to_f32(q_b[(q0 + qi) * p.qs[1] + gi * p.qs[2] + d]) * p.scale;
    qt[d * kPad + r] = x;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // S = QK^T tiling: rows sa_r0 .. +3, keys sa_c0 .. +3 of the tile
  const int sa_r0 = (tid / 16) * 4, sa_c0 = (tid % 16) * 4;
  int qpos_a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos_a[i] = q0 + (sa_r0 + i) / g;
  // O += PV tiling: rows oc_r0 .. +TM-1, columns oc_c0 .. +7
  const int n_chunks = D / 8;
  const bool oc_active = tid < (kRows / TM) * n_chunks;
  const int oc_r0 = (tid / n_chunks) * TM, oc_c0 = (tid % n_chunks) * 8;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int lo = 0, hi = S;
  if (p.causal) hi = min(S, q0 + nq);
  if (p.window > 0) lo = max(0, q0 - p.window + 1);
  lo = lo / kBK * kBK;

  const T* k_b = k + b * p.ks[0] + (size_t)h * p.ks[2];
  const T* v_b = v + b * p.vs[0] + (size_t)h * p.vs[2];
  for (int j0 = lo; j0 < hi; j0 += kBK) {
    __syncthreads();                       // the last tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int jj = e / D, d = e - jj * D;
      const int kpos = j0 + jj;
      float kx = 0.f, vx = 0.f;
      if (kpos < S) {
        kx = to_f32(k_b[kpos * p.ks[1] + d]);
        vx = to_f32(v_b[kpos * p.vs[1] + d]);
      }
      kt[d * kPad + jj] = kx;
      vt[jj * D + d] = vx;
    }
    __syncthreads();

    {  // scores, masked
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 x = *reinterpret_cast<const float4*>(&qt[d * kPad + sa_r0]);
        const float4 y = *reinterpret_cast<const float4*>(&kt[d * kPad + sa_c0]);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = fmaf(xs[i], ys[j], a[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = j0 + sa_c0 + j;
        float out[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bool ok = kpos < S;
          if (p.causal) ok = ok && qpos_a[i] >= kpos;
          if (p.window > 0) ok = ok && qpos_a[i] - kpos < p.window;
          out[i] = ok ? a[i][j] : kNegInf;
        }
        *reinterpret_cast<float4*>(&st[(sa_c0 + j) * kPad + sa_r0]) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();

    {  // online softmax: 4 threads per row, 16 keys each
      const int r = tid % kRows, part = tid / kRows;
      float mx = kNegInf;
#pragma unroll 4
      for (int c = part * 16; c < part * 16 + 16; ++c)
        mx = fmaxf(mx, st[c * kPad + r]);
      red[part * kRows + r] = mx;
      __syncthreads();
      const float m_old = m_s[r];
      const float m_new =
          fmaxf(fmaxf(m_old, fmaxf(red[r], red[kRows + r])),
                fmaxf(red[2 * kRows + r], red[3 * kRows + r]));
      float sum = 0.f;
#pragma unroll 4
      for (int c = part * 16; c < part * 16 + 16; ++c) {
        const float e = expf(st[c * kPad + r] - m_new);
        st[c * kPad + r] = e;
        sum += e;
      }
      red2[part * kRows + r] = sum;
      __syncthreads();
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + red2[r] + red2[kRows + r] +
                 red2[2 * kRows + r] + red2[3 * kRows + r];
        m_s[r] = m_new;
        c_s[r] = corr;
      }
      __syncthreads();
    }

    if (oc_active) {  // O = O * rescale + P V
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float c = c_s[oc_r0 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= c;
      }
#pragma unroll 4
      for (int jj = 0; jj < kBK; ++jj) {
        float pr[TM];
        if constexpr (TM == 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(&st[jj * kPad + oc_r0]);
          pr[0] = x.x; pr[1] = x.y; pr[2] = x.z; pr[3] = x.w;
        } else {
          const float2 x =
              *reinterpret_cast<const float2*>(&st[jj * kPad + oc_r0]);
          pr[0] = x.x; pr[1] = x.y;
        }
        const float4 y0 = *reinterpret_cast<const float4*>(&vt[jj * D + oc_c0]);
        const float4 y1 =
            *reinterpret_cast<const float4*>(&vt[jj * D + oc_c0 + 4]);
        const float ys[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pr[i], ys[j], acc[i][j]);
      }
    }
  }

  if (oc_active) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = oc_r0 + i;
      const int qi = r / g, gi = r - qi * g;
      if (r >= R || qi >= nq) continue;
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      T* orow = o + b * p.os[0] + (q0 + qi) * p.os[1] +
                ((size_t)h * g + gi) * p.os[2] + oc_c0;
#pragma unroll
      for (int j = 0; j < 8; ++j) orow[j] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int TM>
int launch(const Params& p, int B, cudaStream_t st) {
  const size_t smem = smem_floats(p.D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + p.bq - 1) / p.bq, p.Hkv, B);
  flash_fwd_kernel<T, TM><<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements, for the batch, sequence and head axes of q,
// k, v and out; the last axis of each is contiguous.  causal: 0 or 1.
// window: 0 for full attention, else keys with qpos - kpos >= window are
// masked.  scale: the softmax scale D**-0.5.  dtype: 0 = float32, 1 =
// bfloat16.  Returns the launch's cudaError_t (0 on success);
// cudaErrorInvalidValue for sizes the kernel does not take.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long o_sb, long long o_ss, long long o_sh, int B,
                    int S, int H, int Hkv, int D, int causal, int window,
                    float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > kMaxG ||
      D < 8 || D % 8 != 0 || D > kMaxD || window < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out;
  const long long strides[4][3] = {{q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
                                   {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh}};
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[0][i];
    p.ks[i] = strides[1][i];
    p.vs[i] = strides[2][i];
    p.os[i] = strides[3][i];
  }
  p.S = S; p.H = H; p.Hkv = Hkv; p.D = D;
  p.g = H / Hkv;
  p.bq = kRows / p.g;
  p.causal = causal != 0;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  const bool narrow = D <= 64;             // TM = 2 keeps all 256 threads busy
  if (dtype == 0)
    return narrow ? launch<float, 2>(p, B, st) : launch<float, 4>(p, B, st);
  return narrow ? launch<__nv_bfloat16, 2>(p, B, st)
                : launch<__nv_bfloat16, 4>(p, B, st);
}

}  // extern "C"
