// Split-KV decode attention shared by the paged and the contiguous decode
// kernels (paged_decode_attention.cu, decode_attention.cu): one query
// token per sequence, the g = H/Hkv query heads of one KV head computed
// together, flash-decoding with splits of up to kTile positions and a
// merge kernel.
//
// The two kernels differ only in where position t of a sequence lives:
// through a block table in a paged pool, or at row t of a contiguous
// (B, S, Hkv, D) cache.  Each split kernel finds its positions and hands
// attend_split() a function from a split-local position to the element
// offset of that position's K/V row for the KV head; everything after
// that is here.
//
// What bounds decode: the bytes of K and V read.  Each (sequence, KV
// head) reads kv_len * D elements of K and as many of V once, and does
// 4 * g * D operations per position: at g <= 3 that is ~1.5 operations
// per byte in bf16, far below the ~295 the card needs before compute
// binds.  So every valid K/V element is read exactly once and nothing
// else, and enough reads are kept in flight to stream them:
//   * One CTA per (split, KV head, sequence): a 2048-position sequence
//     spreads over 16 CTAs; splits past a sequence's length exit at once.
//   * A split's scores: one thread per position reading its K row in
//     16-byte vectors; a split-wide softmax in f32; P @ V with 16-byte
//     vectors across D (V reads coalesce) split over groups of positions.
//     The g query heads share every K/V read.  The split's unnormalised
//     (g, D) sum, its maxima and its denominators go to an f32 workspace.
//   * merge_kernel combines the splits of each (sequence, KV head) with
//     the rescale by exp(m_split - m) and divides by max(l, 1e-30), as
//     the TPU kernels' online softmax does across their grid steps.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace split_decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;                // positions per split (max)
constexpr int kMaxD = 128;
constexpr int kMaxG = 8;                  // query heads per KV head
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Workspace per (sequence, KV head, split): the g*D partial sums, then
// g maxima and g denominators.
inline __host__ __device__ size_t split_stride(int g, int D) {
  return (size_t)g * (D + 2);
}

// 16-byte vectors: 8 bf16 or 4 f32 values per load.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Dynamic shared memory attend_split needs, in bytes; a split kernel may
// place its own data after it.
inline __host__ __device__ size_t split_smem_bytes(int g, int D,
                                                 int vec) {
  return sizeof(float) * ((size_t)g * D + (size_t)g * kTile +
                          (size_t)g * kThreads * vec);
}

// One split of n_pos (1..kTile) positions for the g query heads at q_row
// (g*D values).  row(t) is the element offset, in k and in v, of
// split-local position t's D values for this KV head.  Writes the
// split's partial sums, maxima and denominators to w.  Every thread of
// the block must call it.
template <typename T, typename RowFn>
__device__ __forceinline__ void attend_split(
    const T* __restrict__ q_row, const T* __restrict__ k,
    const T* __restrict__ v, RowFn row, int n_pos, int g, int D, float scale,
    float* __restrict__ w, float* smem) {
  constexpr int V = Vec<T>::n;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* q_s = smem;                         // (g, D) scaled query
  float* p_s = q_s + g * D;                  // (g, kTile) scores -> probs
  float* red_s = p_s + g * kTile;            // (groups, g, D) P@V partials

  for (int e = tid; e < g * D; e += kThreads)
    q_s[e] = to_f32(q_row[e]) * scale;
  __syncthreads();

  // scores: one thread per position (kThreads == kTile), 16-byte loads
  // along its K row; every lane of a warp reads the same q element, a
  // shared-memory broadcast
  for (int t = tid; t < n_pos; t += kThreads) {
    const T* krow = k + row(t);
    float acc[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += V) {
      float kv[V];
      Vec<T>::load(krow + d0, kv);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) {
#pragma unroll
          for (int j = 0; j < V; ++j) acc[gi] += q_s[gi * D + d0 + j] * kv[j];
        }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi)
      if (gi < g) p_s[gi * kTile + t] = acc[gi];
  }
  __syncthreads();

  // split-wide softmax: one warp per query head
  float* ml = w + (size_t)g * D;             // g maxima, then g sums
  for (int gi = warp; gi < g; gi += kWarps) {
    float* prow = p_s + gi * kTile;
    float m = kNegInf;
    for (int t = lane; t < n_pos; t += 32) m = fmaxf(m, prow[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n_pos; t += 32) {
      const float p = expf(prow[t] - m);
      prow[t] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      ml[gi] = m;
      ml[g + gi] = l;
    }
  }
  __syncthreads();

  // P @ V: D/V threads cover a V row with 16-byte loads; the kThreads /
  // (D/V) groups of them take the positions t = grp (mod groups)
  const int per_row = D / V;
  const int groups = kThreads / per_row;
  const int grp = tid / per_row;
  const int c = (tid - grp * per_row) * V;   // first column of this thread
  if (grp < groups) {
    float acc[kMaxG][V];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[gi][j] = 0.f;
#pragma unroll 2
    for (int t = grp; t < n_pos; t += groups) {
      float vv[V];
      Vec<T>::load(v + row(t) + c, vv);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) {
          const float p = p_s[gi * kTile + t];
#pragma unroll
          for (int j = 0; j < V; ++j) acc[gi][j] += p * vv[j];
        }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi)
      if (gi < g) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          red_s[(grp * g + gi) * D + c + j] = acc[gi][j];
      }
  }
  __syncthreads();
  for (int e = tid; e < g * D; e += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < groups; ++r) sum += red_s[r * g * D + e];
    w[e] = sum;
  }
}

// Combines the splits of one (KV head, sequence) per CTA: grid (Hkv, B).
// Sequence b has ceil(min(kv_len[b], max_len) / split_len) splits of the
// n_splits the workspace holds.  Dynamic shared memory:
// merge_smem_bytes(g, n_splits).
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const int32_t* __restrict__ kv_len,
             const float* __restrict__ work, T* __restrict__ out, int H,
             int Hkv, int D, int n_splits, int split_len, int max_len) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / Hkv;
  const int len = max(0, min(kv_len[b], max_len));
  const int n = (len + split_len - 1) / split_len;
  const size_t stride = split_stride(g, D);
  const float* w = work + ((size_t)b * Hkv + h) * n_splits * stride;

  extern __shared__ float smem[];
  float* weight_s = smem;                    // (g, n) per-split rescales
  float* inv_l = weight_s + (size_t)g * n_splits;   // (g,)
  for (int gi = threadIdx.x; gi < g; gi += kThreads) {
    float m = kNegInf;
    for (int i = 0; i < n; ++i) m = fmaxf(m, w[i * stride + g * D + gi]);
    float l = 0.f;
    for (int i = 0; i < n; ++i) {
      const float c = expf(w[i * stride + g * D + gi] - m);
      weight_s[gi * n + i] = c;
      l += c * w[i * stride + g * D + g + gi];
    }
    inv_l[gi] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  T* o_row = out + ((size_t)b * H + (size_t)h * g) * D;
  for (int e = threadIdx.x; e < g * D; e += kThreads) {
    const int gi = e / D;
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += weight_s[gi * n + i] * w[i * stride + e];
    o_row[e] = from_f32<T>(acc * inv_l[gi]);
  }
}

inline size_t merge_smem_bytes(int g, int n_splits) {
  return sizeof(float) * ((size_t)g * n_splits + g);
}

// Whether the split kernels take these head sizes.
inline bool heads_ok(int B, int H, int Hkv, int D) {
  return B >= 1 && Hkv >= 1 && H % Hkv == 0 && H / Hkv <= kMaxG && D >= 8 &&
         D % 8 == 0 && D <= kMaxD;
}

}  // namespace split_decode
