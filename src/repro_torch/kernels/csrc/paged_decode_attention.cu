// Paged decode attention for Hopper (sm_90a): one query token per
// sequence against a paged KV pool, the g = H/Hkv query heads of one KV
// head computed together (flash-decoding with split-KV).
//
// Replaces: the Pallas TPU kernel repro/kernels/paged_decode_attention.py
// (paged_decode_attention_kernel), which the JAX model dispatches at
// repro/models/attention.py::paged_attention_decode for every decode
// token.
//
// Layouts (all row-major, contiguous):
//   q            (B, H, D)                 f32 or bf16
//   k/v pages    (n_pages, ps, Hkv, D)     same type as q
//   block_tables (B, max_pages)            int32, page 0 is scratch
//   kv_len       (B,)                      int32, >= 1
//   out          (B, H, D)                 q's type
// Positions [j*ps, (j+1)*ps) of sequence b live in page block_tables[b, j].
//
// What bounds it: the bytes of K and V read.  Each (sequence, KV head)
// reads kv_len * D elements of K and as many of V once, and does
// 4 * g * D operations per position: at g <= 3 that is ~1.5 operations
// per byte in bf16, far below the ~295 the card needs before compute
// binds.  So the design reads every valid K/V element exactly once and
// nothing else, and keeps enough reads in flight to stream them:
//   * The TPU kernel walks the pages of one (sequence, KV head) in
//     order on one core.  On Hopper one CTA per (sequence, KV head) is
//     only B*Hkv CTAs (40 for smollm at 8 slots), each walking up to 128
//     pages serially: latency-bound (about 1 ms at kv_len 2048, measured
//     with that first design).  Here the pages are cut into splits of up
//     to 128 positions, one CTA per (split, KV head, sequence), so a
//     2048-position sequence spreads over 16 CTAs; splits past a
//     sequence's length exit at once.
//   * Each CTA reads its own block-table entries (there is no scalar
//     prefetch), stops at kv_len (stale data past the length, in a
//     recycled page's tail or in the scratch page, is never read), and
//     computes the split's scores with one thread per position reading
//     its K row in 16-byte vectors, a split-wide softmax in f32, and
//     P @ V with 16-byte vectors across D (V reads coalesce) split over
//     groups of positions; the g query heads share every K/V read.  It writes the split's unnormalised (g, D) sum, its maxima
//     and its denominators to an f32 workspace.
//   * A second kernel merges the splits of each (sequence, KV head) with
//     the rescale by exp(m_split - m) and divides by max(l, 1e-30), as
//     the TPU kernel's online softmax does across its grid steps.
// A block table naming a page outside the pool makes the affected rows
// NaN instead of reading out of bounds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

struct Shape {
  int B, H, Hkv, D, ps, max_pages, n_pages, pages_per_split, n_splits;
};

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp,
                   const int32_t* __restrict__ block_tables,
                   const int32_t* __restrict__ kv_len,
                   float* __restrict__ work, Shape s, float scale) {
  constexpr int V = Vec<T>::n;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = s.H / s.Hkv;
  const int D = s.D;
  const int len = kv_len[b];
  const int n_tab = min(s.max_pages, (len + s.ps - 1) / s.ps);
  const int p0 = split * s.pages_per_split;
  if (p0 >= n_tab) return;                   // past the sequence's pages
  const int p1 = min(p0 + s.pages_per_split, n_tab);
  const int n_pos = min(len, p1 * s.ps) - p0 * s.ps;   // 1..kTile
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;                         // (g, D) scaled query
  float* p_s = q_s + g * D;                  // (g, kTile) scores -> probs
  float* red_s = p_s + g * kTile;            // (groups, g, D) P@V partials
  int* page_s = (int*)(red_s + g * kThreads * V);
  __shared__ int bad_page;

  const T* q_row = q + ((size_t)b * s.H + (size_t)h * g) * D;
  for (int e = tid; e < g * D; e += kThreads)
    q_s[e] = to_f32(q_row[e]) * scale;
  if (tid == 0) bad_page = 0;
  __syncthreads();
  for (int j = tid; j < p1 - p0; j += kThreads) {
    const int page = block_tables[(size_t)b * s.max_pages + p0 + j];
    page_s[j] = page;
    if (page < 0 || page >= s.n_pages) bad_page = 1;
  }
  __syncthreads();

  float* w = work + (((size_t)b * s.Hkv + h) * s.n_splits + split) *
                        split_stride(g, D);
  if (bad_page) {                            // never read out of bounds
    for (int e = tid; e < g * (D + 2); e += kThreads)
      w[e] = __int_as_float(0x7fc00000);
    return;
  }
  const size_t row_stride = (size_t)s.Hkv * D;   // between positions
  const size_t head_off = (size_t)h * D;

  // scores: one thread per position (kThreads == kTile), 16-byte loads
  // along its K row; every lane of a warp reads the same q element, a
  // shared-memory broadcast
  for (int t = tid; t < n_pos; t += kThreads) {
    const T* krow = kp + ((size_t)page_s[t / s.ps] * s.ps + t % s.ps) *
                             row_stride + head_off;
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
    float* row = p_s + gi * kTile;
    float m = kNegInf;
    for (int t = lane; t < n_pos; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n_pos; t += 32) {
      const float p = expf(row[t] - m);
      row[t] = p;
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
      Vec<T>::load(vp + ((size_t)page_s[t / s.ps] * s.ps + t % s.ps) *
                            row_stride + head_off + c, vv);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const int32_t* __restrict__ kv_len,
                   const float* __restrict__ work, T* __restrict__ out,
                   Shape s) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = s.H / s.Hkv;
  const int D = s.D;
  const int n_tab = min(s.max_pages, (kv_len[b] + s.ps - 1) / s.ps);
  const int n = (n_tab + s.pages_per_split - 1) / s.pages_per_split;
  const size_t stride = split_stride(g, D);
  const float* w = work + ((size_t)b * s.Hkv + h) * s.n_splits * stride;

  extern __shared__ float smem[];
  float* weight_s = smem;                    // (g, n) per-split rescales
  float* inv_l = weight_s + (size_t)g * s.n_splits;   // (g,)
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
  T* o_row = out + ((size_t)b * s.H + (size_t)h * g) * D;
  for (int e = threadIdx.x; e < g * D; e += kThreads) {
    const int gi = e / D;
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += weight_s[gi * n + i] * w[i * stride + e];
    o_row[e] = from_f32<T>(acc * inv_l[gi]);
  }
}

bool make_shape(Shape* s, int B, int H, int Hkv, int D, int ps, int max_pages,
                int n_pages) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > kMaxG || D < 8 ||
      D % 8 != 0 || D > kMaxD || ps < 1 || ps > kTile || max_pages < 1 ||
      n_pages < 1)
    return false;
  s->B = B;
  s->H = H;
  s->Hkv = Hkv;
  s->D = D;
  s->ps = ps;
  s->max_pages = max_pages;
  s->n_pages = n_pages;
  s->pages_per_split = kTile / ps;
  s->n_splits = (max_pages + s->pages_per_split - 1) / s->pages_per_split;
  return true;
}

}  // namespace

extern "C" {

// Floats of f32 device workspace a call with these sizes needs (0 for
// sizes the kernel does not take: g > 8, D > 128 or not a multiple of 8,
// page_size > 128).
size_t paged_decode_attention_workspace(int B, int H, int Hkv, int D, int ps,
                                        int max_pages) {
  Shape s;
  if (!make_shape(&s, B, H, Hkv, D, ps, max_pages, 1)) return 0;
  return (size_t)B * Hkv * s.n_splits * split_stride(H / Hkv, D);
}

// scale: the softmax scale D**-0.5.  dtype: 0 = float32, 1 = bfloat16.
// workspace: paged_decode_attention_workspace(...) floats on the device.
// Returns the launches' cudaError_t (0 on success); cudaErrorInvalidValue
// for sizes the kernel does not take.
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* kv_len, void* out, void* workspace,
                           int B, int H, int Hkv, int D, int ps,
                           int max_pages, int n_pages, float scale, int dtype,
                           void* stream) {
  Shape s;
  if (!make_shape(&s, B, H, Hkv, D, ps, max_pages, n_pages) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int g = H / Hkv;
  const int vec = dtype == 0 ? Vec<float>::n : Vec<__nv_bfloat16>::n;
  const size_t smem1 =
      sizeof(float) * ((size_t)g * D + (size_t)g * kTile +
                       (size_t)g * kThreads * vec) +
      sizeof(int) * s.pages_per_split;
  const size_t smem2 = sizeof(float) * ((size_t)g * s.n_splits + g);
  if (smem2 > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid1(s.n_splits, Hkv, B), grid2(Hkv, B);
  float* work = (float*)workspace;
  const int32_t* bt = (const int32_t*)block_tables;
  const int32_t* kl = (const int32_t*)kv_len;
  if (dtype == 0) {
    paged_split_kernel<float><<<grid1, kThreads, smem1, st>>>(
        (const float*)q, (const float*)k_pages, (const float*)v_pages, bt,
        kl, work, s, scale);
    paged_merge_kernel<float><<<grid2, kThreads, smem2, st>>>(
        kl, work, (float*)out, s);
  } else {
    paged_split_kernel<__nv_bfloat16><<<grid1, kThreads, smem1, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
        (const __nv_bfloat16*)v_pages, bt, kl, work, s, scale);
    paged_merge_kernel<__nv_bfloat16><<<grid2, kThreads, smem2, st>>>(
        kl, work, (__nv_bfloat16*)out, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
