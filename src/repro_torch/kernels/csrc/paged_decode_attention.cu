// Paged decode attention for Hopper (sm_90a): one query token per
// sequence against a paged KV pool, the g = H/Hkv query heads of one KV
// head computed together (flash-decoding with split-KV; the design, and
// what bounds it, are in split_decode.cuh, which this kernel shares with
// the contiguous decode kernel decode_attention.cu).
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
// What is particular to pages: the TPU kernel walks the pages of one
// (sequence, KV head) in order on one core.  On Hopper one CTA per
// (sequence, KV head) is only B*Hkv CTAs (40 for smollm at 8 slots), each
// walking up to 128 pages serially: latency-bound (about 1 ms at kv_len
// 2048, measured with that first design).  Here a split covers up to 128
// positions of whole pages, and each CTA reads its own block-table
// entries (there is no scalar prefetch) and stops at kv_len: stale data
// past the length, in a recycled page's tail or in the scratch page, is
// never read.  A block table naming a page outside the pool makes the
// affected rows NaN instead of reading out of bounds.

#include "split_decode.cuh"

namespace {

using namespace split_decode;

struct Shape {
  int B, H, Hkv, D, ps, max_pages, n_pages, pages_per_split, n_splits;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp,
                   const int32_t* __restrict__ block_tables,
                   const int32_t* __restrict__ kv_len,
                   float* __restrict__ work, Shape s, float scale) {
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
  const int vec = Vec<T>::n;

  extern __shared__ float smem[];
  int* page_s = (int*)(smem + split_smem_bytes(g, D, vec) / sizeof(float));
  __shared__ int bad_page;
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
  const int ps = s.ps;
  attend_split<T>(
      q + ((size_t)b * s.H + (size_t)h * g) * D, kp, vp,
      [=](int t) {
        return ((size_t)page_s[t / ps] * ps + t % ps) * row_stride + head_off;
      },
      n_pos, g, D, scale, w, smem);
}

bool make_shape(Shape* s, int B, int H, int Hkv, int D, int ps, int max_pages,
                int n_pages) {
  if (!heads_ok(B, H, Hkv, D) || ps < 1 || ps > kTile || max_pages < 1 ||
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
      split_smem_bytes(g, D, vec) + sizeof(int) * s.pages_per_split;
  const size_t smem2 = merge_smem_bytes(g, s.n_splits);
  if (smem2 > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid1(s.n_splits, Hkv, B), grid2(Hkv, B);
  const int split_len = s.pages_per_split * ps, max_len = max_pages * ps;
  float* work = (float*)workspace;
  const int32_t* bt = (const int32_t*)block_tables;
  const int32_t* kl = (const int32_t*)kv_len;
  if (dtype == 0) {
    paged_split_kernel<float><<<grid1, kThreads, smem1, st>>>(
        (const float*)q, (const float*)k_pages, (const float*)v_pages, bt,
        kl, work, s, scale);
    merge_kernel<float><<<grid2, kThreads, smem2, st>>>(
        kl, work, (float*)out, H, Hkv, D, s.n_splits, split_len, max_len);
  } else {
    paged_split_kernel<__nv_bfloat16><<<grid1, kThreads, smem1, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
        (const __nv_bfloat16*)v_pages, bt, kl, work, s, scale);
    merge_kernel<__nv_bfloat16><<<grid2, kThreads, smem2, st>>>(
        kl, work, (__nv_bfloat16*)out, H, Hkv, D, s.n_splits, split_len,
        max_len);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
