// Paged decode attention for Hopper (sm_90a): one query token per
// sequence against a paged KV pool, the g = H/Hkv query heads of one KV
// head computed together (split-KV in one launch, the splits merged in a
// thread block cluster; the design, and what bounds it, are in
// split_decode.cuh, which this kernel shares with the contiguous decode
// kernel decode_attention.cu).
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
// 2048, measured with that first design).  Here each CTA of a cluster
// takes a contiguous run of whole pages; it reads its sequence's block
// table row itself (there is no scalar prefetch), with kv_len, in one
// round trip, then issues
// every copy of its first two tiles at once, each a gather of
// page_size-row pieces (cp.async rather than TMA: a tensor map would
// have to be encoded on the host per pool pointer, and the decode step
// is host-bound already).  It stops at kv_len: stale data past the
// length, in a recycled page's tail or in the scratch page, is never
// read.  A block table naming a page outside the pool makes that
// sequence's rows NaN instead of reading out of bounds.

#include "split_decode.cuh"

namespace {

using namespace split_decode;

struct Shape {
  int H, Hkv, D, ps, max_pages, n_pages;
};

template <typename T, int GC, int CPG>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ kv_len, T* __restrict__ out,
                    Shape s, Plan L, float scale) {
  const int rank = blockIdx.x;               // == the CTA's cluster rank
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = s.H / s.Hkv;
  const int D = s.D, ps = s.ps;
  const Lanes<T, GC, CPG> me(L, q + ((size_t)b * s.H + (size_t)h * g) * D,
                             g, D);                  // q's loads go first
  // the sequence's whole table row, read with kv_len in one round trip
  // (its CTA's pages are known only once kv_len is)
  extern __shared__ __align__(16) unsigned char smem[];
  int* page_s = reinterpret_cast<int*>(smem + L.pg);
  const int tid = threadIdx.x;
  const int32_t* table = block_tables + (size_t)b * s.max_pages;
  const int len = max(0, kv_len[b]);
  for (int j = tid; j < s.max_pages; j += kThreads) page_s[j] = table[j];
  const int n_tab = min(s.max_pages, (len + ps - 1) / ps);
  const int ppc = (n_tab + L.C - 1) / L.C;   // the CTA's whole pages
  const int pg0 = rank * ppc;
  const int npg = max(0, min(ppc, n_tab - pg0));
  const int n = npg > 0 ? min(len, (pg0 + npg) * ps) - pg0 * ps : 0;
  __shared__ int bad_page;
  if (tid == 0) bad_page = 0;
  __syncthreads();
  for (int j = tid; j < npg; j += kThreads) {
    const int page = page_s[pg0 + j];
    if (page < 0 || page >= s.n_pages) bad_page = 1;
  }
  __syncthreads();
  page_s += pg0;                             // the CTA's first page

  const size_t row_stride = (size_t)s.Hkv * D;   // between positions
  const size_t head_off = (size_t)h * D;
  attend_cluster<T, GC, CPG>(
      me, kp, vp,
      [=](int u) {
        const int j = u / ps;
        return ((size_t)page_s[j] * ps + (u - j * ps)) * row_stride +
               head_off;
      },
      n, bad_page != 0, g, D, scale, L, smem,
      out + ((size_t)b * s.H + (size_t)h * g) * D, nullptr);
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const int32_t*,
                        const int32_t*, T*, Shape, Plan, float);

// The kernel instance for a plan's head cut (two chunks a group: f32
// only).
template <typename T>
Kernel<T> pick(int gc, int cpg) {
  if constexpr (sizeof(T) == 4)
    if (cpg == 2) return paged_decode_kernel<T, kChunk, 2>;
  switch (gc) {
    case 1: return paged_decode_kernel<T, 1, 1>;
    case 2: return paged_decode_kernel<T, 2, 1>;
    case 3: return paged_decode_kernel<T, 3, 1>;
    case 4: return paged_decode_kernel<T, 4, 1>;
    default: return paged_decode_kernel<T, kChunk, 1>;
  }
}

template <typename T>
cudaError_t choose(Plan* L, int B, int Hkv, int g, int D, int max_pages) {
  int gc, cpg, hs, ns, W;
  head_cut(g, D, sizeof(T), &gc, &cpg, &hs, &ns, &W);
  if (!cpg) return cudaErrorInvalidValue;
  return choose_plan(pick<T>(gc, cpg), L, B, Hkv, g, D, sizeof(T),
                     max_pages);
}

// The shape and the plan a call with these sizes runs under, checked
// against the card for the dtype's kernel (0 = float32, 1 = bfloat16).
cudaError_t plan_for(Shape* s, Plan* L, int B, int H, int Hkv, int D, int ps,
                     int max_pages, int n_pages, int dtype) {
  if ((dtype != 0 && dtype != 1) || !heads_ok(B, H, Hkv, D) || ps < 1 ||
      ps > 128 || max_pages < 1 || n_pages < 1)
    return cudaErrorInvalidValue;
  *s = Shape{H, Hkv, D, ps, max_pages, n_pages};
  return dtype == 0 ? choose<float>(L, B, Hkv, H / Hkv, D, max_pages)
                    : choose<__nv_bfloat16>(L, B, Hkv, H / Hkv, D, max_pages);
}

}  // namespace

extern "C" {

// Floats of device workspace a call with these sizes needs: 1 for sizes
// the kernel takes (the splits merge in shared memory, so it needs
// none; the Python wrapper does not call it and passes no workspace; the
// C interface keeps the function), 0 for sizes it does not take:
// D > 128 or not a multiple of 8, page_size > 128, or a group too large
// for the registers and shared memory (more than 64 heads at D = 128).
// Asks for the bf16 plan (the fp32 one is checked at launch).
size_t paged_decode_attention_workspace(int B, int H, int Hkv, int D, int ps,
                                        int max_pages) {
  Shape s;
  Plan L;
  return plan_for(&s, &L, B, H, Hkv, D, ps, max_pages, 1, 1) == cudaSuccess;
}

// The launch's cut for these sizes and dtype (0 = float32, 1 =
// bfloat16): out[0] = C (CTAs a cluster), out[1] = positions a tile,
// out[2] = shared-memory bytes a CTA.  Returns 0, or
// cudaErrorInvalidValue for sizes the kernel does not take.
int paged_decode_attention_plan(int B, int H, int Hkv, int D, int ps,
                                int max_pages, int dtype, int* out) {
  Shape s;
  Plan L;
  const cudaError_t err =
      plan_for(&s, &L, B, H, Hkv, D, ps, max_pages, 1, dtype);
  if (err != cudaSuccess) return (int)err;
  out[0] = L.C;
  out[1] = L.tile;
  out[2] = (int)L.total;
  return 0;
}

// scale: the softmax scale D**-0.5.  dtype: 0 = float32, 1 = bfloat16.
// workspace: unused.  Returns the launch's cudaError_t (0 on success);
// cudaErrorInvalidValue for sizes the kernel does not take or a cluster
// the card cannot place.
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* kv_len, void* out, void* workspace,
                           int B, int H, int Hkv, int D, int ps,
                           int max_pages, int n_pages, float scale, int dtype,
                           void* stream) {
  (void)workspace;
  Shape s;
  Plan L;
  const cudaError_t err =
      plan_for(&s, &L, B, H, Hkv, D, ps, max_pages, n_pages, dtype);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* bt = (const int32_t*)block_tables;
  const int32_t* kl = (const int32_t*)kv_len;
  if (dtype == 0)
    return launch(pick<float>(L.gc, L.cpg), L, Hkv, B, st, (const float*)q,
                  (const float*)k_pages, (const float*)v_pages, bt, kl,
                  (float*)out, s, L, scale);
  using bf = __nv_bfloat16;
  return launch(pick<bf>(L.gc, L.cpg), L, Hkv, B, st, (const bf*)q,
                (const bf*)k_pages, (const bf*)v_pages, bt, kl, (bf*)out, s,
                L, scale);
}

}  // extern "C"
