// Contiguous decode attention for Hopper (sm_90a): one query token per
// sequence against a contiguous KV cache with a per-sequence valid
// length, the g = H/Hkv query heads of one KV head computed together
// (split-KV in one launch, the splits merged in a thread block cluster;
// the design, and what bounds it, are in split_decode.cuh, which this
// kernel shares with the paged one).
//
// Replaces: the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention_kernel), the one-token decode against a (B, S, Hkv,
// D) cache that repro/models/attention.py::attention_decode computes for
// the fixed-slot ServingEngine and the contiguous SlotManager.
//
// Layouts (all row-major, contiguous):
//   q       (B, H, D)          f32 or bf16
//   k/v     (B, S, Hkv, D)     same type as q: one layer's cache
//   kv_len  (B,)               int32; positions >= min(kv_len, S) unread
//   out     (B, H, D)          q's type
//   lse     (B, H)             f32, or null: each head's log-sum-exp of
//                              its scaled scores over the valid
//                              positions (natural log); -1e30 where a
//                              sequence has none (kv_len 0), whose
//                              outputs are 0
//
// What is particular to the contiguous cache: position t of sequence b
// is row b*S + t, so a CTA's contiguous range of positions needs no
// table.  Only
// positions below kv_len are read: after an eviction a reused slot row
// holds a stale sequence's KV past the new prefix, and a ring buffer
// (sliding window) holds min(pos + 1, S) valid rows in any order, which
// softmax does not see.  A cache cut on its positions over ranks gives
// each rank a slice in which a sequence may hold no valid position
// (kv_len 0): its partial (out 0, lse -1e30) weighs nothing when the
// ranks' partials are merged by their lse.

#include "split_decode.cuh"

namespace {

using namespace split_decode;

template <typename T, int GC, int CPG>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ kv_len,
              T* __restrict__ out, float* __restrict__ lse, int H, int Hkv,
              int D, int S, Plan L, float scale) {
  const int rank = blockIdx.x;               // == the CTA's cluster rank
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hkv;
  const Lanes<T, GC, CPG> me(L, q + ((size_t)b * H + (size_t)h * g) * D, g,
                             D);                     // q's loads go first
  const int len = max(0, min(kv_len[b], S));
  const int per = (len + L.C - 1) / L.C;     // the CTA's positions
  const int t0 = min(rank * per, len);
  const int n = min(per, len - t0);
  const size_t row_stride = (size_t)Hkv * D;  // between positions
  const size_t first = ((size_t)b * S + t0) * row_stride + (size_t)h * D;
  extern __shared__ __align__(16) unsigned char smem[];
  attend_cluster<T, GC, CPG>(
      me, k, v,
      [=](int u) { return first + (size_t)u * row_stride; }, n, false, g, D,
      scale, L, smem, out + ((size_t)b * H + (size_t)h * g) * D,
      lse == nullptr ? nullptr : lse + (size_t)b * H + (size_t)h * g);
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const int32_t*, T*,
                        float*, int, int, int, int, Plan, float);

// The kernel instance for a plan's head cut (two chunks a group: f32
// only).
template <typename T>
Kernel<T> pick(int gc, int cpg) {
  if constexpr (sizeof(T) == 4)
    if (cpg == 2) return decode_kernel<T, kChunk, 2>;
  switch (gc) {
    case 1: return decode_kernel<T, 1, 1>;
    case 2: return decode_kernel<T, 2, 1>;
    case 3: return decode_kernel<T, 3, 1>;
    case 4: return decode_kernel<T, 4, 1>;
    default: return decode_kernel<T, kChunk, 1>;
  }
}

template <typename T>
cudaError_t choose(Plan* L, int B, int Hkv, int g, int D) {
  int gc, cpg, hs, ns, W;
  head_cut(g, D, sizeof(T), &gc, &cpg, &hs, &ns, &W);
  if (!cpg) return cudaErrorInvalidValue;
  return choose_plan(pick<T>(gc, cpg), L, B, Hkv, g, D, sizeof(T), 0);
}

// The plan a call with these sizes runs under, checked against the card
// for the dtype's kernel (0 = float32, 1 = bfloat16).
cudaError_t plan_for(Plan* L, int B, int H, int Hkv, int D, int S,
                     int dtype) {
  if ((dtype != 0 && dtype != 1) || !heads_ok(B, H, Hkv, D) || S < 1)
    return cudaErrorInvalidValue;
  return dtype == 0 ? choose<float>(L, B, Hkv, H / Hkv, D)
                    : choose<__nv_bfloat16>(L, B, Hkv, H / Hkv, D);
}

}  // namespace

extern "C" {

// Floats of device workspace a call with these sizes needs: 1 for sizes
// the kernel takes (the splits merge in shared memory, so it needs
// none; the Python wrapper does not call it and passes no workspace; the
// C interface keeps the function), 0 for sizes it does not take:
// D > 128 or not a multiple of 8, or a group too large for the
// registers and shared memory (more than 64 heads at D = 128).
// Asks for the bf16 plan (the fp32 one is checked at launch).
size_t decode_attention_workspace(int B, int H, int Hkv, int D, int S) {
  Plan L;
  return plan_for(&L, B, H, Hkv, D, S, 1) == cudaSuccess;
}

// The launch's cut for these sizes and dtype (0 = float32, 1 =
// bfloat16): out[0] = C (CTAs a cluster), out[1] = positions a tile,
// out[2] = shared-memory bytes a CTA.  Returns 0, or
// cudaErrorInvalidValue for sizes the kernel does not take.
int decode_attention_plan(int B, int H, int Hkv, int D, int S, int dtype,
                          int* out) {
  Plan L;
  const cudaError_t err = plan_for(&L, B, H, Hkv, D, S, dtype);
  if (err != cudaSuccess) return (int)err;
  out[0] = L.C;
  out[1] = L.tile;
  out[2] = (int)L.total;
  return 0;
}

// scale: the softmax scale D**-0.5.  dtype: 0 = float32, 1 = bfloat16.
// lse: (B, H) f32 written with each head's log-sum-exp, or null (not
// written).  workspace: unused.  Returns the launch's cudaError_t (0 on success);
// cudaErrorInvalidValue for sizes the kernel does not take or a cluster
// the card cannot place.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, void* lse,
                     void* workspace, int B,
                     int H, int Hkv, int D, int S, float scale, int dtype,
                     void* stream) {
  (void)workspace;
  Plan L;
  const cudaError_t err = plan_for(&L, B, H, Hkv, D, S, dtype);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* kl = (const int32_t*)kv_len;
  if (dtype == 0)
    return launch(pick<float>(L.gc, L.cpg), L, Hkv, B, st, (const float*)q,
                  (const float*)k, (const float*)v, kl, (float*)out,
                  (float*)lse, H, Hkv, D, S, L, scale);
  using bf = __nv_bfloat16;
  return launch(pick<bf>(L.gc, L.cpg), L, Hkv, B, st, (const bf*)q,
                (const bf*)k, (const bf*)v, kl, (bf*)out, (float*)lse, H, Hkv,
                D, S, L, scale);
}

}  // extern "C"
