// Contiguous decode attention for Hopper (sm_90a): one query token per
// sequence against a contiguous KV cache with a per-sequence valid
// length, the g = H/Hkv query heads of one KV head computed together
// (flash-decoding with split-KV; the design, and what bounds it, are in
// split_decode.cuh, which this kernel shares with the paged one).
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
//
// What is particular to the contiguous cache: position t of sequence b
// is row b*S + t, so a split of 128 positions needs no table.  Only
// positions below kv_len are read: after an eviction a reused slot row
// holds a stale sequence's KV past the new prefix, and a ring buffer
// (sliding window) holds min(pos + 1, S) valid rows in any order, which
// softmax does not see.

#include "split_decode.cuh"

namespace {

using namespace split_decode;

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ kv_len,
                    float* __restrict__ work, int H, int Hkv, int D, int S,
                    int n_splits, float scale) {
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hkv;
  const int len = max(0, min(kv_len[b], S));
  const int t0 = split * kTile;
  if (t0 >= len) return;                     // past the sequence's length
  const int n_pos = min(len - t0, kTile);
  const size_t row_stride = (size_t)Hkv * D;  // between positions
  const size_t first = ((size_t)b * S + t0) * row_stride + (size_t)h * D;
  extern __shared__ float smem[];
  attend_split<T>(
      q + ((size_t)b * H + (size_t)h * g) * D, k, v,
      [=](int t) { return first + (size_t)t * row_stride; }, n_pos, g, D,
      scale,
      work + (((size_t)b * Hkv + h) * n_splits + split) * split_stride(g, D),
      smem);
}

int n_splits_for(int S) { return (S + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// Floats of f32 device workspace a call with these sizes needs (0 for
// sizes the kernel does not take: g > 8, D > 128 or not a multiple of 8).
size_t decode_attention_workspace(int B, int H, int Hkv, int D, int S) {
  if (!heads_ok(B, H, Hkv, D) || S < 1) return 0;
  return (size_t)B * Hkv * n_splits_for(S) * split_stride(H / Hkv, D);
}

// scale: the softmax scale D**-0.5.  dtype: 0 = float32, 1 = bfloat16.
// workspace: decode_attention_workspace(...) floats on the device.
// Returns the launches' cudaError_t (0 on success); cudaErrorInvalidValue
// for sizes the kernel does not take.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, void* workspace, int B,
                     int H, int Hkv, int D, int S, float scale, int dtype,
                     void* stream) {
  if (!heads_ok(B, H, Hkv, D) || S < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int g = H / Hkv;
  const int n_splits = n_splits_for(S);
  const int vec = dtype == 0 ? Vec<float>::n : Vec<__nv_bfloat16>::n;
  const size_t smem1 = split_smem_bytes(g, D, vec);
  const size_t smem2 = merge_smem_bytes(g, n_splits);
  if (smem2 > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid1(n_splits, Hkv, B), grid2(Hkv, B);
  float* work = (float*)workspace;
  const int32_t* kl = (const int32_t*)kv_len;
  if (dtype == 0) {
    decode_split_kernel<float><<<grid1, kThreads, smem1, st>>>(
        (const float*)q, (const float*)k, (const float*)v, kl, work, H, Hkv,
        D, S, n_splits, scale);
    merge_kernel<float><<<grid2, kThreads, smem2, st>>>(
        kl, work, (float*)out, H, Hkv, D, n_splits, kTile, S);
  } else {
    decode_split_kernel<__nv_bfloat16><<<grid1, kThreads, smem1, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, kl, work, H, Hkv, D, S, n_splits, scale);
    merge_kernel<__nv_bfloat16><<<grid2, kThreads, smem2, st>>>(
        kl, work, (__nv_bfloat16*)out, H, Hkv, D, n_splits, kTile, S);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
