// Warp-level tensor-core helpers shared by the bf16 flash prefill kernel
// (flash_attention.cu) and the bf16 SSD chunked scan (ssm_chunk_scan.cu):
// ldmatrix loads from shared memory, mma.sync products in bf16 and TF32
// with fp32 accumulators, the TF32 hi/lo split, and cp.async copies.
//
// Fragment layouts of mma.sync (lane = 4 * gid + tig, gid = lane / 4,
// tig = lane % 4), which both kernels rely on:
//   m16n8k16 bf16  A (16 x 16, row-major), four b32 registers of two bf16
//                  each: a0 = (row gid, cols 2tig, 2tig+1), a1 = (gid+8,
//                  2tig..), a2 = (gid, 2tig+8..), a3 = (gid+8, 2tig+8..);
//                  B (16 x 8, "col"): b0 = (k 2tig, 2tig+1; col gid),
//                  b1 = (k 2tig+8, 2tig+9; col gid).
//   m16n8k8 tf32   A: a0 = (gid, k tig), a1 = (gid+8, tig), a2 = (gid,
//                  tig+4), a3 = (gid+8, tig+4); B: b0 = (k tig; col gid),
//                  b1 = (k tig+4; col gid).
//   accumulators   C/D (16 x 8 fp32): c0, c1 = (row gid, cols 2tig,
//                  2tig+1), c2, c3 = (row gid+8, the same cols).
// Two facts follow that the kernels use instead of shuffles:
//   * the accumulators of two adjacent n-tiles are, packed to bf16 pairs,
//     a bf16 A fragment over those 16 columns (FlashAttention-2's P);
//   * a TF32 product whose k order inside each 8-block is permuted as
//     k = tig <-> 2tig, k = tig+4 <-> 2tig+1 (applied to both operands,
//     so the sum is unchanged) takes its A fragment straight from an
//     accumulator (a0..a3 = c0, c2, c1, c3) or from a bf16 A fragment's
//     low and high halves, and its B fragment from one ldmatrix.trans of
//     a row-major [k][n] bf16 tile, whose packed (row 2tig, 2tig+1; col
//     gid) pair is exactly (b0, b1).
// A bf16 value widened to fp32 (its bits shifted up 16) is exact in TF32
// (8-bit significand within TF32's 11), so such operands need no split.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async: 16-byte global -> shared copies ------------------------------

// Copies 16 bytes from src to dst, or writes 16 zero bytes (and reads
// nothing) when valid is false.  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- ldmatrix: four 8 x 8 b16 matrices, one row address per lane ----------

// Lanes 8i .. 8i+7 give the row addresses of matrix i; r[i] holds, in
// each lane, row gid of matrix i at columns 2tig, 2tig+1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, transposed: r[i] holds rows 2tig, 2tig+1 of matrix i at
// column gid (the low half is row 2tig).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ---- mma.sync ----------------------------------------------------------------

// d += a b, m16n8k16, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8, TF32 inputs (fp32 bit patterns), fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- conversions -------------------------------------------------------------

// x rounded to TF32 (to nearest, ties away), as fp32 bits.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + r with hi = tf32(x), lo = tf32(x - hi) and |r| <= 2^-22
// |x|: two TF32 products (hi b + lo b) give a product with an fp32-grade
// error where b is exact in TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// Two fp32 values as a bf16 pair, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by the SFU alone (ex2.approx.ftz: ~2 ulp, results below 2^-126
// flushed to 0); exp2f adds a denormal fix-up of a few instructions.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) = (a, b) as a bf16 pair hi plus the pair of what it dropped,
// lo = bf16(a - hi.a), bf16(b - hi.b): hi + lo holds a and b to ~2^-17
// relative, so two bf16 products (hi x + lo x) are fp32-grade where x is
// bf16.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16),
                 b - __uint_as_float(hi & 0xffff0000u));
}

// The low / high bf16 of a packed pair widened to fp32 bits (exact TF32).
__device__ __forceinline__ uint32_t bf16_lo(uint32_t v) { return v << 16; }
__device__ __forceinline__ uint32_t bf16_hi(uint32_t v) {
  return v & 0xffff0000u;
}

}  // namespace mma
