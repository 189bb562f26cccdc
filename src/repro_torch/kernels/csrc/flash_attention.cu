// Flash attention forward for Hopper (sm_90a): FlashAttention-2's online
// softmax over KV tiles, GQA by h // g, causal and sliding-window masks,
// fp32 accumulation, output in q's type and, when asked for, each row's
// log-sum-exp.
//
// Replaces: the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_kernel), the TPU twin of repro/models/flash.py, which
// every monolithic prefill (repro/models/attention.py::attention_fwd,
// mode="flash") runs once per layer.
//
// Layouts: q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv) and
// out (B, Sq, H, Dv), read and written in place through their batch, sequence
// and head strides (elements; the last axis is contiguous): no
// transposed copies.  lse, when the caller passes it (training: the
// backward recomputes the probabilities from it, as
// repro/models/flash.py::_flash_bwd_impl does), is fp32 (B, H, Sq),
// contiguous: row (b, h, s) holds log sum_k exp(scale * q.k) over the
// keys the mask keeps, in natural-log units of the scaled scores, with
// query head h = kv * g + j (the reference's (B, Hkv, g, Sq)).  A null
// lse writes nothing more: the serving paths pass null.  D is the q/k
// head dim, Dv the v head dim: equal
// for GQA attention, 192 and 128 for DeepSeek-V3's expanded MLA prefill
// (qk_nope 128 + qk_rope 64 against v 128; repro/models/attention.py::
// mla_fwd), whose softmax scale is D^-0.5.  Any g = H/Hkv, any Sq and
// Skv (ragged edges masked, nothing padded).  Sq may differ from Skv
// (whisper's cross-attention: Sq text positions against Skv = 1500
// encoder frames); as in the TPU kernel, the causal mask is then
// top-left aligned (qpos >= kpos, both counted from 0), and the grid
// runs over query tiles of Sq while each CTA's key loop runs to Skv (to
// min(Skv, q0 + nq) when causal).  Masked
// scores are -1e30 (not -inf) and l is clamped at 1e-30, as in the TPU
// kernel; a tile in which a row has no valid key adds weight that the
// rescale exp(-1e30 - m) = 0 removes once a valid key comes.
//
// Both designs give one CTA 64 (position, head) rows of one (batch, KV
// head): bq = 64 / gs positions times gs query heads of that KV head,
// so every K/V tile loaded into shared memory serves all gs heads (at g =
// 3, 21 positions and 63 rows).  gs = g up to g = 8; a wider group
// (granite's 48 query heads over one KV head) is cut into g / gs slices
// of gs heads, gs its largest divisor up to 8 (48 -> 8, 12 -> 6), one
// CTA a slice along grid y (H / gs), query heads blockIdx.y * gs + j: a
// slice of one position a CTA would stream the whole causal prefix for
// each position, a slice of 8 heads keeps 8 positions a CTA.  The TPU grid carries m, l and the
// accumulator in VMEM across a sequential kv axis; here the CTA loops
// over the KV tiles itself.  Causal tiles above the diagonal and
// sliding-window tiles below q0 - window + 1 are never loaded.
//
// What bounds it: operations.  At the prefill shapes (S = 1024, D = 64,
// g = 3) a KV tile of 64 positions read once serves 64 query rows, ~64
// operations per byte before the q rows are counted.  So each type gets
// the fastest exact-enough unit:
//
// bf16 (every serve path): the tensor cores, warp-level mma.sync
// (mma_sm90.cuh).  4 warps of 16 rows.  (D, Dv) template parameters:
// D = Dv a multiple of 16 up to 128, or (192, 128) for MLA; rows
// 16-byte aligned (cp.async).  At (192, 128) Q's fragments take 48
// registers and O's 64, so the register cap allows 2 CTAs an SM.
//   * K/V tiles of 64 keys stay bf16 in shared memory, loaded with
//     cp.async into a two-stage ring (tile j+1 in flight while tile j is
//     computed); rows padded by 16 bytes, so the 8 rows an ldmatrix
//     reads fall in distinct banks.
//   * S = QK^T: m16n8k16 bf16 MMAs from Q's A fragments (loaded once,
//     kept in registers) and K as the col-major B operand (ldmatrix of
//     its row-major tile); 16 x 64 fp32 scores per warp in registers,
//     never in shared memory.
//   * Softmax in registers, in the log2 domain: p = exp2(s c - m c)
//     with c = D^-0.5 log2(e), one FFMA and one EX2 a score, all in fp32
//     (Q is not pre-scaled: at D = 112 the scale is not a power of two
//     and a bf16 q * scale would round).  Each row's max is reduced over
//     the quad that holds it with two shuffles, its sum kept per thread
//     and reduced once at the end.  The mask (causal, window, kpos < Skv,
//     row by row at position q0 + r / g) is applied only in tiles that
//     cross one of those edges, and there a warp skips the 16-key blocks
//     past the last key its rows may see; a row with no valid key so far
//     adds no weight (p = 0), which the fp32 design's rescale reaches
//     too.  exp2 is the SFU's ex2.approx.ftz (~2 ulp): exp2f's denormal
//     fix-up cost a few instructions a score.
//   * O += PV: P stays in registers as the A fragment (two adjacent
//     n-tiles of accumulators are one m16n8k16 A fragment), split into
//     bf16 hi + lo and multiplied twice: a single bf16 P (2^-9 relative)
//     moved outputs by 2 bf16 ulps against the fp32 plain version on the
//     card, past atol 1e-3 + rtol 1e-2; hi + lo holds P to ~2^-17, for
//     half again the MMAs.  V is the B operand through ldmatrix.trans; O
//     stays in fp32 registers, rescaled by exp2(m_old - m_new) per row.
//   * Registers are capped so that 4 CTAs (16 warps) share an SM at D <=
//     64 and 3 up to D = 112.  Two variants measured slower on an H100
//     80GB HBM3 at 700 W: 128 rows of 8 warps a CTA (half the k/v tile
//     copies) and a software pipeline holding tile j+1's scores while
//     tile j's softmax runs (162 registers, 3 CTAs an SM).
//
// fp32 (the fp32 cross-checks and tests only): the CUDA cores, fp32
// FMAs from fp32 tiles in shared memory.  Those checks want full fp32
// products, which TF32 MMAs would not give.  16 x 16 threads each hold
// a 4 x 4 score tile reading q and k as float4 from transposed tiles;
// m and l live in shared memory; O += PV over TM rows x 8 columns a
// thread (TM = 2 for Dv <= 64, 4 above); D = Dv a multiple of 8 up to
// 128, or (192, 128) (whose tiles take 154 KB: one CTA an SM).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                 // query rows (position, head) per CTA
constexpr int kBK = 64;                   // key positions per tile
constexpr int kPad = 68;                  // row stride of the transposed tiles
constexpr int kMaxD = 128;                // D = Dv
constexpr int kSplitD = 192, kSplitDv = 128;   // MLA's (D, Dv)
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                             // (B, H, Sq) or null
  long long qs[3], ks[3], vs[3], os[3];   // (batch, seq, head) strides
  int Sq, Skv, H, Hkv, D, Dv, g, bq, causal, window;
  int gs, ns;                             // heads a CTA, slices of a group
  float scale;
};

// ---- fp32: CUDA cores -------------------------------------------------------

// Floats of dynamic shared memory for head sizes D (q/k) and Dv (v).
size_t smem_floats(int D, int Dv) {
  return (size_t)2 * D * kPad             // q^T, k^T
         + (size_t)kBK * Dv               // v
         + (size_t)kBK * kPad             // scores / probabilities, by key
         + 3 * kRows                      // m, l, rescale
         + 8 * kRows;                     // two (4, kRows) reductions
}

template <int TM>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Params p) {
  const float* __restrict__ q = static_cast<const float*>(p.q);
  const float* __restrict__ k = static_cast<const float*>(p.k);
  const float* __restrict__ v = static_cast<const float*>(p.v);
  float* __restrict__ o = static_cast<float*>(p.o);
  const int b = blockIdx.z;
  const int kv = blockIdx.y / p.ns;        // KV head
  const int hq0 = blockIdx.y * p.gs;       // its first query head
  const int g = p.gs, D = p.D, Dv = p.Dv, Sq = p.Sq, Skv = p.Skv;
  const int q0 = blockIdx.x * p.bq;
  const int nq = min(p.bq, Sq - q0);       // valid positions in the block
  const int R = p.bq * g;                  // rows in use (<= kRows)
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* qt = smem;                        // [D][kPad]  q * scale, by dim
  float* kt = qt + (size_t)D * kPad;       // [D][kPad]  k tile, by dim
  float* vt = kt + (size_t)D * kPad;       // [kBK][Dv]  v tile
  float* st = vt + (size_t)kBK * Dv;       // [kBK][kPad] scores, by key
  float* m_s = st + kBK * kPad;            // [kRows] running max
  float* l_s = m_s + kRows;                // [kRows] running denominator
  float* c_s = l_s + kRows;                // [kRows] this tile's rescale
  float* red = c_s + kRows;                // [4][kRows] partial maxima
  float* red2 = red + 4 * kRows;           // [4][kRows] partial sums

  // rows r = qi * g + gi: the g heads of position q0 + qi are contiguous
  const float* q_b = q + b * p.qs[0] + (size_t)hq0 * p.qs[2];
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int qi = r / g, gi = r - qi * g;
    float x = 0.f;
    if (r < R && qi < nq)
      x = q_b[(q0 + qi) * p.qs[1] + gi * p.qs[2] + d] * p.scale;
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
  const int n_chunks = Dv / 8;
  const bool oc_active = tid < (kRows / TM) * n_chunks;
  const int oc_r0 = (tid / n_chunks) * TM, oc_c0 = (tid % n_chunks) * 8;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int lo = 0, hi = Skv;
  if (p.causal) hi = min(Skv, q0 + nq);
  if (p.window > 0) lo = max(0, q0 - p.window + 1);
  lo = lo / kBK * kBK;

  const float* k_b = k + b * p.ks[0] + (size_t)kv * p.ks[2];
  const float* v_b = v + b * p.vs[0] + (size_t)kv * p.vs[2];
  for (int j0 = lo; j0 < hi; j0 += kBK) {
    __syncthreads();                       // the last tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int jj = e / D, d = e - jj * D;
      const int kpos = j0 + jj;
      float kx = 0.f, vx = 0.f;
      if (kpos < Skv) {
        kx = k_b[kpos * p.ks[1] + d];
        if (d < Dv) vx = v_b[kpos * p.vs[1] + d];
      }
      kt[d * kPad + jj] = kx;
      if (d < Dv) vt[jj * Dv + d] = vx;
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
          bool ok = kpos < Skv;
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
        const float4 y0 =
            *reinterpret_cast<const float4*>(&vt[jj * Dv + oc_c0]);
        const float4 y1 =
            *reinterpret_cast<const float4*>(&vt[jj * Dv + oc_c0 + 4]);
        const float ys[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pr[i], ys[j], acc[i][j]);
      }
    }
  }

  if (p.lse != nullptr) {                  // m and l are final (synced above)
    for (int r = tid; r < R; r += kThreads) {
      const int qi = r / g, gi = r - qi * g;
      if (qi < nq)
        p.lse[((size_t)b * p.H + hq0 + gi) * Sq + q0 + qi] =
            m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
    }
  }
  if (oc_active) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = oc_r0 + i;
      const int qi = r / g, gi = r - qi * g;
      if (r >= R || qi >= nq) continue;
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      float* orow = o + b * p.os[0] + (q0 + qi) * p.os[1] +
                ((size_t)hq0 + gi) * p.os[2] + oc_c0;
#pragma unroll
      for (int j = 0; j < 8; ++j) orow[j] = acc[i][j] * inv;
    }
  }
}

template <int TM>
int launch_f32(const Params& p, int B, cudaStream_t st) {
  const size_t smem = smem_floats(p.D, p.Dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.Hkv * p.ns, B);
  flash_fwd_f32_kernel<TM><<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores ------------------------------------------------------

constexpr int kTcThreads = 128;           // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// Bytes of dynamic shared memory: a two-stage ring of k and v tiles,
// rows of D + 8 and Dv + 8 bf16 (16 bytes of padding); q (kRows = kBK
// rows of D) is staged in the second k stage before the loop starts.
size_t tc_smem_bytes(int D, int Dv) {
  return (size_t)2 * kBK * (D + 8 + Dv + 8) * sizeof(bf16);
}

// CTAs an SM must hold: the register cap that leaves (4 at D <= 64: 128
// registers a thread; 3 up to D = 112: 170; 2 above: 255).
constexpr int tc_min_blocks(int D) { return D <= 64 ? 4 : D <= 112 ? 3 : 2; }

template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(D))
    flash_fwd_bf16_kernel(Params p) {
  constexpr int LD = D + 8;               // k/q smem row stride (bf16)
  constexpr int LDV = DV + 8;             // v smem row stride (bf16)
  constexpr int KD = D / 16;              // k-steps of QK^T
  constexpr int ND = DV / 8;              // n-tiles of O
  constexpr int CH = D / 8;               // 16-byte chunks per q/k row
  constexpr int CHV = DV / 8;             // 16-byte chunks per v row
  static_assert(kRows == kBK, "q is staged in one k stage");
  static_assert(D >= DV, "k rows are at least as wide as v rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [2][kBK][LD]
  bf16* vs = ks + 2 * kBK * LD;                    // [2][kBK][LDV]
  bf16* qs = ks + kBK * LD;        // [kRows][LD], k's stage 1 until tile 1
  const int b = blockIdx.z;
  const int kv = blockIdx.y / p.ns;        // KV head
  const int hq0 = blockIdx.y * p.gs;       // its first query head
  const int g = p.gs, Sq = p.Sq, Skv = p.Skv;
  const int q0 = blockIdx.x * p.bq;
  const int nq = min(p.bq, Sq - q0);
  const int R = p.bq * g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // rows r = qi * g + gi: the g heads of position q0 + qi are contiguous
  const bf16* q_b = static_cast<const bf16*>(p.q) + b * p.qs[0] +
                    (long long)hq0 * p.qs[2];
  for (int e = tid; e < kRows * CH; e += kTcThreads) {
    const int r = e / CH, c = e - r * CH;
    const int qi = r / g, gi = r - qi * g;
    const bool ok = r < R && qi < nq;
    const bf16* src =
        ok ? q_b + (q0 + qi) * p.qs[1] + gi * p.qs[2] + c * 8 : q_b;
    mma::cp_async16(qs + r * LD + c * 8, src, ok);
  }
  mma::cp_async_commit();

  int lo = 0, hi = Skv;
  if (p.causal) hi = min(Skv, q0 + nq);
  if (p.window > 0) lo = max(0, q0 - p.window + 1);
  lo = lo / kBK * kBK;
  const int n_tiles = (hi - lo + kBK - 1) / kBK;

  const bf16* k_b = static_cast<const bf16*>(p.k) + b * p.ks[0] +
                    (long long)kv * p.ks[2];
  const bf16* v_b = static_cast<const bf16*>(p.v) + b * p.vs[0] +
                    (long long)kv * p.vs[2];
  auto load_tile = [&](int stage, int j0) {
    bf16* kd = ks + stage * kBK * LD;
    bf16* vd = vs + stage * kBK * LDV;
    // a k and a v chunk per step while both rows have one (every
    // chunk at D = Dv), then the rest of the wider k rows
    for (int e = tid; e < kBK * CHV; e += kTcThreads) {
      const int jj = e / CHV, c = e - jj * CHV;
      const int kpos = j0 + jj;
      const bool ok = kpos < Skv;            // zero-filled past Skv
      mma::cp_async16(kd + jj * LD + c * 8,
                      ok ? k_b + kpos * p.ks[1] + c * 8 : k_b, ok);
      mma::cp_async16(vd + jj * LDV + c * 8,
                      ok ? v_b + kpos * p.vs[1] + c * 8 : v_b, ok);
    }
    if constexpr (CH > CHV) {
      constexpr int XC = CH - CHV;        // k's chunks past v's width
      for (int e = tid; e < kBK * XC; e += kTcThreads) {
        const int jj = e / XC, c = CHV + (e - jj * XC);
        const int kpos = j0 + jj;
        const bool ok = kpos < Skv;
        mma::cp_async16(kd + jj * LD + c * 8,
                        ok ? k_b + kpos * p.ks[1] + c * 8 : k_b, ok);
      }
    }
  };
  load_tile(0, lo);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];                      // Q's A fragments, kept
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    mma::ldmatrix_x4(qf[kd], qs + (warp * 16 + (lane & 15)) * LD + kd * 16 +
                                 (lane >> 4) * 8);
  __syncthreads();                         // qs is k's stage 1 from here

  // this thread's two rows: ra (accumulators 0, 1) and ra + 8 (2, 3)
  const int ra = warp * 16 + gid;
  const int qpos_a = q0 + ra / g, qpos_b = q0 + (ra + 8) / g;
  const float scale_log2 = p.scale * kLog2e;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = lo + it * kBK, st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(st ^ 1, j0 + kBK);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * kBK * LD;
    const bf16* vt = vs + st * kBK * LDV;

    float s[8][4];                         // 16 rows x 64 keys
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const bool need_mask = j0 + kBK > Skv ||
                           (p.causal && j0 + kBK - 1 > q0) ||
                           (p.window > 0 && q0 + nq - 1 - j0 >= p.window);
    // 16-key blocks this warp needs: past the last key that one of its
    // valid rows may see (causal) or past Skv, a block is all masked
    int nblk = 4;
    if (need_mask) {
      int kmax = Skv - 1;
      if (p.causal) kmax = min(kmax, q0 + min(nq - 1, (warp * 16 + 15) / g));
      nblk = kmax < j0 ? 0 : min(4, (kmax - j0) / 16 + 1);
    }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np >= nblk) break;
        uint32_t kb[4];
        mma::ldmatrix_x4(kb, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      LD + kd * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * np], qf[kd], kb[0], kb[1]);
        mma::mma_bf16(s[2 * np + 1], qf[kd], kb[2], kb[3]);
      }
    }

    if (need_mask) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = j0 + n * 8 + 2 * tig + (e & 1);
          const int qpos = e < 2 ? qpos_a : qpos_b;
          bool ok = kpos < Skv;
          if (p.causal) ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
          if (!ok) s[n][e] = kNegInf;
        }
    }
    // maxima of the raw scores (the scale is positive), then everything
    // in the log2 domain: p = exp2(s * scale_log2 - m * scale_log2)
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = mma::ex2((m_a - mn_a) * scale_log2);
    const float corr_b = mma::ex2((m_b - mn_b) * scale_log2);
    m_a = mn_a;
    m_b = mn_b;
    // a row with no valid key yet keeps p = 0 (m * scale_log2 - its
    // rounding could otherwise reach exp2 of ~1e22)
    const float ms_a = mn_a == kNegInf ? 0.f : mn_a * scale_log2;
    const float ms_b = mn_b == kNegInf ? 0.f : mn_b * scale_log2;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = mma::ex2(fmaf(s[n][0], scale_log2, -ms_a));
      s[n][1] = mma::ex2(fmaf(s[n][1], scale_log2, -ms_a));
      s[n][2] = mma::ex2(fmaf(s[n][2], scale_log2, -ms_b));
      s[n][3] = mma::ex2(fmaf(s[n][3], scale_log2, -ms_b));
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr_a;
      o[n][1] *= corr_a;
      o[n][2] *= corr_b;
      o[n][3] *= corr_b;
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {       // 16 keys a step
      if (kk >= nblk) break;               // p = 0 there
      uint32_t ph[4], pl[4];               // P = hi + lo, both bf16
      mma::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      mma::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      mma::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      mma::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vb[4];
        mma::ldmatrix_x4_trans(
            vb, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                    dp * 16 + (lane >> 4) * 8);
        mma::mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        mma::mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        mma::mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
        mma::mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
      }
    }
    __syncthreads();                       // stage st is refilled next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ra + 8 * half;
    const int qi = r / g, gi = r - qi * g;
    if (r >= R || qi >= nq) continue;
    const float l = fmaxf(half ? l_b : l_a, 1e-30f);
    const float m = half ? m_b : m_a;
    const float inv = 1.f / l;
    // m is the raw score's max and l = sum 2^(c (s - m)), c = scale
    // log2(e): in natural-log units lse = scale m + ln l
    if (p.lse != nullptr && tig == 0)
      p.lse[((size_t)b * p.H + hq0 + gi) * Sq + q0 + qi] =
          m == kNegInf ? kNegInf : m * p.scale + logf(l);
    bf16* orow = static_cast<bf16*>(p.o) + b * p.os[0] + (q0 + qi) * p.os[1] +
                 ((long long)hq0 + gi) * p.os[2] + 2 * tig;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) = mma::pack_bf16(
          o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
  }
}

template <int D, int DV = D>
int launch_bf16(const Params& p, int B, cudaStream_t st) {
  const size_t smem = tc_smem_bytes(D, DV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.Hkv * p.ns, B);
  flash_fwd_bf16_kernel<D, DV><<<grid, kTcThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const Params& p, int B, cudaStream_t st) {
  if (p.Dv != p.D) return launch_bf16<kSplitD, kSplitDv>(p, B, st);
  switch (p.D) {
    case 16: return launch_bf16<16>(p, B, st);
    case 32: return launch_bf16<32>(p, B, st);
    case 48: return launch_bf16<48>(p, B, st);
    case 64: return launch_bf16<64>(p, B, st);
    case 80: return launch_bf16<80>(p, B, st);
    case 96: return launch_bf16<96>(p, B, st);
    case 112: return launch_bf16<112>(p, B, st);
    case 128: return launch_bf16<128>(p, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Strides are in elements, for the batch, sequence and head axes of q,
// k, v and out; the last axis of each is contiguous.  Sq: the query
// length, Skv: the key/value length (causal masks are top-left aligned
// when they differ).  lse: null, or fp32 (B, H, Sq) contiguous for each
// row's log-sum-exp.  D: the q/k head
// dim; Dv: the v (and out) head dim; D = Dv a multiple of 8 up to 128,
// or (D, Dv) = (192, 128).  causal: 0 or 1.
// window: 0 for full attention, else keys with qpos - kpos >= window are
// masked.  scale: the softmax scale D**-0.5.  dtype: 0 = float32 (CUDA
// cores), 1 = bfloat16 (tensor cores: D = Dv a multiple of 16 up to
// 128, or (D, Dv) = (192, 128); pointers 16-byte aligned and strides
// multiples of 8).  Returns the launch's cudaError_t
// (0 on success); cudaErrorInvalidValue for sizes or layouts the kernel
// does not take.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    float* lse, long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long o_sb, long long o_ss, long long o_sh, int B,
                    int Sq, int Skv, int H, int Hkv, int D, int Dv,
                    int causal, int window, float scale, int dtype,
                    void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0 ||
      !((D == Dv && D >= 8 && D % 8 == 0 && D <= kMaxD) ||
        (D == kSplitD && Dv == kSplitDv)) ||
      window < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out; p.lse = lse;
  const long long strides[4][3] = {{q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
                                   {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh}};
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[0][i];
    p.ks[i] = strides[1][i];
    p.vs[i] = strides[2][i];
    p.os[i] = strides[3][i];
  }
  if (dtype == 1) {                        // cp.async and 4-byte stores
    bool ok = D % 16 == 0 && Dv % 16 == 0 && (uintptr_t)q % 16 == 0 &&
              (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0 &&
              (uintptr_t)out % 16 == 0;
    for (int t = 0; t < 4; ++t)
      for (int i = 0; i < 3; ++i) ok = ok && strides[t][i] % 8 == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  p.Sq = Sq; p.Skv = Skv; p.H = H; p.Hkv = Hkv; p.D = D; p.Dv = Dv;
  p.g = H / Hkv;
  // a group wider than kMaxG is cut into slices of gs heads, gs the
  // largest divisor of g up to kMaxG (48 -> 8, 12 -> 6): one CTA a slice
  for (p.gs = p.g < kMaxG ? p.g : kMaxG; p.g % p.gs; --p.gs) {
  }
  p.ns = p.g / p.gs;
  p.bq = kRows / p.gs;
  p.causal = causal != 0;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return dispatch_bf16(p, B, st);
  // TM = 2 keeps all 256 threads busy at Dv <= 64
  return Dv <= 64 ? launch_f32<2>(p, B, st) : launch_f32<4>(p, B, st);
}

}  // extern "C"
