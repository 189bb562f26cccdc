// Split-KV decode attention shared by the paged and the contiguous decode
// kernels (paged_decode_attention.cu, decode_attention.cu): one query
// token per sequence, the g = H/Hkv query heads of one KV head computed
// together, in one launch whose splits merge inside a thread block
// cluster.
//
// The two kernels differ only in where position t of a sequence lives:
// through a block table in a paged pool, or at row t of a contiguous
// (B, S, Hkv, D) cache.  Each kernel finds its CTA's positions and hands
// attend_cluster() a function from a CTA-local position to the element
// offset of that position's K/V row for the KV head; everything after
// that is here.
//
// What bounds decode: the bytes of K and V in principle, latency in
// practice.  Each (sequence, KV head) reads kv_len * D elements of K and
// as many of V once and does 4 * g * D operations per position: at
// g <= 8 that is ~1-4 operations per byte in bf16, far below the ~20 the
// CUDA cores need before compute binds (at g = 48 compute does bind).  A
// whole smollm call reads 7.5 MB, 2.25 us at 3.35 TB/s; what costs more
// is a second launch and a chain of dependent round trips to device
// memory and to the other CTAs.  What each part of the design does about
// it:
//   * One launch.  The C CTAs of one (sequence, KV head) form a cluster
//     along grid x; each takes a contiguous range of the positions (whole
//     pages for the paged kernel) and leaves its (m, l, g x D sum) in its
//     own shared memory.  After cluster.sync() each CTA merges a slice of
//     the g x D outputs, reading the C partials together and combining
//     them in rank order through distributed shared memory (the same bits
//     every launch: no atomics), and writes out; a second cluster.sync()
//     keeps every CTA alive while it is read.  No workspace round trip,
//     no merge kernel.
//   * Every byte in flight at once.  q's loads go first, then kv_len
//     (and the paged kernel's block-table row) in one round trip; then
//     a CTA's first tiles of K rows and V rows go to shared memory by
//     16-byte cp.async, K and V in separate commit groups, and the
//     scores run while V lands.  A CTA whose range is longer loops over
//     its tiles with up to four in flight, each stage reissued as soon as
//     its tile's math is done, so any length is taken with no split count
//     sized from S or max_pages.
//   * Little math between the barriers.  A lane group owns a K/V row's
//     16-byte columns, keeps q, its running maxima and sums and its
//     P @ V columns in registers, and runs its own online softmax (base
//     2) over its slot of the positions: no scores in shared memory and
//     no CTA-wide softmax per tile.  The groups' partials merge inside
//     the CTA, then across the cluster.
//   * Any group.  The heads go in register chunks of 1-4 or 8 (a template
//     argument, so no predicated lanes), a chunk per lane group, so a
//     group above 8 costs no extra bytes from device memory; g is bounded
//     by registers (64 heads at D = 128).
//   * C and the tile from the shapes: C so that about two CTAs an SM have
//     work (16, past the portable 8, when few pairs would leave the card
//     idle), the tile and stages so that every CTA can be resident at
//     once, and C halved if the card cannot place such a cluster.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace split_decode {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kChunk = 8;                 // query heads per register chunk
constexpr float kNegInf = -1e30f;
constexpr int kMaxCluster = 16;           // 8 is portable; 16 needs opt-in
constexpr int kCtasPerSmTarget = 2;       // clusters sized to fill the card
constexpr int kMaxStages = 4;             // tiles in flight (4 or 2)
constexpr size_t kSmemPerSm = 228 * 1024;
constexpr size_t kSmemReserved = 1024;    // per CTA, by the driver
constexpr size_t kSmemMax = 226 * 1024;   // one CTA, statics beside

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

// 16-byte vectors: 8 bf16 or 4 f32 values per load (global or shared),
// or unpacked from 16 bytes already loaded.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4 r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  // a bf16 widened to f32 is its bits shifted up 16; the lower address
  // holds the lower half of each word
  __device__ __forceinline__ static void unpack(const uint4 r, float* out) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
};

inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// How a launch is cut.  A CTA's threads form lane groups of W lanes
// (a power of two), each lane holding one 16-byte column of a K/V row
// (lanes past the row idle); a group owns the query heads of up to cpg
// chunks of gc heads and a slot of positions (t = slot mod ns), and
// runs its own online softmax over them with q, the maxima, the sums
// and its P @ V columns in registers.  Dynamic shared memory, in bytes
// from its start:
//   0      `stages` stages of (K tile, V tile), rows padded by 16 bytes
//          so that neighbouring groups' row reads do not share banks;
//          after the loop the same bytes hold the groups' partials
//          ((ns, g, D) sums, then (ns, g) maxima and sums) and, at cta,
//          the CTA's ((g, D) sums, g maxima, g sums: the partial the
//          cluster merge reads)
//   pg     the sequence's block-table row (paged only)
//   flag   1 if the CTA's pages leave the pool
struct Plan {
  int C;            // CTAs a cluster (one (sequence, KV head))
  int tile;         // positions a tile
  int rs;           // elements between staged rows
  int W, gpw;       // lanes a group, groups a warp
  int gc, cpg;      // heads a chunk, chunks a group
  int n_hc, hs, ns; // head chunks, head-chunk sets, position slots
  int stages;       // tiles in flight
  size_t cta, pg, flag, total;
};

// The head cut for g query heads at D in elem-byte values: chunk size
// (the kernel's template argument: 1, 2, 3, 4 or 8), chunks a group.
// cpg 0: not taken (more than two chunks a group in f32, one in bf16,
// would not fit the registers).
inline void head_cut(int g, int D, int elem, int* gc,
                                         int* cpg, int* hs, int* ns,
                                         int* W) {
  const int vec = 16 / elem;
  *W = next_pow2(D / vec);
  const int groups = kWarps * (32 / *W);
  *gc = g <= 4 ? g : kChunk;
  const int n_hc = (g + *gc - 1) / *gc;
  *hs = n_hc == 1 ? 1 : (next_pow2(n_hc) < groups ? next_pow2(n_hc)
                                                   : groups);
  *ns = groups / *hs;
  *cpg = (n_hc + *hs - 1) / *hs;
  if (*cpg > (elem == 4 ? 2 : 1)) *cpg = 0;
}

inline Plan layout(int g, int D, int elem, int C, int tile, int stages,
                   int pages) {
  Plan L;
  const int vec = 16 / elem;
  L.C = C;
  L.tile = tile;
  L.stages = stages;
  L.rs = D + vec;
  head_cut(g, D, elem, &L.gc, &L.cpg, &L.hs, &L.ns, &L.W);
  L.gpw = 32 / L.W;
  L.n_hc = (g + L.gc - 1) / L.gc;
  const size_t kv = (size_t)stages * 2 * tile * L.rs * elem;
  const size_t part = (size_t)L.ns * g * (D + 2) * 4;
  const size_t cta = (size_t)g * (D + 2) * 4;
  L.cta = part;
  size_t off = kv > part + cta ? kv : part + cta;
  L.pg = off;   off += (size_t)pages * 4;
  L.flag = off; off += 4;
  L.total = (off + 15) / 16 * 16;
  return L;
}

// Waits for tile i's K (v false) or V (v true) copies, with `stages`
// tiles issued ahead as two commit groups each: the groups committed
// after the awaited one may stay in flight.
__device__ __forceinline__ void wait_tile(int stages, bool v) {
  switch (stages * 2 - (v ? 2 : 1)) {
    case 3: mma::cp_async_wait<3>(); break;
    case 2: mma::cp_async_wait<2>(); break;
    case 7: mma::cp_async_wait<7>(); break;
    case 6: mma::cp_async_wait<6>(); break;
    default: mma::cp_async_wait<0>(); break;
  }
}

// A thread's place in its CTA under plan L (its lane group, 16-byte
// column, position slot and head-chunk set), and its columns of its
// heads' q as loaded.  The kernels build it first, so q's loads are in
// flight while they read kv_len and the block table.
template <typename T, int GC, int CPG>
struct Lanes {
  static constexpr int V = Vec<T>::n;
  int col, grp, slot, hs;
  bool col_ok;
  uint4 q_raw[CPG][GC];                      // 16 bytes: V values
  __device__ __forceinline__ Lanes(const Plan& L, const T* __restrict__ q_row,
                                   int g, int D) {
    const int lane = threadIdx.x % 32;
    col = (lane % L.W) * V;
    col_ok = col < D;
    grp = (threadIdx.x / 32) * L.gpw + lane / L.W;
    slot = grp / L.hs;
    hs = grp - slot * L.hs;
#pragma unroll
    for (int c = 0; c < CPG; ++c)
#pragma unroll
      for (int h = 0; h < GC; ++h)
        q_raw[c][h] = owns(L, g, c, h) && col_ok
            ? *reinterpret_cast<const uint4*>(q_row + head(L, c, h) * D + col)
            : make_uint4(0, 0, 0, 0);
  }
  // the query head of chunk c, position h in it, and whether this thread
  // owns it
  __device__ __forceinline__ int head(const Plan& L, int c, int h) const {
    return (hs + c * L.hs) * GC + h;
  }
  __device__ __forceinline__ bool owns(const Plan& L, int g, int c,
                                       int h) const {
    return hs + c * L.hs < L.n_hc && head(L, c, h) < g;
  }
};

// Runs one CTA's range of n positions (n may be 0) for the g query heads
// whose q `me` holds, then the cluster merge, which writes this
// cluster's g*D outputs at out_row and, where lse_row is not null, the
// g heads' log-sum-exp of the scaled scores (natural log, fp32; NEG_INF
// for a sequence with no valid position, whose outputs are 0).  row(u)
// is the element offset, in k and in v, of CTA-local position u's D
// values for this KV head.  bad: the CTA's positions must not be read
// (a page outside the pool); the cluster's outputs become NaN.  Every
// thread of every CTA of the cluster calls it.  Softmax runs in base 2:
// q is scaled by scale * log2(e), so the maxima are in log2 units and
// ex2 takes the place of exp.
template <typename T, int GC, int CPG, typename RowFn>
__device__ __forceinline__ void attend_cluster(
    const Lanes<T, GC, CPG>& me, const T* __restrict__ k,
    const T* __restrict__ v, RowFn row, int n, bool bad, int g, int D,
    float scale, const Plan& L, unsigned char* smem, T* __restrict__ out_row,
    float* __restrict__ lse_row) {
  constexpr int V = Vec<T>::n;
  constexpr int PB = GC * CPG > 4 ? 2 : 4;   // positions a batch
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int W = L.W;
  const int col = me.col, slot = me.slot;
  const bool col_ok = me.col_ok;
  const int ns = L.ns;
  const int tile = L.tile, rs = L.rs;
  const int n_tiles = bad ? 0 : (n + tile - 1) / tile;
  T* kv_s = reinterpret_cast<T*>(smem);
  int* flag_s = reinterpret_cast<int*>(smem + L.flag);

  // tile i's K rows, then its V rows, into stage i % stages: two commit
  // groups (empty past the last tile, so the waits below count the same
  // always).  A lane group copies a row, each lane its 16 bytes.
  const int stages = L.stages;
  const int groups = kWarps * L.gpw;
  const size_t stage_elems = (size_t)2 * tile * rs;
  auto issue = [&](int i) {
    if (i < n_tiles) {
      T* ks = kv_s + (size_t)(i % stages) * stage_elems;
      T* vs = ks + (size_t)tile * rs;
      const int t0 = i * tile;
      const int cnt = min(tile, n - t0);
      if (col_ok)
        for (int t = me.grp; t < cnt; t += groups)
          mma::cp_async16(ks + t * rs + col, k + row(t0 + t) + col, true);
      mma::cp_async_commit();
      if (col_ok)
        for (int t = me.grp; t < cnt; t += groups)
          mma::cp_async16(vs + t * rs + col, v + row(t0 + t) + col, true);
      mma::cp_async_commit();
    } else {
      mma::cp_async_commit();
      mma::cp_async_commit();
    }
  };
  for (int i = 0; i < stages; ++i) issue(i);

  // this lane's columns of its heads' q, scaled (the loads were issued
  // first); its group's running maxima and sums, and its columns of P @ V
  const float qscale = scale * 1.4426950408889634f;   // log2(e)
  float q[CPG][GC][V], acc[CPG][GC][V], m[CPG][GC], l[CPG][GC];
#pragma unroll
  for (int c = 0; c < CPG; ++c)
#pragma unroll
    for (int h = 0; h < GC; ++h) {
      Vec<T>::unpack(me.q_raw[c][h], q[c][h]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        q[c][h][j] *= qscale;
        acc[c][h][j] = 0.f;
      }
      m[c][h] = kNegInf;
      l[c][h] = 0.f;
    }
  if (tid == 0) *flag_s = bad ? 1 : 0;

  for (int i = 0; i < n_tiles; ++i) {
    const T* ks = kv_s + (size_t)(i % stages) * stage_elems;
    const T* vs = ks + (size_t)tile * rs;
    const int cnt = min(tile, n - i * tile);
    float s[PB][CPG][GC];
    // the scores of positions t = t0 + slot + pb * ns: each lane's
    // columns, summed over the group's lanes (xor shuffles stay inside
    // the W-lane group)
    auto scores = [&](int t0) {
#pragma unroll
      for (int pb = 0; pb < PB; ++pb) {
        const int t = t0 + slot + pb * ns;
        float kf[V];
        if (col_ok && t < cnt) {
          Vec<T>::load(ks + t * rs + col, kf);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) kf[j] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < CPG; ++c)
#pragma unroll
          for (int h = 0; h < GC; ++h) {
            float d = 0.f;
#pragma unroll
            for (int j = 0; j < V; ++j) d = fmaf(q[c][h][j], kf[j], d);
            s[pb][c][h] = d;
          }
      }
      // step by step over the whole batch, so the shuffles overlap
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        if (off < W) {
#pragma unroll
          for (int pb = 0; pb < PB; ++pb)
#pragma unroll
            for (int c = 0; c < CPG; ++c)
#pragma unroll
              for (int h = 0; h < GC; ++h)
                s[pb][c][h] += __shfl_xor_sync(0xffffffffu, s[pb][c][h], off);
        }
      }
#pragma unroll
      for (int pb = 0; pb < PB; ++pb)
        if (t0 + slot + pb * ns >= cnt) {
#pragma unroll
          for (int c = 0; c < CPG; ++c)
#pragma unroll
            for (int h = 0; h < GC; ++h) s[pb][c][h] = kNegInf;
        }
    };
    // the online softmax step over those positions, then their V rows
    auto update = [&](int t0) {
      float p[PB][CPG][GC];
#pragma unroll
      for (int c = 0; c < CPG; ++c)
#pragma unroll
        for (int h = 0; h < GC; ++h) {
          float mx = m[c][h];
#pragma unroll
          for (int pb = 0; pb < PB; ++pb) mx = fmaxf(mx, s[pb][c][h]);
          const float corr = mma::ex2(m[c][h] - mx);
          float sum = 0.f;
#pragma unroll
          for (int pb = 0; pb < PB; ++pb) {
            const bool ok = t0 + slot + pb * ns < cnt;
            p[pb][c][h] = ok ? mma::ex2(s[pb][c][h] - mx) : 0.f;
            sum += p[pb][c][h];
          }
          l[c][h] = l[c][h] * corr + sum;
          m[c][h] = mx;
#pragma unroll
          for (int j = 0; j < V; ++j) acc[c][h][j] *= corr;
        }
#pragma unroll
      for (int pb = 0; pb < PB; ++pb) {
        const int t = t0 + slot + pb * ns;
        if (col_ok && t < cnt) {
          float vf[V];
          Vec<T>::load(vs + t * rs + col, vf);
#pragma unroll
          for (int c = 0; c < CPG; ++c)
#pragma unroll
            for (int h = 0; h < GC; ++h)
#pragma unroll
              for (int j = 0; j < V; ++j) acc[c][h][j] += p[pb][c][h] * vf[j];
        }
      }
    };
    wait_tile(stages, false);                // this tile's K has landed
    __syncthreads();
    scores(0);                               // while V lands
    wait_tile(stages, true);                 // this tile's V has landed
    __syncthreads();
    update(0);
    for (int t0 = PB * ns; t0 < cnt; t0 += PB * ns) {
      scores(t0);
      update(t0);
    }
    __syncthreads();                         // stage i % stages is free
    issue(i + stages);
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // the groups' partials (over the staged tiles' bytes), then the CTA's:
  // each head's maximum over the slots, the slots' weights and sums, in
  // slot order
  float* part = reinterpret_cast<float*>(smem);            // (ns, g, D)
  float* part_m = part + (size_t)ns * g * D;               // (ns, g)
  float* part_l = part_m + (size_t)ns * g;                 // (ns, g)
  float* acc_s = reinterpret_cast<float*>(smem + L.cta);   // (g, D)
  float* m_s = acc_s + (size_t)g * D;                      // g
  float* l_s = m_s + g;                                    // g
#pragma unroll
  for (int c = 0; c < CPG; ++c)
#pragma unroll
    for (int h = 0; h < GC; ++h) {
      if (me.owns(L, g, c, h)) {
        const int gi = me.head(L, c, h);
        if (col_ok) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            part[((size_t)slot * g + gi) * D + col + j] = acc[c][h][j];
        }
        if (lane % W == 0) {
          part_m[slot * g + gi] = m[c][h];
          part_l[slot * g + gi] = l[c][h];
        }
      }
    }
  __syncthreads();
  for (int gi = tid / 32; gi < g; gi += kWarps) {   // a warp per head
    float M = kNegInf;
    for (int sl = lane; sl < ns; sl += 32) M = fmaxf(M, part_m[sl * g + gi]);
    M = warp_max(M);
    float sum = 0.f;
    for (int sl = lane; sl < ns; sl += 32) {
      const float w = mma::ex2(part_m[sl * g + gi] - M);
      part_m[sl * g + gi] = w;                // now the slot's weight
      sum += w * part_l[sl * g + gi];
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[gi] = M;
      l_s[gi] = sum;
    }
  }
  __syncthreads();
  for (int e = tid; e < g * D; e += kThreads) {
    const int gi = e / D;
    float o = 0.f;
    for (int sl = 0; sl < ns; ++sl)
      o += part_m[sl * g + gi] * part[(size_t)sl * g * D + e];
    acc_s[e] = o;
  }

  // the cluster merge: CTA `rank` combines elements [e0, e1) of the g*D
  // outputs over the C partials, in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int C = L.C;
  const int rank = (int)cluster.block_rank();
  const int per = (g * D + C - 1) / C;
  const int e0 = min(rank * per, g * D), e1 = min(e0 + per, g * D);
  for (int e = e0 + tid; e < e1; e += kThreads) {
    // every rank's partial sum, maximum and sum for this element, loaded
    // together (one round trip), then combined in rank order
    const int gi = e / D;
    float pa[kMaxCluster], pm[kMaxCluster], pl[kMaxCluster];
    int any_bad = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) {
        const float* remote = cluster.map_shared_rank(acc_s, r);
        pa[r] = remote[e];
        pm[r] = remote[g * D + gi];          // m_s follows acc_s
        pl[r] = remote[g * D + g + gi];      // and l_s follows m_s
        any_bad |= *cluster.map_shared_rank(flag_s, r);
      }
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) M = fmaxf(M, pm[r]);
    float o = 0.f, sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) {
        const float w = mma::ex2(pm[r] - M);
        o += w * pa[r];
        sum += w * pl[r];
      }
    out_row[e] = from_f32<T>(any_bad ? __int_as_float(0x7fc00000)
                                     : o / fmaxf(sum, 1e-30f));
    if (lse_row != nullptr && e % D == 0)   // one element a head writes it
      lse_row[gi] = any_bad ? __int_as_float(0x7fc00000)
                    : sum > 0.f ? (M + log2f(sum)) * 0.6931471805599453f
                                : kNegInf;
  }
  cluster.sync();                            // no CTA leaves while read
}

// Whether the kernels take these head sizes (g is bounded by make_plan).
inline bool heads_ok(int B, int H, int Hkv, int D) {
  return B >= 1 && Hkv >= 1 && H % Hkv == 0 && D >= 8 && D % 8 == 0 &&
         D <= kMaxD;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// The launch's cut: C from the number of (sequence, KV head) pairs, so
// that about kCtasPerSmTarget CTAs an SM have work (at most max_C: 8 is
// portable, 16 is taken when even 8 leave most SMs idle, as granite's
// one KV head does).  Then the stages and the tile: four stages, or else
// two, of the largest tile (128, 64, 32 or 16 positions, and at least a
// batch for every position slot) whose shared memory lets every CTA be
// resident at once, at least two an SM; else two stages of the smallest
// tile, one CTA an SM.  pages: the block-table width for the paged
// kernel, 0 for the contiguous one.  Returns false for sizes that do not
// fit.
inline bool make_plan(Plan* out, int B, int Hkv, int g, int D, int elem,
                      int pages, int max_C) {
  const long pairs = (long)B * Hkv;
  const long sms = sm_count();
  int C = 1;
  while (C < 8 && C < max_C && pairs * C < kCtasPerSmTarget * sms) C *= 2;
  if (C == 8 && max_C >= kMaxCluster && pairs * 8 <= sms) C = kMaxCluster;
  long per_sm = (pairs * C + sms - 1) / sms;
  if (per_sm < 2) per_sm = 2;
  const size_t budget = kSmemPerSm / per_sm - kSmemReserved;
  int gc, cpg, hs, ns, W;
  head_cut(g, D, elem, &gc, &cpg, &hs, &ns, &W);
  if (cpg == 0) return false;
  const int batch = (gc * cpg > 4 ? 2 : 4) * ns;   // attend_cluster's PB
  const int min_tile = batch < 16 ? 16 : (batch > 128 ? 128 : batch);
  for (int stages = kMaxStages; stages >= 2; stages /= 2)
    for (int tile = 128; tile >= min_tile; tile /= 2) {
      const Plan L = layout(g, D, elem, C, tile, stages, pages);
      if (L.total <= budget) {
        *out = L;
        return true;
      }
    }
  const Plan L = layout(g, D, elem, C, 16, 2, pages);
  if (L.total > kSmemMax) return false;
  *out = L;
  return true;
}

// A launch configuration on grid (C, Hkv, B) with clusters of C CTAs
// along x (not copyable: cfg points at attr).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(const Plan& L, int Hkv, int B, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = L.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(L.C, Hkv, B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = L.total;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// Asks whether one of plan L's clusters can be placed
// (cudaOccupancyMaxActiveClusters > 0), first allowing the kernel the
// most dynamic shared memory and a non-portable cluster size (each
// launch still asks for its own bytes).  Remembers the answer per
// (kernel, C, bytes), so a decode step pays the queries once.
template <typename Kernel>
cudaError_t placeable(Kernel kernel, const Plan& L, bool* ok) {
  struct Seen { const void* fn; int C; size_t smem; bool ok; };
  static Seen seen[64];
  static int n_seen = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == fn && seen[i].C == L.C && seen[i].smem == L.total) {
      *ok = seen[i].ok;
      return cudaSuccess;
    }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int clusters = 0;
  if (err == cudaSuccess) {
    const ClusterLaunch cl(L, 1, 1, 0);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cl.cfg);
  }
  if (err != cudaSuccess) return err;
  *ok = clusters > 0;
  if (n_seen < 64) seen[n_seen++] = {fn, L.C, L.total, *ok};
  return cudaSuccess;
}

// The plan a launch of kernel uses: make_plan's, with C halved while the
// card cannot place such a cluster.  cudaErrorInvalidValue for sizes no
// tile fits or no cluster can be placed.
template <typename Kernel>
cudaError_t choose_plan(Kernel kernel, Plan* L, int B, int Hkv, int g,
                        int D, int elem, int pages) {
  for (int max_C = kMaxCluster; max_C >= 1; max_C = L->C / 2) {
    if (!make_plan(L, B, Hkv, g, D, elem, pages, max_C))
      return cudaErrorInvalidValue;
    bool ok = false;
    const cudaError_t err = placeable(kernel, *L, &ok);
    if (err != cudaSuccess || ok) return err;
    if (L->C == 1) break;
  }
  return cudaErrorInvalidValue;
}

// One launch of kernel on grid (C, Hkv, B) under plan L (choose_plan's)
// on the stream; its cudaError_t.
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), const Plan& L, int Hkv, int B,
           cudaStream_t st, Args... args) {
  const ClusterLaunch cl(L, Hkv, B, st);
  cudaError_t err = cudaLaunchKernelEx(&cl.cfg, kernel, args...);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // namespace split_decode
