// Confidence gate for Hopper (sm_90a): one pass over (B, V) logits
// emitting max_prob, entropy, margin and the first-index argmax.
//
// Replaces: the Pallas TPU kernel repro/kernels/conf_gate.py
// (confidence_gate_kernel), the fused metric pass behind the gate that
// decides every escalation (repro/core/gating.py::ConfidenceGate.decide,
// called at repro/serving/scheduler.py for each finished sequence; the EO
// cascade's onboard tier at 8 classes).
//
// What bounds it: the bytes of the logits, read once (B * V * itemsize);
// the work is a few operations per element and there is no reuse, so it
// is a bandwidth-bound row reduction.  At the paths' shapes (a few
// hundred 8-class rows; one 49152-wide row) the bytes take well under a
// microsecond, so what the design goes after is latency: no idle lanes,
// every load of a batch in flight at once, short dependent chains, and a
// wide row spread over SMs.
//
// A thread keeps a state (max1, max2, argmax, l = sum exp(x - max1),
// sx = sum (x - max1) exp(x - max1)) over its part of a row.  It issues a
// batch's 16-byte loads (K of them) before using any, takes the batch's
// top two and first argmax without a branch, moves its sums once to the
// new max1, then adds one exp per element.  A row's head and tail that do
// not fill a 16-byte vector (an odd V, a pointer off 16 bytes) are read as
// single elements, so any V and any element-aligned pointer are taken.
// A group of lanes reduces its states in two butterflies of shuffles: the
// top two and argmax first, then each lane moves its sums to the group's
// max1 (one exp) and the sums are added.  Taking sx relative to max1 keeps
// the entropy free of cancellation when the logits are large:
//     max_prob = 1 / l (as exp(-log l));  entropy = log l - sx / l
//     margin = exp(max2 - max1 - log l) below max_prob
// Ties keep the FIRST index: two equal maxima keep the smaller index,
// within a batch the first of equal values is kept, so a tie split across
// lanes, groups or cluster ranks resolves as jnp.argmax / torch.argmax
// do.  max2 counts multiplicity (two equal maxima give margin 0), as top-2
// does.  An element whose exp underflows adds no entropy term (the Pallas
// kernel drops its -1e30 padding so).  The order of every sum is fixed by
// the layout and nothing uses atomics, so every launch repeats the first
// one's bits.
//
// The layout is chosen on the host from V's 16-byte vectors, B and the SM
// count (confidence_gate_plan reports it); one launch either way:
//   narrow   a row of at most 512 bytes, or of at most 2 KB when there
//            are more rows than two an SM, gets a group of G lanes (G a
//            power of two: one 16-byte vector a lane up to 512 bytes, at
//            most four at 2 KB; K the vectors a lane takes, a template
//            argument), many rows a warp, 256 threads a CTA.  (4096, 8)
//            fp32 is 32 CTAs of 128 rows (G = 2); bf16 G = 1.
//   rows     any other row with enough rows to fill the card: one CTA a
//            row, 64-512 threads from V (four vectors a thread a batch),
//            the warps' states merged once more through shared memory.
//   cluster  a wide row with too few rows (B * C <= the SM count, each
//            rank at least 4 KB): the row is split over a thread block
//            cluster of C CTAs (up to 16, non-portable above 8), each
//            reducing a contiguous slice.  Each rank pushes its state into
//            a slot of rank 0's shared memory (distributed shared memory)
//            and arrives on the cluster barrier; only rank 0 waits, then
//            reduces the slots in rank order, one lane a rank.  No second
//            kernel, no atomics, no workspace.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "vec16.cuh"

namespace cg = cooperative_groups;
using vec16::Vec;

namespace {

constexpr float kNegInf = -1e30f;          // the empty state's maxima
constexpr int kNarrowMaxBytes = 2048;      // a row this short: a lane group
constexpr int kOneVecBytes = 32 * 16;      // ... one vector a lane, any B
constexpr int kNarrowThreads = 256;
constexpr int kMinThreads = 64;            // a CTA of the rows / cluster cut
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMinSliceBytes = 4096;       // a cluster rank's least slice

enum Layout { kNarrow = 0, kRows = 1, kCluster = 2 };

struct State {
  float m1, m2, l, sx;
  int am;
};

__device__ __forceinline__ State empty_state() {
  return State{kNegInf, kNegInf, 0.f, 0.f, INT_MAX};
}

// The top two values of a set (max2 counting multiplicity) and the first
// index of its maximum
struct Top2 {
  float m1, m2;
  int am;
};

// Top2 of the union of two disjoint sets: on equal maxima the smaller
// index wins, so the order of a and b does not matter
__device__ __forceinline__ Top2 top2(const Top2& a, const Top2& b) {
  const bool a_wins = a.m1 > b.m1 || (a.m1 == b.m1 && a.am < b.am);
  return Top2{fmaxf(a.m1, b.m1), fmaxf(fmaxf(a.m2, b.m2), fminf(a.m1, b.m1)),
              a_wins ? a.am : b.am};
}

// Moves l and sx, taken relative to max1 m, to a max1 m_new >= m (sx is
// relative to max1, so it gains (m - m_new) * l)
__device__ __forceinline__ void rescale(float& l, float& sx, float m,
                                        float m_new) {
  const float d = m - m_new, c = expf(d);
  sx = (sx + d * l) * c;
  l *= c;
}

// Reduces each aligned group of G lanes (G a power of two up to 32; every
// lane of the warp calls it) to the group's state, in every lane of the
// group: the top two and argmax by a butterfly of shuffles, then each lane
// moves its sums to the group's max1 (one exp) and a butterfly adds them.
// Every lane ends with the same bits (a + b and b + a are equal), and the
// order of the sums is fixed by G.
template <int G>
__device__ __forceinline__ State group_reduce(State s) {
  Top2 t{s.m1, s.m2, s.am};
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const Top2 o{__shfl_xor_sync(0xffffffffu, t.m1, off, G),
                 __shfl_xor_sync(0xffffffffu, t.m2, off, G),
                 __shfl_xor_sync(0xffffffffu, t.am, off, G)};
    t = top2(t, o);
  }
  rescale(s.l, s.sx, s.m1, t.m1);
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    s.l += __shfl_xor_sync(0xffffffffu, s.l, off, G);
    s.sx += __shfl_xor_sync(0xffffffffu, s.sx, off, G);
  }
  return State{t.m1, t.m2, s.l, s.sx, t.am};
}

// group_reduce at a width known only at run time (uniform in the warp)
__device__ __forceinline__ State group_reduce(State s, int G) {
  switch (G) {
    case 1: return s;
    case 2: return group_reduce<2>(s);
    case 4: return group_reduce<4>(s);
    case 8: return group_reduce<8>(s);
    case 16: return group_reduce<16>(s);
    default: return group_reduce<32>(s);
  }
}

// Folds a batch of N values (row indices increasing with i; ok[i] false
// for a slot past the slice) into st: the batch's top two and first
// argmax, one rescale of the sums to the new max1, one exp a value.
template <int N>
__device__ __forceinline__ void fold(State& st, const float (&x)[N],
                                     const int (&idx)[N],
                                     const bool (&ok)[N]) {
  Top2 b{kNegInf, kNegInf, INT_MAX};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float v = ok[i] ? x[i] : kNegInf;
    b.m2 = fmaxf(b.m2, fminf(b.m1, v));
    b.am = ok[i] && (v > b.m1 || b.am == INT_MAX) ? idx[i] : b.am;
    b.m1 = fmaxf(b.m1, v);
  }
  const Top2 n = top2(Top2{st.m1, st.m2, st.am}, b);
  rescale(st.l, st.sx, st.m1, n.m1);
  float l = st.l, sx = st.sx;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float d = x[i] - n.m1;
    const float e = ok[i] ? expf(d) : 0.f;
    l += e;
    sx += e > 0.f ? d * e : 0.f;
  }
  st = State{n.m1, n.m2, l, sx, n.am};
}

// The state of elements [lo, hi) of row, read by P threads of which this
// is `rank`: the 16-byte-aligned middle as vectors, kK of them a thread
// in flight (vector j to thread j % P), and the head and tail before and
// after it (fewer than a vector each) as single elements.
template <typename T, int kK>
__device__ __forceinline__ State reduce_slice(const T* __restrict__ row,
                                              int lo, int hi, int rank,
                                              int P) {
  constexpr int W = Vec<T>::kN;
  State st = empty_state();
  const int mis = (int)(((uintptr_t)(row + lo) / sizeof(T)) % W);
  const int a0 = min(lo + (W - mis) % W, hi);
  const int nvec = (hi - a0) / W;
  const int a1 = a0 + nvec * W;
  const int n_head = a0 - lo, n_edge = n_head + (hi - a1);
  if (rank < n_edge) {
    constexpr int kE = 2 * (W - 1);
    float x[kE];
    int idx[kE];
    bool ok[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int j = rank + e * P;
      ok[e] = j < n_edge;
      idx[e] = j < n_head ? lo + j : a1 + (j - n_head);
      x[e] = ok[e] ? vec16::to_f32(row[idx[e]]) : kNegInf;
    }
    fold(st, x, idx, ok);
  }
  const T* mid = row + a0;
  for (int base = rank; base < nvec; base += kK * P) {
    uint4 raw[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {            // every load before any use
      const int j = base + k * P;
      raw[k] = j < nvec ? vec16::load16(mid + (size_t)j * W)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
    float x[kK * W];
    int idx[kK * W];
    bool ok[kK * W];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int j = base + k * P;
      Vec<T>::unpack(raw[k], x + k * W);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        ok[k * W + w] = j < nvec;
        idx[k * W + w] = a0 + j * W + w;
      }
    }
    fold(st, x, idx, ok);
  }
  return st;
}

// The CTA's merged state, in thread 0 (blockDim.x a power of two >= 64):
// warps by shuffles, then warp 0 over the warps' states in warp order.
__device__ __forceinline__ State block_merge(State st, State* red) {
  st = group_reduce<32>(st);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) red[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = lane < n_warps ? red[lane] : empty_state();
    st = group_reduce(st, n_warps);
  }
  return st;
}

// The cluster barrier in two halves (every thread of every CTA arrives
// once a phase; a CTA may leave after its last arrive)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void emit(const State& st, int b,
                                     float* __restrict__ max_prob,
                                     float* __restrict__ entropy,
                                     float* __restrict__ margin,
                                     int32_t* __restrict__ argmax) {
  const float l = fmaxf(st.l, 1e-30f);
  const float log_l = logf(l);
  const float mp = expf(-log_l);
  max_prob[b] = mp;
  entropy[b] = log_l - st.sx / l;
  margin[b] = mp - expf(st.m2 - st.m1 - log_l);
  argmax[b] = st.am;
}

// 16-byte vectors a thread has in flight in the rows and cluster cuts
// (make_plan's K; a CTA is sized so that one batch holds a thread's share
// of its slice where 512 threads can)
constexpr int kWideVecs = 4;

// kK: vectors a lane has in flight (1, 2 or 4: a lane's share of the row)
template <typename T, int kK>
__global__ void __launch_bounds__(kNarrowThreads)
gate_narrow(const T* __restrict__ logits, float* __restrict__ max_prob,
            float* __restrict__ entropy, float* __restrict__ margin,
            int32_t* __restrict__ argmax, int B, int V, int log2_G) {
  const int G = 1 << log2_G;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = t >> log2_G, rank = t & (G - 1);
  // a group past B still takes part in its warp's shuffles
  State st = b < B ? reduce_slice<T, kK>(logits + (size_t)b * V, 0, V, rank,
                                         G)
                   : empty_state();
  st = group_reduce(st, G);
  if (b < B && rank == 0) emit(st, b, max_prob, entropy, margin, argmax);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gate_rows(const T* __restrict__ logits, float* __restrict__ max_prob,
          float* __restrict__ entropy, float* __restrict__ margin,
          int32_t* __restrict__ argmax, int V) {
  __shared__ State red[32];
  const int b = blockIdx.x;
  State st = reduce_slice<T, kWideVecs>(logits + (size_t)b * V, 0, V,
                                        threadIdx.x, blockDim.x);
  st = block_merge(st, red);
  if (threadIdx.x == 0) emit(st, b, max_prob, entropy, margin, argmax);
}

// grid (C, B), clusters of C CTAs along x: rank r reduces elements
// [r * slice, (r + 1) * slice) of row blockIdx.y and pushes its state into
// slot r of rank 0's shared memory; only rank 0 waits for the others.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gate_cluster(const T* __restrict__ logits, float* __restrict__ max_prob,
             float* __restrict__ entropy, float* __restrict__ margin,
             int32_t* __restrict__ argmax, int V, int slice) {
  __shared__ State red[32];
  __shared__ State ranks[kMaxCluster];        // rank 0's: every rank's state
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int lo = min(rank * slice, V), hi = min(lo + slice, V);
  cluster_arrive_relaxed();                   // phase 1: this CTA runs
  State st = reduce_slice<T, kWideVecs>(logits + (size_t)b * V, lo, hi,
                                        threadIdx.x, blockDim.x);
  st = block_merge(st, red);
  cluster_wait_acquire();                     // every CTA runs: rank 0's
  if (threadIdx.x == 0)                       // shared memory is there
    *cluster.map_shared_rank(&ranks[rank], 0) = st;
  cluster_arrive_release();                   // phase 2: my state is in
  if (rank != 0) return;
  cluster_wait_acquire();                     // every rank's state is in
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    st = lane < C ? ranks[lane] : empty_state();
    st = group_reduce(st, C);                 // in rank order
    if (lane == 0) emit(st, b, max_prob, entropy, margin, argmax);
  }
}

// ---------------------------------------------------------------- host

struct Plan {
  int layout;     // Layout
  int G;          // lanes a row (narrow), else 0
  int C;          // CTAs a row (cluster), else 1
  int threads;    // a CTA
  int ctas;       // the grid
  int slice;      // elements a cluster rank reduces (cluster), else V
  int K;          // 16-byte vectors a thread has in flight
};

int next_pow2(long long n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// the SM count of the current device, queried once a device
cudaError_t sm_count(int* out) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!cached[dev]) {
    err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  *out = cached[dev];
  return cudaSuccess;
}

// The cut from the shapes and the SM count alone.  A row of 0.5-2 KB
// takes the narrow cut only when there are more rows than two an SM:
// with fewer, a CTA a row (two vectors a thread) spreads the rows over
// SMs and halves a lane's serial work.  C is as large as fills the card
// (B * C CTAs at most one an SM) while each rank reads >= 4 KB.
void make_plan(Plan* p, int B, int V, int elem, int sms, int max_C) {
  const long long row_bytes = (long long)V * elem;
  if (row_bytes <= kOneVecBytes ||
      (row_bytes <= kNarrowMaxBytes && B > 2LL * sms)) {
    const int vecs = (int)((row_bytes + 15) / 16);
    const int G = vecs < 32 ? next_pow2(vecs) : 32;
    *p = Plan{kNarrow, G, 1, kNarrowThreads,
              (int)(((long long)B * G + kNarrowThreads - 1) / kNarrowThreads),
              V, next_pow2((vecs + G - 1) / G)};
    return;
  }
  int C = 1;
  while (2 * C <= max_C && (long long)B * 2 * C <= sms &&
         row_bytes / (2 * C) >= kMinSliceBytes)
    C *= 2;
  const int W = 16 / elem;
  const long long per = (V + C - 1) / C;
  const int slice = (int)((per + W - 1) / W * W);
  int threads = next_pow2(((long long)slice * elem / 16 + kWideVecs - 1)
                          / kWideVecs);
  threads = threads < kMinThreads ? kMinThreads
                                  : (threads > kMaxThreads ? kMaxThreads
                                                           : threads);
  *p = Plan{C > 1 ? kCluster : kRows, 0, C, threads, B * C,
            C > 1 ? slice : V, kWideVecs};
}

// A launch configuration for the cluster cut (not copyable: cfg points
// at attr).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(const Plan& p, int B, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(p.C, B, 1);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Whether one cluster of plan p can be placed (asked once a (kernel, C,
// threads); the first call also allows a non-portable cluster size).
template <typename Kernel>
cudaError_t placeable(Kernel kernel, const Plan& p, bool* ok) {
  struct Seen { const void* fn; int C, threads; bool ok; };
  static Seen seen[64];
  static int n_seen = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == fn && seen[i].C == p.C && seen[i].threads == p.threads) {
      *ok = seen[i].ok;
      return cudaSuccess;
    }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int clusters = 0;
  if (err == cudaSuccess) {
    const ClusterLaunch cl(p, 1, 0);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cl.cfg);
  }
  if (err != cudaSuccess) return err;
  *ok = clusters > 0;
  if (n_seen < 64) seen[n_seen++] = {fn, p.C, p.threads, *ok};
  return cudaSuccess;
}

// make_plan's cut, with C halved while the card cannot place the cluster
template <typename T>
cudaError_t choose_plan(Plan* p, int B, int V) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  for (int max_C = kMaxCluster;; max_C = p->C / 2) {
    make_plan(p, B, V, (int)sizeof(T), sms, max_C);
    if (p->layout != kCluster) return cudaSuccess;
    bool ok = false;
    err = placeable(gate_cluster<T>, *p, &ok);
    if (err != cudaSuccess || ok) return err;
  }
}

template <typename T>
int launch(const void* logits, float* mp, float* ent, float* mar,
           int32_t* am, int B, int V, cudaStream_t s) {
  Plan p;
  cudaError_t err = choose_plan<T>(&p, B, V);
  if (err != cudaSuccess) return (int)err;
  const T* x = (const T*)logits;
  if (p.layout == kNarrow) {
    int log2_G = 0;
    while ((1 << log2_G) < p.G) ++log2_G;
    if (p.K == 1)
      gate_narrow<T, 1><<<p.ctas, p.threads, 0, s>>>(x, mp, ent, mar, am, B,
                                                     V, log2_G);
    else if (p.K == 2)
      gate_narrow<T, 2><<<p.ctas, p.threads, 0, s>>>(x, mp, ent, mar, am, B,
                                                     V, log2_G);
    else
      gate_narrow<T, 4><<<p.ctas, p.threads, 0, s>>>(x, mp, ent, mar, am, B,
                                                     V, log2_G);
  } else if (p.layout == kRows) {
    gate_rows<T><<<B, p.threads, 0, s>>>(x, mp, ent, mar, am, V);
  } else {
    const ClusterLaunch cl(p, B, s);
    err = cudaLaunchKernelEx(&cl.cfg, gate_cluster<T>, x, mp, ent, mar, am,
                             V, p.slice);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int plan_of(int B, int V, int* out) {
  Plan p;
  const cudaError_t err = choose_plan<T>(&p, B, V);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.layout;
  out[1] = p.G;
  out[2] = p.C;
  out[3] = p.threads;
  out[4] = p.ctas;
  out[5] = p.slice;
  out[6] = p.K;
  return 0;
}

}  // namespace

extern "C" {

// logits: (B, V) contiguous, any element-aligned pointer; dtype 0 =
// float32, 1 = bfloat16, 2 = float16.  Outputs: three (B,) float32 arrays
// and one (B,) int32 array.  One launch; returns its cudaError_t (0 on
// success).
int confidence_gate(const void* logits, void* max_prob, void* entropy,
                    void* margin, void* argmax, int B, int V, int dtype,
                    void* stream) {
  if (B < 1 || V < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* mp = (float*)max_prob;
  float* ent = (float*)entropy;
  float* mar = (float*)margin;
  int32_t* am = (int32_t*)argmax;
  if (dtype == 0) return launch<float>(logits, mp, ent, mar, am, B, V, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, mp, ent, mar, am, B, V, s);
  if (dtype == 2) return launch<__half>(logits, mp, ent, mar, am, B, V, s);
  return (int)cudaErrorInvalidValue;
}

// The cut confidence_gate takes at these sizes: out[0] the layout (0
// narrow, 1 rows, 2 cluster), out[1] lanes a row (narrow), out[2] CTAs a
// row, out[3] threads a CTA, out[4] CTAs, out[5] elements a CTA reduces
// (a cluster rank's slice, or V).  Reads the SM count; launches nothing.
int confidence_gate_plan(int B, int V, int dtype, int* out) {
  if (B < 1 || V < 2) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return plan_of<float>(B, V, out);
  if (dtype == 1) return plan_of<__nv_bfloat16>(B, V, out);
  if (dtype == 2) return plan_of<__half>(B, V, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
