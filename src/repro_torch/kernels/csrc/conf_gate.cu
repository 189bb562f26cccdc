// Confidence gate for Hopper (sm_90a): one streaming pass over (B, V)
// logits emitting max_prob, entropy, margin and the first-index argmax.
//
// Replaces: the Pallas TPU kernel repro/kernels/conf_gate.py
// (confidence_gate_kernel), the fused metric pass behind the gate that
// decides every escalation (repro/core/gating.py::ConfidenceGate.decide,
// called at repro/serving/scheduler.py for each finished sequence).
//
// What bounds it: the bytes of the logits, read once (B * V * itemsize);
// the work is ~4 operations per element and there is no reuse, so it is
// a pure bandwidth-bound row reduction.  The design reads each logit
// exactly once, in one pass, and keeps everything else in registers:
// each thread streams a strided slice of its row (kBatch loads in
// flight at a time) keeping a running
// (max1, max2, argmax, sum exp(x - max1), sum x * exp(x - max1)) with
// the online-softmax rescale on a new maximum; the per-thread states are
// then merged by warp shuffles and once more across warps through
// shared memory.  max_prob, entropy and margin follow from the merged
// state without a second pass:
//     lse = max1 + log(l);  max_prob = exp(max1 - lse)
//     entropy = lse - sx / l;  margin = max_prob - exp(max2 - lse)
// Ties keep the FIRST index: a thread sees its indices in increasing
// order and replaces its argmax only on a strictly larger value, and a
// merge of two equal maxima keeps the smaller index, so a tie split
// across threads (or across the TPU kernel's vocab blocks) resolves as
// jnp.argmax / torch.argmax do.  max2 counts multiplicity (two equal
// maxima give margin 0), as top-2 does.  One CTA per row; splitting one
// row over several CTAs (for B = 1 at large V) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBatch = 16;              // loads in flight per thread
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

struct State {
  float m1, m2, l, sx;
  int am;
};

__device__ __forceinline__ State merge(const State& a, const State& b) {
  State r;
  const bool a_wins = a.m1 > b.m1 || (a.m1 == b.m1 && a.am < b.am);
  r.m1 = fmaxf(a.m1, b.m1);
  r.am = a_wins ? a.am : b.am;
  r.m2 = fmaxf(fmaxf(a.m2, b.m2), fminf(a.m1, b.m1));
  const float ca = expf(a.m1 - r.m1);
  const float cb = expf(b.m1 - r.m1);
  r.l = a.l * ca + b.l * cb;
  r.sx = a.sx * ca + b.sx * cb;
  return r;
}

__device__ __forceinline__ State shfl_down(const State& s, int off) {
  State o;
  o.m1 = __shfl_down_sync(0xffffffffu, s.m1, off);
  o.m2 = __shfl_down_sync(0xffffffffu, s.m2, off);
  o.l = __shfl_down_sync(0xffffffffu, s.l, off);
  o.sx = __shfl_down_sync(0xffffffffu, s.sx, off);
  o.am = __shfl_down_sync(0xffffffffu, s.am, off);
  return o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conf_gate_kernel(const T* __restrict__ logits, float* __restrict__ max_prob,
                 float* __restrict__ entropy, float* __restrict__ margin,
                 int32_t* __restrict__ argmax, int V) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const T* row = logits + (size_t)b * V;

  State st{kNegInf, kNegInf, 0.f, 0.f, 0};
  // kBatch independent loads in flight per thread before the dependent
  // running-state updates (one load at a time would pay the full memory
  // latency per element)
  for (int base = tid; base < V; base += kThreads * kBatch) {
    float xs[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads;
      xs[k] = i < V ? to_f32(row[i]) : kNegInf;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads;
      if (i >= V) break;
      const float x = xs[k];
      if (x > st.m1) {
        const float c = expf(st.m1 - x);
        st.l *= c;
        st.sx *= c;
        st.m2 = st.m1;
        st.m1 = x;
        st.am = i;
      } else if (x > st.m2) {
        st.m2 = x;
      }
      const float e = expf(x - st.m1);
      st.l += e;
      st.sx += x * e;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) st = merge(st, shfl_down(st, off));

  __shared__ State warp_state[kWarps];
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (lane == 0) warp_state[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = lane < kWarps ? warp_state[lane]
                       : State{kNegInf, kNegInf, 0.f, 0.f, 0};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) st = merge(st, shfl_down(st, off));
    if (lane == 0) {
      const float l = fmaxf(st.l, 1e-30f);
      const float lse = st.m1 + logf(l);
      const float mp = expf(st.m1 - lse);
      max_prob[b] = mp;
      entropy[b] = lse - st.sx / l;
      margin[b] = mp - expf(st.m2 - lse);
      argmax[b] = st.am;
    }
  }
}

}  // namespace

extern "C" {

// logits: (B, V) contiguous; dtype 0 = float32, 1 = bfloat16, 2 = float16.
// Outputs: three (B,) float32 arrays and one (B,) int32 array.  Returns
// the launch's cudaError_t (0 on success).
int confidence_gate(const void* logits, void* max_prob, void* entropy,
                    void* margin, void* argmax, int B, int V, int dtype,
                    void* stream) {
  if (B < 1 || V < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* mp = (float*)max_prob;
  float* ent = (float*)entropy;
  float* mar = (float*)margin;
  int32_t* am = (int32_t*)argmax;
  if (dtype == 0) {
    conf_gate_kernel<float><<<B, kThreads, 0, s>>>(
        (const float*)logits, mp, ent, mar, am, V);
  } else if (dtype == 1) {
    conf_gate_kernel<__nv_bfloat16><<<B, kThreads, 0, s>>>(
        (const __nv_bfloat16*)logits, mp, ent, mar, am, V);
  } else if (dtype == 2) {
    conf_gate_kernel<__half><<<B, kThreads, 0, s>>>(
        (const __half*)logits, mp, ent, mar, am, V);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
