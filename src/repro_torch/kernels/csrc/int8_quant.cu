// Row-wise absmax int8 quantization for Hopper (sm_90a): (N, D) fp32,
// bf16 or fp16 -> int8 (N, D) plus one fp32 scale per row,
//     scale = max(absmax(row), 1e-8) / 127,  q = clip(rint(x / scale), +-127).
//
// Replaces: the Pallas TPU kernel repro/kernels/int8_quant.py
// (int8_quantize_kernel), the escalation payload compression behind
// CascadeConfig.quantize_payload (repro/core/cascade.py), which the port
// runs for real: every escalated EO tile goes down the link as one int8
// row plus its scale.
//
// What bounds it: bytes.  Each input element is read once from device
// memory and each int8 written once (N * D * (itemsize + 1) + 4N bytes);
// the work is a few operations per element, far below the card's ~20
// operations per byte at its fp32 rate.  The design: one CTA per row
// streams it with 16-byte loads where the row is aligned and reduces the
// absmax by warp shuffles and once more across warps; the second pass
// reads the row again, now from L2 (a row is at most a few KB, and a
// whole escalation payload fits in the 50 MB L2), and writes the int8 row
// with 4- or 8-byte stores.  A small row gets a CTA of as few warps as
// its vectors fill.

// Exactness: q equals the plain version bit for bit.  The row is scaled
// by an IEEE division x / scale (a multiply by 1 / scale would move values
// that sit on .5), rounded half to even with rintf (jnp.round and
// torch.round round so; roundf would round half away from zero), and the
// build uses no fast math.  A row of zeros gets scale 1e-8 / 127 and q 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float r = rintf(x / scale);
  return (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

// 16 bytes of T as kVec floats
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < kN; ++k) out[k] = to_f32(e[k]);
  }
};

template <int kN>
__device__ __forceinline__ void store_q(int8_t* p, const int8_t* q);
template <>
__device__ __forceinline__ void store_q<4>(int8_t* p, const int8_t* q) {
  char4 v = make_char4(q[0], q[1], q[2], q[3]);
  *reinterpret_cast<char4*>(p) = v;
}
template <>
__device__ __forceinline__ void store_q<8>(int8_t* p, const int8_t* q) {
  uint2 v;
  int8_t* b = reinterpret_cast<int8_t*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = q[k];
  *reinterpret_cast<uint2*>(p) = v;
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < n_warps ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;                      // every thread holds the row's absmax
}

// kVec: the row is read with 16-byte loads (D % (16 / sizeof(T)) == 0,
// 16-byte-aligned x and a q aligned for the int8 vector stores)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
int8_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scale, int D) {
  __shared__ float red[kMaxWarps];
  const size_t r = blockIdx.x;
  const T* row = x + r * D;
  int8_t* qrow = q + r * D;
  constexpr int V = kVec ? Vec<T>::kN : 1;
  const int nv = D / V;

  float amax = 0.f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    if constexpr (kVec) {
      float v[V];
      Vec<T>::load(row + (size_t)i * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) amax = fmaxf(amax, fabsf(v[k]));
    } else {
      amax = fmaxf(amax, fabsf(to_f32(row[i])));
    }
  }

  const float s = fmaxf(block_max(amax, red), 1e-8f) / 127.0f;
  if (threadIdx.x == 0) scale[r] = s;

  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    if constexpr (kVec) {
      float v[V];
      Vec<T>::load(row + (size_t)i * V, v);
      int8_t o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = quantize(v[k], s);
      store_q<V>(qrow + (size_t)i * V, o);
    } else {
      qrow[i] = quantize(to_f32(row[i]), s);
    }
  }
}

template <typename T, bool kVec>
int launch(const void* x, void* q, void* scale, int N, int D,
           cudaStream_t stream) {
  const int items = kVec ? D / Vec<T>::kN : D;
  int threads = ((items + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                        : threads);
  int8_quant_kernel<T, kVec><<<N, threads, 0, stream>>>(
      (const T*)x, (int8_t*)q, (float*)scale, D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, void* q, void* scale, int N, int D,
             cudaStream_t stream) {
  const bool vec = D % Vec<T>::kN == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)q % Vec<T>::kN == 0;
  return vec ? launch<T, true>(x, q, scale, N, D, stream)
             : launch<T, false>(x, q, scale, N, D, stream);
}

}  // namespace

extern "C" {

// x: (N, D) contiguous; dtype 0 = float32, 1 = bfloat16, 2 = float16.
// q: (N, D) int8; scale: (N,) float32.  Returns the launch's cudaError_t
// (0 on success).
int int8_quantize(const void* x, void* q, void* scale, int N, int D,
                  int dtype, void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(x, q, scale, N, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, q, scale, N, D, s);
  if (dtype == 2) return dispatch<__half>(x, q, scale, N, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
