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
// operations per byte at its fp32 rate.  At the path's shape (a few
// hundred 12 KB rows) the bytes take about a microsecond, so the design
// goes after latency: one read of each row, every load of a thread in
// flight at once.
//
// The design, chosen on the host from D alone (int8_quantize_plan):
//   registers  each thread issues all its loads of the row at once and
//              keeps them in registers: R slots (a template argument, 1,
//              2, 4 or 8), slot j of the row to thread j % P, a slot a
//              16-byte vector (4 fp32 or 8 bf16/fp16 values) where the
//              row allows it.  The absmax reduces by warp shuffles (and
//              once more across warps), then the row is quantized from
//              those registers, with no second read, and written with one
//              4- or 8-byte store a slot (a warp's stores are one
//              contiguous run).  A row of at most 64 slots takes a warp
//              (8 rows a CTA; R = 1 or 2); a longer one a CTA of up to 512
//              threads (R the least that keeps P <= 512: more slots a
//              lane of a warp row measured slower than a CTA row).
//   streaming  a row wider than the registers hold (more than 512 x 8
//              slots: D > 16384 in fp32, 32768 in bf16) takes a CTA of 512
//              threads in two passes, kStreamSlots loads a thread in
//              flight: the absmax, then the row again (from the 50 MB L2)
//              quantized.
// A slot is one element (the scalar path) where D is not a multiple of a
// vector or a pointer is off its alignment.

// Exactness: q equals the plain version bit for bit.  The row is scaled
// by an IEEE division x / scale (__fdiv_rn; a multiply by 1 / scale would
// move values that sit on .5), rounded half to even with rintf (jnp.round
// and torch.round round so; roundf would round half away from zero), and
// the build uses no fast math.  A row of zeros gets scale 1e-8 / 127 and
// q 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

using vec16::Vec;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kWarpSlots = 64;             // a row this short: one warp
constexpr int kWarpRows = 8;               // rows a CTA, a warp a row
constexpr int kMaxSlots = 8;               // R, the registers' plan
constexpr int kStreamSlots = 4;            // loads in flight, streaming

enum Path { kWarpRow = 0, kCtaRow = 1, kStream = 2 };

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

// one slot of the row: kW values (16 bytes, or one element if kW == 1)
template <typename T, int kW>
struct Slot {
  uint4 raw;
  __device__ __forceinline__ void load(const T* row, int j) {
    raw = vec16::load16(row + (size_t)j * kW);
  }
  __device__ __forceinline__ void values(float* o) const {
    Vec<T>::unpack(raw, o);
  }
};

template <typename T>
struct Slot<T, 1> {
  float v;
  __device__ __forceinline__ void load(const T* row, int j) {
    v = vec16::to_f32(row[j]);
  }
  __device__ __forceinline__ void values(float* o) const { o[0] = v; }
};

template <int kW>
__device__ __forceinline__ void store_q(int8_t* p, const int8_t* q);
template <>
__device__ __forceinline__ void store_q<1>(int8_t* p, const int8_t* q) {
  *p = q[0];
}
template <>
__device__ __forceinline__ void store_q<4>(int8_t* p, const int8_t* q) {
  *reinterpret_cast<char4*>(p) = make_char4(q[0], q[1], q[2], q[3]);
}
template <>
__device__ __forceinline__ void store_q<8>(int8_t* p, const int8_t* q) {
  uint2 v;
  int8_t* b = reinterpret_cast<int8_t*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = q[k];
  *reinterpret_cast<uint2*>(p) = v;
}

template <int kW>
__device__ __forceinline__ void quantize_slot(int8_t* qrow, int j,
                                              const float* v, float s) {
  int8_t o[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) o[k] = quantize(v[k], s);
  store_q<kW>(qrow + (size_t)j * kW, o);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the CTA's absmax in every thread (the warps' maxima through red)
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x / 32) ? red[lane] : 0.f;
  return warp_max(v);
}

// The registers path: P threads a row (P = 32, blockDim.x / 32 rows a
// CTA; or P = blockDim.x, one row), kR slots a thread.
template <typename T, int kW, int kR>
__global__ void __launch_bounds__(kMaxThreads)
int8_rows(const T* __restrict__ x, int8_t* __restrict__ q,
          float* __restrict__ scale, int N, int D, int P) {
  __shared__ float red[kMaxWarps];
  const int r = blockIdx.x * (blockDim.x / P) + threadIdx.x / P;
  const int rank = threadIdx.x % P;
  if (r >= N) return;                 // whole warps (P = 32): no shuffle
  const T* row = x + (size_t)r * D;
  const int slots = D / kW;
  Slot<T, kW> v[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {      // every load before any use
    const int j = rank + k * P;
    if (j < slots) v[k].load(row, j);
  }
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    if (rank + k * P < slots) {
      float f[kW];
      v[k].values(f);
#pragma unroll
      for (int w = 0; w < kW; ++w) amax = fmaxf(amax, fabsf(f[w]));
    }
  }
  amax = P > 32 ? block_max(amax, red) : warp_max(amax);
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (rank == 0) scale[r] = s;
  int8_t* qrow = q + (size_t)r * D;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int j = rank + k * P;
    if (j < slots) {
      float f[kW];
      v[k].values(f);
      quantize_slot<kW>(qrow, j, f, s);
    }
  }
}

// The streaming path: one CTA a row, two passes of kStreamSlots slots a
// thread in flight.
template <typename T, int kW>
__global__ void __launch_bounds__(kMaxThreads)
int8_stream(const T* __restrict__ x, int8_t* __restrict__ q,
            float* __restrict__ scale, int D) {
  __shared__ float red[kMaxWarps];
  const size_t r = blockIdx.x;
  const T* row = x + r * D;
  const int slots = D / kW, P = blockDim.x;
  float amax = 0.f;
  for (int base = threadIdx.x; base < slots; base += kStreamSlots * P) {
    Slot<T, kW> v[kStreamSlots];
#pragma unroll
    for (int k = 0; k < kStreamSlots; ++k)
      if (base + k * P < slots) v[k].load(row, base + k * P);
#pragma unroll
    for (int k = 0; k < kStreamSlots; ++k) {
      if (base + k * P < slots) {
        float f[kW];
        v[k].values(f);
#pragma unroll
        for (int w = 0; w < kW; ++w) amax = fmaxf(amax, fabsf(f[w]));
      }
    }
  }
  const float s = __fdiv_rn(fmaxf(block_max(amax, red), 1e-8f), 127.0f);
  if (threadIdx.x == 0) scale[r] = s;
  int8_t* qrow = q + r * D;
  for (int base = threadIdx.x; base < slots; base += kStreamSlots * P) {
    Slot<T, kW> v[kStreamSlots];
#pragma unroll
    for (int k = 0; k < kStreamSlots; ++k)
      if (base + k * P < slots) v[k].load(row, base + k * P);
#pragma unroll
    for (int k = 0; k < kStreamSlots; ++k) {
      if (base + k * P < slots) {
        float f[kW];
        v[k].values(f);
        quantize_slot<kW>(qrow, base + k * P, f, s);
      }
    }
  }
}

// ---------------------------------------------------------------- host

struct Plan {
  int path;       // Path
  int W;          // values a slot (16 / itemsize, or 1: the scalar path)
  int R;          // slots a thread holds (registers) or has in flight
  int P;          // threads a row
  int rows;       // rows a CTA
  int threads;    // a CTA
  int ctas;       // the grid
};

Plan make_plan(int N, int D, int vec_w) {
  const int W = vec_w;
  const int slots = D / W;
  Plan p{};
  p.W = W;
  if (slots <= kWarpSlots) {
    p.path = kWarpRow;
    p.R = slots <= 32 ? 1 : 2;
    p.P = 32;
    p.rows = kWarpRows;
  } else if (slots <= kMaxThreads * kMaxSlots) {
    p.path = kCtaRow;
    p.R = 1;
    while (p.R < kMaxSlots && (slots + p.R - 1) / p.R > kMaxThreads)
      p.R *= 2;
    p.P = ((slots + p.R - 1) / p.R + 31) / 32 * 32;
    p.rows = 1;
  } else {
    p.path = kStream;
    p.R = kStreamSlots;
    p.P = kMaxThreads;
    p.rows = 1;
  }
  p.threads = p.P * p.rows;
  p.ctas = (N + p.rows - 1) / p.rows;
  return p;
}

template <typename T, int kW, int kR>
void launch_rows(const Plan& p, const void* x, void* q, void* scale, int N,
                 int D, cudaStream_t s) {
  int8_rows<T, kW, kR><<<p.ctas, p.threads, 0, s>>>(
      (const T*)x, (int8_t*)q, (float*)scale, N, D, p.P);
}

template <typename T, int kW>
int launch(const Plan& p, const void* x, void* q, void* scale, int N, int D,
           cudaStream_t s) {
  if (p.path == kStream) {
    int8_stream<T, kW><<<p.ctas, p.threads, 0, s>>>(
        (const T*)x, (int8_t*)q, (float*)scale, D);
  } else if (p.R == 1) {
    launch_rows<T, kW, 1>(p, x, q, scale, N, D, s);
  } else if (p.R == 2) {
    launch_rows<T, kW, 2>(p, x, q, scale, N, D, s);
  } else if (p.R == 4) {
    launch_rows<T, kW, 4>(p, x, q, scale, N, D, s);
  } else {
    launch_rows<T, kW, 8>(p, x, q, scale, N, D, s);
  }
  return (int)cudaGetLastError();
}

// 16-byte slots where D is a multiple of a vector, x starts on 16 bytes
// and q on the int8 store's width
template <typename T>
bool vectors(const void* x, const void* q, int D) {
  constexpr int W = Vec<T>::kN;
  return D % W == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)q % W == 0;
}

template <typename T>
int dispatch(const void* x, void* q, void* scale, int N, int D,
             cudaStream_t s) {
  constexpr int W = Vec<T>::kN;
  if (vectors<T>(x, q, D))
    return launch<T, W>(make_plan(N, D, W), x, q, scale, N, D, s);
  return launch<T, 1>(make_plan(N, D, 1), x, q, scale, N, D, s);
}

int vector_width(int dtype) { return dtype == 0 ? 4 : 8; }

}  // namespace

extern "C" {

// x: (N, D) contiguous; dtype 0 = float32, 1 = bfloat16, 2 = float16.
// q: (N, D) int8; scale: (N,) float32.  One launch; returns its
// cudaError_t (0 on success).
int int8_quantize(const void* x, void* q, void* scale, int N, int D,
                  int dtype, void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(x, q, scale, N, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, q, scale, N, D, s);
  if (dtype == 2) return dispatch<__half>(x, q, scale, N, D, s);
  return (int)cudaErrorInvalidValue;
}

// The cut int8_quantize takes at these sizes, with aligned pointers if
// `aligned` (else the scalar path): out[0] the path (0 a warp a row, 1 a
// CTA a row, 2 streaming), out[1] values a slot, out[2] slots a thread,
// out[3] threads a row, out[4] rows a CTA, out[5] threads a CTA, out[6]
// CTAs.  Touches no device.
int int8_quantize_plan(int N, int D, int dtype, int aligned, int* out) {
  if (N < 1 || D < 1 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int W = vector_width(dtype);
  const Plan p = make_plan(N, D, aligned && D % W == 0 ? W : 1);
  const int v[7] = {p.path, p.W, p.R, p.P, p.rows, p.threads, p.ctas};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
