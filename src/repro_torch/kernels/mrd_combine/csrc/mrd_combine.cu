// Fused dequant-accumulate of the int8 MRD wire format, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mrd_combine/kernel.py
//           (_combine_kernel, launched by mrd_combine_fwd).
//
// What it computes (the Pallas kernel's contract):
//   x [n] float32 or bfloat16; q [n] int8; scales [n / 256] float32,
//   n % 256 == 0  ->  out[i] = T(float(x[i]) + float(q[i]) * scales[i / 256]).
//   The product and the sum are rounded separately (__fmul_rn, __fadd_rn),
//   as the plain version computes them, so that nvcc cannot contract them
//   into one FMA: in float32 the kernel equals the plain version bit for
//   bit, and in bfloat16 the one rounding of the fp32 sum (round to
//   nearest even) equals the plain version's cast.
//
// What bounds it: device-memory bytes.  Each element reads x (4 or 2 B)
// and q (1 B) and writes out (4 or 2 B), plus 4 B of scale per 256
// elements: 9 B an element in float32, at two flops an element.  The
// design streams every byte once: a grid-stride loop in which a thread
// takes 16 consecutive elements, i.e. one 16-byte load of q, 16-byte loads
// of x (four in float32, two in bfloat16) and stores of the same width,
// and reads the one scale of the 256-block its 16 elements lie in.  No
// shared memory, no TMA: a simple first kernel, at about half the bytes
// bound on an H100 (PERF.md).  Unmeasured candidate for a later kernel: a
// warp's 16-byte accesses of x and out lie 64 bytes apart, not adjacent.
//
// C entry point repro_mrd_combine(...) launches on the given stream and
// returns cudaGetLastError() (0 on success), or -1 for a length or type
// it does not take; the Python wrapper raises on any non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;     // elements a thread takes per iteration
constexpr int kQBlock = 256; // quantization block (one scale each)
constexpr int kUnsupported = -1;

// x and out as 16 elements: four float4 in fp32, two uint4 (8 bf16 each)
// in bf16.  Both are 16-byte vector accesses.
__device__ __forceinline__ void load16(const float* p, float (&v)[kVec]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float4 t = p4[j];
    v[4 * j] = t.x; v[4 * j + 1] = t.y; v[4 * j + 2] = t.z; v[4 * j + 3] = t.w;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[kVec]) {
  float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    p4[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint4 t = p4[j];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[8 * j + k] = __bfloat162float(h[k]);
  }
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4* p4 = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint4 t;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&t);
#pragma unroll
    for (int k = 0; k < 8; ++k) h[k] = __float2bfloat16_rn(v[8 * j + k]);
    p4[j] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mrd_combine_kernel(const T* __restrict__ x,           // [n]
                   const int8_t* __restrict__ q,      // [n]
                   const float* __restrict__ scales,  // [n / 256]
                   T* __restrict__ out,               // [n]
                   int64_t n_vec) {                   // n / 16
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_vec;
       i += stride) {
    const int4 qv = reinterpret_cast<const int4*>(q)[i];
    const int8_t* qb = reinterpret_cast<const int8_t*>(&qv);
    const float s = scales[i / (kQBlock / kVec)];
    float v[kVec];
    load16(x + i * kVec, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      v[k] = __fadd_rn(v[k], __fmul_rn(static_cast<float>(qb[k]), s));
    store16(out + i * kVec, v);
  }
}

template <typename T>
int launch(const void* x, const void* q, const void* scales, void* out, int64_t n,
           cudaStream_t stream) {
  const int64_t n_vec = n / kVec;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // enough blocks to fill every SM several times over; the loop covers the rest
  const int64_t want = (n_vec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 132) * 8;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  mrd_combine_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scales), static_cast<T*>(out), n_vec);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x and out).  Tensors are
// contiguous, 16-byte aligned and on the stream's device; n % 256 == 0.
extern "C" int repro_mrd_combine(const void* x, const void* q, const void* scales,
                                 void* out, long long n, int dtype, void* stream) {
  if (n <= 0 || n % kQBlock != 0) return kUnsupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case 0: rc = launch<float>(x, q, scales, out, n, s); break;
    case 1: rc = launch<__nv_bfloat16>(x, q, scales, out, n, s); break;
    default: rc = kUnsupported;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
