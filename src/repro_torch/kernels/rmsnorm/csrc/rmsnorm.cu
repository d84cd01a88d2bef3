// RMSNorm forward for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * (1 + w).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py (_rms_kernel, launched by
//           rmsnorm_fwd).
//
// What it computes (the Pallas kernel's contract): x [T, d] (fp32 or bf16),
// w [d] (fp32 or bf16, the (1 + w) convention) -> out [T, d] in x's type.
// The sum of squares, the mean, rsqrt and the products are fp32, in the
// plain version's order: (x * r) * (1 + w).
//
// What bounds it: device-memory bytes.  Each row is read once and written
// once (w stays in L1/L2): 2 * T * d * sizeof(x) bytes for about 4 flops
// an element, far below the card's operations-per-byte balance.  The
// design reads each row exactly once from device memory: one block of 128
// threads a row, 16-byte loads, the row kept in registers (up to VPT
// vectors a thread) between the reduction and the write, the sum of
// squares reduced by warp shuffles and one shared-memory step.  A simple
// first kernel: a row of d = 64 leaves most of the block idle (decode-size
// and smoke rows are few), which later work can pack several rows a block.
//
// C entry point repro_rmsnorm(...) launches on the given stream and
// returns cudaGetLastError() (0 on success), or -1 for a shape or type it
// does not support; the Python wrapper raises on any non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnsupported = -1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TX, typename TW, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
               int d, float eps) {
  constexpr int kN = 16 / sizeof(TX);  // elements of a 16-byte vector
  __shared__ float partial[kWarps];
  const int tid = threadIdx.x;
  const int n_vec = d / kN;
  const uint4* row = reinterpret_cast<const uint4*>(x + (int64_t)blockIdx.x * d);
  uint4* orow = reinterpret_cast<uint4*>(out + (int64_t)blockIdx.x * d);

  uint4 buf[VPT];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = tid + i * kThreads;
    if (j < n_vec) {
      buf[i] = row[j];
      const TX* xv = reinterpret_cast<const TX*>(&buf[i]);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float f = to_float(xv[e]);
        ss += f * f;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((tid & 31) == 0) partial[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += partial[i];
  const float r = rsqrtf(total / (float)d + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = tid + i * kThreads;
    if (j < n_vec) {
      const TX* xv = reinterpret_cast<const TX*>(&buf[i]);
      uint4 o;
      TX* ov = reinterpret_cast<TX*>(&o);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float scaled = to_float(xv[e]) * r;
        ov[e] = from_float<TX>(scaled * (1.f + to_float(w[j * kN + e])));
      }
      orow[j] = o;
    }
  }
}

template <typename TX, typename TW, int VPT>
int launch(const void* x, const void* w, void* out, int T, int d, float eps,
           cudaStream_t stream) {
  rmsnorm_kernel<TX, TW, VPT><<<T, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), d, eps);
  return 0;
}

template <typename TX, typename TW>
int dispatch_vpt(const void* x, const void* w, void* out, int T, int d, float eps,
                 cudaStream_t stream) {
  const int n_vec = d / (16 / (int)sizeof(TX));
  const int vpt = (n_vec + kThreads - 1) / kThreads;
  if (vpt <= 1) return launch<TX, TW, 1>(x, w, out, T, d, eps, stream);
  if (vpt <= 2) return launch<TX, TW, 2>(x, w, out, T, d, eps, stream);
  if (vpt <= 4) return launch<TX, TW, 4>(x, w, out, T, d, eps, stream);
  if (vpt <= 8) return launch<TX, TW, 8>(x, w, out, T, d, eps, stream);
  if (vpt <= 16) return launch<TX, TW, 16>(x, w, out, T, d, eps, stream);
  return kUnsupported;
}

template <typename TX>
int dispatch_w(int w_dtype, const void* x, const void* w, void* out, int T, int d,
               float eps, cudaStream_t stream) {
  switch (w_dtype) {
    case 0: return dispatch_vpt<TX, float>(x, w, out, T, d, eps, stream);
    case 1: return dispatch_vpt<TX, __nv_bfloat16>(x, w, out, T, d, eps, stream);
    default: return kUnsupported;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x and out are contiguous [T, d]
// with d % 8 == 0 and x 16-byte aligned; w is contiguous [d].
extern "C" int repro_rmsnorm(const void* x, const void* w, void* out, int T, int d,
                             int x_dtype, int w_dtype, float eps, void* stream) {
  if (T <= 0 || d <= 0 || d % 8 != 0) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (x_dtype) {
    case 0: rc = dispatch_w<float>(w_dtype, x, w, out, T, d, eps, s); break;
    case 1: rc = dispatch_w<__nv_bfloat16>(w_dtype, x, w, out, T, d, eps, s); break;
    default: rc = kUnsupported;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
