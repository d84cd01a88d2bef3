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
// elements: 9 B an element in float32, 5 B in bfloat16, at two flops an
// element.  The design (v2) streams every byte once at the card's rate:
//   - a warp takes one 256-block, so its scale is one read-only load (the
//     same address for every lane) and its index is the warp's, with no
//     division; n is a whole number of 256-blocks, so no warp has a
//     partial one;
//   - a lane's 16-byte accesses of x and out (4 float32 or 8 bfloat16) sit
//     beside its neighbours', so each warp-wide access is 512 contiguous
//     bytes (two in float32), and q's loads (4 or 8 bytes a lane) are
//     contiguous too (lanes 64 bytes apart touch twice the sectors they
//     use, and ran at half the bound on an H100, PERF.md);
//   - every load of the block (x, q, the scale) is issued before the first
//     product, and the grid holds one warp for every 256-block, so the SMs
//     keep enough loads in flight without a loop (a grid-stride loop over
//     one wave of blocks was slower there);
//   - out is written once, so its stores carry the streaming hint
//     (st.global.cs); x and q go through the read-only path, which was
//     faster there than their streaming loads.
//
// C entry point repro_mrd_combine(...) launches on the given stream and
// returns cudaGetLastError() (0 on success), or -1 for a length or type
// it does not take; the Python wrapper raises on any non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // warps (256-blocks) a block
constexpr int kQBlock = 256; // quantization block (one scale each)
constexpr int kUnsupported = -1;

// One lane's share of a warp-wide access: 16 bytes of x (4 float32 or 8
// bfloat16) and the q bytes of the same elements (4 or 8).
template <typename T>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int kElems = 4;
  using X = float4;
  using Q = int;  // 4 int8

  static __device__ __forceinline__ X load_x(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ Q load_q(const int8_t* p) {
    return __ldg(reinterpret_cast<const int*>(p));
  }
  static __device__ __forceinline__ void store(float* p, X v) {
    __stcs(reinterpret_cast<float4*>(p), v);
  }
  static __device__ __forceinline__ X combine(X v, Q q, float s) {
    v.x = __fadd_rn(v.x, __fmul_rn(static_cast<float>(static_cast<int8_t>(q)), s));
    v.y = __fadd_rn(v.y, __fmul_rn(static_cast<float>(static_cast<int8_t>(q >> 8)), s));
    v.z = __fadd_rn(v.z, __fmul_rn(static_cast<float>(static_cast<int8_t>(q >> 16)), s));
    v.w = __fadd_rn(v.w, __fmul_rn(static_cast<float>(static_cast<int8_t>(q >> 24)), s));
    return v;
  }
};

template <>
struct Lane<__nv_bfloat16> {
  static constexpr int kElems = 8;
  using X = uint4;  // 4 words of 2 bfloat16 each
  using Q = int2;   // 8 int8

  static __device__ __forceinline__ X load_x(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Q load_q(const int8_t* p) {
    return __ldg(reinterpret_cast<const int2*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, X v) {
    __stcs(reinterpret_cast<uint4*>(p), v);
  }
  // two bfloat16 of a word (low element first) and their two q bytes
  static __device__ __forceinline__ uint32_t pair(uint32_t w, int q, float s) {
    const float lo = __fadd_rn(__uint_as_float(w << 16),
                               __fmul_rn(static_cast<float>(static_cast<int8_t>(q)), s));
    const float hi = __fadd_rn(__uint_as_float(w & 0xffff0000u),
                               __fmul_rn(static_cast<float>(static_cast<int8_t>(q >> 8)), s));
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ X combine(X v, Q q, float s) {
    v.x = pair(v.x, q.x, s);
    v.y = pair(v.y, q.x >> 16, s);
    v.z = pair(v.z, q.y, s);
    v.w = pair(v.w, q.y >> 16, s);
    return v;
  }
};

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
mrd_combine_kernel(const T* __restrict__ x,           // [n]
                   const int8_t* __restrict__ q,      // [n]
                   const float* __restrict__ scales,  // [n / 256]
                   T* __restrict__ out,               // [n]
                   int64_t n_blocks) {                // n / 256
  using L = Lane<T>;
  constexpr int kSpan = 32 * L::kElems;        // elements of one warp-wide access
  constexpr int kSpans = kQBlock / kSpan;      // 2 in float32, 1 in bfloat16
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= n_blocks) return;
  const int64_t e0 = b * kQBlock + (threadIdx.x & 31) * L::kElems;
  typename L::X xv[kSpans];
  typename L::Q qv[kSpans];
#pragma unroll
  for (int j = 0; j < kSpans; ++j) {
    xv[j] = L::load_x(x + e0 + j * kSpan);
    qv[j] = L::load_q(q + e0 + j * kSpan);
  }
  const float s = __ldg(scales + b);
#pragma unroll
  for (int j = 0; j < kSpans; ++j) L::store(out + e0 + j * kSpan, L::combine(xv[j], qv[j], s));
}

template <typename T>
void launch(const void* x, const void* q, const void* scales, void* out, int64_t n,
            cudaStream_t stream) {
  const int64_t n_blocks = n / kQBlock;
  const unsigned grid = static_cast<unsigned>((n_blocks + kWarps - 1) / kWarps);
  mrd_combine_kernel<T><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scales), static_cast<T*>(out), n_blocks);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x and out).  Tensors are
// contiguous, 16-byte aligned and on the stream's device; n % 256 == 0.
extern "C" int repro_mrd_combine(const void* x, const void* q, const void* scales,
                                 void* out, long long n, int dtype, void* stream) {
  if (n <= 0 || n % kQBlock != 0) return kUnsupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(x, q, scales, out, n, s); break;
    case 1: launch<__nv_bfloat16>(x, q, scales, out, n, s); break;
    default: return kUnsupported;
  }
  return static_cast<int>(cudaGetLastError());
}
