// Paged decode attention for Hopper (sm_90a): one query per sequence,
// K/V read through a per-sequence block table.
//
// Replaces: src/repro/kernels/flash_attention/paged_kernel.py
//           (_paged_kernel, launched by paged_attention_fwd).
//
// What it computes (the Pallas kernel's contract):
//   q [S, H, hd]; k/v pages [N, bs, KV, hd]; block_tables [S, nb] int32;
//   lengths [S] int32 -> out [S, H, hd] in q's type, rep = H / KV.
//   For sequence s and kv head g, the GQA rows r < rep (head g*rep + r)
//   attend over positions [0, lengths[s]) of the logical cache, whose
//   block j lives in physical block block_tables[s, j].  Scores, the
//   running max, the running sum and the accumulator are fp32; positions
//   >= length get -1e30 before the max, as paged_kernel.py does.
//
// What bounds it: device-memory bytes.  A decode tick reads
//   sum_s lengths[s] * KV * hd * 2 (K and V) * sizeof(T)
// per layer and does ~4 flops per byte read, far below the card's
// operations-per-byte balance.  The design reads every K/V element of a
// live block exactly once: one CUDA block per (sequence, kv head) walks
// its table with the dynamic bound cdiv(length, bs), stages the [bs, hd]
// K and V tiles in shared memory, and serves all rep query rows of the
// GQA group from that one copy.  It is a simple first kernel: no TMA, no
// wgmma, no split over the sequence (S * KV blocks do not fill 132 SMs at
// small batch); those are for later work.
//
// C entry point repro_paged_attention(...) launches on the given stream
// and returns cudaGetLastError() (0 on success), or -1 for a shape or
// type it does not support; the Python wrapper raises on any non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
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

template <typename T, int HD, int REP, int BS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,            // [S, KV*REP, HD]
                       const T* __restrict__ k_pages,      // [N, BS, KV, HD]
                       const T* __restrict__ v_pages,      // [N, BS, KV, HD]
                       const int32_t* __restrict__ tables,  // [S, nb]
                       const int32_t* __restrict__ lengths, // [S]
                       T* __restrict__ out,                 // [S, KV*REP, HD]
                       int kv_heads, int nb, float scale) {
  constexpr int kRows = REP * HD;  // accumulator entries of the GQA group
  constexpr int kPerThread = (kRows + kThreads - 1) / kThreads;

  __shared__ float q_s[REP][HD];
  __shared__ float k_s[BS][HD + 1];  // +1: the score loop reads a column
  __shared__ float v_s[BS][HD];
  __shared__ float p_s[REP][BS];
  __shared__ float m_s[REP];
  __shared__ float l_s[REP];
  __shared__ float alpha_s[REP];

  const int s = blockIdx.x / kv_heads;
  const int g = blockIdx.x % kv_heads;
  const int tid = threadIdx.x;
  const int n_heads = kv_heads * REP;

  const T* q_seq = q + ((int64_t)s * n_heads + (int64_t)g * REP) * HD;
  for (int i = tid; i < kRows; i += kThreads) {
    q_s[i / HD][i % HD] = to_float(q_seq[i]) * scale;
  }
  if (tid < REP) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;

  const int length = lengths[s];
  int nblk = (length + BS - 1) / BS;
  if (nblk > nb) nblk = nb;  // never read past the table row
  const int32_t* table = tables + (int64_t)s * nb;
  const int64_t row_stride = (int64_t)kv_heads * HD;  // one position
  __syncthreads();

  for (int j = 0; j < nblk; ++j) {
    const int64_t base = ((int64_t)table[j] * BS) * row_stride + (int64_t)g * HD;
    for (int i = tid; i < BS * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      const int64_t off = base + t * row_stride + d;
      k_s[t][d] = to_float(k_pages[off]);
      v_s[t][d] = to_float(v_pages[off]);
    }
    __syncthreads();

    // scores [REP, BS], masked by absolute position
    for (int i = tid; i < REP * BS; i += kThreads) {
      const int r = i / BS, t = i % BS;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot += q_s[r][d] * k_s[t][d];
      p_s[r][t] = (j * BS + t < length) ? dot : kNegInf;
    }
    __syncthreads();

    // online softmax: one thread per query row
    if (tid < REP) {
      const float m_old = m_s[tid];
      float m_new = m_old;
#pragma unroll
      for (int t = 0; t < BS; ++t) m_new = fmaxf(m_new, p_s[tid][t]);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < BS; ++t) {
        const float p = expf(p_s[tid][t] - m_new);
        p_s[tid][t] = p;
        sum += p;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      alpha_s[tid] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ V, each thread owning fixed (row, d) entries
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < kRows) {
        const int r = e / HD, d = e % HD;
        float a = acc[i] * alpha_s[r];
#pragma unroll
        for (int t = 0; t < BS; ++t) a += p_s[r][t] * v_s[t][d];
        acc[i] = a;
      }
    }
    __syncthreads();  // the next block overwrites k_s, v_s and p_s
  }

  T* out_seq = out + ((int64_t)s * n_heads + (int64_t)g * REP) * HD;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < kRows) {
      out_seq[e] = from_float<T>(acc[i] / fmaxf(l_s[e / HD], 1e-30f));
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* tables;
  const int32_t* lengths;
  void* out;
  int S, KV, nb;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int REP, int BS>
int launch(const Args& a) {
  paged_attention_kernel<T, HD, REP, BS><<<a.S * a.KV, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.tables, a.lengths, static_cast<T*>(a.out),
      a.KV, a.nb, a.scale);
  return 0;
}

template <typename T, int HD, int REP>
int dispatch_bs(int bs, const Args& a) {
  switch (bs) {
    case 8: return launch<T, HD, REP, 8>(a);
    case 16: return launch<T, HD, REP, 16>(a);
    default: return kUnsupported;
  }
}

template <typename T, int HD>
int dispatch_rep(int rep, int bs, const Args& a) {
  switch (rep) {
    case 1: return dispatch_bs<T, HD, 1>(bs, a);
    case 2: return dispatch_bs<T, HD, 2>(bs, a);
    case 4: return dispatch_bs<T, HD, 4>(bs, a);
    default: return kUnsupported;
  }
}

template <typename T>
int dispatch_hd(int hd, int rep, int bs, const Args& a) {
  switch (hd) {
    case 16: return dispatch_rep<T, 16>(rep, bs, a);
    case 64: return dispatch_rep<T, 64>(rep, bs, a);
    default: return kUnsupported;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Tensors are contiguous, on the
// stream's device; block_tables and lengths are int32.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages, const void* block_tables,
                                     const void* lengths, void* out, int S, int H,
                                     int KV, int hd, int bs, int nb, int dtype,
                                     float scale, void* stream) {
  if (S <= 0 || KV <= 0 || nb <= 0 || H % KV != 0) return kUnsupported;
  Args a{q, k_pages, v_pages,
         static_cast<const int32_t*>(block_tables),
         static_cast<const int32_t*>(lengths), out, S, KV, nb, scale,
         static_cast<cudaStream_t>(stream)};
  const int rep = H / KV;
  int rc;
  switch (dtype) {
    case 0: rc = dispatch_hd<float>(hd, rep, bs, a); break;
    case 1: rc = dispatch_hd<__nv_bfloat16>(hd, rep, bs, a); break;
    default: rc = kUnsupported;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
