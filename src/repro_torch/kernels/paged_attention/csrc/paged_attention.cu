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
//   >= length get -1e30 before the max, as paged_kernel.py does (here they
//   are skipped: their weight exp(-1e30 - m) is an exact 0, and a skipped
//   position cannot bring a NaN of an unwritten row into the sum).
//
// What bounds it: device-memory bytes.  A decode step reads
//   sum_s lengths[s] * KV * hd * 2 (K and V) * sizeof(T)
// and does ~4 flops a byte read, far below the card's operations-per-byte
// balance; at the served lengths (<= 112 positions) one launch is too short
// for any rate, and the latency of its few dependent loads sets its time.
// No tensor cores: with one query a sequence and rep <= 7 query rows a KV
// head, an mma tile (16 or 64 rows) would be mostly padding, and the
// products are not what bounds the kernel.
//
// The design (v2):
//   * The positions are split across blocks: grid (S * KV, splits), a
//     split = pages_per_split table entries, both sized on the host from the
//     table's width nb alone (lengths stay on the device: no host sync).
//     A block whose split starts at or past cdiv(lengths[s], bs) writes an
//     empty partial (m = -1e30, l = 0) and exits.  With one split the block
//     writes the output; with more, it writes its (m, l, acc) partial to a
//     workspace and paged_attention_combine_kernel merges the partials by
//     the log-sum-exp rule.
//   * 16-byte loads: a K or V row of one position is hd * sizeof(T) bytes,
//     read by HD / (16 / sizeof(T)) adjacent lanes (8 at hd 64 bf16, so a
//     warp-wide load covers 4 positions); each lane keeps the REP query
//     rows' matching 16-byte slice in registers.  A row that is not a whole
//     number of 16-byte pieces takes 8-byte loads (bf16 hd 12: 3 lanes of
//     4 elements).  The reductions over a row's lanes are xor butterflies,
//     so a row takes a power of two of lanes: the count rounded up, and the
//     lanes past the row's own load nothing and hold zeros (hd 80: 10 of 16
//     lanes load at bf16, 20 of 32 at fp32; hd 12 fp32: 3 of 4).
//   * Warp-level scores and softmax: each of the block's 4 warps takes 16
//     positions at a time, 8 or 4 where a row takes 16 or 32 lanes (at most
//     4 loads of K and of V a lane, all issued before any is used, so that
//     a lane's rep x (16 / sizeof(T)) query slice, accumulator and scores
//     stay in registers up to rep 7, hd 128), scores
//     a position with a reduction over its row's lanes (3 shuffles at hd 64
//     bf16), and keeps its own online softmax (m, l, acc) in registers; the
//     rows of a warp merge by shuffles and the warps once in shared memory,
//     at the end.  No barrier a page: one after the block loads its split's
//     table entries into shared memory, one before the warps merge.
//
// C entry point repro_paged_attention(...) launches on the given stream
// and returns cudaGetLastError() (0 on success), or -1 for a shape, type
// or split it does not support; the Python wrapper raises on any non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 16;               // positions a warp takes an iteration (at most)
constexpr int kMaxPagesPerSplit = 32;    // table entries a block stages
constexpr int kCombineThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr int kUnsupported = -1;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// W 32-bit words: one load of 4 W bytes (16 or 8)
template <int W>
struct Words {
  uint32_t w[W];
};

template <int W>
__device__ __forceinline__ Words<W> load_words(const void* p) {
  Words<W> r;
  if constexpr (W == 4) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = u.x, r.w[1] = u.y, r.w[2] = u.z, r.w[3] = u.w;
  } else {
    static_assert(W == 2, "16- or 8-byte loads");
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = u.x, r.w[1] = u.y;
  }
  return r;
}

template <int W>
__device__ __forceinline__ Words<W> zero_words() {
  Words<W> r;
#pragma unroll
  for (int i = 0; i < W; ++i) r.w[i] = 0u;
  return r;
}

// The words of one load as floats (bf16: the low half of each word is the
// earlier element)
template <typename T, int W>
__device__ __forceinline__ void unpack(const Words<W>& u, float* f) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      f[i] = __uint_as_float(u.w[i]);
    } else {
      f[2 * i] = __uint_as_float(u.w[i] << 16);
      f[2 * i + 1] = __uint_as_float(u.w[i] & 0xffff0000u);
    }
  }
}

// The bytes of one lane's load: 16, or 8 where a row is no whole number of
// 16-byte pieces
template <typename T, int HD>
__host__ __device__ constexpr int load_bytes() {
  return (HD * (int)sizeof(T)) % 16 == 0 ? 16 : 8;
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// The length a block attends over: clamped to the table, as v1 did.
__device__ __forceinline__ int clamped_length(const int32_t* lengths, int s, int nb, int bs) {
  return min(max(lengths[s], 0), nb * bs);
}

template <typename T, int HD, int REP, int BS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,             // [S, KV*REP, HD]
                       const T* __restrict__ k_pages,       // [N, BS, KV, HD]
                       const T* __restrict__ v_pages,       // [N, BS, KV, HD]
                       const int32_t* __restrict__ tables,  // [S, nb]
                       const int32_t* __restrict__ lengths, // [S]
                       T* __restrict__ out,                 // [S, KV*REP, HD]
                       float* __restrict__ ws,              // partials (splits > 1)
                       int n_seq, int kv_heads, int nb, int pages_per_split, int splits,
                       float scale) {
  constexpr int kBytes = load_bytes<T, HD>();
  constexpr int kWords = kBytes / 4;
  constexpr int kVec = kBytes / sizeof(T);    // elements a load
  constexpr int kRowLanes = HD / kVec;        // lanes that load one position's row
  constexpr int kLanesPerRow = pow2_at_least(kRowLanes);  // lanes a row takes
  constexpr int kRows = 32 / kLanesPerRow;    // positions a warp-wide load covers
  // loads of K (and of V) a lane issues an iteration: at most 4, so that a
  // lane's query slice, accumulator and scores stay in registers up to rep
  // 7 at hd 128, and at least 1; kStep positions a warp an iteration (16 at
  // most, but 32 where one lane holds a row: bf16 hd 8)
  constexpr int kU = kGroup / kRows < 1 ? 1 : kGroup / kRows < 4 ? kGroup / kRows : 4;
  constexpr int kStep = kU * kRows;
  static_assert(HD % kVec == 0 && kLanesPerRow <= 32 && kU * kRows == kStep,
                "unsupported head dim");

  __shared__ int s_tab[kMaxPagesPerSplit];
  __shared__ float s_m[kWarps][REP];
  __shared__ float s_l[kWarps][REP];
  __shared__ float s_acc[kWarps][REP][HD];

  const int s = blockIdx.x / kv_heads;
  const int g = blockIdx.x % kv_heads;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane / kLanesPerRow;
  const int col = lane % kLanesPerRow;
  const bool loads = col < kRowLanes;  // a lane past the row's own holds zeros
  const int n_heads = kv_heads * REP;
  const int64_t head0 = (int64_t)s * n_heads + (int64_t)g * REP;  // this group's first head

  // partials: acc [S, H, splits, HD], then m and l [S, H, splits]
  float* ws_acc = ws;
  float* ws_m = ws + (int64_t)n_seq * n_heads * splits * HD;
  float* ws_l = ws_m + (int64_t)n_seq * n_heads * splits;

  const int length = clamped_length(lengths, s, nb, BS);
  const int live_pages = (length + BS - 1) / BS;
  const int page0 = split * pages_per_split;
  if (splits > 1 && page0 >= live_pages) {  // wholly past the length: an empty partial
    if (threadIdx.x < REP) {
      ws_m[(head0 + threadIdx.x) * splits + split] = kNegInf;
      ws_l[(head0 + threadIdx.x) * splits + split] = 0.f;
    }
    return;
  }
  const int pages = min(pages_per_split, live_pages - page0);
  for (int i = threadIdx.x; i < pages; i += kThreads) {
    s_tab[i] = tables[(int64_t)s * nb + page0 + i];
  }

  float qv[REP][kVec];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    unpack<T, kWords>(loads ? load_words<kWords>(q + (head0 + r) * HD + col * kVec)
                            : zero_words<kWords>(),
                      qv[r]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) qv[r][e] *= scale;
  }
  float m[REP], l[REP], acc[REP][kVec];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
  }
  __syncthreads();  // s_tab

  const int pos0 = page0 * BS;
  const int pos1 = min(length, pos0 + pages * BS);
  const int64_t row_stride = (int64_t)kv_heads * HD;  // one position of a page
  for (int base = pos0 + warp * kStep; base < pos1; base += kWarps * kStep) {
    Words<kWords> kr[kU], vr[kU];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int p = base + u * kRows + row;
      ok[u] = p < pos1;
      kr[u] = vr[u] = zero_words<kWords>();
      if (ok[u] && loads) {
        const int64_t phys = s_tab[p / BS - page0];
        const int64_t off = (phys * BS + p % BS) * row_stride + (int64_t)g * HD + col * kVec;
        kr[u] = load_words<kWords>(k_pages + off);
        vr[u] = load_words<kWords>(v_pages + off);
      }
    }
    float sc[kU][REP];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[kVec];
      unpack<T, kWords>(kr[u], kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) d = fmaf(qv[r][e], kf[e], d);
        sc[u][r] = d;
      }
    }
    // the row's lanes are adjacent: a butterfly over them leaves the full
    // score in each
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int r = 0; r < REP; ++r) sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], off);
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kU; ++u) mx = ok[u] ? fmaxf(mx, sc[u][r]) : mx;
      const float alpha = expf(m[r] - mx);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] *= alpha;
      m[r] = mx;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[kVec];
      unpack<T, kWords>(vr[u], vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = ok[u] ? expf(sc[u][r] - m[r]) : 0.f;
        l[r] += p;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }

  // merge the warp's rows (lanes kLanesPerRow apart hold the same columns)
#pragma unroll
  for (int off = kLanesPerRow; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mx = fmaxf(m[r], mo);
      const float a = expf(m[r] - mx), b = expf(mo - mx);
      l[r] = l[r] * a + lo * b;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * a + ao * b;
      }
      m[r] = mx;
    }
  }
  if (row == 0 && loads) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) s_acc[warp][r][col * kVec + e] = acc[r][e];
      if (col == 0) {
        s_m[warp][r] = m[r];
        s_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // merge the warps: one thread an accumulator entry of the GQA group
  for (int i = threadIdx.x; i < REP * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w][r] - mx);
      L = fmaf(s_l[w][r], c, L);
      A = fmaf(s_acc[w][r][d], c, A);
    }
    if (splits == 1) {
      out[(head0 + r) * HD + d] = from_float<T>(A / fmaxf(L, 1e-30f));
    } else {
      const int64_t part = (head0 + r) * splits + split;
      ws_acc[part * HD + d] = A;
      if (d == 0) {
        ws_m[part] = mx;
        ws_l[part] = L;
      }
    }
  }
}

// Merges the splits' partials of each (sequence, head, column) by the
// log-sum-exp rule, over the splits that hold a live position.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_attention_combine_kernel(const float* __restrict__ ws, const int32_t* __restrict__ lengths,
                               T* __restrict__ out, int n_seq, int n_heads, int hd, int nb,
                               int bs, int pages_per_split, int splits) {
  const int64_t total = (int64_t)n_seq * n_heads * hd;
  const int64_t i = (int64_t)blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t sh = i / hd;  // (sequence, head)
  const int d = (int)(i % hd);
  const int s = (int)(sh / n_heads);
  const float* ws_acc = ws;
  const float* ws_m = ws + (int64_t)n_seq * n_heads * splits * hd;
  const float* ws_l = ws_m + (int64_t)n_seq * n_heads * splits;
  const int live_pages = (clamped_length(lengths, s, nb, bs) + bs - 1) / bs;
  const int live = (live_pages + pages_per_split - 1) / pages_per_split;
  float mx = kNegInf;
  for (int j = 0; j < live; ++j) mx = fmaxf(mx, ws_m[sh * splits + j]);
  float L = 0.f, A = 0.f;
  for (int j = 0; j < live; ++j) {
    const float c = expf(ws_m[sh * splits + j] - mx);
    L = fmaf(ws_l[sh * splits + j], c, L);
    A = fmaf(ws_acc[(sh * splits + j) * hd + d], c, A);
  }
  out[i] = from_float<T>(A / fmaxf(L, 1e-30f));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* tables;
  const int32_t* lengths;
  void* out;
  float* ws;
  int S, KV, nb, pages_per_split, splits;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int REP, int BS>
int launch(const Args& a) {
  const dim3 grid(a.S * a.KV, a.splits);
  paged_attention_kernel<T, HD, REP, BS><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.tables, a.lengths, static_cast<T*>(a.out), a.ws, a.S, a.KV, a.nb, a.pages_per_split,
      a.splits, a.scale);
  if (a.splits > 1) {
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    const int64_t total = (int64_t)a.S * a.KV * REP * HD;
    const int blocks = (int)((total + kCombineThreads - 1) / kCombineThreads);
    paged_attention_combine_kernel<T><<<blocks, kCombineThreads, 0, a.stream>>>(
        a.ws, a.lengths, static_cast<T*>(a.out), a.S, a.KV * REP, HD, a.nb, BS,
        a.pages_per_split, a.splits);
  }
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
    case 5: return dispatch_bs<T, HD, 5>(bs, a);
    case 7: return dispatch_bs<T, HD, 7>(bs, a);
    default: return kUnsupported;
  }
}

template <typename T>
int dispatch_hd(int hd, int rep, int bs, const Args& a) {
  switch (hd) {
    case 8: return dispatch_rep<T, 8>(rep, bs, a);
    case 12: return dispatch_rep<T, 12>(rep, bs, a);
    case 16: return dispatch_rep<T, 16>(rep, bs, a);
    case 64: return dispatch_rep<T, 64>(rep, bs, a);
    case 80: return dispatch_rep<T, 80>(rep, bs, a);
    case 128: return dispatch_rep<T, 128>(rep, bs, a);
    default: return kUnsupported;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Tensors are contiguous, on the
// stream's device, q/k/v 16-byte aligned; block_tables and lengths are
// int32.  pages_per_split (1..32) table entries a block, splits =
// cdiv(nb, pages_per_split); with splits > 1, workspace holds S * H *
// splits * (hd + 2) floats (the partials), else it may be null.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages, const void* block_tables,
                                     const void* lengths, void* out, void* workspace, int S,
                                     int H, int KV, int hd, int bs, int nb, int dtype,
                                     int pages_per_split, int splits, float scale,
                                     void* stream) {
  if (S <= 0 || KV <= 0 || nb <= 0 || H % KV != 0) return kUnsupported;
  if (pages_per_split < 1 || pages_per_split > kMaxPagesPerSplit || splits > 65535 ||
      splits != (nb + pages_per_split - 1) / pages_per_split ||
      (splits > 1 && workspace == nullptr)) {
    return kUnsupported;
  }
  Args a{q, k_pages, v_pages,
         static_cast<const int32_t*>(block_tables),
         static_cast<const int32_t*>(lengths), out, static_cast<float*>(workspace),
         S, KV, nb, pages_per_split, splits, scale,
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
