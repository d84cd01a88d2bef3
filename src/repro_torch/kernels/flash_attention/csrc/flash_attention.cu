// Flash attention forward for Hopper (sm_90a): causal / sliding-window /
// bidirectional GQA attention with an online softmax over key tiles.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py (_fa_kernel,
//           launched by flash_attention_fwd).
//
// What it computes (the Pallas kernel's contract):
//   q [B, Sq, H, hd]; k, v [B, Skv, KV, hd], contiguous, one type (fp32 or
//   bf16) -> out [B, Sq, H, hd] in q's type, rep = H / KV.  Query i sits at
//   position q_offset + i, key j at position j; key j is visible to query i
//   when j < Skv, (causal) q_pos >= j and (window > 0) q_pos - j < window.
//   Scores are (q . k) * hd^-0.5 in fp32; the running max m, sum l and the
//   accumulator are fp32; the output is acc / max(l, 1e-30).  A masked
//   score contributes exactly 0 (never NaN): a row with no visible key,
//   such as a padded query row, writes 0.
//
// What bounds it: at the served lengths, tensor-core operations.  A
// (query, key) pair costs 4 * hd flops (q.k and p.v); bytes are q, k, v
// read once and out written once.  At 32k tokens, hd 256, a causal global
// layer is ~8.9e12 flops against ~0.1 GB.  The design:
//
// - One CUDA block per (q tile, batch x kv head).  The rep query heads of
//   the GQA group that share a kv head are rows of the same tile (row r =
//   query (r / rep), head (r % rep)), so one K/V tile in shared memory
//   serves the whole group.
// - Key tiles wholly above the causal diagonal, or wholly left of every
//   row's window (key < q_lo - window + 1), are never visited: a local
//   layer of window w costs O(S * w), not O(S^2).  Every visited row keeps
//   its diagonal key, so the result equals the full walk.
// - bf16: nvcuda::wmma m16n16k16 tensor-core products with fp32
//   accumulation, 8 warps, a 64-row tile and 64-key tiles.  Each warp
//   keeps its rows of Q and its share of the fp32 accumulator [64, hd] in
//   registers for the whole walk; the per-row rescale by alpha runs on
//   the fragments through their element -> row map, read once at start
//   (wmma leaves that layout unspecified).  S = Q K^T goes through shared
//   memory to the softmax (a warp per 8 rows, shuffle reductions); P is
//   rounded to bf16 for P V.  The next K/V tile streams in by cp.async
//   (two buffers) while the current one is computed.  hd 256 needs ~192
//   KB of dynamic shared memory: one block an SM.
// - fp32: CUDA cores only (no TF32), a 32-row tile and 32-key tiles, the
//   accumulator in registers (hd * 32 / 256 floats a thread).
//
// Still simple: no TMA, no wgmma, no warp specialization; those are for
// later work.
//
// C entry point repro_flash_attention(...) launches on the given stream
// and returns cudaGetLastError() (0 on success), or -1 for a shape or type
// it does not support; the Python wrapper raises on any non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kUnsupported = -1;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Skv, H, KV;
  int causal;  // 0 or 1
  int window;  // <= 0: no window
  int q_offset;
  float scale;
};

__device__ __forceinline__ bool visible(int qp, int kp, const Args& a) {
  return kp < a.Skv && (!a.causal || qp >= kp) && (a.window <= 0 || qp - kp < a.window);
}

// Key tiles [t0, t1) that hold a key visible to some query of positions
// [q_lo, q_hi]: nothing above the causal diagonal, nothing left of the
// first row's window.
__device__ __forceinline__ void key_tiles(int q_lo, int q_hi, int bk, const Args& a, int& t0,
                                          int& t1) {
  int k_end = a.Skv;
  if (a.causal && q_hi + 1 < k_end) k_end = q_hi + 1;
  int k_begin = 0;
  if (a.window > 0 && q_lo - a.window + 1 > 0) k_begin = q_lo - a.window + 1;
  t0 = k_begin / bk;
  t1 = k_end > 0 ? (k_end + bk - 1) / bk : 0;
  if (t1 < t0) t1 = t0;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy a tile of ROWS rows of HD elements from device memory into shared
// memory rows of stride LD (elements), in 16-byte vectors.  Tile row r is
// position r / R (stride pos_stride elements) and head r % R (stride HD);
// positions >= valid_pos are zero-filled.  T's 16-byte vector holds 16 /
// sizeof(T) elements; HD * sizeof(T) and LD * sizeof(T) are multiples of 16.
template <typename T, int HD, int LD, int ROWS, int R>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t pos_stride,
                                          int valid_pos) {
  constexpr int kN = 16 / sizeof(T);
  constexpr int kVec = HD / kN;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * kN;
    const int pos = r / R, h = r % R;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (pos < valid_pos) {
      val = *reinterpret_cast<const uint4*>(src + pos * pos_stride + h * HD + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// 16-byte asynchronous copy device -> shared memory; zero-fills when !valid
// (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// load_tile's contract, for bf16, issued as asynchronous copies.
template <int HD, int LD, int ROWS, int R>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int64_t pos_stride,
                                                int valid_pos) {
  constexpr int kVec = HD / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const int pos = r / R, h = r % R;
    const bool ok = pos < valid_pos;
    cp_async_16(dst + r * LD + c, ok ? src + pos * pos_stride + h * HD + c : src, ok);
  }
}

template <int HD, int REP>
struct Bf16Tile {
  static constexpr int kM = 64;           // rows: kBQ queries x REP heads
  static constexpr int kBQ = kM / REP;
  static constexpr int kBK = 64;          // keys a tile
  static constexpr int kLdq = HD + 8;     // bf16 rows of Q, K, V (skewed)
  static constexpr int kLds = kBK + 4;    // fp32 scores
  static constexpr int kLdp = kBK + 8;    // bf16 probabilities
  static constexpr size_t kKV = sizeof(bf16) * kBK * kLdq;  // one K or V tile
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(bf16) * kM * kLdq;  // two K buffers
  static constexpr size_t kV = kK + 2 * kKV;                     // two V buffers
  static constexpr size_t kS = kV + 2 * kKV;
  static constexpr size_t kP = kS + sizeof(float) * kM * kLds;
  static constexpr size_t kStat = kP + sizeof(bf16) * kM * kLdp;
  static constexpr size_t kBytes = kStat + sizeof(float) * 3 * kM;
};

template <int HD, int REP>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(Args a) {
  using C = Bf16Tile<HD, REP>;
  using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  constexpr int kM = C::kM, kBQ = C::kBQ, kBK = C::kBK;
  constexpr int kLdq = C::kLdq, kLds = C::kLds, kLdp = C::kLdp;
  constexpr int kAccN = AccFrag::num_elements;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + C::kQ);
  bf16* k_buf = reinterpret_cast<bf16*>(smem + C::kK);
  bf16* v_buf = reinterpret_cast<bf16*>(smem + C::kV);
  float* s_s = reinterpret_cast<float*>(smem + C::kS);
  bf16* p_s = reinterpret_cast<bf16*>(smem + C::kP);
  float* m_s = reinterpret_cast<float*>(smem + C::kStat);
  float* l_s = m_s + kM;
  float* alpha_s = l_s + kM;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / a.KV, g = blockIdx.y % a.KV;
  const int64_t q_pos_stride = (int64_t)a.H * HD;
  const int64_t kv_pos_stride = (int64_t)a.KV * HD;
  const bf16* q = static_cast<const bf16*>(a.q) + ((int64_t)b * a.Sq + q0) * q_pos_stride +
                  (int64_t)g * REP * HD;
  const bf16* k = static_cast<const bf16*>(a.k) + (int64_t)b * a.Skv * kv_pos_stride +
                  (int64_t)g * HD;
  const bf16* v = static_cast<const bf16*>(a.v) + (int64_t)b * a.Skv * kv_pos_stride +
                  (int64_t)g * HD;
  const int q_lo = a.q_offset + q0;
  const int q_hi = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  int t0, t1;
  key_tiles(q_lo, q_hi, kBK, a, t0, t1);

  // the Q tile and the first K/V tile, in flight while the block sets up
  load_tile_async<HD, kLdq, kM, REP>(q_s, q, q_pos_stride, a.Sq - q0);
  if (t0 < t1) {
    const int k0 = t0 * kBK;
    load_tile_async<HD, kLdq, kBK, 1>(k_buf, k + k0 * kv_pos_stride, kv_pos_stride, a.Skv - k0);
    load_tile_async<HD, kLdq, kBK, 1>(v_buf, v + k0 * kv_pos_stride, kv_pos_stride, a.Skv - k0);
  }
  cp_async_commit();
  if (tid < kM) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // warp roles: S fragments (kSpw a warp, one row block), output
  // fragments (kFpw a warp, one row block, held in registers across the
  // key tiles), softmax rows (8 a warp)
  constexpr int kSCols = kBK / 16;
  constexpr int kSpw = (kM / 16) * kSCols / kWarps;
  constexpr int kOCols = HD / 16;
  constexpr int kOFrags = (kM / 16) * kOCols;
  constexpr int kFpw = kOFrags >= kWarps ? kOFrags / kWarps : 1;
  constexpr int kRowsPerWarp = kM / kWarps;
  static_assert(kSpw >= 1 && kSCols % kSpw == 0, "score fragments must split by warp");
  static_assert(kOCols % kFpw == 0, "a warp's output fragments share one row block");
  const int s_rb = (warp * kSpw) / kSCols;
  const bool owns_out = warp * kFpw < kOFrags;
  const int o_rb = (warp * kFpw) / kOCols;

  // The accumulator fragment's element -> row mapping is not specified by
  // wmma: read it once from a fragment loaded with each row's index, so the
  // per-row rescale by alpha can run on the fragments in registers.
  int row_of[kAccN];
  {
    float* blk = s_s + warp * 256;
    for (int e = lane; e < 256; e += 32) blk[e] = (float)(e / 16);
    __syncwarp();
    AccFrag map;
    wmma::load_matrix_sync(map, blk, 16, wmma::mem_row_major);
#pragma unroll
    for (int i = 0; i < kAccN; ++i) row_of[i] = (int)map.x[i];
    __syncwarp();
  }
  AccFrag acc[kFpw];
#pragma unroll
  for (int i = 0; i < kFpw; ++i) wmma::fill_fragment(acc[i], 0.f);
  AFrag qa[HD / 16];

  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kBK;
    const bf16* k_s = k_buf + ((t - t0) & 1) * (kBK * kLdq);
    const bf16* v_s = v_buf + ((t - t0) & 1) * (kBK * kLdq);
    cp_async_wait_all();  // this tile (and, first, Q) has landed for this thread
    __syncthreads();      // ... for every thread; the previous tile is no longer read
    if (t + 1 < t1) {     // the next tile streams in behind this one's math
      const int k1 = k0 + kBK;
      bf16* k_n = k_buf + ((t + 1 - t0) & 1) * (kBK * kLdq);
      bf16* v_n = v_buf + ((t + 1 - t0) & 1) * (kBK * kLdq);
      load_tile_async<HD, kLdq, kBK, 1>(k_n, k + k1 * kv_pos_stride, kv_pos_stride, a.Skv - k1);
      load_tile_async<HD, kLdq, kBK, 1>(v_n, v + k1 * kv_pos_stride, kv_pos_stride, a.Skv - k1);
    }
    cp_async_commit();
    if (t == t0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::load_matrix_sync(qa[kk], q_s + s_rb * 16 * kLdq + kk * 16, kLdq);
      }
    }

    // S = Q K^T (unscaled), fp32
    {
      AccFrag sacc[kSpw];
#pragma unroll
      for (int i = 0; i < kSpw; ++i) wmma::fill_fragment(sacc[i], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < kSpw; ++i) {
          const int cb = (warp * kSpw + i) % kSCols;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, k_s + cb * 16 * kLdq + kk * 16, kLdq);
          wmma::mma_sync(sacc[i], qa[kk], kb, sacc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kSpw; ++i) {
        const int cb = (warp * kSpw + i) % kSCols;
        wmma::store_matrix_sync(s_s + s_rb * 16 * kLds + cb * 16, sacc[i], kLds,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // online softmax, one warp per row: P = exp(S * scale - m) on visible keys
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qp = q_lo + r / REP;
      float sv[kBK / 32];
      bool vis[kBK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j) {
        const int c = lane + 32 * j;
        vis[j] = visible(qp, k0 + c, a);
        sv[j] = s_s[r * kLds + c] * a.scale;
        if (vis[j]) mx = fmaxf(mx, sv[j]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j) {
        const float p = vis[j] ? expf(sv[j] - m_new) : 0.f;
        sum += p;
        p_s[r * kLdp + lane + 32 * j] = __float2bfloat16_rn(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P V, on the fragments in registers
    if (owns_out) {
      AFrag pa[kBK / 16];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::load_matrix_sync(pa[kk], p_s + o_rb * 16 * kLdp + kk * 16, kLdp);
      }
      float alpha_r[kAccN];
#pragma unroll
      for (int i = 0; i < kAccN; ++i) alpha_r[i] = alpha_s[o_rb * 16 + row_of[i]];
#pragma unroll
      for (int f = 0; f < kFpw; ++f) {
        const int cb = (warp * kFpw + f) % kOCols;
#pragma unroll
        for (int i = 0; i < kAccN; ++i) acc[f].x[i] *= alpha_r[i];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
          wmma::load_matrix_sync(vb, v_s + kk * 16 * kLdq + cb * 16, kLdq);
          wmma::mma_sync(acc[f], pa[kk], vb, acc[f]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // S is free for the output staging; l is final

  // out = acc / max(l, 1e-30): each fragment through a per-warp 16 x 16
  // staging block, 8 bf16 (16 bytes) a store
  if (owns_out) {
    bf16* out = static_cast<bf16*>(a.out) + ((int64_t)b * a.Sq + q0) * q_pos_stride +
                (int64_t)g * REP * HD;
    float* blk = s_s + warp * 256;
    const int r = o_rb * 16 + lane / 2, half = (lane % 2) * 8;
    const int pos = r / REP, h = r % REP;
    const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int f = 0; f < kFpw; ++f) {
      const int cb = (warp * kFpw + f) % kOCols;
      wmma::store_matrix_sync(blk, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      if (q0 + pos < a.Sq) {
        uint4 pk;
        bf16* pv = reinterpret_cast<bf16*>(&pk);
#pragma unroll
        for (int e = 0; e < 8; ++e) pv[e] = __float2bfloat16_rn(blk[(lane / 2) * 16 + half + e] / den);
        *reinterpret_cast<uint4*>(out + pos * q_pos_stride + h * HD + cb * 16 + half) = pk;
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

template <int HD, int REP>
struct F32Tile {
  static constexpr int kM = 32;
  static constexpr int kBQ = kM / REP;
  static constexpr int kBK = 32;
  static constexpr int kLdk = HD + 1;  // a score thread reads a column of K
  static constexpr int kLds = kBK + 1;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(float) * kM * HD;
  static constexpr size_t kV = kK + sizeof(float) * kBK * kLdk;
  static constexpr size_t kS = kV + sizeof(float) * kBK * HD;
  static constexpr size_t kStat = kS + sizeof(float) * kM * kLds;
  static constexpr size_t kBytes = kStat + sizeof(float) * 3 * kM;
};

template <int HD, int REP>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(Args a) {
  using C = F32Tile<HD, REP>;
  constexpr int kM = C::kM, kBQ = C::kBQ, kBK = C::kBK, kLdk = C::kLdk, kLds = C::kLds;
  constexpr int kAcc = kM * HD / kThreads;  // accumulator entries a thread
  constexpr int kRowStep = kThreads / HD;   // rows between a thread's entries
  static_assert(kThreads % HD == 0 && kAcc >= 1, "a thread owns one column of the tile");
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + C::kQ);
  float* k_s = reinterpret_cast<float*>(smem + C::kK);
  float* v_s = reinterpret_cast<float*>(smem + C::kV);
  float* s_s = reinterpret_cast<float*>(smem + C::kS);
  float* m_s = reinterpret_cast<float*>(smem + C::kStat);
  float* l_s = m_s + kM;
  float* alpha_s = l_s + kM;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / a.KV, g = blockIdx.y % a.KV;
  const int64_t q_pos_stride = (int64_t)a.H * HD;
  const int64_t kv_pos_stride = (int64_t)a.KV * HD;
  const float* q = static_cast<const float*>(a.q) + ((int64_t)b * a.Sq + q0) * q_pos_stride +
                   (int64_t)g * REP * HD;
  const float* k = static_cast<const float*>(a.k) + (int64_t)b * a.Skv * kv_pos_stride +
                   (int64_t)g * HD;
  const float* v = static_cast<const float*>(a.v) + (int64_t)b * a.Skv * kv_pos_stride +
                   (int64_t)g * HD;

  load_tile<float, HD, HD, kM, REP>(q_s, q, q_pos_stride, a.Sq - q0);
  if (tid < kM) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int col = tid % HD, row0 = tid / HD;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int q_lo = a.q_offset + q0;
  const int q_hi = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  int t0, t1;
  key_tiles(q_lo, q_hi, kBK, a, t0, t1);

  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kBK;
    __syncthreads();
    // K rows are skewed (stride HD + 1): 16-byte loads, scalar stores
    for (int i = tid; i < kBK * (HD / 4); i += kThreads) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < a.Skv) kv = *reinterpret_cast<const float4*>(k + (k0 + r) * kv_pos_stride + c);
      float* dst = k_s + r * kLdk + c;
      dst[0] = kv.x;
      dst[1] = kv.y;
      dst[2] = kv.z;
      dst[3] = kv.w;
    }
    load_tile<float, HD, HD, kBK, 1>(v_s, v + k0 * kv_pos_stride, kv_pos_stride, a.Skv - k0);
    __syncthreads();

    // scores: thread (lane = key, warp = row group) computes kM / kWarps rows
    {
      float dot[kM / kWarps];
#pragma unroll
      for (int i = 0; i < kM / kWarps; ++i) dot[i] = 0.f;
      for (int d = 0; d < HD; ++d) {
        const float kd = k_s[lane * kLdk + d];
#pragma unroll
        for (int i = 0; i < kM / kWarps; ++i) dot[i] += q_s[(warp + kWarps * i) * HD + d] * kd;
      }
#pragma unroll
      for (int i = 0; i < kM / kWarps; ++i) s_s[(warp + kWarps * i) * kLds + lane] = dot[i];
    }
    __syncthreads();

    // online softmax, one warp per row, one key a lane; P overwrites S
    for (int rr = 0; rr < kM / kWarps; ++rr) {
      const int r = warp * (kM / kWarps) + rr;
      const bool vis = visible(q_lo + r / REP, k0 + lane, a);
      const float s = s_s[r * kLds + lane] * a.scale;
      const float mx = warp_max(vis ? s : kNegInf);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = vis ? expf(s - m_new) : 0.f;
      s_s[r * kLds + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over this thread's column
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha_s[row0 + kRowStep * i];
    for (int j = 0; j < kBK; ++j) {
      const float vj = v_s[j * HD + col];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += s_s[(row0 + kRowStep * i) * kLds + j] * vj;
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(a.out) + ((int64_t)b * a.Sq + q0) * q_pos_stride +
               (int64_t)g * REP * HD;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = row0 + kRowStep * i;
    const int pos = r / REP, h = r % REP;
    if (q0 + pos < a.Sq) out[pos * q_pos_stride + h * HD + col] = acc[i] / fmaxf(l_s[r], 1e-30f);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch_with_smem(Kernel kernel, size_t smem, int q_tiles, int batch_heads, const Args& a,
                     cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(q_tiles, batch_heads), kThreads, smem, stream>>>(a);
  return 0;
}

template <int HD, int REP>
int launch(int dtype, int B, const Args& a, cudaStream_t stream) {
  if (dtype == 1) {
    using C = Bf16Tile<HD, REP>;
    return launch_with_smem(flash_bf16_kernel<HD, REP>, C::kBytes,
                            (a.Sq + C::kBQ - 1) / C::kBQ, B * a.KV, a, stream);
  }
  using C = F32Tile<HD, REP>;
  return launch_with_smem(flash_f32_kernel<HD, REP>, C::kBytes, (a.Sq + C::kBQ - 1) / C::kBQ,
                          B * a.KV, a, stream);
}

template <int HD>
int dispatch_rep(int rep, int dtype, int B, const Args& a, cudaStream_t stream) {
  switch (rep) {
    case 1: return launch<HD, 1>(dtype, B, a, stream);
    case 2: return launch<HD, 2>(dtype, B, a, stream);
    case 4: return launch<HD, 4>(dtype, B, a, stream);
    default: return kUnsupported;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, Sq, H, hd] and k/v [B, Skv,
// KV, hd] are contiguous and 16-byte aligned, on the stream's device.
// window <= 0 means no window; causal is 0 or 1.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int Sq, int Skv, int H, int KV, int hd, int dtype,
                                     int causal, int window, int q_offset, float scale,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0) return kUnsupported;
  if (dtype != 0 && dtype != 1) return kUnsupported;
  Args a{q, k, v, out, Sq, Skv, H, KV, causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rep = H / KV;
  int rc;
  switch (hd) {
    case 16: rc = dispatch_rep<16>(rep, dtype, B, a, s); break;
    case 64: rc = dispatch_rep<64>(rep, dtype, B, a, s); break;
    case 128: rc = dispatch_rep<128>(rep, dtype, B, a, s); break;
    case 256: rc = dispatch_rep<256>(rep, dtype, B, a, s); break;
    default: rc = kUnsupported;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
