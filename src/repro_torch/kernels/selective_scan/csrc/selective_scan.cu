// Selective scan (the mamba1 recurrence) forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan/kernel.py (_scan_kernel,
//           launched by selective_scan_fwd).
//
// What it computes: h_t = decay_t * h_{t-1} + bx_t and y_t = sum_n h_t[n] *
// c_t[n] over [B, S, D, N], with fp32 state and fp32 y [B, S, D], from an
// optional h0 [B, D, N] (zeros otherwise); it also writes h_final [B, D,
// N], which serving needs (the prompt's state at admission, one step a
// decode tick).  h_final may be h0 itself (each state of h0 is read once,
// before the same state of h_final is written, by the same thread), so a
// decode tick updates a slot's state in place; an optional write_ok [B]
// leaves the h_final rows of batches where it is 0 as they were (inactive
// slots).  Two input forms:
//
//   materialized (the Pallas kernel's contract): decay, bx [B, S, D, N] and
//     cs [B, S, N], fp32 or bf16;
//   fused (the model's path): dt [B, S, D] fp32 (after softplus), x [B, S,
//     D] (post-conv activations), A [D, N] fp32 (-exp(A_log)), Bs, Cs [B,
//     S, N], x/Bs/Cs fp32 or bf16; the kernel forms decay = expf(dt * A)
//     and bx = (dt * x) * B in registers, in the order of the reference's
//     ssm._mamba1_ssm_inputs (accurate expf: no fast math), one
//     exponential a (step, channel, state), once.
//
// What bounds it: at the 32k prefill ([1, 32768, 8192, 16], fused) the
// bytes are dt, x and y, S * D * (4 + 2 + 4) = 2.68 GB (0.80 ms at 3.35
// TB/s), and the exponentials, S * D * N = 4.29e9, take the special
// function units ~1.0 ms at 16 a clock an SM.  Around each exponential
// (accurate expf: 8 instructions, one of them on those units) a (step,
// channel, state) costs ~6 more issued instructions and 3/4 of a 16-byte
// shared-memory load, so the SMs' issue rate and shared-memory bandwidth,
// not the bytes, set the pace.  The materialized form would move 2 x 17.2
// GB of decay and bx instead, which is why the model uses the fused one.
// No tensor cores: the recurrence is elementwise, and the sum over states
// needs fp32 (tf32 keeps 10 bits).
//
// The design (v3), two instances:
//
//   chunked (S > 1, and the materialized form at any S): a lane keeps 2
//     states of one channel in registers and walks the sequence; the N / 2
//     lanes of a channel are adjacent, and a block of 32 channels stages
//     its inputs a chunk of 64 steps at a time.  The chunk's dt, x, Bs and
//     Cs rows (Bs and Cs shared by all the channels) land in shared memory
//     by cp.async (16-byte pieces where every row is 16-byte aligned), the
//     next chunk's while the current one is computed from, and are then
//     transposed once a block into fp32 rows of steps, dt * x formed there:
//     a lane brings 4 steps of an input with one 16-byte load.  A lane sums
//     its states' h * c a step in registers; every 16 steps the lanes of a
//     channel add those partial sums through a per-warp scratch (no
//     shuffle a step), and y leaves through a shared tile as 16-byte rows.
//     One exponential a (step, channel, state), once.  Steps past S are
//     staged as zeros (dt = 0: an identity step).  The materialized form
//     reads decay and bx from device memory in the same loop, the lanes of
//     a channel side by side.  Not parallel across time: at the 32k
//     prefill's batch of one, 65,536 lanes of 2 states give each SM the 16
//     warps its registers hold at 128 a thread, and a time-parallel form
//     (lanes over consecutive steps, composed by a warp scan) issued about
//     twice the instructions a (step, channel, state) and ran slower on the
//     card, and so did the chunk-parallel form across blocks (pieces of the
//     sequence from zero, a carry, the pieces again: two launches of this
//     instance, each exponential twice) (PERF.md).
//   step (the fused form at S = 1, a decode tick): one thread per (batch,
//     channel, 4 states): 16-byte loads of h and A, y from the channel's
//     N / 4 lanes by shuffles, a 16-byte store of h unless write_ok is 0.
//
// C entry point repro_selective_scan(...) launches on the given stream and
// returns cudaGetLastError() (0 on success), or -1 for a shape, type or
// instance it does not support; the Python wrapper raises on any non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kStepThreads = 256;
constexpr int kUnsupported = -1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// in0..in4: fused dt, x, A, Bs, Cs; materialized decay, bx, cs (in3, in4 unused)
struct Args {
  const void* in0;
  const void* in1;
  const void* in2;
  const void* in3;
  const void* in4;
  const float* h0;  // may be null: zeros
  float* y;
  float* h_final;            // may alias h0
  const uint8_t* write_ok;   // may be null: every batch writes h_final
  int S;
  int D;
  // every row of every typed input starts on a 16-byte boundary: the chunk
  // is staged in 16-byte pieces; else element by element
  bool aligned;
};

// words a row of `cols` elements of T takes in a tile
template <typename T>
__host__ __device__ constexpr int row_words(int cols) { return cols * (int)sizeof(T) / 4; }

__device__ __forceinline__ void cp_async4(uint32_t* smem, const void* gmem, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(uint32_t* smem, const void* gmem, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stages rows t0 .. t0 + kRows - 1 (steps of batch row0 / S) of src [*, width]
// elements, columns c0 .. c0 + kCols - 1, into a [kRows, row_words<T>(kCols)]
// tile; rows past S and columns past width are zeros.  Aligned rows go in
// 16-byte pieces (the served shapes); others element by element: 4-byte
// cp.async of fp32, 2-byte loads of bf16.
template <typename T, int kCols, int kThr, int kRows>
__device__ __forceinline__ void stage_tile(uint32_t* tile, const T* src, int64_t row0, int t0,
                                           int S, int width, int c0, bool aligned) {
  constexpr int W = row_words<T>(kCols);
  if constexpr (W % 4 == 0) {
    if (aligned) {  // 16-byte pieces: a piece is all in or all out of a row
      constexpr int kPer = 16 / sizeof(T);  // elements a piece
      for (int k = threadIdx.x; k < kRows * W / 4; k += kThr) {
        const int t = k / (W / 4), j = k % (W / 4);
        const bool ok = t0 + t < S && c0 + j * kPer < width;
        const T* from = src + (row0 + t0 + t) * (int64_t)width + c0 + j * kPer;
        cp_async16(tile + t * W + 4 * j, ok ? from : src, ok);
      }
      return;
    }
  }
  for (int k = threadIdx.x; k < kRows * W; k += kThr) {
    const int t = k / W, j = k % W;
    uint32_t* dst = tile + t * W + j;
    const bool row_ok = t0 + t < S;
    const int64_t rowe = (row0 + t0 + t) * (int64_t)width;
    if constexpr (std::is_same<T, float>::value) {
      const bool ok = row_ok && c0 + j < width;
      cp_async4(dst, ok ? src + rowe + c0 + j : src, ok);
    } else {
      const int c = c0 + 2 * j;
      const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
      const uint32_t lo = (row_ok && c < width) ? h[rowe + c] : 0u;
      const uint32_t hi = (row_ok && c + 1 < width) ? h[rowe + c + 1] : 0u;
      *dst = lo | (hi << 16);
    }
  }
}

// The chunked instance: a lane keeps kS = 2 states of one channel and walks
// the chunk's steps; the N / 2 lanes of a channel are adjacent.  Shared
// memory, in words: the raw inputs of a chunk as they lie in device
// memory (one row a step; the next chunk's land there while the current one
// is computed from), the chunk transposed to fp32 rows of steps (dt and dt *
// x [kCh][kRow], Bs and Cs [N][kRow]: one 16-byte load brings a lane 4
// steps), the y tile [kT][kYRow] and each warp's scratch for the sums over
// states.  A block serves kCh = 32 adjacent channels.
constexpr int kT = 64;   // steps a chunk
constexpr int kL = 16;   // steps a lane walks between sums over states

template <bool kFused, typename T, int N>
struct ChunkLayout {
  static constexpr int kCh = 32;
  static constexpr int kS = 2;                   // states a lane
  static constexpr int kLanes = N / kS;          // lanes of a channel
  static constexpr int kCw = 32 / kLanes;        // channels a warp
  static constexpr int kWarps = kCh / kCw;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRow = kT + 4;            // 16-byte rows
  static constexpr int kYRow = kCh + 4;
  static constexpr int kGroup = kLanes < 4 ? 4 : kLanes;  // scratch offset a channel
  static constexpr int kRed = 32 * (kL + 4) + kCw * kGroup;  // a warp's scratch
  static constexpr int kDt = kFused ? kT * kCh : 0;
  static constexpr int kX = kFused ? kT * row_words<T>(kCh) : 0;
  static constexpr int kB = kFused ? kT * row_words<T>(N) : 0;
  static constexpr int kC = kT * row_words<T>(N);
  static constexpr int kStage = kDt + kX + kB + kC;
  static constexpr int kDtT = kFused ? kCh * kRow : 0;
  static constexpr int kBT = kFused ? N * kRow : 0;
  static constexpr int kCT = N * kRow;
  static constexpr int kWords = kStage + 2 * kDtT + kBT + kCT + kT * kYRow + kWarps * kRed;
  static constexpr int kBytes = 4 * kWords;
};

// Element j of row t of a raw [*, W words] tile of T, as float.
template <typename T, int W>
__device__ __forceinline__ float raw_at(const uint32_t* tile, int t, int j) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(tile[t * W + j]);
  } else {
    const uint32_t w = tile[t * W + (j >> 1)];
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <bool kFused, typename T, int N>
__global__ void __launch_bounds__(ChunkLayout<kFused, T, N>::kThreads, 2)
selective_scan_kernel(Args args) {
  using L = ChunkLayout<kFused, T, N>;
  constexpr int kThr = L::kThreads;
  constexpr int kCh = L::kCh, kLanes = L::kLanes, kRow = L::kRow, kS = L::kS;
  constexpr int WX = row_words<T>(kCh), WN = row_words<T>(N);
  extern __shared__ __align__(16) uint32_t smem[];
  float* s_dtT = reinterpret_cast<float*>(smem + L::kStage);
  float* s_dtxT = s_dtT + L::kDtT;
  float* s_bT = s_dtxT + L::kDtT;
  float* s_cT = s_bT + L::kBT;
  float* s_y = s_cT + L::kCT;
  float* s_red = s_y + kT * L::kYRow;

  const int S = args.S, D = args.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane % kLanes;             // this lane's place in its channel
  const int n0 = kS * j;                   // its first state
  const int cl = lane / kLanes;            // its channel in the warp
  const int ch = warp * L::kCw + cl;       // its channel in the block
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + ch;
  const bool live = d < D;
  const bool warp_live = d0 + warp * L::kCw < D;
  const int64_t row0 = (int64_t)b * S;  // first (batch, step) row of this batch
  const bool aligned = args.aligned;

  const float* dt_g = static_cast<const float*>(args.in0);
  const T* x_g = static_cast<const T*>(args.in1);
  const float* a_g = static_cast<const float*>(args.in2);
  const T* b_g = static_cast<const T*>(args.in3);
  const T* c_g = static_cast<const T*>(kFused ? args.in4 : args.in2);
  const T* decay_g = static_cast<const T*>(args.in0);
  const T* bx_g = static_cast<const T*>(args.in1);

  // the lane's states of h0 are read here, before the same thread writes
  // them to h_final (which may be h0) at the end
  const int64_t st = ((int64_t)b * D + d) * N + n0;
  float h[kS], a[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    h[k] = (live && args.h0 != nullptr) ? args.h0[st + k] : 0.f;
    a[k] = 0.f;
    if constexpr (kFused) a[k] = live ? a_g[(int64_t)d * N + n0 + k] : 0.f;
  }
  // read before the loop (v2: read after it, ptxas scheduled the loop worse)
  const bool store = live && (args.write_ok == nullptr || args.write_ok[b]);

  auto stage = [&](int c) {
    const int t0 = c * kT;
    if constexpr (kFused) {
      stage_tile<float, kCh, kThr, kT>(smem, dt_g, row0, t0, S, D, d0, aligned);
      stage_tile<T, kCh, kThr, kT>(smem + L::kDt, x_g, row0, t0, S, D, d0, aligned);
      stage_tile<T, N, kThr, kT>(smem + L::kDt + L::kX, b_g, row0, t0, S, N, 0, aligned);
    }
    stage_tile<T, N, kThr, kT>(smem + L::kDt + L::kX + L::kB, c_g, row0, t0, S, N, 0,
                                      aligned);
    cp_async_commit();
  };

  // y of chunk c, from the y tile, as 16-byte rows where they fit
  auto write_out = [&](int c) {
    const int t0 = c * kT;
    for (int k = threadIdx.x; k < kT * kCh / 4; k += kThr) {
      const int t = k / (kCh / 4), i = 4 * (k % (kCh / 4));
      if (t0 + t >= S) continue;
      const float4 v = ld4(s_y + t * L::kYRow + i);
      float* to = args.y + (row0 + t0 + t) * D + d0 + i;
      if (d0 + i + 4 <= D && (reinterpret_cast<uintptr_t>(to) & 15) == 0) {
        *reinterpret_cast<float4*>(to) = v;
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
        for (int q = 0; q < 4 && d0 + i + q < D; ++q) to[q] = e[q];
      }
    }
  };

  // this lane's rows of the transposed tiles; its scratch row, and the rows
  // of its channel (a channel's rows kGroup words further, so the lanes'
  // reads of one column fall in distinct banks)
  const float* dt_r = s_dtT + ch * kRow;
  const float* dtx_r = s_dtxT + ch * kRow;
  const float* b_r = s_bT + n0 * kRow;
  const float* c_r = s_cT + n0 * kRow;
  float* red = s_red + warp * L::kRed + cl * (kLanes * (kL + 4) + L::kGroup);
  float* red_w = red + j * (kL + 4);

  const int n_chunks = (S + kT - 1) / kT;
  stage(0);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c staged; chunk c - 1 computed (its tiles free, its y whole)
    if (c > 0) write_out(c - 1);
    const int t0 = c * kT;
    // transpose the chunk to fp32 rows of steps (dt * x formed once here)
    if constexpr (kFused) {
      for (int k = threadIdx.x; k < kT * kCh; k += kThr) {
        const int t = k / kCh, i = k % kCh;
        const float dtv = __uint_as_float(smem[t * kCh + i]);
        s_dtT[i * kRow + t] = dtv;
        s_dtxT[i * kRow + t] = dtv * raw_at<T, WX>(smem + L::kDt, t, i);
      }
      for (int k = threadIdx.x; k < kT * N; k += kThr) {
        const int t = k / N, i = k % N;
        s_bT[i * kRow + t] = raw_at<T, WN>(smem + L::kDt + L::kX, t, i);
      }
    }
    for (int k = threadIdx.x; k < kT * N; k += kThr) {
      const int t = k / N, i = k % N;
      s_cT[i * kRow + t] = raw_at<T, WN>(smem + L::kDt + L::kX + L::kB, t, i);
    }
    __syncthreads();  // the tiles are whole, the raw inputs and the y tile free
    if (c + 1 < n_chunks) stage(c + 1);
    if (warp_live) {
#pragma unroll 1
      for (int s0 = 0; s0 < kT; s0 += kL) {
        float yp[kL];  // sum of h_t * c_t over this lane's states
#pragma unroll
        for (int q = 0; q < kL; q += 4) {
          float dec[kS][4], bxv[kS][4], cv[kS][4];
#pragma unroll
          for (int k = 0; k < kS; ++k) {
            const float4 c4 = ld4(c_r + k * kRow + s0 + q);
            cv[k][0] = c4.x, cv[k][1] = c4.y, cv[k][2] = c4.z, cv[k][3] = c4.w;
          }
          if constexpr (kFused) {
            const float4 t4 = ld4(dt_r + s0 + q), x4 = ld4(dtx_r + s0 + q);
            const float dtv[4] = {t4.x, t4.y, t4.z, t4.w};
            const float dtx[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int k = 0; k < kS; ++k) {
              const float4 b4 = ld4(b_r + k * kRow + s0 + q);
              const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                dec[k][e] = expf(dtv[e] * a[k]);
                bxv[k][e] = dtx[e] * bv[e];
              }
            }
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = t0 + s0 + q + e;
              const int64_t g = ((row0 + t) * D + d) * N + n0;
#pragma unroll
              for (int k = 0; k < kS; ++k) {
                const bool ok = live && t < S;
                dec[k][e] = ok ? to_float(decay_g[g + k]) : 1.f;
                bxv[k][e] = ok ? to_float(bx_g[g + k]) : 0.f;
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < kS; ++k) {
              h[k] = fmaf(dec[k][e], h[k], bxv[k][e]);
              acc = fmaf(h[k], cv[k][e], acc);
            }
            yp[q + e] = acc;
          }
        }
        // y_t = the sum of yp_t over the channel's lanes: through the warp's
        // scratch, each lane summing kL / kLanes steps of its channel
#pragma unroll
        for (int q = 0; q < kL; q += 4) {
          *reinterpret_cast<float4*>(red_w + q) = make_float4(yp[q], yp[q + 1], yp[q + 2],
                                                              yp[q + 3]);
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < kL / kLanes; ++r) {
          const int step = j + r * kLanes;
          float part[4] = {0.f, 0.f, 0.f, 0.f};  // a short tree, not one long chain
#pragma unroll
          for (int m = 0; m < kLanes; ++m) part[m % 4] += red[m * (kL + 4) + step];
          s_y[(s0 + step) * L::kYRow + ch] = (part[0] + part[1]) + (part[2] + part[3]);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  write_out(n_chunks - 1);
  if (store) {
#pragma unroll
    for (int k = 0; k < kS; ++k) args.h_final[st + k] = h[k];
  }
}

template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kStepThreads) selective_scan_step_kernel(Args args, int B) {
  constexpr int kLanes = N / 4;  // threads of one channel, adjacent lanes
  const int D = args.D;
  const int64_t i = (int64_t)blockIdx.x * kStepThreads + threadIdx.x;
  const bool live = i < (int64_t)B * D * kLanes;
  const int64_t bd = live ? i / kLanes : 0;  // (batch, channel); S = 1
  const int n0 = (int)(i % kLanes) * 4;
  const int b = (int)(bd / D), d = (int)(bd % D);
  const float* dt_g = static_cast<const float*>(args.in0);
  const T* x_g = static_cast<const T*>(args.in1);
  const float* a_g = static_cast<const float*>(args.in2);
  const T* b_g = static_cast<const T*>(args.in3);
  const T* c_g = static_cast<const T*>(args.in4);
  const bool store = live && (args.write_ok == nullptr || args.write_ok[b]);

  float h[4] = {0.f, 0.f, 0.f, 0.f}, a[4], bv[4], cv[4];
  const int64_t st = bd * N + n0;
  if constexpr (kVec) {
    const float4 a4 = *reinterpret_cast<const float4*>(a_g + (int64_t)d * N + n0);
    a[0] = a4.x, a[1] = a4.y, a[2] = a4.z, a[3] = a4.w;
    if (args.h0 != nullptr) {
      const float4 h4 = *reinterpret_cast<const float4*>(args.h0 + st);
      h[0] = h4.x, h[1] = h4.y, h[2] = h4.z, h[3] = h4.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = a_g[(int64_t)d * N + n0 + k];
      if (args.h0 != nullptr) h[k] = args.h0[st + k];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bv[k] = to_float(b_g[(int64_t)b * N + n0 + k]);
    cv[k] = to_float(c_g[(int64_t)b * N + n0 + k]);
  }
  const float dtv = dt_g[bd];
  const float dtx = dtv * to_float(x_g[bd]);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h[k] = fmaf(expf(dtv * a[k]), h[k], dtx * bv[k]);
    acc = fmaf(h[k], cv[k], acc);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && n0 == 0) args.y[bd] = acc;
  if (store) {
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(args.h_final + st) = make_float4(h[0], h[1], h[2], h[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) args.h_final[st + k] = h[k];
    }
  }
}

template <bool kFused, typename T, int N>
int launch_chunked(const Args& args, int B, cudaStream_t stream) {
  using L = ChunkLayout<kFused, T, N>;
  // above 48 KB of dynamic shared memory (fp32 inputs) a kernel launches
  // only after this attribute (set on the stream's device)
  const cudaError_t e = cudaFuncSetAttribute(selective_scan_kernel<kFused, T, N>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((args.D + L::kCh - 1) / L::kCh, B);
  selective_scan_kernel<kFused, T, N><<<grid, L::kThreads, L::kBytes, stream>>>(args);
  return 0;
}

template <typename T, int N>
int launch_step(const Args& args, int B, cudaStream_t stream) {
  const int64_t threads = (int64_t)B * args.D * (N / 4);
  const int blocks = (int)((threads + kStepThreads - 1) / kStepThreads);
  const auto at = [](const void* p, int bytes) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const bool vec = at(args.in2, 16) && at(args.h0, 16) && at(args.h_final, 16);
  if (vec) {
    selective_scan_step_kernel<T, N, true><<<blocks, kStepThreads, 0, stream>>>(args, B);
  } else {
    selective_scan_step_kernel<T, N, false><<<blocks, kStepThreads, 0, stream>>>(args, B);
  }
  return 0;
}

template <bool kFused, typename T, int N>
int dispatch_instance(const Args& args, int B, int step, cudaStream_t stream) {
  if (!step) return launch_chunked<kFused, T, N>(args, B, stream);
  if constexpr (kFused) {
    if (args.S == 1) return launch_step<T, N>(args, B, stream);
  }
  return kUnsupported;
}

template <bool kFused, typename T>
int dispatch_n(const Args& args, int B, int N, int step, cudaStream_t stream) {
  switch (N) {
    case 4: return dispatch_instance<kFused, T, 4>(args, B, step, stream);
    case 8: return dispatch_instance<kFused, T, 8>(args, B, step, stream);
    case 16: return dispatch_instance<kFused, T, 16>(args, B, step, stream);
    default: return kUnsupported;
  }
}

template <typename T>
int dispatch_form(int fused, const Args& args, int B, int N, int step, cudaStream_t stream) {
  return fused ? dispatch_n<true, T>(args, B, N, step, stream)
               : dispatch_n<false, T>(args, B, N, step, stream);
}

}  // namespace

// fused: 1 = (dt, x, A, Bs, Cs), 0 = (decay, bx, cs); dtype of the typed
// inputs (x, Bs, Cs or decay, bx, cs): 0 = float32, 1 = bfloat16; step: 1
// launches the one-step instance (fused, S = 1 only), 0 the chunked one
// (the wrapper chooses).  Every
// array is contiguous; h0 may be null; h_final may be h0; write_ok [B] may
// be null; N in {4, 8, 16}; B <= 65535.
extern "C" int repro_selective_scan(int fused, int dtype, int step, int B, int S, int D,
                                    int N,
                                    const void* in0, const void* in1, const void* in2,
                                    const void* in3, const void* in4, const float* h0,
                                    float* y, float* h_final, const uint8_t* write_ok,
                                    void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0) return kUnsupported;
  const auto at16 = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int esz = dtype == 0 ? 4 : 2;  // bytes of a typed element
  const bool rows16 = (D * esz) % 16 == 0 && (N * esz) % 16 == 0 && at16(in0) &&
                      at16(in1) && at16(in3) && at16(in4) && (fused || at16(in2));
  const Args args{in0, in1, in2, in3, in4, h0, y, h_final, write_ok, S, D, rows16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case 0: rc = dispatch_form<float>(fused, args, B, N, step, s); break;
    case 1: rc = dispatch_form<__nv_bfloat16>(fused, args, B, N, step, s); break;
    default: rc = kUnsupported;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
