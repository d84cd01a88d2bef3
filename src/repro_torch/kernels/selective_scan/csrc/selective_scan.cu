// Selective scan (the mamba1 recurrence) forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan/kernel.py (_scan_kernel,
//           launched by selective_scan_fwd).
//
// What it computes: h_t = decay_t * h_{t-1} + bx_t and y_t = sum_n h_t[n] *
// c_t[n] over [B, S, D, N], with fp32 state and fp32 y [B, S, D], from an
// optional h0 [B, D, N] (zeros otherwise); it also writes h_final [B, D,
// N], which serving needs (the prompt's state at admission, one step a
// decode tick).  h_final may be h0 itself (each thread reads its states of
// h0 once, before it writes the same states of h_final), so a decode tick
// updates a slot's state in place; an optional write_ok [B] leaves the
// h_final rows of batches where it is 0 as they were (inactive slots).
// Two input forms, two template instances of one body:
//
//   materialized (the Pallas kernel's contract): decay, bx [B, S, D, N] and
//     cs [B, S, N], fp32 or bf16;
//   fused (the model's path): dt [B, S, D] fp32 (after softplus), x [B, S,
//     D] (post-conv activations), A [D, N] fp32 (-exp(A_log)), Bs, Cs [B,
//     S, N], x/Bs/Cs fp32 or bf16; the kernel forms decay = expf(dt * A)
//     and bx = (dt * x) * B in registers, in the order of the reference's
//     ssm._mamba1_ssm_inputs (accurate expf: no fast math).
//
// What bounds it: at the 32k prefill ([1, 32768, 8192, 16], fused) the
// bytes are dt, x and y, S * D * (4 + 2 + 4) = 2.68 GB (0.80 ms at 3.35
// TB/s), and the exponentials, S * D * N = 4.29e9, take the special
// function units ~1.0 ms at 16 a clock an SM; the materialized form would
// move 2 x 17.2 GB of decay and bx instead, which is why the model uses the
// fused one.  The design: each thread holds kStates = 2 states of one
// channel d in registers and walks the whole sequence; the N / 2 threads
// of a channel are adjacent lanes and reduce y with shuffles.  The block's
// inputs of the next chunk of steps are loaded into registers while the
// current chunk is computed from shared memory, and y goes out through
// shared memory as coalesced rows.  A simple first kernel, bound by the
// latency of each step's chain (loads, expf, the multiply-adds, the
// shuffles), not by a rate: at batch 1, B * D * N / 2 = 65,536 threads
// fill a quarter of the card (fewer states a thread give more threads to
// hide that latency, but one more shuffle level a step for each halving);
// a sequence split into chunks with a carry pass is later work.  The
// Pallas kernel's padding of S (decay 1, bx 0) is not needed: the last
// chunk is cut short.
//
// C entry point repro_selective_scan(...) launches on the given stream and
// returns cudaGetLastError() (0 on success), or -1 for a shape or type it
// does not support; the Python wrapper raises on any non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStates = 2;         // states of one channel a thread holds
constexpr int kChunkElems = 1024;  // (step, channel) pairs a block stages a chunk
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
};

template <bool kFused, typename T, int N>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(Args args) {
  constexpr int kLanes = N / kStates;           // adjacent lanes of one channel
  constexpr int kDb = kThreads / kLanes;        // channels a block
  constexpr int kT = kChunkElems / kDb;         // steps a chunk
  constexpr int kPer = kChunkElems / kThreads;  // (step, channel) pairs a thread stages
  constexpr int kCn = kT * N;                   // (step, state) pairs of C (and B) a chunk
  constexpr int kPerC = (kCn + kThreads - 1) / kThreads;
  constexpr int kFusedElems = kFused ? kChunkElems : 1;
  constexpr int kFusedCn = kFused ? kCn : 1;

  __shared__ float s_dt[kFusedElems];
  __shared__ float s_x[kFusedElems];
  __shared__ float s_b[kFusedCn];
  __shared__ float s_c[kCn];
  __shared__ float s_y[kChunkElems];

  const int S = args.S, D = args.D;
  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kDb;
  const int dl = tid / kLanes;
  const int n0 = (tid % kLanes) * kStates;
  const int d = d0 + dl;
  const bool live = d < D;
  const int64_t row0 = (int64_t)blockIdx.y * S;  // first (batch, step) row of this batch

  const float* dt_g = static_cast<const float*>(args.in0);
  const T* x_g = static_cast<const T*>(args.in1);
  const float* a_g = static_cast<const float*>(args.in2);
  const T* b_g = static_cast<const T*>(args.in3);
  const T* c_g = static_cast<const T*>(kFused ? args.in4 : args.in2);
  const T* decay_g = static_cast<const T*>(args.in0);
  const T* bx_g = static_cast<const T*>(args.in1);

  float h[kStates], a[kStates];
  const int64_t state0 = ((int64_t)blockIdx.y * D + d) * N + n0;
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    h[i] = (live && args.h0 != nullptr) ? args.h0[state0 + i] : 0.f;
    a[i] = 0.f;
    if constexpr (kFused) a[i] = live ? a_g[(int64_t)d * N + n0 + i] : 0.f;
  }

  // the next chunk's inputs, loaded while the current one is computed
  float r_dt[kPer], r_x[kPer], r_b[kPerC], r_c[kPerC];
  auto load = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kPerC; ++k) {
      const int i = tid + k * kThreads;
      const int t = t0 + i / N;
      const bool ok = i < kCn && t < S;
      const int64_t g = (row0 + t) * N + i % N;
      r_c[k] = ok ? to_float(c_g[g]) : 0.f;
      if constexpr (kFused) r_b[k] = ok ? to_float(b_g[g]) : 0.f;
    }
    if constexpr (kFused) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * kThreads;
        const int t = t0 + i / kDb, dd = d0 + i % kDb;
        const bool ok = t < S && dd < D;
        const int64_t g = (row0 + t) * D + dd;
        r_dt[k] = ok ? dt_g[g] : 0.f;
        r_x[k] = ok ? to_float(x_g[g]) : 0.f;
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int k = 0; k < kPerC; ++k) {
      const int i = tid + k * kThreads;
      if (i < kCn) {
        s_c[i] = r_c[k];
        if constexpr (kFused) s_b[i] = r_b[k];
      }
    }
    if constexpr (kFused) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        s_dt[tid + k * kThreads] = r_dt[k];
        s_x[tid + k * kThreads] = r_x[k];
      }
    }
  };

  // read before the loop: read after it, the same loop was scheduled worse
  // by ptxas and ran markedly slower at the 32k prefill's shape
  const bool store = live && (args.write_ok == nullptr || args.write_ok[blockIdx.y]);
  const int n_chunks = (S + kT - 1) / kT;
  load(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kT;
    stage();
    __syncthreads();
    if (c + 1 < n_chunks) load(t0 + kT);
    const int steps = min(kT, S - t0);
#pragma unroll 4
    for (int tl = 0; tl < steps; ++tl) {
      float dec[kStates], bxv[kStates];
      if constexpr (kFused) {
        const float dtv = s_dt[tl * kDb + dl];
        const float dtx = dtv * s_x[tl * kDb + dl];
#pragma unroll
        for (int i = 0; i < kStates; ++i) {
          dec[i] = expf(dtv * a[i]);
          bxv[i] = dtx * s_b[tl * N + n0 + i];
        }
      } else {
        const int64_t g = ((row0 + t0 + tl) * D + d) * N + n0;
#pragma unroll
        for (int i = 0; i < kStates; ++i) {
          dec[i] = live ? to_float(decay_g[g + i]) : 0.f;
          bxv[i] = live ? to_float(bx_g[g + i]) : 0.f;
        }
      }
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kStates; ++i) {
        h[i] = dec[i] * h[i] + bxv[i];
        acc += h[i] * s_c[tl * N + n0 + i];
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (n0 == 0) s_y[tl * kDb + dl] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      const int t = t0 + i / kDb, dd = d0 + i % kDb;
      if (t < S && dd < D) args.y[(row0 + t) * D + dd] = s_y[i];
    }
  }
  if (store) {
#pragma unroll
    for (int i = 0; i < kStates; ++i) args.h_final[state0 + i] = h[i];
  }
}

template <bool kFused, typename T, int N>
int launch(const Args& args, int B, cudaStream_t stream) {
  constexpr int kDb = kThreads / (N / kStates);
  const dim3 grid((args.D + kDb - 1) / kDb, B);
  selective_scan_kernel<kFused, T, N><<<grid, kThreads, 0, stream>>>(args);
  return 0;
}

template <bool kFused, typename T>
int dispatch_n(const Args& args, int B, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<kFused, T, 4>(args, B, stream);
    case 8: return launch<kFused, T, 8>(args, B, stream);
    case 16: return launch<kFused, T, 16>(args, B, stream);
    default: return kUnsupported;
  }
}

template <typename T>
int dispatch_form(int fused, const Args& args, int B, int N, cudaStream_t stream) {
  return fused ? dispatch_n<true, T>(args, B, N, stream)
               : dispatch_n<false, T>(args, B, N, stream);
}

}  // namespace

// fused: 1 = (dt, x, A, Bs, Cs), 0 = (decay, bx, cs); dtype of the typed
// inputs (x, Bs, Cs or decay, bx, cs): 0 = float32, 1 = bfloat16.  Every
// array is contiguous; h0 may be null; h_final may be h0; write_ok [B] may
// be null; N in {4, 8, 16}; B <= 65535.
extern "C" int repro_selective_scan(int fused, int dtype, int B, int S, int D, int N,
                                    const void* in0, const void* in1, const void* in2,
                                    const void* in3, const void* in4, const float* h0,
                                    float* y, float* h_final, const uint8_t* write_ok,
                                    void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0) return kUnsupported;
  const Args args{in0, in1, in2, in3, in4, h0, y, h_final, write_ok, S, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case 0: rc = dispatch_form<float>(fused, args, B, N, s); break;
    case 1: rc = dispatch_form<__nv_bfloat16>(fused, args, B, N, s); break;
    default: rc = kUnsupported;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
