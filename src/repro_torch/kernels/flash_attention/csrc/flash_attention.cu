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
// layer is ~8.8e12 flops against ~0.1 GB.  The design:
//
// - One CUDA block per (batch x kv head, q tile).  The rep query heads of
//   the GQA group that share a kv head are rows of the same tile (row r =
//   query (r / rep), head (r % rep)), so one K/V tile in shared memory
//   serves the whole group.  Causal q tiles are issued from the longest
//   key walk to the shortest, so the last wave is short.
// - Key tiles wholly above the causal diagonal, or wholly left of every
//   row's window (key < q_lo - window + 1), are never visited: a local
//   layer of window w costs O(S * w), not O(S^2).  Of the visited tiles,
//   only edge tiles (the diagonal, the window's left edge, the tile past
//   Skv) test visibility; a masked score takes a finite sentinel and its
//   probability is set to exactly 0.
// - bf16, warp-specialised (flash_wgmma_kernel): three warpgroups of 128
//   threads.  Warpgroup 0 is the producer: one thread loads the block's Q
//   tile once and streams K and V tiles into a two-stage ring by TMA
//   (cp.async.bulk.tensor, tensor maps made on the host for each launch),
//   each stage guarded by "full" mbarriers (TMA byte counts) and "empty"
//   mbarriers (one arrival per consumer warp).  Warpgroups 1 and 2 are the
//   consumers, 64 rows each (a 128-row tile); setmaxnreg gives them 240
//   registers a thread and the producer 24.  S = Q K^T is one chain of
//   wgmma.mma_async m64nBKk16 with Q and K read from shared memory and S
//   in fp32 registers; the online softmax runs in those registers (the
//   accumulator's row is 16 * warp + lane / 4, or + 8, so a row's max is
//   taken over the 4 lanes of a quad); P is rounded to bf16 and fed back
//   as the register A operand of O += P V (m64n{hd}k16, V read
//   transposed, MN-major, from shared memory), and O stays in registers
//   for the whole walk.  Within a warpgroup, Q K^T of tile t and P V of
//   tile t - 1 are issued together and the softmax of tile t runs while
//   that P V is on the tensor cores; O is rescaled by alpha only after the
//   P V before it has drained (wgmma.wait_group), and not at all when every
//   row of the warp kept its max (alpha == 1).  P is packed to bf16 only
//   once no product is in flight, so ptxas does not serialize the wgmmas.
// - GQA groups of any rep up to 7: a consumer warpgroup takes floor(64 /
//   rep) query positions, rep rows each (64 rows at rep 1, 2 and 4; 60 at
//   rep 5, 63 at rep 7), and a block twice that.  The rows past them are
//   dead: zero-filled in shared memory before Q arrives, masked out of the
//   softmax (no key is visible to them) and never stored.
// - TMA: q and out are read and written as [B, Sq, H, hd] in boxes of
//   (floor(64 / rep) positions, the rep heads of one kv head, 64 columns),
//   so a box holds a warpgroup's live rows in (position, head) order and
//   stops at the end of its own sequence; k and v as [B, Skv, KV, hd] in boxes of
//   (a key tile, one kv head, 64 columns).  TMA zero-fills rows past Sq or
//   Skv.  The output goes through the warpgroup's own Q tile in shared
//   memory (swizzled) and out by a TMA store, which clips rows past Sq.
// - Shared memory: tiles are loaded in the 128-byte swizzle as boxes of 64
//   columns where 64 divides hd, else in the 32-byte swizzle as boxes of
//   16 (hd 16: one box; hd 80: five, P V at n = 80), and the wgmma
//   descriptors use the same swizzle.  hd 256: Q 64 KB + 2 stages x (K +
//   V) of 64 keys, 192 KB; hd 128 and below: 128-key tiles (hd 80: 100 KB).
// - bf16 hd 8 and 12 (the smoke configs' heads) are less than one k16 step:
//   the wrapper zero-pads them to 16 (the scale stays hd^-0.5).
// - libcuda's cuTensorMapEncodeTiled is reached through
//   cudaGetDriverEntryPoint(ByVersion), so the build links no -lcuda.
// - fp32: CUDA cores only (no TF32), a 32-row tile (floor(32 / rep)
//   positions; the rows past them dead, as above) and 32-key tiles, the
//   accumulator in registers (ceil(hd * 32 / 256) floats a thread: one
//   column where hd divides 256, else a walk over the flattened tile, as
//   at hd 12 and 80).  It serves the parity checks and the fp32 smoke
//   configs (hd 8 to 256) on the card.
//
// Still simple: the two consumer warpgroups are not scheduled against each
// other (ping-pong on named barriers was slower on the card), one block
// walks one q tile (not persistent), and each block loads its own K/V
// tiles from L2 (no cluster multicast to the blocks of neighbouring q
// tiles, which would halve that traffic).
//
// C entry point repro_flash_attention(...) launches on the given stream
// and returns cudaGetLastError() (0 on success), or -1 for a shape or type
// it does not support, -2 when a tensor map cannot be made; the Python
// wrapper raises on any non-zero.

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // fp32 kernel
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kUnsupported = -1;
constexpr int kNoTensorMap = -2;

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
// bf16: warp-specialised wgmma kernel
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive once and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// One box from shared memory to a 4-D tensor map (rows outside it are clipped).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence/wait instructions around it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, and the swizzle of the tile (SW bytes: 128 or 32).
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t kLayout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (kLayout << 62);
}

// Byte offset of a tile element under the SW-byte swizzle that TMA and
// wgmma share: the 16-byte chunk index XOR the row's bits above it.
template <int SW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// wgmma.mma_async m64nNk16, bf16 in, fp32 accumulator d (N / 2 registers a
// thread).  _ss: A and B from shared memory, both K-major.  _rs: A from
// registers (4 a thread), B from shared memory MN-major (transposed).
// scale_d == 0 overwrites d instead of adding to it.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int HD, int REP>
struct WgTile {
  static constexpr int kM = 128;             // rows: 2 consumer warpgroups x 64
  static constexpr int kWgPos = 64 / REP;    // query positions a consumer warpgroup
  static constexpr int kLive = kWgPos * REP; // its live rows: the rest are dead
  static constexpr int kBQ = 2 * kWgPos;     // query positions a block
  static constexpr int kBK = HD == 256 ? 64 : 128;  // keys a tile
  static constexpr int kStages = 2;
  // swizzle span = bytes of a box row: 128 (64 columns) where they divide
  // the row, else 32 (16 columns, one k16 step): hd 16, and hd 80 in five
  // boxes.  A 128-byte box and a 32-byte one for hd 80 would need two
  // swizzles and two descriptor forms a tile; padding it to 128 columns
  // would cost 1.6x the products and the bytes.
  static constexpr int kSW = HD % 64 == 0 ? 128 : 32;
  static constexpr int kCols = kSW / 2;      // hd columns a box
  static constexpr int kChunks = HD / kCols;  // boxes a row of hd
  static constexpr uint32_t kQChunk = 64 * kSW;         // 64 rows of one box
  static constexpr uint32_t kQBox = kLive * kSW;        // bytes TMA moves a box of q or out
  static constexpr uint32_t kQWg = kChunks * kQChunk;   // a warpgroup's Q (then out) tile
  static constexpr uint32_t kKChunk = kBK * kSW;
  static constexpr uint32_t kKV = kChunks * kKChunk;    // one K or V tile
  static constexpr uint32_t kKOff = 2 * kQWg;
  static constexpr uint32_t kVOff = kKOff + kStages * kKV;
  static constexpr uint32_t kBarOff = kVOff + kStages * kKV;
  // barriers: q_full, then k_full, v_full, k_empty, v_empty a stage
  static constexpr uint32_t kBytes = kBarOff + 8 * (1 + 4 * kStages) + 1024;  // + alignment
  static_assert(HD % kCols == 0 && kCols % 16 == 0 && HD <= 256,
                "hd splits into boxes of k16 steps (and P V's n is at most 256)");
  static_assert(kBytes <= 227 * 1024, "shared memory of one block");
};

// One key tile's online softmax in a consumer thread's registers.  s[4 j +
// 2 r + e] is the score of row r (row0, row0 + 8) and key k0 + 8 j + 2 tq +
// e.  Updates the rows' running max m and this lane's share of their sums l,
// returns the factors alpha that rescale the rows of O, and leaves P =
// exp(S * scale - m) in s.  Edge tiles test each key: a masked score takes
// the finite sentinel and its probability is set to exactly 0.
// A dead row (live[r] false) sees no key; its thread takes the edge path.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge, int k0,
                                             const int (&qp)[2], const bool (&live)[2], int tq,
                                             float scale_log2, const Args& a) {
  uint32_t vis[2] = {0u, 0u};  // edge tiles: a bit a key of each row
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * j + 2 * tq + e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (live[r] && visible(qp[r], kp, a)) {
            vis[r] |= 1u << (2 * j + e);
          } else {
            s[4 * j + 2 * r + e] = kNegInf;
          }
        }
      }
    }
  }
  float mx[2] = {m[0], m[1]}, ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = ex2((m[r] - mx[r]) * scale_log2);
    m[r] = mx[r];
    ms[r] = mx[r] * scale_log2;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * r + e];
        x = ex2(fmaf(x, scale_log2, -ms[r]));
        if (edge && !((vis[r] >> (2 * j + e)) & 1u)) x = 0.f;
        sum[r] += x;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];  // the quad's sum: at the end
}

template <int HD, int REP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap o_map, Args a) {
  using C = WgTile<HD, REP>;
  constexpr int kBK = C::kBK, kSW = C::kSW, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles need 1024-byte aligned boxes
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + C::kBarOff;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8u * (1 + 3 * kStages + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const int b = blockIdx.x / a.KV, g = blockIdx.x % a.KV;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBQ;  // longest key walks first
  const int q_lo = a.q_offset + q0;
  const int q_hi = a.q_offset + min(q0 + C::kBQ, a.Sq) - 1;
  int t0, t1;
  key_tiles(q_lo, q_hi, kBK, a, t0, t1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (C::kLive < 64) {
    // the dead rows of each Q box (TMA fills only the live ones), zeroed
    // for the wgmma reads (async proxy) of Q K^T
    constexpr int kDead = (64 - C::kLive) * kSW / 16;  // 16-byte pieces a box
    for (int i = threadIdx.x; i < 2 * C::kChunks * kDead; i += kWgThreads) {
      *reinterpret_cast<uint4*>(smem + (i / kDead) * C::kQChunk + C::kQBox + 16 * (i % kDead)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full, 2 * C::kChunks * C::kQBox);
      for (int w = 0; w < 2; ++w) {
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(base + w * C::kQWg + c * C::kQChunk, &q_map, q_full, c * C::kCols, g * REP,
                   q0 + w * C::kWgPos, b);
        }
      }
      for (int t = t0; t < t1; ++t) {
        const int s = (t - t0) % kStages;
        const uint32_t parity = (((t - t0) / kStages) & 1) ^ 1;  // a fresh stage is empty
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), C::kKV);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(base + C::kKOff + s * C::kKV + c * C::kKChunk, &k_map, k_full(s),
                   c * C::kCols, g, t * kBK, b);
        }
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), C::kKV);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(base + C::kVOff + s * C::kKV + c * C::kKChunk, &v_map, v_full(s),
                   c * C::kCols, g, t * kBK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns tile rows [64 cw, 64 cw + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1, tq = lane % 4;
  const int row0 = 16 * (warp % 4) + lane / 4;  // this thread's rows: row0 and row0 + 8
  // the warpgroup's first position; row r is position r / REP of it
  const int wq_lo = q_lo + cw * C::kWgPos;
  const int qp[2] = {wq_lo + row0 / REP, wq_lo + (row0 + 8) / REP};
  const bool live[2] = {row0 < C::kLive, row0 + 8 < C::kLive};
  const bool dead = !(live[0] && live[1]);  // a thread with a dead row masks every tile
  // the warpgroup's real query positions decide which key tiles need a mask
  const int wq_hi = min(wq_lo + C::kWgPos - 1, a.q_offset + a.Sq - 1);
  const float scale_log2 = a.scale * 1.4426950408889634f;
  const uint32_t q_tile = base + cw * C::kQWg;
  auto edge = [&](int t) {
    const int k0 = t * kBK;
    return dead || !(k0 + kBK <= a.Skv && (!a.causal || k0 + kBK - 1 <= wq_lo) &&
                     (a.window <= 0 || wq_hi - k0 < a.window));
  };

  float o[HD / 2];
  float s_acc[kBK / 2];
  uint32_t p_frag[kBK / 4];  // P in bf16, the A operand of P V: slice kk is [4 kk, 4 kk + 4)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s_acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  // S = Q K^T (unscaled) of the tile in stage st, into s_acc
  auto qk = [&](int st) {
    const uint32_t k_tile = base + C::kKOff + st * C::kKV;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
      for (int kk = 0; kk < C::kCols / 16; ++kk) {
        wgmma_ss(s_acc, smem_desc<kSW>(q_tile + c * C::kQChunk + 32 * kk, 16, 8 * kSW),
                 smem_desc<kSW>(k_tile + c * C::kKChunk + 32 * kk, 16, 8 * kSW),
                 (c | kk) != 0);
      }
    }
  };
  // O = O * alpha, then O += P V of the tile in stage st
  auto rescale_pv = [&](int st) {
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
    const uint32_t v_tile = base + C::kVOff + st * C::kKV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_rs(o, p_frag + 4 * kk, smem_desc<kSW>(v_tile + kk * 16 * kSW, C::kKChunk, 8 * kSW),
               1);
    }
    wgmma_commit();
  };
  auto pack_p = [&] {
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) p_frag[i] = pack_bf16(s_acc[2 * i], s_acc[2 * i + 1]);
  };

  mbar_wait(q_full, 0);
  if (t0 < t1) {
    // the first tile: S, then P (O is still 0: its rescale is harmless)
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    qk(0);
    wgmma_commit();
    wgmma_wait<0>();
    pin(s_acc);
    if (lane == 0) mbar_arrive(k_empty(0));
    softmax_tile<kBK>(s_acc, m, l, alpha, edge(t0), t0 * kBK, qp, live, tq, scale_log2, a);
    pack_p();
  }
  // then a tile at a time: Q K^T of tile t and P V of tile t - 1 go to the
  // tensor cores together, and the softmax of tile t runs beside that P V.
  // P is packed only once no product is in flight.
  for (int t = t0 + 1; t < t1; ++t) {
    const int st = (t - t0) % kStages, sp = (t - 1 - t0) % kStages;
    mbar_wait(k_full(st), ((t - t0) / kStages) & 1);
    wgmma_fence();
    qk(st);
    wgmma_commit();
    mbar_wait(v_full(sp), ((t - 1 - t0) / kStages) & 1);
    rescale_pv(sp);
    wgmma_wait<1>();  // S of tile t is in
    pin(s_acc);
    if (lane == 0) mbar_arrive(k_empty(st));
    softmax_tile<kBK>(s_acc, m, l, alpha, edge(t), t * kBK, qp, live, tq, scale_log2, a);
    wgmma_wait<0>();  // P V of tile t - 1 has drained
    pin(o);
    pin(p_frag);
    if (lane == 0) mbar_arrive(v_empty(sp));
    pack_p();
  }
  if (t0 < t1) {  // P V of the last tile
    const int sl = (t1 - 1 - t0) % kStages;
    mbar_wait(v_full(sl), ((t1 - 1 - t0) / kStages) & 1);
    rescale_pv(sl);
    wgmma_wait<0>();
    pin(o);
  }

  // out = O / max(l, 1e-30), rounded to bf16 into this warpgroup's Q tile
  // (its last Q K^T has completed), then one TMA store a box
  const float inv0 = 1.f / fmaxf(quad_sum(l[0]), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l[1]), 1e-30f);
  unsigned char* out_tile = smem + cw * C::kQWg;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const uint32_t chunk = (col / C::kCols) * C::kQChunk;
    const uint32_t cb = 2 * (col % C::kCols);
    *reinterpret_cast<uint32_t*>(out_tile + chunk + swizzle<kSW>(row0 * kSW + cb)) =
        pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(out_tile + chunk + swizzle<kSW>((row0 + 8) * kSW + cb)) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // st.shared -> TMA
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  if (threadIdx.x % 128 == 0) {
    for (int c = 0; c < C::kChunks; ++c) {
      tma_store(&o_map, q_tile + c * C::kQChunk, c * C::kCols, g * REP, q0 + cw * C::kWgPos, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

template <int HD, int REP>
struct F32Tile {
  static constexpr int kM = 32;
  static constexpr int kBQ = kM / REP;       // query positions a block
  static constexpr int kLive = kBQ * REP;    // live rows: the rest are dead
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
  constexpr int kLive = C::kLive;
  // A thread owns entries tid + kThreads * i of the flattened kM x HD
  // tile.  Where HD divides kThreads they share one column, kRowStep rows
  // apart; otherwise (hd 12, 80) the walk crosses columns, and where kM * HD
  // is not a multiple of kThreads (hd 12) the last entry of some threads is
  // past the tile: it repeats the tile's last entry and is not stored.
  constexpr int kEntries = kM * HD;
  constexpr int kAcc = (kEntries + kThreads - 1) / kThreads;  // accumulator entries a thread
  constexpr bool kOneCol = kThreads % HD == 0;
  constexpr int kRowStep = kOneCol ? kThreads / HD : 0;
  static_assert(HD % 4 == 0, "rows are read in 16-byte vectors");
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

  // dead rows (position kBQ) are zero-filled
  load_tile<float, HD, HD, kM, REP>(q_s, q, q_pos_stride, min(a.Sq - q0, kBQ));
  if (tid < kM) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  int row[kAcc], col[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = min(tid + kThreads * i, kEntries - 1);
    row[i] = kOneCol ? tid / HD + kRowStep * i : e / HD;
    col[i] = kOneCol ? tid % HD : e % HD;
  }
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
      const bool vis = r < kLive && visible(q_lo + r / REP, k0 + lane, a);
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

    // acc = acc * alpha + P V over this thread's entries
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha_s[row[i]];
    for (int j = 0; j < kBK; ++j) {
      const float* vj = v_s + j * HD;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += s_s[row[i] * kLds + j] * vj[col[i]];
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(a.out) + ((int64_t)b * a.Sq + q0) * q_pos_stride +
               (int64_t)g * REP * HD;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = row[i];
    const int pos = r / REP, h = r % REP;
    if (tid + kThreads * i < kEntries && r < kLive && q0 + pos < a.Sq) {
      out[pos * q_pos_stride + h * HD + col[i]] = acc[i] / fmaxf(l_s[r], 1e-30f);
    }
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor [d3, d2, d1, d0] (d0 innermost, contiguous) cut into boxes
// of [1, box2, box1, box0] elements, in the given swizzle.
bool tensor_map(CUtensorMap* map, const void* ptr, int d0, int d1, int d2, int d3, int box0,
                int box1, int box2, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2,
                                 (cuuint64_t)d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)box1, (cuuint32_t)box2, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q and out [B, Sq, H, hd] in boxes of (floor(64 / rep) positions, the rep
// heads of one kv head, one box of hd columns); k and v [B, Skv, KV, hd] in boxes of
// (BK keys, one kv head, one box of hd columns).
template <int HD, int REP>
int launch_bf16(int B, const Args& a, cudaStream_t stream) {
  using C = WgTile<HD, REP>;
  const int q_tiles = (a.Sq + C::kBQ - 1) / C::kBQ;
  if (q_tiles > 65535) return kUnsupported;
  const CUtensorMapSwizzle sw = C::kSW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!tensor_map(&q_map, a.q, HD, a.H, a.Sq, B, C::kCols, REP, C::kWgPos, sw) ||
      !tensor_map(&k_map, a.k, HD, a.KV, a.Skv, B, C::kCols, 1, C::kBK, sw) ||
      !tensor_map(&v_map, a.v, HD, a.KV, a.Skv, B, C::kCols, 1, C::kBK, sw) ||
      !tensor_map(&o_map, a.out, HD, a.H, a.Sq, B, C::kCols, REP, C::kWgPos, sw)) {
    return kNoTensorMap;
  }
  auto kernel = flash_wgmma_kernel<HD, REP>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(B * a.KV, q_tiles), kWgThreads, C::kBytes, stream>>>(q_map, k_map, v_map, o_map,
                                                                     a);
  return 0;
}

template <int HD, int REP>
int launch(int dtype, int B, const Args& a, cudaStream_t stream) {
  if (dtype == 1) {
    // below hd 16 a row is less than one k16 step of wgmma: the wrapper
    // pads bf16 hd 8 and 12 to 16 before it gets here
    if constexpr (HD % 16 == 0) return launch_bf16<HD, REP>(B, a, stream);
    return kUnsupported;
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
    case 5: return launch<HD, 5>(dtype, B, a, stream);
    case 7: return launch<HD, 7>(dtype, B, a, stream);
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
    case 8: rc = dispatch_rep<8>(rep, dtype, B, a, s); break;
    case 12: rc = dispatch_rep<12>(rep, dtype, B, a, s); break;
    case 16: rc = dispatch_rep<16>(rep, dtype, B, a, s); break;
    case 64: rc = dispatch_rep<64>(rep, dtype, B, a, s); break;
    case 80: rc = dispatch_rep<80>(rep, dtype, B, a, s); break;
    case 128: rc = dispatch_rep<128>(rep, dtype, B, a, s); break;
    case 256: rc = dispatch_rep<256>(rep, dtype, B, a, s); break;
    default: rc = kUnsupported;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
