// Flash attention for Hopper (sm_90a) with bf16 products on the tensor
// cores: the forward (out, lse) and the backward's delta, dq and dk/dv.
//
// Replaces, for bfloat16 inputs at head_dim 32, 64 and 128, the TPU kernels
// of neural_networks_parallel_training_with_mpi_tpu/ops/pallas_kernels.py
//   _flash_fwd_kernel      (:97,  reached by _flash_forward :171)
//   _flash_bwd_dq_kernel   (:255, reached by _flash_backward :347)
//   _flash_bwd_dkv_kernel  (:296, reached by _flash_backward :347)
// and the custom_vjp over them, flash_attention_with_lse (:445, B5), whose
// backward (:465-479) folds the lse cotangent into delta (:366-369).  They
// compute what the JAX kernels compute: scale 1/sqrt(D); mask modes none /
// causal (k <= q) / causal_exclusive (k < q); online softmax; lse in
// natural log; a row with no attendable key outputs 0 with lse -1e30 and
// gets gradient 0; dS = P (dP - delta) scale with delta = rowsum(dO * O) -
// g_lse (flash_delta.cuh).  The f32 kernels stay in csrc/flash_attention.cu;
// ops/flash_attention.py routes by dtype before any launch.
//
// What bounds them on this card: at the training shape (8, 1024, 16, 64)
// causal the forward does 2 products, dq 3 (S, dP, dQ) and dk/dv 4 (S^T,
// dP^T, dV, dK) of 2 D flops per attended pair: 17.2, 25.8 and 34.4 GFLOP,
// i.e. 0.017, 0.026 and 0.035 ms at the bf16 tensor-core rate (989
// TFLOP/s), against 0.020, 0.025 and 0.030 ms to move their inputs and
// outputs once at 3.35 TB/s (NVIDIA H100 SXM data sheet, 700 W).  All sit
// near the ridge, so neither f32 SIMT products (67 TFLOP/s at best) nor
// element-wise f32 staging can come close: the products have to run on
// the tensor cores, fed from shared memory without stalls.  At a ring
// shard (8, 256, 16, 64) each kernel's grid is only (128, 4) blocks of 1-4
// tile steps: launch and tail latency, and the host's calls, dominate.
//
// Design:
// - One warpgroup (128 threads) per block owns 64 rows: queries in the
//   forward and dq, keys in dk/dv.  Grid (B*H, ceil(T/64)); the slow grid
//   dimension is the tile, ordered so the tiles with the most work start
//   first.
// - Any T: the last tile may be partial.  Its rows at or past T are
//   zero-filled by the copies (cp.async with src-size 0), keys at or past
//   T are masked out of S (forward, dq) and S^T (dk/dv), queries at or past
//   T get P = 0 in dk/dv, and every store is guarded by row < T.  Each
//   kernel is built twice (kTail): the launch takes the one without that
//   code when T % 64 == 0, so whole tiles run the same loop as before.
// - Tiles live in shared memory in the layout wgmma reads: rows of 128
//   bytes (64 bytes for D = 32), 16-byte chunks XOR-swizzled by row, a
//   D = 128 tile split into two 64-column blocks.  cp.async copies them 16
//   bytes per thread straight from the strided (B, T, H, D) views (the
//   fused qkv projection's), two stages: the next tile's copy is in flight
//   while the current one computes.  The block's own tiles (Q; Q and dO;
//   K and V) are copied once.
// - Products: wgmma.mma_async m64nNk16, bf16 in, f32 accumulate.  The
//   first products of each step read both operands from shared memory
//   (K-major); the last takes its A operand from registers, an f32
//   accumulator converted to bf16 fragments (the accumulator and
//   A-fragment layouts coincide), so P and dS never touch shared memory.
//   Its B operand is the same shared copy read MN-major (the transpose
//   bit), so Q, dO, K and V each have one copy.
// - Forward: S = Q K^T; the online softmax runs on the accumulator in
//   registers (a row is spread over 4 lanes: quad shuffles), on scores
//   prescaled by scale * log2(e) with exp2; O += P V.  Under a causal mask
//   the key loop ends at the tile's own diagonal and only that tile is
//   masked: the keys this drops are exactly the masked ones.
// - dq (Q-stationary, like the forward): S = Q K^T and dP = dO V^T,
//   P = exp2(S scale log2(e) - lse log2(e)), dS = P (dP - delta) scale,
//   dQ += dS K with K read MN-major, over the key tiles up to the diagonal
//   (causal) or T.  lse and delta of the thread's two rows sit in
//   registers.
// - dk/dv (FlashAttention-2 split, transposed): S^T = K Q^T and
//   dP^T = V dO^T, P^T = exp2(S^T scale log2(e) - lse log2(e)),
//   dS^T = P^T (dP^T - delta) scale, dV += P^T dO, dK += dS^T Q, over the
//   query tiles from the diagonal (causal) or 0 to T.
// - Two C entries: flash_sm90_forward, and flash_sm90_backward, the whole
//   backward in one call: the delta kernel, then dq and dk/dv either as
//   two launches or as one launch whose blocks take either role
//   (flash_bwd_sm90_kernel, dq and dk/dv tiles interleaved, the longest of
//   each first), so the two share the card instead of running one after
//   the other.  No atomics in any kernel: the results are deterministic.
// Numerics: Q K^T, dO V^T and V dO^T of bf16 inputs accumulate in f32, as
// the JAX kernels' f32 dots do, in another order.  P and dS are rounded to
// bf16 once, as the A operands of the last products; the softmax
// denominator sums the unrounded f32 P.  flash_forward_reference /
// flash_dq_reference / flash_dkv_reference with round_p=True repeat that
// rounding.
// Plain C interface, loaded with ctypes: each entry returns the CUDA error
// code, or -1 for an unsupported head_dim or kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_delta.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;        // rows of every tile
constexpr int kThreads = 128;    // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;  // the lse of a row with no key
constexpr int kMaskNone = 0;
constexpr int kMaskCausal = 1;

// element strides of a (B, T, H, D) view; head_dim has stride 1
struct Strides {
  long long b, t, h;
};

// blocks of the shared dq + dk/dv launch each SM must hold at once: at
// head_dim 32 and 64, 3 (at most 168 registers a thread; the shared-memory
// tiles allow 4), so the two roles' blocks overlap; at head_dim 128 the
// accumulators need ~240 registers and one block is all that is asked
template <int D>
constexpr int kMinBlocks = D == 128 ? 1 : 3;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse_in;
  const float* delta;
  bf16* out;        // forward
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse_out;
  Strides qs, ks, vs, dos, os, dqs, dks, dvs;
  int n_heads, t, mask;
  float scale;
};

// ---------------------------------------------------------------------------
// shared-memory tiles in the wgmma layout
// ---------------------------------------------------------------------------

// A tile of kRows rows x D bf16 (a row is one position's head_dim) as D*2 /
// kRowBytes column blocks of kRows rows x kRowBytes bytes; the 16-byte chunk
// c of row r sits at chunk c ^ f(r), which is what the hardware's 128-byte
// swizzle (64-byte for D = 32) reads.  Tiles start 1024-byte aligned.
template <int D>
struct Tile {
  static constexpr int kRowBytes = D >= 64 ? 128 : 64;
  static constexpr int kChunksPerRow = kRowBytes / 16;
  static constexpr uint32_t kBlockBytes = kRows * kRowBytes;
  static constexpr uint32_t kBytes = kRows * D * 2;
  static constexpr uint64_t kSwizzle = D >= 64 ? 1 : 2;  // 128B : 64B
  // byte offset of the 16-byte chunk c (0 .. D/8 - 1) of row r
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const int blk = c / kChunksPerRow, cc = c % kChunksPerRow;
    const int f = kRowBytes == 128 ? (r & 7) : ((r >> 1) & 3);
    return blk * kBlockBytes + r * kRowBytes + ((cc ^ f) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies src_bytes (16 or 0) and zero-fills the rest of the 16 bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// copies src_bytes (4 or 0) and zero-fills the rest of the 4 bytes
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// the copies above write through the generic proxy; wgmma reads shared
// memory through the async proxy
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows 0 .. kRows-1 of src (row stride in elements) -> tile at dst; rows
// at or past n_rows (the tail of the sequence) are zero-filled, their
// source never read.  A whole tile (every tile but the sequence's last;
// every tile when kTail is false, T % 64 == 0) takes the unpredicated
// copies.
template <int D, bool kTail>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long row_stride, int n_rows) {
  constexpr int kChunks = D / 8;
  if (!kTail || n_rows >= kRows) {
#pragma unroll
    for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
      const int i = it * kThreads + threadIdx.x;
      const int r = i / kChunks, c = i % kChunks;
      cp_async16(dst + Tile<D>::offset(r, c), src + r * row_stride + c * 8,
                 16);
    }
    return;
  }
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < n_rows;
    cp_async16(dst + Tile<D>::offset(r, c),
               src + (in ? r * row_stride : 0) + c * 8, in ? 16 : 0);
  }
}

// keys at or past T in the tail key tile: their scores (columns of a
// 64 x 64 accumulator, see store_rows) to -inf, so P = 0 there
__device__ __forceinline__ void mask_tail_keys(float (&s)[32], int c_lo,
                                               int k_rows) {
#pragma unroll
  for (int e = 0; e < 32; ++e)
    if (8 * (e >> 2) + c_lo + (e & 1) >= k_rows) s[e] = -INFINITY;
}

// rows of a tile starting at row0 that lie inside the sequence (1 .. kRows)
__device__ __forceinline__ int rows_in(int t, int row0) {
  return min(kRows, t - row0);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// matrix descriptor: start address, leading and stride byte offsets (16-byte
// units), swizzle mode
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

// K-major operand: the tile's rows are M (or N), its head_dim is K; k-step
// kk covers head_dim 16 kk .. 16 kk + 15.  Eight-row groups lie 8 rows
// apart (SBO); LBO is unused by the swizzled K-major layouts.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  constexpr int kPerBlock = Tile<D>::kRowBytes / 32;  // k-steps per block
  return make_desc(tile + (kk / kPerBlock) * Tile<D>::kBlockBytes +
                       (kk % kPerBlock) * 32,
                   16, 8 * Tile<D>::kRowBytes, Tile<D>::kSwizzle);
}

// MN-major operand: the tile's rows are K, its head_dim is N; k-step kk
// covers rows 16 kk .. 16 kk + 15.  Eight-row (K) groups lie 8 rows apart
// (SBO); 64-column (N) blocks one column block apart (LBO).
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * Tile<D>::kRowBytes, Tile<D>::kBlockBytes,
                   8 * Tile<D>::kRowBytes, Tile<D>::kSwizzle);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from reading an accumulator, or reusing the registers
// of an A fragment, before the asynchronous product that owns them is done
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64) = [d +] a (64 x 16, K-major smem) . b (64 x 16, K-major smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32) += a (64 x 16, registers) . b (16 x 32, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += a (64 x 16, registers) . b (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += a (64 x 16, registers) . b (16 x 128, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x, +0 for -inf
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator of a 64 x 64 product as the A fragments of the next one
// (4 k-steps of 16 columns): element 8 kk + e of the accumulator holds
// row r_lo + 8 ((e >> 1) & 1), column 16 kk + 8 (e >> 2) + 2 (lane % 4) +
// (e & 1), which is where the A fragment wants it.
__device__ __forceinline__ void to_a_fragments(const float (&acc)[32],
                                               uint32_t (&frag)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      frag[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// Thread layout of a 64 x N accumulator: warp w, lane l holds rows
// 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1); element
// 4 j + 2 i + c is row half i, column 8 j + 2 (l % 4) + c.
// Stores such an accumulator (64 rows x D, times row_scale) as bf16; with
// kTail, rows below n_rows only.
template <int D, bool kTail>
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride,
                                           int r_lo, int c_lo, int n_rows,
                                           const float (&acc)[D / 2],
                                           const float (&row_scale)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kTail && r_lo + 8 * i >= n_rows) continue;
      const int e = 4 * j + 2 * i;
      *reinterpret_cast<uint32_t*>(dst + (r_lo + 8 * i) * row_stride +
                                   8 * j + c_lo) =
          pack_bf16(acc[e] * row_scale[i], acc[e + 1] * row_scale[i]);
    }
}

// ---------------------------------------------------------------------------
// forward: out, lse of one 64-row query tile
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t fwd_smem() {
  return 1024 + 5 * Tile<D>::kBytes;  // Q, 2 stages of K and V, alignment
}

template <int D, bool kTail>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_sm90_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kTile = Tile<D>::kBytes;
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  // stage s holds K at kv_s(s) and V at kv_s(s) + kTile
  const auto kv_s = [&](int s) { return q_s + (1 + 2 * s) * kTile; };

  const int n_tiles = (a.t + kRows - 1) / kRows;
  const bool causal = a.mask != kMaskNone;
  const int bh = blockIdx.x, b = bh / a.n_heads, h = bh % a.n_heads;
  // causal: the last query tile has the most keys, so it starts first
  const int qt = causal ? n_tiles - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int row0 = qt * kRows, q_rows = rows_in(a.t, row0);
  const int n_kv = causal ? qt + 1 : n_tiles;  // up to the diagonal
  const bf16* kg = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vg = a.v + b * a.vs.b + h * a.vs.h;

  load_tile<D, kTail>(q_s, a.q + b * a.qs.b + h * a.qs.h + row0 * a.qs.t,
                      a.qs.t, q_rows);
  load_tile<D, kTail>(kv_s(0), kg, a.ks.t, rows_in(a.t, 0));
  load_tile<D, kTail>(kv_s(0) + kTile, vg, a.vs.t, rows_in(a.t, 0));
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_lo = 16 * warp + (lane >> 2);  // rows r_lo and r_lo + 8
  const int c_lo = 2 * (lane & 3);
  const float scale_log2 = a.scale * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  // running max (log2 units) and this thread's part of the denominator
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait_all();  // tile j is in (the only copy in flight)
    fence_async_proxy();
    __syncthreads();      // ... for every thread; tile j - 1 is released
    if (j + 1 < n_kv) {
      const int r = (j + 1) * kRows;
      const int n = rows_in(a.t, r);
      load_tile<D, kTail>(kv_s((j + 1) & 1), kg + r * a.ks.t, a.ks.t, n);
      load_tile<D, kTail>(kv_s((j + 1) & 1) + kTile, vg + r * a.vs.t, a.vs.t,
                          n);
      cp_async_commit();
    }
    const uint32_t k_t = kv_s(j & 1), v_t = k_t + kTile;

    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k_major<D>(q_s, kk), desc_k_major<D>(k_t, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // mask (keys at or past T in the tail tile; the diagonal tile), new
    // row max over the quad
    const int k_rows = rows_in(a.t, j * kRows);
    if (kTail && k_rows < kRows) mask_tail_keys(s, c_lo, k_rows);
    const bool diag = causal && j == qt;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      float x = s[e] * scale_log2;
      if (diag) {
        const int r = r_lo + 8 * i, c = 8 * (e >> 2) + c_lo + (e & 1);
        if (a.mask == kMaskCausal ? c > r : c >= r) x = -INFINITY;
      }
      s[e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mu[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // a row with no key yet
      const float corr = exp2_approx(m[i] - mu[i]);
      l[i] *= corr;
#pragma unroll
      for (int j2 = 0; j2 < D / 8; ++j2) {
        o[4 * j2 + 2 * i] *= corr;
        o[4 * j2 + 2 * i + 1] *= corr;
      }
      m[i] = mx[i];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      s[e] = exp2_approx(s[e] - mu[i]);
      l[i] += s[e];
    }

    uint32_t p[4][4];
    to_a_fragments(s, p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(o, p[kk], desc_mn_major<D>(v_t, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p);
  }

  // a row whose max never left -inf attended no key: output 0, lse -1e30
  float inv[2], lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const bool empty = m[i] == -INFINITY;
    inv[i] = empty ? 0.f : 1.f / l[i];
    lse[i] = empty ? kNegInf : m[i] * kLn2 + logf(l[i]);
  }
  if ((lane & 3) == 0) {
    float* lse_row = a.lse_out + static_cast<long long>(bh) * a.t + row0;
    if (!kTail || r_lo < q_rows) lse_row[r_lo] = lse[0];
    if (!kTail || r_lo + 8 < q_rows) lse_row[r_lo + 8] = lse[1];
  }
  store_rows<D, kTail>(a.out + b * a.os.b + h * a.os.h + row0 * a.os.t,
                       a.os.t, r_lo, c_lo, q_rows, o, inv);
}

// ---------------------------------------------------------------------------
// backward: dk, dv of one 64-key tile
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dkv_smem() {
  // K, V, 2 stages of Q and dO, 2 stages of 64 lse + 64 delta, alignment
  return 1024 + 6 * Tile<D>::kBytes + 2 * 2 * kRows * sizeof(float);
}

// key tile kt: tile 0 has the most queries; the first query tile that sees
// it is its diagonal (causal) or 0
template <int D, bool kTail>
__device__ __forceinline__ void dkv_tile(const Args& a, int kt) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kTile = Tile<D>::kBytes;
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + kTile;
  // stage s holds Q at qo_s(s), dO at qo_s(s) + kTile, and lse, delta at
  // rows_s + s * 2 * kRows, + kRows
  const auto qo_s = [&](int s) { return base + (2 + 2 * s) * kTile; };
  const uint32_t rows_addr = base + 6 * kTile;
  const float* rows_s = reinterpret_cast<const float*>(
      smem_raw + (rows_addr - smem_addr(smem_raw)));

  const int n_tiles = (a.t + kRows - 1) / kRows;
  const bool causal = a.mask != kMaskNone;
  const int bh = blockIdx.x, b = bh / a.n_heads, h = bh % a.n_heads;
  const int col0 = kt * kRows, k_rows = rows_in(a.t, col0);
  const bool k_tail = k_rows < kRows;
  const int first = causal ? kt : 0;
  const bf16* qg = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* dog = a.dout + b * a.dos.b + h * a.dos.h;
  const float* lse_g = a.lse_in + static_cast<long long>(bh) * a.t;
  const float* delta_g = a.delta + static_cast<long long>(bh) * a.t;

  const auto load_queries = [&](int s, int tile) {
    const int r = tile * kRows, n = rows_in(a.t, r);
    load_tile<D, kTail>(qo_s(s), qg + r * a.qs.t, a.qs.t, n);
    load_tile<D, kTail>(qo_s(s) + kTile, dog + r * a.dos.t, a.dos.t, n);
    // 64 lse, then 64 delta, one 4-byte copy per thread (any T: rows are
    // not 16-byte aligned); rows at or past T zero-filled
    const int c = threadIdx.x & (kRows - 1), which = threadIdx.x / kRows;
    const float* src = which ? delta_g : lse_g;
    const bool in = !kTail || c < n;
    cp_async4(rows_addr + (s * 2 + which) * kRows * 4 + 4 * c,
              src + (in ? r + c : 0), in ? 4 : 0);
  };
  load_tile<D, kTail>(k_s, a.k + b * a.ks.b + h * a.ks.h + col0 * a.ks.t,
                      a.ks.t, k_rows);
  load_tile<D, kTail>(v_s, a.v + b * a.vs.b + h * a.vs.h + col0 * a.vs.t,
                      a.vs.t, k_rows);
  load_queries(0, first);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_lo = 16 * warp + (lane >> 2);  // keys r_lo and r_lo + 8
  const int c_lo = 2 * (lane & 3);           // queries 8 j + c_lo (+ 1)
  const float scale_log2 = a.scale * kLog2e;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;

  for (int i = first; i < n_tiles; ++i) {
    const int st = (i - first) & 1;
    cp_async_wait_all();
    fence_async_proxy();
    __syncthreads();
    if (i + 1 < n_tiles) {
      load_queries(st ^ 1, i + 1);
      cp_async_commit();
    }
    const uint32_t q_t = qo_s(st), do_t = q_t + kTile;
    const float* lse_t = rows_s + st * 2 * kRows;
    const float* delta_t = lse_t + kRows;
    const int q_rows = rows_in(a.t, i * kRows);

    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k_major<D>(k_s, kk), desc_k_major<D>(q_t, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_k_major<D>(v_s, kk), desc_k_major<D>(do_t, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in place: rows are keys, columns queries
    const bool diag = causal && i == kt;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = 8 * j + c_lo + c;
        const float lse = lse_t[qc], delta = delta_t[qc];
        // a row with no key (lse -1e30) and a query at or past T get P = 0
        const float lse2 = (!kTail || qc < q_rows) && lse > 0.5f * kNegInf
                               ? lse * kLog2e
                               : INFINITY;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int e = 4 * j + 2 * hi + c, key = r_lo + 8 * hi;
          float p = exp2_approx(s[e] * scale_log2 - lse2);
          if (diag && (a.mask == kMaskCausal ? key > qc : key >= qc)) p = 0.f;
          if (kTail && k_tail && key >= k_rows) p = 0.f;
          s[e] = p;
          dp[e] = p * (dp[e] - delta) * a.scale;
        }
      }

    uint32_t pt[4][4], dst[4][4];
    to_a_fragments(s, pt);
    to_a_fragments(dp, dst);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dv, pt[kk], desc_mn_major<D>(do_t, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dk, dst[kk], desc_mn_major<D>(q_t, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pt);
    fence_regs(dst);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D, kTail>(a.dk + b * a.dks.b + h * a.dks.h + col0 * a.dks.t,
                       a.dks.t, r_lo, c_lo, k_rows, dk, one);
  store_rows<D, kTail>(a.dv + b * a.dvs.b + h * a.dvs.h + col0 * a.dvs.t,
                       a.dvs.t, r_lo, c_lo, k_rows, dv, one);
}

// ---------------------------------------------------------------------------
// backward: dq of one 64-row query tile
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_smem() {
  return 1024 + 6 * Tile<D>::kBytes;  // Q, dO, 2 stages of K and V, alignment
}

// query tile number y in launch order: causal, the last query tile (the
// most keys) first
template <int D, bool kTail>
__device__ __forceinline__ void dq_tile(const Args& a, int y) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kTile = Tile<D>::kBytes;
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + kTile;
  // stage s holds K at kv_s(s) and V at kv_s(s) + kTile
  const auto kv_s = [&](int s) { return q_s + (2 + 2 * s) * kTile; };

  const int n_tiles = (a.t + kRows - 1) / kRows;
  const bool causal = a.mask != kMaskNone;
  const int bh = blockIdx.x, b = bh / a.n_heads, h = bh % a.n_heads;
  const int qt = causal ? n_tiles - 1 - y : y;
  const int row0 = qt * kRows, q_rows = rows_in(a.t, row0);
  const int n_kv = causal ? qt + 1 : n_tiles;  // up to the diagonal
  const bf16* kg = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vg = a.v + b * a.vs.b + h * a.vs.h;

  load_tile<D, kTail>(q_s, a.q + b * a.qs.b + h * a.qs.h + row0 * a.qs.t,
                      a.qs.t, q_rows);
  load_tile<D, kTail>(do_s,
                      a.dout + b * a.dos.b + h * a.dos.h + row0 * a.dos.t,
                      a.dos.t, q_rows);
  load_tile<D, kTail>(kv_s(0), kg, a.ks.t, rows_in(a.t, 0));
  load_tile<D, kTail>(kv_s(0) + kTile, vg, a.vs.t, rows_in(a.t, 0));
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_lo = 16 * warp + (lane >> 2);  // queries r_lo and r_lo + 8
  const int c_lo = 2 * (lane & 3);           // keys 8 j + c_lo (+ 1)
  const float scale_log2 = a.scale * kLog2e;
  // this thread's two rows: lse (log2 units; a row with no key, lse
  // -1e30, or a row at or past T gets P = 0) and delta
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    const long long row = static_cast<long long>(bh) * a.t + row0 + r;
    const bool in = !kTail || r < q_rows;
    const float lse = in ? a.lse_in[row] : kNegInf;
    lse2[i] = lse > 0.5f * kNegInf ? lse * kLog2e : INFINITY;
    delta[i] = in ? a.delta[row] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait_all();  // tile j is in (the only copy in flight)
    fence_async_proxy();
    __syncthreads();      // ... for every thread; tile j - 1 is released
    if (j + 1 < n_kv) {
      const int r = (j + 1) * kRows;
      const int n = rows_in(a.t, r);
      load_tile<D, kTail>(kv_s((j + 1) & 1), kg + r * a.ks.t, a.ks.t, n);
      load_tile<D, kTail>(kv_s((j + 1) & 1) + kTile, vg + r * a.vs.t, a.vs.t,
                          n);
      cp_async_commit();
    }
    const uint32_t k_t = kv_s(j & 1), v_t = k_t + kTile;

    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k_major<D>(q_s, kk), desc_k_major<D>(k_t, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_k_major<D>(do_s, kk), desc_k_major<D>(v_t, kk),
               kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P and dS in place: rows are queries, columns keys; keys at or past
    // T in the tail tile and the diagonal tile are masked
    const int k_rows = rows_in(a.t, j * kRows);
    if (kTail && k_rows < kRows) mask_tail_keys(s, c_lo, k_rows);
    const bool diag = causal && j == qt;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      const int r = r_lo + 8 * i, c = 8 * (e >> 2) + c_lo + (e & 1);
      float p = exp2_approx(s[e] * scale_log2 - lse2[i]);
      if (diag && (a.mask == kMaskCausal ? c > r : c >= r)) p = 0.f;
      dp[e] = p * (dp[e] - delta[i]) * a.scale;
    }

    uint32_t ds[4][4];
    to_a_fragments(dp, ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dq, ds[kk], desc_mn_major<D>(k_t, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    fence_regs(ds);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D, kTail>(a.dq + b * a.dqs.b + h * a.dqs.h + row0 * a.dqs.t,
                       a.dqs.t, r_lo, c_lo, q_rows, dq, one);
}

template <int D, bool kTail>
__global__ void __launch_bounds__(kThreads)
    flash_dq_sm90_kernel(const Args a) {
  dq_tile<D, kTail>(a, blockIdx.y);
}

template <int D, bool kTail>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_sm90_kernel(const Args a) {
  dkv_tile<D, kTail>(a, blockIdx.y);
}

// dq and dk/dv in one grid of (B*H, 2 ceil(T/64)) blocks: even y take the
// dq role, odd y the dk/dv role, each in its own longest-first order, so
// the two roles' tiles interleave and share the card
template <int D, bool kTail>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
    flash_bwd_sm90_kernel(const Args a) {
  const int y = blockIdx.y >> 1;
  if (blockIdx.y & 1)
    dkv_tile<D, kTail>(a, y);
  else
    dq_tile<D, kTail>(a, y);
}

template <int D>
constexpr size_t bwd_smem() {
  return dq_smem<D>() > dkv_smem<D>() ? dq_smem<D>() : dkv_smem<D>();
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Args& a, int batch, int y_per_tile,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * a.n_heads, y_per_tile * ((a.t + kRows - 1) / kRows));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// which: 0 = forward, 1 = dq, 2 = dk/dv
template <int D, bool kTail>
int launch_one(int which, const Args& a, int batch, cudaStream_t stream) {
  if (which == 0)
    return launch(flash_fwd_sm90_kernel<D, kTail>, fwd_smem<D>(), a, batch, 1,
                  stream);
  if (which == 1)
    return launch(flash_dq_sm90_kernel<D, kTail>, dq_smem<D>(), a, batch, 1,
                  stream);
  if (which == 2)
    return launch(flash_dkv_sm90_kernel<D, kTail>, dkv_smem<D>(), a, batch, 1,
                  stream);
  return -1;
}

// the kernels without tail code when T % 64 == 0 (every tile whole)
template <int D>
int launch_which(int which, const Args& a, int batch, cudaStream_t stream) {
  return a.t % kRows ? launch_one<D, true>(which, a, batch, stream)
                     : launch_one<D, false>(which, a, batch, stream);
}

// dq and dk/dv after delta: one shared launch, or two in turn
template <int D>
int launch_backward(const Args& a, int batch, int shared, cudaStream_t stream) {
  if (shared)
    return a.t % kRows
               ? launch(flash_bwd_sm90_kernel<D, true>, bwd_smem<D>(), a,
                        batch, 2, stream)
               : launch(flash_bwd_sm90_kernel<D, false>, bwd_smem<D>(), a,
                        batch, 2, stream);
  const int err = launch_which<D>(1, a, batch, stream);
  return err != 0 ? err : launch_which<D>(2, a, batch, stream);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

// The forward: out and lse.  strides: 3 per tensor, in the order q, k, v,
// out.  mask: 0 none, 1 causal, 2 causal_exclusive.  Any t.  The caller
// guarantees bf16 tensors, 16-byte aligned base pointers and (B, T, H)
// strides of q/k/v/out, and a contiguous (B*H, T) f32 lse.
extern "C" int flash_sm90_forward(int head_dim, const void* q, const void* k,
                                  const void* v, void* out, void* lse,
                                  const long long* strides, int batch,
                                  int n_heads, int t, int mask, float scale,
                                  void* stream) {
  if (batch == 0 || n_heads == 0 || t == 0) return 0;
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.lse_out = static_cast<float*>(lse);
  a.qs = strides_at(strides, 0);
  a.ks = strides_at(strides, 1);
  a.vs = strides_at(strides, 2);
  a.os = strides_at(strides, 3);
  a.n_heads = n_heads;
  a.t = t;
  a.mask = mask;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return launch_which<32>(0, a, batch, st);
  if (head_dim == 64) return launch_which<64>(0, a, batch, st);
  if (head_dim == 128) return launch_which<128>(0, a, batch, st);
  return -1;
}

// The whole backward in one call: delta = rowsum(dout * out) - g_lse into
// `delta`, then dq, dk, dv (shared != 0: one launch of both roles, else two
// launches).  strides: 3 per tensor in the order q, k, v, out, dout, dq, dk,
// dv, then g_lse's two (B*H, T) strides.  g_lse may be null.  Any t.  The
// caller guarantees bf16 tensors, 16-byte aligned base pointers and
// (B, T, H) strides of the eight (B, T, H, D) tensors, a contiguous
// (B*H, T) f32 lse and delta, and an f32 g_lse.
extern "C" int flash_sm90_backward(int head_dim, const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   const void* g_lse, void* dq, void* dk,
                                   void* dv, void* delta,
                                   const long long* strides, int batch,
                                   int n_heads, int t, int mask, float scale,
                                   int shared, void* stream) {
  if (batch == 0 || n_heads == 0 || t == 0) return 0;
  if (head_dim != 32 && head_dim != 64 && head_dim != 128) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_delta::Args<bf16> da;
  da.out = static_cast<const bf16*>(out);
  da.dout = static_cast<const bf16*>(dout);
  da.g_lse = static_cast<const float*>(g_lse);
  da.delta = static_cast<float*>(delta);
  da.os = flash_delta::View{strides[9], strides[10], strides[11]};
  da.dos = flash_delta::View{strides[12], strides[13], strides[14]};
  da.g_bh = strides[24];
  da.g_t = strides[25];
  da.n_heads = n_heads;
  da.t = t;
  da.n_rows = static_cast<long long>(batch) * n_heads * t;
  int err = flash_delta::launch_head_dim(head_dim, da, st);
  if (err != 0) return err;

  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.qs = strides_at(strides, 0);
  a.ks = strides_at(strides, 1);
  a.vs = strides_at(strides, 2);
  a.dos = strides_at(strides, 4);
  a.dqs = strides_at(strides, 5);
  a.dks = strides_at(strides, 6);
  a.dvs = strides_at(strides, 7);
  a.n_heads = n_heads;
  a.t = t;
  a.mask = mask;
  a.scale = scale;
  if (head_dim == 32) return launch_backward<32>(a, batch, shared, st);
  if (head_dim == 64) return launch_backward<64>(a, batch, shared, st);
  return launch_backward<128>(a, batch, shared, st);
}
