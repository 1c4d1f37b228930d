// Paged attention over the serving KV block pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel neural_networks_parallel_training_with_mpi_tpu/
// ops/pallas_kernels.py:_paged_attn_kernel (called by paged_attention
// there).  Same function: for every stream s and query row (column w,
// head h) at absolute position starts[s] + w, attend over the stream's
// keys 0 .. lengths[s]-1 read through its block table, causal against
// the row's position; GQA folds the n_heads/kv_heads query heads of one
// KV head into rows; int8 pools dequantise on load with one f32 scale per
// (position, head); a stream with length 0, and any row with no key to
// attend, outputs 0.
//
// What bounds it on this card: decode reads every live K/V byte once and
// does 4 flops per K/V element (q.k and p.v), far below the H100's ridge
// point, so the bound is bytes: (live K/V [+ scales] + q + out) over
// 3.35 TB/s.  Prefill chunks raise the flops per byte by the chunk width
// but stay on CUDA cores here (wgmma, TMA and split-K over long contexts
// are later work).
//
// Design (not a block-by-block translation of the Pallas kernel):
// - Grid (stream, kv_head, row tile).  The TPU kernel ran one program per
//   stream and unrolled the KV heads so each pool block was DMA'd once;
//   here blocks run in parallel, so each (stream, kv_head) pair is its
//   own block and reads only its head's slice of each pool block.
// - Each block reads its own tables/lengths/starts (no scalar prefetch)
//   and walks j < ceil(min(len, last row's position + 1) / BS) pool
//   blocks: beyond that every key of the tile is masked anyway.
// - One BS x HD K/V tile at a time is staged in shared memory as f32
//   (dequantised there for int8).  Tile j+1 is loaded into registers
//   while tile j is computed, which hides most of the load latency.
// - A warp owns ROWS_PER_WARP query rows and keeps their running
//   (max, denominator, accumulator) in f32 registers.  For the scores,
//   lane l handles key l % BS over 1/(32/BS) of the head dim and the
//   partial dots are combined by shuffles; for the value product each
//   lane owns HD/32 output dims.
// - q and out are indexed through their (S, W, H, hd) strides, so the
//   wrapper passes the strided q view from the fused qkv projection as
//   it is.
// Plain C interface, loaded with ctypes: the launch returns the CUDA
// error code (or -1 for an unsupported combination).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename QT, typename KT, int HD, int BS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, long long q_s0,
                       long long q_s1, long long q_s2,
                       const KT* __restrict__ k_pool,
                       const KT* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       const int* __restrict__ starts,
                       QT* __restrict__ out, int width, int n_heads,
                       int kv_heads, int max_blocks, float scale) {
  constexpr bool kQuant = sizeof(KT) == 1;
  constexpr int kSplit = 32 / BS;        // lanes sharing one key
  constexpr int kDimsPerLane = HD / kSplit;
  constexpr int kAcc = HD / 32;          // output dims per lane
  constexpr int kTile = BS * HD;
  constexpr int kPerThread = kTile / kThreads;
  static_assert(kTile % kThreads == 0, "tile must split over the block");
  static_assert(32 % BS == 0 && HD % 32 == 0, "unsupported geometry");

  __shared__ float ks[BS][HD + 1];       // +1: lanes on different keys
  __shared__ float vs[BS][HD];           //     hit different banks
  __shared__ float qs[kRows][HD];

  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int groups = n_heads / kv_heads;
  const int rows = width * groups;
  const int len = lengths[s];
  const int start = starts[s];

  // query rows of this tile, pre-scaled as the TPU kernel does
  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, row = row0 + r;
    float val = 0.f;
    if (row < rows) {
      const int w = row / groups, h = kvh * groups + row % groups;
      val = to_f32(q[s * q_s0 + w * q_s1 + h * q_s2 + d]) * scale;
    }
    qs[r][d] = val;
  }

  const int last_row = min(row0 + kRows, rows) - 1;
  const int keys = min(len, start + last_row / groups + 1);
  const int nb = keys > 0 ? (keys + BS - 1) / BS : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kAcc];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[r][i] = 0.f;
  }

  float kr[kPerThread], vr[kPerThread];
  auto load_tile = [&](int j) {
    const long long blk = tables[(long long)s * max_blocks + j];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int key = e / HD, d = e % HD;
      const long long pos = (blk * BS + key) * kv_heads + kvh;
      kr[i] = to_f32(k_pool[pos * HD + d]);
      vr[i] = to_f32(v_pool[pos * HD + d]);
      if constexpr (kQuant) {
        kr[i] *= k_scale[pos];
        vr[i] *= v_scale[pos];
      }
    }
  };

  if (nb > 0) load_tile(0);
  const int key = lane % BS;
  const int part = lane / BS;
  for (int j = 0; j < nb; ++j) {
    __syncthreads();  // every warp is done with tile j-1
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      ks[e / HD][e % HD] = kr[i];
      vs[e / HD][e % HD] = vr[i];
    }
    __syncthreads();
    if (j + 1 < nb) load_tile(j + 1);  // in flight while tile j computes

    const int k_pos = j * BS + key;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (row0 + r >= rows) break;  // warp-uniform
      const int q_pos = start + (row0 + r) / groups;
      float sc = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = part * kDimsPerLane + i;
        sc = fmaf(qs[r][d], ks[key][d], sc);
      }
#pragma unroll
      for (int off = BS; off < 32; off <<= 1)
        sc += __shfl_xor_sync(kFull, sc, off);
      const bool keep = k_pos < len && k_pos <= q_pos;
      sc = keep ? sc : kNegInf;
      float bmax = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(kFull, bmax, off));
      const float m_new = fmaxf(m[rr], bmax);
      const float p = keep ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      float psum = part == 0 ? p : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(kFull, psum, off);
      l[rr] = corr * l[rr] + psum;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[rr][i] *= corr;
#pragma unroll
      for (int kk = 0; kk < BS; ++kk) {
        const float pk = __shfl_sync(kFull, p, kk);
#pragma unroll
        for (int i = 0; i < kAcc; ++i)
          acc[rr][i] = fmaf(pk, vs[kk][lane + 32 * i], acc[rr][i]);
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= rows) break;
    const int w = row / groups, h = kvh * groups + row % groups;
    const bool empty = m[rr] < kNegInf * 0.5f;
    const float inv = empty ? 0.f : 1.f / l[rr];
    QT* o = out + (((long long)s * width + w) * n_heads + h) * HD;
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      o[lane + 32 * i] = from_f32<QT>(empty ? 0.f : acc[rr][i] * inv);
  }
}

template <typename QT, typename KT, int HD, int BS>
int launch(const void* q, long long q_s0, long long q_s1, long long q_s2,
           const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* tables, const void* lengths,
           const void* starts, void* out, int streams, int width,
           int n_heads, int kv_heads, int max_blocks, float scale,
           cudaStream_t stream) {
  const int rows = width * (n_heads / kv_heads);
  const dim3 grid(streams, kv_heads, (rows + kRows - 1) / kRows);
  paged_attention_kernel<QT, KT, HD, BS><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), q_s0, q_s1, q_s2,
      static_cast<const KT*>(k_pool), static_cast<const KT*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<const int*>(starts), static_cast<QT*>(out), width,
      n_heads, kv_heads, max_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int dispatch_geometry(int head_dim, int block_size, const void* q,
                      long long q_s0, long long q_s1, long long q_s2,
                      const void* k_pool, const void* v_pool,
                      const void* k_scale, const void* v_scale,
                      const void* tables, const void* lengths,
                      const void* starts, void* out, int streams, int width,
                      int n_heads, int kv_heads, int max_blocks, float scale,
                      cudaStream_t stream) {
#define PA_CASE(HD, BS)                                                     \
  if (head_dim == HD && block_size == BS)                                   \
    return launch<QT, KT, HD, BS>(q, q_s0, q_s1, q_s2, k_pool, v_pool,      \
                                  k_scale, v_scale, tables, lengths, starts, \
                                  out, streams, width, n_heads, kv_heads,    \
                                  max_blocks, scale, stream);
  PA_CASE(64, 16)
  PA_CASE(64, 32)
  PA_CASE(128, 16)
  PA_CASE(128, 32)
#undef PA_CASE
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only; needs
// the f32 scale pools)
extern "C" int paged_attention_supported(int head_dim, int block_size) {
  return (head_dim == 64 || head_dim == 128) &&
         (block_size == 16 || block_size == 32);
}

extern "C" int paged_attention_launch(
    int q_dtype, int kv_dtype, int head_dim, int block_size, const void* q,
    long long q_s0, long long q_s1, long long q_s2, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* tables, const void* lengths, const void* starts, void* out,
    int streams, int width, int n_heads, int kv_heads, int max_blocks,
    float scale, void* stream) {
  if (streams == 0 || width == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS                                                              \
  head_dim, block_size, q, q_s0, q_s1, q_s2, k_pool, v_pool, k_scale,       \
      v_scale, tables, lengths, starts, out, streams, width, n_heads,       \
      kv_heads, max_blocks, scale, st
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch_geometry<float, float>(PA_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_geometry<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
  if (q_dtype == 0 && kv_dtype == 2)
    return dispatch_geometry<float, int8_t>(PA_ARGS);
  if (q_dtype == 1 && kv_dtype == 2)
    return dispatch_geometry<__nv_bfloat16, int8_t>(PA_ARGS);
#undef PA_ARGS
  return -1;
}
