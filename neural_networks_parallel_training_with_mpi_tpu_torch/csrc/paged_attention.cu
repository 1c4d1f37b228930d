// Paged attention over the serving KV block pool, for Hopper (sm_90a),
// split over the context (flash-decoding).
//
// Replaces the TPU kernel neural_networks_parallel_training_with_mpi_tpu/
// ops/pallas_kernels.py:_paged_attn_kernel (called by paged_attention
// there).  Same function: for every stream s and query row (column w,
// head h) at absolute position starts[s] + w, attend over the stream's
// keys 0 .. lengths[s]-1 read through its block table, causal against
// the row's position; GQA folds the n_heads/kv_heads query heads of one
// KV head into rows; int8 pools dequantise on read with one f32 scale per
// (position, head); a stream with length 0, and any row with no key to
// attend, outputs 0.
//
// What bounds it on this card: decode reads every live K/V byte once and
// does 4 flops per K/V element (q.k and p.v), far below the H100's ridge
// point, so the bound is bytes: (live K/V [+ scales] + q + out) over
// 3.35 TB/s (NVIDIA H100 SXM data sheet, 700 W).  A lane's keys are one
// chain of dependent softmax steps, so a kernel that walks a long lane in
// one block is bound by the latency of that chain, not by bytes: the
// design cuts the chain.  Prefill chunks raise the flops per byte by the
// chunk width but stay on CUDA cores here (tensor cores for their 16-row
// tiles are later work).
//
// Design (not a block-by-block translation of the Pallas kernel):
// - Grid (stream x split, kv_head, 16-row tile).  The TPU kernel ran one
//   program per stream and unrolled the KV heads so each pool block was
//   DMA'd once; here blocks run in parallel, so each (stream, kv_head)
//   pair reads only its head's slice of each pool block.
// - Split-K: split sp of a tile walks keys [sp * split_keys,
//   (sp + 1) * split_keys) of its lane (split_keys = split_blocks x BS,
//   from ops/paged_attention.py:split_plan, which sizes the grid from the
//   table's capacity, never from lengths).  Each block reads its own
//   tables/lengths/starts (no scalar prefetch) and stops at ceil(min(len,
//   last row's position + 1) / BS) pool blocks, as before: a split past
//   that exits at once, so a short lane in a long table costs one block,
//   and the sink block that unallocated entries point at is never read.
// - Inside a block each warp takes 16-key units of the split (unit u
//   goes to warp u % 4) and keeps its own running (max, denominator,
//   accumulator) for every row of the tile in f32 registers.  Its units
//   come in by 16-byte cp.async copies, in their own type (f32, bf16 or
//   int8 bytes plus f32 scales), into a two-stage ring of its own: the
//   next unit's copy is in flight while the current one computes, with
//   warp barriers only (four stages measured no faster).  Key rows are stored with their 16-byte chunks
//   XOR-swizzled, so the 16 lanes that read 16 keys' chunk c at once hit
//   different banks.  Scores: lane l takes key l % 16 over half of the
//   head dim, one shuffle joins the halves; values: each lane owns HD/32
//   output dims.  At head_dim 16 a key is half a warp's dims: lanes
//   l and l + 16 own dim l % 16, the first half of the warp adds the
//   unit's even keys and the second its odd ones, and one shuffle joins
//   the two partial accumulators before the merge.
// - Merge, in a fixed order so the result does not depend on which block
//   ran first: the 4 warps' partials are combined in warp order through
//   shared memory.  A tile whose keys fit one split writes its output
//   there.  Otherwise every split writes (max, denominator, f32
//   accumulator) to a scratch buffer the wrapper allocates, and the
//   last-arriving split of the (stream, kv_head, tile), found by a ticket
//   (atomicAdd after a fence), merges all splits in split-index order and
//   writes the output; it resets its ticket to 0, so the ticket buffer is
//   zero between launches.  One launch per call, no allocation, no sync.
// - q and out are indexed through their (S, W, H, hd) strides, so the
//   wrapper passes the strided q view from the fused qkv projection as
//   it is.
// - Geometry: head_dim 16, 32, 64 or 128 (one template each; a lane
//   owns max(head_dim / 32, 1) output dims and reads half of each key's
//   16-byte chunks, so int8 at head_dim 32 takes one chunk per half, and
//   int8 at head_dim 16, one chunk a key, 8 bytes of it), and any
//   pool block size that is a multiple of the 16-key unit, read at run
//   time: a unit never straddles two pool blocks, and shared memory holds
//   units, so it does not grow with the block size.
// Plain C interface, loaded with ctypes: the launch returns the CUDA
// error code (or -1 for an unsupported combination).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;     // query rows of a tile (ops: TILE_ROWS)
constexpr int kUnit = 16;     // keys of a warp's unit
constexpr int kStages = 2;    // cp.async ring of each warp
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory layout of one kernel instance
template <typename KT, int HD>
struct Layout {
  static constexpr bool kQuant = sizeof(KT) == 1;
  static constexpr int kChunks = HD * static_cast<int>(sizeof(KT)) / 16;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(KT));
  static constexpr int kRowBytes = kChunks * 16;        // one key's slice
  static constexpr int kUnitBytes = kUnit * kRowBytes;  // K (or V) of a unit
  // K, V, then (int8) 16 K scales and 16 V scales
  static constexpr int kStageBytes = 2 * kUnitBytes + (kQuant ? 128 : 0);
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  // the warps' partials: max, denominator, accumulator of every row
  static constexpr int kMergeBytes = kWarps * kRows * (HD + 2) * 4;
  static constexpr int kQBytes = kRows * HD * 4;
  static constexpr size_t kSmem =
      kQBytes + (kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes);
  // a lane reads half a key's chunks: an even count (int8 at head_dim 32
  // has 2 chunks of 16 values, one per half), or half of the one chunk
  // of int8 at head_dim 16
  static constexpr bool kHalfChunk = kChunks == 1;
  static_assert(kHalfChunk || kChunks % 2 == 0, "unsupported geometry");
  static_assert(HD % 16 == 0, "unsupported geometry");
  // byte offset of chunk c of key row k: chunks XOR-swizzled by row, so
  // the 8 lanes of a quarter-warp, reading 8 keys' chunk c, hit 8
  // different 16-byte bank groups (the XOR stays below kChunks; a row of
  // one chunk is not swizzled: 16 keys' rows are 256 bytes in a row)
  static __device__ __forceinline__ int offset(int k, int c) {
    const int f = kChunks >= 8   ? (k & 7)
                  : kChunks == 4 ? ((k >> 1) & 3)
                  : kChunks == 2 ? ((k >> 2) & 1)
                                 : 0;
    return k * kRowBytes + ((c ^ f) << 4);
  }
};

// one 16-byte chunk of f32, bf16 or int8 values as f32
__device__ __forceinline__ void chunk_to_f32(const float4& raw,
                                             float (&x)[4]) {
  x[0] = raw.x;
  x[1] = raw.y;
  x[2] = raw.z;
  x[3] = raw.w;
}
__device__ __forceinline__ void chunk_to_f32(const float4& raw,
                                             float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void chunk_to_f32(const float4& raw,
                                             float (&x)[16]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 16; ++e) x[e] = static_cast<float>(b[e]);
}

struct Params {
  const void* q;
  long long q_s0, q_s1, q_s2;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* lengths;
  const int* starts;
  void* out;
  float* part_ml;    // (tile, split, row) x (max, denominator)
  float* part_acc;   // (tile, split, row) x HD
  int* tickets;      // one per (stream, kv_head, tile), zero between calls
  int width, n_heads, kv_heads, max_blocks, block_size, split_keys, n_splits;
  float scale;
};

template <typename QT, typename KT, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const Params p) {
  using L = Layout<KT, HD>;
  // lanes that own output dims (dim d is lane d % kDimLanes's), and the
  // keys a warp adds at once in p.v: 2 at head_dim 16, else 1
  constexpr int kDimLanes = HD < 32 ? HD : 32;
  constexpr int kKeyPar = 32 / kDimLanes;
  constexpr int kAcc = HD / kDimLanes;   // output dims per lane
  constexpr int kHalf = L::kHalfChunk ? 1 : L::kChunks / 2;  // per lane
  const int dim0 = (threadIdx.x & 31) % kDimLanes;
  const bool owns = (threadIdx.x & 31) < kDimLanes;  // writes its dims
  // pool block size, a multiple of kUnit (the launch checks): a unit lies
  // in one pool block, so shared memory does not depend on it
  const int BS = p.block_size;

  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);          // [kRows][HD]
  uint8_t* ring = smem + L::kQBytes;                     // aliased by merge
  float* m_s = reinterpret_cast<float*>(ring);           // [kWarps][kRows]
  float* l_s = m_s + kWarps * kRows;                     // [kWarps][kRows]
  float* acc_s = l_s + kWarps * kRows;             // [kWarps][kRows][HD]
  __shared__ int last_s;

  const int s = blockIdx.x / p.n_splits, sp = blockIdx.x % p.n_splits;
  const int kvh = blockIdx.y, tile = blockIdx.z, row0 = tile * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int groups = p.n_heads / p.kv_heads;
  const int rows = p.width * groups;
  const int n_live = min(kRows, rows - row0);
  const int len = p.lengths[s];
  const int start = p.starts[s];

  // keys this tile can attend (the last row's position bounds them), the
  // pool blocks that holds, and the splits they fill
  const int keys = min(len, start + (row0 + n_live - 1) / groups + 1);
  const int walked = keys > 0 ? (keys + BS - 1) / BS * BS : 0;
  const int n_used = (walked + p.split_keys - 1) / p.split_keys;
  if (sp >= max(n_used, 1)) return;  // past the live keys: nothing to add

  const auto out_at = [&](int row) {
    const int w = row / groups, h = kvh * groups + row % groups;
    return static_cast<QT*>(p.out) +
           ((static_cast<long long>(s) * p.width + w) * p.n_heads + h) * HD;
  };
  if (n_used == 0) {  // no key at all: output 0
    for (int e = tid; e < n_live * HD; e += kThreads)
      out_at(row0 + e / HD)[e % HD] = from_f32<QT>(0.f);
    return;
  }

  const int k0 = sp * p.split_keys;
  const int n_units = (min(k0 + p.split_keys, walked) - k0) / kUnit;
  const int n_mine = warp < n_units ? (n_units - warp + kWarps - 1) / kWarps
                                    : 0;
  uint8_t* my_ring = ring + warp * kStages * L::kStageBytes;
  const char* kp = static_cast<const char*>(p.k_pool);
  const char* vp = static_cast<const char*>(p.v_pool);
  const int* table = p.tables + static_cast<long long>(s) * p.max_blocks;

  // the copies of this warp's i-th unit into ring stage st
  const auto load_unit = [&](int i, int st) {
    const int key0 = k0 + (warp + i * kWarps) * kUnit;
    const long long blk = table[key0 / BS];
    // (position, head) index of the unit's first key
    const long long pos0 = (blk * BS + key0 % BS) * p.kv_heads + kvh;
    const uint32_t dst = smem_addr(my_ring + st * L::kStageBytes);
    constexpr int kCopies = kUnit * L::kChunks;  // 16-byte copies of K
#pragma unroll
    for (int it = 0; it < (kCopies + 31) / 32; ++it) {
      const int e = it * 32 + lane, key = e / L::kChunks, c = e % L::kChunks;
      if (kCopies % 32 != 0 && e >= kCopies) break;
      const long long src =
          (pos0 + static_cast<long long>(key) * p.kv_heads) * L::kRowBytes +
          c * 16;
      cp_async16(dst + L::offset(key, c), kp + src);
      cp_async16(dst + L::kUnitBytes + L::offset(key, c), vp + src);
    }
    if constexpr (L::kQuant) {
      const int key = lane & 15, which = lane >> 4;
      cp_async4(dst + 2 * L::kUnitBytes + 4 * lane,
                (which ? p.v_scale : p.k_scale) + pos0 +
                    static_cast<long long>(key) * p.kv_heads);
    }
  };

  float m[kRows], l[kRows], acc[kRows][kAcc];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[r][i] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_mine) load_unit(i, i);
    cp_async_commit();
  }
  // query rows of this tile, pre-scaled as the TPU kernel does, while
  // the first units' copies are in flight
  const QT* q = static_cast<const QT*>(p.q);
  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, row = row0 + r;
    float val = 0.f;
    if (r < n_live) {
      const int w = row / groups, h = kvh * groups + row % groups;
      val = to_f32(q[s * p.q_s0 + w * p.q_s1 + h * p.q_s2 + d]) * p.scale;
    }
    q_s[e] = val;
  }
  __syncthreads();  // q_s is in

  const int key = lane & 15, half = lane >> 4;
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<kStages - 1>();  // unit i is in (this lane's copies)
    __syncwarp();                  // ... and every lane's
    const uint8_t* k_t = my_ring + (i % kStages) * L::kStageBytes;
    const uint8_t* v_t = k_t + L::kUnitBytes;
    const float* scales =
        reinterpret_cast<const float*>(v_t + L::kUnitBytes);
    const int key0 = k0 + (warp + i * kWarps) * kUnit;
    const int k_pos = key0 + key;

    // this lane's key slice, in its own type
    float4 kc[kHalf];
    uint2 kh;  // int8 at head_dim 16: 8 bytes, half of the key's chunk
    if constexpr (L::kHalfChunk) {
      kh = *reinterpret_cast<const uint2*>(k_t + key * L::kRowBytes +
                                           half * 8);
    } else {
#pragma unroll
      for (int cc = 0; cc < kHalf; ++cc)
        kc[cc] = *reinterpret_cast<const float4*>(
            k_t + L::offset(key, half * kHalf + cc));
    }
    const float k_scale = L::kQuant ? scales[key] : 1.f;

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= n_live) break;  // warp-uniform
      const int q_pos = start + (row0 + r) / groups;
      const float* qr = q_s + r * HD + half * (HD / 2);
      float sc = 0.f;
      if constexpr (L::kHalfChunk) {
        const int8_t* b = reinterpret_cast<const int8_t*>(&kh);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sc = fmaf(qr[e], static_cast<float>(b[e]), sc);
      } else {
#pragma unroll
        for (int cc = 0; cc < kHalf; ++cc) {
          float kf[L::kVec];
          chunk_to_f32(kc[cc], kf);
#pragma unroll
          for (int e = 0; e < L::kVec; ++e)
            sc = fmaf(qr[cc * L::kVec + e], kf[e], sc);
        }
      }
      sc += __shfl_xor_sync(kFull, sc, 16);
      const bool keep = k_pos < len && k_pos <= q_pos;
      sc = keep ? sc * k_scale : kNegInf;
      float bmax = sc;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(kFull, bmax, off));
      const float m_new = fmaxf(m[r], bmax);
      const float pr = keep ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      float psum = pr;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(kFull, psum, off);
      l[r] = corr * l[r] + psum;
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[r][a] *= corr;
#pragma unroll
      for (int k2 = 0; k2 < kUnit; k2 += kKeyPar) {
        // this lane's key of the step: k2, or k2 + 1 on the second half
        // of the warp at head_dim 16
        const int kk = k2 + lane / kDimLanes;
        const float pk = __shfl_sync(kFull, pr, kk);
        if (pk == 0.f) continue;  // masked (warp-uniform if kKeyPar == 1)
        const float v_scale = L::kQuant ? scales[kUnit + kk] : 1.f;
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          const int d = dim0 + kDimLanes * a;
          const KT* vr = reinterpret_cast<const KT*>(
              v_t + L::offset(kk, d / L::kVec));
          acc[r][a] = fmaf(pk, to_f32(vr[d % L::kVec]) * v_scale, acc[r][a]);
        }
      }
      m[r] = m_new;
    }
    __syncwarp();  // every lane is done with this stage
    if (i + kStages < n_mine) load_unit(i + kStages, i % kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if constexpr (kKeyPar > 1) {  // join the halves' keys: every lane full
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= n_live) break;  // warp-uniform
#pragma unroll
      for (int a = 0; a < kAcc; ++a)
        for (int off = kDimLanes; off < 32; off <<= 1)
          acc[r][a] += __shfl_xor_sync(kFull, acc[r][a], off);
    }
  }
  __syncthreads();  // every warp is done with its ring: the merge reuses it

  // the warps' partials, combined in warp order
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= n_live) break;
    if (lane == 0) {
      m_s[warp * kRows + r] = m[r];
      l_s[warp * kRows + r] = l[r];
    }
    if (owns) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a)
        acc_s[(warp * kRows + r) * HD + dim0 + kDimLanes * a] = acc[r][a];
    }
  }
  __syncthreads();
  const long long tile_id =
      (static_cast<long long>(s) * p.kv_heads + kvh) * gridDim.z + tile;
  for (int r = warp; r < n_live; r += kWarps) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kRows + r]);
    float den = 0.f, num[kAcc];
#pragma unroll
    for (int a = 0; a < kAcc; ++a) num[a] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w * kRows + r] - mx);
      den = fmaf(c, l_s[w * kRows + r], den);
#pragma unroll
      for (int a = 0; a < kAcc; ++a)
        num[a] = fmaf(c, acc_s[(w * kRows + r) * HD + dim0 + kDimLanes * a],
                      num[a]);
    }
    if (n_used == 1) {  // the whole tile in one split: the output
      const bool empty = mx < kNegInf * 0.5f;
      const float inv = empty ? 0.f : 1.f / den;
      QT* o = out_at(row0 + r);
      if (owns) {
#pragma unroll
        for (int a = 0; a < kAcc; ++a)
          o[dim0 + kDimLanes * a] = from_f32<QT>(num[a] * inv);
      }
    } else {
      const long long at = (tile_id * p.n_splits + sp) * kRows + r;
      if (lane == 0) {
        p.part_ml[2 * at] = mx;
        p.part_ml[2 * at + 1] = den;
      }
      if (owns) {
#pragma unroll
        for (int a = 0; a < kAcc; ++a)
          p.part_acc[at * HD + dim0 + kDimLanes * a] = num[a];
      }
    }
  }
  if (n_used == 1) return;

  // the last split to arrive merges every split, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int arrived = atomicAdd(p.tickets + tile_id, 1) + 1;
    last_s = arrived == n_used;
    if (last_s) p.tickets[tile_id] = 0;  // zero again for the next call
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int r = warp; r < n_live; r += kWarps) {
    const long long at0 = tile_id * p.n_splits * kRows + r;
    float mx = kNegInf;
    for (int j = 0; j < n_used; ++j)
      mx = fmaxf(mx, __ldcg(p.part_ml + 2 * (at0 + j * kRows)));
    float den = 0.f, num[kAcc];
#pragma unroll
    for (int a = 0; a < kAcc; ++a) num[a] = 0.f;
    for (int j = 0; j < n_used; ++j) {
      const long long at = at0 + j * kRows;
      const float c = expf(__ldcg(p.part_ml + 2 * at) - mx);
      den = fmaf(c, __ldcg(p.part_ml + 2 * at + 1), den);
#pragma unroll
      for (int a = 0; a < kAcc; ++a)
        num[a] = fmaf(c, __ldcg(p.part_acc + at * HD + dim0 + kDimLanes * a),
                      num[a]);
    }
    const bool empty = mx < kNegInf * 0.5f;
    const float inv = empty ? 0.f : 1.f / den;
    QT* o = out_at(row0 + r);
    if (owns) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a)
        o[dim0 + kDimLanes * a] = from_f32<QT>(num[a] * inv);
    }
  }
}

template <typename QT, typename KT, int HD>
int launch(const Params& p, int streams, cudaStream_t stream) {
  constexpr size_t smem = Layout<KT, HD>::kSmem;
  const auto kernel = paged_attention_kernel<QT, KT, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = p.width * (p.n_heads / p.kv_heads);
  const dim3 grid(streams * p.n_splits, p.kv_heads,
                  (rows + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int dispatch_geometry(int head_dim, const Params& p, int streams,
                      cudaStream_t stream) {
  if (head_dim == 16) return launch<QT, KT, 16>(p, streams, stream);
  if (head_dim == 32) return launch<QT, KT, 32>(p, streams, stream);
  if (head_dim == 64) return launch<QT, KT, 64>(p, streams, stream);
  if (head_dim == 128) return launch<QT, KT, 128>(p, streams, stream);
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only; needs
// the f32 scale pools)
// head_dim 16, 32, 64 or 128; any block size that is a multiple of 16 keys
extern "C" int paged_attention_supported(int head_dim, int block_size) {
  return (head_dim == 16 || head_dim == 32 || head_dim == 64 ||
          head_dim == 128) &&
         block_size > 0 && block_size % kUnit == 0;
}

// split_keys: keys per split, a multiple of block_size; n_splits splits
// cover max_blocks * block_size keys.  part_ml / part_acc: scratch of
// streams x kv_heads x tiles x n_splits x 16 rows x (2 | head_dim) f32;
// tickets: streams x kv_heads x tiles int32, zero on entry, left zero.
// The three are unused, and may be null, when n_splits == 1.
extern "C" int paged_attention_launch(
    int q_dtype, int kv_dtype, int head_dim, int block_size, const void* q,
    long long q_s0, long long q_s1, long long q_s2, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* tables, const void* lengths, const void* starts, void* out,
    void* part_ml, void* part_acc, void* tickets, int streams, int width,
    int n_heads, int kv_heads, int max_blocks, int split_keys, int n_splits,
    float scale, void* stream) {
  if (streams == 0 || width == 0) return 0;
  if (!paged_attention_supported(head_dim, block_size)) return -1;
  if (split_keys <= 0 || split_keys % block_size || n_splits <= 0 ||
      static_cast<long long>(split_keys) * n_splits <
          static_cast<long long>(max_blocks) * block_size)
    return -1;
  Params p;
  p.q = q;
  p.q_s0 = q_s0;
  p.q_s1 = q_s1;
  p.q_s2 = q_s2;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.starts = static_cast<const int*>(starts);
  p.out = out;
  p.part_ml = static_cast<float*>(part_ml);
  p.part_acc = static_cast<float*>(part_acc);
  p.tickets = static_cast<int*>(tickets);
  p.width = width;
  p.n_heads = n_heads;
  p.kv_heads = kv_heads;
  p.max_blocks = max_blocks;
  p.block_size = block_size;
  p.split_keys = split_keys;
  p.n_splits = n_splits;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch_geometry<float, float>(head_dim, p, streams, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_geometry<__nv_bfloat16, __nv_bfloat16>(head_dim, p,
                                                           streams, st);
  if (q_dtype == 0 && kv_dtype == 2)
    return dispatch_geometry<float, int8_t>(head_dim, p, streams, st);
  if (q_dtype == 1 && kv_dtype == 2)
    return dispatch_geometry<__nv_bfloat16, int8_t>(head_dim, p, streams,
                                                    st);
  return -1;
}
