// Flash attention forward and FlashAttention-2 backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of neural_networks_parallel_training_with_mpi_tpu/
// ops/pallas_kernels.py: _flash_fwd_kernel (forward, out + lse),
// _flash_bwd_dq_kernel (dq) and _flash_bwd_dkv_kernel (dk, dv), reached by
// flash_attention there.  Same function: scale 1/sqrt(D); mask modes none /
// causal (k <= q) / causal_exclusive (k < q); online softmax in f32; a row
// with no attendable key outputs 0 with lse -1e30 and gets gradient 0; the
// backward recomputes P = exp(s - lse) and uses delta = rowsum(dO * O),
// computed outside the kernels as the JAX package does.
//
// What bounds it on this card: at the training shape (T 1024, D 64, bf16)
// each kernel does 2-4 causal T x T x D products per head, about 64 flops
// per byte moved, so the bound is operations at the bf16 tensor-core rate.
// This first version runs its products on the CUDA cores in f32 (no
// mma/wgmma, no TF32), which keeps the f32 path exact to f32 rounding and
// the code simple; moving the bf16 products onto the tensor cores is the
// next step for these kernels.
//
// Design (not a block-by-block translation of the Pallas kernels, which
// hold a whole K/V row in VMEM):
// - A block of 256 threads owns one 64-row tile: of queries (forward, dq;
//   grid (T/64, B*H)) or of keys (dkv; grid (T/64, B*H)).  It stages its
//   own tile in shared memory as f32 and streams the other operand through
//   shared memory 64 rows at a time.
// - Thread (ty, tx) of a 16 x 16 layout holds the 4 x 4 scores of rows
//   ty + 16i and columns tx + 16j; a row's 16 threads sit in one half-warp,
//   so row max and row sum are xor shuffles.  Probabilities go through
//   shared memory for the value-side products, where the thread owns
//   rows ty + 16i and head dims tx + 16d.
// - The key loop of the forward and dq kernels ends where the TPU kernel's
//   ends (_k_block_hi of the block_q block holding the tile's last row), and
//   the dkv kernel's query loop starts where the TPU kernel's starts (the
//   block_q block holding the first row of the block_k block), so the
//   kernels visit the keys the TPU kernels visit; the extra keys a 64-tile
//   may cover are masked and contribute exactly 0.
// - dq accumulates per query tile and dk/dv per key tile (the FA-2 split):
//   no atomics, deterministic results.
// - q/k/v/out/dO/dq/dk/dv are read and written through their (B, T, H)
//   element strides with head_dim contiguous, so the strided views of the
//   fused qkv projection go in without a copy.
// Plain C interface, loaded with ctypes: each launch returns the CUDA error
// code, or -1 for an unsupported dtype / head_dim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;               // rows of a tile
constexpr int kLanes = 16;              // threads sharing one tile row
constexpr int kThreads = kLanes * kLanes;
constexpr int kPer = kTile / kLanes;    // rows (or columns) per thread
constexpr int kPLd = kTile + 1;         // padded row of a score tile
constexpr unsigned kFull = 0xffffffffu;

constexpr int kMaskNone = 0;
constexpr int kMaskCausal = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename E> __device__ __forceinline__ E from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// element strides of a (B, T, H, D) view; head_dim has stride 1
struct Strides {
  long long b, t, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;       // out / dq / dk
  void* out1;       // dv
  float* lse_out;
  Strides qs, ks, vs, dos, o0s, o1s;
  int batch, n_heads, t, block_q, block_k, mask;
  float scale;
};

__device__ __forceinline__ bool keep(int mask, int q_pos, int k_pos) {
  return mask == kMaskNone ||
         (mask == kMaskCausal ? k_pos <= q_pos : k_pos < q_pos);
}

// exclusive end of the keys the TPU kernel visits for the block_q block
// holding query `row` (pallas_kernels._k_block_hi)
__device__ __forceinline__ int key_end(int mask, int row, int t, int block_q,
                                       int block_k) {
  if (mask == kMaskNone) return t;
  const int qi = row / block_q;
  const int last_k = (qi + 1) * block_q - (mask == kMaskCausal ? 1 : 2);
  const int hi = min(t / block_k, max(0, (last_k + block_k) / block_k));
  return hi * block_k;
}

// first query the TPU dkv kernel visits for the block_k block holding `key`
__device__ __forceinline__ int query_start(int mask, int key, int block_q,
                                           int block_k) {
  if (mask == kMaskNone) return 0;
  const int kj = key / block_k;
  return (kj * block_k / block_q) * block_q;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// rows row0 .. row0+63 of one (b, h) head of a (B, T, H, D) view -> f32
// shared tile [kTile][D + 1] (the +1 keeps the threads of a warp, which
// read 16 different rows at one column, on different banks)
template <typename E, int D>
__device__ __forceinline__ void load_tile(float* dst, const E* __restrict__ src,
                                          Strides s, int b, int h, int row0,
                                          float scale) {
  const E* base = src + b * s.b + h * s.h;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = to_f32(base[(long long)(row0 + r) * s.t + d]) * scale;
  }
}

template <typename E, int D>
__device__ __forceinline__ void store_rows(E* __restrict__ dst, Strides s,
                                           int b, int h, int row0, int ty,
                                           int tx, float (&acc)[kPer][D / kLanes]) {
  E* base = dst + b * s.b + h * s.h;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    E* row = base + (long long)(row0 + ty + kLanes * i) * s.t;
#pragma unroll
    for (int dd = 0; dd < D / kLanes; ++dd)
      row[tx + kLanes * dd] = from_f32<E>(acc[i][dd]);
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kPLd);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPLd);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kPLd + 2 * kTile);
}

// ---------------------------------------------------------------------------
// forward: out, lse for one 64-row query tile
// ---------------------------------------------------------------------------
template <typename E, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int kDims = D / kLanes;
  extern __shared__ float smem[];
  float* q_s = smem;                  // pre-scaled, as the TPU kernel does
  float* k_s = q_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* p_s = v_s + kTile * LD;

  const int row0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / a.n_heads, h = bh % a.n_heads;
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const E* q = static_cast<const E*>(a.q);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);

  load_tile<E, D>(q_s, q, a.qs, b, h, row0, a.scale);
  float m[kPer], l[kPer], acc[kPer][kDims];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) acc[i][dd] = 0.f;
  }

  const int end = key_end(a.mask, row0 + kTile - 1, a.t, a.block_q,
                          a.block_k);
  for (int col0 = 0; col0 < end; col0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    load_tile<E, D>(k_s, k, a.ks, b, h, col0, 1.f);
    load_tile<E, D>(v_s, v, a.vs, b, h, col0, 1.f);
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kPer], kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) qv[i] = q_s[(ty + kLanes * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) kv[j] = k_s[(tx + kLanes * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kLanes * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!keep(a.mask, row0 + r, col0 + tx + kLanes * j)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[r * kPLd + tx + kLanes * j] = p;
        ps += p;
      }
      l[i] = corr * l[i] + row_sum(ps);
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) acc[i][dd] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[kPer], vv[kDims];
#pragma unroll
      for (int i = 0; i < kPer; ++i) pv[i] = p_s[(ty + kLanes * i) * kPLd + c];
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) vv[dd] = v_s[c * LD + tx + kLanes * dd];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int dd = 0; dd < kDims; ++dd)
          acc[i][dd] = fmaf(pv[i], vv[dd], acc[i][dd]);
    }
  }

  // a row whose m never left -1e30 attended no key: output 0, lse -1e30
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const bool empty = m[i] < kNegInf * 0.5f;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd)
      acc[i][dd] = empty ? 0.f : acc[i][dd] / l[i];
    if (tx == 0)
      a.lse_out[(long long)bh * a.t + row0 + ty + kLanes * i] =
          empty ? kNegInf : m[i] + logf(l[i]);
  }
  store_rows<E, D>(static_cast<E*>(a.out0), a.o0s, b, h, row0, ty, tx, acc);
}

// ---------------------------------------------------------------------------
// backward dq for one 64-row query tile
// ---------------------------------------------------------------------------
template <typename E, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int kDims = D / kLanes;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;

  const int row0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / a.n_heads, h = bh % a.n_heads;
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);

  load_tile<E, D>(q_s, static_cast<const E*>(a.q), a.qs, b, h, row0, 1.f);
  load_tile<E, D>(do_s, static_cast<const E*>(a.dout), a.dos, b, h, row0, 1.f);
  float lse[kPer], delta[kPer], dq[kPer][kDims];
  bool live[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long idx = (long long)bh * a.t + row0 + ty + kLanes * i;
    lse[i] = a.lse_in[idx];
    live[i] = lse[i] > kNegInf * 0.5f;   // no-key rows: gradient 0
    lse[i] = live[i] ? lse[i] : 0.f;
    delta[i] = a.delta[idx];
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) dq[i][dd] = 0.f;
  }

  const int end = key_end(a.mask, row0 + kTile - 1, a.t, a.block_q,
                          a.block_k);
  for (int col0 = 0; col0 < end; col0 += kTile) {
    __syncthreads();
    load_tile<E, D>(k_s, k, a.ks, b, h, col0, 1.f);
    load_tile<E, D>(v_s, v, a.vs, b, h, col0, 1.f);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kPer], dov[kPer], kv[kPer], vv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qv[i] = q_s[(ty + kLanes * i) * LD + d];
        dov[i] = do_s[(ty + kLanes * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        kv[j] = k_s[(tx + kLanes * j) * LD + d];
        vv[j] = v_s[(tx + kLanes * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kLanes * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kLanes * j;
        const float sc = keep(a.mask, row0 + r, col0 + c) ? s[i][j] * a.scale
                                                          : kNegInf;
        const float p = live[i] ? expf(sc - lse[i]) : 0.f;
        ds_s[r * kPLd + c] = p * (dp[i][j] - delta[i]) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[kPer], kv[kDims];
#pragma unroll
      for (int i = 0; i < kPer; ++i) dsv[i] = ds_s[(ty + kLanes * i) * kPLd + c];
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) kv[dd] = k_s[c * LD + tx + kLanes * dd];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int dd = 0; dd < kDims; ++dd)
          dq[i][dd] = fmaf(dsv[i], kv[dd], dq[i][dd]);
    }
  }
  store_rows<E, D>(static_cast<E*>(a.out0), a.o0s, b, h, row0, ty, tx, dq);
}

// ---------------------------------------------------------------------------
// backward dk, dv for one 64-key tile
// ---------------------------------------------------------------------------
template <typename E, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int kDims = D / kLanes;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = q_s + kTile * LD;
  float* p_s = do_s + kTile * LD;
  float* ds_s = p_s + kTile * kPLd;
  float* lse_s = ds_s + kTile * kPLd;
  float* delta_s = lse_s + kTile;

  const int col0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / a.n_heads, h = bh % a.n_heads;
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const E* q = static_cast<const E*>(a.q);
  const E* dout = static_cast<const E*>(a.dout);

  load_tile<E, D>(k_s, static_cast<const E*>(a.k), a.ks, b, h, col0, 1.f);
  load_tile<E, D>(v_s, static_cast<const E*>(a.v), a.vs, b, h, col0, 1.f);
  // thread owns keys ty + 16i and head dims tx + 16dd of dk and dv
  float dk[kPer][kDims], dv[kPer][kDims];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) dk[i][dd] = dv[i][dd] = 0.f;

  const int start =
      query_start(a.mask, col0, a.block_q, a.block_k) / kTile * kTile;
  for (int row0 = start; row0 < a.t; row0 += kTile) {
    __syncthreads();
    load_tile<E, D>(q_s, q, a.qs, b, h, row0, 1.f);
    load_tile<E, D>(do_s, dout, a.dos, b, h, row0, 1.f);
    if (threadIdx.x < kTile) {
      const long long idx = (long long)bh * a.t + row0 + threadIdx.x;
      lse_s[threadIdx.x] = a.lse_in[idx];
      delta_s[threadIdx.x] = a.delta[idx];
    }
    __syncthreads();

    // scores: queries ty + 16i, keys tx + 16j
    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kPer], dov[kPer], kv[kPer], vv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qv[i] = q_s[(ty + kLanes * i) * LD + d];
        dov[i] = do_s[(ty + kLanes * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        kv[j] = k_s[(tx + kLanes * j) * LD + d];
        vv[j] = v_s[(tx + kLanes * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kLanes * i;
      const float lse = lse_s[r];
      const bool live = lse > kNegInf * 0.5f;
      const float lse_safe = live ? lse : 0.f;
      const float delta = delta_s[r];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kLanes * j;
        const float sc = keep(a.mask, row0 + r, col0 + c) ? s[i][j] * a.scale
                                                          : kNegInf;
        const float p = live ? expf(sc - lse_safe) : 0.f;
        p_s[r * kPLd + c] = p;
        ds_s[r * kPLd + c] = p * (dp[i][j] - delta) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pv[kPer], dsv[kPer], dov[kDims], qv[kDims];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pv[i] = p_s[r * kPLd + ty + kLanes * i];
        dsv[i] = ds_s[r * kPLd + ty + kLanes * i];
      }
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) {
        dov[dd] = do_s[r * LD + tx + kLanes * dd];
        qv[dd] = q_s[r * LD + tx + kLanes * dd];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int dd = 0; dd < kDims; ++dd) {
          dv[i][dd] = fmaf(pv[i], dov[dd], dv[i][dd]);
          dk[i][dd] = fmaf(dsv[i], qv[dd], dk[i][dd]);
        }
    }
  }
  store_rows<E, D>(static_cast<E*>(a.out0), a.o0s, b, h, col0, ty, tx, dk);
  store_rows<E, D>(static_cast<E*>(a.out1), a.o1s, b, h, col0, ty, tx, dv);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.t / kTile, a.batch * a.n_heads);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// which: 0 = forward, 1 = dq, 2 = dkv
template <typename E, int D>
int launch_which(int which, const Args& a, cudaStream_t stream) {
  if (which == 0) return launch(flash_fwd_kernel<E, D>, fwd_smem<D>(), a, stream);
  if (which == 1) return launch(flash_dq_kernel<E, D>, dq_smem<D>(), a, stream);
  return launch(flash_dkv_kernel<E, D>, dkv_smem<D>(), a, stream);
}

template <typename E>
int dispatch_head_dim(int which, int head_dim, const Args& a,
                      cudaStream_t stream) {
  if (head_dim == 32) return launch_which<E, 32>(which, a, stream);
  if (head_dim == 64) return launch_which<E, 64>(which, a, stream);
  if (head_dim == 128) return launch_which<E, 128>(which, a, stream);
  return -1;
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

extern "C" int flash_attention_supported(int head_dim) {
  return head_dim == 32 || head_dim == 64 || head_dim == 128;
}

extern "C" int flash_attention_tile() { return kTile; }

// One entry for the three kernels.  strides: 3 per tensor, in the order
// q, k, v, dout, out0, out1 (the entries of tensors a kernel does not take
// are ignored).  dtype: 0 = float32, 1 = bfloat16.  mask: 0 none,
// 1 causal, 2 causal_exclusive.  The caller guarantees t % 64 == 0.
extern "C" int flash_attention_launch(
    int which, int dtype, int head_dim, const void* q, const void* k,
    const void* v, const void* dout, const void* lse_in, const void* delta,
    void* out0, void* out1, void* lse_out, const long long* strides,
    int batch, int n_heads, int t, int block_q, int block_k, int mask,
    float scale, void* stream) {
  if (batch == 0 || n_heads == 0 || t == 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse_in);
  a.delta = static_cast<const float*>(delta);
  a.out0 = out0;
  a.out1 = out1;
  a.lse_out = static_cast<float*>(lse_out);
  a.qs = strides_at(strides, 0);
  a.ks = strides_at(strides, 1);
  a.vs = strides_at(strides, 2);
  a.dos = strides_at(strides, 3);
  a.o0s = strides_at(strides, 4);
  a.o1s = strides_at(strides, 5);
  a.batch = batch;
  a.n_heads = n_heads;
  a.t = t;
  a.block_q = block_q;
  a.block_k = block_k;
  a.mask = mask;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_head_dim<float>(which, head_dim, a, st);
  if (dtype == 1) return dispatch_head_dim<__nv_bfloat16>(which, head_dim, a, st);
  return -1;
}
