// delta = rowsum(dO * O) - g_lse in f32: the row statistic of the flash
// backward, shared by both kernel designs' backward entries
// (flash_attention_sm90.cu for bf16 at head_dim 32-128,
// flash_attention.cu for f32 and for bf16 at head_dim 8 and 16).
//
// No TPU kernel: the JAX package computes it in XLA, one fused
// elementwise reduce in _flash_backward
// (neural_networks_parallel_training_with_mpi_tpu/ops/pallas_kernels.py
// :366-369), and ops/flash_attention.py:flash_delta is its plain version.
//
// What bounds it on this card: bytes.  It reads O and dO once (2 x 4.2 MB
// in bf16 at the ring shard (8, 256, 16, 64)) and writes one f32 per row,
// about 2.6 us at 3.35 TB/s; the few flops per byte are nothing.  Done in
// eager PyTorch it took two f32 casts, a product, a sum, a permute, a
// subtraction and a copy: ~7 launches and ~59 MB moved.
//
// Design: lanes of a warp share a row (one (b, t, h) position, D
// elements): 16-byte loads of 8 bf16 (the wrapper guarantees 16-byte
// aligned rows to every bf16 launch), or one f32 per lane (any alignment); the partial sums
// meet by xor shuffles within the row's lanes.  Rows are numbered in the
// output's (b, h, t) order, so delta (B*H, T) is written contiguous;
// O and dO are read through their (B, T, H) element strides and g_lse
// through its two (B*H, T) strides (it may arrive strided from the ring
// merge's gradient).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_delta {

constexpr int kThreads = 256;

// element strides of a (B, T, H, D) view; head_dim has stride 1
struct View {
  long long b, t, h;
};

template <typename T>
struct Args {
  const T* out;
  const T* dout;
  const float* g_lse;  // (B*H, T) or null
  float* delta;        // (B*H, T), contiguous
  View os, dos;
  long long g_bh, g_t;
  int n_heads, t;
  long long n_rows;  // B*H*T
};

// kElems elements per lane load, and their dot product in f32
template <typename T>
struct Load;

template <>
struct Load<float> {
  static constexpr int kElems = 1;
  static __device__ __forceinline__ float dot(const float* a,
                                              const float* b) {
    return a[0] * b[0];
  }
};

template <>
struct Load<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ float dot(const __nv_bfloat16* a,
                                              const __nv_bfloat16* b) {
    const uint4 x = *reinterpret_cast<const uint4*>(a);
    const uint4 y = *reinterpret_cast<const uint4*>(b);
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = __bfloat1622float2(xa[i]);
      const float2 v = __bfloat1622float2(ya[i]);
      s = fmaf(u.x, v.x, s);
      s = fmaf(u.y, v.y, s);
    }
    return s;
  }
};

template <typename T, int D>
struct Shape {
  static constexpr int kElems = Load<T>::kElems;
  // lanes per row
  static constexpr int kLanes = D / kElems < 32 ? D / kElems : 32;
  static constexpr int kIters = D / (kElems * kLanes);
  static constexpr int kRowsPerBlock = kThreads / kLanes;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_delta_kernel(const Args<T> a) {
  using S = Shape<T, D>;
  const long long row =
      static_cast<long long>(blockIdx.x) * S::kRowsPerBlock +
      threadIdx.x / S::kLanes;
  const int sub = threadIdx.x % S::kLanes;
  const bool live = row < a.n_rows;
  long long bh = 0;
  int ti = 0;
  float acc = 0.f;
  if (live) {
    bh = row / a.t;
    ti = static_cast<int>(row - bh * a.t);
    const long long b = bh / a.n_heads, h = bh % a.n_heads;
    const T* o = a.out + b * a.os.b + ti * a.os.t + h * a.os.h;
    const T* g = a.dout + b * a.dos.b + ti * a.dos.t + h * a.dos.h;
#pragma unroll
    for (int it = 0; it < S::kIters; ++it) {
      const int e = (it * S::kLanes + sub) * S::kElems;
      acc += Load<T>::dot(o + e, g + e);
    }
  }
  // every lane takes part: a row's lanes are kLanes aligned neighbours
#pragma unroll
  for (int off = S::kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && sub == 0) {
    if (a.g_lse != nullptr) acc -= a.g_lse[bh * a.g_bh + ti * a.g_t];
    a.delta[row] = acc;
  }
}

template <typename T, int D>
int launch(const Args<T>& a, cudaStream_t stream) {
  constexpr int kRows = Shape<T, D>::kRowsPerBlock;
  const unsigned blocks =
      static_cast<unsigned>((a.n_rows + kRows - 1) / kRows);
  flash_delta_kernel<T, D><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// head_dim 8 / 16 / 32 / 64 / 128; -1 for any other
template <typename T>
int launch_head_dim(int head_dim, const Args<T>& a, cudaStream_t stream) {
  if (a.n_rows == 0) return 0;
  if (head_dim == 8) return launch<T, 8>(a, stream);
  if (head_dim == 16) return launch<T, 16>(a, stream);
  if (head_dim == 32) return launch<T, 32>(a, stream);
  if (head_dim == 64) return launch<T, 64>(a, stream);
  if (head_dim == 128) return launch<T, 128>(a, stream);
  return -1;
}

}  // namespace flash_delta
