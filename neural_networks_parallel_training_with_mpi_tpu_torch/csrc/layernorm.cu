// Row LayerNorm with f32 statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel neural_networks_parallel_training_with_mpi_tpu/
// ops/pallas_kernels.py:_ln_kernel (called by fused_layernorm there).
// Same function: for every row x of the last dim d,
//   mean = sum(x) / d,  var = sum((x - mean)^2) / d,
//   y = (x - mean) * rsqrt(var + eps) * scale + bias,
// statistics and arithmetic in f32, y stored in x's type.  The variance is
// the mean of squared deviations (as the TPU kernel computes it), not
// E[x^2] - mean^2, which cancels badly for rows with a large mean.
//
// What bounds it on this card: it reads each x element once and writes
// each y element once, with ~8 flops per element, far below the ridge
// point, so the bound is bytes: (x + y + scale + bias) over 3.35 TB/s.
//
// Design: the TPU kernel processed blocks of block_rows rows in VMEM; here
// one warp owns one row and keeps it in registers (lane l holds columns
// l, l + 32, l + 64, ...: each load instruction of the warp reads
// neighbouring addresses), so x is read from device memory exactly once
// for the two passes.  Pass 1: warp-shuffle sum -> mean.  Pass 2: the
// deviations stay in registers, shuffle sum of their squares -> var.
// Then scale, shift and store.  Eight warps (rows) per block; the grid
// covers any row count, the last block masks the rows past the end, and
// columns past d are masked in registers, so any d up to 32 x kMaxPerLane
// works.  block_rows is the TPU's tiling and does not change the result.
// Plain C interface, loaded with ctypes: the launch returns the CUDA error
// code (or -1 for an unsupported combination).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // rows per block
constexpr int kMaxPerLane = 128;   // d <= 4096

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int N>
__global__ void __launch_bounds__(kWarps * 32)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y,
                     long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + row * d;
  float v[N];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d ? to_float(xr[c]) : 0.f;
    sum += v[i];
  }
  const float inv_d = 1.f / static_cast<float>(d);
  const float mean = warp_sum(sum) * inv_d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d ? v[i] - mean : 0.f;
    sq += v[i] * v[i];
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = lane + 32 * i;
    if (c < d) yr[c] = from_float<T>(v[i] * rstd * scale[c] + bias[c]);
  }
}

template <typename T, int N>
int launch_n(const void* x, const void* scale, const void* bias, void* y,
             long long rows, int d, float eps, cudaStream_t st) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  layernorm_kernel<T, N><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                           st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* bias, void* y,
             long long rows, int d, float eps, cudaStream_t st) {
  const int per_lane = (d + 31) / 32;
  if (per_lane <= 4) return launch_n<T, 4>(x, scale, bias, y, rows, d, eps, st);
  if (per_lane <= 8) return launch_n<T, 8>(x, scale, bias, y, rows, d, eps, st);
  if (per_lane <= 16)
    return launch_n<T, 16>(x, scale, bias, y, rows, d, eps, st);
  if (per_lane <= 32)
    return launch_n<T, 32>(x, scale, bias, y, rows, d, eps, st);
  if (per_lane <= 64)
    return launch_n<T, 64>(x, scale, bias, y, rows, d, eps, st);
  if (per_lane <= kMaxPerLane)
    return launch_n<T, kMaxPerLane>(x, scale, bias, y, rows, d, eps, st);
  return -1;
}

}  // namespace

extern "C" int layernorm_max_dim() { return 32 * kMaxPerLane; }

// dtype: 0 float32, 1 bfloat16 (x and y); scale and bias are f32 (d,).
// x and y are contiguous (rows, d).
extern "C" int layernorm_launch(int dtype, const void* x, const void* scale,
                                const void* bias, void* y, long long rows,
                                int d, float eps, void* stream) {
  if (rows == 0) return 0;
  if (d < 1 || d > 32 * kMaxPerLane) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, scale, bias, y, rows, d, eps, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, scale, bias, y, rows, d, eps, st);
  return -1;
}
