// Positional uint32 digest (plus an advisory f32 fold) of many tensors in
// one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this with XLA ops
// inside one jitted program (neural_networks_parallel_training_with_mpi_tpu/
// utils/consistency.py: Fingerprinter.device_fp).  It is the fast path of
// the replica-consistency check: every rank folds its replicated training
// state into a few bytes, the ranks gather them, and a single flipped bit
// anywhere shows as a differing digest.  Same function, per leaf l:
//   s_l = sum_i bits(x_l[i]) * ((i * 0x9E3779B9) | 1)            mod 2^32
//   fold_l = sum_{i % 64 == 0} |x_l[i]|   (f32, float leaves only)
// with bits() the raw pattern as uint32 (f32 bitcast, bf16/f16 zero-
// extended, int8 sign-extended, uint8/bool zero-extended, int32 as is,
// int64 its low 32 bits) and i the element's index inside its leaf; then
// the leaves are chained FNV-style, h = h * 16777619 + s_l from
// h = 0x811C9DC5, and the folds summed in leaf order.
//
// What bounds it on this card: each element is read once and takes a few
// integer operations, so the bound is bytes: the state's bytes over
// 3.35 TB/s (2.63 GB, ~0.79 ms, for the 219M-parameter flagship's params
// plus Adam's two moments).
//
// Design: the wrapper cuts every leaf into chunks of kChunk elements and
// uploads a table of (leaf, first element) per chunk, beside a table of
// (pointer, size, type code) per leaf; one block reduces one chunk, so a
// launch covers every leaf whatever their sizes.  Each thread keeps a
// uint32 partial (the position factor is computed on the fly, no
// temporary) and four independent loads in flight; the block reduces by
// warp shuffles and adds its partial to its leaf's slot with atomicAdd.
// Integer addition mod 2^32 is order-free, so the digests are bitwise
// deterministic and equal to the plain version; only the advisory f32
// fold depends on the order of its atomics.  A one-thread second kernel
// chains the leaves.  Plain C interface, loaded with ctypes: the launch
// returns the CUDA error code.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kChunk = 1LL << 18;   // must equal ops/fingerprint.py
constexpr uint32_t kPosMul = 0x9E3779B9u;   // -1640531527 mod 2^32
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kFnvBasis = 0x811C9DC5u;  // -2128831035 mod 2^32

// type codes, as ops/fingerprint.py assigns them
enum Code { kF32 = 0, kBF16 = 1, kI32 = 2, kF16 = 3, kI8 = 4, kU8 = 5,
            kI64 = 6 };

template <int C>
struct Elem;
template <>
struct Elem<kF32> {
  using T = uint32_t;
  static constexpr bool kFloat = true;
  __device__ static uint32_t bits(T v) { return v; }
  __device__ static float value(T v) { return __uint_as_float(v); }
};
template <>
struct Elem<kI32> {
  using T = uint32_t;
  static constexpr bool kFloat = false;
  __device__ static uint32_t bits(T v) { return v; }
  __device__ static float value(T) { return 0.f; }
};
template <>
struct Elem<kBF16> {
  using T = uint16_t;
  static constexpr bool kFloat = true;
  __device__ static uint32_t bits(T v) { return v; }
  __device__ static float value(T v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
};
template <>
struct Elem<kF16> {
  using T = uint16_t;
  static constexpr bool kFloat = true;
  __device__ static uint32_t bits(T v) { return v; }
  __device__ static float value(T v) {
    return __half2float(__ushort_as_half(v));
  }
};
template <>
struct Elem<kI8> {
  using T = int8_t;
  static constexpr bool kFloat = false;
  __device__ static uint32_t bits(T v) {
    return static_cast<uint32_t>(static_cast<int32_t>(v));
  }
  __device__ static float value(T) { return 0.f; }
};
template <>
struct Elem<kU8> {
  using T = uint8_t;
  static constexpr bool kFloat = false;
  __device__ static uint32_t bits(T v) { return v; }
  __device__ static float value(T) { return 0.f; }
};
template <>
struct Elem<kI64> {
  using T = unsigned long long;
  static constexpr bool kFloat = false;
  __device__ static uint32_t bits(T v) { return static_cast<uint32_t>(v); }
  __device__ static float value(T) { return 0.f; }
};

template <int C>
__device__ __forceinline__ void chunk_sum(const void* ptr, long long begin,
                                          long long end, uint32_t* s,
                                          float* f) {
  using E = Elem<C>;
  const typename E::T* __restrict__ x =
      static_cast<const typename E::T*>(ptr);
  uint32_t acc = 0;
  float fold = 0.f;
  long long i = begin + threadIdx.x;
  constexpr long long kStep = static_cast<long long>(kThreads) * kUnroll;
  // full tiles: kUnroll independent loads per thread in flight
  for (; i + (kUnroll - 1) * kThreads < end; i += kStep) {
    typename E::T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = x[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * kThreads;
      acc += E::bits(v[u]) * ((static_cast<uint32_t>(j) * kPosMul) | 1u);
      if (E::kFloat && (j & 63) == 0) fold += fabsf(E::value(v[u]));
    }
  }
  for (; i < end; i += kThreads) {
    const typename E::T v = x[i];
    acc += E::bits(v) * ((static_cast<uint32_t>(i) * kPosMul) | 1u);
    if (E::kFloat && (i & 63) == 0) fold += fabsf(E::value(v));
  }
  *s = acc;
  *f = fold;
}

__global__ void __launch_bounds__(kThreads)
    fingerprint_chunks(const long long* __restrict__ leaves,
                       const long long* __restrict__ chunks,
                       uint32_t* __restrict__ digests,
                       float* __restrict__ folds) {
  const long long leaf = chunks[2 * blockIdx.x];
  const long long begin = chunks[2 * blockIdx.x + 1];
  const void* ptr = reinterpret_cast<const void*>(leaves[3 * leaf]);
  const long long size = leaves[3 * leaf + 1];
  const int code = static_cast<int>(leaves[3 * leaf + 2]);
  const long long end = begin + kChunk < size ? begin + kChunk : size;
  uint32_t s = 0;
  float f = 0.f;
  switch (code) {   // uniform over the block
    case kF32: chunk_sum<kF32>(ptr, begin, end, &s, &f); break;
    case kBF16: chunk_sum<kBF16>(ptr, begin, end, &s, &f); break;
    case kI32: chunk_sum<kI32>(ptr, begin, end, &s, &f); break;
    case kF16: chunk_sum<kF16>(ptr, begin, end, &s, &f); break;
    case kI8: chunk_sum<kI8>(ptr, begin, end, &s, &f); break;
    case kU8: chunk_sum<kU8>(ptr, begin, end, &s, &f); break;
    default: chunk_sum<kI64>(ptr, begin, end, &s, &f); break;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    f += __shfl_xor_sync(0xffffffffu, f, off);
  }
  __shared__ uint32_t ws[kThreads / 32];
  __shared__ float wf[kThreads / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    ws[warp] = s;
    wf[warp] = f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t bs = 0;
    float bf = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      bs += ws[w];
      bf += wf[w];
    }
    atomicAdd(digests + leaf, bs);
    if (bf != 0.f) atomicAdd(folds + leaf, bf);
  }
}

// slot n_leaves: the chained digest and the summed fold
__global__ void fingerprint_chain(int n_leaves, uint32_t* digests,
                                  float* folds) {
  uint32_t h = kFnvBasis;
  float fold = 0.f;
  for (int l = 0; l < n_leaves; ++l) {
    h = h * kFnvPrime + digests[l];
    fold += folds[l];
  }
  digests[n_leaves] = h;
  folds[n_leaves] = fold;
}

}  // namespace

extern "C" {

long long fingerprint_chunk_elems() { return kChunk; }

// leaves: device int64 (n_leaves, 3) = (pointer, elements, type code);
// chunks: device int64 (n_chunks, 2) = (leaf, first element);
// digests (uint32) and folds (f32): n_leaves + 1 slots each, zeroed here.
int fingerprint_launch(const long long* leaves, const long long* chunks,
                       int n_leaves, long long n_chunks, void* digests,
                       void* folds, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_leaves < 0 || n_chunks < 0 || n_chunks > 0x7fffffffLL) return -1;
  cudaError_t e = cudaMemsetAsync(digests, 0, (n_leaves + 1) * 4, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(folds, 0, (n_leaves + 1) * 4, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_chunks > 0) {
    fingerprint_chunks<<<static_cast<unsigned>(n_chunks), kThreads, 0, st>>>(
        leaves, chunks, static_cast<uint32_t*>(digests),
        static_cast<float*>(folds));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fingerprint_chain<<<1, 1, 0, st>>>(n_leaves,
                                     static_cast<uint32_t*>(digests),
                                     static_cast<float*>(folds));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
