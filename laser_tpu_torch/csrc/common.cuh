// Shared device helpers for the laser_tpu_torch kernels.
//
// Every kernel library entry point is a plain C function (extern "C") that
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LTT_API extern "C" __attribute__((visibility("default")))

namespace ltt {

// dtype codes shared with laser_tpu_torch/registry.py (DTYPE_CODES; kI8 in
// POOL_DTYPE_CODES: the int8 KV pages of the paged attention kernel and the
// int8 GEMM's inputs; kI32 the int8 GEMM's accumulator output, GEMM_DTYPE_CODES)
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kI32 = 4 };

// finite "minus infinity": keeps exp() and the running-max rescale NaN-free
// (laser_tpu/ops/attention.py:37)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}
template <> __device__ __forceinline__ int8_t from_f32<int8_t>(float x) {
  return static_cast<int8_t>(x);
}

// x rounded through T and back: the point where the TPU kernels cast the
// softmax probabilities to the input dtype before the P.V product
template <typename T> __device__ __forceinline__ float round_through(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the whole block; every thread gets the total. `red` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // `red` may still be read from the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
  return warp_sum(t);
}

// Max over the whole block; every thread gets it. `red` holds 32 floats.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();  // `red` may still be read from the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : -INFINITY;
  return warp_max(t);
}

// merge (m2, s2) into (m, s): s is the sum of exp(x - m) over the merged set
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both sets empty
  s = (m == -INFINITY ? 0.f : s * expf(m - mn)) + (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mn));
  m = mn;
}

// Block-wide merge; every thread gets the row's (m, s). `red` holds 64 floats.
__device__ __forceinline__ void block_lse(float& m, float& s, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lse_merge(m, s, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, s, o));
  __syncthreads();
  if (lane == 0) {
    red[warp] = m;
    red[32 + warp] = s;
  }
  __syncthreads();
  m = lane < nwarps ? red[lane] : -INFINITY;
  s = lane < nwarps ? red[32 + lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lse_merge(m, s, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, s, o));
}

// elements of T in one 16-byte vector
template <typename T> __host__ __device__ constexpr int vec_n() { return 16 / sizeof(T); }

// Call f(c, x_c) for every column of the row, thread-strided; `vec` selects
// 16-byte loads (row width a multiple of the vector and the row aligned).
template <typename T, typename F>
__device__ __forceinline__ void for_row(const T* __restrict__ row, int V, bool vec, F f) {
  constexpr int N = vec_n<T>();
  if (vec) {
    for (int c0 = threadIdx.x * N; c0 < V; c0 += blockDim.x * N) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + c0);
      const T* wv = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int e = 0; e < N; ++e) f(c0 + e, to_f32(wv[e]));
    }
  } else {
    for (int c = threadIdx.x; c < V; c += blockDim.x) f(c, to_f32(row[c]));
  }
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K> inline int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace ltt
