// Row normalisation: layer_norm or rms_norm with an optional affine.
//
// Replaces laser_tpu/ops/norm.py:28 _build_norm.
//
// What bounds it on the H100: one read and one write of the rows (4096 x 2048
// on the serving slice's prefill, 8 x 2048 at decode), so HBM bytes. Design:
// one block per row (32 threads, a single warp, for rows narrower than 256),
// statistics in fp32 over the logical columns. The row is read up to three
// times (sum, centred sum of squares, write); the second and third reads hit
// L1/L2, so HBM sees it once. Two-pass centred variance, as the TPU kernel.
#include "common.cuh"

namespace {

using ltt::from_f32;
using ltt::to_f32;

enum Kind { kLayer = 0, kRms = 1 };

template <typename T>
__global__ void norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                            const float* __restrict__ beta, T* __restrict__ y, int cols,
                            int kind, float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  const float inv_n = 1.f / static_cast<float>(cols);

  float mean = 0.f;
  float s = 0.f;
  if (kind == kLayer) {
    for (int c = threadIdx.x; c < cols; c += blockDim.x) s += to_f32(xr[c]);
    mean = ltt::block_sum(s, red) * inv_n;
    s = 0.f;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const float d = to_f32(xr[c]) - mean;
      s += d * d;
    }
  } else {
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const float v = to_f32(xr[c]);
      s += v * v;
    }
  }
  const float rstd = rsqrtf(ltt::block_sum(s, red) * inv_n + eps);

  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float v = (to_f32(xr[c]) - mean) * rstd;
    if (gamma) v *= gamma[c];
    if (beta) v += beta[c];
    yr[c] = from_f32<T>(v);
  }
}

template <typename T>
void launch(const void* x, const float* g, const float* b, void* y, int rows, int cols, int kind,
            float eps, cudaStream_t s) {
  const int threads = cols >= 1024 ? 256 : (cols >= 256 ? 128 : 32);
  norm_kernel<T><<<rows, threads, 0, s>>>(static_cast<const T*>(x), g, b, static_cast<T*>(y),
                                          cols, kind, eps);
}

}  // namespace

// x, y: (rows, cols) contiguous in dtype; gamma, beta: (cols,) fp32 or null.
LTT_API int ltt_norm(const void* x, const void* gamma, const void* beta, void* y, int rows,
                     int cols, int kind, float eps, int dtype, void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32)
    launch<float>(x, g, b, y, rows, cols, kind, eps, s);
  else if (dtype == ltt::kBF16)
    launch<__nv_bfloat16>(x, g, b, y, rows, cols, kind, eps, s);
  else
    launch<__half>(x, g, b, y, rows, cols, kind, eps, s);
  return ltt::launch_status();
}
