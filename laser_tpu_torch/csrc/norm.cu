// Row normalisation: layer_norm or rms_norm with an optional affine.
//
// Replaces laser_tpu/ops/norm.py:28 _build_norm: statistics in fp32 over the
// logical columns, two-pass centred variance (the mean, then the sum of
// (v - mean)^2), the affine with gamma / beta converted to fp32 in the
// kernel, one rounding to x's dtype.
//
// What bounds it on the H100: one read and one write of the rows (4096 x
// 2048 on the serving slice's prefill, 8 x 2048 at decode), so HBM bytes.
// gamma and beta are read in their own dtype (f32, bf16 or f16, a code
// each), as laser_tpu casts them inside its kernel: a call is one launch and
// allocates only its output.
//
// Two routes, each with its own counter in ops/norm.py:
// - "vec" (norm_vec_kernel): the row read once into registers by 16-byte
//   loads (8 bf16/f16 or 4 f32 a vector, at most NV_MAX_VPT vectors a
//   thread) and written once by 16-byte stores. Rows of up to 32 *
//   NV_MAX_VPT vectors (1024 bf16 columns) take one warp each, eight rows a
//   256-thread block, so decode's 8 rows are one block; wider rows take a
//   256-thread block each (a 2048-wide bf16 row is one vector a thread, the
//   Llama width 4096 two). Sums by warp shuffles and, across a block's
//   warps, one shared-memory step; the centred sum is taken from the
//   registers. It takes rows whose width is a whole number of vectors, of
//   at most 256 * NV_MAX_VPT vectors (8192 bf16 / 4096 f32 columns), with
//   x, y, gamma and beta at 16-byte-aligned bases.
// - "classic" (norm_kernel): one block per row (a single warp for rows
//   narrower than 256), scalar loads, the row read up to three times (sum,
//   centred sum, write; L1/L2 serve the re-reads). It takes every other row:
//   a ragged vector tail, an unaligned view, rows past the register budget
//   (the choice of this source: no looping variant of the vec kernel).
#include "hopper.cuh"

namespace {

using ltt::from_f32;
using ltt::to_f32;
using ltt::hp::aligned16;

enum Kind { kLayer = 0, kRms = 1 };
enum Route { kRouteAuto = 0, kRouteClassic = 1, kRouteVec = 2 };

constexpr int NV_THREADS = 256;
constexpr int NV_MAX_VPT = 4;  // 16-byte vectors a thread: the register budget

// gain i of a (cols,) vector in dtype code `code`, as fp32
__device__ __forceinline__ float gain_at(const void* p, int code, int i) {
  if (code == ltt::kF32) return static_cast<const float*>(p)[i];
  if (code == ltt::kBF16) return to_f32(static_cast<const __nv_bfloat16*>(p)[i]);
  return to_f32(static_cast<const __half*>(p)[i]);
}

template <typename T>
__global__ void norm_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                            const void* __restrict__ beta, T* __restrict__ y, int cols, int kind,
                            float eps, int gcode, int bcode) {
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
    if (gamma) v *= gain_at(gamma, gcode, c);
    if (beta) v += gain_at(beta, bcode, c);
    yr[c] = from_f32<T>(v);
  }
}

// the N gains of columns c0 .. c0 + N - 1 (c0 a multiple of N, the base
// 16-byte aligned), as fp32
template <int N>
__device__ __forceinline__ void gains(const void* p, int code, int c0, float (&g)[N]) {
  if (code == ltt::kF32) {
    const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(p) + c0);
#pragma unroll
    for (int e = 0; e < N / 4; ++e) {
      const float4 w = f[e];
      g[4 * e] = w.x;
      g[4 * e + 1] = w.y;
      g[4 * e + 2] = w.z;
      g[4 * e + 3] = w.w;
    }
    return;
  }
  // N 16-bit values: 16 bytes for N 8, 8 for N 4
  uint32_t w[N / 2];
  const char* base = static_cast<const char*>(p) + (size_t)c0 * 2;
  if constexpr (N == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(base);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(base);
    w[0] = v.x, w[1] = v.y;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const uint16_t b = static_cast<uint16_t>(w[e / 2] >> (16 * (e % 2)));
    g[e] = code == ltt::kBF16 ? __bfloat162float(__ushort_as_bfloat16(b))
                              : __half2float(__ushort_as_half(b));
  }
}

// a sum over the TPR threads of one row: a warp's shuffles, or the block's
template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
  if constexpr (TPR == 32) return ltt::warp_sum(v);
  else return ltt::block_sum(v, red);
}

// TPR threads a row (32: a warp, eight rows a block; 256: the block), VPT
// 16-byte vectors a thread, held in registers.
template <typename T, int TPR, int VPT>
__global__ void __launch_bounds__(NV_THREADS)
    norm_vec_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                    const void* __restrict__ beta, T* __restrict__ y, int rows, int cols,
                    int kind, float eps, int gcode, int bcode) {
  constexpr int N = ltt::vec_n<T>();
  constexpr int RPB = NV_THREADS / TPR;
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * RPB + threadIdx.x / TPR;
  const int li = threadIdx.x % TPR;
  if (TPR == 32 && row >= (size_t)rows) return;  // a whole warp: no barrier follows
  const int nvec = cols / N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * cols);
  uint4* yr = reinterpret_cast<uint4*>(y + row * cols);
  const float inv_n = 1.f / static_cast<float>(cols);

  float v[VPT][N];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = li + TPR * i;
    if (c < nvec) {
      const uint4 w = xr[c];
      const T* wv = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int e = 0; e < N; ++e) v[i][e] = to_f32(wv[e]);
    }
  }
  float mean = 0.f;
  if (kind == kLayer) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (li + TPR * i < nvec) {
#pragma unroll
        for (int e = 0; e < N; ++e) s += v[i][e];
      }
    }
    mean = row_sum<TPR>(s, red) * inv_n;
  }
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (li + TPR * i < nvec) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float d = v[i][e] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(row_sum<TPR>(q, red) * inv_n + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = li + TPR * i;
    if (c < nvec) {
      float o[N];
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = (v[i][e] - mean) * rstd;
      if (gamma) {
        float g[N];
        gains<N>(gamma, gcode, c * N, g);
#pragma unroll
        for (int e = 0; e < N; ++e) o[e] *= g[e];
      }
      if (beta) {
        float b[N];
        gains<N>(beta, bcode, c * N, b);
#pragma unroll
        for (int e = 0; e < N; ++e) o[e] += b[e];
      }
      uint4 w;
      T* wv = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int e = 0; e < N; ++e) wv[e] = from_f32<T>(o[e]);
      yr[c] = w;
    }
  }
}

template <typename T>
bool vec_fits(const void* x, const void* g, const void* b, const void* y, int cols) {
  constexpr int N = ltt::vec_n<T>();
  return cols % N == 0 && cols / N <= NV_THREADS * NV_MAX_VPT && aligned16(x) &&
         aligned16(y) && (!g || aligned16(g)) && (!b || aligned16(b));
}

template <typename T, int TPR, int VPT>
void launch_vec(const void* x, const void* g, const void* b, void* y, int rows, int cols,
                int kind, float eps, int gcode, int bcode, cudaStream_t s) {
  constexpr int RPB = NV_THREADS / TPR;
  norm_vec_kernel<T, TPR, VPT><<<(rows + RPB - 1) / RPB, NV_THREADS, 0, s>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(y), rows, cols, kind, eps, gcode, bcode);
}

// the fewest threads a row (a warp up to 32 * NV_MAX_VPT vectors) and then
// the fewest vectors a thread
template <typename T, int TPR>
void launch_vpt(const void* x, const void* g, const void* b, void* y, int rows, int cols,
                int kind, float eps, int gcode, int bcode, cudaStream_t s) {
  const int vpt = (cols / ltt::vec_n<T>() + TPR - 1) / TPR;
  if (vpt <= 1) launch_vec<T, TPR, 1>(x, g, b, y, rows, cols, kind, eps, gcode, bcode, s);
  else if (vpt == 2) launch_vec<T, TPR, 2>(x, g, b, y, rows, cols, kind, eps, gcode, bcode, s);
  else if (vpt == 3) launch_vec<T, TPR, 3>(x, g, b, y, rows, cols, kind, eps, gcode, bcode, s);
  else launch_vec<T, TPR, 4>(x, g, b, y, rows, cols, kind, eps, gcode, bcode, s);
}

// route: kRouteAuto takes the vec kernel where vec_fits, kRouteClassic the
// classic kernel, kRouteVec the vec kernel (an error where it does not fit);
// *taken gets the route that launched.
template <typename T>
int launch(const void* x, const void* g, const void* b, void* y, int rows, int cols, int kind,
           float eps, int gcode, int bcode, int route, int* taken, cudaStream_t s) {
  const bool fits = vec_fits<T>(x, g, b, y, cols);
  if (route == kRouteVec && !fits) return static_cast<int>(cudaErrorInvalidValue);
  if (route != kRouteAuto && route != kRouteClassic && route != kRouteVec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fits && route != kRouteClassic) {
    *taken = kRouteVec;
    if (cols / ltt::vec_n<T>() <= 32 * NV_MAX_VPT)
      launch_vpt<T, 32>(x, g, b, y, rows, cols, kind, eps, gcode, bcode, s);
    else
      launch_vpt<T, NV_THREADS>(x, g, b, y, rows, cols, kind, eps, gcode, bcode, s);
    return ltt::launch_status();
  }
  *taken = kRouteClassic;
  const int threads = cols >= 1024 ? 256 : (cols >= 256 ? 128 : 32);
  norm_kernel<T><<<rows, threads, 0, s>>>(static_cast<const T*>(x), g, b, static_cast<T*>(y),
                                          cols, kind, eps, gcode, bcode);
  return ltt::launch_status();
}

}  // namespace

// x, y: (rows, cols) contiguous in dtype; gamma, beta: (cols,) contiguous in
// the dtypes gamma_dtype, beta_dtype (f32, bf16 or f16 codes), or null.
// route: 0 picks, 1 the classic kernel, 2 the vec kernel; *taken gets the
// route that launched.
LTT_API int ltt_norm(const void* x, const void* gamma, const void* beta, void* y, int rows,
                     int cols, int kind, float eps, int dtype, int gamma_dtype, int beta_dtype,
                     int route, int* taken, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32)
    return launch<float>(x, gamma, beta, y, rows, cols, kind, eps, gamma_dtype, beta_dtype,
                         route, taken, s);
  if (dtype == ltt::kBF16)
    return launch<__nv_bfloat16>(x, gamma, beta, y, rows, cols, kind, eps, gamma_dtype,
                                 beta_dtype, route, taken, s);
  return launch<__half>(x, gamma, beta, y, rows, cols, kind, eps, gamma_dtype, beta_dtype,
                        route, taken, s);
}
