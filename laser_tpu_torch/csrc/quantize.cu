// int8 quantization: (rows, cols) f32/bf16/f16 -> int8 q and f32 scales,
// one scale per row or one for the whole tensor, rounding half to even or
// stochastically.
//
// Replaces laser_tpu/ops/quant.py:29 _build_quantize.
//
// What bounds it on the H100: bytes. Each input element is read (twice:
// the amax pass, then the quantize pass, the second from L1/L2 for a row)
// and one int8 written: at 4096^2 f32, 84 MB from HBM, 0.025 ms at
// 3.35 TB/s; the two divisions per element are far below the FP32 rate.
//
// Design: per row, one block per row finds amax = max |v| (block_max) and
// scale = max(amax, 1e-30) * f32(1/127) (XLA folds laser_tpu's division by
// the constant 127 into that multiply), then writes q = clip(rint(v /
// scale), -127, 127), half to even as jnp.round; v / scale is an IEEE
// division (__fdiv_rn), never a reciprocal multiply, so the bits are the
// plain version's and laser_tpu's. Global: a first launch writes one amax partial
// per block over a grid-stride range; the quantize launch reduces the
// partials in every block (max is exact in any order) and block 0 writes
// the (1, 1) scale: two launches, as laser_tpu's multi-block branch
// (quant.py:108-116). Stochastic: floor(v / scale + u) with u in [0, 1)
// the top 24 bits of a splitmix64 hash of (seed, row * cols + col), the
// counter-based noise of ops/sampling.py; the plain version computes the
// same hash, so kernel and plain version agree bit for bit.
#include "common.cuh"

namespace {

using ltt::to_f32;

constexpr int Q_THREADS = 256;
constexpr int MAX_PARTIALS = 1024;
constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ull;

__host__ __device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// u in [0, 1): 24 bits of the hash of (seed key, flat index)
__device__ __forceinline__ float noise(uint64_t key, uint64_t flat) {
  const uint64_t h = mix64(key + (flat + 1ull) * kGolden);
  return (float)(h >> 40) * 0x1p-24f;
}

template <typename T>
__global__ void __launch_bounds__(Q_THREADS) amax_partials_kernel(const T* __restrict__ x,
                                                                  float* partials, long long n) {
  __shared__ float red[32];
  float m = 0.f;
  for (long long i = blockIdx.x * (long long)Q_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * Q_THREADS)
    m = fmaxf(m, fabsf(to_f32(x[i])));
  m = ltt::block_max(m, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

// One block per row. PER_ROW: the row's own amax; else the amax of the
// partials. STOCH: stochastic rounding with the hash key.
template <typename T, bool PER_ROW, bool STOCH>
__global__ void __launch_bounds__(Q_THREADS)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* scales,
                    const float* partials, int n_partials, int cols, uint64_t key) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * cols;
  float m = 0.f;
  if (PER_ROW) {
    for (int c = threadIdx.x; c < cols; c += Q_THREADS) m = fmaxf(m, fabsf(to_f32(xr[c])));
  } else {
    for (int i = threadIdx.x; i < n_partials; i += Q_THREADS) m = fmaxf(m, partials[i]);
  }
  const float amax = ltt::block_max(m, red);
  const float scale = __fmul_rn(fmaxf(amax, 1e-30f), 1.f / 127.f);
  if (threadIdx.x == 0 && (PER_ROW || row == 0)) scales[PER_ROW ? row : 0] = scale;
  int8_t* qr = q + row * cols;
  for (int c = threadIdx.x; c < cols; c += Q_THREADS) {
    const float s = __fdiv_rn(to_f32(xr[c]), scale);
    float r;
    if (STOCH)
      r = floorf(__fadd_rn(s, noise(key, (uint64_t)row * cols + c)));
    else
      r = rintf(s);
    qr[c] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
}

template <typename T, bool PER_ROW>
void launch_quantize(const T* x, int8_t* q, float* scales, float* partials, int rows, int cols,
                     bool stochastic, uint64_t key, cudaStream_t s) {
  int n_partials = 0;
  if (!PER_ROW) {
    const long long n = (long long)rows * cols;
    const long long want = (n + Q_THREADS * 16 - 1) / (Q_THREADS * 16);
    n_partials = (int)(want < MAX_PARTIALS ? want : MAX_PARTIALS);
    amax_partials_kernel<T><<<n_partials, Q_THREADS, 0, s>>>(x, partials, n);
  }
  if (stochastic)
    quantize_kernel<T, PER_ROW, true>
        <<<rows, Q_THREADS, 0, s>>>(x, q, scales, partials, n_partials, cols, key);
  else
    quantize_kernel<T, PER_ROW, false>
        <<<rows, Q_THREADS, 0, s>>>(x, q, scales, partials, n_partials, cols, key);
}

template <typename T>
int launch_t(const void* x, void* q, void* scales, void* partials, int rows, int cols,
             int per_row, int stochastic, uint64_t key, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  float* pt = static_cast<float*>(partials);
  if (per_row)
    launch_quantize<T, true>(xt, qt, st, pt, rows, cols, stochastic, key, s);
  else
    launch_quantize<T, false>(xt, qt, st, pt, rows, cols, stochastic, key, s);
  return ltt::launch_status();
}

}  // namespace

// x: (rows, cols) contiguous in dtype; q: (rows, cols) int8; scales: (rows,)
// f32 per row or (1,) global; partials: MAX_PARTIALS f32 of scratch (global
// only, else null); seed: the stochastic key's seed, as its 64 bits.
LTT_API int ltt_quantize_int8(const void* x, void* q, void* scales, void* partials, int rows,
                              int cols, int per_row, int stochastic, long long seed, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t key = mix64((uint64_t)seed + kGolden);
  if (rows == 0 || cols == 0) return 0;
  if (dtype == ltt::kF32)
    return launch_t<float>(x, q, scales, partials, rows, cols, per_row, stochastic, key, s);
  if (dtype == ltt::kBF16)
    return launch_t<__nv_bfloat16>(x, q, scales, partials, rows, cols, per_row, stochastic, key,
                                   s);
  return launch_t<__half>(x, q, scales, partials, rows, cols, per_row, stochastic, key, s);
}
