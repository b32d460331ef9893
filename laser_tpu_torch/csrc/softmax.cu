// Row softmax over (rows, cols): y = exp(x - max) / sum exp(x - max), the
// arithmetic in fp32 and one cast to the input dtype.
//
// softmax_rows_kernel replaces laser_tpu/ops/vector_math.py:276 softmax (the
// row-resident kernel, pallas_call at :329); softmax_online_kernel replaces
// laser_tpu/ops/vector_math.py:200 _softmax_online (pallas_call at :255).
//
// What bounds them on the H100: bytes. Each reads the rows once from HBM and
// writes them once (8192 x 4096 f32: 268 MB, 80 us at 3.35 TB/s); one expf,
// a compare and a divide per element are far below that.
//
// Design. The TPU kernels hold (8, cols) blocks in VMEM and the online one
// carries (m, l) in scratch from one grid step to the next. On Hopper
// blocks carry nothing between them, so:
// - the row kernel gives each row one block, which copies the row into
//   shared memory as fp32 (up to 16384 columns: 64 KB, three blocks on an
//   SM), takes its max, turns it into exp(x - max) in place with the sum,
//   and writes e / sum. HBM sees one read and one write.
// - the online kernel, for rows wider than that, gives each row one block
//   that loops over it twice: a first sweep keeps a running (m, l) per
//   thread (l rescaled when m rises), merged over the block; a second sweep
//   reads the row again (from L2 when it is still there) and writes
//   exp(x - m) / l.
// Rows are read in 16-byte vectors where the width and alignment allow.
// exp is expf (about an ulp; laser_tpu's polynomial is within 7.9e-8
// relative), never the __expf intrinsic. -inf entries give exactly 0.
//
// A row of nothing but -inf: as laser_tpu, the row kernel returns NaN (the
// sum is 0 and e / 0 = 0 / 0; vector_math.py:319-327) and the online kernel
// returns 0 (its sum is taken as 1 when it is 0; vector_math.py:252-253).
//
// y may be x (the caller donated it): the row kernel reads the whole row
// before it writes, and the online kernel's second sweep writes each element
// right after the same thread read it.
#include "common.cuh"

namespace {

using ltt::from_f32;
using ltt::to_f32;

constexpr int kOnlineThreads = 1024;

template <typename T>
inline bool aligned16(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
__global__ void softmax_rows_kernel(const T* x, T* y, int cols, bool vec) {
  extern __shared__ float row[];  // cols fp32
  __shared__ float red[32];
  const size_t r = blockIdx.x;
  const T* xr = x + r * cols;
  T* yr = y + r * cols;

  float m = -INFINITY;
  ltt::for_row(xr, cols, vec, [&](int c, float v) {
    row[c] = v;
    m = fmaxf(m, v);
  });
  m = ltt::block_max(m, red);  // its barrier also publishes row[]
  const float ms = isfinite(m) ? m : 0.f;
  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float v = row[c];
    const float e = v == -INFINITY ? 0.f : expf(v - ms);
    row[c] = e;  // read back below by this same thread
    s += e;
  }
  s = ltt::block_sum(s, red);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) yr[c] = from_f32<T>(row[c] / s);
}

template <typename T>
__global__ void __launch_bounds__(kOnlineThreads)
    softmax_online_kernel(const T* x, T* y, int cols, bool vec) {
  __shared__ float red[64];
  const size_t r = blockIdx.x;
  const T* xr = x + r * cols;
  T* yr = y + r * cols;

  float m = -INFINITY, l = 0.f;
  ltt::for_row(xr, cols, vec, [&](int, float v) {
    if (v == -INFINITY) return;
    if (v > m) {
      l *= expf(m - v);  // 0 while m is still -inf
      m = v;
    }
    l += expf(v - m);
  });
  ltt::block_lse(m, l, red);
  const float ms = isfinite(m) ? m : 0.f;
  const float ls = l > 0.f ? l : 1.f;

  constexpr int N = ltt::vec_n<T>();
  if (vec) {
    for (int c0 = threadIdx.x * N; c0 < cols; c0 += blockDim.x * N) {
      const uint4 w = *reinterpret_cast<const uint4*>(xr + c0);
      const T* wv = reinterpret_cast<const T*>(&w);
      uint4 o;
      T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float v = to_f32(wv[e]);
        ov[e] = from_f32<T>((v == -INFINITY ? 0.f : expf(v - ms)) / ls);
      }
      *reinterpret_cast<uint4*>(yr + c0) = o;
    }
  } else {
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const float v = to_f32(xr[c]);
      yr[c] = from_f32<T>((v == -INFINITY ? 0.f : expf(v - ms)) / ls);
    }
  }
}

template <typename T>
int launch(const void* xv, void* yv, int rows, int cols, bool online, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  // every row starts on a 16-byte boundary when the width is whole vectors
  const bool vec = cols % ltt::vec_n<T>() == 0 && aligned16(x) && aligned16(y);
  if (online) {
    softmax_online_kernel<T><<<rows, kOnlineThreads, 0, s>>>(x, y, cols, vec);
    return ltt::launch_status();
  }
  const int threads = cols >= 2048 ? 256 : (cols >= 512 ? 128 : 32);
  const size_t smem = static_cast<size_t>(cols) * sizeof(float);
  const int st = ltt::allow_smem(softmax_rows_kernel<T>, smem);
  if (st) return st;
  softmax_rows_kernel<T><<<rows, threads, smem, s>>>(x, y, cols, vec);
  return ltt::launch_status();
}

int dispatch(const void* x, void* y, int rows, int cols, bool online, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32) return launch<float>(x, y, rows, cols, online, s);
  if (dtype == ltt::kBF16) return launch<__nv_bfloat16>(x, y, rows, cols, online, s);
  return launch<__half>(x, y, rows, cols, online, s);
}

}  // namespace

// x, y: (rows, cols) contiguous in dtype; y may be x. The row kernel takes
// cols up to what the wrapper allows in shared memory (SOFTMAX_ROW_MAX_COLS
// in laser_tpu_torch/ops/vector_math.py).
LTT_API int ltt_softmax_rows(const void* x, void* y, int rows, int cols, int dtype,
                             void* stream) {
  return dispatch(x, y, rows, cols, false, dtype, stream);
}

LTT_API int ltt_softmax_online(const void* x, void* y, int rows, int cols, int dtype,
                               void* stream) {
  return dispatch(x, y, rows, cols, true, dtype, stream);
}
