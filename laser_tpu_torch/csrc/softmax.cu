// Row softmax over (rows, cols): y = exp(x - max) / sum exp(x - max), the
// arithmetic in fp32 and one cast to the input dtype.
//
// softmax_vec_kernel and softmax_rows_kernel replace
// laser_tpu/ops/vector_math.py:276 softmax (the row-resident kernel,
// pallas_call at :329); softmax_online_kernel replaces
// laser_tpu/ops/vector_math.py:200 _softmax_online (pallas_call at :255).
//
// What bounds them on the H100: bytes. Each reads the rows once from HBM and
// writes them once (8192 x 4096 f32: 268 MB, 80 us at 3.35 TB/s); one expf,
// a compare and a divide per element are far below that. At C1's head (16 x
// 1000 f32, 128 KB) nothing bounds the kernel but its own latency: a few
// microseconds of loads, reductions and stores, under the wrapper's host work.
//
// Design. The TPU kernels hold (8, cols) blocks in VMEM and the online one
// carries (m, l) in scratch from one grid step to the next. On Hopper
// blocks carry nothing between them, so:
// - the vec kernel (route "vec", every row of at most SOFTMAX_ROW_MAX_COLS
//   columns) holds the row in registers as fp32, read by 16-byte loads all
//   issued before the first reduction and written by 16-byte stores. A warp
//   takes a row of up to 1024 columns where there are many rows (eight rows
//   a 256-thread block, no barrier), four warps where there are few (C1's
//   16 rows: 8 blocks, 2 vectors a thread); a 256-thread block takes a
//   wider row of up to 2048 vectors (8192 f32, 16384 bf16/f16 columns), a
//   1024-thread block the widest f32 rows. Max and sum by warp shuffles
//   (and across a row's warps one shared-memory step each). A row whose
//   base is not on a 16-byte boundary, or whose width is not whole vectors,
//   reads its head up to the first boundary and its tail past the last whole
//   vector element by element (one each a thread), in the same launch; when
//   x and y sit at different offsets from a boundary the stores are scalar.
// - the classic row kernel (route "classic", asked for; no model path)
//   gives each row one block, which copies the row into shared memory as
//   fp32 (up to 16384 columns: 64 KB, three blocks on an SM), takes its max,
//   turns it into exp(x - max) in place with the sum, and writes e / sum.
// - the online kernel, for rows wider than that, gives each row one block
//   that loops over it twice: a first sweep keeps a running (m, l) per
//   thread (l rescaled when m rises), merged over the block; a second sweep
//   reads the row again (from L2 when it is still there) and writes
//   exp(x - m) / l.
// exp is expf (about an ulp; laser_tpu's polynomial is within 7.9e-8
// relative), never the __expf intrinsic; the quotient is an IEEE divide.
// -inf entries give exactly 0.
//
// A row of nothing but -inf: as laser_tpu, the row kernels return NaN (the
// sum is 0 and e / 0 = 0 / 0; vector_math.py:319-327) and the online kernel
// returns 0 (its sum is taken as 1 when it is 0; vector_math.py:252-253).
//
// y may be x (the caller donated it): the row kernels read the whole row
// before they write, and the online kernel's second sweep writes each
// element right after the same thread read it. Hence no __restrict__.
#include "common.cuh"

namespace {

using ltt::from_f32;
using ltt::to_f32;

constexpr int kOnlineThreads = 1024;
constexpr int kVecThreads = 256;       // a vec block's threads, unless a row takes more
constexpr int kVecWarpMaxCols = 1024;  // widest row a warp (or four) takes
// fewest rows that take a warp each: below it, rows wider than 64 vectors
// take four warps, which cuts each thread's serial chain of loads, expf and
// divides to a quarter (C1's 16 rows of 1000: 2 vectors a thread, not 8)
constexpr int kVecWarpMinRows = 4096;
constexpr int kVecMaxCols = 16384;     // SOFTMAX_ROW_MAX_COLS in ops/vector_math.py

enum Route { kRouteAuto = 0, kRouteClassic = 1, kRouteVec = 2 };

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

// a max or a sum over the TPR threads of one row: a warp's shuffles, then
// past a warp one shared-memory step over the row's warps, in their order
// (every thread of the block takes part in the barriers)
template <int TPR, bool MAX>
__device__ __forceinline__ float row_reduce(float v, float* red) {
  v = MAX ? ltt::warp_max(v) : ltt::warp_sum(v);
  if constexpr (TPR > 32) {
    constexpr int W = TPR / 32;
    const int warp = threadIdx.x / 32, first = warp / W * W;
    __syncthreads();  // red may still be read by the reduction before
    if (threadIdx.x % 32 == 0) red[warp] = v;
    __syncthreads();
    v = red[first];
#pragma unroll
    for (int i = 1; i < W; ++i) v = MAX ? fmaxf(v, red[first + i]) : v + red[first + i];
  }
  return v;
}

// TPR threads a row (32: a warp, eight rows a block; 128: two rows a block;
// else the block), VPT 16-byte vectors a thread in registers, and at most
// one head and one tail element a thread. ystore_vec: y's rows sit at the
// same offset from a 16-byte boundary as x's, so the vectors are stored
// whole.
template <typename T, int TPR, int VPT>
__global__ void __launch_bounds__(TPR > kVecThreads ? TPR : kVecThreads)
    softmax_vec_kernel(const T* x, T* y, int rows, int cols, bool ystore_vec) {
  constexpr int N = ltt::vec_n<T>();
  constexpr int RPB = (TPR > kVecThreads ? TPR : kVecThreads) / TPR;
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * RPB + threadIdx.x / TPR;
  const int li = threadIdx.x % TPR;
  if (TPR == 32 && row >= (size_t)rows) return;  // a whole warp: no barrier follows
  // past the last row (two rows a block) the threads hold an empty row and
  // still meet the block's barriers
  const int width = row < (size_t)rows ? cols : 0;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  // elements before the row's first 16-byte boundary, the whole vectors
  // after it, and the elements past the last of them
  int head = static_cast<int>(((16 - reinterpret_cast<uintptr_t>(xr) % 16) % 16) / sizeof(T));
  head = head < width ? head : width;
  const int nvec = (width - head) / N;
  const int tail0 = head + nvec * N;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);

  float v[VPT][N];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = li + TPR * i;
    if (c < nvec) {
      const uint4 w = xv[c];
      const T* wv = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int e = 0; e < N; ++e) v[i][e] = to_f32(wv[e]);
    }
  }
  const bool has_head = li < head, has_tail = tail0 + li < width;
  float hv = has_head ? to_f32(xr[li]) : -INFINITY;
  float tv = has_tail ? to_f32(xr[tail0 + li]) : -INFINITY;

  float m = fmaxf(hv, tv);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (li + TPR * i < nvec) {
#pragma unroll
      for (int e = 0; e < N; ++e) m = fmaxf(m, v[i][e]);
    }
  }
  m = row_reduce<TPR, true>(m, red);
  const float ms = isfinite(m) ? m : 0.f;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (li + TPR * i < nvec) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        v[i][e] = v[i][e] == -INFINITY ? 0.f : expf(v[i][e] - ms);
        s += v[i][e];
      }
    }
  }
  hv = hv == -INFINITY ? 0.f : expf(hv - ms);  // 0 where absent
  tv = tv == -INFINITY ? 0.f : expf(tv - ms);
  s = row_reduce<TPR, false>(s + hv + tv, red);

  if (has_head) yr[li] = from_f32<T>(hv / s);
  if (has_tail) yr[tail0 + li] = from_f32<T>(tv / s);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = li + TPR * i;
    if (c < nvec) {
      uint4 w;
      T* wv = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int e = 0; e < N; ++e) wv[e] = from_f32<T>(v[i][e] / s);
      if (ystore_vec) {
        reinterpret_cast<uint4*>(yr + head)[c] = w;
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) yr[head + c * N + e] = wv[e];
      }
    }
  }
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

// the fewest vectors a thread (1, 2, 4 or 8) for rows of nvec vectors at
// TPR threads a row
template <typename T, int TPR>
void launch_vpt(const T* x, T* y, int rows, int cols, int nvec, bool yvec, cudaStream_t s) {
  constexpr int RPB = (TPR > kVecThreads ? TPR : kVecThreads) / TPR;
  const dim3 grid(static_cast<unsigned>((rows + RPB - 1LL) / RPB)), block(TPR > kVecThreads ? TPR : kVecThreads);
  if (nvec <= TPR)
    softmax_vec_kernel<T, TPR, 1><<<grid, block, 0, s>>>(x, y, rows, cols, yvec);
  else if (nvec <= 2 * TPR)
    softmax_vec_kernel<T, TPR, 2><<<grid, block, 0, s>>>(x, y, rows, cols, yvec);
  else if (nvec <= 4 * TPR || TPR > kVecThreads)  // 1024 threads: 64 registers a thread
    softmax_vec_kernel<T, TPR, 4><<<grid, block, 0, s>>>(x, y, rows, cols, yvec);
  else if constexpr (TPR <= kVecThreads)
    softmax_vec_kernel<T, TPR, 8><<<grid, block, 0, s>>>(x, y, rows, cols, yvec);
}

template <typename T>
int launch_vec(const T* x, T* y, int rows, int cols, cudaStream_t s) {
  if (cols > kVecMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = cols / ltt::vec_n<T>();  // at least a row's whole vectors
  const bool yvec = (reinterpret_cast<uintptr_t>(x) - reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  if (cols <= kVecWarpMaxCols && (rows >= kVecWarpMinRows || nvec <= 64))
    launch_vpt<T, 32>(x, y, rows, cols, nvec, yvec, s);
  else if (cols <= kVecWarpMaxCols)
    launch_vpt<T, 128>(x, y, rows, cols, nvec, yvec, s);
  else if (nvec <= 8 * kVecThreads)
    launch_vpt<T, kVecThreads>(x, y, rows, cols, nvec, yvec, s);
  else if constexpr (sizeof(T) == 4)  // f32 past 8192 columns; 16-bit rows stop short
    launch_vpt<T, 1024>(x, y, rows, cols, nvec, yvec, s);
  return ltt::launch_status();
}

template <typename T>
int launch(const void* xv, void* yv, int rows, int cols, bool online, int route, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  if (!online && route != kRouteClassic) return launch_vec<T>(x, y, rows, cols, s);
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

int dispatch(const void* x, void* y, int rows, int cols, bool online, int route, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route != kRouteAuto && route != kRouteClassic && route != kRouteVec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ltt::kF32) return launch<float>(x, y, rows, cols, online, route, s);
  if (dtype == ltt::kBF16) return launch<__nv_bfloat16>(x, y, rows, cols, online, route, s);
  if (dtype == ltt::kF16) return launch<__half>(x, y, rows, cols, online, route, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y: (rows, cols) contiguous in dtype; y may be x. route 0 or 2: the vec
// kernel, any width up to kVecMaxCols and any alignment; 1: the classic
// kernel, cols up to what the wrapper allows in shared memory
// (SOFTMAX_ROW_MAX_COLS in laser_tpu_torch/ops/vector_math.py).
LTT_API int ltt_softmax_rows(const void* x, void* y, int rows, int cols, int dtype, int route,
                             void* stream) {
  return dispatch(x, y, rows, cols, false, route, dtype, stream);
}

LTT_API int ltt_softmax_online(const void* x, void* y, int rows, int cols, int dtype,
                               void* stream) {
  return dispatch(x, y, rows, cols, true, kRouteAuto, dtype, stream);
}
