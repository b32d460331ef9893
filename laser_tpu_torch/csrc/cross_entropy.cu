// Cross-entropy over (T, V) logit rows, with optional label smoothing eps:
// the target distribution is q = (1 - eps) onehot(t) + eps / V.
//
// ce_fwd_kernel replaces laser_tpu/ops/loss.py:41 _build_ce_fwd: per row
//   lse = log sum_c exp(x_c),  loss = lse - (1 - eps) x_t - (eps / V) sum_c x_c.
// ce_fused_grad_kernel replaces laser_tpu/ops/loss.py:180 _build_ce_fused_grad:
// the same loss and the unit-cotangent gradient dxu = softmax(x) - q.
// ce_bwd_kernel replaces laser_tpu/ops/loss.py:130 _build_ce_bwd: the gradient
// dx = g_row (exp(x - lse_row) - q) from the forward's saved per-row lse and
// the incoming per-row cotangent g, over a (T, W) tile of logit columns
// [c0, c0 + W) of a V-column vocabulary (c0 = 0, W = V for cross_entropy's
// two-kernel VJP; one vocabulary chunk of lm_cross_entropy's backward).
//
// What bounds it on the H100: bytes. At the training slice's shape (T = 8184,
// V = 8192, bf16) ce_fwd reads the logits once (134 MB, 0.040 ms at
// 3.35 TB/s) and ce_fused_grad also writes dxu (268 MB, 0.080 ms); the
// arithmetic (a few fp32 operations and one exp per element) is far below
// the memory time.
//
// Design. The TPU kernels keep a whole (rows, V) block resident in VMEM. A
// Hopper block has 227 KB of shared memory, so the port does not rely on
// residency: one block per row makes an online max/sum pass over the row
// (each thread keeps its own running max and sum, merged across the block
// at the end), which is all ce_fwd needs; ce_fused_grad then reads the row
// a second time to write dxu, and that read hits L1/L2 (a 16 KB row at
// V = 8192; 256 KB at V = 131072, still in the 50 MB L2). Rows are read in
// 16-byte vectors where the row width and alignment allow, else element by
// element. exp/log are expf/logf (accurate to about an ulp; laser_tpu's
// vector_math cores are 7.9e-8 relative), never the __expf intrinsic.
// Logits of -inf are skipped in the sums; a target outside [0, V) matches
// no column, as in the TPU kernels.
//
// ce_bwd is a streaming pass, bound by bytes: read x and write dx once (at
// T 2048 x V 256000 bf16, 2.10 GB: 0.626 ms at 3.35 TB/s). The TPU kernel
// walks (bt, bv) blocks of one row block in order; here a 2-D grid of
// independent blocks, one (row, tile of kBwdTile columns) each, reads the row's
// lse, g and target once and streams its tile in 16-byte vectors (when W is a
// multiple of the vector and x, dx are aligned; else element by element),
// computing in fp32 and writing x's dtype. Nothing is padded: the loop ends
// at column W. q's two values arrive rounded to fp32 from the host
// ((1 - eps) and eps / V, V the full vocabulary), so q is the plain
// version's (1 - eps) onehot + eps / V bit for bit; a row with g = 0 (an
// ignore_index row) writes zeros.
#include "common.cuh"

#include <math.h>

namespace {

using ltt::from_f32;
using ltt::to_f32;

// One row's statistics: (m, s) for the logsumexp, the target logit and the
// plain sum of the logits (label smoothing). Returns lse and the loss.
template <typename T>
__device__ __forceinline__ void row_loss(const T* __restrict__ row, int V, int t, float eps,
                                         bool vec, float* red, float& m, float& s, float& loss,
                                         float& lse) {
  m = -INFINITY;
  s = 0.f;
  float tv = 0.f, sv = 0.f;
  ltt::for_row(row, V, vec, [&](int c, float x) {
    if (x == -INFINITY) return;
    if (x > m) {
      s *= expf(m - x);  // 0 while m is still -inf
      m = x;
    }
    s += expf(x - m);
    if (c == t) tv = x;
    sv += x;
  });
  ltt::block_lse(m, s, red);
  tv = ltt::block_sum(tv, red + 64);
  if (eps != 0.f) sv = ltt::block_sum(sv, red + 64);
  lse = m + logf(s);
  loss = eps != 0.f ? lse - (1.f - eps) * tv - (eps / V) * sv : lse - tv;
}

template <typename T>
__global__ void ce_fwd_kernel(const T* __restrict__ x, const int* __restrict__ targets,
                              float* __restrict__ loss, float* __restrict__ lse, int V,
                              float eps, bool vec) {
  __shared__ float red[96];
  const size_t row = blockIdx.x;
  float m, s, lo, ls;
  row_loss(x + row * V, V, targets[row], eps, vec, red, m, s, lo, ls);
  if (threadIdx.x == 0) {
    loss[row] = lo;
    lse[row] = ls;
  }
}

template <typename T>
__global__ void ce_fused_grad_kernel(const T* __restrict__ x, const int* __restrict__ targets,
                                     float* __restrict__ loss, T* __restrict__ dxu, int V,
                                     float eps, bool vec) {
  __shared__ float red[96];
  const size_t row = blockIdx.x;
  const int t = targets[row];
  const T* xr = x + row * V;
  T* dr = dxu + row * V;
  float m, s, lo, ls;
  row_loss(xr, V, t, eps, vec, red, m, s, lo, ls);
  if (threadIdx.x == 0) loss[row] = lo;

  // dxu = exp(x - m) / s - q, as the TPU kernel's p = e / s
  const float q_off = eps / V;            // smoothing mass on every column
  const float q_on = (1.f - eps) + q_off;  // the target column
  constexpr int N = ltt::vec_n<T>();
  if (vec) {
    for (int c0 = threadIdx.x * N; c0 < V; c0 += blockDim.x * N) {
      const uint4 w = *reinterpret_cast<const uint4*>(xr + c0);
      const T* wv = reinterpret_cast<const T*>(&w);
      uint4 o;
      T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int c = c0 + e;
        const float xv = to_f32(wv[e]);
        const float p = xv == -INFINITY ? 0.f : expf(xv - m) / s;
        ov[e] = from_f32<T>(p - (c == t ? q_on : q_off));
      }
      *reinterpret_cast<uint4*>(dr + c0) = o;
    }
  } else {
    for (int c = threadIdx.x; c < V; c += blockDim.x) {
      const float xv = to_f32(xr[c]);
      const float p = xv == -INFINITY ? 0.f : expf(xv - m) / s;
      dr[c] = from_f32<T>(p - (c == t ? q_on : q_off));
    }
  }
}

constexpr int kBwdTile = 8192;  // columns per block of ce_bwd_kernel (a multiple of every N)

template <typename T>
__global__ void ce_bwd_kernel(const T* __restrict__ x, const int* __restrict__ targets,
                              const float* __restrict__ lse, const float* __restrict__ g,
                              T* __restrict__ dx, int W, int c0, float q_hit, float q_off,
                              bool vec) {
  const size_t row = blockIdx.x;
  const int begin = blockIdx.y * kBwdTile;
  const int end = min(begin + kBwdTile, W);
  const float l = lse[row], gr = g[row];
  const int t = targets[row] - c0;  // the target's column within this tile of W
  const T* xr = x + row * W;
  T* dr = dx + row * W;
  if (vec) {
    constexpr int N = ltt::vec_n<T>();
    for (int c0v = begin + threadIdx.x * N; c0v < end; c0v += blockDim.x * N) {
      const uint4 w = *reinterpret_cast<const uint4*>(xr + c0v);
      const T* wv = reinterpret_cast<const T*>(&w);
      uint4 o;
      T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float q = (c0v + e == t ? q_hit : 0.f) + q_off;
        ov[e] = from_f32<T>(gr * (expf(to_f32(wv[e]) - l) - q));
      }
      *reinterpret_cast<uint4*>(dr + c0v) = o;
    }
  } else {
    for (int c = begin + threadIdx.x; c < end; c += blockDim.x) {
      const float q = (c == t ? q_hit : 0.f) + q_off;
      dr[c] = from_f32<T>(gr * (expf(to_f32(xr[c]) - l) - q));
    }
  }
}

template <typename T>
int launch_bwd(const void* x, const int* targets, const float* lse, const float* g, void* dx,
               int T_, int W, int c0, float q_hit, float q_off, cudaStream_t stream) {
  constexpr int N = ltt::vec_n<T>();
  const bool vec = W % N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const dim3 grid(T_, (W + kBwdTile - 1) / kBwdTile);
  ce_bwd_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(x), targets, lse, g,
                                             static_cast<T*>(dx), W, c0, q_hit, q_off, vec);
  return ltt::launch_status();
}

struct CeArgs {
  const void* x;
  const int* targets;
  float* loss;
  void* out;  // lse (fp32) for ce_fwd, dxu (dtype) for ce_fused_grad
  int T, V;
  float eps;
  cudaStream_t stream;
};

template <typename T>
int launch(const CeArgs& a, bool fused) {
  constexpr int N = ltt::vec_n<T>();
  const bool vec = a.V % N == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                   (!fused || reinterpret_cast<uintptr_t>(a.out) % 16 == 0);
  const int threads = a.V >= 2048 ? 256 : (a.V >= 512 ? 128 : 32);
  const T* x = static_cast<const T*>(a.x);
  if (fused)
    ce_fused_grad_kernel<T><<<a.T, threads, 0, a.stream>>>(x, a.targets, a.loss,
                                                            static_cast<T*>(a.out), a.V, a.eps,
                                                            vec);
  else
    ce_fwd_kernel<T><<<a.T, threads, 0, a.stream>>>(x, a.targets, a.loss,
                                                     static_cast<float*>(a.out), a.V, a.eps, vec);
  return ltt::launch_status();
}

int dispatch(const CeArgs& a, int dtype, bool fused) {
  if (dtype == ltt::kF32) return launch<float>(a, fused);
  if (dtype == ltt::kBF16) return launch<__nv_bfloat16>(a, fused);
  return launch<__half>(a, fused);
}

}  // namespace

// x: (T, V) contiguous in dtype; targets: (T,) int32; loss, lse: (T,) fp32.
LTT_API int ltt_ce_fwd(const void* x, const void* targets, void* loss, void* lse, int T, int V,
                       float eps, int dtype, void* stream) {
  CeArgs a{x, static_cast<const int*>(targets), static_cast<float*>(loss), lse, T, V, eps,
           static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, false);
}

// As ltt_ce_fwd; writes the loss and dxu: (T, V) in dtype (a fresh buffer,
// not the logits).
LTT_API int ltt_ce_fused_grad(const void* x, const void* targets, void* loss, void* dxu, int T,
                              int V, float eps, int dtype, void* stream) {
  CeArgs a{x, static_cast<const int*>(targets), static_cast<float*>(loss), dxu, T, V, eps,
           static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, true);
}

// x: (T, W) contiguous in dtype, columns [c0, c0 + W) of a V-column
// vocabulary; targets: (T,) int32; lse, g: (T,) fp32; dx: (T, W) in dtype
// (a fresh buffer, not the logits). eps is the label smoothing.
LTT_API int ltt_ce_bwd(const void* x, const void* targets, const void* lse, const void* g,
                       void* dx, int T, int W, int c0, int V, double eps, int dtype,
                       void* stream) {
  const float q_hit = static_cast<float>(1.0 - eps);
  const float q_off = static_cast<float>(eps / V);
  const int* t = static_cast<const int*>(targets);
  const float* l = static_cast<const float*>(lse);
  const float* gr = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32) return launch_bwd<float>(x, t, l, gr, dx, T, W, c0, q_hit, q_off, s);
  if (dtype == ltt::kBF16)
    return launch_bwd<__nv_bfloat16>(x, t, l, gr, dx, T, W, c0, q_hit, q_off, s);
  return launch_bwd<__half>(x, t, l, gr, dx, T, W, c0, q_hit, q_off, s);
}
