// Fused optimizer updates, in place: AdamW and SGD with momentum.
//
// Replaces laser_tpu/ops/optim.py:38 _build_adamw (adamw_update) and
// laser_tpu/ops/optim.py:80 _build_sgdm (sgdm_multi_kernel, and the
// per-leaf sgdm_kernel asked for by route "classic").
//
// What bounds it on the H100: bytes. AdamW reads p, g, m, v and writes p, m,
// v: 14 bytes a bf16 parameter, about 10 operations on them; SGD reads p, g,
// m and writes p, m (10 bytes). Both sit far below the card's ~295
// operations a byte, so the least time is the bytes over 3.35 TB/s.
//
// Design (laser_tpu's (8, 128) relayout of a leaf is Mosaic tiling and has
// no counterpart here). Everything is computed in fp32 and stored in the
// parameter's dtype, moments included, as the Pallas route writes p, m and
// v as the parameter's type (optim.py:58-60). Every operation is rounded on
// its own (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn): nvcc would
// contract a * b + c into one FMA, while the plain PyTorch version rounds
// each op, and the two must agree bit for bit. lr (a schedule's 0-d tensor)
// and the two bias corrections may be read through device pointers, so the
// caller never reads a device value on the host, and a launch can be
// captured in a CUDA graph.
// - adamw_kernel and sgdm_kernel: one launch per leaf, a grid-stride loop
//   over its flat elements. Where all pointers are 16-byte aligned each
//   step moves one 16-byte vector of every stream (8 bf16/f16 or 4 f32
//   elements); a scalar loop takes the tail.
// - sgdm_multi_kernel: one launch for every leaf of one dtype in a tree.
//   The leaves' (p, g, m, n) travel in a table that is the kernel's one
//   __grid_constant__ parameter (CUDA 12.1+ takes 32 KB of parameters:
//   kMultiLeaves leaves). Each leaf is cut into chunks of kMultiUnroll
//   16-byte vectors a thread, and the grid has a block a chunk of all the
//   leaves (a persistent grid of a few blocks an SM, each walking many
//   chunks, moved the same bytes measurably slower on the H100: the
//   scheduler's fresh blocks keep more of HBM busy than blocks that wait
//   on their own next chunk). Each block finds its leaf by a binary search
//   over the table's prefix sums of chunks. A thread loads its
//   kMultiUnroll vectors of p, g and m before it computes, so every SM
//   keeps tens of KB of loads in flight. A leaf whose pointers are
//   not all 16-byte aligned takes the scalar path in the same launch; an
//   aligned leaf's last few elements past its whole vectors too.
#include <climits>

#include "common.cuh"

namespace {

using ltt::from_f32;
using ltt::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct AdamArgs {
  void* p;
  const void* g;
  void* m;
  void* v;
  long long n;
  const float* lr_dev;  // or null: lr
  const float* bc_dev;  // (bc1, bc2) or null: bc1, bc2
  float lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2;
  int vec;
};

struct SgdArgs {
  void* p;
  const void* g;
  void* m;
  long long n;
  const float* lr_dev;
  float lr, mu;
  int vec;
};

struct AdamHyper {
  float lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2;
};

// laser_tpu's kernel body (optim.py:44-60), one rounding per operation
template <bool WD>
__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v,
                                          const AdamHyper& h) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float mhat = __fmul_rn(m, h.bc1);
  const float vhat = __fmul_rn(v, h.bc2);
  float upd = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  if (WD) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, upd));
}

// optim.py:86-90
template <bool NESTEROV>
__device__ __forceinline__ void sgd_elem(float& p, float g, float& m, float lr, float mu) {
  m = __fadd_rn(__fmul_rn(m, mu), g);
  const float upd = NESTEROV ? __fadd_rn(g, __fmul_rn(mu, m)) : m;
  p = __fsub_rn(p, __fmul_rn(lr, upd));
}

template <typename T, bool WD>
__global__ void __launch_bounds__(kThreads) adamw_kernel(AdamArgs a) {
  AdamHyper h{a.lr_dev ? *a.lr_dev : a.lr, a.b1, a.b2, a.omb1, a.omb2, a.eps, a.wd,
              a.bc_dev ? a.bc_dev[0] : a.bc1, a.bc_dev ? a.bc_dev[1] : a.bc2};
  constexpr int V = ltt::vec_n<T>();
  T* P = static_cast<T*>(a.p);
  const T* G = static_cast<const T*>(a.g);
  T* M = static_cast<T*>(a.m);
  T* Vv = static_cast<T*>(a.v);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = a.vec ? a.n / V : 0;
  for (long long i = tid; i < nvec; i += stride) {
    uint4 pw = reinterpret_cast<const uint4*>(P)[i];
    const uint4 gw = reinterpret_cast<const uint4*>(G)[i];
    uint4 mw = reinterpret_cast<const uint4*>(M)[i];
    uint4 vw = reinterpret_cast<const uint4*>(Vv)[i];
    T* pe = reinterpret_cast<T*>(&pw);
    const T* ge = reinterpret_cast<const T*>(&gw);
    T* me = reinterpret_cast<T*>(&mw);
    T* ve = reinterpret_cast<T*>(&vw);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float p = to_f32(pe[e]), m = to_f32(me[e]), v = to_f32(ve[e]);
      adam_elem<WD>(p, to_f32(ge[e]), m, v, h);
      pe[e] = from_f32<T>(p);
      me[e] = from_f32<T>(m);
      ve[e] = from_f32<T>(v);
    }
    reinterpret_cast<uint4*>(P)[i] = pw;
    reinterpret_cast<uint4*>(M)[i] = mw;
    reinterpret_cast<uint4*>(Vv)[i] = vw;
  }
  for (long long i = nvec * V + tid; i < a.n; i += stride) {
    float p = to_f32(P[i]), m = to_f32(M[i]), v = to_f32(Vv[i]);
    adam_elem<WD>(p, to_f32(G[i]), m, v, h);
    P[i] = from_f32<T>(p);
    M[i] = from_f32<T>(m);
    Vv[i] = from_f32<T>(v);
  }
}

template <typename T, bool NESTEROV>
__global__ void __launch_bounds__(kThreads) sgdm_kernel(SgdArgs a) {
  const float lr = a.lr_dev ? *a.lr_dev : a.lr;
  constexpr int V = ltt::vec_n<T>();
  T* P = static_cast<T*>(a.p);
  const T* G = static_cast<const T*>(a.g);
  T* M = static_cast<T*>(a.m);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = a.vec ? a.n / V : 0;
  for (long long i = tid; i < nvec; i += stride) {
    uint4 pw = reinterpret_cast<const uint4*>(P)[i];
    const uint4 gw = reinterpret_cast<const uint4*>(G)[i];
    uint4 mw = reinterpret_cast<const uint4*>(M)[i];
    T* pe = reinterpret_cast<T*>(&pw);
    const T* ge = reinterpret_cast<const T*>(&gw);
    T* me = reinterpret_cast<T*>(&mw);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float p = to_f32(pe[e]), m = to_f32(me[e]);
      sgd_elem<NESTEROV>(p, to_f32(ge[e]), m, lr, a.mu);
      pe[e] = from_f32<T>(p);
      me[e] = from_f32<T>(m);
    }
    reinterpret_cast<uint4*>(P)[i] = pw;
    reinterpret_cast<uint4*>(M)[i] = mw;
  }
  for (long long i = nvec * V + tid; i < a.n; i += stride) {
    float p = to_f32(P[i]), m = to_f32(M[i]);
    sgd_elem<NESTEROV>(p, to_f32(G[i]), m, lr, a.mu);
    P[i] = from_f32<T>(p);
    M[i] = from_f32<T>(m);
  }
}

// elements a sgdm_multi_kernel chunk holds: kMultiUnroll vectors a thread
constexpr int kMultiUnroll = 4;
constexpr int kMultiLeaves = 768;  // SGDM_TABLE_LEAVES in laser_tpu_torch/ops/optim.py

template <typename T>
__host__ __device__ constexpr long long multi_chunk() {
  return (long long)kThreads * kMultiUnroll * ltt::vec_n<T>();
}

struct SgdTable {
  const float* lr_dev;  // or null: lr
  float lr, mu;
  int leaves;
  long long start[kMultiLeaves + 1];  // chunks before each leaf; start[leaves]: all
  long long n[kMultiLeaves];
  void* p[kMultiLeaves];
  const void* g[kMultiLeaves];
  void* m[kMultiLeaves];
};
static_assert(sizeof(SgdTable) <= 32764, "the kernel parameter limit of CUDA 12.1+");

template <typename T, bool NESTEROV>
__global__ void __launch_bounds__(kThreads) sgdm_multi_kernel(const __grid_constant__ SgdTable t) {
  constexpr int V = ltt::vec_n<T>();
  constexpr long long kChunk = multi_chunk<T>();
  const float lr = t.lr_dev ? *t.lr_dev : t.lr;
  const float mu = t.mu;
  const long long chunks = t.start[t.leaves];
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    int lo = 0, hi = t.leaves - 1;  // the last leaf whose first chunk is at or before c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.start[mid] <= c) lo = mid;
      else hi = mid - 1;
    }
    T* P = static_cast<T*>(t.p[lo]);
    const T* G = static_cast<const T*>(t.g[lo]);
    T* M = static_cast<T*>(t.m[lo]);
    const long long e0 = (c - t.start[lo]) * kChunk;
    const long long e1 = min(e0 + kChunk, t.n[lo]);
    long long scalar0 = e0;  // the first element the scalar loop takes
    if ((reinterpret_cast<uintptr_t>(P) | reinterpret_cast<uintptr_t>(G) |
         reinterpret_cast<uintptr_t>(M)) % 16 == 0) {
      const long long v0 = e0 / V, v1 = e1 / V;
      uint4 pw[kMultiUnroll], gw[kMultiUnroll], mw[kMultiUnroll];
#pragma unroll
      for (int u = 0; u < kMultiUnroll; ++u) {
        const long long i = v0 + threadIdx.x + (long long)u * kThreads;
        if (i < v1) {
          pw[u] = reinterpret_cast<const uint4*>(P)[i];
          gw[u] = reinterpret_cast<const uint4*>(G)[i];
          mw[u] = reinterpret_cast<const uint4*>(M)[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kMultiUnroll; ++u) {
        const long long i = v0 + threadIdx.x + (long long)u * kThreads;
        if (i < v1) {
          T* pe = reinterpret_cast<T*>(&pw[u]);
          const T* ge = reinterpret_cast<const T*>(&gw[u]);
          T* me = reinterpret_cast<T*>(&mw[u]);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            float p = to_f32(pe[e]), m = to_f32(me[e]);
            sgd_elem<NESTEROV>(p, to_f32(ge[e]), m, lr, mu);
            pe[e] = from_f32<T>(p);
            me[e] = from_f32<T>(m);
          }
          reinterpret_cast<uint4*>(P)[i] = pw[u];
          reinterpret_cast<uint4*>(M)[i] = mw[u];
        }
      }
      scalar0 = v1 * V;
    }
    for (long long i = scalar0 + threadIdx.x; i < e1; i += kThreads) {
      float p = to_f32(P[i]), m = to_f32(M[i]);
      sgd_elem<NESTEROV>(p, to_f32(G[i]), m, lr, mu);
      P[i] = from_f32<T>(p);
      M[i] = from_f32<T>(m);
    }
  }
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

int grid_for(long long n, int vec_elems) {
  const long long items = n / vec_elems + n % vec_elems;
  const long long blocks = (items + kThreads - 1) / kThreads;
  return (int)(blocks < 1 ? 1 : blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename T>
int launch_adamw(AdamArgs& a, int wd, cudaStream_t s) {
  a.vec = aligned16(a.p) && aligned16(a.g) && aligned16(a.m) && aligned16(a.v);
  const int grid = grid_for(a.n, a.vec ? ltt::vec_n<T>() : 1);
  if (wd)
    adamw_kernel<T, true><<<grid, kThreads, 0, s>>>(a);
  else
    adamw_kernel<T, false><<<grid, kThreads, 0, s>>>(a);
  return ltt::launch_status();
}

template <typename T>
int launch_sgdm(SgdArgs& a, int nesterov, cudaStream_t s) {
  a.vec = aligned16(a.p) && aligned16(a.g) && aligned16(a.m);
  const int grid = grid_for(a.n, a.vec ? ltt::vec_n<T>() : 1);
  if (nesterov)
    sgdm_kernel<T, true><<<grid, kThreads, 0, s>>>(a);
  else
    sgdm_kernel<T, false><<<grid, kThreads, 0, s>>>(a);
  return ltt::launch_status();
}

template <typename T, bool NESTEROV>
int launch_sgdm_multi(SgdTable& t, cudaStream_t s) {
  const long long chunks = t.start[t.leaves];
  if (chunks == 0) return 0;
  const int grid = (int)(chunks < INT_MAX ? chunks : INT_MAX);  // a block a chunk
  sgdm_multi_kernel<T, NESTEROV><<<grid, kThreads, 0, s>>>(t);
  return ltt::launch_status();
}

template <typename T>
int fill_and_launch_multi(SgdTable& t, const long long* table, int nesterov, cudaStream_t s) {
  constexpr long long kChunk = multi_chunk<T>();
  t.start[0] = 0;
  for (int i = 0; i < t.leaves; ++i) {
    const long long* leaf = table + 4 * i;
    t.p[i] = reinterpret_cast<void*>(leaf[0]);
    t.g[i] = reinterpret_cast<const void*>(leaf[1]);
    t.m[i] = reinterpret_cast<void*>(leaf[2]);
    t.n[i] = leaf[3];
    t.start[i + 1] = t.start[i] + (leaf[3] + kChunk - 1) / kChunk;
  }
  return nesterov ? launch_sgdm_multi<T, true>(t, s) : launch_sgdm_multi<T, false>(t, s);
}

}  // namespace

// p, g, m, v: n contiguous elements of one dtype; p, m and v are updated in
// place. lr_dev (a device float) or lr; bc_dev (two device floats) or bc1,
// bc2; omb1 = 1 - b1 and omb2 = 1 - b2, taken in double by the caller.
LTT_API int ltt_adamw(void* p, const void* g, void* m, void* v, long long n, const void* lr_dev,
                      float lr, float b1, float b2, float omb1, float omb2, float eps, float wd,
                      const void* bc_dev, float bc1, float bc2, int has_wd, int dtype,
                      void* stream) {
  AdamArgs a{p, g, m, v, n, static_cast<const float*>(lr_dev), static_cast<const float*>(bc_dev),
             lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32) return launch_adamw<float>(a, has_wd, s);
  if (dtype == ltt::kBF16) return launch_adamw<__nv_bfloat16>(a, has_wd, s);
  if (dtype == ltt::kF16) return launch_adamw<__half>(a, has_wd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// p, g, m: n contiguous elements of one dtype; p and m are updated in place.
LTT_API int ltt_sgdm(void* p, const void* g, void* m, long long n, const void* lr_dev, float lr,
                     float mu, int nesterov, int dtype, void* stream) {
  SgdArgs a{p, g, m, n, static_cast<const float*>(lr_dev), lr, mu, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32) return launch_sgdm<float>(a, nesterov, s);
  if (dtype == ltt::kBF16) return launch_sgdm<__nv_bfloat16>(a, nesterov, s);
  if (dtype == ltt::kF16) return launch_sgdm<__half>(a, nesterov, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// table: `leaves` rows of four int64 (p, g and m as addresses, n), every
// leaf n contiguous elements of one dtype, n >= 0; p and m are updated in
// place, all leaves in one launch. At most kMultiLeaves leaves.
LTT_API int ltt_sgdm_multi(const void* table, int leaves, const void* lr_dev, float lr, float mu,
                           int nesterov, int dtype, void* stream) {
  if (leaves < 0 || leaves > kMultiLeaves) return static_cast<int>(cudaErrorInvalidValue);
  SgdTable t;
  t.lr_dev = static_cast<const float*>(lr_dev);
  t.lr = lr;
  t.mu = mu;
  t.leaves = leaves;
  const long long* rows = static_cast<const long long*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32) return fill_and_launch_multi<float>(t, rows, nesterov, s);
  if (dtype == ltt::kBF16) return fill_and_launch_multi<__nv_bfloat16>(t, rows, nesterov, s);
  if (dtype == ltt::kF16) return fill_and_launch_multi<__half>(t, rows, nesterov, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
