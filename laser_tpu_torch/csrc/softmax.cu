// Row softmax over (rows, cols): y = exp(x - max) / sum exp(x - max), the
// arithmetic in fp32 and one cast to the input dtype.
//
// softmax_vec_kernel and softmax_rows_kernel replace
// laser_tpu/ops/vector_math.py:276 softmax (the row-resident kernel,
// pallas_call at :329); softmax_cluster_kernel and softmax_online_kernel
// replace laser_tpu/ops/vector_math.py:200 _softmax_online (pallas_call at
// :255).
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
// - the cluster kernel (route 0 of ltt_softmax_online: the online function,
//   and softmax's rows wider than kVecMaxCols) splits each row over the C
//   blocks of a thread-block cluster, 512 threads a block, two a SM. The
//   classic online kernel below read each row twice on one block a row (64
//   rows of Llama-3's 128256-word vocabulary: 64 of 132 SMs, 4x the byte
//   bound). Here each block reads its slice once, with 16-byte loads into
//   registers (32 values a thread, 16384 columns a block, at most 16
//   blocks). Its phases run in lock step on a SM, so the design keeps them
//   few: each thread takes the max m of its own values and e = exp(x - m)
//   with their sum, with no barrier; the block merges its threads' (m, sum)
//   pairs, and the cluster its blocks' pairs through distributed shared
//   memory after one cluster barrier (in rank order, so every block holds
//   the same M and L); each thread writes e exp(m - M) / L. One read, one
//   write, one cluster barrier (two when the maximum went first: 0.0386 ms
//   against 0.0368 at 64 x 128256 f32, PERF.md row 13). x - m and x - M
//   round apart, so e exp(m - M) is within |x - M| ulp of exp(x - M) (3e-6
//   relative on randn * 4 rows, the f32 bar 1e-5). C is
//   at most 8 portable blocks, 16 with the non-portable attribute: 262144
//   columns; wider rows take the classic online kernel by shape.
// - the classic online kernel (route 1, asked for; rows past the cluster's
//   262144 columns) gives each row one block that loops over it twice: a
//   first sweep keeps a running (m, l) per thread (l rescaled when m
//   rises), merged over the block; a second sweep reads the row again (from
//   L2 when it is still there) and writes exp(x - m) / l.
// exp is expf (about an ulp; laser_tpu's polynomial is within 7.9e-8
// relative), never the __expf intrinsic; the quotient is an IEEE divide.
// -inf entries give exactly 0.
//
// A row of nothing but -inf: as laser_tpu, the row kernels return NaN (the
// sum is 0 and e / 0 = 0 / 0; vector_math.py:319-327) and the online kernel
// returns 0 (its sum is taken as 1 when it is 0; vector_math.py:252-253),
// the cluster kernel too.
//
// y may be x (the caller donated it): the row kernels read the whole row
// before they write, the cluster kernel's blocks their whole slice before
// the first cluster barrier, and the online kernel's second sweep writes
// each element right after the same thread read it. Hence no __restrict__.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

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
// the online kernels' routes (ONLINE_ROUTES in ops/vector_math.py): 0 the
// cluster kernel where a row fits a cluster, 1 the classic kernel. *taken
// reports the kernel: kOnlineClassic, or kOnlineCluster (not a route one
// asks for).
enum OnlineRoute { kOnlineAuto = 0, kOnlineClassic = 1, kOnlineCluster = 2 };

constexpr int kClusterThreads = 512;
constexpr int kClusterValues = 32;     // fp32 values a thread holds at most
constexpr int kClusterMaxBlocks = 16;  // past 8 with the non-portable attribute

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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A row's slice of the cluster kernel, for thread li of block `rank` of C:
// the elements before the row's first 16-byte boundary (head, block 0's),
// its whole vectors split into C runs of `per`, this thread's first vector
// v0 (then every kClusterThreads-th) and the run's end v1, the tail past
// the last vector (block C - 1's)
struct RowSlice {
  int head, tail0, v0, v1;
};

template <typename T>
__device__ __forceinline__ RowSlice row_slice(const T* xr, int cols, int C, int rank, int li) {
  constexpr int N = ltt::vec_n<T>();
  RowSlice r;
  r.head = static_cast<int>(((16 - reinterpret_cast<uintptr_t>(xr) % 16) % 16) / sizeof(T));
  r.head = r.head < cols ? r.head : cols;
  const int nvec = (cols - r.head) / N;
  r.tail0 = r.head + nvec * N;
  const int per = (nvec + C - 1) / C;
  r.v0 = rank * per + li;
  r.v1 = rank * per + per < nvec ? rank * per + per : nvec;
  return r;
}

// One row over the C blocks of a thread-block cluster (see the note at the
// top): block `rank` holds its slice of the row's whole 16-byte vectors as
// fp32, VPT a thread in registers, read once; block 0 the head elements
// before the row's first 16-byte boundary, block C - 1 the tail past the
// last vector, one a thread. Each thread takes the max m of its own values
// (no barrier) and e = exp(x - m) in place with its sum; the block merges
// the threads' (m, sum) pairs (block_lse), the cluster the blocks' through
// distributed shared memory after one barrier: M their max, L the sum of
// s_b exp(m_b - M) in rank order, so every block holds the same (M, L).
// Each thread then writes e exp(m - M) / L. Every block reads its whole
// slice before the barrier, so y may be x.
template <typename T, int VPT>
__global__ void __launch_bounds__(kClusterThreads, 2)
    softmax_cluster_kernel(const T* x, T* y, int cols, bool ystore_vec) {
  constexpr int N = ltt::vec_n<T>();
  __shared__ float red[64];
  __shared__ float part[2];  // this block's max and its sum of exp(x - max)
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int li = threadIdx.x;
  const size_t row = blockIdx.x / C;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  const RowSlice r = row_slice(xr, cols, C, rank, li);
  const uint4* xv = reinterpret_cast<const uint4*>(xr + r.head);
  auto at = [&](int i) { return r.v0 + kClusterThreads * i; };  // vector i of the thread

  float v[VPT][N];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (at(i) < r.v1) {
      const uint4 w = xv[at(i)];
      const T* wv = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int e = 0; e < N; ++e) v[i][e] = to_f32(wv[e]);
    }
  }
  const bool has_head = rank == 0 && li < r.head;
  const bool has_tail = rank == C - 1 && r.tail0 + li < cols;
  float hv = has_head ? to_f32(xr[li]) : -INFINITY;
  float tv = has_tail ? to_f32(xr[r.tail0 + li]) : -INFINITY;

  float m = fmaxf(hv, tv);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (at(i) < r.v1) {
#pragma unroll
      for (int e = 0; e < N; ++e) m = fmaxf(m, v[i][e]);
    }
  }
  const float ms = isfinite(m) ? m : 0.f;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (at(i) < r.v1) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        v[i][e] = v[i][e] == -INFINITY ? 0.f : expf(v[i][e] - ms);
        s += v[i][e];
      }
    }
  }
  hv = hv == -INFINITY ? 0.f : expf(hv - ms);  // 0 where absent
  tv = tv == -INFINITY ? 0.f : expf(tv - ms);
  s += hv + tv;
  float mb = m, sb = s;
  ltt::block_lse(mb, sb, red);
  if (li == 0) {
    part[0] = mb;
    part[1] = sb;
  }
  cluster_arrive();
  cluster_wait();
  // the cluster's (M, L): lane j reads block j's pair, every warp the same
  const int lane = li & 31;
  float mj = -INFINITY, sj = 0.f;
  if (lane < C) {
    mj = *cl.map_shared_rank(&part[0], lane);
    sj = *cl.map_shared_rank(&part[1], lane);
  }
  const float M = ltt::warp_max(mj);
  float l = ltt::warp_sum(mj == -INFINITY ? 0.f : sj * expf(mj - M));
  l = l > 0.f ? l : 1.f;  // an all -inf row: 0, as the classic online kernel
  // no block may leave while another still reads its part[]: arrive now,
  // wait after the stores
  cluster_arrive();
  const float f = m == -INFINITY ? 0.f : expf(m - M);  // this thread's e to exp(x - M)

  if (has_head) yr[li] = from_f32<T>(hv * f / l);
  if (has_tail) yr[r.tail0 + li] = from_f32<T>(tv * f / l);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (at(i) < r.v1) {
      uint4 w;
      T* wv = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int e = 0; e < N; ++e) wv[e] = from_f32<T>(v[i][e] * f / l);
      if (ystore_vec) {
        reinterpret_cast<uint4*>(yr + r.head)[at(i)] = w;
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) yr[r.head + at(i) * N + e] = wv[e];
      }
    }
  }
  cluster_wait();
}

// The cluster kernel's shape for rows of `cols` columns: C blocks a row (the
// fewest that hold it at kClusterValues values a thread: 16384 columns a
// block; 64 rows of 128256 take 512 blocks, two waves at two a SM), then
// VPT, the fewest vectors a thread for the row's whole vectors; C 0 past
// kClusterMaxBlocks blocks (262144 columns: the row does not fit on chip).
// Two designs that held more on chip were slower at 64 x 128256 (PERF.md
// row 13's redesign): a cluster taking two rows, the second's slice copied into shared
// memory while the first is reduced, and one wave of blocks holding half
// their slice in shared memory.
template <typename T>
void cluster_shape(int cols, int* C, int* vpt) {
  constexpr int N = ltt::vec_n<T>();
  const int64_t per_block = int64_t{kClusterThreads} * kClusterValues;  // columns
  const int64_t c = cols == 0 ? 1 : (cols + per_block - 1) / per_block;
  *C = c <= kClusterMaxBlocks ? static_cast<int>(c) : 0;
  int v = 1;
  while (int64_t{v} * kClusterThreads * c < cols / N) v *= 2;
  *vpt = v;
}

template <typename T, int VPT>
int launch_cluster_vpt(const T* x, T* y, int rows, int cols, int C, bool yvec, cudaStream_t s) {
  auto kern = softmax_cluster_kernel<T, VPT>;
  if (C > 8) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(static_cast<int64_t>(rows) * C));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, x, y, cols, yvec);
  return e != cudaSuccess ? static_cast<int>(e) : ltt::launch_status();
}

template <typename T>
int launch_cluster(const T* x, T* y, int rows, int cols, int C, int vpt, cudaStream_t s) {
  if (static_cast<int64_t>(rows) * C > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool yvec = (reinterpret_cast<uintptr_t>(x) - reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  if (vpt == 1) return launch_cluster_vpt<T, 1>(x, y, rows, cols, C, yvec, s);
  if (vpt == 2) return launch_cluster_vpt<T, 2>(x, y, rows, cols, C, yvec, s);
  if (vpt == 4) return launch_cluster_vpt<T, 4>(x, y, rows, cols, C, yvec, s);
  if constexpr (kClusterValues / ltt::vec_n<T>() >= 8)
    if (vpt == 8) return launch_cluster_vpt<T, 8>(x, y, rows, cols, C, yvec, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
int launch(const void* xv, void* yv, int rows, int cols, bool online, int route, int* taken,
           cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  if (!online && route != kRouteClassic) return launch_vec<T>(x, y, rows, cols, s);
  // every row starts on a 16-byte boundary when the width is whole vectors
  const bool vec = cols % ltt::vec_n<T>() == 0 && aligned16(x) && aligned16(y);
  if (online) {
    int C = 0, vpt = 0;
    if (route != kOnlineClassic) cluster_shape<T>(cols, &C, &vpt);
    if (C > 0) {
      *taken = kOnlineCluster;
      return launch_cluster<T>(x, y, rows, cols, C, vpt, s);
    }
    *taken = kOnlineClassic;
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
             int* taken, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (online ? route != kOnlineAuto && route != kOnlineClassic
             : route != kRouteAuto && route != kRouteClassic && route != kRouteVec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ltt::kF32) return launch<float>(x, y, rows, cols, online, route, taken, s);
  if (dtype == ltt::kBF16)
    return launch<__nv_bfloat16>(x, y, rows, cols, online, route, taken, s);
  if (dtype == ltt::kF16) return launch<__half>(x, y, rows, cols, online, route, taken, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y: (rows, cols) contiguous in dtype; y may be x. route 0 or 2: the vec
// kernel, any width up to kVecMaxCols and any alignment; 1: the classic
// kernel, cols up to what the wrapper allows in shared memory
// (SOFTMAX_ROW_MAX_COLS in laser_tpu_torch/ops/vector_math.py).
LTT_API int ltt_softmax_rows(const void* x, void* y, int rows, int cols, int dtype, int route,
                             void* stream) {
  int taken = 0;
  return dispatch(x, y, rows, cols, false, route, dtype, &taken, stream);
}

// route 0: the cluster kernel where a row fits a cluster's registers (at
// most kClusterMaxBlocks * kClusterThreads * kClusterValues columns), else
// the classic online kernel; 1: the classic online kernel; 2: the cluster
// kernel (wider rows refused). *taken: 1 or 2, the kernel launched.
LTT_API int ltt_softmax_online(const void* x, void* y, int rows, int cols, int dtype,
                               int route, int* taken, void* stream) {
  return dispatch(x, y, rows, cols, true, route, dtype, taken, stream);
}
