// The five elementwise and reduction templates that a traced body fills.
//
// ops/codegen.py translates a user's torch body into a struct `Body` and
// emits a short .cu that includes this header, defines `Body` and names one
// entry macro below; registry.load_generated builds it with nvcc for
// sm_90a into a library of its own. The templates replace laser_tpu's
// ops/foreach.py kernels:
// - for_each_kernel: `for_each` (foreach.py:109, pallas_call at :154) and
//   `for_each_multi` (:172, at :199): N operands in, K outputs out;
// - row_reduce_kernel: `row_reduce` (:219, at :262): reduce(map(...)) over
//   the last axis of a (rows, cols) operand set;
// - map_reduce_stage1/2: `map_reduce` (:277), both sites: the resident
//   accumulator (:363) becomes a second launch over the per-block partials,
//   and the per-block partials with a custom combine_fn (:379) are stage 1
//   alone, combined by the caller in torch as laser_tpu does outside its
//   kernel (:393);
// - for_each_rows_kernel (the default) and for_each_strided_kernel (route
//   "classic"): for_each over strided views, replacing
//   laser_tpu/ops/strided.py:222 build_strided_foreach (pallas_call at :305);
// - staged_one (staged_stage1/2 on the classic route): `map_reduce_staged`
//   (foreach.py:442, at :494), an accumulator pytree of scalar leaves per
//   block and a traced combine.
//
// What bounds them on the H100: bytes. Each reads every operand once and
// writes every output once (4096^2 f32 x + y - sin z: 268 MB, 80 us at
// 3.35 TB/s); a body's few operations per element are far below the
// 67 TFLOP/s f32 line.
//
// Design. The TPU kernels re-lay the operands out as (rows, 128 or 4096)
// blocks that fit VMEM and walk a sequential grid; on Hopper:
// - for_each is a grid-stride loop over the flat elements. When every
//   pointer is 16-byte aligned each thread takes kVec consecutive elements
//   per step (kVec = 16 bytes over the smallest element size, so every
//   operand moves in whole 16-byte words), then a scalar tail; otherwise it
//   goes element by element. The operand and output pointers travel in one
//   by-value argument struct (PtrArgs). Output 0 may be operand 0 (donate):
//   each element is read before the same thread writes it.
// - row_reduce gives each row one block that streams it in any length (no
//   VMEM limit: laser_tpu's `return None` past its VMEM budget, :240, is a
//   TPU artifact), every thread folding kVec interleaved accumulators;
//   then a fixed warp and block tree.
// - map_reduce is deterministic with no atomics: block b of stage 1 folds
//   the fixed range [b*chunk, (b+1)*chunk) in a fixed order (per thread kVec
//   accumulators, a pairwise tree over them, a fixed warp and block tree),
//   stage 2 is one block that folds the partials in index order the same
//   way. The number of blocks depends on n and the dtypes only, so two runs
//   give the same bits. Nothing is padded, so nothing but real elements is
//   mapped (laser_tpu maps its identity padding; ROADMAP queue 3).
// - for_each over strided views walks the views' merged iteration space.
//   Its bound is the contiguous template's (every 2nd row of 16384 x 4096
//   f32: 268 MB, 80 us). The classic kernel (StridedGeom below) pays for
//   its generality on every vector: one int64 divmod per thread over six
//   padded dims, then per 16-byte vector six int64 multiply-adds an operand
//   and a six-digit carry odometer, one load in flight a thread. The tiled
//   kernel (RowsGeom) takes the merged space as rows of its innermost dim:
//   a block a (row group, column chunk) tile, each thread's row turned into
//   base offsets once (specialised on the merged rank: 0, 1 or up to 4
//   divmods), 32-bit offsets wherever every operand's span fits, U 16-byte
//   items of a row loaded before the body runs on any. Both move 16-byte
//   vectors along rows where every operand's rows are whole aligned
//   vectors, elements otherwise (ragged, unaligned, negative or zero
//   strides, transposed views), in the same launch. Each reads each element
//   of the views once and writes the dense output once.
// - map_reduce_staged holds a block's elements in registers, so a body of
//   reduction depth D (mean_var's m, then sum (b - m)^2: D = 2) sweeps its
//   registers D times and reads device memory once; see its section below.
// Float accumulators are f32 (a bf16 or f16 accumulator type is held in
// f32 and rounded once where it is stored), integer ones int32 (narrower
// types wrap to the same value when stored) or int64; min and max keep NaN,
// as torch.amax and jnp.max do.
#pragma once

#include <algorithm>
#include <cstring>

#include "common.cuh"
#include "vector_math.cuh"

namespace ltt {

constexpr int kMaxIn = 16;
constexpr int kMaxOut = 8;
constexpr int kMaxDims = 6;  // config.py LASER_MAXRANK
constexpr int kThreads = 256;
constexpr int kMaxReduceBlocks = 4096;  // stage 1 of map_reduce
// Elements per thread block: for_each gets one block per kElementwiseGrain
// elements (64 per thread; 4096^2 f32 gets 1024 blocks, about 8 per SM, one
// resident wave), and stage 1 of map_reduce one per kReduceGrain (8192^2
// f32 gets the same 1024). laser_tpu's config grains size a v5e's VMEM
// blocks instead; the port accepts those names and does not use them.
constexpr int64_t kElementwiseGrain = 16384;
constexpr int64_t kReduceGrain = 65536;  // ops/foreach.py REDUCE_GRAIN
enum ReduceOp { kSum = 0, kMin = 1, kMax = 2 };

struct PtrArgs {
  const void* in[kMaxIn];
  void* out[kMaxOut];
};

// V elements of T as whole 16-byte words (the caller keeps them aligned)
template <typename T, int V> struct Vec {
  static constexpr int kWords = V * static_cast<int>(sizeof(T)) / 16;
  static_assert(kWords * 16 == V * static_cast<int>(sizeof(T)), "whole 16-byte words");
  uint4 w[kWords];
  __device__ __forceinline__ T& operator[](int k) { return reinterpret_cast<T*>(w)[k]; }
  __device__ __forceinline__ void load(const void* p, int64_t i) {
    const uint4* s = reinterpret_cast<const uint4*>(static_cast<const T*>(p) + i);
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = s[k];
  }
  __device__ __forceinline__ void store(void* p, int64_t i) const {
    uint4* d = reinterpret_cast<uint4*>(static_cast<T*>(p) + i);
#pragma unroll
    for (int k = 0; k < kWords; ++k) d[k] = w[k];
  }
};

// V elements of T in registers for the strided template's tiled route: V
// == 1 is one element of any alignment, V > 1 whole 16-byte words (Vec)
template <typename T, int V> struct Lane : Vec<T, V> {};
template <typename T> struct Lane<T, 1> {
  T v;
  __device__ __forceinline__ T& operator[](int) { return v; }
  __device__ __forceinline__ void load(const void* p, int64_t i) { v = static_cast<const T*>(p)[i]; }
  __device__ __forceinline__ void store(void* p, int64_t i) const { static_cast<T*>(p)[i] = v; }
};

// --- scalar helpers the generated bodies call -------------------------------

__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || isnan(a)) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || isnan(a)) ? a : b; }
template <typename I> __device__ __forceinline__ I max_nan(I a, I b) { return a > b ? a : b; }
template <typename I> __device__ __forceinline__ I min_nan(I a, I b) { return a < b ? a : b; }

__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
template <typename I> __device__ __forceinline__ I radd(I a, I b) {
  // integer sums wrap, as torch's and jnp's
  return static_cast<I>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}

template <int Op, typename A> __device__ __forceinline__ A rcombine(A a, A b) {
  if constexpr (Op == kSum) return radd(a, b);
  else if constexpr (Op == kMin) return min_nan(a, b);
  else return max_nan(a, b);
}

template <int Op, typename A> __device__ __forceinline__ A warp_reduce(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = rcombine<Op>(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the block's fold in a fixed order; thread 0 gets it. `red` holds 32 A.
template <int Op, typename A> __device__ __forceinline__ A block_reduce(A v, A ident, A* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_reduce<Op>(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_reduce<Op>(lane < nwarps ? red[lane] : ident);
  return v;
}

// pairwise tree over a thread's V accumulators
template <int Op, typename A, int V> __device__ __forceinline__ A fold_lanes(A (&acc)[V]) {
#pragma unroll
  for (int h = V / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int k = 0; k < h; ++k) acc[k] = rcombine<Op>(acc[k], acc[k + h]);
  }
  return acc[0];
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class B> inline bool all_aligned(const PtrArgs& a, int n_out) {
  for (int k = 0; k < B::kIn; ++k)
    if (!aligned16(a.in[k])) return false;
  for (int k = 0; k < n_out; ++k)
    if (!aligned16(a.out[k])) return false;
  return true;
}

template <class B> inline PtrArgs make_args(const void* const* in, void* const* out, int n_out) {
  static_assert(B::kIn >= 1 && B::kIn <= kMaxIn && B::kOut <= kMaxOut, "operand count");
  PtrArgs a{};
  for (int k = 0; k < B::kIn; ++k) a.in[k] = in[k];
  for (int k = 0; k < n_out; ++k) a.out[k] = out[k];
  return a;
}

inline int64_t cdiv64(int64_t a, int64_t b) { return (a + b - 1) / b; }

// --- for_each / for_each_multi ---------------------------------------------

template <class B>
__global__ void __launch_bounds__(kThreads) for_each_kernel(PtrArgs a, int64_t n, bool vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t i0 = 0;
  if (vec) {
    constexpr int V = B::kVec;
    const int64_t nv = n / V;
    for (int64_t j = t; j < nv; j += stride) B::template apply_vec<V>(a, j * V);
    i0 = nv * V;
  }
  for (int64_t i = i0 + t; i < n; i += stride) B::apply1(a, i);
}

template <class B>
int launch_for_each(const void* const* in, void* const* out, int64_t n, void* stream) {
  const PtrArgs a = make_args<B>(in, out, B::kOut);
  const bool vec = all_aligned<B>(a, B::kOut);
  const int64_t items = vec ? n / B::kVec + n % B::kVec : n;
  const int64_t blocks =
      std::max<int64_t>(1, std::min<int64_t>({cdiv64(n, kElementwiseGrain), cdiv64(items, kThreads),
                                              int64_t{1} << 30}));
  for_each_kernel<B><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, n, vec);
  return launch_status();
}

// --- one thread's fold over [lo, hi), V interleaved accumulators -------------

template <class B, int Op>
__device__ __forceinline__ typename B::acc_t fold_range(const PtrArgs& a, int64_t lo, int64_t hi,
                                                        int tid, int nthreads, bool vec) {
  using A = typename B::acc_t;
  constexpr int V = B::kVec;
  A acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = B::identity();
  int64_t tail = lo;
  if (vec) {  // lo is a multiple of V and every pointer 16-byte aligned
    const int64_t hv = lo + (hi - lo) / V * V;
    for (int64_t i = lo + static_cast<int64_t>(tid) * V; i < hv;
         i += static_cast<int64_t>(nthreads) * V) {
      A m[V];
      B::template map_vec<V>(a, i, m);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = rcombine<Op>(acc[k], m[k]);
    }
    tail = hv;
  }
  for (int64_t i = tail + tid; i < hi; i += nthreads) acc[0] = rcombine<Op>(acc[0], B::map1(a, i));
  return fold_lanes<Op>(acc);
}

// --- row_reduce --------------------------------------------------------------

template <class B>
__global__ void row_reduce_kernel(PtrArgs a, void* out, int64_t cols, bool vec) {
  using A = typename B::acc_t;
  __shared__ A red[32];
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * cols;
  A v = fold_range<B, B::kOp>(a, lo, lo + cols, threadIdx.x, blockDim.x, vec);
  v = block_reduce<B::kOp>(v, B::identity(), red);
  if (threadIdx.x == 0) B::store_out(out, blockIdx.x, v);
}

template <class B>
int launch_row_reduce(const void* const* in, void* out, int64_t rows, int64_t cols,
                      void* stream) {
  const PtrArgs a = make_args<B>(in, nullptr, 0);
  // every row starts on a 16-byte boundary when the width is whole vectors
  const bool vec = all_aligned<B>(a, 0) && cols % B::kVec == 0;
  const int threads = cols >= 2048 ? 256 : (cols >= 512 ? 128 : 32);
  row_reduce_kernel<B><<<static_cast<unsigned>(rows), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, out, cols, vec);
  return launch_status();
}

// --- map_reduce --------------------------------------------------------------

// block b folds [b*chunk, min(n, (b+1)*chunk)); raw partials stay in acc_t
// for stage 2, otherwise they are stored in the accumulator dtype
template <class B>
__global__ void __launch_bounds__(kThreads)
    map_reduce_stage1(PtrArgs a, void* partials, int64_t n, int64_t chunk, bool vec, bool raw) {
  using A = typename B::acc_t;
  __shared__ A red[32];
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  A v = fold_range<B, B::kOp>(a, lo, hi, threadIdx.x, kThreads, vec);
  v = block_reduce<B::kOp>(v, B::identity(), red);
  if (threadIdx.x == 0) {
    if (raw) static_cast<A*>(partials)[blockIdx.x] = v;
    else B::store_acc(partials, blockIdx.x, v);
  }
}

// one block folds the G raw partials in index order with the combine op
template <class B, int Op>
__global__ void __launch_bounds__(kThreads)
    map_reduce_stage2(const void* partials, void* result, int g) {
  using A = typename B::acc_t;
  __shared__ A red[32];
  const A* p = static_cast<const A*>(partials);
  A v = B::identity();
  for (int i = threadIdx.x; i < g; i += kThreads) v = rcombine<Op>(v, p[i]);
  v = block_reduce<Op>(v, B::identity(), red);
  if (threadIdx.x == 0) B::store_acc(result, 0, v);
}

// (blocks, chunk) of stage 1 for n elements: one block per kReduceGrain
// elements, at most kMaxReduceBlocks, each chunk whole vectors
inline void reduce_plan(int64_t n, int vec_n, int64_t* blocks, int64_t* chunk) {
  int64_t g = std::max<int64_t>(1, std::min<int64_t>(cdiv64(n, kReduceGrain), kMaxReduceBlocks));
  int64_t c = cdiv64(cdiv64(n, g), vec_n) * vec_n;
  *chunk = c;
  *blocks = cdiv64(n, c);
}

// result null: stage 1 alone, partials in the accumulator dtype (the
// caller's combine_fn takes them); else partials are acc_t scratch of at
// least kMaxReduceBlocks and stage 2 writes the result
template <class B>
int launch_map_reduce(const void* const* in, void* partials, void* result, int64_t n,
                      int combine, void* stream) {
  const PtrArgs a = make_args<B>(in, nullptr, 0);
  const bool vec = all_aligned<B>(a, 0);
  int64_t blocks, chunk;
  reduce_plan(n, B::kVec, &blocks, &chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  map_reduce_stage1<B><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      a, partials, n, chunk, vec, result != nullptr);
  if (result == nullptr) return launch_status();
  const int g = static_cast<int>(blocks);
  if (combine == kSum) map_reduce_stage2<B, kSum><<<1, kThreads, 0, s>>>(partials, result, g);
  else if (combine == kMin) map_reduce_stage2<B, kMin><<<1, kThreads, 0, s>>>(partials, result, g);
  else map_reduce_stage2<B, kMax><<<1, kThreads, 0, s>>>(partials, result, g);
  return launch_status();
}

// --- for_each over strided views ---------------------------------------------

// The iteration space of a strided for_each: the view's logical shape with
// dims merged where they are contiguous with each other on every operand,
// padded in front with extent-1 dims to kMaxDims; on the vector path the
// innermost extent is in vectors of V elements and its strides are V.
// Each operand: its buffer start (in PtrArgs), its element offset and its
// element strides (negative or zero allowed). The output is dense.
struct StridedGeom {
  int64_t shape[kMaxDims];
  int64_t offset[kMaxIn];
  int64_t stride[kMaxIn][kMaxDims];
};

// Grid-stride over the items (elements, or V-element vectors): each thread
// turns its first index into digits over the shape by divmod once, then
// steps its digits by the grid stride's own digits with carries (the
// reference's odometer, foreach.nim:64-113), and each operand's offset is
// its offset plus digits times strides.
template <class B, int V>
__global__ void __launch_bounds__(kThreads)
    for_each_strided_kernel(PtrArgs a, StridedGeom g, int64_t items) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= items) return;
  int64_t d[kMaxDims], sd[kMaxDims];
  int64_t r = j, q = step;
#pragma unroll
  for (int k = kMaxDims - 1; k >= 0; --k) {
    d[k] = r % g.shape[k];
    r /= g.shape[k];
    sd[k] = q % g.shape[k];
    q /= g.shape[k];
  }
  for (; j < items; j += step) {
    int64_t off[B::kIn];
#pragma unroll
    for (int o = 0; o < B::kIn; ++o) {
      int64_t v = g.offset[o];
#pragma unroll
      for (int k = 0; k < kMaxDims; ++k) v += d[k] * g.stride[o][k];
      off[o] = v;
    }
    if constexpr (V > 1) B::template apply_vec_at<V>(a, off, j * V);
    else B::apply1_at(a, off, j);
    int64_t carry = 0;
#pragma unroll
    for (int k = kMaxDims - 1; k >= 0; --k) {
      d[k] += sd[k] + carry;
      carry = d[k] >= g.shape[k];
      if (carry) d[k] -= g.shape[k];
    }
  }
}

// --- the tiled route: rank-specialised (row, column-chunk) tiles -------------

// The merged iteration space as rows of its innermost dim: the outer dims
// (front-padded with extent 1 to D) give the row, the inner dim the
// column, in items of V elements (V > 1 only where every operand's inner
// stride is 1). Pointers are each operand's logical element 0, so an
// operand is its strides alone (negative or zero allowed). A thread takes
// TX = 2^tx_shift columns apart (kThreads / TX rows a tile) and U items of
// one row.
template <int D>
struct RowsGeom {
  int64_t outer[D];
  int64_t ostride[kMaxIn][D];
  int64_t istride[kMaxIn];
  int64_t rows, cols, col_tiles, tiles;
  int tx_shift;
};

// Items of one thread in flight: 16-byte words of all operands up to 8 (a
// single f32 operand: 4 vectors, 64 bytes, all loaded before the body runs)
template <class B, int V>
__host__ __device__ constexpr int rows_items() {
  int words = 0;
  for (int o = 0; o < B::kIn; ++o) words += V > 1 ? V * B::kSize[o] / 16 : 1;
  const int u = V > 1 ? 8 / words : 4;
  return u < 1 ? 1 : (u > 4 ? 4 : u);
}

// A tile (row group, column chunk) a block (a grid-stride over tiles past
// the grid): each thread turns its row into the operands' base offsets
// once (D - 1 divmods in I), loads its U items of every operand, then runs
// the body on them and stores the dense output. I is int32_t wherever every
// operand's span and the element count fit, else int64_t.
template <class B, int V, int D, typename I>
__global__ void __launch_bounds__(kThreads) for_each_rows_kernel(PtrArgs a, RowsGeom<D> g) {
  constexpr int U = rows_items<B, V>();
  const int txs = g.tx_shift;
  const I TX = I{1} << txs;
  const I tx = static_cast<I>(threadIdx.x) & (TX - 1);
  const I ty = static_cast<I>(threadIdx.x) >> txs;
  const I rows_tile = I{kThreads} >> txs;
  const I rows = static_cast<I>(g.rows), cols = static_cast<I>(g.cols);
  const I col_tiles = static_cast<I>(g.col_tiles), tiles = static_cast<I>(g.tiles);
  for (I tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const I rt = tile / col_tiles;
    const I r = rt * rows_tile + ty;
    if (r >= rows) continue;
    I base[B::kIn];
#pragma unroll
    for (int o = 0; o < B::kIn; ++o) base[o] = 0;
    I q = r;
#pragma unroll
    for (int k = D - 1; k >= 0; --k) {
      I d = q;
      if (k > 0) {
        const I n = static_cast<I>(g.outer[k]);
        d = q % n;
        q /= n;
      }
#pragma unroll
      for (int o = 0; o < B::kIn; ++o) base[o] += d * static_cast<I>(g.ostride[o][k]);
    }
    const I c0 = (tile - rt * col_tiles) * (TX * U) + tx;
    typename B::template Regs<V> x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const I c = c0 + u * TX;
      if (c < cols) {
        I off[B::kIn];
#pragma unroll
        for (int o = 0; o < B::kIn; ++o)
          off[o] = base[o] + (V > 1 ? c * V : c * static_cast<I>(g.istride[o]));
        B::template load<V>(x[u], a, off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const I c = c0 + u * TX;
      if (c < cols) B::template store<V>(x[u], a, (r * cols + c) * V);
    }
  }
}

template <class B, int V, int D>
int launch_rows(const PtrArgs& a, int R, const int64_t* shape, const int64_t* const* st,
                bool i32, cudaStream_t s) {
  constexpr int U = rows_items<B, V>();
  RowsGeom<D> g{};
  const int outer = R - 1;  // at most D
  g.rows = 1;
  for (int k = 0; k < D; ++k) {
    const int src = k - (D - outer);  // the merged dim at padded position k
    g.outer[k] = src >= 0 ? shape[src] : 1;
    g.rows *= g.outer[k];
    for (int o = 0; o < B::kIn; ++o) g.ostride[o][k] = src >= 0 ? st[o][src] : 0;
  }
  for (int o = 0; o < B::kIn; ++o) g.istride[o] = st[o][R - 1];
  g.cols = shape[R - 1] / V;
  int txs = 0;  // the fewest threads a row that cover it in U items each, at most kThreads
  while ((int64_t{1} << txs) * U < g.cols && (1 << txs) < kThreads) ++txs;
  g.tx_shift = txs;
  g.col_tiles = cdiv64(g.cols, (int64_t{1} << txs) * U);
  g.tiles = g.col_tiles * cdiv64(g.rows, kThreads >> txs);
  const unsigned grid = static_cast<unsigned>(std::min<int64_t>(g.tiles, int64_t{1} << 30));
  if (i32) for_each_rows_kernel<B, V, D, int32_t><<<grid, kThreads, 0, s>>>(a, g);
  else for_each_rows_kernel<B, V, D, int64_t><<<grid, kThreads, 0, s>>>(a, g);
  return launch_status();
}

template <class B, int V>
int launch_rows_rank(const PtrArgs& a, int R, const int64_t* shape, const int64_t* const* st,
                     bool i32, cudaStream_t s) {
  if (R <= 2) return launch_rows<B, V, 1>(a, R, shape, st, i32, s);
  if (R == 3) return launch_rows<B, V, 2>(a, R, shape, st, i32, s);
  return launch_rows<B, V, kMaxDims - 1>(a, R, shape, st, i32, s);
}

// Routes of the strided template (ops/strided.py ROUTES): 0 the tiled
// kernel, 1 the classic grid-stride kernel. *taken reports the kernel:
// kStridedClassic, or kStridedTiled (not a route one asks for).
enum StridedRoute { kStridedAuto = 0, kStridedClassic = 1, kStridedTiled = 2 };

// geom: the merged rank R (1..kMaxDims), shape[R], then each operand's
// strides[R] in elements; in[] are the operands' logical element 0. The
// launcher finds the vector path (every operand's inner stride 1, rows of
// whole 16-byte vectors at 16-byte boundaries) and the index width itself,
// and reports the route it took in *taken.
template <class B>
int launch_for_each_strided(const void* const* in, void* const* out, const int64_t* geom,
                            int route, int* taken, void* stream) {
  const int R = static_cast<int>(geom[0]);
  if (R < 1 || R > kMaxDims || (route != kStridedAuto && route != kStridedClassic))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* shape = geom + 1;
  const int64_t* st[kMaxIn];
  for (int o = 0; o < B::kIn; ++o) st[o] = geom + 1 + R + o * R;
  int64_t n = 1;
  for (int k = 0; k < R; ++k) n *= shape[k];
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const PtrArgs a = make_args<B>(in, out, B::kOut);
  constexpr int V = B::kVec;
  bool vec = shape[R - 1] % V == 0 && aligned16(a.out[0]);
  bool i32 = n < (int64_t{1} << 30);
  for (int o = 0; o < B::kIn; ++o) {
    vec = vec && st[o][R - 1] == 1 && aligned16(a.in[o]);
    int64_t span = 0;
    for (int k = 0; k < R; ++k) {
      vec = vec && (k == R - 1 || st[o][k] * B::kSize[o] % 16 == 0);
      span += (shape[k] - 1) * (st[o][k] < 0 ? -st[o][k] : st[o][k]);
    }
    i32 = i32 && span < (int64_t{1} << 30);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route != kStridedClassic) {
    *taken = kStridedTiled;
    return vec ? launch_rows_rank<B, V>(a, R, shape, st, i32, s)
               : launch_rows_rank<B, 1>(a, R, shape, st, i32, s);
  }
  // the classic kernel: the merged space padded in front to kMaxDims, each
  // operand at offset 0 from its logical element 0
  *taken = kStridedClassic;
  StridedGeom g{};
  const int pad = kMaxDims - R;
  for (int k = 0; k < kMaxDims; ++k) g.shape[k] = k < pad ? 1 : shape[k - pad];
  for (int o = 0; o < B::kIn; ++o)
    for (int k = 0; k < kMaxDims; ++k) g.stride[o][k] = k < pad ? 0 : st[o][k - pad];
  if (vec) {
    g.shape[kMaxDims - 1] /= V;
    for (int o = 0; o < B::kIn; ++o) g.stride[o][kMaxDims - 1] = V;
  }
  const int64_t items = vec ? n / V : n;
  const int64_t blocks =
      std::max<int64_t>(1, std::min<int64_t>({cdiv64(n, kElementwiseGrain), cdiv64(items, kThreads),
                                              int64_t{1} << 30}));
  if (vec && V > 1)
    for_each_strided_kernel<B, V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a, g, items);
  else
    for_each_strided_kernel<B, 1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a, g, items);
  return launch_status();
}

// --- map_reduce_staged -----------------------------------------------------------

// Stage 1: block b owns the fixed block [b*G, (b+1)*G) of G = kStagedGrain
// elements; thread t holds elements b*G + e*kStagedThreads + t, e <
// kStagedPer, in registers (coalesced loads: a warp's load is one 128-byte
// line of f32, all issued before any arithmetic). Positions past n are
// never loaded: their value is 0 and `valid` false there. The generated
// body then runs one sweep over the registers per reduction level, each
// reduction a per-thread fold in register order and a block_allreduce
// (fixed warp and block trees), and returns the block's accumulator: its
// leaves as the typed partials hold them (B::store_partial writes them).
// The fold: T accumulators (staged_fold_width), accumulator v the chain of
// partials v, v + T, v + 2T, ... combined in that order with the generated
// combine, then a halving tree with an odd tail over the T accumulators in
// shared memory (laser_tpu's order, foreach.py:507-522), then the generated
// finish (the identity, or mean_var's M2 / n) stores the results. Every
// order is fixed, so a result is the same bits run after run; no atomics
// on the values.
//
// Routes. classic (route="classic"): staged_stage1 (one thread block a
// block, writing the partials), then staged_stage2 (one thread block of T
// threads: thread v folds chain v, then the tree; also under graph capture).
// staged_one (the default), one launch of min(nb, T) thread blocks: thread block v runs stage 1 on the
// blocks of chain v in order and folds them as it goes, in registers, in the
// classic route's order; no partial is written. Then it writes its chain to
// the workspace and takes a ticket (__threadfence, then atomicAdd on the
// workspace's counter); the thread block that draws the last ticket resets
// the counter to 0, loads every chain and runs the tree: the classic route's
// bits. One ticket a thread block of many blocks: a ticket a block of 4096
// elements would hold each thread block resident over a fence and an
// atomic's round trip. The workspace (ops/foreach.py STAGED_WORK_BYTES: the
// counter, then the T accumulators) is one a stream, zeroed once (a call on
// the same stream starts after the last one ends), so other streams never
// share a live counter; under CUDA graph capture the wrapper takes the
// two-launch route, as replays would share one. T = 256 (accumulators over
// 32 bytes) leaves the one launch 256 thread blocks, under a wave.
constexpr int kStagedThreads = 256;
constexpr int kStagedPer = 16;
constexpr int64_t kStagedGrain = int64_t{kStagedThreads} * kStagedPer;  // ops/foreach.py STAGED_GRAIN
constexpr int kMaxLeaves = 16;
constexpr int kStagedAccOffset = 16;  // the workspace's accumulators, after the counter

struct StagedArgs {
  const void* in[kMaxIn];
  void* part[kMaxLeaves];  // per leaf: (n_blocks,) partials in the leaf's dtype
  void* out[kMaxLeaves];   // per result leaf: the 0-d result
};

// The fold's accumulators: T (1024, or 256 for accumulators over 32 bytes,
// so that they stay within 32 KB of shared memory)
template <class B>
__host__ __device__ constexpr int staged_fold_width() {
  return sizeof(typename B::Acc) <= 32 ? 1024 : 256;
}

// An accumulator another thread block wrote in this launch, read from L2
// (ld.global.cg: never a line this SM's L1 kept), word by word.
template <typename A>
__device__ __forceinline__ void load_acc_cg(const A* p, A& out) {
  if constexpr (sizeof(A) % 4 == 0) {
    unsigned w[sizeof(A) / 4];
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int k = 0; k < static_cast<int>(sizeof(A) / 4); ++k)
      asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(w[k]) : "l"(q + k));
    memcpy(&out, w, sizeof(A));
  } else {
    unsigned char c[sizeof(A)];
    const unsigned char* q = reinterpret_cast<const unsigned char*>(p);
#pragma unroll
    for (int k = 0; k < static_cast<int>(sizeof(A)); ++k) {
      unsigned short u;
      asm volatile("ld.global.cg.u8 %0, [%1];" : "=h"(u) : "l"(q + k));
      c[k] = static_cast<unsigned char>(u);
    }
    memcpy(&out, c, sizeof(A));
  }
}

// the block's fold of v in a fixed order, returned to every thread. `red`
// holds 33 A; successive calls may reuse it with another A (each call's
// reads of red end before its last __syncthreads)
template <int Op, typename A> __device__ __forceinline__ A block_allreduce(A v, A ident, A* red) {
  v = block_reduce<Op>(v, ident, red);
  if (threadIdx.x == 0) red[32] = v;
  __syncthreads();
  return red[32];
}

// The halving tree over s[0 .. m) (filled, and synced), by the block's NT
// threads; thread 0 stores the result.
template <class B, int NT>
__device__ __forceinline__ void staged_tree(const StagedArgs& a, int m, typename B::Acc* s) {
  const int t = threadIdx.x;
  while (m > 1) {
    const int h = m / 2;
    for (int v = t; v < h; v += NT) B::combine(s[v], s[v + h], s[v]);
    __syncthreads();
    if ((m & 1) && t == 0) s[h] = s[2 * h];
    __syncthreads();
    m = h + (m & 1);
  }
  if (t == 0) B::store_result(a, s[0]);
}

template <class B>
__global__ void __launch_bounds__(kStagedThreads) staged_stage1(StagedArgs a, int64_t n) {
  __shared__ __align__(16) unsigned char red[33 * 8];
  const typename B::Acc r = B::block(a, n, blockIdx.x, red);
  if (threadIdx.x == 0) B::store_partial(a, blockIdx.x, r);
}

template <class B, int T>
__global__ void __launch_bounds__(T) staged_stage2(StagedArgs a, int nb) {
  using Acc = typename B::Acc;
  __shared__ Acc s[T];
  const int t = threadIdx.x;
  const int m0 = nb < T ? nb : T;
  if (t < m0) {
    Acc acc;
    B::load_partial(a, t, acc);
    for (int i = t + T; i < nb; i += T) {
      Acc p;
      B::load_partial(a, i, p);
      B::combine(acc, p, acc);
    }
    s[t] = acc;
  }
  __syncthreads();
  staged_tree<B, T>(a, m0, s);
}

// See Routes above: min(nb, T) thread blocks, block b folding chain b of
// blocks b, b + T, b + 2T, ...; work the workspace.
template <class B>
__global__ void __launch_bounds__(kStagedThreads) staged_one(StagedArgs a, int64_t n, int nb,
                                                            unsigned char* work) {
  using Acc = typename B::Acc;
  constexpr int T = staged_fold_width<B>();
  __shared__ __align__(16) unsigned char red[33 * 8];
  __shared__ Acc s[T];
  __shared__ bool last;
  unsigned* ticket = reinterpret_cast<unsigned*>(work);
  Acc* chains = reinterpret_cast<Acc*>(work + kStagedAccOffset);
  // every thread holds the chain (block() returns its leaves to all of them)
  Acc chain = B::block(a, n, blockIdx.x, red);
  for (int tile = blockIdx.x + T; tile < nb; tile += T) {
    const Acc r = B::block(a, n, tile, red);
    B::combine(chain, r, chain);
  }
  if (threadIdx.x == 0) {
    chains[blockIdx.x] = chain;
    __threadfence();  // the chain before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other thread block's chain is visible from here on
  if (threadIdx.x == 0) *ticket = 0;  // every ticket is drawn: ready for the next launch
  const int m0 = static_cast<int>(gridDim.x);
  for (int v = threadIdx.x; v < m0; v += kStagedThreads) load_acc_cg(chains + v, s[v]);
  __syncthreads();
  staged_tree<B, kStagedThreads>(a, m0, s);
}

template <class B>
StagedArgs staged_args(const void* const* in, void* const* out) {
  static_assert(B::kIn >= 1 && B::kIn <= kMaxIn && B::kLeaves >= 1 &&
                    B::kLeaves <= kMaxLeaves && B::kOut >= 1 && B::kOut <= kMaxLeaves,
                "operand and leaf counts");
  StagedArgs a{};
  for (int k = 0; k < B::kIn; ++k) a.in[k] = in[k];
  for (int k = 0; k < B::kOut; ++k) a.out[k] = out[k];
  return a;
}

template <class B>
int launch_staged(const void* const* in, void* const* part, void* const* out, int64_t n,
                  void* stream) {
  StagedArgs a = staged_args<B>(in, out);
  for (int k = 0; k < B::kLeaves; ++k) a.part[k] = part[k];
  const int64_t nb = cdiv64(n, kStagedGrain);
  if (n <= 0 || nb > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  staged_stage1<B><<<static_cast<unsigned>(nb), kStagedThreads, 0, s>>>(a, n);
  constexpr int T2 = staged_fold_width<B>();
  staged_stage2<B, T2><<<1, T2, 0, s>>>(a, static_cast<int>(nb));
  return launch_status();
}

// work: the stream's workspace (its counter 0 between launches).
template <class B>
int launch_staged_one(const void* const* in, void* const* out, void* work, int64_t n,
                      void* stream) {
  static_assert(kStagedAccOffset + staged_fold_width<B>() * sizeof(typename B::Acc) <=
                    kStagedAccOffset + 1024 * 8 * kMaxLeaves,
                "the accumulators fit the workspace");
  const StagedArgs a = staged_args<B>(in, out);
  const int64_t nb = cdiv64(n, kStagedGrain);
  if (n <= 0 || nb > INT32_MAX || work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(nb < staged_fold_width<B>() ? nb : staged_fold_width<B>());
  staged_one<B><<<grid, kStagedThreads, 0, s>>>(a, n, static_cast<int>(nb),
                                                static_cast<unsigned char*>(work));
  return launch_status();
}

}  // namespace ltt

#define LTT_FOR_EACH_ENTRY(B)                                                              \
  LTT_API int ltt_gen_for_each(const void* const* in, void* const* out, int64_t n,          \
                               void* stream) {                                              \
    return ltt::launch_for_each<B>(in, out, n, stream);                                     \
  }

#define LTT_ROW_REDUCE_ENTRY(B)                                                            \
  LTT_API int ltt_gen_row_reduce(const void* const* in, void* out, int64_t rows,            \
                                 int64_t cols, void* stream) {                              \
    return ltt::launch_row_reduce<B>(in, out, rows, cols, stream);                          \
  }

#define LTT_MAP_REDUCE_ENTRY(B)                                                            \
  LTT_API int ltt_gen_map_reduce(const void* const* in, void* partials, void* result,       \
                                 int64_t n, int combine, void* stream) {                    \
    return ltt::launch_map_reduce<B>(in, partials, result, n, combine, stream);             \
  }

#define LTT_FOR_EACH_STRIDED_ENTRY(B)                                                      \
  LTT_API int ltt_gen_for_each_strided(const void* const* in, void* const* out,             \
                                       const int64_t* geom, int route, int* taken,          \
                                       void* stream) {                                      \
    return ltt::launch_for_each_strided<B>(in, out, geom, route, taken, stream);            \
  }

#define LTT_STAGED_ENTRY(B)                                                                \
  LTT_API int ltt_gen_map_reduce_staged(const void* const* in, void* const* part,           \
                                        void* const* out, int64_t n, void* stream) {        \
    return ltt::launch_staged<B>(in, part, out, n, stream);                                 \
  }                                                                                         \
  LTT_API int ltt_gen_map_reduce_staged_one(const void* const* in, void* const* out,        \
                                            void* work, int64_t n, void* stream) {          \
    return ltt::launch_staged_one<B>(in, out, work, n, stream);                             \
  }
