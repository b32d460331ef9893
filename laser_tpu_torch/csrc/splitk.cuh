// The small-M split-K skeleton: out (M, N) = epilogue(A (M, K) W (K, N))
// for M <= 64 rows, where W is a weight read once from HBM. Shared by the
// 16-bit GEMM's small-M route (csrc/gemm.cu, W a bf16/f16 (K, N) matrix)
// and the int4 GEMM's streaming route (csrc/w4_gemm.cu, W laser_tpu's
// packed nibbles and f32 scales), each through a weight-loader policy.
//
// What bounds it: the bytes of W. At M 8 a bf16 product does 8 operations
// a byte against the H100's ridge of 295, so the tensor cores idle and only
// the bytes in flight matter (3.35 TB/s over ~1 us of latency is ~3 MB, tens
// of KB an SM). The design:
// - split K: a grid of (column tiles of 128) x (K splits), the number of
//   splits picked from N, K and the SM count so that about two blocks an SM
//   run in one wave (Plan below), whatever N is;
// - a ring of W's tiles in shared memory, filled by cp.async 16-byte copies
//   (L2 only, zero fill past K, past the split and past N), 4 stages;
// - A's K-slice for the split read into shared memory once a block;
// - the product on mma.sync m16n8k16 (fp32 accumulators): 4 warps, 32
//   columns each, A fragments by ldmatrix from the slice, W's fragments
//   from the policy;
// - a deterministic reduce: with one split the block runs the epilogue on
//   its accumulators; with more, each block writes fp32 partials into a
//   workspace (splits, M, N) that the wrapper allocates, and a second kernel
//   sums each output's splits in a fixed order (a lane per split residue,
//   then an xor tree over the lanes) and runs the epilogue once. No float
//   atomics: the same inputs give the same bits on every call.
//
// A weight policy W provides:
//   using T;                       the activation type (bf16 / f16)
//   static constexpr int BK;       k rows a ring stage (a multiple of 16)
//   static constexpr int STAGES;   ring stages
//   int stage_bytes;               bytes of one stage (a multiple of 16)
//   void load(uint8_t* stage, int k0, int k_end, int n0) const;
//        issue the cp.async copies of k rows [k0, k0 + BK) (none at or past
//        k_end) and block columns [n0, n0 + 128), from all kThreads threads
//   void frags(const uint8_t* stage, int k0, int kk, int col, uint32_t (&b)[4][2]) const;
//        the mma.sync B fragments of k rows [kk, kk + 16) of the stage that
//        starts at row k0, for the 4 n8 tiles of block columns col..col+31
//   static int column(int j, int n);
//        the block column (less col) of column n (0..7) of n8 tile j
// An epilogue Epi provides store2(row, col, v0, v1): outputs (row, col) and
// (row, col + 1) from their fp32 sums.
#pragma once

#include <algorithm>

#include "hopper.cuh"

namespace ltt {
namespace sk {

constexpr int kThreads = 128;  // 4 warps, 32 output columns each
constexpr int kBN = 128;       // output columns a block
constexpr int kMaxMT = 4;      // m16 tiles: M <= 64
// shared memory a block, so that two blocks fit an SM (228 KB, 1 KB each reserved)
constexpr int kBlockSmem = 113 * 1024;
// the most a block may ask for (one block an SM)
constexpr int kMaxSmem = 227 * 1024;

struct Plan {
  int splits;  // blocks along K
  int kchunk;  // k rows a split, a multiple of the policy's BK
};

// About two blocks an SM in one wave: splits = (2 SMs) / column tiles, at
// most one a k tile, each split at most max_kchunk rows (A's slice must fit
// shared memory; a split that long takes more splits, and more waves).
inline Plan plan(int N, int K, int bk, int max_kchunk, int sms) {
  const int tiles_n = (N + kBN - 1) / kBN;
  const int ktiles = (K + bk - 1) / bk;
  int splits = std::max(1, std::min(2 * sms / tiles_n, ktiles));
  int per = (ktiles + splits - 1) / splits;
  per = std::max(1, std::min(per, max_kchunk / bk));
  splits = (ktiles + per - 1) / per;
  return {splits, per * bk};
}

// A's slice row stride in elements: 16 bytes of padding put the 8 rows of
// an ldmatrix on distinct banks
inline __host__ __device__ int slice_ld(int kchunk) { return kchunk + 8; }

// The longest split (a multiple of bk) whose 16-bit A slice of mpad rows
// fits `bytes`.
inline int max_kchunk(int mpad, int bytes, int bk) {
  const int k = bytes / (2 * mpad) - 8;
  return k < bk ? 0 : k / bk * bk;
}

template <class W, int MT, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
    splitk_mma_kernel(const typename W::T* __restrict__ a, int M, int N, int K, int vec_a, W w,
                      Plan pl, float* __restrict__ ws, Epi epi) {
  using T = typename W::T;
  extern __shared__ __align__(128) uint8_t sk_smem[];
  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int k_begin = split * pl.kchunk;
  const int k_end = min(K, k_begin + pl.kchunk);
  const int ktiles = (k_end - k_begin + W::BK - 1) / W::BK;
  const int lda = slice_ld(pl.kchunk);
  uint16_t* As = reinterpret_cast<uint16_t*>(sk_smem + W::STAGES * w.stage_bytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the ring's first stages go out before A's slice is read
#pragma unroll
  for (int s = 0; s < W::STAGES - 1; ++s) {
    if (s < ktiles) w.load(sk_smem + s * w.stage_bytes, k_begin + s * W::BK, k_end, n0);
    hp::cp_async_commit();
  }
  // A's slice: rows [0, 16 MT), k [k_begin, k_begin + ktiles BK); zeros past
  // M and past the split (0 * garbage can be NaN)
  const int kw = ktiles * W::BK;
  const uint16_t* A = reinterpret_cast<const uint16_t*>(a);
  if (vec_a) {  // K % 8 == 0, A 16-byte aligned: 8-element chunks are in or out
    for (int i = tid; i < 16 * MT * (kw / 8); i += kThreads) {
      const int r = i / (kw / 8), c = (i % (kw / 8)) * 8;
      const int gk = k_begin + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < M && gk < k_end) v = *reinterpret_cast<const uint4*>(A + (size_t)r * K + gk);
      *reinterpret_cast<uint4*>(As + r * lda + c) = v;
    }
  } else {
    for (int i = tid; i < 16 * MT * kw; i += kThreads) {
      const int r = i / kw, c = i % kw;
      const int gk = k_begin + c;
      As[r * lda + c] = (r < M && gk < k_end) ? A[(size_t)r * K + gk] : uint16_t(0);
    }
  }

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const int col = warp * 32;  // the warp's first column in the block
  // the lane's ldmatrix row of an m16 x k16 A fragment (matrices: rows 0-7 /
  // 8-15 at k 0-7, then the same at k 8-15)
  const uint32_t a_lane =
      hp::smem_u32(As + ((lane & 7) + 8 * ((lane >> 3) & 1)) * lda + 8 * (lane >> 4));
  for (int kt = 0; kt < ktiles; ++kt) {
    hp::cp_async_wait<W::STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();                     // ... everyone's; stage kt - 1 is free
    const int nk = kt + W::STAGES - 1;
    if (nk < ktiles)
      w.load(sk_smem + (nk % W::STAGES) * w.stage_bytes, k_begin + nk * W::BK, k_end, n0);
    hp::cp_async_commit();
    const uint8_t* st = sk_smem + (kt % W::STAGES) * w.stage_bytes;
    const int k0 = k_begin + kt * W::BK;
#pragma unroll
    for (int kk = 0; kk < W::BK; kk += 16) {
      uint32_t b[4][2];
      w.frags(st, k0, kk, col, b);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        hp::ldsm_x4(af, a_lane + (uint32_t)((16 * mt * lda + kt * W::BK + kk) * 2));
#pragma unroll
        for (int j = 0; j < 4; ++j) hp::mma16816<T>(acc[mt][j], af, b[j][0], b[j][1]);
      }
    }
  }

  // c0c1: row g, columns 2q, 2q + 1 of the n8 tile (block columns by the
  // policy's map); c2c3: row g + 8. One split: the sums go through shared
  // memory (the ring, now free) and the epilogue runs in a plain loop over
  // them (unrolled over the accumulators, its copies made the compiler keep
  // them in local memory). More: fp32 partials into the workspace.
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  float* Cs = reinterpret_cast<float*>(sk_smem);  // [16 MT][kBN]
  if (pl.splits == 1) {
    hp::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + g + 8 * (e >> 1), c = col + W::column(j, q2 + (e & 1));
        if (pl.splits == 1)
          Cs[row * kBN + c] = acc[mt][j][e];
        else if (row < M && n0 + c < N)
          ws[((size_t)split * M + row) * N + n0 + c] = acc[mt][j][e];
      }
  if (pl.splits > 1) return;
  __syncthreads();
  for (int i = tid; i < M * (kBN / 2); i += kThreads) {
    const int row = i / (kBN / 2), c = (i % (kBN / 2)) * 2;
    if (n0 + c < N) epi.store2(row, n0 + c, Cs[row * kBN + c], Cs[row * kBN + c + 1]);
  }
}

// Sum the splits of each 4 outputs in a fixed order and run the epilogue:
// `lanes` (a power of two <= 32) lanes a group of 4 outputs, lane l summing
// splits l, l + lanes, ... in order, then an xor tree over the lanes.
template <class Epi>
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(const float* __restrict__ ws, int splits, int M, int N, int lanes,
                         Epi epi) {
  const long long quads = (long long)M * N / 4;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long quad = t / lanes;
  const int l = static_cast<int>(t % lanes);
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (quad < quads) {
    for (int z = l; z < splits; z += lanes) {
      const float4 v = w4[(size_t)z * quads + quad];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  // every lane of the warp takes part, live or not (its sums are 0)
  for (int o = lanes / 2; o > 0; o >>= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
    s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
    s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
  }
  if (quad < quads && l == 0) {
    const int row = static_cast<int>(quad * 4 / N), c = static_cast<int>(quad * 4 % N);
    epi.store2(row, c, s.x, s.y);
    epi.store2(row, c + 2, s.z, s.w);
  }
}

// The reduce's launch: lanes the next power of two >= splits, at most 32.
// N % 4 == 0 (the routes ask for it).
template <class Epi>
inline void launch_reduce(const float* ws, int splits, int M, int N, Epi epi, cudaStream_t s) {
  int lanes = 1;
  while (lanes < splits && lanes < 32) lanes <<= 1;
  const long long threads = (long long)M * N / 4 * lanes;
  splitk_reduce_kernel<Epi><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(ws, splits, M, N,
                                                                             lanes, epi);
}

// Launch the product with MT m16 tiles (16 MT >= M) and, past one split,
// the reduce. Shared memory: the ring and A's slice (plan_for sized it).
template <class W, int MT, class Epi>
inline int launch_mt(const typename W::T* a, int M, int N, int K, int vec_a, const W& w,
                     const Plan& pl, float* ws, const Epi& epi, cudaStream_t s) {
  auto kernel = splitk_mma_kernel<W, MT, Epi>;
  const int smem = W::STAGES * w.stage_bytes + 16 * MT * slice_ld(pl.kchunk) * 2;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const dim3 grid((N + kBN - 1) / kBN, pl.splits);
  kernel<<<grid, kThreads, smem, s>>>(a, M, N, K, vec_a, w, pl, ws, epi);
  if (pl.splits > 1) {
    const int st = launch_status();
    if (st) return st;
    launch_reduce(ws, pl.splits, M, N, epi, s);
  }
  return launch_status();
}

// The m16 tiles a launch of M rows takes (1..kMaxMT, each instantiated).
inline int mtiles(int M) { return (M + 15) / 16; }

// The plan for M rows: A's slice of 16 mtiles(M) rows within what two
// blocks an SM leave beside the ring (or one block an SM, if the ring alone
// is past that).
template <class W>
inline Plan plan_for(const W& w, int M, int N, int K) {
  const int mpad = 16 * mtiles(M);
  const int ring = W::STAGES * w.stage_bytes;
  int kmax = max_kchunk(mpad, kBlockSmem - ring, W::BK);
  if (kmax == 0) kmax = max_kchunk(mpad, kMaxSmem - ring, W::BK);
  if (kmax == 0) return {0, 0};  // no room for one k tile of A: launch refuses
  return plan(N, K, W::BK, kmax, hp::sm_count());
}

// Bytes of the fp32 workspace the launch needs (0 with one split).
template <class W>
inline long long workspace_bytes(const W& w, int M, int N, int K) {
  const Plan pl = plan_for(w, M, N, K);
  return pl.splits > 1 ? (long long)pl.splits * M * N * 4 : 0;
}

template <class W, class Epi>
inline int launch(const typename W::T* a, int M, int N, int K, int vec_a, const W& w, float* ws,
                  const Epi& epi, cudaStream_t s) {
  const Plan pl = plan_for(w, M, N, K);
  if (pl.kchunk == 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (mtiles(M)) {
    case 1: return launch_mt<W, 1>(a, M, N, K, vec_a, w, pl, ws, epi, s);
    case 2: return launch_mt<W, 2>(a, M, N, K, vec_a, w, pl, ws, epi, s);
    case 3: return launch_mt<W, 3>(a, M, N, K, vec_a, w, pl, ws, epi, s);
    default: return launch_mt<W, 4>(a, M, N, K, vec_a, w, pl, ws, epi, s);
  }
}

// ---------------------------------------------------------------------------
// The 16-bit dense weight: W (K, N) row-major, N % 8 == 0, 16-byte aligned
// ---------------------------------------------------------------------------
template <typename TT>
struct DenseWeights {
  using T = TT;
  static constexpr int BK = 64, STAGES = 4;
  static constexpr int LDB = kBN + 8;  // elements a staged row: 16 B of padding for ldmatrix
  const T* b;
  int N;
  int stage_bytes;  // BK * LDB * 2

  __device__ __forceinline__ void load(uint8_t* st, int k0, int k_end, int n0) const {
    const uint32_t base = hp::smem_u32(st);
#pragma unroll
    for (int it = 0; it < BK * (kBN / 8) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < k_end && gn < N;
      hp::cp_async16(base + (r * LDB + c) * 2, ok ? b + (size_t)gk * N + gn : b, ok);
    }
  }

  __device__ static __forceinline__ int column(int j, int n) { return 8 * j + n; }

  // x4.trans: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
  // (k 8-15, n 8-15) of each 16-column half; lane t gets B[2(t%4)..+1][t/4]
  __device__ __forceinline__ void frags(const uint8_t* st, int, int kk, int col,
                                        uint32_t (&f)[4][2]) const {
    const int lane = threadIdx.x & 31;
    const int r = kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t q[4];
      hp::ldsm_x4_trans(q, hp::smem_u32(st) + (r * LDB + col + 16 * h + 8 * (lane >> 4)) * 2);
      f[2 * h][0] = q[0];
      f[2 * h][1] = q[1];
      f[2 * h + 1][0] = q[2];
      f[2 * h + 1][1] = q[3];
    }
  }
};

template <typename T>
inline DenseWeights<T> dense_weights(const void* b, int N) {
  return {static_cast<const T*>(b), N, DenseWeights<T>::BK * DenseWeights<T>::LDB * 2};
}

// ---------------------------------------------------------------------------
// laser_tpu's int4 weight: q4 (K/2, N) int8, rows 2i (low nibble) and 2i+1
// (high nibble) of a column in one byte; s4 (K/group, N) f32; group even and
// dividing K; N % 16 == 0, both 16-byte aligned
// ---------------------------------------------------------------------------
template <typename TT>
struct PackedInt4Weights {
  using T = TT;
  static constexpr int BK = 128, STAGES = 4;
  static constexpr int LDQ = kBN + 32;  // bytes a staged packed row: rows of an mma on distinct banks
  static constexpr int Q_BYTES = BK / 2 * LDQ;
  const int8_t* q4;
  const float* s4;
  int N, group;
  int group_shift;  // log2(group) for a power of two, else -1
  int srows;        // scale rows a stage holds: (BK - 1) / group + 2 at most
  int stage_bytes;  // Q_BYTES + srows * kBN * 4

  __device__ __forceinline__ int group_of(int k) const {
    return group_shift >= 0 ? k >> group_shift : k / group;
  }

  __device__ __forceinline__ void load(uint8_t* st, int k0, int k_end, int n0) const {
    const uint32_t base = hp::smem_u32(st);
    // packed rows [k0 / 2, k0 / 2 + BK / 2): 16-column chunks (k0, k_end even)
#pragma unroll
    for (int it = 0; it < (BK / 2) * (kBN / 16) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const int gk = k0 + 2 * r, gn = n0 + c;
      const bool ok = gk < k_end && gn < N;
      hp::cp_async16(base + r * LDQ + c, ok ? q4 + (size_t)(gk / 2) * N + gn : q4, ok);
    }
    // scale rows from the stage's first group: 4-column chunks
    const int g0 = group_of(k0);
    for (int i = threadIdx.x; i < srows * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      const int gr = g0 + r, gn = n0 + c;
      const bool ok = (long long)gr * group < k_end && gn < N;
      hp::cp_async16(base + Q_BYTES + (r * kBN + c) * 4, ok ? s4 + (size_t)gr * N + gn : s4, ok);
    }
  }

  // Column n of n8 tile j is block column 4 n + j (less col): lane t's four
  // tiles take the 4 neighbouring columns 4 (t/4) .. 4 (t/4) + 3, one 32-bit
  // word of a packed row, and their scales one float4.
  __device__ static __forceinline__ int column(int j, int n) { return 4 * n + j; }

  // Lane t's B fragment is column t/4, rows 2(t%4), 2(t%4) + 1 and the same
  // 8 rows below: two packed bytes (packed rows kk/2 + t%4 and 4 below),
  // each dequantized with the scale of its own group.
  __device__ __forceinline__ void frags(const uint8_t* st, int k0, int kk, int col,
                                        uint32_t (&f)[4][2]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int pr = kk / 2 + q, c = col + 4 * g;
    const int g0 = group_of(k0);
    const int s0 = group_of(k0 + kk + 2 * q) - g0, s1 = group_of(k0 + kk + 8 + 2 * q) - g0;
    const float* S = reinterpret_cast<const float*>(st + Q_BYTES);
    const float4 a4 = *reinterpret_cast<const float4*>(S + s0 * kBN + c);
    const float4 b4 = *reinterpret_cast<const float4*>(S + s1 * kBN + c);
    const float sa[4] = {a4.x, a4.y, a4.z, a4.w}, sb[4] = {b4.x, b4.y, b4.z, b4.w};
    float lo[4], hi[4];
    // the weight times its f32 scale, rounded to T (the plain version's order)
    hp::nibbles8(*reinterpret_cast<const uint32_t*>(st + pr * LDQ + c), lo, hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j][0] = hp::pack2<T>(lo[j] * sa[j], hi[j] * sa[j]);
    hp::nibbles8(*reinterpret_cast<const uint32_t*>(st + (pr + 4) * LDQ + c), lo, hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j][1] = hp::pack2<T>(lo[j] * sb[j], hi[j] * sb[j]);
  }
};

template <typename T>
inline PackedInt4Weights<T> int4_weights(const void* q4, const void* s4, int N, int group) {
  using W = PackedInt4Weights<T>;
  int shift = -1;
  for (int b = 0; b < 31; ++b)
    if (group == (1 << b)) shift = b;
  const int srows = (W::BK - 1) / group + 2;
  return {static_cast<const int8_t*>(q4), static_cast<const float*>(s4), N, group, shift,
          srows, W::Q_BYTES + srows * kBN * 4};
}

}  // namespace sk
}  // namespace ltt
