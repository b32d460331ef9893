// Digit-plane GEMMs on the int8 tensor cores: the bucketed limb product and
// the exact mod-2^32 int32 GEMM on top of it.
//
// Replaces laser_tpu/ops/gemm/limb_kernel.py:75 build_gemm_limbs (the
// substrate of the int64 and f64 GEMMs: out[s] = sum_{p+q=s} A_p @ B_q over
// int8 digit planes, int32 exact) and laser_tpu/ops/gemm/int32_kernel.py:65
// build_gemm_int32 (alpha * (A @ B) + beta * C mod 2^32 from the 10 limb
// products with p + q <= 3).
//
// What bounds it on the H100: the digit products. An (nA, M, K) x (nB, K, N)
// call does one int8 product per pair (p, q) with p + q < n_buckets: 36 for
// the int64 GEMM and the f64 GEMM's 8 slices, 10 for int32 and 4 slices,
// each 2 M N K operations at the int8 tensor-core rate (1979 TOP/s dense).
// At bench.py's 2048^3 the operations bound it by far (int64: 0.3125 ms for
// 36 products, against 0.06 ms for its 33.6 MB of digits and 134 MB of
// bucket planes; int32: 0.0868 ms for 10).
//
// Two routes, each with its own counter; the launcher picks one, or is asked
// for one (enum Route), and reports it.
//
// Both routes read B's planes K-major, (nB, N, K), the one layout of the
// entry points below: the 8-bit wgmma forms read only K-major operands. The
// port's digit splits make them so from b.t() (ops/gemm/int32_kernel.py,
// int64_kernel.py, f64_kernel.py); the Python entries that take laser_tpu's
// (nB, K, N) copy them once first (csrc/transpose.cu).
//
// wgmma (limb_wgmma_kernel): the persistent wgmma + TMA skeleton of
// csrc/wgmma_gemm.cuh with the int8 instruction (m64n128k32 s32.s8.s8, the
// int8 GEMM's route in csrc/gemm.cu). One 128 x 128 output tile walks its
// buckets in order; for bucket s the k loop runs over the pairs (p, s - p)
// one after another, each K/128 steps whose TMA boxes are (k, m0, plane p)
// of A and (k, n0, plane q) of B: laser_tpu's "A planes side by side along
// K" done by coordinates instead of copies. A bucket is a segment of the skeleton: at
// its last step the consumers write the accumulator to plane s and start
// the next bucket from zero. The int32 GEMM walks its 4 buckets from s = 3
// down and shifts the accumulator left by 8 between them (Horner: ((S3
// 2^8 + S2) 2^8 + S1) 2^8 + S0 = sum_s S_s 2^8s mod 2^32, every step
// wrapping mod 2^32 in the tensor cores' int32 sum, no .satfinite), so one
// set of 64 accumulators a thread carries the combine and the alpha, beta *
// C epilogue (in uint32) runs once a tile. Every tile does all its products
// (36, or 10), so tiles are balanced; at 2048^2 the 256 tiles take one wave
// of 2 blocks on each of 132 SMs (264 slots). TMA's zero fill covers ragged
// M, N and K; its 16-byte strides need K % 16 == 0 and 16-byte bases.
//
// classic (limb_gemm_kernel, every other call): one block owns a 32 x 64
// output tile and walks K in 32-deep slabs (8 planes a side fit in static
// shared memory): every digit plane of the A and B tiles is staged once in
// shared memory (csrc/int8_tile.cuh: 16-byte chunks, zero-filled tails, so
// M, N and K need no padding), then each of 8 warps loads the 16 x 16
// fragments of all planes for its output block and runs every pair of every
// bucket into that bucket's int32 accumulator fragment (WMMA s8 16x16x16,
// no .satfinite). One pass over K fills all buckets. The
// int32 epilogue adds the buckets shifted by 8s and applies alpha * acc +
// beta * C, all in uint32 (wrapping mod 2^32 is the result; signed overflow
// would be undefined). NP (4 or 8 planes, a template) bounds nA, nB and
// n_buckets; pairs beyond nA or nB are skipped.
//
// Exactness: a bucket sums at most 8 K products of |d_p d_q| <= 2^14, exact
// in int32 while K <= max_k_for (limb_kernel.py:41-44): the callers chunk K
// (the int32 GEMM needs no chunks: its buckets count only mod 2^32).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "int8_tile.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace i8 = ltt::i8;
using namespace nvcuda;
using namespace ltt::hp;

enum Route { kRouteAuto = 0, kRouteClassic = 1, kRouteWgmma = 2 };

constexpr int L_BM = 32, L_BN = 64, L_BK = 32;
constexpr int L_THREADS = 256;  // 8 warps: 2 (M) x 4 (N) of 16 x 16
constexpr int L_LDC = L_BN + 4;
constexpr int A_TILE = L_BM * L_BK, B_TILE = L_BK * L_BN;

struct LimbArgs {
  const int8_t* a;  // (nA, M, K)
  const int8_t* b;  // (nB, N, K): K-major
  const int* c;     // (M, N) int32 or null (the int32 GEMM)
  int* out;         // (n_buckets, M, N), or (M, N) for the int32 GEMM
  int nA, nB, n_buckets;
  int M, N, K;
  int vec_a, vec_b;
  int alpha, beta;
};

// INT32: out = alpha * sum_{s<4} (S_s << 8s) + beta * C (mod 2^32); else the
// bucket planes S_s for s < n_buckets.
template <int NP, bool INT32>
__global__ void __launch_bounds__(L_THREADS) limb_gemm_kernel(LimbArgs p) {
  __shared__ __align__(128) int8_t As[NP][A_TILE];
  __shared__ __align__(128) int8_t Bs[NP][B_TILE];
  __shared__ __align__(128) int Cs[L_BM * L_LDC];

  const int m0 = blockIdx.y * L_BM;
  const int n0 = blockIdx.x * L_BN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 16;
  const int wn = (warp & 3) * 16;
  const size_t plane_a = (size_t)p.M * p.K, plane_b = (size_t)p.N * p.K;

  i8::FragAcc acc[NP];
#pragma unroll
  for (int s = 0; s < NP; ++s) wmma::fill_fragment(acc[s], 0);

  for (int k0 = 0; k0 < p.K; k0 += L_BK) {
    for (int q = 0; q < p.nA; ++q)
      i8::stage_tile<true, L_BM, L_BK / 16>(As[q], p.a + q * plane_a, p.K, m0, p.M, k0, p.K,
                                            p.vec_a);
    for (int q = 0; q < p.nB; ++q)
      i8::stage_tile<true, L_BN, L_BK / 16>(Bs[q], p.b + q * plane_b, p.K, n0, p.N, k0, p.K,
                                            p.vec_b);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < L_BK / 16; ++ks) {
      i8::FragA<true> fa[NP];
      i8::FragB<true> fb[NP];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        if (q < p.nA)
          wmma::load_matrix_sync(fa[q], i8::frag_ptr<true, L_BM>(As[q], wm, ks), 16);
        if (q < p.nB)
          wmma::load_matrix_sync(fb[q], i8::frag_ptr<true, L_BN>(Bs[q], wn, ks), 16);
      }
#pragma unroll
      for (int s = 0; s < NP; ++s)
#pragma unroll
        for (int q = 0; q <= s; ++q)
          if (s < p.n_buckets && q < p.nA && s - q < p.nB)
            wmma::mma_sync(acc[s], fa[q], fb[s - q], acc[s]);
    }
    __syncthreads();
  }

  if (INT32) {
    // sum_s S_s << 8s, mod 2^32, element by element of the fragment: every
    // accumulator fragment of one warp maps its elements alike
    uint32_t comb[i8::FragAcc::num_elements];
#pragma unroll
    for (int e = 0; e < i8::FragAcc::num_elements; ++e) comb[e] = 0u;
#pragma unroll
    for (int s = 0; s < 4 && s < NP; ++s)
#pragma unroll
      for (int e = 0; e < i8::FragAcc::num_elements; ++e)
        comb[e] += (uint32_t)acc[s].x[e] << (8 * s);
#pragma unroll
    for (int e = 0; e < i8::FragAcc::num_elements; ++e) acc[0].x[e] = (int)comb[e];
    wmma::store_matrix_sync(Cs + wm * L_LDC + wn, acc[0], L_LDC, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < L_BM * L_BN; i += L_THREADS) {
      const int r = i / L_BN, n = i % L_BN;
      const int gm = m0 + r, gn = n0 + n;
      if (gm >= p.M || gn >= p.N) continue;
      const size_t o = (size_t)gm * p.N + gn;
      uint32_t v = (uint32_t)Cs[r * L_LDC + n] * (uint32_t)p.alpha;
      if (p.c) v += (uint32_t)p.beta * (uint32_t)p.c[o];
      p.out[o] = (int)v;
    }
    return;
  }

  const size_t plane_o = (size_t)p.M * p.N;
  for (int s = 0; s < NP; ++s) {
    if (s >= p.n_buckets) break;
    wmma::store_matrix_sync(Cs + wm * L_LDC + wn, acc[s], L_LDC, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < L_BM * L_BN; i += L_THREADS) {
      const int r = i / L_BN, n = i % L_BN;
      const int gm = m0 + r, gn = n0 + n;
      if (gm < p.M && gn < p.N) p.out[s * plane_o + (size_t)gm * p.N + gn] = Cs[r * L_LDC + n];
    }
    __syncthreads();
  }
}

int launch_classic(LimbArgs& p, bool int32, int need, cudaStream_t st) {
  p.vec_a = p.K % 16 == 0 && aligned16(p.a);
  p.vec_b = p.K % 16 == 0 && aligned16(p.b);
  dim3 grid((p.N + L_BN - 1) / L_BN, (p.M + L_BM - 1) / L_BM);
  if (int32)
    limb_gemm_kernel<4, true><<<grid, L_THREADS, 0, st>>>(p);
  else if (need <= 4)
    limb_gemm_kernel<4, false><<<grid, L_THREADS, 0, st>>>(p);
  else
    limb_gemm_kernel<8, false><<<grid, L_THREADS, 0, st>>>(p);
  return ltt::launch_status();
}

// ---------------------------------------------------------------------------
// The wgmma route: csrc/wgmma_gemm.cuh's skeleton, a bucket a segment
// ---------------------------------------------------------------------------

// The skeleton's tile policy. A: (nA, M, K) and B: (nB, N, K), 3-D maps
// (k, row, plane). Segment seg is bucket bucket(seg): ascending for the
// bucket planes, descending (s = 3 .. 0) for the int32 GEMM's Horner sum.
template <bool INT32>
struct LimbTiles {
  int M, N;
  int ktiles;            // 128-deep k steps of one digit product
  int nA, nB, nseg;      // planes a side; buckets that have a pair
  int total;             // k steps of a tile: every pair's ktiles
  int* out;
  const int* cmat;       // the int32 GEMM's C or null
  int alpha, beta;

  __device__ __forceinline__ int bucket(int seg) const { return INT32 ? nseg - 1 - seg : seg; }
  __device__ __forceinline__ int first_p(int s) const { return max(0, s - nB + 1); }
  __device__ __forceinline__ int pairs(int s) const { return min(s, nA - 1) - first_p(s) + 1; }
  __device__ __forceinline__ int steps() const { return total; }
  __device__ __forceinline__ int segments() const { return nseg; }
  __device__ __forceinline__ int seg_steps(int seg) const { return pairs(bucket(seg)) * ktiles; }

  __device__ __forceinline__ void load(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                       uint8_t* a_tile, uint8_t* b_tile, uint64_t* bar,
                                       const TileCoord& c, int step) const {
    int pr = step / ktiles;
    const int k0 = (step - pr * ktiles) * WG_BK_I8;
    int seg = 0, s = bucket(0);
    while (pr >= pairs(s)) {  // at most 8 buckets
      pr -= pairs(s);
      s = bucket(++seg);
    }
    const int pa = first_p(s) + pr;
    tma_load_3d(a_tile, map_a, bar, k0, c.m0, pa);
    tma_load_3d(b_tile, map_b, bar, k0, c.n0, s - pa);
  }

  // the int32 GEMM: acc << 8 between its buckets; the planes: every bucket stored
  __device__ __forceinline__ bool finish(int seg, int (&acc)[64]) const {
    if (!INT32 || seg == nseg - 1) return true;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = (int)((uint32_t)acc[i] << 8);
    return false;
  }

  __device__ __forceinline__ void store4(const TileCoord&, int seg, int row, int col,
                                         int4 v) const {
    int o[4] = {v.x, v.y, v.z, v.w};
    const size_t i = (size_t)row * N + col;
    if (INT32) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t r = (uint32_t)o[e] * (uint32_t)alpha;
        if (cmat && col + e < N) r += (uint32_t)beta * (uint32_t)cmat[i + e];
        o[e] = (int)r;
      }
    }
    int* dst = out + (INT32 ? 0 : (size_t)bucket(seg) * M * N) + i;
    if (col + 4 <= N && (N & 3) == 0) {
      *reinterpret_cast<int4*>(dst) = make_int4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < N) dst[e] = o[e];
    }
  }
};

template <bool INT32>
__global__ void __launch_bounds__(WG_THREADS, WG_BLOCKS_PER_SM)
    limb_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, const LimbTiles<INT32> tiles,
                      int ntiles) {
  wgmma_gemm<int8_t, false, true>(&map_a, &map_b, tiles, ntiles);
}

// The wgmma route takes K > 0 a multiple of 16 (TMA's 16-byte strides) and
// 16-byte-aligned bases.
bool wgmma_fits(const LimbArgs& p) {
  return p.K > 0 && p.K % 16 == 0 && aligned16(p.a) && aligned16(p.b);
}

template <bool INT32>
int launch_wgmma(const LimbArgs& p, cudaStream_t st) {
  const int nseg = INT32 ? 4 : min(p.n_buckets, p.nA + p.nB - 1);
  LimbTiles<INT32> pol{p.M, p.N, (p.K + WG_BK_I8 - 1) / WG_BK_I8, p.nA, p.nB, nseg, 0,
                       p.out, p.c, p.alpha, p.beta};
  for (int s = 0; s < nseg; ++s)
    pol.total += (std::min(s, p.nA - 1) - std::max(0, s - p.nB + 1) + 1) * pol.ktiles;
  if (!INT32 && nseg < p.n_buckets) {  // buckets no pair reaches are zero
    const size_t plane = (size_t)p.M * p.N * sizeof(int);
    const cudaError_t e =
        cudaMemsetAsync(p.out + (size_t)nseg * p.M * p.N, 0, (p.n_buckets - nseg) * plane, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  CUtensorMap ma, mb;
  if (!encode_map_i8(&ma, p.a, p.K, p.M, p.nA, WG_BM) ||
      !encode_map_i8(&mb, p.b, p.K, p.N, p.nB, WG_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = limb_wgmma_kernel<INT32>;
  const int err = ltt::allow_smem(kernel, WG_SMEM_BYTES);
  if (err) return err;
  const long long tiles = (long long)((p.M + WG_BM - 1) / WG_BM) * ((p.N + WG_BN - 1) / WG_BN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ntiles = static_cast<int>(tiles);
  const int slots = sm_count() * WG_BLOCKS_PER_SM;
  kernel<<<ntiles > slots ? slots : ntiles, WG_THREADS, WG_SMEM_BYTES, st>>>(ma, mb, pol, ntiles);
  return ltt::launch_status();
}

// *taken gets the route that launched (kRouteClassic or kRouteWgmma), or -1
// where the route asked for does not fit.
int launch(LimbArgs& p, bool int32, int route, int* taken, cudaStream_t st) {
  const int np = p.nA > p.nB ? p.nA : p.nB;
  const int need = np > p.n_buckets ? np : p.n_buckets;
  *taken = -1;
  if (need > 8) return static_cast<int>(cudaErrorInvalidValue);
  const bool wg = wgmma_fits(p);
  *taken = route == kRouteAuto      ? (wg ? kRouteWgmma : kRouteClassic)
           : route == kRouteClassic ? kRouteClassic
           : route == kRouteWgmma && wg ? kRouteWgmma
                                        : -1;
  if (*taken < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (*taken == kRouteWgmma) return int32 ? launch_wgmma<true>(p, st) : launch_wgmma<false>(p, st);
  return launch_classic(p, int32, need, st);
}

}  // namespace

// a: (nA, M, K) int8 digit planes, b: (nB, N, K) K-major; out: (n_buckets,
// M, N) int32, contiguous; nA, nB, n_buckets <= 8. route: 0 picks (wgmma
// where it fits, else classic), 1 classic, 2 wgmma; *taken gets the route
// that launched.
LTT_API int ltt_gemm_limbs(const void* a, const void* b, void* out, int nA, int nB, int n_buckets,
                           int M, int N, int K, int route, int* taken, void* stream) {
  LimbArgs p = {};
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.out = static_cast<int*>(out);
  p.nA = nA;
  p.nB = nB;
  p.n_buckets = n_buckets;
  p.M = M;
  p.N = N;
  p.K = K;
  return launch(p, false, route, taken, static_cast<cudaStream_t>(stream));
}

// a: (4, M, K) int8 limbs of the int32 A, b: (4, N, K) K-major; c: (M, N)
// int32 or null, out: (M, N) int32 = alpha * (A @ B) + beta * C mod 2^32.
// route and *taken as ltt_gemm_limbs's.
LTT_API int ltt_gemm_int32(const void* a, const void* b, const void* c, void* out, int M, int N,
                           int K, int alpha, int beta, int route, int* taken, void* stream) {
  LimbArgs p = {};
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.c = static_cast<const int*>(c);
  p.out = static_cast<int*>(out);
  p.nA = p.nB = p.n_buckets = 4;
  p.M = M;
  p.N = N;
  p.K = K;
  p.alpha = alpha;
  p.beta = beta;
  return launch(p, true, route, taken, static_cast<cudaStream_t>(stream));
}
