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
// The planes are read once per tile pass, so at bench.py's 2048^3 the
// operations bound it by far (int64: 0.31 ms for 36 products, against
// 0.03 ms for its 33.6 MB of digits and 134 MB of bucket planes).
//
// Design: the int32 path is the same digit-product main loop as the limb
// product (chosen over a direct int32 multiply-add on the CUDA cores, which
// runs at about a sixth of the tensor-core limb rate) with a second
// epilogue. One block owns a 32 x 64 output tile and walks K in 32-deep
// slabs (8 planes a side fit in static shared memory): every digit plane of
// the A and B tiles is staged once in shared memory (csrc/int8_tile.cuh:
// 16-byte chunks, zero-filled tails, so M, N and K need no padding), then
// each of 8 warps loads the 16 x 16 fragments of all planes for its output
// block and runs every pair of every bucket into that bucket's int32
// accumulator fragment (WMMA s8 16x16x16, no
// .satfinite). One pass over K fills all buckets; the digits are read once
// per tile. A bucket sums at most 8 K products of |d_p d_q| <= 2^14, exact
// in int32 while K <= max_k_for (limb_kernel.py:41-44): the caller chunks
// K. The int32 epilogue adds the buckets shifted by 8s and applies
// alpha * acc + beta * C, all in uint32 (wrapping mod 2^32 is the result;
// signed overflow would be undefined). NP (4 or 8 planes, a template)
// bounds nA, nB and n_buckets; pairs beyond nA or nB are skipped. Simple
// first: no cp.async, TMA or wgmma yet.
#include "common.cuh"
#include "int8_tile.cuh"

namespace {

namespace i8 = ltt::i8;
using namespace nvcuda;

constexpr int L_BM = 32, L_BN = 64, L_BK = 32;
constexpr int L_THREADS = 256;  // 8 warps: 2 (M) x 4 (N) of 16 x 16
constexpr int L_LDC = L_BN + 4;
constexpr int A_TILE = L_BM * L_BK, B_TILE = L_BK * L_BN;

struct LimbArgs {
  const int8_t* a;  // (nA, M, K)
  const int8_t* b;  // (nB, K, N)
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
  const size_t plane_a = (size_t)p.M * p.K, plane_b = (size_t)p.K * p.N;

  i8::FragAcc acc[NP];
#pragma unroll
  for (int s = 0; s < NP; ++s) wmma::fill_fragment(acc[s], 0);

  for (int k0 = 0; k0 < p.K; k0 += L_BK) {
    for (int q = 0; q < p.nA; ++q)
      i8::stage_tile<true, L_BM, L_BK / 16>(As[q], p.a + q * plane_a, p.K, m0, p.M, k0, p.K,
                                            p.vec_a);
    for (int q = 0; q < p.nB; ++q)
      i8::stage_tile<false, L_BK, L_BN / 16>(Bs[q], p.b + q * plane_b, p.N, n0, p.N, k0, p.K,
                                             p.vec_b);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < L_BK / 16; ++ks) {
      i8::FragA<true> fa[NP];
      i8::FragB<false> fb[NP];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        if (q < p.nA)
          wmma::load_matrix_sync(fa[q], i8::frag_ptr<true, L_BM>(As[q], wm, ks), 16);
        if (q < p.nB)
          wmma::load_matrix_sync(fb[q], i8::frag_ptr<false, L_BK>(Bs[q], wn, ks), 16);
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

int launch(LimbArgs& p, bool int32, cudaStream_t st) {
  p.vec_a = p.K % 16 == 0 && reinterpret_cast<uintptr_t>(p.a) % 16 == 0;
  p.vec_b = p.N % 16 == 0 && reinterpret_cast<uintptr_t>(p.b) % 16 == 0;
  const int np = p.nA > p.nB ? p.nA : p.nB;
  const int need = np > p.n_buckets ? np : p.n_buckets;
  if (need > 8) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((p.N + L_BN - 1) / L_BN, (p.M + L_BM - 1) / L_BM);
  if (int32)
    limb_gemm_kernel<4, true><<<grid, L_THREADS, 0, st>>>(p);
  else if (need <= 4)
    limb_gemm_kernel<4, false><<<grid, L_THREADS, 0, st>>>(p);
  else
    limb_gemm_kernel<8, false><<<grid, L_THREADS, 0, st>>>(p);
  return ltt::launch_status();
}

}  // namespace

// a: (nA, M, K) int8 digit planes, b: (nB, K, N), out: (n_buckets, M, N)
// int32, contiguous; nA, nB, n_buckets <= 8.
LTT_API int ltt_gemm_limbs(const void* a, const void* b, void* out, int nA, int nB, int n_buckets,
                           int M, int N, int K, void* stream) {
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
  return launch(p, false, static_cast<cudaStream_t>(stream));
}

// a: (4, M, K) int8 limbs of the int32 A, b: (4, K, N), c: (M, N) int32 or
// null, out: (M, N) int32 = alpha * (A @ B) + beta * C mod 2^32.
LTT_API int ltt_gemm_int32(const void* a, const void* b, const void* c, void* out, int M, int N,
                           int K, int alpha, int beta, void* stream) {
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
  return launch(p, true, static_cast<cudaStream_t>(stream));
}
