// Weight-only int4 GEMM: out (M, N) = h (M, K) @ dequant(q4, s4), in h's
// dtype with fp32 accumulation.
//
// Replaces laser_tpu/ops/gemm/int4_kernel.py:87 build_w4_gemm.
//
// Layout (int4_kernel.py:37-73): q4 (K/2, N) int8, one byte holds rows 2i
// (low nibble) and 2i+1 (high nibble) of column n, symmetric values in
// [-7, 7]; s4 (K/group, N) f32, one scale per (row group, column); the group
// is even and divides K, so a byte never straddles two groups. A weight is
// dequantized as the TPU kernel does it (int4_kernel.py:106-109): the nibble
// sign-extends (((p & 15) ^ 8) - 8 and an arithmetic p >> 4 of the
// sign-extended byte), multiplies its group's f32 scale, and rounds to the
// activation dtype BEFORE the product.
//
// What bounds it on the H100: at decode (M = 8) every weight byte is read
// once for 8 rows, so the packed weight streams from HBM: K/2 x N bytes plus
// the scales, about a quarter of the bf16 weight. At prefill (M up to 4096)
// it is the tensor-core product. The point of the kernel is that the bf16
// weight never exists in HBM: each K step brings the packed (BK/2, BN) tile
// and its scales into registers and unpacks them into shared memory.
//
// Design: bf16/f16 activations use the tensor cores through WMMA (16x16x16,
// fp32 accumulators), one 64x64 output tile per block of 4 warps, K walked
// in 64-deep steps. The global loads of step k+1 (activation chunks, packed
// words and their scales) are issued into registers before the products of
// step k, so one step's load latency hides behind the previous step's work.
// Warps whose 32 rows lie wholly past M skip their products (decode fills 8
// of 64 rows). f32 activations run full-fp32 FFMA on the f32 dequantized
// weight (64x64 tile, 16-deep steps), which is JAX's HIGHEST product. Out of
// range rows and columns load as 0 on both operands and are never stored.
// Simple first: no split-K for decode, no wgmma or TMA yet.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using ltt::from_f32;
using ltt::to_f32;

struct W4Args {
  const void* h;     // (M, K) activations
  const int8_t* q4;  // (K/2, N) packed nibbles
  const float* s4;   // (K/group, N) scales
  void* out;         // (M, N), h's dtype
  int M, N, K, group;
  int vec_h;  // 16-byte loads of h: K % 8 == 0 and h 16-byte aligned
  int vec_q;  // 4-byte loads of q4: N % 4 == 0 and q4 4-byte aligned
};

// the two sign-extended nibbles of a packed byte p (already sign-extended
// from 8 bits), as int4_kernel.py:51-53
__device__ __forceinline__ int nib_lo(int p) { return ((p & 15) ^ 8) - 8; }
__device__ __forceinline__ int nib_hi(int p) { return p >> 4; }

__device__ __forceinline__ int byte_of(uint32_t word, int j) {
  return static_cast<int>(static_cast<signed char>((word >> (8 * j)) & 0xFFu));
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores through WMMA
// ---------------------------------------------------------------------------
constexpr int TB_M = 64, TB_N = 64, TB_K = 64, TB_THREADS = 128;
constexpr int LDA = TB_K + 8;  // 16-bit ldm must be a multiple of 8
constexpr int LDB = TB_N + 8;
constexpr int LDC = TB_N + 4;  // fp32 ldm must be a multiple of 4
constexpr int A_CHUNKS = TB_M * TB_K / 8 / TB_THREADS;         // 8 activations each
constexpr int Q_WORDS = (TB_K / 2) * (TB_N / 4) / TB_THREADS;  // 4 packed bytes each

// one K step's operands, held in registers between its load and its store
struct Stage {
  uint4 a[A_CHUNKS];
  uint32_t q[Q_WORDS];
  float s[Q_WORDS][4];
};

// T is 16 bits wide; 0 is its bit pattern for 0.0
__device__ __forceinline__ void load_stage(const W4Args& p, int m0, int n0, int k0, Stage& st) {
  const unsigned short* H = static_cast<const unsigned short*>(p.h);
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int c = threadIdx.x + i * TB_THREADS;
    const int r = c / (TB_K / 8), kk = (c % (TB_K / 8)) * 8;
    const int gm = m0 + r, gk = k0 + kk;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gm < p.M && gk < p.K) {
      const unsigned short* row = H + (size_t)gm * p.K + gk;
      if (p.vec_h) {
        v = *reinterpret_cast<const uint4*>(row);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; j < 8 && gk + j < p.K; ++j)
          w[j / 2] |= static_cast<uint32_t>(row[j]) << (16 * (j % 2));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    st.a[i] = v;
  }
#pragma unroll
  for (int i = 0; i < Q_WORDS; ++i) {
    const int w = threadIdx.x + i * TB_THREADS;
    const int r = w / (TB_N / 4), c = (w % (TB_N / 4)) * 4;
    const int gr = k0 / 2 + r;  // packed row: weight rows 2 gr, 2 gr + 1
    const int gn = n0 + c;
    uint32_t word = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) st.s[i][j] = 0.f;
    if (2 * gr < p.K && gn < p.N) {
      const int8_t* qrow = p.q4 + (size_t)gr * p.N + gn;
      const float* srow = p.s4 + (size_t)(2 * gr / p.group) * p.N + gn;
      if (p.vec_q) {
        word = *reinterpret_cast<const uint32_t*>(qrow);
      } else {
        for (int j = 0; j < 4 && gn + j < p.N; ++j)
          word |= static_cast<uint32_t>(static_cast<uint8_t>(qrow[j])) << (8 * j);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < p.N) st.s[i][j] = srow[j];
    }
    st.q[i] = word;
  }
}

// activations as they are; weights unpacked, scaled and rounded to T
template <typename T>
__device__ __forceinline__ void store_stage(const Stage& st, T* As, T* Bs) {
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int c = threadIdx.x + i * TB_THREADS;
    const int r = c / (TB_K / 8), kk = (c % (TB_K / 8)) * 8;
    *reinterpret_cast<uint4*>(&As[r * LDA + kk]) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < Q_WORDS; ++i) {
    const int w = threadIdx.x + i * TB_THREADS;
    const int r = w / (TB_N / 4), c = (w % (TB_N / 4)) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = byte_of(st.q[i], j);
      Bs[(2 * r) * LDB + c + j] = from_f32<T>(static_cast<float>(nib_lo(b)) * st.s[i][j]);
      Bs[(2 * r + 1) * LDB + c + j] = from_f32<T>(static_cast<float>(nib_hi(b)) * st.s[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(TB_THREADS) w4_gemm_tc_kernel(W4Args p) {
  __shared__ __align__(128) T As[TB_M * LDA];
  __shared__ __align__(128) T Bs[TB_K * LDB];
  __shared__ __align__(128) float Cs[TB_M * LDC];

  const int m0 = blockIdx.y * TB_M;
  const int n0 = blockIdx.x * TB_N;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;  // 2x2 warps, 32x32 each
  const int wn = (warp & 1) * 32;
  const bool live = m0 + wm < p.M;  // uniform over the warp

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Stage st;
  load_stage(p, m0, n0, 0, st);
  for (int k0 = 0; k0 < p.K; k0 += TB_K) {
    store_stage<T>(st, As, Bs);
    __syncthreads();
    if (k0 + TB_K < p.K) load_stage(p, m0, n0, k0 + TB_K, st);  // in flight below
    if (live) {
#pragma unroll
      for (int kk = 0; kk < TB_K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < TB_M * TB_N; i += TB_THREADS) {
    const int r = i / TB_N, n = i % TB_N;
    const int gm = m0 + r, gn = n0 + n;
    if (gm < p.M && gn < p.N) out[(size_t)gm * p.N + gn] = from_f32<T>(Cs[r * LDC + n]);
  }
}

// ---------------------------------------------------------------------------
// f32: full-precision FFMA on the f32 dequantized weight
// ---------------------------------------------------------------------------
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS) w4_gemm_f32_kernel(W4Args p) {
  __shared__ float As[F_BK][F_BM + 4];  // k-major: a thread's 4 rows are adjacent
  __shared__ float Bs[F_BK][F_BN + 4];

  const float* H = static_cast<const float*>(p.h);
  const int m0 = blockIdx.y * F_BM;
  const int n0 = blockIdx.x * F_BN;
  const int tx = threadIdx.x % 16;  // 4 output columns each
  const int ty = threadIdx.x / 16;  // 4 output rows each
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += F_BK) {
#pragma unroll
    for (int t = 0; t < F_BM * F_BK / F_THREADS; ++t) {
      const int i = threadIdx.x + t * F_THREADS;
      const int r = i / F_BK, kk = i % F_BK;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < p.M && gk < p.K) ? H[(size_t)gm * p.K + gk] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < (F_BK / 2) * F_BN / F_THREADS; ++t) {
      const int i = threadIdx.x + t * F_THREADS;
      const int r = i / F_BN, n = i % F_BN;
      const int gr = k0 / 2 + r, gn = n0 + n;
      float lo = 0.f, hi = 0.f;
      if (2 * gr < p.K && gn < p.N) {
        const int b = p.q4[(size_t)gr * p.N + gn];
        const float s = p.s4[(size_t)(2 * gr / p.group) * p.N + gn];
        lo = static_cast<float>(nib_lo(b)) * s;
        hi = static_cast<float>(nib_hi(b)) * s;
      }
      Bs[2 * r][n] = lo;
      Bs[2 * r + 1][n] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < p.N) out[(size_t)gm * p.N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// h (M, K) in dtype; q4 (K/2, N) int8; s4 (K/group, N) f32; out (M, N) in
// dtype. All contiguous row-major; group even, K a multiple of group.
LTT_API int ltt_w4_gemm(const void* h, const void* q4, const void* s4, void* out, int M, int N,
                        int K, int group, int dtype, void* stream) {
  W4Args p;
  p.h = h;
  p.q4 = static_cast<const int8_t*>(q4);
  p.s4 = static_cast<const float*>(s4);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.group = group;
  p.vec_h = K % 8 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  p.vec_q = N % 4 == 0 && reinterpret_cast<uintptr_t>(q4) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32) {
    dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
    w4_gemm_f32_kernel<<<grid, F_THREADS, 0, s>>>(p);
  } else {
    dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M);
    if (dtype == ltt::kBF16)
      w4_gemm_tc_kernel<__nv_bfloat16><<<grid, TB_THREADS, 0, s>>>(p);
    else
      w4_gemm_tc_kernel<__half><<<grid, TB_THREADS, 0, s>>>(p);
  }
  return ltt::launch_status();
}
