// GEMM with a fused epilogue: out = act(alpha * op(A) op(B) + beta * C + bias),
// and its batched form out[z] = A[z] B[z].
//
// Replaces laser_tpu/ops/gemm/kernel.py:62 build_gemm (the Pallas MXU matmul)
// and, with a batch index, laser_tpu/ops/gemm/batched.py:28 _build_batched.
//
// What bounds it on the H100: the serving slice calls it at two regimes.
// Prefill (M = prompts x bucket, up to 4096; K, N in {2048, 6144, 8192}) is
// compute-bound, and the bf16/f16 path runs on the tensor cores through WMMA
// (mma.sync 16x16x16, fp32 accumulators). Decode (M = 8) reads every weight
// once for 8 rows: it is bound by the weight bytes streamed from HBM, and a
// 64-wide column tile per block gives N/64 blocks (32..128) to stream them.
// f32 runs as full-fp32 FFMA, never TF32 (config.matmul_precision "highest",
// laser_tpu/ops/gemm/kernel.py:87-89). int8 inputs (bench.py's int8 4096^3
// row, gemm_quantized) run on the int8 tensor cores (WMMA s8, int32
// accumulators: 1979 TOP/s dense is the bound at 4096^3); the accumulator
// wraps mod 2^32 (no .satfinite), as laser_tpu's int32 accumulator does.
//
// Design: one 64x64 output tile per block, K walked in 32 (16-bit tensor
// core), 64 (int8) or 16 (FFMA) deep slabs staged through shared memory.
// Transposed operands are read in place by the tile loader (int8: staged
// K-contiguous and read by column-major fragments, csrc/int8_tile.cuh).
// Out-of-range M/N/K reads load as 0 on BOTH operands (0 * garbage can be
// NaN: kernel.py:107-115); stores are masked. The float epilogue (alpha,
// beta*C, bias, activation) runs in fp32 before the single cast to the
// output dtype; the int8 epilogue runs in int32 with wrapping uint32
// arithmetic (kernel.py:122-131), alpha and beta already cast to int32 by
// the caller, a float activation on the int32 value. The batch index is
// blockIdx.z over contiguous (B, M, K) x (B, K, N) -> (B, M, N) operands.
// Simple first: no cp.async, TMA or wgmma yet.
#include <mma.h>

#include "common.cuh"
#include "int8_tile.cuh"

namespace {

using namespace nvcuda;
using ltt::from_f32;
using ltt::to_f32;

enum Epilogue { kNone = 0, kRelu = 1, kTanh = 2, kSigmoid = 3, kGelu = 4 };

struct GemmArgs {
  const void* a;
  const void* b;
  const void* c;     // (M, N) fp32 (int32 for int8 inputs) or null
  const void* bias;  // (N,) fp32 (int32 for int8 inputs) or null
  void* out;
  int M, N, K;
  int trans_a, trans_b;
  int vec_a, vec_b;  // 16-byte vector loads allowed for the operand tile
  float alpha, beta;
  int alpha_i, beta_i;  // the int8 path's int32 alpha and beta
  int epilogue;
  int out_dtype;
  long long batch_a, batch_b, batch_o;  // elements between batch entries
};

__host__ __device__ __forceinline__ int dtype_size(int dt) {
  return dt == ltt::kF32 || dt == ltt::kI32 ? 4 : dt == ltt::kI8 ? 1 : 2;
}

// Move the operand and output pointers to batch entry blockIdx.z.
__device__ __forceinline__ void to_batch_entry(GemmArgs& p, int in_size) {
  const long long z = blockIdx.z;
  p.a = static_cast<const char*>(p.a) + z * p.batch_a * in_size;
  p.b = static_cast<const char*>(p.b) + z * p.batch_b * in_size;
  p.out = static_cast<char*>(p.out) + z * p.batch_o * dtype_size(p.out_dtype);
}

__device__ __forceinline__ float activate(float r, int epi) {
  switch (epi) {
    case kRelu:
      return fmaxf(r, 0.f);
    case kTanh:
      return tanhf(r);
    case kSigmoid:
      return 1.f / (1.f + expf(-r));
    case kGelu: {
      // tanh approximation, as jax.nn.gelu's default (approximate=True)
      const float u = 0.7978845608028654f * (r + 0.044715f * r * r * r);
      return 0.5f * r * (1.f + tanhf(u));
    }
    default:
      return r;
  }
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int dt) {
  if (dt == ltt::kI32) {  // a float activation of the int8 path: truncate, as astype
    static_cast<int*>(out)[i] = __float2int_rz(v);
  } else if (dt == ltt::kF32) {
    static_cast<float*>(out)[i] = v;
  } else if (dt == ltt::kBF16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  } else {
    static_cast<__half*>(out)[i] = __float2half(v);
  }
}

__device__ __forceinline__ float epilogue_value(const GemmArgs& p, float acc, int m, int n) {
  float r = acc * p.alpha;
  if (p.c) r += p.beta * static_cast<const float*>(p.c)[(size_t)m * p.N + n];
  if (p.bias) r += static_cast<const float*>(p.bias)[n];
  return activate(r, p.epilogue);
}

// The int8 path's epilogue in int32: alpha * acc + beta * C + bias wrapping
// mod 2^32 (uint32 arithmetic: signed overflow is undefined in C++), relu on
// the int, any other activation in fp32 on the int's value.
__device__ __forceinline__ void store_int_epilogue(const GemmArgs& p, int acc, int m, int n,
                                                   size_t i) {
  uint32_t r = (uint32_t)acc * (uint32_t)p.alpha_i;
  if (p.c) r += (uint32_t)p.beta_i * (uint32_t)static_cast<const int*>(p.c)[(size_t)m * p.N + n];
  if (p.bias) r += (uint32_t)static_cast<const int*>(p.bias)[n];
  int v = (int)r;
  if (p.epilogue == kRelu) v = max(v, 0);
  if (p.epilogue == kNone || p.epilogue == kRelu) {
    if (p.out_dtype == ltt::kI32)
      static_cast<int*>(p.out)[i] = v;
    else
      store_out(p.out, i, (float)v, p.out_dtype);
  } else {
    store_out(p.out, i, activate((float)v, p.epilogue), p.out_dtype);
  }
}

template <typename T>
__device__ __forceinline__ T load_a(const GemmArgs& p, int m, int k) {
  const T* A = static_cast<const T*>(p.a);
  if (m >= p.M || k >= p.K) return from_f32<T>(0.f);
  return p.trans_a ? A[(size_t)k * p.M + m] : A[(size_t)m * p.K + k];
}

template <typename T>
__device__ __forceinline__ T load_b(const GemmArgs& p, int k, int n) {
  const T* B = static_cast<const T*>(p.b);
  if (k >= p.K || n >= p.N) return from_f32<T>(0.f);
  return p.trans_b ? B[(size_t)n * p.K + k] : B[(size_t)k * p.N + n];
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores through WMMA
// ---------------------------------------------------------------------------
constexpr int TC_BM = 64, TC_BN = 64, TC_BK = 32, TC_THREADS = 128;
constexpr int TC_LDA = TC_BK + 8;  // 16-bit ldm must be a multiple of 8
constexpr int TC_LDB = TC_BN + 8;
constexpr int TC_LDC = TC_BN + 4;  // fp32 ldm must be a multiple of 4

template <typename T>
__global__ void __launch_bounds__(TC_THREADS) gemm_tc_kernel(GemmArgs p) {
  __shared__ __align__(128) T As[TC_BM * TC_LDA];
  __shared__ __align__(128) T Bs[TC_BK * TC_LDB];
  __shared__ __align__(128) float Cs[TC_BM * TC_LDC];

  to_batch_entry(p, sizeof(T));
  const int m0 = blockIdx.y * TC_BM;
  const int n0 = blockIdx.x * TC_BN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;  // 2x2 warps, 32x32 each
  const int wn = (warp & 1) * 32;
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < p.K; k0 += TC_BK) {
    // ---- A tile (BM x BK) ----
    if (p.vec_a) {
      // row-major A with K % 8 == 0: whole 8-element chunks are in or out
      for (int c = threadIdx.x; c < TC_BM * TC_BK / 8; c += TC_THREADS) {
        const int r = c / (TC_BK / 8);
        const int kk = (c % (TC_BK / 8)) * 8;
        const int gm = m0 + r, gk = k0 + kk;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gm < p.M && gk < p.K)
          v = *reinterpret_cast<const uint4*>(A + (size_t)gm * p.K + gk);
        *reinterpret_cast<uint4*>(&As[r * TC_LDA + kk]) = v;
      }
    } else {
      for (int i = threadIdx.x; i < TC_BM * TC_BK; i += TC_THREADS) {
        int r, kk;
        if (p.trans_a) {  // neighbouring threads on neighbouring m
          kk = i / TC_BM;
          r = i % TC_BM;
        } else {
          r = i / TC_BK;
          kk = i % TC_BK;
        }
        As[r * TC_LDA + kk] = load_a<T>(p, m0 + r, k0 + kk);
      }
    }
    // ---- B tile (BK x BN) ----
    if (p.vec_b) {
      for (int c = threadIdx.x; c < TC_BK * TC_BN / 8; c += TC_THREADS) {
        const int kk = c / (TC_BN / 8);
        const int n = (c % (TC_BN / 8)) * 8;
        const int gk = k0 + kk, gn = n0 + n;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gk < p.K && gn < p.N)
          v = *reinterpret_cast<const uint4*>(B + (size_t)gk * p.N + gn);
        *reinterpret_cast<uint4*>(&Bs[kk * TC_LDB + n]) = v;
      }
    } else {
      for (int i = threadIdx.x; i < TC_BK * TC_BN; i += TC_THREADS) {
        int kk, n;
        if (p.trans_b) {  // neighbouring threads on neighbouring k
          n = i / TC_BK;
          kk = i % TC_BK;
        } else {
          kk = i / TC_BN;
          n = i % TC_BN;
        }
        Bs[kk * TC_LDB + n] = load_b<T>(p, k0 + kk, n0 + n);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * TC_LDA + kk, TC_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * TC_LDB + wn + j * 16, TC_LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * TC_LDC + wn + j * 16, acc[i][j], TC_LDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int i = threadIdx.x; i < TC_BM * TC_BN; i += TC_THREADS) {
    const int r = i / TC_BN, n = i % TC_BN;
    const int gm = m0 + r, gn = n0 + n;
    if (gm < p.M && gn < p.N)
      store_out(p.out, (size_t)gm * p.N + gn, epilogue_value(p, Cs[r * TC_LDC + n], gm, gn),
                p.out_dtype);
  }
}

// ---------------------------------------------------------------------------
// f32: full-precision FFMA (no TF32)
// ---------------------------------------------------------------------------
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS) gemm_f32_kernel(GemmArgs p) {
  __shared__ float As[F_BK][F_BM + 4];  // k-major: a thread's 4 rows are adjacent
  __shared__ float Bs[F_BK][F_BN + 4];

  to_batch_entry(p, sizeof(float));
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
      int r, kk;
      if (p.trans_a) {
        kk = i / F_BM;
        r = i % F_BM;
      } else {
        r = i / F_BK;
        kk = i % F_BK;
      }
      As[kk][r] = load_a<float>(p, m0 + r, k0 + kk);
    }
#pragma unroll
    for (int t = 0; t < F_BK * F_BN / F_THREADS; ++t) {
      const int i = threadIdx.x + t * F_THREADS;
      int kk, n;
      if (p.trans_b) {
        n = i / F_BK;
        kk = i % F_BK;
      } else {
        kk = i / F_BN;
        n = i % F_BN;
      }
      Bs[kk][n] = load_b<float>(p, k0 + kk, n0 + n);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < p.N)
        store_out(p.out, (size_t)gm * p.N + gn, epilogue_value(p, acc[i][j], gm, gn), p.out_dtype);
    }
  }
}

// ---------------------------------------------------------------------------
// int8: tensor cores through WMMA s8 16x16x16, int32 accumulators
// ---------------------------------------------------------------------------
constexpr int I8_THREADS = 128;
constexpr int I8_LDC = TC_BN + 4;

// TA / TB: the operand is stored transposed, (K, M) / (N, K).
template <bool TA, bool TB>
__global__ void __launch_bounds__(I8_THREADS) gemm_i8_kernel(GemmArgs p) {
  namespace i8 = ltt::i8;
  __shared__ __align__(128) int8_t As[i8::kTileBytes];
  __shared__ __align__(128) int8_t Bs[i8::kTileBytes];
  __shared__ __align__(128) int Cs[TC_BM * I8_LDC];

  to_batch_entry(p, 1);
  const int m0 = blockIdx.y * TC_BM;
  const int n0 = blockIdx.x * TC_BN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;  // 2x2 warps, 32x32 each
  const int wn = (warp & 1) * 32;
  const int8_t* A = static_cast<const int8_t*>(p.a);
  const int8_t* B = static_cast<const int8_t*>(p.b);
  // A staged K-contiguous unless transposed; B staged K-contiguous if transposed
  constexpr bool AK = !TA, BK = TB;

  i8::FragAcc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < p.K; k0 += i8::kTile) {
    i8::stage_tile<AK>(As, A, TA ? p.M : p.K, m0, p.M, k0, p.K, p.vec_a);
    i8::stage_tile<BK>(Bs, B, TB ? p.K : p.N, n0, p.N, k0, p.K, p.vec_b);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < i8::kTile / 16; ++ks) {
      i8::FragA<AK> fa[2];
      i8::FragB<BK> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], i8::frag_ptr<AK>(As, wm + i * 16, ks), 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], i8::frag_ptr<BK>(Bs, wn + j * 16, ks), 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * I8_LDC + wn + j * 16, acc[i][j], I8_LDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int i = threadIdx.x; i < TC_BM * TC_BN; i += I8_THREADS) {
    const int r = i / TC_BN, n = i % TC_BN;
    const int gm = m0 + r, gn = n0 + n;
    if (gm < p.M && gn < p.N)
      store_int_epilogue(p, Cs[r * I8_LDC + n], gm, gn, (size_t)gm * p.N + gn);
  }
}

int launch(GemmArgs& p, int in_dtype, int batch, cudaStream_t s) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(p.a), pb = reinterpret_cast<uintptr_t>(p.b);
  if (in_dtype == ltt::kI8) {
    // a 16-byte chunk along the contiguous index: K (A) or M (A transposed),
    // N (B) or K (B transposed)
    p.vec_a = (p.trans_a ? p.M : p.K) % 16 == 0 && pa % 16 == 0;
    p.vec_b = (p.trans_b ? p.K : p.N) % 16 == 0 && pb % 16 == 0;
    dim3 grid((p.N + TC_BN - 1) / TC_BN, (p.M + TC_BM - 1) / TC_BM, batch);
    if (p.trans_a && p.trans_b)
      gemm_i8_kernel<true, true><<<grid, I8_THREADS, 0, s>>>(p);
    else if (p.trans_a)
      gemm_i8_kernel<true, false><<<grid, I8_THREADS, 0, s>>>(p);
    else if (p.trans_b)
      gemm_i8_kernel<false, true><<<grid, I8_THREADS, 0, s>>>(p);
    else
      gemm_i8_kernel<false, false><<<grid, I8_THREADS, 0, s>>>(p);
    return ltt::launch_status();
  }
  p.vec_a = !p.trans_a && p.K % 8 == 0 && pa % 16 == 0;
  p.vec_b = !p.trans_b && p.N % 8 == 0 && pb % 16 == 0;
  if (in_dtype == ltt::kF32) {
    dim3 grid((p.N + F_BN - 1) / F_BN, (p.M + F_BM - 1) / F_BM, batch);
    gemm_f32_kernel<<<grid, F_THREADS, 0, s>>>(p);
  } else {
    dim3 grid((p.N + TC_BN - 1) / TC_BN, (p.M + TC_BM - 1) / TC_BM, batch);
    if (in_dtype == ltt::kBF16)
      gemm_tc_kernel<__nv_bfloat16><<<grid, TC_THREADS, 0, s>>>(p);
    else
      gemm_tc_kernel<__half><<<grid, TC_THREADS, 0, s>>>(p);
  }
  return ltt::launch_status();
}

GemmArgs make_args(const void* a, const void* b, void* out, int M, int N, int K, int out_dtype) {
  GemmArgs p = {};
  p.a = a;
  p.b = b;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.alpha = 1.f;
  p.alpha_i = 1;
  p.out_dtype = out_dtype;
  return p;
}

}  // namespace

// a: (M,K) or (K,M) with trans_a; b: (K,N) or (N,K) with trans_b; c: (M,N)
// or null and bias: (N,) or null, fp32 for float inputs and int32 for int8
// inputs; out: (M,N) in out_dtype (kI32 only for int8 inputs). All
// contiguous row-major. alpha and beta are the int32 values for int8 inputs.
LTT_API int ltt_gemm(const void* a, const void* b, const void* c, const void* bias, void* out,
                     int M, int N, int K, int trans_a, int trans_b, double alpha, double beta,
                     int epilogue, int in_dtype, int out_dtype, void* stream) {
  GemmArgs p = make_args(a, b, out, M, N, K, out_dtype);
  p.c = c;
  p.bias = bias;
  p.trans_a = trans_a;
  p.trans_b = trans_b;
  p.alpha = static_cast<float>(alpha);
  p.beta = static_cast<float>(beta);
  if (in_dtype == ltt::kI8) {  // int32 values, exact in a double
    p.alpha_i = static_cast<int>(alpha);
    p.beta_i = static_cast<int>(beta);
  }
  p.epilogue = epilogue;
  return launch(p, in_dtype, 1, static_cast<cudaStream_t>(stream));
}

// a: (B, M, K), b: (B, K, N), out: (B, M, N), contiguous; no epilogue.
LTT_API int ltt_gemm_batched(const void* a, const void* b, void* out, int B, int M, int N, int K,
                             int in_dtype, int out_dtype, void* stream) {
  GemmArgs p = make_args(a, b, out, M, N, K, out_dtype);
  p.batch_a = (long long)M * K;
  p.batch_b = (long long)K * N;
  p.batch_o = (long long)M * N;
  return launch(p, in_dtype, B, static_cast<cudaStream_t>(stream));
}
