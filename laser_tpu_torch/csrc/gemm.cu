// GEMM with a fused epilogue: out = act(alpha * op(A) op(B) + beta * C + bias),
// and its batched form out[z] = A[z] B[z].
//
// Replaces laser_tpu/ops/gemm/kernel.py:62 build_gemm (the Pallas MXU matmul)
// and, with a batch index, laser_tpu/ops/gemm/batched.py:28 _build_batched.
//
// What bounds it on the H100: the slices call it at two regimes. Prefill and
// training (M up to 8192; K, N 2048..14336) are compute-bound: 989 TFLOP/s
// of bf16 tensor cores. The decode products (M = 1..40: a batch of slots, a
// speculative verify's windows) read every weight once for a few rows: 8
// operations a byte at M 8 against the ridge of 295, bound by the weight
// bytes streamed from HBM. f32 runs as full-fp32 FFMA, never TF32
// (config.matmul_precision "highest", laser_tpu/ops/gemm/kernel.py:87-89).
// int8 inputs (bench.py's int8 4096^3 row, gemm_quantized) run on the int8
// tensor cores (wgmma s8 where it fits, else WMMA s8; int32 accumulators:
// 1979 TOP/s dense is the bound at 4096^3); the accumulator
// wraps mod 2^32 (no .satfinite), as laser_tpu's int32 accumulator does.
//
// Four routes; the launcher picks one from the shape and alignment, or is
// asked for one (enum Route), and reports it:
// - split-K (small M): bf16/f16/f32 products with M <= SPLITK_MAX_M
//   (SPLITK_F32_MAX_M for f32), B not transposed, A not transposed, N % 8 ==
//   0 (f32: N % 4), 16-byte-aligned bases, one batch entry. The skeleton of
//   csrc/splitk.cuh streams B through a 4-stage cp.async ring over
//   (column tile, K split) blocks, A's K-slice in shared memory, mma.sync
//   for 16-bit inputs; f32 runs gemm_splitk_f32_kernel below (FFMA, a
//   column a thread, the same ring and plan). Partials reduce in a second
//   kernel in a fixed order; the epilogue runs once, after the sum.
// - wgmma (compute-bound 16-bit products, M >= WG_MIN_M; int8 products
//   with K % 16 == 0, one batch entry): see their notes.
// - simt (f32 products split-K does not take: M > SPLITK_F32_MAX_M, or
//   transposed operands, or a batch): gemm_simt_kernel, the FFMA skeleton of
//   csrc/simt_gemm.cuh (a 128 x 128 tile, 8 x 8 outputs a thread, both
//   operands staged k-major through a 3-stage ring), any transposition,
//   each operand's contiguous dimension a multiple of 4 and 16-byte bases.
// - classic, every other product: one 64x64 output tile per block, K walked
//   in 32 (16-bit WMMA: gemm_tc_kernel), 64 (int8) or 16 (FFMA:
//   gemm_f32_kernel) deep slabs staged through shared memory. Transposed
//   operands are read in place by the tile loader (int8: staged
//   K-contiguous and read by column-major fragments, csrc/int8_tile.cuh). It
//   takes the products the other routes cannot: ragged (N % 8, K % 8; f32:
//   a contiguous dimension % 4) or unaligned operands, int8.
// Out-of-range M/N/K reads load as 0 on BOTH operands (0 * garbage can be
// NaN: kernel.py:107-115); stores are masked. The float epilogue (alpha,
// beta*C, bias, activation) runs in fp32 before the single cast to the
// output dtype; the int8 epilogue runs in int32 with wrapping uint32
// arithmetic (kernel.py:122-131), alpha and beta already cast to int32 by
// the caller, a float activation on the int32 value. The batch index is
// blockIdx.z over contiguous (B, M, K) x (B, K, N) -> (B, M, N) operands.
#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "int8_tile.cuh"
#include "simt_gemm.cuh"
#include "splitk.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace nvcuda;
using namespace ltt::hp;
namespace sk = ltt::sk;
namespace simt = ltt::simt;
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

// alpha * acc + beta * C + bias of the int8 path, wrapping mod 2^32 (uint32
// arithmetic: signed overflow is undefined in C++)
__device__ __forceinline__ int int_epilogue_value(const GemmArgs& p, int acc, int m, int n) {
  uint32_t r = (uint32_t)acc * (uint32_t)p.alpha_i;
  if (p.c) r += (uint32_t)p.beta_i * (uint32_t)static_cast<const int*>(p.c)[(size_t)m * p.N + n];
  if (p.bias) r += (uint32_t)static_cast<const int*>(p.bias)[n];
  return (int)r;
}

// The int8 path's epilogue in int32 (int_epilogue_value), relu on the int,
// any other activation in fp32 on the int's value.
__device__ __forceinline__ void store_int_epilogue(const GemmArgs& p, int acc, int m, int n,
                                                   size_t i) {
  int v = int_epilogue_value(p, acc, m, n);
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


// ---------------------------------------------------------------------------
// bf16 / f16 on Hopper: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------
// Replaces the same TPU kernels (kernel.py:62 build_gemm, batched.py:28
// _build_batched) on the compute-bound shapes. What bounds it on the H100:
// at the prefill and training shapes (M 1024..8192, K and N 2048..14336, the
// LM loss's 4092 x 4096 x 8192 chunks) 2MNK operations over (MK + KN + MN)
// 2-byte elements is far above the 295 operations a byte where the tensor
// cores, not HBM, are the limit: 989 TFLOP/s is the bound. Only wgmma reaches
// that rate, and only if the operands arrive in shared memory while earlier
// products run. So:
// - one producer warp issues TMA tile loads (cp.async.bulk.tensor, 3-D:
//   column, row, batch entry) into a ring of WG_STAGES stages, each stage an
//   A tile (128 x 64) and a B tile (64 x 128), 128-byte swizzled, with a
//   full/empty mbarrier pair a stage. TMA fills out-of-range boxes with zeros,
//   so ragged M, N and K read 0 on both operands (the rule of the kernels
//   above) with no masks in the loop;
// - two consumer warpgroups, each 64 rows of the 128 x 128 output tile, run
//   wgmma.mma_async m64n128k16 (fp32 accumulators in registers) on each
//   stage as it lands, keep one group of products in flight and free a stage
//   as soon as its products are done;
// - transposed operands stay in place: a K-contiguous operand (A, or B
//   transposed) is read K-major, an M- or N-contiguous one MN-major (the
//   instruction's transpose bits), each with its own box and descriptor;
// - the epilogue goes through shared memory: each half of the tile's
//   columns is written from the accumulators as fp32 into the tile's last
//   ring stage, then all 256 consumer threads run alpha, beta * C (fp32 C),
//   bias and the activation on 4 neighbouring outputs at a time, one cast,
//   one vector store. Run from the registers, with the activation picked
//   per element, the unrolled epilogue carried 64 copies of every
//   activation and took longer than the main loop on an H100 (instruction
//   fetch); this one is a short loop, and its stores are coalesced;
// - a persistent grid of two blocks an SM (288 threads, 97 KB of shared
//   memory each) walks the output tiles 8 tile rows at a time: the ring runs
//   on across a block's tiles, so the producer loads the next tile's first
//   stages during the epilogue.
// What holds it on an H100 (chip_smoke.py phases 2 and 15): at a 128 x 128
// tile each 64-deep k step reads 32 KB from L2 for 2.1 MFLOP. Wider tiles
// (256 x 128, 128 x 256, one block an SM) ran slower in trials made while
// the epilogue still ran from the registers, and have not been tried with
// this one; they, and thread-block clusters that share a tile's loads by
// TMA multicast, are the next steps.
// The route needs 16-byte-aligned bases and each operand's contiguous
// dimension a multiple of 8 (TMA's 16-byte strides) and M >= WG_MIN_M.
// The ring, the consumers and the epilogue's staging are the skeleton of
// csrc/wgmma_gemm.cuh (shared with the packed GEMM); DenseTiles below gives
// it this kernel's box coordinates and epilogue.
// The routes' M thresholds, from chip_smoke.py phase 2's crossover (every
// route asked for at M 1..128, 20 calls in a CUDA graph; NVIDIA H100 80GB
// HBM3, 700 W; PERF.md §6). bf16 split-K against wgmma: on the decode
// product (K 2048, N 6144, 48 column tiles) split-K is ahead to M 16 and
// behind from M 32 (0.0240 against 0.0209 ms at M 40); on Llama-3-8B's
// w_down (K 14336, N 4096) it is ahead at every M to 64 (0.0840 against
// 0.1221 at M 40), as on every product whose few column tiles leave
// wgmma's grid a fraction of the SMs. 40 keeps the speculative verify's
// rows (W 5 x 8 slots) on split-K. wgmma is ahead of the WMMA kernel at
// every M measured, so it takes every other 16-bit product it fits. f32
// (K 2048, N 6144): split-K is ahead of simt at every M to 64 (0.1334
// against 0.2213 ms at M 64), so SPLITK_F32_MAX_M stays 64; simt is ahead
// of the classic FFMA kernel at M 16..64 and 256 (0.2359 against 0.2664)
// and even with it at M 128, where simt's 48 tiles leave most SMs idle
// (0.2341 against 0.2311, 0.2355 against 0.2428 in another run), so simt
// takes every other f32 product it fits. int8 (K 4096, N 4096): the wgmma
// route is ahead of the WMMA kernel at every M measured, 1 to 128, even with
// B's K-major copy in the call (0.0620 against 0.0869 ms at M 1, 0.0621
// against 0.1000 at M 128; 0.0164 on a B given K-major), so it takes every
// int8 product it fits.
constexpr int SPLITK_MAX_M = 40;
constexpr int SPLITK_F32_MAX_M = 64;
constexpr int WG_MIN_M = SPLITK_MAX_M + 1;

enum Route {
  kRouteAuto = 0, kRouteClassic = 1, kRouteWgmma = 2, kRouteSplitK = 3, kRouteSimt = 4
};

__device__ __forceinline__ void store_out2(void* out, size_t i, float v0, float v1, int dt) {
  if (dt == ltt::kF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = make_float2(v0, v1);
  } else if (dt == ltt::kBF16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + i) =
        __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<__half2*>(static_cast<__half*>(out) + i) = __floats2half2_rn(v0, v1);
  }
}

// Four outputs from column col of row row (values v, col a multiple of 4):
// the float epilogue on each, one cast, one vector store where the row holds
// all four and they are aligned, else one store each.
__device__ __forceinline__ void epilogue_store4(const GemmArgs& p, void* out, int row, int col,
                                                float4 v) {
  const size_t i = (size_t)row * p.N + col;
  float r[4] = {v.x, v.y, v.z, v.w};
  const int n = min(4, p.N - col);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) r[e] = epilogue_value(p, r[e], row, col + e);
  if (n == 4 && (p.N & 3) == 0) {
    if (p.out_dtype == ltt::kF32) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
      store_out2(out, i, r[0], r[1], p.out_dtype);
      store_out2(out, i + 2, r[2], r[3], p.out_dtype);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) store_out(out, i + e, r[e], p.out_dtype);
  }
}

// The skeleton's tile policy for row-major operands. TA: A stored (K, M),
// read MN-major; TB: B stored (N, K), read K-major. Each operand is a 3-D
// map (column, row, batch entry).
template <bool TA, bool TB>
struct DenseTiles : OneSegment {
  GemmArgs p;
  int M, N;

  __device__ __forceinline__ void load(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                       uint8_t* a_tile, uint8_t* b_tile, uint64_t* bar,
                                       const TileCoord& c, int kt) const {
    const int k0 = kt * WG_BK;
    if (TA) {
      tma_load_3d(a_tile, map_a, bar, c.m0, k0, c.z);
      tma_load_3d(a_tile + WG_HALF_BYTES, map_a, bar, c.m0 + 64, k0, c.z);
    } else {
      tma_load_3d(a_tile, map_a, bar, k0, c.m0, c.z);
    }
    if (TB) {
      tma_load_3d(b_tile, map_b, bar, k0, c.n0, c.z);
    } else {
      tma_load_3d(b_tile, map_b, bar, c.n0, k0, c.z);
      tma_load_3d(b_tile + WG_HALF_BYTES, map_b, bar, c.n0 + 64, k0, c.z);
    }
  }

  __device__ __forceinline__ void store4(const TileCoord& c, int, int row, int col,
                                         float4 v) const {
    void* out = static_cast<char*>(p.out) + (size_t)c.z * p.batch_o * dtype_size(p.out_dtype);
    epilogue_store4(p, out, row, col, v);
  }
};

template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(WG_THREADS, WG_BLOCKS_PER_SM)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, const DenseTiles<TA, TB> tiles,
                      int ntiles) {
  wgmma_gemm<T, TA, TB>(&map_a, &map_b, tiles, ntiles);
}

// The wgmma route takes bf16/f16 inputs with 16-byte-aligned bases, K > 0,
// each operand's contiguous dimension a multiple of 8 (TMA strides are
// multiples of 16 bytes) and M >= min_m.
bool wgmma_fits(const GemmArgs& p, int in_dtype, int min_m) {
  if ((in_dtype != ltt::kBF16 && in_dtype != ltt::kF16) || p.M < min_m || p.K <= 0) return false;
  if (reinterpret_cast<uintptr_t>(p.a) % 16 || reinterpret_cast<uintptr_t>(p.b) % 16) return false;
  const int a_inner = p.trans_a ? p.M : p.K;
  const int b_inner = p.trans_b ? p.K : p.N;
  return a_inner % 8 == 0 && b_inner % 8 == 0;
}

template <typename T, bool TA, bool TB>
int launch_wgmma_tt(const GemmArgs& p, int batch, cudaStream_t s) {
  CUtensorMap ma, mb;
  const int dt = std::is_same<T, __half>::value ? ltt::kF16 : ltt::kBF16;
  const bool ok = (TA ? encode_map(&ma, p.a, dt, p.M, p.K, batch, 64, 64)
                      : encode_map(&ma, p.a, dt, p.K, p.M, batch, 64, WG_BM)) &&
                  (TB ? encode_map(&mb, p.b, dt, p.K, p.N, batch, 64, WG_BN)
                      : encode_map(&mb, p.b, dt, p.N, p.K, batch, 64, 64));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_wgmma_kernel<T, TA, TB>;
  const int err = ltt::allow_smem(kernel, WG_SMEM_BYTES);
  if (err) return err;
  const long long tiles =
      (long long)((p.M + WG_BM - 1) / WG_BM) * ((p.N + WG_BN - 1) / WG_BN) * batch;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ntiles = static_cast<int>(tiles);
  const int slots = sm_count() * WG_BLOCKS_PER_SM;
  const DenseTiles<TA, TB> pol{{(p.K + WG_BK - 1) / WG_BK}, p, p.M, p.N};
  kernel<<<ntiles > slots ? slots : ntiles, WG_THREADS, WG_SMEM_BYTES, s>>>(ma, mb, pol, ntiles);
  return ltt::launch_status();
}

template <typename T>
int launch_wgmma_t(const GemmArgs& p, int batch, cudaStream_t s) {
  if (p.trans_a && p.trans_b) return launch_wgmma_tt<T, true, true>(p, batch, s);
  if (p.trans_a) return launch_wgmma_tt<T, true, false>(p, batch, s);
  if (p.trans_b) return launch_wgmma_tt<T, false, true>(p, batch, s);
  return launch_wgmma_tt<T, false, false>(p, batch, s);
}

int launch_wgmma(const GemmArgs& p, int in_dtype, int batch, cudaStream_t s) {
  if (in_dtype == ltt::kBF16) return launch_wgmma_t<__nv_bfloat16>(p, batch, s);
  return launch_wgmma_t<__half>(p, batch, s);
}

// ---------------------------------------------------------------------------
// int8 on Hopper: the same skeleton on the int8 tensor cores
// ---------------------------------------------------------------------------
// Replaces kernel.py:62 build_gemm's int8 -> int32 case (the int8 4096^3 row
// of bench.py, gemm_quantized) where it fits. What bounds it on the H100: 2MNK
// int8 operations at 1979 TOP/s (0.0694 ms at 4096^3) against 48 MB of
// operands and output at 3.35 TB/s (0.0150 ms): the tensor cores. Only wgmma
// reaches that rate, so the route is gemm_wgmma_kernel's skeleton
// (csrc/wgmma_gemm.cuh) with the int8 instruction, m64n128k32 s32.s8.s8:
// - a stage is a bf16 stage in bytes, 128 rows of 128 bytes (k 128) a
//   side, 128-byte swizzled, so the ring, the descriptors and the 32-byte k
//   step are the 16-bit kernel's; int32 accumulators, no .satfinite, so the
//   sum wraps mod 2^32 as gemm_i8_kernel's and laser_tpu's accumulator do;
// - the 8-bit forms read only K-major operands, so the route takes A (M, K)
//   and B transposed (N, K) and nothing else: the wrapper
//   (ops/gemm/kernel.py) copies a transposed A or a row-major B K-major
//   first, with csrc/transpose.cu's 1-byte kernel (K x N bytes, 16 MB at
//   4096^3, a launch of its own);
// - the epilogue stages the int32 bits (never a float: 24 bits would not
//   hold them) through the tile's last stage and runs gemm_i8_kernel's
//   int32 epilogue (alpha, beta * C, bias wrapping mod 2^32, the
//   activation, the output type) on 4 outputs at a time;
// - TMA fills boxes past M, N and K with zeros, so ragged edges need no
//   masks; its 16-byte strides need K % 16 == 0 and 16-byte bases. One
//   batch entry (ltt_gemm; the batched int8 product stays on
//   gemm_i8_kernel).

// The int8 epilogue on four outputs of row `row` from column `col`: an int32
// output without a float activation is one 16-byte store where the row holds
// all four.
__device__ __forceinline__ void int_epilogue_store4(const GemmArgs& p, int row, int col, int4 v) {
  const size_t i = (size_t)row * p.N + col;
  const int r[4] = {v.x, v.y, v.z, v.w};
  const int n = min(4, p.N - col);
  if (n == 4 && (p.N & 3) == 0 && p.out_dtype == ltt::kI32 &&
      (p.epilogue == kNone || p.epilogue == kRelu)) {
    int o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = int_epilogue_value(p, r[e], row, col + e);
      if (p.epilogue == kRelu) o[e] = max(o[e], 0);
    }
    *reinterpret_cast<int4*>(static_cast<int*>(p.out) + i) = make_int4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) store_int_epilogue(p, r[e], row, col + e, i + e);
  }
}

// The skeleton's tile policy for the int8 route: A (M, K) and B (N, K), both
// K-major 2-D maps (one batch entry).
struct I8Tiles : OneSegment {
  GemmArgs p;
  int M, N;

  __device__ __forceinline__ void load(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                       uint8_t* a_tile, uint8_t* b_tile, uint64_t* bar,
                                       const TileCoord& c, int kt) const {
    const int k0 = kt * WG_BK_I8;
    tma_load_3d(a_tile, map_a, bar, k0, c.m0, 0);
    tma_load_3d(b_tile, map_b, bar, k0, c.n0, 0);
  }

  __device__ __forceinline__ void store4(const TileCoord&, int, int row, int col, int4 v) const {
    int_epilogue_store4(p, row, col, v);
  }
};

__global__ void __launch_bounds__(WG_THREADS, WG_BLOCKS_PER_SM)
    gemm_i8_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b, const I8Tiles tiles,
                         int ntiles) {
  wgmma_gemm<int8_t, false, true>(&map_a, &map_b, tiles, ntiles);
}

// The int8 route takes one batch entry (ltt_gemm only) with K-major operands
// (A not transposed, B transposed), K > 0 a multiple of 16 and 16-byte
// bases.
bool i8_wgmma_fits(const GemmArgs& p, int in_dtype, int batch, bool ltt_gemm_only) {
  if (in_dtype != ltt::kI8 || batch != 1 || !ltt_gemm_only || p.K <= 0 || p.K % 16) return false;
  return !p.trans_a && p.trans_b && aligned16(p.a) && aligned16(p.b);
}

int launch_i8_wgmma(const GemmArgs& p, cudaStream_t s) {
  CUtensorMap ma, mb;
  if (!encode_map_i8(&ma, p.a, p.K, p.M, 1, WG_BM) ||
      !encode_map_i8(&mb, p.b, p.K, p.N, 1, WG_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = ltt::allow_smem(gemm_i8_wgmma_kernel, WG_SMEM_BYTES);
  if (err) return err;
  const long long tiles = (long long)((p.M + WG_BM - 1) / WG_BM) * ((p.N + WG_BN - 1) / WG_BN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ntiles = static_cast<int>(tiles);
  const int slots = sm_count() * WG_BLOCKS_PER_SM;
  const I8Tiles pol{{(p.K + WG_BK_I8 - 1) / WG_BK_I8}, p, p.M, p.N};
  gemm_i8_wgmma_kernel<<<ntiles > slots ? slots : ntiles, WG_THREADS, WG_SMEM_BYTES, s>>>(
      ma, mb, pol, ntiles);
  return ltt::launch_status();
}

// ---------------------------------------------------------------------------
// Split-K for few rows (the decode products): csrc/splitk.cuh
// ---------------------------------------------------------------------------

// The GEMM's epilogue on the split-K route's sums: alpha, beta * C, bias,
// the activation in fp32, one cast.
struct GemmEpi {
  GemmArgs p;
  __device__ __forceinline__ void store2(int row, int col, float v0, float v1) const {
    store_out2(p.out, (size_t)row * p.N + col, epilogue_value(p, v0, row, col),
               epilogue_value(p, v1, row, col + 1), p.out_dtype);
  }
  __device__ __forceinline__ void store1(int row, int col, float v) const {
    store_out(p.out, (size_t)row * p.N + col, epilogue_value(p, v, row, col), p.out_dtype);
  }
};

// f32 split-K: the same ring and plan as the 16-bit skeleton, FFMA in full
// fp32, 128 threads. Thread t owns block column t (B rows read 128 floats a warp, no
// bank conflicts) and all MP (>= M) rows; A's slice is stored k-major, so a
// k step reads its rows as MP / 4 broadcast float4s.
constexpr int SF_BK = 32, SF_STAGES = 4, SF_THREADS = sk::kBN;
constexpr int SF_STAGE_BYTES = SF_BK * sk::kBN * 4;

template <int MP>
__global__ void __launch_bounds__(SF_THREADS, 2)
    gemm_splitk_f32_kernel(GemmArgs p, sk::Plan pl, float* __restrict__ ws) {
  extern __shared__ __align__(128) uint8_t sf_smem[];
  const float* A = static_cast<const float*>(p.a);
  const float* B = static_cast<const float*>(p.b);
  const int M = p.M, N = p.N, K = p.K;
  const int n0 = blockIdx.x * sk::kBN, split = blockIdx.y;
  const int k_begin = split * pl.kchunk, k_end = min(K, k_begin + pl.kchunk);
  const int ktiles = (k_end - k_begin + SF_BK - 1) / SF_BK;
  float* As = reinterpret_cast<float*>(sf_smem + SF_STAGES * SF_STAGE_BYTES);  // [k][MP]
  const int tid = threadIdx.x;

  // rows [k0, k0 + SF_BK) x block columns, 4-float chunks, zeros past the split and N
  auto load = [&](int kt) {
    const uint32_t base = smem_u32(sf_smem + (kt % SF_STAGES) * SF_STAGE_BYTES);
    const int k0 = k_begin + kt * SF_BK;
#pragma unroll
    for (int it = 0; it < SF_BK * (sk::kBN / 4) / SF_THREADS; ++it) {
      const int i = tid + it * SF_THREADS;
      const int r = i / (sk::kBN / 4), c = (i % (sk::kBN / 4)) * 4;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < k_end && gn < N;
      cp_async16(base + (r * sk::kBN + c) * 4, ok ? B + (size_t)gk * N + gn : B, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < SF_STAGES - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();
  }
  const int kw = ktiles * SF_BK;
  for (int i = tid; i < MP * kw; i += SF_THREADS) {
    const int m = i / kw, k = i % kw;
    const int gk = k_begin + k;
    As[k * MP + m] = (m < M && gk < k_end) ? A[(size_t)m * K + gk] : 0.f;
  }

  float acc[MP];
#pragma unroll
  for (int m = 0; m < MP; ++m) acc[m] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<SF_STAGES - 2>();
    __syncthreads();
    if (kt + SF_STAGES - 1 < ktiles) load(kt + SF_STAGES - 1);
    cp_async_commit();
    const float* st = reinterpret_cast<const float*>(sf_smem + (kt % SF_STAGES) * SF_STAGE_BYTES);
    const float* ak = As + kt * SF_BK * MP;
#pragma unroll 4
    for (int kk = 0; kk < SF_BK; ++kk) {
      const float bv = st[kk * sk::kBN + tid];
#pragma unroll
      for (int m4 = 0; m4 < MP / 4; ++m4) {
        const float4 av = *reinterpret_cast<const float4*>(ak + kk * MP + 4 * m4);
        acc[4 * m4] = fmaf(av.x, bv, acc[4 * m4]);
        acc[4 * m4 + 1] = fmaf(av.y, bv, acc[4 * m4 + 1]);
        acc[4 * m4 + 2] = fmaf(av.z, bv, acc[4 * m4 + 2]);
        acc[4 * m4 + 3] = fmaf(av.w, bv, acc[4 * m4 + 3]);
      }
    }
  }

  const int cn = n0 + tid;
  if (cn >= N) return;
  const GemmEpi epi{p};
#pragma unroll
  for (int m = 0; m < MP; ++m) {
    if (m >= M) break;
    if (pl.splits == 1)
      epi.store1(m, cn, acc[m]);
    else
      ws[((size_t)split * M + m) * N + cn] = acc[m];
  }
}

// the f32 kernel's padded rows: 8, 16, 32 or 64 (instantiated)
int f32_rows(int M) { return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64; }

sk::Plan splitk_f32_plan(const GemmArgs& p) {
  const int mp = f32_rows(p.M);
  const int room = sk::kBlockSmem - SF_STAGES * SF_STAGE_BYTES;
  const int kmax = room / (4 * mp) / SF_BK * SF_BK;
  return sk::plan(p.N, p.K, SF_BK, kmax, sm_count());
}

template <int MP>
int launch_splitk_f32_mp(const GemmArgs& p, const sk::Plan& pl, float* ws, cudaStream_t s) {
  auto kernel = gemm_splitk_f32_kernel<MP>;
  const int smem = SF_STAGES * SF_STAGE_BYTES + MP * pl.kchunk * 4;
  const int err = ltt::allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<dim3((p.N + sk::kBN - 1) / sk::kBN, pl.splits), SF_THREADS, smem, s>>>(p, pl, ws);
  if (pl.splits > 1) {
    const int st = ltt::launch_status();
    if (st) return st;
    sk::launch_reduce(ws, pl.splits, p.M, p.N, GemmEpi{p}, s);
  }
  return ltt::launch_status();
}

int launch_splitk_f32(const GemmArgs& p, float* ws, cudaStream_t s) {
  const sk::Plan pl = splitk_f32_plan(p);
  switch (f32_rows(p.M)) {
    case 8: return launch_splitk_f32_mp<8>(p, pl, ws, s);
    case 16: return launch_splitk_f32_mp<16>(p, pl, ws, s);
    case 32: return launch_splitk_f32_mp<32>(p, pl, ws, s);
    default: return launch_splitk_f32_mp<64>(p, pl, ws, s);
  }
}

// The split-K route takes one batch entry of bf16/f16/f32 (M <= 64) with neither operand transposed, K > 0, N % 8 == 0 (f32: N % 4)
// and 16-byte-aligned bases, and M <= max_m.
bool splitk_fits(const GemmArgs& p, int in_dtype, int batch, int max_m) {
  if (batch != 1 || p.trans_a || p.trans_b || p.M < 1 || p.M > max_m || p.K <= 0) return false;
  if (!aligned16(p.a) || !aligned16(p.b)) return false;
  if (in_dtype == ltt::kF32) return p.M <= 64 && p.N % 4 == 0;
  return (in_dtype == ltt::kBF16 || in_dtype == ltt::kF16) && p.M <= 16 * sk::kMaxMT &&
         p.N % 8 == 0;
}

long long splitk_workspace(const GemmArgs& p, int in_dtype) {
  if (in_dtype == ltt::kF32) {
    const sk::Plan pl = splitk_f32_plan(p);
    return pl.splits > 1 ? (long long)pl.splits * p.M * p.N * 4 : 0;
  }
  if (in_dtype == ltt::kBF16)
    return sk::workspace_bytes(sk::dense_weights<__nv_bfloat16>(p.b, p.N), p.M, p.N, p.K);
  return sk::workspace_bytes(sk::dense_weights<__half>(p.b, p.N), p.M, p.N, p.K);
}

int launch_splitk(const GemmArgs& p, int in_dtype, float* ws, cudaStream_t s) {
  if (splitk_workspace(p, in_dtype) > 0 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == ltt::kF32) return launch_splitk_f32(p, ws, s);
  const int vec_a = p.K % 8 == 0;  // A is 16-byte aligned (splitk_fits)
  if (in_dtype == ltt::kBF16)
    return sk::launch(static_cast<const __nv_bfloat16*>(p.a), p.M, p.N, p.K, vec_a,
                      sk::dense_weights<__nv_bfloat16>(p.b, p.N), ws, GemmEpi{p}, s);
  return sk::launch(static_cast<const __half*>(p.a), p.M, p.N, p.K, vec_a,
                    sk::dense_weights<__half>(p.b, p.N), ws, GemmEpi{p}, s);
}

// ---------------------------------------------------------------------------
// f32 on the simt skeleton (csrc/simt_gemm.cuh): see its note
// ---------------------------------------------------------------------------

// The skeleton's tile policy for row-major operands. TA: A stored (K, M),
// k-major; TB: B stored (N, K), k-minor. Reads past M, N or K are 0.
template <bool TA, bool TB>
struct SimtDense {
  static constexpr bool kAKMajor = TA, kBKMajor = !TB;
  GemmArgs p;
  int M, N, ktiles, m0, n0;

  __device__ __forceinline__ const float* a(int kt, int x, int y, bool& ok) const {
    const float* A = static_cast<const float*>(p.a);
    const int k = kt * simt::kBK + (TA ? x : y), m = m0 + (TA ? y : x);
    ok = k < p.K && m < M;
    return ok ? A + (TA ? (size_t)k * M + m : (size_t)m * p.K + k) : A;
  }

  __device__ __forceinline__ const float* b(int kt, int x, int y, bool& ok) const {
    const float* B = static_cast<const float*>(p.b);
    const int k = kt * simt::kBK + (TB ? y : x), n = n0 + (TB ? x : y);
    ok = k < p.K && n < N;
    return ok ? B + (TB ? (size_t)n * p.K + k : (size_t)k * N + n) : B;
  }

  __device__ __forceinline__ void store4(int row, int col, float4 v) const {
    epilogue_store4(p, p.out, row, col, v);
  }
};

template <bool TA, bool TB>
__global__ void __launch_bounds__(simt::kThreads, simt::kBlocksPerSm)
    gemm_simt_kernel(GemmArgs p) {
  extern __shared__ __align__(16) float simt_smem[];
  to_batch_entry(p, sizeof(float));
  const SimtDense<TA, TB> t{p, p.M, p.N, (p.K + simt::kBK - 1) / simt::kBK,
                            (int)blockIdx.y * simt::kBM, (int)blockIdx.x * simt::kBN};
  simt::gemm_tile(t, t.m0, t.n0, simt_smem);
}

// The simt route takes f32 inputs with 16-byte-aligned bases and each
// operand's contiguous dimension a multiple of 4 (whole 16-byte vectors).
bool simt_fits(const GemmArgs& p, int in_dtype) {
  if (in_dtype != ltt::kF32 || !aligned16(p.a) || !aligned16(p.b)) return false;
  return (p.trans_a ? p.M : p.K) % 4 == 0 && (p.trans_b ? p.K : p.N) % 4 == 0;
}

template <bool TA, bool TB>
int launch_simt_tt(const GemmArgs& p, int batch, cudaStream_t s) {
  auto kernel = gemm_simt_kernel<TA, TB>;
  const int err = ltt::allow_smem(kernel, simt::kSmemBytes);
  if (err) return err;
  dim3 grid((p.N + simt::kBN - 1) / simt::kBN, (p.M + simt::kBM - 1) / simt::kBM, batch);
  kernel<<<grid, simt::kThreads, simt::kSmemBytes, s>>>(p);
  return ltt::launch_status();
}

int launch_simt(const GemmArgs& p, int batch, cudaStream_t s) {
  if (p.trans_a && p.trans_b) return launch_simt_tt<true, true>(p, batch, s);
  if (p.trans_a) return launch_simt_tt<true, false>(p, batch, s);
  if (p.trans_b) return launch_simt_tt<false, true>(p, batch, s);
  return launch_simt_tt<false, false>(p, batch, s);
}

// The route a product takes, or -1 where the route asked for does not fit.
// kRouteAuto: split-K up to SPLITK_MAX_M (SPLITK_F32_MAX_M) rows where it
// fits (and split_ok: ltt_gemm only, which has a workspace), then wgmma from
// WG_MIN_M rows (16-bit; int8 at any M, ltt_gemm only, K-major operands) or
// simt (f32) where it fits, else the classic kernels. An asked-for route runs at any M it can
// take.
int pick_route(const GemmArgs& p, int in_dtype, int batch, int route, bool split_ok) {
  const int split_max = in_dtype == ltt::kF32 ? SPLITK_F32_MAX_M : SPLITK_MAX_M;
  switch (route) {
    case kRouteAuto:
      if (split_ok && splitk_fits(p, in_dtype, batch, split_max)) return kRouteSplitK;
      if (wgmma_fits(p, in_dtype, WG_MIN_M) || i8_wgmma_fits(p, in_dtype, batch, split_ok))
        return kRouteWgmma;
      return simt_fits(p, in_dtype) ? kRouteSimt : kRouteClassic;
    case kRouteClassic:
      return kRouteClassic;
    case kRouteWgmma:
      return wgmma_fits(p, in_dtype, 1) || i8_wgmma_fits(p, in_dtype, batch, split_ok)
                 ? kRouteWgmma
                 : -1;
    case kRouteSplitK:
      return split_ok && splitk_fits(p, in_dtype, batch, 16 * sk::kMaxMT) ? kRouteSplitK : -1;
    case kRouteSimt:
      return simt_fits(p, in_dtype) ? kRouteSimt : -1;
    default:
      return -1;
  }
}

// *taken gets the route that launched (pick_route's).
int launch(GemmArgs& p, int in_dtype, int batch, int route, bool split_ok, float* ws, int* taken,
           cudaStream_t s) {
  *taken = pick_route(p, in_dtype, batch, route, split_ok);
  if (*taken < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (*taken == kRouteSplitK) return launch_splitk(p, in_dtype, ws, s);
  if (*taken == kRouteWgmma)
    return in_dtype == ltt::kI8 ? launch_i8_wgmma(p, s) : launch_wgmma(p, in_dtype, batch, s);
  if (*taken == kRouteSimt) return launch_simt(p, batch, s);
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
// route: 0 picks, 1 the WMMA/FFMA/int8 kernels, 2 wgmma (16-bit, and int8
// with A not transposed and B transposed), 3 split-K, 4 simt; *taken gets
// the route that launched. workspace: ltt_gemm_workspace's bytes of fp32
// scratch (null where it says 0).
LTT_API int ltt_gemm(const void* a, const void* b, const void* c, const void* bias, void* out,
                     void* workspace, int M, int N, int K, int trans_a, int trans_b, double alpha,
                     double beta, int epilogue, int in_dtype, int out_dtype, int route,
                     int* taken, void* stream) {
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
  return launch(p, in_dtype, 1, route, true, static_cast<float*>(workspace), taken,
                static_cast<cudaStream_t>(stream));
}

// The bytes of workspace ltt_gemm needs for these operands and route (the
// split-K route's fp32 partials past one split; else 0), in *bytes; returns
// an error where the route asked for does not fit.
LTT_API int ltt_gemm_workspace(const void* a, const void* b, int M, int N, int K, int trans_a,
                               int trans_b, int in_dtype, int route, long long* bytes) {
  GemmArgs p = make_args(a, b, nullptr, M, N, K, in_dtype);
  p.trans_a = trans_a;
  p.trans_b = trans_b;
  const int r = pick_route(p, in_dtype, 1, route, true);
  *bytes = r == kRouteSplitK ? splitk_workspace(p, in_dtype) : 0;
  return r < 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// a: (B, M, K), b: (B, K, N), out: (B, M, N), contiguous; no epilogue.
LTT_API int ltt_gemm_batched(const void* a, const void* b, void* out, int B, int M, int N, int K,
                             int in_dtype, int out_dtype, int route, int* taken, void* stream) {
  GemmArgs p = make_args(a, b, out, M, N, K, out_dtype);
  p.batch_a = (long long)M * K;
  p.batch_b = (long long)K * N;
  p.batch_o = (long long)M * N;
  return launch(p, in_dtype, B, route, false, nullptr, taken, static_cast<cudaStream_t>(stream));
}
