// Weight-only int4 GEMM: out (M, N) = h (M, K) @ dequant(q4, s4), in h's
// dtype with fp32 accumulation.
//
// Replaces laser_tpu/ops/gemm/int4_kernel.py:87 build_w4_gemm.
//
// Layout (int4_kernel.py:37-73), unchanged: q4 (K/2, N) int8, one byte holds
// rows 2i (low nibble) and 2i+1 (high nibble) of column n, symmetric values
// in [-7, 7]; s4 (K/group, N) f32, one scale per (row group, column); the
// group is even and divides K, so a byte never straddles two groups. A
// weight is dequantized as the TPU kernel does it (int4_kernel.py:106-109):
// the nibble sign-extends, multiplies its group's f32 scale, and rounds to
// the activation dtype BEFORE the product.
//
// What bounds it on the H100: at decode (M = 1..40) every weight byte is
// read once for a few rows, so the packed weight streams from HBM: K/2 x N
// bytes plus the scales, a quarter of the bf16 weight's bytes. At prefill (M
// up to 4096) it is the tensor-core product (989 TFLOP/s bf16). The bf16
// weight never exists in HBM: each kernel dequantizes a tile at a time on
// the chip. Three routes, the launcher picking one from the shape and
// alignment (or asked for one, enum W4Route) and reporting it:
// - stream (bf16/f16, M <= W4_STREAM_MAX_M): the split-K skeleton of
//   csrc/splitk.cuh with the packed bytes and their scales as the streamed
//   operand (PackedInt4Weights): a 4-stage cp.async ring of 128-deep packed
//   tiles and their scale rows; each lane builds its mma.sync B fragment
//   from two packed bytes straight from the staged tile (column t/4, rows
//   2(t%4), 2(t%4)+1 and 8 below are one byte each), each byte with the
//   scale of its own group, so any even group is right;
// - mma (bf16/f16, more rows): w4_gemm_wgmma_kernel below, the wgmma
//   kernel of csrc/gemm.cu with a dequantizing warpgroup in B's place;
// - classic: w4_gemm_tc_kernel (WMMA on a 64x64 tile, the first port; the
//   launcher sends it what the others cannot take: N % 16 != 0, unaligned
//   bases) and, for f32 activations, w4_gemm_f32_kernel (full-fp32 FFMA on
//   the f32 dequantized weight, JAX's HIGHEST product).
// Out of range rows and columns load as 0 on both operands and are never
// stored.
#include <mma.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "splitk.cuh"

namespace {

using namespace nvcuda;
using namespace ltt::hp;
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


// ---------------------------------------------------------------------------
// The stream route: csrc/splitk.cuh with the packed weight
// ---------------------------------------------------------------------------

// Two outputs rounded to T.
template <typename T>
struct CastEpi {
  T* out;
  int N;
  __device__ __forceinline__ void store2(int row, int col, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) = pack2<T>(v0, v1);
  }
};

template <typename T>
int launch_stream(const W4Args& p, float* ws, cudaStream_t s) {
  const auto w = ltt::sk::int4_weights<T>(p.q4, p.s4, p.N, p.group);
  if (ltt::sk::workspace_bytes(w, p.M, p.N, p.K) > 0 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return ltt::sk::launch(static_cast<const T*>(p.h), p.M, p.N, p.K, p.vec_h, w, ws,
                         CastEpi<T>{static_cast<T*>(p.out), p.N}, s);
}

// ---------------------------------------------------------------------------
// The mma route: wgmma on a dequantized B tile
// ---------------------------------------------------------------------------
// What bounds it: 2 M N K operations at the bf16 tensor-core rate (M4096
// K4096 N14336: 481 GFLOP, 0.486 ms at 989 TFLOP/s). The design is the
// 16-bit wgmma kernel's (csrc/gemm.cu: a 128 x 128 output tile, two
// consumer warpgroups on wgmma m64n128k16, a persistent grid walking the
// tiles 8 tile rows at a time, the epilogue staged through the tile's last
// ring stage) with B made on the chip:
// - one producer warp issues, for each 64-deep k step, three TMA boxes into
//   a ring stage: h's 128 x 64 tile (128-byte swizzle, as A in csrc/gemm.cu),
//   the 32 x 128 packed bytes and the scale rows the step's k range covers
//   (srows x 128 f32), and arms the stage's `full` barrier with their bytes;
// - two dequantizing warpgroups wait on `full`, turn each packed byte into
//   its two weights (hp::nibbles8: the nibble built in a float's bits, times
//   the scale, rounded to T), write them as 16-byte chunks into the stage's
//   B tile in the MN-major 128-byte-swizzled layout that TMA writes for an
//   untransposed B (mn_major_chunk), fence the writes for the async proxy
//   and arrive on the stage's `bfull` barrier. A weight costs ~6
//   instructions, 1.4 of them on the half-rate integer pipe; one warpgroup
//   took longer a stage than the tensor cores (PERF.md §6);
// - the consumers wait on both, run wgmma on h's tile and the B tile, and
//   free the stage (`empty`) once its products are done.
// One block an SM (544 threads, up to 6 stages of 38 KB at group 64): a
// stage carries h, B, the packed bytes and the scales. TMA zero-fills past
// M, K, N and the last scale row, so ragged tiles need no masks.
constexpr int W4M_STAGES_MAX = 6;
constexpr int W4M_DEQ_THREADS = 256;
constexpr int W4M_THREADS = WG_CONSUMERS * 128 + W4M_DEQ_THREADS + 32;
constexpr int W4M_A_BYTES = WG_BM * WG_BK * 2;
constexpr int W4M_B_BYTES = WG_BK * WG_BN * 2;
constexpr int W4M_Q_BYTES = WG_BK / 2 * WG_BN;

struct W4MmaArgs {
  W4Args p;
  int srows;        // scale rows a stage: those k rows [k0, k0 + 64) cover, at most
  int stage_bytes;  // A | B | Q | scales, rounded up to 1024 (the swizzle atoms)
  int stages;
  int ntiles;
};

template <typename T>
__global__ void __launch_bounds__(W4M_THREADS, 1)
    w4_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_h,
                         const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_s, const W4MmaArgs w) {
  __shared__ __align__(8) uint64_t full[W4M_STAGES_MAX], bfull[W4M_STAGES_MAX],
      empty[W4M_STAGES_MAX];
  extern __shared__ uint8_t w4_smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(w4_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const W4Args& p = w.p;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ktiles = (p.K + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < w.stages; ++s) {
      mbar_init(&full[s], 1);                       // the producer's expect_tx
      mbar_init(&bfull[s], W4M_DEQ_THREADS / 32);   // lane 0 of every dequantizing warp
      mbar_init(&empty[s], WG_CONSUMERS * 4);       // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int s = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++s == w.stages) {
      s = 0;
      phase ^= 1;
    }
  };
  constexpr int DEQ_WARP0 = WG_CONSUMERS * 4;
  if (warp == DEQ_WARP0 + W4M_DEQ_THREADS / 32) {  // the producer warp: lane 0 issues every load
    if (lane == 0) {
      const uint32_t tx = W4M_A_BYTES + W4M_Q_BYTES + w.srows * WG_BN * 4;
      for (int t = blockIdx.x; t < w.ntiles; t += gridDim.x) {
        const TileCoord c = tile_coord(t, p.M, p.N);
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);  // the first pass over the ring never waits
          uint8_t* st = ring + s * w.stage_bytes;
          mbar_expect_tx(&full[s], tx);
          const int k0 = kt * WG_BK;
          tma_load_3d(st, &map_h, &full[s], k0, c.m0, 0);
          tma_load_3d(st + W4M_A_BYTES + W4M_B_BYTES, &map_q, &full[s], c.n0, k0 / 2, 0);
          tma_load_3d(st + W4M_A_BYTES + W4M_B_BYTES + W4M_Q_BYTES, &map_s, &full[s], c.n0,
                      k0 / p.group, 0);
          advance();
        }
      }
    }
    return;
  }

  if (warp >= DEQ_WARP0) {
    // the dequantizing warpgroups: thread d takes 8-column group d % 16 of
    // packed rows d / 16 + 16 i (i < 2); each packed row gives k rows 2 pr
    // (low nibbles) and 2 pr + 1 (high), one 16-byte chunk each
    constexpr int ROWS = W4M_DEQ_THREADS / 16;
    const int d = threadIdx.x - DEQ_WARP0 * 32;
    const int cg = d & 15, half = cg >> 3, chunk = cg & 7;
    for (int t = blockIdx.x; t < w.ntiles; t += gridDim.x) {
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[s], phase);
        uint8_t* st = ring + s * w.stage_bytes;
        uint8_t* B = st + W4M_A_BYTES;
        const uint8_t* Q = B + W4M_B_BYTES;
        const float* S = reinterpret_cast<const float*>(Q + W4M_Q_BYTES);
        const int k0 = kt * WG_BK, g0 = k0 / p.group;
#pragma unroll
        for (int i = 0; i < WG_BK / 2 / ROWS; ++i) {
          const int pr = (d >> 4) + ROWS * i;
          const uint2 qv = *reinterpret_cast<const uint2*>(Q + pr * WG_BN + cg * 8);
          const float* srow = S + ((k0 + 2 * pr) / p.group - g0) * WG_BN + cg * 8;
          const float4 sa = *reinterpret_cast<const float4*>(srow);
          const float4 sb = *reinterpret_cast<const float4*>(srow + 4);
          const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
          // the weight times its f32 scale, rounded to T (the plain version's order)
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // bytes 4h .. 4h + 3
            float l[4], u[4];
            nibbles8(h ? qv.y : qv.x, l, u);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int b = 4 * h + 2 * e;
              lo[2 * h + e] = pack2<T>(l[2 * e] * sc[b], l[2 * e + 1] * sc[b + 1]);
              hi[2 * h + e] = pack2<T>(u[2 * e] * sc[b], u[2 * e + 1] * sc[b + 1]);
            }
          }
          *reinterpret_cast<uint4*>(B + mn_major_chunk(half, 2 * pr, chunk)) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
          *reinterpret_cast<uint4*>(B + mn_major_chunk(half, 2 * pr + 1, chunk)) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
        fence_proxy_async();  // the B tile's writes, before wgmma reads them
        __syncwarp();
        if (lane == 0) mbar_arrive(&bfull[s]);
        advance();
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64) of a tile
  const int wg = warp >> 2;
  T* out = static_cast<T*>(p.out);
  float acc[64];
  for (int t = blockIdx.x; t < w.ntiles; t += gridDim.x) {
    const TileCoord c = tile_coord(t, p.M, p.N);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full[s], phase);
      mbar_wait(&bfull[s], phase);
      const uint32_t a_tile = smem_u32(ring + s * w.stage_bytes) + wg * WG_HALF_BYTES;
      const uint32_t b_tile = smem_u32(ring + s * w.stage_bytes + W4M_A_BYTES);
      acc_fence(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma_m64n128k16<T, false, false>(acc, operand_desc<true>(a_tile, kk),
                                          operand_desc<false>(b_tile, kk));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // the previous stage's products are done once at most this group runs
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      acc_fence(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      advance();
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    acc_fence(acc);

    // The epilogue through the tile's last stage (its h and B tiles, 32 KB):
    // each half of the columns as fp32 (acc[4 j + 2 h + e] is row 16 w +
    // lane / 4 + 8 h of the warpgroup's 64, column 8 j + 2 (lane % 4) + e),
    // then 4 neighbouring outputs a thread, rounded to T, one 8-byte store.
    float* stage = reinterpret_cast<float*>(ring + prev * w.stage_bytes);
    const int lrow = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      consumers_sync();  // the stage's products (or the last half's reads) are done
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 8 * half + jj;
          *reinterpret_cast<float2*>(stage + staged(lrow + 8 * h, 8 * jj + 2 * (lane & 3))) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      consumers_sync();
      for (int idx = threadIdx.x; idx < WG_BM * 16; idx += WG_CONSUMERS * 128) {
        const int r = idx >> 4, cl = (idx & 15) * 4;
        const int row = c.m0 + r, col = c.n0 + 64 * half + cl;
        if (row < p.M && col < p.N) {  // N % 16 == 0: all four are in
          const float4 v = *reinterpret_cast<const float4*>(stage + staged(r, cl));
          *reinterpret_cast<uint2*>(out + (size_t)row * p.N + col) =
              make_uint2(pack2<T>(v.x, v.y), pack2<T>(v.z, v.w));
        }
      }
    }
    consumers_sync();  // every read of the stage is done: hand it back to the producer
    fence_proxy_async();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }
}

// scale rows the k rows [k0, k0 + 64) of a stage cover, at most (k0 a
// multiple of 64)
int mma_scale_rows(int group) {
  if (WG_BK % group == 0) return WG_BK / group;
  if (group % WG_BK == 0) return 1;
  return (WG_BK - 1) / group + 2;
}

template <typename T>
int launch_mma(const W4Args& p, cudaStream_t s) {
  const int dt = std::is_same<T, __half>::value ? ltt::kF16 : ltt::kBF16;
  W4MmaArgs w;
  w.p = p;
  w.srows = mma_scale_rows(p.group);
  w.stage_bytes = (W4M_A_BYTES + W4M_B_BYTES + W4M_Q_BYTES + w.srows * WG_BN * 4 + 1023) / 1024 * 1024;
  const int room = ltt::sk::kMaxSmem - 1024 - 3 * W4M_STAGES_MAX * 8;
  w.stages = std::min(W4M_STAGES_MAX, room / w.stage_bytes);
  if (w.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mh, mq, ms;
  const bool ok =
      encode_map(&mh, p.h, dt, p.K, p.M, 1, WG_BK, WG_BM) &&
      encode_tiled(&mq, p.q4, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.N, p.K / 2, 1, WG_BN,
                   WG_BK / 2, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      encode_tiled(&ms, p.s4, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.N, p.K / p.group, 1, WG_BN,
                   w.srows, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = w4_gemm_wgmma_kernel<T>;
  const int smem = w.stages * w.stage_bytes + 1024;
  const int err = ltt::allow_smem(kernel, smem);
  if (err) return err;
  const long long tiles = (long long)((p.M + WG_BM - 1) / WG_BM) * ((p.N + WG_BN - 1) / WG_BN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  w.ntiles = static_cast<int>(tiles);
  const int blocks = std::min(w.ntiles, sm_count());
  kernel<<<blocks, W4M_THREADS, smem, s>>>(mh, mq, ms, w);
  return ltt::launch_status();
}

// ---------------------------------------------------------------------------
// Routes
// ---------------------------------------------------------------------------
// The most rows the launcher sends to the stream route by itself, from
// chip_smoke.py phase 2's crossover on Llama-3-8B's w_gate (K 4096, N 14336,
// group 64; 20 calls in a CUDA graph; NVIDIA H100 80GB HBM3, 700 W; PERF.md
// §6): stream ahead of mma to M 16 (0.0380 against 0.0546 ms), behind
// from M 32 (0.0645 against 0.0547).
constexpr int W4_STREAM_MAX_M = 16;

enum W4Route { kW4Auto = 0, kW4Classic = 1, kW4Stream = 2, kW4Mma = 3 };

// Both fast routes: 16-bit activations, N % 16 == 0 (16-byte rows of q4),
// 16-byte-aligned h, q4 and s4; the mma route also K % 8 == 0 (h's rows by
// TMA), the stream route M <= 64.
bool w4_fast_fits(const W4Args& p, int dtype) {
  return (dtype == ltt::kBF16 || dtype == ltt::kF16) && p.M >= 1 && p.N % 16 == 0 &&
         aligned16(p.h) && aligned16(p.q4) && aligned16(p.s4);
}

bool stream_fits(const W4Args& p, int dtype, int max_m) {
  return w4_fast_fits(p, dtype) && p.M <= max_m && p.M <= 16 * ltt::sk::kMaxMT;
}

bool mma_fits(const W4Args& p, int dtype) { return w4_fast_fits(p, dtype) && p.K % 8 == 0; }

int pick_w4_route(const W4Args& p, int dtype, int route) {
  switch (route) {
    case kW4Auto:
      if (stream_fits(p, dtype, W4_STREAM_MAX_M)) return kW4Stream;
      return mma_fits(p, dtype) ? kW4Mma : kW4Classic;
    case kW4Classic:
      return kW4Classic;
    case kW4Stream:
      return stream_fits(p, dtype, 16 * ltt::sk::kMaxMT) ? kW4Stream : -1;
    case kW4Mma:
      return mma_fits(p, dtype) ? kW4Mma : -1;
    default:
      return -1;
  }
}

W4Args make_w4_args(const void* h, const void* q4, const void* s4, void* out, int M, int N, int K,
                    int group) {
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
  return p;
}

long long stream_workspace(const W4Args& p, int dtype) {
  if (dtype == ltt::kBF16)
    return ltt::sk::workspace_bytes(ltt::sk::int4_weights<__nv_bfloat16>(p.q4, p.s4, p.N, p.group),
                                    p.M, p.N, p.K);
  return ltt::sk::workspace_bytes(ltt::sk::int4_weights<__half>(p.q4, p.s4, p.N, p.group), p.M,
                                  p.N, p.K);
}

}  // namespace

// h (M, K) in dtype; q4 (K/2, N) int8; s4 (K/group, N) f32; out (M, N) in
// dtype. All contiguous row-major; group even, K a multiple of group.
// route: 0 picks, 1 classic (WMMA / f32 FFMA), 2 stream, 3 mma; *taken gets
// the route that launched. workspace: ltt_w4_gemm_workspace's bytes of fp32
// scratch (null where it says 0).
LTT_API int ltt_w4_gemm(const void* h, const void* q4, const void* s4, void* out, void* workspace,
                        int M, int N, int K, int group, int dtype, int route, int* taken,
                        void* stream) {
  const W4Args p = make_w4_args(h, q4, s4, out, M, N, K, group);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *taken = pick_w4_route(p, dtype, route);
  if (*taken < 0) return static_cast<int>(cudaErrorInvalidValue);
  float* ws = static_cast<float*>(workspace);
  if (*taken == kW4Stream)
    return dtype == ltt::kBF16 ? launch_stream<__nv_bfloat16>(p, ws, s)
                               : launch_stream<__half>(p, ws, s);
  if (*taken == kW4Mma)
    return dtype == ltt::kBF16 ? launch_mma<__nv_bfloat16>(p, s) : launch_mma<__half>(p, s);
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

// The bytes of workspace ltt_w4_gemm needs (the stream route's fp32
// partials past one split; else 0), in *bytes; an error where the route
// asked for does not fit.
LTT_API int ltt_w4_gemm_workspace(const void* h, const void* q4, const void* s4, int M, int N,
                                  int K, int group, int dtype, int route, long long* bytes) {
  const W4Args p = make_w4_args(h, q4, s4, nullptr, M, N, K, group);
  const int r = pick_w4_route(p, dtype, route);
  *bytes = r == kW4Stream ? stream_workspace(p, dtype) : 0;
  return r < 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}
