// The f32 FFMA GEMM skeleton shared by csrc/gemm.cu (gemm_simt_kernel:
// row-major or transposed operands, the fused epilogue, a batch index) and
// csrc/packed_gemm.cu (packed_simt_kernel: laser_tpu's packed blocks, its
// per-op-rounded epilogue). "simt" as CUTLASS names its GEMMs off the
// tensor cores.
//
// Replaces laser_tpu/ops/gemm/kernel.py:62 build_gemm at f32 "highest"
// precision and laser_tpu/ops/gemm/prepacked.py:80 _build_packed_gemm at
// f32: full-fp32 products, never TF32 (config.matmul_precision).
//
// What bounds it on the H100: FFMA, 67 TFLOP/s (132 SMs x 128 fp32 lanes x
// 2 operations at 1.98 GHz). At the shapes the paths give it (M4096 K2048
// N2048, the packed 4096^3) the operations over the bytes are far above the
// ridge, so the limit is how many of an SM's instruction slots go to FFMA. The
// design spends as few as it can on anything else:
// - a 128 x 128 output tile a block of 256 threads, 8 warps as 2 (M) x 4
//   (N) of 64 x 32; each thread owns 8 x 8 outputs as four 4 x 4 quarters
//   (rows r*4 and 32 + r*4, columns c*4 and 16 + c*4 of its warp's tile,
//   lane = 4 r + c), so a k step reads its 8 A and 8 B values as four
//   16-byte shared loads for 64 FFMAs (the classic kernels: 8 + 2 and
//   4 + 4 loads for 64 and 16);
// - both operands staged k-major in shared memory, [16][128] floats each:
//   a warp's fragment loads read one k row (A: 8 distinct 16-byte words,
//   B: 4), the cp.async copies and the transposing stores below write one
//   row with consecutive lanes on consecutive words, so no access conflicts
//   and the rows need no padding;
// - a 3-stage ring of 16-deep slabs (48 KB a block, two blocks an SM).
//   Operands already k-major in device memory (A transposed, B not, packed
//   B) go by 16-byte cp.async two slabs ahead; k-minor ones (A, B
//   transposed, packed A) are loaded as two 16-byte vectors a thread into
//   registers two slabs ahead and stored transposed one slab ahead (each
//   thread one row's 8 consecutive k: a 32-byte sector), so each slab's
//   loads have a whole slab of FFMAs to land behind;
// - the k step's fragments double-buffered in registers: step k + 1's four
//   loads go out before step k's 64 FFMAs;
// - __launch_bounds__(256, 2): 128 registers a thread at most. ptxas
//   (sm_90a, CUDA 12.8): gemm_simt_kernel 128 / 127 / 127 / 128 registers
//   (A, B as stored: both plain / B transposed / A transposed / both),
//   packed_simt_kernel 128, no spill.
// Measured (chip_smoke.py phases 2 and 16, NVIDIA H100 80GB HBM3, 700 W,
// the SM clock at 1980 MHz throughout; 20 calls in a row): 0.61 of the
// FFMA bound at M4096 K2048 N2048 and 0.63 at the packed 4096^3 (cuBLAS
// 0.72 there, and 0.74 here one call), the classic kernels 0.42 and 0.47.
// scripts/time_simt_variants.py times this body against variants of its
// constants (slab depth, stages, registers) on the card; none moved it by
// more than 5% (PERF.md §6): what holds it is the instruction stream (a
// slab's 1024 FFMAs beside 64 shared loads and ~120 other instructions),
// not a stage or a tile size.
//
// A tile policy P gives each kernel's addressing and epilogue:
//   static constexpr bool kAKMajor, kBKMajor
//                 the operand is k-major in device memory (cp.async) or
//                 k-minor (registers, stored transposed);
//   int M, N      the output's rows and columns (the epilogue's masks);
//   int ktiles    16-deep slabs;
//   const float* a(int kt, int x, int y, bool& ok) const
//   const float* b(int kt, int x, int y, bool& ok) const
//                 the address of 4 consecutive floats of slab kt: for a
//                 k-major operand at slab row x (0..15), tile column y
//                 (0..124, a multiple of 4); for a k-minor one at tile row
//                 x (0..127), slab column y (0, 4, 8, 12); ok false where
//                 they lie past the matrix (read as 0; the address must
//                 still be mapped);
//   void store4(int row, int col, float4 v) const
//                 the epilogue of outputs (row, col .. col + 3), row < M
//                 and col < N (col a multiple of 4; the policy masks past
//                 N).
#pragma once

#include "hopper.cuh"

namespace ltt {
namespace simt {

constexpr int kBM = 128, kBN = 128, kBK = 16, kThreads = 256, kStages = 3;
constexpr int kBlocksPerSm = 2;
constexpr int kTileFloats = kBK * kBM;  // one operand's slab: [16][128]
constexpr int kStageFloats = 2 * kTileFloats;
constexpr int kSmemBytes = kStages * kStageFloats * 4;
static_assert(kBM == kBN, "one slab layout for both operands");

// Slab kt of a k-major operand into tile t by cp.async: 16 rows of 128
// floats, 32 lanes a row.
template <bool IS_A, class P>
__device__ __forceinline__ void copy_kmajor(const P& p, float* t, int kt) {
#pragma unroll
  for (int it = 0; it < kTileFloats / 4 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int x = i >> 5, y = (i & 31) * 4;
    bool ok;
    const float* src = IS_A ? p.a(kt, x, y, ok) : p.b(kt, x, y, ok);
    hp::cp_async16(hp::smem_u32(t + x * kBM + y), src, ok);
  }
}

// Slab kt of a k-minor operand into registers: thread t takes tile row
// t % 128 and the slab's k half t / 128, kVecs 16-byte vectors.
constexpr int kVecs = kBK * kBM / kThreads / 4;
static_assert(kThreads == 2 * kBM && kVecs >= 1, "two threads a tile row");

template <bool IS_A, class P>
__device__ __forceinline__ void load_kminor(const P& p, float4 (&r)[kVecs], int kt) {
  const int x = threadIdx.x & (kBM - 1), y = (threadIdx.x >> 7) * (kBK / 2);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    bool ok;
    const float* src = IS_A ? p.a(kt, x, y + 4 * j, ok) : p.b(kt, x, y + 4 * j, ok);
    r[j] = ok ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ... and stored transposed into tile t ([k][row]): a warp writes 32
// consecutive floats of one k row at a time.
__device__ __forceinline__ void store_kminor(float* t, const float4 (&r)[kVecs]) {
  const int x = threadIdx.x & (kBM - 1), y = (threadIdx.x >> 7) * (kBK / 2);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    float* d = t + (y + 4 * j) * kBM + x;
    d[0] = r[j].x;
    d[kBM] = r[j].y;
    d[2 * kBM] = r[j].z;
    d[3 * kBM] = r[j].w;
  }
}

// The body of a simt kernel (kThreads threads, kSmemBytes of dynamic shared
// memory at smem): the output tile at (m0, n0).
template <class P>
__device__ __forceinline__ void gemm_tile(const P& p, int m0, int n0, float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int am = (warp >> 2) * 64 + (lane >> 2) * 4;  // the thread's first A row in the tile
  const int bn = (warp & 3) * 32 + (lane & 3) * 4;    // and first B column
  const int ktiles = p.ktiles;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra[kVecs], rb[kVecs];  // the k-minor operands' next slab
  auto stage = [&](int kt) { return smem + (kt % kStages) * kStageFloats; };
  auto copy = [&](int kt) {
    if constexpr (P::kAKMajor) copy_kmajor<true>(p, stage(kt), kt);
    if constexpr (P::kBKMajor) copy_kmajor<false>(p, stage(kt) + kTileFloats, kt);
  };
  auto load = [&](int kt) {
    if constexpr (!P::kAKMajor) load_kminor<true>(p, ra, kt);
    if constexpr (!P::kBKMajor) load_kminor<false>(p, rb, kt);
  };
  auto store = [&](int kt) {
    if constexpr (!P::kAKMajor) store_kminor(stage(kt), ra);
    if constexpr (!P::kBKMajor) store_kminor(stage(kt) + kTileFloats, rb);
  };

  // copies of slabs 0 .. kStages - 2 in flight, one group each; slab 0's
  // registers stored, slab 1's loaded
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) copy(s);
    hp::cp_async_commit();
  }
  if (ktiles > 0) {
    load(0);
    store(0);
  }
  if (ktiles > 1) load(1);

  for (int kt = 0; kt < ktiles; ++kt) {
    // slab kt's copies have landed (this thread's), and after the barrier
    // everyone's copies and stores of slab kt are visible, and the stage
    // of slab kt - 1 (= kt + kStages - 1) is free: every thread has done
    // its FFMAs
    hp::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + 1 < ktiles) store(kt + 1);  // the stage of slab kt - 2
    if (kt + 2 < ktiles) load(kt + 2);
    if (kt + kStages - 1 < ktiles) copy(kt + kStages - 1);
    hp::cp_async_commit();

    const float* as = stage(kt) + am;
    const float* bs = stage(kt) + kTileFloats + bn;
    float4 fa[2][2], fb[2][2];  // [step parity][quarter]
    fa[0][0] = *reinterpret_cast<const float4*>(as);
    fa[0][1] = *reinterpret_cast<const float4*>(as + 32);
    fb[0][0] = *reinterpret_cast<const float4*>(bs);
    fb[0][1] = *reinterpret_cast<const float4*>(bs + 16);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const int cur = k & 1, nxt = cur ^ 1;
      if (k + 1 < kBK) {
        fa[nxt][0] = *reinterpret_cast<const float4*>(as + (k + 1) * kBM);
        fa[nxt][1] = *reinterpret_cast<const float4*>(as + (k + 1) * kBM + 32);
        fb[nxt][0] = *reinterpret_cast<const float4*>(bs + (k + 1) * kBM);
        fb[nxt][1] = *reinterpret_cast<const float4*>(bs + (k + 1) * kBM + 16);
      }
      const float a[8] = {fa[cur][0].x, fa[cur][0].y, fa[cur][0].z, fa[cur][0].w,
                          fa[cur][1].x, fa[cur][1].y, fa[cur][1].z, fa[cur][1].w};
      const float b[8] = {fb[cur][0].x, fb[cur][0].y, fb[cur][0].z, fb[cur][0].w,
                          fb[cur][1].x, fb[cur][1].y, fb[cur][1].z, fb[cur][1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  hp::cp_async_wait<0>();  // no copy outlives the block (none is pending: kt ran past them)

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + am + (i < 4 ? i : 32 + i - 4);
    if (row >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + bn + 16 * h;
      if (col < p.N)
        p.store4(row, col, make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                       acc[i][4 * h + 3]));
    }
  }
}

}  // namespace simt
}  // namespace ltt
