// The persistent wgmma GEMM skeleton shared by csrc/gemm.cu
// (gemm_wgmma_kernel: row-major or transposed operands, the fused epilogue)
// and csrc/packed_gemm.cu (packed_wgmma_kernel: laser_tpu's packed blocks,
// its per-op-rounded epilogue). See gemm.cu's note on gemm_wgmma_kernel for
// the design: a producer warp's TMA loads into a WG_STAGES-deep ring of
// (128 x 64 A, 64 x 128 B) 128-byte-swizzled stages, two consumer
// warpgroups on wgmma m64n128k16 with fp32 accumulators, the epilogue staged
// through the tile's last stage, a persistent grid walking the output tiles
// (tile_coord) WG_GROUP_M tile rows at a time.
//
// The two kernels differ only in where a (tile, k step) reads its boxes and
// in what the epilogue does, so each passes a tile policy P:
//   int M, N      the output's rows and columns (the tile walk, the masks);
//   int ktiles    64-deep k steps;
//   void load(map_a, map_b, a_tile, b_tile, bar, TileCoord c, int kt) const
//                 issue one stage's TMA loads for k step kt of tile c:
//                 WG_STAGE_BYTES complete on bar (A into a_tile K-major
//                 unless TA, B into b_tile MN-major unless TB, as
//                 operand_desc reads them);
//   void store4(TileCoord c, int row, int col, float4 v) const
//                 the epilogue of outputs (row, col .. col + 3), row < M and
//                 col < N (col a multiple of 4; the policy masks past N).
#pragma once

#include "hopper.cuh"

namespace ltt {
namespace hp {

constexpr int WG_STAGES = 3;
constexpr int WG_BLOCKS_PER_SM = 2;
constexpr int WG_THREADS = WG_CONSUMERS * 128 + 32;        // + the producer warp
constexpr int WG_TILE_BYTES = WG_BM * WG_BK * 2;           // A's tile in a stage; B's the same
constexpr int WG_STAGE_BYTES = 2 * WG_TILE_BYTES;
constexpr int WG_SMEM_BYTES = WG_STAGES * WG_STAGE_BYTES + 1024;  // + 1024-byte alignment

// The body of a persistent wgmma kernel (launch it with WG_THREADS threads,
// WG_SMEM_BYTES of dynamic shared memory, at most WG_BLOCKS_PER_SM blocks an
// SM): block b takes output tiles b, b + gridDim.x, ... The ring runs on
// across tiles, so the producer loads the next tile's first stages while the
// consumers run the last one's epilogue. TA: A read MN-major; TB: B read
// K-major.
template <typename T, bool TA, bool TB, class P>
__device__ __forceinline__ void wgmma_gemm(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                           const P& pol, int ntiles) {
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  extern __shared__ uint8_t wg_smem_raw[];
  // the swizzle atoms are 1024 bytes: align the ring to them
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ktiles = pol.ktiles;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);                    // the producer's expect_tx
      mbar_init(&empty[s], WG_CONSUMERS * 4);    // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int s = 0;
  uint32_t phase = 0;
  if (warp == WG_CONSUMERS * 4) {  // the producer warp: lane 0 issues every load
    if (lane == 0) {
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const TileCoord c = tile_coord(t, pol.M, pol.N);
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);  // the first pass over the ring never waits
          uint8_t* a_tile = ring + s * WG_STAGE_BYTES;
          mbar_expect_tx(&full[s], WG_STAGE_BYTES);
          pol.load(map_a, map_b, a_tile, a_tile + WG_TILE_BYTES, &full[s], c, kt);
          if (++s == WG_STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64) of a tile;
  // its A rows are 8 KB into the tile in either layout
  const int wg = warp >> 2;
  float acc[64];
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const TileCoord c = tile_coord(t, pol.M, pol.N);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full[s], phase);
      const uint32_t a_tile = smem_u32(ring + s * WG_STAGE_BYTES) + wg * WG_HALF_BYTES;
      const uint32_t b_tile = smem_u32(ring + s * WG_STAGE_BYTES + WG_TILE_BYTES);
      acc_fence(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma_m64n128k16<T, TA, TB>(acc, operand_desc<!TA>(a_tile, kk),
                                    operand_desc<TB>(b_tile, kk));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // the previous stage's products are done once at most this group runs
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      acc_fence(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == WG_STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    acc_fence(acc);

    // The epilogue, through the tile's last stage (32 KB, still held from
    // the producer): each half of the tile's columns goes from the
    // accumulators into it as fp32, then every consumer thread runs the
    // policy's epilogue on 4 neighbouring outputs at a time.
    // The accumulator layout (m64nNk16): acc[4 j + 2 h + e] is row 16 w +
    // lane / 4 + 8 h of the warpgroup's 64, column 8 j + 2 (lane % 4) + e.
    float* stage = reinterpret_cast<float*>(ring + prev * WG_STAGE_BYTES);
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
        if (row < pol.M && col < pol.N)
          pol.store4(c, row, col, *reinterpret_cast<const float4*>(stage + staged(r, cl)));
      }
    }
    consumers_sync();  // every read of the stage is done: hand it back to the producer
    fence_proxy_async();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }
}

}  // namespace hp
}  // namespace ltt
