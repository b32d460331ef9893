// The persistent wgmma GEMM skeleton shared by csrc/gemm.cu
// (gemm_wgmma_kernel: row-major or transposed 16-bit operands, the fused
// epilogue; gemm_i8_wgmma_kernel: int8, the int32 epilogue),
// csrc/packed_gemm.cu (packed_wgmma_kernel: laser_tpu's packed blocks, its
// per-op-rounded epilogue) and csrc/limb_gemm.cu (limb_wgmma_kernel: the
// digit-plane products, a bucket a segment). See gemm.cu's note on
// gemm_wgmma_kernel for the design: a producer warp's TMA loads into a
// WG_STAGES-deep ring of 128-byte-swizzled stages (a 128-row A tile and a
// 128-column B tile, 128 bytes of K each: k 64 of a 16-bit type, k 128 of
// int8), two consumer warpgroups on wgmma (m64n128k16 with fp32
// accumulators, or m64n128k32 s8 with int32 ones), the epilogue staged
// through the tile's last stage, a persistent grid walking the output tiles
// (tile_coord) WG_GROUP_M tile rows at a time.
//
// The kernels differ only in where a (tile, k step) reads its boxes and in
// what the epilogue does, so each passes a tile policy P:
//   int M, N      the output's rows and columns (the tile walk, the masks);
//   int steps() const           the k steps of a tile;
//   int segments() const        the runs those steps fall into, in order:
//                               after each the accumulator goes to finish;
//   int seg_steps(int seg) const  the steps of segment seg;
//   void load(map_a, map_b, a_tile, b_tile, bar, TileCoord c, int step) const
//                 issue one stage's TMA loads for k step `step` (counted
//                 from the tile's first) of tile c: WG_STAGE_BYTES
//                 complete on bar (A into a_tile K-major unless TA, B into
//                 b_tile MN-major unless TB, as operand_desc reads them);
//   bool finish(int seg, Acc (&acc)[64]) const
//                 called when segment seg's products are in acc (every
//                 thread, its own accumulators): true runs the epilogue on
//                 acc and starts the next segment from zero; false keeps
//                 acc, as the policy left it, for the next segment;
//   void store4(TileCoord c, int seg, int row, int col, V v) const
//                 the epilogue of outputs (row, col .. col + 3) of segment
//                 seg, row < M and col < N (col a multiple of 4; the policy
//                 masks past N); V is float4 (16-bit types) or int4 (int8).
// Every segment has at least one step, and a tile's last segment's finish
// returns true. A single-product policy has one segment of steps() steps
// whose finish returns true (OneSegment below).
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

// The accumulator of T's products and the four staged outputs the epilogue
// hands the policy.
template <typename T>
using wg_acc_t = std::conditional_t<std::is_same<T, int8_t>::value, int, float>;
template <typename T>
using wg_vec2_t = std::conditional_t<std::is_same<T, int8_t>::value, int2, float2>;
template <typename T>
using wg_vec4_t = std::conditional_t<std::is_same<T, int8_t>::value, int4, float4>;

// The members of a policy with one segment: `ktiles` steps, then the epilogue.
struct OneSegment {
  int ktiles;
  __device__ __forceinline__ int steps() const { return ktiles; }
  __device__ __forceinline__ int segments() const { return 1; }
  __device__ __forceinline__ int seg_steps(int) const { return ktiles; }
  template <typename Acc>
  __device__ __forceinline__ bool finish(int, Acc (&)[64]) const {
    return true;
  }
};

// The body of a persistent wgmma kernel (launch it with WG_THREADS threads,
// WG_SMEM_BYTES of dynamic shared memory, at most WG_BLOCKS_PER_SM blocks an
// SM): block b takes output tiles b, b + gridDim.x, ... The ring runs on
// across tiles, so the producer loads the next tile's first stages while the
// consumers run the last one's epilogue. TA: A read MN-major; TB: B read
// K-major. T int8: both operands K-major (TA false, TB true), int32
// accumulators that wrap.
template <typename T, bool TA, bool TB, class P>
__device__ __forceinline__ void wgmma_gemm(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                           const P& pol, int ntiles) {
  using Acc = wg_acc_t<T>;
  using Vec4 = wg_vec4_t<T>;
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  extern __shared__ uint8_t wg_smem_raw[];
  // the swizzle atoms are 1024 bytes: align the ring to them
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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
      const int steps = pol.steps();
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const TileCoord c = tile_coord(t, pol.M, pol.N);
        for (int step = 0; step < steps; ++step) {
          mbar_wait(&empty[s], phase ^ 1);  // the first pass over the ring never waits
          uint8_t* a_tile = ring + s * WG_STAGE_BYTES;
          mbar_expect_tx(&full[s], WG_STAGE_BYTES);
          pol.load(map_a, map_b, a_tile, a_tile + WG_TILE_BYTES, &full[s], c, step);
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
  Acc acc[64];
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const TileCoord c = tile_coord(t, pol.M, pol.N);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = Acc(0);
    const int nseg = pol.segments();
    for (int seg = 0; seg < nseg; ++seg) {
      const int nsteps = pol.seg_steps(seg);
      int prev = -1;
      for (int j = 0; j < nsteps; ++j) {
        mbar_wait(&full[s], phase);
        const uint32_t a_tile = smem_u32(ring + s * WG_STAGE_BYTES) + wg * WG_HALF_BYTES;
        const uint32_t b_tile = smem_u32(ring + s * WG_STAGE_BYTES + WG_TILE_BYTES);
        acc_fence(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // four 32-byte k steps of the 128-byte rows
          wgmma_k32b<T, TA, TB>(acc, operand_desc<!TA>(a_tile, kk), operand_desc<TB>(b_tile, kk));
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
      if (!pol.finish(seg, acc)) {  // acc carries on into the next segment
        if (lane == 0) mbar_arrive(&empty[prev]);
        continue;
      }

      // The epilogue, through the segment's last stage (32 KB, still held
      // from the producer): each half of the tile's columns goes from the
      // accumulators into it as fp32 (int32), then every consumer thread
      // runs the policy's epilogue on 4 neighbouring outputs at a time.
      // The accumulator layout (m64nNk16, and m64nNk32 s32 alike):
      // acc[4 j + 2 h + e] is row 16 w + lane / 4 + 8 h of the warpgroup's
      // 64, column 8 j + 2 (lane % 4) + e.
      Acc* stage = reinterpret_cast<Acc*>(ring + prev * WG_STAGE_BYTES);
      const int lrow = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        consumers_sync();  // the stage's products (or the last half's reads) are done
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 8 * half + jj;
            Acc* dst = stage + staged(lrow + 8 * h, 8 * jj + 2 * (lane & 3));
            *reinterpret_cast<wg_vec2_t<T>*>(dst) = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
          }
        }
        consumers_sync();
        for (int idx = threadIdx.x; idx < WG_BM * 16; idx += WG_CONSUMERS * 128) {
          const int r = idx >> 4, cl = (idx & 15) * 4;
          const int row = c.m0 + r, col = c.n0 + 64 * half + cl;
          if (row < pol.M && col < pol.N)
            pol.store4(c, seg, row, col, *reinterpret_cast<const Vec4*>(stage + staged(r, cl)));
        }
      }
      consumers_sync();  // every read of the stage is done: hand it back to the producer
      fence_proxy_async();
      if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = Acc(0);
    }
  }
}

}  // namespace hp
}  // namespace ltt
