// Flash attention backward over (BH, S, D): dQ, dK and dV from the forward's
// saved per-row statistics (m, l), never materialising the S x S matrix.
//
// Replaces laser_tpu/ops/attention_bwd.py:72 _build_bwd_dq (flash_bwd_dq_kernel)
// and :173 _build_bwd_dkv (flash_bwd_dkv_kernel), MHA, causal or full mask.
//
// Math, per (batch x head), all fp32 (attention_bwd.py:1-13):
//   p_ij  = exp(scale * q_i.k_j - m_i) / l_i   (recomputed; 0 when masked or l_i == 0)
//   dp_ij = dO_i.v_j,  ds_ij = scale * p_ij * (dp_ij - dvec_i),  dvec_i = rowsum(dO_i * O_i)
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij dO_i
//
// What bounds it on the H100: at the training slice's shape (BH = 8 x 16,
// S = 1024, D = 128, causal, bf16) the dq pass does 3 and the dk/dv pass 4
// products of 2 x D FLOPs per visible (query, key) pair: about 51 and 69
// GFLOP, against ~170 MB of operands each, so arithmetic. This first version
// runs every product as fp32 FFMA from shared memory (bf16 x bf16 products
// are exact in fp32), like the forward's FFMA kernel. These FFMA kernels stay
// for f32 inputs (no TF32 under matmul_precision "highest"), for head dims
// other than 64 and 128 and for route 1; bf16/f16 at D 64 and 128 take
// flash_bwd_dq_mma_kernel and flash_bwd_dkv_mma_kernel (the tensor cores;
// see their note below).
//
// Design. The TPU kernels walk the streamed axis as a sequential grid
// dimension and carry the accumulator in VMEM scratch. Here blocks run in
// parallel, so each block OWNS a tile of rows and loops over the other axis
// itself: flash_bwd_dq_kernel owns 16 query rows and streams 32-key tiles;
// flash_bwd_dkv_kernel owns 16 key rows and streams 32-query tiles. No
// output is shared between blocks, so no atomics. Each warp owns 4 of the
// block's rows. Scores and dp: lane = streamed row (its tile row padded by
// one column so lanes read conflict-free). Accumulation: lane = head-dim
// column. The causal block skip holds on both sides: dq stops at the block's
// last query, dk/dv starts at the first query tile that can see the block's
// first key. Keys and queries at or past S are zero-filled and masked; rows
// past S are never written. A row with l == 0 gets p = 0 (never inf * 0).
// The scores are summed in the forward's order, so exp(s - m) <= 1 exactly.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using ltt::from_f32;
using ltt::to_f32;
using ltt::hp::cp_async_commit;
using ltt::hp::cp_async_tile;
using ltt::hp::cp_async_wait;
using ltt::hp::ldsm_x4;
using ltt::hp::ldsm_x4_trans;
using ltt::hp::mma16816;
using ltt::hp::pack2;
using ltt::hp::smem_u32;
using ltt::hp::swz;

constexpr int BW_WARPS = 4;
constexpr int BW_ROWS = 4;                  // owned rows per warp
constexpr int BW_BR = BW_WARPS * BW_ROWS;   // 16 owned rows per block
constexpr int BW_BS = 32;                   // streamed rows per tile (one per lane)
constexpr int BW_THREADS = BW_WARPS * 32;

__host__ __device__ constexpr size_t bwd_smem_floats(int dp) {
  // two owned [BR][DP] panels, two streamed [BS][DP + 1] tiles, two [BR][BS]
  return 2 * (size_t)BW_BR * dp + 2 * (size_t)BW_BS * (dp + 1) + 2 * (size_t)BW_BR * BW_BS;
}

__device__ __forceinline__ float recompute_p(float s, float m, float l, bool valid,
                                             float scale) {
  return (valid && l > 0.f) ? expf(s * scale - m) / l : 0.f;
}

template <typename T, int DC>
__global__ void __launch_bounds__(BW_THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ m, const float* __restrict__ l,
                        const float* __restrict__ dvec, T* __restrict__ dq, int S, int D,
                        int causal, float scale) {
  constexpr int DP = DC * 32;
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BR][DP]
  float* dOs = Qs + BW_BR * DP;           // [BR][DP]
  float* Ks = dOs + BW_BR * DP;           // [BS][DP + 1]
  float* Vs = Ks + BW_BS * (DP + 1);      // [BS][DP + 1]
  float* DSs = Vs + BW_BS * (DP + 1);     // [BR][BS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BW_BR;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t sbase = (size_t)blockIdx.y * S;

  for (int i = tid; i < BW_BR * DP; i += BW_THREADS) {
    const int r = i / DP, d = i % DP;
    const int gq = q0 + r;
    const bool ok = gq < S && d < D;
    const size_t off = base + (size_t)gq * D + d;
    Qs[i] = ok ? to_f32(q[off]) : 0.f;
    dOs[i] = ok ? to_f32(dout[off]) : 0.f;
  }

  float mr[BW_ROWS], lr[BW_ROWS], dr[BW_ROWS], acc[BW_ROWS][DC];
#pragma unroll
  for (int r = 0; r < BW_ROWS; ++r) {
    const int qpos = q0 + warp * BW_ROWS + r;
    const bool ok = qpos < S;
    mr[r] = ok ? m[sbase + qpos] : 0.f;
    lr[r] = ok ? l[sbase + qpos] : 0.f;  // l == 0: the row contributes nothing
    dr[r] = ok ? dvec[sbase + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BW_BR) : S;
  for (int k0 = 0; k0 < kend; k0 += BW_BS) {
    __syncthreads();  // the previous tile is consumed (and Qs/dOs are written)
    for (int i = tid; i < BW_BS * DP; i += BW_THREADS) {
      const int r = i / DP, d = i % DP;
      const int gk = k0 + r;
      const bool ok = gk < S && d < D;
      const size_t off = base + (size_t)gk * D + d;
      Ks[r * (DP + 1) + d] = ok ? to_f32(k[off]) : 0.f;
      Vs[r * (DP + 1) + d] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // s = q.k and dp = dO.v for this warp's rows against key k0 + lane
    float s[BW_ROWS], dp[BW_ROWS];
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) s[r] = dp[r] = 0.f;
    const float* kr = Ks + lane * (DP + 1);
    const float* vr = Vs + lane * (DP + 1);
    const float* qw = Qs + warp * BW_ROWS * DP;
    const float* dw = dOs + warp * BW_ROWS * DP;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
      const float vd = vr[d];
#pragma unroll
      for (int r = 0; r < BW_ROWS; ++r) {
        s[r] = fmaf(qw[r * DP + d], kd, s[r]);
        dp[r] = fmaf(dw[r * DP + d], vd, dp[r]);
      }
    }
    const int key = k0 + lane;
    float* dsw = DSs + warp * BW_ROWS * BW_BS;
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) {
      const int qpos = q0 + warp * BW_ROWS + r;
      const bool valid = key < S && (!causal || key <= qpos);
      const float p = recompute_p(s[r], mr[r], lr[r], valid, scale);
      dsw[r * BW_BS + lane] = scale * p * (dp[r] - dr[r]);
    }
    __syncwarp();

    // dq += ds . K: lane owns head-dim columns lane + 32 c
    for (int j = 0; j < BW_BS; ++j) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[j * (DP + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < BW_ROWS; ++r) {
        const float dsj = dsw[r * BW_BS + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(dsj, kv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < BW_ROWS; ++r) {
    const int qpos = q0 + warp * BW_ROWS + r;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dq[base + (size_t)qpos * D + d] = from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(BW_THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ m, const float* __restrict__ l,
                         const float* __restrict__ dvec, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int D, int causal, float scale) {
  constexpr int DP = DC * 32;
  extern __shared__ float smem[];
  float* Ks = smem;                       // [BR][DP]  owned keys
  float* Vs = Ks + BW_BR * DP;            // [BR][DP]
  float* Qs = Vs + BW_BR * DP;            // [BS][DP + 1]  streamed queries
  float* dOs = Qs + BW_BS * (DP + 1);     // [BS][DP + 1]
  float* Ps = dOs + BW_BS * (DP + 1);     // [BR][BS]
  float* DSs = Ps + BW_BR * BW_BS;        // [BR][BS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = blockIdx.x * BW_BR;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t sbase = (size_t)blockIdx.y * S;

  for (int i = tid; i < BW_BR * DP; i += BW_THREADS) {
    const int r = i / DP, d = i % DP;
    const int gk = k0 + r;
    const bool ok = gk < S && d < D;
    const size_t off = base + (size_t)gk * D + d;
    Ks[i] = ok ? to_f32(k[off]) : 0.f;
    Vs[i] = ok ? to_f32(v[off]) : 0.f;
  }

  float acck[BW_ROWS][DC], accv[BW_ROWS][DC];
#pragma unroll
  for (int r = 0; r < BW_ROWS; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acck[r][c] = accv[r][c] = 0.f;

  // causal: query rows before the block's first key see none of its keys
  const int qbeg = causal ? (k0 / BW_BS) * BW_BS : 0;
  for (int q0 = qbeg; q0 < S; q0 += BW_BS) {
    __syncthreads();  // the previous tile is consumed (and Ks/Vs are written)
    for (int i = tid; i < BW_BS * DP; i += BW_THREADS) {
      const int r = i / DP, d = i % DP;
      const int gq = q0 + r;
      const bool ok = gq < S && d < D;
      const size_t off = base + (size_t)gq * D + d;
      Qs[r * (DP + 1) + d] = ok ? to_f32(q[off]) : 0.f;
      dOs[r * (DP + 1) + d] = ok ? to_f32(dout[off]) : 0.f;
    }
    __syncthreads();

    // lane = query q0 + lane: its statistics, and its scores against this
    // warp's key rows
    const int qpos = q0 + lane;
    const bool qok = qpos < S;
    const float mq = qok ? m[sbase + qpos] : 0.f;
    const float lq = qok ? l[sbase + qpos] : 0.f;
    const float dq_ = qok ? dvec[sbase + qpos] : 0.f;
    float s[BW_ROWS], dp[BW_ROWS];
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) s[r] = dp[r] = 0.f;
    const float* qr = Qs + lane * (DP + 1);
    const float* dor = dOs + lane * (DP + 1);
    const float* kw = Ks + warp * BW_ROWS * DP;
    const float* vw = Vs + warp * BW_ROWS * DP;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
      const float od = dor[d];
#pragma unroll
      for (int r = 0; r < BW_ROWS; ++r) {
        s[r] = fmaf(qd, kw[r * DP + d], s[r]);
        dp[r] = fmaf(od, vw[r * DP + d], dp[r]);
      }
    }
    float* pw = Ps + warp * BW_ROWS * BW_BS;
    float* dsw = DSs + warp * BW_ROWS * BW_BS;
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) {
      const int key = k0 + warp * BW_ROWS + r;
      const bool valid = qok && key < S && (!causal || key <= qpos);
      const float p = recompute_p(s[r], mq, lq, valid, scale);
      pw[r * BW_BS + lane] = p;
      dsw[r * BW_BS + lane] = scale * p * (dp[r] - dq_);
    }
    __syncwarp();

    // dv += p^T dO, dk += ds^T Q over this tile's queries; lane owns columns
    for (int i = 0; i < BW_BS; ++i) {
      float qv[DC], ov[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        qv[c] = Qs[i * (DP + 1) + lane + 32 * c];
        ov[c] = dOs[i * (DP + 1) + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < BW_ROWS; ++r) {
        const float pi = pw[r * BW_BS + i];
        const float dsi = dsw[r * BW_BS + i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          accv[r][c] = fmaf(pi, ov[c], accv[r][c]);
          acck[r][c] = fmaf(dsi, qv[c], acck[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < BW_ROWS; ++r) {
    const int key = k0 + warp * BW_ROWS + r;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[base + (size_t)key * D + d] = from_f32<T>(acck[r][c]);
        dv[base + (size_t)key * D + d] = from_f32<T>(accv[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16, D 64 or 128: the tensor cores through mma.sync.m16n8k16
// ---------------------------------------------------------------------------
// The same two functions on the tensor cores (FlashAttention-2's backward,
// split in two kernels as laser_tpu splits it: deterministic, no atomics).
// What bounds them: 3 (dq) and 4 (dk/dv) products of 2 x D flops per
// visible pair, 51.5 and 68.7 GFLOP at BH 128, S 1024, D 128 causal, against
// ~170 MB of operands: the bf16 tensor-core rate (989 TFLOP/s dense: 0.0522
// and 0.0696 ms), which only tensor-core instructions reach; the FFMA
// kernels above run at the 67 TFLOP/s fp32 rate at best. Design (the
// forward's flash_fwd_mma_kernel, on csrc/hopper.cuh's cp.async, swizzle,
// ldmatrix and mma):
// - flash_bwd_dq_mma_kernel: a block of 4 warps owns 64 query rows, 16 a
//   warp, whose Q and dO are loaded once and held as mma A fragments in
//   registers; 64-key K and V tiles stream through two shared-memory
//   buffers by cp.async in the input dtype (swizzled; keys past S
//   zero-filled), the next tile in flight while this one is used. In 32-key
//   steps: S = Q K^T and dP = dO V^T in fp32 registers (K, V fragments by
//   ldmatrix); P = exp2(s scale log2(e) - m log2(e)) / l from the forward's
//   (m, l), 0 where the key is masked or l == 0 (never inf * 0); dS = scale
//   P (dP - dvec), rounded to the input dtype in registers, is the A
//   fragment of dQ += dS K (the accumulator layout of two adjacent n8
//   blocks is the A layout of one k16 slice), K fragments by
//   ldmatrix.trans. Causal: key tiles past the block's last query are never
//   loaded, and the query tiles with the most keys run first.
// - flash_bwd_dkv_mma_kernel: a block owns 64 key rows, 16 a warp. K and V
//   stay in shared memory and give their A fragments by ldmatrix each step
//   (held in registers beside the 2 x 64 fp32 dK and dV accumulators of a
//   thread at D 128 they would pass 255 registers). 64-query tiles of Q and
//   dO stream through two buffers by cp.async, and the tile's m log2(e),
//   1 / l and dvec through two small fp32 buffers (plain loads issued a
//   tile ahead). In 32-query steps: S^T = K Q^T and dP^T = V dO^T, whose
//   columns are the streamed queries, so each column's statistics are read
//   from shared memory; P^T and dS^T, rounded in registers, are the A
//   fragments of dV += P^T dO and dK += dS^T Q (dO, Q fragments by
//   ldmatrix.trans). Causal: query tiles before the block's first key are
//   never loaded; the key tiles that see the most queries (blockIdx.y 0)
//   run first.
// Numerics: P and dS are rounded to the input dtype before their products,
// as laser_tpu's kernels are for 16-bit inputs (prec=None: one bf16 pass on
// the MXU, attention_bwd.py:84, :182); every sum is fp32. Rows at or past S
// are never written.
// ptxas (sm_90a, CUDA 12.8, nvcc.log), registers a thread: dq 225 at D 64
// and 255 at D 128, dk/dv 199 and 255, no spills (at D 128 two blocks an
// SM: 128 threads x 255 registers, 96-98 KB of shared memory a block).
constexpr int BM_WARPS = 4;
constexpr int BM_THREADS = BM_WARPS * 32;
constexpr int BM_ROWS = BM_WARPS * 16;  // owned rows a block
constexpr int BM_TILE = 64;             // streamed rows a tile
constexpr int BM_STEP = 32;             // streamed rows a score step
constexpr float BM_LOG2E = 1.4426950408889634f;

// 2^x on the SFU with denormal results flushed to 0 (a flushed p is below
// 2^-126 / l), without exp2f's denormal handling. With the masks kept to
// edge tiles it took dq from 0.225-0.231 ms to 0.210-0.212 and dk/dv from
// 0.376-0.381 to 0.339-0.341 on an H100 (20 calls in a row at BH 128,
// S 1024, causal; scripts/time_in_turns.py flash_backward)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the owned pair (Q, dO or K, V), two buffers of the streamed pair, all
// [rows][D] in the input dtype; dk/dv: two buffers of 3 x 64 fp32 statistics
__host__ __device__ constexpr size_t bwd_mma_smem_bytes(int D, bool dkv) {
  return (size_t)(2 * BM_ROWS + 4 * BM_TILE) * D * 2 + (dkv ? 2 * 3 * BM_TILE * 4 : 0);
}

template <typename T, int D>
__global__ void __launch_bounds__(BM_THREADS, 2)
    flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ m, const float* __restrict__ l,
                            const float* __restrict__ dvec, T* __restrict__ dq, int S,
                            int causal, float scale) {
  constexpr int KC = D / 16;  // 16-deep chunks of the head dim
  constexpr int NB = D / 8;   // 8-wide blocks of the output
  extern __shared__ __align__(128) uint8_t bm_smem[];
  T* Qs = reinterpret_cast<T*>(bm_smem);
  T* dOs = Qs + BM_ROWS * D;
  T* KV = dOs + BM_ROWS * D;  // buffer b: K at KV + 2 b 64 D, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which matrix, which row of it
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM_ROWS;
  const size_t base = (size_t)bh * S * D;
  const T* kg = k + base;
  const T* vg = v + base;
  // causal: keys past the block's last query row are never visible
  const int kend = causal ? min(S, q0 + BM_ROWS) : S;
  const int ntiles = (kend + BM_TILE - 1) / BM_TILE;

  cp_async_tile<T, D, BM_ROWS, BM_THREADS>(Qs, q + base, q0, S);
  cp_async_tile<T, D, BM_ROWS, BM_THREADS>(dOs, dout + base, q0, S);
  cp_async_tile<T, D, BM_TILE, BM_THREADS>(KV, kg, 0, S);
  cp_async_tile<T, D, BM_TILE, BM_THREADS>(KV + BM_TILE * D, vg, 0, S);
  cp_async_commit();

  // rows qrow and qrow + 8: m log2(e), 1 / l (0 where l == 0 or past S), dvec
  const int qrow = q0 + warp * 16 + g;
  float ml[2], il[2], dv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qrow + 8 * h;
    const bool ok = row < S;
    const float lr = ok ? l[(size_t)bh * S + row] : 0.f;
    ml[h] = ok ? m[(size_t)bh * S + row] * BM_LOG2E : 0.f;
    il[h] = lr > 0.f ? 1.f / lr : 0.f;
    dv[h] = ok ? dvec[(size_t)bh * S + row] : 0.f;
  }
  const float sl = scale * BM_LOG2E;

  uint32_t qf[KC][4], of[KC][4];
  float acc[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      T* nxt = KV + ((j + 1) & 1) * 2 * BM_TILE * D;
      cp_async_tile<T, D, BM_TILE, BM_THREADS>(nxt, kg, (j + 1) * BM_TILE, S);
      cp_async_tile<T, D, BM_TILE, BM_THREADS>(nxt + BM_TILE * D, vg, (j + 1) * BM_TILE, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      // A fragments of the warp's 16 rows: matrices (rows 0-7 | 8-15) x
      // (k 0-7 | 8-15), in a0..a3 order
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const int off = swz<D>(warp * 16 + mr + 8 * (mi & 1), 2 * kc + (mi >> 1));
        ldsm_x4(qf[kc], smem_u32(Qs + off));
        ldsm_x4(of[kc], smem_u32(dOs + off));
      }
    }
    const T* Ks = KV + (j & 1) * 2 * BM_TILE * D;
    const T* Vs = Ks + BM_TILE * D;
    // only the diagonal tile and a ragged last one need the mask
    const bool edge = (causal && j == ntiles - 1) || (j + 1) * BM_TILE > S;

#pragma unroll
    for (int st = 0; st < BM_TILE / BM_STEP; ++st) {
      const int r0 = st * BM_STEP;  // the step's first key row in the tile
      // S = Q K^T and dP = dO V^T for 16 rows x 32 keys: [nb] is key block nb
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          // matrices (keys 0-7 | 8-15 of pair np) x (d 0-7 | 8-15): b0 b1 of
          // blocks 2np and 2np+1
          const int off = swz<D>(r0 + np * 16 + mr + 8 * (mi >> 1), 2 * kc + (mi & 1));
          uint32_t b[4];
          ldsm_x4(b, smem_u32(Ks + off));
          mma16816<T>(s[2 * np], qf[kc], b[0], b[1]);
          mma16816<T>(s[2 * np + 1], qf[kc], b[2], b[3]);
          ldsm_x4(b, smem_u32(Vs + off));
          mma16816<T>(dp[2 * np], of[kc], b[0], b[1]);
          mma16816<T>(dp[2 * np + 1], of[kc], b[2], b[3]);
        }
      }
      // s[nb][2 h + e] is row qrow + 8 h, key j 64 + r0 + 8 nb + 2 t + e;
      // dS in registers: block nb is half of the A fragment of key chunk nb / 2
      uint32_t dsf[2][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int key = j * BM_TILE + r0 + nb * 8 + 2 * t + (e & 1);
          const bool valid =
              il[h] > 0.f && (!edge || (key < S && (!causal || key <= qrow + 8 * h)));
          const float p = valid ? ex2(fmaf(s[nb][e], sl, -ml[h])) * il[h] : 0.f;
          d[e] = scale * p * (dp[nb][e] - dv[h]);
        }
        dsf[nb >> 1][2 * (nb & 1)] = pack2<T>(d[0], d[1]);
        dsf[nb >> 1][2 * (nb & 1) + 1] = pack2<T>(d[2], d[3]);
      }
      // dQ += dS K: matrices (keys 0-7 | 8-15) x (d 0-7 | 8-15) of each
      // 16-wide d pair, transposed: b0 b1 of d blocks 2 dp2 and 2 dp2 + 1
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int dp2 = 0; dp2 < NB / 2; ++dp2) {
          uint32_t b[4];
          ldsm_x4_trans(b, smem_u32(Ks + swz<D>(r0 + kk * 16 + mr + 8 * (mi & 1),
                                                2 * dp2 + (mi >> 1))));
          mma16816<T>(acc[2 * dp2], dsf[kk], b[0], b[1]);
          mma16816<T>(acc[2 * dp2 + 1], dsf[kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qrow + 8 * h;
    if (row >= S) continue;
    T* orow = dq + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i) = pack2<T>(acc[i][2 * h], acc[i][2 * h + 1]);
  }
}

// the statistics of query rows [row0, row0 + 64) as the dk/dv kernel reads
// them: m log2(e), 1 / l (0 where l == 0 or past S), dvec; thread i < 64
// loads row row0 + i
__device__ __forceinline__ void load_stats(float (&st)[3], const float* __restrict__ m,
                                           const float* __restrict__ l,
                                           const float* __restrict__ dvec, size_t sbase,
                                           int row0, int S) {
  const int row = row0 + (int)threadIdx.x;
  const bool ok = threadIdx.x < BM_TILE && row < S;
  const float lr = ok ? l[sbase + row] : 0.f;
  st[0] = ok ? m[sbase + row] * BM_LOG2E : 0.f;
  st[1] = lr > 0.f ? 1.f / lr : 0.f;
  st[2] = ok ? dvec[sbase + row] : 0.f;
}

__device__ __forceinline__ void store_stats(float* buf, const float (&st)[3]) {
  if (threadIdx.x < BM_TILE) {
    buf[threadIdx.x] = st[0];
    buf[BM_TILE + threadIdx.x] = st[1];
    buf[2 * BM_TILE + threadIdx.x] = st[2];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BM_THREADS, 2)
    flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ m, const float* __restrict__ l,
                             const float* __restrict__ dvec, T* __restrict__ dk,
                             T* __restrict__ dv, int S, int causal, float scale) {
  constexpr int KC = D / 16;
  constexpr int NB = D / 8;
  extern __shared__ __align__(128) uint8_t bm_smem[];
  T* Ks = reinterpret_cast<T*>(bm_smem);
  T* Vs = Ks + BM_ROWS * D;
  T* QD = Vs + BM_ROWS * D;  // buffer b: Q at QD + 2 b 64 D, dO after it
  float* ST = reinterpret_cast<float*>(QD + 4 * BM_TILE * D);  // buffer b at ST + 3 b 64

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BM_ROWS;
  const size_t base = (size_t)bh * S * D;
  const size_t sbase = (size_t)bh * S;
  const T* qg = q + base;
  const T* og = dout + base;
  // causal: query tiles before the block's first key see none of its keys
  const int qbeg = causal ? k0 / BM_TILE : 0;
  const int ntiles = (S + BM_TILE - 1) / BM_TILE - qbeg;

  cp_async_tile<T, D, BM_ROWS, BM_THREADS>(Ks, k + base, k0, S);
  cp_async_tile<T, D, BM_ROWS, BM_THREADS>(Vs, v + base, k0, S);
  cp_async_tile<T, D, BM_TILE, BM_THREADS>(QD, qg, qbeg * BM_TILE, S);
  cp_async_tile<T, D, BM_TILE, BM_THREADS>(QD + BM_TILE * D, og, qbeg * BM_TILE, S);
  cp_async_commit();
  {
    float st0[3];
    load_stats(st0, m, l, dvec, sbase, qbeg * BM_TILE, S);
    store_stats(ST, st0);
  }

  const int krow = k0 + warp * 16 + g;  // rows krow and krow + 8 of S^T
  const bool kin[2] = {krow < S, krow + 8 < S};  // queries past S have 1 / l == 0
  const float sl = scale * BM_LOG2E;
  float acck[NB][4], accv[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[i][e] = accv[i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int qt = qbeg + j;
    const bool more = j + 1 < ntiles;
    float nst[3];
    if (more) {
      T* nxt = QD + ((j + 1) & 1) * 2 * BM_TILE * D;
      cp_async_tile<T, D, BM_TILE, BM_THREADS>(nxt, qg, (qt + 1) * BM_TILE, S);
      cp_async_tile<T, D, BM_TILE, BM_THREADS>(nxt + BM_TILE * D, og, (qt + 1) * BM_TILE, S);
      cp_async_commit();
      load_stats(nst, m, l, dvec, sbase, (qt + 1) * BM_TILE, S);  // stored after this tile
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qs = QD + (j & 1) * 2 * BM_TILE * D;
    const T* dOs = Qs + BM_TILE * D;
    const float* st = ST + (j & 1) * 3 * BM_TILE;
    // only the diagonal tile and a ragged last one need the mask
    const bool edge = (causal && j == 0) || (qt + 1) * BM_TILE > S;

    // not unrolled: the two steps interleaved spilled 68 B at D 128 (28 not
    // interleaved) and took 0.403-0.410 ms against 0.376-0.377 on an H100 (20
    // calls in a row at BH 128, S 1024, causal; scripts/time_in_turns.py
    // flash_backward), before the masks were kept to edge tiles
#pragma unroll 1
    for (int sp = 0; sp < BM_TILE / BM_STEP; ++sp) {
      const int c0 = sp * BM_STEP;  // the step's first query row in the tile
      // S^T = K Q^T and dP^T = V dO^T for 16 keys x 32 queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ka[4], va[4];
        const int aoff = swz<D>(warp * 16 + mr + 8 * (mi & 1), 2 * kc + (mi >> 1));
        ldsm_x4(ka, smem_u32(Ks + aoff));
        ldsm_x4(va, smem_u32(Vs + aoff));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int off = swz<D>(c0 + np * 16 + mr + 8 * (mi >> 1), 2 * kc + (mi & 1));
          uint32_t b[4];
          ldsm_x4(b, smem_u32(Qs + off));
          mma16816<T>(s[2 * np], ka, b[0], b[1]);
          mma16816<T>(s[2 * np + 1], ka, b[2], b[3]);
          ldsm_x4(b, smem_u32(dOs + off));
          mma16816<T>(dp[2 * np], va, b[0], b[1]);
          mma16816<T>(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
      // s[nb][2 h + e] is key krow + 8 h, query qt 64 + c0 + 8 nb + 2 t + e
      uint32_t pf[2][4], dsf[2][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int c = c0 + nb * 8 + 2 * t;
        const float2 mq = *reinterpret_cast<const float2*>(st + c);
        const float2 iq = *reinterpret_cast<const float2*>(st + BM_TILE + c);
        const float2 dq2 = *reinterpret_cast<const float2*>(st + 2 * BM_TILE + c);
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = krow + 8 * (e >> 1);
          const int qpos = qt * BM_TILE + c + (e & 1);
          const float mle = (e & 1) ? mq.y : mq.x;
          const float ile = (e & 1) ? iq.y : iq.x;
          const float dve = (e & 1) ? dq2.y : dq2.x;
          const bool valid = kin[e >> 1] && ile > 0.f && (!edge || !causal || key <= qpos);
          p[e] = valid ? ex2(fmaf(s[nb][e], sl, -mle)) * ile : 0.f;
          d[e] = scale * p[e] * (dp[nb][e] - dve);
        }
        pf[nb >> 1][2 * (nb & 1)] = pack2<T>(p[0], p[1]);
        pf[nb >> 1][2 * (nb & 1) + 1] = pack2<T>(p[2], p[3]);
        dsf[nb >> 1][2 * (nb & 1)] = pack2<T>(d[0], d[1]);
        dsf[nb >> 1][2 * (nb & 1) + 1] = pack2<T>(d[2], d[3]);
      }
      // dV += P^T dO and dK += dS^T Q: matrices (queries 0-7 | 8-15) x
      // (d 0-7 | 8-15) of each 16-wide d pair, transposed
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int dp2 = 0; dp2 < NB / 2; ++dp2) {
          const int off = swz<D>(c0 + kk * 16 + mr + 8 * (mi & 1), 2 * dp2 + (mi >> 1));
          uint32_t b[4];
          ldsm_x4_trans(b, smem_u32(dOs + off));
          mma16816<T>(accv[2 * dp2], pf[kk], b[0], b[1]);
          mma16816<T>(accv[2 * dp2 + 1], pf[kk], b[2], b[3]);
          ldsm_x4_trans(b, smem_u32(Qs + off));
          mma16816<T>(acck[2 * dp2], dsf[kk], b[0], b[1]);
          mma16816<T>(acck[2 * dp2 + 1], dsf[kk], b[2], b[3]);
        }
      }
    }
    if (more) store_stats(ST + ((j + 1) & 1) * 3 * BM_TILE, nst);
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = krow + 8 * h;
    if (row >= S) continue;
    T* dkr = dk + base + (size_t)row * D + 2 * t;
    T* dvr = dv + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * i) = pack2<T>(acck[i][2 * h], acck[i][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvr + 8 * i) = pack2<T>(accv[i][2 * h], accv[i][2 * h + 1]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *m, *l, *dvec;
  void *dq, *dk, *dv;
  int BH, S, D, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DC>
int launch(const BwdArgs& a, bool dkv) {
  const size_t smem = bwd_smem_floats(DC * 32) * sizeof(float);
  dim3 grid((a.S + BW_BR - 1) / BW_BR, a.BH);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (dkv) {
    const int err = ltt::allow_smem(flash_bwd_dkv_kernel<T, DC>, smem);
    if (err) return err;
    flash_bwd_dkv_kernel<T, DC><<<grid, BW_THREADS, smem, a.stream>>>(
        q, k, v, dout, a.m, a.l, a.dvec, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S,
        a.D, a.causal, a.scale);
  } else {
    const int err = ltt::allow_smem(flash_bwd_dq_kernel<T, DC>, smem);
    if (err) return err;
    flash_bwd_dq_kernel<T, DC><<<grid, BW_THREADS, smem, a.stream>>>(
        q, k, v, dout, a.m, a.l, a.dvec, static_cast<T*>(a.dq), a.S, a.D, a.causal, a.scale);
  }
  return ltt::launch_status();
}

template <typename T, int D>
int launch_mma(const BwdArgs& a, bool dkv) {
  const size_t smem = bwd_mma_smem_bytes(D, dkv);
  dim3 grid(a.BH, (a.S + BM_ROWS - 1) / BM_ROWS);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (dkv) {
    const int err = ltt::allow_smem(flash_bwd_dkv_mma_kernel<T, D>, smem);
    if (err) return err;
    flash_bwd_dkv_mma_kernel<T, D><<<grid, BM_THREADS, smem, a.stream>>>(
        q, k, v, dout, a.m, a.l, a.dvec, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S,
        a.causal, a.scale);
  } else {
    const int err = ltt::allow_smem(flash_bwd_dq_mma_kernel<T, D>, smem);
    if (err) return err;
    flash_bwd_dq_mma_kernel<T, D><<<grid, BM_THREADS, smem, a.stream>>>(
        q, k, v, dout, a.m, a.l, a.dvec, static_cast<T*>(a.dq), a.S, a.causal, a.scale);
  }
  return ltt::launch_status();
}

// route codes shared with ops/attention_bwd.py (ROUTES), as the forward's
enum Route { kRouteAuto = 0, kRouteFfma = 1, kRouteMma = 2 };

// the tensor-core route: bf16/f16, D 64 or 128, 16-byte-aligned tensors
template <typename T>
bool mma_fits(const BwdArgs& a) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                        reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
                        reinterpret_cast<uintptr_t>(a.dq) | reinterpret_cast<uintptr_t>(a.dk) |
                        reinterpret_cast<uintptr_t>(a.dv);
  return !std::is_same<T, float>::value && (a.D == 64 || a.D == 128) && any % 16 == 0;
}

// route: kRouteAuto takes the tensor cores where mma_fits, kRouteFfma the
// FFMA kernels, kRouteMma the tensor cores (an error where they do not
// fit); *taken gets the route that launched.
template <typename T>
int launch_d(const BwdArgs& a, bool dkv, int route, int* taken) {
  const bool fits = mma_fits<T>(a);
  *taken = kRouteFfma;
  if (route == kRouteMma && !fits) return static_cast<int>(cudaErrorInvalidValue);
  if (fits && route != kRouteFfma) {
    *taken = kRouteMma;
    if constexpr (!std::is_same<T, float>::value) {
      if (a.D == 64) return launch_mma<T, 64>(a, dkv);
      return launch_mma<T, 128>(a, dkv);
    }
  }
  if (a.D <= 32) return launch<T, 1>(a, dkv);
  if (a.D <= 64) return launch<T, 2>(a, dkv);
  if (a.D <= 128) return launch<T, 4>(a, dkv);
  return launch<T, 8>(a, dkv);
}

int dispatch(const BwdArgs& a, int dtype, bool dkv, int route, int* taken) {
  if (dtype == ltt::kF32) return launch_d<float>(a, dkv, route, taken);
  if (dtype == ltt::kBF16) return launch_d<__nv_bfloat16>(a, dkv, route, taken);
  return launch_d<__half>(a, dkv, route, taken);
}

}  // namespace

// q, k, v, dout, dq: (BH, S, D) contiguous in dtype, D <= 256; m, l, dvec:
// (BH, S) fp32. route: 0 picks, 1 the FFMA kernel, 2 the tensor cores;
// *taken gets the route that launched.
LTT_API int ltt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* m, const void* l, const void* dvec, void* dq, int BH,
                             int S, int D, int causal, float scale, int dtype, int route,
                             int* taken, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(m), static_cast<const float*>(l),
            static_cast<const float*>(dvec), dq, nullptr, nullptr, BH, S, D, causal, scale,
            static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, false, route, taken);
}

// As ltt_flash_bwd_dq; writes dk, dv: (BH, S, D) in dtype.
LTT_API int ltt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* m, const void* l, const void* dvec, void* dk, void* dv,
                              int BH, int S, int D, int causal, float scale, int dtype,
                              int route, int* taken, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(m), static_cast<const float*>(l),
            static_cast<const float*>(dvec), nullptr, dk, dv, BH, S, D, causal, scale,
            static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, true, route, taken);
}
