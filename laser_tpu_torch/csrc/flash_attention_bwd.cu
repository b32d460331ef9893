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
// are exact in fp32), like the forward; tensor cores are later work.
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
#include "common.cuh"

namespace {

using ltt::from_f32;
using ltt::to_f32;

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

template <typename T>
int launch_d(const BwdArgs& a, bool dkv) {
  if (a.D <= 32) return launch<T, 1>(a, dkv);
  if (a.D <= 64) return launch<T, 2>(a, dkv);
  if (a.D <= 128) return launch<T, 4>(a, dkv);
  return launch<T, 8>(a, dkv);
}

int dispatch(const BwdArgs& a, int dtype, bool dkv) {
  if (dtype == ltt::kF32) return launch_d<float>(a, dkv);
  if (dtype == ltt::kBF16) return launch_d<__nv_bfloat16>(a, dkv);
  return launch_d<__half>(a, dkv);
}

}  // namespace

// q, k, v, dout, dq: (BH, S, D) contiguous in dtype, D <= 256; m, l, dvec:
// (BH, S) fp32.
LTT_API int ltt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* m, const void* l, const void* dvec, void* dq, int BH,
                             int S, int D, int causal, float scale, int dtype, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(m), static_cast<const float*>(l),
            static_cast<const float*>(dvec), dq, nullptr, nullptr, BH, S, D, causal, scale,
            static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, false);
}

// As ltt_flash_bwd_dq; writes dk, dv: (BH, S, D) in dtype.
LTT_API int ltt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* m, const void* l, const void* dvec, void* dk, void* dv,
                              int BH, int S, int D, int causal, float scale, int dtype,
                              void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(m), static_cast<const float*>(l),
            static_cast<const float*>(dvec), nullptr, dk, dv, BH, S, D, causal, scale,
            static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, true);
}
