// Flash attention forward over (BH, S, D): softmax(Q K^T * scale [causal]) V.
//
// Replaces laser_tpu/ops/attention.py:60 _build_flash (value output, MHA and
// the GQA kv-head map, causal or full mask), and its return_stats=True
// variant: when the m/l
// pointers are not null, each row's running max of the SCALED scores and its
// softmax denominator (fp32, (BH, S)) are written beside the output, as
// the backward kernels (flash_attention_bwd.cu) expect them. The stats write
// is a compile-time variant (STATS): with a run-time test of the pointers,
// the value-only forward at the serving prefill's shape took 0.730 ms in
// place of 0.640 on an H100 (scripts/time_in_turns.py flash_forward).
//
// What bounds it on the H100: at the serving slice's prefill (BH = 8 x 16,
// S = bucket <= 512, D = 128) it is 2 x BH x S^2 x D FLOPs over only
// 4 x BH x S x D x 2 bytes, so arithmetic. This first version runs the two
// products as fp32 FFMA from shared memory (bf16 x bf16 products are exact
// in fp32, so it computes what the MXU computes); moving them onto the
// tensor cores is later work.
//
// GQA (attention.py:239-247): q holds B x Hq heads, k and v only B x Hkv;
// query row b reads kv row (b / Hq) * Hkv + (b % Hq) / (Hq / Hkv), so each kv
// head is read from HBM by its group of Hq / Hkv query heads and never
// repeated. MHA callers pass Hq == Hkv (any equal pair maps b to b).
//
// Design: one block of 4 warps per (head, 16-query tile); each warp owns 4
// query rows. Key/value tiles of 32 rows are staged in shared memory as fp32
// (the key tile padded by one column so lane j reading key j is
// conflict-free). Scores: lane = key. P.V: lane = head-dim column. Online
// softmax with fp32 statistics and accumulator; causal tiles past the
// block's last query are never loaded (the block skip); keys >= S are masked
// and their rows zero-filled. Masked probabilities are set to 0 explicitly,
// so a row that sees no valid key ends with l == 0 and writes 0, never NaN.
// P is rounded to the input dtype before the P.V product, as the TPU kernel
// does (attention.py:173-175); l sums the unrounded P.
#include "common.cuh"

namespace {

using ltt::from_f32;
using ltt::kNegInf;
using ltt::to_f32;

constexpr int FL_WARPS = 4;
constexpr int FL_ROWS = 4;                   // query rows per warp
constexpr int FL_BQ = FL_WARPS * FL_ROWS;    // 16 query rows per block
constexpr int FL_BK = 32;                    // keys per tile (one per lane)
constexpr int FL_THREADS = FL_WARPS * 32;

__host__ __device__ constexpr size_t flash_smem_floats(int dp) {
  return (size_t)FL_BQ * dp + (size_t)FL_BK * (dp + 1) + (size_t)FL_BK * dp +
         (size_t)FL_BQ * FL_BK;
}

// DC: head-dim columns per lane (D <= 32 * DC); STATS: write m_out, l_out
template <typename T, int DC, bool STATS>
__global__ void __launch_bounds__(FL_THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                     int S, int D, int Hq, int Hkv, int causal, float scale) {
  constexpr int DP = DC * 32;
  extern __shared__ float smem[];
  float* Qs = smem;                       // [FL_BQ][DP]
  float* Ks = Qs + FL_BQ * DP;            // [FL_BK][DP + 1]
  float* Vs = Ks + FL_BK * (DP + 1);      // [FL_BK][DP]
  float* Ps = Vs + FL_BK * DP;            // [FL_BQ][FL_BK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * FL_BQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int kv_row = (blockIdx.y / Hq) * Hkv + (blockIdx.y % Hq) / (Hq / Hkv);
  const size_t kv_base = (size_t)kv_row * S * D;

  for (int i = tid; i < FL_BQ * DP; i += FL_THREADS) {
    const int r = i / DP, d = i % DP;
    const int gq = q0 + r;
    Qs[i] = (gq < S && d < D) ? to_f32(q[base + (size_t)gq * D + d]) : 0.f;
  }

  float m[FL_ROWS], l[FL_ROWS], acc[FL_ROWS][DC];
#pragma unroll
  for (int r = 0; r < FL_ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // causal: keys past the block's last query row are never visible
  const int kend = causal ? min(S, q0 + FL_BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += FL_BK) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < FL_BK * DP; i += FL_THREADS) {
      const int r = i / DP, d = i % DP;
      const int gk = k0 + r;
      const bool ok = gk < S && d < D;
      const size_t off = kv_base + (size_t)gk * D + d;
      Ks[r * (DP + 1) + d] = ok ? to_f32(k[off]) : 0.f;
      Vs[r * DP + d] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // scores for this warp's rows against key k0 + lane
    float s[FL_ROWS];
#pragma unroll
    for (int r = 0; r < FL_ROWS; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (DP + 1);
    const float* qw = Qs + warp * FL_ROWS * DP;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < FL_ROWS; ++r) s[r] = fmaf(qw[r * DP + d], kd, s[r]);
    }
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < FL_ROWS; ++r) {
      const int qpos = q0 + warp * FL_ROWS + r;
      const bool valid = key < S && (!causal || key <= qpos);
      const float sv = valid ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], ltt::warp_max(sv));
      const float corr = expf(m[r] - m_new);
      const float p = valid ? expf(sv - m_new) : 0.f;
      l[r] = l[r] * corr + ltt::warp_sum(p);
      m[r] = m_new;
      Ps[(warp * FL_ROWS + r) * FL_BK + lane] = ltt::round_through<T>(p);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
    }
    __syncwarp();

    // P.V: lane owns head-dim columns lane + 32 c
    const float* pw = Ps + warp * FL_ROWS * FL_BK;
    for (int j = 0; j < FL_BK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * DP + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < FL_ROWS; ++r) {
        const float pj = pw[r * FL_BK + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FL_ROWS; ++r) {
    const int qpos = q0 + warp * FL_ROWS + r;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D)
        o[base + (size_t)qpos * D + d] = from_f32<T>(l[r] > 0.f ? acc[r][c] / l[r] : 0.f);
    }
    if constexpr (STATS) {
      if (lane == 0) {
        const size_t row = (size_t)blockIdx.y * S + qpos;
        m_out[row] = m[r];
        l_out[row] = l[r];
      }
    }
  }
}

template <typename T, int DC, bool STATS>
int launch(const void* q, const void* k, const void* v, void* o, float* m, float* l, int BH,
           int S, int D, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = flash_smem_floats(DC * 32) * sizeof(float);
  const int err = ltt::allow_smem(flash_fwd_kernel<T, DC, STATS>, smem);
  if (err) return err;
  dim3 grid((S + FL_BQ - 1) / FL_BQ, BH);
  flash_fwd_kernel<T, DC, STATS><<<grid, FL_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m, l, S, D, Hq, Hkv, causal, scale);
  return ltt::launch_status();
}

template <typename T, bool STATS>
int launch_d(const void* q, const void* k, const void* v, void* o, float* m, float* l, int BH,
             int S, int D, int Hq, int Hkv, int causal, float scale, cudaStream_t s) {
  if (D <= 32) return launch<T, 1, STATS>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, s);
  if (D <= 64) return launch<T, 2, STATS>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, s);
  if (D <= 128) return launch<T, 4, STATS>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, s);
  return launch<T, 8, STATS>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, s);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, float* m, float* l, int BH,
             int S, int D, int Hq, int Hkv, int causal, float scale, cudaStream_t s) {
  if (m) return launch_d<T, true>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, s);
  return launch_d<T, false>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, s);
}

}  // namespace

// q, o: (BH, S, D) and k, v: (BH / Hq * Hkv, S, D), contiguous in dtype,
// D <= 256, Hq a multiple of Hkv. m, l: (BH, S) fp32, or both null for the
// value-only forward (m alone decides the variant).
LTT_API int ltt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                          int BH, int S, int D, int Hq, int Hkv, int causal, float scale,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  if (dtype == ltt::kF32)
    return launch_t<float>(q, k, v, o, mf, lf, BH, S, D, Hq, Hkv, causal, scale, s);
  if (dtype == ltt::kBF16)
    return launch_t<__nv_bfloat16>(q, k, v, o, mf, lf, BH, S, D, Hq, Hkv, causal, scale, s);
  return launch_t<__half>(q, k, v, o, mf, lf, BH, S, D, Hq, Hkv, causal, scale, s);
}
