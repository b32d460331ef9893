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
//
// This FFMA kernel stays for f32 inputs (no TF32 under matmul_precision
// "highest") and for head dims other than 64 and 128. bf16/f16 at D 64 and
// 128 take flash_fwd_mma_kernel (the tensor cores; see its note).
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using ltt::from_f32;
using ltt::kNegInf;
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


// ---------------------------------------------------------------------------
// bf16 / f16, D 64 or 128: the tensor cores through mma.sync.m16n8k16
// ---------------------------------------------------------------------------
// The same function on the tensor cores (FlashAttention-2's scheme). What
// bounds it: 4 D flops per visible (query, key) pair, 8.6 GFLOP at the
// serving prefill (BH 128, S 512, causal) against 67 MB of operands, so the
// bf16 tensor-core rate (989 TFLOP/s dense), which only tensor-core
// instructions reach; the FFMA kernel above runs at the 67 TFLOP/s fp32 rate
// at best and stages K and V as fp32. Design:
// - a block of 4 warps owns 64 query rows, each warp 16; Q is loaded once
//   and held as mma A fragments in registers;
// - 64-key K and V tiles stream through two shared-memory buffers with
//   cp.async in the input dtype (16-byte chunks, the chunk index XOR the
//   row's low 3 bits so ldmatrix reads are conflict-free; rows past S are
//   zero-filled), the next tile in flight while this one is used;
// - S = Q K^T stays in registers (fp32 accumulators; K fragments by
//   ldmatrix), the online softmax runs on them with fp32 m and l, a row's
//   max and sums over its quad by shuffles, exp as exp2 of the scores scaled
//   by scale * log2(e); m and l are kept in natural-log units, so the STATS
//   variant writes what the FFMA kernel writes (m the max of the scaled
//   scores, l the denominator) for flash_attention_bwd.cu;
// - P is rounded to the input dtype in registers and used as the A fragment
//   of P.V (V fragments by ldmatrix.trans) while l sums the unrounded P, as
//   above; a row that sees no key writes 0;
// - causal: key tiles past the block's last query are never loaded, and the
//   q tiles with the most keys are scheduled first (blockIdx.y reversed);
// - the GQA kv-row map is the FFMA kernel's;
// - cp.async, the swizzle, ldmatrix and mma are csrc/hopper.cuh's, shared
//   with the backward's tensor-core kernels (csrc/flash_attention_bwd.cu).
// The scores are summed in another order than the FFMA kernel's and the
// backward's, so exp(s - m) in the backward may exceed 1 by a rounding.
constexpr int FM_WARPS = 4;
constexpr int FM_BQ = FM_WARPS * 16;  // query rows a block
constexpr int FM_BK = 64;             // keys a tile
constexpr int FM_THREADS = FM_WARPS * 32;
constexpr float FM_LOG2E = 1.4426950408889634f;

// Q, then two (K, V) buffers, all [rows][D] in the input dtype
__host__ __device__ constexpr size_t mma_smem_bytes(int D) {
  return (size_t)(FM_BQ + 4 * FM_BK) * D * 2;
}

template <typename T, int D, bool STATS>
__global__ void __launch_bounds__(FM_THREADS)
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, float* __restrict__ m_out,
                         float* __restrict__ l_out, int S, int Hq, int Hkv, int causal,
                         float scale) {
  constexpr int KC = D / 16;  // 16-deep chunks of the head dim
  constexpr int NB = D / 8;   // 8-wide blocks of the output
  extern __shared__ __align__(128) uint8_t fm_smem[];
  T* Qs = reinterpret_cast<T*>(fm_smem);
  T* KV = Qs + FM_BQ * D;  // buffer b: K at KV + 2 b 64 D, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * FM_BQ;
  const size_t base = (size_t)bh * S * D;
  const int kv_row = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const T* kg = k + (size_t)kv_row * S * D;
  const T* vg = v + (size_t)kv_row * S * D;
  // causal: keys past the block's last query row are never visible
  const int kend = causal ? min(S, q0 + FM_BQ) : S;
  const int ntiles = (kend + FM_BK - 1) / FM_BK;

  cp_async_tile<T, D, FM_BQ, FM_THREADS>(Qs, q + base, q0, S);
  cp_async_tile<T, D, FM_BK, FM_THREADS>(KV, kg, 0, S);
  cp_async_tile<T, D, FM_BK, FM_THREADS>(KV + FM_BK * D, vg, 0, S);
  cp_async_commit();

  uint32_t qf[KC][4];
  float acc[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's partial sums
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which matrix, which row of it
  const int qrow = q0 + warp * 16 + g;      // rows qrow and qrow + 8

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      T* nxt = KV + ((j + 1) & 1) * 2 * FM_BK * D;
      cp_async_tile<T, D, FM_BK, FM_THREADS>(nxt, kg, (j + 1) * FM_BK, S);
      cp_async_tile<T, D, FM_BK, FM_THREADS>(nxt + FM_BK * D, vg, (j + 1) * FM_BK, S);
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
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(qf[kc], smem_u32(Qs + swz<D>(warp * 16 + mr + 8 * (mi & 1), 2 * kc + (mi >> 1))));
    }
    const T* Ks = KV + (j & 1) * 2 * FM_BK * D;
    const T* Vs = Ks + FM_BK * D;

    // S = Q K^T for 16 rows x 64 keys: s[nb] is key block nb
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7),
        // (keys 8-15, d 8-15) of key pair np: b0 b1 of blocks 2np and 2np+1
        uint32_t b[4];
        ldsm_x4(b, smem_u32(Ks + swz<D>(np * 16 + mr + 8 * (mi >> 1), 2 * kc + (mi & 1))));
        mma16816<T>(s[2 * np], qf[kc], b[0], b[1]);
        mma16816<T>(s[2 * np + 1], qf[kc], b[2], b[3]);
      }
    }

    // mask, scale, and the online softmax: s[nb][2 h + e] is row qrow + 8 h,
    // key j 64 + 8 nb + 2 t + e
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * FM_BK + nb * 8 + 2 * t + (e & 1);
        const bool valid = key < S && (!causal || key <= qrow + 8 * (e >> 1));
        s[nb][e] = valid ? s[nb][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    }
    float ml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);  // m starts at the finite kNegInf
      const float corr = exp2f((m[h] - mn) * FM_LOG2E);
      m[h] = mn;
      ml[h] = mn * FM_LOG2E;
      l[h] *= corr;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        acc[i][2 * h] *= corr;
        acc[i][2 * h + 1] *= corr;
      }
    }
    // P in registers: block nb's (row, key pair) values are the A fragment
    // of key chunk nb / 2 (a0 a1 from the even block, a2 a3 from the odd)
    uint32_t pf[4][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = exp2f(fmaf(s[nb][e], FM_LOG2E, -ml[e >> 1]));
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pf[nb >> 1][2 * (nb & 1)] = pack2<T>(p[0], p[1]);
      pf[nb >> 1][2 * (nb & 1) + 1] = pack2<T>(p[2], p[3]);
    }

    // O += P V: matrices (keys 0-7 | 8-15) x (d 0-7 | 8-15) of each 16-wide
    // d pair, transposed: b0 b1 of d blocks 2dp and 2dp+1
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dp = 0; dp < NB / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_u32(Vs + swz<D>(kc * 16 + mr + 8 * (mi & 1), 2 * dp + (mi >> 1))));
        mma16816<T>(acc[2 * dp], pf[kc], b[0], b[1]);
        mma16816<T>(acc[2 * dp + 1], pf[kc], b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = qrow + 8 * h;
    if (row >= S) continue;
    T* orow = o + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float v0 = l[h] > 0.f ? acc[i][2 * h] / l[h] : 0.f;
      const float v1 = l[h] > 0.f ? acc[i][2 * h + 1] / l[h] : 0.f;
      *reinterpret_cast<uint32_t*>(orow + 8 * i) = pack2<T>(v0, v1);
    }
    if constexpr (STATS) {
      if (t == 0) {
        m_out[(size_t)bh * S + row] = m[h];
        l_out[(size_t)bh * S + row] = l[h];
      }
    }
  }
}

template <typename T, int D, bool STATS>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* m, float* l, int BH,
               int S, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(D);
  const int err = ltt::allow_smem(flash_fwd_mma_kernel<T, D, STATS>, smem);
  if (err) return err;
  dim3 grid(BH, (S + FM_BQ - 1) / FM_BQ);
  flash_fwd_mma_kernel<T, D, STATS><<<grid, FM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m, l, S, Hq, Hkv, causal, scale);
  return ltt::launch_status();
}

enum Route { kRouteAuto = 0, kRouteFfma = 1, kRouteMma = 2 };

// the tensor-core route: bf16/f16, D 64 or 128, 16-byte-aligned tensors
template <typename T>
bool mma_fits(const void* q, const void* k, const void* v, const void* o, int D) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  return !std::is_same<T, float>::value && (D == 64 || D == 128) && any % 16 == 0;
}

// route: kRouteAuto takes the tensor cores where mma_fits, kRouteFfma the
// FFMA kernel, kRouteMma the tensor cores (an error where they do not fit);
// *taken gets the route that launched.
template <typename T, bool STATS>
int launch_d(const void* q, const void* k, const void* v, void* o, float* m, float* l, int BH,
             int S, int D, int Hq, int Hkv, int causal, float scale, int route, int* taken,
             cudaStream_t s) {
  const bool fits = mma_fits<T>(q, k, v, o, D);
  *taken = kRouteFfma;
  if (route == kRouteMma && !fits) return static_cast<int>(cudaErrorInvalidValue);
  if (fits && route != kRouteFfma) {
    *taken = kRouteMma;
    if constexpr (!std::is_same<T, float>::value) {
      if (D == 64) return launch_mma<T, 64, STATS>(q, k, v, o, m, l, BH, S, Hq, Hkv, causal, scale, s);
      return launch_mma<T, 128, STATS>(q, k, v, o, m, l, BH, S, Hq, Hkv, causal, scale, s);
    }
  }
  if (D <= 32) return launch<T, 1, STATS>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, s);
  if (D <= 64) return launch<T, 2, STATS>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, s);
  if (D <= 128) return launch<T, 4, STATS>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, s);
  return launch<T, 8, STATS>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, s);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, float* m, float* l, int BH,
             int S, int D, int Hq, int Hkv, int causal, float scale, int route, int* taken,
             cudaStream_t s) {
  if (m) return launch_d<T, true>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, route,
                                  taken, s);
  return launch_d<T, false>(q, k, v, o, m, l, BH, S, D, Hq, Hkv, causal, scale, route, taken, s);
}

}  // namespace

// q, o: (BH, S, D) and k, v: (BH / Hq * Hkv, S, D), contiguous in dtype,
// D <= 256, Hq a multiple of Hkv. m, l: (BH, S) fp32, or both null for the
// value-only forward (m alone decides the variant). route: 0 picks, 1 the
// FFMA kernel, 2 the tensor cores; *taken gets the route that launched.
LTT_API int ltt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                          int BH, int S, int D, int Hq, int Hkv, int causal, float scale,
                          int dtype, int route, int* taken, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  if (dtype == ltt::kF32)
    return launch_t<float>(q, k, v, o, mf, lf, BH, S, D, Hq, Hkv, causal, scale, route, taken,
                           s);
  if (dtype == ltt::kBF16)
    return launch_t<__nv_bfloat16>(q, k, v, o, mf, lf, BH, S, D, Hq, Hkv, causal, scale, route,
                                   taken, s);
  return launch_t<__half>(q, k, v, o, mf, lf, BH, S, D, Hq, Hkv, causal, scale, route, taken, s);
}
