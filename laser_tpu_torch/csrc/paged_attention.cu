// Paged decode attention: one query token per slot over the slot's
// block-table pages.
//
// Replaces laser_tpu/ops/paged_attention.py:121 build_paged_attention (float
// pools, no window).
//
// Layouts (as the TPU kernel): q (S, Hq, hd); pools (P, Hkv, ps, hd);
// tables (S, max_pages) int32; lengths (S,) int32; out (S, Hq, hd).
//
// What bounds it on the H100: each key and value row is read once and used
// for `group` = Hq / Hkv dot products, so decode attention is bound by the
// KV bytes streamed from HBM (8 slots x 16 heads x up to 1024 keys x 128 x
// 2 x 2 bytes = 64 MiB per layer at the slice's full width).
//
// Design: one block per (slot, kv head), 4 warps. The Hq query heads fold
// to (Hkv, group) with consecutive q heads per kv head (paged_attention.py:161).
// The block reads its own table row and length (Hopper has no scalar
// prefetch). The slot's keys are cut into 32-key tiles spread round-robin
// over the warps, so the 4 warps stream different pages at once; each warp
// keeps its own online softmax (fp32 m, l, accumulator) and the block merges
// the four at the end. Keys at or past `length` are never read, so pages past
// the length are skipped and garbage rows left by a padded prefill are never
// attended; `length == 0` writes zeros. Scores: lane = key; P.V: lane =
// head-dim column, with P broadcast by shuffle and rounded to the pool dtype
// first, as the TPU kernel does. Pool offsets are 64-bit.
#include "common.cuh"

namespace {

using ltt::from_f32;
using ltt::kNegInf;
using ltt::to_f32;

constexpr int PA_WARPS = 4;
constexpr int PA_THREADS = PA_WARPS * 32;
constexpr int PA_MAXG = 8;  // query heads per kv head

template <typename T, int DC>
__global__ void __launch_bounds__(PA_THREADS)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool, const int* __restrict__ tables,
                           const int* __restrict__ lengths, T* __restrict__ out, int Hq,
                           int Hkv, int ps, int hd, int max_pages, float scale) {
  constexpr int DP = DC * 32;
  __shared__ float qs[PA_MAXG][DP];
  __shared__ float ms[PA_WARPS][PA_MAXG];
  __shared__ float ls[PA_WARPS][PA_MAXG];
  __shared__ float accs[PA_WARPS][PA_MAXG][DP];

  const int slot = blockIdx.x;
  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* table = tables + (size_t)slot * max_pages;
  // a table row addresses at most max_pages * ps keys
  const int length = min(lengths[slot], max_pages * ps);

  for (int i = tid; i < G * DP; i += PA_THREADS) {
    const int g = i / DP, d = i % DP;
    qs[g][d] = d < hd ? to_f32(q[((size_t)slot * Hq + h * G + g) * hd + d]) : 0.f;
  }
  __syncthreads();

  float m[PA_MAXG], l[PA_MAXG], acc[PA_MAXG][DC];
#pragma unroll
  for (int g = 0; g < PA_MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[g][c] = 0.f;
  }

  const int ntiles = (length + 31) / 32;
  for (int t = warp; t < ntiles; t += PA_WARPS) {
    const int pos = t * 32 + lane;
    const bool valid = pos < length;
    float s[PA_MAXG];
#pragma unroll
    for (int g = 0; g < PA_MAXG; ++g) s[g] = 0.f;
    if (valid) {
      const size_t page = (size_t)table[pos / ps];
      const T* kr = k_pool + ((page * Hkv + h) * ps + pos % ps) * hd;
      for (int d = 0; d < hd; ++d) {
        const float kd = to_f32(kr[d]);
#pragma unroll
        for (int g = 0; g < PA_MAXG; ++g)
          if (g < G) s[g] = fmaf(qs[g][d], kd, s[g]);
      }
    }
    float p[PA_MAXG];
#pragma unroll
    for (int g = 0; g < PA_MAXG; ++g) {
      p[g] = 0.f;
      if (g < G) {
        const float sv = valid ? s[g] * scale : kNegInf;
        const float m_new = fmaxf(m[g], ltt::warp_max(sv));
        const float corr = expf(m[g] - m_new);
        const float pv = valid ? expf(sv - m_new) : 0.f;
        l[g] = l[g] * corr + ltt::warp_sum(pv);
        m[g] = m_new;
        p[g] = ltt::round_through<T>(pv);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[g][c] *= corr;
      }
    }
    const int nvalid = min(32, length - t * 32);
    for (int j = 0; j < nvalid; ++j) {
      const int pj_pos = t * 32 + j;
      const size_t page = (size_t)table[pj_pos / ps];
      const T* vr = v_pool + ((page * Hkv + h) * ps + pj_pos % ps) * hd;
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < hd ? to_f32(vr[d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < PA_MAXG; ++g) {
        if (g < G) {
          const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[g][c] = fmaf(pj, vv[c], acc[g][c]);
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < PA_MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        ms[warp][g] = m[g];
        ls[warp][g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) accs[warp][g][lane + 32 * c] = acc[g][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += PA_THREADS) {
    const int g = i / hd, d = i % hd;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) mx = fmaxf(mx, ms[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) {
      const float f = expf(ms[w][g] - mx);
      L += ls[w][g] * f;
      A += accs[w][g][d] * f;
    }
    out[((size_t)slot * Hq + h * G + g) * hd + d] = from_f32<T>(L > 0.f ? A / L : 0.f);
  }
}

template <typename T, int DC>
void launch(const void* q, const void* kp, const void* vp, const int* tables, const int* lengths,
            void* out, int S, int Hq, int Hkv, int ps, int hd, int max_pages, float scale,
            cudaStream_t s) {
  dim3 grid(S, Hkv);
  paged_attention_kernel<T, DC><<<grid, PA_THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      lengths, static_cast<T*>(out), Hq, Hkv, ps, hd, max_pages, scale);
}

template <typename T>
void launch_d(const void* q, const void* kp, const void* vp, const int* tables,
              const int* lengths, void* out, int S, int Hq, int Hkv, int ps, int hd,
              int max_pages, float scale, cudaStream_t s) {
  if (hd <= 32)
    launch<T, 1>(q, kp, vp, tables, lengths, out, S, Hq, Hkv, ps, hd, max_pages, scale, s);
  else if (hd <= 64)
    launch<T, 2>(q, kp, vp, tables, lengths, out, S, Hq, Hkv, ps, hd, max_pages, scale, s);
  else if (hd <= 128)
    launch<T, 4>(q, kp, vp, tables, lengths, out, S, Hq, Hkv, ps, hd, max_pages, scale, s);
  else
    launch<T, 8>(q, kp, vp, tables, lengths, out, S, Hq, Hkv, ps, hd, max_pages, scale, s);
}

}  // namespace

// q (S, Hq, hd); k_pool, v_pool (P, Hkv, ps, hd); tables (S, max_pages) int32;
// lengths (S,) int32; out (S, Hq, hd). hd <= 256, Hq / Hkv <= 8.
LTT_API int ltt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                const void* tables, const void* lengths, void* out, int S,
                                int Hq, int Hkv, int ps, int hd, int max_pages, float scale,
                                int dtype, void* stream) {
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32)
    launch_d<float>(q, k_pool, v_pool, t, l, out, S, Hq, Hkv, ps, hd, max_pages, scale, s);
  else if (dtype == ltt::kBF16)
    launch_d<__nv_bfloat16>(q, k_pool, v_pool, t, l, out, S, Hq, Hkv, ps, hd, max_pages, scale,
                            s);
  else
    launch_d<__half>(q, k_pool, v_pool, t, l, out, S, Hq, Hkv, ps, hd, max_pages, scale, s);
  return ltt::launch_status();
}
