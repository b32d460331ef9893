// Paged decode attention: one query token per slot over the slot's
// block-table pages.
//
// Replaces laser_tpu/ops/paged_attention.py:121 build_paged_attention (float
// pools, and int8 pools with per-token scales; no window).
//
// Layouts (as the TPU kernel): q (S, Hq, hd); pools (P, Hkv, ps, hd);
// tables (S, max_pages) int32; lengths (S,) int32; out (S, Hq, hd); with
// int8 pools also k_scale, v_scale (P, Hkv, ps) f32.
//
// Two routes. "split" (bf16/f16 q at hd 64 or 128, 16-byte-aligned q, pools
// and out) is the tensor-core skeleton of paged_split.cuh at W = 1, shared
// with the verify (ltt_paged_window_attention), so the two give the same
// bits there. "classic", the kernel below, takes the rest (f32 q, other
// head dims, unaligned operands), and route "classic" asks for it.
//
// What bounds it on the H100: each key and value row is read once and used
// for `group` = Hq / Hkv dot products, so decode attention is bound by the
// KV bytes streamed from HBM (8 slots x 16 heads x up to 1024 keys x 128 x
// 2 x 2 bytes = 64 MiB per layer at the serving slice's width; int8 pages
// stream a quarter of the f32 bytes, half of bf16, plus 4 bytes of scale per
// row).
//
// Classic design: one block per (slot, kv head), 4 warps. The Hq query heads fold
// to (Hkv, group) with consecutive q heads per kv head (paged_attention.py:161).
// The block reads its own table row and length (Hopper has no scalar
// prefetch). The slot's keys are cut into 32-key tiles spread round-robin
// over the warps, so the 4 warps stream different pages at once; each warp
// keeps its own online softmax (fp32 m, l, accumulator) and the block merges
// the four at the end. Keys at or past `length` are never read, so pages past
// the length are skipped and garbage rows left by a padded prefill are never
// attended; `length == 0` writes zeros. Scores: lane = key; P.V: lane =
// head-dim column, with P broadcast by shuffle and rounded to the q dtype
// first, as the TPU kernel does. Pool offsets are 64-bit.
//
// int8 pools (a compile-time variant, KT = int8_t) follow the TPU kernel's
// order (paged_attention.py:162-214): the int8 row converts exactly to fp32,
// s = (q.k) * scale * k_scale[token], l sums p BEFORE p *= v_scale[token],
// then p rounds to the q dtype (a no-op for f32, JAX's "base" tier) and
// enters the P.V product. The scales are never folded into the rows.
#include <type_traits>

#include "common.cuh"
#include "paged_split.cuh"

namespace {

using ltt::from_f32;
using ltt::kNegInf;
using ltt::to_f32;

constexpr int PA_WARPS = 4;
constexpr int PA_THREADS = PA_WARPS * 32;
constexpr int PA_MAXG = 8;  // query heads per kv head

// KT: the pool element type, T or int8_t (then k_scale, v_scale are read)
template <typename T, typename KT, int DC>
__global__ void __launch_bounds__(PA_THREADS)
    paged_attention_kernel(const T* __restrict__ q, const KT* __restrict__ k_pool,
                           const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, const int* __restrict__ tables,
                           const int* __restrict__ lengths, T* __restrict__ out, int Hq,
                           int Hkv, int ps, int hd, int max_pages, float scale) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
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
    float ks = 1.f, vs = 1.f;  // this lane's token scales (int8 pools)
    if (valid) {
      const size_t row = ((size_t)table[pos / ps] * Hkv + h) * ps + pos % ps;
      const KT* kr = k_pool + row * hd;
      for (int d = 0; d < hd; ++d) {
        const float kd = to_f32(kr[d]);
#pragma unroll
        for (int g = 0; g < PA_MAXG; ++g)
          if (g < G) s[g] = fmaf(qs[g][d], kd, s[g]);
      }
      if constexpr (QUANT) {
        ks = k_scale[row];
        vs = v_scale[row];
      }
    }
    float p[PA_MAXG];
#pragma unroll
    for (int g = 0; g < PA_MAXG; ++g) {
      p[g] = 0.f;
      if (g < G) {
        float sv = s[g] * scale;
        if constexpr (QUANT) sv *= ks;
        sv = valid ? sv : kNegInf;
        const float m_new = fmaxf(m[g], ltt::warp_max(sv));
        const float corr = expf(m[g] - m_new);
        const float pv = valid ? expf(sv - m_new) : 0.f;
        l[g] = l[g] * corr + ltt::warp_sum(pv);
        m[g] = m_new;
        p[g] = ltt::round_through<T>(QUANT ? pv * vs : pv);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[g][c] *= corr;
      }
    }
    const int nvalid = min(32, length - t * 32);
    for (int j = 0; j < nvalid; ++j) {
      const int pj_pos = t * 32 + j;
      const size_t page = (size_t)table[pj_pos / ps];
      const KT* vr = v_pool + ((page * Hkv + h) * ps + pj_pos % ps) * hd;
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

template <typename T, typename KT, int DC>
void launch(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
            const int* tables, const int* lengths, void* out, int S, int Hq, int Hkv, int ps,
            int hd, int max_pages, float scale, cudaStream_t s) {
  dim3 grid(S, Hkv);
  paged_attention_kernel<T, KT, DC><<<grid, PA_THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const KT*>(kp), static_cast<const KT*>(vp), ks, vs,
      tables, lengths, static_cast<T*>(out), Hq, Hkv, ps, hd, max_pages, scale);
}

template <typename T, typename KT>
void launch_d(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
              const int* tables, const int* lengths, void* out, int S, int Hq, int Hkv, int ps,
              int hd, int max_pages, float scale, cudaStream_t s) {
  if (hd <= 32)
    launch<T, KT, 1>(q, kp, vp, ks, vs, tables, lengths, out, S, Hq, Hkv, ps, hd, max_pages,
                     scale, s);
  else if (hd <= 64)
    launch<T, KT, 2>(q, kp, vp, ks, vs, tables, lengths, out, S, Hq, Hkv, ps, hd, max_pages,
                     scale, s);
  else if (hd <= 128)
    launch<T, KT, 4>(q, kp, vp, ks, vs, tables, lengths, out, S, Hq, Hkv, ps, hd, max_pages,
                     scale, s);
  else
    launch<T, KT, 8>(q, kp, vp, ks, vs, tables, lengths, out, S, Hq, Hkv, ps, hd, max_pages,
                     scale, s);
}

// the pool is either q's dtype or int8
template <typename T>
void launch_pool(const void* q, const void* kp, const void* vp, const float* ks,
                 const float* vs, const int* tables, const int* lengths, void* out, int S,
                 int Hq, int Hkv, int ps, int hd, int max_pages, float scale, int pool_dtype,
                 cudaStream_t s) {
  if (pool_dtype == ltt::kI8)
    launch_d<T, int8_t>(q, kp, vp, ks, vs, tables, lengths, out, S, Hq, Hkv, ps, hd, max_pages,
                        scale, s);
  else
    launch_d<T, T>(q, kp, vp, ks, vs, tables, lengths, out, S, Hq, Hkv, ps, hd, max_pages,
                   scale, s);
}

}  // namespace

// q (S, Hq, hd); k_pool, v_pool (P, Hkv, ps, hd) in q's dtype, or int8 with
// k_scale, v_scale (P, Hkv, ps) f32 (null for float pools); tables
// (S, max_pages) int32; lengths (S,) int32; out (S, Hq, hd). hd <= 256,
// Hq / Hkv <= 8. workspace: ltt_paged_workspace's bytes of fp32 scratch
// (null where it says 0). route: 0 picks, 1 the classic kernel, 2 the split
// kernel (an error where it does not fit); *taken gets the route that
// launched.
LTT_API int ltt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                const void* k_scale, const void* v_scale, const void* tables,
                                const void* lengths, void* out, void* workspace, int S, int Hq,
                                int Hkv, int ps, int hd, int max_pages, float scale, int dtype,
                                int pool_dtype, int route, int* taken, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r =
      ltt::ps_route(route, ltt::ps_fits(dtype, hd, 1, Hq, Hkv, q, k_pool, v_pool, out));
  if (r < 0) return static_cast<int>(cudaErrorInvalidValue);
  *taken = r;
  if (r == ltt::kPagedSplit) {
    const PsArgs a{q, k_pool, v_pool, ks, vs, t, l, out, static_cast<float*>(workspace),
                   S, 1, Hq, Hkv, ps, hd, max_pages, scale};
    return ltt::paged_split(a, dtype, pool_dtype, s);
  }
  if (dtype == ltt::kF32)
    launch_pool<float>(q, k_pool, v_pool, ks, vs, t, l, out, S, Hq, Hkv, ps, hd, max_pages,
                       scale, pool_dtype, s);
  else if (dtype == ltt::kBF16)
    launch_pool<__nv_bfloat16>(q, k_pool, v_pool, ks, vs, t, l, out, S, Hq, Hkv, ps, hd,
                               max_pages, scale, pool_dtype, s);
  else
    launch_pool<__half>(q, k_pool, v_pool, ks, vs, t, l, out, S, Hq, Hkv, ps, hd, max_pages,
                        scale, pool_dtype, s);
  return ltt::launch_status();
}

// The bytes of workspace a decode (W = 1) or verify call with these
// operands and route needs (the split kernel's fp32 partials past one key
// chunk; else 0), in *bytes; returns an error where the route asked for does
// not fit.
LTT_API int ltt_paged_workspace(const void* q, const void* k_pool, const void* v_pool, int S,
                                int W, int Hq, int Hkv, int ps, int hd, int max_pages,
                                int dtype, int route, long long* bytes) {
  const int r =
      ltt::ps_route(route, ltt::ps_fits(dtype, hd, W, Hq, Hkv, q, k_pool, v_pool, nullptr));
  *bytes = r == ltt::kPagedSplit ? ltt::ps_workspace_bytes(S, W, Hq, Hkv, ps, hd, max_pages) : 0;
  return r < 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}
