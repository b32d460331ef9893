// Paged window attention (the speculative verify): the f32 instances and the
// C entry point. The kernel and its design note are in
// paged_window_attention.cuh; the bf16 and f16 instances are compiled from
// paged_window_attention_bf16.cu and paged_window_attention_f16.cu. That
// kernel is route "classic" (f32 q, other head dims, unaligned operands, and
// what route="classic" asks for); bf16/f16 at hd 64 or 128 take the split
// kernel of paged_split.cuh, the decode's skeleton at W queries.
#include "paged_split.cuh"
#include "paged_window_attention.cuh"

int ltt::paged_window_f32(const PwArgs& a, int pool_dtype, cudaStream_t s) {
  return launch_pool<float>(a, pool_dtype, s);
}

// q (S, W, Hq, hd); k_pool, v_pool (P, Hkv, ps, hd) in q's dtype, or int8
// with k_scale, v_scale (P, Hkv, ps) f32 (null for float pools); tables
// (S, max_pages) int32; lengths (S,) int32; out (S, W, Hq, hd). hd <= 256,
// W * (Hq / Hkv) <= 64. workspace: ltt_paged_workspace's bytes of fp32
// scratch (null where it says 0). route: 0 picks, 1 the classic kernel, 2
// the split kernel of paged_split.cuh (bf16/f16 at hd 64 or 128, 16-byte
// aligned; an error where it does not fit); *taken gets the route that
// launched.
LTT_API int ltt_paged_window_attention(const void* q, const void* k_pool, const void* v_pool,
                                       const void* k_scale, const void* v_scale,
                                       const void* tables, const void* lengths, void* out,
                                       void* workspace, int S, int W, int Hq, int Hkv, int ps,
                                       int hd, int max_pages, float scale, int dtype,
                                       int pool_dtype, int route, int* taken, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r =
      ltt::ps_route(route, ltt::ps_fits(dtype, hd, W, Hq, Hkv, q, k_pool, v_pool, out));
  if (r < 0) return static_cast<int>(cudaErrorInvalidValue);
  *taken = r;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lengths);
  if (r == ltt::kPagedSplit) {
    const PsArgs a{q, k_pool, v_pool, ks, vs, t, l, out, static_cast<float*>(workspace),
                   S, W, Hq, Hkv, ps, hd, max_pages, scale};
    return ltt::paged_split(a, dtype, pool_dtype, s);
  }
  const PwArgs a{q, k_pool, v_pool, ks, vs, t, l, out, S, W, Hq, Hkv, ps, hd, max_pages, scale};
  if (dtype == ltt::kF32) return ltt::paged_window_f32(a, pool_dtype, s);
  if (dtype == ltt::kBF16) return ltt::paged_window_bf16(a, pool_dtype, s);
  return ltt::paged_window_f16(a, pool_dtype, s);
}
