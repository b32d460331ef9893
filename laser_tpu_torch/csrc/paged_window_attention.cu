// Paged window attention (the speculative verify): the f32 instances and the
// C entry point. The kernel and its design note are in
// paged_window_attention.cuh; the bf16 and f16 instances are compiled from
// paged_window_attention_bf16.cu and paged_window_attention_f16.cu.
#include "paged_window_attention.cuh"

int ltt::paged_window_f32(const PwArgs& a, int pool_dtype, cudaStream_t s) {
  return launch_pool<float>(a, pool_dtype, s);
}

// q (S, W, Hq, hd); k_pool, v_pool (P, Hkv, ps, hd) in q's dtype, or int8
// with k_scale, v_scale (P, Hkv, ps) f32 (null for float pools); tables
// (S, max_pages) int32; lengths (S,) int32; out (S, W, Hq, hd). hd <= 256,
// W * (Hq / Hkv) <= 64.
LTT_API int ltt_paged_window_attention(const void* q, const void* k_pool, const void* v_pool,
                                       const void* k_scale, const void* v_scale,
                                       const void* tables, const void* lengths, void* out,
                                       int S, int W, int Hq, int Hkv, int ps, int hd,
                                       int max_pages, float scale, int dtype, int pool_dtype,
                                       void* stream) {
  const PwArgs a{q,
                 k_pool,
                 v_pool,
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int*>(tables),
                 static_cast<const int*>(lengths),
                 out,
                 S, W, Hq, Hkv, ps, hd, max_pages,
                 scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32) return ltt::paged_window_f32(a, pool_dtype, s);
  if (dtype == ltt::kBF16) return ltt::paged_window_bf16(a, pool_dtype, s);
  return ltt::paged_window_f16(a, pool_dtype, s);
}
