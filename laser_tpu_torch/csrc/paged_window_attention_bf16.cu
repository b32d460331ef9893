// Paged window attention: the bf16 instances (see paged_window_attention.cuh).
#include "paged_window_attention.cuh"

int ltt::paged_window_bf16(const PwArgs& a, int pool_dtype, cudaStream_t s) {
  return launch_pool<__nv_bfloat16>(a, pool_dtype, s);
}
