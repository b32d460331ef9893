// Paged window attention: the f16 instances (see paged_window_attention.cuh).
#include "paged_window_attention.cuh"

int ltt::paged_window_f16(const PwArgs& a, int pool_dtype, cudaStream_t s) {
  return launch_pool<__half>(a, pool_dtype, s);
}
