// Paged attention's split route: the bf16 instances (see paged_split.cuh).
#include "paged_split.cuh"

int ltt::paged_split_bf16(const PsArgs& a, int pool_dtype, cudaStream_t s) {
  return ps_launch<__nv_bfloat16>(a, pool_dtype, s);
}
