// Paged attention's split route: the f16 instances (see paged_split.cuh).
#include "paged_split.cuh"

int ltt::paged_split_f16(const PsArgs& a, int pool_dtype, cudaStream_t s) {
  return ps_launch<__half>(a, pool_dtype, s);
}
