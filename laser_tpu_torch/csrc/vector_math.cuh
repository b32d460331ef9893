// exp / log / tanh / sigmoid as __device__ functions, in two tiers, for the
// elementwise bodies that ops/codegen.py emits into csrc/foreach.cuh.
//
// The accurate tier is laser_tpu's polynomial cores
// (laser_tpu/ops/vector_math.py: _exp_expr :57-89, _log_expr :101-127,
// _tanh_expr :130-136, _sigmoid_expr :139-143), op for op:
// - every f32 add, multiply and divide is an explicitly rounded intrinsic
//   (__fadd_rn, __fmul_rn, __fdiv_rn), so nvcc contracts nothing into an
//   FMA and the result equals the plain PyTorch version
//   (laser_tpu_torch/ops/vector_math.py, _exp_poly and friends) bit for bit;
// - exp and log run in f32 and the caller rounds once to the output type,
//   as laser_tpu casts once at the end; tanh and sigmoid are templates on
//   the storage type T and round every step to T, as laser_tpu's jnp block
//   math does for a bf16 or f16 block (R<T> is the identity for float).
// The clamp to +-88 keeps NaN (jnp.clip does), so NaN propagates; +inf
// gives exp(88) and -inf gives exp(-88) = 0 after single-factor exponent
// stuffing (0 exactly below ln(2^-126) = -87.34, where the result would be
// subnormal). laser_tpu measured these cores within 7.9e-8 (exp) of
// float64 over +-88; the port's tests hold them to 1e-6.
//
// The fast tier is CUDA's own (CUDA C++ Programming Guide, mathematical
// functions appendix, maximum errors):
// - exp_fast: __expf, 2 + floor(|1.173 x|) ulp (x = 88: 105 ulp, 1.3e-5);
// - log_fast: __logf, 2^-21.41 absolute on [0.5, 2], 3 ulp elsewhere;
// - tanh_fast: tanhf, 2 ulp;
// - sigmoid_fast: __fdividef(1, 1 + __expf(-x)), __expf's error plus 2 ulp.
#pragma once

#include "common.cuh"

namespace ltt {
namespace vm {

template <typename T> __device__ __forceinline__ float R(float x) { return round_through<T>(x); }

// clamp that keeps NaN, as jnp.clip and torch.clamp
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// laser_tpu/ops/vector_math.py:57 _exp_expr
__device__ __forceinline__ float exp_acc(float x) {
  const float xc = clamp_nan(x, -88.f, 88.f);
  const float n = rintf(__fmul_rn(xc, 1.4426950408889634f));
  float r = __fsub_rn(xc, __fmul_rn(n, 0.693359375f));
  r = __fsub_rn(r, __fmul_rn(n, -2.12194440e-4f));
  float p = 1.9875691500e-4f;
  p = __fadd_rn(__fmul_rn(p, r), 1.3981999507e-3f);
  p = __fadd_rn(__fmul_rn(p, r), 8.3334519073e-3f);
  p = __fadd_rn(__fmul_rn(p, r), 4.1665795894e-2f);
  p = __fadd_rn(__fmul_rn(p, r), 1.6666665459e-1f);
  p = __fadd_rn(__fmul_rn(p, r), 5.0000001201e-1f);
  p = __fadd_rn(__fadd_rn(__fmul_rn(p, __fmul_rn(r, r)), r), 1.f);
  const int ni = isnan(n) ? 0 : static_cast<int>(n);  // NaN: p is NaN already
  const float s = __int_as_float(max(ni + 127, 0) << 23);
  return __fmul_rn(p, s);
}

// laser_tpu/ops/vector_math.py:101 _log_expr
__device__ __forceinline__ float log_acc(float x) {
  const int bits = __float_as_int(x);
  // re-centre the exponent so the mantissa lands in [sqrt(1/2), sqrt(2));
  // 0x3f3504f3 is sqrt(2)/2. Unsigned, so a wrap is defined (as in jnp).
  const int shifted = static_cast<int>(static_cast<unsigned>(bits) + (0x3F800000u - 0x3F3504F3u));
  const float k = static_cast<float>((shifted >> 23) - 127);
  const float m = __int_as_float((shifted & 0x007FFFFF) + 0x3F3504F3);
  const float f = __fsub_rn(m, 1.f);
  const float s = __fdiv_rn(f, __fadd_rn(2.f, f));
  const float z = __fmul_rn(s, s);
  const float w = __fmul_rn(z, z);
  const float t1 = __fmul_rn(w, __fadd_rn(0.40000972152f, __fmul_rn(w, 0.24279078841f)));
  const float t2 = __fmul_rn(z, __fadd_rn(0.66666662693f, __fmul_rn(w, 0.28498786688f)));
  const float r = __fadd_rn(t2, t1);
  const float hfsq = __fmul_rn(__fmul_rn(0.5f, f), f);
  const float inner = __fsub_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(s, __fadd_rn(hfsq, r)), __fmul_rn(k, -2.12194440e-4f)), f),
      hfsq);
  float res = __fadd_rn(__fmul_rn(k, 0.693359375f), inner);
  if (x == 0.f) res = -INFINITY;
  if (x < 0.f) res = NAN;
  if (isinf(x) && x > 0.f) res = INFINITY;
  if (isnan(x)) res = NAN;
  return res;
}

// laser_tpu/ops/vector_math.py:130 _tanh_expr, every step rounded to T
template <typename T> __device__ __forceinline__ float tanh_acc(float x) {
  const float a = fabsf(x);
  const float a2 = R<T>(__fmul_rn(2.f, a));
  const float e = R<T>(exp_acc(isnan(a2) ? a2 : fminf(a2, 40.f)));
  const float t = R<T>(__fsub_rn(1.f, R<T>(__fdiv_rn(2.f, R<T>(__fadd_rn(e, 1.f))))));
  const float sg = x > 0.f ? 1.f : (x < 0.f ? -1.f : x);  // jnp.sign: NaN and 0 kept
  return R<T>(__fmul_rn(sg, t));
}

// laser_tpu/ops/vector_math.py:139 _sigmoid_expr, every step rounded to T
template <typename T> __device__ __forceinline__ float sigmoid_acc(float x) {
  const float e = R<T>(exp_acc(-fabsf(x)));
  const float pos = R<T>(__fdiv_rn(1.f, R<T>(__fadd_rn(1.f, e))));
  return x >= 0.f ? pos : R<T>(__fsub_rn(1.f, pos));
}

__device__ __forceinline__ float exp_fast(float x) { return __expf(x); }
__device__ __forceinline__ float log_fast(float x) { return __logf(x); }
__device__ __forceinline__ float tanh_fast(float x) { return tanhf(x); }
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

}  // namespace vm
}  // namespace ltt
