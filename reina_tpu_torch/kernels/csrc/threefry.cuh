// jax.random's threefry2x32 and the floats made from its bits, for one
// element at a time: shared by the draw kernel (threefry.cu) and the
// samplers (samplers.cu).
//
// Element k of a draw hashes the counter pair (0, k) of the flattened
// shape under the key's two words, and its 32 bits are the two output
// words xored (jax_threefry_partitionable). The floats follow
// reina_tpu_torch/ops/prng.py op for op, each product and sum rounded on
// its own (__fmul_rn, __fadd_rn: nvcc never contracts them into an FMA,
// which the twin's separate ops do not do), with the CUDA math functions
// that torch's elementwise kernels call (logf, log1pf, sqrtf), and the
// float32 values of the twin's Python scalars.
#pragma once

#include <math.h>
#include <stdint.h>

namespace reina_rng {

struct Key {
  uint32_t k1, k2;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 of the counter pair (0, ctr) under key, the two words
// xored: 20 rounds of add, rotate and xor, and a key injection every 4
__device__ __forceinline__ uint32_t bits(Key key, uint32_t ctr) {
  const uint32_t ks0 = key.k1, ks1 = key.k2,
                 ks2 = key.k1 ^ key.k2 ^ 0x1BD11BDAu;
  uint32_t x0 = ks0, x1 = ctr + ks1;
#define REINA_ROUND(r) \
  x0 += x1;            \
  x1 = rotl(x1, r);    \
  x1 ^= x0;
#define REINA_EVEN REINA_ROUND(13) REINA_ROUND(15) REINA_ROUND(26) REINA_ROUND(6)
#define REINA_ODD REINA_ROUND(17) REINA_ROUND(29) REINA_ROUND(16) REINA_ROUND(24)
  REINA_EVEN x0 += ks1; x1 += ks2 + 1u;
  REINA_ODD  x0 += ks2; x1 += ks0 + 2u;
  REINA_EVEN x0 += ks0; x1 += ks1 + 3u;
  REINA_ODD  x0 += ks1; x1 += ks2 + 4u;
  REINA_EVEN x0 += ks2; x1 += ks0 + 5u;
#undef REINA_EVEN
#undef REINA_ODD
#undef REINA_ROUND
  return x0 ^ x1;
}

// torch.clamp_min / clamp_max / minimum on CUDA: NaN propagates (fminf
// and fmaxf alone would drop it)
__device__ __forceinline__ float clamp_min(float x, float m) {
  return isnan(x) ? x : fmaxf(x, m);
}
__device__ __forceinline__ float clamp_max(float x, float m) {
  return isnan(x) ? x : fminf(x, m);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}

// uniform in [lo, lo + scale): the mantissa of [1, 2) filled with the
// top 23 bits, less 1, times scale, plus lo, then clamp_min(·, lo)
// (prng.uniform_twin; lo and scale are the twin's float32 values)
__device__ __forceinline__ float uniform(uint32_t b, float lo, float scale) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  return clamp_min(__fadd_rn(__fmul_rn(f, scale), lo), lo);
}

// XLA's single-precision erf_inv in prng.erf_inv's order: two degree-8
// polynomials in w = -log1p(-x²), split at w = 5
__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  // prng._ERFINV_LT5 and prng._ERFINV_GE5
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = __fadd_rn(lt ? 3.43273939e-07f : 0.000100950558f, __fmul_rn(p, w));
  p = __fadd_rn(lt ? -3.5233877e-06f : 0.00134934322f, __fmul_rn(p, w));
  p = __fadd_rn(lt ? -4.39150654e-06f : -0.00367342844f, __fmul_rn(p, w));
  p = __fadd_rn(lt ? 0.00021858087f : 0.00573950773f, __fmul_rn(p, w));
  p = __fadd_rn(lt ? -0.00125372503f : -0.0076224613f, __fmul_rn(p, w));
  p = __fadd_rn(lt ? -0.00417768164f : 0.00943887047f, __fmul_rn(p, w));
  p = __fadd_rn(lt ? 0.246640727f : 1.00167406f, __fmul_rn(p, w));
  p = __fadd_rn(lt ? 1.50140941f : 2.83297682f, __fmul_rn(p, w));
  return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
}

// prng.normal_twin: erf_inv of a uniform on [lo, 1) times float32 √2
// (lo = prng._NORMAL_LO and scale = 1 - lo as the twin rounds them)
__device__ __forceinline__ float normal(uint32_t b, float lo, float scale) {
  return __fmul_rn(erf_inv(uniform(b, lo, scale)), 1.41421354f);
}

}  // namespace reina_rng
