// The day's fixed-round samplers, one launch a call: gamma_fixed
// (Marsaglia-Tsang, 4 rounds) and binomial_fixed (CDF inversion over 48
// steps for n·p <= 10, BTRS with 6 rounds above, p > 0.5 by flipping).
//
// Replaces the code XLA compiles for the reference's samplers,
// reina_tpu/ops/random.py:gamma_fixed (:29-59) and binomial_fixed
// (:62-173), whose rounds run under lax.scan; they have no Pallas
// counterpart. The plain twins are reina_tpu_torch/ops/random.py:
// gamma_fixed_twin and binomial_fixed_twin, which run every round and
// both branches on every lane as eager ops (~1,500 and ~3,200 launches a
// call with their draws).
//
// What bounds it on the card: integer operations, the hashes of the
// lanes' draws (~72 INT32 operations each: one a lane for the
// inversion, two a round for BTRS and for gamma); the float arithmetic
// is a few dozen operations a round. The design:
//
//   * one thread a lane; each draw of a round is the threefry hash of
//     the lane's flat index under that round's key (threefry.cuh), so a
//     lane draws exactly the numbers the twin's whole-array draws give
//     it;
//   * the keys are split on the host as the twin splits them (13 for
//     binomial_fixed, 8 for gamma_fixed) and passed by value, or, for a
//     captured day step (CUDA graphs), read at launch from the day's key
//     table in device memory and staged in shared memory (the *_dev
//     kernels), so that a replay draws with the day's keys;
//   * a lane computes only the branch that the twin's
//     where(small_m, small, big) keeps, and stops at the round or step
//     where it settles. Both are exact: skipping a round shifts no
//     other draw, and once a lane is settled or done the twin never
//     changes its value again;
//   * every product, quotient and sum is rounded on its own as in the
//     twin (__fmul_rn, __fdiv_rn, __fadd_rn: no FMA contraction); a
//     scalar divided by a tensor is the tensor's reciprocal times the
//     scalar, as torch computes `s / t`; selections propagate NaN as
//     torch.minimum and clamp do.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using reina_rng::Key;
using reina_rng::clamp_max;
using reina_rng::clamp_min;
using reina_rng::minimum;

constexpr int THREADS = 128;
constexpr int MAX_ROUNDS = 8;
constexpr int MAX_COUNT = 48;  // the inversion's horizon

// the float32 affines of the twin's uniforms (prng.affine)
struct Affines {
  float unit_lo, unit_scale;    // [0, 1)
  float tiny_lo, tiny_scale;    // [1e-37, 1)
  float normal_lo, normal_scale;  // [_NORMAL_LO, 1), for normal draws
};

struct GammaKeys {
  Key x[MAX_ROUNDS], u[MAX_ROUNDS];  // each round's split(k) = (kx, ku)
};

struct BinomialKeys {
  Key inv;                           // split(key)[0]
  Key u[MAX_ROUNDS], v[MAX_ROUNDS];  // split(split(key)[1], rounds)[r]
};

__device__ __forceinline__ float cube(float x) {
  return __fmul_rn(x, __fmul_rn(x, x));
}

// s / t as torch computes a Python scalar over a tensor:
// t.reciprocal() * s
__device__ __forceinline__ float rdiv(float s, float t) {
  return __fmul_rn(__fdiv_rn(1.0f, t), s);
}

// a key struct's words copied from device memory into shared memory by
// the block, before any lane returns
template <typename K>
__device__ __forceinline__ void stage_keys(K& dst, const K* src) {
  static_assert(sizeof(K) % sizeof(unsigned) == 0, "keys are words");
  const unsigned* s = reinterpret_cast<const unsigned*>(src);
  unsigned* d = reinterpret_cast<unsigned*>(&dst);
  for (int j = threadIdx.x; j < (int)(sizeof(K) / sizeof(unsigned));
       j += blockDim.x)
    d[j] = s[j];
  __syncthreads();
}

__device__ __forceinline__ void gamma_lane(float* __restrict__ out,
                                           long long n, const GammaKeys& keys,
                                           int rounds, float d, float c,
                                           float kappa, const Affines& af) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t ctr = (uint32_t)i;
  float res = kappa;  // lanes that never accept take kappa
  for (int r = 0; r < rounds; ++r) {
    const float x = reina_rng::normal(reina_rng::bits(keys.x[r], ctr),
                                      af.normal_lo, af.normal_scale);
    const float v = cube(__fadd_rn(1.0f, __fmul_rn(c, x)));
    if (!(v > 0.0f)) continue;
    const float u = reina_rng::uniform(reina_rng::bits(keys.u[r], ctr),
                                       af.tiny_lo, af.tiny_scale);
    // 0.5 * x * x + d - d * v + d * log(clamp_min(v, 1e-37))
    float rhs = __fadd_rn(__fmul_rn(__fmul_rn(0.5f, x), x), d);
    rhs = __fsub_rn(rhs, __fmul_rn(d, v));
    rhs = __fadd_rn(rhs, __fmul_rn(d, logf(clamp_min(v, 1e-37f))));
    if (logf(u) < rhs) {
      res = __fmul_rn(d, v);
      break;
    }
  }
  out[i] = res;
}

__global__ void __launch_bounds__(THREADS)
    gamma_kernel(float* __restrict__ out, long long n, GammaKeys keys,
                 int rounds, float d, float c, float kappa, Affines af) {
  gamma_lane(out, n, keys, rounds, d, c, kappa, af);
}

__global__ void __launch_bounds__(THREADS)
    gamma_kernel_dev(float* __restrict__ out, long long n,
                     const GammaKeys* __restrict__ keys_dev, int rounds,
                     float d, float c, float kappa, Affines af) {
  __shared__ GammaKeys keys;
  stage_keys(keys, keys_dev);
  gamma_lane(out, n, keys, rounds, d, c, kappa, af);
}

// _binomial_inversion for one lane: the count at which the CDF first
// passes u, or min(n, MAX_COUNT) if it never does
__device__ float inversion(Key key, uint32_t ctr, float n, float p,
                           const Affines& af) {
  p = clamp_min(clamp_max(p, 1.0f), 0.0f);
  const float u =
      reina_rng::uniform(reina_rng::bits(key, ctr), af.unit_lo, af.unit_scale);
  const float q = clamp_min(__fsub_rn(1.0f, p), 1e-37f);
  float f = expf(__fmul_rn(n, logf(q)));
  const float ratio = __fdiv_rn(p, q);
  float cdf = f;
  if (u < f) return 0.0f;
  for (int k = 0; k < MAX_COUNT; ++k) {
    const float kf = (float)k;
    // f * (n - k) * (1 / (k + 1)) * ratio, as the twin rounds it
    f = __fmul_rn(__fmul_rn(f, __fsub_rn(n, kf)),
                  __fdiv_rn(1.0f, (float)(k + 1)));
    f = clamp_min(__fmul_rn(f, ratio), 0.0f);
    cdf = __fadd_rn(cdf, f);
    if (u < cdf) return (float)(k + 1);
  }
  return clamp_max(n, (float)MAX_COUNT);
}

// the Stirling correction fc(x) = 1/(12 x) - 1/(360 x³)
__device__ __forceinline__ float fc(float x) {
  return __fsub_rn(rdiv(1.0f, __fmul_rn(x, 12.0f)),
                   rdiv(1.0f, __fmul_rn(360.0f, cube(x))));
}

// _binomial_btrs for one lane (n·p >= 10, p <= 0.5)
__device__ float btrs(const BinomialKeys& keys, int rounds, uint32_t ctr,
                      float n, float p, const Affines& af) {
  p = clamp_min(clamp_max(p, 0.5f), 1e-9f);
  const float q = __fsub_rn(1.0f, p);
  const float spq = sqrtf(__fmul_rn(__fmul_rn(n, p), q));
  const float b = __fadd_rn(__fmul_rn(2.53f, spq), 1.15f);
  const float a = __fadd_rn(__fadd_rn(__fmul_rn(0.0248f, b), -0.0873f),
                            __fmul_rn(0.01f, p));
  const float c_ = __fadd_rn(__fmul_rn(n, p), 0.5f);
  const float v_r = __fsub_rn(0.92f, rdiv(4.2f, b));
  const float log_r = __fsub_rn(logf(p), logf(q));
  const float alpha = __fmul_rn(__fadd_rn(rdiv(5.1f, b), 2.83f), spq);
  const float m = floorf(__fmul_rn(__fadd_rn(n, 1.0f), p));
  const float fc_m = fc(m);
  for (int r = 0; r < rounds; ++r) {
    const float u = __fsub_rn(
        reina_rng::uniform(reina_rng::bits(keys.u[r], ctr), af.unit_lo,
                           af.unit_scale),
        0.5f);
    const float us = __fsub_rn(0.5f, fabsf(u));
    const float k = floorf(__fadd_rn(
        __fmul_rn(__fadd_rn(__fdiv_rn(__fmul_rn(2.0f, a), us), b), u), c_));
    if (!(k >= 0.0f && k <= n)) continue;
    const float v = reina_rng::uniform(reina_rng::bits(keys.v[r], ctr),
                                       af.tiny_lo, af.tiny_scale);
    const float k_c = minimum(clamp_min(k, 0.0f), n);
    if (us >= 0.07f && v <= v_r) return k_c;  // the squeeze
    const float v2 = logf(__fdiv_rn(
        __fmul_rn(v, alpha),
        __fadd_rn(__fdiv_rn(a, __fmul_rn(us, us)), b)));
    // log f(k_c) - log f(m), the twin's log_pmf_ratio
    const float d = __fsub_rn(k_c, m);
    float part1;
    if (k_c < 0.5f) {
      part1 = __fadd_rn(
          __fadd_rn(__fsub_rn(__fmul_rn(__fadd_rn(m, 0.5f), logf(m)), m),
                    fc_m),
          0.9189385f);
    } else {
      const float k_s = clamp_min(k_c, 0.5f);
      float t = __fadd_rn(__fmul_rn(__fadd_rn(m, 0.5f),
                                    log1pf(__fdiv_rn(d, m))),
                          __fmul_rn(d, logf(k_s)));
      t = __fsub_rn(t, d);
      t = __fadd_rn(t, fc(clamp_min(k_c, 1.0f)));
      part1 = -__fsub_rn(t, fc_m);
    }
    const float nk = __fsub_rn(n, k_c);
    const float a_ = clamp_min(nk, 0.5f);
    const float b_ = clamp_min(__fsub_rn(n, m), 1.0f);
    float part2 = __fadd_rn(__fmul_rn(__fadd_rn(a_, 0.5f),
                                      log1pf(__fdiv_rn(d, a_))),
                            __fmul_rn(d, logf(b_)));
    part2 = __fsub_rn(part2, d);
    part2 = __fadd_rn(part2, fc(b_));
    part2 = __fsub_rn(part2, fc(clamp_min(nk, 1.0f)));
    const float lpr =
        __fadd_rn(__fadd_rn(__fmul_rn(d, log_r), part1), part2);
    if (v2 <= lpr) return k_c;
  }
  return rintf(__fmul_rn(n, p));  // torch.round: half to even
}

__device__ __forceinline__ void binomial_lane(
    float* __restrict__ out, const float* __restrict__ n_in,
    const float* __restrict__ p_in, long long len, const BinomialKeys& keys,
    int rounds, const Affines& af) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= len) return;
  const uint32_t ctr = (uint32_t)i;
  const float n = n_in[i];
  const float p = clamp_min(clamp_max(p_in[i], 1.0f), 0.0f);
  const bool flip = p > 0.5f;
  const float p_eff = flip ? __fsub_rn(1.0f, p) : p;
  const float mean = __fmul_rn(n, p_eff);
  float cnt;
  if (mean <= 10.0f) {
    cnt = inversion(keys.inv, ctr, n, p_eff, af);
  } else {
    const bool big = mean > 10.0f;  // false for a NaN mean
    cnt = btrs(keys, rounds, ctr, big ? n : 100.0f, big ? p_eff : 0.2f, af);
  }
  cnt = minimum(clamp_min(cnt, 0.0f), n);
  out[i] = flip ? __fsub_rn(n, cnt) : cnt;
}

__global__ void __launch_bounds__(THREADS)
    binomial_kernel(float* __restrict__ out, const float* __restrict__ n_in,
                    const float* __restrict__ p_in, long long len,
                    BinomialKeys keys, int rounds, Affines af) {
  binomial_lane(out, n_in, p_in, len, keys, rounds, af);
}

__global__ void __launch_bounds__(THREADS)
    binomial_kernel_dev(float* __restrict__ out,
                        const float* __restrict__ n_in,
                        const float* __restrict__ p_in, long long len,
                        const BinomialKeys* __restrict__ keys_dev, int rounds,
                        Affines af) {
  __shared__ BinomialKeys keys;
  stage_keys(keys, keys_dev);
  binomial_lane(out, n_in, p_in, len, keys, rounds, af);
}

template <typename K>
K keys_from(const unsigned* words) {
  K k;
  static_assert(sizeof(K) % sizeof(unsigned) == 0, "keys are words");
  unsigned* dst = reinterpret_cast<unsigned*>(&k);
  for (size_t j = 0; j < sizeof(K) / sizeof(unsigned); ++j) dst[j] = words[j];
  return k;
}

Affines affines_from(const float* f) {
  return Affines{f[0], f[1], f[2], f[3], f[4], f[5]};
}

unsigned grid_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace

// out: n floats. words: 4 * MAX_ROUNDS key words (kx of rounds
// 0..MAX_ROUNDS-1, then ku): on the host, copied into the kernel's
// parameters, or, where words_dev is not NULL, the same words in device
// memory (4-byte aligned), read at launch. affines: the 6 floats of
// Affines. d, c, kappa: the twin's float32 scalars.
extern "C" int reina_gamma_fixed(void* out, long long n, const unsigned* words,
                                 const void* words_dev, int rounds, float d,
                                 float c, float kappa, const float* affines,
                                 void* stream) {
  if (rounds < 1 || rounds > MAX_ROUNDS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (words_dev != nullptr) {
    gamma_kernel_dev<<<grid_for(n), THREADS, 0, st>>>(
        (float*)out, n, (const GammaKeys*)words_dev, rounds, d, c, kappa,
        affines_from(affines));
  } else {
    gamma_kernel<<<grid_for(n), THREADS, 0, st>>>(
        (float*)out, n, keys_from<GammaKeys>(words), rounds, d, c, kappa,
        affines_from(affines));
  }
  return (int)cudaGetLastError();
}

// out, n_in, p_in: len float32 lanes. words: 2 + 4 * MAX_ROUNDS key
// words (k_inv, then ku and kv of each BTRS round), on the host or,
// where words_dev is not NULL, in device memory, as for gamma.
extern "C" int reina_binomial_fixed(void* out, const void* n_in,
                                    const void* p_in, long long len,
                                    const unsigned* words,
                                    const void* words_dev, int rounds,
                                    const float* affines, void* stream) {
  if (rounds < 1 || rounds > MAX_ROUNDS) return (int)cudaErrorInvalidValue;
  if (len <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (words_dev != nullptr) {
    binomial_kernel_dev<<<grid_for(len), THREADS, 0, st>>>(
        (float*)out, (const float*)n_in, (const float*)p_in, len,
        (const BinomialKeys*)words_dev, rounds, affines_from(affines));
  } else {
    binomial_kernel<<<grid_for(len), THREADS, 0, st>>>(
        (float*)out, (const float*)n_in, (const float*)p_in, len,
        keys_from<BinomialKeys>(words), rounds, affines_from(affines));
  }
  return (int)cudaGetLastError();
}
