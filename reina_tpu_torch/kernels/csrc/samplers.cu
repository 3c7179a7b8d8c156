// The day's fixed-round samplers: gamma_fixed (Marsaglia-Tsang, 4
// rounds; one launch draws one sample or two of one shape, the day step's
// two gamma draws) and binomial_fixed (CDF inversion over 48 steps for
// n·p <= 10, BTRS with 6 rounds above, p > 0.5 by flipping), one launch
// a call.
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
// is a few dozen operations a round. At the day step's sizes (a few
// thousand gamma lanes, ~10^5 binomial lanes) a call is far from that
// bound and its time is the latency of its longest lane behind a launch.
// The design shortens that chain:
//
//   * each draw of a round is the threefry hash of the lane's flat index
//     under that round's key (threefry.cuh), so a lane draws exactly the
//     numbers the twin's whole-array draws give it, whichever thread
//     computes it;
//   * gamma: a lane's rounds run side by side, one thread a round in a
//     group of a power of two threads (4 for the day's 4 rounds); each
//     thread hashes and tests its round, and the group keeps its first
//     accepting round (__ballot_sync, __ffs), or kappa where none
//     accepts. The twin keeps the first round that accepts, and a round's
//     draws depend only on its keys and the lane, so this is exact. The
//     samples of one launch are the grid's y axis, each with its own keys,
//     kappa, d and c: the day's two draws are one launch;
//   * binomial: each CTA classifies its lanes (n·p_eff <= 10: the
//     inversion, else BTRS; a NaN mean goes to BTRS as in the twin) and
//     lays them out in shared memory, inversion lanes first, so that
//     each warp but one a CTA runs one branch; a thread takes the lane
//     at its place and writes that lane's output. A lane of the
//     inversion with n = 0 or p_eff = 0 is settled at once (its CDF
//     starts at 1, and u < 1), without a hash. The inversion multiplies
//     by a table of the float32 reciprocals 1/(k + 1), immediates of its
//     unrolled loop (the twin multiplies by the same float32 values),
//     not by a quotient a step;
//     BTRS hashes its first round's draws before its setup, which does
//     not depend on them;
//   * a lane computes only the branch that the twin's
//     where(small_m, small, big) keeps, and stops at the round or step
//     where it settles. Both are exact: skipping a round shifts no
//     other draw, and once a lane is settled or done the twin never
//     changes its value again;
//   * the keys are split on the host as the twin splits them (13 for
//     binomial_fixed, 8 for gamma_fixed) and passed by value in the
//     kernel's parameters, or, for a captured day step (CUDA graphs),
//     read at launch from the day's key table in device memory, so that
//     a replay draws with the day's keys;
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

constexpr int GAMMA_THREADS = 128;
constexpr int BIN_THREADS = 128;
constexpr int MAX_ROUNDS = 8;
constexpr int MAX_SAMPLES = 2;  // gamma samples a launch
constexpr int MAX_COUNT = 48;   // the inversion's horizon

// the float32 affines of the twin's uniforms (prng.affine)
struct Affines {
  float unit_lo, unit_scale;    // [0, 1)
  float tiny_lo, tiny_scale;    // [1e-37, 1)
  float normal_lo, normal_scale;  // [_NORMAL_LO, 1), for normal draws
};

struct GammaKeys {
  Key x[MAX_ROUNDS], u[MAX_ROUNDS];  // each round's split(k) = (kx, ku)
};

// one sample of a gamma launch: its keys by value or, where dev is not
// NULL, in device memory; the twin's float32 scalars
struct GammaSample {
  GammaKeys keys;
  const GammaKeys* dev;
  float d, c, kappa;
};

struct GammaArgs {
  GammaSample s[MAX_SAMPLES];  // sample h is the grid's y = h
  float* out;                  // sample h's n lanes at out + h * n
  long long n;
  int rounds, shift;           // a lane's group: 1 << shift >= rounds
  Affines af;
};

struct BinomialKeys {
  Key inv;                           // split(key)[0]
  Key u[MAX_ROUNDS], v[MAX_ROUNDS];  // split(split(key)[1], rounds)[r]
};

struct BinomialArgs {
  BinomialKeys keys;
  const BinomialKeys* dev;  // the keys in device memory, or NULL
  float* out;
  const float* n;
  const float* p;
  long long len;
  int rounds;
  Affines af;
};

__device__ __forceinline__ float cube(float x) {
  return __fmul_rn(x, __fmul_rn(x, x));
}

// s / t as torch computes a Python scalar over a tensor:
// t.reciprocal() * s
__device__ __forceinline__ float rdiv(float s, float t) {
  return __fmul_rn(__fdiv_rn(1.0f, t), s);
}

// round r of gamma_fixed_twin for lane ctr: whether it accepts, and its
// sample d·v in *dv
__device__ __forceinline__ bool gamma_round(const GammaKeys* k, int r,
                                            uint32_t ctr,
                                            const GammaSample& s,
                                            const Affines& af, float* dv) {
  const float x = reina_rng::normal(reina_rng::bits(k->x[r], ctr),
                                    af.normal_lo, af.normal_scale);
  const float v = cube(__fadd_rn(1.0f, __fmul_rn(s.c, x)));
  *dv = __fmul_rn(s.d, v);
  if (!(v > 0.0f)) return false;
  const float u = reina_rng::uniform(reina_rng::bits(k->u[r], ctr),
                                     af.tiny_lo, af.tiny_scale);
  // 0.5 * x * x + d - d * v + d * log(clamp_min(v, 1e-37))
  float rhs = __fadd_rn(__fmul_rn(__fmul_rn(0.5f, x), x), s.d);
  rhs = __fsub_rn(rhs, __fmul_rn(s.d, v));
  rhs = __fadd_rn(rhs, __fmul_rn(s.d, logf(clamp_min(v, 1e-37f))));
  return logf(u) < rhs;
}

// thread t of sample blockIdx.y runs round t & (width - 1) of lane
// t >> shift; the group's first accepting round is the lane's sample
__global__ void __launch_bounds__(GAMMA_THREADS)
    gamma_kernel(const __grid_constant__ GammaArgs a) {
  const GammaSample& s = a.s[blockIdx.y];
  const long long t = (long long)blockIdx.x * GAMMA_THREADS + threadIdx.x;
  const long long i = t >> a.shift;
  const int width = 1 << a.shift;
  const int r = (int)(t & (width - 1));
  bool ok = false;
  float dv = 0.0f;
  if (i < a.n && r < a.rounds)
    ok = gamma_round(s.dev != nullptr ? s.dev : &s.keys, r, (uint32_t)i, s,
                     a.af, &dv);
  const unsigned vote = __ballot_sync(0xffffffffu, ok);
  const unsigned group =
      (vote >> ((threadIdx.x & 31) & ~(width - 1))) & ((1u << width) - 1);
  const int first = group != 0 ? __ffs(group) - 1 : 0;
  if (i < a.n && r == first)
    a.out[blockIdx.y * a.n + i] = group != 0 ? dv : s.kappa;
}

// _binomial_inversion for one lane: the count at which the CDF first
// passes u, or min(n, MAX_COUNT) if it never does
__device__ float inversion(Key key, uint32_t ctr, float n, float p,
                           const Affines& af) {
  const float u =
      reina_rng::uniform(reina_rng::bits(key, ctr), af.unit_lo, af.unit_scale);
  p = clamp_min(clamp_max(p, 1.0f), 0.0f);
  const float q = clamp_min(__fsub_rn(1.0f, p), 1e-37f);
  float f = expf(__fmul_rn(n, logf(q)));
  const float ratio = __fdiv_rn(p, q);
  float cdf = f;
  if (u < f) return 0.0f;
  // the float32 reciprocals 1/(k + 1), correctly rounded: immediates of
  // the unrolled loop (no module data, which a lazily loaded module
  // would have to set up at its first launch)
  constexpr float RECIP[MAX_COUNT] = {
      1.0f, 0.5f, 0.333333343f, 0.25f, 0.200000003f, 0.166666672f,
      0.142857149f, 0.125f, 0.111111112f, 0.100000001f, 0.0909090936f,
      0.0833333358f, 0.0769230798f, 0.0714285746f, 0.0666666701f, 0.0625f,
      0.0588235296f, 0.055555556f, 0.0526315793f, 0.0500000007f,
      0.0476190485f, 0.0454545468f, 0.0434782617f, 0.0416666679f,
      0.0399999991f, 0.0384615399f, 0.0370370373f, 0.0357142873f,
      0.0344827585f, 0.0333333351f, 0.0322580636f, 0.03125f, 0.0303030312f,
      0.0294117648f, 0.0285714287f, 0.027777778f, 0.0270270277f,
      0.0263157897f, 0.025641026f, 0.0250000004f, 0.024390243f,
      0.0238095243f, 0.0232558139f, 0.0227272734f, 0.0222222228f,
      0.0217391308f, 0.0212765951f, 0.020833334f};
#pragma unroll
  for (int k = 0; k < MAX_COUNT; ++k) {
    // f * (n - k) * (1 / (k + 1)) * ratio, as the twin rounds it
    f = __fmul_rn(__fmul_rn(f, __fsub_rn(n, (float)k)), RECIP[k]);
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

// _binomial_btrs for one lane (n·p >= 10, p <= 0.5): its setup, and
// each round from that round's two hashes
struct Btrs {
  float n, p, b, a, c_, v_r, log_r, alpha, m, fc_m;
  __device__ Btrs(float n_, float p_) : n(n_) {
    p = clamp_min(clamp_max(p_, 0.5f), 1e-9f);
    const float q = __fsub_rn(1.0f, p);
    const float spq = sqrtf(__fmul_rn(__fmul_rn(n, p), q));
    b = __fadd_rn(__fmul_rn(2.53f, spq), 1.15f);
    a = __fadd_rn(__fadd_rn(__fmul_rn(0.0248f, b), -0.0873f),
                  __fmul_rn(0.01f, p));
    c_ = __fadd_rn(__fmul_rn(n, p), 0.5f);
    v_r = __fsub_rn(0.92f, rdiv(4.2f, b));
    log_r = __fsub_rn(logf(p), logf(q));
    alpha = __fmul_rn(__fadd_rn(rdiv(5.1f, b), 2.83f), spq);
    m = floorf(__fmul_rn(__fadd_rn(n, 1.0f), p));
    fc_m = fc(m);
  }
  // the count of lanes no round accepts
  __device__ float fallback() const {
    return rintf(__fmul_rn(n, p));  // torch.round: half to even
  }
  // whether the round of hashes bu, bv accepts, and its count in *k_out
  __device__ bool round(uint32_t bu, uint32_t bv, const Affines& af,
                        float* k_out) const {
    const float u = __fsub_rn(
        reina_rng::uniform(bu, af.unit_lo, af.unit_scale), 0.5f);
    const float us = __fsub_rn(0.5f, fabsf(u));
    const float k = floorf(__fadd_rn(
        __fmul_rn(__fadd_rn(__fdiv_rn(__fmul_rn(2.0f, a), us), b), u), c_));
    if (!(k >= 0.0f && k <= n)) return false;
    const float v = reina_rng::uniform(bv, af.tiny_lo, af.tiny_scale);
    const float k_c = minimum(clamp_min(k, 0.0f), n);
    *k_out = k_c;
    if (us >= 0.07f && v <= v_r) return true;  // the squeeze
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
    return v2 <= lpr;
  }
};

// BTRS for one lane, its rounds in turn; the first round's hashes come
// first: nothing of the setup feeds them
__device__ float btrs(const BinomialKeys& keys, int rounds, uint32_t ctr,
                      float n, float p, const Affines& af) {
  uint32_t bu = reina_rng::bits(keys.u[0], ctr);
  uint32_t bv = reina_rng::bits(keys.v[0], ctr);
  const Btrs s(n, p);
  float k;
  for (int r = 0; r < rounds; ++r) {
    if (r > 0) {
      bu = reina_rng::bits(keys.u[r], ctr);
      bv = reina_rng::bits(keys.v[r], ctr);
    }
    if (s.round(bu, bv, af, &k)) return k;
  }
  return s.fallback();
}

enum Kind { SETTLED = 0, INVERSION = 1, BTRS = 2 };

// lane i's n, clamped p, flip and p_eff, and which branch it takes
struct Lane {
  float n, p, p_eff, mean;
  bool flip;
  __device__ Lane(float n_, float p_) : n(n_) {
    p = clamp_min(clamp_max(p_, 1.0f), 0.0f);
    flip = p > 0.5f;
    p_eff = flip ? __fsub_rn(1.0f, p) : p;
    mean = __fmul_rn(n, p_eff);
  }
  __device__ Kind kind() const {
    if (!(mean <= 10.0f)) return BTRS;  // a NaN mean too
    return n == 0.0f || p_eff == 0.0f ? SETTLED : INVERSION;
  }
  __device__ float out(float cnt) const {
    cnt = minimum(clamp_min(cnt, 0.0f), n);
    return flip ? __fsub_rn(n, cnt) : cnt;
  }
};

// a CTA of BIN_THREADS lanes: classify, lay the inversion lanes out
// first and the BTRS lanes after them (each in thread order), then
// thread j computes the lane at place j
__global__ void __launch_bounds__(BIN_THREADS)
    binomial_kernel(const __grid_constant__ BinomialArgs a) {
  constexpr int WARPS = BIN_THREADS / 32;
  __shared__ float n_of[BIN_THREADS], p_of[BIN_THREADS];
  __shared__ int lane_at[BIN_THREADS];
  __shared__ int inv_in[WARPS], btrs_in[WARPS];
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const long long base = (long long)blockIdx.x * BIN_THREADS;
  Kind kind = SETTLED;
  if (base + tid < a.len) {
    n_of[tid] = a.n[base + tid];
    p_of[tid] = a.p[base + tid];
    const Lane l(n_of[tid], p_of[tid]);
    kind = l.kind();
    if (kind == SETTLED) a.out[base + tid] = l.out(0.0f);
  }
  const unsigned inv = __ballot_sync(0xffffffffu, kind == INVERSION);
  const unsigned big = __ballot_sync(0xffffffffu, kind == BTRS);
  if (wl == 0) {
    inv_in[warp] = __popc(inv);
    btrs_in[warp] = __popc(big);
  }
  __syncthreads();
  int n_inv = 0, n_btrs = 0, inv_before = 0, btrs_before = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) {
      inv_before += inv_in[w];
      btrs_before += btrs_in[w];
    }
    n_inv += inv_in[w];
    n_btrs += btrs_in[w];
  }
  const unsigned below = (1u << wl) - 1u;
  if (kind == INVERSION) lane_at[inv_before + __popc(inv & below)] = tid;
  if (kind == BTRS)
    lane_at[n_inv + btrs_before + __popc(big & below)] = tid;
  __syncthreads();
  if (tid >= n_inv + n_btrs) return;
  const int j = lane_at[tid];
  const uint32_t ctr = (uint32_t)(base + j);
  const Lane l(n_of[j], p_of[j]);
  const BinomialKeys& keys = a.dev != nullptr ? *a.dev : a.keys;
  float cnt;
  if (tid < n_inv) {
    cnt = inversion(keys.inv, ctr, l.n, l.p_eff, a.af);
  } else {
    const bool big_m = l.mean > 10.0f;  // false for a NaN mean
    cnt = btrs(keys, a.rounds, ctr, big_m ? l.n : 100.0f,
               big_m ? l.p_eff : 0.2f, a.af);
  }
  a.out[base + j] = l.out(cnt);
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

}  // namespace

// out: samples * n floats, sample h at out + h * n (samples 1 or 2).
// words: 4 * MAX_ROUNDS key words a sample (kx of rounds
// 0..MAX_ROUNDS-1, then ku), copied into the kernel's parameters; where
// words_dev[h] is not NULL, sample h's words in device memory (4-byte
// aligned) instead, read at launch. dck: d, c and kappa of each sample,
// the twin's float32 scalars. affines: the 6 floats of Affines.
extern "C" int reina_gamma_fixed(void* out, long long n, int samples,
                                 const unsigned* words,
                                 const void* const* words_dev, int rounds,
                                 const float* dck, const float* affines,
                                 void* stream) {
  if (rounds < 1 || rounds > MAX_ROUNDS || samples < 1 ||
      samples > MAX_SAMPLES)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  GammaArgs a{};
  for (int h = 0; h < samples; ++h) {
    GammaSample& s = a.s[h];
    s.dev = (const GammaKeys*)words_dev[h];
    if (s.dev == nullptr)
      s.keys = keys_from<GammaKeys>(words + h * 4 * MAX_ROUNDS);
    s.d = dck[3 * h];
    s.c = dck[3 * h + 1];
    s.kappa = dck[3 * h + 2];
  }
  a.out = (float*)out;
  a.n = n;
  a.rounds = rounds;
  while ((1 << a.shift) < rounds) ++a.shift;
  a.af = affines_from(affines);
  const long long threads = n << a.shift;
  const dim3 grid((unsigned)((threads + GAMMA_THREADS - 1) / GAMMA_THREADS),
                  (unsigned)samples);
  gamma_kernel<<<grid, GAMMA_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out, n_in, p_in: len float32 lanes. words: 2 + 4 * MAX_ROUNDS key
// words (k_inv, then ku and kv of each BTRS round), copied into the
// kernel's parameters or, where words_dev is not NULL, the same words in
// device memory, as for gamma.
extern "C" int reina_binomial_fixed(void* out, const void* n_in,
                                    const void* p_in, long long len,
                                    const unsigned* words,
                                    const void* words_dev, int rounds,
                                    const float* affines, void* stream) {
  if (rounds < 1 || rounds > MAX_ROUNDS) return (int)cudaErrorInvalidValue;
  if (len <= 0) return 0;
  BinomialArgs a{};
  a.dev = (const BinomialKeys*)words_dev;
  if (a.dev == nullptr) a.keys = keys_from<BinomialKeys>(words);
  a.out = (float*)out;
  a.n = (const float*)n_in;
  a.p = (const float*)p_in;
  a.len = len;
  a.rounds = rounds;
  a.af = affines_from(affines);
  const unsigned grid = (unsigned)((len + BIN_THREADS - 1) / BIN_THREADS);
  binomial_kernel<<<grid, BIN_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
