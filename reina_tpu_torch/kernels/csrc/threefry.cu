// The day's random draws: jax.random's threefry2x32 bits, and the
// uniform, normal and gumbel floats made from them, one launch a draw.
//
// Replaces the code XLA compiles for each jax.random draw of the
// reference's day step (reina_tpu/core/step.py, e.g. :1106-1117); it has
// no Pallas counterpart. Its plain twins are
// reina_tpu_torch/ops/prng.py: random_bits_twin, uniform_twin,
// normal_twin and gumbel_twin, which run the hash as ~140 eager int32
// ops a draw.
//
// What bounds it on the card: integer operations. The hash is 20 rounds
// of add, funnel shift and xor plus six key injections, ~72 INT32
// operations an element, against 4 bytes written. The design:
//
//   * one launch a draw; the key's two words, the first counter
//     (`start`, a 1-D slab's offset), the count and the float32 affine
//     of the uniform are kernel arguments, so a draw copies nothing from
//     the host to the device. A captured day step (CUDA graphs, see
//     reina_tpu_torch/core/graphs.py) passes instead a pointer to the two
//     words in its day's key table, which the replay of another day has
//     rewritten: the kernel reads them at launch;
//   * a thread takes ELEMS consecutive elements: element k hashes the
//     counter pair (0, start + k), whatever the draw's shape (the flat
//     position of a 2-D or 3-D draw), and the thread writes them as one
//     16-byte store (the tail of a draw element by element);
//   * the mode is a template argument: raw bits, a uniform, a normal
//     (erf_inv of a uniform) or a gumbel (-log(-log(u))), all in
//     threefry.cuh, op for op as the twins.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using reina_rng::Key;

constexpr int THREADS = 256;
constexpr int ELEMS = 4;  // consecutive elements a thread

enum Mode { BITS = 0, UNIFORM = 1, NORMAL = 2, GUMBEL = 3 };

template <int MODE>
__device__ __forceinline__ uint32_t element(Key key, uint32_t ctr, float lo,
                                            float scale) {
  const uint32_t b = reina_rng::bits(key, ctr);
  if (MODE == BITS) return b;
  if (MODE == UNIFORM) return __float_as_uint(reina_rng::uniform(b, lo, scale));
  if (MODE == NORMAL) return __float_as_uint(reina_rng::normal(b, lo, scale));
  // gumbel: lo = the float32 tiny, scale = 1 - tiny
  const float u = reina_rng::uniform(b, lo, scale);
  return __float_as_uint(-logf(-logf(u)));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    draw_kernel(uint32_t* __restrict__ out, long long n, uint32_t start,
                Key key, const uint32_t* __restrict__ key_dev, float lo,
                float scale) {
  const long long base =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * ELEMS;
  if (base >= n) return;
  if (key_dev != nullptr) key = Key{key_dev[0], key_dev[1]};
  uint32_t w[ELEMS];
#pragma unroll
  for (int j = 0; j < ELEMS; ++j)
    w[j] = element<MODE>(key, start + (uint32_t)(base + j), lo, scale);
  if (base + ELEMS <= n) {
    *reinterpret_cast<uint4*>(out + base) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int j = 0; base + j < n; ++j) out[base + j] = w[j];
  }
}

static_assert(ELEMS == 4, "one uint4 store a thread");

}  // namespace

// out: n 32-bit words, 16-byte aligned; element k hashes counter
// start + k (start + n <= 2^31, checked by the wrapper). The key: the
// words k1, k2, or, where key_dev is not NULL, the two words it points
// to in device memory. mode: 0 bits, 1 uniform, 2 normal, 3 gumbel; lo
// and scale: the uniform's float32 affine (unused for bits).
extern "C" int reina_draw(void* out, long long n, long long start,
                          unsigned k1, unsigned k2, const void* key_dev,
                          int mode, float lo, float scale, void* stream) {
  if (n <= 0) return 0;
  const Key key{k1, k2};
  const uint32_t* kd = (const uint32_t*)key_dev;
  const long long per_block = (long long)THREADS * ELEMS;
  const unsigned grid = (unsigned)((n + per_block - 1) / per_block);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  const uint32_t st = (uint32_t)start;
  switch (mode) {
    case BITS:
      draw_kernel<BITS><<<grid, THREADS, 0, s>>>(o, n, st, key, kd, lo, scale);
      break;
    case UNIFORM:
      draw_kernel<UNIFORM><<<grid, THREADS, 0, s>>>(o, n, st, key, kd, lo, scale);
      break;
    case NORMAL:
      draw_kernel<NORMAL><<<grid, THREADS, 0, s>>>(o, n, st, key, kd, lo, scale);
      break;
    case GUMBEL:
      draw_kernel<GUMBEL><<<grid, THREADS, 0, s>>>(o, n, st, key, kd, lo, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
