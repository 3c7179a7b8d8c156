// Weighted 2-D histogram: out[a, b] = sum_i w_i * [code_a_i == a] *
// [code_b_i == b], where code_a_i is taken as -1 where a gate is given and
// gate_i is false; codes outside [0, na) or [0, nb) count nowhere.
//
// Replaces reina_tpu/ops/fusedmap.py:fused_bihistogram (the Pallas kernel,
// which built a weighted (na, block) one-hot and ran it through the TPU's
// matrix unit against the (block, nb) one-hot). On the day step's path it
// bins the exposers' contact counts (gate = exposer, int32 weights) by
// (variant, infectious day, asymptomatic) = na (84 at two variants) and
// source age = nb (101).
//
// What bounds it on the card: bytes, and only ~3% of the agents count.
// The design, in one launch:
//
//   * a persistent grid sized to the card (one wave at HUS size: 103
//     CTAs of 1,024 threads);
//   * a thread takes 16 consecutive agents a step (vec16.cuh): one
//     16-byte load of the gate (four of code_a without one), and a word
//     that is all zero ends the step. code_a, w and code_b are read only
//     for gated agents, as predicated loads that do not wait on each
//     other;
//   * the weights are integer contact counts <= 128 (the reference's
//     stated contract), int32 or float32, added as int32: exact in any
//     order, so the result equals the twin's float sums;
//   * the bins: each count goes straight into a persistent int32 buffer
//     in L2 with a global atomic (~50 k atomics over 8,484 addresses a
//     day, little contention), so a CTA neither zeroes nor scans bins of
//     its own. Per-CTA bins in shared memory, folded at the end, were
//     ~0.0008 ms slower on the card (PERF.md);
//   * the last CTA to finish writes the float32 output and zeroes the
//     buffer (hist_finish.cuh): no memset and no finish launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_finish.cuh"
#include "vec16.cuh"

namespace {

constexpr int THREADS = 1024;  // the last CTA reads all bins at once

__device__ __forceinline__ int weight(float w) { return __float2int_rn(w); }
__device__ __forceinline__ int weight(int w) { return w; }

__device__ __forceinline__ void add(int* acc, int a, int b, int wi, int na,
                                    int nb) {
  if (a >= 0 && a < na && b >= 0 && b < nb && wi)
    atomicAdd(&acc[a * nb + b], wi);
}

// gate: NULL, or (n,) bytes; acc: na * nb + 1 int32, zero on entry and
// on exit
template <typename W, bool GATED>
__global__ void __launch_bounds__(THREADS)
    bihist_kernel(const uint8_t* gate, const int* code_a, const W* w,
                  const int* code_b, int* acc, float* out, long long n,
                  int na, int nb) {
  const long long nvec = n / VEC;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long v = (long long)blockIdx.x * THREADS + threadIdx.x; v < nvec;
       v += stride) {
    const long long i0 = v * VEC;
    int a[VEC];
    bool on[VEC];
    if constexpr (GATED) {
      const uint4 g = ld16(gate, i0);
      if ((g.x | g.y | g.z | g.w) == 0) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        on[j] = byte_of(g, j);
        a[j] = on[j] ? __ldg(code_a + i0 + j) : -1;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(code_a + i0) + q);
        a[4 * q] = x.x, a[4 * q + 1] = x.y, a[4 * q + 2] = x.z,
        a[4 * q + 3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) on[j] = a[j] >= 0 && a[j] < na;
    }
    // independent predicated loads: one round trip for the step's agents
    int b[VEC], wi[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      b[j] = on[j] ? __ldg(code_b + i0 + j) : -1;
      wi[j] = on[j] ? weight(__ldg(w + i0 + j)) : 0;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) add(acc, a[j], b[j], wi[j], na, nb);
  }
  // the n % 16 tail, one agent a thread of the first CTA
  const long long i = nvec * VEC + (long long)blockIdx.x * THREADS +
                      threadIdx.x;
  if (i < n && (!GATED || gate[i]))
    add(acc, code_a[i], code_b[i], weight(w[i]), na, nb);
  finish_last_cta(acc, na * nb, out);
}

template <typename W, bool GATED>
int launch(const void* gate, const void* code_a, const void* w,
           const void* code_b, void* scratch, void* out, long long n, int na,
           int nb, cudaStream_t st) {
  auto kernel = bihist_kernel<W, GATED>;
  int ctas = 0;
  const cudaError_t err = persistent_ctas(kernel, THREADS, 0, n, &ctas);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, THREADS, 0, st>>>(
      (const uint8_t*)gate, (const int*)code_a, (const W*)w,
      (const int*)code_b, (int*)scratch, (float*)out, n, na, nb);
  return (int)cudaGetLastError();
}

}  // namespace

// gate: NULL or (n,) bools, 16-byte aligned (without it code_a is);
// w_float: w is float32, else int32; scratch: na * nb + 1 int32, zeroed,
// left zeroed; out: (na, nb) float32. events: NULL, or 2 CUDA events
// recorded before and after the launch.
extern "C" int reina_bihistogram(const void* gate, const void* code_a,
                                 const void* w, int w_float,
                                 const void* code_b, void* scratch,
                                 void* out, long long n, int na, int nb,
                                 void* const* events, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (na <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  if (events) cudaEventRecord((cudaEvent_t)events[0], st);
  const int err =
      gate ? (w_float ? launch<float, true>(gate, code_a, w, code_b, scratch,
                                            out, n, na, nb, st)
                      : launch<int, true>(gate, code_a, w, code_b, scratch,
                                          out, n, na, nb, st))
           : (w_float ? launch<float, false>(gate, code_a, w, code_b,
                                             scratch, out, n, na, nb, st)
                      : launch<int, false>(gate, code_a, w, code_b, scratch,
                                           out, n, na, nb, st));
  if (events) cudaEventRecord((cudaEvent_t)events[1], st);
  return err;
}
