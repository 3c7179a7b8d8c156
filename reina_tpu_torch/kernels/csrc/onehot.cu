// Masked one-hot sums: out[k, b] = sum_i parts[k][i] * [code[i] == b] for
// K bool masks.
//
// Replaces reina_tpu/ops/fusedmap.py:fused_onehot_sum (the Pallas kernel,
// which ran bf16 one-hot dots on the TPU's matrix unit). Its callers: the
// day-0 snapshot counts 13 masks by 11 output groups, the vaccination
// phase one eligibility mask by 101 ages.
//
// What bounds it on the card: bytes, K + 4 an agent (28.7 MB at K = 13
// and HUS size), read once. The design, in one launch:
//
//   * the K masks are read where they lie: the wrapper passes K pointers
//     in a struct given by value, so no stacked copy of them is written;
//   * the step skeleton of onehot_runs.cuh (a persistent grid, 16
//     consecutive agents a thread a step, run-length counts of the
//     codes, which both callers lay out by age), K + 4 vector loads a
//     step;
//   * K is a template parameter, so a run's K counts stay in registers;
//     the instances run from 1 to MAX_K = 16, and a larger K is refused;
//   * each CTA adds its non-zero bins into a persistent int32 buffer, and
//     the last CTA to finish writes the float32 output and zeroes the
//     buffer (hist_finish.cuh): no memset and no finish launch.
//
// Integer counts are exact in any order, so the result equals the twin's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_finish.cuh"
#include "onehot_runs.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 16;
constexpr size_t MAX_SMEM = 48 * 1024;  // static limit of a launch

struct Masks {
  const uint8_t* p[MAX_K];
};

// the masks' source for onehot_runs.cuh: one vector load a mask
template <int K>
struct MaskBytes {
  Masks m;
  uint4 w[K];

  __device__ __forceinline__ void load(long long i0) {
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = ld16(m.p[k], i0);
  }
  __device__ __forceinline__ bool counts(int) const { return true; }
  __device__ __forceinline__ void add(int j, int (&c)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] += byte_of(w[k], j) != 0;
  }
  __device__ __forceinline__ bool add_one(long long i, int (&c)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] += m.p[k][i] != 0;
    return true;
  }
};

// acc: K * nb + 1 int32, zero on entry and on exit
template <int K>
__global__ void __launch_bounds__(THREADS)
    onehot_kernel(Masks m, const int* code, int* acc, float* out,
                  long long n, int nb) {
  extern __shared__ int h[];
  const int total = K * nb;
  for (int i = threadIdx.x; i < total; i += THREADS) h[i] = 0;
  __syncthreads();
  MaskBytes<K> src{m};
  count_runs<K, THREADS>(src, code, n, nb, h);
  __syncthreads();
  for (int j = threadIdx.x; j < total; j += THREADS)
    if (h[j]) atomicAdd(&acc[j], h[j]);
  finish_last_cta(acc, total, out);
}

template <int K>
int launch(const Masks& m, const int* code, int* acc, float* out,
           long long n, int nb, void* const* events, cudaStream_t strm) {
  const size_t smem = (size_t)K * nb * sizeof(int);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int ctas = 0;
  const cudaError_t err =
      persistent_ctas(onehot_kernel<K>, THREADS, smem, n, &ctas);
  if (err != cudaSuccess) return (int)err;
  if (events) cudaEventRecord((cudaEvent_t)events[0], strm);
  onehot_kernel<K><<<ctas, THREADS, smem, strm>>>(m, code, acc, out, n, nb);
  if (events) cudaEventRecord((cudaEvent_t)events[1], strm);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const Masks&, const int*, int*, float*, long long,
                       int, void* const*, cudaStream_t);
const Launch LAUNCH[MAX_K] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>};

}  // namespace

// masks: K (n,) bool masks as bytes, each 16-byte aligned, 1 <= K <= 16;
// code: (n,) int32, 16-byte aligned; scratch: K * nb + 1 int32, zeroed,
// left zeroed; out: (K, nb) float32; K * nb * 4 bytes of bins fit 48 KB.
// events: NULL, or 2 CUDA events recorded before and after the launch.
extern "C" int reina_onehot_sum(const void* const* masks, int K,
                                const void* code, void* scratch, void* out,
                                long long n, int nb, void* const* events,
                                void* stream) {
  if (K < 1 || K > MAX_K) return (int)cudaErrorInvalidValue;
  Masks m{};
  for (int k = 0; k < K; ++k) m.p[k] = (const uint8_t*)masks[k];
  return LAUNCH[K - 1](m, (const int*)code, (int*)scratch, (float*)out, n,
                       nb, events, (cudaStream_t)stream);
}
