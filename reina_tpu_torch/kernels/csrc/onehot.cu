// Masked one-hot sums: out[k, b] = sum_i parts[k][i] * [code[i] == b].
//
// Replaces reina_tpu/ops/fusedmap.py:fused_onehot_sum (the Pallas
// kernel, which ran bf16 one-hot dots on the TPU's matrix unit). The day-0
// snapshot counts 13 bool masks by 11 output groups.
//
// What bounds it on the card: bytes (K + 4 bytes per agent, ~29 MB at
// HUS size) and shared-memory atomics. A matrix product would waste the
// tensor cores on 0/1 operands; each block instead keeps K * n_b int32
// bins in shared memory, counts its grid-stride share of agents with
// atomicAdd, and folds its bins into a global int32 buffer. Integer
// counts are exact in any order, so the result equals the twin's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void onehot_hist(const uint8_t* parts, const int* code, int* acc,
                            long long n, int K, int nb) {
  extern __shared__ int h[];
  for (int i = threadIdx.x; i < K * nb; i += THREADS) h[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const int c = code[i];
    if (c < 0 || c >= nb) continue;
    for (int k = 0; k < K; ++k)
      if (parts[(long long)k * n + i]) atomicAdd(&h[k * nb + c], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * nb; i += THREADS)
    if (h[i] != 0) atomicAdd(&acc[i], h[i]);
}

__global__ void onehot_finish(const int* acc, float* out, int total) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < total) out[i] = (float)acc[i];
}

}  // namespace

// parts: K stacked (n,) bool masks as bytes; acc: K * nb int32 scratch.
extern "C" int reina_onehot_sum(const void* parts, const void* code,
                                void* acc, void* out, long long n, int K,
                                int nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int total = K * nb;
  cudaMemsetAsync(acc, 0, (size_t)total * sizeof(int), st);
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 1056) blocks = 1056;  // 8 blocks per SM on 132 SMs
  if (blocks < 1) blocks = 1;
  onehot_hist<<<(int)blocks, THREADS, (size_t)total * sizeof(int), st>>>(
      (const uint8_t*)parts, (const int*)code, (int*)acc, n, K, nb);
  onehot_finish<<<(total + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      (const int*)acc, (float*)out, total);
  return (int)cudaGetLastError();
}
