// The end of a histogram that runs in one launch (bihist.cu, fn_onehot.cu).
//
// Each CTA has added its counts into acc[0, total) with atomics, and
// acc[total] counts the CTAs that are done. The last CTA to take a ticket
// writes out = float(acc) and zeroes acc and the counter, so the next
// launch finds its scratch zeroed: no memset before the histogram and no
// finish launch after it. The last CTA keeps 16 loads in flight a thread,
// so a CTA of 1,024 threads reads 16,384 bins in one L2 round trip. The
// wrapper allocates acc (total + 1 int32) once, zeroed. Two launches on
// the same scratch must not overlap.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ void finish_last_cta(int* acc, int total,
                                                float* out) {
  __shared__ bool last;
  // the CTA's atomics, then one release by thread 0 (the pattern of
  // cooperative groups' grid sync), then the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&acc[total], 1) == (int)gridDim.x - 1;
    if (last) __threadfence();  // every other CTA's atomics before reads
  }
  __syncthreads();
  if (!last) return;
  // U loads in flight a thread, read from L2 where the atomics landed
  constexpr int U = 16;
  const int step = (int)blockDim.x;
  for (int base = threadIdx.x; base < total; base += U * step) {
    int v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = base + u * step < total ? __ldcg(&acc[base + u * step]) : 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * step < total) {
        out[base + u * step] = (float)v[u];
        __stcg(&acc[base + u * step], 0);
      }
    }
  }
  if (threadIdx.x == 0) __stcg(&acc[total], 0);
}
