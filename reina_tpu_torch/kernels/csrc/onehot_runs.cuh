// The step skeleton of the masked one-hot sums (fn_onehot.cu, onehot.cu):
// out[k, g] = sum_i mask_k(i) * [code_i == g] for K masks.
//
// A persistent grid walks the agents 16 consecutive agents a thread a
// step (vec16.cuh). Agents are laid out by age, so a thread's 16 codes
// are almost always equal: the K counts of a run of equal codes stay in
// registers and go to the CTA's shared bins h[k * nb + g] only when the
// code changes; the last run of every lane is summed across the warp
// with __reduce_add_sync when all 32 lanes end on one code. With random
// codes every agent is a run of its own: the result does not depend on
// the layout. Codes outside [0, nb) count nowhere. The n % 16 tail goes
// through a scalar path, one agent a thread of the first CTA.
//
// What is counted comes from a source ``Src`` of the masks:
//   void load(long long i0)       read agents [i0, i0 + 16) in 16-byte
//                                 words;
//   bool counts(int j)            whether loaded agent j counts at all;
//   void add(int j, int (&c)[K])  add loaded agent j's K mask bits;
//   bool add_one(long long i, int (&c)[K])
//                                 agent i alone (the tail): add its mask
//                                 bits, or return false if it counts
//                                 nowhere.
#pragma once
#include "vec16.cuh"

template <int K>
__device__ __forceinline__ void flush(int* h, int nb, int g, int (&c)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (c[k]) atomicAdd(&h[k * nb + g], c[k]);
    c[k] = 0;
  }
}

// Count this thread's steps and tail agent into the CTA's bins h.
template <int K, int THREADS, class Src>
__device__ __forceinline__ void count_runs(Src& src, const int* code,
                                           long long n, int nb, int* h) {
  const int lane = threadIdx.x & 31;
  const long long nvec = n / VEC;
  const long long stride = (long long)gridDim.x * THREADS;
  // every lane of a warp runs the same trip count, for the warp-wide sum
  for (long long base = (long long)blockIdx.x * THREADS + (threadIdx.x - lane);
       base < nvec; base += stride) {
    const long long v = base + lane;
    int cur = -1;  // the code of the open run; -1 for none
    int c[K] = {};
    if (v < nvec) {
      const long long i0 = v * VEC;
      src.load(i0);
      uint4 cd[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) cd[q] = ld16(code, 4 * i0 + 16 * q);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int g = int_of(cd, j);
        if (g < 0 || g >= nb || !src.counts(j)) continue;
        if (g != cur) {
          if (cur >= 0) flush(h, nb, cur, c);
          cur = g;
        }
        src.add(j, c);
      }
    }
    const int g0 = __shfl_sync(FULL, cur, 0);
    if (__all_sync(FULL, cur == g0)) {
      if (g0 >= 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int t = __reduce_add_sync(FULL, c[k]);
          if (lane == 0 && t) atomicAdd(&h[k * nb + g0], t);
        }
      }
    } else if (cur >= 0) {
      flush(h, nb, cur, c);
    }
  }
  const long long i = nvec * VEC + (long long)blockIdx.x * THREADS +
                      threadIdx.x;
  if (i < n) {
    const int g = code[i];
    int c[K] = {};
    if (g >= 0 && g < nb && src.add_one(i, c)) flush(h, nb, g, c);
  }
}
