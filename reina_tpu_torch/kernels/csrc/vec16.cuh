// Loads and stores of 16 consecutive agents a thread (post.cu,
// fn_onehot.cu, onehot.cu).
//
// A thread that owns agents [i0, i0 + 16) reads each of its streams in
// 16-byte words: one for a byte stream (int8, bool), two for an int16
// stream, four for an int32 or float32 stream, and picks agent j's value
// out of them in registers. Every stream must be 16-byte aligned; the
// wrappers check it.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int VEC = 16;  // consecutive agents a thread takes a step
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint4 ld16(const void* p, long long byte_off) {
  return __ldg(reinterpret_cast<const uint4*>(
      static_cast<const uint8_t*>(p) + byte_off));
}

__device__ __forceinline__ void st16(void* p, long long byte_off,
                                     const uint4& v) {
  *reinterpret_cast<uint4*>(static_cast<uint8_t*>(p) + byte_off) = v;
}

__device__ __forceinline__ unsigned word_of(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// byte j of 16, half j of 16 (two words), int j of 16 (four words)
__device__ __forceinline__ unsigned byte_of(const uint4& v, int j) {
  return (word_of(v, j >> 2) >> (8 * (j & 3))) & 0xffu;
}

__device__ __forceinline__ unsigned half_of(const uint4& lo, const uint4& hi,
                                            int j) {
  const int k = j & 7;
  return (word_of(j < 8 ? lo : hi, k >> 1) >> (16 * (k & 1))) & 0xffffu;
}

__device__ __forceinline__ unsigned word_of4(const uint4 (&v)[4], int j) {
  return word_of(v[j >> 2], j & 3);
}

__device__ __forceinline__ int int_of(const uint4 (&v)[4], int j) {
  return (int)word_of4(v, j);
}

__device__ __forceinline__ float float_of(const uint4 (&v)[4], int j) {
  return __uint_as_float(word_of4(v, j));
}

__device__ __forceinline__ unsigned& word_at(uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// agent j's byte (or half) set into the zeroed 16-byte words that store
// 16 agents
__device__ __forceinline__ void put_byte(uint4& v, int j, unsigned b) {
  word_at(v, j >> 2) |= (b & 0xffu) << (8 * (j & 3));
}

__device__ __forceinline__ void put_half(uint4& lo, uint4& hi, int j,
                                         unsigned h) {
  word_at(j < 8 ? lo : hi, (j & 7) >> 1) |= (h & 0xffffu) << (16 * (j & 1));
}

// The persistent grid of a kernel whose threads take 16 agents a step: as
// many CTAs as the card holds at once, no more than the agents need, at
// least one (for the n % 16 tail).
template <class Kernel>
__host__ inline cudaError_t persistent_ctas(Kernel kernel, int threads,
                                            size_t smem, long long n,
                                            int* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const long long need = (n / VEC + threads - 1) / threads;
  const long long most = (long long)sms * per_sm;
  *ctas = (int)(need < 1 ? 1 : need < most ? need : most);
  return cudaSuccess;
}
