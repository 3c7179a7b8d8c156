// Phase-7 output counts: out[k, g] = sum_i mask_k(fields_i) * [code_i == g]
// for the 10 masks of _output_masks_reduced (reina_tpu_torch/core/step.py).
//
// Replaces reina_tpu/ops/fusedmap.py:fused_fn_onehot_sum (the Pallas
// kernel, which computed the masks in VMEM and ran bf16 one-hot dots on
// the TPU's matrix unit). The masks, in row order:
//
//   0 active & dov >= 0           5 active & st == HOSPITALIZED
//   1 active & (is_inf | has_imm) 6 active & st == DEAD
//   2 active & det                7 active & st == RECOVERED
//   3 active & st == IN_ICU       8 active & st == DEAD & dout
//   4 active & ever_icu           9 active & newly
//
// The state codes come from reina_tpu_torch/core/constants.py through
// the wrapper; none is written here.
//
// What bounds it on the card: bytes. Nine field streams in their own
// types (seven bools, dov int16, st int8) and the int32 group code, 14
// bytes an agent, ~23.6 MB at HUS size, read once; the masks never reach
// device memory. The design, in one launch:
//
//   * a persistent grid sized to the card (SMs x resident CTAs, no more
//     than the agents need): at HUS size 396 CTAs (3 an SM at 80
//     registers) for the 412 the agents fill, so a few threads take a
//     second step; capping registers for one wave spilled and was slower;
//   * a thread takes 16 consecutive agents a step: one 16-byte load for
//     each byte stream, two for dov and four for the codes (12 vector
//     loads where a lane-per-agent loop makes 160 scalar ones);
//   * agents are laid out by age, so a thread's 16 codes are almost
//     always equal: the 10 counts of a run of equal codes stay in
//     registers and go to the CTA's shared bins only when the code
//     changes; the last run of every lane is summed across the warp with
//     __reduce_add_sync when all 32 lanes end on one code. With random
//     codes every agent is a run of its own: the result does not depend
//     on the layout;
//   * the N % 16 tail goes through a scalar path;
//   * each CTA adds its non-zero bins into a persistent int32 buffer, and
//     the last CTA to finish writes the float32 output and zeroes the
//     buffer (hist_finish.cuh).
//
// Integer counts are exact in any order, so the result equals the twin's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_finish.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int K = 10;
constexpr int VEC = 16;  // consecutive agents a thread takes a step
constexpr unsigned FULL = 0xffffffffu;

struct States {
  int hospitalized, in_icu, recovered, dead;
};

struct Fields {
  const uint8_t *active, *is_inf, *has_imm;
  const int16_t* dov;
  const uint8_t* det;
  const int8_t* st;
  const uint8_t *ever_icu, *dout, *newly;
  const int* code;
};

__device__ __forceinline__ uint4 ld16(const void* p, long long byte_off) {
  return __ldg(reinterpret_cast<const uint4*>(
      static_cast<const uint8_t*>(p) + byte_off));
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

__device__ __forceinline__ int int_of(const uint4 (&v)[4], int j) {
  return (int)word_of(v[j >> 2], j & 3);
}

// one active agent's masks added to the run's counts
__device__ __forceinline__ void add_agent(int (&c)[K], bool dov_ok,
                                          bool inf, bool imm, bool det,
                                          int st, bool ever_icu, bool dout,
                                          bool newly, const States& s) {
  const bool dead = st == s.dead;
  c[0] += dov_ok;
  c[1] += inf | imm;
  c[2] += det;
  c[3] += st == s.in_icu;
  c[4] += ever_icu;
  c[5] += st == s.hospitalized;
  c[6] += dead;
  c[7] += st == s.recovered;
  c[8] += dead & dout;
  c[9] += newly;
}

__device__ __forceinline__ void flush(int* h, int nb, int g, int (&c)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (c[k]) atomicAdd(&h[k * nb + g], c[k]);
    c[k] = 0;
  }
}

// acc: 10 * nb + 1 int32, zero on entry and on exit
__global__ void __launch_bounds__(THREADS)
    fn_onehot_kernel(Fields f, int* acc, float* out, long long n, int nb,
                     States s) {
  extern __shared__ int h[];
  const int total = K * nb;
  for (int i = threadIdx.x; i < total; i += THREADS) h[i] = 0;
  __syncthreads();
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
      const uint4 act = ld16(f.active, i0), inf = ld16(f.is_inf, i0),
                  imm = ld16(f.has_imm, i0), det = ld16(f.det, i0),
                  st = ld16(f.st, i0), evi = ld16(f.ever_icu, i0),
                  dout = ld16(f.dout, i0), nw = ld16(f.newly, i0),
                  dv0 = ld16(f.dov, 2 * i0), dv1 = ld16(f.dov, 2 * i0 + 16);
      uint4 cd[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) cd[q] = ld16(f.code, 4 * i0 + 16 * q);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int g = int_of(cd, j);
        if (!byte_of(act, j) || g < 0 || g >= nb) continue;
        if (g != cur) {
          if (cur >= 0) flush(h, nb, cur, c);
          cur = g;
        }
        add_agent(c, !(half_of(dv0, dv1, j) & 0x8000u), byte_of(inf, j),
                  byte_of(imm, j), byte_of(det, j),
                  (int)(int8_t)byte_of(st, j), byte_of(evi, j),
                  byte_of(dout, j), byte_of(nw, j), s);
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
  // the n % 16 tail, one agent a thread of the first CTA
  const long long i = nvec * VEC + (long long)blockIdx.x * THREADS +
                      threadIdx.x;
  if (i < n) {
    const int g = f.code[i];
    if (f.active[i] && g >= 0 && g < nb) {
      int c[K] = {};
      add_agent(c, f.dov[i] >= 0, f.is_inf[i], f.has_imm[i], f.det[i],
                f.st[i], f.ever_icu[i], f.dout[i], f.newly[i], s);
      flush(h, nb, g, c);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < total; j += THREADS)
    if (h[j]) atomicAdd(&acc[j], h[j]);
  finish_last_cta(acc, total, out);
}

}  // namespace

// fields: the nine (n,) streams in _output_masks_reduced's order, bools
// as bytes, and code, each 16-byte aligned; scratch: 10 * nb + 1 int32,
// zeroed, left zeroed; out: (10, nb) float32. events: NULL, or 2 CUDA
// events recorded before and after the launch.
extern "C" int reina_fn_onehot_output_masks(
    const void* active, const void* is_inf, const void* has_imm,
    const void* dov, const void* det, const void* st, const void* ever_icu,
    const void* dout, const void* newly, const void* code, void* scratch,
    void* out, long long n, int nb, int hospitalized, int in_icu,
    int recovered, int dead, void* const* events, void* stream) {
  cudaStream_t strm = (cudaStream_t)stream;
  const size_t smem = (size_t)K * nb * sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn_onehot_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long need = (n / VEC + THREADS - 1) / THREADS;
  const long long ctas = need < 1 ? 1 : min((long long)sms * per_sm, need);
  const Fields f{(const uint8_t*)active, (const uint8_t*)is_inf,
                 (const uint8_t*)has_imm, (const int16_t*)dov,
                 (const uint8_t*)det,    (const int8_t*)st,
                 (const uint8_t*)ever_icu, (const uint8_t*)dout,
                 (const uint8_t*)newly,  (const int*)code};
  const States s{hospitalized, in_icu, recovered, dead};
  if (events) cudaEventRecord((cudaEvent_t)events[0], strm);
  fn_onehot_kernel<<<(int)ctas, THREADS, smem, strm>>>(f, (int*)scratch,
                                                       (float*)out, n, nb, s);
  if (events) cudaEventRecord((cudaEvent_t)events[1], strm);
  return (int)cudaGetLastError();
}
