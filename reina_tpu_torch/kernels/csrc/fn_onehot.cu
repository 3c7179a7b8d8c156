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
//   * the step skeleton of onehot_runs.cuh: a persistent grid sized to
//     the card (at HUS size 396 CTAs, 3 an SM at 80 registers, for the
//     412 the agents fill, so a few threads take a second step; capping
//     registers for one wave spilled and was slower), 16 consecutive
//     agents a thread a step and run-length counts. Here a step is 12
//     vector loads (one for each byte stream, two for dov, four for the
//     codes) where a lane-per-agent loop makes 160 scalar ones; an
//     inactive agent counts nowhere;
//   * each CTA adds its non-zero bins into a persistent int32 buffer, and
//     the last CTA to finish writes the float32 output and zeroes the
//     buffer (hist_finish.cuh).
//
// Integer counts are exact in any order, so the result equals the twin's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_finish.cuh"
#include "onehot_runs.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int K = 10;

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

// the masks' source for onehot_runs.cuh: 10 vector loads for 16 agents
struct PhaseSeven {
  Fields f;
  States s;
  uint4 act, inf, imm, det, st, evi, dout, nw, dv0, dv1;

  __device__ __forceinline__ void load(long long i0) {
    act = ld16(f.active, i0);
    inf = ld16(f.is_inf, i0);
    imm = ld16(f.has_imm, i0);
    det = ld16(f.det, i0);
    st = ld16(f.st, i0);
    evi = ld16(f.ever_icu, i0);
    dout = ld16(f.dout, i0);
    nw = ld16(f.newly, i0);
    dv0 = ld16(f.dov, 2 * i0);
    dv1 = ld16(f.dov, 2 * i0 + 16);
  }
  __device__ __forceinline__ bool counts(int j) const {
    return byte_of(act, j);
  }
  __device__ __forceinline__ void add(int j, int (&c)[K]) const {
    add_agent(c, !(half_of(dv0, dv1, j) & 0x8000u), byte_of(inf, j),
              byte_of(imm, j), byte_of(det, j), (int)(int8_t)byte_of(st, j),
              byte_of(evi, j), byte_of(dout, j), byte_of(nw, j), s);
  }
  __device__ __forceinline__ bool add_one(long long i, int (&c)[K]) const {
    if (!f.active[i]) return false;
    add_agent(c, f.dov[i] >= 0, f.is_inf[i], f.has_imm[i], f.det[i],
              f.st[i], f.ever_icu[i], f.dout[i], f.newly[i], s);
    return true;
  }
};

// acc: 10 * nb + 1 int32, zero on entry and on exit
__global__ void __launch_bounds__(THREADS)
    fn_onehot_kernel(Fields f, int* acc, float* out, long long n, int nb,
                     States s) {
  extern __shared__ int h[];
  const int total = K * nb;
  for (int i = threadIdx.x; i < total; i += THREADS) h[i] = 0;
  __syncthreads();
  PhaseSeven src{f, s};
  count_runs<K, THREADS>(src, f.code, n, nb, h);
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
  int ctas = 0;
  const cudaError_t err =
      persistent_ctas(fn_onehot_kernel, THREADS, smem, n, &ctas);
  if (err != cudaSuccess) return (int)err;
  const Fields f{(const uint8_t*)active, (const uint8_t*)is_inf,
                 (const uint8_t*)has_imm, (const int16_t*)dov,
                 (const uint8_t*)det,    (const int8_t*)st,
                 (const uint8_t*)ever_icu, (const uint8_t*)dout,
                 (const uint8_t*)newly,  (const int*)code};
  const States s{hospitalized, in_icu, recovered, dead};
  if (events) cudaEventRecord((cudaEvent_t)events[0], strm);
  fn_onehot_kernel<<<ctas, THREADS, smem, strm>>>(f, (int*)scratch,
                                                  (float*)out, n, nb, s);
  if (events) cudaEventRecord((cudaEvent_t)events[1], strm);
  return (int)cudaGetLastError();
}
