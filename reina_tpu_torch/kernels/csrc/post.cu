// The day step's post-ledger pass: bed and ICU grants applied,
// denied-care deaths drawn, the day's state transitions.
//
// Replaces reina_tpu/ops/fusedmap.py:fused_map (the Pallas kernel) for
// its body reina_tpu/core/step.py:_phase5_post. Its plain twin is
// reina_tpu_torch/core/step.py:post: its bool algebra runs here on four
// agents' bytes at once, its float arithmetic agent by agent, operation
// for operation.
//
// What bounds it on the card: bytes. 20 streams in and 7 out, 35 bytes
// an agent, 59.0 MB at HUS size; 24 of the 27 streams are one byte wide
// (14 bools, and st, sev and var as int8), o2r and u are float32, dl_a
// and dl int16. The design, in one launch:
//
//   * a thread takes 16 consecutive agents a step (vec16.cuh): 27
//     16-byte words in (one for each byte stream, four for o2r and for
//     u, two for dl_a) and 8 out (one for st and for each bool, two for
//     dl). A lane-per-agent pass makes each byte stream a one-byte access;
//   * the words in are copied to shared memory with cp.async, a ring of
//     STAGES steps a thread: while a thread computes one step, the copies
//     of its next steps are in flight, and they hold no registers. Each
//     thread reads back only the words it copied, so no CTA barrier is
//     needed;
//   * the arithmetic takes a 32-bit word of every byte stream at a time
//     (post_four): the grants, denials, transitions and bool outputs are
//     bitwise operations and byte selects on four agents at once; only
//     the two denial draws and the two day counts are taken agent by
//     agent;
//   * a persistent grid sized by occupancy; the four V-entry tables
//     (ratio_before_hosp, ratio_in_ward, p_icu_death_no_beds,
//     p_hosp_death_no_beds) go to shared memory once a CTA;
//   * the n % 16 tail goes through post_four too, one agent a thread of
//     the first CTA, as byte 0 of its words.
//
// Numerics, bit-equal to the twin: hosp_days and icu_days are
// floor(o2r * x + 0.5) in float32 with the product and the sum each
// rounded on its own (__fmul_rn and __fadd_rn keep nvcc from contracting
// them into an FMA that the twin does not do), and 1 - rw - rb is taken
// in the twin's order. The floor narrows to int16 as the twin's
// .to(int16) does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int STAGES = 2;  // steps a thread has in shared memory at once

// reina_tpu_torch/core/constants.py (kernels/fused_bodies.py asserts them)
constexpr int ILLNESS = 2, HOSPITALIZED = 3, IN_ICU = 4, RECOVERED = 5,
              DEAD = 6;
constexpr int SEVERE = 2, CRITICAL = 3, FATAL = 4;

// the byte streams; then the 16-byte words a thread stages for a step:
// one for each byte stream, four of o2r, four of u, two of dl_a
enum {
  ST, SEV, VAR, GBED, GICU, BED_REQ, ICU_REQ, DIE_HOME, RECOVER_ILL,
  HOSP_RECOVER, ICU_DIE, ICU_RECOVER, WDET, ISINF, HASIMM, EVERICU, ONSET,
  N_BYTES
};
constexpr int O2R = N_BYTES, U = O2R + 4, DL_A = U + 4, WORDS = DL_A + 2;

struct In {
  const uint8_t* b[N_BYTES];
  const float *o2r, *u;
  const int16_t* dl_a;
};

struct Out {
  int8_t* st;
  int16_t* dl;
  uint8_t *isinf, *hasimm, *evericu, *wdet, *detect_hosp;
};

struct Tables {
  const float* p[4];
};

constexpr unsigned ONES = 0x01010101u;  // 1 in each byte

// _round_to_int(o2r * x): floor(f + 0.5) as int16, widened
__device__ __forceinline__ int round_days(float o2r, float x) {
  return (int)(short)floorf(__fadd_rn(__fmul_rn(o2r, x), 0.5f));
}

// w with its bytes where m's byte is 1 set to v's bytes
__device__ __forceinline__ unsigned select_bytes(unsigned w, unsigned m,
                                                 unsigned v) {
  const unsigned mask = m * 0xffu;
  return (w & ~mask) | (v & mask);
}

// Four agents at once. b: their byte streams as 32-bit words, agent a in
// byte a (bools are 0 or 1, as torch.bool stores them), so the twin's
// bool algebra runs on whole words; o2r, u: their floats; dl: dl_a's
// halves in two words. Only the denial draws and the day counts are
// taken agent by agent. o: st, dl (two words), isinf, hasimm, evericu,
// wdet, detect_hosp as words. tab: rb, rw, p_icu, p_hosp, V entries each.
__device__ __forceinline__ void post_four(const unsigned (&b)[N_BYTES],
                                          const float (&o2r)[4],
                                          const float (&u)[4],
                                          const unsigned (&dl)[2],
                                          const float* tab, int V,
                                          unsigned (&o)[8]) {
  const unsigned hospitalized_now = b[BED_REQ] & b[GBED];
  const unsigned bed_denied = b[BED_REQ] & ~b[GBED];
  const unsigned icu_denied = b[ICU_REQ] & ~b[GICU];
  unsigned die = 0, icu_die = 0;  // the denial draws: u < the chance
  int hosp_days[4], icu_days[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int sev = (int)(int8_t)(b[SEV] >> (8 * a));
    const int var = (int)(int8_t)(b[VAR] >> (8 * a));
    const int vt = var >= 1 && var < V ? var : 0;
    const float rb = tab[vt], rw = tab[V + vt], p_icu = tab[2 * V + vt],
                p_hosp = tab[3 * V + vt];
    const float die_chance =
        sev == FATAL ? 1.0f : sev == CRITICAL ? p_icu : p_hosp;
    die |= (unsigned)(u[a] < die_chance) << (8 * a);
    icu_die |= (unsigned)(u[a] < (sev == FATAL ? 1.0f : p_icu)) << (8 * a);
    hosp_days[a] =
        round_days(o2r[a], sev == SEVERE ? __fsub_rn(1.0f, rb) : rw);
    icu_days[a] = round_days(o2r[a], __fsub_rn(__fsub_rn(1.0f, rw), rb));
  }
  const unsigned denied_die = bed_denied & die;
  const unsigned icu_denied_die = icu_denied & icu_die;
  const unsigned icu_enter =
      (b[ICU_REQ] & b[GICU]) | (icu_denied & ~icu_denied_die);
  const unsigned dies =
      b[DIE_HOME] | denied_die | icu_denied_die | b[ICU_DIE];
  const unsigned recovers = b[RECOVER_ILL] | (bed_denied & ~denied_die) |
                            b[HOSP_RECOVER] | b[ICU_RECOVER];
  unsigned st = b[ST];
  st = select_bytes(st, b[ONSET], ILLNESS * ONES);
  st = select_bytes(st, hospitalized_now, HOSPITALIZED * ONES);
  st = select_bytes(st, icu_enter, IN_ICU * ONES);
  st = select_bytes(st, recovers, RECOVERED * ONES);
  st = select_bytes(st, dies, DEAD * ONES);
  o[0] = st;
  o[1] = o[2] = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    int d = (int)(int16_t)(dl[a >> 1] >> (16 * (a & 1)));
    if ((hospitalized_now >> (8 * a)) & 1) d = hosp_days[a];
    if ((icu_enter >> (8 * a)) & 1) d = icu_days[a];
    o[1 + (a >> 1)] |= ((unsigned)d & 0xffffu) << (16 * (a & 1));
  }
  const unsigned gone = dies | recovers;
  o[3] = b[ISINF] & ~gone;
  o[4] = b[HASIMM] | (gone & b[ISINF]);
  o[5] = b[EVERICU] | icu_enter;
  o[6] = b[WDET] | b[BED_REQ];
  o[7] = b[BED_REQ] & ~b[WDET];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's newest groups are in
// flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// copy the WORDS words of agents [i0, i0 + 16) to this thread's slot s,
// word k at s[k * THREADS]
__device__ __forceinline__ void stage(const In& in, uint4* s, long long i0) {
#pragma unroll
  for (int k = 0; k < N_BYTES; ++k) cp_async16(s + k * THREADS, in.b[k] + i0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    cp_async16(s + (O2R + q) * THREADS, in.o2r + i0 + 4 * q);
    cp_async16(s + (U + q) * THREADS, in.u + i0 + 4 * q);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    cp_async16(s + (DL_A + q) * THREADS, in.dl_a + i0 + 8 * q);
}

// shared memory: STAGES * WORDS * THREADS words, then the 4 * V tables
__global__ void __launch_bounds__(THREADS)
    post_kernel(In in, Tables t, int V, Out out, long long n) {
  extern __shared__ uint4 ring[];
  float* tab = reinterpret_cast<float*>(ring + STAGES * WORDS * THREADS);
  for (int i = threadIdx.x; i < 4 * V; i += THREADS)
    tab[i] = t.p[i / V][i % V];
  __syncthreads();
  const long long nvec = n / VEC;
  const long long stride = (long long)gridDim.x * THREADS;
  long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  uint4* mine = ring + threadIdx.x;
  constexpr int SLOT = WORDS * THREADS;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    const long long w = v + k * stride;
    if (w < nvec) stage(in, mine + k * SLOT, w * VEC);
    cp_async_commit();
  }
  for (int slot = 0; v < nvec; v += stride, slot = (slot + 1) % STAGES) {
    const long long ahead = v + (STAGES - 1) * stride;
    if (ahead < nvec)
      stage(in, mine + (slot + STAGES - 1) % STAGES * SLOT, ahead * VEC);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this step's words have landed
    const uint4* s = mine + slot * SLOT;
    uint4 w[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) w[k] = s[k * THREADS];
    uint4 out_w[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // agents 4q .. 4q + 3
      unsigned b[N_BYTES], dl[2], o[8];
      float o2r[4], u[4];
#pragma unroll
      for (int k = 0; k < N_BYTES; ++k) b[k] = word_of(w[k], q);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        o2r[a] = __uint_as_float(word_of(w[O2R + q], a));
        u[a] = __uint_as_float(word_of(w[U + q], a));
      }
      dl[0] = word_of(w[DL_A + (q >> 1)], 2 * (q & 1));
      dl[1] = word_of(w[DL_A + (q >> 1)], 2 * (q & 1) + 1);
      post_four(b, o2r, u, dl, tab, V, o);
      // st and the bools: word q of their 16 bytes; dl: words 2q, 2q + 1
      // of its 8
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k == 1 || k == 2) {
          word_at(out_w[1 + (q >> 1)], 2 * (q & 1) + (k - 1)) = o[k];
        } else {
          word_at(out_w[k], q) = o[k];
        }
      }
    }
    const long long i0 = v * VEC;
    st16(out.st, i0, out_w[0]);
    st16(out.dl, 2 * i0, out_w[1]);
    st16(out.dl, 2 * i0 + 16, out_w[2]);
    st16(out.isinf, i0, out_w[3]);
    st16(out.hasimm, i0, out_w[4]);
    st16(out.evericu, i0, out_w[5]);
    st16(out.wdet, i0, out_w[6]);
    st16(out.detect_hosp, i0, out_w[7]);
  }
  // the n % 16 tail, one agent a thread of the first CTA, as byte 0 of
  // post_four's words
  const long long i = nvec * VEC + (long long)blockIdx.x * THREADS +
                      threadIdx.x;
  if (i < n) {
    unsigned b[N_BYTES], o[8];
#pragma unroll
    for (int k = 0; k < N_BYTES; ++k) b[k] = in.b[k][i];
    const float o2r[4] = {in.o2r[i], 0, 0, 0}, u[4] = {in.u[i], 0, 0, 0};
    const unsigned dl[2] = {(unsigned short)in.dl_a[i], 0};
    post_four(b, o2r, u, dl, tab, V, o);
    out.st[i] = (int8_t)o[0];
    out.dl[i] = (int16_t)o[1];
    out.isinf[i] = (uint8_t)o[3];
    out.hasimm[i] = (uint8_t)o[4];
    out.evericu[i] = (uint8_t)o[5];
    out.wdet[i] = (uint8_t)o[6];
    out.detect_hosp[i] = (uint8_t)o[7];
  }
}

}  // namespace

// ins: the 20 (n,) streams of core/step.py:post in its argument order
// (bools as bytes), outs: its 7 results (st int8, dl int16, 5 bools as
// bytes), each stream 16-byte aligned; tables: the 4 (V,) float32
// tables. events: NULL, or 2 CUDA events recorded before and after the
// launch.
extern "C" int reina_post(const void* const* ins, const void* const* tables,
                          int V, void* const* outs, long long n,
                          void* const* events, void* stream) {
  cudaStream_t strm = (cudaStream_t)stream;
  const size_t smem = (size_t)STAGES * WORDS * THREADS * sizeof(uint4) +
                      4 * (size_t)V * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      post_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = persistent_ctas(post_kernel, THREADS, smem, n, &ctas);
  if (err != cudaSuccess) return (int)err;
  In in;
  const int byte_arg[N_BYTES] = {0, 1, 2, 5, 6, 8, 9, 10, 11,
                                 12, 13, 14, 15, 16, 17, 18, 19};
  for (int k = 0; k < N_BYTES; ++k)
    in.b[k] = (const uint8_t*)ins[byte_arg[k]];
  in.o2r = (const float*)ins[3];
  in.dl_a = (const int16_t*)ins[4];
  in.u = (const float*)ins[7];
  const Out out{(int8_t*)outs[0],  (int16_t*)outs[1], (uint8_t*)outs[2],
                (uint8_t*)outs[3], (uint8_t*)outs[4], (uint8_t*)outs[5],
                (uint8_t*)outs[6]};
  const Tables t{{(const float*)tables[0], (const float*)tables[1],
                  (const float*)tables[2], (const float*)tables[3]}};
  if (events) cudaEventRecord((cudaEvent_t)events[0], strm);
  post_kernel<<<ctas, THREADS, smem, strm>>>(in, t, V, out, n);
  if (events) cudaEventRecord((cudaEvent_t)events[1], strm);
  return (int)cudaGetLastError();
}
