// Blockwise prefix sum over a virtual concatenation of masked copies.
//
// Replaces reina_tpu/ops/fusedmap.py:fused_concat_prefix (the Pallas
// kernel). With R = n / 128 rows of 128 lanes and logical blocks of blk
// rows (G = R / blk blocks per segment), the output is, for segment s
// and block j (flat block b = s * G + j, in grid order):
//
//   x      = where(codes == s, w, 0) on the (blk, 128) block
//   x_ls   = Hillis-Steele scan of each row's 128 lanes
//   t      = x_ls[:, 127]               (row totals)
//   r      = Hillis-Steele scan of t over the blk rows
//   out_b  = (x_ls + (r - t)) + carry_b,  carry_{b+1} = out_b[last]
//
// which is the reference's float association step for step
// (_hs_prefix_block and the serial carry), so the result equals the
// plain twin bit for bit even for real-valued weights. Each step adds
// +0.0 where the twin's shifted copy is zero. Only additions occur, so
// no FMA contraction can change a rounding.
//
// What bounds it on the card: bytes (each weight and code read once,
// each output written once), and at these sizes the launches: a cold
// launch costs several microseconds. So the three phases run in one
// cooperative launch, separated by grid-wide barriers, with a CTA per SM
// slot (all resident), and the logical block fixes the association, not
// the launch shape:
//
//   1. row totals   one warp per row, 4 rows a warp loaded before any is
//                   summed. A lane holds 4 lanes of a row in registers
//                   (one float4 of w, one int4 of codes). The scan's last
//                   lane is a pairwise tree of the row (row_total), 5
//                   xor-shuffles. One read gives the row totals of all
//                   n_seg segments; the rows stay in registers for
//                   phase 3.
//   2. row offsets  a CTA per logical block: the Hillis-Steele scan of
//                   its blk row totals in shared memory, the row offsets
//                   d = r - t (in place of t) and the block's last value.
//   3. emit         every CTA folds the n_seg * G last values into the
//                   carries, serially in grid order, then scans its rows
//                   (lane_scan: Hillis-Steele steps k = 1, 2 combine the
//                   lane's own values and its left neighbour's, steps
//                   k >= 4 shuffle by k / 4 lanes) and writes
//                   (x_ls + d) + carry as float4.
//
// Values written inside the launch are read back through L2 (__ldcg):
// another SM's L1 may hold the row totals that the offsets replaced.
//
// A count and its picks (csrc/pick.cuh): where the caller passes a count
// pointer, thread 0 of CTA 0 writes the last prefix value as int32 (the
// count of a mask's set positions, what the plain step takes as
// cum[-1].to(int32)) once the carry fold is done, hs_last[nb - 1] +
// carry[nb - 1], the same operations on the same operands as the last
// output, and then makes the picks of its Fold: the day graph's tier
// picks folded into the launch that produces their count.
//
// The sharded form keeps the global layout (rows of the whole agent
// axis, the same logical blocks, the carry in block order) for one slab
// of whole rows, [row0, row0 + Rl): a block may straddle two slabs. It
// is two launches around an all-gather of the row totals:
//
//   prefix_row_totals  phase 1 on the slab's rows (one group a CTA);
//   (the caller all-gathers the slabs' totals, (k, n_seg, Rl) floats)
//   prefix_emit_slab   one cooperative launch: the gathered totals into
//                      the global (n_seg, R) order, phase 2 for every
//                      logical block (each slab needs every block's last
//                      value for the carry chain), then phase 3 on the
//                      slab's rows; CTA 0 also writes each segment's
//                      last prefix value (the carry chain's end) and,
//                      where the caller passes a count pointer, segment
//                      0's as int32, then makes the picks of its Fold,
//                      as the unsharded launch does. Every slab computes
//                      the same global count, so every rank makes the
//                      same picks: the conditionals of each rank's day
//                      graph take the same branches, and the
//                      collectives inside them stay matched.
//
// Every value is computed by the same operations on the same operands
// as in the unsharded launch, so the slab's output equals its part of
// the unsharded output bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pick.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int LANE = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;               // rows a warp holds
constexpr int ROWS_PER_CTA = WARPS * ROWS;
constexpr unsigned FULL = 0xffffffffu;

struct Rows {
  float x[ROWS][4];
  int c[ROWS][4];
};

// Rows g * ROWS_PER_CTA + warp + k * WARPS (k < ROWS) of group g, those
// below R.
__device__ __forceinline__ long long row_of(long long g, int k) {
  return g * ROWS_PER_CTA + threadIdx.x / 32 + k * WARPS;
}

__device__ __forceinline__ void load_rows(const float* __restrict__ w,
                                          const int* __restrict__ codes,
                                          long long R, long long g,
                                          Rows& rows) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const long long row = row_of(g, k);
    if (row >= R) break;
    const long long i = row * LANE + 4 * lane;
    const float4 v = __ldg(reinterpret_cast<const float4*>(w + i));
    rows.x[k][0] = v.x, rows.x[k][1] = v.y, rows.x[k][2] = v.z,
    rows.x[k][3] = v.w;
    if (codes != nullptr) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(codes + i));
      rows.c[k][0] = q.x, rows.c[k][1] = q.y, rows.c[k][2] = q.z,
      rows.c[k][3] = q.w;
    }
  }
}

// Row k masked to segment s (no mask without codes).
__device__ __forceinline__ void masked(const Rows& rows, int k,
                                       bool has_codes, int s, float v[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = (!has_codes || rows.c[k][i] == s) ? rows.x[k][i] : 0.0f;
}

// Hillis-Steele scan of a 128-lane row held by one warp, 4 values a lane
// (row lanes 4 * lane + i): step k adds lane l - k, or +0.0 for l < k.
__device__ __forceinline__ void lane_scan(float v[4], int lane) {
  const bool left = lane >= 1;
  {  // k = 1
    const float u3 = __shfl_up_sync(FULL, v[3], 1);
    const float n0 = v[0] + (left ? u3 : 0.0f);
    const float n1 = v[1] + v[0];
    const float n2 = v[2] + v[1];
    const float n3 = v[3] + v[2];
    v[0] = n0, v[1] = n1, v[2] = n2, v[3] = n3;
  }
  {  // k = 2
    const float u2 = __shfl_up_sync(FULL, v[2], 1);
    const float u3 = __shfl_up_sync(FULL, v[3], 1);
    const float n0 = v[0] + (left ? u2 : 0.0f);
    const float n1 = v[1] + (left ? u3 : 0.0f);
    const float n2 = v[2] + v[0];
    const float n3 = v[3] + v[1];
    v[0] = n0, v[1] = n1, v[2] = n2, v[3] = n3;
  }
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {  // k = 4m: lane l - m, same slot
    float u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __shfl_up_sync(FULL, v[i], m);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = v[i] + (lane >= m ? u[i] : 0.0f);
  }
}

// The row's total as the Hillis-Steele scan leaves it in lane 127: the
// sums it adds into that lane form a balanced pairwise tree (lanes
// 2i + 1 and 2i, then pairs of those, ...), and float addition is
// commutative, so 5 xor-shuffles give the same bits in every lane.
__device__ __forceinline__ float row_total(const float v[4]) {
  float x = (v[3] + v[2]) + (v[1] + v[0]);
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) x = x + __shfl_xor_sync(FULL, x, m);
  return x;
}

// Phase 2 for logical block b: the scan of its row totals tb[0, blk);
// d = r - t in place of t, hs_last[b] = its last output before the
// carry. sm: 3 * blk floats.
__device__ void block_offsets(float* tb, int blk, float* hs_last, int b,
                              float* sm) {
  float* t = sm;        // blk
  float* rb = t + blk;  // 2 * blk
  for (int i = threadIdx.x; i < blk; i += THREADS) {
    const float x = __ldcg(tb + i);
    t[i] = x;
    rb[i] = x;
  }
  __syncthreads();
  int cur = 0;
  for (int k = 1; k < blk; k <<= 1) {
    for (int i = threadIdx.x; i < blk; i += THREADS) {
      const float x = rb[cur * blk + i];
      const float y = i >= k ? rb[cur * blk + i - k] : 0.0f;
      rb[(1 - cur) * blk + i] = x + y;
    }
    cur ^= 1;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < blk; i += THREADS)
    tb[i] = rb[cur * blk + i] - t[i];
  if (threadIdx.x == 0)
    hs_last[b] = t[blk - 1] + (rb[cur * blk + blk - 1] - t[blk - 1]);
  __syncthreads();
}

// carry[b] = the serial fold of hs_last[< b], b < nb, by one warp: 32
// block values loaded at a time, folded in order by every lane alike
// (lane k stores the carry of block j0 + k).
__device__ void fold_carries(const float* hs_last, int nb, float* carry) {
  const int lane = threadIdx.x % 32;
  float c = 0.0f;
  for (int j0 = 0; j0 < nb; j0 += 32) {
    const int j = j0 + lane;
    const float h = j < nb ? __ldcg(hs_last + j) : 0.0f;
    const int m = min(32, nb - j0);
    for (int k = 0; k < m; ++k) {
      const float hk = __shfl_sync(FULL, h, k);
      if (lane == k) carry[j] = c;
      c = hk + c;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
prefix_fused(const float* __restrict__ w, const int* __restrict__ codes,
             long long R, int n_seg, int blk, float* td, float* hs_last,
             float* __restrict__ out, int* count, reina::Fold fold) {
  extern __shared__ float sm[];  // max(3 * blk, n_seg * G) floats
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x % 32;
  const bool has_codes = codes != nullptr;
  const long long groups = (R + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  const int G = (int)(R / blk), nb = n_seg * G;
  // this CTA's groups are blockIdx.x + m * gridDim.x; phase 1 walks them
  // last first, so that the registers end up holding the first
  Rows rows;
  const long long mine =
      blockIdx.x < groups ? (groups - 1 - blockIdx.x) / gridDim.x : -1;
  for (long long m = mine; m >= 0; --m) {
    const long long g = blockIdx.x + m * gridDim.x;
    load_rows(w, codes, R, g, rows);
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const long long row = row_of(g, k);
      if (row >= R) break;
      for (int s = 0; s < n_seg; ++s) {
        float v[4];
        masked(rows, k, has_codes, s, v);
        const float t = row_total(v);
        if (lane == 31) td[s * R + row] = t;
      }
    }
  }
  grid.sync();
  for (int b = blockIdx.x; b < nb; b += gridDim.x)
    block_offsets(td + (long long)b * blk, blk, hs_last, b, sm);
  grid.sync();
  if (threadIdx.x < 32) fold_carries(hs_last, nb, sm);
  __syncthreads();
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    *count = (int)(__ldcg(hs_last + nb - 1) + sm[nb - 1]);
    reina::take_fold(fold);
  }
  for (long long m = 0; m <= mine; ++m) {
    const long long g = blockIdx.x + m * gridDim.x;
    if (m > 0) load_rows(w, codes, R, g, rows);
    for (int s = 0; s < n_seg; ++s) {
      float dr[ROWS];   // the row offsets, all loaded before any scan
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const long long row = row_of(g, k);
        dr[k] = row < R ? __ldcg(td + s * R + row) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const long long row = row_of(g, k);
        if (row >= R) break;
        float v[4];
        masked(rows, k, has_codes, s, v);
        lane_scan(v, lane);
        const float cb = sm[s * G + (int)(row / blk)];
        float4 o;
        o.x = (v[0] + dr[k]) + cb;
        o.y = (v[1] + dr[k]) + cb;
        o.z = (v[2] + dr[k]) + cb;
        o.w = (v[3] + dr[k]) + cb;
        *reinterpret_cast<float4*>(out + (s * R + row) * LANE + 4 * lane) =
            o;
      }
    }
  }
}


// Phase 1 of a slab: td[s * R + row] = the row total of segment s.
__global__ void __launch_bounds__(THREADS)
prefix_row_totals(const float* __restrict__ w, const int* __restrict__ codes,
                  long long R, int n_seg, float* __restrict__ td) {
  const int lane = threadIdx.x % 32;
  const long long g = blockIdx.x;
  Rows rows;
  load_rows(w, codes, R, g, rows);
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const long long row = row_of(g, k);
    if (row >= R) break;
    for (int s = 0; s < n_seg; ++s) {
      float v[4];
      masked(rows, k, codes != nullptr, s, v);
      const float t = row_total(v);
      if (lane == 31) td[s * R + row] = t;
    }
  }
}

// Phases 2 and 3 of a slab of Rl rows from global row row0, out of R:
// gathered holds the (k, n_seg, Rl) row totals of every slab, td takes
// them in (n_seg, R) order and then the row offsets. out: the slab's
// (n_seg, Rl * 128) prefix; ends[s]: segment s's last prefix value.
__global__ void __launch_bounds__(THREADS)
prefix_emit_slab(const float* __restrict__ w, const int* __restrict__ codes,
                 const float* __restrict__ gathered, long long Rl,
                 long long R, long long row0, int n_seg, int blk, float* td,
                 float* hs_last, float* __restrict__ out,
                 float* __restrict__ ends, int* count, reina::Fold fold) {
  extern __shared__ float sm[];  // max(3 * blk, n_seg * G) floats
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x % 32;
  const bool has_codes = codes != nullptr;
  const int G = (int)(R / blk), nb = n_seg * G;
  const long long total = (long long)n_seg * R;
  for (long long x = (long long)blockIdx.x * THREADS + threadIdx.x;
       x < total; x += (long long)gridDim.x * THREADS) {
    const long long s = x / R, r = x % R, j = r / Rl;
    td[x] = __ldg(gathered + (j * n_seg + s) * Rl + r % Rl);
  }
  grid.sync();
  for (int b = blockIdx.x; b < nb; b += gridDim.x)
    block_offsets(td + (long long)b * blk, blk, hs_last, b, sm);
  grid.sync();
  if (threadIdx.x < 32) fold_carries(hs_last, nb, sm);
  __syncthreads();
  if (blockIdx.x == 0 && (int)threadIdx.x < n_seg) {
    const int b = (threadIdx.x + 1) * G - 1;
    ends[threadIdx.x] = __ldcg(hs_last + b) + sm[b];
  }
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    *count = (int)(__ldcg(hs_last + G - 1) + sm[G - 1]);
    reina::take_fold(fold);
  }
  const long long groups = (Rl + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    Rows rows;
    load_rows(w, codes, Rl, g, rows);
    for (int s = 0; s < n_seg; ++s) {
      float dr[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const long long row = row_of(g, k);
        dr[k] = row < Rl ? __ldcg(td + s * R + row0 + row) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const long long row = row_of(g, k);
        if (row >= Rl) break;
        float v[4];
        masked(rows, k, has_codes, s, v);
        lane_scan(v, lane);
        const float cb = sm[s * G + (int)((row0 + row) / blk)];
        float4 o;
        o.x = (v[0] + dr[k]) + cb;
        o.y = (v[1] + dr[k]) + cb;
        o.z = (v[2] + dr[k]) + cb;
        o.w = (v[3] + dr[k]) + cb;
        *reinterpret_cast<float4*>(out + (s * Rl + row) * LANE + 4 * lane) =
            o;
      }
    }
  }
}
}  // namespace

// n % 1024 == 0, (n / 128) % blk == 0, w and codes 16-byte aligned.
// scratch (floats): n_seg * n / 128 row totals / offsets, then n_seg * G
// block values. count: NULL, or an int32 on the device that takes the
// last prefix value; fold: NULL, or the picks to make once it is written
// (host memory, as daygraph.cu's reina_fold_set fills it). events: NULL,
// or 2 CUDA events recorded before and after the launch.
extern "C" int reina_concat_prefix(const void* w, const void* codes,
                                   void* out, void* scratch, long long n,
                                   int n_seg, int blk, void* count,
                                   const void* fold, void* const* events,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long R = n / LANE;
  const int nb = n_seg * (int)(R / blk);
  float* td = (float*)scratch;
  float* hs_last = td + (long long)n_seg * R;
  size_t smem = (size_t)max(3 * blk, nb) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      prefix_fused, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prefix_fused,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (R + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  const unsigned ctas = (unsigned)min((long long)sms * per_sm, groups);
  const float* wp = (const float*)w;
  const int* cp = (const int*)codes;
  float* op = (float*)out;
  int* np = (int*)count;
  reina::Fold f = fold == nullptr ? reina::Fold{} : *(const reina::Fold*)fold;
  void* args[] = {&wp, &cp, &R, &n_seg, &blk, &td, &hs_last, &op, &np, &f};
  if (events) cudaEventRecord((cudaEvent_t)events[0], st);
  err = cudaLaunchCooperativeKernel((const void*)prefix_fused, dim3(ctas),
                                    dim3(THREADS), args, smem, st);
  if (events) cudaEventRecord((cudaEvent_t)events[1], st);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The sharded form, launch 1, on a slab of n agents (n % 128 == 0):
// td (floats, n_seg * n / 128) gets the row totals of each segment.
// events: NULL, or 2 CUDA events recorded before and after the launch.
extern "C" int reina_prefix_row_totals(const void* w, const void* codes,
                                       void* td, long long n, int n_seg,
                                       void* const* events, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long R = n / LANE;
  const long long groups = (R + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  if (events) cudaEventRecord((cudaEvent_t)events[0], st);
  prefix_row_totals<<<(unsigned)groups, THREADS, 0, st>>>(
      (const float*)w, (const int*)codes, R, n_seg, (float*)td);
  if (events) cudaEventRecord((cudaEvent_t)events[1], st);
  return (int)cudaGetLastError();
}

// The sharded form, launch 2, on a slab of n agents from global agent
// row0 * 128 of n_global (n_global % 1024 == 0, (n_global / 128) % blk
// == 0, n % 128 == 0): gathered holds the (k, n_seg, n / 128) row
// totals of all k = n_global / n slabs in slab order. out: (n_seg, n)
// floats, ends: (n_seg,) floats. scratch (floats): n_seg * n_global /
// 128 row totals / offsets, then n_seg * G block values. count, fold: as
// reina_concat_prefix's, of segment 0's last value. events: as
// reina_prefix_row_totals'.
extern "C" int reina_prefix_emit_slab(const void* w, const void* codes,
                                      const void* gathered, void* out,
                                      void* ends, void* scratch, long long n,
                                      long long n_global, long long row0,
                                      int n_seg, int blk, void* count,
                                      const void* fold, void* const* events,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long Rl = n / LANE, R = n_global / LANE;
  const int nb = n_seg * (int)(R / blk);
  float* td = (float*)scratch;
  float* hs_last = td + (long long)n_seg * R;
  size_t smem = (size_t)max(3 * blk, nb) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      prefix_emit_slab, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, prefix_emit_slab, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (Rl + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  const unsigned ctas =
      (unsigned)min((long long)sms * per_sm, max(groups, (long long)nb));
  const float* wp = (const float*)w;
  const int* cp = (const int*)codes;
  const float* gp = (const float*)gathered;
  float* op = (float*)out;
  float* ep = (float*)ends;
  int* np = (int*)count;
  reina::Fold f = fold == nullptr ? reina::Fold{} : *(const reina::Fold*)fold;
  void* args[] = {&wp, &cp, &gp, &Rl, &R, &row0, &n_seg, &blk,
                  &td, &hs_last, &op, &ep, &np, &f};
  if (events) cudaEventRecord((cudaEvent_t)events[0], st);
  err = cudaLaunchCooperativeKernel((const void*)prefix_emit_slab,
                                    dim3(ctas), dim3(THREADS), args, smem, st);
  if (events) cudaEventRecord((cudaEvent_t)events[1], st);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
