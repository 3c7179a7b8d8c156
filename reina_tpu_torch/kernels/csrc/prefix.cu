// Blockwise prefix sum over a virtual concatenation of masked copies.
//
// Replaces reina_tpu/ops/fusedmap.py:fused_concat_prefix (the Pallas
// kernel). With R = n / 128 rows of 128 lanes and blocks of blk rows
// (G = R / blk blocks per segment), the output is, for segment s and
// block j (flat block b = s * G + j, in grid order):
//
//   x      = where(codes == s, w, 0) on the (blk, 128) block
//   x_ls   = Hillis-Steele scan of each row's 128 lanes
//   t      = x_ls[:, 127]               (row totals)
//   r      = Hillis-Steele scan of t over the blk rows
//   out_b  = (x_ls + (r - t)) + carry_b,  carry_{b+1} = out_b[last]
//
// which is the reference's float association step for step
// (_hs_prefix_block and the serial carry), so the result equals the
// plain twin bit for bit even for real-valued weights. Only additions
// occur, so no FMA contraction can change a rounding.
//
// What bounds it on the card: bytes. It reads the weights and codes
// twice per segment and writes the output once, ~60 MB for the two-
// segment pass at HUS size. The Pallas kernel carried the running total
// from one grid step to the next; here the carry is split out: pass A
// scans each block's rows and row totals, one thread folds the n_seg * G
// block totals in grid order (9 per segment at HUS size), and pass C
// rescans the rows and adds the row offsets and the block's carry.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Load one row (lanes 4*lane .. 4*lane+3 of this thread), masked to
// segment s.
__device__ __forceinline__ void load_row(const float* w, const int* codes,
                                         long long row, int seg, int lane,
                                         float v[4]) {
  const long long i = row * LANE + 4 * lane;
  const float4 x = *reinterpret_cast<const float4*>(w + i);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
  if (codes != nullptr) {
    const int4 c = *reinterpret_cast<const int4*>(codes + i);
    v[0] = c.x == seg ? v[0] : 0.0f;
    v[1] = c.y == seg ? v[1] : 0.0f;
    v[2] = c.z == seg ? v[2] : 0.0f;
    v[3] = c.w == seg ? v[3] : 0.0f;
  }
}

// Hillis-Steele scan of a 128-lane row held by one warp, through a
// per-warp double buffer: step k adds lane l-k (or 0) to lane l.
__device__ void lane_scan(float* sb, int lane, float v[4]) {
  int cur = 0;
  for (int i = 0; i < 4; ++i) sb[4 * lane + i] = v[i];
  __syncwarp();
  for (int k = 1; k < LANE; k <<= 1) {
    for (int i = 0; i < 4; ++i) {
      const int l = 4 * lane + i;
      const float x = sb[cur * LANE + l];
      const float y = l >= k ? sb[cur * LANE + l - k] : 0.0f;
      sb[(1 - cur) * LANE + l] = x + y;
    }
    cur ^= 1;
    __syncwarp();
  }
  for (int i = 0; i < 4; ++i) v[i] = sb[cur * LANE + 4 * lane + i];
  __syncwarp();
}

// Pass A: row totals, their Hillis-Steele scan, the per-row offsets
// (r - t) and the block's last value.
__global__ void prefix_rows(const float* w, const int* codes, int G, int blk,
                            float* dscr, float* hs_last) {
  extern __shared__ float smem[];
  float* t = smem;                  // blk
  float* rb = t + blk;              // 2 * blk
  float* wb = rb + 2 * blk;         // WARPS * 2 * LANE
  const int b = blockIdx.x;
  const int seg = b / G, j = b % G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sb = wb + warp * 2 * LANE;
  for (int rr = warp; rr < blk; rr += WARPS) {
    float v[4];
    load_row(w, codes, (long long)j * blk + rr, seg, lane, v);
    lane_scan(sb, lane, v);
    if (lane == 31) t[rr] = v[3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < blk; i += THREADS) rb[i] = t[i];
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
    dscr[(long long)b * blk + i] = rb[cur * blk + i] - t[i];
  if (threadIdx.x == 0)
    hs_last[b] = t[blk - 1] + (rb[cur * blk + blk - 1] - t[blk - 1]);
}

// The serial carry across blocks in grid order.
__global__ void prefix_carry(const float* hs_last, float* carry, int nb) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  float c = 0.0f;
  for (int b = 0; b < nb; ++b) {
    carry[b] = c;
    c = hs_last[b] + c;
  }
}

// Pass C: rescan each row and write (x_ls + (r - t)) + carry.
__global__ void prefix_emit(const float* w, const int* codes, int G, int blk,
                            const float* dscr, const float* carry,
                            float* out) {
  __shared__ float wbuf[WARPS * 2 * LANE];
  const int b = blockIdx.x;
  const int seg = b / G, j = b % G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sb = wbuf + warp * 2 * LANE;
  const float cb = carry[b];
  for (int rr = warp; rr < blk; rr += WARPS) {
    float v[4];
    load_row(w, codes, (long long)j * blk + rr, seg, lane, v);
    lane_scan(sb, lane, v);
    const float d = dscr[(long long)b * blk + rr];
    float4 o;
    o.x = (v[0] + d) + cb;
    o.y = (v[1] + d) + cb;
    o.z = (v[2] + d) + cb;
    o.w = (v[3] + d) + cb;
    *reinterpret_cast<float4*>(out + ((long long)b * blk + rr) * LANE +
                               4 * lane) = o;
  }
}

}  // namespace

// n % 128 == 0, (n / 128) % blk == 0. scratch: n_seg * n / 128 row
// offsets, then n_seg * G block totals, then n_seg * G carries (floats).
extern "C" int reina_concat_prefix(const void* w, const void* codes,
                                   void* out, void* scratch, long long n,
                                   int n_seg, int blk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long R = n / LANE;
  const int G = (int)(R / blk);
  const int nb = n_seg * G;
  float* dscr = (float*)scratch;
  float* hs_last = dscr + (long long)n_seg * R;
  float* carry = hs_last + nb;
  const size_t smem = (size_t)(3 * blk + WARPS * 2 * LANE) * sizeof(float);
  cudaFuncSetAttribute(prefix_rows,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  prefix_rows<<<nb, THREADS, smem, st>>>((const float*)w, (const int*)codes,
                                         G, blk, dscr, hs_last);
  prefix_carry<<<1, 32, 0, st>>>(hs_last, carry, nb);
  prefix_emit<<<nb, THREADS, 0, st>>>((const float*)w, (const int*)codes, G,
                                      blk, dscr, carry, (float*)out);
  return (int)cudaGetLastError();
}
