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
// axis, the same logical blocks, the carry in block order) for slab
// ``index`` of k equal slabs of whole rows, [a, a + Rl) of R: a block may
// straddle slab edges. A block wholly inside one slab needs only that
// slab's row totals; a block that straddles needs every row total of it,
// from the slabs it spans. So each slab sends the others, a segment at a
// time, a message of M floats: the row totals of its head and tail rows
// (those in blocks that straddle its edges), then the last value of each
// of its whole blocks. Two launches around the all-gather of the
// messages, neither cooperative, no grid barrier:
//
//   prefix_slab_totals  phase 1 on the slab's rows (one group a CTA),
//                       the head's and tail's totals into the message; a
//                       ticket a whole block (atomicAdd of the rows done)
//                       finds the CTA that completes the block, and that
//                       CTA writes its last value into the message by
//                       block_last (the scan's last output as a pairwise
//                       tree, no scan);
//   (the caller all-gathers the messages, (k, n_seg, M) floats)
//   prefix_slab_emit    a CTA takes a role by a ticket (atomicAdd at its
//                       start, so the first roles are taken by CTAs that
//                       already run): a CTA a block of a segment that the
//                       slab shares rows with does its phase 2 (the row
//                       offsets of the slab's rows), a CTA a block that
//                       straddles a slab edge its last value (block_last,
//                       from the gathered totals), then each raises its
//                       flag; every other CTA loads its group of rows,
//                       waits for the flags, folds every block's last
//                       value into the carries (each CTA alike) and runs
//                       phase 3 on its rows. The CTA of group 0 writes
//                       each segment's last prefix value and, where the
//                       caller passes a count pointer, segment 0's as
//                       int32, then makes the picks of its Fold, as the
//                       unsharded launch does. Every slab computes the
//                       same global count, so every rank makes the same
//                       picks: the conditionals of each rank's day graph
//                       take the same branches, and the collectives
//                       inside them stay matched.
//
// So a slab scans only the blocks it shares rows with, and takes every
// other block's last value from the message of the slab that holds it,
// or, for a block that straddles a slab edge, by a reduction. The tickets
// and flags are scratch that each launch leaves zeroed (its last CTA
// zeroes them), so no memset goes before a launch. What bounds both
// launches is their latency, not their bytes: a slab's rows are a few MB.
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

// The Hillis-Steele scan of blk row totals held twice in sm, at
// [0, blk) and [blk, 2 blk): the scan ends in sm + blk + cur * blk, and
// cur is returned. Step k adds the value k rows before, or +0.0.
__device__ int hs_rows(float* sm, int blk) {
  float* rb = sm + blk;
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
  return cur;
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
  const int cur = hs_rows(sm, blk);
  for (int i = threadIdx.x; i < blk; i += THREADS)
    tb[i] = rb[cur * blk + i] - t[i];
  if (threadIdx.x == 0)
    hs_last[b] = t[blk - 1] + (rb[cur * blk + blk - 1] - t[blk - 1]);
  __syncthreads();
}

// carry[b] = the serial fold of last(j), j < b, for b < nb, by one warp:
// 32 block values loaded at a time, folded in order by every lane alike
// (lane k stores the carry of block j0 + k).
template <class Last>
__device__ void fold_carries(const Last& last, int nb, float* carry) {
  const int lane = threadIdx.x % 32;
  float c = 0.0f;
  for (int j0 = 0; j0 < nb; j0 += 32) {
    const int j = j0 + lane;
    const float h = j < nb ? last(j) : 0.0f;
    const int m = min(32, nb - j0);
    for (int k = 0; k < m; ++k) {
      const float hk = __shfl_sync(FULL, h, k);
      if (lane == k) carry[j] = c;
      c = hk + c;
    }
  }
}

// The blocks' last values of the unsharded launch, written inside it.
struct InLaunch {
  const float* hs_last;
  __device__ float operator()(int j) const { return __ldcg(hs_last + j); }
};

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
  if (threadIdx.x < 32) fold_carries(InLaunch{hs_last}, nb, sm);
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


// A slab's place in the global rows: slab j holds rows [a, a + Rl); its
// h head rows [a, a + h) and t tail rows [a + Rl - t, a + Rl) lie in
// blocks that straddle a slab edge, its W whole blocks from block fw lie
// inside it. Its message (a segment) is the head's and the tail's row
// totals, then the whole blocks' last values. Rows are int: R < 2^31.
struct Slab {
  int a, h, t, fw, W;
};

__host__ __device__ inline Slab slab_of(int Rl, int blk, int j) {
  Slab sl;
  sl.a = j * Rl;
  const int b = sl.a + Rl;
  const int fws = (sl.a + blk - 1) / blk * blk, lwe = b / blk * blk;
  sl.h = (fws < b ? fws : b) - sl.a;
  sl.t = b - (lwe > sl.a + sl.h ? lwe : sl.a + sl.h);
  sl.W = lwe > fws ? (lwe - fws) / blk : 0;
  sl.fw = fws / blk;
  return sl;
}

// strad[0, S): the blocks of a segment that straddle a slab edge, in
// order (strad NULL: only counted); returns S.
__host__ __device__ inline int straddling(int Rl, int blk, int k,
                                          int* strad) {
  int S = 0, prev = -1;
  for (int e = 1; e < k; ++e) {
    const int r = e * Rl;
    if (r % blk == 0 || r / blk == prev) continue;
    prev = r / blk;
    if (strad) strad[S] = prev;
    ++S;
  }
  return S;
}

// The blocks of a segment that slab index's emit takes roles for, into
// uni[0, U) (NULL: only counted): its own blocks (those it shares rows
// with), then the straddling blocks outside them (strad[0, S)); returns
// U.
__host__ __device__ inline int role_blocks(int Rl, int blk, int index,
                                           const int* strad, int S,
                                           int* uni) {
  const int b0 = index * Rl / blk, b1 = (index * Rl + Rl - 1) / blk;
  int U = 0;
  for (int B = b0; B <= b1; ++B, ++U)
    if (uni) uni[U] = B;
  for (int i = 0; i < S; ++i)
    if (strad[i] < b0 || strad[i] > b1) {
      if (uni) uni[U] = strad[i];
      ++U;
    }
  return U;
}

// The last value of phase 2 (block_offsets' hs_last) of the blk <= 2048
// row totals that row(i) gives, without the scan: the Hillis-Steele
// scan's last output adds at step k the sum of the k rows before its own
// k, so it is a balanced pairwise tree over the rows right-aligned in
// 2048 slots, zeros in front (where the scan adds +0.0 for a row before
// the block, the tree adds a zero; a subtree of zeros adds +0.0 to a
// sum, which leaves it as it is). Each thread folds 8 slots as a tree,
// then the lanes (xor-shuffles, as row_total), then the 8 warps.
template <class Row>
__device__ float block_last(const Row& row, int blk, float* sm) {
  const int pad = 8 * THREADS - blk;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = 8 * (int)threadIdx.x + j - pad;
    v[j] = i >= 0 ? row(i) : 0.0f;
  }
  float x = ((v[7] + v[6]) + (v[5] + v[4])) + ((v[3] + v[2]) + (v[1] + v[0]));
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) x = x + __shfl_xor_sync(FULL, x, m);
  if (threadIdx.x % 32 == 0) sm[threadIdx.x / 32] = x;
  __syncthreads();
  float y = sm[threadIdx.x % WARPS];
#pragma unroll
  for (int m = 1; m < WARPS; m <<= 1) y = y + __shfl_xor_sync(FULL, y, m);
  const float t = row(blk - 1);
  __syncthreads();
  return t + (y - t);
}

// Row totals of the slab's own rows, written inside a launch.
struct OwnRows {
  const float* td;
  __device__ float operator()(int i) const { return __ldcg(td + i); }
};

// The ticket of a launch's last CTA (tickets[gridDim.x - 1 done]): the
// CTA's writes, one release by thread 0 (the pattern of cooperative
// groups' grid sync), then the ticket; the last CTA zeroes what `zero`
// names (the scratch that the launch's CTAs count in) and the ticket, so
// the next launch finds them zeroed.
__device__ __forceinline__ void finish_tickets(int* zero, int n, int* ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i < n; i += THREADS) __stcg(zero + i, 0);
  if (threadIdx.x == 0) __stcg(ticket, 0);
}

// Launch 1 of slab index: row totals of each segment into td (n_seg, Rl),
// the head's and tail's also into msg (n_seg, M); the CTA that completes
// a whole block (tick[w] counts its rows done; the CTA that completes it
// zeroes it) writes the block's last value into msg (block_last).
__global__ void __launch_bounds__(THREADS)
prefix_slab_totals(const float* __restrict__ w, const int* __restrict__ codes,
                   int Rl, int index, int n_seg, int blk, int M, float* td,
                   float* msg, int* tick) {
  __shared__ float sm[WARPS];
  // the whole blocks this CTA completes: its 32 rows touch at most 5
  // blocks of 8 rows or more
  __shared__ int done[8];
  __shared__ int n_done;
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x;
  const Slab sl = slab_of(Rl, blk, index);
  Rows rows;
  load_rows(w, codes, Rl, g, rows);
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int row = (int)row_of(g, k);
    if (row >= Rl) break;
    const bool edge = row < sl.h || row >= Rl - sl.t;
    const int at = row < sl.h ? row : sl.h + row - (Rl - sl.t);
    for (int s = 0; s < n_seg; ++s) {
      float v[4];
      masked(rows, k, codes != nullptr, s, v);
      const float t = row_total(v);
      if (lane == 31) {
        td[s * Rl + row] = t;
        if (edge) msg[s * M + at] = t;
      }
    }
  }
  if (sl.W == 0) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    n_done = 0;
    const int r0 = g * ROWS_PER_CTA;
    const int lo = max(r0, sl.h);
    const int hi = min(min(r0 + ROWS_PER_CTA, Rl), sl.h + sl.W * blk);
    for (int x = lo; x < hi;) {
      const int wb = (x - sl.h) / blk;
      const int end = min(hi, sl.h + (wb + 1) * blk);
      if (atomicAdd(tick + wb, end - x) + (end - x) == blk) {
        done[n_done++] = wb;
        tick[wb] = 0;
      }
      x = end;
    }
    if (n_done) __threadfence();
  }
  __syncthreads();
  for (int i = 0; i < n_done; ++i)
    for (int s = 0; s < n_seg; ++s) {
      const float last = block_last(
          OwnRows{td + s * Rl + sl.h + done[i] * blk}, blk, sm);
      if (threadIdx.x == 0) msg[s * M + sl.h + sl.t + done[i]] = last;
    }
}

// A block's row totals in the emit: the slab's own rows from td, the
// others from the message of the slab that holds them (slab table sl).
struct BlockRows {
  const float* msgs;
  const float* td;
  const Slab* sl;
  int Rl, n_seg, M, s, r0, index;
  __device__ float operator()(int i) const {
    const int r = r0 + i, q = r / Rl;
    if (q == index) return __ldcg(td + s * Rl + r - sl[q].a);
    const Slab& x = sl[q];
    const int at = r < x.a + x.h ? r - x.a : x.h + r - (x.a + Rl - x.t);
    return __ldg(msgs + (q * n_seg + s) * M + at);
  }
};

// Every block's last value in the emit: a whole block's from the message
// of the slab that holds it, a straddling block's from its role.
struct Gathered {
  const float* msgs;
  const float* hs;
  const Slab* sl;
  const int* strad;
  int Rl, blk, n_seg, M, S, G;
  __device__ float operator()(int j) const {
    const int s = j / G, B = j % G;
    const int r0 = B * blk, q = r0 / Rl;
    if ((r0 + blk - 1) / Rl == q)
      return __ldg(msgs + (q * n_seg + s) * M + sl[q].h + sl[q].t +
                   (B - sl[q].fw));
    int i = 0;
    while (strad[i] != B) ++i;
    return __ldcg(hs + s * S + i);
  }
};

// Launch 2 of slab index of k: msgs holds every slab's message, (k,
// n_seg, M); td the slab's row totals from launch 1. hs: n_seg * S
// floats (the straddling blocks' last values). work: n_seg * G + 2 ints,
// zero at the launch and left zeroed: the role ticket, the roles' flags,
// and at the end the finish ticket. out: the slab's (n_seg, Rl * 128)
// prefix; ends[s]: segment s's last prefix value.
//
// A CTA takes a role by a ticket at its start, so the first roles go to
// CTAs that already run and no CTA waits on one that may not be resident.
// Roles [0, n_seg * U): a block of a segment (role_blocks): an own block
// gets phase 2 (the row offsets of the slab's rows in it into td), a
// straddling block its last value into hs (block_last, on every slab
// alike, so that every rank folds the same carries); then the role's
// flag. The other CTAs each load a group of rows, wait for the flags,
// fold every block's last value into the carries (each CTA alike) and
// run phase 3.
__global__ void __launch_bounds__(THREADS)
prefix_slab_emit(const float* __restrict__ w, const int* __restrict__ codes,
                 const float* __restrict__ msgs, int Rl, int k, int index,
                 int n_seg, int blk, int M, float* td, float* hs, int* work,
                 float* __restrict__ out, float* __restrict__ ends,
                 int* count, reina::Fold fold) {
  extern __shared__ float sm[];  // max(3 * blk, n_seg * G) + 8 floats,
                                 // k Slabs, k straddling, U role blocks
  __shared__ int role, S_sh, U_sh;
  const int lane = threadIdx.x % 32;
  const bool has_codes = codes != nullptr;
  const int R = Rl * k, G = R / blk, nb = n_seg * G;
  float* tail = sm + max(3 * blk, nb);  // block_last's 8 floats
  Slab* sl = reinterpret_cast<Slab*>(tail + 8);
  int* strad = reinterpret_cast<int*>(sl + k);
  int* uni = strad + k;
  const Slab own = slab_of(Rl, blk, index);
  int* flags = work + 1;
  for (int j = threadIdx.x; j < k; j += THREADS) sl[j] = slab_of(Rl, blk, j);
  if (threadIdx.x == 0) {
    role = atomicAdd(work, 1);
    S_sh = straddling(Rl, blk, k, strad);
    U_sh = role_blocks(Rl, blk, index, strad, S_sh, uni);
  }
  __syncthreads();
  const int S = S_sh, U = U_sh, P = n_seg * U;
  if (role < P) {
    const int s = role / U, B = uni[role % U];
    const int r0 = B * blk;
    const BlockRows rows_of{msgs, td, sl, Rl, n_seg, M, s, r0, index};
    if ((r0 + blk - 1) / Rl != r0 / Rl) {  // before td holds offsets
      int si = 0;
      while (strad[si] != B) ++si;
      const float last = block_last(rows_of, blk, tail);
      if (threadIdx.x == 0) hs[s * S + si] = last;
    }
    if (B * blk < own.a + Rl && (B + 1) * blk > own.a) {
      float* t = sm;
      float* rb = sm + blk;
      for (int i = threadIdx.x; i < blk; i += THREADS) {
        const float x = rows_of(i);
        t[i] = x;
        rb[i] = x;
      }
      __syncthreads();
      const int cur = hs_rows(sm, blk);
      for (int i = threadIdx.x; i < blk; i += THREADS) {
        const int r = r0 + i;
        if (r >= own.a && r < own.a + Rl)
          td[s * Rl + r - own.a] = rb[cur * blk + i] - t[i];
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicExch(flags + role, 1);
    }
    finish_tickets(work, P + 1, work + nb + 1);
    return;
  }
  const int g = role - P;
  Rows rows;
  load_rows(w, codes, Rl, g, rows);  // in flight while it waits
  if (threadIdx.x == 0) {
    for (int i = 0; i < P; ++i)
      while (((volatile int*)flags)[i] == 0) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
  const Gathered last{msgs, hs, sl, strad, Rl, blk, n_seg, M, S, G};
  if (threadIdx.x < 32) fold_carries(last, nb, sm);
  __syncthreads();
  if (g == 0) {
    if ((int)threadIdx.x < n_seg) {
      const int b = (threadIdx.x + 1) * G - 1;
      ends[threadIdx.x] = last(b) + sm[b];
    }
    if (count != nullptr && threadIdx.x == 0) {
      *count = (int)(last(G - 1) + sm[G - 1]);
      reina::take_fold(fold);
    }
  }
  for (int s = 0; s < n_seg; ++s) {
    float dr[ROWS];
#pragma unroll
    for (int k2 = 0; k2 < ROWS; ++k2) {
      const long long row = row_of(g, k2);
      dr[k2] = row < Rl ? __ldcg(td + s * Rl + row) : 0.0f;
    }
#pragma unroll
    for (int k2 = 0; k2 < ROWS; ++k2) {
      const long long row = row_of(g, k2);
      if (row >= Rl) break;
      float v[4];
      masked(rows, k2, has_codes, s, v);
      lane_scan(v, lane);
      const float cb = sm[s * G + (int)((own.a + row) / blk)];
      float4 o;
      o.x = (v[0] + dr[k2]) + cb;
      o.y = (v[1] + dr[k2]) + cb;
      o.z = (v[2] + dr[k2]) + cb;
      o.w = (v[3] + dr[k2]) + cb;
      *reinterpret_cast<float4*>(out + (s * Rl + row) * LANE + 4 * lane) = o;
    }
  }
  finish_tickets(work, P + 1, work + nb + 1);
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

// The sharded form, launch 1, on slab `index` of k equal slabs of n
// agents (n % 128 == 0, k * n % 1024 == 0, (k * n / 128) % blk == 0, blk
// <= 2048): td (floats, n_seg * n / 128) gets the row totals of each
// segment; msg (floats, n_seg * M) the slab's message. tick: an int a
// whole block of the slab, zero, left zeroed. events: NULL, or 2 CUDA
// events recorded before and after the launch.
extern "C" int reina_prefix_row_totals(const void* w, const void* codes,
                                       void* td, void* msg, void* tick,
                                       long long n, int k, int index,
                                       int n_seg, int blk, int M,
                                       void* const* events, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int Rl = (int)(n / LANE);
  const int groups = (Rl + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  if (events) cudaEventRecord((cudaEvent_t)events[0], st);
  prefix_slab_totals<<<groups, THREADS, 0, st>>>(
      (const float*)w, (const int*)codes, Rl, index, n_seg, blk, M,
      (float*)td, (float*)msg, (int*)tick);
  if (events) cudaEventRecord((cudaEvent_t)events[1], st);
  return (int)cudaGetLastError();
}

// The sharded form, launch 2, on slab `index` of k (as launch 1's):
// gathered holds every slab's message, (k, n_seg, M) floats in slab
// order; td is launch 1's. out: (n_seg, n) floats, ends: (n_seg,)
// floats. hs: n_seg * S floats (S: the blocks of a segment that straddle
// a slab edge). work: n_seg * G + 3 ints (G blocks a segment), zero,
// left zeroed. count, fold: as reina_concat_prefix's, of segment 0's
// last value. events: as reina_prefix_row_totals'.
extern "C" int reina_prefix_emit_slab(const void* w, const void* codes,
                                      const void* gathered, void* td,
                                      void* out, void* ends, void* hs,
                                      void* work, long long n, int k,
                                      int index, int n_seg, int blk, int M,
                                      void* count, const void* fold,
                                      void* const* events, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int Rl = (int)(n / LANE), R = Rl * k;
  const int nb = n_seg * (R / blk);
  int strad[64];
  if (k > 64) return (int)cudaErrorInvalidValue;
  const int S = straddling(Rl, blk, k, strad);
  const int U = role_blocks(Rl, blk, index, strad, S, nullptr);
  const size_t smem = (size_t)(max(3 * blk, nb) + 8) * sizeof(float) +
                      (size_t)k * sizeof(Slab) + (size_t)(k + U) *
                      sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      prefix_slab_emit, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (Rl + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  reina::Fold f = fold == nullptr ? reina::Fold{} : *(const reina::Fold*)fold;
  if (events) cudaEventRecord((cudaEvent_t)events[0], st);
  prefix_slab_emit<<<n_seg * U + groups, THREADS, smem, st>>>(
      (const float*)w, (const int*)codes, (const float*)gathered, Rl, k,
      index, n_seg, blk, M, (float*)td, (float*)hs, (int*)work, (float*)out,
      (float*)ends, (int*)count, f);
  if (events) cudaEventRecord((cudaEvent_t)events[1], st);
  return (int)cudaGetLastError();
}
