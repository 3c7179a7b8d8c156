// Capacity-ledger grants for the bed and ICU ledgers of the day step.
//
// Replaces reina_tpu/ops/clamped.py:_ledger_kernel (the Pallas streaming
// scan) and the grant arithmetic that consumes its streams
// (_grants_from_streams). For each ledger, over positions i of the agent
// axis, with a = rel - req, s the prefix sum of a and
// key[i] = (req[i] ? 0 : NEG) - s_incl[i]:
//
//   s_excl[offset] = c_off,  base_a = init - c_off
//   final_a = s_tot + max(base_a, max_{j >= offset} key[j])
//   final_b = c_off + max(final_a, max_{j < offset} key[j])    -> final
//   granted[i] = req[i] && s_excl[i] + rel[i]
//                + (i >= offset ? max(base_a, max_{offset <= j < i} key[j])
//                               : max(final_a, max_{j < i} key[j])) > 0
//
// the first-come-first-served sweep from offset to the end and then from
// 0 to offset. It equals the plain twin (ops/clamped.py:grants_twin)
// exactly: all arithmetic is in int64, where every association gives the
// same integers.
//
// What bounds it on the card: bytes, 5 read and 1 written per agent and
// ledger. The Pallas kernel carried (sum, masked max, max) from one grid
// step to the next; blocks on the GPU run in no order, so the carry is a
// scan over the monoid
//
//   (s1, ka1, kf1) + (s2, ka2, kf2) = (s1 + s2, max(ka1, ka2 - s1),
//                                      max(kf1, kf2 - s1))
//
// (a segment's key maxima are kept relative to its own start, so
// appending a segment subtracts the sum before it; ka counts positions
// >= offset only), in three launches over tiles of 4096 agents:
//
//   K1 ledger_tile_fold   each CTA folds its tile: a lane reads 16
//                         consecutive agents (4 int4 of rel, 16 bytes of
//                         req), folds them in registers, and the lanes
//                         and warps are scanned with shuffles, left
//                         operand first. The CTA that holds offset also
//                         writes the fold of its tile before offset.
//   K2 ledger_tile_scan   one CTA per ledger scans the tile folds in
//                         parallel and computes the boundary scalars
//                         (c_off, base_a, final_a; final_b into finals).
//   K3 ledger_emit        each CTA rescans its tile from its carry and
//                         writes the grants, 16 bytes a lane.
//
// Nothing agent-sized but the grants is written.
//
// The sharded form (the JAX package's _grants_sharded with the kernel's
// base and emit_carry, reina_tpu/ops/clamped.py:247-294) runs the same
// fold and emit for one contiguous slab of the agent axis whose first
// position is ``base``, in two launches around the all-gather of every
// slab's folds. The cyclic mask is taken at the global position (the
// kernels get offset - base; in a captured day each launch reads the
// day's offset from device memory and subtracts base, as the unsharded
// launches read it):
//
//   F  ledger_fold_slab   K1 on the slab; then a ticket a ledger (one
//                         atomicAdd a CTA after a __threadfence) finds the
//                         CTA that finishes last, and that CTA scans the
//                         tile folds and writes the slab's two folds out:
//                         all of it, and its positions before offset; it
//                         zeroes the ticket for the next launch. One
//                         launch, no grid barrier, no memset.
//   (the caller all-gathers every slab's folds, in slab order)
//   E  ledger_emit_slab   warp 0 of each CTA folds the k slabs' folds with
//                         a shuffle scan (32 slabs a round): the carry of
//                         the slabs before its own, and the boundary
//                         scalars from all of them; then it emits as K3.
//
// What bounds the sharded form is not its bytes (a slab of HUS's ledgers
// is a few MB) but its launches and the serial steps between them: the
// tile scan and the fold of the k slabs, each now inside a launch that
// runs anyway.
//
// The monoid is exact in int64, so the grants and finals equal the
// unsharded launch's bit for bit for any slab count and association.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                // consecutive agents a lane owns
constexpr int TILE = THREADS * ITEMS;    // 4096
constexpr int SCAN_THREADS = 1024;
constexpr long long NEG = -(1LL << 30);
constexpr long long NEG_INF = -(1LL << 62);
constexpr unsigned FULL = 0xffffffffu;

struct Tup {
  long long s, ka, kf;
};

__device__ __forceinline__ Tup tup_id() { return Tup{0, NEG_INF, NEG_INF}; }

// x followed by y
__device__ __forceinline__ Tup combine(const Tup& x, const Tup& y) {
  return Tup{x.s + y.s, max(x.ka, y.ka - x.s), max(x.kf, y.kf - x.s)};
}

__device__ __forceinline__ Tup shfl_up(const Tup& x, int d) {
  return Tup{__shfl_up_sync(FULL, x.s, d), __shfl_up_sync(FULL, x.ka, d),
             __shfl_up_sync(FULL, x.kf, d)};
}

// Exclusive scan of one value a thread across the block, in thread
// order; returns the fold of the whole block. buf: 33 Tups of shared
// memory. The monoid is not commutative: the left operand is always the
// earlier segment.
template <int NW>
__device__ Tup block_exclusive(const Tup& v, Tup& ex, Tup* buf) {
  static_assert(NW <= 32, "one warp scans the warp folds");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  Tup inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Tup y = shfl_up(inc, d);
    if (lane >= d) inc = combine(y, inc);
  }
  if (lane == 31) buf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Tup x = lane < NW ? buf[lane] : tup_id();
#pragma unroll
    for (int d = 1; d < NW; d <<= 1) {
      const Tup y = shfl_up(x, d);
      if (lane >= d) x = combine(y, x);
    }
    Tup xe = shfl_up(x, 1);
    if (lane == 0) xe = tup_id();
    __syncwarp();
    buf[lane] = xe;
    if (lane == NW - 1) buf[32] = x;
  }
  __syncthreads();
  Tup e = shfl_up(inc, 1);
  if (lane == 0) e = tup_id();
  ex = combine(buf[warp], e);
  const Tup total = buf[32];
  __syncthreads();
  return total;
}

// A lane's 16 agents from i (i % 16 == 0): rel as 4 int4, req as one
// 16-byte word; positions >= n read as nothing.
struct Agents {
  int r[ITEMS];
  unsigned q[ITEMS / 4];   // req bytes, 4 a word
  __device__ int req(int e) const { return (q[e / 4] >> (8 * (e % 4))) & 0xff; }
};

__device__ __forceinline__ void load_agents(const int* __restrict__ rel,
                                            const uint8_t* __restrict__ req,
                                            long long i, long long n,
                                            Agents& a) {
  if (i + ITEMS <= n) {
#pragma unroll
    for (int j = 0; j < ITEMS / 4; ++j) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(rel + i) + j);
      a.r[4 * j] = x.x, a.r[4 * j + 1] = x.y, a.r[4 * j + 2] = x.z,
      a.r[4 * j + 3] = x.w;
    }
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(req + i));
    a.q[0] = y.x, a.q[1] = y.y, a.q[2] = y.z, a.q[3] = y.w;
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS / 4; ++j) a.q[j] = 0;
#pragma unroll
    for (int e = 0; e < ITEMS; ++e) {
      a.r[e] = i + e < n ? rel[i + e] : 0;
      if (i + e < n) a.q[e / 4] |= (unsigned)req[i + e] << (8 * (e % 4));
    }
  }
}

// The running form of the fold: from (s, ka, kf), agent i with release
// r and request q moves s to s + r - q and raises kf (and, from offset
// on, ka) to its key (q ? 0 : NEG) - s. This is combine with the agent's
// element, with ka left at its value before offset where combine would
// give NEG_INF - s; either stays far below every balance it is maxed
// with.
__device__ __forceinline__ void step(Tup& t, int r, int q, bool in_a) {
  t.s += (long long)r - q;
  const long long key = (q ? 0 : NEG) - t.s;
  t.kf = max(t.kf, key);
  if (in_a) t.ka = max(t.ka, key);
}

// Fold of the agents i .. i + 15 below lim.
__device__ __forceinline__ Tup fold(const Agents& a, long long i,
                                    long long lim, long long offset) {
  Tup acc = tup_id();
#pragma unroll
  for (int e = 0; e < ITEMS; ++e)
    if (i + e < lim) step(acc, a.r[e], a.req(e), i + e >= offset);
  return acc;
}

struct Ledgers {
  const int* rel[2];
  const uint8_t* req[2];
  uint8_t* granted[2];
};

// Loads this lane's 16 agents of ledger blockIdx.y and scans the CTA's
// tile: ex is the fold of the tile before them; returns the tile's fold.
__device__ __forceinline__ Tup scan_tile(const Ledgers& lg, long long n,
                                         long long offset, long long i,
                                         Agents& a, Tup& ex, Tup* buf) {
  const bool second = blockIdx.y != 0;
  load_agents(second ? lg.rel[1] : lg.rel[0], second ? lg.req[1] : lg.req[0],
              i, n, a);
  return block_exclusive<WARPS>(fold(a, i, n, offset), ex, buf);
}

// K1: tiles[led * ntiles + tile] = the tile's fold; pre[led] = the fold
// of the agents of offset's tile before offset. Where off_dev is not
// NULL, offset is *off_dev - base (the day's global offset, read when the
// launch runs, made local to a slab that starts at base).
__global__ void __launch_bounds__(THREADS, 3)
ledger_tile_fold(Ledgers lg, long long n, long long offset,
                 const int* off_dev, long long base, Tup* tiles, Tup* pre) {
  if (off_dev) offset = *off_dev - base;
  __shared__ Tup buf[33];
  const long long i = (long long)blockIdx.x * TILE + ITEMS * threadIdx.x;
  Agents a;
  Tup ex;
  const Tup total = scan_tile(lg, n, offset, i, a, ex, buf);
  const int led = blockIdx.y;
  if (threadIdx.x == 0) tiles[(long long)led * gridDim.x + blockIdx.x] = total;
  if (offset >= i && offset < i + ITEMS)
    pre[led] = combine(ex, fold(a, i, offset, offset));
}

// K2: excl[led * ntiles + t] = the fold of the tiles before t; the
// boundary scalars into scal[2 * led + {0, 1}] = (base_a, final_a) and
// finals[led] = final_b.
__global__ void ledger_tile_scan(const Tup* tiles, Tup* excl, const Tup* pre,
                                 const int* init, long long offset,
                                 const int* off_dev, int ntiles,
                                 long long* scal, int* finals) {
  if (off_dev) offset = *off_dev;
  __shared__ Tup buf[33];
  const int led = blockIdx.x;
  const Tup* tl = tiles + (long long)led * ntiles;
  Tup* el = excl + (long long)led * ntiles;
  Tup carry = tup_id();
  for (int base = 0; base < ntiles; base += SCAN_THREADS) {
    const int j = base + threadIdx.x;
    Tup ex;
    const Tup total = block_exclusive<SCAN_THREADS / 32>(
        j < ntiles ? tl[j] : tup_id(), ex, buf);
    if (j < ntiles) el[j] = combine(carry, ex);
    carry = combine(carry, total);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const Tup at_off = combine(el[offset / TILE], pre[led]);
  const long long c_off = at_off.s;
  const long long base_a = init[led] - c_off;
  const long long final_a = carry.s + max(base_a, carry.ka);
  scal[2 * led] = base_a;
  scal[2 * led + 1] = final_a;
  finals[led] = (int)(c_off + max(final_a, at_off.kf));
}

// The grants of a lane's 16 agents from i, one 16-byte store; cur is
// the fold of the agents before i.
__device__ __forceinline__ void emit_grants(const Ledgers& lg, long long n,
                                            long long offset, long long i,
                                            const Agents& a, Tup cur,
                                            long long base_a,
                                            long long final_a, int led) {
  unsigned out[ITEMS / 4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < ITEMS; ++e) {
    const int q = a.req(e);
    const bool in_a = i + e >= offset;
    const long long m = in_a ? max(base_a, cur.ka) : max(final_a, cur.kf);
    out[e / 4] |= (unsigned)(q && cur.s + a.r[e] + m > 0) << (8 * (e % 4));
    step(cur, a.r[e], q, in_a);
  }
  uint8_t* g = led ? lg.granted[1] : lg.granted[0];
  if (i + ITEMS <= n) {
    *reinterpret_cast<uint4*>(g + i) = make_uint4(out[0], out[1], out[2],
                                                  out[3]);
  } else {
#pragma unroll
    for (int e = 0; e < ITEMS; ++e)
      if (i + e < n) g[i + e] = (out[e / 4] >> (8 * (e % 4))) & 0xff;
  }
}

// K3: the grants of this lane's 16 agents.
__global__ void __launch_bounds__(THREADS, 3)
ledger_emit(Ledgers lg, long long n, long long offset, const int* off_dev,
            const Tup* excl, const long long* scal) {
  if (off_dev) offset = *off_dev;
  __shared__ Tup buf[33];
  const long long i = (long long)blockIdx.x * TILE + ITEMS * threadIdx.x;
  Agents a;
  Tup ex;
  scan_tile(lg, n, offset, i, a, ex, buf);
  const int led = blockIdx.y;
  const Tup cur = combine(excl[(long long)led * gridDim.x + blockIdx.x], ex);
  emit_grants(lg, n, offset, i, a, cur, scal[2 * led], scal[2 * led + 1],
              led);
}

// The sharded form. A slab's folds, 6 int64 a ledger: (s, ka, kf) of the
// whole slab, then of its positions before offset.
__device__ __forceinline__ Tup load_tup(const long long* p) {
  return Tup{p[0], p[1], p[2]};
}

// A fold written by another CTA of the launch, read through L2.
__device__ __forceinline__ Tup load_tup_cg(const Tup* p) {
  const long long* q = reinterpret_cast<const long long*>(p);
  return Tup{__ldcg(q), __ldcg(q + 1), __ldcg(q + 2)};
}

// F: K1 on a slab, then the slab scan in the CTA that finishes last:
// excl as K2's, and folds[6 * led ..]: the slab's fold, then the fold of
// its positions before offset. offset is local (offset - base, any value;
// off_dev as K1's). tick: L ints, zero, left zeroed.
__global__ void __launch_bounds__(THREADS, 3)
ledger_fold_slab(Ledgers lg, long long n, long long offset, const int* off_dev,
                 long long base, Tup* tiles, Tup* excl, Tup* pre, int* tick,
                 long long* folds) {
  if (off_dev) offset = *off_dev - base;
  __shared__ Tup buf[33];
  __shared__ int last;
  const int led = blockIdx.y, ntiles = gridDim.x;
  const long long i = (long long)blockIdx.x * TILE + ITEMS * threadIdx.x;
  {
    Agents a;
    Tup ex;
    const Tup total = scan_tile(lg, n, offset, i, a, ex, buf);
    if (threadIdx.x == 0) tiles[(long long)led * ntiles + blockIdx.x] = total;
    if (offset >= i && offset < i + ITEMS)
      pre[led] = combine(ex, fold(a, i, offset, offset));
  }
  // the CTA's writes, one release by thread 0, then the ticket; the last
  // CTA zeroes it for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(tick + led, 1) == ntiles - 1;
    if (last) {
      tick[led] = 0;
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  const Tup* tl = tiles + (long long)led * ntiles;
  Tup* el = excl + (long long)led * ntiles;
  Tup carry = tup_id();
  for (int t0 = 0; t0 < ntiles; t0 += THREADS) {
    const int j = t0 + threadIdx.x;
    Tup ex;
    const Tup total = block_exclusive<WARPS>(
        j < ntiles ? load_tup_cg(tl + j) : tup_id(), ex, buf);
    if (j < ntiles) el[j] = combine(carry, ex);
    carry = combine(carry, total);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const Tup before = offset <= 0  ? tup_id()
                     : offset >= n ? carry
                                   : combine(el[offset / TILE],
                                             load_tup_cg(pre + led));
  long long* f = folds + 6 * led;
  f[0] = carry.s, f[1] = carry.ka, f[2] = carry.kf;
  f[3] = before.s, f[4] = before.ka, f[5] = before.kf;
}

__device__ __forceinline__ Tup shfl_tup(const Tup& x, int src) {
  return Tup{__shfl_sync(FULL, x.s, src), __shfl_sync(FULL, x.ka, src),
             __shfl_sync(FULL, x.kf, src)};
}

// E: all_folds holds every slab's folds, (k, L, 6) int64 in slab order;
// this slab is number index. Warp 0 of each CTA folds them, 32 slabs a
// round, each round an inclusive shuffle scan (the left operand the
// earlier slab) appended to the rounds before: the carry of the slabs
// before this one, and the boundary scalars from all of them. The CTAs
// of tile 0 write the finals.
__global__ void __launch_bounds__(THREADS, 3)
ledger_emit_slab(Ledgers lg, long long n, long long offset,
                 const int* off_dev, long long base, const Tup* excl,
                 const long long* all_folds, int k, int index, int L,
                 const int* init, int* finals) {
  if (off_dev) offset = *off_dev - base;
  __shared__ Tup buf[33];
  __shared__ Tup carry_in;
  __shared__ long long scal[2];
  const int led = blockIdx.y;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    Tup c = tup_id(), total = tup_id(), at_off = tup_id();
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int m = min(32, k - j0);
      Tup f = tup_id(), g = tup_id();
      if (lane < m) {
        const long long* p =
            all_folds + 6 * ((long long)(j0 + lane) * L + led);
        f = load_tup(p);
        g = load_tup(p + 3);
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const Tup y = shfl_up(f, d), z = shfl_up(g, d);
        if (lane >= d) f = combine(y, f), g = combine(z, g);
      }
      // index, j0 and m are the same in every lane: each shuffle below
      // has the whole warp
      if (index == j0) c = total;
      else if (index > j0 && index < j0 + m)
        c = combine(total, shfl_tup(f, index - j0 - 1));
      total = combine(total, shfl_tup(f, m - 1));
      at_off = combine(at_off, shfl_tup(g, m - 1));
    }
    if (lane == 0) {
      const long long c_off = at_off.s;
      const long long base_a = init[led] - c_off;
      const long long final_a = total.s + max(base_a, total.ka);
      carry_in = c;
      scal[0] = base_a;
      scal[1] = final_a;
      if (blockIdx.x == 0)
        finals[led] = (int)(c_off + max(final_a, at_off.kf));
    }
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * TILE + ITEMS * threadIdx.x;
  Agents a;
  Tup ex;
  scan_tile(lg, n, offset, i, a, ex, buf);
  const Tup cur = combine(
      combine(carry_in, excl[(long long)led * gridDim.x + blockIdx.x]), ex);
  emit_grants(lg, n, offset, i, a, cur, scal[0], scal[1], led);
}

}  // namespace

// 0 <= offset < n: the host's offset or, where off_dev is not NULL, the
// int32 it points to in device memory, read by each launch (a captured
// day step's offset, from its day row). rel, req and granted 16-byte
// aligned. init: (L,) int32 on the device; finals: (L,) int32 out. scratch: int64, 6 * L *
// ceil(n / 4096) + 5 * L entries. events: NULL, or 4 CUDA events
// recorded before K1 and after each launch.
extern "C" int reina_ledger_grants(const void* rel0, const void* rel1,
                                   const void* req0, const void* req1,
                                   void* granted0, void* granted1,
                                   const void* init, void* finals,
                                   void* scratch, long long n,
                                   long long offset, const void* off_dev,
                                   int L, void* const* events, void* stream) {
  const int* od = (const int*)off_dev;
  cudaStream_t st = (cudaStream_t)stream;
  Ledgers lg;
  lg.rel[0] = (const int*)rel0;
  lg.rel[1] = (const int*)rel1;
  lg.req[0] = (const uint8_t*)req0;
  lg.req[1] = (const uint8_t*)req1;
  lg.granted[0] = (uint8_t*)granted0;
  lg.granted[1] = (uint8_t*)granted1;
  const int ntiles = (int)((n + TILE - 1) / TILE);
  Tup* tiles = (Tup*)scratch;
  Tup* excl = tiles + (long long)L * ntiles;
  Tup* pre = excl + (long long)L * ntiles;
  long long* scal = (long long*)(pre + L);
  const dim3 grid(ntiles, L);
  if (events) cudaEventRecord((cudaEvent_t)events[0], st);
  ledger_tile_fold<<<grid, THREADS, 0, st>>>(lg, n, offset, od, 0, tiles,
                                             pre);
  if (events) cudaEventRecord((cudaEvent_t)events[1], st);
  ledger_tile_scan<<<L, SCAN_THREADS, 0, st>>>(tiles, excl, pre,
                                               (const int*)init, offset, od,
                                               ntiles, scal, (int*)finals);
  if (events) cudaEventRecord((cudaEvent_t)events[2], st);
  ledger_emit<<<grid, THREADS, 0, st>>>(lg, n, offset, od, excl, scal);
  if (events) cudaEventRecord((cudaEvent_t)events[3], st);
  return (int)cudaGetLastError();
}

namespace {
Ledgers ledgers(const void* rel0, const void* rel1, const void* req0,
                const void* req1, void* granted0, void* granted1) {
  Ledgers lg;
  lg.rel[0] = (const int*)rel0;
  lg.rel[1] = (const int*)rel1;
  lg.req[0] = (const uint8_t*)req0;
  lg.req[1] = (const uint8_t*)req1;
  lg.granted[0] = (uint8_t*)granted0;
  lg.granted[1] = (uint8_t*)granted1;
  return lg;
}
}  // namespace

// The sharded form's fold (one launch) on a slab of n agents whose first
// global position is base: 0 <= offset < the global length, the host's
// offset or, where off_dev is not NULL, the int32 it points to, read by
// the launch (a captured day's offset, from its day row). scratch:
// int64, 6 * L * ceil(n / 4096) + 3 * L entries, kept for the emit;
// tick: L ints, zero, which the launch leaves zeroed; folds: (L, 6)
// int64 out. events: NULL, or 2 CUDA events recorded before and after
// the launch.
extern "C" int reina_ledger_fold_slab(const void* rel0, const void* rel1,
                                      const void* req0, const void* req1,
                                      void* scratch, void* tick, void* folds,
                                      long long n, long long base,
                                      long long offset, const void* off_dev,
                                      int L, void* const* events,
                                      void* stream) {
  const int* od = (const int*)off_dev;
  cudaStream_t st = (cudaStream_t)stream;
  const Ledgers lg = ledgers(rel0, rel1, req0, req1, nullptr, nullptr);
  const int ntiles = (int)((n + TILE - 1) / TILE);
  Tup* tiles = (Tup*)scratch;
  Tup* excl = tiles + (long long)L * ntiles;
  Tup* pre = excl + (long long)L * ntiles;
  if (events) cudaEventRecord((cudaEvent_t)events[0], st);
  ledger_fold_slab<<<dim3(ntiles, L), THREADS, 0, st>>>(
      lg, n, offset - base, od, base, tiles, excl, pre, (int*)tick,
      (long long*)folds);
  if (events) cudaEventRecord((cudaEvent_t)events[1], st);
  return (int)cudaGetLastError();
}

// The sharded form's emit (one launch): the slab's grants and the global
// finals from every slab's folds (all_folds: (k, L, 6) int64 on the
// device; this slab is number index) and the scratch of its fold launch.
// offset, off_dev: as the fold launch's. events: NULL, or 2 CUDA events
// recorded before and after the launch.
extern "C" int reina_ledger_emit_slab(const void* rel0, const void* rel1,
                                      const void* req0, const void* req1,
                                      void* granted0, void* granted1,
                                      const void* init, void* finals,
                                      const void* scratch,
                                      const void* all_folds, long long n,
                                      long long base, long long offset,
                                      const void* off_dev, int L, int k,
                                      int index, void* const* events,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Ledgers lg = ledgers(rel0, rel1, req0, req1, granted0, granted1);
  const int ntiles = (int)((n + TILE - 1) / TILE);
  const Tup* excl = (const Tup*)scratch + (long long)L * ntiles;
  if (events) cudaEventRecord((cudaEvent_t)events[0], st);
  ledger_emit_slab<<<dim3(ntiles, L), THREADS, 0, st>>>(
      lg, n, offset - base, (const int*)off_dev, base, excl,
      (const long long*)all_folds, k, index, L,
      (const int*)init, (int*)finals);
  if (events) cudaEventRecord((cudaEvent_t)events[1], st);
  return (int)cudaGetLastError();
}
