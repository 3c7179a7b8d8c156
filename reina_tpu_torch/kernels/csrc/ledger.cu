// Capacity-ledger scan for the bed and ICU ledgers of the day step.
//
// Replaces reina_tpu/ops/clamped.py:_ledger_kernel (the Pallas streaming
// scan). For each ledger, over positions i of the agent axis:
//
//   a[i]   = rel[i] - req[i]
//   U[i]   = s_excl[i] + rel[i]                        (s = prefix sum of a)
//   key[i] = (req[i] ? 0 : NEG) - s_incl[i]
//   rm[i]  = max(NEG, max_{j<i, j>=offset} key[j])     if i >= offset
//            max(NEG, max_{j<i} key[j])                otherwise
//
// The plain twin consumes U and rm into grants (ops/clamped.py).
//
// What bounds it on the card: bytes. Per agent it reads 4+1 bytes and
// writes 8 bytes per ledger, ~45 MB in all at HUS size, a few
// microseconds of HBM time; the sequential carry is the design problem.
// The Pallas kernel carried (sum, masked max, max) from one grid step to
// the next. Blocks on the GPU run in no order, so the carry becomes a
// three-phase scan over the monoid
//
//   (s1, ka1, kf1) + (s2, ka2, kf2) = (s1 + s2, max(ka1, ka2 - s1),
//                                      max(kf1, kf2 - s1))
//
// (a segment's key maxima are kept relative to the segment's own start,
// so appending a segment subtracts the sum before it): each block folds
// its tile, one thread scans the tile totals, and each block rescans its
// tile from its carry. Sums and keys are int64 inside the scan, so no
// intermediate saturates; rm is clamped to NEG only at the store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr long long NEG = -(1LL << 30);
constexpr long long NEG_INF = -(1LL << 62);

struct Tup {
  long long s, ka, kf;
};

__device__ __forceinline__ Tup tup_id() {
  Tup t;
  t.s = 0;
  t.ka = NEG_INF;
  t.kf = NEG_INF;
  return t;
}

// x followed by y
__device__ __forceinline__ Tup combine(const Tup& x, const Tup& y) {
  Tup r;
  r.s = x.s + y.s;
  r.ka = max(x.ka, y.ka - x.s);
  r.kf = max(x.kf, y.kf - x.s);
  return r;
}

__device__ __forceinline__ Tup element(const int* rel, const uint8_t* req,
                                       long long i, long long n,
                                       long long offset) {
  if (i >= n) return tup_id();
  long long r = rel[i];
  long long q = req[i] ? 1 : 0;
  Tup t;
  t.s = r - q;
  t.kf = (q ? 0 : NEG) - t.s;
  t.ka = i >= offset ? t.kf : NEG_INF;
  return t;
}

// Exclusive scan of one Tup per thread across the block (Hillis-Steele
// over shared memory; the monoid is not commutative, so the left operand
// is always the earlier segment).
__device__ Tup block_exclusive(Tup v, Tup* buf) {
  const int tid = threadIdx.x;
  int cur = 0;
  buf[tid] = v;
  __syncthreads();
  for (int d = 1; d < THREADS; d <<= 1) {
    Tup x = buf[cur * THREADS + tid];
    if (tid >= d) x = combine(buf[cur * THREADS + tid - d], x);
    buf[(1 - cur) * THREADS + tid] = x;
    cur = 1 - cur;
    __syncthreads();
  }
  Tup ex = tid == 0 ? tup_id() : buf[cur * THREADS + tid - 1];
  __syncthreads();
  return ex;
}

struct Ledgers {
  const int* rel[2];
  const uint8_t* req[2];
  int* U[2];
  int* rm[2];
};

__global__ void tile_reduce(Ledgers lg, int L, long long n, long long offset,
                            Tup* tiles) {
  __shared__ Tup buf[2 * THREADS];
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  for (int led = 0; led < L; ++led) {
    Tup acc = tup_id();
    for (int j = 0; j < ITEMS; ++j)
      acc = combine(acc, element(lg.rel[led], lg.req[led], base + j, n,
                                 offset));
    Tup ex = block_exclusive(acc, buf);
    if (threadIdx.x == THREADS - 1)
      tiles[(long long)led * gridDim.x + blockIdx.x] = combine(ex, acc);
  }
}

__global__ void tile_scan(const Tup* tiles, Tup* excl, int L, int ntiles) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  for (int led = 0; led < L; ++led) {
    Tup c = tup_id();
    for (int b = 0; b < ntiles; ++b) {
      excl[(long long)led * ntiles + b] = c;
      c = combine(c, tiles[(long long)led * ntiles + b]);
    }
  }
}

__global__ void tile_emit(Ledgers lg, int L, long long n, long long offset,
                          const Tup* excl) {
  __shared__ Tup buf[2 * THREADS];
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  for (int led = 0; led < L; ++led) {
    const int* rel = lg.rel[led];
    const uint8_t* req = lg.req[led];
    Tup acc = tup_id();
    for (int j = 0; j < ITEMS; ++j)
      acc = combine(acc, element(rel, req, base + j, n, offset));
    Tup ex = block_exclusive(acc, buf);
    Tup c = combine(excl[(long long)led * gridDim.x + blockIdx.x], ex);
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = base + j;
      if (i >= n) break;
      lg.U[led][i] = (int)(c.s + rel[i]);
      const long long m = i >= offset ? c.ka : c.kf;
      lg.rm[led][i] = (int)(m > NEG ? m : NEG);
      c = combine(c, element(rel, req, i, n, offset));
    }
  }
}

}  // namespace

// tiles and excl: int64 scratch of 3 * L * ceil(n / 4096) entries each.
extern "C" int reina_ledger_scan(const void* rel0, const void* rel1,
                                 const void* req0, const void* req1,
                                 void* U0, void* U1, void* rm0, void* rm1,
                                 void* tiles, void* excl, long long n,
                                 long long offset, int L, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Ledgers lg;
  lg.rel[0] = (const int*)rel0;
  lg.rel[1] = (const int*)rel1;
  lg.req[0] = (const uint8_t*)req0;
  lg.req[1] = (const uint8_t*)req1;
  lg.U[0] = (int*)U0;
  lg.U[1] = (int*)U1;
  lg.rm[0] = (int*)rm0;
  lg.rm[1] = (int*)rm1;
  const int ntiles = (int)((n + TILE - 1) / TILE);
  tile_reduce<<<ntiles, THREADS, 0, st>>>(lg, L, n, offset, (Tup*)tiles);
  tile_scan<<<1, 32, 0, st>>>((const Tup*)tiles, (Tup*)excl, L, ntiles);
  tile_emit<<<ntiles, THREADS, 0, st>>>(lg, L, n, offset,
                                        (const Tup*)excl);
  return (int)cudaGetLastError();
}
