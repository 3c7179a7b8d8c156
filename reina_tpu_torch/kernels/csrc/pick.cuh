// A tier pick made inside the kernel that produces its count: the index
// computation of the reference's lax.switch and lax.cond inside its
// compiled day (reina_tpu/core/step.py: the slot-tier switch's
// searchsorted at :1344, the member-tier switches :922 and :952, the
// column-tier switch :912-918, the tracing cond :976, the overflow bits
// :979-981 and :1231-1232). Its plain twin is
// reina_tpu_torch/core/daygraph.py:pick_twin.
//
// A pick reads one or two int32 counts, takes for each the left
// searchsorted into its tier ceilings (the count clamped to a cap first,
// the index clamped to the last branch, as lax.switch clamps it), and
//   * sets the day graph's conditional node through the handle in the
//     graph set's handle table (which the day graph's head fills), where
//     the producer runs inside a day graph,
//   * writes the branch into row *counter of the run's picks table,
//   * adds one to the branch's tally (the launches that ran),
//   * ORs the overflow bit of a count above its cap into the carry's
//     problem bits.
// A Fold is what one producing launch picks: up to two picks, made by
// one thread once the count is in memory; with `gate`, the second only
// where the first took a branch other than 0 (the tracing cond, then
// T1's switch in its body).
#pragma once
#include <cuda_runtime.h>

namespace reina {

// tier ceilings of one count: head · 3^k up to an int32 cap, from a
// head of 1 (core/daygraph.py:MAX_ENDS)
constexpr int MAX_ENDS = 24;

struct Pick {
  const int* count[2];        // count[1] == nullptr: a pick of one count
  int ends[2][MAX_ENDS];      // each count's tier ceilings, ascending
  int n[2];                   // how many
  int cap[2];                 // the count's clamp (< 0: none)
  int bit[2];                 // problem bit where the count exceeds cap
  int* picks;                 // (days, ncols) int32
  const long long* counter;   // the row: the run's device day counter
  int ncols, col;
  int* tally;                 // one int32 a branch
  int* problem;               // the carry's int32 problem bits
  // the conditional's slot in the handle table (nullptr: launched
  // outside a day graph, no conditional to set)
  const unsigned long long* handle;
};

struct Fold {
  int n;                      // picks: 0, 1 or 2
  int gate;                   // 1: p[1] only where p[0]'s branch != 0
  Pick p[2];
};

__device__ __forceinline__ unsigned take_pick(const Pick& a) {
  unsigned branch = 0;
  int bits = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (a.count[k] == nullptr) continue;
    const int x = *(volatile const int*)a.count[k];
    if (a.bit[k] != 0 && x > a.cap[k]) bits |= a.bit[k];
    const int y = (a.cap[k] >= 0 && x > a.cap[k]) ? a.cap[k] : x;
    int b = 0;
    while (b < a.n[k] - 1 && a.ends[k][b] < y) ++b;
    branch = branch * (unsigned)a.n[k] + (unsigned)b;
  }
  a.picks[*a.counter * a.ncols + a.col] = (int)branch;
  a.tally[branch] += 1;
  if (bits != 0) *a.problem |= bits;
  if (a.handle != nullptr)
    cudaGraphSetConditional((cudaGraphConditionalHandle)*a.handle, branch);
  return branch;
}

// The fold's picks, by the one thread that wrote the count.
__device__ __forceinline__ void take_fold(const Fold& f) {
  if (f.n < 1) return;
  const unsigned b = take_pick(f.p[0]);
  if (f.n > 1 && (f.gate == 0 || b != 0)) take_pick(f.p[1]);
}

}  // namespace reina
