// The day graph: a day of the port's day step as one CUDA graph, with the
// JAX package's tier picks made on the device, and the pick kernel that
// makes them.
//
// Replaces the index computation of the reference's lax.switch and
// lax.cond inside its compiled day (reina_tpu/core/step.py: the slot-tier
// switch's searchsorted at :1344, the member-tier switches :922 and :952,
// the column-tier switch :912-918, the tracing cond :976, the overflow
// bits :979-981 and :1231-1232); it has no Pallas counterpart. Its plain
// twin is reina_tpu_torch/core/daygraph.py:pick_twin.
//
// A pick reads one or two int32 counts where the span before it left
// them, takes for each the left searchsorted into its tier ceilings (the
// count clamped to a cap first, the index clamped to the last branch, as
// lax.switch clamps it), and
//   * sets the conditional node that follows it to the branch
//     (cudaGraphSetConditional: a switch over the tiers, or an if),
//   * writes the branch into row *counter of the run's picks table,
//   * adds one to the branch's tally (the launches that ran),
//   * ORs the overflow bit of a count above its cap into the carry's
//     problem bits.
// What bounds it: nothing but a launch. One thread reads at most 8 bytes
// of counts, 8 of the day counter and 4 of the tally (and 4 of the
// problem bits where a count overflows) and writes at most 12; its time
// is the launch's floor.
//
// The graph is assembled here from the spans' captured torch graphs
// (torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()), each added
// as a child-graph node (a clone); a conditional node's bodies are
// graphs that the node owns. Every entry point returns a cudaError_t.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  cudaGraphConditionalHandle handle;
  int set;                    // 0: launched outside a graph, no handle
};

__global__ void pick_kernel(Pick a) {
  unsigned branch = 0;
  int bits = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (a.count[k] == nullptr) continue;
    const int x = *a.count[k];
    if (a.bit[k] != 0 && x > a.cap[k]) bits |= a.bit[k];
    const int y = (a.cap[k] >= 0 && x > a.cap[k]) ? a.cap[k] : x;
    int b = 0;
    while (b < a.n[k] - 1 && a.ends[k][b] < y) ++b;
    branch = branch * (unsigned)a.n[k] + (unsigned)b;
  }
  a.picks[*a.counter * a.ncols + a.col] = (int)branch;
  a.tally[branch] += 1;
  if (bits != 0) *a.problem |= bits;
  if (a.set) cudaGraphSetConditional(a.handle, branch);
}

int make_pick(Pick* a, const void* c0, const int* ends0, int n0, int cap0,
              int bit0, const void* c1, const int* ends1, int n1, int cap1,
              int bit1, void* picks, const void* counter, int ncols, int col,
              void* tally, void* problem) {
  *a = Pick{};
  const void* cs[2] = {c0, c1};
  const int* es[2] = {ends0, ends1};
  const int ns[2] = {n0, n1};
  const int caps[2] = {cap0, cap1};
  const int bs[2] = {bit0, bit1};
  if (c0 == nullptr || picks == nullptr || counter == nullptr ||
      tally == nullptr || problem == nullptr || col < 0 || col >= ncols)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 2; ++k) {
    if (cs[k] == nullptr) continue;
    if (ns[k] < 1 || ns[k] > MAX_ENDS) return (int)cudaErrorInvalidValue;
    a->count[k] = (const int*)cs[k];
    a->n[k] = ns[k];
    a->cap[k] = caps[k];
    a->bit[k] = bs[k];
    for (int i = 0; i < ns[k]; ++i) a->ends[k][i] = es[k][i];
  }
  a->picks = (int*)picks;
  a->counter = (const long long*)counter;
  a->ncols = ncols;
  a->col = col;
  a->tally = (int*)tally;
  a->problem = (int*)problem;
  return 0;
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     cudaGraphNode_t dep, cudaGraphNodeParams* p) {
  const size_t nd = dep == nullptr ? 0 : 1;
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, &dep, nullptr, nd, p);
#else
  return cudaGraphAddNode(node, graph, &dep, nd, p);
#endif
}

}  // namespace

#define PICK_ARGS                                                          \
  const void *c0, const int *ends0, int n0, int cap0, int bit0,           \
      const void *c1, const int *ends1, int n1, int cap1, int bit1,       \
      void *picks, const void *counter, int ncols, int col, void *tally,  \
      void *problem
#define PICK_NAMES                                                         \
  c0, ends0, n0, cap0, bit0, c1, ends1, n1, cap1, bit1, picks, counter,    \
      ncols, col, tally, problem

// One pick launched on a stream, outside a graph (no conditional to set):
// the kernel's check against its twin. c0: the first count (int32 on the
// device); ends0: its n0 ceilings (host); cap0 < 0: no clamp; bit0: the
// problem bit of a count above cap0; c1 ... bit1 the second count, c1 NULL
// for none. The branch goes to picks[*counter * ncols + col].
extern "C" int reina_pick(PICK_ARGS, void* stream) {
  Pick a;
  const int err = make_pick(&a, PICK_NAMES);
  if (err != 0) return err;
  pick_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int reina_dg_create(void** graph) {
  return (int)cudaGraphCreate((cudaGraph_t*)graph, 0);
}

// A clone of `child` (a captured span) into `graph` after `dep` (NULL:
// first in its graph).
extern "C" int reina_dg_child(void* graph, void* dep, void* child,
                              void** node) {
  cudaGraphNode_t d = (cudaGraphNode_t)dep;
  return (int)cudaGraphAddChildGraphNode((cudaGraphNode_t*)node,
                                         (cudaGraph_t)graph, &d,
                                         d == nullptr ? 0 : 1,
                                         (cudaGraph_t)child);
}

// A conditional handle on `graph`, the graph that will hold its node.
extern "C" int reina_dg_handle(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h;
  const cudaError_t err =
      cudaGraphConditionalHandleCreate(&h, (cudaGraph_t)graph, 0, 0);
  *handle = (unsigned long long)h;
  return (int)err;
}

// The pick kernel as a node of `graph` after `dep`, setting `handle`.
extern "C" int reina_dg_pick(void* graph, void* dep, PICK_ARGS,
                             unsigned long long handle, void** node) {
  Pick a;
  const int err = make_pick(&a, PICK_NAMES);
  if (err != 0) return err;
  a.handle = (cudaGraphConditionalHandle)handle;
  a.set = 1;
  void* args[] = {&a};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)pick_kernel;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t d = (cudaGraphNode_t)dep;
  return (int)cudaGraphAddKernelNode((cudaGraphNode_t*)node,
                                     (cudaGraph_t)graph, &d,
                                     d == nullptr ? 0 : 1, &kp);
}

// A conditional node of `graph` after `dep`: kind 0 an if (size 1), kind
// 1 a switch over `size` branches. bodies: its `size` body graphs, owned
// by the node.
extern "C" int reina_dg_cond(void* graph, void* dep, unsigned long long handle,
                             int kind, int size, void** node, void** bodies) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = (cudaGraphConditionalHandle)handle;
  p.conditional.type = kind == 0 ? cudaGraphCondTypeIf : cudaGraphCondTypeSwitch;
  p.conditional.size = (unsigned)size;
  const cudaError_t err =
      add_node((cudaGraphNode_t*)node, (cudaGraph_t)graph,
               (cudaGraphNode_t)dep, &p);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < size; ++i) bodies[i] = (void*)p.conditional.phGraph_out[i];
  return 0;
}

extern "C" int reina_dg_instantiate(void* graph, void** exec) {
  return (int)cudaGraphInstantiate((cudaGraphExec_t*)exec, (cudaGraph_t)graph,
                                   0);
}

extern "C" int reina_dg_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// Destroys an instantiated day graph and its graph (either may be NULL).
extern "C" int reina_dg_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec != nullptr) err = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph != nullptr) {
    const cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
    if (err == cudaSuccess) err = e2;
  }
  return (int)err;
}

// counts[t] += the nodes of type t (cudaGraphNodeType, t < 32) of `graph`.
extern "C" int reina_dg_node_types(void* graph, int* counts) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return (int)err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes((cudaGraph_t)graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err == cudaSuccess && (int)t >= 0 && (int)t < 32) counts[(int)t] += 1;
  }
  delete[] nodes;
  return (int)err;
}

extern "C" const char* reina_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
