// The day graph: a day of the port's day step as one CUDA graph, with the
// JAX package's tier picks made on the device by the kernels that produce
// their counts (csrc/pick.cuh), and the reduce-and-pick kernel for the
// counts that are a maximum.
//
// Every tier pick of the day (reina_tpu_torch/core/step.py:day_program)
// is folded into a producer's launch (core/daygraph.py:FOLDS): the slot
// pick into the prefix of today's infections (csrc/prefix.cu), the
// tracing cond and T1's switch into the prefix that compacts the drained
// agents, T3's into the frontier's prefix, and T2's and T4's into
// max_pick below, which takes the bucket fill maximum of the members at
// the end of each branch of T1 and T3. There is no pick node: a
// conditional node follows the span (or branch) whose kernel set it.
//
// max_pick replaces the torch maximum of the reference's
// jnp.max(fill_m) (reina_tpu/core/step.py:912-918) and the pick that
// read it. What bounds it: the fill values it reads (4 bytes a member of
// the tier's ceiling) and a launch; one CTA reads them, which at the
// tiers a day uses (up to a few thousand members) is a launch's floor.
//
// The graph is assembled here from the spans' captured torch graphs
// (torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()), each added
// as a child-graph node (a clone); a conditional node's bodies are
// graphs that the node owns. A producing kernel sits in a captured span,
// captured before the day graph and its handles exist, and each span is
// cloned into up to four day graphs; so it reads its conditional's
// handle from the graph set's handle table, which a memcpy node at the
// head of each day graph fills with that graph's handles. A kernel in a
// child graph or a conditional body may set a conditional of an
// enclosing graph or of a nested body (kernels/cond_parts.py checks each
// layout the day uses on the card). Every entry point returns a
// cudaError_t.
//
// The gates of a graphed shard of the agent axis (core/graphs.py): a
// span that holds captured NCCL collectives is split after each of them
// into pieces (reina_dg_split: the nodes before and at the first
// collective, then up to the next, ...), and each piece runs inside an
// if node whose handle stop_gate sets from the graph set's stop word, a
// word of host-mapped pinned memory (reina_stop_alloc). The host sets the
// word before it aborts the agent group's communicator
// (parallel/mesh.py:give_up), which ends a collective stuck on a lost
// peer: every piece after it, of that day and of the days queued behind
// it, then reads the word and runs nothing, so no kernel ever reads what
// the aborted collective left in its buffers. A gate is one one-thread
// kernel and one conditional node: ~9.6 µs of a chain on an H100, of
// which the conditional node ~6.2 (kernels/gate_parts.py).
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

#include "pick.cuh"

namespace {

using reina::Fold;
using reina::MAX_ENDS;
using reina::Pick;

constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(MAX_THREADS)
max_pick_kernel(const int* __restrict__ x, long long n, int* out, Fold f) {
  __shared__ int wm[MAX_THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int m = INT_MIN;
  for (long long i = threadIdx.x; i < n; i += MAX_THREADS)
    m = max(m, __ldg(x + i));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = max(m, __shfl_xor_sync(FULL, m, s));
  if (lane == 0) wm[warp] = m;
  __syncthreads();
  if (warp != 0) return;
  m = wm[lane];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = max(m, __shfl_xor_sync(FULL, m, s));
  if (lane == 0) {
    *out = m;
    reina::take_fold(f);
  }
}

// Runs its if node's body only while the stop word is 0; volatile: the
// host writes the word while the card runs. No fence before the read:
// the host sets the word before it aborts the group, and the collective
// before the gate returns only once the abort has reached the card
// (kernels/gate_parts.py: a system fence cost 2.3 µs a gate).
__global__ void stop_gate(cudaGraphConditionalHandle h,
                          const volatile int* stop) {
  cudaGraphSetConditional(h, *stop == 0 ? 1u : 0u);
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

extern "C" int reina_fold_bytes() { return (int)sizeof(Fold); }

// Pick i (0 or 1) of the Fold at `fold` (host memory, reina_fold_bytes()
// bytes, zeroed by the caller); gate: the second pick only where the
// first took a branch other than 0. c0: the first count (int32 on the
// device); ends0: its n0 ceilings (host); cap0 < 0: no clamp; bit0: the
// problem bit of a count above cap0; c1 ... bit1 the second count, c1
// NULL for none. The branch goes to picks[*counter * ncols + col].
// handle: the conditional's slot in the handle table on the device, NULL
// for none.
extern "C" int reina_fold_set(void* fold, int i, int gate, const void* c0,
                              const int* ends0, int n0, int cap0, int bit0,
                              const void* c1, const int* ends1, int n1,
                              int cap1, int bit1, void* picks,
                              const void* counter, int ncols, int col,
                              void* tally, void* problem,
                              const void* handle) {
  Fold* f = (Fold*)fold;
  if (f == nullptr || i < 0 || i > 1 || c0 == nullptr || picks == nullptr ||
      counter == nullptr || tally == nullptr || problem == nullptr ||
      col < 0 || col >= ncols)
    return (int)cudaErrorInvalidValue;
  Pick* a = &f->p[i];
  *a = Pick{};
  const void* cs[2] = {c0, c1};
  const int* es[2] = {ends0, ends1};
  const int ns[2] = {n0, n1};
  const int caps[2] = {cap0, cap1};
  const int bs[2] = {bit0, bit1};
  for (int k = 0; k < 2; ++k) {
    if (cs[k] == nullptr) continue;
    if (ns[k] < 1 || ns[k] > MAX_ENDS) return (int)cudaErrorInvalidValue;
    a->count[k] = (const int*)cs[k];
    a->n[k] = ns[k];
    a->cap[k] = caps[k];
    a->bit[k] = bs[k];
    for (int j = 0; j < ns[k]; ++j) a->ends[k][j] = es[k][j];
  }
  a->picks = (int*)picks;
  a->counter = (const long long*)counter;
  a->ncols = ncols;
  a->col = col;
  a->tally = (int*)tally;
  a->problem = (int*)problem;
  a->handle = (const unsigned long long*)handle;
  if (f->n < i + 1) f->n = i + 1;
  f->gate = gate;
  return 0;
}

// out (int32 on the device) = the maximum of x[0, n) (int32, n >= 1),
// then the picks of `fold` (host memory as reina_fold_set fills it; NULL:
// none). events: NULL, or 2 CUDA events recorded before and after the
// launch.
extern "C" int reina_max_pick(const void* x, long long n, void* out,
                              const void* fold, void* const* events,
                              void* stream) {
  if (x == nullptr || out == nullptr || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Fold f = fold == nullptr ? Fold{} : *(const Fold*)fold;
  if (events) cudaEventRecord((cudaEvent_t)events[0], st);
  max_pick_kernel<<<1, MAX_THREADS, 0, st>>>((const int*)x, n, (int*)out, f);
  if (events) cudaEventRecord((cudaEvent_t)events[1], st);
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

// A device-to-device copy of `bytes` from src to dst as a node of
// `graph` after `dep` (the handle table's fill at a day graph's head).
extern "C" int reina_dg_memcpy(void* graph, void* dep, void* dst,
                               const void* src, long long bytes,
                               void** node) {
  cudaGraphNode_t d = (cudaGraphNode_t)dep;
  return (int)cudaGraphAddMemcpyNode1D(
      (cudaGraphNode_t*)node, (cudaGraph_t)graph, &d, d == nullptr ? 0 : 1,
      dst, src, (size_t)bytes, cudaMemcpyDeviceToDevice);
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

// A graph set's stop word: one int of host-mapped pinned memory, zeroed;
// *host its host address, *dev its device address.
extern "C" int reina_stop_alloc(void** host, void** dev) {
  cudaError_t err =
      cudaHostAlloc(host, 64, cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return (int)err;
  *(volatile int*)*host = 0;
  return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

extern "C" int reina_stop_free(void* host) {
  return (int)cudaFreeHost(host);
}

// A gate of `graph` after `dep`: stop_gate (reading the stop word at its
// device address `stop`) then an if node; *body: the if node's body,
// which runs only while the word is 0; *node: the if node.
extern "C" int reina_dg_gate(void* graph, void* dep, void* stop, void** node,
                             void** body) {
  cudaGraph_t g = (cudaGraph_t)graph;
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (err != cudaSuccess) return (int)err;
  cudaKernelNodeParams kp = {};
  void* args[] = {&h, &stop};
  kp.func = (void*)stop_gate;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t d = (cudaGraphNode_t)dep, kn;
  err = cudaGraphAddKernelNode(&kn, g, &d, d == nullptr ? 0 : 1, &kp);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeIf;
  p.conditional.size = 1;
  err = add_node((cudaGraphNode_t*)node, g, kn, &p);
  if (err != cudaSuccess) return (int)err;
  *body = (void*)p.conditional.phGraph_out[0];
  return 0;
}

// The nodes a stream under capture has just captured (its capture
// dependencies, at most 8, into nodes[0, *n)): where a collective ends,
// a piece of its span ends.
extern "C" int reina_dg_capture_leaf(void* stream, void** nodes, int* n) {
  cudaStreamCaptureStatus st;
  const cudaGraphNode_t* deps = nullptr;
  size_t nd = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &st,
                                             nullptr, nullptr, &deps,
                                             nullptr, &nd);
#else
  cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &st,
                                             nullptr, nullptr, &deps, &nd);
#endif
  if (err != cudaSuccess) return (int)err;
  if (st != cudaStreamCaptureStatusActive || nd < 1 || nd > 8)
    return (int)cudaErrorStreamCaptureUnmatched;
  for (size_t i = 0; i < nd; ++i) nodes[i] = (void*)deps[i];
  *n = (int)nd;
  return 0;
}

// Splits a captured span `graph` at its guard nodes (guards[0, ng), in
// capture order): piece i holds the nodes that guard i depends on (itself
// among them) and no earlier guard does; the last piece holds the rest.
// Each piece that holds a node is a new graph (a clone of `graph` less
// the other pieces' nodes; every edge between two pieces runs from an
// earlier piece to a later one, so running the pieces in order keeps
// every dependency), into pieces[0, *n), in order.
extern "C" int reina_dg_split(void* graph, void* const* guards, int ng,
                              void** pieces, int* n) {
  cudaGraph_t g = (cudaGraph_t)graph;
  *n = 0;
  size_t nn = 0, ne = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &nn);
  if (err != cudaSuccess) return (int)err;
  std::vector<cudaGraphNode_t> nodes(nn);
  if (nn) err = cudaGraphGetNodes(g, nodes.data(), &nn);
  if (err != cudaSuccess) return (int)err;
#if CUDART_VERSION >= 13000
  err = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &ne);
#else
  err = cudaGraphGetEdges(g, nullptr, nullptr, &ne);
#endif
  if (err != cudaSuccess) return (int)err;
  std::vector<cudaGraphNode_t> from(ne), to(ne);
  if (ne) {
#if CUDART_VERSION >= 13000
    err = cudaGraphGetEdges(g, from.data(), to.data(), nullptr, &ne);
#else
    err = cudaGraphGetEdges(g, from.data(), to.data(), &ne);
#endif
    if (err != cudaSuccess) return (int)err;
  }
  auto index = [&](cudaGraphNode_t v) {
    for (size_t i = 0; i < nn; ++i)
      if (nodes[i] == v) return (long)i;
    return -1L;
  };
  std::vector<int> piece(nn, ng);
  for (int p = 0; p < ng; ++p) {
    const long gi = index((cudaGraphNode_t)guards[p]);
    if (gi < 0) return (int)cudaErrorInvalidValue;
    std::vector<long> stack{gi};
    while (!stack.empty()) {
      const long v = stack.back();
      stack.pop_back();
      if (piece[v] != ng) continue;
      piece[v] = p;
      for (size_t e = 0; e < ne; ++e)
        if (to[e] == nodes[v]) stack.push_back(index(from[e]));
    }
  }
  for (int p = 0; p <= ng; ++p) {
    bool any = false;
    for (size_t i = 0; i < nn; ++i) any |= piece[i] == p;
    if (!any) continue;
    cudaGraph_t c;
    err = cudaGraphClone(&c, g);
    if (err != cudaSuccess) return (int)err;
    for (size_t i = 0; i < nn && err == cudaSuccess; ++i) {
      if (piece[i] == p) continue;
      cudaGraphNode_t ci;
      err = cudaGraphNodeFindInClone(&ci, nodes[i], c);
      if (err == cudaSuccess) err = cudaGraphDestroyNode(ci);
    }
    if (err != cudaSuccess) {
      cudaGraphDestroy(c);
      return (int)err;
    }
    pieces[(*n)++] = (void*)c;
  }
  return 0;
}

extern "C" const char* reina_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
