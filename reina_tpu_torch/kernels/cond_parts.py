"""Which kernels of a day graph may set which conditional nodes: a probe
of the CUDA graph layouts that the fused tier picks rely on
(``kernels/csrc/pick.cuh``, ``core/daygraph.py``).

    python -m reina_tpu_torch.kernels.cond_parts

A pick is made by the kernel that produces its count, and that kernel
sits in a captured span: a child-graph node of the day graph or of a
conditional body, where the conditional node it sets may lie in an
enclosing graph or in a nested body. The kernel reads the handle from a
device table that a memcpy node at the day graph's head fills. Each
case below builds a small graph with the CUDA runtime (nvcc, sm_90a,
into ``build/reina_tpu_torch/parts/``), launches it with the condition
set to 0 and to 1, and prints whether the body ran exactly when it was
set to 1:

  child_sets_enclosing  a kernel in a child graph sets an if of the
                        graph that holds the child (C from span B)
  outer_sets_nested     a kernel of the top graph sets an if inside an
                        if's body (T1 from span A)
  body_sets_sibling     a kernel in a switch's branch body (a child graph
                        there) sets an if beside the switch (T2 from a
                        T1 branch, T3 from a T2 branch)
  captured_cooperative  a cooperative launch captured from a stream, as
                        a child graph, sets an if of the top graph (the
                        prefix kernel under torch's capture)
  table_by_memcpy       as child_sets_enclosing, the handle table
                        filled by a memcpy node at the graph's head
  twice                 two graphs, each with its own handle and memcpy
                        node into one table, launched in turn

Needs a CUDA device; prints one line a case and exits 1 if any case
fails.
"""
from __future__ import annotations

import ctypes
import subprocess

from . import build

SOURCE = r"""
#include <cuda_runtime.h>
typedef unsigned long long u64;

__global__ void setk(const u64* slot, unsigned v) {
  cudaGraphSetConditional((cudaGraphConditionalHandle)*slot, v);
}
__global__ void setk_coop(const u64* slot, unsigned v) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    cudaGraphSetConditional((cudaGraphConditionalHandle)*slot, v);
}
__global__ void mark(int* m) { *m += 1; }

static cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t g,
                            cudaGraphNode_t dep, cudaGraphNodeParams* p) {
  const size_t nd = dep == nullptr ? 0 : 1;
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, g, &dep, nullptr, nd, p);
#else
  return cudaGraphAddNode(node, g, &dep, nd, p);
#endif
}
static cudaError_t kern(cudaGraph_t g, cudaGraphNode_t dep, void* f,
                        void** args, cudaGraphNode_t* out) {
  cudaKernelNodeParams kp = {};
  kp.func = f;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(out, g, &dep, dep ? 1 : 0, &kp);
}
static cudaError_t cond(cudaGraph_t g, cudaGraphNode_t dep, u64 h, int sw,
                        cudaGraphNode_t* out, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = (cudaGraphConditionalHandle)h;
  p.conditional.type = sw ? cudaGraphCondTypeSwitch : cudaGraphCondTypeIf;
  p.conditional.size = sw ? 2 : 1;
  cudaError_t e = add_node(out, g, dep, &p);
  if (e == cudaSuccess) {
    body[0] = p.conditional.phGraph_out[0];
    if (sw) body[1] = p.conditional.phGraph_out[1];
  }
  return e;
}
static cudaError_t handle(cudaGraph_t g, u64* h) {
  cudaGraphConditionalHandle c;
  cudaError_t e = cudaGraphConditionalHandleCreate(&c, g, 0, 0);
  *h = (u64)c;
  return e;
}
// a child graph of one kernel setk(slot, v) in g after dep
static cudaError_t child_setk(cudaGraph_t g, cudaGraphNode_t dep, u64* slot,
                              unsigned v, cudaGraphNode_t* out) {
  cudaGraph_t c;
  cudaGraphCreate(&c, 0);
  cudaGraphNode_t k;
  void* a[] = {&slot, &v};
  cudaError_t e = kern(c, nullptr, (void*)setk, a, &k);
  if (e == cudaSuccess)
    e = cudaGraphAddChildGraphNode(out, g, &dep, dep ? 1 : 0, c);
  cudaGraphDestroy(c);
  return e;
}

#define T(x) do { cudaError_t e_ = (x); if (e_ != cudaSuccess) return (int)e_; } while (0)

// case k with condition v; *marker (device) counts the body's runs;
// table: 4 u64 on the device; stage: 4 u64 on the device
extern "C" int probe(int k, unsigned v, int* marker, u64* table, u64* stage) {
  cudaGraph_t g, g2 = nullptr;
  T(cudaGraphCreate(&g, 0));
  cudaGraphNode_t n0 = nullptr, n1, n2, n3;
  cudaGraph_t b[2], bb[2];
  u64 h[4] = {0, 0, 0, 0};
  unsigned one = 1;
  void* am[] = {&marker};
  int launches = 1;
  if (k == 0 || k == 4) {                    // child sets enclosing
    T(handle(g, &h[0]));
    if (k == 4)
      T(cudaGraphAddMemcpyNode1D(&n0, g, nullptr, 0, table, stage,
                                 sizeof(u64), cudaMemcpyDeviceToDevice));
    T(child_setk(g, n0, table, v, &n1));
    T(cond(g, n1, h[0], 0, &n2, b));
    T(kern(b[0], nullptr, (void*)mark, am, &n3));
  } else if (k == 5) {                       // two graphs, one table
    for (int i = 0; i < 2; ++i) {
      cudaGraph_t gi = g;
      if (i == 1) {
        T(cudaGraphCreate(&g2, 0));
        gi = g2;
      }
      T(handle(gi, &h[i]));
      T(cudaGraphAddMemcpyNode1D(&n0, gi, nullptr, 0, table, stage + i,
                                 sizeof(u64), cudaMemcpyDeviceToDevice));
      T(child_setk(gi, n0, table, v, &n1));
      T(cond(gi, n1, h[i], 0, &n2, b));
      T(kern(b[0], nullptr, (void*)mark, am, &n3));
    }
  } else if (k == 1) {                       // outer sets nested
    T(handle(g, &h[0]));
    u64* s0 = table;
    void* a0[] = {&s0, &one};
    T(kern(g, nullptr, (void*)setk, a0, &n0));
    cudaGraphNode_t nk;
    T(child_setk(g, n0, table + 1, v, &nk));
    T(cond(g, nk, h[0], 0, &n1, b));
    T(handle(b[0], &h[1]));
    T(cond(b[0], nullptr, h[1], 0, &n2, bb));
    T(kern(bb[0], nullptr, (void*)mark, am, &n3));
  } else if (k == 2) {                       // body sets sibling
    T(handle(g, &h[0]));
    u64* s0 = table;
    void* a0[] = {&s0, &one};
    T(kern(g, nullptr, (void*)setk, a0, &n0));
    T(cond(g, n0, h[0], 0, &n1, b));           // if T (taken)
    T(handle(b[0], &h[1]));                    // switch in T's body
    T(handle(b[0], &h[2]));                    // if beside it
    cudaGraphNode_t ns, nk, ni;
    u64* s1 = table + 1;
    void* a1[] = {&s1, &one};
    T(kern(b[0], nullptr, (void*)setk, a1, &nk));  // switch -> branch 1
    T(cond(b[0], nk, h[1], 1, &ns, bb));
    for (int i = 0; i < 2; ++i) {
      cudaGraphNode_t c;
      T(child_setk(bb[i], nullptr, table + 2, i == 1 ? v : 0, &c));
    }
    cudaGraph_t bi[1];
    T(cond(b[0], ns, h[2], 0, &ni, bi));
    T(kern(bi[0], nullptr, (void*)mark, am, &n3));
  } else if (k == 3) {                       // captured cooperative
    T(handle(g, &h[0]));
    cudaStream_t st;
    T(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
    cudaGraph_t cap;
    T(cudaStreamBeginCapture(st, cudaStreamCaptureModeThreadLocal));
    u64* s0 = table;
    void* a0[] = {&s0, &v};
    cudaError_t le = cudaLaunchCooperativeKernel((const void*)setk_coop,
                                                 dim3(4), dim3(64), a0, 0, st);
    T(cudaStreamEndCapture(st, &cap));
    T(le);
    T(cudaGraphAddChildGraphNode(&n1, g, nullptr, 0, cap));
    cudaGraphDestroy(cap);
    cudaStreamDestroy(st);
    T(cond(g, n1, h[0], 0, &n2, b));
    T(kern(b[0], nullptr, (void*)mark, am, &n3));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaGraphExec_t ex, ex2 = nullptr;
  T(cudaGraphInstantiate(&ex, g, 0));
  if (g2) {
    T(cudaGraphInstantiate(&ex2, g2, 0));
    launches = 2;
  }
  // the table holds this graph's handles (case 4, 5: through stage)
  T(cudaMemcpy(k >= 4 ? stage : table, h, sizeof(h), cudaMemcpyHostToDevice));
  T(cudaGraphLaunch(ex, 0));
  if (ex2) T(cudaGraphLaunch(ex2, 0));
  T(cudaDeviceSynchronize());
  cudaGraphExecDestroy(ex);
  if (ex2) cudaGraphExecDestroy(ex2);
  cudaGraphDestroy(g);
  if (g2) cudaGraphDestroy(g2);
  return launches == 2 ? -2 : 0;
}

extern "C" const char* probe_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
"""

CASES = ("child_sets_enclosing", "outer_sets_nested", "body_sets_sibling",
         "captured_cooperative", "table_by_memcpy", "twice")


def _build():
    out = build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "cond_probe.cu", out / "cond_probe.so"
    cu.write_text(SOURCE)
    r = subprocess.run([build.nvcc_path(), *build._NVCC_FLAGS, "-shared",
                        "-o", str(so), str(cu)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the probe:\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.probe.argtypes = [ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p]
    lib.probe_error.restype = ctypes.c_char_p
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    lib = _build()
    ok = True
    for k, name in enumerate(CASES):
        runs = []
        for v in (0, 1):
            marker = torch.zeros(1, dtype=torch.int32, device="cuda")
            table = torch.zeros(4, dtype=torch.int64, device="cuda")
            stage = torch.zeros(4, dtype=torch.int64, device="cuda")
            torch.cuda.synchronize()
            err = lib.probe(k, v, marker.data_ptr(), table.data_ptr(),
                            stage.data_ptr())
            launches = 2 if err == -2 else 1
            if err not in (0, -2):
                runs.append(f"error {err} ({lib.probe_error(err).decode()})")
                continue
            got = int(marker.item())
            runs.append(got == v * launches)
        good = all(r is True for r in runs)
        ok &= good
        print(f"{name:22s} {'ok' if good else 'FAILED'}  (set 0, set 1: "
              f"{runs})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
