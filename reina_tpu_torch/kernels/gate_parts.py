"""What a stop-word gate costs in a CUDA graph (csrc/daygraph.cu: the
gates of a graphed shard of the agent axis), by its parts.

    python -m reina_tpu_torch.kernels.gate_parts [--pieces 64]

Builds (nvcc, sm_90a, into ``build/reina_tpu_torch/parts/``) graphs of
``--pieces`` pieces in a chain, each piece a child graph of one small
kernel, and times one launch of each graph (CUDA events, median of 51
after 10 warm launches):

  plain          the pieces alone
  gate           each piece inside an if node that a one-thread kernel
                 sets from a stop word in host-mapped memory, with a
                 system fence before the read
  gate_nofence   the same without the fence (csrc/daygraph.cu's gate)
  gate_device    the same, the word in device memory
  kernel_only    a kernel that reads the word (as the gate's does) before
                 each piece, no if node
  if_only        an if node around each piece whose handle is set to 1
                 at each launch (cudaGraphCondAssignDefault), no kernel
  one_gate       one gate kernel setting every piece's if (one read a
                 launch): what a gate costs without its own kernel
  body_nodes     as gate_nofence, the piece's kernel node made in the
                 if's body itself, not as a child graph

Prints each graph's µs a launch and, past ``plain``, µs a piece, beside
the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess

from . import build

SOURCE = r"""
#include <cuda_runtime.h>
#include <vector>

__global__ void work(int* m) { *m += 1; }
__global__ void gate(cudaGraphConditionalHandle h, const volatile int* stop,
                     int fence) {
  if (fence) __threadfence_system();
  cudaGraphSetConditional(h, *stop == 0 ? 1u : 0u);
}
__global__ void read_word(const volatile int* stop, int* sink) {
  if (*stop == 12345) *sink = 0;
}
__global__ void gate_all(const cudaGraphConditionalHandle* h, int n,
                         const volatile int* stop) {
  const unsigned v = *stop == 0 ? 1u : 0u;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    cudaGraphSetConditional(h[i], v);
}

#define T(x) do { cudaError_t e = (x); if (e != cudaSuccess) return (int)e; } while (0)

static cudaError_t add_if(cudaGraph_t g, cudaGraphNode_t* deps, size_t nd,
                          cudaGraphConditionalHandle h, cudaGraphNode_t* node,
                          cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeIf;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(node, g, deps, nullptr, nd, &p);
#else
  cudaError_t e = cudaGraphAddNode(node, g, deps, nd, &p);
#endif
  *body = p.conditional.phGraph_out[0];
  return e;
}

static cudaError_t add_kernel(cudaGraph_t g, cudaGraphNode_t* deps, size_t nd,
                              void* fn, void** args, cudaGraphNode_t* node,
                              int threads = 1) {
  cudaKernelNodeParams kp = {};
  kp.func = fn;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(threads);
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, g, deps, nd, &kp);
}

// variant: 0 plain, 1 gate, 2 gate_nofence, 3 gate_device, 4 kernel_only,
// 5 if_only, 6 one_gate, 7 body_nodes. Times `reps` launches; *us: the
// median of them, µs.
extern "C" int gate_time(int variant, int pieces, int* marker,
                         int* stop_host, int* stop_dev, float* us) {
  cudaGraph_t piece;
  T(cudaGraphCreate(&piece, 0));
  cudaGraphNode_t wn;
  void* wargs[] = {&marker};
  T(add_kernel(piece, nullptr, 0, (void*)work, wargs, &wn));
  cudaGraph_t g;
  T(cudaGraphCreate(&g, 0));
  cudaGraphNode_t dep = nullptr;
  int* stop = variant == 3 ? stop_dev : stop_host;
  int fence = variant == 1;
  std::vector<cudaGraphConditionalHandle> hs(pieces);
  cudaGraphConditionalHandle* hdev = nullptr;
  if (variant == 6) {
    for (int i = 0; i < pieces; ++i)
      T(cudaGraphConditionalHandleCreate(&hs[i], g, 0, 0));
    T(cudaMalloc(&hdev, pieces * sizeof(cudaGraphConditionalHandle)));
    T(cudaMemcpy(hdev, hs.data(), pieces * sizeof(cudaGraphConditionalHandle),
                 cudaMemcpyHostToDevice));
    int n = pieces;
    void* args[] = {&hdev, &n, &stop};
    T(add_kernel(g, nullptr, 0, (void*)gate_all, args, &dep, 128));
  }
  for (int i = 0; i < pieces; ++i) {
    cudaGraphNode_t* d = dep ? &dep : nullptr;
    size_t nd = dep ? 1 : 0;
    cudaGraphNode_t node;
    if (variant == 0) {
      T(cudaGraphAddChildGraphNode(&node, g, d, nd, piece));
      dep = node;
      continue;
    }
    if (variant == 4) {
      void* args[] = {&stop, &marker};
      cudaGraphNode_t kn;
      T(add_kernel(g, d, nd, (void*)read_word, args, &kn));
      T(cudaGraphAddChildGraphNode(&node, g, &kn, 1, piece));
      dep = node;
      continue;
    }
    cudaGraphConditionalHandle h = 0;
    if (variant == 6) {
      h = hs[i];
    } else if (variant == 5) {
      T(cudaGraphConditionalHandleCreate(&h, g, 1, cudaGraphCondAssignDefault));
    } else {
      T(cudaGraphConditionalHandleCreate(&h, g, 0, 0));
      void* args[] = {&h, &stop, &fence};
      cudaGraphNode_t kn;
      T(add_kernel(g, d, nd, (void*)gate, args, &kn));
      dep = kn;
      d = &dep;
      nd = 1;
    }
    cudaGraph_t body;
    T(add_if(g, d, nd, h, &node, &body));
    if (variant == 7) {
      cudaGraphNode_t bn;
      T(add_kernel(body, nullptr, 0, (void*)work, wargs, &bn));
    } else {
      cudaGraphNode_t cn;
      T(cudaGraphAddChildGraphNode(&cn, body, nullptr, 0, piece));
    }
    dep = node;
  }
  cudaGraphExec_t ex;
  T(cudaGraphInstantiate(&ex, g, 0));
  cudaStream_t st;
  T(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
  for (int i = 0; i < 10; ++i) T(cudaGraphLaunch(ex, st));
  const int reps = 51;
  std::vector<float> t(reps);
  cudaEvent_t a, b;
  T(cudaEventCreate(&a));
  T(cudaEventCreate(&b));
  for (int i = 0; i < reps; ++i) {
    T(cudaEventRecord(a, st));
    T(cudaGraphLaunch(ex, st));
    T(cudaEventRecord(b, st));
    T(cudaEventSynchronize(b));
    T(cudaEventElapsedTime(&t[i], a, b));
  }
  std::vector<float> s = t;
  for (int i = 0; i < reps; ++i)
    for (int j = i + 1; j < reps; ++j)
      if (s[j] < s[i]) { float x = s[i]; s[i] = s[j]; s[j] = x; }
  *us = s[reps / 2] * 1000.0f;
  cudaGraphExecDestroy(ex);
  cudaGraphDestroy(g);
  cudaGraphDestroy(piece);
  if (hdev) cudaFree(hdev);
  cudaStreamDestroy(st);
  return 0;
}
"""

VARIANTS = ("plain", "gate", "gate_nofence", "gate_device", "kernel_only",
            "if_only", "one_gate", "body_nodes")


def _build():
    out = build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "gate_probe.cu", out / "gate_probe.so"
    cu.write_text(SOURCE)
    r = subprocess.run([build.nvcc_path(), *build._NVCC_FLAGS, "-shared",
                        "-o", str(so), str(cu)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the probe:\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.gate_time.argtypes = ([ctypes.c_int, ctypes.c_int]
                              + [ctypes.c_void_p] * 4)
    return lib


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pieces", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(f"nvidia-smi: {smi[0]}", flush=True)
    lib = _build()
    marker = torch.zeros(1, dtype=torch.int32, device="cuda")
    stop_host = torch.zeros(1, dtype=torch.int32).pin_memory()
    stop_dev = torch.zeros(1, dtype=torch.int32, device="cuda")
    plain = None
    for v, name in enumerate(VARIANTS):
        us = ctypes.c_float()
        err = lib.gate_time(v, args.pieces, marker.data_ptr(),
                            stop_host.data_ptr(), stop_dev.data_ptr(),
                            ctypes.byref(us))
        if err:
            print(f"{name:13s} error {err}", flush=True)
            continue
        plain = us.value if v == 0 else plain
        extra = ("" if v == 0 else
                 f", {(us.value - plain) / args.pieces:.3f} µs a piece "
                 "over plain")
        print(f"{name:13s} {us.value:9.2f} µs a launch of {args.pieces} "
              f"pieces{extra}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
