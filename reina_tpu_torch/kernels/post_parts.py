"""The post-ledger body beside the yardsticks of its bytes, and design
variants of its kernel, on one card at the HUS agent count.

    python -m reina_tpu_torch.kernels.post_parts

Times with ``checks.time_ms`` (cold L2, median of 7), on the inputs of
``kernels/checks.py``:

  body           the post body as this tree launches it (``fused_map``)
  post full      ``post.cu`` built alone, as it is: CTAs of 128 threads,
                 two steps a thread staged in shared memory
  post t64       CTAs of 64 threads
  post t256      CTAs of 256 threads
  post s3        three steps staged a thread
  fill1          a one-element fill: the floor of this timing for any
                 launch
  copy           a device copy that moves as many bytes as the body
                 (reads half, writes half)

Each variant is built from this checkout's ``post.cu`` (nvcc, sm_90a)
into ``build/reina_tpu_torch/parts/`` and says whether its outputs equal
the twin's. Needs a CUDA device.
"""
from __future__ import annotations

import subprocess

import torch

from . import build, checks


def _threads(k):
    return ("constexpr int THREADS = 128;", f"constexpr int THREADS = {k};")


def _stages(k):
    return ("constexpr int STAGES = 2;", f"constexpr int STAGES = {k};")


VARIANTS = {"full": (), "t64": (_threads(64),), "t256": (_threads(256),),
            "s3": (_stages(3),)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from ..core import step
    from ..ops import fusedmap
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    n = checks.HUS_N
    s = checks._streams(n, 0, "cuda")
    po = checks.post_args(s)
    want = step.post(*po)
    moved = checks._nbytes(po) + checks._nbytes(want)
    body = checks.time_ms(lambda: fusedmap.fused_map(step.post, po[:20],
                                                     po[20:]))
    print(f"body           {body:.4f} ms ({moved} B moved)", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    outs = [torch.empty_like(w) for w in want]
    ins, tabs = build.pointers(po[:20]), build.pointers(po[20:])
    out_p = build.pointers(outs)
    for name, cuts in VARIANTS.items():
        fn = build.build_variant("post.cu", "reina_post", f"post_{name}",
                                 cuts)

        def call():
            build.check(fn(ins, tabs, checks.V, out_p, n, None, stream),
                        name)

        call()
        torch.cuda.synchronize()
        equal = all(torch.equal(o, w) for o, w in zip(outs, want))
        print(f"post {name:9s} {checks.time_ms(call):.4f} ms  equal to "
              f"twin: {equal}", flush=True)
    dst = torch.empty(1, device="cuda")
    src = torch.ones(moved // 2, dtype=torch.uint8, device="cuda")
    dst2 = torch.empty_like(src)
    print(f"fill1          {checks.time_ms(lambda: dst.fill_(0)):.4f} ms")
    print(f"copy           {checks.time_ms(lambda: dst2.copy_(src)):.4f} ms "
          f"({2 * src.numel()} B moved)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
