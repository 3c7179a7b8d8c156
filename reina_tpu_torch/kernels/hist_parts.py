"""Design variants of the two histogram kernels, timed on one card at
the HUS agent count.

    python -m reina_tpu_torch.kernels.hist_parts

Each variant is built from this checkout's ``bihist.cu`` or
``fn_onehot.cu`` (nvcc, sm_90a) into ``build/reina_tpu_torch/parts/``,
launched on the inputs of ``kernels/checks.py`` at the day step's call
and timed with ``checks.time_ms`` (cold L2, median of 7):

  bihist l2            the kernel as it is: counts added straight into
                       the scratch in L2 with global atomics
  fn_onehot full       the kernel as it is
  fn_onehot no_fold    without the fold of the CTAs' bins into the
                       scratch
  <kernel> no_finish   without the last-CTA ticket and finish

The cut variants compute wrong results on purpose: the difference to
the full kernel is the cost of the part cut, on the critical path.

Each line also says whether the variant's output equals the twin.
Beside them: a one-element fill, the floor of this timing for any
launch, and a copy that moves as many bytes as fn_onehot reads. Needs a
CUDA device.
"""
from __future__ import annotations

import torch

from . import build, checks

_FOLD = ("    if (h[j]) atomicAdd(&acc[j], h[j]);\n", "    ;\n")
_FINISH = ("  finish_last_cta(acc, ", "  if (0) finish_last_cta(acc, ")
VARIANTS = {
    ("bihist", "l2"): (),
    ("bihist", "no_finish"): (_FINISH,),
    ("fn_onehot", "full"): (),
    ("fn_onehot", "no_fold"): (_FOLD,),
    ("fn_onehot", "no_finish"): (_FINISH,),
}
# kernel -> (source, C entry point)
_KERNELS = {"bihist": ("bihist.cu", "reina_bihistogram"),
            "fn_onehot": ("fn_onehot.cu", "reina_fn_onehot_output_masks")}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from ..core import constants as C
    from ..core import step
    from ..ops import fusedmap
    s = checks._streams(checks.HUS_N, 0, "cuda")
    n, G, VTS, A = checks.HUS_N, checks.G + 1, checks.VTS, checks.A
    stream = torch.cuda.current_stream().cuda_stream
    fields, grp = s["fields"], s["grp"]
    gate, vts, ks, ages = s["gate"], s["vts"], s["k_s"], s["ages"]
    want = {"bihist": fusedmap.bihistogram_twin(vts, VTS, ks, ages, A, gate),
            "fn_onehot": fusedmap.fn_onehot_sum_twin(
                fields, step._output_masks_reduced, 10, grp, G)}
    for (kernel, name), cuts in VARIANTS.items():
        fn = build.build_variant(*_KERNELS[kernel], f"{kernel}_{name}", cuts)
        if kernel == "bihist":
            out = torch.empty((VTS, A), device="cuda")
            acc = torch.zeros(VTS * A + 1, dtype=torch.int32, device="cuda")

            def call():
                build.check(fn(gate.data_ptr(), vts.data_ptr(),
                               ks.data_ptr(), 0, ages.data_ptr(),
                               acc.data_ptr(), out.data_ptr(), n, VTS, A,
                               None, stream), name)
        else:
            out = torch.empty((10, G), device="cuda")
            acc = torch.zeros(10 * G + 1, dtype=torch.int32, device="cuda")

            def call():
                build.check(fn(*(f.data_ptr() for f in fields),
                               grp.data_ptr(), acc.data_ptr(),
                               out.data_ptr(), n, G, C.HOSPITALIZED,
                               C.IN_ICU, C.RECOVERED, C.DEAD, None, stream),
                            name)
        call()
        torch.cuda.synchronize()
        equal = torch.equal(out, want[kernel])
        print(f"{kernel:9s} {name:8s} {checks.time_ms(call):.4f} ms  "
              f"equal to twin: {equal}", flush=True)
    dst = torch.empty(1, device="cuda")
    half = torch.ones(7 * n // 4, dtype=torch.int32, device="cuda")
    dst2 = torch.empty_like(half)
    print(f"fill1 {checks.time_ms(lambda: dst.fill_(0)):.4f} ms  copy of "
          f"{7 * n} B (moves fn_onehot's {14 * n} B) "
          f"{checks.time_ms(lambda: dst2.copy_(half)):.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
