"""Where the prefix kernel's time goes: timing-only variants of
``kernels/csrc/prefix.cu`` with phases taken out, at the HUS agent
count.

    python -m reina_tpu_torch.kernels.prefix_parts

Each variant is built from this checkout's ``prefix.cu`` (nvcc, sm_90a)
into ``build/reina_tpu_torch/parts/``, launched on the inputs of
``kernels/checks.py`` (the day step's n_seg 1 and n_seg 2 calls) and
timed with ``checks.time_ms`` (cold L2, median of 7). The variants other
than ``full`` compute wrong results on purpose:

  full             the kernel as it is
  no_phase2        without the row-offset scan of the logical blocks
  no_phase2_sync   also without the two grid barriers
  phase1_only      row totals only
  phase3_only      rows loaded, then the emit only

The differences between lines are the phases' costs on the critical
path. Beside them: a one-element fill (the floor of this timing for any
launch), a copy of the 6.7 MB ``newly`` weights and ``torch.cumsum`` of
them. Needs a CUDA device.
"""
from __future__ import annotations

import torch

from . import build, checks

# the source text each cut replaces, and what it becomes
_PHASE2 = ("for (int b = blockIdx.x; b < nb; b += gridDim.x)",
           "for (int b = blockIdx.x; b < 0; b += gridDim.x)")
_SYNC = ("  grid.sync();\n", "")
_PHASE1 = ("    for (int k = 0; k < ROWS; ++k) {\n"
           "      const long long row = row_of(g, k);\n"
           "      if (row >= R) break;\n      for (int s = 0;",
           "    for (int k = 0; k < 0; ++k) {\n"
           "      const long long row = row_of(g, k);\n"
           "      if (row >= R) break;\n      for (int s = 0;")
_PHASE3 = ("for (long long m = 0; m <= mine; ++m) {",
           "for (long long m = 0; m <= -1; ++m) {")
VARIANTS = {
    "full": (),
    "no_phase2": (_PHASE2,),
    "no_phase2_sync": (_PHASE2, _SYNC),
    "phase1_only": (_PHASE2, _SYNC, _PHASE3),
    "phase3_only": (_PHASE2, _SYNC, _PHASE1),
}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    n = checks.HUS_N
    s = checks._streams(n, 0, "cuda")
    codes = s["var"].to(torch.int32)
    R, blk = n // 128, 1464          # _largest_block(R, 2048, 8) at HUS
    stream = torch.cuda.current_stream().cuda_stream
    for name, cuts in VARIANTS.items():
        fn = build.build_variant("prefix.cu", "reina_concat_prefix",
                                 f"prefix_{name}", cuts)
        ms = []
        for n_seg, w, c in ((1, s["newly"], None), (2, s["w"], codes)):
            out = torch.empty(n_seg * n, device="cuda")
            scratch = torch.zeros(n_seg * (R + R // blk), device="cuda")

            def call():
                build.check(fn(w.data_ptr(), None if c is None else
                               c.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), n, n_seg, blk, None,
                               None, None, stream), name)

            ms.append(checks.time_ms(call))
        print(f"{name:16s} n_seg 1 {ms[0]:.4f} ms  n_seg 2 {ms[1]:.4f} ms",
              flush=True)
    x = s["newly"]
    dst = torch.empty_like(x)
    print(f"fill1 {checks.time_ms(lambda: dst[:1].fill_(0)):.4f} ms  "
          f"copy {checks.time_ms(lambda: dst.copy_(x)):.4f} ms  "
          f"cumsum {checks.time_ms(lambda: torch.cumsum(x, 0)):.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
