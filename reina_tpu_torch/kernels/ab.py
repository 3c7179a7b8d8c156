"""The prefix pair, the ledger, the phase-7 counts and the 2-D histogram
of two source trees, timed on one card in turns.

    python -m reina_tpu_torch.kernels.ab --other DIR [--rounds 1]

DIR is another checkout of this repository (for example an earlier
commit unpacked with ``git archive``). Each tree runs in an interpreter
of its own, since both packages are named ``reina_tpu_torch``, in the
order other, this, this, other (``--rounds`` times), on the
inputs of ``kernels/checks.py`` at the HUS agent count. Each run prints
one line ``AB <tree> {json}`` with:

  * ``prefix_ms``: ``fused_concat_prefix`` of ``newly`` (n_seg 1) and of
    the weights (n_seg 2), the pair the day step makes; ``cumsum_ms``:
    ``torch.cumsum`` of the same two, in the same process;
  * ``ledger_ms``: ``clamped_counter_grants`` for both ledgers;
  * ``fn_onehot_ms``: ``fused_fn_onehot_sum`` of the phase-7 fields;
  * ``bihist_site_ms``: the day step's histogram call as the tree makes
    it: ``fused_bihistogram(vts, VTS, k_s, ages, A, gate=exposer)``
    where the wrapper takes a gate, else ``torch.where(exposer, vts,
    -1)``, ``k_s.to(float32)`` and the kernel (same inputs either way);
  * ``device_us``: device time per call by kernel name, and
    ``kernels_per_call``: device kernels per call, both from
    torch.profiler over 20 back-to-back calls of each (warm L2).

The ``_ms`` times are ``checks.time_ms``: cold L2, median of 7. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]

_CHILD = r'''
import inspect, json, sys
from collections import defaultdict
import torch
sys.path.insert(0, ".")
from reina_tpu_torch.core import step
from reina_tpu_torch.kernels import checks
from reina_tpu_torch.ops import clamped, fusedmap
s = checks._streams(checks.HUS_N, 0, "cuda")
if "gate" in s:
    gate, vts, k_s = s["gate"], s["vts"], s["k_s"]
else:                   # a tree whose streams hold where(exposer, vts, -1)
    gate, vts = s["code_a"] >= 0, s["code_a"]
    k_s = s["k_s"].to(torch.int32)
VTS, A = checks.VTS, checks.A
if "gate" in inspect.signature(fusedmap.fused_bihistogram).parameters:
    def bihist_site():
        return fusedmap.fused_bihistogram(vts, VTS, k_s, s["ages"], A,
                                          gate=gate)
else:
    def bihist_site():
        return fusedmap.fused_bihistogram(torch.where(gate, vts, -1), VTS,
                                          k_s.to(torch.float32), s["ages"], A)
codes = s["var"].to(torch.int32)
init = torch.tensor([300, 60], dtype=torch.int32, device="cuda")
cat = torch.cat([torch.where(codes == v, s["w"], 0.0)
                 for v in range(checks.V)])
fns = {
    "prefix": lambda: (fusedmap.fused_concat_prefix(s["newly"], None, 1),
                       fusedmap.fused_concat_prefix(s["w"], codes, checks.V)),
    "cumsum": lambda: (torch.cumsum(s["newly"], 0), torch.cumsum(cat, 0)),
    "ledger": lambda: clamped.clamped_counter_grants(s["rel"], s["req"],
                                                     init, s["offset"]),
    "fn_onehot": lambda: fusedmap.fused_fn_onehot_sum(
        s["fields"], step._output_masks_reduced, 10, s["grp"], checks.G + 1),
    "bihist_site": bihist_site,
}
out = {k + "_ms": checks.time_ms(f) for k, f in fns.items()}
out["device_us"], out["kernels_per_call"] = {}, {}
for k, f in fns.items():
    f()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            f()
        torch.cuda.synchronize()
    by = defaultdict(float)
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.name[:80]] += e.time_range.elapsed_us() / 20
            count += 1
    out["device_us"][k] = dict(by)
    out["kernels_per_call"][k] = count / 20
print("AB " + sys.argv[1] + " " + json.dumps(out), flush=True)
'''


def run_tree(tree: Path, label: str) -> dict:
    r = subprocess.run([sys.executable, "-c", _CHILD, label], cwd=tree,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise SystemExit(f"{label} ({tree}) failed:\n{r.stderr[-4000:]}")
    line = [x for x in r.stdout.splitlines() if x.startswith("AB ")][-1]
    print(line, flush=True)
    return json.loads(line.split(" ", 2)[2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for label in ("other", "this", "this", "other"):
            tree = args.other.resolve() if label == "other" else HERE
            runs[label].append(run_tree(tree, label))
    for label, rs in runs.items():
        keys = sorted(k for k in rs[0] if k.endswith("_ms"))
        print(f"{label}: " + ", ".join(
            f"{k} " + " / ".join(f"{r[k]:.4f}" for r in rs) for k in keys))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
