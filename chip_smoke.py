#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device. It

  1. prints the device and its power limit, and builds the CUDA kernels
     from reina_tpu_torch/kernels/csrc (nvcc, sm_90a);
  2. holds every hand-written kernel of the main path against its plain
     PyTorch twin on the card, at the HUS run's agent count, and times
     both with CUDA events;
  3. drives the main path: build_run for the default HUS scenario (365
     days, 1,685,983 agents) on "cuda", then run_days, counting every
     kernel's launches in that run;
  4. checks the outcome: finite outputs of the expected shape, agents
     conserved every day, every kernel launched, and the final
     all_infected inside the JAX package's 1000-seed spread
     (373,466 ± 4 × 22,396, BENCH_MC.json).

It prints one JSON line of kernel results before the last line, and as
the last line {"ok": true, "device": {...}}. Any failed phase exits
non-zero. Without a CUDA device, or outside the repository, it exits
non-zero and prints no result. Nothing runs on the CPU in its place.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HUS_AGENTS = 1685983
MC_MEAN, MC_STD = 373466.083, 22395.919729319245
DAYS = 365


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    # the JAX package's import hook would load jax if it were installed
    os.environ.setdefault("REINA_NO_JAX_CACHE", "1")
    from reina_tpu_torch import kernels
    from reina_tpu_torch.kernels import build, checks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"device: {kind}; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi[0] if smi else 'unavailable'}")

    t0 = time.perf_counter()
    build.lib()
    print(f"cuda kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds} s)")

    # ---- kernels against their twins at HUS shapes
    results = {}
    for c in checks.checks(checks.HUS_N, 0, "cuda"):
        r = checks.run_check(c)
        results[c.name] = (c, r)
        print(f"kernel {r.name:22s} ok={r.ok} mismatches={r.mismatches} "
              f"max_abs_err={r.max_abs_err:.3g} max_ulp={r.max_ulp} "
              f"kernel {r.ms:.4f} ms  twin {r.plain_ms:.4f} ms")
    bad = [n for n, (_, r) in results.items() if not r.ok]
    if bad:
        fail(f"kernels disagree with their twins: {bad}")

    # ---- the main path
    from reina_tpu.config.variables import VARIABLE_DEFAULTS
    from reina_tpu_torch.core.engine import run_days, build_run
    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = DAYS
    t0 = time.perf_counter()
    run = build_run(v, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_pad = run.init_state.age.shape[0]
    print(f"build_run: {build_s:.2f} s, agents={run.n_agents}, "
          f"padded={n_pad}")
    if run.n_agents != HUS_AGENTS:
        fail(f"expected {HUS_AGENTS} agents, got {run.n_agents}")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, state, carry, chunk_times = run_days(run, chunk_days=52)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    steps = DAYS - 1
    final = int(out.by_group[-1, 3].sum())
    print(f"run_days: {wall:.3f} s for {steps} days "
          f"({wall / steps * 1000:.2f} ms/day, "
          f"{run.n_agents * steps / wall:.1f} agent-days/s), "
          f"peak device memory {peak / 2**30:.2f} GiB")
    print(f"final all_infected={final}; launches={launches}")

    # ---- outcome checks
    G = len(run.group_labels)
    if out.by_group.shape != (DAYS, 13, G):
        fail(f"by_group shape {out.by_group.shape}")
    for name in out._fields:
        a = getattr(out, name)
        if len(a) != DAYS:
            fail(f"{name}: {len(a)} rows")
        if a.dtype.kind == "f" and not (a == a).all():
            fail(f"{name}: non-finite values")
    cons = out.by_group[:, 0].sum(1) + out.by_group[:, 3].sum(1)
    if not (cons == run.n_agents).all():
        fail("agents not conserved (susceptible + all_infected)")
    want = {"fused_map.prologue": steps, "fused_map.recv_front": steps,
            "fused_map.post": steps, "fused_map.finalize": steps,
            "ledger_scan": steps, "fused_concat_prefix": 2 * steps,
            "fused_onehot_sum": 1}
    for k, lo in want.items():
        if launches.get(k, 0) < lo:
            fail(f"{k} launched {launches.get(k, 0)} times, want ≥ {lo}")
    lo, hi = MC_MEAN - 4 * MC_STD, MC_MEAN + 4 * MC_STD
    if not lo <= final <= hi:
        fail(f"final all_infected {final} outside [{lo:.0f}, {hi:.0f}]")

    print(json.dumps({"kernels": [
        {"name": c.name, "route": c.route, "source": c.source,
         "replaces": c.replaces, "launches": launches[c.name],
         "max_abs_err": r.max_abs_err, "ms": r.ms, "plain_ms": r.plain_ms}
        for c, r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
