#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device. It

  1. prints the device and its power limit, and builds the CUDA kernels
     from reina_tpu_torch/kernels/csrc (nvcc, sm_90a, one process per
     source);
  2. holds every hand-written kernel of the main path against its plain
     PyTorch twin on the card, at the HUS run's agent count, and times
     the kernel, the twin and, where there is one, the PyTorch library
     call that computes the same function (CUDA events, cold L2, median
     of 7), beside the least time the card could take (bound), and
     times each launch of the CUDA kernels;
  3. drives the main path: build_run for the default HUS scenario (365
     days, 1,685,983 agents) on "cuda", then run_days, counting every
     kernel's launches in that run;
  4. checks the outcome: finite outputs of the expected shape, agents
     conserved every day, every kernel launched, and the final
     all_infected inside the JAX package's 1000-seed spread
     (373,466 ± 4 × 22,396, BENCH_MC.json);
  5. resumes at HUS scale: run_days to day 182 with a checkpoint, then
     a second run_days to day 364 that resumes from it; its outputs and
     final agent state must equal step 3's bit for bit;
  6. runs the CLI through the simulation driver in this process, twice
     (30 days, seeds 1 and 2): the second call must be served by the
     build cache and reseed_run.

Each of steps 3, 5 and 6 sets the kernels' launch counts to 0 just
before it and reads them just after. It prints one JSON line of kernel
results before the last line, and as the last line {"ok": true,
"device": {...}}. Any failed phase exits non-zero. Without a CUDA
device, or outside the repository, it exits non-zero and prints no
result. Nothing runs on the CPU in its place.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HUS_AGENTS = 1685983
MC_MEAN, MC_STD = 373466.083, 22395.919729319245
DAYS = 365
RESUME_AT = 182
CLI_DAYS = 30


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check_launched(launches: dict, want: dict, phase: str) -> None:
    for k, lo in want.items():
        if launches.get(k, 0) < lo:
            fail(f"{phase}: {k} launched {launches.get(k, 0)} times, "
                 f"want ≥ {lo}")


def resume_phase(run, out, state, scratch: str) -> None:
    """Checkpoint at day RESUME_AT, resume to the end, compare with the
    uninterrupted run."""
    import numpy as np
    import torch
    from reina_tpu_torch import kernels
    from reina_tpu_torch.core import checkpoint as ckpt
    from reina_tpu_torch.core.engine import run_days

    d = os.path.join(scratch, "resume")
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, st1, cr1, _ = run_days(run, n_days=RESUME_AT + 1, checkpoint_dir=d,
                              checkpoint_every=RESUME_AT)
    torch.cuda.synchronize()
    leg1 = time.perf_counter() - t0
    path = ckpt.checkpoint_path(d, RESUME_AT)
    if not os.path.exists(path):
        fail(f"resume: no checkpoint at day {RESUME_AT}")
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    ckpt.save_checkpoint(os.path.join(scratch, "again.npz"), st1, cr1)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.load_checkpoint(path)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out2, state2, _, _ = run_days(run, n_days=DAYS, checkpoint_dir=d)
    torch.cuda.synchronize()
    leg2 = time.perf_counter() - t0
    launches = kernels.launches()
    print(f"resume: leg 1 (days 0-{RESUME_AT}) {leg1:.3f} s, leg 2 "
          f"(days {RESUME_AT}-{DAYS - 1}, resumed) {leg2:.3f} s; "
          f"checkpoint {size} bytes, save {save_s:.3f} s, load "
          f"(with bucket rebuild) {load_s:.3f} s; launches={launches}")
    steps = DAYS - 1
    check_launched(launches, {k: steps for k in (
        "fused_map.prologue", "fused_map.recv_front", "fused_map.post",
        "fused_map.finalize", "ledger_scan", "fused_fn_onehot_sum",
        "fused_bihistogram")} | {"fused_concat_prefix": 2 * steps,
                                 "fused_onehot_sum": 2}, "resume")
    for name, a, b in zip(out._fields, out, out2):
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"resume: outputs.{name} differ from the uninterrupted run")
    for name, a, b in zip(state._fields, state, state2):
        if not torch.equal(a, b):
            fail(f"resume: state.{name} differs from the uninterrupted run")
    print("resume: outputs and final state equal the uninterrupted run "
          "bit for bit")


def cli_phase() -> None:
    """Two CLI runs in this process; the second hits the build cache."""
    import numpy as np
    from reina_tpu_torch import cli, kernels
    from reina_tpu_torch.simulation import BUILD_CACHE, simulate_individuals

    results = []
    for seed, want in ((1, "built"), (2, "reseeded")):
        hits, reseeds = BUILD_CACHE.hits, BUILD_CACHE.reseeds
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["simulate", "--days", str(CLI_DAYS), "--seed",
                       str(seed), "--quiet"])
        wall = time.perf_counter() - t0
        launches = kernels.launches()
        outcome, build_s = BUILD_CACHE.last
        print(f"cli seed {seed}: exit {rc}, {wall:.3f} s, build "
              f"{build_s:.3f} s ({outcome}); launches={launches}")
        if rc != 0:
            fail(f"cli seed {seed}: exit code {rc}")
        if outcome != want:
            fail(f"cli seed {seed}: build {outcome}, want {want}")
        if want == "reseeded" and (BUILD_CACHE.hits != hits + 1
                                   or BUILD_CACHE.reseeds != reseeds + 1):
            fail("cli: the second call did not hit the cache and reseed")
        steps = CLI_DAYS - 1
        check_launched(launches, {k: steps for k in (
            "fused_map.prologue", "fused_map.recv_front", "fused_map.post",
            "fused_map.finalize", "ledger_scan", "fused_fn_onehot_sum",
            "fused_bihistogram")} | {"fused_concat_prefix": 2 * steps,
                                     "fused_onehot_sum": 1}, "cli")
        # the memoized result of the run the CLI just made
        cols, cube = simulate_individuals(only_if_in_cache=True,
                                          device="cuda")
        if len(cols["date"]) != CLI_DAYS or cube.values.shape[0] != CLI_DAYS:
            fail(f"cli seed {seed}: {len(cols['date'])} rows")
        if not (cols["susceptible"] + cols["all_infected"]
                == HUS_AGENTS).all():
            fail(f"cli seed {seed}: agents not conserved")
        results.append(cols)
    if all(np.array_equal(results[0][k], results[1][k])
           for k in ("all_infected", "exposed_per_day")):
        fail("cli: seeds 1 and 2 gave the same run")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
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
        lib = "none" if r.library_ms is None else f"{r.library_ms:.4f} ms"
        print(f"kernel {r.name:22s} ok={r.ok} mismatches={r.mismatches} "
              f"max_abs_err={r.max_abs_err:.3g} max_ulp={r.max_ulp} "
              f"kernel {r.ms:.4f} ms  twin {r.plain_ms:.4f} ms  "
              f"library {lib}  bound {r.bound_ms:.4f} ms ({r.bound_by})"
              f"{'' if c.library_note == '' else '  [' + c.library_note + ']'}")
    bad = [n for n, (_, r) in results.items() if not r.ok]
    if bad:
        fail(f"kernels disagree with their twins: {bad}")
    print("per-launch ms (cold L2, median of 7): "
          + json.dumps(checks.launch_times(checks.HUS_N, 0, "cuda")))

    # ---- the main path
    from reina_tpu_torch.config.variables import VARIABLE_DEFAULTS
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
    check_launched(launches, {k: steps for k in (
        "fused_map.prologue", "fused_map.recv_front", "fused_map.post",
        "fused_map.finalize", "ledger_scan", "fused_fn_onehot_sum",
        "fused_bihistogram")} | {"fused_concat_prefix": 2 * steps,
                                 "fused_onehot_sum": 1}, "main path")
    lo, hi = MC_MEAN - 4 * MC_STD, MC_MEAN + 4 * MC_STD
    if not lo <= final <= hi:
        fail(f"final all_infected {final} outside [{lo:.0f}, {hi:.0f}]")

    with tempfile.TemporaryDirectory(dir=here) as scratch:
        resume_phase(run, out, state, scratch)
    del run, out, state, carry
    cli_phase()

    print(json.dumps({"kernels": [
        {"name": c.name, "route": c.route, "source": c.source,
         "replaces": c.replaces, "launches": launches[c.name],
         "max_abs_err": r.max_abs_err, "ms": r.ms, "plain_ms": r.plain_ms,
         "bound_ms": r.bound_ms, "bound_by": r.bound_by,
         "library_ms": r.library_ms}
        for c, r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
