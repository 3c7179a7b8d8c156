"""Run one cell of BENCHMARK.json once on this machine's card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the card, its power limit and the torch and CUDA versions first,
then sets up the cell (set-up: imports, the kernels' build, the
configuration's build, graph sets and warm-up), measures its traffic for
``--seconds``, reads the peak device memory, with ``--trace 1`` traces
one more stretch of the same traffic under torch.profiler, and then
checks the window's answers against the plain reference
(``harness/check.py``). The numbers compared go to standard error with
their limits as its last lines. The last line of standard output is the
result: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``). Without a card, or with fewer than the cell
asks for, it prints no result and exits 3; if JAX or the JAX package
was loaded, 4. Every cache the program builds lies under ``build/`` in
the checkout."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "reina_tpu")


def cache_dirs(root: Path = ROOT) -> None:
    """Triton's and the CUDA driver's caches at fixed paths inside the
    checkout (the program's nvcc builds go to build/reina_tpu_torch)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton-cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda-cache")


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line(torch) -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "nvidia-smi: none"
    return (f"card: {smi}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, python {sys.version.split()[0]}")


def counters() -> dict:
    """The program's counters: step.STATS and the kernels' launches."""
    from reina_tpu_torch import kernels
    from reina_tpu_torch.core import step
    c = {f"stats.{k}": v for k, v in step.STATS.items()}
    c.update({f"launch.{k}": v for k, v in kernels.launches().items()})
    return c


def driver(cell, seed: int, device):
    """The driver of the cell's traffic mix: ``Driver`` of
    ``traffic/<kind>.py``, found by the mix's ``kind``."""
    from .harness.cell import traffic_driver
    return traffic_driver(cell.traffic["kind"])(cell.config, cell.traffic,
                                                seed, device)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = None) -> dict:
    """One run of ``cell``: the result's fields and the numbers compared
    (``checks``: {name: [value, limit]})."""
    import numpy as np
    import torch
    from .harness import check
    from .harness import trace as tr
    from .harness.cell import layer_reader, rooflines

    t_start = T_START if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    d = driver(cell, seed, device)
    parts = {"import_s": time.perf_counter() - t_start}
    from reina_tpu_torch.kernels import build as kbuild
    if on_card:
        t0 = time.perf_counter()
        kbuild.lib()
        parts["kernel_build_s"] = time.perf_counter() - t0
    d.setup()
    if on_card:
        torch.cuda.synchronize()
    parts.update(d.setup_parts)
    setup_s = time.perf_counter() - t_start
    parts["setup_s"] = setup_s
    print("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
          file=sys.stderr, flush=True)
    w = d.window(seconds, counters)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    e2e = d.e2e(w)
    print(f"window: {w.seconds:.3f} s, e2e {e2e}, counters "
          f"{ {k: v for k, v in w.counters.items() if v} }",
          file=sys.stderr, flush=True)
    print(f"window: {d.notes(w)}", file=sys.stderr, flush=True)
    traced = None
    if trace:
        wall, wall_prof, prof, days = d.traced(tr.profile)
        traced = tr.reduce(prof, days, wall, wall_prof)
        del prof
        print(f"trace: {days} days, wall {wall:.3f} s ({wall_prof:.3f} s "
              f"profiled), busy {traced.busy_s:.3f} s, {traced.events} "
              "device events", file=sys.stderr)
        for name, s in traced.device_ops(30):
            print(f"  {s * 1e3 / days:.4f} ms/day  {name[:100]}",
                  file=sys.stderr)
        for name, s in traced.gaps[:10]:
            print(f"  idle {s:.4f} s  {name[:100]}", file=sys.stderr)
    rng = np.random.default_rng([int(seed), 0x434845])
    items = d.items(w, rng)
    n_items = len(items)
    d.close()
    t0 = time.perf_counter()
    nums = check.compare(items, rng, int(cell.traffic["check_days"]),
                         device,
                         log=lambda s: print(s, file=sys.stderr, flush=True))
    del items
    check_s = time.perf_counter() - t0
    limits = cell.limits
    checks = {k: [v, limits[k]] for k, v in nums.items()}
    # a run with no answer to check is not correct
    correct = n_items > 0 and all(v <= lim for v, lim in checks.values())
    attempted, failed = _attempted(w)
    metrics = {}
    names = {m["name"]: m for m in
             (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        ctx = dict(window=w, trace=traced, driver=d, cell=cell,
                   setup=parts, rooflines=rooflines())
        for name, m in names.items():
            v = layer_reader(name)(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": m["unit"]}
    else:
        vals = dict(e2e, setup_s=setup_s)
        for name, m in names.items():
            if name in vals:
                metrics[name] = {"value": vals[name], "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name()
                               if on_card else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if traced is not None:
        out["device"]["busy_s"] = traced.busy_s
        out["device"]["window_s"] = traced.window_s
        out["breakdown"] = {"device_ops": traced.device_ops(10),
                            "idle_gaps": [[k, v] for k, v in
                                          traced.gaps[:10]]}
    out["checks"] = checks
    print(f"check: {check_s:.1f} s", file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"{k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    return out


def _attempted(w):
    if hasattr(w, "requests"):
        return len(w.requests), sum(r.error is not None for r in w.requests)
    return len(w.seeds), 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .harness.cell import cell as find_cell
    cell = find_cell(args.workload)
    cache_dirs()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(card_line(torch), flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
