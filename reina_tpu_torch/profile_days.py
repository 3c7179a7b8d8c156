"""Where a day's time goes on the card: torch.profiler over a window of
days of the HUS run, with the plain day step and as CUDA graphs, from
the same state in one call; or that of two source trees in turns.

    python -m reina_tpu_torch.profile_days [--start 100] [--days 10]
        [--other DIR] [--rounds 1]

Builds the default HUS scenario on "cuda", steps it to day ``start``,
then runs the next ``days`` days in each mode from that state
(``--start 0 --days 364``: the whole run): in the graphed mode first the
start that builds the window's day graphs (its captures and seconds:
warm-ups, captures and assembly), then in each mode one window without
and one under the profiler. For each mode it prints wall ms/day (host clock
ending in a synchronize), device-busy ms/day (the sum of the device
events' durations under the profiler), the device's idle share (1 -
busy / the wall without the profiler, since the profiler's own host
overhead stretches the wall it sees), device events (kernels, copies,
sets) a day, day-graph launches and host reads a day, the host CPU
seconds of the profiled window, and the ten device events that took
the most time.

``--other DIR``: DIR is another checkout of this repository (for
example an earlier commit unpacked with ``git archive``); each tree runs
this module with the same ``--start`` and ``--days`` in an interpreter
of its own, in turns as ``kernels/ab.py`` runs them (other, this, this,
other; ``--rounds`` times), and each mode's window line of every run is
printed again side by side. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
# a mode's window line (the same in earlier trees)
_WINDOW = re.compile(
    r"^(eager|graphed) days \d+-\d+: wall ([\d.]+) ms/day .*device busy "
    r"([\d.]+) ms/day, idle share ([-\d.]+), device events/day ([\d.]+)")


def _in_turns(args) -> int:
    from .kernels.ab import in_turns

    def run_tree(tree: Path, label: str) -> dict:
        r = subprocess.run(
            [sys.executable, "-m", "reina_tpu_torch.profile_days",
             "--start", str(args.start), "--days", str(args.days)],
            cwd=tree, capture_output=True, text=True, timeout=1500)
        print(f"--- {label} ({tree}), rc {r.returncode}", flush=True)
        print(r.stdout, flush=True)
        if r.returncode != 0:
            raise SystemExit(f"{label} failed:\n{r.stderr[-4000:]}")
        return {m[1]: m.groups()[1:] for m in map(_WINDOW.match,
                                                   r.stdout.splitlines())
                if m}

    runs = in_turns(args.other, args.rounds, run_tree, HERE)
    print(f"days {args.start}-{args.start + args.days - 1}, each run of "
          "each tree in turn: wall ms/day, busy ms/day, idle share, "
          "device events/day")
    for mode in ("eager", "graphed"):
        for label, rs in runs.items():
            print(f"{mode} {label}: " + "; ".join(
                ", ".join(r[mode]) for r in rs if mode in r))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--start", type=int, default=100)
    ap.add_argument("--days", type=int, default=10)
    ap.add_argument("--other", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if args.other is not None:
        return _in_turns(args)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from .config.variables import VARIABLE_DEFAULTS
    from .core import graphs, step
    from .core.engine import build_run, run_chunk, run_days
    from .core.schedule import Schedules
    from .ops import prng

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = 365
    run = build_run(v, "cuda")
    _, state, carry, _ = run_days(run, n_days=args.start + 1)
    host = Schedules(*(x.cpu().numpy() for x in run.schedules))
    key = prng.PRNGKey(run.random_seed)
    d = args.days
    # a set of its own in place of the run's, so that the window's
    # builds are measured
    graphs.drop_idle()
    build = (run.cfg, run.arrays, run.schedules)
    gs = graphs.GraphSet(*build, state, carry, run.device)

    def window(graphed: bool):
        """The window's wall seconds and graph counters."""
        if graphed:
            plans = gs.prepare(host, key, args.start, d,
                               carry.weekly_leftover, state.age.shape[0])
            gs.start(*build, state, carry, args.start, plans)
        else:
            # the day step updates the bucket table in place: each
            # window starts from its own copy
            c = carry._replace(bkt_dst=carry.bkt_dst.clone())
        torch.cuda.synchronize()
        step.reset_stats()
        t0 = time.perf_counter()
        if graphed:
            gs.step(plans)
        else:
            run_chunk(run.cfg, run.arrays, run.schedules, host, state, c,
                      key, d, args.start)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, dict(step.STATS)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for graphed in (False, True):
        mode = "graphed" if graphed else "eager"
        if graphed:
            step.reset_stats()
            t0 = time.perf_counter()
            gs.start(*build, state, carry, args.start, gs.prepare(
                host, key, args.start, d, carry.weekly_leftover,
                state.age.shape[0]))
            torch.cuda.synchronize()
            st = dict(step.STATS)
            print(f"{mode}: start {time.perf_counter() - t0:.3f} s with "
                  f"{st.get('captures', 0)} captures in "
                  f"{st.get('graphs.capture_s', 0.0):.3f} s and "
                  f"{len(gs.days)} day graphs assembled in "
                  f"{st.get('graphs.assemble_s', 0.0):.3f} s")
        wall, st = window(graphed)
        with torch.profiler.profile(activities=acts) as prof:
            c0 = time.process_time()
            wall_prof, _ = window(graphed)
            cpu = time.process_time() - c0
        busy_us, count = 0.0, 0
        by_name = defaultdict(lambda: [0.0, 0])
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            busy_us += us
            count += 1
            by_name[e.name][0] += us
            by_name[e.name][1] += 1
        print(f"{mode} days {args.start}-{args.start + d - 1}: wall "
              f"{wall / d * 1e3:.2f} ms/day ({wall_prof / d * 1e3:.2f} under "
              f"the profiler), device busy {busy_us / d / 1e3:.2f} ms/day, "
              f"idle share {1 - busy_us / 1e6 / wall:.3f}, device events/day "
              f"{count / d:.1f}, day-graph launches/day "
              f"{st.get('launches', 0) / d:.1f}, host reads/day "
              f"{st.get('reads', 0) / d:.1f}, "
              f"host CPU {cpu:.3f} s")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        for name, (us, n) in top:
            print(f"  {us / d / 1e3:8.3f} ms/day  {n / d:7.1f}/day  "
                  f"{100 * us / busy_us:5.1f}%  {name[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
