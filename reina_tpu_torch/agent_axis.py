"""The graphed agent axis over NCCL on several cards of one host, timed,
for one checkout of this repository or another.

    python reina_tpu_torch/agent_axis.py [--tree DIR] [--ranks 2 4]
        [--plain]

Times the checkout at DIR (this file's own by default; for example an
earlier commit unpacked with ``git archive``, whose package may not have
this file: the file imports only what the agent axis has had since it
was graphed). It builds the default HUS scenario at its full size, 365
days, and prints, each beside the card's name and power limit:

  * one card (cuda:0): the graphed run again on the graph set that its
    first run built, ms/day;
  * for each count of ranks k: k processes, a card each, over NCCL
    (``tcp://127.0.0.1``), each running the days on ``make_mesh(1, k)``
    graphed (building its set), then again on that set (ms/day: the
    wall of the slowest rank), with ``--plain`` also with the plain day
    step; then rank 0's window of the graphed days 100-109 under
    torch.profiler (:func:`profile_window`): wall ms/day without the
    profiler, device-busy ms/day, the idle share and the NCCL kernels'
    ms/day.

The last line is one JSON object of every figure. Two checkouts are
held against each other by running this file for each in turns within
one call of the machine. Needs a CUDA device per rank.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

DAYS = 365
# the profiled window of the graphed agent axis: these days
PROFILE_START, PROFILE_DAYS = 100, 10
# a world's ranks are killed after this many seconds
RANK_S = 240


def _hus(dev: str):
    from reina_tpu_torch.config.variables import VARIABLE_DEFAULTS
    from reina_tpu_torch.core.engine import build_run
    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = DAYS
    return build_run(v, dev)


def _timed(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_window(run, agents, profiled: bool) -> dict:
    """Days PROFILE_START.. of the graphed agent axis on this rank's
    slab, on a graph set of its own (made idle at the end), from its
    state at PROFILE_START: a window timed on the host, then one under
    torch.profiler where ``profiled`` (the other ranks step the same
    days unprofiled). Returns the wall ms/day, and where profiled the
    device-busy ms/day (the sum of the device events' durations), the
    idle share (1 - busy / wall) and the ms/day and events/day of the
    NCCL, sharded ledger and sharded prefix kernels."""
    import torch
    from reina_tpu_torch.core import graphs as G
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.core.schedule import Schedules
    from reina_tpu_torch.ops import prng
    from reina_tpu_torch.parallel import mesh as M

    start, d = PROFILE_START, PROFILE_DAYS
    _, state, carry, _ = run_days(run, n_days=start + 1, mesh=agents)
    shard = M.AgentShard(agents, run.init_state.age.shape[0])
    arrays, schedules, _, _ = M.shard_run(run, agents)
    build = (run.cfg, arrays, schedules)
    host = Schedules(*(x.cpu().numpy() for x in schedules))
    key = prng.PRNGKey(run.random_seed)
    gs = G.acquire(*build, state, carry, agents.device, shard)

    def window() -> float:
        plans = gs.prepare(host, key, start, d, carry.weekly_leftover,
                           shard.n)
        gs.start(*build, state, carry, start, plans)
        return _timed(lambda: gs.step(plans))

    wall = window()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {"wall_ms": wall / d * 1e3}
    if not profiled:
        window()
        G.release(gs)
        return out
    with torch.profiler.profile(activities=acts) as prof:
        window()
    G.release(gs)
    busy, n = 0.0, 0
    parts = {"nccl": [0.0, 0], "ledger": [0.0, 0], "prefix": [0.0, 0]}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy += us
        n += 1
        for part, acc in parts.items():
            if part in e.name.lower():
                acc[0] += us
                acc[1] += 1
    out.update(busy_ms=busy / d / 1e3, idle=1 - busy / 1e6 / wall,
               events=n / d,
               **{f"{k}_ms": v[0] / d / 1e3 for k, v in parts.items()},
               **{f"{k}_n": v[1] / d for k, v in parts.items()})
    return out


def child(rank: int, k: int, port: int, work: str, plain: bool) -> None:
    """One rank of a world of ``k``: its record into ``work``."""
    import torch
    from reina_tpu_torch.core import graphs as G
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.kernels import build
    from reina_tpu_torch.parallel import mesh as M

    build.lib()                 # built by the parent: loaded here
    dev = f"cuda:{rank}"
    torch.cuda.set_device(dev)
    M.init_distributed(f"tcp://127.0.0.1:{port}", k, rank, "nccl")
    run = _hus(dev)
    agents = M.make_mesh(1, k, device=dev)
    steps = DAYS - 1
    rec = {}
    # the graphed runs share one graph set, freed when the scope ends,
    # before the communicators are destroyed
    with G.reusing():
        rec["first_ms"] = _timed(lambda: run_days(run, mesh=agents)) \
            / steps * 1e3
        rec["again_ms"] = _timed(lambda: run_days(run, mesh=agents)) \
            / steps * 1e3
        if plain:
            rec["plain_ms"] = _timed(lambda: run_days(
                run, mesh=agents, graphs=False)) / steps * 1e3
        rec["profile"] = profile_window(run, agents, rank == 0)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(work, f"rank_{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def world(tree: str, k: int, plain: bool) -> list:
    """Spawn the ``k`` ranks, wait for them (killed after RANK_S) and
    return their records."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    with tempfile.TemporaryDirectory() as work:
        procs = []
        for r in range(k):
            with open(os.path.join(work, f"log_{r}.txt"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--tree",
                     tree, "--child", str(r), str(k), str(port), work,
                     str(int(plain))], cwd=tree, stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.time() + RANK_S
        while time.time() < deadline and any(p.poll() is None
                                             for p in procs):
            time.sleep(0.5)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            tails = "\n".join(f"--- rank {r}:\n" + open(os.path.join(
                work, f"log_{r}.txt")).read()[-3000:] for r in bad)
            raise SystemExit(f"{k} ranks: ranks {bad} failed (killed after "
                             f"{RANK_S} s where negative):\n{tails}")
        return [json.load(open(os.path.join(work, f"rank_{r}.json")))
                for r in range(k)]


def main(args) -> int:
    import torch
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(f"tree {args.tree}; nvidia-smi: {smi[0]} x {len(smi)}; torch "
          f"{torch.__version__}", flush=True)
    build.lib()
    run = _hus("cuda:0")
    run_days(run)
    res = {"tree": args.tree, "card": smi[0],
           "one_card_again_ms": _timed(lambda: run_days(run))
           / (DAYS - 1) * 1e3}
    print(f"one card, graphed again: {res['one_card_again_ms']:.3f} ms/day",
          flush=True)
    del run
    torch.cuda.empty_cache()
    for k in args.ranks:
        recs = world(args.tree, k, args.plain)
        p = recs[0]["profile"]
        res[k] = {key: max(r[key] for r in recs)
                  for key in ("first_ms", "again_ms", "plain_ms",
                              "peak_gib") if key in recs[0]}
        res[k]["profile"] = p
        plain = (f", plain {res[k]['plain_ms']:.2f}"
                 if "plain_ms" in res[k] else "")
        print(f"{k} ranks over NCCL, the slowest rank: graphed first "
              f"{res[k]['first_ms']:.2f}, again {res[k]['again_ms']:.3f}"
              f"{plain} ms/day; peak {res[k]['peak_gib']:.2f} GiB; rank 0, "
              f"graphed days {PROFILE_START}-"
              f"{PROFILE_START + PROFILE_DAYS - 1}: wall "
              f"{p['wall_ms']:.3f} ms/day, device busy {p['busy_ms']:.3f}, "
              f"idle share {p['idle']:.3f}, NCCL {p['nccl_ms']:.3f} ms/day "
              f"({p['nccl_n']:.1f}/day), sharded ledger "
              f"{p['ledger_ms']:.3f}, sharded prefix {p['prefix_ms']:.3f}",
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--child", nargs=5)
    a = ap.parse_args()
    a.tree = os.path.abspath(a.tree)
    # the package timed is the tree's, not this file's
    sys.path[0] = a.tree
    if a.child:
        r, k, port, work, plain = a.child
        child(int(r), int(k), int(port), work, plain == "1")
    else:
        sys.exit(main(a))
