"""The spread of the HUS run's final all_infected over seeds, on the card.

    python -m reina_tpu_torch.mc_spread [--seeds 16] [--days 365]
        [--out build/mc_spread.json] [--area NAME] [--curves PATH]
    torchrun --nproc-per-node K -m reina_tpu_torch.mc_spread --n-seed K ...

Builds the default HUS configuration once (``random_seed`` 0) and runs
``ensemble.run_ensemble`` over seeds 0..S-1, one member at a time, as
the JAX package's 1,000-seed record did (BENCH_MC.json, from
tools/bench_monte_carlo.py: one build, only the day keys vary). After
every member it prints the member's final all_infected and seconds and
rewrites the JSON record at ``--out``, so a run cut short leaves the
seeds it finished. The record holds the finals, their mean and std
(ddof 0, as BENCH_MC.json), seeds per hour on this card under
BENCH_MC.json's metric name, the card's name and power limit, and the
record's bands: the mean within BENCH_MC.json's mean ± 3 std/√S and the
std within the 99% chi-square band for S - 1 degrees of freedom.
``--area`` builds another area of the defaults instead (its record has
no reference and no bands: BENCH_MC.json is HUS's); ``--curves`` appends
each seed's daily totals (all_infected, new_infections, all_detected,
in_ward, in_icu, dead; one JSON line a seed, as the seed ends) to PATH,
to set the mean curves of two runs side by side day by day.
Runs on the card only.

With ``--n-seed K`` under torchrun (K ranks, one card each: the seed
axis of parallel/mesh.py) the seeds go K at a time, one a rank, each
rank on the card ``LOCAL_RANK``; the record then counts the seeds per
hour of all K cards, and only rank 0 prints and writes it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the daily totals --curves keeps: their rows of DayOutputs.by_group
CURVES = {"all_infected": 3, "new_infections": 12, "all_detected": 5,
          "in_ward": 8, "in_icu": 6, "dead": 9}


def bands(n: int, ref: dict) -> dict:
    """BENCH_MC.json's mean ± 3 std/√n, and its std × the 99% chi-square
    band of a sample std over n seeds."""
    from scipy.stats import chi2
    mean, std = ref["final_all_infected_mean"], ref["final_all_infected_std"]
    half = 3 * std / np.sqrt(n)
    lo, hi = (np.sqrt(chi2.ppf(q, n - 1) / (n - 1)) for q in (0.005, 0.995))
    return {"mean": [mean - half, mean + half], "std": [std * lo, std * hi]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--days", type=int, default=365)
    ap.add_argument("--out", default=os.path.join(_REPO, "build",
                                                  "mc_spread.json"))
    ap.add_argument("--n-seed", type=int, default=1,
                    help="ranks on the seed axis (under torchrun)")
    ap.add_argument("--area", default=None,
                    help="an area other than the defaults' (HUS)")
    ap.add_argument("--curves", default=None,
                    help="a JSONL file that takes each seed's daily totals")
    args = ap.parse_args(argv)

    from .config.variables import VARIABLE_DEFAULTS
    from .core.engine import build_run
    from .ensemble import run_ensemble
    from .parallel import mesh as M
    from .simulation import resolve_device

    dev = resolve_device("cuda")
    mesh = None
    if args.n_seed > 1:
        M.init_distributed()
        mesh = M.make_mesh(n_seed=args.n_seed, n_agent=1)
        dev = mesh.device
    lead = mesh is None or mesh.rank == 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    with open(os.path.join(_REPO, "BENCH_MC.json")) as f:
        ref = json.load(f)
    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = args.days
    v["random_seed"] = 0
    if args.area is not None:
        v["area_name"] = args.area
    hus = v["area_name"] == VARIABLE_DEFAULTS["area_name"]
    t0 = time.perf_counter()
    run = build_run(v, dev)
    if lead:
        print(f"build_run {time.perf_counter() - t0:.3f} s, {run.n_agents} "
              f"agents; {torch.cuda.get_device_name(dev)}; nvidia-smi: "
              f"{smi[0] if smi else 'unavailable'}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    finals, seconds = [], []
    rec = {}
    step = args.n_seed
    for s0 in range(0, args.seeds, step):
        seeds = list(range(s0, min(s0 + step, args.seeds)))
        t0 = time.perf_counter()
        outs = run_ensemble(run, seeds, mesh=mesh)
        seconds.append(time.perf_counter() - t0)
        finals += [int(x) for x in outs.by_group[:, -1, 3].sum(-1)]
        wall = float(sum(seconds))
        if not lead:
            continue
        if args.curves is not None:
            with open(args.curves, "a") as f:
                for i, s in enumerate(seeds):
                    tot = outs.by_group[i].sum(-1)
                    f.write(json.dumps({"seed": s, "area": v["area_name"], **{
                        k: tot[:, j].tolist() for k, j in CURVES.items()}})
                            + "\n")
        rec = {
            "metric": "hus_monte_carlo_seeds_per_hour_per_chip",
            "area": v["area_name"], "n_agents": run.n_agents,
            "device": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi[0] if smi else None,
            "cards": step,
            "n_seeds": len(finals), "n_seeds_requested": args.seeds,
            "days": args.days - 1, "wall_s": wall,
            "seeds_per_hour": len(finals) / wall * 3600,
            "seeds_per_hour_per_card": len(finals) / wall * 3600 / step,
            "seconds_per_round": seconds,
            "finals": finals,
            "final_all_infected_mean": float(np.mean(finals)),
            "final_all_infected_std": float(np.std(finals)),
        }
        if hus:
            rec["reference"] = {k: ref[k] for k in (
                "n_seeds", "final_all_infected_mean",
                "final_all_infected_std")}
        if hus and len(finals) > 1:
            b = bands(len(finals), ref)
            rec["bands"] = b
            rec["mean_in_band"] = bool(
                b["mean"][0] <= rec["final_all_infected_mean"] <= b["mean"][1])
            rec["std_in_band"] = bool(
                b["std"][0] <= rec["final_all_infected_std"] <= b["std"][1])
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"seeds {seeds}: final all_infected "
              f"{finals[-len(seeds):]}, {seconds[-1]:.3f} s "
              f"({seconds[-1] / (args.days - 1) * 1000:.2f} ms/day)",
              flush=True)
    if lead:
        print(json.dumps(rec))
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
