"""Command-line interface of the port (port of reina_tpu/cli.py;
reference: ``python -m calc.simulation`` main,
calc/simulation.py:388-469).

  python -m reina_tpu_torch.cli simulate [--area HUS] [--days N] [--seed S]
      [--scenario ID] [--interval N] [--quiet] [--device cuda|cpu]
  python -m reina_tpu_torch.cli monte-carlo [--scenario default] [--runs 1000]
      [--batch-size 1] [--device cuda|cpu]
  python -m reina_tpu_torch.cli sample --what symptom_severity [--age 90]
      [--severity SEVERE] [--device cuda|cpu]
  python -m reina_tpu_torch.cli calibrate --grid '{"infectiousness_multiplier": [0.4, 0.55, 0.7]}'
      [--area HUS] [--days N] [--metric all_detected|dead] [--batch-size 8]
      [--device cuda|cpu]

Every command runs on the card (``--device cuda``, the default) and
fails when there is none; ``--device cpu`` is the explicit way to run
on the CPU. Tables are printed from numpy columns (no pandas).
"""
from __future__ import annotations

import argparse
import sys

_ROW_ATTRS = ["ct_cases_per_day", "r", "exposures", "us_per_infected"]


def _print_header():
    from .simulation import POP_ATTRS
    header = "%-10s" % "day"
    for attr in POP_ATTRS + _ROW_ATTRS:
        header += "%15s" % attr
    print(header)


def _print_row(cols, i: int):
    from .simulation import EXPOSURES_ATTRS, POP_ATTRS
    s = "%-12s" % str(cols["date"][i])
    for attr in POP_ATTRS:
        s += "%15d" % cols[attr][i]
    s += "%15d" % cols["ct_cases_per_day"][i]
    s += "%13.2f" % cols["r"][i]
    s += "%15d" % sum(int(cols[x][i]) for x in EXPOSURES_ATTRS)
    s += "%13.2f" % cols["us_per_infected"][i]
    print(s)


def _step_printer(cols):
    _print_row(cols, len(cols["date"]) - 1)
    return True


def _print_cube(cube, date):
    """The last day's counts by age group."""
    print(f"age groups on {date}:")
    print("%-22s" % "attr" + "".join("%10s" % g for g in cube.groups))
    for a, attr in enumerate(cube.attrs):
        print("%-22s" % attr
              + "".join("%10d" % v for v in cube.values[-1, a]))


def cmd_simulate(args):
    from .config import allow_set_variable, set_variable
    from .simulation import BUILD_CACHE, simulate_individuals

    with allow_set_variable():
        if args.area:
            set_variable("area_name", args.area)
        if args.days:
            set_variable("simulation_days", args.days)
        if args.seed is not None:
            set_variable("random_seed", args.seed)
        if args.scenario:
            from .config.scenarios import get_scenario
            get_scenario(args.scenario).apply()
        _print_header()
        cols, cube = simulate_individuals(
            step_callback=_step_printer if not args.quiet else None,
            callback_day_interval=args.interval, skip_cache=True,
            device=args.device)
    if args.quiet:
        for i in range(max(len(cols["date"]) - 10, 0), len(cols["date"])):
            _print_row(cols, i)
    outcome, seconds = BUILD_CACHE.last
    print(f"run on {args.device}: build {seconds:.3f} s ({outcome})")
    _print_cube(cube, cols["date"][-1])
    return 0


def cmd_monte_carlo(args):
    from .ensemble import DESCRIBE_STATS, describe, run_monte_carlo
    cols = run_monte_carlo(args.scenario, n_runs=args.runs,
                           batch_size=args.batch_size, device=args.device)
    last = cols["date"] == cols["date"].max()
    stats = describe({k: v[last] for k, v in cols.items()})
    # pandas' describe() of the last day's rows, one line per column
    print(f"last day {cols['date'].max()}:")
    print("%-34s" % "column" + "".join("%20s" % k for k in DESCRIBE_STATS))
    for name, row in stats.items():
        print("%-34s" % name + "".join("%20.12g" % x for x in row))
    return 0


def cmd_calibrate(args):
    import json

    from .calibration import calibrate
    from .config.variables import VariableStore

    variables = VariableStore().copy_all()
    if args.area:
        variables["area_name"] = args.area
    if args.days:
        variables["simulation_days"] = args.days
    grid = json.loads(args.grid)
    best, ranked = calibrate(variables, grid, batch_size=args.batch_size,
                             metric=args.metric, device=args.device)
    print("rank  score        point")
    for i, (pt, score) in enumerate(ranked):
        print("%-5d %-12.5f %s" % (i + 1, score, json.dumps(pt)))
    print("best:", json.dumps(best))
    return 0


def cmd_sample(args):
    from .simulation import sample_model_parameters
    cats, counts = sample_model_parameters(args.what, args.age, args.severity,
                                           device=args.device)
    total = counts.sum()
    for k, v in zip(cats, counts / total):
        print("    (%s, %.4f)," % (k, v))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="reina_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd")

    p = sub.add_parser("simulate", help="run one simulation, print daily table")
    p.add_argument("--area", default=None)
    p.add_argument("--days", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--scenario", default=None)
    p.add_argument("--interval", type=int, default=1)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda; cpu runs "
                        "the plain twins on the CPU)")
    p.set_defaults(func=cmd_simulate)

    p = sub.add_parser("monte-carlo", help="Monte-Carlo ensemble over seeds")
    p.add_argument("--scenario", default="default")
    p.add_argument("--runs", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=1,
                   help="kept for the JAX package's CLI: members run one "
                        "after another whatever it is")
    p.add_argument("--device", default="cuda",
                   help="torch device of the runs (default cuda)")
    p.set_defaults(func=cmd_monte_carlo)

    p = sub.add_parser("sample", help="sample model parameter distributions")
    p.add_argument("--what", required=True)
    p.add_argument("--age", type=int, default=30)
    p.add_argument("--severity", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the draws (default cuda)")
    p.set_defaults(func=cmd_sample)

    p = sub.add_parser(
        "calibrate", help="parameter-grid sweep scored against observed data")
    p.add_argument("--grid", required=True,
                   help='JSON, e.g. {"infectiousness_multiplier": [0.4, 0.55, 0.7]}')
    p.add_argument("--area", default=None)
    p.add_argument("--days", type=int, default=None)
    p.add_argument("--metric", default="all_detected",
                   choices=["all_detected", "dead"])
    p.add_argument("--batch-size", type=int, default=8,
                   help="kept for the JAX package's CLI: points run one "
                        "after another whatever it is")
    p.add_argument("--device", default="cuda",
                   help="torch device of the runs (default cuda)")
    p.set_defaults(func=cmd_calibrate)

    args = ap.parse_args(argv)
    if not args.cmd:
        ap.print_help()
        return 1
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
