"""Parameter-grid calibration sweeps (port of reina_tpu/calibration.py).

The reference has no built-in calibration: its only sweep axis is the
Monte-Carlo seed pool (calc/simulation.py:349-385), and fitting model
parameters (e.g. ``infectiousness_multiplier``) against observed case
data was a manual exercise. ``sweep_grid`` runs every point of a grid
and ``calibrate`` ranks the points by their fit to the observed
cumulative detected-case curve of the area, as the reference's
empirical validation compares them (components/results.py:56-94).

The points run one after another through the single-run path, as the
seeds of ``ensemble.run_ensemble`` do (see there for why). Each point
is built when its turn comes and released after it, so the device holds
one point's run besides the base run at a time. Across ranks (``mesh``)
each agent group runs its share of the points and every rank returns
all of them, as ``ensemble.run_ensemble`` does.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .core import graphs
from .core.engine import CompiledRun, build_run, run_days
from .core.params import DISEASE_PARAMS
from .core.step import GROUP_ROW, DayOutputs
from .data import loaders
from .ensemble import check_batch_size, stack_members

# Grid variables must only affect the compiled disease/model arrays:
# the sweep shares one engine config, schedule set and seed across
# points, so anything else would be silently ignored.
SWEEPABLE = set(DISEASE_PARAMS)


def grid_points(grid: Dict[str, Sequence[Any]]) -> List[Dict[str, Any]]:
    """Cartesian product of a {variable: [values]} grid."""
    unknown = set(grid) - SWEEPABLE
    if unknown:
        raise ValueError(
            "grid variables must be disease parameters (they alone feed "
            "the per-point model arrays); not sweepable: %s"
            % ", ".join(sorted(unknown)))
    names = list(grid)
    return [dict(zip(names, combo))
            for combo in itertools.product(*(grid[n] for n in names))]


def sweep_grid(variables: Dict[str, Any], grid: Dict[str, Sequence[Any]],
               n_days: Optional[int] = None, batch_size: int = 8,
               pad_multiple: int = 1024, age_counts_override=None,
               device="cuda", mesh=None) -> Tuple[List[Dict[str, Any]],
                                                  DayOutputs, CompiledRun]:
    """Run every grid point on ``device``; returns (points, DayOutputs
    as numpy with leading (n_points, days-1) axes, base run).

    As in the JAX package's ``_grid_scan``, every point runs with the
    base run's (the first point's) engine config and schedules, its own
    model arrays and initial state and carry (seeding draws severities
    and durations through the point's own disease arrays), and the
    shared key ``PRNGKey(base.random_seed)``. ``base.meta
    ["sweep_seconds"]`` holds each point's (build, days) seconds.
    ``batch_size`` changes no value and no launch (ensemble.py). With
    ``mesh`` every rank calls it with the same arguments, builds the
    base run and its share of the points on its own device, and gets
    every point (``sweep_seconds`` of each from the rank that ran it)."""
    from .parallel.mesh import batch_placement, gather_placed
    from .simulation import resolve_device

    check_batch_size(batch_size)
    dev = mesh.device if mesh is not None else resolve_device(device)
    points = grid_points(grid)

    def build(pt):
        v = dict(variables)
        v.update(pt)
        return build_run(v, dev, pad_multiple=pad_multiple,
                         age_counts_override=age_counts_override)

    mine = batch_placement(mesh, points)
    t0 = time.perf_counter()
    base = build(points[0])
    base_s = time.perf_counter() - t0
    steps = (n_days if n_days is not None else base.days) - 1
    results = []
    # the points share one graph set, also on an agent axis over NCCL
    with graphs.reusing():
        for i in mine:
            t0 = time.perf_counter()
            run = base if i == 0 else build(points[i])
            t1 = time.perf_counter()
            run = replace(run, cfg=base.cfg, schedules=base.schedules)
            out, _, _, _ = run_days(run, n_days=steps + 1,
                                    seed=base.random_seed, mesh=mesh)
            del run
            results.append((DayOutputs(*(x[1:] for x in out)),
                            (base_s if i == 0 else t1 - t0,
                             time.perf_counter() - t1)))
    results = gather_placed(mesh, mine, results, len(points))
    base.meta["sweep_seconds"] = [sec for _, sec in results]
    return points, stack_members([out for out, _ in results]), base


def score_against_observed(outs: DayOutputs, run: CompiledRun,
                           observed_rows: Optional[List[dict]] = None,
                           metric: str = "all_detected") -> np.ndarray:
    """Least-squares distance in log1p space between each point's
    simulated cumulative series and the observed series, aligned by
    date. Lower is better."""
    from datetime import date

    if observed_rows is None:
        observed_rows = loaders.get_detected_cases(run.meta["area_name"])
    # observed casefile column per simulated metric
    obs_col = {"all_detected": "confirmed", "dead": "dead",
               "in_icu": "in_icu", "in_ward": "in_ward"}
    if metric not in obs_col:
        raise ValueError(f"unsupported calibration metric {metric!r}; "
                         f"choose from {sorted(obs_col)}")
    attr_idx = GROUP_ROW[metric]
    start = date.fromisoformat(run.start_date)
    sim = outs.by_group[..., attr_idx, :].sum(axis=-1)   # (G, days)
    n_days = sim.shape[1]
    obs_by_day = {}
    for r in observed_rows:
        # sweep outputs have no leading snapshot row: sim[j] is the
        # state after day j, i.e. dated start + j + 1 — an observation
        # dated start + d therefore aligns with sim[d - 1]
        d = (date.fromisoformat(r["date"]) - start).days
        if 0 <= d - 1 < n_days:
            obs_by_day[d - 1] = float(r[obs_col[metric]])
    if not obs_by_day:
        raise ValueError("no observed days overlap the simulation window")
    idx = np.array(sorted(obs_by_day))
    obs = np.array([obs_by_day[i] for i in idx])
    diff = np.log1p(sim[:, idx]) - np.log1p(obs)[None, :]
    return (diff ** 2).mean(axis=1)


def calibrate(variables: Dict[str, Any], grid: Dict[str, Sequence[Any]],
              n_days: Optional[int] = None, metric: str = "all_detected",
              observed_rows: Optional[List[dict]] = None,
              batch_size: int = 8, pad_multiple: int = 1024,
              age_counts_override=None,
              device="cuda", mesh=None) -> Tuple[Dict[str, Any], list]:
    """Evaluate the grid and rank points by fit against observed data.
    Returns (best_point, [(point, score), ...] sorted best-first). With
    ``mesh`` the points run across ranks (``sweep_grid``)."""
    points, outs, base = sweep_grid(
        variables, grid, n_days=n_days, batch_size=batch_size,
        pad_multiple=pad_multiple, age_counts_override=age_counts_override,
        device=device, mesh=mesh)
    scores = score_against_observed(outs, base, observed_rows, metric)
    ranked = sorted(zip(points, scores.tolist()), key=lambda x: x[1])
    return ranked[0][0], ranked
