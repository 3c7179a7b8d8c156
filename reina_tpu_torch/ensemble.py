"""Monte-Carlo ensembles over seeds (port of reina_tpu/ensemble.py).

Replaces the reference's 8-process ``multiprocessing.Pool.map`` over
1000 seeds (calc/simulation.py:349-385).

Execution strategy: every member runs through the single-run path,
``run_days`` of the one built run with the member's seed, one member
after another. That is the JAX package's single-chip strategy
(reina_tpu/ensemble.py:6-18: on one chip the sequential single-run
program beat the batched one by a measured 12×, and its 1,000-seed
record BENCH_MC.json ran so). Batching seeds into one launch would need
a seed axis in every kernel of the day step (per-seed ledgers, segments
and bins); ``batch_size`` is kept for the JAX package's signature and
CLI and changes no value and no launch.

Across ranks (``mesh``, parallel/mesh.py) each agent group runs its
contiguous share of the seeds in that way (sharding each member over its
ranks when the agent axis has several), and every rank returns all the
members in the caller's order: what the one-card call returns.

``run_monte_carlo`` returns numpy columns (``simulation.daily_columns``
plus ``run`` and ``scenario``) and writes the CSV that the JAX
package's ``df.to_csv(csv_path, index=False)`` writes, without pandas.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .core import graphs
from .core.engine import CompiledRun, build_run, run_days, stack_outputs
from .core.step import DayOutputs, snapshot_outputs
from .utils import perf


def check_batch_size(batch_size: int) -> None:
    if batch_size < 1:
        raise ValueError(f"batch_size must be at least 1, got {batch_size}")


def stack_members(members: Sequence[DayOutputs]) -> DayOutputs:
    """Per-member DayOutputs (days, ...) → one (members, days, ...)."""
    return DayOutputs(*(np.stack(xs) for xs in zip(*members)))


def run_ensemble(run: CompiledRun, seeds: List[int], batch_size: int = 1,
                 n_days: Optional[int] = None, mesh=None) -> DayOutputs:
    """Run ``seeds`` on the run's device; returns DayOutputs as numpy
    stacked with a leading (n_seeds, days-1) shape (the day-0 snapshot
    is omitted: it is the same for every seed).

    Member s is ``run_days(run, n_days=steps + 1, seed=s)`` without its
    row 0: the same initial state, day keys from ``PRNGKey(s)``.
    ``run_days`` checks the problem bitmask of every member. With
    ``mesh`` every rank calls it with the same arguments (``run`` built
    on its own device) and gets every member: each agent group runs its
    members, graphed on an agent axis over NCCL, then the seed axis
    gathers them. A rank that fails marks the mesh failed, and the other
    ranks' runs and gathers give up on that mark or on a lost rank
    (parallel/mesh.py), so that every rank raises. Each member of this
    rank is a span ``ensemble.member`` (utils/perf.py)."""
    from .parallel.mesh import batch_placement, gather_placed
    check_batch_size(batch_size)
    steps = (n_days if n_days is not None else run.days) - 1
    mine = batch_placement(mesh, seeds)
    members = []
    # the members share one graph set, also on an agent axis over NCCL
    with graphs.reusing():
        for i in mine:
            with perf.span("ensemble.member"):
                out, _, _, _ = run_days(run, n_days=steps + 1, seed=seeds[i],
                                        mesh=mesh)
                members.append(DayOutputs(*(x[1:] for x in out)))
    return stack_members(gather_placed(mesh, mine, members, len(seeds)))


def run_monte_carlo(scenario_name: str = "default", n_runs: int = 1000,
                    batch_size: int = 1, variables: Optional[Dict] = None,
                    csv_path: Optional[str] = None,
                    device="cuda", mesh=None) -> Dict[str, np.ndarray]:
    """Seed sweep for a scenario (reference run_monte_carlo,
    calc/simulation.py:362-385); returns the concatenated daily columns:
    ``date``, the daily columns in ``daily_columns`` order, ``run`` and
    ``scenario``, one block of rows per member.

    As in the JAX package, the scenario is applied to a fresh
    VariableStore, whose values replace ``variables``, and the seed is 0
    for the build; member s draws its days from ``PRNGKey(s)``. The
    day-0 row is the snapshot at ``mobility_scalar[0]``. With ``mesh``
    the members run across its seed axis on each rank's device, every
    rank returns all the columns, and only rank 0 writes the CSV."""
    from .config import session_store
    from .config.scenarios import get_scenario
    from .config.variables import VariableStore
    from .simulation import daily_columns, resolve_device

    dev = mesh.device if mesh is not None else resolve_device(device)
    store = VariableStore()
    with session_store(store):
        get_scenario(scenario_name).apply()
        variables = store.copy_all()
    variables["random_seed"] = 0

    run = build_run(variables, dev)
    outs = run_ensemble(run, list(range(n_runs)), batch_size, mesh=mesh)
    snap = stack_outputs([snapshot_outputs(
        run.cfg, run.arrays, run.init_state, run.init_carry,
        run.schedules.mobility_scalar[0].cpu().numpy())])
    blocks = []
    for s in range(n_runs):
        padded = DayOutputs(*(np.concatenate([a, b[s]])
                              for a, b in zip(snap, outs)))
        cols = daily_columns(padded, run.variant_names, run.start_date,
                             run.days)
        cols["run"] = np.full(run.days, s, np.int64)
        blocks.append(cols)
    cols = {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}
    cols["scenario"] = np.full(len(cols["date"]), scenario_name, object)
    if csv_path and (mesh is None or mesh.rank == 0):
        write_csv(cols, csv_path)
    return cols


def _csv_text(a: np.ndarray) -> np.ndarray:
    """A column as the text pandas' ``to_csv`` writes for it: dates as
    ISO days, numbers by numpy's ``str`` of their own dtype, NaN empty."""
    if a.dtype.kind == "M":
        return a.astype("datetime64[D]").astype(str)
    if a.dtype.kind == "f":
        text = a.astype(str).astype(object)
        text[np.isnan(a)] = ""
        return text
    return a.astype(str)


def write_csv(cols: Dict[str, np.ndarray], path: str) -> None:
    """Columns → CSV with a header row and no index column."""
    texts = [_csv_text(np.asarray(v)) for v in cols.values()]
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator=os.linesep)
        w.writerow(cols)
        w.writerows(zip(*texts))


DESCRIBE_STATS = ("count", "mean", "std", "min", "25%", "50%", "75%", "max")


def describe(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """pandas ``DataFrame.describe()`` of the numeric columns, in
    numpy: per column the DESCRIBE_STATS over its non-NaN values (std
    with ddof 1, quantiles by linear interpolation)."""
    out = {}
    for name, a in cols.items():
        if a.dtype.kind not in "iuf":
            continue
        x = np.asarray(a, np.float64)
        x = x[~np.isnan(x)]
        if len(x) == 0:
            out[name] = np.array([0.0] + [np.nan] * 7)
            continue
        q = np.percentile(x, [0, 25, 50, 75, 100])
        std = x.std(ddof=1) if len(x) > 1 else np.nan
        out[name] = np.array([len(x), x.mean(), std, *q])
    return out
