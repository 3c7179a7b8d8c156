"""Simulation driver (port of reina_tpu/simulation.py; reference:
calc/simulation.py).

``simulate_individuals`` builds (or takes from the build cache) a run on
a device, steps it, and returns the daily columns and the (day × attr ×
age group) cube as numpy, under the JAX package's frame column names;
``outputs_to_frames`` turns the same outputs into the JAX package's two
DataFrames for callers that want pandas (imported there only: the
card's machine has no pandas). Partial results stream through
``step_callback`` with cooperative cancellation.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``cuda``, and with no CUDA device they raise.
"""
from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from contextlib import nullcontext
from datetime import date
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config.variables import copy_variables
from .core import constants as C
from .core.engine import CompiledRun, build_run, reseed_run, run_days
from .core.params import DISEASE_PARAMS
from .core.step import GROUP_ROW
from .utils.memoize import calcfunc
from .utils import perf

# Daily output attribute sets (reference calc/simulation.py:17-47)
POP_ATTRS = [
    "susceptible", "vaccinated", "infected", "detected", "all_detected",
    "in_ward", "in_icu", "dead", "non_hospital_deaths", "recovered",
    "all_infected", "new_infections",
]
EXPOSURES_ATTRS = ["exposures_%s" % p for p in C.PLACES]
STATE_ATTRS = [
    "exposed_per_day", "available_hospital_beds", "available_icu_units",
    "total_icu_units", "ct_cases_per_day", "r", "mobility_limitation",
]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA without a card (an
    entry point never carries on on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return dev


_BUILD_CACHE_MAX = 2


class BuildCache:
    """Compiled runs by resolved variables and device, at most
    ``_BUILD_CACHE_MAX``, oldest dropped first.

    The key leaves out ``random_seed``: only the initial state depends
    on it, so a hit with another seed goes through ``reseed_run``
    instead of a rebuild. At most one build runs per key at a time;
    concurrent misses for one key wait for it. A CompiledRun is
    read-only to the engine, so threads may share it. ``step.STATS``
    counts ``build.misses``, ``build.hits`` and ``build.reseeds``;
    ``last`` is the calling thread's last (outcome, seconds)."""

    def __init__(self):
        self._runs: "OrderedDict[str, CompiledRun]" = OrderedDict()
        self._lock = threading.Lock()
        self._key_locks: Dict[str, threading.Lock] = {}
        self._local = threading.local()

    @property
    def last(self) -> Tuple[str, float]:
        """This thread's last ``get``: its outcome (built, cached or
        reseeded) and seconds; ("", 0.0) before its first."""
        return getattr(self._local, "last", ("", 0.0))

    @staticmethod
    def key(variables: Dict, device: torch.device) -> str:
        return json.dumps({"device": str(device),
                           "variables": {k: v for k, v in variables.items()
                                         if k != "random_seed"}},
                          sort_keys=True, default=str)

    def get(self, variables: Dict, device) -> CompiledRun:
        device = torch.device(device)
        seed = variables.get("random_seed")
        key = self.key(variables, device)
        t0 = time.perf_counter()
        with self._lock:
            key_lock = self._key_locks.setdefault(key, threading.Lock())
        with key_lock:
            with self._lock:
                run = self._runs.get(key)
            if run is None:
                run = build_run(variables, device)
                with self._lock:
                    while len(self._runs) >= _BUILD_CACHE_MAX:
                        old, _ = self._runs.popitem(last=False)
                        self._key_locks.pop(old, None)
                    self._runs[key] = run
                perf.count("build.misses")
                outcome = "built"
            else:
                perf.count("build.hits")
                outcome = "cached"
        if run.random_seed != seed:
            run = reseed_run(run, seed)
            perf.count("build.reseeds")
            outcome = "reseeded"
        self._local.last = (outcome, time.perf_counter() - t0)
        return run


BUILD_CACHE = BuildCache()


def _cached_build_run(variables: Dict, device) -> CompiledRun:
    return BUILD_CACHE.get(variables, device)


def daily_columns(out, variant_names, start_date: str, rows: int,
                  us_per_infected: Optional[np.ndarray] = None
                  ) -> Dict[str, np.ndarray]:
    """The first ``rows`` days of stacked DayOutputs as numpy columns,
    named and ordered as the JAX package's daily DataFrame, after a
    ``date`` column (that frame's index)."""
    cols: Dict[str, np.ndarray] = {
        "date": np.datetime64(date.fromisoformat(start_date), "D")
        + np.arange(rows)}
    for attr in POP_ATTRS:
        cols[attr] = out.by_group[:rows, GROUP_ROW[attr]].sum(axis=1)
    for attr in STATE_ATTRS:
        cols[attr] = np.asarray(getattr(out, attr))[:rows]
    for p_i, name in enumerate(EXPOSURES_ATTRS):
        cols[name] = out.exposures_by_place[:rows, p_i]
    cols["us_per_infected"] = (us_per_infected[:rows]
                               if us_per_infected is not None
                               else np.zeros(rows))
    # per-variant daily infections (main.pyx:1847-1850), as prefix
    # columns so the takeover curve reaches every consumer
    for v_i, name in enumerate(variant_names):
        cols["infected_by_variant_%s" % name] = \
            out.infected_by_variant[:rows, v_i]
    return cols


class AgeGroupCube(NamedTuple):
    """The (date × attr × age group) cube: ``values[d, a, g]``."""
    values: np.ndarray       # (days, len(attrs), len(groups))
    attrs: List[str]         # POP_ATTRS
    groups: List[str]        # the run's age-group labels


def age_group_cube(out, group_labels) -> AgeGroupCube:
    """The by_group rows of stacked DayOutputs in POP_ATTRS order."""
    return AgeGroupCube(out.by_group[:, [GROUP_ROW[a] for a in POP_ATTRS], :],
                        list(POP_ATTRS), list(group_labels))


def outputs_to_frames(out, run, n_days: int,
                      us_per_infected: Optional[np.ndarray] = None):
    """Stacked DayOutputs → (daily df, age-group cube df), as the JAX
    package's ``outputs_to_frames``. Needs pandas."""
    import pandas as pd

    cols = daily_columns(out, run.variant_names, run.start_date, n_days,
                         us_per_infected)
    del cols["date"]
    idx = pd.date_range(date.fromisoformat(run.start_date), periods=n_days)
    df = pd.DataFrame(cols, index=idx)
    adf = pd.DataFrame(
        age_group_cube(out, run.group_labels).values.reshape(
            n_days * len(POP_ATTRS) * len(run.group_labels)),
        index=pd.MultiIndex.from_product(
            [idx, POP_ATTRS, run.group_labels],
            names=["date", "attr", "age_group"]),
        columns=["pop"],
    )
    adf = adf.unstack("attr").unstack("age_group")
    adf.columns = adf.columns.droplevel()
    return df, adf


@calcfunc(
    variables=list(DISEASE_PARAMS) + [
        "simulation_days", "interventions", "active_scenario", "scenarios",
        "start_date", "hospital_beds", "icu_units", "random_seed", "max_age",
        "imported_infection_ages", "area_name",
        "incubating_at_simulation_start", "ill_at_simulation_start",
        "recovered_at_simulation_start",
    ],
    key_args=("device",),
)
def simulate_individuals(step_callback: Optional[Callable] = None,
                         callback_day_interval: int = 1,
                         variables: Optional[Dict] = None,
                         device="cuda"):
    """Run a full simulation on ``device``; returns (daily columns,
    age-group cube) as numpy (``daily_columns``, ``age_group_cube``).

    Mirrors reference calc/simulation.py:148-290. ``step_callback``
    receives the partial daily columns; returning a falsy value cancels
    the run (→ ExecutionInterrupted)."""
    dev = resolve_device(device)
    pc = perf.PerfCounter()
    run = _cached_build_run(variables, dev)
    pc.measure()

    n_days = variables["simulation_days"]
    us_rows = np.zeros(n_days, dtype=np.float64)
    chunk = max(callback_day_interval, 1) if step_callback else 32

    # output row 0 is the initial snapshot (emit-then-iterate): no
    # simulated day produced it, so the perf accounting starts at row 1
    done = 1

    def day_cb(day_idx, partial):
        nonlocal done
        # with a callback: its partial result (the server's cache write)
        with perf.span("serve.publish") if step_callback else nullcontext():
            rows = day_idx + 1
            ms = pc.measure()
            # wall-µs per infected agent per day (calc/simulation.py:212),
            # averaged over the chunk just computed
            infected = partial.by_group[:rows,
                                        GROUP_ROW["infected"]].sum(axis=1)
            per_day_ms = ms / max(rows - done, 1)
            for d in range(done, rows):
                us_rows[d] = (per_day_ms * 1000 / infected[d] if infected[d]
                              else 0)
            done = rows
            if step_callback is None:
                return True
            return bool(step_callback(daily_columns(
                partial, run.variant_names, run.start_date, rows, us_rows)))

    out, _, _, _ = run_days(run, n_days=n_days, chunk_days=chunk,
                            day_callback=day_cb)
    return (daily_columns(out, run.variant_names, run.start_date, n_days,
                          us_rows),
            age_group_cube(out, run.group_labels))


def sample_model_parameters(what: str, age: int, severity: Optional[str] = None,
                            variables: Optional[Dict] = None, device="cuda"):
    """Distribution sampling for the parameter-explorer UI (reference
    calc/simulation.py:301-346 + main.pyx:2047-2101): ``sampling.
    sample_distribution`` on the active variables, drawn on ``device``;
    returns (categories, counts)."""
    from .sampling import sample_distribution
    if variables is None:
        variables = copy_variables()
    return sample_distribution(what, age, severity, variables, device)
