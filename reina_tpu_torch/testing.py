"""Test helpers: tiny synthetic compiled runs (port of reina_tpu/testing.py)."""
from __future__ import annotations

from typing import Dict, Optional

from reina_tpu.config.variables import VARIABLE_DEFAULTS

from .core.engine import CompiledRun, build_run


def synthetic_variables(days: int = 20, seed: int = 0,
                        interventions: Optional[list] = None,
                        **overrides) -> Dict:
    """Resolved variable dict for a small synthetic run."""
    v = dict(VARIABLE_DEFAULTS)
    v["area_name"] = "synthetic"
    v["simulation_days"] = days
    v["random_seed"] = seed
    v["hospital_beds"] = overrides.pop("hospital_beds", 50)
    v["icu_units"] = overrides.pop("icu_units", 10)
    if interventions is not None:
        v["interventions"] = interventions
    v.update(overrides)
    return v


def synthetic_age_counts(n_agents: int = 20000, nr_ages: int = 101,
                         seed: int = 1):
    """A plausible age pyramid summing to ``n_agents``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    weights = np.linspace(1.2, 0.4, nr_ages) + rng.uniform(0, 0.1, nr_ages)
    weights /= weights.sum()
    counts = np.floor(weights * n_agents).astype(np.int64)
    counts[0] += n_agents - counts.sum()
    return counts


def build_synthetic_run(device, n_agents: int = 20000, days: int = 20,
                        seed: int = 0, interventions: Optional[list] = None,
                        pad_multiple: int = 1024,
                        cfg_overrides: Optional[Dict] = None,
                        **overrides) -> CompiledRun:
    v = synthetic_variables(days=days, seed=seed,
                            interventions=interventions, **overrides)
    return build_run(v, device, cfg_overrides=cfg_overrides,
                     age_counts_override=synthetic_age_counts(n_agents),
                     pad_multiple=pad_multiple)
