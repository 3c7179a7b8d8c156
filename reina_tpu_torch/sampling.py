"""Parameter-distribution sampling (port of reina_tpu/sampling.py;
reference: main.pyx:2047-2101 + calc/simulation.py:301-346): 10k draws
from the model's stochastic primitives for the parameter-explorer UI.

Draws run through the engine's own samplers — the severity chain
(``core.step.severity_draw_slots``), the fixed-round gamma
(``ops.random.gamma_fixed``) and the contact-count expression of the
exposure phase — from one key, ``PRNGKey(random_seed)``, with the same
draw shapes and float expressions as the JAX package, so the explorer
cannot drift from the step. The draws run on the given device, ``cuda``
unless the caller asks for the CPU; the counting is numpy. Results are
plain ``(categories, counts)`` arrays, categories sorted (no pandas).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .core import constants as C
from .core.params import compile_disease, create_disease_params
from .core.step import severity_draw_slots
from .data import loaders
from .ops import prng
from .ops.random import gamma_fixed
from .simulation import resolve_device

SAMPLE_SIZE = 10000

SUPPORTED = {
    "infectiousness", "contacts_per_day", "symptom_severity",
    "incubation_period", "illness_period", "hospitalization_period",
    "icu_period", "onset_to_removed_period",
}

_SEVERITY_TABLES = ("p_sympt", "p_doh", "p_severe_c", "p_critical_c",
                    "p_fatal_c")


def _gamma_engine(key, mu: float, cv: float, device) -> np.ndarray:
    """The engine's duration draw: fixed-round standard gamma (float32
    on ``device``) scaled by theta in numpy, as the JAX package's
    ``_gamma_engine`` scales its draw."""
    kappa = 1.0 / (cv ** 2)
    theta = (cv ** 2) * mu
    return gamma_fixed(key, kappa, (SAMPLE_SIZE,), device).cpu().numpy() \
        * theta


def sample_distribution(what: str, age: int, severity: Optional[str],
                        variables: Dict, device="cuda"
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(categories, counts) of ``what`` for an agent of ``age``:
    the categories sorted (severity codes in code order, as names), the
    counts of 10,000 draws, or for ``infectiousness`` the non-zero
    points of the curve by day from onset."""
    if what not in SUPPORTED:
        raise ValueError(
            "unknown sample type. supported: %s" % ", ".join(sorted(SUPPORTED)))
    dev = resolve_device(device)
    nr_ages = variables["max_age"] + 1
    disease, _names = compile_disease(create_disease_params(variables), nr_ages)
    sev = C.STR_TO_SEVERITY[severity] if severity else C.MILD

    if what == "infectiousness":
        days = np.arange(-C.IOT_OFFSET, C.IOT_OFFSET + 1)
        curve = np.array(C.INFECTIOUSNESS_OVER_TIME)
        return days[curve != 0], curve[curve != 0]

    key = prng.PRNGKey(variables.get("random_seed", 0))
    if what == "contacts_per_day":
        base = loaders.get_contact_tensor().per_year_participant(
            variables["max_age"])
        limit_mob = variables.get("sample_limit_mobility", 0)
        mob = (100 - limit_mob) / 100.0
        mean_contacts = float(base[age].sum()) * mob
        # exposure-phase expression (core/step.py, exposure phase)
        z = prng.normal(key, (SAMPLE_SIZE,), dev)
        f = torch.exp(C.CONTACT_LOGNORMAL_SIGMA * z) * mean_contacts
        f = torch.clamp_min(f, 1.0)
        out = torch.clamp(torch.floor(f).to(torch.int32) - 1, 0,
                          C.DEFAULT_CONTACT_LIMIT).cpu().numpy()
    elif what == "symptom_severity":
        tables = SimpleNamespace(**{
            name: torch.as_tensor(np.asarray(getattr(disease, name),
                                             np.float32), device=dev)
            for name in _SEVERITY_TABLES})
        v_i = torch.zeros(SAMPLE_SIZE, dtype=torch.long, device=dev)
        age_i = torch.full((SAMPLE_SIZE,), age, dtype=torch.long, device=dev)
        dov_i = torch.full((SAMPLE_SIZE,), -1, dtype=torch.int16, device=dev)
        sev_i, _outside = severity_draw_slots(key, tables, v_i, age_i, dov_i,
                                              0)
        out = sev_i.cpu().numpy().astype(np.int64)
    elif what == "incubation_period":
        g = _gamma_engine(key, float(disease.mu_incub[0]), C.INCUBATION_CV,
                          dev)
        out = np.floor(g + 0.5).astype(np.int64)
    else:
        mu = (disease.mu_death[0] if sev == C.FATAL
              else disease.mu_recov[0])
        o2r = _gamma_engine(key, float(mu), C.ONSET_TO_REMOVED_CV, dev)
        rb = float(disease.ratio_before_hosp[0])
        rw = float(disease.ratio_in_ward[0])
        if what == "onset_to_removed_period":
            out = np.floor(o2r + 0.5).astype(np.int64)
        elif what == "illness_period":
            ratio = rb if sev >= C.SEVERE else 1.0
            out = np.floor(o2r * ratio + 0.5).astype(np.int64)
        elif what == "hospitalization_period":
            ratio = (1 - rb) if sev == C.SEVERE else (
                rw if sev >= C.CRITICAL else 0.0)
            out = np.floor(o2r * ratio + 0.5).astype(np.int64)
        else:   # icu_period
            ratio = (1 - rw - rb) if sev >= C.CRITICAL else 0.0
            out = np.floor(o2r * ratio + 0.5).astype(np.int64)

    cats, counts = np.unique(out, return_counts=True)
    if what == "symptom_severity":
        cats = np.array([C.SEVERITY_TO_STR[int(c)] for c in cats])
    return cats, counts
