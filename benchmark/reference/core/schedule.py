"""The benchmark reference's frozen copy of reina_tpu_torch/core/schedule.py.

Intervention compiler: dated interventions → dense per-day schedules.

The reference dispatches intervention objects against engine state at
runtime (Context.apply_intervention, main.pyx:1880-1960) and lazily
regenerates contact tables when mobility changes (main.pyx:1285-1288).
Here the full calendar is *compiled* before the run: every intervention
type becomes a row in a (days × …) array, so the scanned day step only
gathers ``schedule[day]`` and no Python branching remains in the loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from datetime import date
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from . import constants as C
from ..config.interventions import Intervention


class Schedules(NamedTuple):
    """Per-day compiled intervention state. All leading axes = days."""
    mobility: np.ndarray         # (D, A, P) float32 — contact multipliers
    mobility_scalar: np.ndarray  # (D,) float32 — last-set factor (UI metric)
    mask_p: np.ndarray           # (D, A, P) float32 — share of masked contacts
    testing_mode: np.ndarray     # (D,) int32
    trace_p: np.ndarray          # (D,) float32 — contact-tracing success p
    detect_anyway_p: np.ndarray  # (D,) float32 — mild-case detection p
    beds_build: np.ndarray       # (D,) int32 — new beds coming online
    icu_build: np.ndarray        # (D,) int32
    import_today: np.ndarray     # (D, V) int32 — one-shot imports
    weekly_amount: np.ndarray    # (D,) float32 — weekly import level
    weekly_shares: np.ndarray    # (D, V) float32 — per-variant shares
    vacc_nr: np.ndarray          # (D, S) float32 — daily vaccinations per slot


@dataclass
class VaccinationSlots:
    """Static campaign definitions: one slot per distinct age window."""
    min_age: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int32))
    max_age: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int32))
    count: int = 0


def _day_index(date_str: str, start: date) -> int:
    return (date.fromisoformat(date_str) - start).days


def compile_schedules(
        interventions: List[Intervention],
        start_date: str,
        days: int,
        nr_ages: int,
        variant_names: List[str],
) -> Tuple[Schedules, VaccinationSlots]:
    start = date.fromisoformat(start_date)
    A, P, V = nr_ages, C.NR_PLACES, len(variant_names)

    # Group interventions by day; out-of-window ones never fire (the
    # reference matches dates exactly, main.pyx:2012-2015).
    by_day: Dict[int, List[Intervention]] = {}
    for iv in interventions:
        d = _day_index(iv.date, start)
        if 0 <= d < days:
            by_day.setdefault(d, []).append(iv)

    # Persistent replayed state
    mobility_factors: Dict[Tuple[int, int, int], float] = {}
    mobility_scalar = 1.0
    mask_state = np.zeros((A, P), dtype=np.float32)
    testing_mode = C.TESTING_NO_TESTING
    trace_p = 1.0
    detect_anyway_p = 0.0
    weekly_amount = 0.0
    weekly_shares = np.zeros(V, dtype=np.float32)
    weekly_shares[0] = 1.0

    # Vaccination slots: one per distinct RAW (min_age, max_age) pair.
    # The reference keys campaigns on the raw values including None
    # (start_vaccinating, main.pyx:585-593) and normalizes only at
    # execution (main.pyx:551-556) — so an age-less campaign and an
    # explicit (0, max) campaign run CONCURRENTLY, they don't merge.
    slot_keys: List[Tuple[Optional[int], Optional[int]]] = []
    slot_nr: Dict[Tuple[Optional[int], Optional[int]], float] = {}
    for iv in interventions:
        if iv.type == "vaccinate":
            p = iv.get_param_values()
            key = (p.get("min_age"), p.get("max_age"))
            if key not in slot_keys:
                slot_keys.append(key)
    S = max(len(slot_keys), 1)

    out = Schedules(
        mobility=np.ones((days, A, P), dtype=np.float32),
        mobility_scalar=np.ones(days, dtype=np.float32),
        mask_p=np.zeros((days, A, P), dtype=np.float32),
        testing_mode=np.zeros(days, dtype=np.int32),
        trace_p=np.ones(days, dtype=np.float32),
        detect_anyway_p=np.zeros(days, dtype=np.float32),
        beds_build=np.zeros(days, dtype=np.int32),
        icu_build=np.zeros(days, dtype=np.int32),
        import_today=np.zeros((days, V), dtype=np.int32),
        weekly_amount=np.zeros(days, dtype=np.float32),
        weekly_shares=np.zeros((days, V), dtype=np.float32),
        vacc_nr=np.zeros((days, S), dtype=np.float32),
    )

    def variant_idx(name: Optional[str]) -> int:
        if name is None:
            return 0
        return variant_names.index(name)

    for d in range(days):
        for iv in by_day.get(d, []):
            p = iv.get_param_values()
            t = iv.type
            if t == "test-all-with-symptoms":
                testing_mode = C.TESTING_ALL_WITH_SYMPTOMS
            elif t == "test-only-severe-symptoms":
                testing_mode = C.TESTING_ONLY_SEVERE_SYMPTOMS
                detect_anyway_p = (p["mild_detection_rate"] or 0) / 100.0
            elif t == "test-with-contact-tracing":
                testing_mode = C.TESTING_ALL_WITH_SYMPTOMS_CT
                trace_p = (p["efficiency"] or 0) / 100.0
            elif t == "build-new-icu-units":
                out.icu_build[d] += p["units"]
            elif t == "build-new-hospital-beds":
                out.beds_build[d] += p["beds"]
            elif t == "import-infections":
                out.import_today[d, variant_idx(p.get("variant"))] += p["amount"]
            elif t == "import-infections-weekly":
                weekly_amount = float(p["weekly_amount"])
                shares = np.zeros(V, dtype=np.float32)
                for pn, val in p.items():
                    if pn.startswith("variant_") and val:
                        shares[variant_idx(pn[len("variant_"):])] = val / 100.0
                if shares[1:].sum() > 1.0 + 1e-6:
                    raise ValueError(
                        "import-infections-weekly variant shares sum to "
                        f"{shares[1:].sum() * 100:.0f}% > 100% on {iv.date}")
                shares[0] = 1.0 - shares[1:].sum()
                weekly_shares = shares
            elif t == "limit-mobility":
                factor = (100 - p["reduction"]) / 100.0
                place = p.get("place")
                key = (C.PLACE_TO_IDX[place] if place is not None else C.PLACE_ALL,
                       p.get("min_age") if p.get("min_age") is not None else 0,
                       p.get("max_age") if p.get("max_age") is not None else A - 1)
                mobility_factors[key] = factor
                # The reference records the *last set* factor as the
                # headline mobility metric regardless of scope
                # (main.pyx:1251, 1842).
                mobility_scalar = factor
            elif t == "wear-masks":
                share = p["share_of_contacts"] / 100.0
                mn = p.get("min_age") if p.get("min_age") is not None else 0
                mx = p.get("max_age") if p.get("max_age") is not None else A - 1
                place = p.get("place")
                cols = ([C.PLACE_TO_IDX[place]] if place is not None
                        else list(range(P)))
                mask_state[mn:mx + 1, cols] = share
            elif t == "vaccinate":
                # Daily count truncates weekly/7 (reference
                # main.pyx:557,1954: int cast of weekly/7)
                slot_nr[(p.get("min_age"), p.get("max_age"))] = \
                    p["weekly_vaccinations"] / 7.0
            else:
                raise ValueError(f"unknown intervention type: {t}")

        mob = np.ones((A, P), dtype=np.float32)
        for (place, mn, mx), factor in mobility_factors.items():
            if factor == 1.0:
                continue
            cols = slice(None) if place == C.PLACE_ALL else [place]
            mob[mn:mx + 1, cols] *= factor
        out.mobility[d] = mob
        out.mobility_scalar[d] = mobility_scalar
        out.mask_p[d] = mask_state
        out.testing_mode[d] = testing_mode
        out.trace_p[d] = trace_p
        out.detect_anyway_p[d] = detect_anyway_p
        out.weekly_amount[d] = weekly_amount
        out.weekly_shares[d] = weekly_shares
        for key, nr in slot_nr.items():
            out.vacc_nr[d, slot_keys.index(key)] = nr

    # normalize None bounds only here, as the reference does at
    # execution time (main.pyx:551-556)
    slots = VaccinationSlots(
        min_age=np.array([k[0] if k[0] is not None else 0
                          for k in slot_keys] or [0], dtype=np.int32),
        max_age=np.array([k[1] if k[1] is not None else A - 1
                          for k in slot_keys] or [0], dtype=np.int32),
        count=len(slot_keys),
    )
    return out, slots
