"""The benchmark reference's frozen copy of reina_tpu_torch/data/loaders.py.

Dataset loaders (reference: calc/datasets.py).

All loaders read the compact ``.npz`` archives produced by
the JAX package's ``reina_tpu.data.etl`` — no network and no raw upstream files at
runtime. Functions mirror the reference API shapes so the driver layer
stays recognizable to reference users.
"""
from __future__ import annotations

import csv
import io
import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

FILES_DIR = os.path.join(os.path.dirname(__file__), "files")

MAX_AGE = 100
PLACES = ("home", "work", "school", "transport", "leisure", "other")


class DatasetMissing(RuntimeError):
    pass


def _load(name: str):
    path = os.path.join(FILES_DIR, name)
    if not os.path.exists(path):
        raise DatasetMissing(
            f"{path} not found — run `python -m reina_tpu.data.etl` and copy it here")
    return np.load(path, allow_pickle=False)


@lru_cache(maxsize=None)
def _population():
    z = _load("population.npz")
    return {
        "munis": [str(x) for x in z["munis"]],
        "pop": z["pop"],  # (M, 101, 2) male/female
        "district": {
            str(m): str(d)
            for m, d in zip(z["district_muni"], z["district_name"])
        },
    }


def get_population_for_area(area_name: str) -> np.ndarray:
    """Age structure for a municipality or healthcare district.

    Returns int64 array of length 101 (residents per 1-year age group).
    Mirrors reference calc/datasets.py:48-61: if ``area_name`` is not a
    municipality it is treated as a healthcare-district name and member
    municipalities are summed.
    """
    p = _population()
    pop_total = p["pop"].sum(axis=2)  # (M, 101)
    if area_name in p["munis"]:
        return pop_total[p["munis"].index(area_name)].astype(np.int64)
    members = [m for m, d in p["district"].items() if d == area_name]
    idx = [p["munis"].index(m) for m in members if m in p["munis"]]
    if not idx:
        raise KeyError(f"unknown area: {area_name!r}")
    return pop_total[idx].sum(axis=0).astype(np.int64)


@dataclass(frozen=True)
class ContactTensor:
    """POLYMOD daily contacts: values[place, participant_band, contact_band]."""
    values: np.ndarray          # (P, B, B) float64
    band_lo: np.ndarray         # (B,) int32
    band_hi: np.ndarray         # (B,) int32  (last band extends to MAX_AGE)
    places: tuple = PLACES

    @property
    def nr_bands(self) -> int:
        return len(self.band_lo)

    def band_of_age(self, max_age: int = MAX_AGE) -> np.ndarray:
        """(max_age+1,) → band index per 1-year age."""
        out = np.zeros(max_age + 1, dtype=np.int32)
        for b, (lo, hi) in enumerate(zip(self.band_lo, self.band_hi)):
            out[lo:min(hi, max_age) + 1] = b
        out[self.band_hi[-1]:] = self.nr_bands - 1
        return out

    def per_year_participant(self, max_age: int = MAX_AGE) -> np.ndarray:
        """Expand participant bands to 1-year ages: (A, P, B) contacts.

        Mirrors reference calc/simulation.py:75-100 (get_contacts_per_day):
        each 1-year participant age inherits its band's row unchanged.
        """
        boa = self.band_of_age(max_age)
        # values is (P, B, B) → (A, P, B)
        return np.ascontiguousarray(self.values[:, boa, :].transpose(1, 0, 2))


@lru_cache(maxsize=None)
def get_contact_tensor() -> ContactTensor:
    z = _load("contacts.npz")
    return ContactTensor(
        values=z["values"], band_lo=z["band_lo"], band_hi=z["band_hi"])


@lru_cache(maxsize=None)
def _cases():
    z = np.load(os.path.join(FILES_DIR, "cases.npz"), allow_pickle=False)
    out = {}
    for area, blob in zip(z["areas"], z["csv_blobs"]):
        rows = list(csv.DictReader(io.StringIO(str(blob))))
        out[str(area)] = rows
    return out


def get_detected_cases(area_name: str):
    """Observed series for an area: list of dict rows with keys
    date, dead, in_icu, in_ward, hospitalized, confirmed.
    (reference calc/datasets.py:89-103; 'confirmed' ≙ all_detected)
    """
    path = os.path.join(FILES_DIR, "cases.npz")
    if not os.path.exists(path):
        raise DatasetMissing(f"{path} not found — run the data ETL first")
    cases = _cases()
    if area_name not in cases:
        raise KeyError(f"no case data for area {area_name!r}")
    return cases[area_name]


@dataclass
class InitialPopulationCondition:
    """Epidemic state at simulation start (reference calc/datasets.py:106-135)."""
    dead: int = 0
    in_icu: int = 0
    in_ward: int = 0
    confirmed_cases: int = 0
    infected_cases: int = 0
    incubating: int = 0
    ill: int = 0
    recovered: int = 0

    def has_initial_state(self) -> bool:
        return bool(self.dead or self.in_icu or self.in_ward
                    or self.confirmed_cases or self.infected_cases
                    or self.incubating or self.ill or self.recovered)

    def were_incubating(self) -> int:
        return (self.dead + self.recovered + self.in_icu + self.in_ward
                + self.ill + self.incubating)

    def were_ill(self) -> int:
        return self.dead + self.recovered + self.in_icu + self.in_ward + self.ill

    def recovered_without_illness(self) -> int:
        return self.were_incubating() - self.were_ill()


def get_initial_population_condition(
        area_name: str, start_date: str,
        incubating: int = 0, ill: int = 0, recovered: int = 0,
) -> InitialPopulationCondition:
    """Initial condition from the area casefile at start_date
    (reference calc/datasets.py:138-173); zeros when the date is absent."""
    try:
        rows = get_detected_cases(area_name)
    except (DatasetMissing, KeyError):
        # no casefile (e.g. synthetic areas): the variable-driven seed
        # counts still apply (reference calc/simulation.py:163-167)
        return InitialPopulationCondition(
            incubating=incubating, ill=ill, recovered=recovered)
    for r in rows:
        if r["date"] == start_date:
            return InitialPopulationCondition(
                dead=int(r["dead"]), in_icu=int(r["in_icu"]),
                in_ward=int(r["in_ward"]),
                confirmed_cases=int(r["confirmed"]),
                incubating=incubating, ill=ill, recovered=recovered)
    return InitialPopulationCondition(
        incubating=incubating, ill=ill, recovered=recovered)
