"""The benchmark reference's frozen copy of reina_tpu_torch/data/mobility.py.

Data-driven intervention generators (reference: calc/datasets.py:176-275).

The reference turns the Google COVID-19 Community Mobility ZIP into
weekly ``limit-mobility`` interventions and THL vaccination CSVs into
``vaccinate`` interventions. Those sources are refreshed by an online
ETL at container start; in this offline environment the generated
archive may be absent, in which case both generators return an empty
list and the variable-defined calendar stands alone.

Archive format (produced by an external ETL into data/files/derived_ivs.npz):
  json_blob: a JSON object {area_name: [iv_tuple, ...]} for each kind.
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import List, Optional

import numpy as np

from .loaders import FILES_DIR
from ..config.variables import get_variable

DERIVED_PATH = os.path.join(FILES_DIR, "derived_ivs.npz")


@lru_cache(maxsize=None)
def _derived() -> dict:
    if not os.path.exists(DERIVED_PATH):
        return {}
    z = np.load(DERIVED_PATH, allow_pickle=False)
    return json.loads(str(z["json_blob"]))


def update_derived(update: dict, path: str = DERIVED_PATH) -> dict:
    """Merge ``update`` ({kind: {area: payload}}) into the derived
    archive, rewrite it, and invalidate the in-process cache — the one
    write path every ETL importer shares, so a long-lived server starts
    serving refreshed calendars without a restart."""
    derived: dict = {}
    if os.path.exists(path):
        z = np.load(path, allow_pickle=False)
        derived = json.loads(str(z["json_blob"]))
    for kind, areas in update.items():
        derived.setdefault(kind, {}).update(areas)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, json_blob=np.array(json.dumps(derived)))
    _derived.cache_clear()
    return derived


def generate_mobility_ivs(variables: Optional[dict] = None) -> List[list]:
    """Weekly Google-mobility derived ``limit-mobility`` interventions."""
    area = (variables or {}).get("area_name") or get_variable("area_name")
    return _derived().get("mobility", {}).get(area, [])


def generate_vaccination_ivs(variables: Optional[dict] = None) -> List[list]:
    """THL vaccination-data derived ``vaccinate`` interventions."""
    area = (variables or {}).get("area_name") or get_variable("area_name")
    return _derived().get("vaccinations", {}).get(area, [])


def get_mobility_series(area: str) -> Optional[dict]:
    """Raw daily Google-mobility percent-change series for the area:
    {"dates": [...], "values": {category: [v|None, ...]}}; None when the
    derived archive is absent or lacks the area."""
    return _derived().get("mobility_raw", {}).get(area)
