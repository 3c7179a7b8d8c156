"""Output-metric registry (reference: common/metrics.py): ids, labels,
units, colors and typing flags consumed by the APIs and UIs (a copy of
reina_tpu/config/metrics.py; tests/test_torch_config.py holds the two
equal)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..utils.locale import gettext as _


@dataclass
class Metric:
    id: str
    label: str
    description: Optional[str] = None
    unit: Optional[str] = None
    color: Optional[str] = None
    is_integer: bool = False
    is_simulated: bool = True
    is_categorized: bool = False


METRICS = [
    Metric("susceptible", _("Susceptible"), None, _("residents"),
           color="yellow", is_integer=True),
    Metric("vaccinated", _("Vaccinated"), None, _("residents"),
           color="#78C091", is_integer=True, is_categorized=True),
    Metric("infected", _("Active infections"), None, _("residents"),
           "purple", is_integer=True),
    Metric("all_infected", _("Total infections (cum.)"), None, _("residents"),
           None, is_integer=True),
    Metric("new_infections", _("New daily infections (14 day avg.)"), None,
           _("infections"), "purple", is_integer=True),
    Metric("detected", _("Detected cases (14 day avg.)"), None, _("cases"),
           "teal", is_integer=True),
    Metric("all_detected", _("Detected cases"), None, _("cases (cum.)"),
           "teal", is_integer=True),
    Metric("in_ward", _("In hospital ward"), None, _("beds in use"),
           "orange", is_integer=True),
    Metric("in_icu", _("In ICU"), None, _("ICU units in use"),
           "red", is_integer=True),
    Metric("dead", _("Dead"), None, _("deaths (cum.)"),
           "indigo", is_integer=True),
    Metric("recovered", _("Recovered"), None, _("residents"),
           "#84b082", is_integer=True),
    Metric("available_hospital_beds", _("Available hospital beds"), None,
           _("beds"), is_integer=True),
    Metric("available_icu_units", _("Available ICU units"), None,
           _("ICU units"), is_integer=True),
    Metric("r", _("Reproductive number (Rₜ)")),
    Metric("ifr", _("Infection fatality ratio (IFR)"), unit="%"),
    Metric("cfr", _("Case fatality ratio (CFR)"), unit="%"),
    # additive vs the reference's metric list: inputs of the Dash
    # indicator cards (components/results.py:334-358), exposed so API
    # clients can derive the Restriction Day Index and ICU-capacity
    # exhaustion without a second data path
    Metric("mobility_limitation", _("Limit population mobility"), None, None),
    Metric("total_icu_units", _("ICU units"), None, _("ICU units"),
           is_integer=True),
    # per-variant daily infections (reference main.pyx:1847-1850 exposes
    # infected_by_variant keyed by variant name in every state dict);
    # categories = variant names, from the infected_by_variant_* columns
    Metric("infected_by_variant", _("New infections by variant"), None,
           _("infections"), is_integer=True, is_categorized=True),
]

# Google-mobility overlay metrics (reference common/mobility.py)
MOBILITY_PLACES = {
    "retail_and_recreation": {"name": _("Retail and recreation")},
    "grocery_and_pharmacy": {"name": _("Grocery and pharmacy")},
    "parks": {"name": _("Parks")},
    "transit_stations": {"name": _("Transit stations")},
    "workplaces": {"name": _("Workplaces")},
    "residential": {"name": _("Residential")},
}

MOBILITY_METRICS = [
    Metric("%s_mobility_change" % p_id, p["name"],
           description=_("Change in mobility compared to baseline"),
           unit="%", is_integer=True)
    for p_id, p in MOBILITY_PLACES.items()
]

ALL_METRICS = METRICS + MOBILITY_METRICS


def get_metric(metric_id: str) -> Optional[Metric]:
    for m in ALL_METRICS:
        if m.id == metric_id:
            return m
    return None
