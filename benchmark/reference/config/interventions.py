"""The benchmark reference's frozen copy of reina_tpu_torch/config/interventions.py.

Typed intervention registry and tuple codec (reference: common/interventions.py).

Interventions are serialized as ``[type, date, *params]`` tuples — the
same wire format the reference uses in variables, the GraphQL API and
scenario presets — and validated against per-type parameter specs.
The engine itself never sees these objects: the schedule compiler
(reina_tpu_torch.core.schedule) turns the active intervention list into dense
per-day parameter arrays before the simulation starts.
"""
from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from enum import Enum

from .variables import get_variable


def _(s: str) -> str:
    """Labels as written: the reference needs no translations."""
    return s


class ContactPlace(Enum):
    HOME = 1
    WORK = 2
    SCHOOL = 3
    TRANSPORT = 4
    LEISURE = 5
    OTHER = 6

    def label(self) -> str:
        return _(self.name.capitalize())


@dataclass
class Parameter:
    id: str
    label: str
    required: bool = True


@dataclass
class IntParameter(Parameter):
    min_value: typing.Optional[int] = None
    max_value: typing.Optional[int] = None
    unit: typing.Optional[str] = None


@dataclass
class Choice:
    id: str
    label: str


@dataclass
class ChoiceParameter(Parameter):
    choices: typing.Optional[typing.List[Choice]] = None


@dataclass
class Intervention:
    type: str
    label: str
    parameters: typing.List[Parameter] = field(default_factory=list)
    values: typing.Dict[str, typing.Union[int, Choice, None]] = field(default_factory=dict)
    date: typing.Optional[str] = None
    id: typing.Optional[str] = None

    def make_from_iv_tuple(self, iv: list) -> "Intervention":
        values: dict = {}
        date = iv[1]
        rest = list(iv)[2:]
        for p in self.parameters:
            if not rest:
                break
            val = rest.pop(0)
            if val is None:
                continue
            if isinstance(p, IntParameter):
                if not isinstance(val, int):
                    raise TypeError(f"{self.type}.{p.id} expects int, got {val!r}")
            elif isinstance(p, ChoiceParameter):
                for c in p.choices or []:
                    if val == c.id:
                        val = c
                        break
                else:
                    raise ValueError(f"invalid choice for {self.type}.{p.id}: {val!r}")
            values[p.id] = val
        obj = dataclasses.replace(self, values=values)
        obj.date = date
        return obj

    def get_param_values(self) -> dict:
        out = {}
        for p in self.parameters:
            val = self.values.get(p.id)
            if isinstance(p, ChoiceParameter):
                if not val:
                    continue
                val = val.id
            out[p.id] = val
        return out

    def copy(self) -> "Intervention":
        return dataclasses.replace(self, values=dict(self.values))

    def set_param(self, param_id: str, val) -> None:
        for p in self.parameters:
            if p.id == param_id:
                break
        else:
            raise KeyError(f"invalid parameter id: {param_id}")
        if isinstance(p, IntParameter):
            if val is not None and not isinstance(val, int):
                raise TypeError(f"{param_id} requires int")
            self.values[p.id] = val
        elif isinstance(p, ChoiceParameter):
            if val is not None:
                for c in p.choices or []:
                    if val == c.id:
                        val = c
                        break
                else:
                    raise ValueError(f"invalid choice for {param_id}: {val!r}")
            self.values[p.id] = val

    def make_iv_tuple(self) -> list:
        params = []
        for p in self.parameters:
            val = self.values.get(p.id)
            if isinstance(p, ChoiceParameter):
                val = val.id if val else None
            params.append(val)
        return [self.type, self.date, *params]


def _place_choices() -> typing.List[Choice]:
    return [Choice(x.name.lower(), x.label()) for x in ContactPlace]


def _age_params(what: str) -> typing.List[Parameter]:
    return [
        IntParameter(id="min_age", label=_(f"Minimum age for {what}"),
                     min_value=0, max_value=100, unit=_("years"), required=False),
        IntParameter(id="max_age", label=_(f"Maximum age for {what}"),
                     min_value=0, max_value=100, unit=_("years"), required=False),
    ]


def _variants() -> typing.List[typing.Tuple[str, str]]:
    return [(x["name"], x["name"]) for x in get_variable("variants")]


def build_registry() -> typing.List[Intervention]:
    """All 11 intervention types of the reference (common/interventions.py:159-323)."""
    variants = _variants()
    return [
        Intervention("test-all-with-symptoms", _("Test all patients with symptoms")),
        Intervention(
            "test-only-severe-symptoms",
            _("Test people only with severe symptoms"),
            parameters=[IntParameter(
                id="mild_detection_rate",
                label=_("Percentage of mild cases that are detected"),
                min_value=0, max_value=100, unit="%")],
        ),
        Intervention(
            "test-with-contact-tracing",
            _("Test all with symptoms and perform contact tracing"),
            parameters=[IntParameter(
                id="efficiency",
                label=_("Percentage of infectors that are caught through contact tracing"),
                min_value=0, max_value=100, unit="%")],
        ),
        Intervention(
            "limit-mobility",
            _("Limit population mobility"),
            parameters=[
                IntParameter(id="reduction", label=_("Reduction in contacts"),
                             min_value=0, max_value=100, unit="%"),
                *_age_params("limitation"),
                ChoiceParameter(id="place",
                                label=_("Place where the contacts happen"),
                                choices=_place_choices(), required=False),
            ],
        ),
        Intervention(
            "wear-masks",
            _("People wear masks"),
            parameters=[
                IntParameter(id="share_of_contacts",
                             label=_("Portion of daily contacts where masks are in use"),
                             min_value=0, max_value=100, unit="%"),
                *_age_params("intervention"),
                ChoiceParameter(id="place",
                                label=_("Place where intervention happens"),
                                choices=_place_choices(), required=False),
            ],
        ),
        Intervention(
            "vaccinate",
            _("Vaccinate people against disease"),
            parameters=[
                IntParameter(id="weekly_vaccinations",
                             label=_("Number of people vaccinated weekly"),
                             min_value=0, unit=_("persons/week")),
                *_age_params("intervention"),
            ],
        ),
        Intervention(
            "import-infections",
            _("Import infections from outside the area"),
            parameters=[
                IntParameter(id="amount", label=_("Amount of new infections"),
                             unit=_("infections")),
                ChoiceParameter(id="variant", label=_("Variant of the disease"),
                                choices=[Choice(v, lbl) for v, lbl in variants],
                                required=False),
            ],
        ),
        Intervention(
            "import-infections-weekly",
            _("Import infections from outside the area every week"),
            parameters=[
                IntParameter(id="weekly_amount",
                             label=_("Amount of new weekly infections"),
                             unit=_("infections/week")),
                *[IntParameter(id=f"variant_{vid}",
                               label=_(f"Share of variant {vlabel}"),
                               unit="%", required=False)
                  for vid, vlabel in variants],
            ],
        ),
        Intervention(
            "build-new-hospital-beds",
            _("Build new hospital beds"),
            parameters=[IntParameter(id="beds", label=_("Number of new beds built"),
                                     unit=_("beds"))],
        ),
        Intervention(
            "build-new-icu-units",
            _("Build new ICU units"),
            parameters=[IntParameter(id="units", label=_("Number of new ICU units built"),
                                     unit=_("ICU units"))],
        ),
    ]


INTERVENTIONS = build_registry()


def get_intervention(iv_type: str) -> Intervention:
    for obj in INTERVENTIONS:
        if obj.type == iv_type:
            return obj
    raise KeyError(f"invalid intervention type: {iv_type}")


def iv_tuple_to_obj(iv: list) -> Intervention:
    return get_intervention(iv[0]).make_from_iv_tuple(iv)


def get_active_interventions(variables: typing.Optional[dict] = None) -> typing.List[Intervention]:
    """Resolved intervention list for a run: the variable calendar plus
    the active scenario's additions (reference common/interventions.py:342-376).

    The reference also appends Google-mobility and THL-vaccination
    derived interventions here; those datasets are fetched by an online
    ETL at deploy time, so we append them only when the generated
    archives exist (see reina_tpu_torch.data.mobility)."""
    if variables is not None:
        scenarios = variables["scenarios"]
        active_scenario = variables["active_scenario"]
        interventions = variables["interventions"]
    else:
        scenarios = get_variable("scenarios")
        active_scenario = get_variable("active_scenario")
        interventions = get_variable("interventions")

    out = []
    for idx, iv in enumerate(interventions):
        obj = iv_tuple_to_obj(iv)
        obj.id = str(idx)
        out.append(obj)

    # data-derived calendar (Google mobility + THL vaccinations); the
    # reference folds these in unconditionally (common/interventions.py:
    # 342-376). A malformed archive is reported, not hidden — only the
    # derived events are dropped so preset scenarios keep working.
    try:
        from ..data.mobility import generate_mobility_ivs, generate_vaccination_ivs
        for iv in generate_mobility_ivs(variables):
            out.append(iv_tuple_to_obj(iv))
        for iv in generate_vaccination_ivs(variables):
            out.append(iv_tuple_to_obj(iv))
    except Exception:
        import logging
        logging.getLogger(__name__).warning(
            "failed to load derived interventions (derived_ivs.npz); "
            "continuing without them", exc_info=True)

    if active_scenario:
        for s in scenarios:
            if s["id"] == active_scenario:
                break
        else:
            raise ValueError(f"invalid active scenario: {active_scenario}")
        for iv in s.get("add_interventions", []):
            out.append(iv_tuple_to_obj(iv))

    return out
