"""The REINA GraphQL schema (port of reina_tpu/runtime/graphql/schema.py;
reference: graphql_schema.py) — identical queries/mutations so the
reina-ui frontend keeps working:

  Query: availableEvents, activeEvents, simulationResults(runId),
         validationMetrics, mobilityChangeMetrics, area, scenarios
  Mutation: runSimulation(randomSeed), addEvent(event),
            deleteEvent(eventId), resetVariables,
            activateScenario(scenarioId)

Additive extensions covering the reference's Dash parameter explorer
(components/params.py:144-298 — disease-parameter table and the
"Distributions" panel), which the reference exposed only through Dash:

  Query: diseaseParameters, sampleDistribution(what, age, severity,
         limitMobility)
  Mutation: setParameter(parameterId, value), resetParameters

The per-request variable store rides in ``info.context['store']``
(the analog of the reference's Flask session), and the device that runs
simulations and explorer draws in ``info.context['device']`` (``cuda``
when absent). Results arrive from the workers as numpy columns and an
``AgeGroupCube`` (runner.py); ``results_to_metrics`` computes the
JAX package's pandas post-processing on them in numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from datetime import date, timedelta
from typing import Any, Dict, List, Optional

import numpy as np

from .engine import GraphQLError
from .. import cache
from ..runner import REGISTRY, BusyError
from ...config.interventions import (ChoiceParameter, IntParameter,
                                     INTERVENTIONS, get_active_interventions,
                                     get_intervention)
from ...config.metrics import METRICS, get_metric
from ...config.variables import VARIABLE_DEFAULTS, VariableStore
from ...data import loaders
from ...utils.locale import gettext as _


# --- typed result objects ---------------------------------------------------

@dataclass
class Choice:
    id: str
    label: str


@dataclass
class EventIntParameter:
    id: str
    description: str
    required: bool
    min_value: Optional[int] = None
    max_value: Optional[int] = None
    unit: Optional[str] = None
    value: Optional[int] = None
    graphql_interfaces = ("EventParameter",)


@dataclass
class EventChoiceParameter:
    id: str
    description: str
    required: bool
    choices: List[Choice] = field(default_factory=list)
    choice: Optional[Choice] = None
    graphql_interfaces = ("EventParameter",)


@dataclass
class Event:
    id: Optional[str]
    date: Optional[str]
    description: str
    type: str
    parameters: List[Any]
    modifiable: bool = False
    modified_by_user: bool = False


@dataclass
class CategorizedIntValues:
    categories: List[str]
    values: List[List[Optional[int]]]


@dataclass
class Metric:
    type: str
    label: str
    description: Optional[str] = None
    unit: Optional[str] = None
    color: Optional[str] = None
    is_integer: bool = False
    is_simulated: bool = True
    is_categorized: bool = False
    int_values: Optional[List[Optional[int]]] = None
    float_values: Optional[List[Optional[float]]] = None
    categorized_int_values: Optional[CategorizedIntValues] = None


@dataclass
class DailyMetrics:
    dates: List[str]
    metrics: List[Metric]


@dataclass
class ScenarioObj:
    id: str
    label: str
    description: Optional[str]
    active: bool
    graphql_typename = "Scenario"


@dataclass
class SimulationResults:
    run_id: str
    finished: bool
    predicted_metrics: DailyMetrics
    end_date: Optional[str] = None
    # "compiling" | "running" | "finished" (additive vs the reference:
    # until its first partial result a run sits in build_run and the
    # first kernel build; the client's 0.5 s poll needs something to
    # show)
    phase: str = "running"


@dataclass
class PopulationAgeGroup:
    label: str
    count: int


@dataclass
class SimulationArea:
    name: str
    name_long: str
    total_population: int
    age_groups: List[PopulationAgeGroup]


def iv_to_graphql_obj(iv, obj_id=None) -> Event:
    """reference graphql_schema.py:116-165."""
    params: List[Any] = []
    for p in iv.parameters:
        # labels are stored as source-language strings and translated at
        # resolve time against the request's active locale
        if isinstance(p, IntParameter):
            params.append(EventIntParameter(
                id=p.id, description=_(p.label), required=p.required,
                min_value=p.min_value, max_value=p.max_value,
                unit=_(p.unit) if p.unit else p.unit,
                value=iv.values.get(p.id)))
        elif isinstance(p, ChoiceParameter):
            c = iv.values.get(p.id)
            params.append(EventChoiceParameter(
                id=p.id, description=_(p.label), required=p.required,
                choices=[Choice(c2.id, _(c2.label))
                         for c2 in (p.choices or [])],
                choice=Choice(c.id, _(c.label)) if c else None))
        else:
            raise GraphQLError("Unknown parameter type")
    modifiable = False
    if iv.id:
        obj_id = iv.id
        modifiable = True
    elif obj_id is not None:
        obj_id = "N%d" % obj_id
    return Event(id=obj_id, type=iv.type, description=_(iv.label),
                 date=getattr(iv, "date", None), modifiable=modifiable,
                 parameters=params)


def _opt_int_list(series) -> List[Optional[int]]:
    out = []
    for v in series:
        if v is None or (isinstance(v, float) and np.isnan(v)) or v is getattr(np, "nan", None):
            out.append(None)
        else:
            try:
                if np.isnan(v):
                    out.append(None)
                    continue
            except TypeError:
                pass
            out.append(int(v))
    return out


def _opt_float_list(series) -> List[Optional[float]]:
    out = []
    for v in series:
        try:
            f = float(v)
        except (TypeError, ValueError):
            out.append(None)
            continue
        out.append(None if np.isnan(f) else f)
    return out


def _rolling_mean(x, window: int) -> np.ndarray:
    """pandas' ``Series.rolling(window).mean()`` in float64: NaN for the
    first ``window - 1`` rows. Each window is summed on its own, where
    pandas keeps a running sum, so the last bits may differ."""
    x = np.asarray(x, dtype=np.float64)
    out = np.full(len(x), np.nan)
    if len(x) >= window:
        out[window - 1:] = np.lib.stride_tricks.sliding_window_view(
            x, window).sum(axis=1) / window
    return out


def results_to_metrics(results, only=None):
    """IFR/CFR + rolling means post-processing
    (reference graphql_schema.py:168-233) on the published numpy
    columns: the JAX package's pandas version, column for column."""
    df = dict(results["total"])
    cube = results["age_groups"]
    dates = [str(x) for x in df["date"]]

    selected = METRICS if only is None else [get_metric(m) for m in only]

    # the reference's clip(lower=20).replace(20, inf): every count up
    # to 20 becomes an infinite denominator, so the ratio is 0
    MIN_CASES = 20
    denom_inf = np.where(df["all_infected"] <= MIN_CASES, np.inf,
                         df["all_infected"].astype(np.float64))
    denom_det = np.where(df["all_detected"] <= MIN_CASES, np.inf,
                         df["all_detected"].astype(np.float64))
    dead = df["dead"].astype(np.float64)
    df["ifr"] = _rolling_mean(dead / denom_inf * 100, 7)
    df["cfr"] = _rolling_mean(dead / denom_det * 100, 7)
    df["r"] = _rolling_mean(df["r"], 7)
    df["new_infections"] = np.round(_rolling_mean(df["new_infections"], 14))
    df["detected"] = np.round(_rolling_mean(df["detected"], 14))

    metrics = []
    for m in selected:
        int_values = float_values = categorized = None
        if m.is_categorized:
            # two category sources: the age-group cube (attrs like
            # "vaccinated"; the groups sorted as strings, as the
            # reference's unstack sorts them) and prefix columns in the
            # daily columns (e.g. infected_by_variant_<name> — variant
            # takeover, in column order)
            prefix = m.id + "_"
            pcols = [c for c in df if c.startswith(prefix)]
            if cube is not None and m.id in cube.attrs:
                order = sorted(range(len(cube.groups)),
                               key=lambda g: cube.groups[g])
                categories = [str(cube.groups[g]) for g in order]
                rows = cube.values[:, cube.attrs.index(m.id)][:, order]
            elif pcols:
                categories = [c[len(prefix):] for c in pcols]
                rows = np.stack([df[c] for c in pcols], axis=1)
            else:
                continue
            categorized = CategorizedIntValues(
                categories=categories,
                values=[_opt_int_list(row) for row in rows])
        else:
            if m.id not in df:
                raise GraphQLError("metric %s not found in dataset" % m.id)
            if m.is_integer:
                int_values = _opt_int_list(df[m.id])
            else:
                float_values = _opt_float_list(df[m.id])
        metrics.append(Metric(
            type=m.id, label=_(m.label), description=m.description, unit=_(m.unit) if m.unit else m.unit,
            color=m.color, is_integer=m.is_integer, is_simulated=m.is_simulated,
            is_categorized=m.is_categorized, int_values=int_values,
            float_values=float_values, categorized_int_values=categorized))
    return dates, metrics


def _store(info) -> VariableStore:
    return info.context["store"]


def _get(info, name):
    return _store(info).get(name)


def _device(info):
    return info.context.get("device", "cuda")


# --- Query resolvers ---------------------------------------------------------

def resolve_available_events(_root, _info):
    return [iv_to_graphql_obj(iv) for iv in INTERVENTIONS]


def resolve_active_events(_root, info):
    ivs = sorted(get_active_interventions(_store(info).copy_all()),
                 key=lambda x: x.date)
    return [iv_to_graphql_obj(iv, idx) for idx, iv in enumerate(ivs)]


def resolve_simulation_results(_root, info, run_id):
    finished = cache.get("%s-finished" % run_id)
    if finished is None:
        raise GraphQLError("No simulation run active")
    if finished:
        REGISTRY.reap(run_id)
    error = cache.get("%s-error" % run_id)
    if error is not None:
        raise GraphQLError("Simulation error: %s" % error)
    results = cache.get("%s-results" % run_id)
    if results is not None:
        dates, metrics = results_to_metrics(results)
    else:
        dates, metrics = [], []
    end = (date.fromisoformat(_get(info, "start_date"))
           + timedelta(days=_get(info, "simulation_days"))).isoformat()
    phase = cache.get("%s-phase" % run_id) or \
        ("finished" if finished else "running")
    return SimulationResults(
        run_id=run_id, finished=bool(finished), end_date=end, phase=phase,
        predicted_metrics=DailyMetrics(dates=dates, metrics=metrics))


def resolve_validation_metrics(_root, info):
    rows = loaders.get_detected_cases(_get(info, "area_name"))
    sim_start = date.fromisoformat(_get(info, "start_date"))
    sim_end = sim_start + timedelta(days=_get(info, "simulation_days"))
    rows = [r for r in rows if date.fromisoformat(r["date"]) < sim_end]
    dates = [r["date"] for r in rows]

    detected = np.array([float(r["confirmed"]) for r in rows])
    detected_diff = np.diff(detected, prepend=np.nan)
    roll = np.full(len(rows), np.nan)
    for i in range(13, len(rows)):
        w = detected_diff[i - 13:i + 1]
        roll[i] = np.nan if np.isnan(w).any() else np.round(w.mean())

    cols = {
        "dead": [int(r["dead"]) for r in rows],
        "in_icu": [int(r["in_icu"]) for r in rows],
        "in_ward": [int(r["in_ward"]) for r in rows],
        "all_detected": [int(r["confirmed"]) for r in rows],
        "detected": [None if np.isnan(v) else int(v) for v in roll],
    }
    metrics = []
    for col, values in cols.items():
        m = get_metric(col)
        if not m:
            raise GraphQLError("no metric found for %s" % col)
        metrics.append(Metric(
            type=m.id, label=_(m.label), description=m.description, unit=_(m.unit) if m.unit else m.unit,
            color=m.color, is_integer=m.is_integer, is_simulated=False,
            int_values=values))
    return DailyMetrics(dates=dates, metrics=metrics)


def resolve_mobility_change_metrics(_root, info):
    """7-day rolling means of the raw Google-mobility series
    (reference graphql_schema.py:322-347). Empty when the derived
    dataset is absent (the reference fetches it with an online ETL at
    deploy time)."""
    from ...data.mobility import get_mobility_series
    raw = get_mobility_series(_get(info, "area_name"))
    if not raw:
        return DailyMetrics(dates=[], metrics=[])
    dates = raw["dates"]
    metrics = []
    for cat, series in raw["values"].items():
        m = get_metric("%s_mobility_change" % cat)
        if m is None:
            continue
        vals = np.array([np.nan if v is None else float(v) for v in series])
        roll = np.full(len(vals), np.nan)
        for i in range(6, len(vals)):
            w = vals[i - 6:i + 1]
            if not np.isnan(w).any():
                roll[i] = np.round(w.mean())
        int_values = [None if np.isnan(v) else int(v) for v in roll]
        metrics.append(Metric(
            type=m.id, label=_(m.label), description=_(m.description),
            unit=m.unit, color=m.color, is_integer=True, is_simulated=False,
            int_values=int_values))
    # drop leading all-null rows like the reference's dropna(how="all")
    first = 0
    for i in range(len(dates)):
        if any(mm.int_values[i] is not None for mm in metrics):
            first = i
            break
    return DailyMetrics(
        dates=dates[first:],
        metrics=[Metric(
            type=mm.type, label=mm.label, description=mm.description,
            unit=mm.unit, color=mm.color, is_integer=True,
            is_simulated=False, int_values=mm.int_values[first:])
            for mm in metrics])


def resolve_area(_root, info):
    from ...core.params import make_age_groups
    name = _get(info, "area_name")
    counts = loaders.get_population_for_area(name)
    labels = make_age_groups(len(counts) - 1)
    group_names = sorted(set(labels))
    sums = {g: 0 for g in group_names}
    for age, c in enumerate(counts):
        sums[labels[age]] += int(c)
    return SimulationArea(
        name=name, name_long=_get(info, "area_name_long"),
        total_population=int(counts.sum()),
        age_groups=[PopulationAgeGroup(label=g, count=sums[g])
                    for g in group_names])


# Editable disease parameters (reference components/params.py:144-158;
# the reference row 'p_asymptomatic' reads a variable that does not
# exist upstream — dead row; we expose the live
# 'p_asymptomatic_infection' multiplier instead).
DISEASE_PARAM_DEFS = (
    ("p_asymptomatic_infection",
     "Relative infectiousness of asymptomatic cases", ""),
    ("p_hospital_death_no_beds",
     "Probability of dying if severe symptoms and no hospital beds are available", "%"),
    ("p_icu_death_no_beds",
     "Probability of dying if no ICU units are available", "%"),
    ("mean_incubation_duration", "Mean incubation period length", "days"),
    ("mean_duration_from_onset_to_recovery",
     "Mean duration from symptom onset to recovery", "days"),
    ("mean_duration_from_onset_to_death",
     "Mean duration from symptom onset to death", "days"),
    ("ratio_of_duration_before_hospitalisation",
     "Ratio of time before hospitalization", "%"),
    ("ratio_of_duration_in_ward",
     "Ratio of time in ward before ICU care", "%"),
    ("incubating_at_simulation_start",
     "People who are a- or presymptomatic at simulation start", ""),
    ("ill_at_simulation_start",
     "People who are ill with symptoms at simulation start", ""),
    ("recovered_at_simulation_start",
     "People who have recovered from infection at simulation start", ""),
)


@dataclass
class DiseaseParameter:
    id: str
    label: str
    value: float
    unit: str


@dataclass
class Distribution:
    what: str
    categories: List[str]
    counts: List[float]   # draw counts, or curve values for "infectiousness"


def resolve_disease_parameters(_root, info):
    store = _store(info)
    return [DiseaseParameter(id=pid, label=_(label),
                             value=float(store.get(pid)), unit=_(unit))
            for pid, label, unit in DISEASE_PARAM_DEFS]


def resolve_sample_distribution(_root, info, what, age=60, severity=None,
                                limit_mobility=0):
    from ...sampling import sample_distribution
    variables = _store(info).copy_all()
    variables["sample_limit_mobility"] = limit_mobility
    try:
        cats, counts = sample_distribution(what, int(age), severity,
                                           variables, _device(info))
    except ValueError as e:
        raise GraphQLError(str(e))
    return Distribution(
        what=what,
        categories=[str(c) for c in cats],
        counts=[float(v) for v in counts])


def resolve_scenarios(_root, info):
    store = _store(info)
    scenarios = store.get("scenarios")
    active_scenario = store.get("active_scenario")
    customized = _customized_overrides(store.overrides())
    out = []
    for s in scenarios:
        active = s["id"] == active_scenario and not customized
        out.append(ScenarioObj(id=s["id"], label=s["label"],
                               description=s.get("description"),
                               active=active))
    return out


# --- Mutations ----------------------------------------------------------------

def _customized_overrides(variables: Dict[str, Any]) -> List[str]:
    """Session overrides beyond the active-scenario marker — the shared
    definition of a 'customized session' (scenario active-flag and the
    preset-restriction gate must agree)."""
    return [k for k in variables if k != "active_scenario"]


def mutate_run_simulation(_root, info, random_seed=None):
    variables = _store(info).overrides()
    if random_seed is not None:
        variables["random_seed"] = random_seed
    # overload guard (reference corona.py:584-585): when the deployment
    # restricts to preset scenarios, refuse any non-preset run — custom
    # parameters, timeframe and explicit random seeds all change the
    # run key and would bypass the preset result cache
    from ...config import settings
    if settings.RESTRICT_TO_PRESET_SCENARIOS and _customized_overrides(variables):
        raise GraphQLError(
            "Service is restricted to preset scenarios right now; "
            "custom settings are temporarily disabled")
    try:
        run_id = REGISTRY.start_run(variables, _device(info))
    except BusyError as e:
        raise GraphQLError(str(e))
    return {"runId": run_id, "run_id": run_id}


def _event_type_value(raw: str) -> str:
    """EventType enum name (LIMIT_MOBILITY) → intervention type string
    (the reference builds the enum the same way, graphql_schema.py:20-22)."""
    raw = str(raw)
    if raw.isupper():
        return raw.lower().replace("_", "-")
    return raw


def mutate_add_event(_root, info, event):
    store = _store(info)
    iv_type = _event_type_value(event["type"])
    iv_list = list(store.get("interventions"))
    obj = get_intervention(iv_type).copy()
    obj.date = event["date"]
    for p in event.get("parameters", []):
        obj.set_param(p["id"], p.get("choice") or p.get("value"))
    iv_list.append(obj.make_iv_tuple())
    store.set("interventions", iv_list)
    return {"id": len(iv_list) - 1}


def _norm_iv_tuple(t):
    """Strip trailing Nones: make_iv_tuple pads omitted optional params
    with None, while stored defaults keep the short form — both spell
    the same intervention (the reference's exact-equality match at
    graphql_schema.py:456-463 cannot delete its own short-form
    defaults; normalizing fixes that bit-rot)."""
    t = list(t)
    while t and t[-1] is None:
        t.pop()
    return t


def mutate_delete_event(_root, info, event_id):
    store = _store(info)
    event_id = str(event_id)  # GraphQL ID may arrive as an int
    iv_objs = get_active_interventions(store.copy_all())
    for iv in iv_objs:
        if iv.id and event_id == iv.id:
            break
    else:
        raise GraphQLError("invalid intervention ID")
    iv_tuple = _norm_iv_tuple(iv.make_iv_tuple())
    iv_list = list(store.get("interventions"))
    for cand in iv_list:
        if _norm_iv_tuple(cand) == iv_tuple:
            iv_list.remove(cand)
            store.set("interventions", iv_list)
            return {"ok": True}
    raise GraphQLError("invalid intervention ID")


def mutate_reset_variables(_root, info):
    _store(info).reset()
    return {"ok": True}


def mutate_set_parameter(_root, info, parameter_id, value):
    """Write-through from the parameter-editor table (the reference's
    Dash callback writes edited rows back with set_variable,
    components/params.py:~260-290)."""
    ids = {pid for pid, _l, _u in DISEASE_PARAM_DEFS}
    if parameter_id not in ids:
        raise GraphQLError("unknown parameter: %s" % parameter_id)
    default = VARIABLE_DEFAULTS[parameter_id]
    store = _store(info)
    store.set(parameter_id,
              int(value) if isinstance(default, int) else float(value))
    return {"ok": True}


def mutate_reset_parameters(_root, info):
    """The parameter editor's "Restore defaults" button."""
    store = _store(info)
    for pid, _l, _u in DISEASE_PARAM_DEFS:
        store.reset(pid)
    return {"ok": True}


def mutate_set_simulation_days(_root, info, days):
    """The Dash app's Timeframe dropdown (reference corona.py:244-254)
    writes simulation_days into the session; exposed here so the web UI
    can do the same."""
    try:
        days = int(days)
    except (TypeError, ValueError):
        raise GraphQLError("days must be an integer")
    if not 1 <= days <= 1095:
        raise GraphQLError("simulation_days must be between 1 and 1095")
    _store(info).set("simulation_days", days)
    return {"ok": True}


def resolve_simulation_days(_root, info):
    return int(_get(info, "simulation_days"))


def mutate_activate_scenario(_root, info, scenario_id):
    store = _store(info)
    scenarios = store.get("scenarios")
    if scenario_id:
        for s in scenarios:
            if scenario_id == s["id"]:
                break
        else:
            raise GraphQLError("invalid scenario ID")
    else:
        scenario_id = ""
    store.reset()
    store.set("active_scenario", scenario_id)
    return {"ok": True}


SCHEMA = {
    "query": {
        "available_events": resolve_available_events,
        "active_events": resolve_active_events,
        "simulation_results": resolve_simulation_results,
        "validation_metrics": resolve_validation_metrics,
        "mobility_change_metrics": resolve_mobility_change_metrics,
        "area": resolve_area,
        "scenarios": resolve_scenarios,
        "disease_parameters": resolve_disease_parameters,
        "sample_distribution": resolve_sample_distribution,
        "simulation_days": resolve_simulation_days,
    },
    "mutation": {
        "run_simulation": mutate_run_simulation,
        "add_event": mutate_add_event,
        "delete_event": mutate_delete_event,
        "reset_variables": mutate_reset_variables,
        "activate_scenario": mutate_activate_scenario,
        "set_parameter": mutate_set_parameter,
        "reset_parameters": mutate_reset_parameters,
        "set_simulation_days": mutate_set_simulation_days,
    },
}

# __schema/__type introspection over the SDL-declared type system
# (the reference serves a real graphene schema that answers these;
# graphql_schema.py:500-508, graphql_backend.py:40-45)
from .introspection import introspection_resolvers  # noqa: E402
from .sdl import SDL  # noqa: E402

SCHEMA["query"].update(introspection_resolvers(SDL))
