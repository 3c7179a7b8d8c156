"""Host compile and one plain day of the reference (see the package's
docstring): ``build`` is the port's ``core/engine.host_compile`` and its
device placement as they stood when the benchmark was written; ``step``
runs one day from a state with that day's keys."""
from __future__ import annotations

from dataclasses import dataclass
from datetime import date
from typing import Any, Dict, List

import numpy as np
import torch

from . import convert
from .config.interventions import get_active_interventions
from .core.params import (compile_disease, compile_import_ages,
                          compile_population, create_disease_params,
                          make_age_groups)
from .core.schedule import Schedules, compile_schedules
from .core.state import (AgentState, DayCarry, blank_state,
                         initial_all_detected, seed_initial_state)
from .core.step import (GROUP_ROW, DayOutputs, EngineConfig, ModelArrays,
                        SchedRow, day_step, derive_day_keys,
                        snapshot_outputs)
from .data import loaders
from .ops import prng

POP_ATTRS = [
    "susceptible", "vaccinated", "infected", "detected", "all_detected",
    "in_ward", "in_icu", "dead", "non_hospital_deaths", "recovered",
    "all_infected", "new_infections",
]
PLACES = ["home", "work", "school", "transport", "leisure", "other"]
STATE_ATTRS = [
    "exposed_per_day", "available_hospital_beds", "available_icu_units",
    "total_icu_units", "ct_cases_per_day", "r", "mobility_limitation",
]


@dataclass
class Build:
    cfg: EngineConfig
    arrays: ModelArrays
    schedules: Schedules          # device tensors, leading axis = days
    host: Schedules               # the same as numpy
    state: AgentState             # the initial state
    carry: DayCarry
    days: int
    start_date: str
    variant_names: List[str]
    n_agents: int


def _pairs(lst):
    return [(int(a), float(w)) for a, w in lst]


def host_compile(variables: Dict[str, Any]):
    """Variables → (cfg, arrays, schedules, state, carry, meta), numpy."""
    nr_ages = variables["max_age"] + 1
    days = variables["simulation_days"]
    seed = variables["random_seed"]
    age_counts = loaders.get_population_for_area(
        variables["area_name"])[:nr_ages]
    contacts = loaders.get_contact_tensor()
    band_of_age = contacts.band_of_age(variables["max_age"])
    contact_base = contacts.per_year_participant(
        variables["max_age"]).astype(np.float32)

    disease, variant_names = compile_disease(
        create_disease_params(variables), nr_ages)
    V = len(variant_names)
    pop = compile_population(np.asarray(age_counts), band_of_age,
                             pad_multiple=1024)
    n_padded = len(pop.ages)

    ivs = get_active_interventions(variables)
    sched_np, slots = compile_schedules(
        ivs, variables["start_date"], max(days, 1), nr_ages, variant_names)
    import_ages = compile_import_ages(
        _pairs(variables["imported_infection_ages"]), nr_ages)

    B = int(band_of_age.max()) + 1
    sigma_max = np.zeros((V, B), dtype=np.float32)
    for b in range(B):
        sigma_max[:, b] = disease.p_susc[:, band_of_age == b].max(axis=1)
    G = pop.nr_groups

    ages_i = pop.ages.astype(np.int32)
    band_ag = band_of_age[ages_i].astype(np.int32)
    nb_ag = pop.band_counts[band_ag].astype(np.float32)
    smax_ag = sigma_max[:, band_ag]
    with np.errstate(divide="ignore", invalid="ignore"):
        lam = disease.p_susc[:, ages_i] / (smax_ag * np.maximum(nb_ag, 1.0))
    lam_log1p_ag = np.log1p(
        -np.where(smax_ag > 0, lam, 0.0)).astype(np.float32)

    arrays = dict(
        ages=pop.ages.astype(np.int32), active=pop.active,
        age_start=pop.age_start, band_of_age=pop.band_of_age,
        band_counts=pop.band_counts, group_of_agent=pop.group_of_agent,
        active_per_group=np.bincount(
            pop.group_of_agent[pop.active],
            minlength=G + 1)[:G].astype(np.int32),
        contact_base=contact_base, p_susc=disease.p_susc,
        sigma_max=sigma_max, p_sympt=disease.p_sympt,
        p_severe_c=disease.p_severe_c, p_critical_c=disease.p_critical_c,
        p_fatal_c=disease.p_fatal_c, p_doh=disease.p_doh, band_ag=band_ag,
        lam_log1p_ag=lam_log1p_ag, iot=disease.iot,
        inf_mult=disease.inf_mult, asymp_mult=disease.asymp_mult,
        mask_pw=disease.mask_pw, mask_po=disease.mask_po,
        p_hosp_death_no_beds=disease.p_hosp_death_no_beds,
        p_icu_death_no_beds=disease.p_icu_death_no_beds,
        mu_incub=disease.mu_incub, mu_death=disease.mu_death,
        mu_recov=disease.mu_recov,
        ratio_before_hosp=disease.ratio_before_hosp,
        ratio_in_ward=disease.ratio_in_ward,
        import_cum_p=import_ages.cum_p, import_min_age=import_ages.min_age,
        import_max_age=import_ages.max_age,
        vacc_min_age=slots.min_age, vacc_max_age=slots.max_age)

    state_np = blank_state(pop)
    ipc = loaders.get_initial_population_condition(
        variables["area_name"], variables["start_date"],
        incubating=variables["incubating_at_simulation_start"],
        ill=variables["ill_at_simulation_start"],
        recovered=variables["recovered_at_simulation_start"])
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC0FFEE]))
    beds, icu = variables["hospital_beds"], variables["icu_units"]
    state_np, avail_beds, avail_icu = seed_initial_state(
        state_np, disease, ipc, beds, icu, rng)

    labels = make_age_groups(nr_ages - 1)
    group_of_age = np.array([pop.group_labels.index(x) for x in labels],
                            dtype=np.int32)
    cfg = EngineConfig(vacc_slots=max(slots.count, 1), nr_variants=V,
                       nr_groups=G)
    carry_np = DayCarry(
        day=0,
        beds_avail=np.int32(avail_beds), icu_avail=np.int32(avail_icu),
        beds_total=np.int32(beds), icu_total=np.int32(icu),
        weekly_leftover=np.zeros(V, np.float32),
        all_detected=initial_all_detected(ipc.confirmed_cases, group_of_age,
                                          G, nr_ages),
        problem=np.int32(0),
        bkt_dst=np.full(n_padded * cfg.max_infectees, n_padded, np.int32),
        bkt_fill=np.zeros(n_padded, np.int32),
        mob=np.full(contact_base.shape[:2], -1.0, np.float32),
        nc_ag=np.zeros(n_padded, np.float32),
        app_pos=(n_padded * cfg.max_infectees
                 + np.arange(cfg.infection_buffer, dtype=np.int32)),
        app_val=np.full(cfg.infection_buffer, n_padded, np.int32),
        app_n=np.int32(0))
    meta = dict(days=days, start_date=variables["start_date"],
                variant_names=variant_names,
                n_agents=int(np.asarray(age_counts).sum()))
    return cfg, arrays, sched_np, state_np, carry_np, meta


def build(variables: Dict[str, Any], device) -> Build:
    """Compile a run from resolved variables onto ``device``."""
    device = torch.device(device)
    cfg, arrays, sched_np, state_np, carry_np, meta = host_compile(variables)
    schedules = convert.schedules(sched_np, device)
    return Build(cfg=cfg, arrays=convert.model_arrays(arrays, device),
                 schedules=schedules,
                 host=Schedules(*(x.cpu().numpy() for x in schedules)),
                 state=convert.agent_state(state_np, device),
                 carry=convert.day_carry(carry_np, device),
                 days=meta["days"], start_date=meta["start_date"],
                 variant_names=meta["variant_names"],
                 n_agents=meta["n_agents"])


def sched_row(b: Build, d: int) -> SchedRow:
    s, h = b.schedules, b.host
    return SchedRow(
        mobility=s.mobility[d], mobility_scalar=h.mobility_scalar[d],
        mask_p=s.mask_p[d], testing_mode=int(h.testing_mode[d]),
        trace_p=h.trace_p[d], detect_anyway_p=h.detect_anyway_p[d],
        beds_build=int(h.beds_build[d]), icu_build=int(h.icu_build[d]),
        import_today=h.import_today[d], weekly_amount=h.weekly_amount[d],
        weekly_shares=h.weekly_shares[d], vacc_nr=h.vacc_nr[d])


def snapshot(b: Build) -> DayOutputs:
    """The day-0 outputs of the initial state."""
    return snapshot_outputs(b.cfg, b.arrays, b.state, b.carry,
                            b.host.mobility_scalar[0])


def _bf16(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    if isinstance(x, np.ndarray) and x.dtype == np.float32:
        return _bf16(torch.from_numpy(x)).numpy()
    return x


def _lower(t):
    return type(t)(*(_bf16(x) for x in t))


def step(b: Build, state: AgentState, carry: DayCarry, seed: int,
         lower: bool = False):
    """Day ``carry.day`` from ``state`` and ``carry`` with the keys of
    ``seed``: (state, carry, DayOutputs) of the next day. The carry's
    bucket table is copied first (the plain step writes it in place).
    ``lower``: the control, every float32 the day reads (the model
    arrays, the state, the carry, the schedule row) and writes rounded
    to bfloat16."""
    day = int(carry.day)
    dk = derive_day_keys(b.cfg, prng.PRNGKey(seed), np.array([day]))
    carry = carry._replace(bkt_dst=carry.bkt_dst.clone())
    arrays, row = b.arrays, sched_row(b, day)
    if lower:
        arrays, row = _lower(arrays), _lower(row)
        state, carry = _lower(state), _lower(carry)
    state, carry, out = day_step(b.cfg, arrays, row, state, carry,
                                 dk.day(0))
    if lower:
        state, carry, out = _lower(state), _lower(carry), _lower(out)
    return state, carry, out


def stack(outs: List[DayOutputs]) -> DayOutputs:
    """Per-day outputs along a leading day axis, as numpy."""
    cols = []
    for vals in zip(*outs):
        cols.append(np.stack([v.cpu().numpy() if isinstance(v, torch.Tensor)
                              else np.asarray(v) for v in vals]))
    return DayOutputs(*cols)


def daily_columns(out: DayOutputs, variant_names, start_date: str,
                  rows: int) -> Dict[str, np.ndarray]:
    """Stacked outputs as the served result's daily columns (all but
    the wall-clock ``us_per_infected``)."""
    cols: Dict[str, np.ndarray] = {
        "date": np.datetime64(date.fromisoformat(start_date), "D")
        + np.arange(rows)}
    for attr in POP_ATTRS:
        cols[attr] = out.by_group[:rows, GROUP_ROW[attr]].sum(axis=1)
    for attr in STATE_ATTRS:
        cols[attr] = np.asarray(getattr(out, attr))[:rows]
    for p_i, place in enumerate(PLACES):
        cols["exposures_" + place] = out.exposures_by_place[:rows, p_i]
    for v_i, name in enumerate(variant_names):
        cols["infected_by_variant_%s" % name] = \
            out.infected_by_variant[:rows, v_i]
    return cols


def resolved(variables: Dict[str, Any]) -> Dict[str, Any]:
    """The packaged defaults with ``variables`` over them."""
    from .config.variables import VARIABLE_DEFAULTS
    out = dict(VARIABLE_DEFAULTS)
    out.update(variables)
    return out

