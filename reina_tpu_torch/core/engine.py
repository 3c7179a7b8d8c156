"""Run assembly and execution (port of reina_tpu/core/engine.py):
variables → compiled run on a device → days.

``build_run`` carries over the JAX package's numpy host compile and
places every tensor on the device it is given; nothing picks a device
by itself. ``run_days`` steps the days eagerly, accumulating each
chunk's outputs on the device, and checks the problem bitmask at the
end of every chunk.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import constants as C
from .params import (compile_disease, compile_import_ages,
                     compile_population, create_disease_params,
                     make_age_groups)
from .schedule import Schedules, compile_schedules
from .state import (AgentState, DayCarry, blank_state, initial_all_detected,
                    seed_initial_state)
from .step import (DayOutputs, EngineConfig, ModelArrays, SchedRow,
                   day_step, derive_day_keys, snapshot_outputs)
from ..ops import prng
from reina_tpu.config.interventions import get_active_interventions
from reina_tpu.data import loaders


@dataclass
class CompiledRun:
    cfg: EngineConfig
    arrays: ModelArrays
    schedules: Schedules          # device tensors, leading axis = days
    init_state: AgentState
    init_carry: DayCarry
    days: int
    start_date: str
    random_seed: int
    variant_names: List[str]
    group_labels: List[str]
    n_agents: int
    device: torch.device
    meta: Dict[str, Any] = field(default_factory=dict)


def create_pairs(lst):
    return [(int(a), float(w)) for a, w in lst]


def host_compile(variables: Dict[str, Any],
                 cfg_overrides: Optional[Dict[str, Any]] = None,
                 age_counts_override: Optional[np.ndarray] = None,
                 pad_multiple: int = 1024):
    """The JAX package's build_run up to its device placement: returns
    (cfg, arrays, schedules, state, carry, meta) as numpy values (the
    arrays as a dict of ModelArrays fields)."""
    nr_ages = variables["max_age"] + 1
    days = variables["simulation_days"]
    seed = variables["random_seed"]

    if age_counts_override is not None:
        age_counts = np.asarray(age_counts_override)[:nr_ages]
    else:
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
                             pad_multiple=pad_multiple)
    n_padded = len(pop.ages)

    ivs = get_active_interventions(variables)
    sched_np, slots = compile_schedules(
        ivs, variables["start_date"], max(days, 1), nr_ages, variant_names)
    import_ages = compile_import_ages(
        create_pairs(variables["imported_infection_ages"]), nr_ages)

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
                       nr_groups=G, **(cfg_overrides or {}))
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
                random_seed=seed, variant_names=variant_names,
                group_labels=pop.group_labels,
                n_agents=int(np.asarray(age_counts).sum()),
                area_name=variables["area_name"])
    return cfg, arrays, sched_np, state_np, carry_np, meta


def build_run(variables: Dict[str, Any], device,
              cfg_overrides: Optional[Dict[str, Any]] = None,
              age_counts_override: Optional[np.ndarray] = None,
              pad_multiple: int = 1024) -> CompiledRun:
    """Compile a full simulation from resolved variables onto ``device``."""
    from .. import convert
    device = torch.device(device)
    cfg, arrays, sched_np, state_np, carry_np, meta = host_compile(
        variables, cfg_overrides, age_counts_override, pad_multiple)
    return CompiledRun(
        cfg=cfg,
        arrays=convert.model_arrays(arrays, device),
        schedules=convert.schedules(sched_np, device),
        init_state=convert.agent_state(state_np, device),
        init_carry=convert.day_carry(carry_np, device),
        days=meta["days"], start_date=meta["start_date"],
        random_seed=meta["random_seed"],
        variant_names=meta["variant_names"],
        group_labels=meta["group_labels"], n_agents=meta["n_agents"],
        device=device, meta={"area_name": meta["area_name"]})


def sched_row(schedules: Schedules, host: Schedules, d: int) -> SchedRow:
    """Day ``d`` of the schedules: (A, P) tables from the device, the
    rest from the host copy."""
    return SchedRow(
        mobility=schedules.mobility[d],
        mobility_scalar=host.mobility_scalar[d],
        mask_p=schedules.mask_p[d],
        testing_mode=int(host.testing_mode[d]),
        trace_p=host.trace_p[d],
        detect_anyway_p=host.detect_anyway_p[d],
        beds_build=int(host.beds_build[d]),
        icu_build=int(host.icu_build[d]),
        import_today=host.import_today[d],
        weekly_amount=host.weekly_amount[d],
        weekly_shares=host.weekly_shares[d],
        vacc_nr=host.vacc_nr[d])


def check_problems(problem) -> None:
    """Raise SimulationFailed for any set problem bit."""
    problem = int(problem)
    if problem:
        msgs = [s for bit, s in C.PROBLEM_TO_STR.items() if problem & bit]
        raise C.SimulationFailed(", ".join(msgs))


def stack_outputs(outs: List[DayOutputs]) -> DayOutputs:
    """Stack per-day outputs along a leading day axis, as numpy."""
    cols = []
    for vals in zip(*outs):
        if isinstance(vals[0], torch.Tensor):
            cols.append(torch.stack(list(vals)).cpu().numpy())
        else:
            cols.append(np.stack([np.asarray(v) for v in vals]))
    return DayOutputs(*cols)


def run_chunk(cfg: EngineConfig, arrays: ModelArrays, schedules: Schedules,
              host_sched: Schedules, state: AgentState, carry: DayCarry,
              base_key, chunk_len: int, day0: int):
    """Step ``chunk_len`` days from ``day0``; returns (state, carry,
    list of DayOutputs on the device)."""
    dkeys = derive_day_keys(cfg, base_key, day0 + np.arange(chunk_len))
    outs = []
    for i in range(chunk_len):
        state, carry, out = day_step(cfg, arrays,
                                     sched_row(schedules, host_sched,
                                               day0 + i),
                                     state, carry, dkeys.day(i))
        outs.append(out)
    return state, carry, outs


def run_days(run: CompiledRun, n_days: Optional[int] = None,
             chunk_days: int = 32, day_callback=None,
             seed: Optional[int] = None):
    """Execute the run; returns (stacked DayOutputs as numpy with a
    leading day axis of ``n_days`` rows — row 0 is the initial
    snapshot —, final state, final carry, chunk times).

    ``day_callback(day, outputs_so_far)`` fires after each chunk;
    returning False cancels the run with ExecutionInterrupted. The
    problem bitmask is checked at the end of every chunk."""
    n_days = n_days if n_days is not None else run.days
    base_key = prng.PRNGKey(run.random_seed if seed is None else seed)
    arrays, schedules, cfg = run.arrays, run.schedules, run.cfg
    host_sched = Schedules(*(x.cpu().numpy() for x in schedules))
    state = run.init_state
    # the bucket table is updated in place by the day step: copy the
    # run's initial table once so the run stays reusable
    carry = run.init_carry._replace(bkt_dst=run.init_carry.bkt_dst.clone())

    rows = [stack_outputs([snapshot_outputs(cfg, arrays, state, carry,
                                            np.float32(1.0))])]
    day = 0
    steps_left = n_days - 1
    chunk_times = []
    while steps_left > 0:
        this_chunk = min(chunk_days, steps_left)
        t0 = time.perf_counter()
        state, carry, outs = run_chunk(cfg, arrays, schedules, host_sched,
                                       state, carry, base_key, this_chunk,
                                       day)
        rows.append(stack_outputs(outs))
        check_problems(carry.problem)
        day += this_chunk
        steps_left -= this_chunk
        chunk_times.append((this_chunk, time.perf_counter() - t0))
        if day_callback is not None:
            partial = DayOutputs(*(np.concatenate(xs, axis=0)
                                   for xs in zip(*rows)))
            if not day_callback(day, partial):
                raise ExecutionInterrupted()
    stacked = DayOutputs(*(np.concatenate(xs, axis=0) for xs in zip(*rows)))
    return stacked, state, carry, chunk_times


class ExecutionInterrupted(Exception):
    """Cooperative cancellation."""
