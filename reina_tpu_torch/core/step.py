"""One simulated day on tensors (port of reina_tpu/core/step.py).

The phases, the draws and their shapes follow the JAX package's
``day_step`` one for one, so that a day stepped from the same state
with the same keys agrees field by field:

  1. capacity builds + weekly-import accounting
  2. R_t bookkeeping (inside the exposure prologue pass)
  3. testing-queue drain, 2-level contact tracing, vaccination
  4. exposure: contact counts, dart aggregation and binomial split,
     receiver-side infection draws
  5. progression with first-come-first-served bed/ICU ledgers
  6. merge of new infections (imports + contacts) with attribution
  7. per-age-group output counts

PyTorch runs eagerly, so the JAX package's ``lax.cond``/``lax.switch``
tiers become host decisions on counts read from the device; each tier
still draws at its ceiling's shape, which keeps the random streams
bit-equal. Scatters with the JAX package's ``mode="drop"`` sentinels go
to one spare slot past the end of a buffer, or are cut to the prefix of
used slots, which the host knows. The four fused per-agent bodies below
(``prologue``, ``recv_front``, ``post``, ``finalize``) are the plain
twins of the Triton kernels in reina_tpu_torch/kernels/fused_bodies.py;
``fused_map`` picks one or the other by device.
"""
from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import constants as C
from .state import AgentState, DayCarry
from ..ops import prng
from ..ops.clamped import clamped_counter_grants
from ..ops.compact import compact_indices
from ..ops.fusedmap import (fused_bihistogram, fused_concat_prefix,
                            fused_fn_onehot_sum, fused_map,
                            fused_onehot_sum)
from ..ops.random import binomial_fixed, gamma_fixed, searchsorted

I8, I16, I32, I64 = torch.int8, torch.int16, torch.int32, torch.int64
F32 = torch.float32


@dataclass(frozen=True)
class EngineConfig:
    """Static engine sizes (the JAX package's EngineConfig less its
    Pallas and mesh switches)."""
    infection_buffer: int = 1 << 16   # max new contact-infections per day
    infection_head: int = 1 << 9      # first slot tier
    import_buffer: int = 512          # max imported infections per day
    import_attempts: int = 10         # susceptible-search retries
    max_infectees: int = 64           # per-source infectee-bucket capacity
    bucket_head: int = 4              # first bucket-column tier
    vacc_slots: int = 1               # vaccination campaign slots (≥ 1)
    nr_variants: int = 2
    nr_groups: int = 10               # output age groups


class ModelArrays(NamedTuple):
    """Compiled static model data (device tensors). The JAX package's
    bf16 age one-hots are not carried: ``expand_by_age`` is a gather."""
    ages: torch.Tensor            # (N,) int32
    active: torch.Tensor          # (N,) bool
    age_start: torch.Tensor       # (A+1,) int32 — agents are age-sorted
    band_of_age: torch.Tensor     # (A,) int32
    band_counts: torch.Tensor     # (B,) int32
    group_of_agent: torch.Tensor  # (N,) int32 (G = padding)
    active_per_group: torch.Tensor  # (G,) int32
    contact_base: torch.Tensor    # (A, P, B) float32
    p_susc: torch.Tensor          # (V, A)
    sigma_max: torch.Tensor       # (V, B)
    p_sympt: torch.Tensor         # (V, A)
    p_severe_c: torch.Tensor      # (V, A)
    p_critical_c: torch.Tensor    # (V, A)
    p_fatal_c: torch.Tensor       # (V, A)
    p_doh: torch.Tensor           # (V, A)
    band_ag: torch.Tensor         # (N,) int32
    lam_log1p_ag: torch.Tensor    # (V, N) f32
    iot: torch.Tensor             # (V, 21)
    inf_mult: torch.Tensor        # (V,)
    asymp_mult: torch.Tensor      # (V,)
    mask_pw: torch.Tensor         # (V,)
    mask_po: torch.Tensor         # (V,)
    p_hosp_death_no_beds: torch.Tensor  # (V,)
    p_icu_death_no_beds: torch.Tensor   # (V,)
    mu_incub: torch.Tensor        # (V,)
    mu_death: torch.Tensor        # (V,)
    mu_recov: torch.Tensor        # (V,)
    ratio_before_hosp: torch.Tensor  # (V,)
    ratio_in_ward: torch.Tensor   # (V,)
    import_cum_p: torch.Tensor    # (Cc,)
    import_min_age: torch.Tensor  # (Cc,)
    import_max_age: torch.Tensor  # (Cc,)
    vacc_min_age: torch.Tensor    # (S,)
    vacc_max_age: torch.Tensor    # (S,)


class SchedRow(NamedTuple):
    """One day of the schedules: the (A, P) tables as device tensors,
    everything else as host numpy values."""
    mobility: torch.Tensor        # (A, P)
    mobility_scalar: np.float32
    mask_p: torch.Tensor          # (A, P)
    testing_mode: int
    trace_p: np.float32
    detect_anyway_p: np.float32
    beds_build: int
    icu_build: int
    import_today: np.ndarray      # (V,) int32
    weekly_amount: np.float32
    weekly_shares: np.ndarray     # (V,) float32
    vacc_nr: np.ndarray           # (S,) float32


class DayOutputs(NamedTuple):
    by_group: torch.Tensor        # (13, G) int32
    available_hospital_beds: torch.Tensor
    available_icu_units: torch.Tensor
    total_icu_units: torch.Tensor
    r: torch.Tensor               # float32
    exposed_per_day: torch.Tensor
    ct_cases_per_day: torch.Tensor
    mobility_limitation: np.float32
    exposures_by_place: torch.Tensor  # (P,) int32
    infected_by_variant: torch.Tensor  # (V,) int32


GROUPED_ATTRS = (
    "susceptible", "vaccinated", "infected", "all_infected", "detected",
    "all_detected", "in_icu", "cum_icu", "in_ward", "dead", "recovered",
    "non_hospital_deaths", "new_infections",
)
GROUP_ROW = {name: i for i, name in enumerate(GROUPED_ATTRS)}


def _round_to_int(f):
    """Reference round_to_int: floor(f + 0.5), as int16."""
    return torch.floor(f + 0.5).to(I16)


def _tab(table, idx):
    """table[idx] for idx in [1, V), else table[0] (the JAX package's
    unrolled variant selects)."""
    V = table.shape[0]
    return table[torch.where((idx >= 1) & (idx < V), idx, 0).long()]


def expand_by_age(arrays: ModelArrays, per_age, terms: int = 2):
    """Per-agent values of a dynamic (A,) table, split into ``terms``
    bf16 residual terms as the JAX package's one-hot matmuls do. The
    one-hots pick exactly one entry, so this is a gather of the same
    sum of terms."""
    rem = per_age.to(F32)
    y = None
    for _ in range(terms):
        part = rem.to(torch.bfloat16).to(F32)
        y = part if y is None else y + part
        rem = rem - part
    return y[arrays.ages.long()]


def severity_from_uniform(val, syc_raw, dohc, sc, cc, fc, vmod):
    """get_symptom_severity's decision chain on a uniform draw; returns
    (severity int8, death_outside bool)."""
    asympt = val >= syc_raw
    syc = syc_raw * vmod
    fatal_doh = (dohc > 0) & (val < dohc * syc)
    val = torch.where(dohc > 0, (val - dohc) / (1 - dohc), val)
    sev = torch.where(val < sc * syc, C.SEVERE, C.MILD)
    sev = torch.where(val < cc * sc * syc, C.CRITICAL, sev)
    fatal_chain = val < fc * cc * sc * syc
    sev = torch.where(fatal_chain, C.FATAL, sev)
    outside = fatal_chain | fatal_doh
    sev = torch.where(fatal_doh, C.FATAL, sev)
    sev = torch.where(asympt, C.ASYMPTOMATIC, sev)
    outside = outside & ~asympt
    return sev.to(I8), outside


def vaccine_modifier(dov_i, day: int):
    return torch.where((dov_i >= 0) & ((day - dov_i.to(I32))
                                       > C.VACCINE_DELAY_DAYS),
                       1.0 - C.VACCINE_EFFICACY, 1.0).to(F32)


def _binomial_split(key, totals, probs):
    """Independent Binomial(totals, p_b) per trailing category, drawn
    on the flattened domain (bit-equal to the JAX package)."""
    n_full = totals[..., None].to(F32).expand(probs.shape)
    flat = binomial_fixed(key, n_full.reshape(-1), probs.to(F32).reshape(-1))
    return flat.reshape(probs.shape)


def _group_counts(cfg: EngineConfig, arrays: ModelArrays, masks):
    counts = fused_onehot_sum(list(masks), arrays.group_of_agent,
                              cfg.nr_groups + 1)
    return counts[:, :-1].to(I32)


# ---------------------------------------------------------------------------
# the four fused per-agent bodies (twins of kernels/fused_bodies.py)

def prologue(st8, dl, doil, doi, sev8, var8, wdet, isinf, act, z, nc_ag,
             incl, ninf, iot, asym, infm, day):
    """Exposure prologue + R_t element passes."""
    st, sev, var = st8.to(I32), sev8.to(I32), var8.to(I32)
    V, T = iot.shape
    removed = (st == C.RECOVERED) | (st == C.DEAD)
    count_now = removed & ~incl & act
    included = incl | count_now
    ninf_m = torch.where(count_now, ninf, 0)

    day_rel = torch.where(st == C.INCUBATION, -dl.to(I32), doil.to(I32))
    iot_idx = day_rel + C.IOT_OFFSET
    iot_ok = (iot_idx >= 0) & (iot_idx < T)
    iot_idx_c = torch.clamp(iot_idx, 0, T - 1)
    can_expose = (((st == C.INCUBATION) & (doi.to(I32) < day))
                  | (st == C.ILLNESS))
    asympt = sev == C.ASYMPTOMATIC
    var_ok = (var >= 0) & (var < V)
    iot_val = torch.where(
        var_ok, iot[torch.clamp(var, 0, V - 1).long(), iot_idx_c.long()], 0.0)
    inf_base = (iot_val * torch.where(asympt, _tab(asym, var), 1.0)
                * _tab(infm, var))
    exposer = can_expose & iot_ok & act & ~wdet & isinf
    inf_base = torch.where(exposer, inf_base, 0.0)
    exposer = inf_base > 0

    sympt_ill = (st == C.ILLNESS) & ~asympt
    factor = torch.where(sympt_ill, C.SYMPTOMATIC_CONTACT_FACTOR, 1.0).to(F32)
    limit = torch.where(sympt_ill, C.SYMPTOMATIC_CONTACT_LIMIT,
                        C.DEFAULT_CONTACT_LIMIT).to(I32)
    f = torch.exp(C.CONTACT_LOGNORMAL_SIGMA * z) * nc_ag * factor
    f = torch.clamp_min(f, 1.0)
    k_s = torch.minimum(torch.clamp_min(torch.floor(f).to(I32) - 1, 0), limit)
    k_s = torch.where(exposer, k_s, 0)
    vts = (var * T + iot_idx_c) * 2 + asympt.to(I32)
    return exposer, inf_base, k_s, vts, count_now, included, ninf_m


def recv_front(band, lam, isinf, hasimm, act, u_inf, u_var, st8, doi, dl,
               o2r, sev8, wdet, dout, doil, u_day, var8, D, rbt, rwt, day,
               mode, dap):
    """Exposure receiver side + progression front half."""
    V, B = D.shape
    band_ok = (band >= 0) & (band < B)
    bc = torch.clamp(band, 0, B - 1).long()
    hs = [1.0 - torch.exp(torch.where(band_ok, D[v][bc], 0.0) * lam[v])
          for v in range(V)]
    one_minus, h_sum = 1.0, 0.0
    for h in hs:
        one_minus = one_minus * (1.0 - h)
        h_sum = h_sum + h
    p_inf = 1.0 - one_minus
    susceptible = act & ~isinf & ~hasimm
    new_contact = susceptible & (u_inf < p_inf)
    u = u_var * torch.clamp_min(h_sum, 1e-30)
    run = 0.0
    nv = torch.zeros(band.shape, dtype=I32, device=band.device)
    for h in hs[:-1]:
        run = run + h
        nv = nv + (u >= run).to(I32)
    nv = torch.clamp(nv, 0, V - 1)

    st, sev, var = st8.to(I32), sev8.to(I32), var8.to(I32)
    dl, doil = dl.to(I32), doil.to(I32)
    live = isinf & act
    adv_inc = (st == C.INCUBATION) & (doi.to(I32) < day) & live
    adv_ill = (st == C.ILLNESS) & live
    adv_hosp = (st == C.HOSPITALIZED) & live
    adv_icu = (st == C.IN_ICU) & live
    adv_any = adv_inc | adv_ill | adv_hosp | adv_icu
    dl_new = torch.where(adv_any, torch.clamp_min(dl - 1, 0), dl)
    fire = adv_any & (dl_new == 0)

    rb = _tab(rbt, var)
    onset = adv_inc & fire
    illness_days = _round_to_int(
        o2r * torch.where(sev >= C.SEVERE, rb, 1.0)).to(I32)
    dl_a = torch.where(onset, illness_days, dl_new).to(I16)

    asympt = sev == C.ASYMPTOMATIC
    seek = onset & ~asympt & ~wdet
    if mode in (C.TESTING_ALL_WITH_SYMPTOMS, C.TESTING_ALL_WITH_SYMPTOMS_CT):
        queue_new = seek
    elif mode == C.TESTING_ONLY_SEVERE_SYMPTOMS:
        queue_new = seek & ((sev >= C.SEVERE) | (u_day < dap))
    else:
        queue_new = torch.zeros_like(seek)

    ill_end = adv_ill & fire
    die_home = ill_end & (sev == C.FATAL) & dout
    bed_request = ill_end & (sev >= C.SEVERE) & ~die_home
    recover_ill = ill_end & ~die_home & ~bed_request
    doil_new = torch.where(adv_ill, doil + 1, doil).to(I16)
    hosp_end = adv_hosp & fire
    icu_request = hosp_end & (sev >= C.CRITICAL)
    hosp_recover = hosp_end & ~icu_request
    icu_end = adv_icu & fire
    icu_die = icu_end & (sev == C.FATAL)
    icu_recover = icu_end & ~icu_die
    return (new_contact, nv, susceptible, dl_a, doil_new, onset, queue_new,
            die_home, bed_request, recover_ill, hosp_end, icu_request,
            hosp_recover, icu_end, icu_die, icu_recover)


def post(st8, sev8, var8, o2r, dl_a, gbed, gicu, u, bed_request,
         icu_request, die_home, recover_ill, hosp_recover, icu_die,
         icu_recover, wdet, isinf, hasimm, evericu, onset, rbt, rwt, picut,
         phospt):
    """Progression after the ledgers: grants, denied-care deaths, final
    state transitions."""
    st, sev, var = st8.to(I32), sev8.to(I32), var8.to(I32)
    dl_a = dl_a.to(I32)
    rb, rw = _tab(rbt, var), _tab(rwt, var)
    p_icu = _tab(picut, var)

    bed_denied = bed_request & ~gbed
    die_chance = torch.where(sev == C.FATAL, 1.0,
                             torch.where(sev == C.CRITICAL, p_icu,
                                         _tab(phospt, var)))
    denied_die = bed_denied & (u < die_chance)
    denied_recover = bed_denied & ~denied_die
    hospitalized_now = bed_request & gbed
    hosp_days = _round_to_int(
        o2r * torch.where(sev == C.SEVERE, 1.0 - rb, rw)).to(I32)
    icu_denied = icu_request & ~gicu
    icu_die_chance = torch.where(sev == C.FATAL, 1.0, p_icu)
    icu_denied_die = icu_denied & (u < icu_die_chance)
    icu_enter = (icu_request & gicu) | (icu_denied & ~icu_denied_die)
    icu_days = _round_to_int(o2r * (1.0 - rw - rb)).to(I32)
    detect_hosp = bed_request & ~wdet
    wdet_out = wdet | bed_request
    dies = die_home | denied_die | icu_denied_die | icu_die
    recovers = recover_ill | denied_recover | hosp_recover | icu_recover

    new_st = st
    new_st = torch.where(onset, C.ILLNESS, new_st)
    new_st = torch.where(hospitalized_now, C.HOSPITALIZED, new_st)
    new_st = torch.where(icu_enter, C.IN_ICU, new_st)
    new_st = torch.where(recovers, C.RECOVERED, new_st)
    new_st = torch.where(dies, C.DEAD, new_st)
    days_left = torch.where(hospitalized_now, hosp_days, dl_a)
    days_left = torch.where(icu_enter, icu_days, days_left)
    gone = dies | recovers
    return (new_st.to(I8), days_left.to(I16), isinf & ~gone,
            hasimm | (gone & isinf), evericu | icu_enter, wdet_out,
            detect_hosp)


def finalize(st8, sev8, var8, var_new, dl, doil, doi, newly, isinf, trc,
             det, det_hosp, day, ct):
    """End-of-day merge of today's new infections."""
    st_n = torch.where(newly, C.INCUBATION, st8.to(I32))
    var_n = torch.where(newly, var_new, var8.to(I32))
    doi_n = torch.where(newly, day, doi.to(I32))
    doil_n = torch.where(newly, 0, doil.to(I32))
    return (st_n.to(I8), sev8.clone(), var_n.to(I8), dl.clone(),
            doil_n.to(I16), doi_n.to(I16), isinf | newly,
            trc | (newly & bool(ct)), det | det_hosp)


def _output_masks_reduced(active, is_inf, has_imm, dov, det, st, ever_icu,
                          dout, newly):
    """The 10 GROUP_ROW masks that need the agent axis (the other 3
    are per-group identities, see the JAX package)."""
    st = st.to(I32)
    ever = is_inf | has_imm
    dead = st == C.DEAD
    return [
        active & (dov.to(I32) >= 0),          # vaccinated
        active & ever,                        # all_infected
        active & det,                         # detected (today)
        active & (st == C.IN_ICU),            # in_icu
        active & ever_icu,                    # cum_icu
        active & (st == C.HOSPITALIZED),      # in_ward
        active & dead,                        # dead
        active & (st == C.RECOVERED),         # recovered
        active & dead & dout,                 # non_hospital_deaths
        active & newly,                       # new_infections
    ]


# ---------------------------------------------------------------------------
# keys

def tier_bounds(head: int, cap: int):
    """Geometric buffer tiers (head, 3·head, …)."""
    head = min(head, cap)
    out = [(0, head)]
    lo = head
    while lo < cap:
        seg = min(lo * 3, cap) - lo
        out.append((lo, seg))
        lo += seg
    return out


def _tier_end(ends, x: int) -> int:
    """The smallest tier ceiling ≥ x (the JAX package's searchsorted
    into the ceilings, clamped to the last branch)."""
    return ends[min(bisect_left(ends, x), len(ends) - 1)]


class DayKeys(NamedTuple):
    """All key material one day consumes (host numpy uint32 pairs);
    ``derive_day_keys`` adds a leading day axis."""
    base: np.ndarray       # (17, 2) split(fold_in(base_key, day), 17)
    l1: np.ndarray         # (P1, 2)
    e1: np.ndarray         # (PE, 2)
    e2: np.ndarray         # (PE, 2)
    k_mem: np.ndarray      # (2,)
    vacc: np.ndarray       # (S, 2)
    attr_age: np.ndarray   # (PK, 2)
    attr_src: np.ndarray   # (PK, 2)
    gam1: np.ndarray       # (PK, 2)
    gam2: np.ndarray       # (PK, 2)
    sev: np.ndarray        # (PK, 2)

    def day(self, i: int) -> "DayKeys":
        return DayKeys(*(x[i] for x in self))


def derive_day_keys(cfg: EngineConfig, base_key, days) -> DayKeys:
    """The JAX package's per-day key chains, vectorised over ``days``."""
    days = np.asarray(days, np.int64)
    ks = prng.split(prng.fold_in(base_key, days), 17)         # (D, 17, 2)
    k4 = prng.split(ks[:, 11], 4)
    k1, k_mem, k_e1, k_e2 = k4[:, 0], k4[:, 1], k4[:, 2], k4[:, 3]
    k_offset = ks[:, 14]
    p1 = len(tier_bounds(min(cfg.infection_head, cfg.infection_buffer),
                         cfg.infection_buffer))
    nb = len(tier_bounds(min(cfg.bucket_head, cfg.max_infectees),
                         cfg.max_infectees))
    pe = p1 * nb
    pk = p1

    def tab(k, parts):
        return prng.fold_in(k[:, None, :], np.asarray(parts)[None, :])

    return DayKeys(
        base=ks, l1=tab(k1, np.arange(p1)), e1=tab(k_e1, np.arange(pe)),
        e2=tab(k_e2, np.arange(pe)), k_mem=k_mem,
        vacc=tab(k_offset, 1000 + np.arange(max(cfg.vacc_slots, 1))),
        attr_age=tab(ks[:, 8], np.arange(pk)),
        attr_src=tab(ks[:, 9], np.arange(pk)),
        gam1=tab(ks[:, 6], np.arange(pk)),
        gam2=tab(ks[:, 7], np.arange(pk)),
        sev=tab(ks[:, 5], np.arange(pk)))


def _spare(x, fill):
    """x with one spare element appended (a drop target for scatters)."""
    return torch.cat([x, torch.full((1,), fill, dtype=x.dtype,
                                    device=x.device)])


# ---------------------------------------------------------------------------
# the day

def day_step(cfg: EngineConfig, arrays: ModelArrays, sched: SchedRow,
             state: AgentState, carry: DayCarry, dk: DayKeys):
    """Advance one day. Returns (state, carry, DayOutputs).

    ``carry.bkt_dst`` is updated in place (it is N·64 int32; the engine
    copies the run's initial table once per run); every other input is
    left as it was."""
    N = state.age.shape[0]
    A = arrays.age_start.shape[0] - 1
    V = cfg.nr_variants
    dev = state.age.device
    day = int(carry.day)
    (k_contact, k_bin, k_place, k_inf, k_var, _k_sev, _k_gam1, _k_gam2,
     _k_attr_age, _k_attr_src, k_imp, _k_trace1, _r1, k_anyway,
     k_offset, _r2, _r3) = dk.base

    age = state.age.to(I32)
    st = state.state
    active = state.active
    problem = carry.problem
    trace_p = float(sched.trace_p)

    # ---- phase 1: capacity builds + weekly imports (host arithmetic
    # in float32, as the JAX package's device arithmetic)
    beds_total = carry.beds_total + int(sched.beds_build)
    icu_total = carry.icu_total + int(sched.icu_build)
    beds_avail = carry.beds_avail + int(sched.beds_build)
    icu_avail = carry.icu_avail + int(sched.icu_build)
    leftover = (np.asarray(carry.weekly_leftover, np.float32)
                + np.float32(sched.weekly_amount) / np.float32(7.0)
                * np.asarray(sched.weekly_shares, np.float32))
    weekly_today = np.floor(leftover).astype(np.int32)
    leftover = (leftover - weekly_today.astype(np.float32)).astype(np.float32)
    import_counts = np.asarray(sched.import_today, np.int32) + weekly_today

    # ---- phase 3: testing drain, tracing, vaccination
    drained = state.queued
    ct_cases = torch.sum(drained & active, dtype=I32)
    newly_detected = drained & ~state.was_detected
    was_detected = state.was_detected | drained
    detected_today = newly_detected
    queued = torch.zeros_like(drained)
    ct_active = int(sched.testing_mode) == C.TESTING_ALL_WITH_SYMPTOMS_CT
    is_dead = st == C.DEAD

    Tcap = cfg.infection_buffer
    CAPB = cfg.max_infectees
    NC = N * CAPB
    bkt_fill = carry.bkt_fill
    # yesterday's pending bucket appends; drop sentinels (≥ NC) land in
    # the table's spare last slot
    bd = carry.bkt_dst
    bd.index_put_((torch.clamp_max(carry.app_pos, NC).long(),),
                  carry.app_val)
    col_ends = [lo + seg for lo, seg in
                tier_bounds(min(cfg.bucket_head, CAPB), CAPB)]
    mem_sizes = [lo + seg for lo, seg in
                 tier_bounds(min(cfg.infection_head, Tcap), Tcap)]

    def do_tracing(queued):
        eligible = active & ~is_dead & ~was_detected & ~queued
        u_mem = prng.uniform(dk.k_mem, (N,), dev)
        infector = state.infector
        r2_tab = torch.where(eligible & (u_mem < trace_p) & (infector >= 0),
                             infector, N)

        def bucket_passes(members_buf, src_ok, ktab, with_recurse, hit,
                          hit_r2, n_m):
            end = _tier_end(mem_sizes, min(n_m, Tcap))
            seg_buf = members_buf[:end]
            used = seg_buf < N
            bp = torch.clamp(seg_buf, 0, N - 1).long()
            ok_m = used if src_ok is None else used & src_ok[bp]
            fill_m = torch.where(ok_m, torch.clamp_max(bkt_fill[bp], CAPB), 0)
            jend = _tier_end(col_ends, int(fill_m.max()))
            cols = torch.arange(jend, dtype=I64, device=dev)
            idx = (bp[:, None] * CAPB + cols[None, :]).reshape(-1)
            dst = bd[idx].reshape(end, jend)
            live = cols[None, :] < fill_m[:, None]
            u = prng.uniform(ktab[0], (end, jend), dev)
            fire = live & (u < trace_p)
            tgt = torch.where(fire, dst, N).reshape(-1)
            hit[tgt.long()] = True
            if with_recurse:
                t2 = torch.where(fire, r2_tab[torch.clamp(dst, 0, N - 1).long()],
                                 N).reshape(-1)
                hit_r2[t2.long()] = True
            return hit, hit_r2

        def blank():
            return torch.zeros(N + 1, dtype=torch.bool, device=dev)

        # level 1: the drained queue
        dbuf, n_d = compact_indices(drained & active, Tcap)
        n_d = int(n_d)
        end = _tier_end(mem_sizes, min(n_d, Tcap))
        seg_buf = dbuf[:end]
        used = seg_buf < N
        inf_s = infector[torch.clamp(seg_buf, 0, N - 1).long()]
        u1 = prng.uniform(dk.l1[0], (end,), dev)
        succ = used & (inf_s >= 0) & (u1 < trace_p)
        tgt = torch.where(succ, inf_s, N)
        hit1, hit_r2a = blank(), blank()
        hit1[tgt.long()] = True
        t2a = torch.where(succ, r2_tab[torch.clamp(tgt, 0, N - 1).long()], N)
        hit_r2a[t2a.long()] = True
        hit12, hit_r2ab = bucket_passes(dbuf, state.is_infected, dk.e1, True,
                                        hit1, hit_r2a, n_d)
        newq1 = eligible & hit12[:N]
        # level 2: infectee buckets of the compacted frontier
        frontier = newq1 & state.is_infected & (bkt_fill > 0)
        fbuf, n_f = compact_indices(frontier, Tcap)
        n_f = int(n_f)
        hit2_l2, _ = bucket_passes(fbuf, None, dk.e2, False, blank(),
                                   blank(), n_f)
        return (queued | (eligible & (hit12[:N] | hit_r2ab[:N]
                                      | hit2_l2[:N])),
                (n_d > Tcap) or (n_f > Tcap))

    if ct_active and int(ct_cases) > 0:
        queued, trace_overflow = do_tracing(queued)
        if trace_overflow:
            problem = problem | C.PROBLEM_TRACING_BUFFER_OVERFLOW

    dov = state.day_of_vaccination
    if np.sum(np.asarray(sched.vacc_nr, np.float32)) >= 1.0:
        ages_l = arrays.ages.long()
        for s in range(cfg.vacc_slots):
            nr = float(np.floor(np.float32(sched.vacc_nr[s])))
            eligible = (active & ~is_dead & ~was_detected & (dov < 0)
                        & (age >= arrays.vacc_min_age[s])
                        & (age <= arrays.vacc_max_age[s]))
            counts = torch.zeros(A, dtype=F32, device=dev).index_add_(
                0, ages_l, eligible.to(F32))
            older = torch.cat([torch.cumsum(counts.flip(0), 0)[:-1].flip(0),
                               torch.zeros(1, dtype=F32, device=dev)])
            need_a = nr - older
            frac_eff = torch.where(
                need_a <= 0, 0.0,
                torch.where(counts <= need_a, 1.0,
                            torch.clamp(need_a / torch.clamp_min(counts, 1.0),
                                        0.0, 1.0)))
            u_vac = prng.uniform(dk.vacc[s], (N,), dev)
            take = eligible & (u_vac < expand_by_age(arrays, frac_eff))
            dov = torch.where(take, day, dov.to(I32)).to(I16)

    # ---- phase 4: exposure
    q = arrays.contact_base * sched.mobility[:, :, None]          # (A, P, B)
    nc_a = q.sum(dim=(1, 2))
    q_hat = q / torch.clamp_min(nc_a, 1e-9)[:, None, None]
    z = prng.normal(k_contact, (N,), dev)
    # a pure function of mobility: recomputing it every day equals the
    # JAX package's carried copy
    nc_ag = expand_by_age(arrays, nc_a)
    exposer, inf_base, k_s, vts, count_now, included, ninf_m = fused_map(
        prologue,
        [state.state, state.days_left, state.day_of_illness,
         state.day_of_infection, state.severity, state.variant,
         was_detected, state.is_infected, active, z, nc_ag,
         state.included_in_totals, state.n_infected],
        [arrays.iot, arrays.asymp_mult, arrays.inf_mult, day])
    exposed_per_day = torch.sum(k_s, dtype=I32)
    total_infectors = torch.sum(count_now, dtype=I32)
    total_infections = torch.sum(ninf_m, dtype=I32)
    r_value = torch.where(
        total_infectors > 5,
        total_infections.to(F32) / torch.clamp_min(total_infectors, 1).to(F32),
        0.0)

    m = sched.mask_p                                               # (A, P)
    a_ = m[None] * arrays.mask_po[:, None, None]
    b_ = m[None] * arrays.mask_pw[:, None, None]
    save = a_ + b_ - a_ * b_                                       # (V, A, P)
    Tq = ((q_hat[None] * (1.0 - save)[..., None]).sum(dim=2)
          * arrays.sigma_max[:, None, :])                          # (V, A, B)

    VTS = V * C.IOT_LEN * 2
    K_age = fused_bihistogram(torch.where(exposer, vts, -1), VTS,
                              k_s.to(F32), arrays.ages, A)         # (VTS, A)
    K_g = K_age.T.reshape(A, V, C.IOT_LEN, 2)
    ig = (arrays.iot[None, :, :, None]
          * torch.stack([torch.ones_like(arrays.asymp_mult),
                         arrays.asymp_mult], dim=-1)[None, :, None, :]
          * arrays.inf_mult[None, :, None, None])
    pi = ig[..., None] * Tq.permute(1, 0, 2)[:, :, None, None, :]
    darts = _binomial_split(k_bin, K_g, pi)                        # (A,V,T,S,B)
    D = darts.sum(dim=(0, 2, 3))                                   # (V, B)

    u_inf = prng.uniform(k_inf, (N,), dev)
    u_var = prng.uniform(k_var, (N,), dev)
    o2r = state.o2r
    u_day = prng.uniform(k_anyway, (N,), dev)
    (new_contact, new_variant, susceptible,
     dl_a, day_of_illness, onset, queue_new, die_home, bed_request,
     recover_ill, hosp_end, icu_request, hosp_recover, icu_end,
     icu_die, icu_recover) = fused_map(
        recv_front,
        [arrays.band_ag, arrays.lam_log1p_ag, state.is_infected,
         state.has_immunity, active, u_inf, u_var, state.state,
         state.day_of_infection, state.days_left, o2r, state.severity,
         was_detected, state.death_outside, state.day_of_illness, u_day,
         state.variant],
        [D, arrays.ratio_before_hosp, arrays.ratio_in_ward, day,
         int(sched.testing_mode), float(sched.detect_anyway_p)])
    queued = queued | queue_new

    offset = prng.randint_scalar(k_offset, 0, N)
    (granted_bed, granted_icu), after2 = clamped_counter_grants(
        [hosp_end.to(I32), icu_end.to(I32)], [bed_request, icu_request],
        torch.stack([beds_avail, icu_avail]), offset)
    beds_after, icu_after = after2[0], after2[1]

    (new_st, days_left, is_infected, has_immunity, ever_icu,
     was_detected, detect_hosp) = fused_map(
        post,
        [state.state, state.severity, state.variant, o2r, dl_a,
         granted_bed, granted_icu, u_day, bed_request, icu_request,
         die_home, recover_ill, hosp_recover, icu_die, icu_recover,
         was_detected, state.is_infected, state.has_immunity,
         state.ever_icu, onset],
        [arrays.ratio_before_hosp, arrays.ratio_in_ward,
         arrays.p_icu_death_no_beds, arrays.p_hosp_death_no_beds])

    # ---- phase 6: merge new infections
    M = cfg.import_buffer
    cum_imp = np.cumsum(import_counts).astype(np.int32)
    tot_imports = int(cum_imp[-1])
    if tot_imports > M:
        problem = problem | C.PROBLEM_IMPORT_BUFFER_OVERFLOW
    newly, variant_new = new_contact, new_variant
    if tot_imports > 0:
        slot_ids = torch.arange(M, dtype=I32, device=dev)
        slot_valid = slot_ids < tot_imports
        slot_variant = torch.clamp(searchsorted(
            torch.from_numpy(cum_imp).to(dev), slot_ids, side="right"),
            0, V - 1)
        u_imp = prng.uniform(k_imp, (M, cfg.import_attempts, 2), dev)
        ncls = arrays.import_cum_p.shape[0]
        cls = torch.clamp(searchsorted(arrays.import_cum_p, u_imp[..., 0]),
                          0, ncls - 1).long()
        lo = arrays.age_start[arrays.import_min_age[cls].long()]
        hi = arrays.age_start[torch.clamp_max(
            arrays.import_max_age[cls] + 1, A).long()]
        pos = lo + torch.floor(
            u_imp[..., 1] * torch.clamp_min(hi - lo, 1).to(F32)).to(I32)
        cand = torch.clamp(pos, 0, N - 1)
        cand_ok = susceptible[cand.long()] & (hi > lo)
        first = torch.argmax(cand_ok.to(I32), dim=1)
        any_ok = cand_ok.any(dim=1)
        import_agent = cand[torch.arange(M, device=dev), first]
        import_tgt = torch.where(slot_valid & any_ok, import_agent, N).long()
        # an agent picked by an import loses any same-day contact
        # infection; the import's variant wins
        newly = _spare(new_contact, False)
        newly[import_tgt] = True
        newly = newly[:N]
        variant_new = _spare(new_variant, 0)
        variant_new[import_tgt] = slot_variant
        variant_new = variant_new[:N]
        nc2 = _spare(new_contact, False)
        nc2[import_tgt] = False
        new_contact = nc2[:N]

    Kcap = cfg.infection_buffer
    Kh = min(cfg.infection_head, Kcap)
    variant = state.variant.to(I32)
    c_s = torch.where(exposer, k_s.to(F32) * inf_base, 0.0)
    cum_newly = fused_concat_prefix(newly.to(F32), None, 1)
    cum_cat = fused_concat_prefix(c_s, variant, V)
    n_new = int(cum_newly[-1])
    if n_new > Kcap:
        problem = problem | C.PROBLEM_INFECTION_BUFFER_OVERFLOW
    n_used = min(n_new, Kcap)

    C_av = (K_g * ig).sum(dim=(2, 3))                              # (A, V)
    kappa_inc = 1.0 / (C.INCUBATION_CV ** 2)
    kappa_o2r = 1.0 / (C.ONSET_TO_REMOVED_CV ** 2)
    slot_ends = [lo_ + seg for lo_, seg in tier_bounds(Kh, Kcap)]
    end = _tier_end(slot_ends, n_used)

    # compaction of today's infections into slots [0, end)
    slots = torch.arange(end, dtype=I32, device=dev)
    buf = searchsorted(cum_newly, (slots + 1).to(F32))
    buf_agent = torch.where(slots < n_used, buf, N)

    # slot pipeline: attribution, severity and duration draws
    bp = torch.clamp(buf_agent, 0, N - 1).long()
    slot_used = buf_agent < N
    contact_p = new_contact[bp] & slot_used
    age_i = age[bp].long()
    b_i = arrays.band_of_age[age_i].long()
    v_i = variant_new[bp].long()
    w = C_av.T[v_i] * Tq.permute(0, 2, 1)[v_i, b_i]               # (m, A)
    gumb = prng.gumbel(dk.attr_age[0], w.shape, dev)
    logw = torch.where(w > 0, torch.log(torch.clamp_min(w, 1e-30)),
                       -float("inf"))
    a_star = torch.argmax(logw + gumb, dim=1)
    u_src = prng.uniform(dk.attr_src[0], (end,), dev)
    off = v_i * N
    lo_i = off + arrays.age_start[a_star]
    hi_i = off + arrays.age_start[a_star + 1]
    both = cum_cat[torch.cat([torch.clamp_min(lo_i - 1, 0),
                              torch.clamp_min(hi_i - 1, 0)])]
    lo_c = torch.where(lo_i > 0, both[:end], 0.0)
    hi_c = both[end:]
    x = lo_c + u_src * (hi_c - lo_c)
    pos = torch.minimum(torch.maximum(searchsorted(cum_cat, x).long(), lo_i),
                        hi_i)
    src = torch.clamp(pos - off, 0, N - 1)
    ok = (hi_c > lo_c) & contact_p
    infector_new = torch.where(ok, src, -1).to(I32)
    tr_slot = ok & state.traceable[src]
    g1 = gamma_fixed(dk.gam1[0], kappa_inc, (end,), dev)
    g2 = gamma_fixed(dk.gam2[0], kappa_o2r, (end,), dev)
    dov_i = dov[bp]
    val = prng.uniform(dk.sev[0], (end,), dev)
    sev_slot, outside_slot = severity_from_uniform(
        val, arrays.p_sympt[v_i, age_i], arrays.p_doh[v_i, age_i],
        arrays.p_severe_c[v_i, age_i], arrays.p_critical_c[v_i, age_i],
        arrays.p_fatal_c[v_i, age_i], vaccine_modifier(dov_i, day))
    theta_inc = (C.INCUBATION_CV ** 2) * arrays.mu_incub[v_i]
    incub_slot = _round_to_int(g1 * theta_inc)
    mu_o2r = torch.where(sev_slot == C.FATAL, arrays.mu_death[v_i],
                         arrays.mu_recov[v_i])
    o2r_slot = g2 * (C.ONSET_TO_REMOVED_CV ** 2) * mu_o2r

    # infectee-bucket appends: sorted by source, ranked within runs;
    # positions past a source's capacity drop (TOO_MANY_INFECTEES)
    e_valid = slot_used & (infector_new >= 0) & tr_slot
    n_app = torch.sum(e_valid, dtype=I32)
    SENT = 1 << 30
    sort_src = torch.where(e_valid, infector_new, SENT)
    src_s, perm = torch.sort(sort_src, stable=True)
    dst_s = buf_agent[perm]
    idx = torch.arange(end, dtype=I32, device=dev)
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          src_s[1:] != src_s[:-1]])
    run_start = torch.cummax(torch.where(is_first, idx, 0), 0).values
    rank = idx - run_start
    valid = src_s < SENT
    sp = torch.clamp(src_s, 0, N - 1)
    j = bkt_fill[sp.long()] + rank
    store = valid & (j < CAPB)
    app_pos = torch.where(store, sp * CAPB + torch.clamp_max(j, CAPB - 1),
                          NC + idx)
    app_val = torch.where(store, dst_s, N)
    app_src = torch.where(valid, sp, N)
    problem = problem | torch.where(torch.any(valid & (j >= CAPB)),
                                    C.PROBLEM_TOO_MANY_INFECTEES, 0).to(I32)
    if end < Kcap:
        tail = torch.arange(end, Kcap, dtype=I32, device=dev)
        app_pos = torch.cat([app_pos, NC + tail])
        app_val = torch.cat([app_val, torch.full_like(tail, N)])
        app_src = torch.cat([app_src, torch.full_like(tail, N)])

    # slot-domain scatters: the used slots are the prefix [0, n_used)
    tgt = buf_agent[:n_used].long()
    infector = state.infector.index_put((tgt,), infector_new[:n_used])
    sev_out = state.severity.index_put((tgt,), sev_slot[:n_used])
    death_outside = state.death_outside.index_put((tgt,),
                                                  outside_slot[:n_used])
    days_left = days_left.index_put((tgt,), incub_slot[:n_used])
    o2r = o2r.index_put((tgt,), o2r_slot[:n_used])
    src_ok = slot_used & (infector_new >= 0)
    n_infected = state.n_infected.index_add(
        0, torch.where(src_ok, infector_new, 0).long(), src_ok.to(I32))
    fill_ok = app_src < N
    bkt_fill = bkt_fill.index_add(0, torch.where(fill_ok, app_src, 0).long(),
                                  fill_ok.to(I32))

    # ---- finalize
    (st8_out, sev8_out, var8_out, dl16_out, doil16_out, doi16_out,
     is_infected, traceable, detected_today) = fused_map(
        finalize,
        [new_st, sev_out, state.variant, variant_new, days_left,
         day_of_illness, state.day_of_infection, newly, is_infected,
         state.traceable, detected_today, detect_hosp],
        [day, int(ct_active)])

    # ---- phase 7: outputs
    fields = [active, is_infected, has_immunity, dov, detected_today,
              st8_out, ever_icu, death_outside, newly]
    by10 = fused_fn_onehot_sum(fields, _output_masks_reduced, 10,
                               arrays.group_of_agent,
                               cfg.nr_groups + 1)[:, :-1].to(I32)
    (vacc_g, ever_g, det_g, inicu_g, cicu_g, ward_g, dead_g, rec_g,
     nh_g, new_g) = by10
    all_detected = carry.all_detected + det_g
    by_group = torch.stack([
        arrays.active_per_group - ever_g, vacc_g, ever_g - dead_g - rec_g,
        ever_g, det_g, all_detected, inicu_g, cicu_g, ward_g, dead_g, rec_g,
        nh_g, new_g])
    exposures = _exposures_by_place(k_place, K_g, q_hat)
    inf_by_variant = torch.stack(
        [torch.sum(newly & (variant_new == v), dtype=I32) for v in range(V)])

    out = DayOutputs(
        by_group=by_group,
        available_hospital_beds=beds_after,
        available_icu_units=icu_after,
        total_icu_units=icu_total,
        r=r_value,
        exposed_per_day=exposed_per_day,
        ct_cases_per_day=ct_cases,
        mobility_limitation=np.float32(1.0) - np.float32(
            sched.mobility_scalar),
        exposures_by_place=exposures,
        infected_by_variant=inf_by_variant,
    )
    new_state = AgentState(
        age=state.age, state=st8_out, severity=sev8_out, variant=var8_out,
        death_outside=death_outside, days_left=dl16_out,
        day_of_illness=doil16_out, day_of_infection=doi16_out,
        day_of_vaccination=dov, o2r=o2r, infector=infector,
        n_infected=n_infected, is_infected=is_infected,
        has_immunity=has_immunity, was_detected=was_detected, queued=queued,
        traceable=traceable, ever_icu=ever_icu, included_in_totals=included,
        active=active)
    new_carry = DayCarry(
        day=day + 1, beds_avail=beds_after, icu_avail=icu_after,
        beds_total=beds_total, icu_total=icu_total, weekly_leftover=leftover,
        all_detected=all_detected, problem=problem, bkt_dst=bd,
        bkt_fill=bkt_fill, mob=sched.mobility, nc_ag=nc_ag,
        app_pos=app_pos, app_val=app_val, app_n=n_app)
    return new_state, new_carry, out


def _exposures_by_place(key, K_g, q_hat):
    """Per-place split of all drawn contacts (independent per-place
    binomials, as the JAX package draws them)."""
    K_age = K_g.sum(dim=(1, 2, 3))                                 # (A,)
    qp = q_hat.sum(dim=2)                                          # (A, P)
    counts = _binomial_split(key, K_age, qp)
    return counts.sum(dim=0).to(I32)


def snapshot_outputs(cfg: EngineConfig, arrays: ModelArrays,
                     state: AgentState, carry: DayCarry,
                     mobility_scalar) -> DayOutputs:
    """The day-0 snapshot before any events."""
    V = cfg.nr_variants
    dev = state.age.device
    st = state.state
    active = state.active
    ever = state.is_infected | state.has_immunity
    zero = torch.zeros_like(active)
    dead_m = st == C.DEAD
    masks = [
        active & ~ever,
        active & (state.day_of_vaccination >= 0),
        active & state.is_infected,
        active & ever,
        zero,
        zero,  # replaced by carry.all_detected below
        active & (st == C.IN_ICU),
        active & state.ever_icu,
        active & (st == C.HOSPITALIZED),
        active & dead_m,
        active & (st == C.RECOVERED),
        active & dead_m & state.death_outside,
        zero,
    ]
    by_group = _group_counts(cfg, arrays, masks)
    by_group[5] = carry.all_detected
    zi = torch.zeros((), dtype=I32, device=dev)
    return DayOutputs(
        by_group=by_group,
        available_hospital_beds=carry.beds_avail,
        available_icu_units=carry.icu_avail,
        total_icu_units=carry.icu_total,
        r=torch.zeros((), dtype=F32, device=dev),
        exposed_per_day=zi,
        ct_cases_per_day=zi,
        mobility_limitation=np.float32(1.0) - np.float32(mobility_scalar),
        exposures_by_place=torch.zeros(C.NR_PLACES, dtype=I32, device=dev),
        infected_by_variant=torch.zeros(V, dtype=I32, device=dev),
    )
