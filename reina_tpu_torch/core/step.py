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

The JAX package compiles the day, and picks each data-dependent size on
the device (``lax.cond``/``lax.switch`` into geometric tiers). Here the
day is a program (``day_program``) of spans and of the tier picks
between them, each pick reading a count that the span before it gave:

  A       day start: capacity builds, the drain, yesterday's bucket
          appends; on a tracing day the drained agents' count ct_cases
          and their compaction to n_d;
  T       on a tracing day, T1-T4 if ct_cases > 0 (the JAX package's
          cond): level 1 at the member tier of n_d, then its buckets at
          the column tier of their fill and the frontier's compaction to
          n_f, level 2 at the member tier of n_f and its column tier;
  B       vaccination, exposure, the ledger, the post pass, imports and
          both prefixes, ending with n_new (A and B are one span "AB" on
          a day without contact tracing);
  C       at the slot tier of n_new: the slot pipeline, the bucket
          appends, finalize and phase 7.

A pick's branch is the JAX package's searchsorted into the tier
ceilings, clamped to the last branch (``tier_branch``); each tier still
draws at its ceiling's shape, which keeps the random streams bit-equal.
A span is keyed by its tier and by what the schedule says (tracing on,
a vaccination day, imports), and reads every value that varies from day
to day from device memory: the day row (``DayIn``: the day, the
schedule's scalars, the ledger's offset, the import counts, the
mobility and mask tables and the day's keys as ``prng.DevKey``s), the
state, the carry and the tensors earlier spans handed on; host values
reach it only through its key. The plain ``day_step`` (``run_day``)
reads each pick's count on the host and runs the span it names; the
graph runner (core/graphs.py) runs a day as one CUDA graph in which each
pick is made by the kernel that produces its count (core/daygraph.py:
FOLDS: the counts' producers take a fold site, ``compact_indices``,
``prefix_count`` and ``count_max``) and sets a conditional node, so the
host reads nothing.
Scatters with the JAX package's ``mode="drop"`` sentinels go to one
spare slot past the end of a buffer. The four fused per-agent bodies
below (``prologue``, ``recv_front``, ``post``, ``finalize``) are the
plain twins of the kernels in reina_tpu_torch/kernels/fused_bodies.py;
``fused_map`` picks one or the other by device.

An agent-sharded run (parallel/mesh.py) steps the same spans with a
``shard``: per-agent tensors then hold this rank's slab of the agent
axis, 1-D draws over the agents take their slab's counters, indices into
the agent axis stay global, and the points where the day crosses agents
go through the shard's collectives: sums of counts and histograms, the
sharded ledger and prefix, lookups of per-agent values at global indices
and scatters that only the owner applies. The slot domain (new
infections, imports, tracing buffers) is replicated: every rank draws
and sorts the same slots. Every pick reads a global value, so the ranks
take the same tiers: on the host in the plain step, and in the graphed
day inside the producing kernels, which run after the collective that
makes their count global (the sharded prefix's emit writes n_new, n_d
and n_f after its all-gather; the tracing cond reads ct_cases after its
all-reduce; T2's and T4's maxima are taken over the lookups' replicated
fills). No value crosses to the host inside a day: the ledger's slab
entries read the day's offset from the day row. With ``shard=None``
each of those points is the plain op.
"""
from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass
from itertools import product
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import constants as C
from .schedule import Schedules
from .state import AgentState, DayCarry
from ..ops import prng
from ..ops.clamped import clamped_counter_grants
from ..ops.compact import compact_indices, count_max
from ..ops.fusedmap import (fused_bihistogram, fused_concat_prefix,
                            fused_fn_onehot_sum, fused_map,
                            fused_onehot_sum, prefix_count,
                            sharded_concat_prefix, sharded_prefix_count)
from ..ops import random as samplers
from ..ops.random import binomial_fixed, gamma_fixed_pair, searchsorted
from ..utils import perf
# the program's counters (utils/perf.py), read here as step.STATS
from ..utils.perf import STATS, reset_stats  # noqa: F401

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
    everything else as host numpy values (``plan_day`` turns them into
    the day row)."""
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
    """One day's outputs: tensors on the run's device, but
    ``mobility_limitation``, a host value."""
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


def vaccine_modifier(dov_i, day):
    return torch.where((dov_i >= 0) & ((day - dov_i.to(I32))
                                       > C.VACCINE_DELAY_DAYS),
                       1.0 - C.VACCINE_EFFICACY, 1.0).to(F32)


def severity_draw_slots(key, arrays, v_i, age_i, dov_i, day):
    """get_symptom_severity (main.pyx:1041-1091) on the infection-slot
    domain: one uniform per slot from ``key``, then the decision chain
    on the (variant, age) table entries of ``arrays`` (any object with
    the p_sympt, p_doh, p_severe_c, p_critical_c and p_fatal_c tables as
    tensors); ``day`` an int or a 0-d tensor. The day step and the
    parameter explorer (``sampling.py``) both draw through it. Returns
    (severity int8, death_outside bool)."""
    val = prng.uniform(key, tuple(v_i.shape), v_i.device)
    return severity_from_uniform(
        val, arrays.p_sympt[v_i, age_i], arrays.p_doh[v_i, age_i],
        arrays.p_severe_c[v_i, age_i], arrays.p_critical_c[v_i, age_i],
        arrays.p_fatal_c[v_i, age_i], vaccine_modifier(dov_i, day))


def _binomial_split(key, totals, probs):
    """Independent Binomial(totals, p_b) per trailing category, drawn
    on the flattened domain (bit-equal to the JAX package)."""
    n_full = totals[..., None].to(F32).expand(probs.shape)
    flat = binomial_fixed(key, n_full.reshape(-1), probs.to(F32).reshape(-1))
    return flat.reshape(probs.shape)


def _group_counts(cfg: EngineConfig, arrays: ModelArrays, masks, shard=None):
    counts = fused_onehot_sum(list(masks), arrays.group_of_agent,
                              cfg.nr_groups + 1)
    return _total(shard, counts[:, :-1].to(I32))


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
    # mode and dap: numbers or 0-d tensors (the day row)
    queue_new = seek & ((mode == C.TESTING_ALL_WITH_SYMPTOMS)
                        | (mode == C.TESTING_ALL_WITH_SYMPTOMS_CT)
                        | ((mode == C.TESTING_ONLY_SEVERE_SYMPTOMS)
                           & ((sev >= C.SEVERE) | (u_day < dap))))

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
            trc | (newly & (ct != 0)), det | det_hosp)


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


def _ceilings(head: int, cap: int):
    return [lo + seg for lo, seg in tier_bounds(min(head, cap), cap)]


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


# the day's draws in the key table: plain keys (2 words), the samplers'
# keys followed by their split words (ops/random.py) for the rounds the
# day step runs (the samplers' defaults)
_PLAIN_KEYS = ("contact", "inf", "var", "imp", "anyway", "mem", "l1", "e1",
               "e2", "attr_age", "attr_src", "sev")
GAMMA_ROUNDS, BINOMIAL_ROUNDS = 4, 6
_SAMPLER_KEYS = (("gam1", samplers.gamma_words, GAMMA_ROUNDS),
                 ("gam2", samplers.gamma_words, GAMMA_ROUNDS),
                 ("bin", samplers.binomial_words, BINOMIAL_ROUNDS),
                 ("place", samplers.binomial_words, BINOMIAL_ROUNDS))


def _day_key_pairs(cfg: EngineConfig, dk: DayKeys) -> Dict[str, np.ndarray]:
    """The (…, 2) key of each draw of the day, by slot name."""
    b = dk.base
    keys = dict(
        contact=b[..., 0, :], bin=b[..., 1, :], place=b[..., 2, :],
        inf=b[..., 3, :], var=b[..., 4, :], imp=b[..., 10, :],
        anyway=b[..., 13, :], mem=dk.k_mem, l1=dk.l1[..., 0, :],
        e1=dk.e1[..., 0, :], e2=dk.e2[..., 0, :],
        attr_age=dk.attr_age[..., 0, :], attr_src=dk.attr_src[..., 0, :],
        sev=dk.sev[..., 0, :], gam1=dk.gam1[..., 0, :],
        gam2=dk.gam2[..., 0, :])
    for s in range(cfg.vacc_slots):
        keys[f"vacc{s}"] = dk.vacc[..., s, :]
    return keys


def key_slots(cfg: EngineConfig) -> Dict[str, tuple]:
    """Slot name → (first word, words, rounds) in a day's key table."""
    slots, at = {}, 0
    names = _PLAIN_KEYS + tuple(f"vacc{s}" for s in range(cfg.vacc_slots))
    for name in names:
        slots[name] = (at, 2, 0)
        at += 2
    for name, words_of, rounds in _SAMPLER_KEYS:
        w = 2 + words_of(np.zeros(2, np.uint32), rounds).size
        slots[name] = (at, w, rounds)
        at += w
    return slots


def key_table(cfg: EngineConfig, dk: DayKeys) -> np.ndarray:
    """The key table of a day (…, KW) uint32, vectorised over the leading
    axes of ``dk`` (``derive_day_keys``'s day axis)."""
    pairs = _day_key_pairs(cfg, dk)
    words_of = {name: (f, r) for name, f, r in _SAMPLER_KEYS}
    cols = []
    for name in key_slots(cfg):
        cols.append(pairs[name])
        if name in words_of:
            f, rounds = words_of[name]
            cols.append(f(pairs[name], rounds))
    return np.concatenate(cols, axis=-1).astype(np.uint32)


def dev_keys(cfg: EngineConfig, words: torch.Tensor) -> Dict[str, "prng.DevKey"]:
    """The DevKey of each slot of a key table held in ``words`` (KW,)
    int32 on a device: views, so a table rewritten in place gives the
    draws their new keys."""
    return {name: prng.DevKey(words[at:at + w], rounds)
            for name, (at, w, rounds) in key_slots(cfg).items()}


# ---------------------------------------------------------------------------
# the day row: what varies from day to day, decided on the host from the
# schedule and put where the spans read it

# int32 row: the day, the testing mode, contact tracing on, the capacity
# builds, the ledger's sweep offset, today's imports and their cumulative
# counts by variant (V entries from I_CUM_IMP)
I_DAY, I_MODE, I_CT, I_BEDS, I_ICU, I_OFFSET, I_TOT_IMP, I_CUM_IMP = range(8)
# float32 row: trace_p, detect_anyway_p, floor(vacc_nr) of each slot
F_TRACE, F_DAP, F_VACC = range(3)


class DayPlan(NamedTuple):
    """A day as the host sees it before it runs."""
    day: int
    ct_active: bool        # contact tracing on (testing mode ..._CT)
    vacc: bool             # a vaccination day
    imports: bool          # imported infections today
    problem: int           # problem bits known from the schedule
    leftover: np.ndarray   # the weekly-import carry after today (V,)
    mobility_limitation: np.float32
    ints: np.ndarray       # the int32 day row
    floats: np.ndarray     # the float32 day row


class DayPlans(NamedTuple):
    """The plans of consecutive days: DayPlan's fields over a leading day
    axis (``plan_days``)."""
    day: np.ndarray        # (D,) int64
    ct_active: np.ndarray  # (D,) bool
    vacc: np.ndarray       # (D,) bool
    imports: np.ndarray    # (D,) bool
    problem: np.ndarray    # (D,) int64
    leftover: np.ndarray   # (D, V) float32
    mobility_limitation: np.ndarray  # (D,) float32
    ints: np.ndarray       # (D, I_CUM_IMP + V) int32
    floats: np.ndarray     # (D, F_VACC + S) float32

    def each(self) -> List[DayPlan]:
        """Each day's DayPlan: host scalars, and views of the day's rows."""
        return [DayPlan(*p) for p in zip(
            self.day.tolist(), self.ct_active.tolist(), self.vacc.tolist(),
            self.imports.tolist(), self.problem.tolist(), self.leftover,
            self.mobility_limitation, self.ints, self.floats)]


def plan_days(cfg: EngineConfig, rows: Schedules, leftover, day0: int,
              dks: DayKeys, n_agents: int) -> DayPlans:
    """Phase 1's host arithmetic and the day rows of days [day0, day0 +
    D), D the day axis of ``dks`` (``derive_day_keys`` over those days),
    as arrays over the days. ``rows``: the host schedules of those days,
    day axis first (their mobility and mask tables are not read);
    ``leftover``: the weekly-import carry before day0; ``n_agents``: the
    run's (padded) agent count, the range of the ledger's offset. The
    weekly imports are float32, as the JAX package's device arithmetic,
    and a day's carry is the day before's: one loop over the days."""
    D, V = len(dks.base), cfg.nr_variants
    inc = ((np.asarray(rows.weekly_amount, np.float32) / np.float32(7.0))
           [:, None] * np.asarray(rows.weekly_shares, np.float32))
    weekly = np.empty((D, V), np.int32)
    left = np.empty((D, V), np.float32)
    carry = np.asarray(leftover, np.float32)
    for i in range(D):
        carry = carry + inc[i]
        weekly[i] = np.floor(carry).astype(np.int32)
        carry = left[i] = carry - weekly[i].astype(np.float32)
    cum_imp = np.cumsum(np.asarray(rows.import_today, np.int32) + weekly,
                        axis=1).astype(np.int32)
    tot_imports = cum_imp[:, -1]
    mode = np.asarray(rows.testing_mode, np.int64)
    ct_active = mode == C.TESTING_ALL_WITH_SYMPTOMS_CT
    vacc_nr = np.asarray(rows.vacc_nr, np.float32)
    days = day0 + np.arange(D, dtype=np.int64)
    offsets = prng.randint(dks.base[:, 14], 0, n_agents)
    ints = np.column_stack([days, mode, ct_active, rows.beds_build,
                            rows.icu_build, offsets, tot_imports,
                            cum_imp]).astype(np.int32)
    floats = np.column_stack([rows.trace_p, rows.detect_anyway_p,
                              np.floor(vacc_nr)]).astype(np.float32)
    return DayPlans(
        day=days, ct_active=ct_active,
        vacc=np.sum(vacc_nr, axis=1) >= 1.0, imports=tot_imports > 0,
        problem=np.where(tot_imports > cfg.import_buffer,
                         C.PROBLEM_IMPORT_BUFFER_OVERFLOW, 0),
        leftover=left,
        mobility_limitation=np.float32(1.0) - np.asarray(
            rows.mobility_scalar, np.float32),
        ints=ints, floats=floats)


def plan_day(cfg: EngineConfig, sched: SchedRow, leftover, day: int,
             dk: DayKeys, n_agents: int) -> DayPlan:
    """``plan_days`` of one day, from its schedule row and keys."""
    host = sched._replace(mobility=None, mask_p=None)
    rows = Schedules(*(x if x is None else np.asarray(x)[None]
                       for x in host))
    dks = DayKeys(*(np.asarray(x)[None] for x in dk))
    return plan_days(cfg, rows, leftover, day, dks, n_agents).each()[0]


class DayIn(NamedTuple):
    """The day row on the device, where the spans read it."""
    ints: torch.Tensor     # int32 (I_CUM_IMP + V,)
    floats: torch.Tensor   # float32 (F_VACC + S,)
    mobility: torch.Tensor  # (A, P)
    mask_p: torch.Tensor   # (A, P)
    keys: Dict[str, "prng.DevKey"]   # views of the day's key table


def day_inputs(cfg: EngineConfig, plan: DayPlan, words: np.ndarray,
               mobility: torch.Tensor, mask_p: torch.Tensor) -> DayIn:
    """A DayIn on the mobility table's device, from a plan and the day's
    key table."""
    dev = mobility.device

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return DayIn(up(plan.ints), up(plan.floats), mobility, mask_p,
                 dev_keys(cfg, up(np.asarray(words, np.uint32)
                                  .view(np.int32))))


def _spare(x, fill):
    """x with one spare element appended (a drop target for scatters)."""
    return torch.cat([x, torch.full((1,), fill, dtype=x.dtype,
                                    device=x.device)])


# the day's points across agents: the plain op unsharded, the shard's
# collective in an agent-sharded run

def _total(shard, *xs):
    """Counts and histograms of the slab summed over the agent group."""
    if shard is None:
        return xs[0] if len(xs) == 1 else list(xs)
    return shard.sum(*xs)


def _local(shard, idx, scale: int = 1):
    """Global indices (sentinel N·scale) → indices into this slab's
    arrays with their spare entry; identity unsharded."""
    return idx if shard is None else shard.local(idx, scale)


def _look(shard, arrays, idx, scale: int = 1):
    """[a[idx] for a in arrays] at global indices."""
    if shard is None:
        return [a[idx] for a in arrays]
    return shard.lookup(arrays, idx, scale)


def _put(shard, x, idx, vals):
    """x with vals put at global indices ``idx``, by their owner; the
    sentinel N drops."""
    n = x.shape[0]
    return _spare(x, 0).index_put_((_local(shard, idx).long(),), vals)[:n]


def _add(shard, x, idx, vals):
    """x.index_add(0, idx, vals) at global indices, by their owner."""
    if shard is None:
        return x.index_add(0, idx, vals)
    n = x.shape[0]
    return _spare(x, 0).index_add_(0, shard.local(idx).long(), vals)[:n]


def _compact(shard, mask, capacity: int, name=None, given=None):
    """compact_indices over the whole agent axis: the first
    ``capacity`` set global indices (sentinel N) and the global count;
    each rank's part of the global prefix, then a search for each slot.
    ``name``, ``given``: the count's fold site and the other counts its
    picks read (on a shard the sharded prefix's emit makes them, after
    its all-gather: the count is global)."""
    if shard is None:
        return compact_indices(mask, capacity, name, given)
    cum, count = sharded_prefix_count(mask.to(F32), shard, name, given)
    slots = torch.arange(capacity, dtype=I32, device=mask.device)
    buf = shard.first_at_least(cum, (slots + 1).to(F32)).to(I32)
    used = slots < torch.clamp_max(count, capacity)
    return torch.where(used, buf, shard.n), count


def _dims(state: AgentState, shard):
    """(agents here, agents in the run, the first one here, device)."""
    n = state.age.shape[0]
    return (n, n if shard is None else shard.n,
            0 if shard is None else shard.lo, state.age.device)


# ---------------------------------------------------------------------------
# the spans: span(cfg, arrays, din, state, carry, env, *key, shard) →
# dict of tensors; ``env`` holds what the earlier spans of the day gave.
# A span reads no host value but its key's, and writes in place only
# the carry's bucket table.

def span_a(cfg: EngineConfig, arrays: ModelArrays, din: DayIn,
           state: AgentState, carry: DayCarry, env, trace: bool,
           shard=None):
    """Day start: capacity builds, the testing queue's drain (phase 3)
    and yesterday's pending bucket appends; with ``trace``, the
    compaction of the drained agents and its count n_d."""
    _, N, _, _ = _dims(state, shard)
    drained = state.queued
    drained_here = drained & state.active
    ct_cases = _total(shard, torch.sum(drained_here, dtype=I32))
    out = dict(
        beds_total=carry.beds_total + din.ints[I_BEDS],
        icu_total=carry.icu_total + din.ints[I_ICU],
        beds_avail=carry.beds_avail + din.ints[I_BEDS],
        icu_avail=carry.icu_avail + din.ints[I_ICU],
        ct_cases=ct_cases,
        detected_today=drained & ~state.was_detected,
        wdet=state.was_detected | drained,
        queued=torch.zeros_like(drained))
    # yesterday's pending bucket appends; drop sentinels (≥ NC) land in
    # the table's spare last slot
    CAPB = cfg.max_infectees
    app = (torch.clamp_max(carry.app_pos, N * CAPB) if shard is None
           else shard.local(carry.app_pos, CAPB))
    carry.bkt_dst.index_put_((app.long(),), carry.app_val)
    if trace:
        dbuf, n_d = _compact(shard, drained_here, cfg.infection_buffer,
                             "n_d", {"ct_cases": ct_cases})
        out.update(dbuf=dbuf, n_d=n_d)
    return out


def _mark(x, idx, value: bool) -> None:
    """x[idx] = value, the value made on x's device (a Python scalar
    put into a CUDA tensor is copied from the host, which a graph
    capture refuses)."""
    x.index_put_((idx.long(),), torch.full((), value, dtype=x.dtype,
                                           device=x.device))


def _blank(n: int, dev):
    return torch.zeros(n + 1, dtype=torch.bool, device=dev)


def _bucket_setup(cfg, state, carry, members_buf, src_ok, end: int, shard):
    """The first ``end`` slots of a compacted member buffer: their agents
    (bp) and their bucket fills (0 for empty slots and, with ``src_ok``,
    for members it rules out)."""
    _, N, _, _ = _dims(state, shard)
    seg_buf = members_buf[:end]
    used = seg_buf < N
    bp = torch.clamp(seg_buf, 0, N - 1).long()
    srcs = [carry.bkt_fill] if src_ok is None else [carry.bkt_fill, src_ok]
    fill_b = _look(shard, srcs, bp)
    ok_m = used if src_ok is None else used & fill_b[1]
    fill_m = torch.where(ok_m, torch.clamp_max(fill_b[0], cfg.max_infectees),
                         0)
    return bp, fill_m


def _bucket_cols(cfg, din, state, carry, bp, fill_m, end: int, jend: int,
                 key, hit, hit_r2, r2_tab, shard):
    """The first ``jend`` columns of the members' infectee buckets, each
    traced with probability trace_p: marks the hit infectees in ``hit``
    and, with ``hit_r2``, their r2_tab entries."""
    _, N, _, dev = _dims(state, shard)
    CAPB = cfg.max_infectees
    cols = torch.arange(jend, dtype=I64, device=dev)
    idx = (bp[:, None] * CAPB + cols[None, :]).reshape(-1)
    dst = _look(shard, [carry.bkt_dst], idx, CAPB)[0].reshape(end, jend)
    live = cols[None, :] < fill_m[:, None]
    u = prng.uniform(key, (end, jend), dev)
    fire = live & (u < din.floats[F_TRACE])
    tgt = torch.where(fire, dst, N).reshape(-1)
    _mark(hit, _local(shard, tgt), True)
    if hit_r2 is not None:
        r2 = _look(shard, [r2_tab], torch.clamp(dst, 0, N - 1).long())[0]
        t2 = torch.where(fire, r2, N).reshape(-1)
        _mark(hit_r2, _local(shard, t2), True)


def span_t1(cfg, arrays, din, state, carry, env, end: int, shard=None):
    """Tracing level 1 on the first ``end`` drained agents: each one's
    infector (and its own infector, r2), then the bucket column ceiling
    of their infectee buckets."""
    n, N, lo, dev = _dims(state, shard)
    trace_p = din.floats[F_TRACE]
    eligible = (state.active & ~(state.state == C.DEAD) & ~env["wdet"]
                & ~env["queued"])
    u_mem = prng.uniform(din.keys["mem"], (n,), dev, start=lo)
    infector = state.infector
    r2_tab = torch.where(eligible & (u_mem < trace_p) & (infector >= 0),
                         infector, N)
    seg_buf = env["dbuf"][:end]
    used = seg_buf < N
    inf_s = _look(shard, [infector],
                  torch.clamp(seg_buf, 0, N - 1).long())[0]
    u1 = prng.uniform(din.keys["l1"], (end,), dev)
    succ = used & (inf_s >= 0) & (u1 < trace_p)
    tgt = torch.where(succ, inf_s, N)
    hit1, hit_r2 = _blank(n, dev), _blank(n, dev)
    _mark(hit1, _local(shard, tgt), True)
    r2 = _look(shard, [r2_tab], torch.clamp(tgt, 0, N - 1).long())[0]
    _mark(hit_r2, _local(shard, torch.where(succ, r2, N)), True)
    _, fill_m = _bucket_setup(cfg, state, carry, env["dbuf"],
                              state.is_infected, end, shard)
    return dict(eligible=eligible, r2_tab=r2_tab, hit1=hit1, hit_r2=hit_r2,
                fill_max=count_max(fill_m, "fill_max"))


def span_t2(cfg, arrays, din, state, carry, env, end: int, jend: int,
            shard=None):
    """Level 1's infectee buckets (``jend`` columns), then the
    compaction of the level-2 frontier and its count n_f."""
    n, _, _, _ = _dims(state, shard)
    bp, fill_m = _bucket_setup(cfg, state, carry, env["dbuf"],
                               state.is_infected, end, shard)
    hit, hit_r2 = env["hit1"].clone(), env["hit_r2"].clone()
    _bucket_cols(cfg, din, state, carry, bp, fill_m, end, jend,
                 din.keys["e1"], hit, hit_r2, env["r2_tab"], shard)
    newq1 = env["eligible"] & hit[:n]
    frontier = newq1 & state.is_infected & (carry.bkt_fill > 0)
    fbuf, n_f = _compact(shard, frontier, cfg.infection_buffer, "n_f")
    return dict(hit12=hit, hit_r2ab=hit_r2, fbuf=fbuf, n_f=n_f)


def span_t3(cfg, arrays, din, state, carry, env, end: int, shard=None):
    """Level 2: the bucket column ceiling of the first ``end`` frontier
    agents."""
    _, fill_m = _bucket_setup(cfg, state, carry, env["fbuf"], None, end,
                              shard)
    return dict(fill2_max=count_max(fill_m, "fill2_max"))


def span_t4(cfg, arrays, din, state, carry, env, end: int, jend: int,
            shard=None):
    """Level 2's infectee buckets; the day's testing queue."""
    n, _, _, dev = _dims(state, shard)
    bp, fill_m = _bucket_setup(cfg, state, carry, env["fbuf"], None, end,
                               shard)
    hit2 = _blank(n, dev)
    _bucket_cols(cfg, din, state, carry, bp, fill_m, end, jend,
                 din.keys["e2"], hit2, None, None, shard)
    queued = env["queued"] | (env["eligible"]
                              & (env["hit12"][:n] | env["hit_r2ab"][:n]
                                 | hit2[:n]))
    return dict(queued=queued)


def span_b(cfg, arrays, din, state, carry, env, vacc: bool, imports: bool,
           shard=None):
    """Vaccination (a vaccination day), exposure, progression through
    the ledgers and the post pass, imports (a day with imports) and the
    prefixes of today's infections; ends with n_new."""
    n, N, lo, dev = _dims(state, shard)
    A = arrays.age_start.shape[0] - 1
    V = cfg.nr_variants
    day = din.ints[I_DAY]
    kd = din.keys
    age = state.age.to(I32)
    active = state.active
    is_dead = state.state == C.DEAD
    wdet = env["wdet"]

    dov = state.day_of_vaccination
    if vacc:
        for s in range(cfg.vacc_slots):
            nr = din.floats[F_VACC + s]
            eligible = (active & ~is_dead & ~wdet & (dov < 0)
                        & (age >= arrays.vacc_min_age[s])
                        & (age <= arrays.vacc_max_age[s]))
            counts = _total(shard, fused_onehot_sum(
                [eligible], arrays.ages, A)[0])                   # (A,)
            older = torch.cat([torch.cumsum(counts.flip(0), 0)[:-1].flip(0),
                               torch.zeros(1, dtype=F32, device=dev)])
            need_a = nr - older
            frac_eff = torch.where(
                need_a <= 0, 0.0,
                torch.where(counts <= need_a, 1.0,
                            torch.clamp(need_a / torch.clamp_min(counts, 1.0),
                                        0.0, 1.0)))
            u_vac = prng.uniform(kd[f"vacc{s}"], (n,), dev, start=lo)
            take = eligible & (u_vac < expand_by_age(arrays, frac_eff))
            dov = torch.where(take, day, dov.to(I32)).to(I16)

    # ---- phase 4: exposure
    q = arrays.contact_base * din.mobility[:, :, None]            # (A, P, B)
    nc_a = q.sum(dim=(1, 2))
    q_hat = q / torch.clamp_min(nc_a, 1e-9)[:, None, None]
    z = prng.normal(kd["contact"], (n,), dev, start=lo)
    # a pure function of mobility: recomputing it every day equals the
    # JAX package's carried copy
    nc_ag = expand_by_age(arrays, nc_a)
    exposer, inf_base, k_s, vts, count_now, included, ninf_m = fused_map(
        prologue,
        [state.state, state.days_left, state.day_of_illness,
         state.day_of_infection, state.severity, state.variant,
         wdet, state.is_infected, active, z, nc_ag,
         state.included_in_totals, state.n_infected],
        [arrays.iot, arrays.asymp_mult, arrays.inf_mult, day])
    VTS = V * C.IOT_LEN * 2
    K_age = fused_bihistogram(vts, VTS, k_s, arrays.ages, A,
                              gate=exposer)                        # (VTS, A)
    exposed_per_day, total_infectors, total_infections, K_age = _total(
        shard, torch.sum(k_s, dtype=I32), torch.sum(count_now, dtype=I32),
        torch.sum(ninf_m, dtype=I32), K_age)
    r_value = torch.where(
        total_infectors > 5,
        total_infections.to(F32) / torch.clamp_min(total_infectors, 1).to(F32),
        0.0)

    m = din.mask_p                                                 # (A, P)
    a_ = m[None] * arrays.mask_po[:, None, None]
    b_ = m[None] * arrays.mask_pw[:, None, None]
    save = a_ + b_ - a_ * b_                                       # (V, A, P)
    Tq = ((q_hat[None] * (1.0 - save)[..., None]).sum(dim=2)
          * arrays.sigma_max[:, None, :])                          # (V, A, B)

    K_g = K_age.T.reshape(A, V, C.IOT_LEN, 2)
    ig = (arrays.iot[None, :, :, None]
          * torch.stack([torch.ones_like(arrays.asymp_mult),
                         arrays.asymp_mult], dim=-1)[None, :, None, :]
          * arrays.inf_mult[None, :, None, None])
    pi = ig[..., None] * Tq.permute(1, 0, 2)[:, :, None, None, :]
    darts = _binomial_split(kd["bin"], K_g, pi)                    # (A,V,T,S,B)
    D = darts.sum(dim=(0, 2, 3))                                   # (V, B)

    u_inf = prng.uniform(kd["inf"], (n,), dev, start=lo)
    u_var = prng.uniform(kd["var"], (n,), dev, start=lo)
    o2r = state.o2r
    u_day = prng.uniform(kd["anyway"], (n,), dev, start=lo)
    (new_contact, new_variant, susceptible,
     dl_a, day_of_illness, onset, queue_new, die_home, bed_request,
     recover_ill, hosp_end, icu_request, hosp_recover, icu_end,
     icu_die, icu_recover) = fused_map(
        recv_front,
        [arrays.band_ag, arrays.lam_log1p_ag, state.is_infected,
         state.has_immunity, active, u_inf, u_var, state.state,
         state.day_of_infection, state.days_left, o2r, state.severity,
         wdet, state.death_outside, state.day_of_illness, u_day,
         state.variant],
        [D, arrays.ratio_before_hosp, arrays.ratio_in_ward, day,
         din.ints[I_MODE], din.floats[F_DAP]])
    queued = env["queued"] | queue_new

    (granted_bed, granted_icu), after2 = clamped_counter_grants(
        [hosp_end.to(I32), icu_end.to(I32)], [bed_request, icu_request],
        torch.stack([env["beds_avail"], env["icu_avail"]]),
        din.ints[I_OFFSET], shard)

    (new_st, days_left, is_infected, has_immunity, ever_icu,
     was_detected, detect_hosp) = fused_map(
        post,
        [state.state, state.severity, state.variant, o2r, dl_a,
         granted_bed, granted_icu, u_day, bed_request, icu_request,
         die_home, recover_ill, hosp_recover, icu_die, icu_recover,
         wdet, state.is_infected, state.has_immunity,
         state.ever_icu, onset],
        [arrays.ratio_before_hosp, arrays.ratio_in_ward,
         arrays.p_icu_death_no_beds, arrays.p_hosp_death_no_beds])

    # ---- phase 6: merge new infections
    newly, variant_new = new_contact, new_variant
    if imports:
        M = cfg.import_buffer
        slot_ids = torch.arange(M, dtype=I32, device=dev)
        slot_valid = slot_ids < din.ints[I_TOT_IMP]
        slot_variant = torch.clamp(searchsorted(
            din.ints[I_CUM_IMP:I_CUM_IMP + V], slot_ids, side="right"),
            0, V - 1)
        u_imp = prng.uniform(kd["imp"], (M, cfg.import_attempts, 2), dev)
        ncls = arrays.import_cum_p.shape[0]
        cls = torch.clamp(searchsorted(arrays.import_cum_p, u_imp[..., 0]),
                          0, ncls - 1).long()
        a_lo = arrays.age_start[arrays.import_min_age[cls].long()]
        a_hi = arrays.age_start[torch.clamp_max(
            arrays.import_max_age[cls] + 1, A).long()]
        pos = a_lo + torch.floor(
            u_imp[..., 1] * torch.clamp_min(a_hi - a_lo, 1).to(F32)).to(I32)
        cand = torch.clamp(pos, 0, N - 1)
        cand_ok = _look(shard, [susceptible], cand.long())[0] & (a_hi > a_lo)
        first = torch.argmax(cand_ok.to(I32), dim=1)
        any_ok = cand_ok.any(dim=1)
        import_agent = cand[torch.arange(M, device=dev), first]
        import_tgt = torch.where(slot_valid & any_ok, import_agent, N).long()
        # an agent picked by an import loses any same-day contact
        # infection; the import's variant wins
        tgt_here = _local(shard, import_tgt)
        newly = _spare(new_contact, False)
        _mark(newly, tgt_here, True)
        newly = newly[:n]
        variant_new = _spare(new_variant, 0)
        variant_new[tgt_here] = slot_variant
        variant_new = variant_new[:n]
        nc2 = _spare(new_contact, False)
        _mark(nc2, tgt_here, False)
        new_contact = nc2[:n]

    variant = state.variant.to(I32)
    c_s = torch.where(exposer, k_s.to(F32) * inf_base, 0.0)
    if shard is None:
        cum_newly, n_new = prefix_count(newly.to(F32), "n_new")
        cum_cat = fused_concat_prefix(c_s, variant, V)
    else:
        cum_newly, n_new = sharded_prefix_count(newly.to(F32), shard,
                                                "n_new")
        cum_cat, _ = sharded_concat_prefix(c_s, variant, V, shard)
    return dict(
        dov=dov, queued_b=queued, new_st=new_st, days_left=days_left,
        is_infected=is_infected, has_immunity=has_immunity,
        ever_icu=ever_icu, was_detected=was_detected,
        detect_hosp=detect_hosp, day_of_illness=day_of_illness,
        included=included, newly=newly, variant_new=variant_new,
        new_contact=new_contact, nc_ag=nc_ag, K_g=K_g, ig=ig, Tq=Tq,
        q_hat=q_hat, cum_newly=cum_newly, cum_cat=cum_cat, n_new=n_new,
        beds_after=after2[0], icu_after=after2[1], r=r_value,
        exposed_per_day=exposed_per_day)


def span_ab(cfg, arrays, din, state, carry, env, vacc: bool, imports: bool,
            shard=None):
    """A and B as one span (a day without contact tracing has no read
    between them)."""
    a = span_a(cfg, arrays, din, state, carry, env, False, shard)
    b = span_b(cfg, arrays, din, state, carry, {**env, **a}, vacc, imports,
               shard)
    return {**a, **b}


def span_c(cfg, arrays, din, state, carry, env, end: int, shard=None):
    """Today's infections in slots [0, end): attribution, severity and
    duration draws, the bucket appends, the scatters, finalize and the
    phase-7 outputs. Returns {"state": AgentState, "carry": the carry's
    device fields, "out": DayOutputs without mobility_limitation}."""
    n, N, _, dev = _dims(state, shard)
    A = arrays.age_start.shape[0] - 1
    V = cfg.nr_variants
    day = din.ints[I_DAY]
    kd = din.keys
    age = state.age.to(I32)
    active = state.active
    Kcap = cfg.infection_buffer
    CAPB = cfg.max_infectees
    NC = N * CAPB
    K_g, Tq, cum_cat = env["K_g"], env["Tq"], env["cum_cat"]
    dov, variant_new, newly = env["dov"], env["variant_new"], env["newly"]

    C_av = (K_g * env["ig"]).sum(dim=(2, 3))                       # (A, V)
    kappa_inc = 1.0 / (C.INCUBATION_CV ** 2)
    kappa_o2r = 1.0 / (C.ONSET_TO_REMOVED_CV ** 2)
    n_used = torch.clamp_max(env["n_new"], Kcap)

    # compaction of today's infections into slots [0, end)
    slots = torch.arange(end, dtype=I32, device=dev)
    if shard is None:
        buf = searchsorted(env["cum_newly"], (slots + 1).to(F32))
    else:
        buf = shard.first_at_least(env["cum_newly"],
                                   (slots + 1).to(F32)).to(I32)
    buf_agent = torch.where(slots < n_used, buf, N)

    # slot pipeline: attribution, severity and duration draws
    bp = torch.clamp(buf_agent, 0, N - 1).long()
    slot_used = buf_agent < N
    nc_b, age_b, vn_b, dov_b = _look(
        shard, [env["new_contact"], age, variant_new, dov], bp)
    contact_p = nc_b & slot_used
    age_i = age_b.long()
    b_i = arrays.band_of_age[age_i].long()
    v_i = vn_b.long()
    w = C_av.T[v_i] * Tq.permute(0, 2, 1)[v_i, b_i]               # (m, A)
    gumb = prng.gumbel(kd["attr_age"], w.shape, dev)
    logw = torch.where(w > 0, torch.log(torch.clamp_min(w, 1e-30)),
                       -float("inf"))
    a_star = torch.argmax(logw + gumb, dim=1)
    u_src = prng.uniform(kd["attr_src"], (end,), dev)
    off = v_i * N
    lo_i = off + arrays.age_start[a_star]
    hi_i = off + arrays.age_start[a_star + 1]
    at = torch.cat([torch.clamp_min(lo_i - 1, 0),
                    torch.clamp_min(hi_i - 1, 0)])
    both = cum_cat[at] if shard is None else shard.lookup_segments(cum_cat,
                                                                   at)
    lo_c = torch.where(lo_i > 0, both[:end], 0.0)
    hi_c = both[end:]
    x = lo_c + u_src * (hi_c - lo_c)
    first = (searchsorted(cum_cat, x).long() if shard is None
             else shard.first_at_least(cum_cat, x, V))
    pos = torch.minimum(torch.maximum(first, lo_i), hi_i)
    src = torch.clamp(pos - off, 0, N - 1)
    ok = (hi_c > lo_c) & contact_p
    infector_new = torch.where(ok, src, -1).to(I32)
    tr_slot = ok & _look(shard, [state.traceable], src)[0]
    g1, g2 = gamma_fixed_pair(kd["gam1"], kappa_inc, kd["gam2"], kappa_o2r,
                              (end,), dev, GAMMA_ROUNDS)
    sev_slot, outside_slot = severity_draw_slots(kd["sev"], arrays, v_i,
                                                 age_i, dov_b, day)
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
    bkt_fill = carry.bkt_fill
    j = _look(shard, [bkt_fill], sp.long())[0] + rank
    store = valid & (j < CAPB)
    app_pos = torch.where(store, sp * CAPB + torch.clamp_max(j, CAPB - 1),
                          NC + idx)
    app_val = torch.where(store, dst_s, N)
    app_src = torch.where(valid, sp, N)
    problem = carry.problem | torch.where(
        torch.any(valid & (j >= CAPB)), C.PROBLEM_TOO_MANY_INFECTEES,
        0).to(I32)
    if end < Kcap:
        tail = torch.arange(end, Kcap, dtype=I32, device=dev)
        app_pos = torch.cat([app_pos, NC + tail])
        app_val = torch.cat([app_val, torch.full_like(tail, N)])
        app_src = torch.cat([app_src, torch.full_like(tail, N)])

    # slot-domain scatters: unused slots hold the sentinel N and drop
    tgt = buf_agent.long()
    infector = _put(shard, state.infector, tgt, infector_new)
    sev_out = _put(shard, state.severity, tgt, sev_slot)
    death_outside = _put(shard, state.death_outside, tgt, outside_slot)
    days_left = _put(shard, env["days_left"], tgt, incub_slot)
    o2r = _put(shard, state.o2r, tgt, o2r_slot)
    src_ok = slot_used & (infector_new >= 0)
    n_infected = _add(shard, state.n_infected,
                      torch.where(src_ok, infector_new, 0).long(),
                      src_ok.to(I32))
    fill_ok = app_src < N
    bkt_fill = _add(shard, bkt_fill, torch.where(fill_ok, app_src, 0).long(),
                    fill_ok.to(I32))

    # ---- finalize
    (st8_out, sev8_out, var8_out, dl16_out, doil16_out, doi16_out,
     is_infected, traceable, detected_today) = fused_map(
        finalize,
        [env["new_st"], sev_out, state.variant, variant_new, days_left,
         env["day_of_illness"], state.day_of_infection, newly,
         env["is_infected"], state.traceable, env["detected_today"],
         env["detect_hosp"]],
        [day, din.ints[I_CT]])

    # ---- phase 7: outputs
    has_immunity, ever_icu = env["has_immunity"], env["ever_icu"]
    fields = [active, is_infected, has_immunity, dov, detected_today,
              st8_out, ever_icu, death_outside, newly]
    by10 = fused_fn_onehot_sum(fields, _output_masks_reduced, 10,
                               arrays.group_of_agent,
                               cfg.nr_groups + 1)[:, :-1].to(I32)
    inf_by_variant = torch.stack(
        [torch.sum(newly & (variant_new == v), dtype=I32) for v in range(V)])
    by10, inf_by_variant = _total(shard, by10, inf_by_variant)
    (vacc_g, ever_g, det_g, inicu_g, cicu_g, ward_g, dead_g, rec_g,
     nh_g, new_g) = by10
    all_detected = carry.all_detected + det_g
    by_group = torch.stack([
        arrays.active_per_group - ever_g, vacc_g, ever_g - dead_g - rec_g,
        ever_g, det_g, all_detected, inicu_g, cicu_g, ward_g, dead_g, rec_g,
        nh_g, new_g])
    exposures = _exposures_by_place(kd["place"], K_g, env["q_hat"])

    out = DayOutputs(
        by_group=by_group,
        available_hospital_beds=env["beds_after"],
        available_icu_units=env["icu_after"],
        total_icu_units=env["icu_total"],
        r=env["r"],
        exposed_per_day=env["exposed_per_day"],
        ct_cases_per_day=env["ct_cases"],
        mobility_limitation=None,
        exposures_by_place=exposures,
        infected_by_variant=inf_by_variant,
    )
    new_state = AgentState(
        age=state.age, state=st8_out, severity=sev8_out, variant=var8_out,
        death_outside=death_outside, days_left=dl16_out,
        day_of_illness=doil16_out, day_of_infection=doi16_out,
        day_of_vaccination=dov, o2r=o2r, infector=infector,
        n_infected=n_infected, is_infected=is_infected,
        has_immunity=has_immunity, was_detected=env["was_detected"],
        queued=env["queued_b"], traceable=traceable, ever_icu=ever_icu,
        included_in_totals=env["included"], active=active)
    carry_dev = dict(
        beds_avail=env["beds_after"], icu_avail=env["icu_after"],
        beds_total=env["beds_total"], icu_total=env["icu_total"],
        all_detected=all_detected, problem=problem, bkt_dst=carry.bkt_dst,
        bkt_fill=bkt_fill, mob=din.mobility, nc_ag=env["nc_ag"],
        app_pos=app_pos, app_val=app_val, app_n=n_app)
    return dict(state=new_state, carry=carry_dev, out=out)


# the spans that open a day (and load its row) and the one that ends it
FIRST_SPANS = ("A", "AB")
LAST_SPAN = "C"


# ---------------------------------------------------------------------------
# the day as a program: the spans, and the tier picks between them that the
# JAX package makes on the device (lax.cond / lax.switch)

class Pick(NamedTuple):
    """A count a tier pick reads: ``env[src]`` (its element ``idx``),
    clamped to ``cap``, and its branch: the JAX package's left
    searchsorted into the ceilings ``ends``, clamped to the last branch
    as lax.switch clamps. ``bit`` is set in the problem bits where the
    count exceeds ``cap``."""
    src: str
    idx: Optional[int]
    ends: tuple
    cap: Optional[int]
    bit: int = 0


class Span(NamedTuple):
    """A span at a key the host knows from the schedule."""
    name: str
    fn: Callable
    key: tuple


class Switch(NamedTuple):
    """A span at the tier its picks name, one ceiling a pick: branch
    b0 · len(ends1) + b1 of a switch over every tier (lax.switch)."""
    name: str
    fn: Callable
    picks: tuple

    def keys(self):
        """The span's key of each branch, in branch order."""
        return [tuple(p.ends[b] for p, b in zip(self.picks, bs))
                for bs in product(*(range(len(p.ends)) for p in self.picks))]


class If(NamedTuple):
    """The ``body`` on a day whose one pick takes branch 1 (lax.cond)."""
    name: str
    picks: tuple
    body: tuple


# the columns of a day's row of picks (-1 where the node did not run)
PICK_COLS = ("T", "T1", "T2", "T3", "T4", "C")


def day_program(cfg: EngineConfig, ct_active: bool, vacc: bool,
                imports: bool) -> tuple:
    """The spans and picks of a day with this schedule (the JAX
    package's day_step: the tracing cond at reina_tpu/core/step.py:976,
    its member-tier switches :922 and :952 with their column switches
    :912-918, the slot-tier switch :1344; the overflow bits :979-981 and
    :1231-1232)."""
    Tcap = cfg.infection_buffer
    mem = tuple(_ceilings(cfg.infection_head, Tcap))
    cols = tuple(_ceilings(cfg.bucket_head, cfg.max_infectees))
    slots = Switch(LAST_SPAN, span_c, (Pick(
        "n_new", None, mem, Tcap, C.PROBLEM_INFECTION_BUFFER_OVERFLOW),))
    if not ct_active:
        return (Span("AB", span_ab, (vacc, imports)), slots)
    n_d = Pick("n_d", None, mem, Tcap, C.PROBLEM_TRACING_BUFFER_OVERFLOW)
    n_f = Pick("n_f", None, mem, Tcap, C.PROBLEM_TRACING_BUFFER_OVERFLOW)
    tracing = (
        Switch("T1", span_t1, (n_d,)),
        Switch("T2", span_t2, (n_d._replace(bit=0),
                               Pick("fill_max", None, cols, None))),
        Switch("T3", span_t3, (n_f,)),
        Switch("T4", span_t4, (n_f._replace(bit=0),
                               Pick("fill2_max", None, cols, None))))
    return (Span("A", span_a, (True,)),
            If("T", (Pick("ct_cases", None, (0, 1), None),), tracing),
            Span("B", span_b, (vacc, imports)), slots)


def conditionals(nodes):
    """Every If and Switch of a program, in order (an If before the
    nodes of its body)."""
    for node in nodes:
        if not isinstance(node, Span):
            yield node
            if isinstance(node, If):
                yield from conditionals(node.body)


def tier_branch(p: Pick, x: int) -> int:
    """The branch pick ``p`` takes for the count ``x`` (the host's form
    of the picks the producing kernels make, kernels/csrc/pick.cuh)."""
    x = x if p.cap is None else min(x, p.cap)
    return min(bisect_left(p.ends, x), len(p.ends) - 1)


def run_day(cfg: EngineConfig, arrays: ModelArrays, plan: DayPlan,
            din: DayIn, state: AgentState, carry: DayCarry, shard=None):
    """One day with the plain step: its program's spans as they come,
    each tier picked on the host from the count it reads. Returns
    (state, carry, DayOutputs, the problem bits found on the host, the
    day's picks as a PICK_COLS row)."""
    env, reads = {}, {}
    row = np.full(len(PICK_COLS), -1, np.int32)
    bits = plan.problem

    def count(p: Pick) -> int:
        if p.src not in reads:
            perf.count("reads")
            if shard is not None:
                shard.before_read(env[p.src])
            reads[p.src] = env[p.src].tolist()
        v = reads[p.src]
        return v if p.idx is None else v[p.idx]

    # a work list, not a recursive closure: a closure that calls itself
    # is a reference cycle, which would keep the day's tensors alive
    # until the garbage collector ran
    nodes = list(day_program(cfg, plan.ct_active, plan.vacc, plan.imports))
    while nodes:
        node = nodes.pop(0)
        if isinstance(node, Span):
            key = node.key
        else:
            flat = 0
            for p in node.picks:
                x = count(p)
                if p.bit and x > p.cap:
                    bits |= p.bit
                flat = flat * len(p.ends) + tier_branch(p, x)
            row[PICK_COLS.index(node.name)] = flat
            if isinstance(node, If):
                if flat:
                    nodes[:0] = node.body
                continue
            key = node.keys()[flat]
        env.update(node.fn(cfg, arrays, din, state, carry, env, *key,
                           shard=shard))

    perf.count("days")
    out = env["out"]._replace(mobility_limitation=plan.mobility_limitation)
    return (env["state"], DayCarry(day=plan.day + 1,
                                   weekly_leftover=plan.leftover,
                                   **env["carry"]), out, bits, row)


def day_step(cfg: EngineConfig, arrays: ModelArrays, sched: SchedRow,
             state: AgentState, carry: DayCarry, dk: DayKeys, shard=None,
             picks=None):
    """Advance one day: its spans, eagerly. Returns (state, carry,
    DayOutputs).

    ``carry.bkt_dst`` is updated in place (it is N·64 int32; the engine
    copies the run's initial table once per run); every other input is
    left as it was. ``shard`` (parallel.mesh.AgentShard): step this
    rank's slab of an agent-sharded run; the outputs and the carry's
    scalars come out replicated. ``picks``: a list that takes the day's
    row of tier picks."""
    _, N, _, _ = _dims(state, shard)
    plan = plan_day(cfg, sched, carry.weekly_leftover, int(carry.day), dk, N)
    din = day_inputs(cfg, plan, key_table(cfg, dk), sched.mobility,
                     sched.mask_p)
    state, carry, out, bits, row = run_day(cfg, arrays, plan, din, state,
                                           carry, shard)
    if bits:
        carry = carry._replace(problem=carry.problem | bits)
    if picks is not None:
        picks.append(row)
    return state, carry, out


def _exposures_by_place(key, K_g, q_hat):
    """Per-place split of all drawn contacts (independent per-place
    binomials, as the JAX package draws them)."""
    K_age = K_g.sum(dim=(1, 2, 3))                                 # (A,)
    qp = q_hat.sum(dim=2)                                          # (A, P)
    counts = _binomial_split(key, K_age, qp)
    return counts.sum(dim=0).to(I32)


def snapshot_outputs(cfg: EngineConfig, arrays: ModelArrays,
                     state: AgentState, carry: DayCarry,
                     mobility_scalar, shard=None) -> DayOutputs:
    """The day-0 snapshot before any events (``shard``: of this rank's
    slab, summed over its agent group)."""
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
    by_group = _group_counts(cfg, arrays, masks, shard)
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
