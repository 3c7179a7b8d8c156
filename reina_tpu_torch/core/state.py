"""Agent state: a struct-of-arrays pytree over the (padded) agent axis.

This replaces the reference's malloc'ed ``Person[N]`` struct array
(main.pyx:132-144). Dynamic per-agent pointers (the ``infectees``
list) are replaced by the ``infector`` back-edge: the set
{t : infector[t] == s} *is* s's infectee list, recovered by vectorized
mask propagation during contact tracing.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from . import constants as C
from .params import DiseaseArrays, PopulationArrays


class AgentState(NamedTuple):
    """All fields are (N,) arrays; N includes tail padding (active=False)."""
    age: np.ndarray              # uint8
    state: np.ndarray            # int8 — PersonState
    severity: np.ndarray         # int8 — SymptomSeverity
    variant: np.ndarray          # int8
    death_outside: np.ndarray    # bool — place_of_death == outside hospital
    days_left: np.ndarray        # int16 — countdown in current state
    day_of_illness: np.ndarray   # int16
    day_of_infection: np.ndarray  # int16, -1 = never
    day_of_vaccination: np.ndarray  # int16, -1 = never
    o2r: np.ndarray              # float32 — days from onset to removed
    infector: np.ndarray         # int32, -1 = none/imported
    n_infected: np.ndarray       # int32 — other_people_infected
    is_infected: np.ndarray      # bool
    has_immunity: np.ndarray     # bool
    was_detected: np.ndarray     # bool
    queued: np.ndarray           # bool — queued_for_testing
    traceable: np.ndarray        # bool — contact tracing was active when
    #                              this agent was infected, i.e. the agent
    #                              owns an infectee list (main.pyx:227-233:
    #                              the list is malloc'ed at the agent's OWN
    #                              infection; edges into its infectees are
    #                              recorded only then)
    ever_icu: np.ndarray         # bool — cumulative-ICU stat flag
    included_in_totals: np.ndarray  # bool — counted into R_t totals
    active: np.ndarray           # bool — False for padding


class DayCarry(NamedTuple):
    """Ledgers carried across days: scalars plus the per-source
    infectee buckets — the vectorized twin of the reference's
    fixed-capacity per-person ``infectees`` arrays
    (main.pyx:128,209-233), appended on infection when the source owns
    a list and read by the tracing BFS with queue-sized gathers.
    The buckets are NOT checkpointed: their content is a pure function
    of per-agent state (infector, traceable, day_of_infection) and is
    rebuilt on resume (checkpoint.rebuild_buckets).

    In the port the fields are tensors on the run's device, except
    ``day`` (a host int) and ``weekly_leftover`` (a host float32 array:
    the import accounting is host arithmetic); ``bkt_dst`` has one spare
    slot at index N·CAPB that takes the day step's dropped scatters."""
    day: np.ndarray              # int32
    beds_avail: np.ndarray       # int32
    icu_avail: np.ndarray        # int32
    beds_total: np.ndarray       # int32
    icu_total: np.ndarray        # int32
    weekly_leftover: np.ndarray  # (V,) float32 — fractional import carry
    all_detected: np.ndarray     # (G,) int32 — cumulative detections by group
    problem: np.ndarray          # int32 bitmask of problem codes
    bkt_dst: np.ndarray          # (N·CAPB,) int32 — source s's infectees
    #                              (row s = slice [s·CAPB, (s+1)·CAPB)) in
    #                              infection order; sentinel N beyond its
    #                              fill count. Kept FLAT on device: the
    #                              (N, CAPB) view would lane-pad each
    #                              64-wide row to 128 (2× HBM) and every
    #                              flat<->2-D reshape is a ~2 ms TPU
    #                              relayout copy
    bkt_fill: np.ndarray         # (N,) int32 — edges ever appended to
    #                              s's bucket (uncapped; entries at
    #                              index >= CAPB were dropped and set
    #                              the TOO_MANY_INFECTEES problem)
    mob: np.ndarray              # (A, P) float32 — mobility the cached
    #                              nc_ag below was computed from
    nc_ag: np.ndarray            # (N,) float32 — per-agent contact-count
    #                              expansion; a pure function of mobility,
    #                              recomputed only when an intervention
    #                              changes it (~0.33 ms/day otherwise)
    app_pos: np.ndarray          # (Kcap,) int32 — PENDING bucket-table
    #                              append positions from the previous
    #                              day, applied at the TOP of the next
    #                              step (before tracing reads) so the
    #                              scatter is the carried table's first
    #                              and only pre-write use and XLA can
    #                              update it in place — the old
    #                              read-then-write order forced a
    #                              432 MB copy every day (deviation-free:
    #                              tracing only ever saw previous days'
    #                              appends). Sentinels NC + slot.
    app_val: np.ndarray          # (Kcap,) int32 — pending append values
    #                              (idempotent .set payload — re-applying
    #                              after a checkpoint bucket rebuild is
    #                              harmless)
    app_n: np.ndarray            # int32 — count of live pending entries
    #                              (they are a prefix of app_pos: the
    #                              sort puts invalid slots last), gating
    #                              the apply's geometric tail tiers —
    #                              the full 64k stream costs ~24 ns per
    #                              update against the 432 MB table while
    #                              p75 of daily appends is ~1k


def blank_state(pop: PopulationArrays) -> AgentState:
    n = len(pop.ages)
    z8 = np.zeros(n, dtype=np.int8)
    z16 = np.zeros(n, dtype=np.int16)
    zb = np.zeros(n, dtype=bool)
    return AgentState(
        age=pop.ages.copy(),
        state=z8.copy(), severity=z8.copy(), variant=z8.copy(),
        death_outside=zb.copy(),
        days_left=z16.copy(), day_of_illness=z16.copy(),
        day_of_infection=np.full(n, -1, dtype=np.int16),
        day_of_vaccination=np.full(n, -1, dtype=np.int16),
        o2r=np.zeros(n, dtype=np.float32),
        infector=np.full(n, -1, dtype=np.int32),
        n_infected=np.zeros(n, dtype=np.int32),
        is_infected=zb.copy(), has_immunity=zb.copy(),
        was_detected=zb.copy(), queued=zb.copy(),
        # seeded agents never own infectee lists: the reference seeds
        # through person_infect BEFORE any intervention applies and the
        # initial testing mode is NO_TESTING (main.pyx:466,1469)
        traceable=zb.copy(),
        ever_icu=zb.copy(), included_in_totals=zb.copy(),
        active=pop.active.copy(),
    )


# ---------------------------------------------------------------------------
# NumPy implementations of the engine's random draws, used for initial
# seeding (and reusable by tests as an independent oracle of the math).

def np_gamma(rng: np.random.Generator, mu: float, cv: float) -> float:
    """Gamma with mean mu, coefficient of variation cv
    (reference simrandom.pyx:46-55)."""
    sigma = cv * mu
    theta = sigma ** 2 / mu
    kappa = mu / theta
    return float(rng.gamma(kappa, theta))


def np_severity_draw(rng: np.random.Generator, dis: DiseaseArrays,
                     variant: int, age: int, vaccinated_days: int = -1,
                     ) -> tuple[int, bool]:
    """Severity + place-of-death draw; the exact decision chain of
    get_symptom_severity (main.pyx:1041-1091), including the duplicated
    fatal branch that routes every chain-fatal case to death outside
    hospital (main.pyx:1077-1083)."""
    val = float(rng.random())
    vmod = 1.0
    if vaccinated_days > C.VACCINE_DELAY_DAYS:
        vmod = 1.0 - C.VACCINE_EFFICACY
    syc = float(dis.p_sympt[variant, age])
    if val >= syc:
        return C.ASYMPTOMATIC, False
    syc *= vmod
    dohc = float(dis.p_doh[variant, age])
    if dohc:
        if val < dohc * syc:
            return C.FATAL, True
        val = (val - dohc) / (1 - dohc)
    sc = float(dis.p_severe_c[variant, age])
    cc = float(dis.p_critical_c[variant, age])
    fc = float(dis.p_fatal_c[variant, age])
    if val < fc * cc * sc * syc:
        return C.FATAL, True
    if val < cc * sc * syc:
        return C.CRITICAL, False
    if val < sc * syc:
        return C.SEVERE, False
    return C.MILD, False


def _round_to_int(f: float) -> int:
    return int(f + 0.5)


def seed_initial_state(state: AgentState, dis: DiseaseArrays,
                       ipc, beds: int, icu_units: int,
                       rng: np.random.Generator,
                       ) -> tuple[AgentState, int, int]:
    """Apply an InitialPopulationCondition (reference main.pyx:1452-1516).

    Every seeded trajectory starts at day 0 of its phase (the reference
    has the same simplification, main.pyx:1466-1469). Returns the state
    plus the remaining available beds / ICU units.
    """
    n_seed = ipc.were_incubating()
    if not n_seed:
        return state, beds, icu_units

    s = AgentState(*(a.copy() for a in state))
    active_idx = np.flatnonzero(s.active)
    chosen = rng.choice(active_idx, size=n_seed, replace=False)

    i_incub = ipc.incubating
    i_recov_ns = i_incub + ipc.recovered_without_illness()
    i_ill = i_recov_ns + ipc.ill
    i_dead = i_ill + ipc.dead
    i_icu = i_dead + ipc.in_icu
    i_ward = i_icu + ipc.in_ward

    avail_beds, avail_icu = beds, icu_units
    for i, idx in enumerate(chosen):
        age = int(s.age[idx])
        sev, outside = np_severity_draw(rng, dis, 0, age)
        incub = _round_to_int(np_gamma(rng, float(dis.mu_incub[0]), C.INCUBATION_CV))
        s.state[idx] = C.INCUBATION
        s.severity[idx] = sev
        s.death_outside[idx] = outside
        s.days_left[idx] = incub
        s.is_infected[idx] = True
        s.day_of_infection[idx] = 0
        s.variant[idx] = 0

        if i < i_incub:
            continue
        if i < i_recov_ns:
            s.state[idx] = C.RECOVERED
            s.is_infected[idx] = False
            s.has_immunity[idx] = True
            continue

        # became ill
        mu = float(dis.mu_death[0]) if sev == C.FATAL else float(dis.mu_recov[0])
        o2r = np_gamma(rng, mu, C.ONSET_TO_REMOVED_CV)
        ratio = float(dis.ratio_before_hosp[0]) if sev >= C.SEVERE else 1.0
        s.state[idx] = C.ILLNESS
        s.o2r[idx] = o2r
        s.days_left[idx] = _round_to_int(o2r * ratio)

        if i < i_ill:
            continue
        if i < i_dead:
            s.state[idx] = C.DEAD
            s.is_infected[idx] = False
            s.has_immunity[idx] = True
            continue
        if i < i_icu:
            # hospitalized then transferred to ICU (net: one ICU unit)
            s.was_detected[idx] = True
            s.state[idx] = C.IN_ICU
            s.ever_icu[idx] = True
            rest = 1 - float(dis.ratio_in_ward[0]) - float(dis.ratio_before_hosp[0])
            s.days_left[idx] = _round_to_int(o2r * rest)
            avail_icu -= 1
            continue
        if i < i_ward:
            s.was_detected[idx] = True
            s.state[idx] = C.HOSPITALIZED
            in_ward_ratio = ((1 - float(dis.ratio_before_hosp[0]))
                             if sev == C.SEVERE else float(dis.ratio_in_ward[0]))
            s.days_left[idx] = _round_to_int(o2r * in_ward_ratio)
            avail_beds -= 1
            continue
        s.state[idx] = C.RECOVERED
        s.is_infected[idx] = False
        s.has_immunity[idx] = True

    return s, avail_beds, avail_icu


def initial_all_detected(confirmed_cases: int, group_of_age: np.ndarray,
                         nr_groups: int, nr_ages: int) -> np.ndarray:
    """Spread initially-confirmed cases over age groups, one per 1-year
    age cyclically (reference main.pyx:1506-1516)."""
    out = np.zeros(nr_groups, dtype=np.int32)
    for i in range(int(confirmed_cases)):
        age = (nr_ages + i) % nr_ages
        out[group_of_age[age]] += 1
    return out
