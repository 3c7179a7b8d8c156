"""Run assembly and execution (port of reina_tpu/core/engine.py):
variables → compiled run on a device → days.

``build_run`` carries over the JAX package's numpy host compile and
places every tensor on the device it is given; nothing picks a device
by itself. ``reseed_run`` re-seeds a built run in numpy (the build
cache's hit path). ``run_days`` steps the days — on a CUDA device as
one CUDA graph launch a day with the tier picks on the device
(core/graphs.py), else with the plain day step —, keeps the outputs on
the device until a sync point,
fetches them there in one packed transfer and checks the problem
bitmask, and checkpoints and resumes in the JAX package's file layout
(``core/checkpoint.py``). Given a mesh whose agent axis has several
ranks (parallel/mesh.py), ``run_days`` steps this rank's slab of the
agents, bit-identical to the one-card run: over NCCL, a rank a card, as
one day-graph launch a day with its collectives captured in it (the JAX
package's sharded compiled chunk); over gloo with the plain day step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
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
from ..config.interventions import get_active_interventions
from ..data import loaders
from ..utils import perf


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
                area_name=variables["area_name"],
                # host intermediates for reseed_run: everything the
                # initial state depends on besides the seed
                reseed=(pop, disease, ipc, beds, icu))
    return cfg, arrays, sched_np, state_np, carry_np, meta


def build_run(variables: Dict[str, Any], device,
              cfg_overrides: Optional[Dict[str, Any]] = None,
              age_counts_override: Optional[np.ndarray] = None,
              pad_multiple: int = 1024) -> CompiledRun:
    """Compile a full simulation from resolved variables onto ``device``:
    the host compile (span ``build.compile``), then its arrays,
    schedules, state and carry put on the device (``build.upload``)."""
    from .. import convert
    device = torch.device(device)
    with perf.span("build.compile"):
        cfg, arrays, sched_np, state_np, carry_np, meta = host_compile(
            variables, cfg_overrides, age_counts_override, pad_multiple)
    with perf.span("build.upload"):
        on_device = dict(arrays=convert.model_arrays(arrays, device),
                         schedules=convert.schedules(sched_np, device),
                         init_state=convert.agent_state(state_np, device),
                         init_carry=convert.day_carry(carry_np, device))
    return CompiledRun(
        cfg=cfg, **on_device,
        days=meta["days"], start_date=meta["start_date"],
        random_seed=meta["random_seed"],
        variant_names=meta["variant_names"],
        group_labels=meta["group_labels"], n_agents=meta["n_agents"],
        device=device, meta={"area_name": meta["area_name"],
                             "_reseed": meta["reseed"]})


def reseed_run(run: CompiledRun, seed: int) -> CompiledRun:
    """A CompiledRun identical to ``run`` except re-seeded: only the
    initial agent state and the capacity scalars depend on
    ``random_seed`` (initial-condition agent picks + severity/duration
    draws, seed_initial_state); arrays/schedules/cfg are shared. Used
    by the build cache: the numpy re-seed replaces a full host compile
    and device placement."""
    from .. import convert
    pop, disease, ipc, beds, icu = run.meta["_reseed"]
    state_np = blank_state(pop)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC0FFEE]))
    state_np, avail_beds, avail_icu = seed_initial_state(
        state_np, disease, ipc, beds, icu, rng)
    carry = run.init_carry._replace(
        beds_avail=convert.tensor(np.int32(avail_beds), run.device),
        icu_avail=convert.tensor(np.int32(avail_icu), run.device))
    return replace(run, init_state=convert.agent_state(state_np, run.device),
                   init_carry=carry, random_seed=seed)


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


def _stack_device(outs: List[DayOutputs]) -> DayOutputs:
    """Per-day outputs stacked along a leading day axis where they lie
    (tensors on their device, host values as numpy)."""
    return DayOutputs(*(torch.stack(list(v)) if isinstance(v[0], torch.Tensor)
                        else np.stack([np.asarray(x) for x in v])
                        for v in zip(*outs)))


def _cat_device(chunks: List[DayOutputs]) -> DayOutputs:
    return DayOutputs(*(torch.cat(list(v)) if isinstance(v[0], torch.Tensor)
                        else np.concatenate(v) for v in zip(*chunks)))


def pack_leaves(int_leaves, float_leaves):
    """The JAX package's ``_pack_leaves`` (reina_tpu/core/engine.py):
    the leaves flattened into one int32 and one float32 tensor on their
    device. Exact: every integer output is < 2^24, and int32/float32
    hold int16, int8 and bool losslessly."""
    dev = (int_leaves + float_leaves)[0].device
    i = (torch.cat([x.reshape(-1).to(torch.int32) for x in int_leaves])
         if int_leaves else torch.zeros(0, dtype=torch.int32, device=dev))
    f = (torch.cat([x.reshape(-1).to(torch.float32) for x in float_leaves])
         if float_leaves else torch.zeros(0, dtype=torch.float32, device=dev))
    return i, f


def fetch_packed(outs: DayOutputs, tail):
    """The JAX package's ``_fetch_chunk_packed``: stacked device outputs
    and an int tensor ``tail`` (the problem bits first, then whatever the
    run loop fetches with them) to the host in one int32 and one float32
    transfer; returns (numpy DayOutputs, ``tail`` as a flat int32
    array). Host leaves pass through as numpy. The host's wait for the
    card (``wait_for``) and the copies with the unpacking (span
    ``run.fetch``) are timed apart."""
    leaves = list(outs)
    on_dev = [isinstance(x, torch.Tensor) for x in leaves]
    is_int = [d and not x.is_floating_point() for x, d in zip(leaves, on_dev)]
    ints = [x for x, b in zip(leaves, is_int) if b]
    flts = [x for x, d, b in zip(leaves, on_dev, is_int) if d and not b]
    pi, pf = pack_leaves(ints + [tail.reshape(-1)], flts)
    wait_for(pi)
    with perf.span("run.fetch"):
        pi, pf = pi.cpu().numpy(), pf.cpu().numpy()
        out, oi, of = [], 0, 0
        for x, d, b in zip(leaves, on_dev, is_int):
            if not d:
                out.append(np.asarray(x))
                continue
            n = x.numel()
            dt = torch.empty(0, dtype=x.dtype).numpy().dtype
            src = pi[oi:oi + n] if b else pf[of:of + n]
            out.append(src.reshape(tuple(x.shape)).astype(dt))
            oi, of = (oi + n, of) if b else (oi, of + n)
    return DayOutputs(*out), pi[oi:]


def wait_for(t: torch.Tensor) -> None:
    """The host waits (span ``run.wait``) until the card has run what is
    queued on its current stream, through a CUDA event recorded after
    ``t``'s work, so that the copy to the host that follows waits for
    nothing; on the CPU there is nothing to wait for."""
    with perf.span("run.wait"):
        if t.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            ev.synchronize()


def run_chunk(cfg: EngineConfig, arrays: ModelArrays, schedules: Schedules,
              host_sched: Schedules, state: AgentState, carry: DayCarry,
              base_key, chunk_len: int, day0: int, shard=None, picks=None):
    """Step ``chunk_len`` days from ``day0`` with the plain day step;
    returns (state, carry, list of DayOutputs on the device). ``picks``:
    a list that takes each day's row of tier picks."""
    dkeys = derive_day_keys(cfg, base_key, day0 + np.arange(chunk_len))
    outs = []
    for i in range(chunk_len):
        state, carry, out = day_step(cfg, arrays,
                                     sched_row(schedules, host_sched,
                                               day0 + i),
                                     state, carry, dkeys.day(i), shard,
                                     picks)
        outs.append(out)
    return state, carry, outs


def run_days(run: CompiledRun, n_days: Optional[int] = None,
             chunk_days: int = 32, day_callback=None,
             seed: Optional[int] = None,
             checkpoint_dir: Optional[str] = None,
             checkpoint_every: int = 64, resume: bool = True, mesh=None,
             graphs: Optional[bool] = None, picks: Optional[list] = None):
    """Execute the run; returns (stacked DayOutputs as numpy with a
    leading day axis of ``n_days`` rows — row 0 is the initial
    snapshot —, final state, final carry, chunk times).

    ``day_callback(day, outputs_so_far)`` fires after each chunk;
    returning False cancels the run with ExecutionInterrupted. With
    ``checkpoint_dir`` set, the full simulation state is saved at the
    first chunk end at least ``checkpoint_every`` days after the last
    save and at the end of the run, and (with ``resume``) a call
    resumes from the newest checkpoint there: bit-identical to an
    uninterrupted run.

    Outputs stay on the device until a sync point, where they come to
    the host in one packed transfer and the problem bitmask is checked:
    the end of every chunk with a callback, a checkpoint directory or an
    agent-sharded mesh, else the end of the run (as the JAX package).
    Spans (utils/perf.py): ``run.prepare`` from the call to the first
    chunk, inside it ``run.plan`` a graphed run's planning of its days
    (their day rows, keys and tables), ``run.launch`` each chunk's
    launches (the plain step's whole work, its planning a day at a time
    included), ``run.wait`` and ``run.fetch`` each sync point's wait for
    the card and its copies to the host.

    ``graphs``: step the days as CUDA graphs (core/graphs.py), one launch
    a day with its tier picks on the device, bit-identical to the plain
    day step; the default on a CUDA device, one card or an agent axis
    over NCCL; False runs the plain day step, which picks each tier on
    the host. An agent axis over gloo on CUDA steps the plain day step
    (a gloo collective cannot be captured; ``graphs=True`` raises). On
    the CPU, True runs the graph runner's CPU model (recorded spans in
    place of graphs, each fold's picks made by its twin inside the
    producer's call), also on an agent axis.

    ``picks``: a list that takes the stepped days' rows of tier picks
    (``step.PICK_COLS``: the branch each conditional took, -1 where it
    did not run), from the device at the sync points of a graphed run,
    from the host in the plain step.

    ``mesh`` (parallel.mesh.Mesh) with an agent axis of k > 1 ranks:
    every rank of the agent group calls ``run_days`` on the same run,
    steps its slab of the agents on its own device and returns the same
    outputs as the unsharded run; the final state and carry are its
    slab's. Graphed, every rank launches one day graph a day whose
    collectives run inside it, and makes the same picks; the host reads
    nothing until a sync point, where the ranks OR their problem bits
    so that all raise together. Its graph set holds the captured NCCL
    collectives, and NCCL destroys a communicator only after every graph
    that holds one: the set is freed when the run ends, so that
    ``destroy_process_group`` may follow, unless the run is inside
    ``graphs.reusing()`` (core/graphs.py), which keeps it for the
    scope's later runs of the same shapes. A checkpoint holds the whole
    run (gathered to the group's first rank, which writes it), so a run
    resumes on any layout. With one rank on the agent axis the mesh
    changes nothing.

    On a mesh no rank hangs on another (parallel/mesh.py): a rank that
    fails anywhere in the run gives it up (``mesh.give_up``: its failure
    marked in the world's store, its agent group's and its mesh's, the
    group aborted, its graphs freed); every wait of a rank on the others
    (a collective that blocks the host, a host read, a sync point, a
    graphed shard's launches) polls on the host and gives up on such a
    mark or on a rank whose heartbeat has stopped. A peer's failure
    raises as GraphError naming the day or the sync point (graphed) or
    as CollectiveError (the plain step); this rank's own as it was
    raised. A graphed shard's captured days stop where a peer's failure
    aborted their collectives, and the card stays usable
    (core/graphs.py).

    The run's device is current while it runs, whatever device the
    caller had current, which is restored after."""
    from . import checkpoint as ckpt
    from . import graphs as G
    from .. import convert
    from ..parallel import mesh as M
    t_entry = perf.now()
    n_days = n_days if n_days is not None else run.days
    base_key = prng.PRNGKey(run.random_seed if seed is None else seed)
    cfg = run.cfg
    shard = None
    if mesh is not None and mesh.n_agent > 1:
        shard = M.AgentShard(mesh, run.init_state.age.shape[0])
        arrays, schedules, state, carry = M.shard_run(run, mesh)
        device = mesh.device
    else:
        arrays, schedules, device = run.arrays, run.schedules, run.device
        state, carry = run.init_state, run.init_carry
    capturable = shard is None or shard.backend == "nccl"
    if graphs is None:
        graphs = device.type == "cuda" and capturable
    elif graphs and device.type == "cuda" and not capturable:
        raise ValueError(f"an agent axis over {shard.backend} steps the "
                         "plain day step (graphs=False): a "
                         f"{shard.backend} collective cannot be captured; "
                         "the graphed agent axis runs over NCCL, a rank a "
                         "card")
    host_sched = Schedules(*(x.cpu().numpy() for x in schedules))

    if shard is None and not graphs:
        # the bucket table is updated in place by the day step: copy the
        # run's initial table once so the run stays reusable
        carry = carry._replace(bkt_dst=carry.bkt_dst.clone())
    pending, rows = [], []
    day = 0
    latest = (ckpt.latest_checkpoint(checkpoint_dir)
              if checkpoint_dir and resume else None)
    sync_each_chunk = (day_callback is not None or checkpoint_dir is not None
                       or (shard is not None and not graphs))
    gs, plans, bits = None, [], 0
    synced = day0 = steps_left = 0
    leftover = None

    def sync():
        """Fetch the pending outputs (and a graphed run's picks and
        branch tallies), check the problem bits."""
        nonlocal pending, synced
        if gs is not None:
            gs.settle(f"the sync point at day {day}")
            if day > synced:
                pending.append(gs.outputs(synced, day,
                                          plans[synced - day0:day - day0]))
            tail_t = gs.sync_tail(synced, day)
        else:
            tail_t = carry.problem.reshape(1)
            if shard is not None:
                shard.before_read(tail_t)
        if pending:
            out_np, tail = fetch_packed(_cat_device(pending), tail_t)
            rows.append(out_np)
            pending = []
        else:
            wait_for(tail_t)
            with perf.span("run.fetch"):
                tail = tail_t.cpu().numpy()
        if gs is not None:
            problem, day_picks = gs.synced(tail)
            if picks is not None:
                picks.extend(day_picks)
        else:
            problem = int(tail[0])
        synced = day
        problem |= bits
        if shard is not None:
            # the bits of every rank, so that all raise together
            got = shard.all_gather(torch.tensor([problem],
                                                dtype=torch.int32,
                                                device=device))
            shard.before_read(got)
            problem = np.bitwise_or.reduce(got.cpu().numpy())
        check_problems(problem)

    chunk_times = []
    since_ckpt = 0
    # on a mesh every wait on the other ranks gives up on a failure mark
    # or a lost rank (parallel/mesh.py), and a rank that fails gives the
    # run up, so that every rank raises and none hangs; the plain step's
    # collectives on a card are queued, its host reads watched
    try:
        with G.on_device(device), M.watching(shard, cards=False):
            with perf.span("run.prepare", start=t_entry):
                # device-resident until a sync point, then fetched rows
                pending = [_stack_device([snapshot_outputs(
                    cfg, arrays, state, carry, np.float32(1.0), shard)])]
                if latest:
                    st_np, cr_np, saved_out = ckpt.load_checkpoint(latest)
                    state = convert.agent_state(st_np, device)
                    carry = convert.day_carry(cr_np, device)
                    if shard is not None:
                        state, carry = M.place_state_carry(
                            mesh, state, carry, cfg.max_infectees)
                    day = carry.day
                    if saved_out is not None:
                        pending, rows = [], [saved_out]
                steps_left = (n_days - 1) - day
                synced = day0 = day
                leftover = carry.weekly_leftover
                if graphs and steps_left > 0:
                    gs = G.acquire(cfg, arrays, schedules, state, carry,
                                   device, shard)
                    with perf.span("run.plan"):
                        plans = gs.prepare(host_sched, base_key, day,
                                           steps_left, leftover,
                                           run.init_state.age.shape[0])
                    gs.start(cfg, arrays, schedules, state, carry, day,
                             plans)
            while steps_left > 0:
                this_chunk = min(chunk_days, steps_left)
                t0 = time.perf_counter()
                with perf.span("run.launch"):
                    if gs is not None:
                        chunk = plans[day - day0:day - day0 + this_chunk]
                        gs.step(chunk)
                        for plan in chunk:
                            bits |= plan.problem  # known from the schedule
                        leftover = chunk[-1].leftover
                    else:
                        state, carry, outs = run_chunk(
                            cfg, arrays, schedules, host_sched, state, carry,
                            base_key, this_chunk, day, shard, picks)
                        pending.append(_stack_device(outs))
                day += this_chunk
                steps_left -= this_chunk
                since_ckpt += this_chunk
                if sync_each_chunk or steps_left == 0:
                    sync()
                chunk_times.append((this_chunk, time.perf_counter() - t0))
                if checkpoint_dir and (since_ckpt >= checkpoint_every
                                       or steps_left == 0):
                    rows = [_concat(rows)]
                    path = ckpt.checkpoint_path(checkpoint_dir, day)
                    st, cr = ((state, carry) if gs is None else
                              gs.state_carry(day, leftover, bits,
                                             clone=False))
                    if shard is None:
                        ckpt.save_checkpoint(path, st, cr, rows[0])
                    else:
                        ckpt.save_sharded(path, shard, st, cr, rows[0],
                                          cfg.max_infectees)
                    since_ckpt = 0
                if day_callback is not None:
                    rows = [_concat(rows)]
                    if not day_callback(day, rows[0]):
                        raise ExecutionInterrupted()
            if pending or day > synced or not chunk_times:
                sync()
            if gs is not None:
                state, carry = gs.state_carry(day, leftover, bits,
                                              clone=True)
    except (C.SimulationFailed, ExecutionInterrupted):
        # the run stopped, on every rank of an agent group at once; its
        # graph set is sound. The mesh is marked: the other agent
        # groups' waits end
        M.give_up(mesh)
        if gs is not None:
            G.release(gs)
        raise
    except BaseException as e:
        # a set whose build, capture, assembly or launch failed is freed,
        # never reused; on a shard with its agent group (once: a failed
        # day gave it up already)
        note = M.give_up(shard if shard is not None else mesh)
        if note:
            e.add_note(note)
        if gs is not None:
            gs.close()
        raise
    if gs is not None:
        G.release(gs)
    return _concat(rows), state, carry, chunk_times


def build_graphs(run: CompiledRun) -> None:
    """Build the day graph of every host key of ``run``'s days
    (core/graphs.py) into an idle graph set of its key on its card, so
    that a later graphed run of any build of that key, of up to as many
    days, builds none of them; nothing is stepped."""
    from . import graphs as G
    host_sched = Schedules(*(x.cpu().numpy() for x in run.schedules))
    build = (run.cfg, run.arrays, run.schedules, run.init_state,
             run.init_carry)
    with G.on_device(run.device):
        gs = G.acquire(*build, run.device)
        plans = gs.prepare(host_sched, prng.PRNGKey(run.random_seed), 0,
                           run.days - 1,
                           run.init_carry.weekly_leftover,
                           run.init_state.age.shape[0])
        gs.start(*build, 0, plans)
        G.release(gs)


def _concat(rows: List[DayOutputs]) -> DayOutputs:
    if len(rows) == 1:
        return rows[0]
    return DayOutputs(*(np.concatenate(xs, axis=0) for xs in zip(*rows)))


class ExecutionInterrupted(Exception):
    """Cooperative cancellation."""
