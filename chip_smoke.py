#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device. It

  1. prints the device and its power limit, and builds the CUDA kernels
     from reina_tpu_torch/kernels/csrc (nvcc, sm_90a, one process per
     source);
  2. holds every hand-written kernel of the main path against its plain
     PyTorch twin on the card, at the HUS run's agent count, and times
     the kernel, the twin and, where there is one, the PyTorch library
     call that computes the same function (CUDA events, cold L2, median
     of 7), beside the least time the card could take (bound), and
     times each launch of the CUDA kernels;
  3. drives the main path: build_run for the default HUS scenario (365
     days, 1,685,983 agents) on "cuda"; first the draw kernels
     (threefry.cu, samplers.cu) against their twins at the day step's
     shapes, with their keys by value and from device memory (the day
     step's key table), gamma_fixed_pair (the day's two gamma draws in
     one launch) and binomial_fixed on the inputs their calls get on
     day 100 of this run (run_days to day 100 records them), and both
     samplers at their edges (the kappa fallback, a mean of exactly 10,
     the flip, n = 0, a NaN mean); then
     run_days, which steps the days as captured CUDA graphs
     as one CUDA graph launch a day with its tier picks on the device
     (reina_tpu_torch/core/graphs.py, core/daygraph.py: each pick made
     inside the launch that produces its count, the prefix kernel of
     csrc/prefix.cu or the reduce-and-pick of csrc/daygraph.cu, which
     sets a conditional node; no pick node of its own), counting every
     kernel's launches in that run (a launch adds its spans' tallies, a
     sync point those of the branches that ran, from the device's branch
     tallies); the fused picks first against their twins (the
     producer's twin, then the picks' twin) at every branch of every
     pick and past each cap;
  4. checks the outcome: finite outputs of the expected shape, agents
     conserved every day, every kernel launched exactly as often as the
     days ran it (each fused entry once a pick it made that opens its
     fold: a picks-table entry), and the final all_infected inside the JAX package's
     1000-seed spread (373,466 ± 4 × 22,396, BENCH_MC.json);
  4b. the graphs: the same run with the plain day step (graphs=False)
     and again as graphs from the built set; both must equal step 3's
     outputs, final state and final carry bit for bit, the plain step's
     host picks must equal the device's picks of step 3 on every day,
     and a graphed run must launch one day graph and read nothing on the
     host a day; it prints the spans captured (span and key), the day
     graphs, the capture and assembly seconds, launches and host reads a
     day, ms/day and peak device memory of each mode, and what the set's
     static copies of a build (model arrays, schedule tables) hold;
  4d. new builds of the main path's shapes on its graph set (graph sets
     are keyed by config, device and shapes, core/graphs.py:set_key):
     the four preset scenarios (mitigation, summer-boogie,
     hammer-and-dance, looser-restrictions-to-start-with), then a build
     with other beds, ICU units and infectiousness and a mobility limit
     moved by a week; each 365 days graphed and with the plain day step,
     equal bit for bit with every kernel's launches exact, on the main
     path's set, building only the spans and day graphs of host keys the
     set lacks (none, where it holds them all);
  4c. Varsinais-Suomi (479,861 agents, 480,256 padded; after step 7):
     every kernel of step 2 against its twin at that agent count, the
     draws and samplers on its run's day-100 inputs, the fused picks at
     its agent count;
     its 365 days graphed and with the plain day step, equal bit for bit,
     picks equal on every day, launches exact; then the CLI's calibrate
     against its observed cases (two points, 60 days);
     Turku (the turku override set with its astra-zeneca scenario, the
     only vaccination in the set, 565 days, 192,962 agents): graphed
     and with the plain day step, equal bit for bit, with every kernel's
     launches exact and a one-hot vaccination sum on each vaccination
     day;
  5. resumes at HUS scale: run_days to day 182 with a checkpoint, then
     a second run_days to day 364 that resumes from it; its outputs and
     final agent state must equal step 3's bit for bit;
  6. runs ensembles and calibration at HUS width, 60 stepped days each:
     run_ensemble over seeds 0-2 on step 3's build (member 0 must equal
     step 3's rows 1-60 bit for bit, members 1 and 2 must differ), then
     sweep_grid over infectiousness_multiplier 0.35 / 0.55 / 0.7 (the
     default point 0.55 must equal the same rows; the finals must rise
     with the multiplier; peak device memory must stay near one run's),
     scored against HUS's observed confirmed cases, and the CLI's
     calibrate over two points (30 days); agents conserved, and every
     per-day kernel launched exactly once a member- or point-day;
  7. the mesh (reina_tpu_torch/parallel/mesh.py): the sharded forms of
     the ledger and the prefix at HUS shape for 2, 4 and 8 slabs, slab
     by slab in this process with the exchange done by stacking, held
     bit for bit to their twins and to the unsharded kernel and twin,
     and timed (all slabs in turn, cold L2); then two ranks spawned as
     interpreters of this script (NCCL with one card each where there
     are two cards, else gloo with both on this card): (a) an agent
     axis of two, 31 days of the HUS run, whose rows must equal step
     3's rows 0-30 and whose gathered final state must equal an
     unsharded 31-day run, with 30 launches of the sharded ledger and
     60 of the sharded prefix on each rank; (b) a seed axis of two,
     run_ensemble over seeds 0-2 for 31 days, equal to step 6's members
     on their first 30 days;
  8. runs the CLI through the simulation driver in this process, twice
     (30 days, seeds 1 and 2): the second call must be served by the
     build cache and reseed_run;
  9. serves: warmup_serving_program("cuda") must leave the default
     session's run in the build cache; then the port's GraphQL server
     (127.0.0.1, any free port, memory cache) takes runs that a client
     starts and polls over HTTP with the web UI's own documents. Run W,
     a fresh session's default run, must be served by the warm-up's
     build; it is timed to its first partial result and cancelled. Two
     365-day HUS runs follow: run A (seed 0, a build-cache miss, whose
     build fits the warm-up's graph set and so must build no span and no
     day graph; polled every 0.05 s until its first partial result) must
     stream partial results and equal step 3's daily all_infected and
     susceptible exactly, and export its 365 days as a workbook; it runs
     five times, with empty result and memo caches and its build dropped
     from the build cache before each, and the median of its first partials
     and build seconds is printed with the build's split into host
     compile and upload; run B (seed 1) must be a reseed of A's build
     and end inside the same
     outcome band; the explorer's severity counts through the server
     must equal the port's on the CPU. Last, 30-day runs from sessions
     of their own, one alone, then 2, 4, 8 and 16 at once, time the
     worker threads' sharing of the card, with each group's peak device
     memory.

    python3 chip_smoke.py --mesh K

runs only step 7's ranks, for 2 and K ranks (NCCL with K cards), after
the 31 days of step 3 and the ensemble of step 6 that they are held to.
Over NCCL the agent axis of (a) runs the 365-day HUS run (plain,
graphed, graphed again), and the two-rank world then profiles rank 0's
graphed days 100-109 with torch.profiler (busy ms/day, idle share, the
NCCL, sharded ledger and sharded prefix kernels' ms/day). With four
ranks, (c) the (2 seed × 2 agent) mesh: run_ensemble over seeds 0-2 for
31 days, each agent group of two cards running its members graphed,
whose members must equal the ensemble phase's bit for bit, with one
day-graph launch and no host read a day on every rank and equal picks
within each agent group; seeds/h and each rank's peak memory beside the
seed axis alone (b). Then (d), a lost rank on two cards over NCCL, the
HUS run cut to 8 days: (d1) rank 1's day-graph launch of day 3 raises
on purpose, (d2) rank 1's process ends there (os._exit); every rank
left must raise, within 5 s in (d1) and within the liveness bound
(reina_tpu_torch/parallel/mesh.py: LIVENESS_S) plus 10 s of rank 1's
end in (d2), each in a world of its own; then every rank left must run
a one-card graphed run on its card equal to the same run made before
(its card usable: the stop word kept what the aborted collectives left
from every kernel) and tear its world down; the seconds of each raise
and of destroy_process_group are printed. Last, (d3): the HUS run cut
to the same days, built on cuda:1 and run graphed once with cuda:1
current and once with cuda:0 current, must be equal bit for bit, picks
included. ``python3 chip_smoke.py --lost`` runs (d) alone.

Each of steps 3, 4c, 4d, 5, 8, the ensemble, the grid and the CLI's
calibrate runs of 4c and 6, the agent-sharded run of 7 (in each rank)
and each served run of 9 sets the kernels' launch counts to 0 just
before it and reads them just after. It prints one JSON line of kernel
results (step 2's and the main path's launches) before the last line,
and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result. Nothing runs on the CPU in its place.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

HUS_AGENTS = 1685983
MC_MEAN, MC_STD = 373466.083, 22395.919729319245
DAYS = 365
RESUME_AT = 182
CLI_DAYS = 30
ENS_DAYS = 61
GRID = [0.35, 0.55, 0.7]
MESH_DAYS = 31
# a mesh phase's ranks are killed after this many seconds
MESH_CHILD_S = 150
MESH_SEEDS = [0, 1, 2]
# the lost-rank phase: the HUS run cut to this many days, rank 1 failing
# at its day-graph launch of day LOST_AT
LOST_DAYS, LOST_AT = 8, 3
CLI_GRID = [0.45, 0.65]
POLL_S = 0.5
# run A's poll until its first partial result: finer than the web UI's
FINE_POLL_S = 0.05
# run A's builds timed, each a build-cache miss
RUN_A_TIMES = 5
# the preset scenarios besides the default (config/scenarios.py)
PRESETS = ("mitigation", "summer-boogie", "hammer-and-dance",
           "looser-restrictions-to-start-with")
# a HUS build of the default's shapes with other values: beds, ICU
# units, infectiousness, and a mobility limit moved by a week
OTHER_VALUES = {"hospital_beds": 2000, "icu_units": 250,
                "infectiousness_multiplier": 0.5}
MOVED = (["limit-mobility", "2020-03-15", 80, 0, 70, "other"],
         ["limit-mobility", "2020-03-22", 80, 0, 70, "other"])
VS_AREA = "Varsinais-Suomi"
WEBUI_POLL = ("query($id: ID!){ simulationResults(runId:$id) {\n"
              "      finished phase predictedMetrics { dates metrics { type "
              "intValues floatValues } } } }")


# kernels launched once a stepped day (the gamma sampler draws the day's
# two samples in one launch; the prefix twice or more a day, the
# snapshot one-hot sums once a run), binomial_fixed twice a day, the
# draw kernel seven times or more a day (the contact normal, the three
# receiver uniforms, the attribution's gumbel and uniform, the
# severity uniform; tracing, imports and vaccination draw more)
DAILY = ("fused_map.prologue", "fused_map.recv_front", "fused_map.post",
         "fused_map.finalize", "ledger_scan", "fused_fn_onehot_sum",
         "fused_bihistogram", "random.gamma_fixed")
TWICE = ("random.binomial_fixed",)
DRAWS_A_DAY = 7
CAPTURE_DAY = 100


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def hold(cs, results: dict, label: str = "") -> None:
    """Each check's kernel against its twin (timed), into ``results`` by
    name; fails if any disagrees."""
    from reina_tpu_torch.kernels import checks
    for c in cs:
        r = checks.run_check(c)
        results[c.name] = (c, r)
        lib = "none" if r.library_ms is None else f"{r.library_ms:.4f} ms"
        print(f"{label}kernel {r.name:22s} ok={r.ok} "
              f"mismatches={r.mismatches} max_abs_err={r.max_abs_err:.3g} "
              f"max_ulp={r.max_ulp} kernel {r.ms:.4f} ms  twin "
              f"{r.plain_ms:.4f} ms  library {lib}  bound {r.bound_ms:.4f} "
              f"ms ({r.bound_by})"
              + ("" if c.library_note == "" else f"  [{c.library_note}]"))
    bad = [n for n, (_, r) in results.items() if not r.ok]
    if bad:
        fail(f"{label}kernels disagree with their twins: {bad}")


# the prefix kernel's launches: alone, and with the tier picks of its
# count (a graphed day's compactions and its count of new infections)
PREFIX = ("fused_concat_prefix", "fused_concat_prefix.pick")


def check_launched(launches: dict, want: dict, phase: str) -> None:
    """At least ``want[k]`` launches of each kernel ``k`` (a tuple of
    names: of them together)."""
    for k, lo in want.items():
        got = sum(launches.get(x, 0) for x in (k if isinstance(k, tuple)
                                                else (k,)))
        if got < lo:
            fail(f"{phase}: {k} launched {got} times, want ≥ {lo}")


def check_picks_launched(launches: dict, picks, phase: str) -> None:
    """A graphed run's picks against its launches, exactly: each fold
    (core/daygraph.py:FOLDS) is one launch of its producer on each day
    its first pick was made, an entry of the picks table (the prefix
    with its picks for the slot pick, the tracing cond with T1 and T3;
    the reduce-and-pick for T2 and T4, beside its warm-ups' launches,
    which make no pick); no separate pick launch."""
    from reina_tpu_torch import kernels
    from reina_tpu_torch.core import daygraph
    warm = kernels.warmups()
    for k, n in daygraph.fold_launches(picks).items():
        if launches.get(k, 0) != n + warm.get(k, 0):
            fail(f"{phase}: {k} launched {launches.get(k, 0)} times, want "
                 f"{n} (one a fold's first pick) and {warm.get(k, 0)} in "
                 f"warm-ups")


def day_launches(steps: int, snapshots: int) -> dict:
    """The least launches of ``steps`` stepped days and ``snapshots``
    day-0 snapshots."""
    return ({k: steps for k in DAILY} | {k: 2 * steps for k in TWICE}
            | {PREFIX: 2 * steps,
               "prng.draw": DRAWS_A_DAY * steps,
               "fused_onehot_sum": snapshots})


def resume_phase(run, out, state, scratch: str) -> None:
    """Checkpoint at day RESUME_AT, resume to the end, compare with the
    uninterrupted run."""
    import numpy as np
    import torch
    from reina_tpu_torch import kernels
    from reina_tpu_torch.core import checkpoint as ckpt
    from reina_tpu_torch.core.engine import run_days

    d = os.path.join(scratch, "resume")
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, st1, cr1, _ = run_days(run, n_days=RESUME_AT + 1, checkpoint_dir=d,
                              checkpoint_every=RESUME_AT)
    torch.cuda.synchronize()
    leg1 = time.perf_counter() - t0
    path = ckpt.checkpoint_path(d, RESUME_AT)
    if not os.path.exists(path):
        fail(f"resume: no checkpoint at day {RESUME_AT}")
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    ckpt.save_checkpoint(os.path.join(scratch, "again.npz"), st1, cr1)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.load_checkpoint(path)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out2, state2, _, _ = run_days(run, n_days=DAYS, checkpoint_dir=d)
    torch.cuda.synchronize()
    leg2 = time.perf_counter() - t0
    launches = kernels.launches()
    print(f"resume: leg 1 (days 0-{RESUME_AT}) {leg1:.3f} s, leg 2 "
          f"(days {RESUME_AT}-{DAYS - 1}, resumed) {leg2:.3f} s; "
          f"checkpoint {size} bytes, save {save_s:.3f} s, load "
          f"(with bucket rebuild) {load_s:.3f} s; launches={launches}")
    steps = DAYS - 1
    check_launched(launches, day_launches(steps, 2), "resume")
    for name, a, b in zip(out._fields, out, out2):
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"resume: outputs.{name} differ from the uninterrupted run")
    for name, a, b in zip(state._fields, state, state2):
        if not torch.equal(a, b):
            fail(f"resume: state.{name} differs from the uninterrupted run")
    print("resume: outputs and final state equal the uninterrupted run "
          "bit for bit")


def graphs_phase(run, out, state, carry, wall: float, stats: dict,
                 peak: int, dev_picks) -> None:
    """The main path's graphed run against the plain day step and a
    second graphed run from the built set: equal bit for bit, the
    device's tier picks equal to the host's on every day, one day-graph
    launch and no host read a day."""
    import numpy as np
    import torch
    from reina_tpu_torch import convert
    from reina_tpu_torch.core import graphs, step
    from reina_tpu_torch.core.engine import run_days

    steps = DAYS - 1
    [gs] = graphs.idle()
    captured = sorted(gs.bodies)
    day_graphs = sorted(gs.days)
    arrays_b = sum(x.numel() * x.element_size() for x in gs.arrays)
    tables_b = sum(x.numel() * x.element_size()
                   for x in (gs.mobility, gs.mask_p))
    print(f"graphs: the set's static copies of a build: model arrays "
          f"{arrays_b / 2**30:.4f} GiB, schedule tables "
          f"{tables_b / 2**30:.4f} GiB ({gs.rows} days)")
    print(f"graphs: {stats.get('captures', 0)} spans captured in "
          f"{stats.get('graphs.capture_s', 0.0):.3f} s (span, key): "
          f"{captured}; {len(day_graphs)} day graphs (ct_active, vacc, "
          f"imports) {day_graphs} assembled in "
          f"{stats.get('graphs.assemble_s', 0.0):.3f} s; "
          f"{stats.get('launches', 0) / steps:.2f} day-graph launches and "
          f"{stats.get('reads', 0) / steps:.2f} host reads a day; graphed "
          f"{wall / steps * 1000:.2f} ms/day with the builds, peak "
          f"device memory {peak / 2**30:.2f} GiB")
    if stats.get("launches") != steps or stats.get("reads", 0):
        fail("graphs: the graphed run did not launch one day graph and "
             "read nothing a day")
    want = (out, state, carry)
    for mode, graphed in (("eager", False), ("graphed again", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        step.reset_stats()
        picks = []
        t0 = time.perf_counter()
        got = run_days(run, chunk_days=52, graphs=graphed, picks=picks)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = dict(step.STATS)
        print(f"graphs: {mode} {secs / steps * 1000:.2f} ms/day "
              f"({run.n_agents * steps / secs:.1f} agent-days/s), "
              f"{st.get('captures', 0)} captures, "
              f"{st.get('launches', 0) / steps:.2f} day-graph launches and "
              f"{st.get('reads', 0) / steps:.2f} host reads a day, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB ({held / 2**30:.2f} GiB held before the run)")
        if graphed and (st.get("captures", 0) or st.get("reads", 0)
                        or st.get("launches") != steps):
            fail("graphs: the second graphed run captured or read again")
        if not graphed:
            if len(picks) != steps or len(dev_picks) != steps:
                fail(f"graphs: {len(picks)} host and {len(dev_picks)} "
                     f"device rows of picks, want {steps}")
            bad = np.flatnonzero((np.array(picks) != np.array(dev_picks))
                                 .any(axis=1))
            if bad.size:
                fail(f"graphs: the device's picks differ from the host's on "
                     f"days {bad[:10].tolist()}")
            tab = np.array(picks)
            print(f"graphs: the device's picks equal the host's on all "
                  f"{steps} days; tracing on {int((tab[:, 0] == 1).sum())}"
                  f" days; slot tiers used "
                  f"{np.bincount(tab[:, 5], minlength=5).tolist()}; "
                  f"member tiers of n_d "
                  f"{np.bincount(tab[tab[:, 1] >= 0, 1], minlength=5).tolist()}")
        elif not np.array_equal(np.array(picks), np.array(dev_picks)):
            fail("graphs: the second graphed run picked other tiers")
        for name, a, b in zip(out._fields, want[0], got[0]):
            if a.shape != b.shape or not np.array_equal(a, b):
                fail(f"graphs: {mode}: outputs.{name} differ")
        for what, w, g in (("state", want[1], got[1]),
                           ("carry", want[2], got[2])):
            w, g = convert.to_numpy(w), convert.to_numpy(g)
            for k in w:
                if not np.array_equal(w[k], g[k]):
                    fail(f"graphs: {mode}: {what}.{k} differs")
        del got
    print("graphs: the graphed run equals the plain day step and the "
          "graphed run again on every output row, the final state and "
          "carry")


def modes_equal(run, label: str, snapshots: int):
    """``run`` graphed, then with the plain day step: every kernel of
    each launched exactly as often as the days ran it (a fold's producer
    with its picks once a day its first pick was made; one day-graph
    launch and no host read a graphed day), agents conserved, the device's picks equal to the
    host's on every day, and the outputs, final state and carry equal bit
    for bit. Returns (the graphed outputs, {mode: figures})."""
    import numpy as np
    import torch
    from reina_tpu_torch import convert, kernels
    from reina_tpu_torch.core import step
    from reina_tpu_torch.core.engine import run_days

    steps = run.days - 1
    res, info = {}, {}
    for mode, graphed in (("graphed", True), ("plain", False)):
        kernels.reset_launches()
        step.reset_stats()
        picks = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res[mode] = run_days(run, chunk_days=52, graphs=graphed, picks=picks)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kernels.launches()
        st = dict(step.STATS)
        out = res[mode][0]
        check_runs_launched(launches, steps, snapshots, f"{label} {mode}")
        if graphed:
            check_picks_launched(launches, picks, label)
            if st.get("launches") != steps or st.get("reads", 0):
                fail(f"{label}: the graphed run did not launch one day "
                     "graph and read nothing a day")
        cons = out.by_group[:, 0].sum(1) + out.by_group[:, 3].sum(1)
        if not (cons == run.n_agents).all():
            fail(f"{label} {mode}: agents not conserved")
        res[mode + " picks"] = picks
        info[mode] = dict(
            secs=secs, ms_day=secs / steps * 1000, launches=launches,
            peak=torch.cuda.max_memory_allocated(),
            captures=st.get("captures", 0),
            day_graphs=st.get("day_graphs", 0),
            final=int(out.by_group[-1, 3].sum()))
    bad = np.flatnonzero((np.array(res["graphed picks"])
                          != np.array(res["plain picks"])).any(axis=1))
    if len(res["plain picks"]) != steps or bad.size:
        fail(f"{label}: the device's picks differ from the host's on days "
             f"{bad[:10].tolist()}")
    (go, gst, gcr), (eo, est, ecr) = (res["graphed"][:3], res["plain"][:3])
    for name, a, b in zip(go._fields, go, eo):
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"{label}: outputs.{name} differ")
    for what, w, g in (("state", est, gst), ("carry", ecr, gcr)):
        w, g = convert.to_numpy(w), convert.to_numpy(g)
        for k in w:
            if not np.array_equal(w[k], g[k]):
                fail(f"{label}: {what}.{k} differs")
    return go, info


def turku_phase() -> None:
    """The turku override set (config/override_sets.json: Turku, 900
    beds, 55 ICU units, its calendar) with its astra-zeneca scenario,
    whose vaccinate event (2021-03-15, day 391) is the only one in the
    set: its 565 default days graphed and with the plain day step, equal
    bit for bit, with one-hot vaccination sums on every vaccination
    day."""
    import copy

    from reina_tpu_torch.config.variables import (VARIABLE_DEFAULTS,
                                                  VARIABLE_OVERRIDE_SETS)
    from reina_tpu_torch.core.engine import build_run

    v = dict(VARIABLE_DEFAULTS)
    v.update(copy.deepcopy(VARIABLE_OVERRIDE_SETS["turku"]))
    v["active_scenario"] = "astra-zeneca"
    t0 = time.perf_counter()
    run = build_run(v, "cuda")
    build_s = time.perf_counter() - t0
    steps = run.days - 1
    vacc_nr = run.schedules.vacc_nr.cpu().numpy()
    vacc_days = int((vacc_nr[:steps].sum(axis=1) >= 1.0).sum())
    out, info = modes_equal(run, "turku", 1 + vacc_days)
    for mode, m in info.items():
        print(f"turku {mode}: {run.n_agents} agents, {steps} days in "
              f"{m['secs']:.3f} s ({m['ms_day']:.2f} ms/day, build "
              f"{build_s:.3f} s), {m['captures']} captures; vaccination "
              f"days {vacc_days}, fused_onehot_sum launched "
              f"{m['launches']['fused_onehot_sum']}; final all_infected "
              f"{m['final']}, vaccinated {int(out.by_group[-1, 1].sum())}")
    if vacc_days == 0 or int(out.by_group[-1, 1].sum()) == 0:
        fail("turku: no vaccination ran")
    print("turku: the graphed run equals the plain day step bit for bit "
          "(outputs, final state and carry, picks)")


def reuse_phase() -> None:
    """New builds of the main path's shapes on its graph set: the four
    preset scenarios, then a build with other values (OTHER_VALUES, a
    mobility limit moved by a week), each 365 days graphed and with the
    plain day step, equal bit for bit. Each must take the main path's
    idle set and build only the spans and day graphs of host keys the
    set lacks (none, for a build whose host keys it holds)."""
    from reina_tpu_torch.config import scenarios
    from reina_tpu_torch.config.variables import (VARIABLE_DEFAULTS,
                                                  session_store)
    from reina_tpu_torch.core import graphs
    from reina_tpu_torch.core.engine import build_run

    builds = []
    for sid in PRESETS:
        with session_store() as store:
            scenarios.get_scenario(sid).apply()
            store.set("simulation_days", DAYS)
            builds.append((sid, store.copy_all()))
    v = dict(VARIABLE_DEFAULTS, simulation_days=DAYS, **OTHER_VALUES)
    ivs = [list(iv) for iv in v["interventions"]]
    ivs[ivs.index(MOVED[0])] = MOVED[1]
    v["interventions"] = ivs
    builds.append(("other values", v))
    for label, v in builds:
        idle = graphs.idle()
        if len(idle) != 1:
            fail(f"reuse {label}: {len(idle)} idle graph sets, want the "
                 "main path's")
        gs = idle[0]
        bodies, days = set(gs.bodies), set(gs.days)
        t0 = time.perf_counter()
        run = build_run(v, "cuda")
        build_s = time.perf_counter() - t0
        _, info = modes_equal(run, f"reuse {label}", 1)
        g, e = info["graphed"], info["plain"]
        new_bodies, new_days = set(gs.bodies) - bodies, set(gs.days) - days
        print(f"reuse {label}: build {build_s:.3f} s; graphed "
              f"{g['ms_day']:.2f} ms/day on the main path's set, "
              f"{g['captures']} spans and {g['day_graphs']} day graphs "
              f"built (host keys new to the set: {sorted(new_days)}); plain "
              f"{e['ms_day']:.2f} ms/day; final all_infected {g['final']}; "
              f"equal bit for bit, picks equal on all {run.days - 1} days")
        if graphs.idle() != [gs]:
            fail(f"reuse {label}: the run did not take the main path's set")
        if (g["captures"], g["day_graphs"]) != (len(new_bodies),
                                                len(new_days)):
            fail(f"reuse {label}: built {g['captures']} spans and "
                 f"{g['day_graphs']} day graphs, want {len(new_bodies)} and "
                 f"{len(new_days)} (the set's missing host keys only)")
        del run


def vs_phase() -> None:
    """Varsinais-Suomi (VARIABLE_DEFAULTS with its area: 479,861 agents,
    480,256 padded): every kernel of the path against its twin at its
    agent count (the draws and samplers on its run's day-100 inputs),
    its 365 days graphed and with the plain day step, equal bit for bit,
    then the CLI's calibrate against its observed cases."""
    import torch
    from reina_tpu_torch import cli, kernels
    from reina_tpu_torch.config.variables import VARIABLE_DEFAULTS
    from reina_tpu_torch.core.engine import build_run
    from reina_tpu_torch.kernels import checks

    results = {}
    hold(checks.checks(checks.VS_N, 0, "cuda"), results, "VS ")
    v = dict(VARIABLE_DEFAULTS, area_name=VS_AREA, simulation_days=DAYS)
    t0 = time.perf_counter()
    run = build_run(v, "cuda")
    build_s = time.perf_counter() - t0
    n_pad = run.init_state.age.shape[0]
    print(f"VS build_run: {build_s:.3f} s, agents={run.n_agents}, "
          f"padded={n_pad}")
    if (run.n_agents, n_pad) != (checks.VS_AGENTS, checks.VS_N):
        fail(f"VS: {run.n_agents} agents padded to {n_pad}, want "
             f"{checks.VS_AGENTS} and {checks.VS_N}")
    captured = checks.capture_samplers(run, CAPTURE_DAY)
    torch.cuda.synchronize()
    print(f"VS day {CAPTURE_DAY}'s sampler inputs: binomial_fixed lanes "
          f"{[int(n.numel()) for n, _ in captured['binomial']]}, "
          f"gamma_fixed_pair (kappa1, kappa2, shape) {captured['gamma']}")
    hold(checks.draw_checks(0, "cuda", captured, checks.VS_N), results,
         "VS ")
    del captured
    hold(checks.fold_checks(checks.VS_N, 0, "cuda"), results, "VS ")
    _, info = modes_equal(run, "VS", 1)
    for mode, m in info.items():
        print(f"VS {mode}: {run.days - 1} days in {m['secs']:.3f} s "
              f"({m['ms_day']:.2f} ms/day, "
              f"{run.n_agents * (run.days - 1) / m['secs']:.1f} "
              f"agent-days/s), {m['captures']} spans and "
              f"{m['day_graphs']} day graphs built, peak device memory "
              f"{m['peak'] / 2**30:.2f} GiB; final all_infected "
              f"{m['final']}; launches={m['launches']}")
    print("VS: the graphed run equals the plain day step bit for bit "
          "(outputs, final state and carry), the device's picks equal the "
          f"host's on all {run.days - 1} days, launches exact")
    del run
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["calibrate", "--area", VS_AREA, "--grid", json.dumps(
        {"infectiousness_multiplier": CLI_GRID}), "--days",
        str(ENS_DAYS)])
    wall = time.perf_counter() - t0
    print(f"VS cli calibrate: exit {rc}, {wall:.3f} s for {len(CLI_GRID)} "
          f"points x {ENS_DAYS - 1} days, {wall / len(CLI_GRID):.3f} s per "
          f"point (build + days); launches={kernels.launches()}")
    if rc != 0:
        fail(f"VS cli calibrate: exit code {rc}")
    check_runs_launched(kernels.launches(), len(CLI_GRID) * (ENS_DAYS - 1),
                        len(CLI_GRID), "VS cli calibrate")


def check_runs_launched(launches: dict, steps: int, runs: int,
                        phase: str) -> None:
    """Exactly one launch of each DAILY kernel a stepped day, two of
    each TWICE kernel and one of the snapshot one-hot sums a run, beside the
    graph warm-ups' launches counted since the counts were reset
    (kernels.WARMUPS); at least two prefix calls and DRAWS_A_DAY draws a
    day."""
    from reina_tpu_torch import kernels
    warm = kernels.warmups()
    for k, n in ({k: steps for k in DAILY} | {k: 2 * steps for k in TWICE}
                 | {"fused_onehot_sum": runs}).items():
        if launches.get(k, 0) != n + warm.get(k, 0):
            fail(f"{phase}: {k} launched {launches.get(k, 0)} times, "
                 f"want {n} and {warm.get(k, 0)} in warm-ups")
    check_launched(launches, {PREFIX: 2 * steps,
                              "prng.draw": DRAWS_A_DAY * steps}, phase)


def ensemble_phase(run, v, out, one_run_bytes: int, run_bytes: int) -> None:
    """Seeds and grid points through the single-run path at HUS width:
    run_ensemble on the main path's build, sweep_grid with the default
    point in the middle, and the CLI's calibrate."""
    import numpy as np
    import torch
    from reina_tpu_torch import cli, kernels
    from reina_tpu_torch.calibration import score_against_observed, sweep_grid
    from reina_tpu_torch.core.step import DayOutputs
    from reina_tpu_torch.ensemble import run_ensemble

    steps = ENS_DAYS - 1
    main_rows = DayOutputs(*(x[1:ENS_DAYS] for x in out))

    def same(outs, g, want, what):
        for name, a, b in zip(DayOutputs._fields, outs, want):
            if a[g].shape != b.shape or not np.array_equal(a[g], b):
                fail(f"{what}: {name} differs from the main path's rows "
                     f"1-{steps}")

    def conserved(outs, what):
        cons = outs.by_group[:, :, 0].sum(-1) + outs.by_group[:, :, 3].sum(-1)
        if not (cons == run.n_agents).all():
            fail(f"{what}: agents not conserved")

    seeds = [0, 1, 2]
    kernels.reset_launches()
    t0 = time.perf_counter()
    ens = run_ensemble(run, seeds=seeds, n_days=ENS_DAYS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    check_runs_launched(launches, len(seeds) * steps, len(seeds), "ensemble")
    finals = ens.by_group[:, -1, 3].sum(-1)
    print(f"ensemble: seeds {seeds} x {steps} days in {wall:.3f} s, "
          f"{wall / len(seeds):.3f} s per member, "
          f"{wall / (len(seeds) * steps) * 1000:.2f} ms/day; day-{steps} "
          f"all_infected {finals.tolist()}; launches={launches}")
    if ens.by_group.shape[:2] != (len(seeds), steps):
        fail(f"ensemble: by_group shape {ens.by_group.shape}")
    same(ens, 0, main_rows, "ensemble member 0")
    for i, j in ((0, 1), (0, 2), (1, 2)):
        if np.array_equal(ens.by_group[i], ens.by_group[j]):
            fail(f"ensemble: members {i} and {j} are equal")
    conserved(ens, "ensemble")
    print("ensemble: member 0 equals the main path's rows bit for bit; "
          "members distinct; agents conserved")
    ens_ms_day = wall / (len(seeds) * steps) * 1000

    grid = {"infectiousness_multiplier": GRID}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    points, outs, base = sweep_grid(v, grid, n_days=ENS_DAYS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    extra = torch.cuda.max_memory_allocated() - before
    launches = kernels.launches()
    check_runs_launched(launches, len(GRID) * steps, len(GRID), "grid")
    finals = outs.by_group[:, -1, 3].sum(-1)
    secs = ", ".join(f"{b:.3f} + {d:.3f}"
                     for b, d in base.meta["sweep_seconds"])
    print(f"grid: {len(points)} points x {steps} days in {wall:.3f} s, "
          f"{wall / len(points):.3f} s per point (build + days: {secs} s); "
          f"peak device memory above the start {extra / 2**30:.3f} GiB "
          f"(the main path's run: {one_run_bytes / 2**30:.3f} GiB, of it "
          f"the built run {run_bytes / 2**30:.3f}); day-{steps} "
          f"all_infected {finals.tolist()}; launches={launches}")
    same(outs, GRID.index(0.55), main_rows, "grid point 0.55")
    if not (np.diff(finals) > 0).all():
        fail(f"grid: finals do not rise with the multiplier: {finals}")
    conserved(outs, "grid")
    # one run's memory and the base run held beside it, not G runs'
    if extra > one_run_bytes + run_bytes + 2**27:
        fail(f"grid: {extra} bytes at peak, more than one run's "
             f"{one_run_bytes} and the base run's {run_bytes}")
    scores = score_against_observed(outs, base)
    ranked = sorted(zip(points, scores.tolist()), key=lambda x: x[1])
    print("grid vs HUS observed confirmed: " + "; ".join(
        f"{pt['infectiousness_multiplier']} {sc:.5f}" for pt, sc in ranked))
    del base, outs

    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["calibrate", "--grid", json.dumps(
        {"infectiousness_multiplier": CLI_GRID}), "--days",
        str(CLI_DAYS + 1)])
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    print(f"cli calibrate: exit {rc}, {wall:.3f} s for {len(CLI_GRID)} "
          f"points x {CLI_DAYS} days; launches={launches}")
    if rc != 0:
        fail(f"cli calibrate: exit code {rc}")
    check_runs_launched(launches, len(CLI_GRID) * CLI_DAYS, len(CLI_GRID),
                        "cli calibrate")
    return ens, ens_ms_day


def mesh_kernels(results: dict) -> dict:
    """The sharded ledger and prefix at HUS shape for 2, 4 and 8 slabs,
    slab by slab in this process, and the sharded prefix's emit with its
    count and picks; returns the 2-slab results (the layout of the
    two-rank run) by name."""
    from reina_tpu_torch.kernels import checks

    unsharded = {"ledger_sharded": "ledger_scan",
                 "concat_prefix_sharded": "fused_concat_prefix",
                 "concat_prefix_sharded.pick": "fused_concat_prefix.pick"}
    out = {}
    for k in (2, 4, 8):
        for c in checks.sharded_checks(checks.HUS_N, 0, "cuda", k):
            r = checks.run_check(c)
            one = results[unsharded[c.name]][1]
            lib = "none" if r.library_ms is None else f"{r.library_ms:.4f} ms"
            print(f"mesh kernel {c.name} k={k}: ok={r.ok} "
                  f"mismatches={r.mismatches} (against its twin and the "
                  f"unsharded kernel and twin; the ledger at offsets 0, "
                  f"N-1, inside slab 0's last tile and from device memory "
                  f"on and across the slab edges; the count and picks at "
                  f"every branch of every prefix fold) all {k} slabs "
                  f"{r.ms:.4f} ms, unsharded kernel {one.ms:.4f} ms; twin "
                  f"{r.plain_ms:.4f} ms, library {lib}, bound "
                  f"{r.bound_ms:.4f} ms ({r.bound_by})")
            if not r.ok:
                fail(f"mesh: {c.name} over {k} slabs disagrees")
            if k == 2:
                out[c.name] = (c, r)
        host, dev = checks.sharded_ledger_offset_ms(checks.HUS_N, 0, "cuda",
                                                    k)
        print(f"mesh kernel ledger_sharded k={k}: all {k} slabs with the "
              f"offset a host int {host:.4f} ms, read from device memory "
              f"{dev:.4f} ms ({dev / host:.3f}x)")
    return out


# the sharded forms' launch counts (kernels.LAUNCHES)
SHARDED = ("ledger_sharded.fold", "ledger_sharded.emit",
           "concat_prefix_sharded.totals", "concat_prefix_sharded.emit",
           "concat_prefix_sharded.pick")


def mesh_child(rank: int, world: int, port: int, backend: str,
               work: str, days: int) -> None:
    """One rank of the mesh phase (run as ``chip_smoke.py --mesh-child``):
    (a) the agent axis for ``days`` days with the plain day step and,
    over NCCL, graphed (a first run that builds the graph set, then
    again on it), (b) the seed axis; results into ``work``."""
    import numpy as np
    import torch
    from reina_tpu_torch import convert, kernels
    from reina_tpu_torch.config.variables import VARIABLE_DEFAULTS
    from reina_tpu_torch.core import graphs as G
    from reina_tpu_torch.core import step
    from reina_tpu_torch import ensemble as E
    from reina_tpu_torch.agent_axis import profile_window
    from reina_tpu_torch.core.engine import build_run, run_days
    from reina_tpu_torch.ensemble import run_ensemble
    from reina_tpu_torch.kernels import build
    from reina_tpu_torch.parallel import mesh as M

    import faulthandler
    # a rank still running near the parent's deadline prints where it is
    faulthandler.dump_traceback_later(MESH_CHILD_S - 40, exit=False)
    build.lib()                 # built by the parent: loaded here
    dev = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    M.init_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend)
    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = DAYS
    run = build_run(v, dev)
    rec = {"rank": rank, "device": str(dev)}
    agents = M.make_mesh(1, world, device=dev)

    def agent_run(label, graphs):
        torch.cuda.synchronize()
        kernels.reset_launches()
        M.reset_stats()
        step.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        picks = []
        t0 = time.perf_counter()
        out, state, _, _ = run_days(run, n_days=days, mesh=agents,
                                    graphs=graphs, picks=picks)
        torch.cuda.synchronize()
        rec[label] = {"s": time.perf_counter() - t0,
                      "launches": kernels.launches(),
                      "warmups": kernels.warmups(), "stats": M.stats(),
                      "step": dict(step.STATS),
                      "peak": torch.cuda.max_memory_allocated(),
                      "picks": np.asarray(picks).tolist()}
        np.savez(os.path.join(work, f"{label}_{rank}.npz"),
                 **{"out__" + k: np.asarray(x)
                    for k, x in zip(out._fields, out)},
                 **{"st__" + k: x
                    for k, x in convert.to_numpy(state).items()})

    # the graphed runs share one graph set; it is freed when the scope
    # ends, before the communicators are destroyed
    with G.reusing():
        for label, graphs in (("plain", False), ("graphed", True),
                              ("again", True))[:3 if backend == "nccl"
                                               else 1]:
            agent_run(label, graphs)
            print(f"rank {rank}: agent axis {label} done in "
                  f"{rec[label]['s']:.3f} s", flush=True)
        if backend == "nccl" and world == 2:
            rec["profile"] = profile_window(run, agents, rank == 0)

    def seed_run(label, mesh):
        torch.cuda.synchronize()
        M.reset_stats()
        step.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        # the picks rows of the members this rank runs, one after
        # another: each member's run_days gets this list
        picks = []

        def with_picks(*args, **kw):
            return run_days(*args, picks=picks, **kw)

        E.run_days = with_picks
        t0 = time.perf_counter()
        try:
            ens = run_ensemble(run, MESH_SEEDS, n_days=MESH_DAYS, mesh=mesh)
        finally:
            E.run_days = run_days
        torch.cuda.synchronize()
        rec[label] = {"s": time.perf_counter() - t0,
                      "members": len(M.batch_placement(mesh, MESH_SEEDS)),
                      "step": dict(step.STATS), "stats": M.stats(),
                      "peak": torch.cuda.max_memory_allocated(),
                      "picks": np.asarray(picks).tolist()}
        print(f"rank {rank}: {label} done in {rec[label]['s']:.3f} s",
              flush=True)
        if rank == 0:
            np.savez(os.path.join(work, f"{label}.npz"),
                     **{k: x for k, x in zip(ens._fields, ens)})

    # (b) the seed axis; (c) with four ranks over NCCL, two agent groups
    # of two cards, each running its members graphed
    seed_run("ensemble", M.make_mesh(world, 1, device=dev))
    if backend == "nccl" and world == 4:
        seed_run("both", M.make_mesh(2, 2, device=dev))
    with open(os.path.join(work, f"rank_{rank}.json"), "w") as f:
        json.dump(rec, f)
    # the communicators' teardown, which the parent's deadline bounds
    t0 = time.perf_counter()
    torch.distributed.destroy_process_group()
    with open(os.path.join(work, f"down_{rank}.txt"), "w") as f:
        f.write(f"{time.perf_counter() - t0:.3f}")


def lost_child(rank: int, port: int, work: str, case: str) -> None:
    """One rank of a lost-rank world (run as ``chip_smoke.py
    --lost-child``), over NCCL on cuda:``rank``: the HUS run cut to
    LOST_DAYS days, one card graphed; then a graphed agent axis of two
    whose rank 1, at its day-graph launch of day LOST_AT, raises (case
    ``d1``) or ends its process (``d2``); then this rank's one-card
    graphed run again, against the first (:func:`usable`). Writes its
    record into ``work``, then tears the world down where its card is
    usable, else leaves at once (the phase fails then)."""
    import torch
    from reina_tpu_torch.config.variables import VARIABLE_DEFAULTS
    from reina_tpu_torch.core import daygraph
    from reina_tpu_torch.core import graphs as G
    from reina_tpu_torch.core.engine import build_run, run_days
    from reina_tpu_torch.kernels import build
    from reina_tpu_torch.parallel import mesh as M

    import faulthandler
    faulthandler.dump_traceback_later(MESH_CHILD_S - 40, exit=False)
    build.lib()
    dev = f"cuda:{rank}"
    # the kernels launch on the current device
    torch.cuda.set_device(dev)
    M.init_distributed(f"tcp://127.0.0.1:{port}", 2, rank, "nccl")
    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = LOST_DAYS
    run = build_run(v, dev)
    alone = run_days(run)[0]
    agents = M.make_mesh(1, 2, device=dev)
    launch = daygraph.DayGraph.launch
    seen = {"n": 0}

    def failing(self, stream):
        seen["n"] += 1
        if seen["n"] == LOST_AT + 1:
            if case == "d1":
                raise G.GraphError("day-graph launch refused on purpose")
            with open(os.path.join(work, "ended_at.txt"), "w") as f:
                f.write(f"{time.time():.6f}")
            os._exit(3)
        return launch(self, stream)

    if rank == 1:
        daygraph.DayGraph.launch = failing
    t0 = time.perf_counter()
    try:
        run_days(run, mesh=agents)
        msg = "no error"
    except G.GraphError as e:
        msg = f"GraphError: {e}"
    finally:
        daygraph.DayGraph.launch = launch
    rec = {"rank": rank, "liveness_s": M.LIVENESS_S,
           "s": time.perf_counter() - t0, "at": time.time(),
           "msg": msg[:800]}
    print(f"rank {rank}: {case}: {msg[:300]}", flush=True)
    rec["usable"] = usable(run, alone)
    path = os.path.join(work, f"lost_{rank}.json")
    with open(path, "w") as f:
        json.dump(rec, f)
    if rec["usable"] is not True:
        sys.stdout.flush()
        os._exit(0)
    t0 = time.perf_counter()
    torch.distributed.destroy_process_group()
    rec["down"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(rec, f)


def usable(run, alone):
    """True where this process's one-card graphed run equals ``alone``;
    else what went wrong ("differs", or the error, with whether a
    ``torch.cuda.synchronize()`` then fails too: an ended CUDA
    context)."""
    import numpy as np
    import torch
    from reina_tpu_torch.core.engine import run_days
    try:
        out = run_days(run)[0]
        return (True if all(np.array_equal(a, b) for a, b in zip(alone, out))
                else "differs")
    except Exception as e:
        first = str(e).strip().splitlines()[0][:300]
        try:
            torch.cuda.synchronize()
        except RuntimeError:
            return f"{type(e).__name__} on an ended context: {first}"
        return f"{type(e).__name__}: {first}"


def device_check() -> None:
    """(d3): the HUS run cut to LOST_DAYS days, built on cuda:1, run
    graphed with cuda:1 current and then, on a graph set built anew,
    with cuda:0 current: outputs and picks bit for bit, and the caller's
    current device restored."""
    import numpy as np
    import torch
    from reina_tpu_torch.config.variables import VARIABLE_DEFAULTS
    from reina_tpu_torch.core import graphs as G
    from reina_tpu_torch.core.engine import build_run, run_days
    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = LOST_DAYS
    run = build_run(v, "cuda:1")
    got = {}
    for current in (1, 0):
        G.drop_idle()
        with torch.cuda.device(current):
            picks = []
            t0 = time.perf_counter()
            out = run_days(run, picks=picks)[0]
            torch.cuda.synchronize(1)
            got[current] = (out, picks, time.perf_counter() - t0)
            if torch.cuda.current_device() != current:
                fail(f"mesh (d3): run_days left cuda:"
                     f"{torch.cuda.current_device()} current, not "
                     f"cuda:{current}")
    same = all(np.array_equal(a, b) for a, b in zip(got[1][0], got[0][0]))
    if not same or np.asarray(got[1][1]).tolist() != \
            np.asarray(got[0][1]).tolist():
        fail("mesh (d3): the graphed run on cuda:1 with cuda:0 current "
             "differs from the run with cuda:1 current")
    G.drop_idle()
    print(f"mesh (d3) a graphed HUS run of {LOST_DAYS} days built on "
          f"cuda:1: with cuda:0 current equal bit for bit (outputs and "
          f"{len(got[0][1])} picks rows) to the run with cuda:1 current "
          f"({got[1][2]:.2f} s and {got[0][2]:.2f} s, each building its "
          f"graph set)")


def lost_rank_phase() -> None:
    """(d): two worlds of two ranks over NCCL on cuda:0-1
    (``lost_child``), (d1) and (d2). In (d1) both must raise, rank 0
    naming another rank, within 5 s of each other; in (d2) rank 0 within
    the liveness bound plus 10 s of rank 1's end. After each, every rank
    left must have a one-card run equal to its first. Then (d3),
    :func:`device_check`."""
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    recs = {}
    for case in ("d1", "d2"):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        with tempfile.TemporaryDirectory(dir=here) as work:
            procs = spawn_ranks(["--lost-child"], 2, lambda r: [
                str(r), str(port), work, case], work, here)
            wait_ranks(procs, work, f"mesh ({case})",
                       {1: 3} if case == "d2" else None)
            for r in range(2 if case == "d1" else 1):
                with open(os.path.join(work, f"lost_{r}.json")) as f:
                    recs[case, r] = json.load(f)
            if case == "d2":
                with open(os.path.join(work, "ended_at.txt")) as f:
                    ended = float(f.read())
    d1_0, d1_1, d2_0 = recs["d1", 0], recs["d1", 1], recs["d2", 0]
    bound = d2_0["liveness_s"]
    if not d1_1["msg"].startswith("GraphError") \
            or "on purpose" not in d1_1["msg"]:
        fail(f"mesh (d1): rank 1 raised {d1_1['msg']!r}")
    for case, x in (("d1", d1_0), ("d2", d2_0)):
        if not x["msg"].startswith("GraphError") \
                or "another rank" not in x["msg"]:
            fail(f"mesh ({case}): rank 0 raised {x['msg']!r}")
    apart = abs(d1_0["at"] - d1_1["at"])
    late = d2_0["at"] - ended
    print(f"mesh (d1) rank 1's day-graph launch of day {LOST_AT} refused, "
          f"the HUS run cut to {LOST_DAYS} days, cuda:0-1 over NCCL: rank "
          f"0 raised {d1_0['s']:.3f} s into its run (the graph set's build "
          f"included) and {apart:.3f} s from rank 1: {d1_0['msg'][:400]}; "
          f"rank 1: {d1_1['msg'][:160]}")
    print(f"mesh (d2) rank 1's process ended at its launch of day "
          f"{LOST_AT}: rank 0 raised {late:.3f} s after that end "
          f"(liveness bound {bound:g} s): {d2_0['msg'][:400]}")
    for (case, r), x in sorted(recs.items()):
        if x["usable"] is not True:
            fail(f"mesh ({case}): rank {r}'s card after the failure: its "
                 f"one-card graphed run {x['usable']}")
        print(f"mesh ({case}) rank {r}: its one-card graphed run afterwards "
              f"equals its first; destroy_process_group {x['down']:.3f} s")
    if apart > 5:
        fail(f"mesh (d1): the ranks raised {apart:.3f} s apart")
    if late > bound + 10:
        fail(f"mesh (d2): rank 0 raised {late:.1f} s after rank 1's end "
             f"(bound {bound:g} s + 10 s)")
    device_check()
    print(f"mesh (d): {time.perf_counter() - t_phase:.1f} s")


def spawn_ranks(flag: list, world: int, args_of, work: str,
                here: str) -> list:
    """``world`` interpreters of this script, rank r with ``flag`` and
    ``args_of(r)``, each logging into ``work``: a file, not a pipe, since
    ranks blocked on a full pipe would stall the others in their
    collectives."""
    procs = []
    for r in range(world):
        with open(os.path.join(work, f"rank_{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *flag,
                 *args_of(r)], cwd=here, stdout=log,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, NCCL_DEBUG=os.environ.get(
                    "NCCL_DEBUG", "WARN"))))
    return procs


def wait_ranks(procs: list, work: str, phase: str, codes=None) -> None:
    """Wait for the ranks, killing those still running after
    MESH_CHILD_S; fail unless each exited with its code (``codes``: by
    rank, 0 where it names none)."""
    deadline = time.time() + MESH_CHILD_S
    while time.time() < deadline and any(p.poll() is None for p in procs):
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for r, p in enumerate(procs):
        if p.returncode != (codes or {}).get(r, 0):
            tails = "\n".join(
                f"--- rank {q}:\n" + open(os.path.join(
                    work, f"rank_{q}.log")).read()[-2500:]
                for q in range(len(procs)))
            fail(f"{phase}: rank {r} exited {p.returncode} (killed after "
                 f"{MESH_CHILD_S} s where negative):\n{tails}")


def sharded_launches(la: dict, warm: dict, picks, steps: int,
                     graphed: bool, phase: str) -> None:
    """A rank's launches of an agent-sharded run of ``steps`` days,
    exactly: each per-day kernel once a day, the sharded ledger's two
    entries once a day, the sharded prefix's emit once a day alone
    (cum_cat) and once a fold's first pick with its count and picks
    (n_new every day, n_d and n_f on tracing days; in the plain step,
    alone), its row totals before each emit, the reduce-and-pick once a
    T2 or T4 pick; the graph warm-ups' launches beside them; no launch of
    the unsharded ledger or prefix."""
    from reina_tpu_torch.core import daygraph
    folds = daygraph.fold_launches(picks, sharded=True)
    made = folds["concat_prefix_sharded.pick"] if graphed else 0
    counted = 2 * steps + sum(1 for r in picks if r[0] >= 0) \
        + sum(1 for r in picks if r[3] >= 0) - made
    want = ({k: steps for k in DAILY if k != "ledger_scan"}
            | {k: 2 * steps for k in TWICE}
            | {"ledger_sharded.fold": steps, "ledger_sharded.emit": steps,
               "concat_prefix_sharded.emit": counted,
               "concat_prefix_sharded.pick": made,
               "daygraph.max_pick": (folds["daygraph.max_pick"]
                                     if graphed else 0),
               "ledger_scan": 0, "fused_concat_prefix": 0,
               "fused_concat_prefix.pick": 0, "fused_onehot_sum": 1})
    for k, n in want.items():
        n += warm.get(k, 0)
        if la.get(k, 0) != n:
            fail(f"{phase}: launched {k} {la.get(k, 0)} times, want {n}")
    tot = la["concat_prefix_sharded.emit"] + la["concat_prefix_sharded.pick"]
    if la["concat_prefix_sharded.totals"] != tot:
        fail(f"{phase}: {la['concat_prefix_sharded.totals']} row totals "
             f"launches for {tot} emits")
    check_launched(la, {"prng.draw": DRAWS_A_DAY * steps}, phase)


def mesh_phase(run, out, state, ens, ens_ms_day: float, world: int = 2,
               one: dict = None) -> dict:
    """``world`` ranks on the card(s): the agent axis against the main
    path (``out``, ``state``: its rows and final state for the phase's
    days), the seed axis against the ensemble phase. ``one``: the
    one-card graphed and plain ms/day and the host's picks of those
    days. Returns rank 0's launches of its last agent-sharded run."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    days = len(out.r)
    steps = days - 1
    layout = (f"one rank a card, cuda:0-{world - 1}" if backend == "nccl"
              else f"all {world} ranks on cuda:0")
    print(f"mesh: {world} ranks over {backend}, {layout}, {steps} days")
    if backend == "gloo":
        print("mesh: the graphed agent axis captures its collectives, "
              "which NCCL runs and gloo cannot; NCCL refuses two ranks on "
              "one GPU, so it needs a card a rank (python3 chip_smoke.py "
              "--mesh K on K cards): here the plain day step")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    labels = ("plain", "graphed", "again") if backend == "nccl" \
        else ("plain",)
    with tempfile.TemporaryDirectory(dir=here) as work:
        procs = spawn_ranks(["--mesh-child"], world, lambda r: [
            str(r), str(world), str(port), backend, work, str(days)],
            work, here)
        wait_ranks(procs, work, "mesh")
        recs, down = [], []
        for r in range(world):
            with open(os.path.join(work, f"rank_{r}.json")) as f:
                recs.append(json.load(f))
            with open(os.path.join(work, f"down_{r}.txt")) as f:
                down.append(float(f.read()))
        print(f"mesh: every rank destroyed its process groups "
              f"(destroy_process_group, {backend}) after its runs, in at "
              f"most {max(down):.3f} s")
        host = None if one is None else one["picks"]
        for label in labels:
            slabs = []
            for r, rec in enumerate(recs):
                z = np.load(os.path.join(work, f"{label}_{r}.npz"))
                for name in out._fields:
                    if not np.array_equal(z["out__" + name],
                                          getattr(out, name)):
                        fail(f"mesh (a) {label}: rank {r}'s {name} differs "
                             f"from the main path's rows 0-{steps}")
                slabs.append(z)
                x = rec[label]
                la, st, sp = x["launches"], x["stats"], x["step"]
                sharded_launches(la, x["warmups"], x["picks"], steps,
                                 label != "plain", f"mesh (a) {label} rank "
                                 f"{r}")
                if label != "plain":
                    if x["picks"] != recs[0][label]["picks"]:
                        fail(f"mesh (a) {label}: rank {r}'s picks differ "
                             "from rank 0's")
                    if host is not None and x["picks"] != host:
                        fail(f"mesh (a) {label}: rank {r}'s picks differ "
                             "from the host's")
                    if sp.get("reads", 0) or sp.get("launches") != steps \
                            or st["staged_calls"]:
                        fail(f"mesh (a) {label}: rank {r} read the host "
                             f"{sp.get('reads', 0)} times, launched "
                             f"{sp.get('launches')} day graphs in {steps} "
                             f"days, staged {st['staged_calls']} "
                             "collectives")
                ms = x["s"] / steps * 1000
                ref = "" if one is None else (
                    f"; one card on cuda:0 in this call: graphed "
                    f"{one['graphed_ms']:.2f}, plain {one['plain_ms']:.2f}"
                    f" ms/day")
                print(f"mesh (a) agent axis {label}, rank {r} on "
                      f"{rec['device']}: {steps} days in {x['s']:.3f} s, "
                      f"{ms:.2f} ms/day{ref}; collectives "
                      f"{st['calls'] / steps:.1f}/day, "
                      f"{st['bytes'] / steps / 1e6:.3f} MB/day (staged "
                      f"through the host: {st['staged_calls']}); host reads "
                      f"{sp.get('reads', 0) / steps:.2f}/day, day-graph "
                      f"launches {sp.get('launches', 0) / steps:.2f}/day, "
                      f"spans captured {sp.get('captures', 0)}, peak device "
                      f"memory {x['peak'] / 2**30:.2f} GiB; launches={la}")
            for name in state._fields:
                whole = np.concatenate([z["st__" + name] for z in slabs])
                if not np.array_equal(whole,
                                      getattr(state, name).cpu().numpy()):
                    fail(f"mesh (a) {label}: gathered state.{name} differs "
                         f"from the unsharded {days}-day run")
            print(f"mesh (a) {label}: rows 0-{steps} equal the main path's "
                  f"and the gathered final state equals the unsharded "
                  f"run's, field by field"
                  + ("" if label == "plain" or host is None else
                     f"; every rank's picks equal rank 0's and the host's "
                     f"on all {steps} days"))
        if backend == "nccl":
            plain = max(rec["plain"]["s"] for rec in recs) / steps * 1000
            again = max(rec["again"]["s"] for rec in recs) / steps * 1000
            print(f"mesh (a) over NCCL, {world} ranks: graphed "
                  f"{again:.2f} ms/day a rank against the plain sharded "
                  f"step's {plain:.2f} ({plain / again:.1f}x)")
        if "profile" in recs[0]:
            from reina_tpu_torch.agent_axis import PROFILE_DAYS, PROFILE_START
            p = recs[0]["profile"]
            print(f"mesh (a) profile, rank 0 of {world} on cuda:0, graphed "
                  f"days {PROFILE_START}-{PROFILE_START + PROFILE_DAYS - 1}"
                  f" under torch.profiler: wall {p['wall_ms']:.3f} ms/day "
                  f"without it, device busy {p['busy_ms']:.3f} ms/day, idle "
                  f"share {p['idle']:.3f}, {p['events']:.1f} device events "
                  f"a day; NCCL kernels {p['nccl_ms']:.3f} ms/day "
                  f"({p['nccl_n']:.1f}/day), sharded ledger "
                  f"{p['ledger_ms']:.3f} ms/day ({p['ledger_n']:.1f}/day), "
                  f"sharded prefix {p['prefix_ms']:.3f} ms/day "
                  f"({p['prefix_n']:.1f}/day)")
        for label, what in (("ensemble", f"(b) seed axis, make_mesh("
                                          f"{world}, 1)"),
                            ("both", "(c) make_mesh(2, 2), agent groups "
                                     "cuda:0-1 and cuda:2-3")):
            if label not in recs[0]:
                continue
            z = np.load(os.path.join(work, f"{label}.npz"))
            for name in ens._fields:
                if not np.array_equal(z[name], getattr(ens, name)[
                        :, :MESH_DAYS - 1]):
                    fail(f"mesh {what}: member {name} differs from the "
                         f"ensemble phase's rows 1-{MESH_DAYS - 1}")
            xs = [rec[label] for rec in recs]
            wall = max(x["s"] for x in xs)
            per_rank = ", ".join(
                f"rank {r}: {x['members']} members in {x['s']:.3f} s, peak "
                f"{x['peak'] / 2**30:.2f} GiB" for r, x in enumerate(xs))
            extra = ""
            if label == "both":
                for r, x in enumerate(xs):
                    sp = x["step"]
                    if sp.get("reads", 0) or \
                            sp.get("launches") != sp.get("days"):
                        fail(f"mesh {what}: rank {r} read the host "
                             f"{sp.get('reads', 0)} times and launched "
                             f"{sp.get('launches')} day graphs in "
                             f"{sp.get('days')} days")
                    if x["picks"] != xs[r ^ 1]["picks"]:
                        fail(f"mesh {what}: rank {r}'s picks differ from "
                             f"rank {r ^ 1}'s")
                days = sum(x["step"]["days"] for x in xs)
                extra = (f"; every rank 1.00 day-graph launch and 0 host "
                         f"reads a day ({days} rank-days), picks equal "
                         f"within each agent group")
            print(f"mesh {what}: seeds {MESH_SEEDS} x {MESH_DAYS - 1} days "
                  f"in {wall:.3f} s, {len(MESH_SEEDS) / wall * 3600:.1f} "
                  f"seeds/h ({per_rank}), "
                  f"{wall / (len(MESH_SEEDS) * (MESH_DAYS - 1)) * 1000:.2f} "
                  f"ms per member-day (the ensemble phase, one card: "
                  f"{ens_ms_day:.2f}); members equal the ensemble phase's "
                  f"rows 1-{MESH_DAYS - 1}{extra}")
    print(f"mesh: {world} ranks, {time.perf_counter() - t_phase:.1f} s")
    return recs[0][labels[-1]]["launches"]


def cli_phase() -> None:
    """Two CLI runs in this process; the second hits the build cache."""
    import numpy as np
    from reina_tpu_torch import cli, kernels
    from reina_tpu_torch.core.step import STATS
    from reina_tpu_torch.simulation import BUILD_CACHE, simulate_individuals

    results = []
    for seed, want in ((1, "built"), (2, "reseeded")):
        hits, reseeds = STATS["build.hits"], STATS["build.reseeds"]
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["simulate", "--days", str(CLI_DAYS), "--seed",
                       str(seed), "--quiet"])
        wall = time.perf_counter() - t0
        launches = kernels.launches()
        outcome, build_s = BUILD_CACHE.last
        print(f"cli seed {seed}: exit {rc}, {wall:.3f} s, build "
              f"{build_s:.3f} s ({outcome}); launches={launches}")
        if rc != 0:
            fail(f"cli seed {seed}: exit code {rc}")
        if outcome != want:
            fail(f"cli seed {seed}: build {outcome}, want {want}")
        if want == "reseeded" and (STATS["build.hits"] != hits + 1
                                   or STATS["build.reseeds"] != reseeds + 1):
            fail("cli: the second call did not hit the cache and reseed")
        steps = CLI_DAYS - 1
        check_launched(launches, day_launches(steps, 1), "cli")
        # the memoized result of the run the CLI just made
        cols, cube = simulate_individuals(only_if_in_cache=True,
                                          device="cuda")
        if len(cols["date"]) != CLI_DAYS or cube.values.shape[0] != CLI_DAYS:
            fail(f"cli seed {seed}: {len(cols['date'])} rows")
        if not (cols["susceptible"] + cols["all_infected"]
                == HUS_AGENTS).all():
            fail(f"cli seed {seed}: agents not conserved")
        results.append(cols)
    if all(np.array_equal(results[0][k], results[1][k])
           for k in ("all_infected", "exposed_per_day")):
        fail("cli: seeds 1 and 2 gave the same run")


class Client:
    """One web-UI client of the port's GraphQL server: JSON over HTTP
    with the session cookie carried from answer to answer."""

    def __init__(self, base: str):
        self.base, self.cookie = base, None

    def post(self, doc: str, variables=None) -> dict:
        import urllib.request
        headers = {"Content-Type": "application/json"}
        if self.cookie:
            headers["Cookie"] = self.cookie
        req = urllib.request.Request(
            self.base + "/graphql", headers=headers,
            data=json.dumps({"query": doc, "variables": variables}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            self.cookie = resp.headers.get("Set-Cookie", "").split(";")[0]
            out = json.loads(resp.read())
        if out.get("errors"):
            fail(f"serve: {doc.split()[0:3]}: {out['errors']}")
        return out["data"]


def served_run(client: Client, name: str, seed_arg: str, want: str,
               first_poll: float = POLL_S):
    """Start a run as the web UI does and poll it every ``first_poll``
    until its first partial result, then every POLL_S until it has
    finished; returns (run id, final results, the graph runner's
    counters of the run, (seconds to its first partial result, its build
    seconds))."""
    from reina_tpu_torch import kernels
    from reina_tpu_torch.core import step

    kernels.reset_launches()
    step.reset_stats()
    t0 = time.perf_counter()
    run_id = client.post(f"mutation {{ runSimulation{seed_arg} "
                         "{ runId } }")["runSimulation"]["runId"]
    t_running = t_partial = None
    lengths = []
    deadline = t0 + 900
    while True:
        res = client.post(WEBUI_POLL, {"id": run_id})["simulationResults"]
        now = time.perf_counter() - t0
        n = len(res["predictedMetrics"]["dates"])
        lengths.append(n)
        if t_running is None and res["phase"] in ("running", "finished"):
            t_running = now
        if t_partial is None and n > 0:
            t_partial = now
        if res["finished"]:
            break
        if time.perf_counter() > deadline:
            fail(f"serve: run {name} did not finish in 900 s")
        time.sleep(first_poll if t_partial is None else POLL_S)
    t_done = time.perf_counter() - t0
    launches = kernels.launches()
    st = dict(step.STATS)
    outcome, build_s = served_build(st)
    print(f"serve run {name}: build {outcome} {build_s:.3f} s (host "
          f"compile {st.get('build.compile_s', 0.0):.3f} s, upload "
          f"{st.get('build.upload_s', 0.0):.3f} s); "
          f"phase running at {t_running:.3f} s, first partial at "
          f"{t_partial:.3f} s (polled every {first_poll} s until then), "
          f"finished at {t_done:.3f} s (polled every {POLL_S} s), "
          f"{t_done / (DAYS - 1) * 1000:.2f} ms/day; "
          f"{st.get('captures', 0)} spans and {st.get('day_graphs', 0)} day "
          f"graphs built; {len(set(lengths))} distinct date counts over "
          f"{len(lengths)} polls; launches={launches}")
    if outcome != want:
        fail(f"serve run {name}: build {outcome}, want {want}")
    if lengths != sorted(lengths) or len(set(lengths)) < 3:
        fail(f"serve run {name}: partial results did not grow: {lengths}")
    if lengths[-1] != DAYS or res["phase"] != "finished":
        fail(f"serve run {name}: {lengths[-1]} dates, phase {res['phase']}")
    steps = DAYS - 1
    check_launched(launches, day_launches(steps, 1), f"serve {name}")
    metrics = {m["type"]: m for m in res["predictedMetrics"]["metrics"]}
    return run_id, metrics, st, (t_partial, build_s)


def served_build(st: dict):
    """A served run's build as its worker's build cache counted it in
    ``st`` (step.STATS since the run began): its outcome and the seconds
    of its host compile and upload."""
    outcome = ("built" if st.get("build.misses") else
               "reseeded" if st.get("build.reseeds") else
               "cached" if st.get("build.hits") else "")
    return outcome, (st.get("build.compile_s", 0.0)
                     + st.get("build.upload_s", 0.0))


def poll(client: Client, run_id: str) -> dict:
    return client.post(WEBUI_POLL, {"id": run_id})["simulationResults"]


def warm_hit_run(base: str) -> None:
    """A fresh session's run of the default variables, which the
    warm-up's build must serve: timed to its first partial result, then
    cancelled, as the registry cancels a run its client left (the
    default session runs 565 days)."""
    from reina_tpu_torch import kernels
    from reina_tpu_torch.core import step
    from reina_tpu_torch.runtime import runner

    client = Client(base)
    kernels.reset_launches()
    before = dict(step.STATS)
    t0 = time.perf_counter()
    run_id = client.post("mutation { runSimulation { runId } }"
                         )["runSimulation"]["runId"]
    t_running = None
    while True:
        res = poll(client, run_id)
        now = time.perf_counter() - t0
        if t_running is None and res["phase"] in ("running", "finished"):
            t_running = now
        if res["predictedMetrics"]["dates"]:
            break
        if res["finished"]:
            fail("serve run W: finished with no partial result")
        if now > 300:
            fail("serve run W: no partial result in 300 s")
        time.sleep(POLL_S)
    outcome, build_s = served_build({k: v - before.get(k, 0)
                                     for k, v in step.STATS.items()})
    runner.REGISTRY.reap(run_id)
    while not res["finished"]:
        if time.perf_counter() - t0 > 600:
            fail("serve run W: the cancelled run did not stop")
        time.sleep(POLL_S)
        res = poll(client, run_id)
    launches = kernels.launches()
    print(f"serve run W (default session, warm-up hit): build {outcome} "
          f"{build_s:.3f} s; phase running at {t_running:.3f} s, first "
          f"partial at {now:.3f} s (polled every {POLL_S} s); cancelled "
          f"after {len(res['predictedMetrics']['dates'])} dates; "
          f"launches={launches}")
    if outcome != "cached":
        fail(f"serve run W: build {outcome}, want cached (the warm-up's)")
    check_launched(launches, {k: 1 for k in DAILY + TWICE + (
        PREFIX, "fused_onehot_sum", "prng.draw")}, "serve W")


def concurrent_runs(base: str) -> None:
    """Time to a result as the worker threads share the card: CLI_DAYS-day
    runs, each from a session of its own, one alone, then 2, 4, 8 and 16
    at once (16: the runner's MAX_CONCURRENT_RUNS), each run on a graph
    set of its own; the peak device memory of each group."""
    import torch
    from reina_tpu_torch import kernels

    groups = (1, 2, 4, 8, 16)
    clients = [Client(base) for _ in range(max(groups))]
    for c in clients:
        c.post(f"mutation {{ setSimulationDays(days: {CLI_DAYS}) "
               "{ ok } }")
    steps = CLI_DAYS - 1
    seed = 3
    for size in groups:
        seeds = list(range(seed, seed + size))
        seed += size
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runs = {s: (c, c.post(
            f"mutation {{ runSimulation(randomSeed: {s}) {{ runId }} }}"
        )["runSimulation"]["runId"]) for s, c in zip(seeds, clients)}
        done = {}
        while len(done) < len(runs):
            if time.perf_counter() - t0 > 300:
                fail(f"serve {size} at once: not finished in 300 s")
            time.sleep(POLL_S)
            for s, (c, run_id) in runs.items():
                if s in done:
                    continue
                res = poll(c, run_id)
                if res["finished"]:
                    done[s] = (time.perf_counter() - t0, res)
        peak = torch.cuda.max_memory_allocated()
        launches = kernels.launches()
        finals, times = set(), []
        for s in seeds:
            t_done, res = done[s]
            times.append(t_done)
            m = {x["type"]: x["intValues"]
                 for x in res["predictedMetrics"]["metrics"]}
            if len(res["predictedMetrics"]["dates"]) != CLI_DAYS:
                fail(f"serve seed {s}: "
                     f"{len(res['predictedMetrics']['dates'])} dates")
            if any(a + i != HUS_AGENTS for a, i in
                   zip(m["susceptible"], m["all_infected"])):
                fail(f"serve seed {s}: agents not conserved")
            finals.add(tuple(m["all_infected"]))
        times.sort()
        print(f"serve {CLI_DAYS}-day runs, {size} at once: finished at "
              f"{times[0]:.3f} / {times[len(times) // 2]:.3f} / "
              f"{times[-1]:.3f} s (first / median / last, polled every "
              f"{POLL_S} s); peak device memory {peak / 2**30:.2f} GiB")
        check_runs_launched(launches, size * steps, size,
                            f"serve {size} at once")
        if len(finals) != size:
            fail(f"serve {size} at once: {size - len(finals)} runs gave "
                 "another run's curve")


def build_split(a_times) -> None:
    """Run A's first partials and builds (each a build-cache miss, its
    host compile and upload printed with the run): their medians and the
    build's share."""
    import numpy as np

    partial, build = (np.array(x) for x in zip(*a_times))
    print(f"serve run A x{len(a_times)}: first partial "
          f"{[round(float(x), 3) for x in partial]} s, median "
          f"{np.median(partial):.3f} s; build "
          f"{[round(float(x), 3) for x in build]} s, median "
          f"{np.median(build):.3f} s, the build "
          f"{np.median(build / partial) * 100:.1f}% of the first partial "
          f"(median); the rest {np.median(partial - build):.3f} s")


def serving_phase(main_all_infected, main_susceptible) -> None:
    """The serving path on the card: warm-up through the build cache,
    two runs through the GraphQL server, the export and the explorer."""
    import io
    import urllib.request
    import zipfile

    import numpy as np
    from reina_tpu_torch.config.variables import VariableStore
    from reina_tpu_torch.runtime import cache
    from reina_tpu_torch.runtime.graphql.server import (
        serve, warmup_serving_program)
    from reina_tpu_torch.sampling import sample_distribution
    from reina_tpu_torch.simulation import BUILD_CACHE, simulate_individuals
    from reina_tpu_torch.utils import memoize
    from reina_tpu_torch.utils.memoize import resolved_variables

    t0 = time.perf_counter()
    warmup_serving_program("cuda")
    warm_s = time.perf_counter() - t0
    BUILD_CACHE.get(resolved_variables(simulate_individuals, {}), "cuda")
    print(f"serve: warm-up {warm_s:.3f} s; the default session's run is "
          f"then {BUILD_CACHE.last[0]} in the build cache")
    if BUILD_CACHE.last[0] != "cached":
        fail("serve: the warm-up left no default-session run in the "
             "build cache")

    cache.init_backend("memory")
    httpd = serve(host="127.0.0.1", port=0, background=True, warmup=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        warm_hit_run(base)
        client = Client(base)
        client.post(f"mutation {{ setSimulationDays(days: {DAYS}) {{ ok }} }}")

        a_times = []
        for k in range(RUN_A_TIMES):
            if k:
                # the next run A misses the result, memo and build caches
                cache.init_backend("memory")
                memoize.clear_cache()
                with BUILD_CACHE._lock:
                    BUILD_CACHE._runs.clear()
            run_a, a, st, times = served_run(client, "A", "", "built",
                                             FINE_POLL_S)
            a_times.append(times)
            if st.get("captures", 0) or st.get("day_graphs", 0):
                fail("serve run A: a build of the warm-up's key built spans "
                     "or day graphs")
            for name, want in (("all_infected", main_all_infected),
                               ("susceptible", main_susceptible)):
                if a[name]["intValues"] != [int(x) for x in want]:
                    fail(f"serve run A: {name} differs from the main path")
        print("serve run A: all_infected and susceptible equal the main "
              f"path's day by day in all {RUN_A_TIMES} runs")
        build_split(a_times)
        with urllib.request.urlopen(f"{base}/export.xlsx?run={run_a}",
                                    timeout=120) as resp:
            sheet = zipfile.ZipFile(io.BytesIO(resp.read())).read(
                "xl/worksheets/sheet1.xml")
        if sheet.count(b"<row>") != DAYS + 1:
            fail(f"serve: the export has {sheet.count(b'<row>')} rows")

        _, b, _, _ = served_run(client, "B", "(randomSeed: 1)", "reseeded")
        final_b = b["all_infected"]["intValues"][-1]
        lo, hi = MC_MEAN - 4 * MC_STD, MC_MEAN + 4 * MC_STD
        print(f"serve run B: final all_infected {final_b}")
        if not lo <= final_b <= hi:
            fail(f"serve run B: final all_infected {final_b} outside "
                 f"[{lo:.0f}, {hi:.0f}]")
        if b["all_infected"]["intValues"] == a["all_infected"]["intValues"]:
            fail("serve: runs A and B gave the same curve")

        doc = ('{ sampleDistribution(what: "%s", age: 80) '
               '{ categories counts } }')
        variables = VariableStore({"simulation_days": DAYS}).copy_all()
        variables["sample_limit_mobility"] = 0
        for what in ("symptom_severity", "incubation_period"):
            t0 = time.perf_counter()
            d = client.post(doc % what)["sampleDistribution"]
            ms = (time.perf_counter() - t0) * 1000
            print(f"serve explorer {what}: {ms:.1f} ms, "
                  f"{len(d['categories'])} categories, first "
                  f"{dict(zip(d['categories'][:5], d['counts'][:5]))}")
            if sum(d["counts"]) != 10000:
                fail(f"serve explorer {what}: {sum(d['counts'])} draws")
        cats, counts = sample_distribution("symptom_severity", 80, None,
                                           variables, "cpu")
        sev = client.post(doc % "symptom_severity")["sampleDistribution"]
        if (sev["categories"] != [str(c) for c in cats]
                or sev["counts"] != [float(c) for c in counts]):
            fail("serve explorer: severity counts on the card differ from "
                 "the CPU's")
        print("serve explorer: severity counts equal the CPU's")
        if not np.isfinite(a["r"]["floatValues"][-1]):
            fail("serve run A: non-finite r")
        concurrent_runs(base)
    finally:
        httpd.shutdown()
        httpd.server_close()


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from reina_tpu_torch import kernels
    from reina_tpu_torch.kernels import build, checks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"device: {kind}; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi[0] if smi else 'unavailable'}")

    t0 = time.perf_counter()
    build.lib()
    print(f"cuda kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds} s)")

    # ---- kernels against their twins at HUS shapes
    results = {}
    hold(checks.checks(checks.HUS_N, 0, "cuda"), results)
    print("per-launch ms (cold L2, median of 7): "
          + json.dumps(checks.launch_times(checks.HUS_N, 0, "cuda")))

    # ---- the main path
    from reina_tpu_torch.config.variables import VARIABLE_DEFAULTS
    from reina_tpu_torch.core.engine import run_days, build_run
    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = DAYS
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    run = build_run(v, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    run_bytes = torch.cuda.memory_allocated() - mem0
    n_pad = run.init_state.age.shape[0]
    print(f"build_run: {build_s:.2f} s, agents={run.n_agents}, "
          f"padded={n_pad}")
    if run.n_agents != HUS_AGENTS:
        fail(f"expected {HUS_AGENTS} agents, got {run.n_agents}")

    # ---- the draw kernels, binomial_fixed on day CAPTURE_DAY's inputs
    t0 = time.perf_counter()
    captured = checks.capture_samplers(run, CAPTURE_DAY)
    torch.cuda.synchronize()
    print(f"day {CAPTURE_DAY}'s sampler inputs in "
          f"{time.perf_counter() - t0:.2f} s: binomial_fixed lanes "
          f"{[int(n.numel()) for n, _ in captured['binomial']]}, "
          f"gamma_fixed_pair (kappa1, kappa2, shape) {captured['gamma']}; "
          f"clock for the "
          f"INT32 bound {checks.sm_clock_hz() / 1e6:.0f} MHz")
    hold(checks.draw_checks(0, "cuda", captured), results)
    del captured
    hold(checks.fold_checks(checks.HUS_N, 0, "cuda"), results)

    from reina_tpu_torch.core import step
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step.reset_stats()
    t0 = time.perf_counter()
    dev_picks = []
    out, state, carry, chunk_times = run_days(run, chunk_days=52,
                                              picks=dev_picks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    warm = kernels.warmups()
    peak = torch.cuda.max_memory_allocated()
    graph_stats = dict(step.STATS)
    steps = DAYS - 1
    final = int(out.by_group[-1, 3].sum())
    print(f"run_days: {wall:.3f} s for {steps} days "
          f"({wall / steps * 1000:.2f} ms/day, "
          f"{run.n_agents * steps / wall:.1f} agent-days/s), "
          f"peak device memory {peak / 2**30:.2f} GiB")
    print(f"final all_infected={final}; launches={launches}, of them "
          f"{sum(warm.values())} in the graph warm-ups: {warm}")

    # ---- outcome checks
    G = len(run.group_labels)
    if out.by_group.shape != (DAYS, 13, G):
        fail(f"by_group shape {out.by_group.shape}")
    for name in out._fields:
        a = getattr(out, name)
        if len(a) != DAYS:
            fail(f"{name}: {len(a)} rows")
        if a.dtype.kind == "f" and not (a == a).all():
            fail(f"{name}: non-finite values")
    cons = out.by_group[:, 0].sum(1) + out.by_group[:, 3].sum(1)
    if not (cons == run.n_agents).all():
        fail("agents not conserved (susceptible + all_infected)")
    check_runs_launched(launches, steps, 1, "main path")
    check_picks_launched(launches, dev_picks, "main path")
    lo, hi = MC_MEAN - 4 * MC_STD, MC_MEAN + 4 * MC_STD
    if not lo <= final <= hi:
        fail(f"final all_infected {final} outside [{lo:.0f}, {hi:.0f}]")

    graphs_phase(run, out, state, carry, wall, graph_stats, peak,
                 dev_picks)
    reuse_phase()
    with tempfile.TemporaryDirectory(dir=here) as scratch:
        resume_phase(run, out, state, scratch)
    ens, ens_ms_day = ensemble_phase(run, v, out, peak - mem0, run_bytes)
    sharded = mesh_kernels(results)
    _, st_mesh, _, _ = run_days(run, n_days=MESH_DAYS, chunk_days=MESH_DAYS)
    mesh_launches = mesh_phase(
        run, type(out)(*(x[:MESH_DAYS] for x in out)), st_mesh, ens,
        ens_ms_day)
    del st_mesh
    main_all_infected = out.by_group[:, 3].sum(1)
    main_susceptible = out.by_group[:, 0].sum(1)
    del run, out, state, carry
    vs_phase()
    turku_phase()
    cli_phase()
    serving_phase(main_all_infected, main_susceptible)

    print(f"smoke: {time.perf_counter() - t_start:.1f} s in all")
    # the sharded forms: launches of rank 0's agent-sharded run (the
    # plain step over gloo: the prefix's emit alone, no count and picks),
    # times of their two slabs in turn
    rows = ([(c, r, launches[c.name]) for c, r in results.values()]
            + [(c, r, mesh_launches[c.name + ".emit"])
               for c, r in sharded.values()
               if c.name + ".emit" in mesh_launches])
    print(json.dumps({"kernels": [
        {"name": c.name, "route": c.route, "source": c.source,
         "replaces": c.replaces, "launches": n,
         "max_abs_err": r.max_abs_err, "ms": r.ms, "plain_ms": r.plain_ms,
         "bound_ms": r.bound_ms, "bound_by": r.bound_by,
         "library_ms": r.library_ms}
        for c, r, n in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def mesh_only(k: int) -> None:
    """Step 7's ranks alone, for 2 and k ranks (over NCCL, a rank a
    card, the agent axis graphed: the 365-day HUS run): first the main
    path on one card, graphed (building its graph set, then again on
    it) and with the plain day step (its host picks), and seeds 0-2 of
    the ensemble, which the ranks are held to."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from reina_tpu_torch.config.variables import VARIABLE_DEFAULTS
    from reina_tpu_torch.core.engine import build_run, run_days
    from reina_tpu_torch.ensemble import run_ensemble
    from reina_tpu_torch.kernels import build

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"device: {kind} x {torch.cuda.device_count()}; torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    build.lib()
    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = DAYS
    run = build_run(v, "cuda")
    steps = DAYS - 1
    dev_picks, host_picks = [], []
    out, state, _, _ = run_days(run, picks=dev_picks)
    one = {}
    for label, kw in (("graphed", {}), ("plain", {"graphs": False,
                                                   "picks": host_picks})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o, st, _, _ = run_days(run, **kw)
        torch.cuda.synchronize()
        one[label + "_ms"] = (time.perf_counter() - t0) / steps * 1000
        for name in out._fields:
            if not np.array_equal(getattr(o, name), getattr(out, name)):
                fail(f"one card {label}: {name} differs from the first "
                     "graphed run")
        del o, st
    one["picks"] = np.asarray(host_picks).tolist()
    if np.asarray(dev_picks).tolist() != one["picks"]:
        fail("one card: the graphed run's picks differ from the host's")
    final = int(out.by_group[-1, 3].sum())
    print(f"one card, {steps} days: graphed {one['graphed_ms']:.2f} ms/day "
          f"(again, on its graph set), plain {one['plain_ms']:.2f} ms/day; "
          f"final all_infected {final}; device picks equal the host's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = run_ensemble(run, MESH_SEEDS, n_days=MESH_DAYS)
    torch.cuda.synchronize()
    ms = ((time.perf_counter() - t0)
          / (len(MESH_SEEDS) * (MESH_DAYS - 1)) * 1000)
    print(f"ensemble on one rank: {ms:.2f} ms per member-day")
    for world in sorted({2, k}):
        mesh_phase(run, out, state, ens, ms, world, one)
    if torch.cuda.device_count() >= 2:
        lost_rank_phase()
    print("mesh: ok")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        a = sys.argv[2:]
        mesh_child(int(a[0]), int(a[1]), int(a[2]), a[3], a[4], int(a[5]))
    elif sys.argv[1:2] == ["--lost-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        a = sys.argv[2:]
        lost_child(int(a[0]), int(a[1]), a[2], a[3])
    elif sys.argv[1:2] == ["--mesh"]:
        mesh_only(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--lost"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from reina_tpu_torch.kernels import build
        build.lib()
        lost_rank_phase()
    else:
        main()
