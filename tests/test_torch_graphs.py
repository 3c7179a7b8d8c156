"""The day program, the pick kernel's twin and the graph runner
(core/step.py, core/daygraph.py, core/graphs.py) on the CPU.

On a card a day is one launch of a CUDA graph whose spans are captured
torch graphs and whose tier picks are a kernel that sets the conditional
node after it; the host reads nothing between sync points. On the CPU a
GraphSet is its model: the same static buffers, day tables, device day
counter, picks table and branch tallies, each (span, key) recorded at
its warm-up and called again on later days, each pick the pick kernel's
twin, whose entry in the picks table names the branch that runs. A span
that read a day-varying value from anywhere but those buffers would give
a wrong day when a recording from another day runs, as a graph would.

Setting: the synthetic run with tests/test_torch_step.py's calendar
(testing, imports, weekly imports, mobility limits, masks, contact
tracing from day 16, vaccination, capacity builds), 20,000 agents, 21
stepped days. Checks, all exact (bit for bit):
  * (a) the graph model stepped day by day equals the plain day step on
    every field of the state, the carry and the outputs, every day, and
    reads nothing on the host;
  * (b) the same GraphSet restarted at day 15 captures nothing, runs
    every span of days 15-20 from recordings made at the first start,
    and equals them again;
  * (c) the model's picks table equals the plain step's host picks day by
    day, and each tier it ran equals the one the JAX package's
    tier_bounds and searchsorted pick for the counts the day left in the
    handoff buffers;
  * (d) the packed fetch equals the JAX package's ``_pack_leaves`` on the
    same outputs, and run_days syncing every chunk (with a callback)
    gives the same outputs as syncing once at the end;
  * (e) the pick twin against the JAX package's searchsorted with the
    switch's clamp at the edges of both tier families, with the overflow
    bits; the overflow bits the model sets equal the plain step's on a
    config whose buffers overflow; a day graph without a branch raises;
  * (f) a build of the same shapes with other values takes the first
    build's idle set, builds nothing and equals its own plain step day
    by day; builds of another N or more days get sets of their own, and
    a set refuses them.
"""
import numpy as np
import pytest
import torch

from reina_tpu_torch import convert
from reina_tpu_torch.core import constants as C
from reina_tpu_torch.core import daygraph, graphs
from reina_tpu_torch.core import step as S
from reina_tpu_torch.core.engine import (fetch_packed, pack_leaves,
                                         run_days, sched_row)
from reina_tpu_torch.core.schedule import Schedules
from reina_tpu_torch.ops import prng
from reina_tpu_torch.testing import build_synthetic_run

IVS = [
    ["test-all-with-symptoms", "2020-02-20"],
    ["import-infections", "2020-02-20", 50],
    ["import-infections-weekly", "2020-02-25", 35],
    ["limit-mobility", "2020-03-01", 30],
    ["wear-masks", "2020-03-05", 50],
    ["test-with-contact-tracing", "2020-03-05", 60],
    ["vaccinate", "2020-03-01", 700, 60, None],
    ["build-new-icu-units", "2020-03-03", 5],
    ["build-new-hospital-beds", "2020-03-03", 20],
]
DAYS = 22           # 21 stepped days, 16-20 with contact tracing
RESTART = 15


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Thousands of tiny ops a day, which intra-op threads only slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Spy(graphs.GraphSet):
    """A CPU GraphSet that logs the spans it captures and runs, in
    order."""

    def __init__(self, *a):
        super().__init__(*a)
        self.log = []

    def entry(self, hkey, name, key):
        entry = super().entry(hkey, name, key)
        self.log.append(("run", name, key))
        return entry

    def capture(self, name, key, body):
        self.log.append(("capture", name, key))
        return super().capture(name, key, body)


# the counts the picks read, in the handoff buffers
COUNTS = ("ct_cases", "n_d", "fill_max", "n_f", "fill2_max", "n_new")


def _np(state, carry, out):
    rec = {}
    for pre, nt in (("state", state), ("carry", carry), ("out", out)):
        for k, v in convert.to_numpy(nt).items():
            rec[f"{pre}.{k}"] = v.copy()   # a CPU tensor's numpy is a view
    return rec


def _assert_day_equal(want, got, day):
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, (day, k)
        np.testing.assert_array_equal(want[k], got[k],
                                      err_msg=f"day {day}: {k}")


def _build(run):
    """What a graph set is made from and started with: a run's config,
    arrays, schedules, initial state and carry."""
    return (run.cfg, run.arrays, run.schedules, run.init_state,
            run.init_carry)


def _plain(run, days):
    """The plain day step, day by day: (per-day records, the state and
    carry before each day, the host's picks rows)."""
    cfg = run.cfg
    host = Schedules(*(x.numpy() for x in run.schedules))
    key = prng.PRNGKey(run.random_seed)
    state = run.init_state
    carry = run.init_carry._replace(bkt_dst=run.init_carry.bkt_dst.clone())
    recs, befores, picks = [], [], []
    for d in range(days):
        # the day step updates the bucket table in place
        befores.append((state, carry._replace(bkt_dst=carry.bkt_dst.clone())))
        dk = S.derive_day_keys(cfg, key, [d]).day(0)
        state, carry, out = S.day_step(cfg, run.arrays,
                                       sched_row(run.schedules, host, d),
                                       state, carry, dk, picks=picks)
        recs.append(_np(state, carry, out))
    return recs, befores, picks


def _model(gs, run, day0, state, carry, days):
    """The graph model from ``day0``, day by day: per-day records, logs,
    picks rows and counts, the start's log and the host reads."""
    host = Schedules(*(x.numpy() for x in run.schedules))
    key = prng.PRNGKey(run.random_seed)
    plans = gs.prepare(host, key, day0, days - day0, carry.weekly_leftover,
                       run.init_state.age.shape[0])
    gs.log = []
    gs.start(run.cfg, run.arrays, run.schedules, state, carry, day0, plans)
    res = dict(start_log=gs.log, days=[], logs=[], rows=[], counts=[])
    S.reset_stats()
    bits = 0
    for i, plan in enumerate(plans):
        gs.log = []
        gs.step([plan])
        bits |= plan.problem
        st, cr = gs.state_carry(day0 + i + 1, plan.leftover, bits,
                                clone=True)
        out = gs.outputs(day0 + i, day0 + i + 1, [plan])
        out = S.DayOutputs(*(x[0] for x in out))
        res["days"].append(_np(st, cr, out))
        res["logs"].append(gs.log)
        res["rows"].append(gs.picks[day0 + i].numpy().copy())
        res["counts"].append({k: gs.handoff[k].tolist() for k in COUNTS
                              if k in gs.handoff})
    res["reads"] = S.STATS["reads"]
    res["launches"] = S.STATS["launches"]
    return res


@pytest.fixture(scope="module")
def runs():
    """The plain day step and the graph model, day by day, and the model
    restarted at day RESTART."""
    run = build_synthetic_run("cpu", n_agents=20000, days=DAYS, seed=3,
                              interventions=IVS)
    ref, ref_states, ref_picks = _plain(run, DAYS - 1)
    gs = Spy(*_build(run), "cpu")
    first = _model(gs, run, 0, run.init_state, run.init_carry, DAYS - 1)
    again = _model(gs, run, RESTART, *ref_states[RESTART], DAYS - 1)
    return dict(run=run, ref=ref, ref_picks=ref_picks, first=first,
                again=again, gs=gs)


def test_graph_model_equals_day_step(runs):
    """(a) every field, every day; the calendar reaches every span; one
    launch and no host read a day."""
    first = runs["first"]
    for d, (want, got) in enumerate(zip(runs["ref"], first["days"])):
        _assert_day_equal(want, got, d)
    spans = {name for name, _ in runs["gs"].bodies}
    assert spans == {"AB", "A", "T1", "T2", "T3", "T4", "B", "C"}
    keys = {k for name, k in runs["gs"].bodies if name in ("AB", "B")}
    assert (True, True) in keys and (False, True) in keys  # vacc, imports
    assert first["reads"] == 0
    assert first["launches"] == len(first["days"])
    assert all(e[0] == "run" for log in first["logs"] for e in log)
    assert all(len(log) >= 2 for log in first["logs"])
    # every variant is captured at the start, before the first day runs
    captured = [e for e in first["start_log"] if e[0] == "capture"]
    assert len(captured) == len(runs["gs"].bodies)


def test_spans_replayed_from_other_days(runs):
    """(b) restarted at day RESTART, the set captures nothing and every
    span of every day runs a recording made at the first start; each day
    is equal again."""
    again = runs["again"]
    for i, (want, got) in enumerate(zip(runs["ref"][RESTART:],
                                        again["days"])):
        _assert_day_equal(want, got, RESTART + i)
    assert again["start_log"] == [] and again["reads"] == 0
    kinds = [e[0] for log in again["logs"] for e in log]
    assert kinds and set(kinds) == {"run"}
    traced = [log for log in again["logs"]
              if any(e[1] == "T4" for e in log)]
    assert len(traced) >= 3


def test_tiers_match_jax_tier_bounds(runs):
    """(c) the picks table equals the plain step's host picks day by
    day, and the ceiling of each span the model ran equals the JAX
    package's tier_bounds + searchsorted (lax.switch clamps to its last
    branch) on the count the day left for it."""
    import jax.numpy as jnp
    from reina_tpu.core.step import tier_bounds as jax_tier_bounds
    cfg = runs["run"].cfg
    Tcap = cfg.infection_buffer
    mem = (cfg.infection_head, Tcap)
    cols = (cfg.bucket_head, cfg.max_infectees)

    def jax_pick(head, cap, x):
        ends = [lo + seg for lo, seg in jax_tier_bounds(min(head, cap), cap)]
        i = int(jnp.searchsorted(jnp.asarray(ends, jnp.int32), x,
                                 side="left"))
        return ends[min(i, len(ends) - 1)]

    first = runs["first"]
    assert len(runs["ref_picks"]) == len(first["rows"])
    checked = set()
    for d, (row, want, cnt, log) in enumerate(zip(
            first["rows"], runs["ref_picks"], first["counts"],
            first["logs"])):
        np.testing.assert_array_equal(row, want, err_msg=f"day {d}")
        spans = {e[1]: e[2] for e in log}
        col = dict(zip(S.PICK_COLS, row))
        if col["T"] == 1:
            ct_cases, n_d = cnt["ct_cases"], cnt["n_d"]
            assert ct_cases > 0
            assert spans["T1"] == (jax_pick(*mem, min(n_d, Tcap)),)
            assert spans["T2"] == (spans["T1"][0],
                                   jax_pick(*cols, cnt["fill_max"]))
            assert spans["T3"] == (jax_pick(*mem, min(cnt["n_f"], Tcap)),)
            assert spans["T4"] == (spans["T3"][0],
                                   jax_pick(*cols, cnt["fill2_max"]))
            checked |= {"T1", "T2", "T3", "T4"}
        else:
            assert not {"T1", "T2", "T3", "T4"} & spans.keys()
            assert all(col[c] == -1 for c in ("T1", "T2", "T3", "T4"))
        assert spans["C"] == (jax_pick(cfg.infection_head, Tcap,
                                       min(cnt["n_new"], Tcap)),)
        checked.add("C")
    assert checked == {"T1", "T2", "T3", "T4", "C"}


def test_model_tallies_and_bits_match_host_picks(runs):
    """(c) the model makes each pick inside the launch of its count's
    producer (daygraph.FOLDS; there is no pick of its own): on untraced
    and tracing days, its branch tallies count the host's picks of both
    starts' days branch by branch, every fold's first pick was made on
    the days its producer ran, and the problem bits equal the plain
    step's every day."""
    gs = runs["gs"]
    rows = np.array(runs["first"]["rows"] + runs["again"]["rows"])
    traced = rows[:, S.PICK_COLS.index("T")] == 1
    assert traced.any() and (~traced).any()
    tally = gs.tally.numpy()
    for name, (col, slot, n) in gs.layout.items():
        picked = rows[:, col]
        np.testing.assert_array_equal(
            tally[slot:slot + n],
            np.bincount(picked[picked >= 0], minlength=n), err_msg=name)
    spans = [{e[1] for e in log} for log in runs["first"]["logs"]]
    made = daygraph.fold_launches(runs["first"]["rows"])
    assert made["fused_concat_prefix.pick"] == sum(
        ("AB" in s or "B" in s) + ("A" in s) + ("T2" in s) for s in spans)
    assert made["daygraph.max_pick"] == sum(
        ("T1" in s) + ("T3" in s) for s in spans)
    for d, (want, got) in enumerate(zip(runs["ref"], runs["first"]["days"])):
        assert want["carry.problem"] == got["carry.problem"], d


def test_packed_fetch_matches_jax_pack_leaves(runs):
    """(d) the packed int32 and float32 buffers of a stack of day outputs
    equal the JAX package's _pack_leaves on the same leaves, and the
    fetch unpacks them to the same outputs."""
    import jax.numpy as jnp
    from reina_tpu.core.engine import _pack_leaves
    days = runs["ref"][:5]
    outs = S.DayOutputs(*(np.stack([d["out." + f] for d in days])
                          for f in S.DayOutputs._fields))
    problem = np.int32(5)
    dev = S.DayOutputs(*(x if f == "mobility_limitation"
                         else torch.from_numpy(x)
                         for f, x in zip(S.DayOutputs._fields, outs)))
    is_int = [f != "mobility_limitation" and not np.issubdtype(
        x.dtype, np.floating) for f, x in zip(S.DayOutputs._fields, outs)]
    ints = [x for x, b in zip(dev, is_int) if b]
    flts = [x for f, x, b in zip(S.DayOutputs._fields, dev, is_int)
            if not b and f != "mobility_limitation"]
    pi, pf = pack_leaves(ints + [torch.tensor([problem])], flts)
    ji, jf = _pack_leaves([jnp.asarray(x.numpy()) for x in ints]
                          + [jnp.asarray([problem])],
                          [jnp.asarray(x.numpy()) for x in flts])
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    got, tail = fetch_packed(dev, torch.tensor([problem]))
    assert tail.tolist() == [5]
    for f, a, b in zip(S.DayOutputs._fields, outs, got):
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_sync_points_do_not_change_outputs():
    """(d) run_days with a callback (a sync after every chunk) and
    without one (one sync at the end), plain and graph model: the same
    outputs; the callback sees the rows grow chunk by chunk."""
    run = build_synthetic_run("cpu", n_agents=3000, days=5, seed=5,
                              interventions=IVS[:2])
    seen = []

    def cb(day, rows):
        seen.append((day, rows.by_group.shape[0]))
        return True

    base = run_days(run)[0]
    for kw in (dict(day_callback=cb, chunk_days=2),
               dict(graphs=True), dict(graphs=True, day_callback=cb,
                                       chunk_days=3)):
        out = run_days(run, **kw)[0]
        for f, a, b in zip(S.DayOutputs._fields, base, out):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert seen == [(2, 3), (4, 5), (3, 4), (4, 5)]


def _switches(cfg):
    """The conditional nodes of a tracing day's program, by name."""
    return {node.name: node for node in S.conditionals(
        S.day_program(cfg, True, False, False))}


def test_pick_twin_matches_jax_searchsorted():
    """(e) the pick twin (and the host's tier_branch) against the JAX
    package's tier_bounds + jnp.searchsorted with lax.switch's clamp, for
    the member/slot tiers (count clamped to the buffer, as
    jnp.minimum(n, Tcap)) and the column tiers, at 0, 1, head - 1, head,
    head + 1, every ceiling, cap, cap + 1 and 10^6; the overflow bit where
    the count exceeds the cap; the table row, the tally; the two-count
    pick's flat branch and the tracing cond."""
    import jax.numpy as jnp
    from reina_tpu.core.step import tier_bounds as jax_tier_bounds
    cfg = S.EngineConfig()
    sw = _switches(cfg)
    I32 = torch.int32

    def jax_index(head, cap, xs):
        ends = [lo + seg for lo, seg in jax_tier_bounds(min(head, cap), cap)]
        i = np.asarray(jnp.searchsorted(jnp.asarray(ends, jnp.int32),
                                        jnp.asarray(xs, jnp.int32),
                                        side="left"))
        return ends, np.minimum(i, len(ends) - 1)

    families = [("T1", 0, cfg.infection_head, cfg.infection_buffer, True),
                ("C", 0, cfg.infection_head, cfg.infection_buffer, True),
                ("T2", 1, cfg.bucket_head, cfg.max_infectees, False)]
    for name, k, head, cap, clamps in families:
        p = sw[name].picks[k]
        col = S.PICK_COLS.index(name)
        ends, _ = jax_index(head, cap, [0])
        xs = sorted({0, 1, head - 1, head, head + 1, *ends, cap, cap + 1,
                     10 ** 6})
        _, want = jax_index(head, cap, [min(x, cap) if clamps else x
                                        for x in xs])
        assert tuple(ends) == p.ends
        table = torch.full((len(xs), len(S.PICK_COLS)), -1, dtype=I32)
        tally = torch.zeros(len(ends), dtype=I32)
        for i, x in enumerate(xs):
            problem = torch.zeros((), dtype=I32)
            b = daygraph.pick_twin([torch.tensor(x, dtype=I32)], (p,), table,
                                   torch.tensor(i), col, tally, problem)
            assert int(b) == want[i] == S.tier_branch(p, x), (name, x)
            assert int(problem) == (p.bit if p.bit and x > cap else 0)
        assert table[:, col].tolist() == want.tolist()
        assert (table.sum() - table[:, col].sum()) == -len(xs) * 5
        assert tally.tolist() == np.bincount(want,
                                             minlength=len(ends)).tolist()
    t2 = sw["T2"]
    ends_m, ends_c = t2.picks[0].ends, t2.picks[1].ends
    for n_d in (0, 513, cfg.infection_buffer + 1, 10 ** 6):
        for fill in (0, 4, 5, 17, 64, 100):
            table = torch.full((1, len(S.PICK_COLS)), -1, dtype=I32)
            b = int(daygraph.pick_twin(
                [torch.tensor(n_d, dtype=I32), torch.tensor(fill, dtype=I32)],
                t2.picks, table, torch.tensor(0), 2,
                torch.zeros(len(t2.keys()), dtype=I32),
                torch.zeros((), dtype=I32)))
            _, im = jax_index(cfg.infection_head, cfg.infection_buffer,
                              [min(n_d, cfg.infection_buffer)])
            _, ic = jax_index(cfg.bucket_head, cfg.max_infectees, [fill])
            assert b == im[0] * len(ends_c) + ic[0]
            assert t2.keys()[b] == (ends_m[im[0]], ends_c[ic[0]])
    cond = sw["T"].picks[0]
    for x, want in ((0, 0), (1, 1), (7, 1), (10 ** 6, 1)):
        table = torch.full((1, len(S.PICK_COLS)), -1, dtype=I32)
        assert int(daygraph.pick_twin(
            [torch.tensor(x, dtype=I32)], (cond,), table, torch.tensor(0), 0,
            torch.zeros(2, dtype=I32), torch.zeros((), dtype=I32))) == want


def test_overflow_bits_match_plain_step():
    """(e) with a 24-slot infection buffer (tiers 4, 12, 24) the first
    7 days overflow it with new infections: the problem bits the model's picks
    set on the device equal those the plain step finds on the host, every
    day, and so does every other field and every pick. (Its tracing
    members stay within the buffer; the tracing bit's edge is in
    test_pick_twin_matches_jax_searchsorted.)"""
    run = build_synthetic_run("cpu", n_agents=20000, days=8, seed=3,
                              interventions=IVS,
                              cfg_overrides=dict(infection_buffer=24,
                                                 infection_head=4))
    ref, _, ref_picks = _plain(run, 7)
    gs = graphs.GraphSet(*_build(run), "cpu")
    got = _model(gs, run, 0, run.init_state, run.init_carry, 7)
    assert got["reads"] == 0
    for d, (want, day) in enumerate(zip(ref, got["days"])):
        _assert_day_equal(want, day, d)
    np.testing.assert_array_equal(np.array(got["rows"]), np.array(ref_picks))
    problems = [int(r["carry.problem"]) for r in ref]
    assert problems[-1] == C.PROBLEM_INFECTION_BUFFER_OVERFLOW
    assert problems.index(problems[-1]) == 2        # from the third day


def test_missing_branch_raises():
    """(e) a day whose pick names a branch the set has no capture of, or
    whose host key has no day graph, raises GraphError; so does a host
    key whose day graph fails to build (here a static handoff buffer of
    the wrong shape), naming the span and the key; nothing runs the day
    another way."""
    run = build_synthetic_run("cpu", n_agents=3000, days=5, seed=5,
                              interventions=IVS[:2])
    host = Schedules(*(x.numpy() for x in run.schedules))
    gs = graphs.GraphSet(*_build(run), "cpu")
    plans = gs.prepare(host, prng.PRNGKey(run.random_seed), 0, 4,
                       run.init_carry.weekly_leftover,
                       run.init_state.age.shape[0])
    gs.start(*_build(run), 0, plans)
    gs.step(plans[:1])
    del gs.bodies[("C", (run.cfg.infection_head,))]
    with pytest.raises(graphs.GraphError, match=r"no capture of span C"):
        gs.step(plans[1:2])
    other = plans[2]._replace(ct_active=True)
    with pytest.raises(graphs.GraphError, match=r"no day graph for host key"):
        gs.step([other])
    other = plans[2]._replace(vacc=True)
    gs.handoff["n_new"] = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(graphs.GraphError,
                       match=r"day graph \(False, True, (True|False)\): "
                             r"warm-up of span AB .*n_new"):
        gs.start(*_build(run), 2, [other])


def test_build_graphs_leaves_nothing_to_build():
    """engine.build_graphs (the server's warm-up) builds every host key
    of a run's days into an idle set of its build without stepping a
    day; a graphed run of the build then captures nothing and equals
    the plain step."""
    from reina_tpu_torch.core.engine import build_graphs
    run = build_synthetic_run("cpu", n_agents=3000, days=5, seed=5,
                              interventions=IVS[:2])
    graphs.drop_idle()
    S.reset_stats()
    build_graphs(run)
    assert S.STATS["captures"] > 0 and "days" not in S.STATS
    S.reset_stats()
    out = run_days(run, graphs=True)[0]
    assert "captures" not in S.STATS and S.STATS["days"] == 4
    base = run_days(run, graphs=False)[0]
    for f, a, b in zip(S.DayOutputs._fields, base, out):
        np.testing.assert_array_equal(a, b, err_msg=f)
    graphs.drop_idle()


def test_pick_refuses_more_tiers_than_the_kernel_holds():
    """A count with more tier ceilings than the pick kernel's table
    holds is refused before anything is launched or assembled."""
    ends = tuple(3 ** k for k in range(daygraph.MAX_ENDS + 1))
    p = S.Pick("n_new", None, ends, ends[-1], 0)
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError, match=r"25 tiers.*at most 24"):
        daygraph._pick_args(
            [torch.zeros((), **i32)], (p,), torch.zeros((2, 6), **i32),
            torch.zeros((), dtype=torch.int64), 5,
            torch.zeros(len(ends), **i32), torch.zeros((), **i32))


def test_warmup_launches_are_counted():
    """A launch in a span's warm-up counts in kernels.LAUNCHES, and again
    in kernels.WARMUPS; one under capture counts in the graph's tally
    only."""
    from reina_tpu_torch import kernels
    kernels.reset_launches()
    with kernels.warming():
        kernels.launched("prng.draw")
    kernels.launched("prng.draw")
    with kernels.capturing() as tally:
        kernels.launched("prng.draw")
    assert kernels.launches()["prng.draw"] == 2
    assert kernels.warmups() == {"prng.draw": 1}
    assert tally == {"prng.draw": 1}
    kernels.reset_launches()
    assert kernels.warmups() == {}


# a second build of the same shapes with other values: other beds and
# ICU units, another infectiousness, the mobility limit a week earlier
OTHER_IVS = [iv if iv[0] != "limit-mobility" else
             ["limit-mobility", "2020-02-23", 30] for iv in IVS]
REUSE_DAYS = 9


def _reuse_run(days=REUSE_DAYS, n_agents=4096, **kw):
    return build_synthetic_run("cpu", n_agents=n_agents, days=days, seed=3,
                               **kw)


def test_same_shape_build_reuses_the_set():
    """A build of the same config and shapes with other values (beds,
    ICU units, infectiousness, an intervention moved by a week) acquires
    the first build's idle set, builds no span and no day graph, and
    equals its own plain day step day by day: the set reads the new
    build's arrays and schedule tables from its static copies, never
    the first build's."""
    first = _reuse_run(interventions=IVS)
    other = _reuse_run(interventions=OTHER_IVS, hospital_beds=35,
                       icu_units=4, infectiousness_multiplier=0.9)
    assert graphs.set_key(*_build(first), "cpu") == \
        graphs.set_key(*_build(other), "cpu")
    graphs.drop_idle()
    gs = Spy(*_build(first), "cpu")
    seen = _model(gs, first, 0, first.init_state, first.init_carry,
                  REUSE_DAYS - 1)
    assert [e for e in seen["start_log"] if e[0] == "capture"]
    graphs.release(gs)
    assert graphs.acquire(*_build(other), "cpu") is gs
    S.reset_stats()
    got = _model(gs, other, 0, other.init_state, other.init_carry,
                 REUSE_DAYS - 1)
    assert got["start_log"] == [] and got["reads"] == 0
    assert "captures" not in S.STATS and "day_graphs" not in S.STATS
    ref, _, ref_picks = _plain(other, REUSE_DAYS - 1)
    for d, (want, day) in enumerate(zip(ref, got["days"])):
        _assert_day_equal(want, day, d)
    np.testing.assert_array_equal(np.array(got["rows"]), np.array(ref_picks))
    # the values reached the run: its curve is not the first build's
    assert not np.array_equal(ref[-1]["out.by_group"],
                              seen["days"][-1]["out.by_group"])
    graphs.release(gs)
    graphs.drop_idle()


def test_other_build_keys_get_sets_of_their_own():
    """A build of another agent count gets a new set (which frees the
    device's idle sets); a build with more days than a set holds gets a
    new set from acquire, and the set itself refuses it, as it refuses
    a build of another key and days past its tables."""
    run = _reuse_run(interventions=IVS[:2])
    graphs.drop_idle()
    gs = graphs.acquire(*_build(run), "cpu")
    graphs.release(gs)
    wider = _reuse_run(n_agents=6000, interventions=IVS[:2])
    assert graphs.set_key(*_build(wider), "cpu") != gs.key
    other = graphs.acquire(*_build(wider), "cpu")
    assert other is not gs and graphs.idle() == []
    with pytest.raises(graphs.GraphError, match=r"its model arrays, state, "
                                                r"carry differ"):
        gs.start(*_build(wider), 0, [])
    graphs.release(gs)
    longer = _reuse_run(days=REUSE_DAYS + 5, interventions=IVS[:2])
    assert graphs.set_key(*_build(longer), "cpu") == gs.key
    assert graphs.acquire(*_build(longer), "cpu") is not gs
    with pytest.raises(graphs.GraphError,
                       match=rf"{REUSE_DAYS + 5} days on a set of "
                             rf"{REUSE_DAYS}"):
        gs.start(*_build(longer), 0, [])
    host = Schedules(*(x.numpy() for x in longer.schedules))
    with pytest.raises(graphs.GraphError, match=r"days \[4, 12\) on a set "
                                                rf"of {REUSE_DAYS} days"):
        gs.prepare(host, prng.PRNGKey(3), 4, 8,
                   longer.init_carry.weekly_leftover,
                   longer.init_state.age.shape[0])
    graphs.drop_idle()


def test_prepare_tables_equal_day_by_day_planning():
    """GraphSet.prepare plans its days in one pass (step.plan_days): the
    plans, day rows, key table and picks rows it leaves equal planning
    each day with plan_day and key_table, from day 0 and from a resume
    at day 5 with that day's leftover; the rows of other days are left
    as they were."""
    run = build_synthetic_run("cpu", n_agents=3000, days=DAYS, seed=3,
                              interventions=IVS)
    cfg, steps = run.cfg, DAYS - 1
    host = Schedules(*(x.numpy() for x in run.schedules))
    key, n = prng.PRNGKey(run.random_seed), run.init_state.age.shape[0]
    dks = S.derive_day_keys(cfg, key, np.arange(steps))
    want, lefts = [], [run.init_carry.weekly_leftover]
    for d in range(steps):
        want.append(S.plan_day(cfg, sched_row(run.schedules, host, d),
                               lefts[-1], d, dks.day(d), n))
        lefts.append(want[-1].leftover)
    assert {(p.vacc, p.imports, p.ct_active) for p in want} >= {
        (False, True, False), (True, True, False), (True, True, True)}
    for day0 in (0, 5):
        gs = graphs.GraphSet(*_build(run), "cpu")
        gs.picks.fill_(7)
        plans = gs.prepare(host, key, day0, steps - day0, lefts[day0], n)
        assert len(plans) == steps - day0
        for p, q in zip(want[day0:], plans):
            for f, a, b in zip(S.DayPlan._fields, p, q):
                assert type(a) is type(b), (p.day, f)
                np.testing.assert_array_equal(a, b, err_msg=f"{p.day} {f}")
        for d in range(DAYS):
            planned = day0 <= d < steps
            rows = ((want[d].ints, want[d].floats.view(np.int32),
                     S.key_table(cfg, dks.day(d)).view(np.int32))
                    if planned else (0, 0, 0))
            got = (gs.tab_i[d], gs.tab_f[d].view(torch.int32), gs.tab_k[d])
            for name, a, b in zip(("tab_i", "tab_f", "tab_k"), rows, got):
                assert (b.numpy() == a).all(), (day0, d, name)
            assert (gs.picks[d] == (-1 if planned else 7)).all(), (day0, d)

