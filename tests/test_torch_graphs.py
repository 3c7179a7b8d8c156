"""The day step's spans and the graph runner (core/graphs.py) on the CPU.

On a card the graph runner replays each (span, key) as a captured CUDA
graph; on the CPU a GraphSet is its model: the same static buffers, day
tables, device day counter and copies, with each (span, key) recorded on
its first day and called again on later days. A span that read a
day-varying value from anywhere but those buffers would give a wrong day
when a recording from another day runs, as a replayed graph would.

Setting: the synthetic run with tests/test_torch_step.py's calendar
(testing, imports, weekly imports, mobility limits, masks, contact
tracing from day 16, vaccination, capacity builds), 20,000 agents, 21
stepped days. Checks, all exact (bit for bit):
  * (a) the graph model stepped day by day equals the plain day step on
    every field of the state, the carry and the outputs, every day;
  * (b) the same GraphSet restarted at day 15 replays every span of days
    15-20 from recordings made on other days, and equals them again;
  * (c) each tier the host picked equals the one the JAX package's
    tier_bounds and searchsorted pick for the counts it read;
  * (d) the packed fetch equals the JAX package's ``_pack_leaves`` on the
    same outputs, and run_days syncing every chunk (with a callback)
    gives the same outputs as syncing once at the end.
"""
import numpy as np
import pytest
import torch

from reina_tpu_torch import convert
from reina_tpu_torch.core import graphs
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
    """A CPU GraphSet that logs its spans (recorded or replayed) and the
    values the host read, in order."""

    def __init__(self, *a):
        super().__init__(*a)
        self.log = []

    def span(self, name, key, fn):
        self.log.append(("replay" if (name, key) in self.entries
                         else "record", name, key))
        return super().span(name, key, fn)

    def read(self, t):
        v = super().read(t)
        self.log.append(("read", v))
        return v


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


@pytest.fixture(scope="module")
def runs():
    """The plain day step and the graph model, day by day, and the model
    restarted at day RESTART."""
    run = build_synthetic_run("cpu", n_agents=20000, days=DAYS, seed=3,
                              interventions=IVS)
    cfg, n = run.cfg, run.init_state.age.shape[0]
    host = Schedules(*(x.numpy() for x in run.schedules))
    key = prng.PRNGKey(run.random_seed)
    state = run.init_state
    carry = run.init_carry._replace(bkt_dst=run.init_carry.bkt_dst.clone())
    ref, ref_states = [], []
    for d in range(DAYS - 1):
        # the day step updates the bucket table in place
        ref_states.append((state, carry._replace(
            bkt_dst=carry.bkt_dst.clone())))
        dk = S.derive_day_keys(cfg, key, [d]).day(0)
        state, carry, out = S.day_step(cfg, run.arrays,
                                       sched_row(run.schedules, host, d),
                                       state, carry, dk)
        ref.append(_np(state, carry, out))

    gs = Spy(cfg, run.arrays, run.schedules, "cpu")

    def model(day0, state, carry):
        gs.start(state, carry, day0)
        plans = gs.prepare(host, key, day0, DAYS - 1 - day0,
                           carry.weekly_leftover, n)
        days, logs, bits = [], [], 0
        for i, plan in enumerate(plans):
            gs.log = []
            bits |= gs.step([plan])
            st, cr = gs.state_carry(day0 + i + 1, plan.leftover, bits,
                                    clone=True)
            out = gs.outputs(day0 + i, day0 + i + 1, [plan])
            out = S.DayOutputs(*(x[0] for x in out))
            days.append(_np(st, cr, out))
            logs.append(gs.log)
        return days, logs

    first, first_logs = model(0, run.init_state, run.init_carry)
    again, again_logs = model(RESTART, *ref_states[RESTART])
    return dict(run=run, ref=ref, first=first, first_logs=first_logs,
                again=again, again_logs=again_logs, gs=gs)


def test_graph_model_equals_day_step(runs):
    """(a) every field, every day; the calendar reaches every span."""
    for d, (want, got) in enumerate(zip(runs["ref"], runs["first"])):
        _assert_day_equal(want, got, d)
    spans = {name for name, _ in runs["gs"].entries}
    assert spans == {"AB", "A", "T1", "T2", "T3", "T4", "B", "C"}
    keys = {k for name, k in runs["gs"].entries if name in ("AB", "B")}
    assert (True, True) in keys and (False, True) in keys  # vacc, imports
    replays = sum(e[0] == "replay" for log in runs["first_logs"]
                  for e in log)
    assert replays > 2 * len(runs["first"])


def test_spans_replayed_from_other_days(runs):
    """(b) restarted at day RESTART, every span of every day is a
    recording made on an earlier day, and each day is equal again."""
    for i, (want, got) in enumerate(zip(runs["ref"][RESTART:],
                                        runs["again"])):
        _assert_day_equal(want, got, RESTART + i)
    kinds = [e[0] for log in runs["again_logs"] for e in log
             if e[0] != "read"]
    assert kinds and set(kinds) == {"replay"}
    traced = [log for log in runs["again_logs"]
              if any(e[0] == "replay" and e[1] == "T4" for e in log)]
    assert len(traced) >= 3


def test_tiers_match_jax_tier_bounds(runs):
    """(c) the ceiling of each keyed span against the JAX package's
    tier_bounds + searchsorted (lax.switch clamps to its last branch)
    on the count the host read before it."""
    import jax.numpy as jnp
    from reina_tpu.core.step import tier_bounds as jax_tier_bounds
    cfg = runs["run"].cfg
    Tcap = cfg.infection_buffer

    def jax_pick(head, cap, x):
        ends = [lo + seg for lo, seg in jax_tier_bounds(min(head, cap), cap)]
        i = int(jnp.searchsorted(jnp.asarray(ends, jnp.int32), x,
                                 side="left"))
        return ends[min(i, len(ends) - 1)]

    checked = set()
    for log in runs["first_logs"]:
        reads = iter(e[1] for e in log if e[0] == "read")
        spans = {e[1]: e[2] for e in log if e[0] != "read"}
        if "A" in spans:
            ct_cases, n_d = next(reads)
            if ct_cases > 0:
                fill1, n_f, fill2 = next(reads), next(reads), next(reads)
                mem = (cfg.infection_head, Tcap)
                cols = (cfg.bucket_head, cfg.max_infectees)
                assert spans["T1"] == (jax_pick(*mem, min(n_d, Tcap)),)
                assert spans["T2"] == (spans["T1"][0],
                                       jax_pick(*cols, fill1))
                assert spans["T3"] == (jax_pick(*mem, min(n_f, Tcap)),)
                assert spans["T4"] == (spans["T3"][0],
                                       jax_pick(*cols, fill2))
                checked |= {"T1", "T2", "T3", "T4"}
        n_new = next(reads)
        assert spans["C"] == (jax_pick(cfg.infection_head, Tcap,
                                       min(n_new, Tcap)),)
        checked.add("C")
    assert checked == {"T1", "T2", "T3", "T4", "C"}


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
    got, p = fetch_packed(dev, torch.tensor(problem))
    assert p == 5
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
