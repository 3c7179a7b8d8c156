"""The port's seed ensembles, Monte-Carlo frames and calibration sweeps.

No JAX engine program is compiled here: a whole run's parity with the
JAX package is held by tests/test_torch_step.py. These tests hold each
new module to the port's own ``run_days``, and the host-side code
(scoring, the Monte-Carlo CSV and statistics, the grid) to the JAX
package's functions on the same numpy inputs.

Checks and tolerances:
  * ensemble (4,000 agents, 9 days): member s equals ``run_days`` with
    seed s, rows 1.., exactly in every field; batch sizes 1 and 2 give
    equal arrays; each member is a span ``ensemble.member`` over its
    run loop's spans, a graphed (model) run a ``run.launch`` a chunk.
  * Monte-Carlo (Alavieska, 8 days, 2 runs): the day-0 row uses
    ``mobility_scalar[0]``; the CSV is byte-equal to the one the JAX
    package's pandas assembly writes from the same numpy outputs; the
    CLI's statistics equal pandas' ``describe()`` within 1e-9 relative.
  * calibration (12,000 agents, 18 days, points 0.2/0.55/1.2): the grid
    points and their error, monotone finals, the generating point ranked
    first; each point equals ``run_days`` of its own build with the base
    cfg and schedules, exactly; scores equal the JAX package's exactly.
"""
import contextlib
import io
import json
from dataclasses import replace
from datetime import date, timedelta
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from reina_tpu import calibration as jcal
from reina_tpu.simulation import outputs_to_frames as jax_outputs_to_frames

from reina_tpu_torch import cli
from reina_tpu_torch.calibration import (calibrate, grid_points,
                                         score_against_observed, sweep_grid)
from reina_tpu_torch.core.engine import build_run, run_days, stack_outputs
from reina_tpu_torch.core.step import DayOutputs, snapshot_outputs
from reina_tpu_torch.ensemble import (DESCRIBE_STATS, describe,
                                      run_ensemble, run_monte_carlo)
from reina_tpu_torch.testing import (build_synthetic_run,
                                     synthetic_age_counts,
                                     synthetic_variables)
from reina_tpu_torch.utils import perf

SEEDS = [5, 6, 7]
MC_RUNS = 2
MC_DAYS = 8
MC_DEFAULTS = {
    "area_name": "Alavieska", "simulation_days": MC_DAYS,
    "interventions": [["limit-mobility", "2020-02-18", 30],
                      ["import-infections", "2020-02-19", 40],
                      ["test-all-with-symptoms", "2020-02-19"]]}
CAL_GRID = {"infectiousness_multiplier": [0.2, 0.55, 1.2]}
CAL_AGENTS = 12000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The CPU runs here are thousands of tiny ops a day, which torch's
    intra-op threads only slow down, most of all on a busy host."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_outputs_equal(a, b):
    for name, x, y in zip(DayOutputs._fields, a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)
        assert np.asarray(x).dtype == np.asarray(y).dtype, name


# ---- ensembles

@pytest.fixture(scope="module")
def ensemble():
    run = build_synthetic_run("cpu", n_agents=4000, days=9, seed=3,
                              interventions=[["import-infections",
                                              "2020-02-19", 50]])
    return run, run_ensemble(run, SEEDS, batch_size=2)


def test_ensemble_members_equal_run_days(ensemble):
    run, outs = ensemble
    assert outs.by_group.shape == (3, 8, 13, len(run.group_labels))
    for name, x in zip(DayOutputs._fields, outs):
        assert x.shape[:2] == (3, 8), name
    for i, s in enumerate(SEEDS):
        out, _, _, _ = run_days(run, seed=s)
        _assert_outputs_equal(DayOutputs(*(x[i] for x in outs)),
                              DayOutputs(*(x[1:] for x in out)))
    finals = outs.by_group[:, -1, 3].sum(axis=-1)
    assert len(set(finals.tolist())) > 1, finals


def test_ensemble_batch_size_changes_nothing(ensemble):
    run, outs = ensemble
    _assert_outputs_equal(run_ensemble(run, SEEDS, batch_size=1), outs)
    with pytest.raises(ValueError, match="batch_size"):
        run_ensemble(run, SEEDS, batch_size=0)


def _spans(id_):
    """The ring's spans of request ``id_``: {name: [(parent, seconds)]}."""
    got = {}
    for name, i, parent, a, b in list(perf.RING):
        if i == id_:
            got.setdefault(name, []).append((parent, (b - a) / 1e9))
    return got


def test_members_are_spans_with_their_run_loops(ensemble):
    """Two members: two ensemble.member spans, each the parent of its
    run's run.prepare, one run.launch (8 days in one chunk) and the
    run.wait and run.fetch of its one sync point."""
    run, _ = ensemble
    n = perf.STATS["ensemble.member_n"]
    with perf.span("t.members", id="members"):
        run_ensemble(run, SEEDS[:2])
    assert perf.STATS["ensemble.member_n"] - n == 2
    got = _spans("members")
    assert {k: len(v) for k, v in got.items()} == {
        "ensemble.member": 2, "run.prepare": 2, "run.launch": 2,
        "run.wait": 2, "run.fetch": 2, "t.members": 1}
    assert all(p == "ensemble.member" for k in ("run.prepare", "run.launch",
                                               "run.wait", "run.fetch")
               for p, _ in got[k])
    member = sum(s for _, s in got["ensemble.member"])
    assert sum(s for k in ("run.prepare", "run.launch", "run.wait",
                           "run.fetch") for _, s in got[k]) <= member


@pytest.mark.parametrize("callback,syncs", [(False, 1), (True, 3)])
def test_graphed_run_loop_spans(ensemble, callback, syncs):
    """The graph runner's CPU model over 8 days in chunks of 3: the
    planning of the run's days a run.plan inside its run.prepare, a
    run.launch a chunk with its day-graph launches counted at the
    chunk's end, a run.wait and run.fetch a sync point (the run's end,
    or every chunk with a callback)."""
    run, _ = ensemble
    before = {k: perf.STATS[k] for k in ("days", "launches")}
    with perf.span("t.graphed", id=f"graphed-{callback}"):
        run_days(run, graphs=True, chunk_days=3,
                 day_callback=(lambda day, out: True) if callback else None)
    spans = _spans(f"graphed-{callback}")
    got = {k: len(v) for k, v in spans.items()}
    assert got == {"run.prepare": 1, "run.plan": 1, "run.launch": 3,
                   "run.wait": syncs, "run.fetch": syncs, "t.graphed": 1}
    assert spans["run.plan"][0][0] == "run.prepare"
    assert {k: perf.STATS[k] - v for k, v in before.items()} == {
        "days": 8, "launches": 8}


def test_graphed_members_plan_once_each(ensemble, monkeypatch):
    """Each member of a graphed ensemble (as on a card: here the graph
    runner's CPU model) plans its days once, one run.plan inside its
    run.prepare, and the members equal the plain step's. The plain step
    plans a day at a time and has no run.plan (the span counts of
    test_members_are_spans_with_their_run_loops)."""
    import functools
    from reina_tpu_torch import ensemble as E
    run, outs = ensemble
    monkeypatch.setattr(E, "run_days",
                        functools.partial(run_days, graphs=True))
    n = perf.STATS["run.plan_n"]
    with perf.span("t.plans", id="plans"):
        got = run_ensemble(run, SEEDS[:2])
    assert perf.STATS["run.plan_n"] - n == 2
    assert [p for p, _ in _spans("plans")["run.plan"]] == ["run.prepare"] * 2
    _assert_outputs_equal(got, DayOutputs(*(x[:2] for x in outs)))


# ---- Monte-Carlo

@pytest.fixture()
def mc_defaults(monkeypatch):
    from reina_tpu_torch.config import variables
    for k, v in MC_DEFAULTS.items():
        monkeypatch.setitem(variables.VARIABLE_DEFAULTS, k, v)


@pytest.fixture()
def mc(mc_defaults, tmp_path):
    path = tmp_path / "mc.csv"
    cols = run_monte_carlo(n_runs=MC_RUNS, csv_path=str(path), device="cpu")
    return cols, path.read_bytes()


@pytest.fixture(scope="module")
def mc_reference():
    """The build and members run_monte_carlo makes, its day-0 row, and
    the JAX package's pandas frame of them."""
    from reina_tpu_torch.config import variables
    with pytest.MonkeyPatch.context() as mp:
        for k, val in MC_DEFAULTS.items():
            mp.setitem(variables.VARIABLE_DEFAULTS, k, val)
        v = variables.VariableStore().copy_all()
    v["random_seed"] = 0
    run = build_run(v, "cpu")
    outs = run_ensemble(run, list(range(MC_RUNS)))
    mob0 = run.schedules.mobility_scalar[0].numpy()
    snap = stack_outputs([snapshot_outputs(run.cfg, run.arrays,
                                           run.init_state, run.init_carry,
                                           mob0)])
    return mob0, _pandas_frame(run, outs, snap)


def _pandas_frame(run, outs, snap, scenario="default"):
    """The JAX package's assembly (reina_tpu/ensemble.py:138-152)."""
    ns = SimpleNamespace(start_date=run.start_date,
                         variant_names=run.variant_names,
                         group_labels=run.group_labels)
    frames = []
    for s in range(outs.by_group.shape[0]):
        padded = DayOutputs(*(np.concatenate([a, b[s]])
                              for a, b in zip(snap, outs)))
        df, _ = jax_outputs_to_frames(padded, ns, run.days)
        df["run"] = s
        frames.append(df)
    df = pd.concat(frames)
    df.index.name = "date"
    df = df.reset_index()
    df["scenario"] = scenario
    return df


def test_monte_carlo_csv_equals_jax_assembly(mc, mc_reference, tmp_path):
    cols, text = mc
    mob0, df = mc_reference
    assert float(mob0) != 1.0       # limit-mobility from the first day
    day0 = cols["mobility_limitation"][::MC_DAYS]
    np.testing.assert_array_equal(day0, np.float32(1.0) - mob0)
    assert len(cols["date"]) == MC_RUNS * MC_DAYS
    np.testing.assert_array_equal(cols["run"],
                                  np.repeat(np.arange(MC_RUNS), MC_DAYS))
    assert cols["all_infected"][-1] > 0
    assert list(cols) == list(df.columns)
    ref = tmp_path / "ref.csv"
    df.to_csv(ref, index=False)
    assert text == ref.read_bytes()


def test_monte_carlo_cli_statistics_equal_describe(mc_defaults,
                                                   mc_reference):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["monte-carlo", "--runs", str(MC_RUNS),
                         "--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    head = lines.index(next(x for x in lines if x.startswith("column")))
    printed = {ln.split()[0]: np.array(ln.split()[1:], float)
               for ln in lines[head + 1:]}
    _, df = mc_reference
    ref = df[df.date == df.date.max()].describe()
    numeric = [c for c in ref.columns if c != "date"]
    assert list(printed) == numeric
    last = df[df.date == df.date.max()]
    stats = describe({k: last[k].to_numpy() for k in numeric})
    for c in numeric:
        want = ref[c][list(DESCRIBE_STATS)].to_numpy(float)
        np.testing.assert_allclose(printed[c], want, rtol=1e-9, atol=0,
                                   err_msg=c)
        np.testing.assert_allclose(stats[c], want, rtol=1e-9, atol=0,
                                   err_msg=c)


# ---- calibration

def test_grid_points():
    grid = {"infectiousness_multiplier": [0.4, 0.6],
            "mean_incubation_duration": [4.0, 5.1, 6.0]}
    pts = grid_points(grid)
    assert pts == jcal.grid_points(grid)
    assert len(pts) == 6
    assert {"infectiousness_multiplier": 0.6,
            "mean_incubation_duration": 6.0} in pts
    with pytest.raises(ValueError, match="not sweepable") as e:
        grid_points({"random_seed": [1, 2]})
    with pytest.raises(ValueError) as ej:
        jcal.grid_points({"random_seed": [1, 2]})
    assert str(e.value) == str(ej.value)


def _cal_variables():
    return synthetic_variables(days=18, seed=5, interventions=[
        ["import-infections", "2020-02-19", 80]])


def _observed_from(curve, start):
    return [{"date": (start + timedelta(days=d + 1)).isoformat(),
             "confirmed": int(curve[d]), "dead": int(curve[d]) // 50}
            for d in range(len(curve))]


@pytest.fixture(scope="module")
def sweep():
    """Each point's own run (its own build with the base cfg and
    schedules, key of the base seed), then ``calibrate`` against the
    0.55 point's all_detected curve; the sweep it made is kept."""
    from reina_tpu_torch import calibration
    v = _cal_variables()
    ages = synthetic_age_counts(CAL_AGENTS)
    own, base = [], None
    for pt in grid_points(CAL_GRID):
        run = build_run(dict(v, **pt), "cpu", pad_multiple=256,
                        age_counts_override=ages)
        base = base or run
        run = replace(run, cfg=base.cfg, schedules=base.schedules)
        out, _, _, _ = run_days(run, seed=base.random_seed)
        own.append(DayOutputs(*(x[1:] for x in out)))
    truth = own[1].by_group[:, 5, :].sum(axis=-1)   # all_detected cum
    rows = _observed_from(truth, date.fromisoformat(v["start_date"]))
    swept = []

    def spy(*args, **kw):
        swept.append(sweep_grid(*args, **kw))
        return swept[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(calibration, "sweep_grid", spy)
        best, ranked = calibrate(v, CAL_GRID, observed_rows=rows,
                                 batch_size=3, pad_multiple=256,
                                 age_counts_override=ages, device="cpu")
    points, outs, base = swept[0]
    return SimpleNamespace(v=v, own=own, rows=rows, best=best,
                           ranked=ranked, points=points, outs=outs,
                           base=base)


def test_sweep_monotone_in_infectiousness(sweep):
    assert sweep.points == grid_points(CAL_GRID)
    assert sweep.outs.by_group.shape[:2] == (3, 17)
    assert len(sweep.base.meta["sweep_seconds"]) == 3
    final = sweep.outs.by_group[..., 3, :].sum(axis=-1)[:, -1]
    assert final[0] < final[1] < final[2], final.tolist()


def test_sweep_points_equal_their_own_runs(sweep):
    for g, own in enumerate(sweep.own):
        _assert_outputs_equal(DayOutputs(*(x[g] for x in sweep.outs)), own)


def test_calibrate_recovers_generating_point(sweep):
    assert sweep.best == {"infectiousness_multiplier": 0.55}
    assert [p for p, _ in sweep.ranked][0] == sweep.best
    assert sweep.ranked[0][1] == 0.0 < sweep.ranked[-1][1]


def test_scores_equal_jax(sweep):
    outs, base, rows = sweep.outs, sweep.base, sweep.rows
    jbase = SimpleNamespace(start_date=base.start_date, meta=base.meta)
    for metric in ("all_detected", "dead"):
        for obs in (rows, rows[3:9], rows[::4]):
            np.testing.assert_array_equal(
                score_against_observed(outs, base, obs, metric),
                jcal.score_against_observed(outs, jbase, obs, metric))
    for obs, metric in ((rows, "recovered"),
                        ([{"date": "2019-01-01", "confirmed": 1}],
                         "all_detected")):
        with pytest.raises(ValueError) as e:
            score_against_observed(outs, base, obs, metric)
        with pytest.raises(ValueError) as ej:
            jcal.score_against_observed(outs, jbase, obs, metric)
        assert str(e.value) == str(ej.value)


def test_calibrate_cli(monkeypatch):
    """The JAX CLI's lines, on a small area with observed rows given."""
    from reina_tpu_torch.data import loaders
    start = date(2020, 2, 18)
    monkeypatch.setattr(loaders, "get_detected_cases", lambda area: [
        {"date": (start + timedelta(days=d)).isoformat(),
         "confirmed": d, "dead": 0} for d in range(1, 6)])
    grid = {"infectiousness_multiplier": [0.3, 0.9]}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["calibrate", "--grid", json.dumps(grid), "--area",
                         "Alavieska", "--days", "6", "--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0] == "rank  score        point"
    assert [ln[:6] for ln in lines[1:3]] == ["1     ", "2     "]
    assert {json.loads(ln[19:])["infectiousness_multiplier"]
            for ln in lines[1:3]} == {0.3, 0.9}
    assert lines[3] == "best: " + lines[1][19:]


def test_mc_compare_paired_and_parting(tmp_path):
    """mc_compare on two made-up spreads of 4 seeds: B is A plus 5,000 on
    every seed from stepped day 5 on (all_infected only), so the means
    differ by 5,000, the paired difference is 5,000 ± 0, and all_infected's
    mean curves stay apart from day 5 while the other totals never part."""
    from reina_tpu_torch import mc_compare
    r = np.random.default_rng(3)
    a_path, b_path = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    with open(a_path, "w") as fa, open(b_path, "w") as fb:
        for s in range(4):
            rec = {k: r.integers(1000, 2000, 20).tolist()
                   for k in mc_compare.TOTALS}
            fa.write(json.dumps({"seed": s, **rec}) + "\n")
            rec["all_infected"] = [x + (5000 if d >= 4 else 0)
                                   for d, x in enumerate(rec["all_infected"])]
            fb.write(json.dumps({"seed": s, "final": 0, **rec}) + "\n")
    res = mc_compare.compare(mc_compare.load(str(a_path)),
                             mc_compare.load(str(b_path)), [5, 20])
    assert res["a"]["seeds"] == res["b"]["seeds"] == 4
    assert res["diff"] == pytest.approx(5000.0)
    assert res["paired"] == {"seeds": 4, "mean": 5000.0, "se": 0.0}
    assert res["b"]["curve_mean"][20] - res["a"]["curve_mean"][20] == \
        pytest.approx(5000.0)
    first = res["first_day_apart"]
    assert first["all_infected"] == 5
    assert all(first[k] is None for k in mc_compare.TOTALS
               if k != "all_infected")
