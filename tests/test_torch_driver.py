"""The port's driver path: checkpoint/resume, reseed_run, the build
cache, simulate_individuals and outputs_to_frames, on the CPU, against
the JAX package where it has a counterpart.

Setting: the synthetic run at N = 3,000 (padded to 3,072), 9 days, with
contact tracing, imports and vaccination from day 1, so the infectee
buckets that a checkpoint leaves out and rebuilds are in use.

All comparisons are exact (bit for bit, dtypes included): the resumed
run against the uninterrupted one, the checkpoint arrays written by
either package and read by the other (after the port's layout mapping:
no spare bucket slot in the file, ``carry__day`` int32), the re-seeded
run against a fresh build, and the port's frames against the JAX
package's on the same numpy outputs. No JAX engine program is compiled.
"""
import numpy as np
import pytest
import torch

from reina_tpu.core import checkpoint as jckpt
from reina_tpu.testing import build_synthetic_run as jax_build
from reina_tpu_torch import convert, simulation
from reina_tpu_torch.core import checkpoint as ckpt
from reina_tpu_torch.core.engine import reseed_run, run_days
from reina_tpu_torch.core.step import STATS
from reina_tpu_torch.testing import build_synthetic_run, synthetic_variables

torch.set_num_threads(1)

N, DAYS, AT = 3000, 9, 4
IVS = [["test-with-contact-tracing", "2020-02-19", 80],
       ["import-infections", "2020-02-19", 40],
       ["vaccinate", "2020-02-20", 300, 60, None]]


def _build(seed=5):
    return build_synthetic_run("cpu", n_agents=N, days=DAYS, seed=seed,
                               interventions=IVS)


@pytest.fixture(scope="module")
def uninterrupted():
    run = _build()
    out, state, carry, _ = run_days(run, chunk_days=3)
    return run, out, state, carry


def _eq(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (name, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _with_pending(carry):
    """The bucket table with the pending appends applied, as the next
    day step applies them first (a rebuilt table already holds them)."""
    bkt = carry.bkt_dst.clone()
    spare = bkt.numel() - 1          # the drop target of sentinels
    bkt[torch.clamp_max(carry.app_pos, spare).long()] = carry.app_val
    return carry._replace(bkt_dst=bkt)


def _eq_runs(want, got, pending=False):
    (wo, ws, wc), (go, gs, gc) = want, got
    if pending:
        wc, gc = _with_pending(wc), _with_pending(gc)
    for name, a, b in zip(wo._fields, wo, go):
        _eq(a, b, "out." + name)
    for tag, w, g in (("state.", ws, gs), ("carry.", wc, gc)):
        for (k, a), b in zip(convert.to_numpy(w).items(),
                             convert.to_numpy(g).values()):
            if k == "bkt_dst":        # the spare drop slot is never read
                a, b = a[:-1], b[:-1]
            _eq(a, b, tag + k)


def test_resume_equals_uninterrupted(uninterrupted, tmp_path):
    run, out, state, carry = uninterrupted
    # the run uses the infectee buckets a checkpoint leaves out
    assert int(carry.bkt_fill.sum()) > 0
    run_days(run, n_days=AT + 1, chunk_days=3, checkpoint_dir=str(tmp_path),
             checkpoint_every=AT)
    assert ckpt.latest_checkpoint(str(tmp_path)) == \
        ckpt.checkpoint_path(str(tmp_path), AT)
    got = run_days(run, chunk_days=3, checkpoint_dir=str(tmp_path))
    _eq_runs((out, state, carry), got[:3])
    # the run's end was saved too, and resuming from it steps no day;
    # its rebuilt table holds the last day's pending appends
    again = run_days(run, chunk_days=3, checkpoint_dir=str(tmp_path))
    assert again[3] == []
    _eq_runs((out, state, carry), again[:3], pending=True)


def test_checkpoint_round_trip(uninterrupted, tmp_path):
    run, out, state, carry = uninterrupted
    path = str(tmp_path / "day.npz")
    ckpt.save_checkpoint(path, state, carry, out)
    st, cr, o = ckpt.load_checkpoint(path)
    for k, v in convert.to_numpy(state).items():
        _eq(v, getattr(st, k), "state." + k)
    want = convert.to_numpy(_with_pending(carry))
    _eq(want["bkt_dst"][:-1], cr.bkt_dst, "bkt_dst")
    _eq(want["bkt_fill"], cr.bkt_fill, "bkt_fill")
    _eq(np.int32(DAYS - 1), cr.day, "day")
    _eq(want["weekly_leftover"], cr.weekly_leftover, "weekly_leftover")
    for name, a, b in zip(out._fields, out, o):
        _eq(a, b, "out." + name)


def test_checkpoints_cross_packages(uninterrupted, tmp_path):
    """Port-written files read by the JAX package and the reverse give
    the same arrays; a JAX-written day-0 checkpoint resumes in the port
    to the port's own uninterrupted run."""
    run, out, state, carry = uninterrupted
    p_path, j_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ckpt.save_checkpoint(p_path, state, carry, out)
    js, jc, jo = jckpt.load_checkpoint(p_path)
    ps, pc, po = ckpt.load_checkpoint(p_path)
    for tag, a, b in (("state", js, ps), ("carry", jc, pc), ("out", jo, po)):
        assert a._fields == b._fields, tag
        for k, x, y in zip(a._fields, a, b):
            _eq(x, y, f"{tag}.{k}")
    jckpt.save_checkpoint(j_path, js, jc, jo)
    with np.load(p_path) as zp, np.load(j_path) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            _eq(zp[k], zj[k], k)

    # a JAX build's initial state, saved by the JAX package, resumes here
    ref = jax_build(n_agents=N, days=DAYS, seed=5, interventions=IVS)
    d = tmp_path / "jax_day0"
    jckpt.save_checkpoint(jckpt.checkpoint_path(str(d), 0),
                          ref.init_state, ref.init_carry)
    got = run_days(run, chunk_days=3, checkpoint_dir=str(d))
    _eq_runs((out, state, carry), got[:3])


@pytest.mark.parametrize("seed", [7, 11])
def test_reseed_equals_build(seed):
    run = _build()
    got, want = reseed_run(run, seed), _build(seed)
    assert got.random_seed == want.random_seed == seed
    for tag in ("init_state", "init_carry"):
        for (k, a), b in zip(convert.to_numpy(getattr(want, tag)).items(),
                             convert.to_numpy(getattr(got, tag)).values()):
            _eq(a, b, f"{tag}.{k}")
    assert got.arrays is run.arrays and got.schedules is run.schedules


def test_build_cache_keys_and_reseeds(monkeypatch):
    built = []

    def fake_build(variables, device):
        built.append((variables["random_seed"], str(device)))
        return build_synthetic_run(device, n_agents=N, days=3,
                                   seed=variables["random_seed"])

    monkeypatch.setattr(simulation, "build_run", fake_build)
    cache = simulation.BuildCache()
    v = synthetic_variables(days=3, seed=1)
    before = dict(STATS)
    a = cache.get(v, "cpu")
    assert cache.last[0] == "built" and built == [(1, "cpu")]
    assert cache.get(v, "cpu") is a and cache.last[0] == "cached"
    b = cache.get(dict(v, random_seed=2), "cpu")
    assert cache.last[0] == "reseeded" and b.random_seed == 2
    assert b.arrays is a.arrays and len(built) == 1
    assert tuple(STATS[f"build.{k}"] - before.get(f"build.{k}", 0)
                 for k in ("hits", "misses", "reseeds")) == (2, 1, 1)
    # the device is part of the key; at most two entries are kept
    cache.get(v, "meta")
    cache.get(dict(v, simulation_days=4), "cpu")
    assert len(built) == 3 and len(cache._runs) == 2
    cache.get(v, "cpu")
    assert len(built) == 4 and cache.last[0] == "built"


def test_simulate_individuals_on_cpu_and_frames(uninterrupted, monkeypatch):
    """simulate_individuals on device='cpu' equals run_days; its columns
    make the JAX package's frames; with no card the default raises."""
    import reina_tpu.simulation as jsim
    run, out, _, _ = uninterrupted
    v = synthetic_variables(days=DAYS, seed=5, interventions=IVS)

    def fake_build(variables, device):
        assert str(device) == "cpu"
        return run

    monkeypatch.setattr(simulation, "BUILD_CACHE", simulation.BuildCache())
    monkeypatch.setattr(simulation, "build_run", fake_build)
    rows = []
    cols, cube = simulation.simulate_individuals(
        step_callback=lambda c: rows.append(len(c["date"])) or True,
        callback_day_interval=4, variable_store=v, skip_cache=True,
        device="cpu")
    assert rows == [5, 9]
    _eq(cube.values, out.by_group[:, [simulation.GROUP_ROW[a]
                                      for a in simulation.POP_ATTRS]],
        "cube")
    assert cube.groups == run.group_labels
    assert len(cols["date"]) == DAYS
    assert str(cols["date"][0]) == run.start_date

    df, adf = simulation.outputs_to_frames(out, run, DAYS,
                                           cols["us_per_infected"])
    jdf, jadf = jsim.outputs_to_frames(out, run, DAYS,
                                       cols["us_per_infected"])
    import pandas as pd
    pd.testing.assert_frame_equal(df, jdf)
    pd.testing.assert_frame_equal(adf, jadf)
    assert [c for c in cols if c != "date"] == list(jdf.columns)
    for c in jdf.columns:
        _eq(cols[c], jdf[c].to_numpy(), c)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            simulation.simulate_individuals(variable_store=v,
                                            skip_cache=True)
