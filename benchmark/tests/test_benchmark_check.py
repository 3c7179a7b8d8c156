"""The comparison that decides ``correct``, driven end to end at a tiny
size on the CPU (Alavieska, 12 days; the port's CPU path is the plain
step with the twins): a sound run is correct, a run with the timed path
broken underneath is not, for each fault the cells can have, and the
control (the reference in bfloat16) fails the committed limits. One
chip has no exchange between chips to leave out. The control at the
cells' own sizes runs on the card (``gpu``)."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import run as B
from benchmark.harness import check
from benchmark.harness.cell import HERE, ROOT, Cell, cell, load_json

TINY_AGENTS = 2393      # Alavieska


def _tiny(kind: str) -> Cell:
    c = cell("hus.served" if kind == "served" else "hus.ensemble")
    cfg = load_json(HERE / "configs" / "hus.json")
    # with cases at the start, so that every day moves many agents
    cfg["variables"].update(area_name="Alavieska", simulation_days=12,
                            incubating_at_simulation_start=1200,
                            ill_at_simulation_start=400)
    cfg["agents"] = TINY_AGENTS
    traffic = dict(c.traffic, check_days=4)
    if kind == "served":
        traffic["clients"] = 2
    return Cell(f"tiny.{kind}", 1, cfg, traffic, c.limits, c.end_to_end,
                c.per_layer)


def _run(kind: str, seconds: float = 2.0) -> dict:
    return B.run_cell(_tiny(kind), 2**31 + 99, seconds, False, "cpu",
                      t_start=time.perf_counter())


@pytest.fixture
def plant(monkeypatch):
    """Break the program's day step: ``plant(fault)``."""
    from reina_tpu_torch.core import engine
    real = engine.day_step

    def planted(fault):
        def step(cfg, arrays, sched, state, carry, dk, shard=None,
                 picks=None):
            s, c, o = real(cfg, arrays, sched, state, carry, dk, shard,
                           picks)
            if fault == "unchanged":
                return state, carry._replace(day=c.day), o
            if fault == "half":
                # every other agent left as it was
                keep = torch.arange(state.age.shape[0]) % 2 == 1
                return (type(s)(*(torch.where(keep, b, a)
                                  for a, b in zip(s, state))), c, o)
            if fault == "altered":
                by = o.by_group.clone()
                by[3, 0] += 1000
                return s, c, o._replace(by_group=by)
            raise ValueError(fault)
        monkeypatch.setattr(engine, "day_step", step)
    return planted


def test_sound_members_are_correct():
    out = _run("members")
    assert out["correct"], out["checks"]
    assert all(v == 0 for v, _ in out["checks"].values())
    assert list(out)[-1] == "checks"
    assert out["metrics"]["agent_days_per_s"]["value"] > 0


def test_sound_served_is_correct():
    out = _run("served", 3.0)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["metrics"]["result_s_p75"]["value"] > 0


@pytest.mark.parametrize("kind", ["members", "served"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_step_is_not_correct(plant, kind, fault):
    plant(fault)
    out = _run(kind, 3.0)
    assert not out["correct"], out["checks"]


def test_the_control_fails_the_limits():
    """The reference in bfloat16 in the program's place, from the
    program's states of a tiny member."""
    from reina_tpu_torch.core.engine import build_run
    c = _tiny("members")
    run = build_run(c.config["variables"], "cpu")
    item = dict(variables=c.config["variables"], seed=5, outputs=None,
                columns=None, run=run)
    nums = check.compare([item], np.random.default_rng(0), 6, "cpu",
                         control=True, log=lambda s: None)
    assert any(nums[k] > c.limits[k] for k in check.NUMBERS), nums


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["hus.ensemble", "vs.ensemble",
                                      "hus.served"])
def test_control_at_the_cells_size(workload):
    """benchmark/control.py on the card: the control fails the cell's
    limits on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "-m", "benchmark.control",
                        "--workload", workload, "--seeds", "3",
                        "--sound", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    lim = cell(workload).limits
    for nums in got["control"]:
        assert any(nums[k] > lim[k] for k in check.NUMBERS), nums

