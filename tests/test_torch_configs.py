"""The JAX package's other configurations, held to it on the CPU: the
port's ``build_run`` of Varsinais-Suomi and of Turku (the ``turku``
override set, with its default scenario and with ``astra-zeneca``, the
set's only vaccination) equals the JAX package's leaf by leaf (config,
model arrays, schedules, initial state and carry); and each preset
scenario's schedules equal the JAX package's.

Host compile only: no day is stepped and no engine program compiled.
Each JAX build runs in a child interpreter of its own (as
tests/test_isolated_modules.py runs the engine-compiling modules),
which writes its leaves to an .npz that the test compares with the
port's build here. Exact throughout (same numpy code, same seeds), with
the layout differences tests/test_torch_host.py names: no bf16 age
one-hots, a spare drop slot after the bucket table, ``day`` as a host
int.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from reina_tpu_torch import convert

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (override set, variables over the defaults and the set, agents)
CONFIGS = {
    "varsinais-suomi": (None, {"area_name": "Varsinais-Suomi"}, 479861),
    "turku": ("turku", {}, 192962),
    "turku-astra-zeneca": ("turku", {"active_scenario": "astra-zeneca"},
                           192962),
}

# the JAX package's build_run of one configuration, its leaves to an .npz
_CHILD = """
import copy, dataclasses, json, sys
import numpy as np
from reina_tpu.config.variables import (VARIABLE_DEFAULTS,
                                        VARIABLE_OVERRIDE_SETS)
from reina_tpu.core.engine import build_run
spec, out = json.loads(sys.argv[1]), sys.argv[2]
v = dict(VARIABLE_DEFAULTS)
if spec["set"]:
    v.update(copy.deepcopy(VARIABLE_OVERRIDE_SETS[spec["set"]]))
v.update(spec["vars"])
run = build_run(v)
leaves = {}
for part in ("arrays", "schedules", "init_state", "init_carry"):
    nt = getattr(run, part)
    for k in nt._fields:
        leaves[part + "." + k] = np.asarray(getattr(nt, k))
meta = dict(cfg=dataclasses.asdict(run.cfg), n_agents=run.n_agents,
            variant_names=list(run.variant_names),
            group_labels=list(run.group_labels), days=run.days)
np.savez(out, meta=json.dumps(meta), **leaves)
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(pkg_vars, override_set, extra):
    import copy
    v = dict(pkg_vars.VARIABLE_DEFAULTS)
    if override_set:
        v.update(copy.deepcopy(pkg_vars.VARIABLE_OVERRIDE_SETS[override_set]))
    v.update(extra)
    return v


def _eq(want, got, name):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (name, want.shape, got.shape)
    assert want.dtype == got.dtype, (name, want.dtype, got.dtype)
    np.testing.assert_array_equal(want, got, err_msg=name)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_build_run_matches_jax(config, tmp_path):
    """The whole build of the configuration, leaf by leaf, against the
    JAX package's built in a child interpreter."""
    from reina_tpu_torch.config import variables as pvars
    from reina_tpu_torch.core.engine import build_run
    override_set, extra, agents = CONFIGS[config]
    out = str(tmp_path / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    spec = json.dumps({"set": override_set, "vars": extra})
    r = subprocess.run([sys.executable, "-c", _CHILD, spec, out], cwd=_REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(out)
    meta = json.loads(str(ref["meta"]))

    run = build_run(_variables(pvars, override_set, extra), "cpu")
    assert run.n_agents == meta["n_agents"] == agents
    assert run.init_state.age.shape[0] % 1024 == 0
    # the JAX package's config has its Pallas and mesh switches besides
    for k, v in dataclasses.asdict(run.cfg).items():
        assert meta["cfg"][k] == v, k
    assert (run.variant_names, run.group_labels, run.days) == \
        (meta["variant_names"], meta["group_labels"], meta["days"])
    for part in ("arrays", "schedules", "init_state"):
        for k, v in convert.to_numpy(getattr(run, part)).items():
            _eq(ref[f"{part}.{k}"], v, f"{part}.{k}")
    n_pad = run.init_state.age.shape[0]
    for k, v in convert.to_numpy(run.init_carry).items():
        want = ref["init_carry." + k]
        if k == "bkt_dst":
            _eq(want, v[:-1], k)
            assert v[-1] == n_pad
        elif k in ("day", "weekly_leftover"):
            np.testing.assert_array_equal(want, v, err_msg=k)
        else:
            _eq(want, v, "init_carry." + k)


def _scenario_schedules(pkg, scenario, days):
    """A package's schedules (and vaccination slots) for a session with
    the preset ``scenario`` applied, over ``days`` days."""
    from importlib import import_module
    pvars = import_module(pkg + ".config.variables")
    psc = import_module(pkg + ".config.scenarios")
    piv = import_module(pkg + ".config.interventions")
    params = import_module(pkg + ".core.params")
    schedule = import_module(pkg + ".core.schedule")
    with pvars.session_store() as store:
        psc.get_scenario(scenario).apply()
        v = store.copy_all()
        ivs = piv.get_active_interventions()
    _, names = params.compile_disease(params.create_disease_params(v),
                                      v["max_age"] + 1)
    return schedule.compile_schedules(ivs, v["start_date"], days,
                                      v["max_age"] + 1, names)


@pytest.mark.parametrize("scenario", ["default", "mitigation",
                                      "summer-boogie", "hammer-and-dance",
                                      "looser-restrictions-to-start-with"])
def test_preset_scenario_schedules_match_jax(scenario):
    """Each preset scenario's compiled schedules (365 days, the card's
    run) and vaccination slots equal the JAX package's; and they have the
    default scenario's shapes, so a build of a preset at HUS has the
    default build's graph-set key (core/graphs.py:set_key)."""
    from reina_tpu_torch.config import scenarios as psc
    assert scenario in [s.id for s in psc.SCENARIOS]
    sched, slots = _scenario_schedules("reina_tpu_torch", scenario, 365)
    jsched, jslots = _scenario_schedules("reina_tpu", scenario, 365)
    for k in sched._fields:
        _eq(getattr(jsched, k), getattr(sched, k), "schedules." + k)
    assert slots.count == jslots.count
    _eq(jslots.min_age, slots.min_age, "min_age")
    _eq(jslots.max_age, slots.max_age, "max_age")
    base, base_slots = _scenario_schedules("reina_tpu_torch", "default", 365)
    assert [x.shape for x in sched] == [x.shape for x in base]
    assert (scenario == "default") == all(
        np.array_equal(a, b) for a, b in zip(sched, base))
    assert max(slots.count, 1) == max(base_slots.count, 1)
