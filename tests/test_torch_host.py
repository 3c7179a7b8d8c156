"""The port's host compile (build_run) equals the JAX package's leaf by
leaf: model arrays, schedules, initial state and carry, config. Exact
(same numpy code, same seeds). Layout differences that the port makes
on purpose: no bf16 age one-hots, a spare drop slot after the bucket
table, ``day`` as a host int, ``weekly_leftover`` on the host."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from reina_tpu.core import params as jparams
from reina_tpu.core import schedule as jschedule
from reina_tpu.core import state as jstate
from reina_tpu.testing import build_synthetic_run as jax_build
from reina_tpu_torch import convert
from reina_tpu_torch.core import params, schedule, state
from reina_tpu_torch.testing import build_synthetic_run

torch.set_num_threads(1)

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


def _eq(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n_agents,seed,pad", [(20000, 3, 1024),
                                               (5000, 8, 256)])
def test_build_run_matches_jax(n_agents, seed, pad):
    ref = jax_build(n_agents=n_agents, days=25, seed=seed,
                    interventions=IVS, pad_multiple=pad)
    run = build_synthetic_run("cpu", n_agents=n_agents, days=25, seed=seed,
                              interventions=IVS, pad_multiple=pad)
    assert run.device == torch.device("cpu")
    for f in dataclasses.fields(run.cfg):
        assert getattr(run.cfg, f.name) == getattr(ref.cfg, f.name), f.name
    for k, v in convert.to_numpy(run.arrays).items():
        _eq(getattr(ref.arrays, k), v, "arrays." + k)
    for k, v in convert.to_numpy(run.schedules).items():
        _eq(getattr(ref.schedules, k), v, "schedules." + k)
    for k, v in convert.to_numpy(run.init_state).items():
        _eq(getattr(ref.init_state, k), v, "state." + k)
    carry = convert.to_numpy(run.init_carry)
    jc = jax.tree.map(np.asarray, ref.init_carry)
    for k, v in carry.items():
        want = getattr(jc, k)
        if k == "bkt_dst":
            _eq(want, v[:-1], k)
            assert v[-1] == want.shape[0] // ref.cfg.max_infectees
        elif k in ("day", "weekly_leftover"):
            np.testing.assert_array_equal(want, v, err_msg=k)
        else:
            _eq(want, v, "carry." + k)
    assert (run.n_agents, run.variant_names, run.group_labels) == \
        (ref.n_agents, ref.variant_names, ref.group_labels)


def test_host_modules_carried_over():
    """The numpy host compile is the JAX package's, close to verbatim:
    same functions, same results on the default variables."""
    from reina_tpu.config.variables import VARIABLE_DEFAULTS
    v = dict(VARIABLE_DEFAULTS)
    dp, jdp = (params.create_disease_params(v),
               jparams.create_disease_params(v))
    assert dp == jdp
    d, names = params.compile_disease(dp, 101)
    jd, jnames = jparams.compile_disease(jdp, 101)
    assert names == jnames
    for k in d._fields:
        _eq(getattr(jd, k), getattr(d, k), k)
    counts = np.arange(101) * 3 + 5
    band = np.minimum(np.arange(101) // 10, 8)
    p = params.compile_population(counts, band, 1024)
    jp = jparams.compile_population(counts, band, 1024)
    for k in p._fields:
        if isinstance(getattr(p, k), np.ndarray):
            _eq(getattr(jp, k), getattr(p, k), k)
    from reina_tpu.config.interventions import get_active_interventions
    ivs = get_active_interventions(v)
    s, slots = schedule.compile_schedules(ivs, v["start_date"], 60, 101,
                                          names)
    js, jslots = jschedule.compile_schedules(ivs, v["start_date"], 60, 101,
                                             names)
    for k in s._fields:
        _eq(getattr(js, k), getattr(s, k), k)
    assert slots.count == jslots.count
    out = state.initial_all_detected(37, np.arange(101) // 10, 11, 101)
    _eq(jstate.initial_all_detected(37, np.arange(101) // 10, 11, 101),
        out, "all_detected")
