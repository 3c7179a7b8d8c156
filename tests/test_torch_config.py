"""The port's copies of the JAX package's configuration, data and
serving modules (reina_tpu_torch/{config,data,utils/locale}, the GraphQL
SDL, the web UI's page) equal the originals.

Exact throughout: the variable defaults, the resolved intervention
lists (as ``[type, date, *params]`` tuples) for the defaults, for every
scenario the defaults list and for every preset scenario applied to a
session, the three loaders' outputs for HUS, the archives byte for
byte, the metric registry field by field, the SDL string, and app.html
byte for byte.
"""
import filecmp
import os

import numpy as np
import pytest

from reina_tpu.config import interventions as jiv
from reina_tpu.config import scenarios as jsc
from reina_tpu.config import variables as jvars
from reina_tpu.data import loaders as jloaders
from reina_tpu_torch.config import interventions as piv
from reina_tpu_torch.config import scenarios as psc
from reina_tpu_torch.config import variables as pvars
from reina_tpu_torch.data import loaders as ploaders

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tuples(ivs):
    return [tuple(iv.make_iv_tuple()) for iv in ivs]


def test_variable_defaults_equal():
    assert pvars.VARIABLE_DEFAULTS == jvars.VARIABLE_DEFAULTS
    assert pvars.DEFAULT_VARIABLE_HASH == jvars.DEFAULT_VARIABLE_HASH


def test_active_interventions_equal():
    v = dict(jvars.VARIABLE_DEFAULTS)
    assert _tuples(piv.get_active_interventions(v)) == \
        _tuples(jiv.get_active_interventions(v))
    for s in v["scenarios"]:
        vs = dict(v, active_scenario=s["id"])
        assert _tuples(piv.get_active_interventions(vs)) == \
            _tuples(jiv.get_active_interventions(vs)), s["id"]


@pytest.mark.parametrize("scenario", [s.id for s in jsc.SCENARIOS])
def test_preset_scenario_interventions_equal(scenario):
    with jvars.session_store():
        jsc.get_scenario(scenario).apply()
        want = _tuples(jiv.get_active_interventions())
    with pvars.session_store():
        psc.get_scenario(scenario).apply()
        got = _tuples(piv.get_active_interventions())
    assert got == want
    assert [s.id for s in psc.SCENARIOS] == [s.id for s in jsc.SCENARIOS]


def test_loaders_equal_for_hus():
    np.testing.assert_array_equal(ploaders.get_population_for_area("HUS"),
                                  jloaders.get_population_for_area("HUS"))
    pc, jc = ploaders.get_contact_tensor(), jloaders.get_contact_tensor()
    for k in ("values", "band_lo", "band_hi"):
        a, b = getattr(pc, k), getattr(jc, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(pc.per_year_participant(),
                                  jc.per_year_participant())
    v = jvars.VARIABLE_DEFAULTS
    args = ("HUS", v["start_date"])
    kw = dict(incubating=v["incubating_at_simulation_start"],
              ill=v["ill_at_simulation_start"],
              recovered=v["recovered_at_simulation_start"])
    assert (ploaders.get_initial_population_condition(*args, **kw).__dict__
            == jloaders.get_initial_population_condition(*args, **kw)
            .__dict__)
    assert ploaders.get_detected_cases("HUS") == \
        jloaders.get_detected_cases("HUS")


@pytest.mark.parametrize("name", ["population.npz", "contacts.npz",
                                  "cases.npz"])
def test_archives_byte_for_byte(name):
    a = os.path.join(_REPO, "reina_tpu_torch", "data", "files", name)
    b = os.path.join(_REPO, "reina_tpu", "data", "files", name)
    assert filecmp.cmp(a, b, shallow=False)


def test_metrics_equal():
    """METRICS and ALL_METRICS field by field (labels are source-language
    strings, translated at resolve time)."""
    import dataclasses

    from reina_tpu.config import metrics as jm
    from reina_tpu_torch.config import metrics as pm
    for name in ("METRICS", "ALL_METRICS"):
        assert ([dataclasses.asdict(m) for m in getattr(pm, name)]
                == [dataclasses.asdict(m) for m in getattr(jm, name)]), name
    assert pm.MOBILITY_PLACES == jm.MOBILITY_PLACES


def test_sdl_and_webui_equal():
    """The GraphQL type system and the web UI's page are the JAX
    package's: the SDL string equal, app.html byte for byte."""
    from reina_tpu.runtime.graphql.sdl import SDL as JSDL
    from reina_tpu_torch.runtime.graphql.sdl import SDL
    assert SDL == JSDL
    assert filecmp.cmp(os.path.join(_REPO, "reina_tpu_torch", "webui",
                                    "app.html"),
                       os.path.join(_REPO, "reina_tpu", "webui", "app.html"),
                       shallow=False)
