"""The port's serving path (reina_tpu_torch/runtime, reina_tpu_torch/webui)
on the CPU, against the JAX package's.

* GraphQL parity. One real port run (Alavieska, 12 days,
  ``simulate_individuals(device="cpu")``) and a synthetic 60-day output
  set (counts around the ≤ 20 denominator quirk, shuffled age-group
  labels) go, as the same outputs, through both packages'
  ``results_to_metrics``: the port's on its numpy columns and
  ``AgeGroupCube``, the JAX package's on the frames of its
  ``outputs_to_frames`` (which compiles no engine program). Integers
  and categories are equal; floats agree within 1e-12 relative (the
  port's rolling means sum each window on its own, pandas keeps a
  running sum, so the last bits may differ).
* Documents. Every document of tests/test_graphql_client_conformance.py
  and the 15 that tools/check_webui.py extracts from the web UI run
  against both SCHEMAs, in order, with equal sessions; runSimulation
  goes to one fake engine shared by both runners (so the run ids are
  equal) that publishes the real run's outputs in each package's form.
  The JSON is equal within the float tolerance above. The JAX package's
  explorer draws compile eagerly and belong in a child interpreter
  (tests/test_sampling.py:1-8), so here its ``sample_distribution``
  returns the port's draws as a pandas Series: these documents check
  the resolvers, and tests/test_torch_sampling.py holds the draws to the
  JAX package's own.
* Runtime: the cases of tests/test_runtime.py on the port with fake
  engines, and one real served run over HTTP whose all_infected equals
  ``simulate_individuals(device="cpu")`` of the same variables.
"""
import dataclasses
import io
import json
import os
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest

from reina_tpu_torch.runtime import cache, runner

_SMALL = {"area_name": "Alavieska", "simulation_days": 12}
REL_TOL = 1e-12


@pytest.fixture(autouse=True)
def fresh_cache():
    cache.init_backend("memory")
    yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The CPU runs here are ~10,000 tiny ops a day, which torch's
    intra-op threads only slow down."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(fn, variables=("random_seed",)):
    """Mark a fake simulate_individuals as a calcfunc (run identity)."""
    fn._calcfunc_variables = list(variables)
    fn._calcfunc_funcs = []
    fn._calcfunc_filedeps = []
    return fn


def _cols(start="2020-02-18", **values):
    n = len(next(iter(values.values())))
    return {"date": np.datetime64(start, "D") + np.arange(n),
            **{k: np.asarray(v) for k, v in values.items()}}


def _interrupted():
    from reina_tpu_torch.core.engine import ExecutionInterrupted
    return ExecutionInterrupted()


def _assert_json_close(a, b, path="$"):
    if isinstance(a, dict) and isinstance(b, dict):
        assert a.keys() == b.keys(), (path, a.keys() ^ b.keys())
        for k in a:
            _assert_json_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_json_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        assert a == b or abs(a - b) <= REL_TOL * max(abs(a), abs(b)), \
            (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


# --- one real port run and its two forms --------------------------------------

@pytest.fixture(scope="module")
def small_run():
    """The Alavieska run through ``simulate_individuals(device="cpu")``:
    (its compiled run, its stacked outputs as far as the frames read
    them, us_per_infected, the columns it returned)."""
    from reina_tpu_torch.core.step import GROUP_ROW, GROUPED_ATTRS
    from reina_tpu_torch.simulation import (BUILD_CACHE, EXPOSURES_ATTRS,
                                            STATE_ATTRS, simulate_individuals)
    from reina_tpu_torch.utils.memoize import resolved_variables

    cols, cube = simulate_individuals(variable_store=dict(_SMALL),
                                      device="cpu", skip_cache=True)
    run = BUILD_CACHE.get(resolved_variables(simulate_individuals,
                                             dict(_SMALL)), "cpu")
    days, _, G = cube.values.shape
    by_group = np.zeros((days, len(GROUPED_ATTRS), G), cube.values.dtype)
    for a, attr in enumerate(cube.attrs):
        by_group[:, GROUP_ROW[attr]] = cube.values[:, a]
    out = SimpleNamespace(
        by_group=by_group,
        exposures_by_place=np.stack([cols[n] for n in EXPOSURES_ATTRS], 1),
        infected_by_variant=np.stack(
            [cols["infected_by_variant_" + v] for v in run.variant_names], 1),
        **{a: cols[a] for a in STATE_ATTRS})
    assert days == _SMALL["simulation_days"]
    assert cols["all_infected"][-1] > 20   # past the denominator quirk
    return run, out, cols["us_per_infected"], cols


def _synthetic_outputs(days=60, seed=5):
    """Stacked outputs with the fields the frames read, random but
    epidemic-shaped: cumulative counts, deaths, and age-group labels in
    shuffled order."""
    from reina_tpu_torch.core.params import make_age_groups
    rng = np.random.default_rng(seed)
    labels = sorted(set(make_age_groups(100)))
    labels = [labels[i] for i in rng.permutation(len(labels))]
    G = len(labels)
    bg = rng.integers(0, 40, (days, 13, G)).astype(np.int32)
    bg[:, 3] = np.cumsum(rng.integers(0, 4, (days, G)), axis=0)  # all_infected
    bg[:, 2] = np.cumsum(rng.integers(0, 2, (days, G)), axis=0)  # all_detected
    bg[:, 8] = np.cumsum(rng.integers(0, 2, (days, G)), axis=0) // 3  # dead
    out = SimpleNamespace(
        by_group=bg,
        exposed_per_day=rng.integers(0, 900, days).astype(np.int32),
        available_hospital_beds=rng.integers(0, 50, days).astype(np.int32),
        available_icu_units=rng.integers(0, 9, days).astype(np.int32),
        total_icu_units=np.full(days, 9, np.int32),
        ct_cases_per_day=rng.integers(0, 30, days).astype(np.int32),
        r=rng.uniform(0.3, 3.1, days).astype(np.float32),
        mobility_limitation=rng.uniform(0, 0.4, days).astype(np.float32),
        exposures_by_place=rng.integers(0, 99, (days, 6)).astype(np.int32),
        infected_by_variant=rng.integers(0, 9, (days, 2)).astype(np.int32))
    run = SimpleNamespace(start_date="2020-02-18", group_labels=labels,
                          variant_names=["wild-type", "b117"])
    return run, out, rng.uniform(0, 9, days)


def _both_results(run, out, us, rows):
    """(JAX package's results, the port's) for the same outputs."""
    from reina_tpu import simulation as jsim
    from reina_tpu_torch.simulation import age_group_cube, daily_columns
    df, adf = jsim.outputs_to_frames(out, run, rows, us)
    cols = daily_columns(out, run.variant_names, run.start_date, rows, us)
    cube = age_group_cube(out, run.group_labels)
    return ({"total": df, "age_groups": adf, "by_variant": None},
            {"total": cols, "age_groups": cube, "by_variant": None})


@pytest.mark.parametrize("case", ["alavieska", "alavieska_partial",
                                  "synthetic"])
def test_results_to_metrics_parity(small_run, case):
    from reina_tpu.runtime.graphql.schema import \
        results_to_metrics as jax_metrics
    from reina_tpu_torch.runtime.graphql.schema import results_to_metrics

    if case == "synthetic":
        run, out, us = _synthetic_outputs()
        rows = len(us)
    else:
        run, out, us, _ = small_run
        rows = len(us)
    jres, pres = _both_results(run, out, us, rows)
    if case == "alavieska_partial":
        jres = {"total": jres["total"].iloc[:8], "age_groups": None}
        pres = {"total": {k: v[:8] for k, v in pres["total"].items()},
                "age_groups": None}
    jd, jm = jax_metrics(jres)
    pd_, pm = results_to_metrics(pres)
    assert pd_ == jd
    _assert_json_close([dataclasses.asdict(m) for m in pm],
                       [dataclasses.asdict(m) for m in jm])
    types = [m.type for m in pm]
    if case != "alavieska_partial":
        assert "vaccinated" in types
        vac = next(m for m in pm if m.type == "vaccinated")
        assert vac.categorized_int_values.categories == sorted(
            run.group_labels)
    if case == "synthetic":
        ifr = next(m for m in pm if m.type == "ifr").float_values
        assert any(v for v in ifr[6:]) and ifr[:6] == [None] * 6


# --- the documents, against both schemas --------------------------------------

SKIP_INCLUDE = """
query Events($withParams: Boolean!) {
  activeEvents {
    id
    parameters @include(if: $withParams) { id }
    date @skip(if: $withParams)
  }
}
"""
UI_VARS = {"id": "check-run", "d": 365, "v": 1.0, "a": 60, "m": 0,
           "e": {"type": "limit-mobility", "date": "2020-05-01",
                 "parameters": [{"id": "reduction", "value": 10}]}}


def _conformance_script():
    """(document, variables, operationName) of every document in
    tests/test_graphql_client_conformance.py, in its tests' order;
    "RUN" marks the run id of the last runSimulation."""
    import test_graphql_client_conformance as t
    event = {"date": "2020-12-01", "type": "LIMIT_MOBILITY", "parameters": [
        {"id": "reduction", "value": 50}, {"id": "min_age", "value": 7},
        {"id": "max_age", "value": 12}, {"id": "place", "choice": "school"}]}
    return [
        (t.GET_AVAILABLE_EVENTS, None, None),
        (t.ADD_EVENT, {"event": event}, None),
        (t.GET_ACTIVE_EVENTS, None, None),
        (t.DELETE_EVENT, {"eventId": "EVENT"}, None),
        (t.GET_ACTIVE_EVENTS, None, None),
        (t.RUN_SIMULATION, {"seed": 1234}, None),
        (t.GET_SIMULATION_RESULTS, {"runId": "RUN"}, None),
        (t.GET_SIMULATION_RESULTS, {"runId": "nope"}, None),
        (SKIP_INCLUDE, {"withParams": True}, None),
        (SKIP_INCLUDE, {"withParams": False}, None),
        (t.GET_SIMULATION_RESULTS, {}, None),
        (t.GET_AVAILABLE_EVENTS + t.GET_ACTIVE_EVENTS, None,
         "GetActiveEvents"),
    ]


def _webui_script():
    import os
    import re
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from check_webui import extract_documents
    docs = extract_documents()
    assert len(docs) == 15
    script = []
    for doc in docs:
        wanted = set(re.findall(r"\$([A-Za-z_]\w*)", doc))
        variables = {k: v for k, v in UI_VARS.items() if k in wanted}
        if "setParameter" in doc:
            variables.update(id="p_asymptomatic_infection", v=50.0)
        if "activateScenario" in doc:
            variables["id"] = "default"
        if "simulationResults" in doc:
            variables["id"] = "RUN"
        assert wanted <= set(variables), (wanted, doc[:80])
        script.append((doc, variables, None))
    return script


def _run_script(execute, schema, ctx, script):
    outs, run_id = [], None
    for doc, variables, op in script:
        variables = json.loads(json.dumps(variables))
        for k, v in (variables or {}).items():
            if v == "RUN":
                variables[k] = run_id
            elif v == "EVENT":
                variables[k] = next(e["id"] for e in outs[-1]["data"]
                                    ["activeEvents"]
                                    if e["date"] == "2020-12-01")
        deadline = time.time() + 30
        while True:
            out = execute(schema, doc, variables=variables,
                          operation_name=op, context=ctx)
            res = (out.get("data") or {}).get("simulationResults")
            if res is None or res.get("finished") or time.time() > deadline:
                break
            time.sleep(0.02)
        if "runSimulation" in doc and out.get("data"):
            run_id = out["data"]["runSimulation"]["runId"]
        outs.append(out)
    return outs


def test_documents_equal_on_both_schemas(small_run, monkeypatch):
    import pandas as pd

    import reina_tpu.sampling as jsampling
    from reina_tpu.config.variables import VariableStore as JStore
    from reina_tpu.core.engine import ExecutionInterrupted as JInterrupted
    from reina_tpu.runtime import cache as jcache
    from reina_tpu.runtime import runner as jrunner
    from reina_tpu.runtime.graphql.engine import execute as jexecute
    from reina_tpu.runtime.graphql.schema import SCHEMA as JSCHEMA
    from reina_tpu_torch.config.variables import VariableStore
    from reina_tpu_torch.runtime.graphql.engine import execute
    from reina_tpu_torch.runtime.graphql.schema import SCHEMA
    from reina_tpu_torch.sampling import sample_distribution

    run, out, us, _ = small_run
    jres, pres = _both_results(run, out, us, len(us))

    def served(step_callback=None, callback_day_interval=1,
               variable_store=None, device=None):
        if device is None:     # the JAX package's runner passes none
            df, adf = jres["total"], jres["age_groups"]
            if step_callback and not step_callback(df.iloc[:7]):
                raise JInterrupted()
            return df, adf
        assert device == "cpu"
        cols, cube = pres["total"], pres["age_groups"]
        if step_callback and not step_callback(
                {k: v[:7] for k, v in cols.items()}):
            raise _interrupted()
        return cols, cube

    def jax_draws(what, age, severity, variables):
        cats, counts = sample_distribution(what, age, severity, variables,
                                           "cpu")
        return pd.Series(counts, index=cats)

    _engine(served, ("random_seed", "area_name", "simulation_days"))
    monkeypatch.setattr(jrunner, "simulate_individuals", served)
    monkeypatch.setattr(runner, "simulate_individuals", served)
    monkeypatch.setattr(jsampling, "sample_distribution", jax_draws)
    jcache.init_backend("memory")

    script = _conformance_script() + _webui_script()
    want = _run_script(jexecute, JSCHEMA, {"store": JStore()}, script)
    got = _run_script(execute, SCHEMA,
                      {"store": VariableStore(), "device": "cpu"}, script)
    assert len(got) == len(want) == 27
    for (doc, _, _), g, w in zip(script, got, want):
        _assert_json_close(g, w, doc.strip()[:50])
    finished = [o["data"]["simulationResults"] for o in got
                if (o.get("data") or {}).get("simulationResults")]
    assert len(finished) == 2 and all(r["finished"] for r in finished)
    errors = [o["errors"][0]["message"] for o in got if o.get("errors")]
    assert len(errors) == 3, errors   # run "nope", a missing variable, and
    assert "No simulation run active" in errors[0]   # the UI's sample id
    assert "invalid intervention ID" in errors[2]    # for deleteEvent


# --- runtime: workers, registry, heartbeat ------------------------------------

def _streaming(step_callback=None, callback_day_interval=1,
               variable_store=None, device="cuda"):
    assert device == "cpu"
    cols = _cols(infected=[1, 2, 3])
    for i in range(3):
        if step_callback and not step_callback(
                {k: v[:i + 1] for k, v in cols.items()}):
            raise _interrupted()
        time.sleep(0.01)
    return cols, cols


def _failing(step_callback=None, callback_day_interval=1,
             variable_store=None, device="cuda"):
    raise RuntimeError("engine exploded")


@pytest.mark.parametrize("engine,error", [(_streaming, None),
                                          (_failing, "engine exploded")])
def test_worker_publishes(monkeypatch, engine, error):
    monkeypatch.setattr(runner, "simulate_individuals", _engine(engine))
    reg = runner.RunRegistry()
    run_id = reg.start_run({"random_seed": 1}, "cpu")
    t = reg.get(run_id)
    assert t is not None
    t.join(timeout=10)
    assert not t.is_alive()
    assert cache.get("%s-finished" % run_id) is True
    assert cache.get("%s-phase" % run_id) == "finished"
    if error:
        assert error in cache.get("%s-error" % run_id)
        return
    assert cache.get("%s-error" % run_id) is None
    res = cache.get("%s-results" % run_id)
    assert res is not None and len(res["total"]["infected"]) == 3
    assert res["age_groups"] is not None


def test_dedup_same_variables(monkeypatch):
    monkeypatch.setattr(runner, "simulate_individuals", _engine(_streaming))
    reg = runner.RunRegistry()
    r1 = reg.start_run({"random_seed": 7}, "cpu")
    live = reg.get(r1)
    r2 = reg.start_run({"random_seed": 7}, "cpu")
    assert r1 == r2  # deterministic run identity
    # the duplicate's thread never started — the LIVE thread stays
    # registered so reap()/cancel still reach it
    assert reg.get(r1) is live
    r3 = reg.start_run({"random_seed": 8}, "cpu")
    assert r3 != r1
    for r in (r1, r3):
        t = reg.get(r)
        if t is not None:
            t.join(timeout=10)


def test_admission_control(monkeypatch):
    gate = threading.Event()

    def slow(step_callback=None, callback_day_interval=1,
             variable_store=None, device="cuda"):
        gate.wait(timeout=5)
        return _cols(infected=[1]), None

    monkeypatch.setattr(runner, "simulate_individuals", _engine(slow))
    reg = runner.RunRegistry(max_runs=2)
    ids = [reg.start_run({"random_seed": 100}, "cpu"),
           reg.start_run({"random_seed": 101}, "cpu")]
    with pytest.raises(runner.BusyError):
        reg.start_run({"random_seed": 102}, "cpu")
    gate.set()
    for r in ids:
        reg.get(r).join(timeout=10)
        assert cache.get("%s-finished" % r) is True


def test_heartbeat_outlives_ttl(monkeypatch):
    """The worker refreshes ``-finished``/``-results`` while the engine
    cannot publish (build_run, the first kernel build), so a TTL shorter
    than that stall does not end the run for its clients."""
    monkeypatch.setattr(runner, "HEARTBEAT_S", 0.05)
    gate = threading.Event()

    def stuck(step_callback=None, callback_day_interval=1,
              variable_store=None, device="cuda"):
        cols = _cols(infected=[1])
        step_callback(cols)        # one early partial publish
        gate.wait(timeout=10)      # then a stall longer than the TTL
        return cols, cols

    monkeypatch.setattr(runner, "simulate_individuals", _engine(stuck))
    t = runner.SimulationThread({"random_seed": 99}, "cpu")
    t.cache_expiration = 0.2   # TTL ≪ the stall below
    t.start()
    run_id = t.cache_key
    time.sleep(0.6)  # ≫ TTL: without the heartbeat both keys expire
    assert cache.get("%s-finished" % run_id) is False
    assert cache.get("%s-phase" % run_id) == "running"
    assert cache.get("%s-results" % run_id) is not None
    gate.set()
    t.join(timeout=10)
    assert cache.get("%s-finished" % run_id) is True


def test_scratch_is_one_tensor_under_concurrent_first_use():
    """Threads that ask for a histogram scratch at once share one
    (ops/fusedmap._scratch; the serving workers are threads)."""
    from reina_tpu_torch.ops import fusedmap
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for trial in range(20):
            got, start = [], threading.Barrier(32)

            def ask():
                start.wait(timeout=10)
                got.append(fusedmap._scratch("cpu", f"stress{trial}", 64))

            threads = [threading.Thread(target=ask) for _ in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
                assert not t.is_alive()
            assert len(got) == 32 and all(g is got[0] for g in got)
            del fusedmap._SCRATCH[("cpu", f"stress{trial}", 64)]
    finally:
        sys.setswitchinterval(old)


# --- HTTP ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    from reina_tpu_torch.runtime.graphql.server import serve
    httpd = serve(host="127.0.0.1", port=0, background=True, device="cpu")
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _post(url, doc, variables=None, cookie=None):
    body = json.dumps({"query": doc, "variables": variables}).encode()
    headers = {"Content-Type": "application/json"}
    if cookie:
        headers["Cookie"] = cookie
    req = urllib.request.Request(url + "/graphql", data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return (json.loads(resp.read()),
                resp.headers.get("Set-Cookie", "").split(";")[0])


def test_serve_needs_a_card_unless_asked_for_the_cpu():
    import torch

    from reina_tpu_torch.runtime.graphql.server import serve
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(host="127.0.0.1", port=0, background=True)


@pytest.mark.parametrize("path,origin", [("/graphql", None),
                                         ("/healthz", "https://evil.example"),
                                         ("/", None)])
def test_http_endpoints(server, path, origin):
    """The GraphQL round trip sets the session cookie; an unlisted origin
    gets '*' without credentials; / serves the web UI's page."""
    if path == "/graphql":
        out, cookie = _post(server, "{ area { name totalPopulation } }")
        assert out["data"]["area"]["name"] == "HUS"
        assert cookie.startswith("reina_session=")
        return
    req = urllib.request.Request(server + path,
                                 headers={"Origin": origin} if origin else {})
    with urllib.request.urlopen(req, timeout=10) as resp:
        body = resp.read()
        if origin:
            assert resp.headers["Access-Control-Allow-Origin"] == "*"
            assert resp.headers.get("Access-Control-Allow-Credentials") \
                is None
        else:
            from reina_tpu_torch.webui import app_html
            assert body == app_html()


def _sheet(data):
    z = zipfile.ZipFile(io.BytesIO(data))
    return {n: z.read(n) for n in z.namelist()}


def test_xlsx_export_equals_the_reference_workbook(server, small_run):
    """/export.xlsx of a run serves the JAX package's workbook for the
    same outputs: every part of the zip byte for byte (the zip's own
    timestamps aside), the header and 12 days; unknown runs 404."""
    from xml.etree import ElementTree

    from reina_tpu.runtime import cache as jcache
    from reina_tpu.runtime.graphql.server import serve as jserve

    run, out, us, _ = small_run
    jres, pres = _both_results(run, out, us, len(us))
    cache.set("xlsxtest-results", pres)
    jcache.init_backend("memory")
    jcache.set("xlsxtest-results", jres)
    jhttpd = jserve(host="127.0.0.1", port=0, background=True)
    try:
        parts = []
        for base in (server, f"http://127.0.0.1:{jhttpd.server_address[1]}"):
            with urllib.request.urlopen(base + "/export.xlsx?run=xlsxtest",
                                        timeout=10) as resp:
                assert "spreadsheetml" in resp.headers["Content-Type"]
                parts.append(_sheet(resp.read()))
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
    assert parts[0] == parts[1]
    ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    sheet = ElementTree.fromstring(parts[0]["xl/worksheets/sheet1.xml"])
    rows = sheet.findall(f"{ns}sheetData/{ns}row")
    assert len(rows) == 1 + 12
    assert rows[1].findall(f"{ns}c")[0].find(f"{ns}is/{ns}t").text \
        == "2020-02-18"
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/export.xlsx?run=nope", timeout=10)
    assert e.value.code == 404


def test_webui_run_poll_protocol(server, monkeypatch):
    """The web UI's run→poll loop (its runSimulation and poll documents,
    every 0.25 s until finished) over HTTP with a fast fake engine:
    phases, growing partial results, and every metric the chart
    render() picks."""
    days = 60

    def fake(step_callback=None, callback_day_interval=1,
             variable_store=None, device="cuda"):
        t = np.arange(days, dtype=float)
        inf = 4000.0 * np.exp(-0.5 * ((t - 35.0) / 10.0) ** 2)
        cols = _cols(
            susceptible=1.66e6 - np.cumsum(inf), infected=inf,
            all_infected=np.cumsum(inf), detected=inf * 0.3,
            all_detected=np.cumsum(inf * 0.3), in_ward=inf * 0.05,
            in_icu=inf * 0.01, dead=np.cumsum(inf) * 0.005,
            recovered=np.cumsum(inf) * 0.9, new_infections=inf,
            available_hospital_beds=2600 - inf * 0.05,
            available_icu_units=300 - inf * 0.01,
            total_icu_units=np.full(days, 300.0), r=1.2 - 0.01 * t,
            mobility_limitation=np.clip(t / 100, 0, 0.3),
            us_per_infected=np.full(days, 4.0))
        for k in range(3):
            rows = (k + 1) * days // 3
            if step_callback and not step_callback(
                    {c: v[:rows] for c, v in cols.items()}):
                raise _interrupted()
            time.sleep(0.2)
        return cols, None

    monkeypatch.setattr(runner, "simulate_individuals", _engine(
        fake, ("random_seed", "area_name", "simulation_days")))
    out, cookie = _post(server, "mutation { runSimulation { runId } }")
    run_id = out["data"]["runSimulation"]["runId"]
    poll = ("query($id: ID!){ simulationResults(runId:$id) { finished "
            "phase predictedMetrics { dates metrics { type intValues "
            "floatValues } } } }")
    phases, lengths = [], []
    deadline = time.time() + 30
    while time.time() < deadline:
        out, cookie = _post(server, poll, {"id": run_id}, cookie)
        assert not out.get("errors"), out["errors"]
        res = out["data"]["simulationResults"]
        phases.append(res["phase"])
        lengths.append(len(res["predictedMetrics"]["dates"]))
        if res["finished"]:
            break
        time.sleep(0.25)
    assert phases[-1] == "finished"
    assert set(phases) <= {"compiling", "running", "finished"}
    assert lengths[-1] == days and lengths == sorted(lengths)
    types = {m["type"] for m in res["predictedMetrics"]["metrics"]}
    assert {"infected", "recovered", "dead", "all_detected", "r", "ifr",
            "cfr", "in_ward", "in_icu", "available_hospital_beds",
            "available_icu_units"} <= types


def test_served_run_equals_simulate_individuals(server, small_run):
    """A real run through the server (runSimulation, then the web UI's
    poll document over HTTP) on the port's engine on the CPU: streamed,
    finished, and its all_infected equal to simulate_individuals of the
    same variables."""
    from reina_tpu_torch.config.variables import VariableStore
    from reina_tpu_torch.runtime.graphql.server import dump_session
    from reina_tpu_torch.utils import memoize
    from reina_tpu_torch.utils.perf import STATS

    memoize.clear_cache()   # a fresh run, not the memoized result
    _, _, _, cols = small_run
    cookie = "reina_session=" + dump_session(VariableStore(dict(_SMALL)))
    before = dict(STATS.items())
    out, cookie = _post(server, "mutation { runSimulation { runId } }",
                        cookie=cookie)
    run_id = out["data"]["runSimulation"]["runId"]
    poll = ("query($id: ID!){ simulationResults(runId:$id) { finished "
            "phase predictedMetrics { dates metrics { type intValues "
            "floatValues } } } }")
    deadline = time.time() + 120
    while time.time() < deadline:
        out, cookie = _post(server, poll, {"id": run_id}, cookie)
        assert not out.get("errors"), out["errors"]
        res = out["data"]["simulationResults"]
        if res["finished"]:
            break
        time.sleep(0.1)
    assert res["finished"] and res["phase"] == "finished"
    # the served run took its build from the cache (a hit, maybe
    # reseeded), on its worker thread: no build
    assert STATS["build.misses"] == before.get("build.misses", 0)
    assert STATS["build.hits"] > before.get("build.hits", 0)
    m = {x["type"]: x for x in res["predictedMetrics"]["metrics"]}
    assert len(res["predictedMetrics"]["dates"]) == 12
    assert m["all_infected"]["intValues"] == cols["all_infected"].tolist()
    assert m["susceptible"]["intValues"] == cols["susceptible"].tolist()


# --- the native shared-memory cache -------------------------------------------

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ compiler to build cpp/shmcache")


def _shm_name(tag):
    """A segment name of this process and call alone: POSIX shared
    memory is one namespace for every checkout on the host, so two test
    runs at once must never open (or unlink) each other's."""
    return f"reina-torch-pytest-{tag}-{os.getpid()}-{uuid.uuid4().hex[:8]}"


@needs_gxx
def test_shm_cache_backend():
    """TTLs, cross-handle visibility, arena compaction."""
    from reina_tpu_torch.runtime.shm import ShmKV
    name = _shm_name("kv")
    try:
        kv = ShmKV(name, 1 << 20)
        kv.set(b"a", b"hello", ttl=60)
        kv2 = ShmKV(name, 1 << 20)
        assert kv2.get(b"a") == b"hello"
        kv.set(b"t", b"x", ttl=0.01)
        time.sleep(0.05)
        assert kv.get(b"t") is None
        # an expired bulk entry is compacted away under arena pressure
        kv.set(b"big", b"z" * 100000, ttl=0.001)
        time.sleep(0.01)
        for i in range(30):
            kv.set(b"k%d" % i, b"v" * 20000)
        assert kv.get(b"k0") == b"v" * 20000
        assert kv.get(b"a") == b"hello"
        kv2.close()
        kv.close()
    finally:
        ShmKV.unlink(name)


@needs_gxx
def test_shm_cache_delete_and_compaction_integrity():
    """Deletes keep probe chains alive (tombstones) and compaction
    repacks in ascending offset order: every survivor stays readable."""
    from reina_tpu_torch.runtime.shm import ShmKV
    name = _shm_name("cc")
    try:
        kv = ShmKV(name, 1 << 18)
        vals = {}
        for i in range(120):
            k = b"key-%03d" % i
            vals[k] = (b"%03d" % i) * (7 + i % 23)
            kv.set(k, vals[k])
            if i % 3 == 0 and i > 0:
                dk = b"key-%03d" % (i - 1)
                kv.delete(dk)
                del vals[dk]
        for k, v in vals.items():
            assert kv.get(k) == v, k
        for rnd in range(6):
            for i in range(0, 120, 5):
                k = b"key-%03d" % i
                if k in vals:
                    vals[k] = bytes([65 + rnd]) * (50 + 37 * i % 1500)
                    kv.set(k, vals[k])
            kv.set(b"filler-%d" % rnd, b"f" * 60000, ttl=0.001)
            time.sleep(0.01)
            kv.set(b"press-%d" % rnd, b"p" * 60000, ttl=0.001)
            for k, v in vals.items():
                assert kv.get(k) == v, (rnd, k)
        kv.close()
    finally:
        ShmKV.unlink(name)


@needs_gxx
def test_shm_cache_interface(small_run):
    """ShmCache pickles the published numpy results through the native
    store and gives them back equal."""
    from reina_tpu_torch.runtime.cache import ShmCache
    from reina_tpu_torch.runtime.shm import ShmKV
    name = _shm_name("cache")
    try:
        c = ShmCache(name, capacity_mb=8)
        run, out, us, cols = small_run
        _, pres = _both_results(run, out, us, len(us))
        c.set("run1-results", pres, timeout=30)
        back = c.get("run1-results")
        assert back["total"].keys() == cols.keys()
        for k in cols:
            np.testing.assert_array_equal(back["total"][k],
                                          pres["total"][k])
        np.testing.assert_array_equal(back["age_groups"].values,
                                      pres["age_groups"].values)
        assert c.get("missing") is None
        c.delete("run1-results")
        assert c.get("run1-results") is None
    finally:
        ShmKV.unlink(name)
