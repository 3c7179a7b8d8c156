"""The port's day step and run loop against the JAX engine.

The JAX reference compiles its whole-engine day program, which is
compile-fragile on XLA:CPU inside a long test process (tests/
_isolation.py), so the comparisons run once in a fresh child
interpreter launched by the fixture below (``python
tests/test_torch_step.py OUT``); the tests read its report. One
``run_chunk`` program (chunk_len=1) is compiled and reused for every
day and seed.

Setting: the synthetic run with tests/conftest.py's calendar (testing,
imports, weekly imports, mobility limits, masks, contact tracing,
vaccination, capacity builds), 20,000 agents padded to a multiple of
1024 — the padding the HUS run has, so ``fused_concat_prefix`` takes
its blockwise branch in both packages.

Checks and tolerances:
  * one day, field by field, from the same converted state and keys,
    on seven days that cover imports, vaccination, testing and contact
    tracing: integer and bool fields of the state, the carry and the
    outputs are equal; float fields lie within 8 ulp (``o2r`` carries
    the gamma draws' normal ulps through a cube; 5 ulp seen). No field
    needs the 0.1%-of-agents allowance for near-threshold flips on
    these days.
  * one day on an agent axis of two: the JAX package's
    ``run_days(mesh=make_mesh(1, 2))`` (two virtual CPU devices, its
    shard_map islands) against the port's graphed agent axis (the graph
    runner's CPU model on two ranks spawned over gloo) from the same
    converted build and keys: the outputs, the gathered state and carry
    with the same tolerances (integer and bool exact, floats within 8
    ulp).
  * 24 days in distribution over 8 seeds: each day's mean of
    all_infected and detected agrees within 4 combined standard errors.
  * the port runs, checkpoints, resumes, serves its CLI (simulate,
    sample and monte-carlo), answers GraphQL queries, and runs its
    ensembles, calibration, SIR model and debug dumps with jax, the JAX
    package and pandas made unimportable.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
N_AGENTS = 20000
DAYS = 25
CHECK_DAYS = (0, 2, 5, 12, 16, 17, 23)
SEEDS = range(40, 48)
MAX_ULP = 8
FLIP_ALLOWANCE = 0.001    # share of agents, for fields named in FLIP_FIELDS
FLIP_FIELDS = ()          # none needed on CHECK_DAYS


def _rows(d, pairs):
    """The report rows of (name, JAX value, port value) pairs."""
    rows = []
    for name, a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        if name == "carry.bkt_dst":
            b = b[:-1]
        row = {"day": d, "field": name, "shape_ok": a.shape == b.shape,
               "n": int(a.size), "mismatch": 0, "ulp": 0}
        if row["shape_ok"]:
            if a.dtype == np.float32:
                ulp = np.abs(a.view(np.int32).astype(np.int64)
                             - b.astype(np.float32).view(np.int32))
                row["ulp"] = int(ulp.max()) if ulp.size else 0
            else:
                row["mismatch"] = int((a != b.astype(a.dtype)).sum())
        rows.append(row)
    return rows


def _mesh_rank(rank, work):
    """One port rank of the agent axis of two: the graphed run (the
    graph runner's CPU model) of one day from the JAX build in
    ``work``/build.pkl; its rows and slab into ``work``."""
    from dataclasses import replace
    import torch
    torch.set_num_threads(1)
    from reina_tpu_torch import convert
    from reina_tpu_torch.core import step as S
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.parallel import mesh as M
    from reina_tpu_torch.testing import build_synthetic_run
    with open(os.path.join(work, "build.pkl"), "rb") as f:
        b = pickle.load(f)
    run = build_synthetic_run("cpu", n_agents=N_AGENTS, days=DAYS, seed=3,
                              interventions=IVS)
    run = replace(run, cfg=S.EngineConfig(**b["cfg"]),
                  arrays=convert.model_arrays(b["arrays"], "cpu"),
                  schedules=convert.schedules(b["schedules"], "cpu"),
                  init_state=convert.agent_state(b["state"], "cpu"),
                  init_carry=convert.day_carry(b["carry"], "cpu"),
                  random_seed=b["seed"])
    M.init_distributed(f"file://{work}/store", 2, rank, backend="gloo")
    out, st, cr, _ = run_days(run, n_days=2, graphs=True,
                              mesh=M.make_mesh(1, 2, device="cpu"))
    np.savez(os.path.join(work, f"rank_{rank}.npz"),
             **{"out__" + k: np.asarray(v) for k, v in zip(out._fields,
                                                          out)},
             **{"st__" + k: v for k, v in convert.to_numpy(st).items()},
             **{"cr__" + k: v for k, v in convert.to_numpy(cr).items()})
    torch.distributed.destroy_process_group()


def _mesh_day(ref, np_tree, work):
    """The JAX package's agent axis of two for one day against the
    port's (two spawned ranks); returns the report rows."""
    import jax
    from reina_tpu.core.engine import run_days as jax_run_days
    from reina_tpu.parallel.mesh import make_mesh
    from reina_tpu_torch.core import step as S
    b = {"cfg": {k: getattr(ref.cfg, k)
                 for k in S.EngineConfig.__dataclass_fields__},
         "seed": int(ref.random_seed)}
    for name, tree in (("arrays", ref.arrays), ("schedules", ref.schedules),
                       ("state", ref.init_state), ("carry", ref.init_carry)):
        b[name] = {k: np.asarray(v) for k, v in np_tree(tree)._asdict()
                   .items()}
    with open(os.path.join(work, "build.pkl"), "wb") as f:
        pickle.dump(b, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         work], cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    mesh = make_mesh(1, 2, devices=jax.devices()[:2])
    jo, js, jc, _ = jax_run_days(ref, n_days=2, chunk_days=1, mesh=mesh)
    js, jc = np_tree(js), np_tree(jc)
    for p in procs:
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log[-3000:]
    z = [np.load(os.path.join(work, f"rank_{r}.npz")) for r in range(2)]
    n = ref.init_state.age.shape[0]

    def whole(pre, k):
        a = [x[pre + k] for x in z]
        if k == "bkt_dst":                  # each slab's spare slot
            return np.concatenate([x[:-1] for x in a] + [a[0][-1:]])
        if a[0].ndim and 2 * a[0].shape[0] == n:
            return np.concatenate(a)
        return a[0]
    pairs = ([("state." + k, getattr(js, k), whole("st__", k))
              for k in js._fields]
             + [("carry." + k, getattr(jc, k), whole("cr__", k))
                for k in jc._fields
                if "cr__" + k in z[0] and k not in ("mob", "nc_ag")]
             + [("out." + k, getattr(jo, k), z[r]["out__" + k])
                for k in jo._fields for r in range(2)])
    return _rows("mesh", pairs)


def _child(out_path):
    """Run every comparison; write a JSON report."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from reina_tpu.utils.compile import enable_persistent_cache
    enable_persistent_cache()
    import jax.random as jr
    import torch
    torch.set_num_threads(1)
    from reina_tpu.core.engine import run_chunk as jax_run_chunk
    from reina_tpu.testing import build_synthetic_run as jax_build
    from reina_tpu_torch import convert
    from reina_tpu_torch.core import step as S
    from reina_tpu_torch.core.engine import run_days, sched_row
    from reina_tpu_torch.core.schedule import Schedules
    from reina_tpu_torch.ops import prng
    from reina_tpu_torch.testing import build_synthetic_run

    report = {"one_day": [], "dist": {}}

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    # ---- one day, field by field
    ref = jax_build(n_agents=N_AGENTS, days=DAYS, seed=3, interventions=IVS,
                    pad_multiple=1024)
    arrays = convert.model_arrays(np_tree(ref.arrays), "cpu")
    sched = convert.schedules(np_tree(ref.schedules), "cpu")
    host = Schedules(*(np.asarray(x) for x in ref.schedules))
    cfg = S.EngineConfig(**{k: getattr(ref.cfg, k)
                            for k in S.EngineConfig.__dataclass_fields__})
    key = jr.PRNGKey(ref.random_seed)
    state, carry = ref.init_state, ref.init_carry
    n = state.age.shape[0]
    for d in range(max(CHECK_DAYS) + 1):
        st_t = convert.agent_state(np_tree(state), "cpu")
        cr_t = convert.day_carry(np_tree(carry), "cpu")
        state, carry, outs = jax_run_chunk(ref.cfg, ref.arrays,
                                           ref.schedules, state, carry,
                                           key, 1, d)
        if d not in CHECK_DAYS:
            continue
        dk = S.derive_day_keys(cfg, prng.PRNGKey(ref.random_seed),
                               [d]).day(0)
        ps, pc, po = S.day_step(cfg, arrays, sched_row(sched, host, d),
                                st_t, cr_t, dk)
        js, jc = np_tree(state), np_tree(carry)
        jo = jax.tree.map(lambda x: np.asarray(x)[0], outs)
        pairs = ([("state." + k, getattr(js, k), v)
                  for k, v in convert.to_numpy(ps).items()]
                 + [("carry." + k, getattr(jc, k), v)
                    for k, v in convert.to_numpy(pc).items()
                    if k not in ("mob", "nc_ag")]
                 + [("out." + k, getattr(jo, k), v)
                    for k, v in convert.to_numpy(po).items()])
        report["one_day"] += _rows(d, pairs)
    report["one_day_agents"] = int(n)
    work = os.path.join(os.path.dirname(out_path), "mesh")
    os.makedirs(work, exist_ok=True)
    report["mesh_day"] = _mesh_day(ref, np_tree, work)

    # ---- 24 days in distribution
    for s in SEEDS:
        r = jax_build(n_agents=N_AGENTS, days=DAYS, seed=s,
                      interventions=IVS, pad_multiple=1024)
        st, cr = r.init_state, r.init_carry
        k = jr.PRNGKey(s)
        ai, de = [], []
        for d in range(DAYS - 1):
            st, cr, o = jax_run_chunk(r.cfg, r.arrays, r.schedules, st, cr,
                                      k, 1, d)
            bg = np.asarray(o.by_group)[0]
            ai.append(int(bg[S.GROUP_ROW["all_infected"]].sum()))
            de.append(int(bg[S.GROUP_ROW["detected"]].sum()))
        assert int(cr.problem) == 0
        run = build_synthetic_run("cpu", n_agents=N_AGENTS, days=DAYS,
                                  seed=s, interventions=IVS)
        out, _, _, _ = run_days(run, chunk_days=8)
        report["dist"][str(s)] = {
            "jax_all_infected": ai, "jax_detected": de,
            "port_all_infected": out.by_group[1:, 3].sum(1).tolist(),
            "port_detected": out.by_group[1:, 4].sum(1).tolist()}
    with open(out_path, "w") as f:
        json.dump(report, f)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_step") / "report.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                       cwd=_REPO, env=env, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, (
        f"comparison child failed (rc={r.returncode}):\n"
        f"{r.stdout[-3000:]}\n{r.stderr[-4000:]}")
    with open(out) as f:
        return json.load(f)


def test_one_day_field_by_field(report):
    rows = report["one_day"]
    assert {r["day"] for r in rows} == set(CHECK_DAYS)
    n_agents = report["one_day_agents"]
    for r in rows:
        assert r["shape_ok"], r
        assert r["ulp"] <= MAX_ULP, r
        if r["field"] in FLIP_FIELDS:
            assert r["mismatch"] <= FLIP_ALLOWANCE * n_agents, r
        else:
            assert r["mismatch"] == 0, r


def test_mesh_day_against_jax(report):
    """One day of the agent axis of two: the JAX package's sharded run
    against the port's graphed agent axis, field by field (outputs of
    both ranks, the gathered state and carry)."""
    rows = report["mesh_day"]
    fields = {r["field"] for r in rows}
    assert "state.infector" in fields and "out.by_group" in fields
    assert "carry.bkt_dst" in fields
    for r in rows:
        assert r["shape_ok"], r
        assert r["ulp"] <= MAX_ULP, r
        assert r["mismatch"] == 0, r


def test_24_days_in_distribution(report):
    dist = report["dist"]
    assert len(dist) == len(SEEDS)
    for metric in ("all_infected", "detected"):
        j = np.array([dist[s]["jax_" + metric] for s in dist], float)
        p = np.array([dist[s]["port_" + metric] for s in dist], float)
        assert j.shape == p.shape == (len(SEEDS), DAYS - 1)
        se = np.hypot(j.std(axis=0, ddof=1), p.std(axis=0, ddof=1)) \
            / np.sqrt(len(SEEDS))
        diff = np.abs(j.mean(axis=0) - p.mean(axis=0))
        assert (diff <= 4 * se + 1e-9).all(), (metric, diff, se)
    # the epidemic actually grew, so the comparison is not vacuous
    assert np.mean([dist[s]["port_all_infected"][-1] for s in dist]) > 200


def test_runs_without_jax(tmp_path):
    """With jax, the JAX package and pandas all unimportable, the port
    builds and runs a synthetic run with a checkpoint, resumes from it,
    runs it through the day-graph model (and a second build of its shapes
    on the same graph set, and the model on an agent shard of a mesh of
    one rank, with the sharded emit's fold), makes the fused tier picks'
    CPU form, imports the conditional-node, gate and NCCL-capture probes
    and the seed-spread tools,
    its CLI simulates a small area and samples the explorer on the CPU,
    its GraphQL server answers an area and an explorer query, and it
    runs an ensemble (also on a mesh of one rank over torch.distributed),
    a calibration, the SIR model, the debug dumps and a Monte-Carlo
    sweep that writes its CSV (also through the CLI)."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "sys.modules['reina_tpu'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import json, urllib.request\n"
        "import torch\n"
        # tiny shapes: more intra-op threads only contend with the other
        # test workers on the host
        "torch.set_num_threads(1)\n"
        "from reina_tpu_torch.testing import build_synthetic_run\n"
        "from reina_tpu_torch.core.engine import run_days\n"
        "from reina_tpu_torch import cli\n"
        "run = build_synthetic_run('cpu', n_agents=3000, days=3, seed=1)\n"
        f"d = {str(tmp_path)!r}\n"
        "out, st, cr, _ = run_days(run, checkpoint_dir=d)\n"
        "assert out.by_group.shape == (3, 13, 9), out.by_group.shape\n"
        "again, _, _, t = run_days(run, checkpoint_dir=d)\n"
        "assert t == [] and (again.by_group == out.by_group).all()\n"
        "from reina_tpu_torch.core import daygraph, graphs\n"
        "picks = []\n"
        "g = run_days(run, graphs=True, picks=picks)[0]\n"
        "assert (g.by_group == out.by_group).all() and len(picks) == 2\n"
        # the fused tier picks' CPU form, the probe of their graph layouts
        "from reina_tpu_torch.kernels import checks, cond_parts, "
        "gate_parts, nccl_parts\n"
        "k, t = checks._fold_pair('n_d', {'ct_cases': 1, 'n_d': 9}, 2048,"
        " 'cpu')\n"
        "assert all(torch.equal(a, b) for a, b in zip(k(), t()))\n"
        "import reina_tpu_torch.mc_spread, reina_tpu_torch.mc_compare\n"
        # a build of the same shapes with other values reuses the set
        "run2 = build_synthetic_run('cpu', n_agents=3000, days=3, seed=2,"
        " hospital_beds=70)\n"
        "[gs] = graphs.idle()\n"
        "g2 = run_days(run2, graphs=True)[0]\n"
        "assert graphs.idle() == [gs]\n"
        "assert (g2.by_group == run_days(run2)[0].by_group).all()\n"
        "assert cli.main(['simulate', '--area', 'Alavieska', '--days', '4',"
        " '--quiet', '--device', 'cpu']) == 0\n"
        "assert cli.main(['sample', '--what', 'symptom_severity', '--age',"
        " '80', '--device', 'cpu']) == 0\n"
        "from reina_tpu_torch.runtime.graphql.server import serve\n"
        "httpd = serve(host='127.0.0.1', port=0, background=True,"
        " device='cpu')\n"
        "def q(doc):\n"
        "    req = urllib.request.Request("
        "'http://127.0.0.1:%d/graphql' % httpd.server_address[1],"
        " data=json.dumps({'query': doc}).encode(),"
        " headers={'Content-Type': 'application/json'})\n"
        "    with urllib.request.urlopen(req, timeout=60) as r:\n"
        "        return json.loads(r.read())['data']\n"
        "assert q('{ area { name } }') == {'area': {'name': 'HUS'}}\n"
        "d = q('{ sampleDistribution(what: \"symptom_severity\", age: 80)"
        " { categories counts } }')['sampleDistribution']\n"
        "assert sum(d['counts']) == 10000 and 'FATAL' in d['categories']\n"
        "httpd.shutdown()\n"
        "from reina_tpu_torch.ensemble import run_ensemble, run_monte_carlo\n"
        "from reina_tpu_torch.calibration import calibrate\n"
        "from reina_tpu_torch.models.sir import simulate_sir, sweep_r0\n"
        "from reina_tpu_torch.core.debug import dump_state, infection_tree\n"
        "from reina_tpu_torch.testing import (synthetic_age_counts,"
        " synthetic_variables)\n"
        "e = run_ensemble(run, [1, 2])\n"
        "assert e.by_group.shape == (2, 2, 13, 9), e.by_group.shape\n"
        "from reina_tpu_torch.parallel import mesh as M\n"
        "assert M.init_distributed() == 1\n"
        f"assert M.init_distributed('file://{tmp_path}/store', 1, 0,"
        " 'gloo') == 1\n"
        "m = M.make_mesh(device='cpu')\n"
        "assert (run_ensemble(run, [1, 2], mesh=m).by_group"
        " == e.by_group).all()\n"
        # the graph runner's model on an agent shard (one slab)
        "from reina_tpu_torch.core.schedule import Schedules\n"
        "from reina_tpu_torch.ops import prng\n"
        "sh = M.AgentShard(m, run.init_state.age.shape[0])\n"
        "b = (run.cfg, run.arrays, run.schedules, run.init_state,"
        " run.init_carry)\n"
        "gs = graphs.GraphSet(*b, 'cpu', sh)\n"
        "plans = gs.prepare(Schedules(*(x.numpy() for x in run.schedules)),"
        " prng.PRNGKey(run.random_seed), 0, 2,"
        " run.init_carry.weekly_leftover, sh.n)\n"
        "gs.start(*b, 0, plans)\n"
        "gs.step(plans)\n"
        "_, rows = gs.synced(gs.sync_tail(0, 2).numpy())\n"
        "assert rows.tolist() == [list(r) for r in picks], rows\n"
        "assert (gs.state_carry(3, None, 0, True)[0].state"
        " == st.state).all()\n"
        "best, ranked = calibrate(synthetic_variables(days=3),"
        " {'infectiousness_multiplier': [0.4, 0.7]}, observed_rows=["
        "{'date': '2020-02-20', 'confirmed': 3}], pad_multiple=256,"
        " age_counts_override=synthetic_age_counts(3000), device='cpu')\n"
        "assert len(ranked) == 2 and best in [p for p, _ in ranked]\n"
        "assert simulate_sir(1e6, 100.0, 2.5, 7.0, 10,"
        " device='cpu').shape == (10, 3)\n"
        "assert sweep_r0(1e6, 100.0, [1.5, 2.5], 7.0, 10,"
        " device='cpu').shape == (2, 10, 3)\n"
        "assert 'agents' in dump_state(st, today=2)\n"
        "assert infection_tree(st, 0).startswith('#0: ')\n"
        "from reina_tpu_torch.config import variables\n"
        "variables.VARIABLE_DEFAULTS.update(area_name='Alavieska',"
        " simulation_days=3)\n"
        f"csv_path = {str(tmp_path / 'mc.csv')!r}\n"
        "cols = run_monte_carlo(n_runs=2, csv_path=csv_path, device='cpu')\n"
        "assert len(cols['date']) == 6\n"
        "assert open(csv_path).read().startswith('date,susceptible,')\n"
        "assert cli.main(['monte-carlo', '--runs', '1', '--device',"
        " 'cpu']) == 0\n"
        "assert not any(m == 'jax' or m.startswith('jax.')\n"
        "               or m == 'reina_tpu' or m.startswith('reina_tpu.')\n"
        "               or m == 'pandas' or m.startswith('pandas.')\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), (
        r.stdout[-2000:], r.stderr[-3000:])


def _plan_day_scalar(cfg, host, leftover, day, key, n_agents):
    """Day ``day``'s plan by scalar arithmetic, the reference of
    step.plan_days: the weekly imports in float32, one day at a time,
    and the ledger's offset by jax.random.randint's two-draw modulus on
    Python integers from the scalar hash."""
    from reina_tpu_torch.core import constants as C
    from reina_tpu_torch.core import step as S
    from reina_tpu_torch.ops import prng
    m32 = 0xFFFFFFFF
    leftover = (np.asarray(leftover, np.float32)
                + np.float32(host.weekly_amount[day]) / np.float32(7.0)
                * host.weekly_shares[day])
    weekly = np.floor(leftover).astype(np.int32)
    leftover = (leftover - weekly.astype(np.float32)).astype(np.float32)
    cum = np.cumsum(host.import_today[day] + weekly).astype(np.int32)
    tot = int(cum[-1])
    mode = int(host.testing_mode[day])
    ct = mode == C.TESTING_ALL_WITH_SYMPTOMS_CT
    hi, lo = (int(np.bitwise_xor(*prng._threefry_np(k[0], k[1], 0, 0)))
              for k in prng.split(key))
    mult = (((2 ** 16 % n_agents) ** 2) & m32) % n_agents
    off = ((((hi % n_agents) * mult) & m32) + lo % n_agents) & m32
    ints = np.array([day, mode, int(ct), int(host.beds_build[day]),
                     int(host.icu_build[day]), off % n_agents, tot, *cum],
                    np.int32)
    vacc_nr = host.vacc_nr[day]
    floats = np.array([host.trace_p[day], host.detect_anyway_p[day],
                       *np.floor(vacc_nr)], np.float32)
    return S.DayPlan(
        day, ct, bool(np.sum(vacc_nr) >= 1.0), tot > 0,
        C.PROBLEM_IMPORT_BUFFER_OVERFLOW if tot > cfg.import_buffer else 0,
        leftover, np.float32(1.0) - np.float32(host.mobility_scalar[day]),
        ints, floats)


def _assert_plans_equal(want, got):
    assert len(want) == len(got)
    for p, q in zip(want, got):
        for f in p._fields:
            a, b = getattr(p, f), getattr(q, f)
            assert type(a) is type(b), (p.day, f, type(a), type(b))
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape, (p.day, f)
                assert a.tobytes() == b.tobytes(), (p.day, f, a, b)
            else:
                assert a == b, (p.day, f, a, b)


@pytest.fixture(scope="module")
def vs_calendar():
    """The VS configuration's host schedules: the default calendar over
    565 days."""
    from reina_tpu_torch.config.interventions import get_active_interventions
    from reina_tpu_torch.config.variables import VARIABLE_DEFAULTS
    from reina_tpu_torch.core import params, schedule
    v = dict(VARIABLE_DEFAULTS, area_name="Varsinais-Suomi")
    _, names = params.compile_disease(params.create_disease_params(v),
                                      v["max_age"] + 1)
    sched, _ = schedule.compile_schedules(
        get_active_interventions(v), v["start_date"], v["simulation_days"],
        v["max_age"] + 1, names)
    return sched


@pytest.mark.parametrize("day0,n_days,seed", [(0, 565, 11), (200, 565, 12),
                                              (0, 100, 2 ** 32 - 5)])
def test_plan_days_equals_day_by_day(vs_calendar, day0, n_days, seed):
    """step.plan_days plans a run's days in one pass over arrays: its
    plans equal, field by field and bit for bit, the scalar reference's
    and the plain step's plan_day's, a day at a time, for the VS calendar
    at 20,480 agents: the whole run, a resume from day 200 with that
    day's leftover, and a run of n_days 100."""
    from reina_tpu_torch.core import step as S
    from reina_tpu_torch.core.engine import sched_row
    from reina_tpu_torch.core.schedule import Schedules
    from reina_tpu_torch.ops import prng
    host, n = vs_calendar, 20480
    assert (host.weekly_amount > 0).sum() > 300   # the carry is exercised
    cfg = S.EngineConfig(nr_variants=host.weekly_shares.shape[1],
                         vacc_slots=host.vacc_nr.shape[1])
    days = np.arange(n_days - 1)
    dks = S.derive_day_keys(cfg, prng.PRNGKey(seed), days)
    want, left = [], np.zeros(cfg.nr_variants, np.float32)
    for d in days:
        want.append(_plan_day_scalar(cfg, host, left, int(d),
                                     dks.base[d, 14], n))
        left = want[-1].leftover
    start = want[day0 - 1].leftover if day0 else np.zeros_like(left)
    got = S.plan_days(cfg, Schedules(*(x[day0:n_days - 1] for x in host)),
                      start, day0, S.DayKeys(*(x[day0:] for x in dks)), n)
    _assert_plans_equal(want[day0:], got.each())
    one, left = [], start
    for d in range(day0, n_days - 1):
        one.append(S.plan_day(cfg, sched_row(host, host, d), left, d,
                              dks.day(d), n))
        left = one[-1].leftover
    _assert_plans_equal(want[day0:], one)


if __name__ == "__main__":
    sys.path.insert(0, _REPO)
    if sys.argv[1] == "--mesh-rank":
        _mesh_rank(int(sys.argv[2]), sys.argv[3])
    else:
        _child(sys.argv[1])
