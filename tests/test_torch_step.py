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
  * 24 days in distribution over 8 seeds: each day's mean of
    all_infected and detected agrees within 4 combined standard errors.
  * the port imports and runs a day with jax made unimportable.
"""
import json
import os
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
            report["one_day"].append(row)
    report["one_day_agents"] = int(n)

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


def test_runs_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import os; os.environ['REINA_NO_JAX_CACHE'] = '1'\n"
        "import torch\n"
        "from reina_tpu_torch.testing import build_synthetic_run\n"
        "from reina_tpu_torch.core.engine import run_days\n"
        "run = build_synthetic_run('cpu', n_agents=3000, days=3, seed=1)\n"
        "out, st, cr, _ = run_days(run)\n"
        "assert out.by_group.shape == (3, 13, 9), out.by_group.shape\n"
        "assert not any(m == 'jax' or m.startswith('jax.')\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), (
        r.stdout[-2000:], r.stderr[-3000:])


if __name__ == "__main__":
    sys.path.insert(0, _REPO)
    _child(sys.argv[1])
