"""The benchmark's files: every cell's found by name, a new cell, mix,
traffic kind, metric or roofline function added without an edit, the
traffic repeated from the seed, the frozen byte counts, the contract's
shape of BENCHMARK.json, and the imports."""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import cell as C
from benchmark.traffic.closed_loop import what_ifs
from benchmark.traffic.members import member_seeds

ROOT = C.ROOT
BENCH = C.HERE
SPEC = C.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(workload):
    c = C.cell(workload)
    assert c.config["variables"]["simulation_days"] == 565
    assert callable(C.traffic_driver(c.traffic["kind"]))
    assert set(c.limits) == {"start_off", "replay_off", "elements_off",
                             "outputs_off"}
    for m in c.per_layer:
        assert callable(C.layer_reader(m["name"]))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_a_new_cell_mix_metric_and_roofline_need_no_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / BENCH.name
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    traffic = json.loads((bench / "traffic" / "ensemble.json").read_text())
    traffic["members_checked"] = 2
    (bench / "traffic" / "ensemble2.json").write_text(json.dumps(traffic))
    (bench / "limits" / "vs.ensemble2.json").write_text(
        (bench / "limits" / "vs.ensemble.json").read_text())
    (bench / "layers" / "run.new_metric.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    (bench / "roofline" / "new_function.py").write_text(
        "PATTERNS = ['new_kernel']\nCALLS_PER_DAY = 1\n\n\n"
        "def least_bytes(n):\n    return 4 * n\n")
    spec["workloads"].append({"name": "vs.ensemble2", "config": "vs",
                              "traffic": "ensemble2", "chips": 1,
                              "why": "a later cell"})
    spec["per_layer"].append({"name": "run.new_metric", "unit": "x",
                              "better": "lower",
                              "source": "program_counter",
                              "layer": "run loop", "moves":
                              "agent_days_per_s",
                              "workloads": ["vs.ensemble2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = C.cell("vs.ensemble2", tmp_path)
    assert c.traffic["members_checked"] == 2
    assert "run.new_metric" in {m["name"] for m in c.per_layer}
    assert C.layer_reader("run.new_metric", tmp_path)({}) == 7.0
    assert C.rooflines(tmp_path)["new_function"].least_bytes(2) == 8
    # the cells already there are as they were
    assert C.cell("vs.ensemble", tmp_path).traffic == C.cell(
        "vs.ensemble").traffic


def test_a_new_traffic_kind_needs_no_edit(tmp_path):
    """A kind of traffic is a driver module of its own beside its mixes,
    found by the mix's ``kind``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / BENCH.name
    (bench / "traffic" / "replay_kind.py").write_text(
        "class Driver:\n"
        "    def __init__(self, config, traffic, seed, device):\n"
        "        self.rate = traffic['rate'] * seed\n")
    (bench / "traffic" / "replay.json").write_text(
        json.dumps({"kind": "replay_kind", "rate": 3}))
    (bench / "limits" / "vs.replay.json").write_text(
        (bench / "limits" / "vs.ensemble.json").read_text())
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "vs.replay", "config": "vs",
                              "traffic": "replay", "chips": 1,
                              "why": "a later kind"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = C.cell("vs.replay", tmp_path)
    d = C.traffic_driver(c.traffic["kind"], tmp_path)(
        c.config, c.traffic, 5, "cpu")
    assert d.rate == 15
    with pytest.raises(SystemExit):
        C.traffic_driver("../run", tmp_path)


def test_the_clients_process_loads_only_the_standard_library():
    """The web-UI clients run apart from the server's interpreter and
    take none of its libraries with them."""
    code = ("import sys; import benchmark.harness.clients; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert not set(eval(out)) & {"torch", "numpy", "reina_tpu_torch"}


def test_member_seeds_repeat_from_the_seed():
    big = 2**31 + 12345
    assert member_seeds(big, 50) == member_seeds(big, 50)
    assert member_seeds(big, 50) != member_seeds(big + 1, 50)
    assert all(0 <= s < 2**32 for s in member_seeds(big, 50))


def test_what_ifs_repeat_from_the_seed():
    c = C.cell("hus.served")
    a = what_ifs(c.config, c.traffic, 2**31 + 7, 40)
    assert a == what_ifs(c.config, c.traffic, 2**31 + 7, 40)
    assert a != what_ifs(c.config, c.traffic, 2**31 + 8, 40)
    keys = {json.dumps(v, sort_keys=True) for v in a}
    assert len(keys) == len(a)          # every request a miss
    lo, hi = c.traffic["ranges"]["hospital_beds"]
    assert all(lo <= v["hospital_beds"] <= hi for v in a)
    assert {v.get("preset_scenario") for v in a} <= set(c.traffic["presets"])


@pytest.mark.parametrize("n", [1686528, 480256])
def test_frozen_bytes_equal_the_kernel_checks(n):
    """The roofline files' bytes against kernels/checks.py's counts."""
    from reina_tpu_torch.kernels import checks as K
    cs = {c.name: c for c in K.checks(n, 0, "cpu")}
    for name, f in C.rooflines().items():
        c = cs[name]
        out = c.twin()
        moved = ((c.read_bytes if c.read_bytes is not None
                  else K._nbytes(c.inputs))
                 + (c.write_bytes if c.write_bytes is not None
                    else K._nbytes(out)))
        if c.read_bytes is None:
            assert f.least_bytes(n) == moved, name
        else:
            # data-dependent reads: the frozen count is its fixed part
            assert n < f.least_bytes(n) <= moved, name


def test_benchmark_json_keeps_the_contract():
    b = SPEC
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in b["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    layers = {}
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            cell_e2e = [x for x in b["end_to_end"]
                        if "workloads" not in x or w in x["workloads"]]
            assert m["moves"] in {x["name"] for x in cell_e2e}
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


FORBIDDEN = {"jax", "jaxlib", "flax", "reina_tpu", "bench", "tools"}


def _imports(path: Path):
    """Top-level names of every module ``path`` imports (relative
    imports excluded)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    """By whole top-level name: reina_tpu_torch begins with reina_tpu."""
    for p in BENCH.rglob("*.py"):
        assert not set(_imports(p)) & FORBIDDEN, p
    for p in (BENCH / "reference").rglob("*.py"):
        assert "reina_tpu_torch" not in set(_imports(p)), p


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.build; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    mods = set(eval(out))
    assert not mods & (FORBIDDEN | {"reina_tpu_torch"})


def test_no_card_no_result(tmp_path):
    """Without a card a run exits 3 and prints no result; alone in a
    directory with only BENCHMARK.json and the benchmark, it fails."""
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "vs.ensemble", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 3 and not r.stdout.strip()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "vs.ensemble", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and "{" not in r.stdout
