"""A cell of BENCHMARK.json and the files it names, each found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` and the driver of
its ``kind``, ``traffic/<kind>.py``, ``limits/<workload>.json``,
``layers/<metric>.py`` for each per-layer metric and every
``roofline/*.py``. A later cell, traffic mix, traffic kind, per-layer
metric or roofline function is a new file and a new entry, never an
edit of a file that is here."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]      # benchmark/
ROOT = HERE.parent                               # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # limits/<workload>.json
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]   # the cell's per-layer metrics


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, workload: str, e2e_names) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of BENCHMARK.json with its files."""
    b = spec(root)
    bench = root / HERE.name
    w = next((w for w in b["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in b["configs"] if c["name"] == w["config"])
    e2e = [m for m in b["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{workload}.json"),
        end_to_end=e2e,
        per_layer=[m for m in b["per_layer"] if _applies(m, workload, names)])


def load_module(path: Path):
    spec_ = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def layer_reader(metric: str, root: Path = ROOT):
    """``read(ctx)`` of layers/<metric>.py: the metric's value, or None
    where the run gave it nothing to read."""
    return load_module(root / HERE.name / "layers" / f"{metric}.py").read


def rooflines(root: Path = ROOT) -> Dict[str, object]:
    """Every roofline/<function>.py by function name."""
    return {p.stem: load_module(p)
            for p in sorted((root / HERE.name / "roofline").glob("*.py"))}


KIND = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def traffic_driver(kind: str, root: Path = ROOT):
    """``Driver`` of traffic/<kind>.py: the generator and driver of every
    mix of that kind, built as ``Driver(config, traffic, seed, device)``."""
    if not KIND.match(kind):
        raise SystemExit(f"traffic kind {kind!r} is no module name")
    name = f"{__package__.split('.')[0]}.traffic.{kind}"
    if root == ROOT:
        return importlib.import_module(name).Driver
    spec_ = importlib.util.spec_from_file_location(
        name, root / HERE.name / "traffic" / f"{kind}.py")
    mod = importlib.util.module_from_spec(spec_)
    sys.modules[name] = mod
    spec_.loader.exec_module(mod)
    return mod.Driver
