"""The port's counters and spans (reina_tpu_torch/utils/perf.py): nesting,
request ids, a span ended on another thread, exact totals from many
threads, the ring's bound, the trace's operator, a served run's span,
and the benchmark's readers of them on hand-made windows."""
import importlib.util
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from reina_tpu_torch.core import step
from reina_tpu_torch.utils import perf


def _ring(name, id_=None):
    return [s for s in list(perf.RING)
            if s[0] == name and (id_ is None or s[1] == id_)]


def test_spans_nest_and_inherit_the_request_id():
    assert step.STATS is perf.STATS
    seen = {}

    def other_thread():
        with perf.span("t.elsewhere") as s:
            seen["parent"] = s.parent

    with perf.span("t.outer", id="req-1") as outer:
        with perf.span("t.inner") as inner:
            with perf.span("t.leaf", id="req-2") as leaf:
                th = threading.Thread(target=other_thread)
                th.start()
                th.join(timeout=10)
    assert not th.is_alive()
    assert seen["parent"] is None        # a thread's spans are its own
    assert (outer.parent, inner.parent, leaf.parent) == (
        None, "t.outer", "t.inner")
    assert (outer.id, inner.id, leaf.id) == ("req-1", "req-1", "req-2")
    [o], [i], [lf] = (_ring(n, x) for n, x in (
        ("t.outer", "req-1"), ("t.inner", "req-1"), ("t.leaf", "req-2")))
    assert o[3] <= i[3] <= lf[3] <= lf[4] <= i[4] <= o[4]
    assert i[2] == "t.outer" and lf[2] == "t.inner"


def test_a_span_ends_on_another_thread_with_its_start():
    t0 = perf.now()
    n = perf.STATS["t.request_n"]

    def finish():
        with perf.span("t.worker", id="req-3"):
            with perf.span("t.request", start=t0):
                pass

    th = threading.Thread(target=finish)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    [rec] = _ring("t.request", "req-3")
    assert rec[2] == "t.worker" and rec[3] == t0 and rec[4] >= t0
    assert perf.STATS["t.request_n"] == n + 1
    # a span of this thread that began before its ``with``
    with perf.span("t.late", id="req-4", start=t0) as s:
        pass
    assert s.start == t0 and _ring("t.late", "req-4")[0][3] == t0


def test_threads_lose_no_count_or_span():
    """8 threads of 10,000 spans and counts each, switching as often as
    the interpreter allows, every count on a key that the threads race
    to make: the totals are exact."""
    threads, each = 8, 10_000
    n = perf.STATS["t.stress_n"]
    start = threading.Barrier(threads)

    def work(i):
        start.wait(timeout=10)
        for j in range(each):
            with perf.span("t.stress", id=f"t{i}"):
                perf.count(f"t.stress.{j}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(i,))
              for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert perf.STATS["t.stress_n"] - n == threads * each
    counts = [perf.STATS.pop(f"t.stress.{j}") for j in range(each)]
    assert counts == [threads] * each
    assert perf.STATS["t.stress_s"] > 0


def test_the_ring_keeps_the_last_spans():
    assert perf.RING.maxlen == perf.RING_SIZE >= 2 ** 16
    t0 = perf.now()
    for i in range(perf.RING_SIZE + 5):
        with perf.span("t.ring", id=str(i), start=t0):
            pass
    ring = list(perf.RING)
    assert len(ring) == perf.RING_SIZE
    assert ring[0][1] == "5" and ring[-1][1] == str(perf.RING_SIZE + 4)
    perf.count("t.zero", 0)
    assert "t.zero" not in perf.STATS


def test_a_span_is_an_operator_in_the_trace():
    """Under torch.profiler a span is the operator reina.<name> of this
    thread, a host event: nothing of it lands on a device's timeline."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with perf.span("t.traced"):
            torch.ones(4).sum()
    got = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "reina.t.traced"]
    assert len(got) == 1 and got[0].device_type() == \
        torch.autograd.DeviceType.CPU and got[0].duration_ns() > 0


def test_a_served_run_is_a_span_under_its_run_id(monkeypatch):
    """One CPU worker: serve.run from its admission to its terminal
    write, under its run id (its cache key), counted before a client
    can read that it finished."""
    from reina_tpu_torch.runtime import cache, runner

    def engine(step_callback=None, callback_day_interval=1,
               variable_store=None, device="cuda"):
        cols = {"date": np.datetime64("2020-02-18", "D") + np.arange(2),
                "infected": np.array([1, 2])}
        step_callback(cols)
        return cols, None

    engine._calcfunc_variables = ["random_seed"]
    engine._calcfunc_funcs = []
    engine._calcfunc_filedeps = []
    cache.init_backend("memory")
    seen = []
    real_set = cache.set

    def watch(key, value, ttl):
        if key.endswith("-finished") and value is True:
            seen.append(len(_ring("serve.run", key[:-len("-finished")])))
        real_set(key, value, ttl)

    monkeypatch.setattr(runner, "simulate_individuals", engine)
    monkeypatch.setattr(cache, "set", watch)
    reg = runner.RunRegistry()
    run_id = reg.start_run({"random_seed": 424242}, "cpu")
    t = reg.get(run_id)
    t.join(timeout=10)
    assert not t.is_alive()
    [rec] = _ring("serve.run", run_id)
    assert rec[3] == t.admitted and rec[4] > rec[3] and seen == [1]


# --- the benchmark's readers of the counters and spans ----------------------

def layer_reader(metric):
    """``read`` of the benchmark's benchmark/layers/<metric>.py, loaded
    from its file."""
    path = (Path(__file__).resolve().parents[1] / "benchmark" / "layers"
            / f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "layer_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(**window):
    return {"window": SimpleNamespace(**window)}


@pytest.mark.parametrize("name,counters,want", [
    ("compile.host_s_per_miss",
     {"stats.build.compile_s": 3.0, "stats.build.misses": 4}, 0.75),
    ("compile.upload_s_per_miss",
     {"stats.build.upload_s": 1.0, "stats.build.misses": 4}, 0.25),
    ("run.sync_wait_s_per_run",
     {"stats.run.wait_s": 6.0, "stats.serve.run_n": 3}, 2.0),
    ("serve.publish_s_per_run",
     {"stats.serve.publish_s": 0.9, "stats.serve.run_n": 3}, 0.3),
    ("run.host_gap_ms_per_member",
     {"stats.ensemble.member_s": 2.4, "stats.run.launch_s": 1.0,
      "stats.run.wait_s": 1.0, "stats.ensemble.member_n": 2}, 200.0),
])
def test_counter_readers(name, counters, want):
    """Each reader's ratio of the window's counters; None where the
    window has nothing to divide by, as on a program without the spans."""
    read = layer_reader(name)
    assert read(_ctx(counters=counters)) == pytest.approx(want)
    assert read(_ctx(counters={})) is None
    none = {k: 0 for k in counters}
    assert read(_ctx(counters=none)) is None


def test_run_s_reader():
    """The median of the window's requests' serve.run spans; a failed
    request counts as never; None without a span for a finished one."""
    read = layer_reader("serve.run_s_p50")
    t0 = perf.now()
    for rid, s in (("rd-a", 1.0), ("rd-b", 3.0), ("rd-c", 2.0)):
        perf.RING.append(("serve.run", rid, None, t0, t0 + int(s * 1e9)))
    req = [SimpleNamespace(run_id=r, error=None)
           for r in ("rd-a", "rd-b", "rd-c")]
    assert read(_ctx(requests=req)) == pytest.approx(2.0)
    failed = SimpleNamespace(run_id="rd-x", error="boom")
    assert read(_ctx(requests=req[:2] + [failed])) == pytest.approx(3.0)
    lost = SimpleNamespace(run_id="rd-none", error=None)
    assert read(_ctx(requests=req + [lost])) is None
    assert read(_ctx(requests=[])) is None
    assert read(_ctx(seeds=[1])) is None
