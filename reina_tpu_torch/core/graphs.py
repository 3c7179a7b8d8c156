"""The day step as captured CUDA graphs: the port's counterpart of the JAX
package's compiled day chunk (reina_tpu/core/engine.py:run_chunk, a
``lax.scan`` over the days of a chunk, compiled once).

A :class:`GraphSet` runs the spans of ``step.run_day`` for one build
(model arrays, schedules, engine config) on one device. The first time a
(span, key) comes up it runs eagerly, as the day's real work, and is
then captured into a ``torch.cuda.CUDAGraph``; every later day with the
same (span, key) replays the graph. For that, everything a span reads
lies at an address that does not change from day to day:

  * the day row (``step.DayIn``): tables of the run's day rows and key
    words are uploaded once a run; the first span of a day copies row
    ``counter`` (a device day counter) into the static day row, the last
    span advances the counter;
  * the state and the carry: static buffers; the last span copies the
    new day's into them (the bucket table is updated in place there, so
    it is never copied in a day);
  * what one span hands the next: a static buffer for each name,
    allocated in the span's eager first run, into which every capture
    of a span that gives that name copies it;
  * the outputs: the last span writes the day's ``DayOutputs`` into row
    ``counter`` of a device table (the scan's stacked outputs), which the
    run loop fetches at its sync points.

The graphs of a set share one memory pool: no span keeps anything in it
past its end, so one graph's temporaries may reuse another's memory.
Captures hold a process-wide lock and use the thread-local capture mode,
so a served run's capture is not broken by another worker thread's work;
each run takes a set of its own (``acquire``/``release``), and a build's
idle sets serve its later runs (ensemble members, reseeded and served
runs). A capture or replay that fails raises, naming the span and key;
nothing runs the day eagerly in its place.

Launch counts (``kernels.LAUNCHES``): a capture's launches go into the
graph's tally, and each replay adds the tally. ``step.STATS`` counts
the captures, their seconds and the replays beside the days and the
host reads.

On the CPU a GraphSet is a model of the same machinery for the tests:
each (span, key) records its body (the span and the copies around it) on
its first day and calls it again on later days, so a span that read a
day-varying value from anywhere but the static buffers would give a
wrong day there, as a replayed graph would.
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import step as S
from .schedule import Schedules
from .state import AgentState, DayCarry
from .. import kernels

_CAPTURE_LOCK = threading.Lock()
_IDLE_LOCK = threading.Lock()
_IDLE: List["GraphSet"] = []

# the carry's fields on the device (day and weekly_leftover are host
# values, kept by the run loop)
DEVICE_CARRY = tuple(f for f in DayCarry._fields
                     if f not in ("day", "weekly_leftover"))

class GraphError(RuntimeError):
    """A span's capture or replay failed."""


class _Entry(NamedTuple):
    run: object            # the CUDAGraph, or on the CPU the body
    fields: tuple          # the names the span gives
    tally: Counter         # launches of one replay


class GraphSet:
    """The static buffers and captured spans of one build on one device."""

    def __init__(self, cfg: S.EngineConfig, arrays: S.ModelArrays,
                 schedules: Schedules, device):
        self.cfg, self.arrays, self.schedules = cfg, arrays, schedules
        self.device = torch.device(device)
        self.model = self.device.type != "cuda"
        days, A, P = schedules.mobility.shape
        V = cfg.nr_variants
        dev = self.device
        ni, nf = S.I_CUM_IMP + V, S.F_VACC + cfg.vacc_slots
        kw = sum(w for _, w, _ in S.key_slots(cfg).values())
        self.key_words = torch.zeros(kw, dtype=torch.int32, device=dev)
        self.tab_i = torch.zeros((days, ni), dtype=torch.int32, device=dev)
        self.tab_f = torch.zeros((days, nf), dtype=torch.float32, device=dev)
        self.tab_k = torch.zeros((days, kw), dtype=torch.int32, device=dev)
        self.din = S.DayIn(
            torch.zeros(ni, dtype=torch.int32, device=dev),
            torch.zeros(nf, dtype=torch.float32, device=dev),
            torch.zeros((A, P), dtype=torch.float32, device=dev),
            torch.zeros((A, P), dtype=torch.float32, device=dev),
            S.dev_keys(cfg, self.key_words))
        # a row a day of the outputs' int leaves, flattened, and of r;
        # made at the first day's eager run of the last span
        self.out_i = self.out_f = None
        self.int_shapes = []
        self.counter = torch.zeros((), dtype=torch.int64, device=dev)
        self.state: Optional[AgentState] = None
        self.carry: Dict[str, torch.Tensor] = {}
        self.handoff: Dict[str, torch.Tensor] = {}
        self.entries: Dict[tuple, _Entry] = {}
        if not self.model:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(dev)

    def matches(self, cfg, arrays, schedules, device) -> bool:
        return (self.arrays is arrays and self.schedules is schedules
                and self.cfg == cfg and self.device == torch.device(device))

    # ---- a run

    def start(self, state: AgentState, carry: DayCarry, day: int) -> None:
        """Take a run's state and carry into the static buffers, from
        ``day``."""
        if self.state is None:
            self.state = AgentState(*(x.clone() for x in state))
            self.carry = {f: getattr(carry, f).clone() for f in DEVICE_CARRY}
        else:
            for dst, src in zip(self.state, state):
                dst.copy_(src)
            for f in DEVICE_CARRY:
                self.carry[f].copy_(getattr(carry, f))
        self.counter.fill_(day)

    def prepare(self, host: Schedules, base_key, day0: int, steps: int,
                leftover, n_agents: int) -> List[S.DayPlan]:
        """The plans of days [day0, day0 + steps) and their rows and keys
        in the device tables (one upload a run)."""
        from .engine import sched_row
        days = day0 + np.arange(steps)
        dks = S.derive_day_keys(self.cfg, base_key, days)
        plans = []
        for i, d in enumerate(days):
            plan = S.plan_day(self.cfg, sched_row(self.schedules, host,
                                                  int(d)),
                              leftover, int(d), dks.day(i), n_agents)
            leftover = plan.leftover
            plans.append(plan)
        if plans:
            rows = slice(day0, day0 + steps)
            self.tab_i[rows].copy_(torch.from_numpy(
                np.stack([p.ints for p in plans])))
            self.tab_f[rows].copy_(torch.from_numpy(
                np.stack([p.floats for p in plans])))
            self.tab_k[rows].copy_(torch.from_numpy(
                S.key_table(self.cfg, dks).view(np.int32)))
        return plans

    def step(self, plans: List[S.DayPlan]) -> int:
        """Run the planned days; returns the problem bits the host found
        (the state, carry and outputs stay in the static buffers)."""
        carry = DayCarry(day=None, weekly_leftover=None, **self.carry)
        bits = 0
        for plan in plans:
            bits |= S.run_day(self.cfg, self.arrays, plan, self.din,
                              self.state, carry, self)[3]
        return bits

    def outputs(self, a: int, b: int, plans) -> S.DayOutputs:
        """The outputs of stepped days [a, b) as device views of the table
        (and the plans' host values)."""
        leaves, at = {}, 0
        for f, shape in zip(_INT_OUTS, self.int_shapes):
            w = int(np.prod(shape))
            leaves[f] = self.out_i[a:b, at:at + w].reshape((b - a,) + shape)
            at += w
        leaves["r"] = self.out_f[a:b, 0]
        leaves["mobility_limitation"] = np.array(
            [p.mobility_limitation for p in plans], np.float32)
        return S.DayOutputs(**leaves)

    def state_carry(self, day: int, leftover, bits: int, clone: bool):
        """The run's state and carry now (views of the static buffers, or
        copies), the host's problem bits merged into ``problem``."""
        copy = (lambda x: x.clone()) if clone else (lambda x: x)
        cr = {f: copy(t) for f, t in self.carry.items()}
        cr["problem"] = self.carry["problem"] | bits
        return (AgentState(*(copy(x) for x in self.state)),
                DayCarry(day=day, weekly_leftover=leftover, **cr))

    # ---- the executor of step.run_day

    @staticmethod
    def read(t: torch.Tensor):
        return t.tolist()

    def span(self, name: str, key: tuple, fn):
        entry = self.entries.get((name, key))
        if entry is None:
            body = self._body(name, fn)
            fields = body()            # the day's work, eagerly
            entry = self._record(name, key, body, fields)
            self.entries[(name, key)] = entry
        else:
            self._replay(name, key, entry)
        if name == S.LAST_SPAN:
            return dict(state=self.state, carry=self.carry, out=None)
        return {f: self.handoff[f] for f in entry.fields}

    def _body(self, name: str, fn):
        def body():
            if name in S.FIRST_SPANS:
                self._load_day()
            return self._commit(name, fn())
        return body

    def _load_day(self) -> None:
        i = self.counter.view(1)
        self.din.ints.copy_(self.tab_i.index_select(0, i)[0])
        self.din.floats.copy_(self.tab_f.index_select(0, i)[0])
        self.key_words.copy_(self.tab_k.index_select(0, i)[0])
        self.din.mobility.copy_(self.schedules.mobility.index_select(0, i)[0])
        self.din.mask_p.copy_(self.schedules.mask_p.index_select(0, i)[0])

    def _commit(self, name: str, outs: dict) -> tuple:
        """Copy a span's results where the next spans (and days) read
        them; returns the names it gave."""
        if name == S.LAST_SPAN:
            for dst, src in zip(self.state, outs["state"]):
                _copy(dst, src, "state")
            for f, src in outs["carry"].items():
                _copy(self.carry[f], src, "carry." + f)
            out = outs["out"]
            row = torch.cat([getattr(out, f).reshape(-1).to(torch.int32)
                             for f in _INT_OUTS])
            if self.out_i is None:
                days = self.tab_i.shape[0]
                self.int_shapes = [tuple(getattr(out, f).shape)
                                   for f in _INT_OUTS]
                self.out_i = torch.zeros((days, row.numel()),
                                         dtype=torch.int32, device=row.device)
                self.out_f = torch.zeros((days, 1), dtype=torch.float32,
                                         device=row.device)
            i = self.counter.view(1)
            self.out_i.index_copy_(0, i, row[None])
            self.out_f.index_copy_(0, i, out.r.reshape(1, 1).to(torch.float32))
            self.counter.add_(1)
            return ()
        for f, t in outs.items():
            h = self.handoff.get(f)
            if h is None:
                if not self.model and torch.cuda.is_current_stream_capturing():
                    raise GraphError(f"span {name} gave {f!r} first under "
                                     "capture")
                self.handoff[f] = t.clone()
            else:
                _copy(h, t, f)
        return tuple(outs)

    def _record(self, name, key, body, fields) -> _Entry:
        S.STATS["captures"] += 1
        if self.model:
            return _Entry(body, fields, Counter())
        g = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with _CAPTURE_LOCK:
            try:
                with kernels.capturing() as tally:
                    with torch.cuda.graph(g, pool=self.pool,
                                          stream=self.stream,
                                          capture_error_mode="thread_local"):
                        body()
            except Exception as e:
                raise GraphError(f"capture of span {name} {key} failed: "
                                 f"{e}") from e
        S.STATS["capture_s"] += time.perf_counter() - t0
        return _Entry(g, fields, tally)

    def _replay(self, name, key, entry: _Entry) -> None:
        S.STATS["replays"] += 1
        if self.model:
            entry.run()
            return
        try:
            entry.run.replay()
        except Exception as e:
            raise GraphError(f"replay of span {name} {key} failed: "
                             f"{e}") from e
        kernels.replayed(entry.tally)


_INT_OUTS = tuple(f for f in S.DayOutputs._fields
                  if f not in ("r", "mobility_limitation"))


def _copy(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    if src is dst:
        return
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise GraphError(f"{what}: {tuple(src.shape)} {src.dtype} into the "
                         f"static {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def acquire(cfg, arrays, schedules, device) -> GraphSet:
    """An idle GraphSet of this build on ``device``, or a new one; making
    a new one frees the idle sets of other builds on the device."""
    device = torch.device(device)
    with _IDLE_LOCK:
        for i, gs in enumerate(_IDLE):
            if gs.matches(cfg, arrays, schedules, device):
                return _IDLE.pop(i)
        _IDLE[:] = [gs for gs in _IDLE if gs.device != device]
    return GraphSet(cfg, arrays, schedules, device)


def release(gs: GraphSet) -> None:
    """Return a set whose run has ended for a later run of its build."""
    with _IDLE_LOCK:
        _IDLE.append(gs)


def drop_idle() -> None:
    """Free every idle set."""
    with _IDLE_LOCK:
        _IDLE.clear()
