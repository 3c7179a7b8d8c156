"""The day step as CUDA graphs: the port's counterpart of the JAX
package's compiled day chunk (reina_tpu/core/engine.py:run_chunk, a
``lax.scan`` over the days of a chunk, compiled once, that picks every
tier on the device).

A :class:`GraphSet` runs the days of the builds of one key on one
device. The key is what its captured graphs depend on, as the JAX
package's jitted ``run_chunk`` is keyed by its static ``cfg`` and
``chunk_len`` and the shapes of its traced arguments: the engine config,
the device, and the shapes and dtypes of the model arrays, of the
schedules less their day axis, of the state and of the carry
(:func:`set_key`); never a build's identity or values. The set owns
static copies of everything the spans read of a build (its model arrays
and the schedules' (day, A, P) tables), into which each run copies its
build's, as it copies its state and carry; so a new build of the same
key (a reseeded, served or swept run, another scenario, other beds or
parameters) reuses the graphs, for a run of up to the set's days.

A day is ``step.day_program``: spans, and tier picks between them. For
each host key (contact tracing on, a vaccination day, imports: what the
schedule says) the set holds a day graph (core/daygraph.py) in which
each span is its captured ``torch.cuda.CUDAGraph`` and each pick is made
by the kernel in a span that produces its count, which sets the
conditional node after that span: while a span is built the set names
the counts' fold sites (``kernels.folding``, core/daygraph.py:Fold), so
that the producer writes the count straight into its static handoff
buffer and makes the picks in the same launch, reading its conditional's
handle from the set's handle table, which each day graph's head fills.
A warm-up makes no pick. A day is one launch of its key's day graph,
and the host reads nothing until the run loop's next sync point.

Every branch exists before a day needs it: when a run starts, every host
key of its days that the set lacks is built. Each (span, key) variant of
the key's program that the set has not captured yet runs once eagerly on
the static buffers (its warm-up: it allocates the span's handoff buffers
and compiles its kernels), is captured, and the day graph is assembled;
only then are the run's state and carry loaded into the static buffers.
For that, everything a span reads lies at an address that does not
change from day to day or from build to build:

  * the build: the set's copies of the model arrays and of the
    schedules' mobility and mask tables, which a run's start fills;
  * the day row (``step.DayIn``): tables of the run's day rows and key
    words are uploaded once a run; the first span of a day copies row
    ``counter`` (a device day counter) into the static day row, the last
    span advances the counter;
  * the state and the carry: static buffers; the last span copies the
    new day's into them (the bucket table is updated in place there, so
    it is never copied in a day);
  * what one span hands the next: a static buffer for each name,
    allocated in the first warm-up that gives it, into which every
    capture of a span that gives that name copies it (a count that a
    producer writes into its buffer itself is not copied);
  * the outputs, picks and tallies: the last span writes the day's
    ``DayOutputs`` into row ``counter`` of a device table (the scan's
    stacked outputs), each pick its branch into row ``counter`` of the
    picks table and one into its branch's tally; the run loop fetches
    them with the problem bits at its sync points.

The graphs of a set share one memory pool: no span keeps anything in it
past its end, so one graph's temporaries may reuse another's memory, and
any branch may follow any other. Captures hold a process-wide lock and
use the thread-local capture mode, so a served run's capture is not
broken by another worker thread's work; each run takes a set of its own
(``acquire``/``release``), and the idle sets of a key serve its later
builds' runs; a build of another key gets a set of its own, which frees
the device's idle sets. A capture, assembly or launch that fails, or a
build that does not fit the set it is given, raises GraphError; nothing
runs the day eagerly in its place.

Launch counts (``kernels.LAUNCHES``): a capture's launches go into the
span's tally; each launch of a day graph adds the tallies of the spans it
always runs, and each sync point those of the branches that ran, from
the device's branch tallies (the picks are inside the spans' launches:
``fused_concat_prefix.pick``, ``daygraph.max_pick``). The
warm-ups launch their kernels eagerly and count them there, each also
in ``kernels.WARMUPS``. ``step.STATS`` counts the captures, the day
graphs built and the day-graph launches beside the days (a chunk's at
its end), and the spans ``graphs.capture`` and ``graphs.assemble``
time the captures and assemblies on a card (utils/perf.py).

On a rank of an agent-sharded run (``shard``, parallel/mesh.py:
AgentShard; over NCCL, a rank a card) the set holds the slab's static
buffers and every span its collectives, captured as NCCL kernels
(``kernels/nccl_parts.py`` probed which layouts CUDA and torch's
ProcessGroupNCCL allow). Every rank builds the same (span, key)
variants in the same order (their plans are the same), after one eager
collective that makes the agent group's communicator. After each
warm-up and after each capture the ranks agree through the world's
store that it was built (``mesh.agree``), and a warm-up's collectives
give up as soon as another rank has failed (``mesh.watching``): a
warm-up or capture that fails on one rank, even halfway through a
span's collectives, raises GraphError on all of them, and each aborts
the agent group's communicator, instead of leaving the others in a
collective. A day is then one day-graph launch on every rank; the
picks, made by kernels that run after the collectives that make their
counts global (core/daygraph.py), agree, so the ranks run the same
branches. The collectives' calls and bytes go into a capture's tally
(``mesh.calls``, ``mesh.bytes``) and ``kernels.REPLAYED`` once a
replay. The key includes the slab count, the slab, the backend and the
agent group (``shard_key``).

A replay is watched as a build is. While a set steps a shard, a
collective that blocks the host (the CPU model's) gives up on a peer's
failure or loss (``mesh.watching``); over NCCL the host launches a day
only once the card has run the day ``AHEAD`` launches back, polling
that day's event (one of a ring, recorded again after each launch), and
a sync point polls the last launch's event (``settle``), so that no
launch or host read blocks behind a collective that a failed or lost
peer never makes. The polls read what the watch's own thread found in
the store, so a launch costs no store round trip. A day that fails on
this rank, or a wait given up on a peer, gives the agent group up
(``mesh.give_up``, the one failure policy): the failure is marked in
the store, where every peer's wait sees it, the group's communicator is
aborted, and every set whose captured collectives use the group (this
one and the idle ones, each noted with ``mesh.hold``) is freed once the
card has run out what was queued (at most ``AHEAD`` days). What runs
out after the abort reads what the aborted collectives left in their
buffers, and on an H100 over NCCL a torch index kernel there has failed
its bounds assert, which ends the card's CUDA context: the rank then
says so in the error it raises, and can use its card no more. The rank
raises its own error as it was (with that note), a peer's as GraphError
naming the day or the sync point.

A captured NCCL collective holds its communicator: NCCL's teardown of
the communicator (``destroy_process_group``) waits until every graph
that holds one is destroyed. So a set on an NCCL shard is freed when
its run ends (``release``), unless a :func:`reusing` scope is open, in
which it stays idle for the scope's later runs until the outermost
scope ends; a failed run's set is freed at once, after the abort.

Every entry that launches work on a set's card (``acquire``, ``start``
with its warm-ups, captures and assembly, ``step``, ``settle``) makes
that card current for its duration (:func:`on_device`) and restores the
caller's current device after: the kernels launch on the current device,
and a run is bit for bit the same whichever device its caller had
current.

On the CPU a GraphSet is a model of the same machinery for the tests:
each (span, key) records its body (the span and the copies around it) at
its warm-up and calls it again on later days, and each fold site makes
its picks with the twin inside the producer's call, whose entry in the
picks table names the branch that runs; the host reads no count. On a
shard the model has its gates too: a collective of a replay that is
given up on a peer sets the set's stop word and ends its span
(``mesh.Stopped``, as an aborted collective returns on the card and the
gate after it runs nothing), and so does every later collective while
the word is set (``GATED`` counts them).
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter, deque
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from . import step as S
from .daygraph import (FOLDS, DayGraph, Fold, GraphError, check_body_nodes,
                       destroy_graphs, fold_nodes, split)
from .schedule import Schedules
from .state import AgentState, DayCarry
from .. import kernels
from ..parallel import mesh
from ..utils import perf

__all__ = ["GraphError", "GraphSet", "acquire", "release", "drop_idle",
           "idle", "on_device", "reusing", "set_key"]

_CAPTURE_LOCK = threading.Lock()
_IDLE_LOCK = threading.Lock()
_IDLE: List["GraphSet"] = []
# open reusing() scopes
_REUSING = 0

# the days a rank's host may run ahead of its card on a graphed shard
# over NCCL (2: the card always has the next day queued, and an abort
# finds few days queued behind it)
AHEAD = 2

# the carry's fields on the device (day and weekly_leftover are host
# values, kept by the run loop)
DEVICE_CARRY = tuple(f for f in DayCarry._fields
                     if f not in ("day", "weekly_leftover"))


# the CPU model's gates: spans ended at a collective once the stop word
# was set ("ended"), conditionals whose producer was cut off
# ("skipped"), spans that ran to their end with the word set
# ("completed": none past a collective, so 0 where every span has one)
GATED = Counter()


class _Entry(NamedTuple):
    run: object            # the CUDAGraph, or on the CPU the body
    tally: Counter         # launches (and collectives) of one run
    # on a gated set's card: the span cut after each of its collectives
    # (graphs daygraph.split made)
    pieces: tuple = ()


def on_device(device):
    """A scope in which ``device`` (a CUDA device) is the current device,
    the caller's restored after; nothing for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def shard_key(shard) -> tuple:
    """What a set's graphs depend on of an agent shard: the slab count,
    this slab's number, the backend and the agent group, whose
    communicator the captured collectives use (None: unsharded)."""
    if shard is None:
        return None
    return (shard.k, shard.index, shard.backend,
            getattr(shard.group, "group_name", None))


def set_key(cfg: S.EngineConfig, arrays: S.ModelArrays,
            schedules: Schedules, state: AgentState, carry: DayCarry,
            device, shard=None) -> tuple:
    """What a set's graphs depend on: the engine config, the device, and
    the shapes and dtypes of the model arrays, the schedules less their
    day axis, the state and the carry's device fields; on a shard of the
    agent axis, its :func:`shard_key`."""
    def sig(ts, lead=0):
        return tuple((tuple(t.shape[lead:]), t.dtype) for t in ts)
    return (cfg, torch.device(device), sig(arrays), sig(schedules, 1),
            sig(state), sig(getattr(carry, f) for f in DEVICE_CARRY),
            shard_key(shard))


def host_key(plan: S.DayPlan) -> tuple:
    """What the schedule decides of a day's program."""
    return (plan.ct_active, plan.vacc, plan.imports)


def _variants(nodes):
    """(name, key, span function) of every span of a program at every
    tier, in the program's order."""
    for node in nodes:
        if isinstance(node, S.Span):
            yield node.name, node.key, node.fn
        elif isinstance(node, S.If):
            yield from _variants(node.body)
        else:
            for key in node.keys():
                yield node.name, key, node.fn


class GraphSet:
    """The static buffers, captured spans and day graphs of the builds of
    one key (:func:`set_key`) on one device, for runs of up to ``rows``
    days."""

    def __init__(self, cfg: S.EngineConfig, arrays: S.ModelArrays,
                 schedules: Schedules, state: AgentState, carry: DayCarry,
                 device, shard=None):
        self.key = set_key(cfg, arrays, schedules, state, carry, device,
                           shard)
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = self.device.type != "cuda"
        self.shard = shard
        if shard is not None and not self.model and shard.backend != "nccl":
            raise GraphError(f"the graphed agent axis captures its "
                             f"collectives, which {shard.backend} cannot: "
                             "run it over NCCL, a rank a card")
        days, A, P = schedules.mobility.shape
        self.rows = days
        # the static copies of a build that the spans read (start fills
        # them with each run's); the warm-ups run on the first build's
        self.arrays = S.ModelArrays(*(x.clone() for x in arrays))
        self.mobility = schedules.mobility.clone()
        self.mask_p = schedules.mask_p.clone()
        self.state = AgentState(*(x.clone() for x in state))
        self.carry = {f: getattr(carry, f).clone() for f in DEVICE_CARRY}
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
        # made at the first warm-up of the last span
        self.out_i = self.out_f = None
        self.int_shapes = []
        self.counter = torch.zeros((), dtype=torch.int64, device=dev)
        self.handoff: Dict[str, torch.Tensor] = {}
        self.bodies: Dict[tuple, _Entry] = {}
        self.days: Dict[tuple, object] = {}
        # each conditional node: its picks-table column, its first
        # branch tally and its branches (the If's: not run, run), and the
        # span key of each branch of a switch
        self.layout: Dict[str, tuple] = {}
        self.branch_keys: Dict[str, list] = {}
        slot = 0
        for node in S.conditionals(S.day_program(cfg, True, False, False)):
            n = 2 if isinstance(node, S.If) else len(node.keys())
            self.layout[node.name] = (S.PICK_COLS.index(node.name), slot, n)
            slot += n
            if isinstance(node, S.Switch):
                self.branch_keys[node.name] = node.keys()
        self.picks = torch.full((days, len(S.PICK_COLS)), -1,
                                dtype=torch.int32, device=dev)
        self.tally = torch.zeros(slot, dtype=torch.int32, device=dev)
        # each conditional's handle in the running day graph, a slot a
        # picks-table column (the day graph's head fills it)
        self.handles = torch.zeros(len(S.PICK_COLS), dtype=torch.int64,
                                   device=dev)
        # each fold's conditionals, their picks-table columns and tallies
        self.folds = {}
        for name in FOLDS:
            nodes = fold_nodes(cfg, name)
            lay = [self.layout[node.name] for node in nodes]
            self.folds[name] = (nodes, [c for c, _, _ in lay],
                                [self.tally[s:s + n] for _, s, n in lay])
        self._tallied = np.zeros(slot, np.int64)
        # the events of the last AHEAD days launched on a collective set,
        # oldest first
        self._ahead = deque()
        # what the set's captured days read before each piece of a span
        # on a shard (the model's too)
        self.stop_word = mesh.StopWord(self.collective)
        if not self.model:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(dev)
            if self.collective:
                self._ahead.extend(torch.cuda.Event() for _ in range(AHEAD))
                mesh.hold(shard.group, self)
            if shard is not None:
                # the agent group's communicator is made by its first
                # collective, which a capture cannot hold
                shard.sum(torch.zeros(1, dtype=torch.int32, device=dev))

    @property
    def stop_dev(self):
        """The stop word's device address, which the gates read (None on
        a set without gates)."""
        return self.stop_word.dev

    def stop(self) -> None:
        """Set the stop word: no piece of a captured span runs from here
        on (mesh.give_up, before it aborts the agent group)."""
        self.stop_word.set()

    def fits(self, key: tuple, rows: int) -> bool:
        """Whether a build of ``key`` with ``rows`` schedule rows can run
        on this set."""
        return key == self.key and rows <= self.rows

    # ---- a run

    def prepare(self, host: Schedules, base_key, day0: int, steps: int,
                leftover, n_agents: int) -> List[S.DayPlan]:
        """The plans of days [day0, day0 + steps) of a build whose host
        schedules are ``host`` (``step.plan_days``, one pass over the
        days), and their rows and keys in the device tables (one upload
        a run); their picks unset."""
        if day0 + steps > self.rows:
            raise GraphError(f"days [{day0}, {day0 + steps}) on a set of "
                             f"{self.rows} days")
        rows = slice(day0, day0 + steps)
        dks = S.derive_day_keys(self.cfg, base_key, day0 + np.arange(steps))
        plans = S.plan_days(self.cfg, Schedules(*(x[rows] for x in host)),
                            leftover, day0, dks, n_agents)
        if steps:
            self.tab_i[rows].copy_(torch.from_numpy(plans.ints))
            self.tab_f[rows].copy_(torch.from_numpy(plans.floats))
            self.tab_k[rows].copy_(torch.from_numpy(
                S.key_table(self.cfg, dks).view(np.int32)))
            self.picks[rows].fill_(-1)
        return plans.each()

    def start(self, cfg: S.EngineConfig, arrays: S.ModelArrays,
              schedules: Schedules, state: AgentState, carry: DayCarry,
              day: int, plans: List[S.DayPlan]) -> None:
        """Take a run of a build of the set's key: copy its arrays and
        schedule tables into the set's, build the day graphs ``plans``
        need that the set lacks, then take the run's state and carry
        into the static buffers, from ``day``."""
        key = set_key(cfg, arrays, schedules, state, carry, self.device,
                      self.shard)
        rows = schedules.mobility.shape[0]
        if not self.fits(key, rows):
            parts = ("config", "device", "model arrays", "schedules",
                     "state", "carry", "agent shard")
            differ = [p for p, a, b in zip(parts, key, self.key) if a != b]
            why = (f"its {', '.join(differ)} differ" if differ
                   else f"{rows} days on a set of {self.rows}")
            raise GraphError(f"a build does not fit the set: {why}")
        with on_device(self.device):
            for dst, src in zip(self.arrays, arrays):
                dst.copy_(src)
            self.mobility[:rows].copy_(schedules.mobility)
            self.mask_p[:rows].copy_(schedules.mask_p)
            for plan in plans:
                hkey = host_key(plan)
                if hkey not in self.days:
                    self._build(hkey, plan.day)
            for dst, src in zip(self.state, state):
                dst.copy_(src)
            for f in DEVICE_CARRY:
                self.carry[f].copy_(getattr(carry, f))
            self.counter.fill_(day)

    def step(self, plans: List[S.DayPlan]) -> None:
        """Run the planned days, one day-graph launch each (the state,
        carry, outputs and picks stay on the device). On a shard a day
        that fails, or a wait given up on a peer, gives the agent group
        up before it raises (see the module docstring)."""
        stream = (None if self.model
                  else torch.cuda.current_stream(self.device).cuda_stream)
        launched = 0
        try:
            with on_device(self.device), self._watching() as watch, \
                    mesh.replaying(self if self.model else None):
                for plan in plans:
                    try:
                        self._day(plan, stream,
                                  watch if self.collective else None)
                        if self.model and watch is not None:
                            # the host's look at its peers after a launch
                            watch.check()
                    except BaseException as e:
                        self._give_up(e, f"day {plan.day}")
                        raise
                    launched += 1
        finally:
            perf.count("launches", launched)
            perf.count("days", launched)

    def _day(self, plan: S.DayPlan, stream, watch) -> None:
        hkey = host_key(plan)
        day = self.days.get(hkey)
        if day is None:
            raise GraphError(f"no day graph for host key {hkey}")
        if self.model:
            self._model_day(hkey, day)
            return
        if watch is None:
            day.launch(stream)
            kernels.replayed(day.fixed)
            return
        ev = self._ahead.popleft()
        watch.wait(ev.query)
        day.launch(stream)
        kernels.replayed(day.fixed)
        ev.record(torch.cuda.current_stream(self.device))
        self._ahead.append(ev)

    def settle(self, what: str) -> None:
        """A sync point of a collective set: poll until the card has run
        every day launched, so that the run loop's host read returns at
        once; a peer's failure or loss meanwhile gives the group up and
        raises GraphError naming ``what``."""
        if not self.collective:
            return
        try:
            with on_device(self.device), self.shard.watch() as watch:
                watch.wait(self._ahead[-1].query)
        except BaseException as e:
            self._give_up(e, what)
            raise

    def _give_up(self, e: BaseException, what: str) -> None:
        """On a shard: give the agent group up (``mesh.give_up``), then
        raise GraphError naming ``what`` where ``e`` is a peer's
        failure; the caller re-raises this rank's own."""
        if self.shard is None:
            return
        note = mesh.give_up(self.shard)
        if isinstance(e, mesh.CollectiveError):
            raise GraphError(f"{what}: {e}"
                             + (f"; {note}" if note else "")) from e
        if note:
            e.add_note(note)

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

    def sync_tail(self, a: int, b: int) -> torch.Tensor:
        """The problem bits, the branch tallies and the picks of days
        [a, b) as one int32 tensor, for the run loop's packed fetch."""
        return torch.cat([self.carry["problem"].reshape(1), self.tally,
                          self.picks[a:b].reshape(-1)])

    def synced(self, tail: np.ndarray):
        """Take a fetched ``sync_tail``: the launches of the branches run
        since the last sync point go into ``kernels.LAUNCHES``. Returns
        (the problem bits, the picks rows)."""
        n = self.tally.numel()
        counts = tail[1:1 + n].astype(np.int64)
        delta, self._tallied = counts - self._tallied, counts
        if not self.model:
            for name, keys in self.branch_keys.items():
                _, slot, nb = self.layout[name]
                for b in range(nb):
                    if delta[slot + b]:
                        entry = self.bodies[(name, keys[b])]
                        kernels.replayed(entry.tally, int(delta[slot + b]))
        return int(tail[0]), tail[1 + n:].reshape(-1, len(S.PICK_COLS))

    def state_carry(self, day: int, leftover, bits: int, clone: bool):
        """The run's state and carry now (views of the static buffers, or
        copies), the schedule's problem bits merged into ``problem``."""
        copy = (lambda x: x.clone()) if clone else (lambda x: x)
        cr = {f: copy(t) for f, t in self.carry.items()}
        cr["problem"] = self.carry["problem"] | bits
        return (AgentState(*(copy(x) for x in self.state)),
                DayCarry(day=day, weekly_leftover=leftover, **cr))

    # ---- building a host key's day

    def entry(self, hkey: tuple, name: str, key: tuple) -> _Entry:
        entry = self.bodies.get((name, key))
        if entry is None:
            raise GraphError(f"day graph {hkey}: no capture of span {name} "
                             f"{key}")
        return entry

    def count(self, p: S.Pick) -> torch.Tensor:
        """The 0-d count a pick reads, in its handoff buffer."""
        t = self.handoff[p.src]
        return t if p.idx is None else t[p.idx]

    def _build(self, hkey: tuple, day: int) -> None:
        """Warm up and capture every variant of ``hkey``'s program the set
        lacks (on the static buffers, with day ``day``'s row), then
        assemble its day graph. On a shard every rank of the agent group
        builds the same variants in the same order (their plans are the
        same), and after each warm-up and each capture the ranks agree
        that it was built."""
        nodes = S.day_program(self.cfg, *hkey)
        for name, key, fn in _variants(nodes):
            if (name, key) in self.bodies:
                continue
            body = self._span_body(name, key, fn)
            self.counter.fill_(day)
            what = f"day graph {hkey}: span {name} {key}"
            err = None
            try:
                with kernels.warming(), self._watching():
                    body()
            except Exception as e:
                err = GraphError(f"day graph {hkey}: warm-up of span {name} "
                                 f"{key} failed: {e}")
                err.__cause__ = e
            self._agree(err, what)
            try:
                entry = self.capture(name, key, body)
            except GraphError as e:
                entry, err = None, e
            self._agree(err, what)
            self.bodies[(name, key)] = entry
        perf.count("day_graphs")
        if self.model:
            self.days[hkey] = nodes
            return
        with perf.span("graphs.assemble"):
            self.days[hkey] = DayGraph(hkey, nodes, self)

    def _watching(self):
        return mesh.watching(self.shard)

    def _agree(self, err, what: str) -> None:
        """Raise ``err`` if it is set; on a shard, on every rank of the
        agent group where any rank's is set or a rank is lost
        (``mesh.agree``), each giving the group up (``mesh.give_up``),
        so that no rank goes on to collectives that the others never
        make."""
        if self.shard is not None:
            try:
                failed = mesh.agree(self.shard, err is not None)
            except mesh.CollectiveError as e:
                failed = True
                if err is None:
                    err = GraphError(f"{what}: {e}")
                    err.__cause__ = e
            if failed:
                note = mesh.give_up(self.shard)
                if err is None:
                    err = GraphError(f"{what}: failed on another rank of "
                                     "the agent group")
                if note:
                    err.add_note(note)
        if err is not None:
            raise err

    def _span_body(self, name: str, key: tuple, fn):
        carry = DayCarry(day=None, weekly_leftover=None, **self.carry)

        def body():
            if name in S.FIRST_SPANS:
                self._load_day()
            with kernels.folding(self._sites(not kernels.is_warming())):
                outs = fn(self.cfg, self.arrays, self.din, self.state, carry,
                          self.handoff, *key, shard=self.shard)
            self._commit(name, outs)
        return body

    def _sites(self, armed: bool) -> dict:
        """The fold site of each count (``FOLDS``): its static handoff
        buffer once a warm-up made it, the picks table, the tallies and
        the problem bits; on a card the handle table."""
        return {name: Fold(nodes, cols, tallies, self.picks, self.counter,
                           self.carry["problem"], lookup=self.count,
                           handles=None if self.model else self.handles,
                           out=self.handoff.get(name), armed=armed)
                for name, (nodes, cols, tallies) in self.folds.items()}

    def _load_day(self) -> None:
        i = self.counter.view(1)
        self.din.ints.copy_(self.tab_i.index_select(0, i)[0])
        self.din.floats.copy_(self.tab_f.index_select(0, i)[0])
        self.key_words.copy_(self.tab_k.index_select(0, i)[0])
        self.din.mobility.copy_(self.mobility.index_select(0, i)[0])
        self.din.mask_p.copy_(self.mask_p.index_select(0, i)[0])

    def _commit(self, name: str, outs: dict) -> None:
        """Copy a span's results where the next spans (and days) read
        them."""
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
            return
        for f, t in outs.items():
            h = self.handoff.get(f)
            if h is None:
                if not self.model and torch.cuda.is_current_stream_capturing():
                    raise GraphError(f"span {name} gave {f!r} first under "
                                     "capture")
                self.handoff[f] = t.clone()
            else:
                _copy(h, t, f)

    def capture(self, name: str, key: tuple, body) -> _Entry:
        """Capture ``body`` as span ``name``'s graph at ``key`` (on the CPU
        record it), with the launches it makes."""
        perf.count("captures")
        if self.model:
            return _Entry(body, Counter())
        g = torch.cuda.CUDAGraph(keep_graph=True)
        pieces = ()
        with perf.span("graphs.capture"), _CAPTURE_LOCK:
            try:
                with kernels.capturing(guards=self.collective) as tally:
                    with torch.cuda.graph(g, pool=self.pool,
                                          stream=self.stream,
                                          capture_error_mode="thread_local"):
                        body()
                    guards = kernels.guards()
                check_body_nodes(g.raw_cuda_graph(), f"span {name} {key}")
                if self.collective:
                    pieces = split(g.raw_cuda_graph(), guards,
                                   f"span {name} {key}: its pieces")
            except Exception as e:
                hint = ("" if self.shard is None else
                        " (over NCCL, with NCCL_GRAPH_MIXING_SUPPORT=0 set "
                        "before its communicators are made, as "
                        "mesh.init_distributed sets it, a captured "
                        "collective is kernel and memcpy nodes only)")
                raise GraphError(f"capture of span {name} {key} failed: "
                                 f"{e}{hint}") from e
        return _Entry(g, tally, pieces)

    @property
    def collective(self) -> bool:
        """Whether the set's graphs hold captured collectives."""
        return self.shard is not None and not self.model

    def close(self) -> None:
        """Destroy the set's day graphs and captured spans now (a set on
        an NCCL shard before its communicator is destroyed or aborted; a
        graph still in flight is destroyed once it has run); the set is
        not used again."""
        if self.collective:
            mesh.unhold(self.shard.group, self)
        with _IDLE_LOCK:
            if self in _IDLE:
                _IDLE.remove(self)
        with on_device(self.device):
            for day in self.days.values():
                if not self.model:
                    day.close()
            for entry in self.bodies.values():
                if entry is not None and not self.model:
                    destroy_graphs(entry.pieces)
                    entry.run.reset()
            self.days.clear()
            self.bodies.clear()
            self.stop_word.free()

    def _model_day(self, hkey: tuple, nodes) -> None:
        """The CPU model of a day graph's launch: recorded spans, and the
        branch that the producer's pick twin wrote into the picks table
        choosing each tier."""
        for node in nodes:
            if isinstance(node, S.Span):
                self._model_span(self.entry(hkey, node.name, node.key))
                continue
            col, _, _ = self.layout[node.name]
            branch = int(self.picks[int(self.counter), col])
            if branch < 0 and self.stop_word.is_set():
                # its producer lay past a given-up collective (on the
                # card the node takes a stale branch, whose gated
                # pieces run nothing past their first collective)
                GATED["skipped"] += 1
                continue
            if branch < 0:
                raise GraphError(f"day graph {hkey}: no pick of {node.name} "
                                 "was made before its node")
            if isinstance(node, S.If):
                if branch:
                    self._model_day(hkey, node.body)
            else:
                self._model_span(self.entry(hkey, node.name,
                                            node.keys()[branch]))

    def _model_span(self, entry) -> None:
        """A recorded span; a collective given up in it, or any
        collective once the stop word is set (mesh.Stopped), ends it, as
        the gate after a collective does on the card. A span that runs
        to its end with the word set counts as ``completed``."""
        try:
            entry.run()
        except mesh.Stopped:
            GATED["ended"] += 1
            return
        if self.stop_word.is_set():
            GATED["completed"] += 1


_INT_OUTS = tuple(f for f in S.DayOutputs._fields
                  if f not in ("r", "mobility_limitation"))


def _copy(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    if src is dst:
        return
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise GraphError(f"{what}: {tuple(src.shape)} {src.dtype} into the "
                         f"static {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def acquire(cfg, arrays, schedules, state, carry, device,
            shard=None) -> GraphSet:
    """An idle GraphSet that a build (its config, arrays, schedules,
    state and carry on ``device``; ``shard``: this rank's agent shard)
    fits, or a new one; making a new one frees the device's idle sets.
    The ranks of an agent group make the same calls, so each finds the
    same sets, with the same spans built."""
    key = set_key(cfg, arrays, schedules, state, carry, device, shard)
    rows = schedules.mobility.shape[0]
    with _IDLE_LOCK:
        for i, gs in enumerate(_IDLE):
            if gs.fits(key, rows):
                return _IDLE.pop(i)
        freed = [gs for gs in _IDLE if gs.device == key[1]]
        _IDLE[:] = [gs for gs in _IDLE if gs.device != key[1]]
    for gs in freed:
        gs.close()
    with on_device(device):
        return GraphSet(cfg, arrays, schedules, state, carry, device, shard)


def release(gs: GraphSet) -> None:
    """Return a set whose run has ended for a later run of its build;
    one that holds captured collectives is freed instead, unless a
    :func:`reusing` scope is open."""
    with _IDLE_LOCK:
        if not gs.collective or _REUSING:
            _IDLE.append(gs)
            return
    gs.close()


@contextlib.contextmanager
def reusing():
    """The sets that hold captured collectives (an agent-sharded run
    over NCCL) stay idle between the runs inside this scope, as every
    other set does; when the outermost scope ends they are freed, so
    that the communicators can then be destroyed."""
    global _REUSING
    with _IDLE_LOCK:
        _REUSING += 1
    try:
        yield
    finally:
        with _IDLE_LOCK:
            _REUSING -= 1
            freed = [] if _REUSING else [gs for gs in _IDLE
                                         if gs.collective]
            _IDLE[:] = [gs for gs in _IDLE if gs not in freed]
        for gs in freed:
            gs.close()


def idle() -> List[GraphSet]:
    """The idle sets, in the order acquire tries them."""
    with _IDLE_LOCK:
        return list(_IDLE)


def drop_idle() -> None:
    """Free every idle set."""
    with _IDLE_LOCK:
        freed = list(_IDLE)
        _IDLE.clear()
    for gs in freed:
        gs.close()
