"""Mesh construction, sharding layouts and collectives over
torch.distributed (port of reina_tpu/parallel/mesh.py).

The reference's parallelism is OS processes: an 8-way multiprocessing
pool for Monte-Carlo ensembles (calc/simulation.py:376-377). Here one
process runs on one device (a rank), and the world's ranks form a
(seed × agent) mesh, as the JAX package's device mesh does:

  * ``seed``  — ensemble members and grid points: each agent group runs
                its share of them, one after another, and every rank
                returns all of them in the caller's order;
  * ``agent`` — one run's population split into contiguous slabs, one a
                rank of an agent group (``AgentShard``). The day step
                (core/step.py) runs on the slab; its cross-agent points
                become the collectives below: sums of counts and
                histograms, the ledger's and the prefix's sharded forms,
                lookups of per-agent values at global indices and
                scatters that only the owner applies. Every result is
                bit-identical to the unsharded run's.

Ranks of an agent group form one process group, and so do ranks of a
seed group; both are made on every rank in the same order. A collective
on CUDA tensors over gloo (several ranks sharing one card) is staged
through host memory on purpose, and counted as staged (``STATS``).

Over NCCL the day's collectives can be captured into CUDA graphs (the
graphed agent axis, core/graphs.py): each is one NCCL call on buffers
made on the device, an all-reduce in place on a tensor of its own and an
``all_gather_into_tensor`` into one buffer, with no host staging and no
list of parts. A collective captured over gloo raises CollectiveError.
While a thread captures, its collectives go into the capture's tally
(``kernels.capture_tally``, as ``mesh.calls`` and ``mesh.bytes``), and
each replay adds them to ``kernels.REPLAYED``, which :func:`stats` adds
to ``STATS``, as kernels.LAUNCHES counts a graph's launches.

The ranks of an agent group build a graph set span by span together,
and tell one another through the world's store, not a collective,
whether each span was built (:func:`agree`): a rank whose warm-up fails
may leave a collective that its peers wait in. Its failure mark in the
store ends the peers' waits inside collectives (:func:`watching`), and
every rank then aborts the group's communicator, which ends what it
left on its card, so that all raise and none hangs.

The same holds for a whole run on a mesh (core/engine.py:run_days,
core/graphs.py). A rank that fails anywhere in it follows one policy,
:func:`give_up`: it marks its agent group and its mesh failed in the
store, aborts the group's communicator and frees the graphs that hold
the group's captured collectives. Every rank of a world keeps a
heartbeat in the store (:func:`make_mesh` starts it), and a peer whose
heartbeat has not moved for ``LIVENESS_S`` seconds counts as lost. Each
wait of a rank on its peers is a poll on the host that gives up
(CollectiveError) on a failure mark, a lost peer or a store that no
longer answers (:class:`Watch`, whose thread asks the store, so that a
poll costs the waiting thread no store round trip): a collective that
blocks the host (over gloo; an NCCL collective is queued on the card
and the host waits at its next read, :meth:`AgentShard.before_read`),
an agreement, the sync points and the bounded run-ahead of a graphed
shard (core/graphs.py), and the world's gather of the seed axis
(:func:`gather_placed`), a sharded checkpoint's gathers and its
agreement that the file is written (:meth:`AgentShard.barrier`), so that
a failure in one agent group of a (seed × agent) mesh makes every rank
raise.

The bootstrap is watched too. :func:`init_distributed` starts the
heartbeat as soon as the world exists, and :func:`make_mesh`, before it
makes any group, waits through the store until every rank of the world
has arrived (a Watch poll: a rank that never arrives or whose heartbeat
stops raises CollectiveError within ``LIVENESS_S``). Over NCCL it then
makes every communicator of the mesh at once, while every rank is
there, each by one eager collective on a thread of its own that a Watch
waits for: NCCL's bootstrap blocks its thread on a lost peer, where no
poll reaches, so the waiting thread gives up instead and aborts the
groups.

A graphed shard's captured days read a stop word (:class:`StopWord`,
host-mapped memory that each graph set on a card holds) after each
collective: :func:`give_up` sets it in every set that holds the group's
captured collectives before it aborts the group, so that nothing the
aborted collectives fed runs on the card: not the rest of the day in
flight, nor the days queued behind it (core/graphs.py). The card stays
usable.
"""
from __future__ import annotations

import ctypes
import math
import os
import pickle
import threading
import time
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels

LANE = 128

# collectives issued by this process: calls and payload bytes, and the
# part of them staged through host memory (gloo on CUDA tensors)
STATS = {"calls": 0, "bytes": 0, "staged_calls": 0, "staged_bytes": 0}


# a peer whose heartbeat in the world's store has not moved for this many
# seconds counts as lost: far above any host stall of a healthy run (a
# test may lower it in its own child)
LIVENESS_S = 30.0
# each rank of a world adds one to its heartbeat this often
HEARTBEAT_S = 1.0
# a Watch's thread asks the store this often
_ASK_S = 0.05
# after an abort, the seconds a rank waits for its card to run what was
# queued before it, and for the abort to return (:func:`give_up`)
DRAIN_S = 10.0

_LOCK = threading.Lock()
# this thread's (Watch, whether it waits for collectives on a card)
# (:func:`watching`)
_watch = threading.local()
# rounds of words in the store (:func:`_words`), by their keys' prefix
_AGREED = Counter()
# the groups this process has aborted, by name
_ABORTED = set()
# what holds captured collectives of a group (graph sets), by group
# name: freed by :func:`give_up` while it aborts the group
_HOLDERS = {}
# each peer's heartbeat as last read: world rank -> (count, monotonic
# time it was first read at that count)
_SEEN = {}
_BEAT = {"thread": None}


class CollectiveError(RuntimeError):
    """A collective that cannot run as asked: one over gloo met under a
    CUDA graph capture, or a wait given up because another rank failed
    or is lost (:class:`Watch`)."""


def reset_stats() -> None:
    with _LOCK:
        for k in STATS:
            STATS[k] = 0
        for k in ("calls", "bytes"):
            kernels.REPLAYED.pop("mesh." + k, None)


def stats() -> dict:
    """``STATS`` with the collectives of the replayed graphs."""
    with _LOCK:
        out = dict(STATS)
        for k in ("calls", "bytes"):
            out[k] += kernels.REPLAYED.get("mesh." + k, 0)
        return out


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> int:
    """Join the world of ranks; returns its size.

    The coordinator, the world size and this rank come from the
    arguments, else from ``REINA_COORDINATOR`` / ``REINA_NUM_PROCESSES``
    / ``REINA_PROCESS_ID`` (the JAX package's variables), else from
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``. With none of them set it does nothing and returns 1. A
    coordinator is ``host:port`` or an init-method URL (``tcp://``,
    ``file://``). ``backend=None`` means ``nccl`` when CUDA is available
    and ``gloo`` otherwise; pass ``gloo`` for several ranks on one card.

    Over NCCL it sets ``NCCL_GRAPH_MIXING_SUPPORT=0`` (unless the
    environment sets it) before any communicator exists: with NCCL's
    support for mixing graph and eager launches a captured collective
    brings event record and wait nodes, which a conditional node's body
    cannot hold (kernels/nccl_parts.py); without it a capture is kernel
    and memcpy nodes, and the run loop launches no eager collective on a
    communicator while a day graph is outstanding (it fetches first). A
    process group made elsewhere needs the same setting for the graphed
    agent axis. In a world of several ranks it starts this process's
    heartbeat in the world's store (:func:`make_mesh` watches it).
    """
    env = os.environ
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    coordinator_address = coordinator_address or env.get("REINA_COORDINATOR")
    torchrun = "MASTER_ADDR" in env and "WORLD_SIZE" in env
    if coordinator_address is None and not torchrun:
        return 1
    if num_processes is None:
        num_processes = int(env.get("REINA_NUM_PROCESSES")
                            or env.get("WORLD_SIZE") or 1)
    if process_id is None:
        process_id = int(env.get("REINA_PROCESS_ID") or env.get("RANK") or 0)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "0")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    if dist.get_world_size() > 1:
        _heartbeat()
    return dist.get_world_size()


@dataclass
class Mesh:
    """This rank's place in the (n_seed, n_agent) grid of the world's
    ranks (rank = seed_index · n_agent + agent_index), its device and
    its two process groups: the agent group (the ranks of its seed
    index, which split one run's agents) and the seed group (the ranks
    of its agent index, one from each agent group)."""
    n_seed: int
    n_agent: int
    rank: int
    seed_index: int
    agent_index: int
    device: torch.device
    backend: Optional[str]
    agent_group: Any
    seed_group: Any
    # the prefix of the mesh's keys in the world's store (None: no world)
    name: Optional[str] = None


def make_mesh(n_seed: Optional[int] = None, n_agent: Optional[int] = None,
              device=None) -> Mesh:
    """Reshape the world's ranks into (n_seed, n_agent), as the JAX
    package's ``make_mesh`` reshapes its devices (all seed by default).
    ``device``: this rank's device, ``cuda:LOCAL_RANK`` by default. In a
    world of several ranks it starts this process's heartbeat, waits
    until every rank of the world has arrived (:func:`_arrive`: a rank
    lost before it raises CollectiveError on the others) and, over NCCL,
    makes the communicators of this rank's two groups (:func:`_connect`,
    watched as well)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_seed is None and n_agent is None:
        n_seed, n_agent = world, 1
    elif n_seed is None:
        n_seed = world // n_agent
    elif n_agent is None:
        n_agent = world // n_seed
    if n_seed < 1 or n_agent < 1 or n_seed * n_agent != world:
        raise ValueError(f"a world of {world} ranks does not factor as "
                         f"{n_seed} seed × {n_agent} agent")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    agent_group = seed_group = name = None
    backend = dist.get_backend() if world > 1 else None
    if world > 1:
        # every rank creates every group, in the same order; the count
        # of groups made before them, the same on every rank, names the
        # mesh
        name = f"reina/mesh/{dist.distributed_c10d._world.group_count}"
        _heartbeat()
        _arrive(name, world)
        for s in range(n_seed):
            g = dist.new_group([s * n_agent + a for a in range(n_agent)])
            if s == rank // n_agent:
                agent_group = g
        for a in range(n_agent):
            g = dist.new_group([s * n_agent + a for s in range(n_seed)])
            if a == rank % n_agent:
                seed_group = g
        if backend == "nccl":
            _connect(name, device, [g for g, size in ((agent_group, n_agent),
                                                      (seed_group, n_seed))
                                    if size > 1])
    return Mesh(n_seed=n_seed, n_agent=n_agent, rank=rank,
                seed_index=rank // n_agent, agent_index=rank % n_agent,
                device=device, backend=backend,
                agent_group=agent_group, seed_group=seed_group, name=name)


def _arrive(name: str, world: int) -> None:
    """Wait, through the world's store, until every rank of the world has
    reached the making of mesh ``name``: a Watch poll on every rank's
    heartbeat, so that a rank that never arrives (lost before it, or
    never started) makes the others raise CollectiveError within
    ``LIVENESS_S``, before any group's rendezvous or communicator could
    block on it."""
    _words(name + "/arrived", dist.get_rank(), world, b"1",
           Watch([(name + "/failed", "another rank of the mesh failed")],
                 range(world), "world"))


def _connect(name: str, device, groups) -> None:
    """Make the NCCL communicators of ``groups`` now, by one eager
    collective each on a thread of its own (NCCL's bootstrap blocks its
    thread on a lost peer, where no poll reaches), while a Watch on the
    world waits for it: a rank lost meanwhile makes this one abort the
    groups and raise CollectiveError."""
    if not groups:
        return
    done, failed = threading.Event(), []

    def bootstrap():
        try:
            with torch.cuda.device(device):
                for g in groups:
                    dist.all_reduce(torch.zeros(1, device=device), group=g)
                torch.cuda.synchronize(device)
        except BaseException as e:       # reported on the waiting thread
            failed.append(e)
        done.set()

    t = threading.Thread(target=bootstrap, name="reina-bootstrap",
                         daemon=True)
    t.start()
    try:
        with Watch([(name + "/failed", "another rank of the mesh failed")],
                   range(dist.get_world_size()), "world") as w:
            w.wait(done.is_set, poll=1e-3)
    except CollectiveError:
        _mark_mesh(name)
        for g in groups:
            threading.Thread(target=_abort_quietly, args=(g,),
                             name="reina-abort", daemon=True).start()
        raise
    if failed:
        raise failed[0]


def _abort_quietly(group) -> None:
    try:
        dist.distributed_c10d._abort_process_group(group)
    except BaseException:   # the group's bootstrap failed: nothing to end
        pass


# ---------------------------------------------------------------------------
# collectives (every one counted in STATS)

def _staged(t: torch.Tensor, backend) -> bool:
    return backend == "gloo" and t.is_cuda


def _count(t: torch.Tensor, staged: bool, backend, factor: int = 1) -> None:
    nbytes = t.numel() * t.element_size() * factor
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        if backend != "nccl":
            raise CollectiveError(f"a collective over {backend} cannot be "
                                  "captured into a CUDA graph (NCCL can)")
        tally = kernels.capture_tally()
        if tally is not None:
            tally["mesh.calls"] += 1
            tally["mesh.bytes"] += nbytes
            return
    with _LOCK:
        STATS["calls"] += 1
        STATS["bytes"] += nbytes
        if staged:
            STATS["staged_calls"] += 1
            STATS["staged_bytes"] += nbytes


def all_reduce(t: torch.Tensor, group, backend, op=dist.ReduceOp.SUM):
    """The reduction of ``t`` over ``group``, in ``t`` itself (a
    contiguous tensor that the caller made for it); returns ``t``."""
    _stopped()
    staged = _staged(t, backend)
    _count(t, staged, backend)
    w = _watched(t)
    if not staged:
        _wait(dist.all_reduce(t, op=op, group=group, async_op=w is not None),
              w)
        _guard(t)
        return t
    buf = t.cpu()
    _wait(dist.all_reduce(buf, op=op, group=group, async_op=w is not None), w)
    return t.copy_(buf)


def all_gather(t: torch.Tensor, group, backend) -> torch.Tensor:
    """(k, *t.shape): ``t`` of every rank of ``group``, in rank order,
    by one ``all_gather_into_tensor`` into a buffer made here."""
    _stopped()
    k = dist.get_world_size(group)
    staged = _staged(t, backend)
    _count(t, staged, backend, k)
    src = t.cpu() if staged else t.contiguous()
    buf = torch.empty(k * t.numel(), dtype=t.dtype, device=src.device)
    w = _watched(t)
    _wait(dist.all_gather_into_tensor(buf, src.reshape(-1), group=group,
                                      async_op=w is not None), w)
    _guard(t)
    return buf.to(t.device).view((k,) + tuple(t.shape))


def _guard(t: torch.Tensor) -> None:
    """Under a capture on a card: the collective just captured ends a
    piece of its span, after which the span's stop-word gate goes."""
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        kernels.guard_point(torch.cuda.current_stream(t.device).cuda_stream)


def _watched(t: torch.Tensor) -> Optional["Watch"]:
    """This thread's Watch where ``t``'s collective blocks the host (on
    the CPU: gloo's), or is a card's while the watch covers those (a
    span's warm-up); never one under capture. An NCCL collective of a
    run is queued on the card, and the host waits at its next read
    (:meth:`AgentShard.before_read`)."""
    w, cards = getattr(_watch, "current", None) or (None, False)
    if w is not None and t.is_cuda and (
            not cards or torch.cuda.is_current_stream_capturing()):
        return None
    return w


def _wait(work, watch: Optional["Watch"]) -> None:
    """Wait for a collective issued with ``async_op=watch is not
    None``: poll it on the host, giving it up (CollectiveError) as soon
    as ``watch`` sees a peer's failure. A collective that fails itself
    (gloo's, when a peer's process ends) raises the peer's failure where
    the store already shows it, else its own error. In a replay of a
    graph set's CPU model a peer's failure stops the set instead
    (:class:`Stopped`)."""
    if work is None:
        return
    try:
        watch.wait(work.is_completed)
        try:
            work.wait()
        except RuntimeError:
            watch.look()
            raise
    except CollectiveError:
        _stopped_replay()
        raise


class Stopped(CollectiveError):
    """A collective of a graph set's CPU model given up in a replay: as an
    aborted NCCL collective returns on the card, after which the set's
    stop word ends the span and skips every later one (core/graphs.py)."""


def _stopped_replay() -> None:
    """In the replay of a graph set's CPU model (``_watch.replay``): set
    the set's stop word, as the card's host does before it aborts the
    group, and end the span in flight (Stopped)."""
    gs = getattr(_watch, "replay", None)
    if gs is not None:
        gs.stop_word.set()
        raise Stopped("a collective of the day in flight was given up: "
                      "the stop word ends the span")


def _stopped() -> None:
    """In a replay of a graph set's CPU model whose stop word is set: end
    the span at this collective (Stopped), as on the card the gate after
    a collective of an aborted group runs nothing."""
    gs = getattr(_watch, "replay", None)
    if gs is not None and gs.stop_word.is_set():
        raise Stopped("the stop word is set: the span ends at its "
                      "collective")


class StopWord:
    """A graph set's stop word: on a card one int in host-mapped pinned
    memory (``dev``: its device address, which the captured days' gate
    kernels read), set by the host without going through a stream, so
    that it takes effect while the card is stuck behind an aborted
    collective; on the CPU a flag (the graph runner's model)."""

    def __init__(self, card: bool):
        self.host = self.dev = None
        self._set = False
        if card:
            from ..kernels import build
            host, dev = ctypes.c_void_p(), ctypes.c_void_p()
            build.check(build.lib().reina_stop_alloc(ctypes.byref(host),
                                                     ctypes.byref(dev)),
                        "stop word")
            self.host, self.dev = host.value, dev.value

    def set(self) -> None:
        self._set = True
        if self.host is not None:
            ctypes.c_int.from_address(self.host).value = 1

    def is_set(self) -> bool:
        return self._set

    def free(self) -> None:
        if self.host is not None:
            from ..kernels import build
            build.lib().reina_stop_free(self.host)
            self.host = self.dev = None


def _store():
    return dist.distributed_c10d._get_default_store()


def _alive_key(rank: int) -> str:
    return f"reina/alive/{rank}"


def _heartbeat() -> None:
    """Start this process's heartbeat, once: a daemon thread that adds
    one to its key in the world's store every ``HEARTBEAT_S`` seconds
    while the world's process group exists."""
    with _LOCK:
        t = _BEAT["thread"]
        if t is not None and t.is_alive():
            return
        t = _BEAT["thread"] = threading.Thread(
            target=_beat, name="reina-heartbeat", daemon=True)
    t.start()


def _beat() -> None:
    while dist.is_initialized():
        try:
            _store().add(_alive_key(dist.get_rank()), 1)
        except (RuntimeError, ValueError):
            return      # the world ended under us
        time.sleep(HEARTBEAT_S)


class Watch:
    """What a rank's wait on its peers gives up on (CollectiveError): a
    failure mark in the world's store (``marks``: (key, why)), a peer of
    ``peers`` (world ranks) whose heartbeat has not moved for
    ``LIVENESS_S`` seconds, or a store that no longer answers (rank 0,
    which hosts a TCPStore, may be the rank lost). ``scope`` names the
    peers in the messages. Inside ``with`` a thread of its own asks the
    store every ``_ASK_S`` seconds, so that :meth:`check` and
    :meth:`wait` cost the waiting thread no round trip."""

    def __init__(self, marks, peers, scope: str, store=None,
                 rank: Optional[int] = None):
        self.store = _store() if store is None else store
        rank = dist.get_rank() if rank is None else rank
        self.marks = list(marks)
        self.peers = [p for p in peers if p != rank]
        self.scope = scope
        # what the watch gave up on (a message: an exception kept here
        # would keep its frames, and a collective's work, alive)
        self.error: Optional[str] = None
        self._stop = threading.Event()
        self._asker = None

    def __enter__(self) -> "Watch":
        self._asker = threading.Thread(target=self._ask_loop,
                                       name="reina-watch", daemon=True)
        self._asker.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        # a store that stopped answering may hold the thread in a call
        self._asker.join(1.0)

    def _ask_loop(self) -> None:
        while not self._stop.wait(_ASK_S):
            try:
                self.look()
            except CollectiveError:
                return

    def _ask(self, fn, *args):
        try:
            return fn(*args)
        except (RuntimeError, OSError) as e:
            raise CollectiveError(
                f"given up: another rank of the {self.scope} failed: the "
                f"world's store stopped answering ({e})") from e

    def look(self) -> None:
        """Ask the store now: raise CollectiveError (and keep its message
        for :meth:`check`) on a failure mark or a lost peer."""
        self.check()
        try:
            for key, why in self.marks:
                if self._ask(self.store.check, [key]):
                    raise CollectiveError(f"given up: {why}")
            t = time.monotonic()
            for p in self.peers:
                n = self._ask(self.store.add, _alive_key(p), 0)
                seen = _SEEN.get(p)
                if seen is None or seen[0] != n:
                    _SEEN[p] = (n, t)
                elif t - seen[1] > LIVENESS_S:
                    raise CollectiveError(
                        f"given up: another rank of the {self.scope} "
                        f"failed: rank {p} is lost (its heartbeat has not "
                        f"moved for {t - seen[1]:.1f} s; bound "
                        f"{LIVENESS_S:g} s)")
        except CollectiveError as e:
            self.error = str(e)
            raise

    def check(self) -> None:
        """Raise what the thread found, if anything."""
        if self.error is not None:
            raise CollectiveError(self.error)

    def wait(self, done, poll: float = 1e-4) -> None:
        """Poll ``done()`` every ``poll`` seconds until it is true,
        checking meanwhile."""
        while not done():
            self.check()
            time.sleep(poll)


def _keys(shard) -> str:
    return "reina/agent_group/" + str(getattr(shard.group, "group_name",
                                              None))


def _in_world(x) -> bool:
    return (x is not None and getattr(x, "name", None) is not None
            and dist.is_initialized())


@contextmanager
def watching(shard, cards: bool = True):
    """This thread's waits on ``shard``'s agent group meanwhile give up
    as soon as another rank of the group or of the mesh marks a failure,
    or a rank of the group is lost (``shard.watch()``): a rank that
    fails halfway through a span's warm-up or a day leaves its peers in
    a collective that it never makes. A collective that blocks the host
    (on the CPU) waits on the host; one on a card does where ``cards``
    (a span's warm-up), else it is queued and the host waits at its next
    read (:meth:`AgentShard.before_read`, the plain step's). Never one
    under capture. Yields the Watch; nothing changes without a shard in
    a world (it yields None)."""
    if not _in_world(shard):
        yield None
        return
    prev = getattr(_watch, "current", None)
    with shard.watch() as w:
        _watch.current = (w, cards)
        try:
            yield w
        finally:
            _watch.current = prev


@contextmanager
def replaying(gs):
    """This thread meanwhile replays graph set ``gs``'s CPU model (None:
    nothing): a watched collective given up in it stops the set
    (:func:`_stopped_replay`)."""
    prev = getattr(_watch, "replay", None)
    _watch.replay = gs
    try:
        yield
    finally:
        _watch.replay = prev


def hold(group, holder) -> None:
    """Note that ``holder`` (a graph set, with ``close()``) holds
    captured collectives of ``group``: :func:`give_up` frees it."""
    with _LOCK:
        _HOLDERS.setdefault(group.group_name, []).append(holder)


def unhold(group, holder) -> None:
    with _LOCK:
        held = _HOLDERS.get(group.group_name, [])
        if holder in held:
            held.remove(holder)


def _mark(where) -> None:
    if isinstance(where, AgentShard):
        _store().set(_keys(where) + "/failed", b"1")
    _mark_mesh(where.name)


def _mark_mesh(name: str) -> None:
    _store().set(name + "/failed", b"1")


def give_up(where, group=None) -> Optional[str]:
    """The one failure policy of a run on a mesh: this rank leaves its
    run on ``where`` (a Mesh, or an AgentShard) after a failure. (1) It
    marks the failure in the world's store, the mesh's and an
    AgentShard's agent group's: every peer's watched wait then gives up.
    (2) It aborts ``group`` (an AgentShard's agent group by default, a
    Mesh's none), which ends the collectives left on the card; the group
    is not used again. (3) It frees what holds captured collectives of
    the group (:func:`hold`). Before the abort it sets each holder's
    stop word (``stop()``), which every captured span reads after each
    of its collectives: what the aborted
    collectives left in their buffers then feeds nothing on the card,
    and the days queued behind run no span. NCCL's abort sets its flag
    at once, which ends the captured collectives on the card, and then
    returns only once every graph that holds one of them is destroyed,
    as its teardown does; and a graph in flight cannot be destroyed
    until it has run. So the abort runs on a thread while the card runs
    out what was queued (``DRAIN_S`` at most; the stopped days take
    microseconds), then the holders are freed and the abort joined.
    Once a group; nothing without a world. Returns None, or what went
    wrong after the abort, for the caller's error: the card's CUDA
    context ended (the holders are freed all the same), or the card or
    the abort not done within ``DRAIN_S`` (the holders are left as they
    are: freeing a graph in flight waits for it)."""
    if not _in_world(where):
        return None
    _mark(where)
    if group is None and isinstance(where, AgentShard):
        group = where.group
    if group is None:
        return None
    with _LOCK:
        if group.group_name in _ABORTED:
            return None
        _ABORTED.add(group.group_name)
        held = _HOLDERS.pop(group.group_name, [])
    for h in held:
        h.stop()
    if not held:
        dist.distributed_c10d._abort_process_group(group)
        return None
    failed = []

    def abort():
        try:
            dist.distributed_c10d._abort_process_group(group)
        except BaseException as e:       # reported below, on this thread
            failed.append(e)

    t = threading.Thread(target=abort, name="reina-abort", daemon=True)
    t.start()
    note = None
    end = time.monotonic() + DRAIN_S
    try:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(where.device))
        while not ev.query():
            if time.monotonic() > end:
                return (f"the card did not run the days queued before the "
                        f"agent group's abort within {DRAIN_S:g} s")
            time.sleep(1e-3)
    except RuntimeError as e:
        note = (f"after the agent group's abort the card's CUDA context "
                f"ended ({str(e).strip().splitlines()[0]}): this process "
                "cannot use its card again")
    for h in held:
        h.close()
    t.join(max(end - time.monotonic(), 1.0))
    if t.is_alive():
        return ((note + "; ") if note else "") + (
            f"the agent group's abort did not return within {DRAIN_S:g} s")
    if failed and note is None:
        note = f"the agent group's abort failed ({failed[0]})"
    return note


def agree(shard, failed: bool) -> bool:
    """Whether any rank of ``shard``'s agent group failed a step that
    every rank of it makes (a graph set's warm-up or capture of one
    span), from every rank's word in the world's store. A rank that
    failed marks it first, which ends its peers' watched waits; where
    any failed, every rank then gives the group up (:func:`give_up`)
    and the group is not used again. A peer lost before its word raises
    CollectiveError. Without a world it returns ``failed``."""
    if not _in_world(shard):
        return failed
    if failed:
        _mark(shard)
    return b"1" in _words(_keys(shard), shard.index, shard.k,
                          b"1" if failed else b"0",
                          Watch([], shard.ranks, "agent group"))


def _words(base: str, index: int, k: int, word: bytes, watch: Watch) -> list:
    """Write this rank's ``word`` as number ``index`` of the next round
    of ``base``'s words in the world's store, then wait (``watch``'s
    poll) until all ``k`` of the round are there; returns them in
    order."""
    store = _store()
    with _LOCK:
        seq = _AGREED[base]
        _AGREED[base] += 1
    store.set(f"{base}/{seq}/{index}", word)
    keys = [f"{base}/{seq}/{j}" for j in range(k)]
    with watch as w:
        w.wait(lambda: store.check(keys), poll=1e-3)
    return [store.get(x) for x in keys]


def gather_objects(obj, group, watch: Watch, device) -> list:
    """Every rank's ``obj`` over ``group``, in rank order (pickled): its
    size, then its bytes padded to the largest, by two
    ``all_gather_into_tensor``s (over NCCL on ``device``, the rank's
    card, whatever device is current), each waited for by ``watch``."""
    k = dist.get_world_size(group)
    with _LOCK:
        STATS["calls"] += 1
    dev = (torch.device(device) if dist.get_backend(group) == "nccl"
           else torch.device("cpu"))
    data = pickle.dumps(obj)
    sizes = torch.empty(k, dtype=torch.int64, device=dev)
    _wait(dist.all_gather_into_tensor(
        sizes, torch.tensor([len(data)], dtype=torch.int64, device=dev),
        group=group, async_op=True), watch)
    sizes = sizes.tolist()
    buf = torch.zeros(max(sizes), dtype=torch.uint8)
    buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    out = torch.empty(k * buf.numel(), dtype=torch.uint8, device=dev)
    _wait(dist.all_gather_into_tensor(out, buf.to(dev), group=group,
                                      async_op=True), watch)
    out = out.cpu().view(k, -1).numpy()
    return [pickle.loads(out[j, :n].tobytes()) for j, n in enumerate(sizes)]


# ---------------------------------------------------------------------------
# the agent axis

def check_shard_rule(n: int, k: int) -> None:
    """Slabs are contiguous and equal: N % (k·128) == 0 and N % 1024 ==
    0, so a slab is whole rows of the prefix's global layout and every
    slab's streams stay 16-byte aligned. Raises ValueError otherwise."""
    if n % (k * LANE) or n % (8 * LANE):
        need = math.lcm(8 * LANE, k * LANE)
        raise ValueError(
            f"{n} agents do not split into {k} slabs of whole rows of "
            f"{LANE}: build the run with a pad_multiple that is a multiple "
            f"of {need} (build_run(..., pad_multiple={need}))")


class AgentShard:
    """This rank's slab [lo, hi) of a run's N agents (slab ``index`` of
    ``k``) and the collectives of its agent group that the day step
    uses. Per-agent tensors of the step hold the slab; indices into the
    agent axis stay global (sentinel N)."""

    def __init__(self, mesh: Mesh, n: int):
        k = mesh.n_agent
        check_shard_rule(n, k)
        self.n, self.k, self.index = n, k, mesh.agent_index
        self.n_local = n // k
        self.lo = self.index * self.n_local
        self.hi = self.lo + self.n_local
        self.group, self.backend = mesh.agent_group, mesh.backend
        self.device = mesh.device
        # the mesh's keys in the store, and the group's world ranks
        self.name = mesh.name
        self.ranks = (dist.get_process_group_ranks(self.group)
                      if _in_world(mesh) else [])

    def watch(self) -> Watch:
        """What a wait of this rank on its agent group gives up on: a
        failure mark of the group or of the mesh, a lost rank of the
        group."""
        return Watch([(_keys(self) + "/failed",
                       "another rank of the agent group failed"),
                      (self.name + "/failed",
                       "another rank of the mesh failed")],
                     self.ranks, "agent group")

    def before_read(self, t: torch.Tensor) -> None:
        """Before a host read of ``t``: while a run on the shard is
        watched (:func:`watching`) and ``t`` is on a card, poll until the
        card has run what was queued so far, giving up on a peer's
        failure or loss; the read would block behind a collective that a
        failed or lost peer never makes."""
        cur = getattr(_watch, "current", None)
        if cur is None or not t.is_cuda:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        cur[0].wait(ev.query)

    # -- reductions

    def sum(self, *xs):
        """Each of ``xs`` summed over the group, in int32 (exact for
        counts; float histograms are cast, summed and cast back), in
        one all-reduce. Returns one tensor, or a list for several."""
        parts = [x.reshape(-1).to(torch.int32) for x in xs]
        tot = all_reduce(torch.cat(parts), self.group, self.backend)
        out, at = [], 0
        for x, p in zip(xs, parts):
            out.append(tot[at:at + p.numel()].reshape(x.shape).to(x.dtype))
            at += p.numel()
        return out[0] if len(out) == 1 else out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return all_gather(t, self.group, self.backend)

    # -- global indices

    def local(self, idx, scale: int = 1):
        """Global indices into an array of ``scale`` entries an agent →
        this slab's local indices; indices of other slabs (and the
        sentinel N·scale) → the spare entry n_local·scale."""
        lo, hi = self.lo * scale, self.hi * scale
        own = (idx >= lo) & (idx < hi)
        return torch.where(own, idx - lo, self.n_local * scale)

    def lookup(self, arrays: Sequence[torch.Tensor], idx, scale: int = 1):
        """[a[idx] for a in arrays] at global indices: the owner of each
        index fills its value, the others 0, and one int32 sum over the
        group replicates them (float32 travels as its bits). ``scale``:
        entries an agent (the flat bucket table: CAPB)."""
        lo = self.lo * scale
        size = self.n_local * scale
        own = (idx >= lo) & (idx < lo + size)
        li = torch.clamp(idx - lo, 0, size - 1).long()
        vals = [self._bits(a[li]) for a in arrays]
        tot = self.sum(*[torch.where(own, v, 0) for v in vals])
        tot = tot if len(arrays) > 1 else [tot]
        return [self._unbits(t, a.dtype) for t, a in zip(tot, arrays)]

    def lookup_segments(self, seg_local, idx):
        """``cat(segments)[idx]`` for the global (n_seg·N,) concatenation
        of per-agent segments, from this slab's (n_seg·n_local,) part
        (segment s at [s·n_local, (s+1)·n_local))."""
        s, i = idx // self.n, idx % self.n
        own = (i >= self.lo) & (i < self.hi)
        li = torch.where(own, s * self.n_local + i - self.lo, 0).long()
        v = torch.where(own, self._bits(seg_local[li]), 0)
        return self._unbits(self.sum(v), seg_local.dtype)

    def first_at_least(self, seg_local, values, n_seg: int = 1):
        """searchsorted(side="left") of ``values`` in the global
        nondecreasing (n_seg·N,) concatenation whose slab part is
        ``seg_local``: the first local position, mapped to its global
        index (n_seg·N where none), then the minimum over the group."""
        nl = self.n_local
        p = torch.searchsorted(seg_local, values.to(seg_local.dtype)
                               .contiguous()).to(torch.int64)
        g = (p // nl) * self.n + self.lo + p % nl
        g = torch.where(p < n_seg * nl, g, n_seg * self.n)
        return all_reduce(g, self.group, self.backend, dist.ReduceOp.MIN)

    @staticmethod
    def _bits(x):
        if x.dtype == torch.float32:
            return x.view(torch.int32)
        return x.to(torch.int32)

    @staticmethod
    def _unbits(x, dtype):
        if dtype == torch.float32:
            return x.view(torch.float32)
        return x.to(dtype)

    # -- whole state (checkpoints)

    def barrier(self) -> None:
        """Wait until every rank of the agent group has reached this
        point, through the world's store (a word a rank), polled by
        :meth:`watch`: a failure mark or a lost rank meanwhile raises
        CollectiveError. Never a collective that blocks the host."""
        if _in_world(self):
            _words(_keys(self) + "/barrier", self.index, self.k, b"1",
                   self.watch())

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The full (N, ...) tensor from every rank's (n_local, ...)
        slab, as bytes over the group."""
        b = t.contiguous().view(torch.uint8)
        allb = self.all_gather(b.reshape(-1))
        return allb.reshape(-1).view(t.dtype).reshape(
            (self.n,) + tuple(t.shape[1:]))


def _slab(x, n: int, lo: int, hi: int, capb: int, device):
    """A leaf of a run on the slab [lo, hi): (N, …) leaves split on axis
    0, (V, N) tables on axis 1, the flat (N·CAPB + 1,) bucket table as
    whole rows plus its spare slot; everything else replicated."""
    if not isinstance(x, torch.Tensor):
        return x
    if x.dim() >= 1 and x.shape[0] == n:
        x = x[lo:hi]
    elif x.dim() == 1 and x.shape[0] == n * capb + 1:
        x = torch.cat([x[lo * capb:hi * capb], x[-1:]])
    elif x.dim() >= 2 and x.shape[1] == n:
        x = x[:, lo:hi]
    return x.to(device).clone()


def place_state_carry(mesh: Mesh, state, carry, capb: int):
    """This rank's slab of an AgentState and a DayCarry in the port's
    layout (the bucket table with its spare slot), on its device; used
    for fresh runs and on resume."""
    n = state.age.shape[0]
    sh = AgentShard(mesh, n)

    def place(x):
        return _slab(x, n, sh.lo, sh.hi, capb, mesh.device)

    return (type(state)(*map(place, state)), type(carry)(*map(place, carry)))


def shard_run(run, mesh: Mesh):
    """(arrays, schedules, state, carry) of a CompiledRun for this
    rank's slab: per-agent leaves split, everything else replicated,
    all on the rank's device. Raises ValueError on an N that breaks the
    shard rule (:func:`check_shard_rule`)."""
    n = run.init_state.age.shape[0]
    capb = run.cfg.max_infectees
    sh = AgentShard(mesh, n)
    arrays = type(run.arrays)(*(_slab(x, n, sh.lo, sh.hi, capb, mesh.device)
                                for x in run.arrays))
    schedules = type(run.schedules)(*(x.to(mesh.device)
                                      for x in run.schedules))
    state, carry = place_state_carry(mesh, run.init_state, run.init_carry,
                                     capb)
    return arrays, schedules, state, carry


# ---------------------------------------------------------------------------
# the seed axis

def batch_placement(mesh: Optional[Mesh], items: Sequence) -> List[int]:
    """The positions in ``items`` (members or grid points) that this
    rank's agent group runs: contiguous, as even as the count allows."""
    if mesh is None or mesh.n_seed == 1:
        return list(range(len(items)))
    return [int(i) for i in np.array_split(np.arange(len(items)),
                                           mesh.n_seed)[mesh.seed_index]]


def gather_placed(mesh: Optional[Mesh], positions: List[int],
                  results: list, n_items: int) -> list:
    """The results of every agent group in the caller's order, on every
    rank: ``results[j]`` is this group's result for ``positions[j]``.
    The gather gives up (CollectiveError) once a rank of the mesh has
    marked a failure (a failed run of another agent group) or a rank of
    the seed group is lost; it then marks the mesh and aborts the seed
    group, whose collective is left on the card."""
    if mesh is None or mesh.n_seed == 1:
        return list(results)
    watch = Watch([(mesh.name + "/failed", "another rank of the mesh "
                    "failed")], dist.get_process_group_ranks(mesh.seed_group),
                  "seed group")
    got = {}
    try:
        with watch:
            parts = gather_objects(list(zip(positions, results)),
                                   mesh.seed_group, watch, mesh.device)
    except CollectiveError:
        give_up(mesh, mesh.seed_group)
        raise
    for pairs in parts:
        got.update(pairs)
    return [got[i] for i in range(n_items)]
