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
"""
from __future__ import annotations

import math
import os
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


_LOCK = threading.Lock()
# the store keys that this thread's collectives watch (:func:`watching`)
_watch = threading.local()
# agreements made on each agent group (:func:`agree`), by group name
_AGREED = Counter()


class CollectiveError(RuntimeError):
    """A collective that cannot run as asked: one over gloo met under a
    CUDA graph capture, or one given up because another rank of its
    group failed (:func:`watching`)."""


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
    agent axis.
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


def make_mesh(n_seed: Optional[int] = None, n_agent: Optional[int] = None,
              device=None) -> Mesh:
    """Reshape the world's ranks into (n_seed, n_agent), as the JAX
    package's ``make_mesh`` reshapes its devices (all seed by default).
    ``device``: this rank's device, ``cuda:LOCAL_RANK`` by default."""
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
    agent_group = seed_group = None
    if world > 1:
        # every rank creates every group, in the same order
        for s in range(n_seed):
            g = dist.new_group([s * n_agent + a for a in range(n_agent)])
            if s == rank // n_agent:
                agent_group = g
        for a in range(n_agent):
            g = dist.new_group([s * n_agent + a for s in range(n_seed)])
            if a == rank % n_agent:
                seed_group = g
    return Mesh(n_seed=n_seed, n_agent=n_agent, rank=rank,
                seed_index=rank // n_agent, agent_index=rank % n_agent,
                device=device,
                backend=dist.get_backend() if world > 1 else None,
                agent_group=agent_group, seed_group=seed_group)


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
    staged = _staged(t, backend)
    _count(t, staged, backend)
    if not staged:
        _wait(dist.all_reduce(t, op=op, group=group, async_op=_watched()))
        return t
    buf = t.cpu()
    _wait(dist.all_reduce(buf, op=op, group=group, async_op=_watched()))
    return t.copy_(buf)


def all_gather(t: torch.Tensor, group, backend) -> torch.Tensor:
    """(k, *t.shape): ``t`` of every rank of ``group``, in rank order,
    by one ``all_gather_into_tensor`` into a buffer made here."""
    k = dist.get_world_size(group)
    staged = _staged(t, backend)
    _count(t, staged, backend, k)
    src = t.cpu() if staged else t.contiguous()
    buf = torch.empty(k * t.numel(), dtype=t.dtype, device=src.device)
    _wait(dist.all_gather_into_tensor(buf, src.reshape(-1), group=group,
                                      async_op=_watched()))
    return buf.to(t.device).view((k,) + tuple(t.shape))


def _watched() -> bool:
    return getattr(_watch, "keys", None) is not None


def _wait(work) -> None:
    """Wait for a collective issued with ``async_op=_watched()``; while
    this thread watches, give it up (CollectiveError) as soon as another
    rank of its group has marked a failure in the store."""
    if work is None:
        return
    store, failed = _watch.keys
    while not work.is_completed():
        if store.check([failed]):
            raise CollectiveError("given up: another rank of the agent "
                                  "group failed")
        time.sleep(1e-4)
    work.wait()


def _store():
    return dist.distributed_c10d._get_default_store()


def _keys(shard) -> str:
    return "reina/agent_group/" + str(getattr(shard.group, "group_name",
                                              None))


@contextmanager
def watching(shard):
    """This thread's collectives meanwhile (a span's warm-up: never
    under capture) wait on the host, and give up as soon as another
    rank of ``shard``'s agent group marks a failure in :func:`agree`: a
    rank that fails halfway through a span's warm-up leaves its peers in
    a collective that it never makes. Nothing changes without a world."""
    if shard.group is None or not dist.is_initialized():
        yield
        return
    _watch.keys = (_store(), _keys(shard) + "/failed")
    try:
        yield
    finally:
        _watch.keys = None


def agree(shard, failed: bool) -> bool:
    """Whether any rank of ``shard``'s agent group failed a step that
    every rank of it makes (a graph set's warm-up or capture of one
    span), from every rank's word in the world's store. A rank that
    failed marks it first, which ends its peers' watched waits; where
    any failed, every rank aborts the group's communicator (which ends
    the collectives left on its card) and the group is not used again.
    Without a world it returns ``failed``."""
    if shard.group is None or not dist.is_initialized():
        return failed
    store, base = _store(), _keys(shard)
    if failed:
        store.set(base + "/failed", b"1")
    with _LOCK:
        seq = _AGREED[base]
        _AGREED[base] += 1
    store.set(f"{base}/{seq}/{shard.index}", b"1" if failed else b"0")
    words = [f"{base}/{seq}/{j}" for j in range(shard.k)]
    store.wait(words)
    if not any(store.get(w) == b"1" for w in words):
        return False
    dist.distributed_c10d._abort_process_group(shard.group)
    return True


def gather_objects(obj, group) -> list:
    """Every rank's ``obj`` over ``group``, in rank order (pickled)."""
    out = [None] * dist.get_world_size(group)
    with _LOCK:
        STATS["calls"] += 1
    dist.all_gather_object(out, obj, group=group)
    return out


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
        with _LOCK:
            STATS["calls"] += 1
        dist.barrier(group=self.group)

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
    rank: ``results[j]`` is this group's result for ``positions[j]``."""
    if mesh is None or mesh.n_seed == 1:
        return list(results)
    got = {}
    for pairs in gather_objects(list(zip(positions, results)),
                                mesh.seed_group):
        got.update(pairs)
    return [got[i] for i in range(n_items)]
