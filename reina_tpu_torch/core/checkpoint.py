"""Mid-run checkpoint/resume (port of reina_tpu/core/checkpoint.py).

The file is the JAX package's npz, format v6, field for field: a
checkpoint written by either package resumes in the other. The full
simulation state (agent arrays, scalar ledgers, the pending bucket
appends and, optionally, the outputs so far) snapshots to one npz; the
per-source infectee buckets are left out and rebuilt from per-agent
state on load (``rebuild_buckets``). Resuming at day d reproduces the
uninterrupted run exactly, because the keys derive from (seed, day) and
every reduction on the day step's path is order-free or has a fixed
order.

The port's ``DayCarry`` differs from the file in three places, mapped
here and in ``convert.day_carry``: ``bkt_dst`` has one spare drop slot
past N·CAPB (never written to the file; added back on load), ``day`` is a
host int (``carry__day`` is int32 in the file) and ``weekly_leftover`` a
host float32 array.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from .state import AgentState, DayCarry

FORMAT_VERSION = 6   # the JAX package's version history:
#                      v6: DayCarry gained the deferred bucket-append
#                      stream (app_pos/app_val/app_n), persisted; v5:
#                      the infectee edge table became per-source
#                      buckets, EXCLUDED from the file (pure function
#                      of per-agent state — rebuild_buckets); v4:
#                      DayCarry gained the cached mobility/nc_ag pair;
#                      v3: AgentState gained ``traceable``; v2:
#                      DayCarry gained the edge table

# derived at load time instead of stored (432 MB at HUS scale)
_REBUILT_CARRY_FIELDS = ("bkt_dst", "bkt_fill")


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rebuild_buckets(state: AgentState, capb: int):
    """Reconstruct the per-source infectee buckets from per-agent
    state — bucket content is a pure function of (infector, traceable,
    day_of_infection): source s's bucket holds its recorded infectees
    in (day_of_infection, agent id) order, exactly the engine's append
    order (appends happen day by day; within a day the slot buffer is
    ascending agent ids and the append sort is stable), truncated to
    ``capb``; fill counts every recorded append (uncapped, matching
    the engine's overflow bookkeeping). Returns numpy (N, capb), (N,)."""
    n = len(_np(state.age))
    inf = _np(state.infector).astype(np.int64)
    doi = _np(state.day_of_infection).astype(np.int64)
    traceable = _np(state.traceable)
    t = np.flatnonzero(inf >= 0)
    t = t[traceable[inf[t]]]
    bkt = np.full((n, capb), n, np.int32)
    fill = np.zeros(n, np.int32)
    if len(t):
        order = np.lexsort((t, doi[t], inf[t]))
        t = t[order]
        s = inf[t]
        idx = np.arange(len(s))
        first = np.r_[True, s[1:] != s[:-1]]
        start = np.maximum.accumulate(np.where(first, idx, 0))
        rank = idx - start
        keep = rank < capb
        bkt[s[keep], rank[keep]] = t[keep]
        np.add.at(fill, s, 1)
    return bkt, fill


def save_checkpoint(path: str, state: AgentState, carry: DayCarry,
                    outputs=None, bucket_capacity: Optional[int] = None
                    ) -> None:
    """Write the port's ``state`` and ``carry`` (tensors on any device)
    in the JAX package's v6 layout. ``outputs`` (optional): the stacked
    numpy DayOutputs rows emitted so far, so a resumed run returns the
    complete output table. ``bucket_capacity``: the bucket table's row
    width, when ``carry.bkt_dst`` is not the whole table."""
    arrays = {}
    for name, val in zip(AgentState._fields, state):
        arrays["state__" + name] = _np(val)
    for name, val in zip(DayCarry._fields, carry):
        if name in _REBUILT_CARRY_FIELDS:
            continue
        arrays["carry__" + name] = _np(val)
    arrays["carry__day"] = np.int32(carry.day)
    arrays["carry__weekly_leftover"] = np.asarray(carry.weekly_leftover,
                                                  np.float32)
    n_agents = arrays["state__age"].shape[0]
    if bucket_capacity is None:
        # the port's table has one spare slot past N·CAPB
        bucket_capacity = (carry.bkt_dst.shape[0] - 1) // n_agents
    arrays["bucket_capacity"] = np.int32(bucket_capacity)
    if outputs is not None:
        for name, val in zip(type(outputs)._fields, outputs):
            arrays["out__" + name] = np.asarray(val)
    arrays["format_version"] = np.int32(FORMAT_VERSION)
    # atomic write: tmp file + rename
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_sharded(path: str, shard, state: AgentState, carry: DayCarry,
                 outputs, bucket_capacity: int) -> None:
    """save_checkpoint of an agent-sharded run: every rank of the agent
    group (``shard``, parallel.mesh.AgentShard) hands in its slab, the
    per-agent fields are gathered, the group's first rank writes the
    same file as an unsharded run, and the group agrees through the
    world's store that it is written (``shard.barrier``). Every wait is
    watched: the first rank reads the gathered rows only once the card
    has run their collectives (``shard.before_read``), so a peer failed
    or lost meanwhile makes every other rank raise (CollectiveError)
    within the liveness bound instead of blocking."""
    state = AgentState(*(shard.gather_rows(x) for x in state))
    carry = carry._replace(nc_ag=shard.gather_rows(carry.nc_ag))
    if shard.index == 0:
        shard.before_read(carry.nc_ag)
        save_checkpoint(path, state, carry, outputs, bucket_capacity)
    shard.barrier()


def load_checkpoint(path: str):
    """(state, carry, outputs) as numpy in the JAX package's layout (flat
    ``bkt_dst`` of N·CAPB, no spare slot); ``convert.agent_state`` and
    ``convert.day_carry`` place them on a device in the port's layout.
    ``outputs`` is None when the file holds none."""
    from .step import DayOutputs

    with np.load(path, allow_pickle=False) as z:
        if int(z["format_version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version in {path}")
        state = AgentState(*(z["state__" + n] for n in AgentState._fields))
        bkt, fill = rebuild_buckets(state, int(z["bucket_capacity"]))
        carry = DayCarry(*(
            {"bkt_dst": bkt.reshape(-1), "bkt_fill": fill}[n]
            if n in _REBUILT_CARRY_FIELDS else z["carry__" + n]
            for n in DayCarry._fields))
        outputs = None
        if "out__by_group" in z.files:
            outputs = DayOutputs(*(z["out__" + n]
                                   for n in DayOutputs._fields))
    return state, carry, outputs


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir)
             if f.startswith("day_") and f.endswith(".npz")]
    if not cands:
        return None
    best = max(cands, key=lambda f: int(f[4:-4]))
    return os.path.join(ckpt_dir, best)


def checkpoint_path(ckpt_dir: str, day: int) -> str:
    return os.path.join(ckpt_dir, f"day_{day:05d}.npz")
