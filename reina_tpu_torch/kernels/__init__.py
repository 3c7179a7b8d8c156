"""Hand-written Hopper kernels for the port's main path.

Nine CUDA kernel sources (``csrc/*.cu``, built by ``build.py`` with
nvcc for sm_90a and bound with ctypes; the post-ledger pass of the day
step among them, the ledger and the prefix also in a sharded form, the
day's random draws: ``threefry.cu`` for each draw, ``samplers.cu`` for
gamma_fixed and binomial_fixed, and ``daygraph.cu``: the day graph's
assembly and the reduce-and-pick of its tier picks; the other picks are
made inside the prefix kernel's launch, ``pick.cuh``) and three Triton
kernels (``fused_bodies``, the other fused per-agent passes).
The wrappers that launch them live beside their plain PyTorch twins in
``reina_tpu_torch.ops`` and ``fused_bodies``; each wrapper calls
:func:`launched` where it launches its kernel, and nowhere else, so a
run can show that it went through the kernels. While a thread captures
a CUDA graph (core/graphs.py) its wrappers launch nothing: their counts
go into the graph's tally instead, and every run of the graph adds
that tally to ``LAUNCHES`` (core/graphs.py: a day graph's always-run
spans at its launch, its branches from the device's branch tallies).
Other layers count what a captured graph does beside its launches in
the same tally (:func:`capture_tally`; the collectives of
parallel/mesh.py, as ``mesh.calls`` and ``mesh.bytes``); a replay adds
those to ``REPLAYED``.
While the graph runner builds a span it names, through :func:`folding`,
the counts whose tier picks the span's producing kernels make
(:func:`fold_site`). Before a span is captured it runs once eagerly
(its warm-up, inside :func:`warming`): those launches are real and go
into ``LAUNCHES`` like any other, and ``WARMUPS`` counts them again, so
that a run's launches are its stepped days' plus its warm-ups'.
"""
from __future__ import annotations

import threading
from collections import Counter
from contextlib import contextmanager

LAUNCHES = {
    "fused_map.prologue": 0,
    "fused_map.recv_front": 0,
    "fused_map.post": 0,
    "fused_map.finalize": 0,
    "ledger_scan": 0,
    "fused_concat_prefix": 0,
    "fused_onehot_sum": 0,
    "fused_fn_onehot_sum": 0,
    "fused_bihistogram": 0,
    # the sharded forms of the ledger and the prefix (an agent-sharded
    # run, parallel/mesh.py): each of their two entry points
    "ledger_sharded.fold": 0,
    "ledger_sharded.emit": 0,
    "concat_prefix_sharded.totals": 0,
    "concat_prefix_sharded.emit": 0,
    # the draws (ops/prng.py: random_bits, uniform, normal, gumbel) and
    # the samplers (ops/random.py)
    "prng.draw": 0,
    "random.gamma_fixed": 0,
    "random.binomial_fixed": 0,
    # the prefix launched with a count and tier picks to make (ops/
    # fusedmap.py:prefix_count under core/daygraph.py's Fold), and the
    # reduce-and-pick of a maximum count (ops/compact.py:count_max)
    "fused_concat_prefix.pick": 0,
    "daygraph.max_pick": 0,
    # the sharded prefix's emit launched with a count and tier picks to
    # make (ops/fusedmap.py:sharded_prefix_count, a graphed agent axis)
    "concat_prefix_sharded.pick": 0,
}


# of LAUNCHES, those made by the graph runner's warm-ups
WARMUPS = Counter()

# the replays' counts of what is not a launch (parallel/mesh.py's
# collectives), by the name the capture's tally gave them
REPLAYED = Counter()

_capture = threading.local()
# served runs count from worker threads of their own
_LOCK = threading.Lock()


def launched(name: str) -> None:
    """One launch of kernel ``name`` (into the capturing thread's tally
    while it captures a graph)."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[name] += 1
        return
    with _LOCK:
        LAUNCHES[name] += 1
        if getattr(_capture, "warming", False):
            WARMUPS[name] += 1


@contextmanager
def warming():
    """This thread's launches meanwhile are a span's warm-up."""
    _capture.warming = True
    try:
        yield
    finally:
        _capture.warming = False


@contextmanager
def capturing(guards: bool = False):
    """This thread's launches meanwhile go into the Counter it yields;
    with ``guards``, the points after its captured collectives go into
    :func:`guards` (:func:`guard_point`)."""
    tally = Counter()
    _capture.tally = tally
    _capture.guards = [] if guards else None
    try:
        yield tally
    finally:
        _capture.tally = None


def guard_point(stream: int) -> None:
    """The capture on ``stream`` (a cudaStream_t) has just captured a
    collective: the nodes it ends with (the capture's dependencies) are
    where a piece of the span ends (core/daygraph.py: the gates of a
    graphed shard)."""
    guards = getattr(_capture, "guards", None)
    if guards is None or getattr(_capture, "tally", None) is None:
        return
    import ctypes
    from . import build
    nodes, n = (ctypes.c_void_p * 8)(), ctypes.c_int()
    build.check(build.lib().reina_dg_capture_leaf(stream, nodes,
                                                  ctypes.byref(n)),
                "the nodes that end a captured collective")
    guards.extend(nodes[i] for i in range(n.value))


def guards() -> list:
    """The guard points of this thread's capture, in capture order."""
    return list(getattr(_capture, "guards", None) or [])


@contextmanager
def folding(sites: dict):
    """This thread's fold sites meanwhile: {count name: site}, each
    naming where the count's producer writes it and which tier picks it
    makes (core/daygraph.py:Fold)."""
    _capture.sites = sites
    try:
        yield
    finally:
        _capture.sites = None


def fold_site(name: str):
    """The fold site of count ``name`` on this thread, or None."""
    sites = getattr(_capture, "sites", None)
    return None if sites is None else sites.get(name)


def is_warming() -> bool:
    """Whether this thread runs a span's warm-up."""
    return getattr(_capture, "warming", False)


def capture_tally():
    """The Counter of the graph this thread captures, or None."""
    return getattr(_capture, "tally", None)


def replayed(tally, times: int = 1) -> None:
    """``times`` runs of a graph whose capture counted ``tally``."""
    with _LOCK:
        for name, n in tally.items():
            if name in LAUNCHES:
                LAUNCHES[name] += n * times
            else:
                REPLAYED[name] += n * times


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        WARMUPS.clear()


def launches() -> dict:
    with _LOCK:
        return dict(LAUNCHES)


def warmups() -> dict:
    with _LOCK:
        return dict(WARMUPS)
