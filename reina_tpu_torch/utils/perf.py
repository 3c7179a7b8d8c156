"""The program's counters and spans, and the wall timer of the outputs'
``us_per_infected``.

``STATS`` counts what the program does: days stepped and host reads of
device values (``core/step.py``, which re-exports it as ``step.STATS``),
the graph runner's captures, day graphs and day-graph launches
(``core/graphs.py``), the build cache's misses, hits and reseeds
(``simulation.py``), and for every span ``<name>_s`` (seconds) and
``<name>_n`` (how many ended). ``count`` adds under a lock, so that
worker threads lose no count, and ``STATS.items()`` is a copy taken
under it, so that a reader may iterate while workers count.

``span(name)`` times a stretch of one thread on the ``perf_counter_ns``
clock. Its parent is the thread's enclosing span; its id (a request's)
is the one given, else the parent's. On exit it adds to ``STATS`` and
appends ``(name, id, parent, start, end)`` to ``RING``, which keeps the
last ``RING_SIZE`` spans. ``span(name, start=t)`` ends a span that
began at ``t`` (``now()``) before its ``with``, maybe on another thread
(a request admitted by one thread and finished by another). While torch.profiler records on the thread, a span is also an
operator ``reina.<name>`` in its trace, on the device events' clock.
That operator is a FUNCTION-scope record, not ``record_function``'s user
scope: a user-scope range also puts an event of its own length on the
device's timeline, which would count as device time. The profiler
records the operators of the thread that started it, so the spans of
other threads are in ``RING`` and ``STATS`` only.

Spans sit at per-build, per-run and per-chunk granularity, never per
day or per kernel; there is no switch to turn them off."""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Optional

import torch

RING_SIZE = 1 << 16

_LOCK = threading.Lock()
_local = threading.local()


class Stats(Counter):
    """A Counter whose ``items()`` is a list taken under the lock that
    ``count`` and the spans add under."""

    def items(self):
        with _LOCK:
            return list(super().items())


STATS = Stats()
# the last RING_SIZE spans as (name, id, parent, start ns, end ns)
RING: deque = deque(maxlen=RING_SIZE)


def now() -> int:
    """The spans' clock: ``time.perf_counter_ns()``."""
    return time.perf_counter_ns()


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to ``STATS[key]`` (nothing for 0: the key stays absent)."""
    if n:
        with _LOCK:
            STATS[key] += n


def reset_stats() -> None:
    """Forget every count and span so far."""
    with _LOCK:
        STATS.clear()
        RING.clear()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _record(name: str, id_, parent, start: int, end_: int) -> None:
    with _LOCK:
        STATS[name + "_s"] += (end_ - start) / 1e9
        STATS[name + "_n"] += 1
    RING.append((name, id_, parent, start, end_))


class Span:
    """A span of the calling thread; see the module docstring. ``start``:
    where the span began on the ``now()`` clock, if before the ``with``,
    maybe on another thread (the trace's operator opens at the
    ``with``)."""

    __slots__ = ("name", "id", "parent", "start", "_op")

    def __init__(self, name: str, id: Optional[str] = None,
                 start: Optional[int] = None):
        self.name, self.id, self.start = name, id, start
        self.parent = self._op = None

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent = top.name
            if self.id is None:
                self.id = top.id
        stack.append(self)
        if torch._C._autograd._profiler_enabled():
            self._op = torch._C._profiler._RecordFunctionFast(
                "reina." + self.name)
            self._op.__enter__()
        if self.start is None:
            self.start = now()
        return self

    def __exit__(self, *exc) -> None:
        t = now()
        if self._op is not None:
            self._op.__exit__(None, None, None)
        _stack().pop()
        _record(self.name, self.id, self.parent, self.start, t)


def span(name: str, id: Optional[str] = None,
         start: Optional[int] = None) -> Span:
    """``with span(name):`` times the block; see ``Span``."""
    return Span(name, id, start)


class PerfCounter:
    """Wall milliseconds between calls of ``measure()``."""

    def __init__(self):
        self.last_value = time.perf_counter_ns()

    def measure(self) -> float:
        """Milliseconds since the previous measure() (or construction)."""
        now_ns = time.perf_counter_ns()
        cur_ms = (now_ns - self.last_value) / 1_000_000
        self.last_value = now_ns
        return cur_ms
