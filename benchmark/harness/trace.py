"""The reduction of a ``torch.profiler`` trace of the card to what the
per-layer metrics and the result's ``breakdown`` read.

Device events are the CUDA kernels, copies and sets the profiler
records (also those inside CUDA graphs). ``busy_s`` is the union of
their intervals; an idle gap is a stretch between two device events in
which none runs, named after what the host was doing then: the
shortest host event (an operator or a CUDA runtime call) that spans
the gap's middle, or ``host:untraced`` where none does."""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


def sync() -> None:
    """Wait for the card, where there is one."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextmanager
def profile():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


@dataclass
class Trace:
    days: int                   # stepped days the traced work covers
    wall_s: float               # the same work's wall without the profiler
    window_s: float             # the traced window's wall
    busy_s: float = 0.0
    events: int = 0
    by_name: Dict[str, List[float]] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def device_ops(self, n: int = 10):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name, us / 1e6] for name, (us, _) in top]

    def kernel_s(self, patterns) -> float:
        """Device seconds of the events whose name matches any of
        ``patterns`` (regular expressions, searched)."""
        rx = [re.compile(p) for p in patterns]
        return sum(us for name, (us, _) in self.by_name.items()
                   if any(r.search(name) for r in rx)) / 1e6


def _events(prof):
    """(on the device, start µs, end µs, name) of every event, from the
    profiler's raw Kineto results: building its FunctionEvents takes
    minutes for the million events of a served wave."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        for e in prof.events():
            yield (e.device_type == cuda, e.time_range.start,
                   e.time_range.end, e.name)
        return
    for e in raw.events():
        a = e.start_ns() / 1e3
        yield e.device_type() == cuda, a, a + e.duration_ns() / 1e3, e.name()


def reduce(prof, days: int, wall_s: float, window_s: float) -> Trace:
    dev, host = [], []
    for on_dev, a, b, name in _events(prof):
        if on_dev:
            dev.append((a, b, name))
        elif b > a:
            host.append((a, b, name))
    t = Trace(days=days, wall_s=wall_s, window_s=window_s, events=len(dev))
    by_name = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        by_name[name][0] += b - a
        by_name[name][1] += 1
    t.by_name = dict(by_name)
    dev.sort()
    busy, gaps, end = 0.0, [], None
    for a, b, _ in dev:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    t.busy_s = busy / 1e6
    host.sort()
    starts = [h[0] for h in host]
    named = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for h in reversed(host[max(0, i - 400):i]):
            if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                best = h
        named[best[2] if best else "host:untraced"] += (b - a) / 1e6
    t.gaps = sorted(named.items(), key=lambda kv: -kv[1])
    return t
