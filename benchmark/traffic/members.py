"""The ``members`` traffic: members of a Monte-Carlo ensemble, one after
another on one build and its graph set, as ``ensemble.run_ensemble``
and ``mc_spread`` run the 1,000-seed ensemble of a scenario.

Set-up builds the configuration once (``build_run``) and runs one
warm-up member, which builds the graph set with every day graph the
days need and compiles every kernel. The window then runs members of
seeds drawn from the run's seed, each ``run_ensemble(run, [seed])``
with its outputs fetched to the host at its end, until ``seconds``
have passed; the member under way then finishes, and the window ends
with it. Every member does the same work: the whole calendar of the
configuration."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import numpy as np


def member_seeds(seed: int, n: int) -> List[int]:
    """The members' seeds of run ``seed`` (32-bit, as the program's
    PRNGKey takes them); the warm-up member's is the first."""
    rng = np.random.default_rng([int(seed), 0x4D454D])
    return [int(s) for s in rng.integers(0, 2**32, size=n, dtype=np.uint64)]


@dataclass
class Window:
    seconds: float = 0.0
    seeds: List[int] = field(default_factory=list)
    outputs: list = field(default_factory=list)   # DayOutputs a member
    days: int = 0                                  # stepped days a member
    agents: int = 0
    counters: dict = field(default_factory=dict)   # program counters


class Members:
    """One cell's run of the members traffic."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.variables = dict(config["variables"])
        self.seeds = member_seeds(seed, 10_000)
        self.run = None
        self.setup_parts = {}

    def setup(self) -> None:
        from reina_tpu_torch.core.engine import build_run
        from reina_tpu_torch.ensemble import run_ensemble
        t0 = time.perf_counter()
        self.run = build_run(self.variables, self.device)
        self.setup_parts["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_ensemble(self.run, [self.seeds[0]])
        self.setup_parts["warm_member_s"] = time.perf_counter() - t0

    def member(self, s: int):
        from reina_tpu_torch.ensemble import run_ensemble
        out = run_ensemble(self.run, [s])
        return type(out)(*(x[0] for x in out))

    def window(self, seconds: float, counters) -> Window:
        w = Window(days=self.run.days - 1, agents=self.config["agents"])
        before = counters()
        t0 = time.perf_counter()
        i = 1
        while time.perf_counter() - t0 < seconds:
            s = self.seeds[i]
            i += 1
            w.outputs.append(self.member(s))
            w.seeds.append(s)
        w.seconds = time.perf_counter() - t0
        w.counters = {k: v - before.get(k, 0) for k, v in counters().items()}
        return w

    def agent_days(self, w: Window) -> float:
        return len(w.seeds) * w.days * w.agents

    def e2e(self, w: Window) -> dict:
        return {"agent_days_per_s": self.agent_days(w) / w.seconds}

    def traced(self, profile):
        """The first window member's seed again, unprofiled, then under
        ``profile`` (a context manager that yields the profiler):
        (unprofiled wall s, profiled wall s, profiler, stepped days)."""
        from ..harness.trace import sync
        s = self.seeds[1]
        sync()
        t0 = time.perf_counter()
        self.member(s)
        wall = time.perf_counter() - t0
        with profile() as prof:
            t0 = time.perf_counter()
            self.member(s)
            sync()
            wall_prof = time.perf_counter() - t0
        return wall, wall_prof, prof, self.run.days - 1

    def items(self, w: Window, rng) -> list:
        """The members the check compares, drawn from the seed: (its
        variables, its seed, its outputs as the window returned them)."""
        k = min(int(self.traffic["members_checked"]), len(w.seeds))
        pick = sorted(rng.choice(len(w.seeds), size=k, replace=False))
        return [dict(variables=self.variables, seed=w.seeds[i],
                     outputs=w.outputs[i], columns=None, run=self.run)
                for i in pick]

    def one(self, seed: int, rng) -> list:
        """The check's item of one answer of the timed path for ``seed``:
        a member of the seed's."""
        s = member_seeds(seed, 2)[1]
        return [dict(variables=self.variables, seed=s, outputs=self.member(s),
                     columns=None, run=self.run)]

    def notes(self, w: Window) -> str:
        """How many of the window's members ran out of hospital beds and
        of ICU units on some day, with the least available."""
        out = []
        for key in ("available_hospital_beds", "available_icu_units"):
            least = [float(np.min(np.asarray(getattr(o, key))))
                     for o in w.outputs]
            out.append(f"{key}: {sum(x <= 0 for x in least)} of "
                       f"{len(least)} ran out, least "
                       f"{min(least, default=float('nan'))}")
        return "; ".join(out)

    def close(self) -> None:
        self.run = None


Driver = Members
