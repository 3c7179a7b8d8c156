"""The ``closed_loop`` traffic: planners asking what-ifs of the web UI's
server, each waiting for its result before asking the next.

Set-up starts the program's GraphQL server in this process (in-process
result cache, runs on the card), runs the server's own warm-up, then
one what-if a client at once, each cancelled at its first partial
result, so that the device holds a graph set for each client and every
kernel is built. In the window each of ``clients`` clients posts the
web UI's ``runSimulation`` with a session that holds its next what-if,
polls the web UI's ``simulationResults`` document every ``poll_s``
until it reads ``finished``, and goes on to the next, until ``seconds``
have passed; the runs under way then finish, and the window ends with
the last. The clients run in a process of their own
(``harness/clients.py``), as remote browsers would, so that only the
server's work shares this interpreter. A what-if is drawn from the
run's seed: the configuration, with one of the frozen preset calendars
(``presets``), the hospital beds, ICU units and infectiousness
multiplier drawn from their ranges, one mobility limit moved by a
whole number of weeks, and a random seed. No two are alike, so every
request misses the result and build caches."""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from datetime import date, timedelta
from pathlib import Path
from typing import List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
# what-ifs a run can ask: 4 clients finish some 30 in a 51 s window
QUEUE = 400


def what_ifs(config: dict, traffic: dict, seed: int, n: int,
             stream: int = 0) -> List[dict]:
    """``n`` what-ifs of run ``seed`` (``stream`` 1: the set-up's), each
    the whole variables of one request."""
    rng = np.random.default_rng([int(seed), 0x5345, stream])
    presets = traffic["presets"]
    names = sorted(presets)
    out = []
    for _ in range(n):
        v = json.loads(json.dumps(config["variables"]))
        v.update(json.loads(json.dumps(presets[names[rng.integers(
            len(names))]])))
        for key, (lo, hi) in traffic["ranges"].items():
            v[key] = (int(rng.integers(lo, hi + 1)) if isinstance(lo, int)
                      else float(np.float32(rng.uniform(lo, hi))))
        limits = [i for i, iv in enumerate(v["interventions"])
                  if iv[0] == "limit-mobility"]
        i = limits[rng.integers(len(limits))]
        lo, hi = traffic["move_weeks"]
        iv = list(v["interventions"][i])
        iv[1] = (date.fromisoformat(iv[1])
                 + timedelta(weeks=int(rng.integers(lo, hi + 1)))).isoformat()
        v["interventions"][i] = iv
        v["random_seed"] = int(rng.integers(0, 2**31))
        out.append(v)
    return out


@dataclass
class Request:
    client: int
    variables: dict
    submitted: float = 0.0
    first_partial: Optional[float] = None
    finished: Optional[float] = None
    error: Optional[str] = None
    columns: Optional[dict] = None
    run_id: str = ""
    # the web UI's all_infected series as the client read it
    all_infected: Optional[list] = None


@dataclass
class Window:
    seconds: float = 0.0
    requests: List[Request] = field(default_factory=list)
    days: int = 0
    agents: int = 0
    counters: dict = field(default_factory=dict)


def short_of(columns: List[dict]) -> str:
    """How many of the scenarios' result columns ran out of hospital
    beds and of ICU units on some day, with the least available."""
    out = []
    for key in ("available_hospital_beds", "available_icu_units"):
        least = [float(np.min(c[key])) for c in columns if c is not None]
        out.append(f"{key}: {sum(x <= 0 for x in least)} of {len(least)} "
                   f"ran out, least {min(least, default=float('nan'))}")
    return "; ".join(out)


class Served:
    """One cell's run of the closed-loop traffic."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.httpd = None
        self.queue = what_ifs(config, traffic, seed, QUEUE)
        self.cookies = []
        self.setup_parts = {}

    def setup(self) -> None:
        from reina_tpu_torch.runtime import cache
        from reina_tpu_torch.runtime.graphql.server import (
            serve, warmup_serving_program)
        cache.init_backend("memory")
        t0 = time.perf_counter()
        warmup_serving_program(str(self.device))
        self.setup_parts["server_warmup_s"] = time.perf_counter() - t0
        self.httpd = serve(host="127.0.0.1", port=0, background=True,
                           warmup=False, device=str(self.device))
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        t0 = time.perf_counter()
        warm = what_ifs(self.config, self.traffic, self.seed,
                        int(self.traffic["clients"]), stream=1)
        w = self._run(warm, 0.0, warm=True)
        bad = [r.error for r in w.requests if r.error]
        if bad:
            raise RuntimeError(f"set-up what-ifs failed: {bad[0]}")
        self.setup_parts["client_sets_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.cookies = [self._cookie(v) for v in self.queue]
        self.setup_parts["sessions_s"] = time.perf_counter() - t0

    @staticmethod
    def _cookie(variables: dict) -> str:
        from reina_tpu_torch.config.variables import VariableStore
        from reina_tpu_torch.runtime.graphql.server import (COOKIE_NAME,
                                                            dump_session)
        return f"{COOKIE_NAME}=" + dump_session(VariableStore(variables))

    def _run(self, variables: List[dict], seconds: float,
             warm: bool = False, cookies: Optional[List[str]] = None,
             clients: Optional[int] = None) -> Window:
        """Serve ``variables`` in order to the clients' process until
        ``seconds`` have passed (0: one a client); ``warm``: cancel each
        at its first partial result, as the registry cancels a run its
        client left (its graph set is whole by then). The results'
        columns are read here as each finishes: the result cache keeps
        them 30 s."""
        from reina_tpu_torch.runtime import cache, runner
        n = int(self.traffic["clients"]) if clients is None else clients
        job = dict(base=self.base, clients=n, seconds=seconds, warm=warm,
                   poll_s=float(self.traffic["poll_s"]),
                   cookies=(cookies if cookies is not None
                            else [self._cookie(v) for v in variables]))
        pkg = __package__.split(".")[0]
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.harness.clients"], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        columns, last = {}, None
        try:
            proc.stdin.write(json.dumps(job) + "\n")
            proc.stdin.close()
            for line in iter(proc.stdout.readline, ""):
                ev = json.loads(line)
                if "partial" in ev:
                    runner.REGISTRY.reap(ev["partial"])
                elif "finished" in ev:
                    got = cache.get(f"{ev['finished']}-results")
                    columns[ev["finished"]] = (None if got is None
                                               else dict(got["total"]))
                else:
                    last = ev
        finally:
            if proc.poll() is None and last is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()
        if proc.returncode != 0 or last is None:
            raise RuntimeError(f"the clients' process ended with "
                               f"{proc.returncode}")
        w = Window(seconds=float(last["seconds"]),
                   days=int(self.config["variables"]["simulation_days"]) - 1,
                   agents=self.config["agents"])
        for r in last["requests"]:
            w.requests.append(Request(
                client=r["client"], variables=variables[r["index"]],
                submitted=r["submitted"], first_partial=r["first_partial"],
                finished=r["finished"], error=r["error"],
                run_id=r["run_id"], all_infected=r["all_infected"],
                columns=columns.get(r["run_id"])))
        return w

    def window(self, seconds: float, counters) -> Window:
        before = counters()
        w = self._run(self.queue, seconds, cookies=self.cookies)
        w.counters = {k: v - before.get(k, 0) for k, v in counters().items()}
        return w

    @staticmethod
    def _p(values, q: float) -> float:
        return float(np.percentile(np.asarray(values, np.float64), q))

    def e2e(self, w: Window) -> dict:
        times = [(r.finished - r.submitted) if r.error is None else np.inf
                 for r in w.requests]
        return {"result_s_p50": self._p(times, 50),
                "result_s_p75": self._p(times, 75)}

    def done(self, w: Window) -> list:
        return [r for r in w.requests if r.error is None]

    def agent_days(self, w: Window) -> float:
        return len(self.done(w)) * w.days * w.agents

    def notes(self, w: Window) -> str:
        return short_of([r.columns for r in self.done(w)])

    def traced(self, profile):
        """One wave of what-ifs, a client each, unprofiled, then the same
        wave again under ``profile`` with the result, memo and build
        caches emptied: (unprofiled wall s, profiled wall s, profiler,
        stepped days)."""
        from ..harness.trace import sync
        wave = what_ifs(self.config, self.traffic, self.seed,
                        int(self.traffic["clients"]), stream=2)
        cookies = [self._cookie(v) for v in wave]

        def run_wave():
            self._forget()
            t0 = time.perf_counter()
            self._run(wave, 0.0, cookies=cookies, clients=len(wave))
            sync()
            return time.perf_counter() - t0

        wall = run_wave()
        with profile() as prof:
            wall_prof = run_wave()
        days = len(wave) * (int(self.config["variables"]["simulation_days"])
                            - 1)
        return wall, wall_prof, prof, days

    def one(self, seed: int, rng) -> list:
        """The check's item of one answer of the timed path for ``seed``:
        the seed's first what-if served through the server."""
        w = self._run(what_ifs(self.config, self.traffic, seed, 1), 0.0,
                      clients=1)
        return self.items(w, rng)

    @staticmethod
    def _forget() -> None:
        from reina_tpu_torch.runtime import cache
        from reina_tpu_torch.simulation import BUILD_CACHE
        from reina_tpu_torch.utils import memoize
        cache.init_backend("memory")
        memoize.clear_cache()
        with BUILD_CACHE._lock:
            BUILD_CACHE._runs.clear()

    def items(self, w: Window, rng) -> list:
        """The scenarios the check compares, drawn from the seed among
        those that finished: their variables, seeds and result columns;
        the program's build of each is made here."""
        from reina_tpu_torch.core.engine import build_run
        done = self.done(w)
        k = min(int(self.traffic["scenarios_checked"]), len(done))
        pick = sorted(rng.choice(len(done), size=k, replace=False))
        out = []
        for i in pick:
            r = done[i]
            # what the client read against the result's columns
            seen = (r.all_infected is not None and r.columns is not None
                    and list(r.all_infected)
                    == [int(x) for x in r.columns["all_infected"]])
            out.append(dict(variables=r.variables, client_off=int(not seen),
                            seed=r.variables["random_seed"], outputs=None,
                            columns=r.columns,
                            run=build_run(r.variables, self.device)))
        return out

    def close(self) -> None:
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None


Driver = Served
