"""Simulation workers and run registry (port of
reina_tpu/runtime/runner.py; reference: simulation_thread.py +
graphql_schema.py:236,382-408).

The reference spawns one OS process per simulation because its engine
holds the GIL. Here workers are *threads* in the server's process that
share one device: its build cache (``simulation.BUILD_CACHE``: a repeat
configuration skips ``build_run``, a new seed only reseeds), the kernel
library and the CUDA kernels' cached scratch. Every worker launches on
the device's default stream; no thread gets a stream of its own, since
the histogram kernels' shared scratch is safe only while their launches
run one after another in stream order (``ops.fusedmap._scratch``). The
run-identity, dedup, streaming and admission-control semantics are
preserved:

  * run_id = deterministic hash of (code, variables, file deps)
    (calc/utils.py:62-72) → identical configs dedupe across workers
  * partial results published at most every 0.5 s under
    ``<run_id>-results`` with a 30 s TTL, as numpy: ``{"total":
    daily_columns, "age_groups": AgeGroupCube | None, "by_variant":
    None}`` (``simulation.daily_columns`` / ``age_group_cube``)
  * at most MAX_CONCURRENT_RUNS live workers, else "System busy"
  * cooperative cancellation via the step callback

A run is a span ``serve.run`` (utils/perf.py) from its admission to its
terminal write, under its run id, whatever thread ends it.
"""
from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Dict, Optional

from . import cache
from ..config import settings
from ..core.engine import ExecutionInterrupted
from ..simulation import simulate_individuals
from ..utils import perf
from ..utils.memoize import generate_cache_key

logger = logging.getLogger(__name__)

MAX_CONCURRENT_RUNS = settings.MAX_CONCURRENT_RUNS
RESULT_TTL_S = 30
PUBLISH_INTERVAL_S = 0.5
HEARTBEAT_S = 10.0


class BusyError(RuntimeError):
    """Raised when the admission-control limit is hit."""


class SimulationThread(threading.Thread):
    """One simulation run on ``device`` publishing streamed results to
    the cache."""

    def __init__(self, variables: Dict, device="cuda"):
        super().__init__(daemon=True)
        # the start of its span serve.run: its admission
        self.admitted = perf.now()
        self.variables = variables
        self.device = device
        self.uuid = str(uuid.uuid4())
        self.cache_key = generate_cache_key(
            simulate_individuals, var_store=variables)
        self.cache_expiration = RESULT_TTL_S
        self.cancel_event = threading.Event()
        self.started = False  # True iff the OS thread was spawned

    def start(self) -> None:
        finished = cache.get("%s-finished" % self.cache_key)
        if finished is not None:
            logger.info("%s: already running elsewhere (%s)",
                        self.uuid, self.cache_key)
            return
        cache.set("%s-error" % self.cache_key, None, self.cache_expiration)
        cache.set("%s-finished" % self.cache_key, False, self.cache_expiration)
        # surfaced via simulationResults.phase: until the first partial
        # result the run sits in build_run (a build-cache miss) and, in
        # a fresh process, in the first build of the kernels; without
        # this the client's 0.5 s poll shows silence
        cache.set("%s-phase" % self.cache_key, "compiling",
                  self.cache_expiration)
        self.started = True
        super().start()

    def cancel(self) -> None:
        self.cancel_event.set()

    def run(self) -> None:
        last_publish = [None]
        last_payload = [None]
        hb_stop = threading.Event()

        def heartbeat():
            # Refresh the liveness + partial-result keys while the
            # engine cannot publish (build_run, the first kernel build,
            # a long chunk): the reference's 30 s TTL assumed a sub-30 s
            # stretch between publishes (simulation_thread.py:20,41);
            # without the refresh ``<run>-finished`` could expire
            # (clients see "No simulation run active" mid-run) and
            # ``<run>-results`` too (streamed charts blank out).
            while not hb_stop.wait(HEARTBEAT_S):
                if hb_stop.is_set():
                    break
                cache.set("%s-finished" % self.cache_key, False,
                          self.cache_expiration)
                phase = ("running" if last_payload[0] is not None
                         else "compiling")
                cache.set("%s-phase" % self.cache_key, phase,
                          self.cache_expiration)
                if last_payload[0] is not None:
                    cache.set("%s-results" % self.cache_key,
                              last_payload[0], self.cache_expiration)

        hb = threading.Thread(target=heartbeat, daemon=True)
        hb.start()

        def finish(error=None):
            # stop (and join) the heartbeat BEFORE the terminal writes
            # so a stale False can never overwrite the final True
            hb_stop.set()
            hb.join(timeout=5.0)
            # counted before a client can read that the run finished
            with perf.span("serve.run", id=self.cache_key,
                           start=self.admitted):
                if error is not None:
                    cache.set("%s-error" % self.cache_key, error,
                              self.cache_expiration)
                cache.set("%s-phase" % self.cache_key, "finished",
                          self.cache_expiration)
            cache.set("%s-finished" % self.cache_key, True,
                      self.cache_expiration)

        def publish(total, age_groups=None, by_variant=None, force=False):
            now = time.time()
            if force or last_publish[0] is None or \
                    now - last_publish[0] > PUBLISH_INTERVAL_S:
                if last_payload[0] is None:
                    # first partial: the build is behind us
                    cache.set("%s-phase" % self.cache_key, "running",
                              self.cache_expiration)
                last_payload[0] = dict(total=total, age_groups=age_groups,
                                       by_variant=by_variant)
                cache.set("%s-results" % self.cache_key, last_payload[0],
                          self.cache_expiration)
                last_publish[0] = now

        def step_callback(cols):
            if self.cancel_event.is_set():
                return False
            publish(cols)
            return True

        try:
            cols, cube = simulate_individuals(
                step_callback=step_callback, callback_day_interval=7,
                variable_store=self.variables, device=self.device)
        except ExecutionInterrupted:
            logger.info("%s: run cancelled", self.uuid)
        except Exception as e:  # noqa: BLE001 — errors surface to clients
            finish(error=str(e))
            logger.exception("%s: run failed", self.uuid)
            return
        else:
            publish(cols, age_groups=cube, force=True)
        finish()


class RunRegistry:
    """Live-run bookkeeping with admission control."""

    def __init__(self, max_runs: int = MAX_CONCURRENT_RUNS):
        self.max_runs = max_runs
        self._runs: Dict[str, SimulationThread] = {}
        self._lock = threading.Lock()

    def start_run(self, variables: Dict, device="cuda") -> str:
        with self._lock:
            for key, t in list(self._runs.items()):
                if not t.is_alive():
                    del self._runs[key]
            if len(self._runs) >= self.max_runs:
                raise BusyError("System busy")
            t = SimulationThread(variables, device)
            run_id = t.cache_key
            t.start()
            # dedup: when an identical config is already publishing,
            # start() is a no-op — keep the LIVE thread registered so
            # reap()/cancel still reach it, instead of clobbering it
            # with the never-started duplicate
            if t.started:
                self._runs[run_id] = t
            return run_id

    def reap(self, run_id: str) -> None:
        with self._lock:
            t = self._runs.pop(run_id, None)
        if t is not None and t.is_alive():
            t.cancel()

    def get(self, run_id: str) -> Optional[SimulationThread]:
        with self._lock:
            return self._runs.get(run_id)


REGISTRY = RunRegistry()
