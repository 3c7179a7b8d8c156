"""Planners' web-UI clients, in a process of their own, so that their
HTTP and JSON work does not share the server's interpreter.

    python3 -m benchmark.harness.clients

reads one job, a JSON object, from standard input: ``base`` (the
server's URL), ``cookies`` (one session cookie a request, taken in
order), ``clients``, ``poll_s``, ``seconds`` and ``warm``. Each of
``clients`` threads posts the web UI's ``runSimulation`` with the next
cookie and polls the web UI's ``simulationResults`` document every
``poll_s`` until it reads ``finished``, and goes on to the next, until
``seconds`` have passed (``seconds`` 0: one request a client); the
requests under way then finish. With ``warm`` a request ends at its
first partial result. Writes JSON lines to standard output as it goes:
``{"partial": run_id}`` at a warm request's first partial, ``{"finished":
run_id}`` as each request finishes, and last ``{"seconds": s,
"requests": [...]}``, every time in seconds from the start of the
first request. Imports nothing but the standard library."""
from __future__ import annotations

import json
import sys
import threading
import time
import urllib.request

POLL_DOC = ("query($id: ID!){ simulationResults(runId:$id) {\n"
            "      finished phase predictedMetrics { dates metrics { type "
            "intValues floatValues } } } }")
RUN_DOC = "mutation { runSimulation { runId } }"
TIMEOUT_S = 300


def post(base: str, cookie: str, doc: str, variables=None) -> dict:
    """One GraphQL document as the web UI posts it, with its session."""
    req = urllib.request.Request(
        base + "/graphql",
        headers={"Content-Type": "application/json", "Cookie": cookie},
        data=json.dumps({"query": doc, "variables": variables}).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        out = json.loads(resp.read())
    if out.get("errors"):
        raise RuntimeError(str(out["errors"])[:500])
    return out["data"]


class Clients:
    def __init__(self, job: dict, out=sys.stdout):
        self.job, self.out = job, out
        self.next = 0
        self.lock = threading.Lock()
        self.requests = []
        self.t0 = 0.0

    def emit(self, obj: dict) -> None:
        with self.lock:
            self.out.write(json.dumps(obj) + "\n")
            self.out.flush()

    def one(self, client: int, index: int) -> dict:
        job = self.job
        r = dict(client=client, index=index, run_id="", first_partial=None,
                 finished=None, error=None, all_infected=None,
                 submitted=time.perf_counter() - self.t0)
        cookie = job["cookies"][index]
        try:
            r["run_id"] = post(job["base"], cookie, RUN_DOC
                               )["runSimulation"]["runId"]
            deadline = time.perf_counter() + TIMEOUT_S
            while True:
                res = post(job["base"], cookie, POLL_DOC,
                           {"id": r["run_id"]})["simulationResults"]
                now = time.perf_counter() - self.t0
                if r["first_partial"] is None and res["predictedMetrics"][
                        "dates"]:
                    r["first_partial"] = now
                    if job["warm"]:
                        self.emit({"partial": r["run_id"]})
                        break
                if res["finished"]:
                    r["finished"] = now
                    self.emit({"finished": r["run_id"]})
                    metrics = {m["type"]: m for m in
                               res["predictedMetrics"]["metrics"]}
                    r["all_infected"] = metrics.get(
                        "all_infected", {}).get("intValues")
                    break
                if time.perf_counter() > deadline:
                    raise TimeoutError(f"no result in {TIMEOUT_S} s")
                time.sleep(float(job["poll_s"]))
        except Exception as e:  # noqa: BLE001 -- a failed request counts
            r["error"] = f"{type(e).__name__}: {e}"
        return r

    def loop(self, client: int) -> None:
        seconds = float(self.job["seconds"])
        while True:
            with self.lock:
                if self.next >= len(self.job["cookies"]):
                    return
                index, self.next = self.next, self.next + 1
            r = self.one(client, index)
            with self.lock:
                self.requests.append(r)
            if time.perf_counter() - self.t0 >= seconds:
                return

    def run(self) -> dict:
        self.t0 = time.perf_counter()
        threads = [threading.Thread(target=self.loop, args=(c,))
                   for c in range(int(self.job["clients"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        seconds = time.perf_counter() - self.t0
        return {"seconds": seconds,
                "requests": sorted(self.requests, key=lambda r: r["index"])}


def main() -> int:
    job = json.loads(sys.stdin.readline())
    c = Clients(job)
    c.emit(c.run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
