"""Which layouts of a day graph may hold a captured NCCL collective: a
probe of torch.distributed's ProcessGroupNCCL under CUDA graph capture,
for the agent-sharded day (core/graphs.py on an AgentShard).

    python -m reina_tpu_torch.kernels.nccl_parts [--world 2]

An agent-sharded day's spans cross the agent axis through collectives
(parallel/mesh.py): all-reduces of counts and lookups, all-gathers of the
ledger's folds and the prefix's row totals. A day graph holds each span
as a child graph, and the tiered spans as the branches of conditional
nodes, which the producing kernels set (csrc/pick.cuh). This probe spawns
``world`` ranks, one a card, joined over NCCL, and on each rank captures
one ``all_reduce`` and one ``all_gather_into_tensor`` (about 18 KB each,
a day's payload) on an agent group in each of these layouts:

  plain               a captured torch graph, replayed
  child               the capture as a child-graph node of a graph built
                      with the day graph's entry points (csrc/daygraph.cu)
  if_body             the child in the body of an if node that the
                      reduce-and-pick kernel (max_pick) sets, its handle
                      read from a table a memcpy node at the head fills
  switch_body         two captures of other sizes as the two branches of
                      a switch node, set the same way
  beside_cooperative  the if body's capture also launches the prefix
                      kernel (a cooperative launch) before and after the
                      collectives

Each graph is launched 100 times (the conditionals with the condition
alternating 0 and 1 on every rank alike) and the accumulated results are
checked against their closed form. Every layout is tried under each
capture_error_mode (thread_local, relaxed, global) and with NCCL's
defaults and with NCCL_GRAPH_MIXING_SUPPORT=0. A case that raises prints
its error; one that does not finish within its time is killed and
reported as hung, and the probe goes on with the next, for at most
PROBE_S seconds (the cases not reached are reported so). It prints the
versions, one line a case with the node types of its captures
(cudaGraphNodeType: count), and the design they allow: A (collectives in
conditional bodies: the one-card day graph on every rank) or B (a graph a
span and tier, picks read on the host between spans). Needs ``world``
CUDA devices; exits 1 if no layout holds a collective at all.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import socket
import subprocess
import sys
import time

LAYOUTS = ("plain", "child", "if_body", "switch_body", "beside_cooperative")
MODES = ("thread_local", "relaxed", "global")
VARIANTS = {"nccl_defaults": {},
            "no_graph_mixing": {"NCCL_GRAPH_MIXING_SUPPORT": "0"}}
REPLAYS = 100
ELEMS = 4608          # int32s a collective: ~18 KB
CASE_S = 60           # a pair of ranks' time for one case
PROBE_S = 420         # no new pair of ranks after this many seconds


def cases():
    return [(mode, layout) for mode in MODES for layout in LAYOUTS]


class _Coll:
    """The static buffers of one captured pair of collectives: each run
    adds 1 to x, all-reduces a copy and all-gathers x, and accumulates
    both."""

    def __init__(self, rank: int, world: int, n: int, dev):
        import torch
        self.world, self.n = world, n
        base = torch.arange(n, dtype=torch.int32)
        self.x0 = [base + 1000 * r for r in range(world)]
        self.x = self.x0[rank].to(dev)
        self.acc_r = torch.zeros(n, dtype=torch.int32, device=dev)
        self.acc_g = torch.zeros(world * n, dtype=torch.int32, device=dev)
        self.runs = 0

    def body(self, group):
        import torch
        import torch.distributed as dist
        self.x.add_(1)
        r = self.x.clone()
        dist.all_reduce(r, group=group)
        g = torch.empty(self.world * self.n, dtype=torch.int32,
                        device=self.x.device)
        dist.all_gather_into_tensor(g, self.x, group=group)
        self.acc_r.add_(r)
        self.acc_g.add_(g)

    def check(self) -> str:
        """'' where the accumulators hold ``runs`` runs, else what
        differs."""
        import torch
        k = self.runs
        tri = k * (k + 1) // 2
        want_r = k * sum(self.x0) + self.world * tri
        want_g = torch.cat([k * x + tri for x in self.x0])
        bad = []
        if not torch.equal(self.acc_r.cpu(), want_r):
            bad.append("all_reduce")
        if not torch.equal(self.acc_g.cpu(), want_g):
            bad.append("all_gather_into_tensor")
        return ", ".join(bad)


def _node_types(graph) -> dict:
    from . import build
    counts = (ctypes.c_int * 32)()
    build.lib().reina_dg_node_types(graph, counts)
    return {t: n for t, n in enumerate(counts) if n}


def _check(err: int, what: str) -> None:
    from . import build
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({build.lib().reina_error_string(err).decode()})")


class _Assembled:
    """A graph built with the day graph's entry points: a memcpy node
    filling the handle table, then ``nodes``, instantiated."""

    def __init__(self, children, cond=None, handles=None, stage=None,
                 pick=None):
        import torch
        from . import build
        lib = self.lib = build.lib()
        g = ctypes.c_void_p()
        _check(lib.reina_dg_create(ctypes.byref(g)), "create")
        self.graph, self.exec = g, None
        dep = None
        if cond is not None:
            head = ctypes.c_void_p()
            _check(lib.reina_dg_memcpy(g, None, handles.data_ptr(),
                                       stage.data_ptr(), 8 * handles.numel(),
                                       ctypes.byref(head)), "memcpy head")
            node = ctypes.c_void_p()
            _check(lib.reina_dg_child(g, head, pick, ctypes.byref(node)),
                   "pick child")
            h = ctypes.c_ulonglong()
            _check(lib.reina_dg_handle(g, ctypes.byref(h)), "handle")
            kind, col = cond
            stage[col] = h.value
            size = len(children)
            bodies = (ctypes.c_void_p * size)()
            cnode = ctypes.c_void_p()
            _check(lib.reina_dg_cond(g, node, h, kind, size,
                                     ctypes.byref(cnode), bodies), "cond")
            for b, child in enumerate(children):
                n = ctypes.c_void_p()
                _check(lib.reina_dg_child(bodies[b], None, child,
                                          ctypes.byref(n)), "body child")
        else:
            for child in children:
                n = ctypes.c_void_p()
                _check(lib.reina_dg_child(g, dep, child, ctypes.byref(n)),
                       "child")
                dep = n
        ex = ctypes.c_void_p()
        _check(lib.reina_dg_instantiate(g, ctypes.byref(ex)), "instantiate")
        self.exec = ex
        torch.cuda.synchronize()

    def launch(self):
        import torch
        _check(self.lib.reina_dg_launch(
            self.exec, torch.cuda.current_stream().cuda_stream), "launch")

    def __del__(self):
        if self.lib is not None:
            self.lib.reina_dg_destroy(self.graph, self.exec)


def _agree(failed: bool, group, dev) -> bool:
    """Whether any rank failed (one eager all-reduce)."""
    import torch
    import torch.distributed as dist
    flag = torch.tensor([int(failed)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(int(flag))


def _case(mode: str, layout: str, rank: int, world: int, group, dev) -> dict:
    """One layout under one capture mode; returns its record. The ranks
    agree that every one captured and assembled before any launches, so
    that no rank waits in a collective that another never makes."""
    import torch
    from ..ops import fusedmap

    colls = [_Coll(rank, world, ELEMS, dev)]
    if layout == "switch_body":
        colls.append(_Coll(rank, world, ELEMS // 2 + 128, dev))
    w = torch.rand(1 << 20, generator=torch.Generator().manual_seed(1))
    w = (w < 0.5).to(torch.float32).to(dev)
    want_prefix = fusedmap.concat_prefix_twin(w.cpu(), None, 1)
    prefixes = []

    def body(c):
        def run():
            if layout == "beside_cooperative":
                prefixes.append(fusedmap.fused_concat_prefix(w, None, 1))
            c.body(group)
            if layout == "beside_cooperative":
                prefixes.append(fusedmap.fused_concat_prefix(w, None, 1))
        return run

    stream = torch.cuda.Stream(dev)
    graphs, nodes = [], {}
    try:
        launch = _build_case(mode, layout, colls, body, stream, graphs,
                             nodes, prefixes, dev)
        err = None
    except Exception as e:     # recorded: the probe's answer
        launch, err = None, f"{type(e).__name__}: {e}"[:600]
    torch.cuda.synchronize()
    if _agree(err is not None, group, dev):
        return {"ok": False, "nodes": nodes,
                "error": err or "failed on another rank"}
    launch()
    torch.cuda.synchronize()
    bad = [c.check() for c in colls]
    bad = "; ".join(b for b in bad if b)
    if layout == "beside_cooperative" and not all(
            torch.equal(p.cpu(), want_prefix) for p in prefixes):
        bad += "; prefix differs"
    return {"ok": not bad, "error": bad or None, "nodes": nodes,
            "runs": [c.runs for c in colls]}


def _build_case(mode, layout, colls, body, stream, graphs, nodes, prefixes,
                dev):
    """Warm up and capture the case's collectives and assemble its
    graph; returns the function that launches it REPLAYS times."""
    import torch
    from ..core import daygraph, step as S
    from ..ops import compact
    for c in colls:
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            body(c)()                 # the warm-up, eagerly
            c.runs += 1
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        prefixes.clear()              # keep the captured outputs only
        g = torch.cuda.CUDAGraph(keep_graph=layout != "plain")
        with torch.cuda.graph(g, stream=stream, capture_error_mode=mode):
            body(c)()
        graphs.append(g)
        if layout != "plain":
            for t, n in _node_types(g.raw_cuda_graph()).items():
                nodes[t] = nodes.get(t, 0) + n
    if layout == "plain":
        def launch():
            for _ in range(REPLAYS):
                graphs[0].replay()
                colls[0].runs += 1
        return launch
    if layout == "child":
        a = _Assembled([graphs[0].raw_cuda_graph()])

        def launch():
            for _ in range(REPLAYS):
                a.launch()
                colls[0].runs += 1
        return launch
    # the condition: max_pick over v, one pick of ceilings (0, 1)
    switch = layout == "switch_body"
    name = "C" if switch else "T"
    pk = S.Pick("v", None, (0, 1), None)
    node = (S.Switch(name, None, (pk,)) if switch
            else S.If(name, (pk,), ()))
    col = S.PICK_COLS.index(name)
    table = torch.full((1, len(S.PICK_COLS)), -1, dtype=torch.int32,
                       device=dev)
    tally = torch.zeros(2, dtype=torch.int32, device=dev)
    problem = torch.zeros((), dtype=torch.int32, device=dev)
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    handles = torch.zeros(len(S.PICK_COLS), dtype=torch.int64,
                          device=dev)
    fold = daygraph.Fold([node], [col], [tally], table, counter, problem,
                         handles=handles)
    v = torch.zeros(1, dtype=torch.int32, device=dev)
    pg = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(pg, stream=stream, capture_error_mode=mode):
        compact.count_max(v, "v", site=fold)
    stage = torch.zeros_like(handles)
    a = _Assembled([g.raw_cuda_graph() for g in graphs],
                   cond=(1 if switch else 0, col), handles=handles,
                   stage=stage, pick=pg.raw_cuda_graph())

    def launch():
        for i in range(REPLAYS):
            b = i % 2
            v.fill_(b)
            a.launch()
            if switch:
                colls[b].runs += 1
            elif b:
                colls[0].runs += 1
    launch.keep = (a, pg, fold, table, tally, problem, counter, handles,
                   stage)
    return launch


def _rank(rank: int, world: int, port: int, skip: int, out: str) -> None:
    import torch
    import torch.distributed as dist
    from . import build

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    build.lib()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    group = dist.new_group(list(range(world)))
    warm = torch.ones(ELEMS, dtype=torch.int32, device=dev)
    dist.all_reduce(warm, group=group)
    gat = torch.empty(world * ELEMS, dtype=torch.int32, device=dev)
    dist.all_gather_into_tensor(gat, warm, group=group)
    torch.cuda.synchronize()
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    for i, (mode, layout) in enumerate(cases()):
        if i < skip:
            continue
        t0 = time.perf_counter()
        try:
            rec = _case(mode, layout, rank, world, group, dev)
        except Exception as e:     # recorded: the probe's answer
            rec = {"ok": False, "error": f"{type(e).__name__}: {e}"[:600],
                   "nodes": {}}
        rec.update(case=i, mode=mode, layout=layout, rank=rank,
                   seconds=round(time.perf_counter() - t0, 3))
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        # every rank goes on only where every rank's case ended
        try:
            torch.cuda.synchronize()
            flag.fill_(0)
            dist.all_reduce(flag, group=group)
            torch.cuda.synchronize()
        except Exception as e:
            with open(out, "a") as f:
                f.write(json.dumps({"case": i, "rank": rank, "broken":
                                    f"{type(e).__name__}: {e}"[:300]})
                        + "\n")
            raise SystemExit(2)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(world: int, variant: str, skip: int, work: str):
    """Runs cases from ``skip`` on ``world`` ranks; returns (records by
    case, the first case not finished or None)."""
    outs = [os.path.join(work, f"{variant}_{skip}_{r}.jsonl")
            for r in range(world)]
    env = dict(os.environ, **VARIANTS[variant])
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "reina_tpu_torch.kernels.nccl_parts",
         "--rank", str(r), "--world", str(world), "--port", str(port),
         "--skip", str(skip), "--out", outs[r]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    # kill the ranks where no case ended for CASE_S seconds
    seen, since = -1, time.time()
    while any(p.poll() is None for p in procs):
        lines = sum(sum(1 for _ in open(o)) for o in outs
                    if os.path.exists(o))
        if lines != seen:
            seen, since = lines, time.time()
        elif time.time() - since > CASE_S:
            for p in procs:
                p.kill()
        time.sleep(1)
    logs = [p.communicate()[0] for p in procs]
    recs = {}
    for path in outs:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                recs.setdefault(r["case"], []).append(r)
    done = [c for c, rs in recs.items()
            if len([r for r in rs if "ok" in r]) == world]
    nxt = max(done) + 1 if done else skip
    unfinished = nxt if nxt < len(cases()) else None
    if unfinished is not None:
        tail = "\n".join(log[-1500:] for log in logs)
        print(f"[{variant}] case {unfinished} did not finish on every "
              f"rank; the ranks' last output:\n{tail}", flush=True)
    return recs, unfinished


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--skip", type=int, default=0)
    ap.add_argument("--out")
    a = ap.parse_args()
    if a.rank is not None:
        _rank(a.rank, a.world, a.port, a.skip, a.out)
        return 0
    if not torch.cuda.is_available() or torch.cuda.device_count() < a.world:
        raise SystemExit(f"needs {a.world} CUDA devices")
    from . import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    drv = subprocess.run(["nvidia-smi", "--query-gpu=driver_version",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}, driver "
          f"{drv[:1]}; cards {smi[:a.world]}", flush=True)
    build.lib()
    import tempfile
    allowed = {}
    t_start = time.time()
    with tempfile.TemporaryDirectory() as work:
        for variant in VARIANTS:
            results, skip = {}, 0
            while skip is not None:
                if time.time() - t_start > PROBE_S:
                    for i in range(skip, len(cases())):
                        results[i] = [{"ok": False, "nodes": {},
                                       "error": "not reached in time"}]
                    break
                recs, unfinished = _pair(a.world, variant, skip, work)
                results.update(recs)
                if unfinished is None:
                    break
                results[unfinished] = [{"ok": False, "error": "hung or "
                                        "died (killed)", "nodes": {}}]
                skip = unfinished + 1 if unfinished + 1 < len(cases()) \
                    else None
            for i, (mode, layout) in enumerate(cases()):
                rs = [r for r in results.get(i, []) if "ok" in r]
                ok = bool(rs) and len(rs) == a.world and all(r["ok"]
                                                            for r in rs)
                errs = sorted({r["error"] for r in rs if r.get("error")})
                nodes = rs[0]["nodes"] if rs else {}
                print(f"{variant:16s} {mode:12s} {layout:19s} "
                      f"{'ok' if ok else 'FAILED'}  nodes={nodes}"
                      + (f"  {errs}" if errs else ""), flush=True)
                allowed[(variant, mode, layout)] = ok
    conditional = ("if_body", "switch_body", "beside_cooperative")
    a_ok = [(v, m) for v in VARIANTS for m in MODES
            if all(allowed[(v, m, lay)] for lay in conditional)]
    any_ok = any(allowed.values())
    print(json.dumps({"design": "A" if a_ok else "B",
                      "conditional_bodies_allowed_with": a_ok,
                      "allowed": [list(k) for k, ok in allowed.items()
                                  if ok]}))
    return 0 if any_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
