"""The port's mesh (reina_tpu_torch/parallel/mesh.py) on the CPU: ranks
are spawned interpreters joined over gloo, one torch thread each, at a
small size (8,192 agents, 10 days), and nothing here compiles a JAX
program. The cases of tests/test_parallel.py and tests/test_multihost.py
that have a counterpart in the port:

  * an agent-sharded run (k = 2 and 4) equals the one-rank ``run_days``
    in every output, state and carry field, bit for bit; the run traces
    contacts, imports infections and vaccinates, so every collective
    point of the day step runs;
  * the graph runner's CPU model on an agent shard (k = 2 and 4, the
    graphed agent axis's model: each (span, tier) recorded at its
    warm-up and called again, every pick made by the sharded producer's
    fold): stepped day by day, every state, carry and output field
    equals the unsharded plain step's on every day; its picks table
    equals the plain step's host picks on every rank, its branch tallies
    count them and its problem bits equal the plain step's;
    ``run_days(graphs=True)`` on the mesh equals the one-rank run; a
    capture that fails on one rank, a warm-up that fails on one rank
    after the first collective of its span, and a day that fails on one
    rank in a replay raise GraphError on every rank at once, and the
    ranks go on to their next collective; in a world of two of its own,
    a rank whose process ends mid-run makes the other raise within the
    liveness bound (these run a build with smaller tiers, ``CFG``);
  * on a (2 seed × 2 agent) mesh, ``run_ensemble`` and ``sweep_grid``
    equal the one-rank ensemble and sweep on every rank, and a failure
    in one agent group makes ``run_ensemble`` raise on all four ranks;
  * a wait's Watch gives up on a failure mark, a lost peer and a store
    that stops answering;
  * a checkpoint resumes across layouts: written by two ranks, resumed
    by one; written by one, resumed by four;
  * ``init_distributed`` without variables, and the errors of
    ``make_mesh`` and ``shard_run``.

Every comparison is exact.
"""
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N, DAYS, AT = 7900, 10, 4          # N pads to 8,192
IVS = [["test-with-contact-tracing", "2020-02-19", 80],
       ["import-infections", "2020-02-19", 40],
       ["vaccinate", "2020-02-20", 300, 60, None]]
SEEDS = [0, 1, 2]
GRID = {"infectiousness_multiplier": [0.4, 0.55, 0.7]}


# for the graph runner's model: tiers of 512, 1536 and 4096 slots and
# of 4, 12 and 16 bucket columns, so that it warms up and records every
# (span, tier) of a tracing day, 27 of them, in a few seconds
CFG = {"infection_buffer": 4096, "max_infectees": 16}
# the liveness bound in the killed-rank worlds (mesh.LIVENESS_S)
LOST_S = 10.0
# rank 1's process ends at its day-graph launch of this day
KILL_AT = 3
# the two NCCL ranks' limit
NCCL_S = 240


def _build(cfg_overrides=None):
    from reina_tpu_torch.testing import build_synthetic_run
    return build_synthetic_run("cpu", n_agents=N, days=DAYS, seed=5,
                               interventions=IVS, cfg_overrides=cfg_overrides)


def _sweep(mesh=None):
    from reina_tpu_torch.calibration import sweep_grid
    from reina_tpu_torch.testing import (synthetic_age_counts,
                                         synthetic_variables)
    points, outs, _ = sweep_grid(
        synthetic_variables(days=DAYS, seed=5, interventions=IVS), GRID,
        age_counts_override=synthetic_age_counts(N), device="cpu",
        mesh=mesh)
    return outs


def _save(path, out, state=None, carry=None):
    from reina_tpu_torch import convert
    arrays = {"out__" + k: np.asarray(v) for k, v in zip(out._fields, out)}
    if state is not None:
        arrays.update({"st__" + k: v
                       for k, v in convert.to_numpy(state).items()})
        arrays.update({"cr__" + k: np.asarray(v)
                       for k, v in convert.to_numpy(carry).items()})
    np.savez(path, **arrays)


def _model_days(run, agents, path):
    """The graph runner's CPU model on this rank's slab, stepped day by
    day: each day's state, carry and outputs, then the picks, the branch
    tallies with their layout and the problem bits, into ``path``."""
    from reina_tpu_torch import convert
    from reina_tpu_torch.core import graphs as G
    from reina_tpu_torch.core.schedule import Schedules
    from reina_tpu_torch.ops import prng
    from reina_tpu_torch.parallel import mesh as M

    shard = M.AgentShard(agents, run.init_state.age.shape[0])
    arrays, schedules, state, carry = M.shard_run(run, agents)
    gs = G.GraphSet(run.cfg, arrays, schedules, state, carry, "cpu", shard)
    plans = gs.prepare(Schedules(*(x.numpy() for x in schedules)),
                       prng.PRNGKey(run.random_seed), 0, DAYS - 1,
                       carry.weekly_leftover, shard.n)
    gs.start(run.cfg, arrays, schedules, state, carry, 0, plans)
    rec = {}
    for d, plan in enumerate(plans):
        gs.step([plan])
        st, cr = gs.state_carry(d + 1, plan.leftover, 0, clone=True)
        out = gs.outputs(d, d + 1, [plan])
        for pre, nt in (("st", st), ("cr", cr)):
            for f, v in convert.to_numpy(nt).items():
                rec[f"d{d}_{pre}__{f}"] = np.array(v)
        for f, v in zip(out._fields, out):
            rec[f"d{d}_out__{f}"] = np.array(v)[0]
    problem, picks = gs.synced(gs.sync_tail(0, DAYS - 1).numpy())
    rec["picks"], rec["problem"] = np.array(picks), np.int32(problem)
    rec["tally"] = gs.tally.numpy().copy()
    rec["layout"] = np.array([gs.layout[c] for c in sorted(gs.layout)])
    np.savez(path, **rec)


def _failing_run(run, rank: int, cls, attr: str, failing,
                 barrier: bool = True) -> str:
    """A graphed run on a fresh agent axis of two (a failure aborts the
    agent group's communicator) with ``cls.attr`` replaced by
    ``failing(original)`` on rank 1: the GraphError each rank raises and
    its seconds, after which a collective of the world runs (unless
    ``barrier`` is false)."""
    from reina_tpu_torch.core import graphs as G
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.parallel import mesh as M

    agents = M.make_mesh(1, 2, device=run.device)
    G.drop_idle()
    original = getattr(cls, attr)
    if rank == 1:
        setattr(cls, attr, failing(original))
    t0 = time.perf_counter()
    try:
        run_days(run, chunk_days=4, mesh=agents, graphs=True)
        msg = "no error"
    except G.GraphError as e:
        msg = f"GraphError: {e}"
    finally:
        setattr(cls, attr, original)
    msg = f"{time.perf_counter() - t0:.3f} {msg}"
    if barrier:
        torch.distributed.barrier()
    return msg


def _on_call(n: int, act):
    """A replacement for a method that runs ``act()`` at its ``n``-th
    call (the n-th day-graph launch: day n - 1) and the method itself at
    every other."""
    seen = {"n": 0}

    def failing(method):
        def fn(self, *args):
            seen["n"] += 1
            if seen["n"] == n:
                act()
            return method(self, *args)
        return fn
    return failing


def _refuse():
    from reina_tpu_torch.core import graphs as G
    raise G.GraphError("day-graph launch refused on purpose")


def _failed_replay(run, rank: int) -> str:
    """A graphed run whose third day fails on rank 1 (the CPU model's
    launch of a day), while rank 0 waits in that day's first collective;
    then the spans the model's gates ended and skipped (``G.GATED``)."""
    from reina_tpu_torch.core import graphs as G
    G.GATED.clear()
    msg = _failing_run(run, rank, G.GraphSet, "_model_day",
                       _on_call(3, _refuse))
    return f"{msg}\n{G.GATED['ended']} {G.GATED['completed']}"


def _killed(work: str):
    """What ends rank 1's process mid-run: the time, then ``os._exit``."""
    def act():
        with open(f"{work}/killed_at.txt", "w") as f:
            f.write(f"{time.time():.3f}")
        os._exit(3)
    return act


def _failed_ensemble(run, rank: int) -> str:
    """``run_ensemble`` on a fresh (2, 2) mesh whose rank 1 (agent group
    0) fails its fifth collective of the plain sharded step: what each
    rank raises and its seconds, then a barrier of the world."""
    from reina_tpu_torch.ensemble import run_ensemble
    from reina_tpu_torch.parallel import mesh as M

    both = M.make_mesh(2, 2, device="cpu")
    real, seen = M.all_reduce, {"n": 0}

    def all_reduce(*args):
        seen["n"] += 1
        if seen["n"] == 5:
            raise RuntimeError("collective refused on purpose")
        return real(*args)

    if rank == 1:
        M.all_reduce = all_reduce
    t0 = time.perf_counter()
    try:
        run_ensemble(run, SEEDS, mesh=both)
        msg = "no error"
    except Exception as e:
        msg = f"{type(e).__name__}: {e}"
    finally:
        M.all_reduce = real
    msg = f"{time.perf_counter() - t0:.3f} {msg}"
    torch.distributed.barrier()
    return msg


def _failed_capture(run, rank: int) -> str:
    """A graphed run whose capture of span A fails on rank 1 only."""
    from reina_tpu_torch.core import graphs as G

    def failing(capture):
        def fn(self, name, key, body):
            if name == "A":
                raise G.GraphError(f"capture of span {name} {key} failed: "
                                   "refused on purpose")
            return capture(self, name, key, body)
        return fn
    return _failing_run(run, rank, G.GraphSet, "capture", failing)


def _failed_warmup(run, rank: int) -> str:
    """A graphed run whose first warm-up with two all-reduces fails on
    rank 1 at its second: rank 0 is then waiting in that all-reduce."""
    from reina_tpu_torch import kernels
    from reina_tpu_torch.core import graphs as G
    from reina_tpu_torch.parallel import mesh as M

    seen = {"n": 0}
    real = M.all_reduce

    def all_reduce(t, group, backend, *op):
        if kernels.is_warming():
            seen["n"] += 1
            if seen["n"] == 2:
                raise RuntimeError("collective refused on purpose")
        return real(t, group, backend, *op)

    def failing(span_body):
        def fn(self, name, key, span):
            body = span_body(self, name, key, span)

            def counted():
                seen["n"] = 0
                M.all_reduce = all_reduce
                try:
                    body()
                finally:
                    M.all_reduce = real
            return counted
        return fn
    return _failing_run(run, rank, G.GraphSet, "_span_body", failing)


def _child(rank: int, world: int, work: str) -> None:
    """One rank of a world of 2 or 4 (see the module docstring)."""
    torch.set_num_threads(1)
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.ensemble import run_ensemble
    from reina_tpu_torch.parallel import mesh as M

    assert M.init_distributed(f"file://{work}/store", world, rank,
                              backend="gloo") == world
    run, small = _build(), _build(CFG)
    agents = M.make_mesh(1, world, device="cpu")
    out, st, cr, _ = run_days(run, chunk_days=4, mesh=agents)
    _save(f"{work}/agent_{rank}.npz", out, st, cr)
    _model_days(small, agents, f"{work}/model_{rank}.npz")
    picks = []
    out, st, cr, _ = run_days(small, chunk_days=4, mesh=agents, graphs=True,
                              picks=picks)
    _save(f"{work}/graphed_{rank}.npz", out, st, cr)
    np.save(f"{work}/graphed_picks_{rank}.npy", np.array(picks))
    if world == 2:
        run_days(run, n_days=AT + 1, checkpoint_dir=f"{work}/ck2",
                 checkpoint_every=AT, mesh=agents)
        run_days(small, n_days=AT + 1, checkpoint_dir=f"{work}/ck2g",
                 checkpoint_every=AT, mesh=agents, graphs=True)
        for name, fn in (("capture", _failed_capture),
                         ("warmup", _failed_warmup),
                         ("replay", _failed_replay)):
            with open(f"{work}/failed_{name}_{rank}.txt", "w") as f:
                f.write(fn(small, rank))
    else:
        out, st, cr, _ = run_days(small, chunk_days=4, mesh=agents,
                                  checkpoint_dir=f"{work}/ck1g",
                                  graphs=True)
        _save(f"{work}/resumed_g_{rank}.npz", out, st, cr)
        out, st, cr, _ = run_days(run, chunk_days=4, mesh=agents,
                                  checkpoint_dir=f"{work}/ck1")
        _save(f"{work}/resumed_{rank}.npz", out, st, cr)
        both = M.make_mesh(2, 2, device="cpu")
        _save(f"{work}/ensemble_{rank}.npz",
              run_ensemble(run, SEEDS, mesh=both))
        _save(f"{work}/sweep_{rank}.npz", _sweep(both))
        with open(f"{work}/failed_ensemble_{rank}.txt", "w") as f:
            f.write(_failed_ensemble(run, rank))
    print(f"rank {rank} of {world}: {M.stats()}", flush=True)
    # join gloo's threads now: left to the interpreter's exit, they can
    # end the process in std::terminate (seen under a loaded host)
    torch.distributed.destroy_process_group()


def _killed_child(rank: int, work: str) -> None:
    """One rank of a world of two over gloo, the liveness bound lowered
    to ``LOST_S``, whose rank 1's process ends mid-run, at its first
    capture of a span of a graphed run (the CPU model), while rank 0
    waits in the store for its word on that capture: only its stopped
    heartbeat tells (over gloo a process's end closes its sockets, so a
    peer in a collective fails at once). Rank 0 writes when its run
    began, when it raised and what."""
    torch.set_num_threads(1)
    from reina_tpu_torch.core import graphs as G
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.parallel import mesh as M

    M.LIVENESS_S = LOST_S
    M.init_distributed(f"file://{work}/store", 2, rank, backend="gloo")
    small = _build(CFG)
    agents = M.make_mesh(1, 2, device="cpu")
    if rank == 1:
        G.GraphSet.capture = _on_call(1, _killed(work))(G.GraphSet.capture)
    t0 = time.time()
    try:
        run_days(small, chunk_days=4, mesh=agents, graphs=True)
        msg = "no error"
    except Exception as e:
        msg = f"{type(e).__name__}: {e}"
    with open(f"{work}/killed_{rank}.txt", "w") as f:
        f.write(f"{t0:.3f} {time.time():.3f} {msg}")
    torch.distributed.destroy_process_group()


def _lost_child(rank: int, work: str, case: str) -> None:
    """One rank of a world of two over gloo, the liveness bound lowered
    to ``LOST_S``, whose rank ends its process: ``boot``, rank 1 after
    ``init_distributed``, before ``make_mesh`` (rank 0 raises in the
    mesh's watched bootstrap); ``ckpt``, rank 0 inside ``save_sharded``,
    as it writes the file (rank 1 raises in the group's agreement that it
    is written). The survivor writes when it raised and what."""
    torch.set_num_threads(1)
    from reina_tpu_torch.core import checkpoint
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.parallel import mesh as M

    M.LIVENESS_S = LOST_S
    M.init_distributed(f"file://{work}/store", 2, rank, backend="gloo")
    lost = 1 if case == "boot" else 0
    if case == "boot" and rank == lost:
        _killed(work)()
    t0 = time.time()
    try:
        agents = M.make_mesh(1, 2, device="cpu")
        if case == "ckpt":
            if rank == lost:
                checkpoint.save_checkpoint = lambda *a, **k: _killed(work)()
            run_days(_build(), n_days=AT + 1, checkpoint_dir=f"{work}/ck",
                     checkpoint_every=AT, mesh=agents)
        msg = "no error"
    except Exception as e:
        msg = f"{type(e).__name__}: {e}"
    with open(f"{work}/lost_{rank}.txt", "w") as f:
        f.write(f"{t0:.3f} {time.time():.3f} {msg}")
    torch.distributed.destroy_process_group()


def _usable(run, alone) -> str:
    """"True" where this process's one-card graphed run equals
    ``alone``; else what went wrong ("False", or the error, with whether
    a ``torch.cuda.synchronize()`` then fails too: an ended CUDA
    context)."""
    from reina_tpu_torch.core.engine import run_days
    try:
        out = run_days(run, chunk_days=4)[0]
        return str(all(np.array_equal(a, b) for a, b in zip(alone, out)))
    except Exception as e:
        first = str(e).strip().splitlines()[0][:300]
        try:
            torch.cuda.synchronize()
        except RuntimeError:
            return f"{type(e).__name__} on an ended context: {first}"
        return f"{type(e).__name__}: {first}"


def _nccl_child(rank: int, work: str, port: str, case: str) -> None:
    """One rank of two over NCCL, a card each (the gpu-marked test), in
    a world of its own for each case. ``nccl``: the graphed agent axis
    by default, then a warm-up that fails on rank 1 after its span's
    first collective. ``replay``: a replay whose day-graph launch of day
    ``KILL_AT`` raises on rank 1. ``killed``: rank 1's process ends at
    that launch (the liveness bound lowered to ``LOST_S``). After the
    failure, the rank's one-card graphed run against the same run made
    first (``_usable``). Each rank writes the seconds to its raise;
    then, where its card is usable, tears the world down and writes
    that's seconds, else leaves at once (the test fails then)."""
    import faulthandler
    # a rank still running near the test's limit prints where it is
    faulthandler.dump_traceback_later(NCCL_S - 60, exit=False)
    from reina_tpu_torch.core import daygraph
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.parallel import mesh as M
    from reina_tpu_torch.testing import build_synthetic_run

    M.LIVENESS_S = LOST_S
    # the kernels launch on the current device
    torch.cuda.set_device(rank)
    M.init_distributed(f"tcp://127.0.0.1:{port}", 2, rank, "nccl")
    run = build_synthetic_run(f"cuda:{rank}", n_agents=N, days=DAYS, seed=5,
                              interventions=IVS, cfg_overrides=CFG)
    alone = run_days(run, chunk_days=4)[0]
    if case == "nccl":
        agents = M.make_mesh(1, 2, device=run.device)
        out, st, cr, _ = run_days(run, chunk_days=4, mesh=agents)
        _save(f"{work}/nccl_{rank}.npz", out, st, cr)
        msg = _failed_warmup(run, rank)
    else:
        act = _refuse if case == "replay" else _killed(work)
        msg = _failing_run(run, rank, daygraph.DayGraph, "launch",
                           _on_call(KILL_AT + 1, act), barrier=False)
    with open(f"{work}/failed_{case}_{rank}.txt", "w") as f:
        f.write(f"{time.time():.3f} {msg}")
    same = _usable(run, alone)
    with open(f"{work}/usable_{case}_{rank}.txt", "w") as f:
        f.write(same)
    print(f"rank {rank}: {case} raised; one-card run after: {same}",
          flush=True)
    if same != "True":
        sys.stdout.flush()
        os._exit(0)
    t0 = time.perf_counter()
    torch.distributed.destroy_process_group()
    with open(f"{work}/down_{case}_{rank}.txt", "w") as f:
        f.write(f"{time.perf_counter() - t0:.3f}")


def _spawn(world: int, work: str, *extra: str):
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         work, *extra], cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait(procs, limit: float = 300, codes=None):
    """Each process's output once it ended with its code (``codes``, a
    code a rank; 0 by default); all are killed once one outlives
    ``limit`` seconds."""
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=limit)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            tails = "\n".join(f"--- rank {q}:\n{x.communicate()[0][-3000:]}"
                              for q, x in enumerate(procs))
            raise AssertionError(f"ranks killed after {limit} s:\n{tails}")
        assert p.returncode == (codes or {}).get(r, 0), out[-4000:]


def _plain_days(run):
    """The unsharded plain day step, day by day: each day's state, carry
    and outputs as numpy, and the host's picks rows."""
    from reina_tpu_torch import convert
    from reina_tpu_torch.core import step as S
    from reina_tpu_torch.core.engine import sched_row
    from reina_tpu_torch.core.schedule import Schedules
    from reina_tpu_torch.ops import prng
    host = Schedules(*(x.numpy() for x in run.schedules))
    key = prng.PRNGKey(run.random_seed)
    state = run.init_state
    carry = run.init_carry._replace(bkt_dst=run.init_carry.bkt_dst.clone())
    days, picks = [], []
    for d in range(DAYS - 1):
        dk = S.derive_day_keys(run.cfg, key, [d]).day(0)
        state, carry, out = S.day_step(run.cfg, run.arrays,
                                       sched_row(run.schedules, host, d),
                                       state, carry, dk, picks=picks)
        days.append(({f: np.array(v) for f, v in
                      convert.to_numpy(state).items()},
                     {f: np.array(v) for f, v in
                      convert.to_numpy(carry).items()},
                     {f: np.asarray(v) for f, v in zip(out._fields, out)}))
    return days, np.array(picks)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-rank results, and the worlds of 2 and 4 ranks run at once
    (the world of 4 resumes checkpoints written here first); for the
    build with smaller tiers (``CFG``), its one-rank run and the
    unsharded plain step day by day."""
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.ensemble import run_ensemble

    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("torch_mesh")
    work = {w: str(base / f"world{w}") for w in (2, 4)}
    for d in work.values():
        os.makedirs(d)
    run, small = _build(), _build(CFG)
    run_days(run, n_days=AT + 1, checkpoint_dir=f"{work[4]}/ck1",
             checkpoint_every=AT)
    run_days(small, n_days=AT + 1, checkpoint_dir=f"{work[4]}/ck1g",
             checkpoint_every=AT)
    lost = {}
    for case in ("killed", "boot", "ckpt"):
        os.makedirs(base / case)
        lost[case] = _spawn(2, str(base / case), case)
    procs = _spawn(2, work[2]) + _spawn(4, work[4])
    try:
        one = run_days(run, chunk_days=4)[:3]
        ens = run_ensemble(run, SEEDS)
        sweep = _sweep()
        small_one = run_days(small, chunk_days=4)[:3]
        plain = _plain_days(small)
    finally:
        try:
            for case, ps in lost.items():
                try:
                    _wait(ps, limit=120, codes={0 if case == "ckpt" else 1: 3})
                except (AssertionError, subprocess.TimeoutExpired) as e:
                    # each lost-rank world's own test reports it
                    with open(base / case / "error.txt", "w") as f:
                        f.write(repr(e)[-4000:])
        finally:
            _wait(procs)
    return run, one, ens, sweep, work, (small, small_one, plain)


def _eq(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _eq_slab(run, one, path, rank, k):
    """A rank's file against its slab of the one-rank run."""
    from reina_tpu_torch import convert
    out, state, carry = one
    z = np.load(path)
    for f, a in zip(out._fields, out):
        _eq(a, z["out__" + f], "out." + f)
    n = run.init_state.age.shape[0] // k
    capb = run.cfg.max_infectees
    lo, hi = rank * n, (rank + 1) * n
    for f, a in convert.to_numpy(state).items():
        _eq(a[lo:hi], z["st__" + f], "state." + f)
    for f, a in convert.to_numpy(carry).items():
        b = z["cr__" + f]
        if f == "bkt_dst":               # rows of the slab; the spare slot
            a, b = a[lo * capb:hi * capb], b[:-1]   # is never read
        elif f in ("bkt_fill", "nc_ag"):
            a = a[lo:hi]
        _eq(a, b, "carry." + f)


@pytest.mark.parametrize("k", [2, 4])
def test_agent_sharded_run_equals_one_rank(runs, k):
    run, one, _, _, work, _ = runs
    out = one[0]
    # the run exercises tracing, imports and vaccination
    assert out.ct_cases_per_day.max() > 0
    assert out.by_group[:, 1].sum(1).max() > 0
    assert int(one[2].bkt_fill.sum()) > 0
    for r in range(k):
        _eq_slab(run, one, f"{work[k]}/agent_{r}.npz", r, k)


def _slab_of(run, f, a, rank, k):
    """The slab of an unsharded carry or state field ``f`` that rank
    ``rank`` of ``k`` holds (the bucket table without its spare slot)."""
    n = run.init_state.age.shape[0] // k
    capb = run.cfg.max_infectees
    lo, hi = rank * n, (rank + 1) * n
    if f == "bkt_dst":
        return a[lo * capb:hi * capb]
    if a.ndim and a.shape[0] == n * k:
        return a[lo:hi]
    return a


@pytest.mark.parametrize("k", [2, 4])
def test_graph_model_on_a_shard_equals_plain_step(runs, k):
    """The graph runner's CPU model on each rank's slab, day by day,
    against the unsharded plain step: every state, carry and output
    field every day; the picks table equals the host's picks on every
    rank (the same branch on every rank), the branch tallies count them
    and the problem bits are the plain step's."""
    _, _, _, _, work, (run, _, (days, host_picks)) = runs
    traced = host_picks[:, 0] == 1
    assert traced.any() and (host_picks[:, 1] >= 0).any()
    for r in range(k):
        z = np.load(f"{work[k]}/model_{r}.npz")
        for d, (st, cr, out) in enumerate(days):
            for f, a in st.items():
                _eq(_slab_of(run, f, a, r, k), z[f"d{d}_st__{f}"],
                    f"rank {r} day {d} state.{f}")
            for f, a in cr.items():
                if f"d{d}_cr__{f}" not in z:
                    continue
                b = z[f"d{d}_cr__{f}"]
                if f == "bkt_dst":
                    b = b[:-1]
                _eq(_slab_of(run, f, a, r, k), b, f"rank {r} day {d} "
                    f"carry.{f}")
            for f, a in out.items():
                _eq(a, z[f"d{d}_out__{f}"], f"rank {r} day {d} out.{f}")
        _eq(host_picks, z["picks"], f"rank {r} picks")
        tally = z["tally"]
        for col, slot, n in z["layout"]:
            picked = host_picks[:, col]
            _eq(np.bincount(picked[picked >= 0], minlength=n).astype(
                tally.dtype), tally[slot:slot + n], f"rank {r} tally {col}")
        assert int(z["problem"]) == int(days[-1][1]["problem"])


@pytest.mark.parametrize("k", [2, 4])
def test_graphed_run_days_on_a_mesh_equals_one_rank(runs, k):
    """``run_days(graphs=True)`` on an agent axis of k (the CPU model)
    equals the one-rank run on every rank, with the host's picks."""
    _, _, _, _, work, (run, one, (_, host_picks)) = runs
    for r in range(k):
        _eq_slab(run, one, f"{work[k]}/graphed_{r}.npz", r, k)
        _eq(host_picks, np.load(f"{work[k]}/graphed_picks_{r}.npy"),
            f"rank {r} picks")


def _failed(runs, name):
    """Each rank's seconds and message of a failing run of the world of
    two."""
    work = runs[4]
    out = []
    for r in range(2):
        s, msg = open(f"{work[2]}/failed_{name}_{r}.txt").read().split(" ", 1)
        out.append((float(s), msg))
    return out


def test_failed_capture_raises_on_every_rank(runs):
    """A capture that fails on rank 1 only raises GraphError on both
    ranks (rank 0 through the ranks' agreement after the span), and
    neither hangs: both reach their next collective."""
    (_, m0), (_, m1) = _failed(runs, "capture")
    assert m1.startswith("GraphError") and "on purpose" in m1
    assert m0.startswith("GraphError") and "another rank" in m0


def test_failed_warmup_raises_on_every_rank(runs):
    """A warm-up that fails on rank 1 after the first collective of its
    span, while rank 0 waits in the second: both raise GraphError within
    seconds (rank 0 gives its collective up on rank 1's mark in the
    store), and both reach their next collective."""
    (s0, m0), (s1, m1) = _failed(runs, "warmup")
    assert m1.startswith("GraphError") and "on purpose" in m1
    assert m0.startswith("GraphError") and "another rank" in m0
    assert max(s0, s1) < 60, (s0, s1)


def test_failed_replay_raises_on_every_rank(runs):
    """A day that fails on rank 1 in a replay (the CPU model's launch of
    its third day), while rank 0 waits in that day's first collective:
    rank 0 gives its collective up on rank 1's mark, raises GraphError
    naming the day and another rank within seconds, and both reach the
    world's barrier."""
    (s0, m0), (s1, m1) = _failed(runs, "replay")
    assert m1.startswith("GraphError") and "on purpose" in m1
    assert m0.startswith("GraphError: day 2:") and "another rank" in m0
    assert max(s0, s1) < 60, (s0, s1)


def test_failed_replay_stops_the_survivors_day(runs):
    """The graph runner's CPU model of the gates (F1): on rank 0, whose
    collective of day 2 was given up on rank 1's mark, that collective
    ended its span (as an aborted collective returns on the card and the
    gate after it runs nothing) and set the stop word; no span of the
    survivor ran past a collective after it (0 ran to their end)."""
    ended, completed = (int(x) for x in _failed(runs, "replay")[0][1]
                        .rsplit("\n", 1)[1].split())
    assert ended >= 1, (ended, completed)
    assert completed == 0, (ended, completed)


def test_killed_rank_raises_on_the_other(runs):
    """Rank 1's process ends mid-run (``_killed_child``): rank 0 raises
    GraphError naming the lost rank within the liveness bound plus 10 s
    of that end, and within 60 s of its run's start; rank 1 exited with
    its code (the fixture waited on both)."""
    work = os.path.join(os.path.dirname(runs[4][2]), "killed")
    assert not os.path.exists(f"{work}/error.txt"), open(
        f"{work}/error.txt").read()
    died = float(open(f"{work}/killed_at.txt").read())
    t0, t1, msg = open(f"{work}/killed_0.txt").read().split(" ", 2)
    assert msg.startswith("GraphError") and "rank 1 is lost" in msg, msg
    assert float(t1) - died < LOST_S + 10, (float(t1) - died, msg)
    assert float(t1) - float(t0) < 60, (float(t1) - float(t0), msg)


def _lost(runs, case: str):
    """(seconds from the lost rank's end to the survivor's raise, the
    survivor's message) of a lost-rank world of the fixture."""
    work = os.path.join(os.path.dirname(runs[4][2]), case)
    assert not os.path.exists(f"{work}/error.txt"), open(
        f"{work}/error.txt").read()
    died = float(open(f"{work}/killed_at.txt").read())
    survivor = 0 if case == "boot" else 1
    t0, t1, msg = open(f"{work}/lost_{survivor}.txt").read().split(" ", 2)
    return float(t1) - died, msg


def test_rank_lost_before_make_mesh_raises_on_the_other(runs):
    """F3: rank 1 ends its process after init_distributed, before
    make_mesh: rank 0, waiting in the mesh's watched bootstrap before it
    makes any group, raises CollectiveError naming the lost rank within
    the liveness bound plus 10 s (over gloo; no group rendezvous ever
    blocks on the lost rank)."""
    late, msg = _lost(runs, "boot")
    assert msg.startswith("CollectiveError") and "rank 1 is lost" in msg, msg
    assert late < LOST_S + 10, (late, msg)


def test_rank_lost_in_sharded_checkpoint_raises_on_the_other(runs):
    """F4: rank 0 ends its process inside save_sharded, as it writes the
    file: rank 1, waiting in the group's agreement through the store
    that the file is written, raises CollectiveError naming the lost
    rank within the liveness bound plus 10 s."""
    late, msg = _lost(runs, "ckpt")
    assert msg.startswith("CollectiveError") and "rank 0 is lost" in msg, msg
    assert late < LOST_S + 10, (late, msg)


def test_failed_group_raises_on_every_rank_of_the_mesh(runs):
    """On a (2, 2) mesh a collective of the plain sharded step fails on
    rank 1 (agent group 0): ``run_ensemble`` raises on all four ranks,
    rank 0 giving up on its group's mark; of ranks 2 and 3 the first to
    look gives up on the mesh's (in its run or in the seed axis's
    gather), the other on that or on its group's; all reach the world's
    barrier."""
    work = runs[4]
    got = [open(f"{work[4]}/failed_ensemble_{r}.txt").read().split(" ", 1)
           for r in range(4)]
    assert "on purpose" in got[1][1], got[1]
    assert "another rank of the agent group failed" in got[0][1], got[0]
    assert all("another rank of the" in got[r][1] for r in (2, 3)), got
    assert any("another rank of the mesh failed" in got[r][1]
               for r in (2, 3)), got
    assert all(m.startswith(("RuntimeError", "CollectiveError"))
               for _, m in got), got
    assert max(float(s) for s, _ in got) < 60, got


def test_watch_gives_up(monkeypatch):
    """A Watch gives up on a failure mark, on a peer whose heartbeat
    stopped for the liveness bound (and not on one that keeps beating)
    and on a store that stops answering."""
    import torch.distributed as dist
    from reina_tpu_torch.parallel import mesh as M
    monkeypatch.setattr(M, "LIVENESS_S", 0.2)
    monkeypatch.setattr(M, "_SEEN", {})
    store = dist.HashStore()
    w = M.Watch([("m/failed", "another rank of the mesh failed")],
                [0, 1, 2], "agent group", store=store, rank=0)
    t0 = time.monotonic()
    with pytest.raises(M.CollectiveError, match="rank 1 is lost") as e:
        while time.monotonic() - t0 < 5:
            store.add(M._alive_key(2), 1)       # rank 2 keeps beating
            w.look()
            time.sleep(0.02)
    assert 0.2 <= time.monotonic() - t0 < 5, e.value
    w.error, w.peers = None, [2]
    w.look()
    store.set("m/failed", b"1")
    with pytest.raises(M.CollectiveError, match="of the mesh failed"):
        w.look()
    # the watch's thread finds it too, and a wait then gives up
    w.error = None
    with w, pytest.raises(M.CollectiveError, match="of the mesh failed"):
        w.wait(lambda: False)

    class Silent:
        def check(self, keys):
            raise RuntimeError("Connection reset by peer")
    with pytest.raises(M.CollectiveError, match="stopped answering"):
        M.Watch([("m/failed", "")], [0, 1], "mesh", store=Silent(),
                rank=0).look()


def test_seed_and_agent_axes_ensemble(runs):
    """A (2, 2) mesh: seeds split over the seed axis, each member over
    an agent group of two; every rank returns all members."""
    _, _, ens, _, work, _ = runs
    for r in range(4):
        z = np.load(f"{work[4]}/ensemble_{r}.npz")
        for f, a in zip(ens._fields, ens):
            _eq(a, z["out__" + f], f"rank {r} ensemble." + f)


def test_sweep_grid_across_ranks(runs):
    _, _, _, sweep, work, _ = runs
    for r in range(4):
        z = np.load(f"{work[4]}/sweep_{r}.npz")
        for f, a in zip(sweep._fields, sweep):
            _eq(a, z["out__" + f], f"rank {r} sweep." + f)


def test_resume_two_ranks_to_one(runs, tmp_path):
    """A checkpoint written by two ranks (the same file as one rank's)
    resumes on one rank to the uninterrupted run."""
    from reina_tpu_torch.core.engine import run_days
    run, one, _, _, work, _ = runs
    d = str(tmp_path / "ck")
    shutil.copytree(f"{work[2]}/ck2", d)
    out, state, _, times = run_days(run, chunk_days=4, checkpoint_dir=d)
    assert sum(n for n, _ in times) == DAYS - 1 - AT
    for f, a, b in zip(out._fields, one[0], out):
        _eq(a, b, "out." + f)
    for f, a, b in zip(state._fields, one[1], state):
        _eq(a.numpy(), b.numpy(), "state." + f)


def test_graphed_checkpoints_across_layouts(runs, tmp_path):
    """The graphed agent axis (the CPU model) checkpoints and resumes as
    the plain one: written by two graphed ranks, resumed by one; written
    by one, resumed by four graphed ranks; both equal the uninterrupted
    run."""
    from reina_tpu_torch.core.engine import run_days
    _, _, _, _, work, (run, one, _) = runs
    d = str(tmp_path / "ck")
    shutil.copytree(f"{work[2]}/ck2g", d)
    out, state, _, times = run_days(run, chunk_days=4, checkpoint_dir=d)
    assert sum(n for n, _ in times) == DAYS - 1 - AT
    for f, a, b in zip(out._fields, one[0], out):
        _eq(a, b, "out." + f)
    for f, a, b in zip(state._fields, one[1], state):
        _eq(a.numpy(), b.numpy(), "state." + f)
    for r in range(4):
        _eq_slab(run, one, f"{work[4]}/resumed_g_{r}.npz", r, 4)


def test_resume_one_rank_to_four(runs):
    run, one, _, _, work, _ = runs
    for r in range(4):
        _eq_slab(run, one, f"{work[4]}/resumed_{r}.npz", r, 4)


def test_init_distributed_without_variables(monkeypatch):
    from reina_tpu_torch.parallel import mesh as M
    for k in ("REINA_COORDINATOR", "REINA_NUM_PROCESSES", "REINA_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert M.init_distributed() == 1
    mesh = M.make_mesh(device="cpu")
    assert (mesh.n_seed, mesh.n_agent, mesh.rank) == (1, 1, 0)
    assert M.batch_placement(mesh, SEEDS) == [0, 1, 2]


def test_mesh_and_shard_rule_errors():
    from reina_tpu_torch.parallel import mesh as M
    with pytest.raises(ValueError, match="does not factor"):
        M.make_mesh(2, 1, device="cpu")          # a world of one rank
    with pytest.raises(ValueError, match="does not factor"):
        M.make_mesh(None, 3, device="cpu")
    run = _build()                               # N = 8,192
    three = M.Mesh(n_seed=1, n_agent=3, rank=0, seed_index=0, agent_index=0,
                   device=torch.device("cpu"), backend="gloo",
                   agent_group=None, seed_group=None)
    with pytest.raises(ValueError, match="pad_multiple"):
        M.shard_run(run, three)                  # 8,192 % 384 != 0
    with pytest.raises(ValueError, match="pad_multiple"):
        M.check_shard_rule(8192 + 512, 4)        # not a multiple of 1,024
    M.check_shard_rule(8192, 8)
    # seed placement: contiguous, as even as the count allows
    parts = [M.batch_placement(M.Mesh(3, 1, s, s, 0, None, "gloo", None,
                                      None), list(range(7)))
             for s in range(3)]
    assert parts == [[0, 1, 2], [3, 4], [5, 6]]


@pytest.mark.gpu
def test_graphed_agent_axis_over_nccl(tmp_path):
    """Two ranks over NCCL, a card each, three worlds of their own
    (``_nccl_child``): ``run_days`` on the agent axis is graphed by
    default and equals the one-card graphed run on every rank; a warm-up
    that fails on rank 1 after its span's first collective raises
    GraphError on both within seconds, both cards stay usable and
    ``destroy_process_group`` then returns on both (the run freed its
    graph set, whose captured collectives hold the communicator). A
    replay whose day-graph launch of day ``KILL_AT`` raises on rank 1
    raises GraphError on both within 5 s of each other; rank 1's process
    ending at that launch makes rank 0 raise within the liveness bound
    plus 10 s. After each, every rank left has a usable card (the stop
    word kept what the aborted collectives left from every kernel): its
    one-card graphed run equals the one made before, and its world's
    teardown returns. Prints each rank's seconds."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import socket
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.testing import build_synthetic_run

    def world(case: str):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = str(sk.getsockname()[1])
        return _spawn(2, str(tmp_path), case, port)

    procs = world("nccl")
    try:
        run = build_synthetic_run("cuda:0", n_agents=N, days=DAYS, seed=5,
                                  interventions=IVS, cfg_overrides=CFG)
        one = run_days(run, chunk_days=4)[:3]
    finally:
        _wait(procs, limit=NCCL_S)
    for case, codes in (("replay", None), ("killed", {1: 3})):
        _wait(world(case), limit=NCCL_S, codes=codes)
    for r in range(2):
        _eq_slab(run, one, f"{tmp_path}/nccl_{r}.npz", r, 2)

    def raised(case: str, r: int):
        at, sec, msg = open(f"{tmp_path}/failed_{case}_{r}.txt").read(
            ).split(" ", 2)
        after = open(f"{tmp_path}/usable_{case}_{r}.txt").read()
        print(f"{case}: rank {r} raised after {sec} s: {msg[:400]}; "
              f"one-card run after: {after}")
        assert after == "True", after
        return float(at), float(sec), msg, after

    for case in ("nccl", "replay"):
        got = [raised(case, r) for r in range(2)]
        assert got[1][2].startswith("GraphError") and "on purpose" in got[1][2]
        assert got[0][2].startswith("GraphError") and "another rank" in \
            got[0][2]
        assert max(g[1] for g in got) < 60, got
        if case == "replay":
            assert abs(got[0][0] - got[1][0]) < 5, got
    # a failed warm-up leaves no graph in flight: both cards stay usable,
    # and the world's teardown returns on both
    for r in range(2):
        assert open(f"{tmp_path}/usable_nccl_{r}.txt").read() == "True"
        down = float(open(f"{tmp_path}/down_nccl_{r}.txt").read())
        print(f"nccl: rank {r}'s destroy_process_group {down:.3f} s")
        assert down < 60
    died = float(open(f"{tmp_path}/killed_at.txt").read())
    at, sec, msg, after = raised("killed", 0)
    print(f"killed: rank 0 raised {at - died:.3f} s after rank 1's end")
    assert msg.startswith("GraphError") and "rank 1 is lost" in msg
    assert at - died < LOST_S + 10
    for case, ranks in (("replay", 2), ("killed", 1)):
        for r in range(ranks):
            path = f"{tmp_path}/down_{case}_{r}.txt"
            print(f"{case}: rank {r}'s destroy_process_group "
                  f"{open(path).read()} s")
            assert float(open(path).read()) < 60


if __name__ == "__main__":
    sys.path.insert(0, _REPO)
    if len(sys.argv) > 5:
        _nccl_child(int(sys.argv[1]), sys.argv[3], sys.argv[5], sys.argv[4])
    elif sys.argv[4:5] == ["killed"]:
        _killed_child(int(sys.argv[1]), sys.argv[3])
    elif sys.argv[4:5] in (["boot"], ["ckpt"]):
        _lost_child(int(sys.argv[1]), sys.argv[3], sys.argv[4])
    else:
        _child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
