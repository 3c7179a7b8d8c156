"""The port's mesh (reina_tpu_torch/parallel/mesh.py) on the CPU: ranks
are spawned interpreters joined over gloo, one torch thread each, at a
small size (8,192 agents, 10 days), and nothing here compiles a JAX
program. The cases of tests/test_parallel.py and tests/test_multihost.py
that have a counterpart in the port:

  * an agent-sharded run (k = 2 and 4) equals the one-rank ``run_days``
    in every output, state and carry field, bit for bit; the run traces
    contacts, imports infections and vaccinates, so every collective
    point of the day step runs;
  * on a (2 seed × 2 agent) mesh, ``run_ensemble`` and ``sweep_grid``
    equal the one-rank ensemble and sweep on every rank;
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


def _build():
    from reina_tpu_torch.testing import build_synthetic_run
    return build_synthetic_run("cpu", n_agents=N, days=DAYS, seed=5,
                               interventions=IVS)


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


def _child(rank: int, world: int, work: str) -> None:
    """One rank of a world of 2 or 4 (see the module docstring)."""
    torch.set_num_threads(1)
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.ensemble import run_ensemble
    from reina_tpu_torch.parallel import mesh as M

    assert M.init_distributed(f"file://{work}/store", world, rank,
                              backend="gloo") == world
    run = _build()
    agents = M.make_mesh(1, world, device="cpu")
    out, st, cr, _ = run_days(run, chunk_days=4, mesh=agents)
    _save(f"{work}/agent_{rank}.npz", out, st, cr)
    if world == 2:
        run_days(run, n_days=AT + 1, checkpoint_dir=f"{work}/ck2",
                 checkpoint_every=AT, mesh=agents)
    else:
        out, st, cr, _ = run_days(run, chunk_days=4, mesh=agents,
                                  checkpoint_dir=f"{work}/ck1")
        _save(f"{work}/resumed_{rank}.npz", out, st, cr)
        both = M.make_mesh(2, 2, device="cpu")
        _save(f"{work}/ensemble_{rank}.npz",
              run_ensemble(run, SEEDS, mesh=both))
        _save(f"{work}/sweep_{rank}.npz", _sweep(both))
    print(f"rank {rank} of {world}: {M.stats()}", flush=True)
    # join gloo's threads now: left to the interpreter's exit, they can
    # end the process in std::terminate (seen under a loaded host)
    torch.distributed.destroy_process_group()


def _spawn(world: int, work: str):
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         work], cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait(procs):
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-rank results, and the worlds of 2 and 4 ranks run at once
    (the world of 4 resumes a checkpoint written here first)."""
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.ensemble import run_ensemble

    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("torch_mesh")
    work = {w: str(base / f"world{w}") for w in (2, 4)}
    for d in work.values():
        os.makedirs(d)
    run = _build()
    run_days(run, n_days=AT + 1, checkpoint_dir=f"{work[4]}/ck1",
             checkpoint_every=AT)
    procs = _spawn(2, work[2]) + _spawn(4, work[4])
    try:
        one = run_days(run, chunk_days=4)[:3]
        ens = run_ensemble(run, SEEDS)
        sweep = _sweep()
    finally:
        _wait(procs)
    return run, one, ens, sweep, work


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
    run, one, _, _, work = runs
    out = one[0]
    # the run exercises tracing, imports and vaccination
    assert out.ct_cases_per_day.max() > 0
    assert out.by_group[:, 1].sum(1).max() > 0
    assert int(one[2].bkt_fill.sum()) > 0
    for r in range(k):
        _eq_slab(run, one, f"{work[k]}/agent_{r}.npz", r, k)


def test_seed_and_agent_axes_ensemble(runs):
    """A (2, 2) mesh: seeds split over the seed axis, each member over
    an agent group of two; every rank returns all members."""
    _, _, ens, _, work = runs
    for r in range(4):
        z = np.load(f"{work[4]}/ensemble_{r}.npz")
        for f, a in zip(ens._fields, ens):
            _eq(a, z["out__" + f], f"rank {r} ensemble." + f)


def test_sweep_grid_across_ranks(runs):
    _, _, _, sweep, work = runs
    for r in range(4):
        z = np.load(f"{work[4]}/sweep_{r}.npz")
        for f, a in zip(sweep._fields, sweep):
            _eq(a, z["out__" + f], f"rank {r} sweep." + f)


def test_resume_two_ranks_to_one(runs, tmp_path):
    """A checkpoint written by two ranks (the same file as one rank's)
    resumes on one rank to the uninterrupted run."""
    from reina_tpu_torch.core.engine import run_days
    run, one, _, _, work = runs
    d = str(tmp_path / "ck")
    shutil.copytree(f"{work[2]}/ck2", d)
    out, state, _, times = run_days(run, chunk_days=4, checkpoint_dir=d)
    assert sum(n for n, _ in times) == DAYS - 1 - AT
    for f, a, b in zip(out._fields, one[0], out):
        _eq(a, b, "out." + f)
    for f, a, b in zip(state._fields, one[1], state):
        _eq(a.numpy(), b.numpy(), "state." + f)


def test_resume_one_rank_to_four(runs):
    run, one, _, _, work = runs
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


if __name__ == "__main__":
    sys.path.insert(0, _REPO)
    _child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
