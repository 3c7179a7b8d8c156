"""REINA on PyTorch and CUDA: a port of the ``reina_tpu`` engine.

The JAX package ``reina_tpu`` is the reference. This package runs its
main path — ``core.engine.build_run`` → ``run_days`` → ``day_step``,
on a card as captured CUDA graphs of the day's spans (``core.graphs``) —
its driver (checkpoints, the build cache, ``simulate_individuals``, the
CLI), seed ensembles and calibration sweeps, the parameter explorer and
the serving runtime (GraphQL server, run workers, result cache, web UI)
on tensors of an explicit device, and across ranks of torch.distributed
on a (seed × agent) mesh. On CUDA the Pallas kernels
of that path are hand-written Hopper kernels (``kernels/``); on the CPU
their plain PyTorch twins run. The package imports torch and nothing of
jax, pandas or the JAX package: ``config``, ``data``, ``utils``, the
GraphQL engine and the web UI's page are its own copies of the JAX
package's.

Layout:

  config/      variables, interventions, scenarios, settings (copies)
  data/        dataset loaders and their .npz archives (copies)
  utils/       locale, memoize (calcfunc), perf (counters and spans)
  core/        constants, params, schedule, state (numpy host compile,
               carried over from the JAX package), step (the day as
               spans), graphs (the spans as CUDA graphs), engine,
               checkpoint (the JAX package's npz v6 layout), debug
               (person_str, dump_state, infection_tree)
  ops/         prng (jax.random's threefry, bit for bit), random
               (samplers), fusedmap, clamped, compact (kernel wrappers
               and their twins)
  kernels/     csrc/*.cu (nvcc, ctypes), fused_bodies.py (Triton)
  simulation.py  build cache, simulate_individuals, outputs_to_frames
  ensemble.py  run_ensemble, run_monte_carlo (numpy columns, CSV)
  calibration.py  grid_points, sweep_grid, score_against_observed,
               calibrate
  mc_spread.py the final all_infected's spread over HUS seeds (card;
               across cards under torchrun)
  parallel/    mesh: init_distributed, make_mesh, the agent shard and
               its collectives, shard_run, the seed placement
  models/      sir (the RK4 comparison model)
  sampling.py  the parameter explorer's draws
  runtime/     result cache (memory, shm, redis), worker threads, xlsx,
               graphql/ (engine, introspection, sdl, schema, server)
  webui/       app.html, served by the GraphQL server
  cli.py       ``python -m reina_tpu_torch.cli simulate``, ``monte-carlo``,
               ``sample`` and ``calibrate``
  convert.py   numpy values → tensors on a device
  testing.py   synthetic runs
"""

__version__ = "0.1.0"
