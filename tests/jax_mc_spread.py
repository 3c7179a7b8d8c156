"""The JAX package's seed spread on XLA:CPU, seed by seed: the reference
side of ``python -m reina_tpu_torch.mc_spread --curves`` (the port's,
on the card).

    JAX_PLATFORMS=cpu python tests/jax_mc_spread.py AREA S0 S1 DAYS OUT

AREA is ``HUS`` (the defaults) or another area of the defaults (e.g.
``Varsinais-Suomi``). It drives the loop of
tools/bench_monte_carlo.py:47-97: one ``build_run`` of the defaults,
base key ``PRNGKey(s)`` for each seed s in [S0, S1), ``run_chunk`` over
28-day chunks, and appends each seed's final all_infected, its seconds
and its daily totals (all_infected, new_infections, all_detected,
in_ward, in_icu, dead) to the JSONL file OUT as the seed ends, so that a
run cut short keeps the seeds it finished. Unlike that tool it writes
nothing else: no BENCH_MC.json. The JAX package's persistent compile
cache goes into ``.jax_cache`` at the root of the tree it runs from, so
run it from a ``git archive`` copy of the repository, not from the
repository itself. A 365-day seed takes ~0.4-0.7 s a day at
Varsinais-Suomi and ~1.2-1.9 s a day at HUS on 8 CPU cores; the first
seed's seconds also hold the compile. ``python -m
reina_tpu_torch.mc_compare OUT PORT.jsonl`` sets the result beside the
port's.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the daily totals kept: their rows of DayOutputs.by_group
CURVES = {"all_infected": 3, "new_infections": 12, "all_detected": 5,
          "in_ward": 8, "in_icu": 6, "dead": 9}


def main(argv) -> int:
    area, s0, s1, days, out = (argv[0], int(argv[1]), int(argv[2]),
                               int(argv[3]), argv[4])
    import jax.random as jr
    import numpy as np

    from reina_tpu.config.variables import VARIABLE_DEFAULTS
    from reina_tpu.core.engine import build_run, run_chunk
    from reina_tpu.utils.compile import enable_persistent_cache
    enable_persistent_cache()

    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = days
    if area != "HUS":
        v["area_name"] = area
    t0 = time.perf_counter()
    run = build_run(v)
    print(f"area={v['area_name']} N={run.init_state.age.shape[0]} "
          f"build {time.perf_counter() - t0:.1f}s", flush=True)
    steps, chunk = days - 1, 28
    for s in range(s0, s1):
        t0 = time.perf_counter()
        key = jr.PRNGKey(s)
        state, carry = run.init_state, run.init_carry
        day, rows = 0, []
        while day < steps:
            step = min(chunk, steps - day)
            state, carry, outs = run_chunk(run.cfg, run.arrays,
                                           run.schedules, state, carry, key,
                                           step, day)
            rows.append(np.asarray(outs.by_group))
            day += step
        tot = np.concatenate(rows).sum(-1)          # (steps, 13)
        sec = time.perf_counter() - t0
        rec = {"seed": s, "area": v["area_name"], "days": steps,
               "final": int(tot[-1, 3]), "seconds": sec,
               "s_per_day": sec / steps,
               **{k: tot[:, j].tolist() for k, j in CURVES.items()}}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"seed {s}: final {rec['final']} {sec:.1f}s "
              f"({sec / steps:.3f} s/day)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
