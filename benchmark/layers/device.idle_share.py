"""The card's idle share: 1 - busy seconds under the profiler / the wall
of the same work without it (the profiler stretches the wall it
sees), as reina_tpu_torch/profile_days.py reckons it."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.events:
        return None
    return 1.0 - t.busy_s / t.wall_s
