"""Seconds of host compile a build-cache miss in the window: the span
``build.compile`` (core/engine.py ``build_run``: ``host_compile``) over
the misses (``step.STATS`` build.misses, simulation.py ``BuildCache``)."""


def read(ctx):
    c = ctx["window"].counters
    misses = c.get("stats.build.misses", 0)
    s = c.get("stats.build.compile_s")
    return s / misses if misses and s is not None else None
