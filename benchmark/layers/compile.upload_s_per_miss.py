"""Seconds of upload a build-cache miss in the window: the span
``build.upload`` (core/engine.py ``build_run``: the build's arrays,
schedules, state and carry put on the card) over the misses
(``step.STATS`` build.misses)."""


def read(ctx):
    c = ctx["window"].counters
    misses = c.get("stats.build.misses", 0)
    s = c.get("stats.build.upload_s")
    return s / misses if misses and s is not None else None
