"""Seconds a served run spends publishing its partial results, a run in
the window: the span ``serve.publish`` (simulation.py: a chunk's daily
columns, the per-infected timing and the result cache's write) over the
runs that ended (``serve.run`` spans)."""


def read(ctx):
    c = ctx["window"].counters
    runs = c.get("stats.serve.run_n", 0)
    s = c.get("stats.serve.publish_s")
    return s / runs if runs and s is not None else None
