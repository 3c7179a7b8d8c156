"""Seconds a served run's worker waits for the card at its sync points
(every 7-day chunk, on the one stream the workers share), a run in the
window: the span ``run.wait`` (core/engine.py ``run_days``) over the
runs that ended (``serve.run`` spans)."""


def read(ctx):
    c = ctx["window"].counters
    runs = c.get("stats.serve.run_n", 0)
    s = c.get("stats.run.wait_s")
    return s / runs if runs and s is not None else None
