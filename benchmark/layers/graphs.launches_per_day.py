"""Day-graph launches a stepped day in the window (``step.STATS``:
launches, days); 1 where every day is one launch."""


def read(ctx):
    c = ctx["window"].counters
    days = c.get("stats.days", 0)
    return c.get("stats.launches", 0) / days if days else None
