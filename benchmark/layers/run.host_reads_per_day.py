"""Host reads of device values a stepped day in the window (the
program's ``step.STATS``: reads, days)."""


def read(ctx):
    c = ctx["window"].counters
    days = c.get("stats.days", 0)
    return c.get("stats.reads", 0) / days if days else None
