"""Spans captured in the window (``step.STATS`` captures): 0 once set-up
has built every day graph the traffic needs."""


def read(ctx):
    c = ctx["window"].counters
    if not c.get("stats.days", 0):
        return None
    return c.get("stats.captures", 0)
