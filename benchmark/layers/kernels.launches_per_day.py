"""Launches of the hand-written kernels a stepped day in the window, those
inside the day graphs included (``kernels.LAUNCHES``)."""


def read(ctx):
    c = ctx["window"].counters
    days = c.get("stats.days", 0)
    n = sum(v for k, v in c.items() if k.startswith("launch."))
    return n / days if days else None
