"""Milliseconds a stepped day in which the card ran a device event, in the
traced stretch (the union of the events' intervals)."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.events:
        return None
    return t.busy_s * 1e3 / t.days
