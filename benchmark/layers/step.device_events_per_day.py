"""Device events (kernels, copies, sets) a stepped day in the traced
stretch."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.events:
        return None
    return t.events / t.days
