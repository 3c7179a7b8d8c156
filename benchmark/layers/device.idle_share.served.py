"""The card's idle share over a wave of the served traffic, a what-if a
client: 1 - busy seconds under the profiler / the wave's wall without
it."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.events:
        return None
    return 1.0 - t.busy_s / t.wall_s
