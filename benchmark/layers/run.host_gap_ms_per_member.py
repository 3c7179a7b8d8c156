"""Milliseconds a member of the host's own time outside its launches and
its waits: the members' spans (``ensemble.member``) less their chunks'
launches (``run.launch``) and their waits for the card (``run.wait``),
over the members in the window. It is the member's set-up
(``run.prepare``), its fetch (``run.fetch``) and the host between. It
is a host self-time, not the card's idle time: the card may work
during part of it (the start's copies in ``run.prepare``), so it bounds
the member's idle from above."""


def read(ctx):
    c = ctx["window"].counters
    members = c.get("stats.ensemble.member_n", 0)
    if not members:
        return None
    self_s = (c.get("stats.ensemble.member_s", 0.0)
              - c.get("stats.run.launch_s", 0.0)
              - c.get("stats.run.wait_s", 0.0))
    return 1e3 * self_s / members
