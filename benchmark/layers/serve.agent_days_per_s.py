"""Agent-days of the scenarios that finished in the window, over the
window's seconds."""


def read(ctx):
    w = ctx["window"]
    if not hasattr(w, "requests"):
        return None
    return ctx["driver"].agent_days(w) / w.seconds if w.seconds else None
