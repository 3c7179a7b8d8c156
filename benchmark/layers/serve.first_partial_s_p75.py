"""The 75th percentile over the window's requests of the seconds from
``runSimulation`` to the first poll with a non-empty ``dates``; a
request that failed counts as never."""


def read(ctx):
    import numpy as np
    reqs = getattr(ctx["window"], "requests", None)
    if not reqs:
        return None
    t = [np.inf if r.error is not None or r.first_partial is None
         else r.first_partial - r.submitted for r in reqs]
    return float(np.percentile(np.asarray(t, np.float64), 75))
