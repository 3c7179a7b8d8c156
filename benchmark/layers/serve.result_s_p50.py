"""The median over the window's requests of the seconds from
``runSimulation`` to the client reading ``finished``; a request that
failed counts as never. A steadier reading beside the tail that the
cell is held to (``result_s_p75``)."""


def read(ctx):
    import numpy as np
    reqs = getattr(ctx["window"], "requests", None)
    if not reqs:
        return None
    t = [np.inf if r.error is not None else r.finished - r.submitted
         for r in reqs]
    return float(np.percentile(np.asarray(t, np.float64), 50))
