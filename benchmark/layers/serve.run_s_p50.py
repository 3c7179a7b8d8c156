"""The median over the window's requests of the server's own seconds a
run, from its admission to its terminal write: the ``serve.run`` spans
of the program's ring (utils/perf.py ``RING``) whose id is a request's
run id; a request that failed counts as never. None where a finished
request has no span in the ring, or the program keeps none."""


def read(ctx):
    import numpy as np
    reqs = getattr(ctx["window"], "requests", None)
    if not reqs:
        return None
    from reina_tpu_torch.utils import perf
    ring = getattr(perf, "RING", None)
    if ring is None:
        return None
    runs = {s[1]: (s[4] - s[3]) / 1e9 for s in list(ring)
            if s[0] == "serve.run"}
    t = []
    for r in reqs:
        if r.error is not None:
            t.append(np.inf)
        elif r.run_id in runs:
            t.append(runs[r.run_id])
        else:
            return None
    return float(np.median(np.asarray(t, np.float64)))
