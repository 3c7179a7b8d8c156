"""The day's per-agent kernels' share of their roofline: the least time of
the functions in benchmark/roofline/ (their least bytes over the H100
SXM's 3.35 TB/s, times their calls a day and the traced days) over the
device time of the kernels their patterns name, in percent."""

HBM_BYTES_PER_S = 3.35e12      # H100 SXM 80 GB, published peak


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.events:
        return None
    n = -(-ctx["cell"].config["agents"] // 1024) * 1024
    least = kernel = 0.0
    for f in ctx["rooflines"].values():
        least += f.least_bytes(n) * f.CALLS_PER_DAY * t.days / HBM_BYTES_PER_S
        kernel += t.kernel_s(f.PATTERNS)
    return 100.0 * least / kernel if kernel else None
