"""fused_map.finalize: the end-of-day merge body (kernels/fused_bodies.py).

One call each stepped day. Its least bytes at ``n`` agents (the padded
count): each input byte read once and each output byte written once, as
``reina_tpu_torch/kernels/checks.py`` counts them for the same function
(held equal at HUS's and Varsinais-Suomi's agent counts by
benchmark/tests/test_benchmark_files.py)."""

PATTERNS = ['_finalize_kernel']
CALLS_PER_DAY = 1


def least_bytes(n: int) -> int:
    return 30 * n + 8
