"""fused_bihistogram: the contact-count histogram (kernels/csrc/bihist.cu):
its gate for every agent and its 84 x 101 bins only; the exposers' codes
and weights, which depend on the day, are left out.

One call each stepped day. Its least bytes at ``n`` agents (the padded
count): each input byte read once and each output byte written once, as
``reina_tpu_torch/kernels/checks.py`` counts them for the same function
(held equal at HUS's and Varsinais-Suomi's agent counts by
benchmark/tests/test_benchmark_files.py)."""

PATTERNS = ['bihist_kernel']
CALLS_PER_DAY = 1


def least_bytes(n: int) -> int:
    return 1 * n + 33936
