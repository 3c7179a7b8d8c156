"""fused_fn_onehot_sum: phase 7's ten output counts by age group
(kernels/csrc/fn_onehot.cu).

One call each stepped day. Its least bytes at ``n`` agents (the padded
count): each input byte read once and each output byte written once, as
``reina_tpu_torch/kernels/checks.py`` counts them for the same function
(held equal at HUS's and Varsinais-Suomi's agent counts by
benchmark/tests/test_benchmark_files.py)."""

PATTERNS = ['fn_onehot_kernel']
CALLS_PER_DAY = 1


def least_bytes(n: int) -> int:
    return 14 * n + 440
