"""fused_map.post: the post-ledger body (kernels/csrc/post.cu).

One call each stepped day. Its least bytes at ``n`` agents (the padded
count): each input byte read once and each output byte written once, as
``reina_tpu_torch/kernels/checks.py`` counts them for the same function
(held equal at HUS's and Varsinais-Suomi's agent counts by
benchmark/tests/test_benchmark_files.py)."""

PATTERNS = ['post_kernel']
CALLS_PER_DAY = 1


def least_bytes(n: int) -> int:
    return 35 * n + 32
