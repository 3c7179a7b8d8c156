"""ledger_scan: the first-come-first-served bed and ICU ledgers
(kernels/csrc/ledger.cu, three launches).

One call each stepped day. Its least bytes at ``n`` agents (the padded
count): each input byte read once and each output byte written once, as
``reina_tpu_torch/kernels/checks.py`` counts them for the same function
(held equal at HUS's and Varsinais-Suomi's agent counts by
benchmark/tests/test_benchmark_files.py)."""

PATTERNS = ['ledger_tile_fold', 'ledger_tile_scan', 'ledger_emit(?!_slab)']
CALLS_PER_DAY = 1


def least_bytes(n: int) -> int:
    return 12 * n + 16
