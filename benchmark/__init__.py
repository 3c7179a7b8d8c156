"""The benchmark of reina_tpu_torch, the port of REINA to PyTorch and
CUDA: ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card
and prints its result as the last line of standard output."""
