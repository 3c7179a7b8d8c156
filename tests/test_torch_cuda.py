"""Kernel-against-twin tests on the card (marker ``gpu``).

Run on a machine with a CUDA device:

    python -m pytest -m gpu tests/test_torch_cuda.py

Without one every test skips. Whether there is a card is decided inside
each test, never at import, so every pytest worker collects the same
tests. The tolerances are those of reina_tpu_torch/kernels/checks.py:
exact for the prefix sums, histograms and ledger; exact integer and
bool outputs and floats within 2 ulp for the fused bodies.
"""
import numpy as np
import pytest
import torch

from reina_tpu_torch import kernels

pytestmark = pytest.mark.gpu

KERNELS = ["fused_map.prologue", "fused_map.recv_front", "fused_map.post",
           "fused_map.finalize", "ledger_scan", "fused_concat_prefix",
           "fused_onehot_sum"]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("n", [8192, 1686528], ids=["small", "hus"])
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matches_twin(name, n):
    _need_cuda()
    from reina_tpu_torch.kernels import checks
    c = {c.name: c for c in checks.checks(n, 0, "cuda")}[name]
    before = kernels.launches()[name]
    r = checks.run_check(c, timing=False)
    assert kernels.launches()[name] > before
    assert r.ok, r


def test_uniform_bits_on_cuda_match_cpu():
    _need_cuda()
    from reina_tpu_torch.ops import prng
    k = prng.PRNGKey(9)
    for shape in [(1686528,), (512, 10, 2), (300, 101)]:
        a = prng.uniform(k, shape, "cuda").cpu()
        b = prng.uniform(k, shape, "cpu")
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_synthetic_run_on_cuda():
    _need_cuda()
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.testing import build_synthetic_run
    ivs = [["test-with-contact-tracing", "2020-02-20", 60],
           ["import-infections", "2020-02-20", 50],
           ["vaccinate", "2020-02-22", 700, 60, None]]
    run = build_synthetic_run("cuda", n_agents=20000, days=14, seed=3,
                              interventions=ivs)
    kernels.reset_launches()
    out, state, carry, _ = run_days(run, chunk_days=8)
    counts = kernels.launches()
    assert all(v > 0 for v in counts.values()), counts
    assert counts["fused_map.prologue"] == 13
    susceptible = out.by_group[:, 0].sum(axis=1)
    all_infected = out.by_group[:, 3].sum(axis=1)
    np.testing.assert_array_equal(susceptible + all_infected, 20000)
    assert all_infected[-1] > all_infected[0]
    assert state.state.is_cuda
