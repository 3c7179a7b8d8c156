"""Hand-written Hopper kernels for the port's main path.

Three CUDA kernels (``csrc/*.cu``, built by ``build.py`` with nvcc for
sm_90a and bound with ctypes) and four Triton kernels (``fused_bodies``,
one per fused per-agent pass of the day step). The wrappers that launch
them live beside their plain PyTorch twins in ``reina_tpu_torch.ops``;
each wrapper adds one to its entry of ``LAUNCHES`` where it launches its
kernel, and nowhere else, so a run can show that it went through the
kernels.
"""
from __future__ import annotations

LAUNCHES = {
    "fused_map.prologue": 0,
    "fused_map.recv_front": 0,
    "fused_map.post": 0,
    "fused_map.finalize": 0,
    "ledger_scan": 0,
    "fused_concat_prefix": 0,
    "fused_onehot_sum": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches() -> dict:
    return dict(LAUNCHES)
