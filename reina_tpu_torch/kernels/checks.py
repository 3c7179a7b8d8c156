"""Kernel-against-twin checks on a CUDA device.

For each hand-written kernel of the main path: inputs at a given agent
count made from a numpy seed (value ranges as the day step produces
them), one launch through the kernel's wrapper and one through its
plain PyTorch twin on the same device, the comparison with its stated
tolerance, and the two times from CUDA events after warm-up. Used by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: the prefix sums, histograms and ledger outputs (U, grants,
final balances) are exact; the fused bodies' integer and bool outputs
are exact and their float outputs within 2 ulp (libdevice ``exp`` and
the twin's ``torch.exp`` may round differently).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from ..core import step
from ..ops import clamped, fusedmap
from . import fused_bodies

HUS_N = 1686528          # the HUS run's padded agent count
V, T, B, G = 2, 21, 9, 10


@dataclass
class Check:
    name: str
    route: str
    source: str
    replaces: str
    kernel: Callable[[], tuple]
    twin: Callable[[], tuple]
    float_ulp: int = 0


@dataclass
class Result:
    name: str
    ok: bool
    mismatches: int
    max_abs_err: float
    max_ulp: int
    ms: float
    plain_ms: float


def _streams(n, seed, dev):
    r = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return dict(
        st=t(r.integers(0, 7, n).astype(np.int8)),
        sev=t(r.integers(0, 5, n).astype(np.int8)),
        var=t(r.integers(0, V, n).astype(np.int8)),
        dl=t(r.integers(0, 4, n).astype(np.int16)),
        doil=t(r.integers(-2, 12, n).astype(np.int16)),
        doi=t(r.integers(-1, 30, n).astype(np.int16)),
        b=[t(r.random(n) < p) for p in np.linspace(0.05, 0.7, 14)],
        f=[t(r.random(n).astype(np.float32)) for _ in range(3)],
        z=t(r.standard_normal(n).astype(np.float32)),
        nc=t((r.random(n) * 30).astype(np.float32)),
        ninf=t(r.integers(0, 5, n).astype(np.int32)),
        band=t(r.integers(0, B, n).astype(np.int32)),
        lam=t(np.log1p(-r.random((V, n)) * 1e-3).astype(np.float32)),
        o2r=t((r.random(n) * 30).astype(np.float32)),
        vnew=t(r.integers(0, V, n).astype(np.int32)),
        tabs=[t((r.random(V) * 0.8 + 0.05).astype(np.float32))
              for _ in range(4)],
        iot=t((r.random((V, T)) * 0.2).astype(np.float32)),
        D=t(np.floor(r.random((V, B)) * 500).astype(np.float32)),
        rel=[t((r.random(n) < 0.002).astype(np.int32)) for _ in range(2)],
        req=[t(r.random(n) < 0.003) for _ in range(2)],
        w=t((r.random(n) * (r.random(n) < 0.05) * 40).astype(np.float32)),
        newly=t((r.random(n) < 0.001).astype(np.float32)),
        code=t(r.integers(0, G + 1, n).astype(np.int32)),
        offset=int(r.integers(0, n)),
    )


_FM = "reina_tpu/ops/fusedmap.py"


def checks(n: int, seed: int, dev) -> List[Check]:
    s = _streams(n, seed, dev)
    b, f = s["b"], s["f"]
    day, mode, dap = 40, 3, 0.25

    pro = [s["st"], s["dl"], s["doil"], s["doi"], s["sev"], s["var"], b[0],
           b[1], b[2], s["z"], s["nc"], b[3], s["ninf"], s["iot"],
           s["tabs"][0], s["tabs"][1], day]
    rf = [s["band"], s["lam"], b[4], b[5], b[6], f[0], f[1], s["st"],
          s["doi"], s["dl"], s["o2r"], s["sev"], b[7], b[8], s["doil"],
          f[2], s["var"], s["D"], s["tabs"][0], s["tabs"][1], day, mode,
          dap]
    po = [s["st"], s["sev"], s["var"], s["o2r"], s["dl"]] + b[:2] + [f[2]] \
        + b[2:14] + s["tabs"]
    fin = [s["st"], s["sev"], s["var"], s["vnew"], s["dl"], s["doil"],
           s["doi"], b[0], b[1], b[2], b[3], b[4], day, 1]
    init = torch.tensor([300, 60], dtype=torch.int32, device=dev)

    def ledger_kernel():
        U, rm = clamped.ledger_streams(s["rel"], s["req"], s["offset"])
        g, fin_ = clamped.grants_from_streams(U, rm, s["rel"], s["req"],
                                              init, s["offset"])
        return tuple(U) + tuple(g) + (fin_,)

    def ledger_twin():
        U = [torch.cumsum(r - q.to(torch.int32), 0, dtype=torch.int32)
             - (r - q.to(torch.int32)) + r
             for r, q in zip(s["rel"], s["req"])]
        g, fin_ = clamped.grants_twin(s["rel"], s["req"], init, s["offset"])
        return tuple(U) + tuple(g) + (fin_,)

    masks = [bb for bb in b[:13]]
    codes = s["var"].to(torch.int32)
    return [
        Check("fused_map.prologue", "triton",
              "reina_tpu_torch/kernels/fused_bodies.py", f"{_FM}:191",
              lambda: fused_bodies.prologue(*pro),
              lambda: step.prologue(*pro), 2),
        Check("fused_map.recv_front", "triton",
              "reina_tpu_torch/kernels/fused_bodies.py", f"{_FM}:191",
              lambda: fused_bodies.recv_front(*rf),
              lambda: step.recv_front(*rf), 2),
        Check("fused_map.post", "triton",
              "reina_tpu_torch/kernels/fused_bodies.py", f"{_FM}:191",
              lambda: fused_bodies.post(*po),
              lambda: step.post(*po), 2),
        Check("fused_map.finalize", "triton",
              "reina_tpu_torch/kernels/fused_bodies.py", f"{_FM}:191",
              lambda: fused_bodies.finalize(*fin),
              lambda: step.finalize(*fin), 2),
        Check("ledger_scan", "cuda", "reina_tpu_torch/kernels/csrc/ledger.cu",
              "reina_tpu/ops/clamped.py:159", ledger_kernel, ledger_twin),
        Check("fused_concat_prefix", "cuda",
              "reina_tpu_torch/kernels/csrc/prefix.cu", f"{_FM}:553",
              lambda: (fusedmap.fused_concat_prefix(s["newly"], None, 1),
                       fusedmap.fused_concat_prefix(s["w"], codes, V)),
              lambda: (fusedmap.concat_prefix_twin(s["newly"], None, 1),
                       fusedmap.concat_prefix_twin(s["w"], codes, V))),
        Check("fused_onehot_sum", "cuda",
              "reina_tpu_torch/kernels/csrc/onehot.cu", f"{_FM}:318",
              lambda: (fusedmap.fused_onehot_sum(masks, s["code"], G + 1),),
              lambda: (fusedmap.onehot_sum_twin(masks, s["code"], G + 1),)),
    ]


def compare(got, want, float_ulp: int):
    """(mismatches, max_abs_err, max_ulp) over paired outputs."""
    mism, err, ulp = 0, 0.0, 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (
            g.shape, w.shape, g.dtype, w.dtype)
        if g.dtype == torch.float32:
            d = (g.view(torch.int32).to(torch.int64)
                 - w.view(torch.int32).to(torch.int64)).abs()
            u = int(d.max()) if d.numel() else 0
            ulp = max(ulp, u)
            mism += int((d > float_ulp).sum())
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        else:
            ne = g != w
            mism += int(ne.sum())
            if ne.any():
                err = max(err, float((g.to(torch.float64)
                                      - w.to(torch.float64)).abs().max()))
    return mism, err, ulp


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def run_check(c: Check, timing: bool = True) -> Result:
    got = c.kernel()
    want = c.twin()
    torch.cuda.synchronize()
    mism, err, ulp = compare(got, want, c.float_ulp)
    ms = time_ms(c.kernel) if timing else float("nan")
    plain = time_ms(c.twin) if timing else float("nan")
    return Result(c.name, mism == 0, mism, err, ulp, ms, plain)
