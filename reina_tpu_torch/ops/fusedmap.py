"""Fused per-agent passes, masked one-hot sums and blockwise prefix sums
(port of reina_tpu/ops/fusedmap.py).

Two of the ops here have a hand-written kernel (reina_tpu_torch/kernels)
and a plain PyTorch twin with the same semantics; the wrapper takes the
twin only for tensors on the CPU and launches the kernel for CUDA
tensors, raising on what the kernel does not take:

  * ``fused_concat_prefix``: the blockwise Hillis-Steele prefix with a
    serial carry, bit for bit the JAX package's association;
  * ``fused_onehot_sum``: exact integer histograms of masks by code.

``fused_map`` runs one of the day step's four fused bodies: the body
function itself (the twin) on the CPU, its Triton kernel on CUDA.

``fused_fn_onehot_sum`` and ``fused_bihistogram`` are plain PyTorch on
every device: the JAX package's day step forces their XLA form, and
their kernels are still to be ported.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .. import kernels

LANE = 128


def _largest_block(n: int, want: int, mult: int) -> int:
    for cand in range(min(want, n) // mult * mult, mult - 1, -mult):
        if n % cand == 0:
            return cand
    return mult


def _same_device(ts):
    devs = {t.device for t in ts if isinstance(t, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    return devs.pop()


# ---------------------------------------------------------------------------
# fused_map

def fused_map(fn: Callable, arrays: Sequence[torch.Tensor],
              smalls: Sequence = ()):
    """Run the fused body ``fn(*arrays, *smalls)``: the function itself
    for CPU tensors, the Triton kernel of the same name for CUDA ones
    (kernels/fused_bodies.py). Returns a tuple of (N,) tensors."""
    dev = _same_device(arrays)
    if dev.type == "cpu":
        out = fn(*arrays, *smalls)
        return out if isinstance(out, tuple) else (out,)
    if dev.type != "cuda":
        raise ValueError(f"fused_map: unsupported device {dev}")
    from ..kernels import fused_bodies
    return fused_bodies.LAUNCHERS[fn.__name__](*arrays, *smalls)


# ---------------------------------------------------------------------------
# fused_onehot_sum

def onehot_sum_twin(parts, code_b, n_b: int) -> torch.Tensor:
    """out[k, b] = sum_i parts[k][i]·[code_b[i] == b]; codes outside
    [0, n_b) count nowhere. Exact for integer-valued parts (f32 sums of
    integers below 2^24)."""
    code = code_b.to(torch.int64)
    ok = (code >= 0) & (code < n_b)
    idx = torch.where(ok, code, 0)
    out = torch.zeros((len(parts), n_b), dtype=torch.float32,
                      device=code.device)
    for k, p in enumerate(parts):
        out[k].index_add_(0, idx, torch.where(ok, p.to(torch.float32), 0.0))
    return out


def fused_onehot_sum(parts, code_b, n_b: int) -> torch.Tensor:
    """(K, n_b) float32 one-hot sums of K bool masks (kernel on CUDA:
    kernels/csrc/onehot.cu)."""
    dev = _same_device(list(parts) + [code_b])
    if dev.type == "cpu":
        return onehot_sum_twin(parts, code_b, n_b)
    n = code_b.shape[0]
    for p in parts:
        if p.dtype != torch.bool or p.shape != (n,):
            raise TypeError("fused_onehot_sum kernel takes (N,) bool masks")
    if code_b.dtype != torch.int32 or not code_b.is_contiguous():
        raise TypeError("fused_onehot_sum kernel takes contiguous int32 codes")
    from ..kernels import build
    stacked = torch.stack(list(parts)).view(torch.uint8)
    K = len(parts)
    acc = torch.empty(K * n_b, dtype=torch.int32, device=dev)
    out = torch.empty((K, n_b), dtype=torch.float32, device=dev)
    kernels.LAUNCHES["fused_onehot_sum"] += 1
    build.check(build.lib().reina_onehot_sum(
        stacked.data_ptr(), code_b.data_ptr(), acc.data_ptr(),
        out.data_ptr(), n, K, n_b, build.stream_of(code_b)),
        "fused_onehot_sum")
    return out


def fused_fn_onehot_sum(fields, mask_fn, n_masks: int, code_b,
                        n_b: int) -> torch.Tensor:
    """Masks computed from raw fields, then counted (plain PyTorch)."""
    masks = mask_fn(*fields)
    if len(masks) != n_masks:
        raise ValueError(f"mask_fn gave {len(masks)} masks, want {n_masks}")
    return onehot_sum_twin(masks, code_b, n_b)


def fused_bihistogram(code_a, n_a: int, weights, code_b,
                      n_b: int) -> torch.Tensor:
    """out[a, b] = sum w·[code_a == a]·[code_b == b]; out-of-range codes
    count nowhere. Exact for integer weights (plain PyTorch)."""
    ca, cb = code_a.to(torch.int64), code_b.to(torch.int64)
    ok = (ca >= 0) & (ca < n_a) & (cb >= 0) & (cb < n_b)
    flat = torch.where(ok, ca * n_b + cb, 0)
    out = torch.zeros(n_a * n_b, dtype=torch.float32, device=ca.device)
    out.index_add_(0, flat, torch.where(ok, weights.to(torch.float32), 0.0))
    return out.reshape(n_a, n_b)


# ---------------------------------------------------------------------------
# fused_concat_prefix

def _hs_prefix_blocks(x):
    """Inclusive flat prefix of each (rows, LANE) block of x (..., rows,
    LANE) with the reference's Hillis-Steele association: lane steps,
    then a row-total scan, then x + (r − t)."""
    rows, lanes = x.shape[-2], x.shape[-1]
    k = 1
    while k < lanes:
        sh = torch.zeros_like(x)
        sh[..., k:] = x[..., :lanes - k]
        x = x + sh
        k *= 2
    t = x[..., lanes - 1:]
    r = t
    k = 1
    while k < rows:
        sh = torch.zeros_like(r)
        sh[..., k:, :] = r[..., :rows - k, :]
        r = r + sh
        k *= 2
    return x + (r - t)


def concat_prefix_twin(weights, codes, n_seg: int,
                       max_block_rows: int = 2048):
    """Inclusive prefix over [where(codes == s, weights, 0) for s <
    n_seg] concatenated (codes None: n_seg = 1, no mask), with the JAX
    package's float association: plain cumsum when N % 1024 != 0, else
    the blockwise Hillis-Steele scan with a serial carry in block order."""
    N = weights.shape[0]
    dt = weights.dtype
    if codes is None and n_seg != 1:
        raise ValueError("codes=None needs n_seg == 1")
    zero = torch.zeros((), dtype=dt, device=weights.device)
    segs = [weights if codes is None else torch.where(codes == s, weights, zero)
            for s in range(n_seg)]
    if N % (8 * LANE) != 0:
        return torch.cumsum(torch.cat(segs), 0, dtype=dt)
    R = N // LANE
    blk = _largest_block(R, max_block_rows, 8)
    G = R // blk
    x = torch.stack(segs).reshape(n_seg * G, blk, LANE)
    hs = _hs_prefix_blocks(x)
    outs = []
    carry = torch.zeros((), dtype=dt, device=weights.device)
    for b in range(n_seg * G):
        p = hs[b] + carry
        outs.append(p)
        carry = p[-1, -1]
    return torch.stack(outs).reshape(n_seg * N)


def fused_concat_prefix(weights, codes, n_seg: int,
                        max_block_rows: int = 2048):
    """(n_seg·N,) float32 inclusive prefix (kernel on CUDA:
    kernels/csrc/prefix.cu, bit-identical to the twin)."""
    dev = _same_device([weights] + ([] if codes is None else [codes]))
    if dev.type == "cpu":
        return concat_prefix_twin(weights, codes, n_seg, max_block_rows)
    N = weights.shape[0]
    if N % (8 * LANE) != 0:
        raise ValueError("fused_concat_prefix kernel needs N % 1024 == 0")
    if weights.dtype != torch.float32 or not weights.is_contiguous():
        raise TypeError("fused_concat_prefix kernel takes contiguous f32")
    if codes is None:
        if n_seg != 1:
            raise ValueError("codes=None needs n_seg == 1")
    elif codes.dtype != torch.int32 or not codes.is_contiguous() \
            or codes.shape != weights.shape:
        raise TypeError("fused_concat_prefix kernel takes int32 codes (N,)")
    from ..kernels import build
    R = N // LANE
    blk = _largest_block(R, max_block_rows, 8)
    nb = n_seg * (R // blk)
    out = torch.empty(n_seg * N, dtype=torch.float32, device=dev)
    scratch = torch.empty(n_seg * R + 2 * nb, dtype=torch.float32,
                          device=dev)
    kernels.LAUNCHES["fused_concat_prefix"] += 1
    build.check(build.lib().reina_concat_prefix(
        weights.data_ptr(), None if codes is None else codes.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), N, n_seg, blk,
        build.stream_of(weights)), "fused_concat_prefix")
    return out
