"""Clamped-counter grants: first-come-first-served beds and ICU units in
cyclic sweep order (port of reina_tpu/ops/clamped.py).

The sequential automaton b_i = max(b_{i-1} + a_i, m_i) has the closed
form arriving_i = S⁻_i + max(init, max_{j<i}(m_j − S_j)): one cumsum
and one cummax per ledger, with the cyclic sweep [offset, N) then
[0, offset) handled as two masked segments over the original order.

The twin (CPU) evaluates that closed form directly. On CUDA the ledger
kernel (kernels/csrc/ledger.cu) computes the same grants and final
balances of both ledgers in int64 in three launches: a fold of each
tile of 4096 agents, a scan of the tile folds that also yields the
closed form's boundary scalars, and a rescan of each tile that writes
the grants.
"""
from __future__ import annotations

import torch

from .. import kernels

_NEG = -(1 << 30)
I32 = torch.int32


def grants_twin(releases, requests, init, offset: int):
    """The closed form, per ledger: 1 cumsum + 2 cummax."""
    n = releases[0].shape[0]
    dev = releases[0].device
    in_a = torch.arange(n, dtype=I32, device=dev) >= offset
    neg1 = torch.full((1,), _NEG, dtype=I32, device=dev)
    granted, finals = [], []
    for led in range(len(releases)):
        rel = releases[led].to(I32)
        req = requests[led]
        a = rel - req.to(I32)
        m = torch.where(req, 0, _NEG).to(I32)
        s_incl = torch.cumsum(a, 0, dtype=I32)
        s_excl = s_incl - a
        c_off = s_excl[offset]
        key = m - s_incl
        key_a = torch.where(in_a, key, _NEG)
        rm_a = torch.cummax(key_a, 0).values
        rm_f = torch.cummax(key, 0).values
        rm_a_excl = torch.cat([neg1, rm_a[:-1]])
        rm_f_excl = torch.cat([neg1, rm_f[:-1]])
        base_a = init[led].to(I32) - c_off
        final_a = s_incl[-1] + torch.maximum(base_a, rm_a[-1])
        arriving_a = s_excl + torch.maximum(base_a, rm_a_excl)
        arriving_b = s_excl + torch.maximum(final_a, rm_f_excl)
        final_b = c_off + torch.maximum(final_a, rm_f_excl[offset])
        arriving = torch.where(in_a, arriving_a, arriving_b)
        granted.append(req & ((arriving + rel) > 0))
        finals.append(final_b)
    return granted, torch.stack(finals)


def ledger_grants(releases, requests, init, offset: int, events=None):
    """The ledger kernel (kernels/csrc/ledger.cu): grants and final
    balances of 1 or 2 ledgers of (n,) int32 releases and bool requests
    on one CUDA device, in three launches and no other op. ``events``:
    None, or 4 recorded CUDA events the kernel records again before its
    first launch and after each one (for timing)."""
    L = len(releases)
    if not 1 <= L <= 2 or len(requests) != L:
        raise ValueError("ledger kernel takes 1 or 2 ledgers")
    n = releases[0].shape[0]
    dev = releases[0].device
    for r, q in zip(releases, requests):
        if r.device != dev or q.device != dev or not r.is_cuda:
            raise ValueError("ledger kernel: tensors on one CUDA device")
        if r.dtype != I32 or q.dtype != torch.bool:
            raise TypeError("ledger kernel takes int32 releases, bool requests")
        if r.shape != (n,) or q.shape != (n,) or not (
                r.is_contiguous() and q.is_contiguous()):
            raise ValueError("ledger kernel takes contiguous (n,) streams")
        if r.data_ptr() % 16 or q.data_ptr() % 16:
            raise ValueError("ledger kernel takes 16-byte aligned streams")
    if init.device != dev or init.dtype != I32 or init.shape != (L,) \
            or not init.is_contiguous():
        raise TypeError("ledger kernel takes (L,) contiguous int32 init on "
                        "the streams' device")
    if not 0 <= offset < n:
        raise ValueError(f"ledger kernel: offset {offset} outside [0, {n})")
    from ..kernels import build
    req = [q.view(torch.uint8) for q in requests]
    granted = [torch.empty(n, dtype=torch.bool, device=dev)
               for _ in range(L)]
    final = torch.empty(L, dtype=I32, device=dev)
    ntiles = (n + 4095) // 4096
    # tile folds, their exclusive scan, the fold of offset's tile before
    # offset (3 int64 each), the boundary scalars (2 per ledger)
    scratch = torch.empty(6 * L * ntiles + 5 * L, dtype=torch.int64,
                          device=dev)

    def ptr(lst, i):
        return lst[i].data_ptr() if i < L else None

    kernels.LAUNCHES["ledger_scan"] += 1
    build.check(build.lib().reina_ledger_grants(
        ptr(releases, 0), ptr(releases, 1), ptr(req, 0), ptr(req, 1),
        ptr(granted, 0), ptr(granted, 1), init.data_ptr(), final.data_ptr(),
        scratch.data_ptr(), n, int(offset), L, build.event_handles(events),
        build.stream_of(releases[0])), "ledger_scan")
    return granted, final


def clamped_counter_grants(releases, requests, init, offset: int):
    """Grant/deny requests against clamped counters in cyclic order.

    releases: list of L (N,) int32 units returned per position;
    requests: list of L (N,) bool; init: (L,) int32 counter values at
    sweep start; offset: host int, the sweep's first position.
    Returns (tuple of L (N,) bool grants, (L,) int32 final balances).
    """
    dev = releases[0].device
    if dev.type == "cpu":
        granted, final = grants_twin(releases, requests, init, offset)
    else:
        granted, final = ledger_grants(
            [r.to(I32).contiguous() for r in releases], list(requests),
            init.to(I32).contiguous(), offset)
    return tuple(granted), final
