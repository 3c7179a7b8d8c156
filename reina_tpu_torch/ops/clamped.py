"""Clamped-counter grants: first-come-first-served beds and ICU units in
cyclic sweep order (port of reina_tpu/ops/clamped.py).

The sequential automaton b_i = max(b_{i-1} + a_i, m_i) has the closed
form arriving_i = S⁻_i + max(init, max_{j<i}(m_j − S_j)): one cumsum
and one cummax per ledger, with the cyclic sweep [offset, N) then
[0, offset) handled as two masked segments over the original order.

The twin (CPU) evaluates that closed form directly. On CUDA the ledger
kernel (kernels/csrc/ledger.cu) emits the streams U = s_excl + rel and
rm (the running key maxima, saturated at _NEG) for every ledger in one
launch, and :func:`grants_from_streams` turns them into grants and the
final balance. Only (granted, final) are held equal to the twin: the
saturation of rm is the kernel's own.
"""
from __future__ import annotations

import torch

from .. import kernels

_NEG = -(1 << 30)
I32 = torch.int32


def grants_from_streams(U, rm, releases, requests, init, offset: int):
    """Grants and final balances from the kernel's U/rm streams (lists
    of (n,) int32 per ledger); the boundary scalars come back out of
    U/rm by single-element reads."""
    n = releases[0].shape[0]
    idx = torch.arange(n, dtype=I32, device=U[0].device)
    in_a = idx >= offset
    om1 = min(max(offset - 1, 0), n - 1)
    granted, finals = [], []
    for led in range(len(releases)):
        rel = releases[led].to(I32)
        req = requests[led].to(I32)
        Ul, rml = U[led], rm[led]

        def key_at(i):
            return torch.where(req[i] == 1, 0, _NEG) - (Ul[i] - req[i])

        s_tot = Ul[n - 1] - req[n - 1]
        rm_a_end = torch.maximum(rml[n - 1], key_at(n - 1))
        c_off = Ul[offset] - rel[offset]
        rmb_end = (torch.maximum(rml[om1], key_at(om1)) if offset > 0
                   else torch.tensor(_NEG, dtype=I32, device=Ul.device))
        base_a = init[led].to(I32) - c_off
        final_a = s_tot + torch.maximum(base_a, rm_a_end)
        final_b = c_off + torch.maximum(final_a, rmb_end)
        arriving_p = Ul + torch.where(in_a, torch.maximum(base_a, rml),
                                      torch.maximum(final_a, rml))
        granted.append(requests[led] & (arriving_p > 0))
        finals.append(final_b)
    return granted, torch.stack(finals).to(I32)


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


def ledger_streams(releases, requests, offset: int):
    """The ledger kernel: per-ledger U and rm streams for 1 or 2 ledgers
    of (n,) int32 releases and bool requests on one CUDA device."""
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
    from ..kernels import build
    U = [torch.empty(n, dtype=I32, device=dev) for _ in range(L)]
    rm = [torch.empty(n, dtype=I32, device=dev) for _ in range(L)]
    ntiles = (n + 4095) // 4096
    tiles = torch.empty(3 * L * ntiles, dtype=torch.int64, device=dev)
    excl = torch.empty_like(tiles)

    def ptr(lst, i, view=None):
        if i >= L:
            return None
        t = lst[i] if view is None else lst[i].view(view)
        return t.data_ptr()

    kernels.LAUNCHES["ledger_scan"] += 1
    build.check(build.lib().reina_ledger_scan(
        ptr(releases, 0), ptr(releases, 1),
        ptr(requests, 0, torch.uint8), ptr(requests, 1, torch.uint8),
        ptr(U, 0), ptr(U, 1), ptr(rm, 0), ptr(rm, 1),
        tiles.data_ptr(), excl.data_ptr(), n, int(offset), L,
        build.stream_of(releases[0])), "ledger_scan")
    return U, rm


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
        rel = [r.to(I32).contiguous() for r in releases]
        U, rm = ledger_streams(rel, list(requests), offset)
        granted, final = grants_from_streams(U, rm, rel, requests, init,
                                             offset)
    return tuple(granted), final
