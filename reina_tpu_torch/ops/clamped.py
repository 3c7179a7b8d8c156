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

An agent-sharded run (parallel/mesh.py) splits the sweep into contiguous
slabs, one a rank, as the JAX package's ``_grants_sharded`` does: each
slab folds its positions (the cyclic mask at the global position), the
slabs' folds are all-gathered, and each slab emits its grants from the
folds of the slabs before it; the global boundary scalars come from all
of them. ``grants_twin_sharded`` is that closed form per slab, and
``kernels/csrc/ledger.cu`` has it as a fold entry and an emit entry,
one launch each.
Every form takes the sweep's offset as a host int or as a 0-d int32
tensor on the streams' device, which the kernels read when they run: a
captured day's offset comes from its day row.
"""
from __future__ import annotations

import torch

from .. import kernels
from .fusedmap import _scratch

_NEG = -(1 << 30)
I32 = torch.int32


def grants_twin(releases, requests, init, offset):
    """The closed form, per ledger: 1 cumsum + 2 cummax. ``offset``: an
    int or a 0-d integer tensor."""
    n = releases[0].shape[0]
    dev = releases[0].device
    if isinstance(offset, torch.Tensor):
        offset = offset.to(torch.int64)
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


# the sharded form: a slab's folds are, per ledger, (s, ka, kf) of the
# whole slab and of its positions before offset, in int64 relative to
# the slab's start; the monoid of ledger.cu:
#   (s1, ka1, kf1) + (s2, ka2, kf2) = (s1 + s2, max(ka1, ka2 - s1),
#                                      max(kf1, kf2 - s1))
NEG_INF = -(1 << 62)
I64 = torch.int64


def _combine(x, y):
    return torch.stack([x[0] + y[0], torch.maximum(x[1], y[1] - x[0]),
                        torch.maximum(x[2], y[2] - x[0])])


def _slab_terms(rel, req, offset, base: int):
    """Per position of a slab: a, the key relative to the slab's start,
    and whether the position is in the sweep's first segment (``offset``:
    an int or a 0-d tensor)."""
    n = rel.shape[0]
    a = rel.to(I64) - req.to(I64)
    s_incl = torch.cumsum(a, 0)
    key = torch.where(req, 0, _NEG).to(I64) - s_incl
    in_a = torch.arange(base, base + n, dtype=I64, device=rel.device) >= offset
    return a, s_incl, key, in_a


def slab_folds_twin(releases, requests, offset, base: int):
    """(L, 2, 3) int64: per ledger, the fold of the slab and the fold of
    its positions before ``offset`` (the slab starts at global position
    ``base``; ``offset`` an int or a 0-d integer tensor)."""
    neg_inf = torch.tensor(NEG_INF, dtype=I64, device=releases[0].device)
    out = []
    for rel, req in zip(releases, requests):
        a, s_incl, key, in_a = _slab_terms(rel, req, offset, base)
        total = torch.stack([s_incl[-1],
                             torch.where(in_a, key, NEG_INF).max(),
                             key.max()])
        pre = ~in_a
        before = torch.stack([torch.where(pre, a, 0).sum(), neg_inf,
                              torch.where(pre, key, NEG_INF).max()])
        out.append(torch.stack([total, before]))
    return torch.stack(out)


def grants_twin_sharded(releases, requests, init, offset, base: int,
                        all_folds, index: int):
    """The closed form over one slab plus a carry: the slab's grants and
    the global finals, from every slab's ``slab_folds_twin`` in slab
    order (``all_folds``: (k, L, 2, 3) int64); this slab is number
    ``index`` and starts at global position ``base``. Equals the slab's
    part of ``grants_twin`` over the whole axis."""
    granted, finals = [], []
    ident = torch.tensor([0, NEG_INF, NEG_INF], dtype=I64,
                         device=all_folds.device)
    for led, (rel, req) in enumerate(zip(releases, requests)):
        carry, total, at_off = ident, ident, ident
        for j in range(all_folds.shape[0]):
            if j == index:
                carry = total
            total = _combine(total, all_folds[j, led, 0])
            at_off = _combine(at_off, all_folds[j, led, 1])
        c_off = at_off[0]
        base_a = init[led].to(I64) - c_off
        final_a = total[0] + torch.maximum(base_a, total[1])
        finals.append(c_off + torch.maximum(final_a, at_off[2]))
        a, s_incl, key, in_a = _slab_terms(rel, req, offset, base)
        neg = torch.full((1,), NEG_INF, dtype=I64, device=rel.device)
        ka_ex = torch.cat([neg, torch.cummax(
            torch.where(in_a, key, NEG_INF), 0).values[:-1]])
        kf_ex = torch.cat([neg, torch.cummax(key, 0).values[:-1]])
        cur_s = carry[0] + (s_incl - a)
        cur_ka = torch.maximum(carry[1], ka_ex - carry[0])
        cur_kf = torch.maximum(carry[2], kf_ex - carry[0])
        m = torch.where(in_a, torch.maximum(base_a, cur_ka),
                        torch.maximum(final_a, cur_kf))
        granted.append(req & (cur_s + rel.to(I64) + m > 0))
    return granted, torch.stack(finals).to(I32)


def _check_streams(releases, requests, what: str):
    L = len(releases)
    if not 1 <= L <= 2 or len(requests) != L:
        raise ValueError(f"{what} takes 1 or 2 ledgers")
    n = releases[0].shape[0]
    dev = releases[0].device
    for r, q in zip(releases, requests):
        if r.device != dev or q.device != dev or not r.is_cuda:
            raise ValueError(f"{what}: tensors on one CUDA device")
        if r.dtype != I32 or q.dtype != torch.bool:
            raise TypeError(f"{what} takes int32 releases, bool requests")
        if r.shape != (n,) or q.shape != (n,) or not (
                r.is_contiguous() and q.is_contiguous()):
            raise ValueError(f"{what} takes contiguous (n,) streams")
        if r.data_ptr() % 16 or q.data_ptr() % 16:
            raise ValueError(f"{what} takes 16-byte aligned streams")
    return L, n, dev


def _offset_arg(offset, dev, n: int, what: str):
    """(host offset, device pointer or None) of an int in [0, n) or a 0-d
    int32 tensor on ``dev`` (whose value is the caller's to keep in
    range)."""
    if isinstance(offset, torch.Tensor):
        if offset.device != dev or offset.dtype != I32 or offset.dim():
            raise TypeError(f"{what} takes a 0-d int32 offset on the "
                            "streams' device")
        return 0, offset.data_ptr()
    if not 0 <= offset < n:
        raise ValueError(f"{what}: offset {offset} outside [0, {n})")
    return int(offset), None


def ledger_fold_slab(releases, requests, offset, base: int,
                     n_global: int, events=None):
    """The sharded ledger's fold entry (kernels/csrc/ledger.cu, one
    launch: the tile folds, and the slab scan in the CTA that finishes
    last, whose tickets are a scratch that every launch leaves zeroed,
    ``fusedmap._scratch``) on a slab of (n,) int32 releases and bool
    requests whose first position is ``base`` of ``n_global``: returns
    the slab's folds, (L, 2, 3) int64 as ``slab_folds_twin``'s, and the
    scratch that ``ledger_emit_slab`` takes. ``offset``: the sweep's
    global offset, an int or a 0-d int32 tensor on the streams' device
    that the launch reads when it runs. ``events``: None, or 2 recorded
    CUDA events, recorded again before and after the launch."""
    L, n, dev = _check_streams(releases, requests, "ledger fold entry")
    if not 0 <= base <= n_global - n:
        raise ValueError(f"ledger fold entry: slab [{base}, {base + n}) "
                         f"outside [0, {n_global})")
    offset, off_dev = _offset_arg(offset, dev, n_global, "ledger fold entry")
    from ..kernels import build
    req = [q.view(torch.uint8) for q in requests]
    ntiles = (n + 4095) // 4096
    # tile folds, their exclusive scan, the fold of offset's tile before
    # offset (3 int64 each); the tickets, which every launch leaves zeroed
    scratch = torch.empty(6 * L * ntiles + 3 * L, dtype=I64, device=dev)
    tick = _scratch(dev, "ledger_sharded.fold", L)
    folds = torch.empty((L, 2, 3), dtype=I64, device=dev)

    def ptr(lst, i):
        return lst[i].data_ptr() if i < L else None

    kernels.launched("ledger_sharded.fold")
    build.check(build.lib().reina_ledger_fold_slab(
        ptr(releases, 0), ptr(releases, 1), ptr(req, 0), ptr(req, 1),
        scratch.data_ptr(), tick.data_ptr(), folds.data_ptr(), n, int(base),
        offset, off_dev, L, build.event_handles(events),
        build.stream_of(releases[0])), "ledger_sharded.fold")
    return folds, scratch


def ledger_emit_slab(releases, requests, init, offset, base: int,
                     all_folds, index: int, scratch, events=None):
    """The sharded ledger's emit entry (one launch): the slab's grants
    and the global (L,) int32 finals from every slab's folds
    (``all_folds``: (k, L, 2, 3) int64 on the streams' device, in slab
    order; this slab is number ``index``) and the scratch of its fold
    entry. ``offset``: as the fold entry's. ``events``: None, or 2
    recorded CUDA events."""
    L, n, dev = _check_streams(releases, requests, "ledger emit entry")
    k = all_folds.shape[0]
    if all_folds.device != dev or all_folds.dtype != I64 \
            or all_folds.shape != (k, L, 2, 3) \
            or not all_folds.is_contiguous():
        raise TypeError(f"ledger emit entry takes contiguous (k, {L}, 2, 3) "
                        "int64 folds on the streams' device")
    if not 0 <= index < k:
        raise ValueError(f"ledger emit entry: slab {index} of {k}")
    ntiles = (n + 4095) // 4096
    if scratch.device != dev or scratch.dtype != I64 \
            or scratch.shape != (6 * L * ntiles + 3 * L,):
        raise TypeError("ledger emit entry takes the scratch of its slab's "
                        "fold entry")
    if init.device != dev or init.dtype != I32 or init.shape != (L,) \
            or not init.is_contiguous():
        raise TypeError("ledger emit entry takes (L,) contiguous int32 init "
                        "on the streams' device")
    offset, off_dev = _offset_arg(offset, dev, n * k, "ledger emit entry")
    from ..kernels import build
    req = [q.view(torch.uint8) for q in requests]
    granted = [torch.empty(n, dtype=torch.bool, device=dev)
               for _ in range(L)]
    final = torch.empty(L, dtype=I32, device=dev)

    def ptr(lst, i):
        return lst[i].data_ptr() if i < L else None

    kernels.launched("ledger_sharded.emit")
    build.check(build.lib().reina_ledger_emit_slab(
        ptr(releases, 0), ptr(releases, 1), ptr(req, 0), ptr(req, 1),
        ptr(granted, 0), ptr(granted, 1), init.data_ptr(), final.data_ptr(),
        scratch.data_ptr(), all_folds.data_ptr(), n, int(base), offset,
        off_dev, L, k, int(index), build.event_handles(events),
        build.stream_of(releases[0])), "ledger_sharded.emit")
    return granted, final


def sharded_grants(releases, requests, init, offset, shard):
    """The grants of this rank's slab and the global finals in an
    agent-sharded run: ``shard`` (parallel.mesh.AgentShard) gives the
    slab ([shard.lo, shard.lo + n) of shard.n), its number
    (shard.index) and the all-gather of the slabs' folds. ``offset``: an
    int or a 0-d int32 tensor on the streams' device (read by the
    kernels, never by the host). The twins on the CPU, the two entries
    of the kernel on CUDA."""
    if releases[0].device.type == "cpu":
        folds = slab_folds_twin(releases, requests, offset, shard.lo)
        return grants_twin_sharded(releases, requests, init, offset,
                                   shard.lo, shard.all_gather(folds),
                                   shard.index)
    rel = [r.to(I32).contiguous() for r in releases]
    init = init.to(I32).contiguous()
    folds, scratch = ledger_fold_slab(rel, list(requests), offset, shard.lo,
                                      shard.n)
    return ledger_emit_slab(rel, list(requests), init, offset, shard.lo,
                            shard.all_gather(folds), shard.index, scratch)


def ledger_grants(releases, requests, init, offset, events=None):
    """The ledger kernel (kernels/csrc/ledger.cu): grants and final
    balances of 1 or 2 ledgers of (n,) int32 releases and bool requests
    on one CUDA device, in three launches and no other op. ``offset``: an
    int in [0, n), or a 0-d int32 tensor on the streams' device that the
    kernel reads when it runs (its value is the caller's to keep in
    range: a captured day step's comes from its day row). ``events``:
    None, or 4 recorded CUDA events the kernel records again before its
    first launch and after each one (for timing)."""
    L, n, dev = _check_streams(releases, requests, "ledger kernel")
    if init.device != dev or init.dtype != I32 or init.shape != (L,) \
            or not init.is_contiguous():
        raise TypeError("ledger kernel takes (L,) contiguous int32 init on "
                        "the streams' device")
    offset, off_dev = _offset_arg(offset, dev, n, "ledger kernel")
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

    kernels.launched("ledger_scan")
    build.check(build.lib().reina_ledger_grants(
        ptr(releases, 0), ptr(releases, 1), ptr(req, 0), ptr(req, 1),
        ptr(granted, 0), ptr(granted, 1), init.data_ptr(), final.data_ptr(),
        scratch.data_ptr(), n, int(offset), off_dev, L,
        build.event_handles(events), build.stream_of(releases[0])),
        "ledger_scan")
    return granted, final


def clamped_counter_grants(releases, requests, init, offset,
                           shard=None):
    """Grant/deny requests against clamped counters in cyclic order.

    releases: list of L (N,) int32 units returned per position;
    requests: list of L (N,) bool; init: (L,) int32 counter values at
    sweep start; offset: the sweep's first position, a host int or a 0-d
    int32 tensor on the streams' device.
    Returns (tuple of L (N,) bool grants, (L,) int32 final balances).
    With ``shard`` (an agent-sharded run) the streams are this rank's
    slab and the grants its slab's (:func:`sharded_grants`).
    """
    dev = releases[0].device
    if shard is not None:
        granted, final = sharded_grants(releases, requests, init, offset,
                                        shard)
    elif dev.type == "cpu":
        granted, final = grants_twin(releases, requests, init, offset)
    else:
        granted, final = ledger_grants(
            [r.to(I32).contiguous() for r in releases], list(requests),
            init.to(I32).contiguous(), offset)
    return tuple(granted), final
