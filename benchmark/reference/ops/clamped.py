"""The benchmark reference's frozen copy of reina_tpu_torch/ops/clamped.py (its plain forms only: every kernel path taken out).

Clamped-counter grants: first-come-first-served beds and ICU units in
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


def sharded_grants(releases, requests, init, offset, shard):
    """The grants of this rank's slab and the global finals in an
    agent-sharded run: ``shard`` (parallel.mesh.AgentShard) gives the
    slab ([shard.lo, shard.lo + n) of shard.n), its number
    (shard.index) and the all-gather of the slabs' folds. ``offset``: an
    int or a 0-d int32 tensor on the streams' device (read by the
    kernels, never by the host). The twins on the CPU, the two entries
    of the kernel on CUDA."""
    folds = slab_folds_twin(releases, requests, offset, shard.lo)
    return grants_twin_sharded(releases, requests, init, offset,
                               shard.lo, shard.all_gather(folds),
                               shard.index)


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
    if shard is not None:
        granted, final = sharded_grants(releases, requests, init, offset,
                                        shard)
    else:
        granted, final = grants_twin(releases, requests, init, offset)
    return tuple(granted), final
