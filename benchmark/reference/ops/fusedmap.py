"""The benchmark reference's frozen copy of reina_tpu_torch/ops/fusedmap.py (its plain forms only: every kernel path taken out).

Fused per-agent passes, masked one-hot sums, 2-D histograms and
blockwise prefix sums (port of reina_tpu/ops/fusedmap.py).

Each op has a hand-written kernel (reina_tpu_torch/kernels) and a plain
PyTorch twin with the same semantics; the wrapper takes the twin only
for tensors on the CPU and launches the kernel for CUDA tensors, raising
on what the kernel does not take:

  * ``fused_concat_prefix``: the blockwise Hillis-Steele prefix with a
    serial carry, bit for bit the JAX package's association;
    ``prefix_count`` also returns its last value as an int32 count,
    written by the kernel, which there may also make the count's tier
    picks (the graph runner's fold site, core/daygraph.py:Fold);
  * ``fused_onehot_sum``: exact integer histograms of masks by code;
  * ``fused_fn_onehot_sum``: the same, with the masks computed inside
    the kernel from raw field streams (one kernel per mask function);
  * ``fused_bihistogram``: an exact weighted 2-D histogram, with an
    optional gate on the first code.

The three histograms run in one launch each on a cached scratch buffer
that the kernel leaves zeroed. An agent-sharded run (parallel/mesh.py)
sums their per-slab results over its ranks, and takes the prefix in its
sharded form (``sharded_concat_prefix``), which keeps the global block
layout and so the one-card association.

``fused_map`` runs one of the day step's four fused bodies: the body
function itself (the twin) on the CPU, its kernel on CUDA
(kernels/fused_bodies.py).
"""
from __future__ import annotations

import functools
import threading
from typing import Callable, Sequence

import torch


LANE = 128
# shared memory a block can hold on sm_90
MAX_BLOCK_SMEM = 232448
# the largest logical block the sharded prefix's entries take (a CTA of
# 256 threads folds a block's last value, 8 rows a thread)
MAX_SHARD_BLOCK = 2048
# kernels/csrc/onehot.cu: its instances (masks a call) and its bins
ONEHOT_MAX_K = 16
ONEHOT_MAX_BINS_BYTES = 48 * 1024


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


_SCRATCH = {}
_SCRATCH_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# fused_map

def fused_map(fn: Callable, arrays: Sequence[torch.Tensor],
              smalls: Sequence = ()):
    """Run the fused body ``fn(*arrays, *smalls)``: the function itself
    for CPU tensors, the kernel of the same name for CUDA ones
    (kernels/fused_bodies.py). Returns a tuple of (N,) tensors."""
    dev = _same_device(arrays)
    out = fn(*arrays, *smalls)
    return out if isinstance(out, tuple) else (out,)


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


def fused_onehot_sum(parts, code_b, n_b: int, events=None) -> torch.Tensor:
    """(K, n_b) float32 one-hot sums of K bool masks: the twin on the CPU;
    on CUDA kernels/csrc/onehot.cu, one launch that reads the masks where
    they lie. The masks and the codes must be contiguous and 16-byte
    aligned, 1 <= K <= ONEHOT_MAX_K, and the K * n_b int32 bins must fit
    48 KB of shared memory. ``events``: as for fused_concat_prefix. Its
    scratch is shared by the calls of one shape on a device (see
    :func:`_scratch`)."""
    dev = _same_device(list(parts) + [code_b])
    return onehot_sum_twin(parts, code_b, n_b)


def fn_onehot_sum_twin(fields, mask_fn, n_masks: int, code_b,
                       n_b: int) -> torch.Tensor:
    """Masks computed from raw fields, then counted (plain PyTorch)."""
    masks = mask_fn(*fields)
    if len(masks) != n_masks:
        raise ValueError(f"mask_fn gave {len(masks)} masks, want {n_masks}")
    return onehot_sum_twin(masks, code_b, n_b)


def fused_fn_onehot_sum(fields, mask_fn, n_masks: int, code_b,
                        n_b: int, events=None) -> torch.Tensor:
    """(n_masks, n_b) float32 one-hot sums of ``mask_fn(*fields)``: the
    twin on the CPU; on CUDA the kernel written for ``mask_fn`` (looked
    up by name), which computes the masks itself in one launch, on
    16-byte aligned streams. ``events``: as for fused_concat_prefix. Its
    scratch is shared by the calls on a device (see :func:`_scratch`)."""
    dev = _same_device(list(fields) + [code_b])
    return fn_onehot_sum_twin(fields, mask_fn, n_masks, code_b, n_b)


# ---------------------------------------------------------------------------
# fused_bihistogram

def bihistogram_twin(code_a, n_a: int, weights, code_b, n_b: int,
                     gate=None) -> torch.Tensor:
    """out[a, b] = sum w·[code_a == a]·[code_b == b], with code_a taken as
    -1 where ``gate`` is given and false; out-of-range codes count
    nowhere. Exact for integer weights (plain PyTorch)."""
    if gate is not None:
        code_a = torch.where(gate, code_a, -1)
    ca, cb = code_a.to(torch.int64), code_b.to(torch.int64)
    ok = (ca >= 0) & (ca < n_a) & (cb >= 0) & (cb < n_b)
    flat = torch.where(ok, ca * n_b + cb, 0)
    out = torch.zeros(n_a * n_b, dtype=torch.float32, device=ca.device)
    out.index_add_(0, flat, torch.where(ok, weights.to(torch.float32), 0.0))
    return out.reshape(n_a, n_b)


def fused_bihistogram(code_a, n_a: int, weights, code_b, n_b: int, *,
                      gate=None, events=None) -> torch.Tensor:
    """(n_a, n_b) float32 weighted 2-D histogram, the JAX package's
    function, plus ``gate``: None, or a bool (N,) that means
    ``where(gate, code_a, -1)`` without a pass of its own (kernel on
    CUDA: kernels/csrc/bihist.cu, one launch). The weights must be
    integers, int32 or float32, as the JAX package's contract states
    (contact counts <= 128): the kernel sums them as int32. The gate,
    or without one code_a, must be 16-byte aligned. ``events``: as for
    fused_concat_prefix. Its scratch is shared by the calls on a device
    (see :func:`_scratch`)."""
    dev = _same_device([code_a, weights, code_b]
                       + ([] if gate is None else [gate]))
    return bihistogram_twin(code_a, n_a, weights, code_b, n_b, gate)


# ---------------------------------------------------------------------------
# fused_concat_prefix

def _hs_scan(x, dim: int):
    """Inclusive Hillis-Steele scan along ``dim``: step k adds the value
    k places before, or +0.0 in front."""
    n = x.shape[dim]
    k = 1
    while k < n:
        sh = torch.zeros_like(x)
        sh.narrow(dim, k, n - k).copy_(x.narrow(dim, 0, n - k))
        x = x + sh
        k *= 2
    return x


def _hs_prefix_blocks(x):
    """Inclusive flat prefix of each (rows, LANE) block of x (..., rows,
    LANE) with the reference's Hillis-Steele association: lane steps,
    then a row-total scan, then x + (r − t)."""
    x = _hs_scan(x, -1)
    t = x[..., -1:]
    return x + (_hs_scan(t, -2) - t)


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
                        max_block_rows: int = 2048, events=None):
    """(n_seg·N,) float32 inclusive prefix (kernel on CUDA:
    kernels/csrc/prefix.cu, bit-identical to the twin, one launch).
    ``events``: None, or 2 recorded CUDA events the kernel records again
    before and after its launch (for timing)."""
    return _prefix(weights, codes, n_seg, max_block_rows, events)[0]


def prefix_count(weights, name=None, given=None, max_block_rows: int = 2048,
                 events=None, site=None):
    """The one-segment prefix of ``weights`` and its last value as a 0-d
    int32, the count of a mask's set positions (the plain step's
    ``cum[-1].to(int32)``); on CUDA the prefix kernel writes it in the
    same launch. ``name``: the count's name, under which the graph
    runner may have set a fold site (``kernels.fold_site``; ``site``
    gives one explicitly): the count then goes into the site's buffer
    and, unless the site is not armed (a warm-up), the launch also makes
    the site's tier picks (on the CPU: the twin, then the picks' twin).
    ``given``: {name: 0-d int32} the other counts those picks read."""
    cum = concat_prefix_twin(weights, None, 1, max_block_rows)
    count = cum[-1].to(torch.int32)
    if site is not None and site.armed:
        site.twin({name: count, **(given or {})})
    return cum, count


def _prefix(weights, codes, n_seg, max_block_rows, events, count=None,
            fold=None):
    dev = _same_device([weights] + ([] if codes is None else [codes]))
    return concat_prefix_twin(weights, codes, n_seg, max_block_rows), None


# ---------------------------------------------------------------------------
# the sharded prefix: one slab of whole rows of the global layout a rank
#
# Slab j of k holds rows [j·Rl, (j+1)·Rl) of the global layout; a logical
# block may straddle slab edges. Each slab sends the others its message,
# (n_seg, M) floats: the row totals of its head and tail rows (those in
# blocks that straddle its edges), then the last value of each of its
# whole blocks (the same scan as the unsharded kernel's, on the same row
# totals). From the gathered messages each slab rebuilds the last value
# of every block, and the row offsets of its own rows: its whole blocks'
# from its own row totals, its straddling blocks' from the gathered
# totals. kernels/csrc/prefix.cu does the same in two launches.

def _lane_scans(weights, codes, n_seg: int):
    """(n_seg, rows, LANE) Hillis-Steele scans of each row's lanes, the
    first phase of _hs_prefix_blocks."""
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    x = torch.stack([weights if codes is None
                     else torch.where(codes == s, weights, zero)
                     for s in range(n_seg)]).reshape(n_seg, -1, LANE)
    return _hs_scan(x, -1)


def _block_scan(t):
    """The row offsets d = r - t and the last value of blocks of row
    totals ``t`` (..., blk): the reference's row-total scan."""
    r = _hs_scan(t, -1)
    return r - t, t[..., -1] + (r[..., -1] - t[..., -1])


def _block_last(t):
    """The last value of ``_block_scan`` of row totals ``t`` (..., blk),
    without the scan, as kernels/csrc/prefix.cu's ``block_last``: the
    scan's last output is a balanced pairwise tree over the rows
    right-aligned in a power-of-two array, zeros in front."""
    blk = t.shape[-1]
    width = 1 << max(blk - 1, 1).bit_length()
    x = torch.cat([torch.zeros(t.shape[:-1] + (width - blk,), dtype=t.dtype,
                               device=t.device), t], -1)
    while x.shape[-1] > 1:
        x = x[..., 1::2] + x[..., 0::2]
    return t[..., -1] + (x[..., 0] - t[..., -1])


@functools.lru_cache(maxsize=None)
def slab_layout(rl: int, blk: int, j: int):
    """(a, h, t, fw, W) of slab j of slabs of ``rl`` rows in blocks of
    ``blk`` rows: its first row a; its h head rows [a, a + h) and t tail
    rows [a + rl - t, a + rl), which lie in blocks that straddle a slab
    edge; its W whole blocks from block fw."""
    a = j * rl
    b = a + rl
    fws, lwe = -(-a // blk) * blk, b // blk * blk
    h = min(fws, b) - a
    t = b - max(lwe, a + h)
    return a, h, t, fws // blk, (lwe - fws) // blk if lwe > fws else 0


@functools.lru_cache(maxsize=None)
def straddling(rl: int, blk: int, k: int):
    """The blocks of a segment that straddle a slab edge, in order."""
    out = []
    for e in range(1, k):
        r = e * rl
        if r % blk and (not out or out[-1] != r // blk):
            out.append(r // blk)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def message_width(rl: int, blk: int, k: int) -> int:
    """M: the floats a segment of every slab's message holds (the widest
    slab's head, tail and whole blocks)."""
    return max(h + t + w for _, h, t, _, w in
               (slab_layout(rl, blk, j) for j in range(k)))


def _shard_shape(n: int, n_global: int, row0: int, max_block_rows: int):
    """(R, rl, blk, k, j) of a slab of n agents from row ``row0`` of
    ``n_global``; raises ValueError where the slabs are not k equal slabs
    of whole rows or N % 1024 != 0."""
    if n_global % (8 * LANE) or n % LANE or n_global % n \
            or row0 % (n // LANE) or not 0 <= row0 * LANE <= n_global - n:
        raise ValueError(f"sharded prefix: a slab of {n} agents from row "
                         f"{row0} of {n_global} (needs N % 1024 == 0 and "
                         "equal slabs of whole rows)")
    R, rl = n_global // LANE, n // LANE
    return R, rl, _largest_block(R, max_block_rows, 8), n_global // n, \
        row0 // rl


def row_totals_twin(weights, codes, n_seg: int, row0: int, n_global: int,
                    max_block_rows: int = 2048) -> torch.Tensor:
    """(n_seg, M) the message of a slab of whole rows from global row
    ``row0`` of ``n_global`` agents: its head's and tail's row totals
    (the last lane of each row's lane scan), then its whole blocks' last
    values, zeros after."""
    R, rl, blk, k, j = _shard_shape(weights.shape[0], n_global, row0,
                                    max_block_rows)
    tot = _lane_scans(weights, codes, n_seg)[..., LANE - 1]
    _, h, t, _, W = slab_layout(rl, blk, j)
    msg = torch.zeros((n_seg, message_width(rl, blk, k)),
                      dtype=weights.dtype, device=weights.device)
    msg[:, :h] = tot[:, :h]
    msg[:, h:h + t] = tot[:, rl - t:]
    if W:
        msg[:, h + t:h + t + W] = _block_last(
            tot[:, h:h + W * blk].reshape(n_seg, W, blk))
    return msg


def concat_prefix_twin_sharded(weights, codes, n_seg: int, row0: int,
                               n_global: int, gathered,
                               max_block_rows: int = 2048):
    """The slab's part of ``concat_prefix_twin`` over the whole axis, as
    (n_seg·n,) (segment s at [s·n, (s+1)·n)), and each segment's last
    prefix value (n_seg,). The slab is rows [row0, row0 + n / LANE) of
    the global layout; ``gathered``: (k, n_seg, M) every slab's
    ``row_totals_twin`` in slab order. The row-offset scans and the carry
    chain from block 0 repeat the one-card association."""
    n = weights.shape[0]
    R, rl, blk, k, j = _shard_shape(n, n_global, row0, max_block_rows)
    G = R // blk
    dev = weights.device
    lay = [slab_layout(rl, blk, q) for q in range(k)]
    scans = _lane_scans(weights, codes, n_seg)
    tot = scans[..., LANE - 1]
    a = lay[j][0]
    d = torch.zeros((n_seg, rl), dtype=weights.dtype, device=dev)
    last = torch.zeros((n_seg, G), dtype=weights.dtype, device=dev)
    for B in range(G):
        r0 = B * blk
        q = r0 // rl
        if (r0 + blk - 1) // rl == q:            # inside slab q
            _, h, t, fw, _ = lay[q]
            last[:, B] = gathered[q, :, h + t + B - fw]
            if q == j:
                d[:, r0 - a:r0 - a + blk] = _block_scan(
                    tot[:, r0 - a:r0 - a + blk])[0]
            continue
        rows = torch.arange(r0, r0 + blk)
        qs = rows // rl
        at = torch.tensor([r - lay[x][0] if r < lay[x][0] + lay[x][1]
                           else lay[x][1] + r - (lay[x][0] + rl - lay[x][2])
                           for r, x in zip(rows.tolist(), qs.tolist())])
        tb = gathered[qs, :, at].T
        last[:, B] = _block_last(tb)
        mine = qs == j
        if mine.any():
            db = _block_scan(tb)[0]
            d[:, (rows[mine] - a).to(dev)] = db[:, mine.to(dev)]
    carries, c = [], torch.zeros((), dtype=weights.dtype, device=dev)
    for h in last.reshape(-1):
        carries.append(c)
        c = h + c
    carry = torch.stack(carries).reshape(n_seg, G)
    row_block = (row0 + torch.arange(rl, device=dev)) // blk
    out = (scans + d[..., None]) + carry[:, row_block][..., None]
    ends = last[:, -1] + carry[:, -1]
    return out.reshape(n_seg * n), ends


def sharded_concat_prefix(weights, codes, n_seg: int, shard,
                          max_block_rows: int = 2048):
    """This rank's slab of ``fused_concat_prefix`` over the whole agent
    axis in an agent-sharded run, (n_seg·n,) with segment s at
    [s·n, (s+1)·n), and each segment's last value (n_seg,): the slab's
    message, their all-gather over the agent group (``shard``,
    parallel.mesh.AgentShard), then the emit. The twins on the CPU, the
    kernel's two entries on CUDA."""
    dev = _same_device([weights] + ([] if codes is None else [codes]))
    row0 = shard.lo // LANE
    msg = row_totals_twin(weights, codes, n_seg, row0, shard.n,
                          max_block_rows)
    return concat_prefix_twin_sharded(
        weights, codes, n_seg, row0, shard.n, shard.all_gather(msg),
        max_block_rows)


def sharded_prefix_count(weights, shard, name=None, given=None,
                         max_block_rows: int = 2048, site=None):
    """``prefix_count`` in an agent-sharded run: this rank's slab of the
    one-segment prefix over the whole agent axis and its last value as a
    0-d int32, the global count, which every rank computes alike; on
    CUDA the emit launch writes it (into the fold site's buffer where the
    graph runner set one for ``name``) and makes the site's tier picks
    after the messages' all-gather, so every rank picks the same
    branches. ``given``, ``site``: as ``prefix_count``'s."""
    row0 = shard.lo // LANE
    msg = row_totals_twin(weights, None, 1, row0, shard.n,
                          max_block_rows)
    cum, ends = concat_prefix_twin_sharded(
        weights, None, 1, row0, shard.n, shard.all_gather(msg),
        max_block_rows)
    count = ends[0].to(torch.int32)
    if site is not None and site.armed:
        site.twin({name: count, **(given or {})})
    return cum, count
