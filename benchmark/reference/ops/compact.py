"""The benchmark reference's frozen copy of reina_tpu_torch/ops/compact.py (its plain forms only: every kernel path taken out).

Stream compaction into a fixed-capacity buffer (port of
reina_tpu/ops/compact.py): the s-th set position of a mask is the first
index where its inclusive prefix count reaches s + 1; and the maximum
of a count's values. Each count may carry the day graph's tier picks
that read it (the graph runner's fold site, core/daygraph.py:Fold)."""
from __future__ import annotations

import torch

from .fusedmap import prefix_count

I32 = torch.int32


def compact_indices(mask, capacity: int, name=None, given=None):
    """Pack the indices of set positions of ``mask`` (N,) bool.

    Returns (buf, count): buf (capacity,) int32 holds the first
    ``capacity`` set indices in ascending order and the sentinel N in
    unused slots; count is the 0-d int32 number of set positions (it
    may exceed capacity; callers flag the overflow). The JAX package
    fills the slots beyond its head tier only when the count reaches
    them; the slots are the same either way. ``name``, ``given``: the
    count's fold site and the other counts its picks read
    (fusedmap.prefix_count)."""
    n = mask.shape[0]
    cum, count = prefix_count(mask.to(torch.float32), name, given)
    slots = torch.arange(capacity, dtype=I32, device=mask.device)
    buf = torch.searchsorted(cum, (slots + 1).to(torch.float32)).to(I32)
    used = slots < torch.clamp_max(count, capacity)
    return torch.where(used, buf, n), count


def count_max(x, name=None, site=None):
    """``x.max()`` (0-d) of a count's values (n,) int32. Where the graph
    runner set a fold site for ``name`` (or ``site`` is given), the
    reduce-and-pick that also makes the site's tier picks: on CUDA one
    launch of kernels/csrc/daygraph.cu's max_pick, which writes the
    maximum into the site's buffer and then, unless the site is not
    armed, picks; on the CPU the maximum, then the picks' twin."""
    if site is None:
        return x.max()
    m = x.max()
    if site.armed:
        site.twin({name: m})
    return m
