"""Stream compaction into a fixed-capacity buffer (port of
reina_tpu/ops/compact.py): the s-th set position of a mask is the first
index where its inclusive prefix count reaches s + 1."""
from __future__ import annotations

import torch

from .fusedmap import fused_concat_prefix

I32 = torch.int32


def compact_indices(mask, capacity: int):
    """Pack the indices of set positions of ``mask`` (N,) bool.

    Returns (buf, count): buf (capacity,) int32 holds the first
    ``capacity`` set indices in ascending order and the sentinel N in
    unused slots; count is the 0-d int32 number of set positions (it
    may exceed capacity; callers flag the overflow). The JAX package
    fills the slots beyond its head tier only when the count reaches
    them; the slots are the same either way."""
    n = mask.shape[0]
    cum = fused_concat_prefix(mask.to(torch.float32), None, 1)
    count = cum[-1].to(I32)
    slots = torch.arange(capacity, dtype=I32, device=mask.device)
    buf = torch.searchsorted(cum, (slots + 1).to(torch.float32)).to(I32)
    used = slots < torch.clamp_max(count, capacity)
    return torch.where(used, buf, n), count
