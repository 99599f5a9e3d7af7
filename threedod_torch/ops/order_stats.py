"""Rank selection (counterpart of ``threedod/ops/order_stats.py``).

The JAX package finds the take-th largest masked value by a 32-pass radix
bisection, a form chosen for the TPU where a sort is costly. The plain form
here sorts once and thresholds on the same order statistic, which selects
the same set, ties at the threshold included.
"""
from __future__ import annotations

import torch


def top_take_mask(values: torch.Tensor, mask: torch.Tensor, take: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the ``take`` largest masked values.

    values (..., K) f32, mask (..., K) bool, take (...,) int (clipped to the
    masked count). Every masked value >= the take-th largest is selected, so
    values tied with the threshold are all taken."""
    big = torch.finfo(torch.float32).max
    keys = torch.where(mask, values.float(), torch.full_like(values, big, dtype=torch.float32))
    n = mask.sum(-1)
    take = torch.minimum(take, n)
    # take-th largest of the masked entries == (n - take)-th smallest (0-based)
    idx = (n - take).clamp(0, values.shape[-1] - 1)
    t = torch.gather(torch.sort(keys, dim=-1).values, -1, idx[..., None])
    return mask & (values >= t) & (take > 0)[..., None]
