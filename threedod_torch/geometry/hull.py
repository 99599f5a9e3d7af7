"""Convex hull order of a few 2D points (counterpart of
``convex_hull_order`` in ``threedod/geometry/hull.py``, after
ProposalNetwork/utils/utils.py's Jarvis march).

The hull of a fixed number of points (the 8 projected corners of a cube) is
found without a data-dependent walk: the points are sorted by angle about
their centroid (a stable sort, as ``jnp.argsort``), then P passes snap every
point that makes a right turn onto its predecessor. The turn test is
dx1 dy2 - dy1 dx2 with the first product unrounded (a fused multiply-add,
which is how XLA computes it): once a point and its neighbour coincide, the
plain difference is exactly 0, while the fused one keeps the second
product's rounding, and the passes go on to snap interior points the plain
form leaves on the hull. The fused form is computed in float64, where the
product of two floats is exact. Leading batch
dimensions are free, so every proposal of every instance is one program.
The soft polygon fill of the JAX module is not here: only the weak
segmentation loss needs it.
"""
from __future__ import annotations

import torch


def convex_hull_order(points: torch.Tensor) -> torch.Tensor:
    """(..., P, 2) points -> (..., P, 2): the hull's vertices in
    counter-clockwise order, each interior point replaced by its nearest kept
    predecessor (a repeated vertex gives an empty edge)."""
    p = points.shape[-2]
    centroid = points.mean(-2, keepdim=True)
    ang = torch.atan2(points[..., 1] - centroid[..., 1], points[..., 0] - centroid[..., 0])
    order = torch.argsort(ang, dim=-1, stable=True)
    cur = torch.gather(points, -2, order[..., None].expand(*order.shape, 2))
    for _ in range(p):
        prev = torch.roll(cur, 1, dims=-2)
        nxt = torch.roll(cur, -1, dims=-2)
        d1, d2 = cur - prev, nxt - prev
        cross = (d1[..., 0].double() * d2[..., 1].double() - (d1[..., 1] * d2[..., 0]).double()).float()
        cur = torch.where((cross < -1e-9)[..., None], prev, cur)
    return cur
