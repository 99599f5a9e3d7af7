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

``fill_polygon_soft`` rasterises such a polygon softly (the weak
``segmentation`` loss): the product over edges of clip(s, 0, 1), s the
edge's signed cross product at each pixel, a repeated-vertex edge counting 1.
Its backward keeps only the (P, 2) polygon and recomputes the planes one
edge at a time, so nothing (P, H, W)-sized is kept between the passes (the
JAX package's ``custom_vjp``): the product rule by zero-factor count, and
the clip's gradient 1 inside (0, 1), 0.5 at s = 0 and s = 1 (where
``jnp.clip`` splits its tie, and integer-lattice vertices put s exactly),
0 outside. ``torch.clamp``'s gradient at its bounds is 1, so autograd
through it would differ there.
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


def _edge(polygon: torch.Tensor, e: int, ys: torch.Tensor, xs: torch.Tensor):
    """Edge ``e`` of (N, P, 2) polygons -> (s (N, H, W), clip(s, 0, 1) with a
    repeated-vertex edge set to 1, the repeated-vertex flags (N,))."""
    v1 = polygon[:, e]
    v2 = polygon[:, (e + 1) % polygon.shape[1]]
    edge = v2 - v1
    degen = (edge * edge).sum(-1) < 1e-12
    # s(y, x) = e0 (y - v1y) - e1 (x - v1x), a row term plus a column term
    # whose product is unrounded: XLA fuses it into a multiply-add there
    # (float64 holds the product of two floats exactly)
    ay = edge[:, 0:1] * (ys[None, :] - v1[:, 1:2])  # (N, H)
    dx = (xs[None, :] - v1[:, 0:1]).double()  # (N, W)
    s = ((-edge[:, 1, None, None]).double() * dx[:, None, :] + ay[:, :, None].double()).to(polygon.dtype)
    cl = torch.where(degen[:, None, None], torch.ones_like(s), s.clamp(0.0, 1.0))
    return s, cl, degen


class _FillPolygonSoft(torch.autograd.Function):
    @staticmethod
    def forward(ctx, polygon, height: int, width: int):
        ys = torch.arange(height, dtype=polygon.dtype, device=polygon.device)
        xs = torch.arange(width, dtype=polygon.dtype, device=polygon.device)
        out = None
        for e in range(polygon.shape[1]):
            cl = _edge(polygon, e, ys, xs)[1]
            out = cl if out is None else out * cl
        ctx.save_for_backward(polygon)
        return out

    @staticmethod
    def backward(ctx, g):
        (polygon,) = ctx.saved_tensors
        n, p = polygon.shape[:2]
        height, width = g.shape[1:]
        ys = torch.arange(height, dtype=polygon.dtype, device=polygon.device)
        xs = torch.arange(width, dtype=polygon.dtype, device=polygon.device)
        # the count of zero factors and the product of the others, pixel by pixel
        nz = torch.zeros(g.shape, dtype=torch.int32, device=g.device)
        prod_nz = torch.ones_like(g)
        for e in range(p):
            cl = _edge(polygon, e, ys, xs)[1]
            z = cl == 0.0
            nz += z
            prod_nz = prod_nz * torch.where(z, torch.ones_like(cl), cl)
        s0, sy, sx = (torch.zeros((n, p), dtype=g.dtype, device=g.device) for _ in range(3))
        for e in range(p):
            s, cl, degen = _edge(polygon, e, ys, xs)
            z = cl == 0.0
            # d(prod)/d(cl_e): every factor non-zero -> prod / cl_e; one zero
            # factor, at this edge -> the product of the others; else 0
            part = torch.where(nz == 0, prod_nz / torch.where(z, torch.ones_like(cl), cl),
                               torch.where((nz == 1) & z, prod_nz, torch.zeros_like(cl)))
            inside = (s > 0.0) & (s < 1.0)
            bound = (s == 0.0) | (s == 1.0)
            ind = torch.where(inside, 1.0, torch.where(bound, 0.5, 0.0)) * (~degen)[:, None, None]
            ds = g * part * ind  # the cotangent of s
            s0[:, e] = ds.sum((1, 2))
            sy[:, e] = (ds.sum(2) * ys).sum(1)
            sx[:, e] = (ds.sum(1) * xs).sum(1)
        v1 = polygon
        v2 = torch.roll(polygon, -1, dims=1)
        # s = (v2x - v1x)(y - v1y) - (v2y - v1y)(x - v1x):
        #   ds/dv1x = v2y - y, ds/dv1y = x - v2x, ds/dv2x = y - v1y, ds/dv2y = v1x - x
        dv1 = torch.stack([v2[..., 1] * s0 - sy, sx - v2[..., 0] * s0], dim=-1)
        dv2 = torch.stack([sy - v1[..., 1] * s0, v1[..., 0] * s0 - sx], dim=-1)
        return dv1 + torch.roll(dv2, 1, dims=1), None, None


def fill_polygon_soft(polygon: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(..., P, 2) counter-clockwise convex polygons (x, y) -> (..., H, W)
    soft masks in [0, 1]: the product over edges of clip(s, 0, 1)."""
    lead = polygon.shape[:-2]
    out = _FillPolygonSoft.apply(polygon.reshape(-1, *polygon.shape[-2:]), height, width)
    return out.reshape(*lead, height, width)


def convex_hull_mask(points: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The soft mask (..., H, W) of the convex hull of (..., P, 2) points."""
    return fill_polygon_soft(convex_hull_order(points), height, width)
