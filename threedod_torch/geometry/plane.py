"""RANSAC plane fitting (counterpart of ``threedod/geometry/plane.py``, after
ProposalNetwork/utils/plane.py ``Plane.fit_parallel``).

Every hypothesis is scored at once: three points a hypothesis, the plane
through them, the distance of every point to every plane, the inlier count,
and the first hypothesis with the most inliers. Leading batch dimensions are
free, so B images are one program of B x hypotheses x points distances.

The hypotheses are (..., RANSAC_HYPOTHESES, 3) point indices, drawn from a
``torch.Generator`` with ``torch.randint`` on the generator's device, or
given (the tests pass the indices ``jax.random.randint`` drew).

Distances are sums of products written out, so they are f32 on every device
whatever the TF32 switches say: inliers are counted at a few centimetres,
where a TF32 product could flip a count.
"""
from __future__ import annotations

from typing import Union

import torch

Hypotheses = Union[torch.Generator, torch.Tensor]

RANSAC_HYPOTHESES = 1000  # three-point samples a fit
INLIER_THRESH = 0.05  # metres from the plane that count as an inlier
CLOUD_STRIDE = 5  # the point cloud takes every fifth pixel of each row and column


def fit_plane_ransac(points: torch.Tensor, hypotheses: Hypotheses, valid_mask: torch.Tensor | None = None):
    """Fit a plane to (..., N, 3) points.

    ``valid_mask`` (..., N) marks the points that may count as inliers.
    Returns (eq (..., 4), inlier_frac (...,)): the plane [a, b, c, d] with a
    unit normal, a x + b y + c z + d = 0, and the share of the valid points
    within ``INLIER_THRESH`` of it. A collinear sample gets no votes; ties go to the
    first hypothesis."""
    n = points.shape[-2]
    batch = points.shape[:-2]
    if valid_mask is None:
        valid_mask = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    if isinstance(hypotheses, torch.Generator):
        hypotheses = torch.randint(0, n, (*batch, RANSAC_HYPOTHESES, 3), generator=hypotheses, device=hypotheses.device)
    idx = hypotheses.to(device=points.device, dtype=torch.int64)  # (..., H, 3)
    tri = torch.take_along_dim(points, idx.reshape(*batch, -1, 1), dim=-2).reshape(*idx.shape, 3)  # (..., H, 3, 3)
    vec_a = tri[..., 1, :] - tri[..., 0, :]
    vec_b = tri[..., 2, :] - tri[..., 0, :]
    normal = torch.linalg.cross(vec_a, vec_b, dim=-1)
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    normal = normal / norm.clamp(min=1e-12)
    k = -(normal * tri[..., 0, :]).sum(-1)  # (..., H)

    px, py, pz = (points[..., None, :, i] for i in range(3))  # (..., 1, N)
    nx, ny, nz = (normal[..., i, None] for i in range(3))  # (..., H, 1)
    dist = (px * nx + py * ny + pz * nz + k[..., None]).abs()  # (..., H, N)
    counts = ((dist <= INLIER_THRESH) & valid_mask[..., None, :]).sum(-1)
    counts = torch.where(norm[..., 0] < 1e-9, torch.zeros_like(counts), counts)

    best = torch.argmax(counts, dim=-1, keepdim=True)  # the first of the largest
    eq = torch.cat([torch.gather(normal, -2, best[..., None].expand(*best.shape, 3))[..., 0, :],
                    torch.gather(k, -1, best)], dim=-1)
    frac = torch.gather(counts, -1, best)[..., 0] / valid_mask.sum(-1).clamp(min=1)
    return eq, frac


def point_cloud_from_depth(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., H, W) depth and (..., 3, 3) intrinsics -> (..., H//CLOUD_STRIDE *
    W//CLOUD_STRIDE, 3) camera points of every ``CLOUD_STRIDE``-th pixel."""
    h, w = depth.shape[-2:]
    ys, xs = cloud_pixels(h, w, depth.device)
    z = depth[..., ys[:, None], xs[None, :]]
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    x3 = z * (xs.to(depth.dtype) - cx) / fx
    y3 = z * (ys[:, None].to(depth.dtype) - cy) / fy
    return torch.stack([x3.flatten(-2), y3.flatten(-2), z.flatten(-2)], dim=-1)


def cloud_pixels(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows and columns ``point_cloud_from_depth`` samples in an H x W map."""
    return (torch.arange(0, h - (h % CLOUD_STRIDE), CLOUD_STRIDE, device=device),
            torch.arange(0, w - (w % CLOUD_STRIDE), CLOUD_STRIDE, device=device))
