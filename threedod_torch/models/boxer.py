"""The ground plane from a depth map (counterpart of the first part of
``threedod/models/boxer.py``, after cubercnn's ROIHeads_Boxer :345-428).

Only what weak Cube R-CNN's ``pose_ground`` losses read is here: the point
cloud of every fifth pixel, a RANSAC plane fitted to its ground pixels, and
the wall-or-floor fix-up of the plane's normal, for a batch of images in one
program. The propose-and-score system (BoxNet) is not ported yet.
"""
from __future__ import annotations

import torch

from ..geometry.plane import Hypotheses, cloud_pixels, fit_plane_ransac, point_cloud_from_depth


def disambiguate_ground_normal(normal: torch.Tensor) -> torch.Tensor:
    """Wall-or-floor fix-ups of (..., 3) normals in camera coordinates (+y
    down): a plane that looks like a back wall (|n.z| largest) is turned 90
    degrees about x, one that looks like a side wall (|n.x| largest) 90
    degrees about y; then the normal is flipped so that n.y >= 0."""
    nx, ny, nz = normal.unbind(-1)
    n1 = torch.where((nz.abs() > ny.abs())[..., None], torch.stack([nx, nz, -ny], -1), normal)
    nx, ny, nz = n1.unbind(-1)
    n2 = torch.where((nx.abs() > ny.abs())[..., None], torch.stack([-nz, nx, ny], -1), n1)
    return torch.where(n2[..., 1:2] < 0, -n2, n2)


def ground_plane_from_depth(hypotheses: Hypotheses, depth_maps: torch.Tensor, K_scaled: torch.Tensor,
                            ground_maps: torch.Tensor | None = None, valid_hw: torch.Tensor | None = None):
    """Ground normals of B images: (B, H, W) depth, (B, 3, 3) intrinsics at
    network resolution, (B, H, W) ground maps (> 0 on the ground) or None,
    (B, 2) valid extents or None. ``hypotheses``: a generator, or (B,
    RANSAC_HYPOTHESES, 3) point indices.

    The plane is fitted to the points inside the image with positive depth,
    and on the ground where there is a ground map. Returns (normal (B, 3),
    points (B, M, 3), no_ground (B, M)): the points off the ground (all of
    them without a ground map) inside the image with positive depth."""
    h, w = depth_maps.shape[-2:]
    ys, xs = cloud_pixels(h, w, depth_maps.device)
    points = point_cloud_from_depth(depth_maps, K_scaled)  # (B, M, 3)

    b = depth_maps.shape[0]
    in_image = torch.ones_like(points[..., 0], dtype=torch.bool)
    if valid_hw is not None:
        in_image = ((ys[None, :, None] < valid_hw[:, 0, None, None])
                    & (xs[None, None, :] < valid_hw[:, 1, None, None])).reshape(b, -1)
    pos_depth = points[..., 2] > 1e-6
    if ground_maps is not None:
        g = ground_maps[:, ys[:, None], xs[None, :]].flatten(1) > 0
        fit_mask = g & in_image & pos_depth
        no_ground = ~g & in_image & pos_depth
    else:
        fit_mask = no_ground = in_image & pos_depth
    eq, _ = fit_plane_ransac(points, hypotheses, valid_mask=fit_mask)
    return disambiguate_ground_normal(eq[:, :3]), points, no_ground
