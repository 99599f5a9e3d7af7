"""Cuboid geometry (counterpart of
``threedod/geometry/cuboids.py``)."""
from __future__ import annotations

import functools

import torch

MIN_Z = 1e-6  # the least depth a projection divides by

# Corner sign pattern (8, 3), same vertex order as the JAX package.
_VERT_SIGNS = (
    (-1, -1, -1),
    (+1, -1, -1),
    (+1, +1, -1),
    (-1, +1, -1),
    (-1, -1, +1),
    (+1, -1, +1),
    (+1, +1, +1),
    (-1, +1, +1),
)


@functools.lru_cache(maxsize=None)
def _signs(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The sign pattern on ``device``, copied there once (a copy from the
    host waits for the card); made outside inference mode, so that training
    can use it after an evaluation made it."""
    with torch.inference_mode(False):
        return torch.tensor(_VERT_SIGNS, dtype=dtype, device=device)


def cuboid_verts(box3d: torch.Tensor, R: torch.Tensor | None = None) -> torch.Tensor:
    """box3d (..., 6) = [x, y, z, w, h, l], R (..., 3, 3) -> verts (..., 8, 3).

    Local extents: X <- l, Y <- h, Z <- w.
    """
    center = box3d[..., :3]
    half = torch.stack([box3d[..., 5], box3d[..., 4], box3d[..., 3]], dim=-1) * 0.5
    verts = _signs(box3d.dtype, box3d.device) * half[..., None, :]  # (..., 8, 3)
    if R is not None:
        verts = torch.matmul(verts, R.transpose(-1, -2))
    return verts + center[..., None, :]


def backproject(K: torch.Tensor, uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) at depth z (...,) -> camera points (..., 3)."""
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    x3d = z * (uv[..., 0] - cx) / fx
    y3d = z * (uv[..., 1] - cy) / fy
    return torch.stack([x3d, y3d, z], dim=-1)


def project_points(K: torch.Tensor, pts3d: torch.Tensor) -> torch.Tensor:
    """Camera points (..., N, 3) through intrinsics (..., 3, 3) -> (..., N, 3):
    (u, v) divided by the depth kept at least ``MIN_Z`` away from zero, and
    the depth. The products are summed as written (f32 whatever the TF32
    switches say)."""
    proj = (K[..., None, :, :] * pts3d[..., :, None, :]).sum(-1)
    z = proj[..., 2:3]
    z_safe = torch.where(z.abs() < MIN_Z, torch.where(z < 0, -MIN_Z, MIN_Z), z)
    return torch.cat([proj[..., :2] / z_safe, z], dim=-1)
