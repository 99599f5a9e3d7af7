"""Rotation conversions and angles (counterpart of
``threedod/geometry/rotations.py``). Leading batch dims are free."""
from __future__ import annotations

import torch


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=eps)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D representation (..., 6) -> matrices (..., 3, 3) whose rows are the
    Gram-Schmidt basis (pytorch3d convention)."""
    a1 = d6[..., 0:3]
    a2 = d6[..., 3:6]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> matrices (Rodrigues), safe at angle 0."""
    angle = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    axis = axis_angle / angle.clamp(min=1e-8)
    a = angle[..., 0]
    c = torch.cos(a)
    s = torch.sin(a)
    t = 1.0 - c
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    return torch.stack(
        [
            torch.stack([t * x * x + c, t * x * y - s * z, t * x * z + s * y], dim=-1),
            torch.stack([t * x * y + s * z, t * y * y + c, t * y * z - s * x], dim=-1),
            torch.stack([t * x * z - s * y, t * y * z + s * x, t * z * z + c], dim=-1),
        ],
        dim=-2,
    )


def _viewing_ray_matrix(K: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotation aligning the optical axis with the viewing ray of pixel (u, v)."""
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    sx = K[..., 0, 2]
    sy = K[..., 1, 2]
    oray = _normalize(torch.stack([(u - sx) / fx, (v - sy) / fy, torch.ones_like(u)], dim=-1))
    angle = torch.arccos(oray[..., 2].clamp(-1.0 + 1e-7, 1.0 - 1e-7))
    axis = _normalize(torch.stack([-oray[..., 1], oray[..., 0], torch.zeros_like(u)], dim=-1))
    M = axis_angle_to_matrix(angle[..., None] * axis)
    eye = torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)
    return torch.where((angle > 1e-7)[..., None, None], M, eye)


def R_from_allocentric(K: torch.Tensor, R_view: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Allocentric -> egocentric rotation: R = M(u, v) @ R_view."""
    return torch.matmul(_viewing_ray_matrix(K, u, v), R_view)


def R_to_allocentric(K: torch.Tensor, R: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Egocentric -> allocentric rotation: R_view = M(u, v)^T @ R."""
    return torch.matmul(_viewing_ray_matrix(K, u, v).transpose(-1, -2), R)


def acos_linear_extrapolation(x: torch.Tensor, bounds=(-0.9999, 0.9999)) -> torch.Tensor:
    """acos, continued linearly outside ``bounds`` so its gradient stays finite."""
    lower, upper = bounds
    acos_clip = torch.arccos(x.clamp(lower, upper))

    def dacos(b):
        return -1.0 / (1.0 - b * b) ** 0.5

    above = acos_clip + (x - upper) * dacos(upper)
    below = acos_clip + (x - lower) * dacos(lower)
    return torch.where(x > upper, above, torch.where(x < lower, below, acos_clip))


def so3_rotation_angle(R: torch.Tensor, cos_angle: bool = False, cos_bound: float = 1e-4) -> torch.Tensor:
    """Rotation angles of matrices (..., 3, 3): acos(0.5 * (tr(R) - 1))."""
    phi_cos = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5
    if cos_angle:
        return phi_cos
    bound = 1.0 - cos_bound
    return acos_linear_extrapolation(phi_cos, (-bound, bound))


def so3_relative_angle(R1: torch.Tensor, R2: torch.Tensor, cos_angle: bool = False,
                       cos_bound: float = 1e-4) -> torch.Tensor:
    """Relative geodesic angle between matched rotation matrices."""
    return so3_rotation_angle(torch.matmul(R1, R2.transpose(-1, -2)), cos_angle=cos_angle, cos_bound=cos_bound)
