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


def _rows(r00, r01, r02, r10, r11, r12, r20, r21, r22) -> torch.Tensor:
    return torch.stack([torch.stack([r00, r01, r02], dim=-1), torch.stack([r10, r11, r12], dim=-1),
                        torch.stack([r20, r21, r22], dim=-1)], dim=-2)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) in (w, x, y, z) order -> matrices (..., 3, 3),
    divided by their squared norm."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / (q * q).sum(-1).clamp(min=1e-12)
    return _rows(1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w),
                 two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w),
                 two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y))


def normalize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions whose real part is not negative (pytorch3d's sign)."""
    norm = torch.sqrt((q * q).sum(-1, keepdim=True).clamp(min=1e-12))
    sign = torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q / (norm * sign)


def euler_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) [x, y, z] -> matrices R = Rz @ Ry @ Rx (the
    reference's ``euler2mat``, ``threedod/geometry/rotations.py``'s
    ``euler_to_matrix``)."""
    cx, sx = torch.cos(euler[..., 0]), torch.sin(euler[..., 0])
    cy, sy = torch.cos(euler[..., 1]), torch.sin(euler[..., 1])
    cz, sz = torch.cos(euler[..., 2]), torch.sin(euler[..., 2])
    return _rows(cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                 sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                 -sy, cy * sx, cy * cx)


def euler_xyz_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) -> matrices in pytorch3d's 'XYZ' convention,
    R = Rx @ Ry @ Rz (the reference cube head's ``euler`` pose)."""
    cx, sx = torch.cos(euler[..., 0]), torch.sin(euler[..., 0])
    cy, sy = torch.cos(euler[..., 1]), torch.sin(euler[..., 1])
    cz, sz = torch.cos(euler[..., 2]), torch.sin(euler[..., 2])
    return _rows(cy * cz, -cy * sz, sy,
                 cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy,
                 sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy)


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


def matrix_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> Euler angles (..., 3) [x, y, z]."""
    sy = torch.sqrt(R[..., 0, 0] * R[..., 0, 0] + R[..., 1, 0] * R[..., 1, 0])
    x = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    y = torch.atan2(-R[..., 2, 0], sy)
    z = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([x, y, z], dim=-1)


def rotate_vector_axis_angle(v: torch.Tensor, k: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of vectors v (..., 3) about unit axes k (..., 3) by
    angles theta (...)."""
    theta = theta[..., None]
    c, s = torch.cos(theta), torch.sin(theta)
    return v * c + torch.linalg.cross(k, v, dim=-1) * s + k * (k * v).sum(-1, keepdim=True) * (1.0 - c)


def orthobasis_from_normal(normal: torch.Tensor, yaw_angles: torch.Tensor) -> torch.Tensor:
    """Rotation bases whose middle column is ``normal``, swept by yaw.

    normal (..., 3) unit vectors, yaw_angles (A,) -> (..., A, 3, 3) with
    columns [x, normal, normal x x]: x is a vector perpendicular to the
    normal (n.y, -n.x, 0), or (0, n.z, -n.y) where n.x is about 0, turned
    about the normal by each angle (after ProposalNetwork/utils/utils.py)."""
    a, b, c = normal.unbind(-1)
    zero = torch.zeros_like(a)
    perp = torch.where((a.abs() < 1e-8)[..., None], torch.stack([zero, c, -b], -1),
                       _normalize(torch.stack([b, -a, zero], -1)))
    n = normal[..., None, :].expand(*normal.shape[:-1], yaw_angles.shape[0], 3)
    x = _normalize(rotate_vector_axis_angle(perp[..., None, :].expand_as(n), n, yaw_angles))
    y = torch.linalg.cross(n, x, dim=-1)
    return torch.stack([x, n, y], dim=-1)
