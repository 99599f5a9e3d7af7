"""Small shared numerics (counterpart of ``threedod/geometry/misc.py``)."""
from __future__ import annotations

import torch


def compute_virtual_scale_from_focal_spaces(f, H, f0, H0):
    """Scaling factor of depth from real (f0, H0) to virtual (f, H) space."""
    return (H0 * f) / (f0 * H)


def scaled_sigmoid(vals: torch.Tensor, min=0.0, max=1.0) -> torch.Tensor:
    """Sigmoid rescaled to (min, max)."""
    return min + (max - min) * torch.sigmoid(vals)


def smooth_l1(x: torch.Tensor, y: torch.Tensor, beta: float = 0.0) -> torch.Tensor:
    """Elementwise smooth-L1 (beta = 0 is plain L1)."""
    diff = (x - y).abs()
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def chamfer_corner_loss(pred_corners: torch.Tensor, gt_corners: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer L1 over 8 box corners, (..., 8, 3) -> (...,)."""
    l1 = (pred_corners[..., :, None, :] - gt_corners[..., None, :, :]).abs().sum(-1)  # (..., 8, 8)
    return l1.amin(-2).mean(-1) + l1.amin(-1).mean(-1)
