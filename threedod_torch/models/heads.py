"""ROI heads' learnable layers (counterpart of ``threedod/models/heads.py``),
with detectron2 / Cube R-CNN names.

Pooled ROI features arrive as (N, S, S, C), the layout the ROIAlign kernel
writes. detectron2 flattens them as (C, S, S), so the first fc's weight
(``fc1``, d2 layout) has its input columns permuted to (S, S, C) when it is
applied, not the pooled block. The MLP layers compute in the model dtype;
the predictors compute in f32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry.rotations import euler_xyz_to_matrix, normalize_quaternion, quaternion_to_matrix, rotation_6d_to_matrix


def linear_chw(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` over (N, S, S, C) input, its weight taken in d2's (C, S, S)
    column order."""
    n, s, _, c = x.shape
    w = layer.weight.reshape(-1, c, s, s).permute(0, 2, 3, 1).reshape(-1, s * s * c)
    return F.linear(x.reshape(n, -1).to(dtype), w.to(dtype), layer.bias.to(dtype))


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class FCStack(nn.Module):
    """``num_fc`` relu'd fc layers ``fc1``.. over pooled (N, S, S, C) input."""

    def __init__(self, in_dim: int, num_fc: int, fc_dim: int):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(in_dim if i == 0 else fc_dim, fc_dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = F.relu(linear_chw(x, self.fc1, dtype))
        for i in range(1, self.num_fc):
            x = F.relu(linear(x, getattr(self, f"fc{i + 1}"), dtype))
        return x


class BoxPredictor(nn.Module):
    """fc features -> (class scores (C+1), per-class box deltas (C*4)), f32."""

    def __init__(self, fc_dim: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, x: torch.Tensor):
        x = x.float()
        return self.cls_score(x), self.bbox_pred(x)


class CubeHeadNet(nn.Module):
    """Pooled ROI features -> raw per-class 3D outputs (the reference's
    CubeHead): fc features from one shared stack (``feature_generator``) or
    one stack a branch (``feature_generator_{XY,dims,pose,Z,conf}``), then
    per-class 2D-centre deltas, dimensions, a pose (6d, quaternion or
    Euler 'XYZ'), depth (one a cluster bin) and, with ``use_confidence``,
    an uncertainty.

    Returns (deltas_2d (N, C, 2), z (N, C), or (N, bins, C) with bins > 1,
    dims (N, C, 3), pose (N, C, 3, 3), uncert (N, C) or None)."""

    POSE_DIMS = {"6d": 6, "quaternion": 4, "euler": 3}
    BRANCHES = ("XY", "dims", "pose", "Z", "conf")

    def __init__(self, in_dim: int, num_classes: int, num_fc: int, fc_dim: int, shared_fc: bool = True,
                 pose_type: str = "6d", cluster_bins: int = 1, use_confidence: float = 1.0):
        super().__init__()
        c = num_classes
        self.num_classes = c
        self.shared_fc = shared_fc
        self.pose_type = pose_type
        self.bins = max(cluster_bins, 1)
        self.use_confidence = use_confidence > 0
        if shared_fc:
            self.feature_generator = FCStack(in_dim, num_fc, fc_dim)
        else:
            for branch in self.BRANCHES[:4] + (("conf",) if self.use_confidence else ()):
                self.add_module(f"feature_generator_{branch}", FCStack(in_dim, num_fc, fc_dim))
        self.bbox_3D_center_deltas = nn.Linear(fc_dim, c * 2)
        self.bbox_3D_dims = nn.Linear(fc_dim, c * 3)
        self.bbox_3D_pose = nn.Linear(fc_dim, c * self.POSE_DIMS[pose_type])
        self.bbox_3D_center_depth = nn.Linear(fc_dim, c * self.bins)
        if self.use_confidence:
            self.bbox_3D_uncertainty = nn.Linear(fc_dim, c)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        n, c = x.shape[0], self.num_classes
        if self.shared_fc:
            feat = self.feature_generator(x, dtype).float()
            f_xy = f_dims = f_pose = f_z = f_conf = feat
        else:
            f_xy, f_dims, f_pose, f_z = (getattr(self, f"feature_generator_{b}")(x, dtype).float()
                                         for b in self.BRANCHES[:4])
            f_conf = self.feature_generator_conf(x, dtype).float() if self.use_confidence else None
        deltas_2d = self.bbox_3D_center_deltas(f_xy).reshape(n, c, 2)
        dims = self.bbox_3D_dims(f_dims).reshape(n, c, 3)
        pose_raw = self.bbox_3D_pose(f_pose).reshape(n * c, self.POSE_DIMS[self.pose_type])
        if self.pose_type == "6d":
            pose = rotation_6d_to_matrix(pose_raw)
        elif self.pose_type == "quaternion":
            pose = quaternion_to_matrix(normalize_quaternion(pose_raw))
        else:
            pose = euler_xyz_to_matrix(pose_raw)
        z = self.bbox_3D_center_depth(f_z)
        z = z.reshape(n, self.bins, c) if self.bins > 1 else z.reshape(n, c)
        uncert = self.bbox_3D_uncertainty(f_conf).clamp(min=0.01) if self.use_confidence else None
        return deltas_2d, z, dims, pose.reshape(n, c, 3, 3), uncert
