"""Cubes: a batch of 3D boxes as one (..., 15) tensor (counterpart of
``threedod/structures/cubes.py``, after ProposalNetwork/utils/spaces.py).

Each row is [x, y, z, w, h, l, R11 .. R33]: the centre in camera space, the
dimensions and the rotation flattened row by row. The propose-and-score
path holds (B, N, P, 15): images, instances, proposals.
"""
from __future__ import annotations

import torch

from ..geometry.cuboids import cuboid_verts, project_points


class Cubes:
    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor

    @property
    def centers(self) -> torch.Tensor:
        return self.tensor[..., :3]

    @property
    def dimensions(self) -> torch.Tensor:
        return self.tensor[..., 3:6]

    @property
    def rotations(self) -> torch.Tensor:
        return self.tensor[..., 6:].reshape(*self.tensor.shape[:-1], 3, 3)

    def get_all_corners(self) -> torch.Tensor:
        """Corners (..., 8, 3) in camera space."""
        return cuboid_verts(self.tensor[..., :6], self.rotations)

    def get_bube_corners(self, K: torch.Tensor, clamp: tuple | None = None) -> torch.Tensor:
        """Projected corners (..., 8, 2) through intrinsics K, which broadcast
        against the leading dimensions with (3, 3) last. ``clamp`` = (width,
        height) clamps x to [int(-w / 2 + 1), int(2 w - 1)] and y likewise,
        as spaces.py does."""
        xy = project_points(K, self.get_all_corners())[..., :2]
        if clamp is not None:
            w, h = clamp
            xy = torch.stack([xy[..., 0].clamp(int(-w / 2 + 1), int(w - 1 + w)),
                              xy[..., 1].clamp(int(-h / 2 + 1), int(h - 1 + h))], dim=-1)
        return xy

    def to_boxes2d(self, K: torch.Tensor, im_shape: tuple | None = None) -> torch.Tensor:
        """Axis-aligned boxes (..., 4) XYXY of the projected corners."""
        return corners_to_boxes(self.get_bube_corners(K, im_shape))

    def get_volumes(self) -> torch.Tensor:
        return self.dimensions.prod(-1)

    @classmethod
    def cat(cls, cubes_list, dim: int = 0) -> "Cubes":
        return cls(torch.cat([c.tensor for c in cubes_list], dim=dim))

    @classmethod
    def from_parts(cls, centers: torch.Tensor, dims: torch.Tensor, rotations: torch.Tensor) -> "Cubes":
        """From centres (..., 3), dimensions (..., 3) and rotations (..., 3, 3)."""
        return cls(torch.cat([centers, dims, rotations.flatten(-2)], dim=-1))


def corners_to_boxes(corners: torch.Tensor) -> torch.Tensor:
    """(..., 8, 2) projected corners -> (..., 4) XYXY."""
    x, y = corners[..., 0], corners[..., 1]
    return torch.stack([x.amin(-1), y.amin(-1), x.amax(-1), y.amax(-1)], dim=-1)
