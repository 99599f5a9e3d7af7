"""Multi-scale deformable attention, ``MSDeformAttn`` (counterpart of
``threedod/models/gdino/deformable.py``'s module).

Value, offset and attention-weight projections of the query, a softmax over
the L * P samples of each head, sample locations from point references
(B, Lq, L, 2) or box references (B, Lq, L, 4), the sampling itself
(``ops.ms_deform.ms_deform_sample``: kernel K3 on the card) and the output
projection. Parameter names are the official checkpoint's
(``sampling_offsets``, ``attention_weights``, ``value_proj``, ``output_proj``).

Types follow the JAX module: the offsets come out of a projection in the
compute dtype and the references are f32, so the locations are f32; the
weights are a softmax in the compute dtype.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ...ops.ms_deform import ms_deform_sample
from .layers import linear


class MSDeformAttn(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, levels: int = 4, points: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.levels, self.points, self.dtype = heads, levels, points, dtype
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query: torch.Tensor, ref_points: torch.Tensor, value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]], value_mask: torch.Tensor | None = None) -> torch.Tensor:
        b, lq, c = query.shape
        h, n_lvl, p = self.heads, self.levels, self.points
        v = linear(value, self.value_proj, self.dtype)
        if value_mask is not None:
            v = v * value_mask[..., None].to(v.dtype)
        v = v.reshape(b, -1, h, c // h)
        off = linear(query, self.sampling_offsets, self.dtype).reshape(b, lq, h, n_lvl, p, 2)
        aw = linear(query, self.attention_weights, self.dtype).reshape(b, lq, h, n_lvl * p)
        aw = torch.softmax(aw, dim=-1).reshape(b, lq, h, n_lvl, p)
        if ref_points.shape[-1] == 2:
            norm = torch.tensor([[wl, hl] for hl, wl in spatial_shapes], dtype=off.dtype, device=off.device)
            loc = ref_points[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
        else:
            xy = ref_points[..., :2][:, :, None, :, None, :]
            wh = ref_points[..., 2:][:, :, None, :, None, :]
            # a true division, as in JAX (on the card a division by a Python
            # scalar is a product with its reciprocal)
            loc = xy + off / torch.tensor(float(p), dtype=off.dtype, device=off.device) * wh * 0.5
        sampled = ms_deform_sample(v.contiguous(), spatial_shapes, loc.float().contiguous(), aw.contiguous())
        return linear(sampled.reshape(b, lq, c), self.output_proj, self.dtype)
