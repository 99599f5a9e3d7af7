"""2D box operations (counterpart of ``threedod/geometry/boxes2d.py``).

Boxes are (..., 4) XYXY.
"""
from __future__ import annotations

import math

import torch

# Clamp for dw/dh in delta application (detectron2's _DEFAULT_SCALE_CLAMP).
SCALE_CLAMP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (boxes[..., 3] - boxes[..., 1]).clamp(min=0)


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) intersection areas."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    return (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU."""
    inter = pairwise_intersection(boxes1, boxes2)
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), torch.zeros_like(inter))


def pairwise_ioa(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) intersection over the area of boxes2."""
    inter = pairwise_intersection(boxes1, boxes2)
    a2 = box_area(boxes2)[..., None, :]
    return torch.where(a2 > 0, inter / a2.clamp(min=1e-12), torch.zeros_like(inter))


def matched_pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of matched boxes, (..., 4) x (..., 4) -> (...,)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), torch.zeros_like(inter))


def matched_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise generalized IoU of matched boxes, (..., 4) -> (...,). The
    intersection is recovered from the IoU, as the JAX package does."""
    iou = matched_pairwise_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    hull = wh[..., 0] * wh[..., 1]
    areas = box_area(boxes1) + box_area(boxes2)
    inter = iou * areas / (1.0 + iou).clamp(min=1e-12)
    union = areas - inter
    return iou - torch.where(hull > 0, (hull - union) / hull.clamp(min=1e-12), torch.zeros_like(hull))


def giou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """1 - GIoU, elementwise (fvcore's ``giou_loss`` without reduction)."""
    return 1.0 - matched_giou(boxes1, boxes2)


def clip_boxes(boxes: torch.Tensor, h, w) -> torch.Tensor:
    """Clip to [0, w] x [0, h]; h, w broadcast against boxes[..., 0]."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return torch.stack(
        [
            torch.minimum(torch.maximum(boxes[..., 0], zero), w),
            torch.minimum(torch.maximum(boxes[..., 1], zero), h),
            torch.minimum(torch.maximum(boxes[..., 2], zero), w),
            torch.minimum(torch.maximum(boxes[..., 3], zero), h),
        ],
        dim=-1,
    )


class Box2BoxTransform:
    """(dx, dy, dw, dh) box regression, detectron2-compatible (log-space
    w/h, dw/dh clamped at SCALE_CLAMP when applied)."""

    def __init__(self, weights=(1.0, 1.0, 1.0, 1.0)):
        self.weights = weights

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        """(..., 4) x (..., 4) -> the (dx, dy, dw, dh) taking src to target."""
        sw = (src_boxes[..., 2] - src_boxes[..., 0]).clamp(min=1e-6)
        sh = (src_boxes[..., 3] - src_boxes[..., 1]).clamp(min=1e-6)
        sx = src_boxes[..., 0] + 0.5 * sw
        sy = src_boxes[..., 1] + 0.5 * sh
        tw = (target_boxes[..., 2] - target_boxes[..., 0]).clamp(min=1e-6)
        th = (target_boxes[..., 3] - target_boxes[..., 1]).clamp(min=1e-6)
        tx = target_boxes[..., 0] + 0.5 * tw
        ty = target_boxes[..., 1] + 0.5 * th
        wx, wy, ww, wh = self.weights
        return torch.stack(
            [wx * (tx - sx) / sw, wy * (ty - sy) / sh, ww * torch.log(tw / sw), wh * torch.log(th / sh)],
            dim=-1,
        )

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """deltas (..., k*4), boxes (..., 4) -> boxes (..., k*4)."""
        w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0)
        h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
        cx = boxes[..., 0] + 0.5 * w
        cy = boxes[..., 1] + 0.5 * h
        wx, wy, ww, wh = self.weights
        d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
        dx = d[..., 0] / wx
        dy = d[..., 1] / wy
        dw = (d[..., 2] / ww).clamp(max=SCALE_CLAMP)
        dh = (d[..., 3] / wh).clamp(max=SCALE_CLAMP)
        pcx = dx * w[..., None] + cx[..., None]
        pcy = dy * h[..., None] + cy[..., None]
        pw = torch.exp(dw) * w[..., None]
        ph = torch.exp(dh) * h[..., None]
        out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
        return out.reshape(deltas.shape)
