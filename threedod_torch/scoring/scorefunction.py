"""Cube scores (counterpart of ``threedod/scoring/scorefunction.py``, after
ProposalNetwork/scoring/scorefunction.py), each over every (instance,
proposal) pair at once.

Shapes: instances carry leading dimensions (...), their proposals one more
(..., P). Masks are (..., H, W), projected cube corners (..., P, 8, 2),
2D boxes XYXY.

* ``score_point_cloud``: points of the depth map's cloud inside each cube's
  axis-aligned extent;
* ``score_iou``: 2D IoU of the projected box with the reference box;
* ``score_corners``: 1 minus the mean distance from the corners of the
  mask's minimum-area rectangle to the nearest projected corner, over its
  largest value among the proposals;
* ``score_segmentation`` / ``score_mod_segmentation``: IoU (and
  intersection^5 / union) of the projected hull's hard fill with the mask on
  a grid of every fourth pixel, counted by rows: a convex hull covers one run
  of each row, so per-row prefix sums of the mask give the intersection, and
  no (P, H, W) raster is made;
* ``score_dimensions``: the prior's Gaussian times a 2D aspect-ratio term.
"""
from __future__ import annotations

import math

import torch

from ..geometry.boxes2d import matched_pairwise_iou
from ..geometry.hull import convex_hull_order
from ..proposals.proposals import linspace
from ..structures.cubes import Cubes

BIG = 1e9  # stands for +-infinity in masked extremes
MASK_SUBSAMPLE = 4  # the segmentation scores' grid step in pixels
RECT_ANGLES = 90  # orientations the minimum-area rectangle tries over [0, 90) degrees


def score_point_cloud(points: torch.Tensor, cubes: Cubes, points_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Points (B, M, 3) strictly inside each cube's axis-aligned extent, for
    cubes (B, N, P, 15) -> (B, N, P) f32. ``points_valid`` (B, M) masks the
    points that count."""
    verts = cubes.get_all_corners()  # (B, N, P, 8, 3)
    lo, hi = verts.amin(-2), verts.amax(-2)
    pc = points[:, None, None]  # (B, 1, 1, M, 3)
    inside = None
    for c in range(3):
        v = pc[..., c]
        cur = (v > lo[..., c, None]) & (v < hi[..., c, None])
        inside = cur if inside is None else inside & cur
    if points_valid is not None:
        inside = inside & points_valid[:, None, None]
    return inside.sum(-1).float()


def score_iou(gt_boxes: torch.Tensor, proposal_boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) reference boxes, (..., P, 4) projected boxes -> (..., P)."""
    return matched_pairwise_iou(gt_boxes[..., None, :].expand_as(proposal_boxes), proposal_boxes)


def min_area_rect(mask: torch.Tensor, num_angles: int = RECT_ANGLES) -> torch.Tensor:
    """Corners (..., 4, 2) of the smallest rectangle, over ``num_angles``
    orientations in [0, 90) degrees, holding the pixels of masks (..., H, W)
    > 0.5 (zeros for an empty mask): the stand-in for ``cv2.minAreaRect``.
    A set's extreme along any direction lies on its hull, whose vertices are
    each a row's leftmost or rightmost pixel, so only those 2H candidates are
    turned."""
    h, w = mask.shape[-2:]
    m = mask > 0.5
    dev = mask.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    row_has = m.any(-1)  # (..., H)
    xmin_row = torch.where(m, xs, torch.full_like(xs, BIG)).amin(-1)
    xmax_row = torch.where(m, xs, torch.full_like(xs, -BIG)).amax(-1)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    cand_x = torch.cat([xmin_row, xmax_row], -1)[..., None, :]  # (..., 1, 2H)
    cand_y = torch.cat([ys, ys])
    ok = torch.cat([row_has, row_has], -1)[..., None, :]
    thetas = linspace(0.0, math.pi / 2, num_angles, device=dev, endpoint=False)
    c, s = torch.cos(thetas)[:, None], torch.sin(thetas)[:, None]  # (A, 1)
    u = cand_x * c + cand_y * s  # (..., A, 2H)
    v = -cand_x * s + cand_y * c
    u_min = torch.where(ok, u, BIG).amin(-1)
    u_max = torch.where(ok, u, -BIG).amax(-1)
    v_min = torch.where(ok, v, BIG).amin(-1)
    v_max = torch.where(ok, v, -BIG).amax(-1)
    i = torch.argmin((u_max - u_min) * (v_max - v_min), dim=-1, keepdim=True)  # (..., 1)

    def pick(t):
        return torch.gather(t, -1, i)[..., 0]

    ci, si = pick(c[:, 0].expand_as(u_min)), pick(s[:, 0].expand_as(u_min))
    u0, u1, v0, v1 = pick(u_min), pick(u_max), pick(v_min), pick(v_max)
    uu = torch.stack([u0, u1, u1, u0], -1)
    vv = torch.stack([v0, v0, v1, v1], -1)
    ci, si = ci[..., None], si[..., None]
    corners = torch.stack([uu * ci - vv * si, uu * si + vv * ci], -1)  # (..., 4, 2)
    return torch.where(m.flatten(-2).any(-1)[..., None, None], corners, torch.zeros_like(corners))


def score_corners(mask: torch.Tensor, bube_corners: torch.Tensor) -> torch.Tensor:
    """Masks (..., H, W), projected corners (..., P, 8, 2) -> (..., P) in [0, 1]."""
    rect = min_area_rect(mask)  # (..., 4, 2)
    diff = rect[..., None, :, None, :] - bube_corners[..., :, None, :, :]  # (..., P, 4, 8, 2)
    d = torch.sqrt((diff * diff).sum(-1))
    scores = d.amin(-1).mean(-1)  # (..., P)
    return 1.0 - scores / torch.clamp(scores.amax(-1, keepdim=True), min=1e-9)


def hull_row_intervals(corners: torch.Tensor, height: int):
    """Per-row run of a convex hull's hard fill: corners (..., Q, 2) ->
    (lo, hi, feasible) each (..., height): the hull covers pixel centres x
    in [lo, hi] on row y (none where hi < lo or not feasible). A centre is
    inside when cross(edge, p - v) >= 0 for every counter-clockwise edge."""
    hull = convex_hull_order(corners)
    e = torch.roll(hull, -1, dims=-2) - hull  # (..., E, 2)
    ys = torch.arange(height, dtype=corners.dtype, device=corners.device)
    ex, ey = e[..., 0, None], e[..., 1, None]  # (..., E, 1)
    num = ex * (ys - hull[..., 1, None])  # (..., E, H)
    base = hull[..., 0, None] + num / torch.where(ey == 0, torch.ones_like(ey), ey)
    live = ~((e * e).sum(-1) < 1e-12)[..., None]
    upper = torch.where((ey > 0) & live, base, torch.full_like(base, BIG))
    lower = torch.where((ey < 0) & live, base, torch.full_like(base, -BIG))
    feas = torch.where((ey == 0) & live, num >= 0, torch.ones_like(num, dtype=torch.bool)).all(-2)
    return torch.ceil(lower.amax(-2)), torch.floor(upper.amin(-2)), feas


def _seg_inter_union(mask: torch.Tensor, bube_corners: torch.Tensor, sub: int = MASK_SUBSAMPLE):
    """(intersection, union, hull empty) pixel counts (..., P) of each
    projected hull's fill against the mask on the ``sub``-step grid."""
    h, w = mask.shape[-2:]
    hs, ws = h // sub, w // sub  # the rows a hull is counted on, the columns it may cover
    seg = mask[..., ::sub, ::sub] > 0.5
    n_seg = seg.sum((-2, -1))  # (...,)
    pref = torch.cat([torch.zeros_like(seg[..., :1], dtype=torch.int32),
                      torch.cumsum(seg.int(), -1, dtype=torch.int32)], -1)  # (..., rows, cols + 1)
    lo, hi, feas = hull_row_intervals(bube_corners / sub, hs)  # (..., P, hs)
    loc = lo.clamp(0, ws).int()
    hic = (hi + 1).clamp(0, ws).int()
    zero = torch.zeros_like(loc)
    n_row = torch.where(feas, torch.clamp(hic - loc, min=0), zero)
    rows = torch.arange(hs, device=mask.device) * pref.shape[-1]
    flat = pref.flatten(-2)

    def at(col):  # prefix sums at (row, col) of every proposal's rows
        idx = (rows + torch.where(feas, col, zero).long()).flatten(-2)  # (..., P hs)
        return torch.gather(flat, -1, idx).reshape(col.shape)

    inter = torch.where(feas & (hic > loc), at(hic) - at(loc), zero).sum(-1)
    n_bube = n_row.sum(-1)
    return inter, n_seg[..., None] + n_bube - inter, n_bube == 0


def _pow5(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    return x * (x2 * x2)


def score_segmentation_pair(mask: torch.Tensor, bube_corners: torch.Tensor, sub: int = MASK_SUBSAMPLE):
    """(score_segmentation, score_mod_segmentation) from one pass."""
    inter, union, empty = _seg_inter_union(mask, bube_corners, sub)
    dead = (inter == 0) | empty
    safe = torch.clamp(union, min=1).float()
    zero = torch.zeros_like(safe)
    return (torch.where(dead, zero, inter.float() / safe), torch.where(dead, zero, _pow5(inter.float()) / safe))


def score_segmentation(mask: torch.Tensor, bube_corners: torch.Tensor, sub: int = MASK_SUBSAMPLE) -> torch.Tensor:
    """IoU of the hull fill with the mask on the ``sub``-step grid."""
    return score_segmentation_pair(mask, bube_corners, sub)[0]


def score_mod_segmentation(mask: torch.Tensor, bube_corners: torch.Tensor, sub: int = MASK_SUBSAMPLE) -> torch.Tensor:
    """intersection^5 / union (reference :108-126)."""
    return score_segmentation_pair(mask, bube_corners, sub)[1]


def score_dimensions(prior_mean, prior_std, dimensions, gt_box, pred_boxes) -> torch.Tensor:
    """The prior's Gaussian of the dimensions, averaged over the three, times
    1 - |aspect difference| / its largest value (reference :144-160).
    prior (..., 3), dimensions (..., P, 3), gt_box (..., 4), pred_boxes (..., P, 4) -> (..., P)."""
    std = torch.clamp(prior_std, min=1e-6)[..., None, :]
    zs = (dimensions - prior_mean[..., None, :]) / std
    dim_scores = torch.exp(-0.5 * (zs * zs)).mean(-1)
    gt_ratio = (gt_box[..., 2] - gt_box[..., 0]) / torch.clamp(gt_box[..., 3] - gt_box[..., 1], min=1e-6)
    pred_ratios = (pred_boxes[..., 2] - pred_boxes[..., 0]) / torch.clamp(pred_boxes[..., 3] - pred_boxes[..., 1],
                                                                          min=1e-6)
    diff = (gt_ratio[..., None] - pred_ratios).abs()
    return (1.0 - diff / torch.clamp(diff.amax(-1, keepdim=True), min=1e-9)) * dim_scores


def score_ratios(gt_box, pred_boxes) -> torch.Tensor:
    """1 - the L1 distance of each box (..., P, 4) to the reference (..., 4)
    over its largest value."""
    diff = (pred_boxes - gt_box[..., None, :]).abs().sum(-1)
    return 1.0 - diff / torch.clamp(diff.amax(-1, keepdim=True), min=1e-9)


def combined_score(iou2d, dims, corners) -> torch.Tensor:
    """IoU2D x dimensions x corners, the combination the method ranks by."""
    return iou2d * dims * corners
