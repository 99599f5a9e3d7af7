"""The propose-and-score system's core (counterpart of
``threedod/models/boxer.py``, after cubercnn's ROIHeads_Boxer :79-660).

* ``ground_plane_from_depth``: the point cloud of every fifth pixel, a
  RANSAC plane fitted to its ground pixels, and the wall-or-floor fix-up of
  the plane's normal (:345-428), for a batch of images in one program (weak
  Cube R-CNN's ``pose_ground`` losses read it too);
* ``propose_and_score``: per image, the ground plane, P proposals per
  reference box from one of the seven samplers, and every score of every
  (instance, proposal) pair (2D IoU, point-cloud count, segmentation IoU and
  its intersection^5 variant, corners, dimensions, random), the combined
  score IoU2D x dimensions x corners, the best cube per box, and the IoU3D of
  every proposal with its box's ground-truth cube where there is one. All
  images, instances and proposals at once, with no read back to the host;
* ``score_proposals``: the scores of given cubes and their projected
  corners, the part of ``propose_and_score`` after the proposals;
* ``box_fill_masks``: filled 2D boxes, the masks when no instance masks ship;
* ``accumulate_scores`` and ``mabo_statistics`` (host numpy): the IoU3D
  running maxima along each score's ranking, and the 26 combinations of
  scores ``COMBINATION_DEFS`` the MABO table ablates (:277-281, :552-578).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from ..geometry.iou3d import iou3d_pairs
from ..geometry.plane import Hypotheses, cloud_pixels, fit_plane_ransac, point_cloud_from_depth
from ..proposals.proposals import draw_standard, propose_batch
from ..scoring.scorefunction import (combined_score, score_corners, score_dimensions, score_iou,
                                     score_point_cloud, score_segmentation_pair)
from ..structures.cubes import Cubes, corners_to_boxes

SCORE_NAMES = ("IoU2D", "seg", "dim", "combined", "random", "point_cloud", "seg_mod", "corner")

# the 26 MABO ablations (reference :552-578): each a product of base scores
COMBINATION_DEFS = (
    ("IoU2D", "seg_mod"),
    ("IoU2D", "dim"),
    ("IoU2D", "corner"),
    ("IoU2D", "point_cloud"),
    ("IoU2D", "seg_mod", "dim"),
    ("IoU2D", "seg_mod", "corner"),
    ("IoU2D", "seg_mod", "point_cloud"),
    ("IoU2D", "dim", "corner"),
    ("IoU2D", "dim", "point_cloud"),
    ("IoU2D", "corner", "point_cloud"),
    ("IoU2D", "seg_mod", "point_cloud"),
    ("IoU2D", "seg_mod", "dim", "point_cloud"),
    ("IoU2D", "seg_mod", "corner", "point_cloud"),
    ("IoU2D", "dim", "corner", "point_cloud"),
    ("IoU2D", "seg_mod", "dim", "corner", "point_cloud"),
    ("seg_mod", "dim"),
    ("seg_mod", "corner"),
    ("seg_mod", "point_cloud"),
    ("seg_mod", "dim", "corner"),
    ("seg_mod", "dim", "point_cloud"),
    ("seg_mod", "corner", "point_cloud"),
    ("seg_mod", "dim", "corner", "point_cloud"),
    ("dim", "corner"),
    ("dim", "point_cloud"),
    ("dim", "corner", "point_cloud"),
    ("corner", "point_cloud"),
)


class BoxerOutput(NamedTuple):
    best_cubes: torch.Tensor  # (B, N, 15) the best-scoring proposal per box
    best_scores: torch.Tensor  # (B, N) its combined score
    best_boxes2d: torch.Tensor  # (B, N, 4) its projected 2D box
    scores: Dict[str, torch.Tensor]  # SCORE_NAMES -> (B, N, P)
    iou3d: Optional[torch.Tensor]  # (B, N, P) against the box's ground-truth cube, where given
    cubes: Cubes  # (B, N, P, 15) every proposal
    normal: torch.Tensor  # (B, 3) the ground normal


class BoxerDraws(NamedTuple):
    """The standard variates of one ``propose_and_score`` call."""

    ransac: torch.Tensor  # (B, RANSAC_HYPOTHESES, 3) point indices
    proposals: Dict[str, torch.Tensor]  # the sampler's ``proposals.sampler_draws``
    random: torch.Tensor  # (B, N, P) U[0, 1): the "random" score


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


def score_proposals(cubes: Cubes, bube: torch.Tensor, boxes: torch.Tensor, masks: torch.Tensor,
                    points: torch.Tensor, points_valid: torch.Tensor, prior_means: torch.Tensor,
                    prior_stds: torch.Tensor, random: torch.Tensor):
    """Every score of cubes (B, N, P, 15) whose projected corners are bube
    (B, N, P, 8, 2), against reference boxes (B, N, 4), masks (B, N, H, W),
    the cloud's points (B, M, 3) with their mask (B, M) and the priors (B,
    N, 3); ``random`` (B, N, P) is the "random" score. -> (SCORE_NAMES ->
    (B, N, P), the projected 2D boxes (B, N, P, 4))."""
    prop_boxes = corners_to_boxes(bube)
    iou2d = score_iou(boxes, prop_boxes)
    seg, seg_mod = score_segmentation_pair(masks, bube)
    corner = score_corners(masks, bube)
    dim = score_dimensions(prior_means, prior_stds, cubes.dimensions, boxes, prop_boxes)
    scores = {"IoU2D": iou2d, "seg": seg, "dim": dim, "combined": combined_score(iou2d, dim, corner),
              "random": random, "point_cloud": score_point_cloud(points, cubes, points_valid), "seg_mod": seg_mod,
              "corner": corner}
    return scores, prop_boxes


def propose_and_score(draws: Union[torch.Generator, BoxerDraws], proposal_function: str, boxes: torch.Tensor,
                      masks: torch.Tensor, prior_means: torch.Tensor, prior_stds: torch.Tensor,
                      depth_maps: torch.Tensor, K_scaled: torch.Tensor, im_shape, number_of_proposals: int = 1000,
                      ground_maps: Optional[torch.Tensor] = None, gt_cubes: Optional[torch.Tensor] = None,
                      valid_hw: Optional[torch.Tensor] = None) -> BoxerOutput:
    """Propose and score for B images of N reference boxes each: boxes (B, N,
    4) XYXY and masks (B, N, H, W) at network resolution, the category
    priors' means and deviations (B, N, 3), depth maps (B, H, W) in metres,
    intrinsics at network resolution (B, 3, 3), im_shape (w, h), ground maps
    (B, H, W) or None, ground-truth cubes (B, N, 15) or None, valid extents
    (B, 2) or None. ``draws`` is a generator (the variates are drawn from it
    on its device) or the variates themselves. The ``propose`` sampler
    aligns its cubes with the fitted ground plane's normal."""
    b, n = boxes.shape[:2]
    p = number_of_proposals
    with_normal = proposal_function == "propose"
    if isinstance(draws, torch.Generator):
        draws = BoxerDraws(draws, draw_standard(proposal_function, b, n, p, draws, with_normal),
                           torch.rand((b, n, p), generator=draws, device=draws.device))
    normal, points, pc_valid = ground_plane_from_depth(draws.ransac, depth_maps, K_scaled, ground_maps,
                                                       valid_hw=valid_hw)
    cubes = propose_batch(draws.proposals, proposal_function, boxes, depth_maps, prior_means, prior_stds,
                          im_shape, K_scaled, p, ground_normal=normal if with_normal else None)

    bube = cubes.get_bube_corners(K_scaled[:, None, None], clamp=im_shape)  # (B, N, P, 8, 2)
    scores, prop_boxes = score_proposals(cubes, bube, boxes, masks, points, pc_valid, prior_means, prior_stds,
                                         draws.random)
    combined = scores["combined"]

    iou3d = None
    if gt_cubes is not None:
        gt_corners = Cubes(gt_cubes).get_all_corners()  # (B, N, 8, 3)
        _, iou3d = iou3d_pairs(gt_corners[:, :, None].expand(b, n, p, 8, 3).reshape(-1, 8, 3),
                               cubes.get_all_corners().reshape(-1, 8, 3))
        iou3d = iou3d.reshape(b, n, p)

    best = torch.argmax(combined, dim=-1, keepdim=True)  # the first of the largest
    return BoxerOutput(
        best_cubes=torch.gather(cubes.tensor, 2, best[..., None].expand(b, n, 1, 15))[:, :, 0],
        best_scores=torch.gather(combined, 2, best)[..., 0],
        best_boxes2d=torch.gather(prop_boxes, 2, best[..., None].expand(b, n, 1, 4))[:, :, 0],
        scores=scores, iou3d=iou3d, cubes=cubes, normal=normal,
    )


def box_fill_masks(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Filled 2D boxes (..., 4) XYXY -> (..., h, w) f32 masks: pixel (y, x)
    is inside when x1 <= x <= x2 and y1 <= y <= y2."""
    yy = torch.arange(h, dtype=torch.float32, device=boxes.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=boxes.device)[None, :]
    bx = boxes[..., None, None, :]
    return ((xx >= bx[..., 0]) & (xx <= bx[..., 2]) & (yy >= bx[..., 1]) & (yy <= bx[..., 3])).float()


def accumulate_scores(scores: np.ndarray, iou3d: np.ndarray) -> np.ndarray:
    """The running maximum of IoU3D along the proposals ranked by score,
    highest first (host numpy)."""
    idx = np.argsort(scores)[::-1]
    return np.maximum.accumulate(iou3d[idx])


def mabo_statistics(scores: dict, iou3d: np.ndarray, valid: np.ndarray):
    """One image's MABO curves: scores name -> (N, P), iou3d (N, P), valid (N,)
    -> (curves: name -> (Nv, P), combinations (Nv, 26): the first entry of
    each combination's curve)."""
    scores = {k: np.asarray(v)[valid] for k, v in scores.items()}
    iou3d = np.asarray(iou3d)[valid]
    nv, p = iou3d.shape
    curves = {name: np.stack([accumulate_scores(s[i], iou3d[i]) for i in range(nv)]) if nv else np.zeros((0, p))
              for name, s in scores.items()}
    combos = np.zeros((nv, len(COMBINATION_DEFS)))
    for ci, parts in enumerate(COMBINATION_DEFS):
        prod = np.ones((nv, p))
        for name in parts:
            prod = prod * scores[name]
        for i in range(nv):
            combos[i, ci] = accumulate_scores(prod[i], iou3d[i])[0]
    return curves, combos
