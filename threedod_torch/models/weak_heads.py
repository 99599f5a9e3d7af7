"""ROIHeads3DScore: weak Cube R-CNN's ROI heads, whose cube branch learns
from 2D boxes, depth maps and ground maps alone (counterpart of
``threedod/models/weak_heads.py``, after cubercnn's ROIHeads3DScore).

The loss menu (``cfg.loss_functions``), each loss one program over the
foreground prefix of every image (B x F rows):

  iou                 1 - GIoU of the cube's projected box and the 2D box
  pose_alignment      1 - |cos| of the relative rotation of every pair of
                      cubes in an image
  pose_ground         1 - |cos| between the cube's up axis and the ground
                      normal (RANSAC on the depth and ground maps); weight
                      0.1 in an image without a ground map
  pose_ground2        1 - cos of the rotation from the ground normal's frame
  z                   the depth 50 steps of 0.1 m away whose projected area
                      best matches the 2D box's
  z_pseudo_gt_patch   the median depth inside the projected box
  z_pseudo_gt_center  the depth at the projected centre
  dims                how far the dimensions lie beyond one standard
                      deviation of the category's prior
  segmentation        the focal loss between the ground truth's stored mask
                      (SAM's, or the filled box) and the soft fill of the
                      hull of the cube's projected corners, on the mask grid
  depth               the 0.9 - 0.1 depth quantile range inside the 2D box
                      (and its mask) against the cube's depth extent

each scaled by the uncertainty sqrt(2) exp(-u) (where the head has a
confidence output) and weighted from the config. The hull fill keeps only
the polygons for its backward (``geometry/hull.py``), so the segmentation
loss needs no recomputation wrapper (the JAX package's ``jax.checkpoint``
around it is for the same memory).

The quantiles sort each window (the JAX package's radix bisection computes
the same order statistic), and the windows are gathers (the JAX package's
one-hot products compute the same values). Nothing here reads a value back
to the host.

Under a process group every loss and metric is this rank's share of the
global batch's (``ops.losses.safely_reduce_losses``); the pose-alignment
loss's mean over the images with a pair is the global batch's on every
rank, and the RANSAC hypotheses are this rank's rows of the global draw.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..geometry.boxes2d import giou_loss, matched_pairwise_iou
from ..geometry.cuboids import backproject, cuboid_verts, project_points
from ..geometry.hull import convex_hull_mask
from ..geometry.misc import smooth_l1
from ..geometry.plane import CLOUD_STRIDE, RANSAC_HYPOTHESES
from ..geometry.rotations import so3_rotation_angle
from ..ops.losses import safely_reduce_losses, sigmoid_focal_loss
from ..parallel import dist
from .boxer import ground_plane_from_depth
from .roi_heads3d import SQRT_2_CONSTANT, ROIHeads3D, SampledROIs

BOX_SAMPLE_GRID = 32  # the s x s window a ROI's quantiles are taken over
Z_STEPS = 50  # the depth search's steps of 0.1 m
BIG = 1e9  # masked entries of a quantile's row


def project_cube_boxes(centers, dims, poses, Ks, im_w, im_h):
    """The 2D boxes (N, 4) around the projected corners of (N,) cubes, the
    corners clamped to half an image beyond each side."""
    corners = cuboid_verts(torch.cat([centers, dims], dim=-1), poses)
    proj = project_points(Ks, corners)
    x = proj[..., 0].clamp(int(-im_w / 2 + 1), int(im_w - 1 + im_w))
    y = proj[..., 1].clamp(int(-im_h / 2 + 1), int(im_h - 1 + im_h))
    return torch.stack([x.amin(-1), y.amin(-1), x.amax(-1), y.amax(-1)], dim=-1)


def pose_alignment_loss(poses, fg_mask):
    """Pose consistency within each image: the mean of 1 - |cos| of the
    relative rotation over the pairs of foreground cubes, averaged over the
    images that have a pair (of the global batch, under a process group).
    poses (B, F, 3, 3), fg_mask (B, F). -> (loss, whether any image has a
    pair)."""
    f = poses.shape[1]
    # trace(R_n R_m^T) is the sum of the elementwise products
    cos = ((poses[:, :, None] * poses[:, None]).sum((-1, -2)) - 1.0) * 0.5  # (B, F, F)
    upper = torch.ones(f, f, dtype=torch.bool, device=poses.device).triu(1)
    pair = fg_mask[:, :, None] & fg_mask[:, None, :] & upper
    s = torch.where(pair, 1.0 - cos.abs(), torch.zeros_like(cos)).sum((1, 2))
    n = pair.sum((1, 2))
    has = n > 0
    per = torch.where(has, s / n.clamp(min=1), torch.zeros_like(s))
    n_valid = dist.all_sum(has.sum())  # the image-level mean is the global batch's, on every rank
    return dist.all_sum(per.sum()) / n_valid.clamp(min=1), n_valid > 0


def ransac_hypotheses(generator: torch.Generator, b: int, n_points: int) -> torch.Tensor:
    """(b, RANSAC_HYPOTHESES, 3) point indices for ``fit_plane_ransac`` on
    b images of ``n_points`` points: this rank's rows of the global batch's
    draw (the draw itself without a process group)."""
    return dist.local_rows(torch.randint(0, n_points, (dist.global_batch(b), RANSAC_HYPOTHESES, 3),
                                         generator=generator, device=generator.device))


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-8)


def normal_to_rotation(normal):
    """The pseudo rotation (..., 3, 3) whose rows are [t0, t1, normal]."""
    x1, y1 = torch.zeros_like(normal), torch.zeros_like(normal)
    x1[..., 0] = 1.0
    y1[..., 1] = 1.0
    t0 = torch.linalg.cross(normal, x1, dim=-1)
    small = (t0 * t0).sum(-1, keepdim=True) < 1e-3
    t0 = _unit(torch.where(small, torch.linalg.cross(normal, y1, dim=-1), t0))
    t1 = _unit(torch.linalg.cross(normal, t0, dim=-1))
    return torch.stack([t0, t1, normal], dim=-2)


@functools.lru_cache(maxsize=None)
def _on_device(make, *args, device: torch.device) -> torch.Tensor:
    """A constant numpy table (``make(*args)``) on ``device``, copied once
    (a host-to-device copy waits for the card, and the training step reads
    the card only once) and outside inference mode."""
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device)


def z_steps() -> np.ndarray:
    """``jnp.linspace(0.0, (Z_STEPS - 1) / 10, Z_STEPS)`` bit for bit, as XLA
    computes it: i * (stop / (Z_STEPS - 1)) in f32 (the compiler folds the
    written stop * (i / (Z_STEPS - 1)) into that), the stop itself last."""
    stop = np.float32((Z_STEPS - 1) / 10.0)
    delta = stop / np.float32(Z_STEPS - 1)
    return np.append(np.arange(Z_STEPS - 1, dtype=np.float32) * delta, stop).astype(np.float32)


def _area(boxes):
    return (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * (boxes[:, 3] - boxes[:, 1]).clamp(min=0)


def z_search_loss(gt_boxes, centers, dims, poses, z, Ks, im_w, im_h):
    """The depth search: move the cube along z in ``Z_STEPS`` steps of 0.1,
    away from the camera if its projected box is larger than the 2D box,
    towards it otherwise, and take the step whose projected area is nearest
    the 2D box's (the first of equals). All inputs (N, ...); -> (N,) losses,
    half of |z - z_best|, or half of 0.1 ``Z_STEPS`` where the projected
    centre lies more than ``Z_STEPS`` pixels outside the 2D box."""
    n = z.shape[0]
    gt_area = _area(gt_boxes)
    proj0 = project_cube_boxes(centers, dims, poses, Ks, im_w, im_h)
    pred_area = _area(proj0)
    pred_cx = (proj0[:, 0] + proj0[:, 2]) * 0.5
    pred_cy = (proj0[:, 1] + proj0[:, 3]) * 0.5
    within = ((gt_boxes[:, 0] - Z_STEPS <= pred_cx) & (pred_cx <= gt_boxes[:, 2] + Z_STEPS)
              & (gt_boxes[:, 1] - Z_STEPS <= pred_cy) & (pred_cy <= gt_boxes[:, 3] + Z_STEPS))
    steps = _on_device(z_steps, device=z.device)
    direction = torch.where(gt_area < pred_area, 1.0, -1.0)
    z_cand = z[:, None] + direction[:, None] * steps[None, :]  # (N, T)
    # the shifted cubes keep x, y, dimensions and pose; only z moves
    centers_c = torch.cat([centers[:, None, :2].expand(n, Z_STEPS, 2), z_cand[..., None]], dim=-1)
    proj = project_cube_boxes(
        centers_c.reshape(-1, 3), dims.repeat_interleave(Z_STEPS, 0), poses.repeat_interleave(Z_STEPS, 0),
        Ks.repeat_interleave(Z_STEPS, 0), im_w, im_h).reshape(n, Z_STEPS, 4)
    areas = (proj[..., 2] - proj[..., 0]).clamp(min=0) * (proj[..., 3] - proj[..., 1]).clamp(min=0)
    areas = torch.where(areas == 0, 1e7, areas)
    best = torch.argmin((areas - gt_area[:, None]).abs(), dim=1, keepdim=True)
    z_best = torch.take_along_dim(z_cand, best, dim=1)[:, 0]
    loss = (z - z_best).abs()
    return torch.where(within, loss, torch.full_like(loss, 0.1 * Z_STEPS)) / 2.0


def segmentation_loss(corners, masks, h: int, w: int):
    """(N, 8, 2) projected corners at network resolution (an h x w canvas),
    clamped to it, and (N, Hm, Wm) f32 masks -> (N,): the mean over the mask
    grid of the focal loss between each mask and the soft fill of its
    corners' hull on that grid, in the reference's argument order (inputs =
    the mask, targets = the fill)."""
    hm, wm = masks.shape[1:]
    sub = h / hm  # the mask grid's subsampling
    cx = corners[..., 0].clamp(0, w - 1) / sub
    cy = corners[..., 1].clamp(0, h - 1) / sub
    hulls = convex_hull_mask(torch.stack([cx, cy], dim=-1), hm, wm)
    return sigmoid_focal_loss(masks, hulls).mean((1, 2))


def masked_quantile_batch(values, mask, *qs):
    """Row-wise quantiles of the masked entries: values and mask (N, K) ->
    one (N,) per q. The q-quantile is the entry at floor(q * max(n - 1, 0))
    (the index formed in f32) of the row sorted with its masked-out entries
    set to 1e9, n the row's count."""
    ordered = torch.where(mask, values, torch.full_like(values, BIG)).sort(dim=-1).values
    n1 = (mask.sum(-1) - 1).clamp(min=0).to(torch.float32)
    outs = []
    for q in qs:
        idx = (n1 * q).to(torch.int64)  # q rounded to f32, an f32 product
        outs.append(torch.take_along_dim(ordered, idx.clamp(0, values.shape[-1] - 1)[:, None], dim=-1)[:, 0])
    return outs[0] if len(outs) == 1 else tuple(outs)


def masked_quantile(values, mask, q):
    """The q-quantile of ``values[mask]``."""
    return masked_quantile_batch(values.reshape(1, -1), mask.reshape(1, -1), q)[0]


def _grid() -> np.ndarray:
    return (np.arange(BOX_SAMPLE_GRID, dtype=np.float32) + np.float32(0.5)) / np.float32(BOX_SAMPLE_GRID)


def _box_window_indices(boxes, h, w):
    """Per-ROI (N, s) row and column indices of an s x s grid spanning each
    box (s = ``BOX_SAMPLE_GRID``), clamped into the image, and the (N, s, s)
    mask of the samples whose unclamped coordinates lie inside it."""
    t = _on_device(_grid, device=boxes.device)
    ys = boxes[:, 1, None] + t[None, :] * (boxes[:, 3] - boxes[:, 1]).clamp(min=1.0)[:, None]
    xs = boxes[:, 0, None] + t[None, :] * (boxes[:, 2] - boxes[:, 0]).clamp(min=1.0)[:, None]
    valid = ((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :]
    yi = ys.to(torch.int64).clamp(0, h - 1)
    xi = xs.to(torch.int64).clamp(0, w - 1)
    return yi, xi, valid


def _box_window_batch(imgs, img_idx, boxes):
    """(N, s, s) nearest-pixel samples of a (B, H, W) stack on each box's
    grid, ROI n from image ``img_idx[n]``, and the inside-the-image mask.
    Callers AND the mask into their quantile's, so that clamped samples do
    not pile up on the border."""
    h, w = imgs.shape[1:]
    yi, xi, valid = _box_window_indices(boxes, h, w)
    return imgs[img_idx[:, None, None], yi[:, :, None], xi[:, None, :]], valid


def _box_window_batch_masks(masks, img_idx, gt_idx, boxes):
    """``_box_window_batch`` over (B, M, Hm, Wm) ground-truth masks: ROI n
    samples mask ``gt_idx[n]`` of image ``img_idx[n]``."""
    hm, wm = masks.shape[2:]
    yi, xi, valid = _box_window_indices(boxes, hm, wm)
    return masks[img_idx[:, None, None], gt_idx[:, None, None], yi[:, :, None], xi[:, None, :]], valid


class ROIHeads3DScore(ROIHeads3D):
    """Weak-loss ROI heads: the box branch, sampling and pooling of
    ``ROIHeads3D``, and the cube branch trained by the weak loss menu.
    Inference is the parent's."""

    VALID_LOSSES = (
        "dims", "pose_alignment", "pose_ground", "pose_ground2", "iou",
        "segmentation", "z", "z_pseudo_gt_patch", "z_pseudo_gt_center", "depth",
    )

    def __init__(self, cfg, in_channels: int):
        super().__init__(cfg, in_channels)
        unknown = set(cfg.loss_functions) - set(self.VALID_LOSSES)
        if unknown:
            raise ValueError(f"unknown weak losses: {sorted(unknown)}")

    def weak_cube_losses(self, out, sampled: SampledROIs, gt_masks, depth_maps, ground_maps, K_scaled, image_hw,
                         hypotheses):
        """-> (losses, metrics). ``out``: ``cube_forward`` on the foreground
        prefix (B x F rows), ``sampled`` that prefix; gt_masks (B, M, Hm, Wm)
        or None; depth_maps (B, H, W) f32; ground_maps (B, H, W) or None;
        K_scaled (B, 3, 3); image_hw (B, 2); ``hypotheses`` the RANSAC
        hypotheses: a generator, or (B, RANSAC_HYPOTHESES, 3) point indices."""
        ch = self.cfg.model.roi_cube_head
        loss_functions = set(self.cfg.loss_functions)
        b, f = sampled.classes.shape
        n = b * f
        h, w = depth_maps.shape[1:3]
        dev = depth_maps.device
        fg = (sampled.fg & sampled.valid).reshape(-1)
        img_idx = torch.arange(b, device=dev).repeat_interleave(f)

        centers = backproject(out["Ks_per"], out["xy"], out["z"])  # (N, 3)
        dims, poses = out["dims"], out["pose"]
        gt_boxes = sampled.matched_gt_boxes.reshape(-1, 4)
        proj_boxes = project_cube_boxes(centers, dims, poses, out["Ks_per"], w, h)

        per_loss = {}  # name -> ((N,) values, weight)
        if "iou" in loss_functions:
            per_loss["loss_iou"] = (giou_loss(gt_boxes, proj_boxes), ch.loss_w_iou)

        if "pose_alignment" in loss_functions:
            align, has = pose_alignment_loss(poses.reshape(b, f, 3, 3), sampled.fg & sampled.valid)
            # the image-level scalar on every row
            per_loss["loss_pose"] = (torch.where(has, align, torch.zeros_like(align)).expand(n), ch.loss_w_pose)

        if "pose_ground" in loss_functions or "pose_ground2" in loss_functions:
            if isinstance(hypotheses, torch.Generator):
                hypotheses = ransac_hypotheses(hypotheses, b, (h // CLOUD_STRIDE) * (w // CLOUD_STRIDE))
            normals, _, _ = ground_plane_from_depth(hypotheses, depth_maps, K_scaled, ground_maps, valid_hw=image_hw)
            if ground_maps is not None:
                conf = torch.where((ground_maps > 0).flatten(1).any(1), 1.0, 0.1)
            else:
                conf = torch.full((b,), 0.1, device=dev)
            normals_per = normals.repeat_interleave(f, 0)  # (N, 3)
            conf_per = conf.repeat_interleave(f, 0)
            if "pose_ground" in loss_functions:
                pred_normal = poses[:, 1, :]
                cos = (normals_per * pred_normal).sum(-1) / (
                    torch.linalg.vector_norm(normals_per, dim=-1).clamp(min=1e-8)
                    * torch.linalg.vector_norm(pred_normal, dim=-1).clamp(min=1e-8))
                per_loss["loss_normal_vec"] = ((1.0 - cos.abs()) * conf_per, ch.loss_w_normal_vec)
            else:
                ps_rot = normal_to_rotation(normals_per)
                rel = (poses[..., :, None, :] * ps_rot[..., None, :, :]).sum(-1)  # poses @ ps_rot^T
                cos = so3_rotation_angle(rel, cos_angle=True)
                per_loss["loss_normal_vec"] = ((1.0 - cos) * conf_per, ch.loss_w_normal_vec)

        if "z" in loss_functions:
            per_loss["loss_z"] = (
                z_search_loss(gt_boxes, centers, dims, poses, out["z"], out["Ks_per"], w, h), ch.loss_w_z)

        if "z_pseudo_gt_patch" in loss_functions:
            # the median depth inside the projected box, on the 2x-subsampled map
            ds = depth_maps[:, ::2, ::2]
            boxes_cl = torch.stack([proj_boxes[:, 0].clamp(0, w - 1), proj_boxes[:, 1].clamp(0, h - 1),
                                    proj_boxes[:, 2].clamp(0, w - 1), proj_boxes[:, 3].clamp(0, h - 1)], dim=1)
            win, vm = _box_window_batch(ds, img_idx, boxes_cl.detach() / 2.0)
            gt_z = masked_quantile_batch(win.reshape(n, -1), vm.reshape(n, -1), 0.5)
            per_loss["loss_pseudo_gt_z"] = (smooth_l1(out["z"], gt_z.detach()), ch.loss_w_z)
        elif "z_pseudo_gt_center" in loss_functions:
            x = out["xy"][:, 0].detach().clamp(10, w - 11).to(torch.int64)
            y = out["xy"][:, 1].detach().clamp(10, h - 11).to(torch.int64)
            per_loss["loss_pseudo_gt_z"] = (smooth_l1(out["z"], depth_maps[img_idx, y, x].detach()), ch.loss_w_z)

        if "dims" in loss_functions:
            zsc = (dims - out["prior_dims_mean"]).abs() / out["prior_dims_std"].clamp(min=1e-6)
            zsc = (zsc - 1.0).clamp(min=0.0)
            for i, axis in enumerate("whl"):
                per_loss[f"loss_dims_{axis}"] = (zsc[:, i], ch.loss_w_dims)

        if "segmentation" in loss_functions and gt_masks is not None:
            corners = project_points(out["Ks_per"], cuboid_verts(torch.cat([centers, dims], -1), poses))[..., :2]
            masks_per = gt_masks[img_idx, sampled.gt_index.reshape(-1)].float()  # (N, Hm, Wm)
            per_loss["loss_seg"] = (segmentation_loss(corners, masks_per, h, w), ch.loss_w_seg)

        if "depth" in loss_functions:
            corner_z = cuboid_verts(torch.cat([centers, dims], -1), poses)[..., 2]
            pred_range = corner_z.amax(-1) - corner_z.amin(-1)
            dwin, dvm = _box_window_batch(depth_maps[:, ::2, ::2], img_idx, gt_boxes / 2.0)
            if gt_masks is not None:
                # the instance mask sampled on the same grid: quantiles over mask == 1
                hm, wm = gt_masks.shape[2:]
                mask_boxes = torch.stack([gt_boxes[:, 0] * (wm / w), gt_boxes[:, 1] * (hm / h),
                                          gt_boxes[:, 2] * (wm / w), gt_boxes[:, 3] * (hm / h)], dim=1)
                mwin, _ = _box_window_batch_masks(gt_masks, img_idx, sampled.gt_index.reshape(-1), mask_boxes)
                sel = (mwin.float() > 0.5) & dvm
            else:
                sel = dvm
            sel2 = sel.reshape(n, -1)
            q9, q1 = masked_quantile_batch(dwin.reshape(n, -1), sel2, 0.9, 0.1)
            gt_range = torch.where(sel2.any(-1), q9 - q1, torch.zeros_like(q9))
            per_loss["loss_depth"] = (smooth_l1(gt_range.detach(), pred_range), ch.loss_w_depth)

        # ---- reporting, uncertainty scaling, reduction -------------------
        total_report = sum(vals.detach() * wgt for vals, wgt in per_loss.values())
        gt3d = sampled.gt_boxes3d.reshape(-1, 9)
        metrics = {
            "Cube/total_3D_loss": safely_reduce_losses(total_report, fg) * ch.loss_w_3d,
            "Cube/z_error": safely_reduce_losses((out["z"] - gt3d[:, 2]).abs(), fg),
            "Cube/dims_error": safely_reduce_losses((dims - gt3d[:, 3:6]).abs().mean(-1), fg),
            "Cube/xy_error": safely_reduce_losses((out["xy"] - gt3d[:, :2]).abs().mean(-1), fg),
            "Cube/2D IoU": safely_reduce_losses(matched_pairwise_iou(gt_boxes, proj_boxes), fg),
        }
        losses = {}
        uncert_sf = None
        if ch.use_confidence > 0 and out["uncert"] is not None:
            uncert_sf = SQRT_2_CONSTANT * torch.exp(-out["uncert"])
            losses["Cube/uncert"] = ch.use_confidence * safely_reduce_losses(out["uncert"], fg)
            metrics["Cube/conf"] = safely_reduce_losses(torch.exp(-out["uncert"]), fg)
        for name, (vals, wgt) in per_loss.items():
            if uncert_sf is not None:
                vals = vals * uncert_sf
            losses[f"Cube/{name}"] = safely_reduce_losses(vals, fg) * wgt * ch.loss_w_3d
        return losses, metrics

    def forward(self, features, proposals, K, im_scale_ratio, image_hw, gt=None, noise=None, depth_maps=None,
                ground_maps=None, hypotheses=None):
        """Eval: the parent's detections (on ``gt``'s boxes where it is
        given: oracle 2D boxes). Training (``self.training``):
        -> (losses, metrics); ``noise`` feeds the ROI sampler,
        ``hypotheses`` the RANSAC fit (each a generator, or the draws)."""
        if not self.training:
            return super().forward(features, proposals, K, im_scale_ratio, image_hw, gt)
        Ks_scaled, v2r = self.camera(K, im_scale_ratio, image_hw)
        prefix, pooled, losses, metrics = self.sample_and_box_branch(features, proposals, gt, noise)
        if self.has_cube:
            out = self.cube_forward(features, prefix.boxes, prefix.classes, Ks_scaled, v2r, pooled=pooled)
            weak_losses, weak_metrics = self.weak_cube_losses(
                out, prefix, gt.masks, depth_maps, ground_maps, Ks_scaled, image_hw, hypotheses)
            losses.update(weak_losses)
            metrics.update(weak_metrics)
        return losses, metrics
