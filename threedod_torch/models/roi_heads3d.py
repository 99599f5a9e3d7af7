"""ROIHeads3D: 2D box branch + 3D cube branch (counterpart of
``threedod/models/roi_heads3d.py``).

Inference. Box branch: pool the proposals, box head, class-wise NMS over the
top class-flattened candidates, keeping ``max_detections``. Cube branch: pool
the detections, cube head, per-class selection, exp dims priors, allocentric
pose, direct virtual depth, then 3D assembly and geometric-mean score fusion
sqrt(s2d * exp(-uncert)).

Training. Proposals (with the ground-truth boxes appended) are labelled and
subsampled into a fixed (B, roi_batch) block whose leading slots hold the
foreground; the block is pooled once for both branches. Box branch: CE and
smooth-L1 normalised by the sampled count. Cube branch, on the foreground
prefix: disentangled corner losses, chamfer pose, joint loss, each scaled by
the heteroscedastic uncertainty sqrt(2) * exp(-u), and the ``uncert`` penalty.

Only the default cube-head options are ported; others raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..geometry.boxes2d import Box2BoxTransform, clip_boxes
from ..geometry.cuboids import backproject, cuboid_verts
from ..geometry.misc import chamfer_corner_loss, compute_virtual_scale_from_focal_spaces, smooth_l1
from ..geometry.rotations import R_from_allocentric
from ..ops.losses import cross_entropy, safely_reduce_losses, smooth_l1_loss
from ..ops.matcher import gumbel_noise, match_and_ignore, subsample_fg_bg
from ..ops.nms import batched_nms
from ..ops.roi_align_cuda import multilevel_roi_align
from .heads import BoxPredictor, CubeHeadNet, FCStack
from .rpn import Proposals, top_k


SQRT_2_CONSTANT = 1.41421356


class SampledROIs(NamedTuple):
    boxes: torch.Tensor  # (B, S, 4) proposal boxes
    classes: torch.Tensor  # (B, S) gt class (background and empty slots = num_classes)
    fg: torch.Tensor  # (B, S) bool
    valid: torch.Tensor  # (B, S) bool: the slot holds a real candidate
    matched_gt_boxes: torch.Tensor  # (B, S, 4)
    gt_boxes3d: torch.Tensor  # (B, S, 9)
    gt_poses: torch.Tensor  # (B, S, 3, 3)


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, D, 4) image coords
    scores: torch.Tensor  # (B, D) final (3D-fused) scores
    scores_2d: torch.Tensor  # (B, D) 2D classification scores
    classes: torch.Tensor  # (B, D) int64
    valid: torch.Tensor  # (B, D) bool
    center_cam: torch.Tensor  # (B, D, 3)
    dimensions: torch.Tensor  # (B, D, 3)
    pose: torch.Tensor  # (B, D, 3, 3)
    center_2d: torch.Tensor  # (B, D, 2) original-resolution 2D centers
    corners3d: torch.Tensor  # (B, D, 8, 3)


_DEFAULT_CUBE_HEAD = dict(
    shared_fc=True, z_type="direct", pose_type="6d", cluster_bins=1,
    allocentric_pose=True, virtual_depth=True, dims_priors_enabled=True,
    dims_priors_func="exp", scale_roi_boxes=0.0,
    disentangled_loss=True, chamfer_pose=True, inverse_z_weight=False,
)


def check_supported(cfg) -> None:
    ch = cfg.model.roi_cube_head
    for key, want in _DEFAULT_CUBE_HEAD.items():
        if getattr(ch, key) != want:
            raise NotImplementedError(f"roi_cube_head.{key}={getattr(ch, key)!r} is not ported yet (only {want!r})")
    if ch.use_confidence <= 0 or ch.loss_w_3d <= 0:
        raise NotImplementedError("the cube head without confidence or 3D branch is not ported yet")
    if ch.pooler_resolution != cfg.model.roi_box_head.pooler_resolution:
        raise NotImplementedError("cube and box heads pooling at different resolutions is not ported yet")


def scale_Ks(K: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """K at network resolution: K / ratio with K[2, 2] pinned to 1."""
    Ks = K / ratio[:, None, None]
    Ks[:, 2, 2] = 1.0
    return Ks


class ROIHeads3D(nn.Module):
    def __init__(self, cfg, in_channels: int):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        c = cfg.model.roi_heads.num_classes
        self.num_classes = c
        bh, ch = cfg.model.roi_box_head, cfg.model.roi_cube_head
        self.compute_dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32
        self.box_head = FCStack(in_channels * bh.pooler_resolution ** 2, bh.num_fc, bh.fc_dim)
        self.box_predictor = BoxPredictor(bh.fc_dim, c)
        self.cube_head = CubeHeadNet(in_channels * ch.pooler_resolution ** 2, c, ch.num_fc, ch.fc_dim)
        self.priors_dims_per_cat = nn.Parameter(torch.ones(1, c, 2, 3))
        self.priors_z_scales = nn.Parameter(torch.ones(c, 1))
        self.priors_z_stats = nn.Parameter(torch.ones(c, 1, 2))
        self.transform = Box2BoxTransform(weights=(10.0, 10.0, 5.0, 5.0))

    def _pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor, resolution: int) -> torch.Tensor:
        """(B, N, 4) boxes -> (B, N, S, S, C) f32, pooled at the model dtype."""
        sampling = max(self.cfg.model.roi_box_head.pooler_sampling_ratio, 2)
        feats = {k: v.to(self.compute_dtype) for k, v in features.items()}
        return multilevel_roi_align(feats, boxes.contiguous(), resolution, sampling).float()

    def label_and_sample(self, proposals: Proposals, gt, noise) -> SampledROIs:
        """Label the proposals (ground-truth boxes appended) against the
        ground truth and subsample ``roi_batch`` of them per image.
        ``noise`` is a ``torch.Generator`` or the Gumbel noise itself,
        (foreground, background), each (B, K + M)."""
        cfg = self.cfg
        rh = cfg.model.roi_heads
        b, k = proposals.scores.shape
        n_cand = k + gt.boxes2d.shape[1]
        if isinstance(noise, torch.Generator):
            noise = tuple(gumbel_noise(noise, (b, n_cand), proposals.boxes.device) for _ in range(2))
        rows = []
        for i in range(b):
            gtb, gtc, gtv = gt.boxes2d[i], gt.classes[i], gt.valid[i]
            valid_gt = gtv & (gtc >= 0)
            cand = torch.cat([proposals.boxes[i], gtb], dim=0)  # proposal_append_gt
            cand_valid = torch.cat([proposals.valid[i], valid_gt], dim=0)
            m, in_ignore = match_and_ignore(
                gtb, valid_gt, gtv & (gtc < 0), cand,
                bg_thresh=rh.iou_thresholds[0], fg_thresh=rh.iou_thresholds[1],
                ignore_thresh=cfg.model.rpn.ignore_threshold,
            )
            labels = torch.where(cand_valid, m.matched_labels, torch.full_like(m.matched_labels, -1))
            labels = torch.where(in_ignore & (labels == 0), torch.full_like(labels, -1), labels)
            idx, is_fg, sel_valid = subsample_fg_bg(
                (noise[0][i], noise[1][i]), labels, m.matched_ious, cfg.shapes.roi_batch, rh.positive_fraction,
            )
            midx = m.matched_idxs[idx]
            bg = torch.full_like(midx, self.num_classes)
            classes = torch.where(is_fg & sel_valid, gtc[midx].long(), bg)
            rows.append(SampledROIs(
                boxes=cand[idx], classes=classes, fg=is_fg, valid=sel_valid,
                matched_gt_boxes=gtb[midx], gt_boxes3d=gt.boxes3d[i][midx], gt_poses=gt.poses[i][midx],
            ))
        return SampledROIs(*(torch.stack(field) for field in zip(*rows)))

    def box_branch_train(self, sampled: SampledROIs, pooled: torch.Tensor):
        """CE over the sampled slots and smooth-L1 on the foreground's
        deltas of its gt class, both normalised by the sampled count."""
        b, s = sampled.classes.shape
        nc = self.num_classes
        scores, deltas = self.box_predictor(self.box_head(pooled.flatten(0, 1), self.compute_dtype))
        classes = sampled.classes.reshape(-1)
        valid = sampled.valid.reshape(-1)
        fg = sampled.fg.reshape(-1)

        loss_cls = cross_entropy(scores, classes, mask=valid)
        cls_idx = classes.clamp(0, nc - 1)
        fg_deltas = deltas.reshape(b * s, nc, 4)[torch.arange(b * s, device=cls_idx.device), cls_idx]
        gt_deltas = self.transform.get_deltas(
            sampled.boxes.reshape(-1, 4), sampled.matched_gt_boxes.reshape(-1, 4)).detach()
        reg = smooth_l1_loss(fg_deltas, gt_deltas).sum(-1)
        loss_reg = (reg * fg).sum() / valid.sum().clamp(min=1.0)
        return {"BoxHead/loss_cls": loss_cls, "BoxHead/loss_box_reg": loss_reg}

    def box_branch_inference(self, features, proposals: Proposals, image_hw):
        """-> (boxes (B, D, 4), scores (B, D), classes (B, D), valid (B, D))."""
        cfg = self.cfg
        b, k = proposals.scores.shape
        nc = self.num_classes
        pooled = self._pool(features, proposals.boxes, cfg.model.roi_box_head.pooler_resolution)
        scores, deltas = self.box_predictor(self.box_head(pooled.flatten(0, 1), self.compute_dtype))
        probs = torch.softmax(scores, dim=-1)[:, :-1].reshape(b, k * nc)
        boxes = self.transform.apply_deltas(deltas, proposals.boxes.reshape(-1, 4)).reshape(b, k * nc, 4)

        cand = min(cfg.shapes.nms_candidates, k * nc)
        d = cfg.shapes.max_detections
        valid = (
            proposals.valid.repeat_interleave(nc, dim=1)
            & (probs > cfg.model.roi_heads.score_thresh_test)
            & torch.isfinite(boxes).all(-1)
        )
        masked = torch.where(valid, probs, torch.full_like(probs, float("-inf")))
        top_s, top_i = top_k(masked, cand)
        top_boxes = torch.gather(boxes, 1, top_i[..., None].expand(b, cand, 4))
        hw = image_hw.float()
        top_boxes = clip_boxes(top_boxes, hw[:, 0, None], hw[:, 1, None])
        top_cls = top_i % nc
        keep = batched_nms(top_boxes, top_s, top_cls, cfg.model.roi_heads.nms_thresh_test,
                           valid=torch.isfinite(top_s))
        kept = torch.where(keep, top_s, torch.full_like(top_s, float("-inf")))
        fin_s, fin_i = top_k(kept, d)
        det_valid = torch.isfinite(fin_s)
        return (
            torch.gather(top_boxes, 1, fin_i[..., None].expand(b, d, 4)),
            torch.where(det_valid, fin_s, torch.zeros_like(fin_s)),
            torch.gather(top_cls, 1, fin_i),
            det_valid,
        )

    def cube_forward(self, features, boxes, box_classes, Ks_scaled, v2r, pooled=None) -> Dict[str, torch.Tensor]:
        """``pooled`` is the precomputed pool of ``boxes`` where the caller
        has one (the training path pools once for both branches)."""
        ch = self.cfg.model.roi_cube_head
        b, n = box_classes.shape
        if pooled is None:
            pooled = self._pool(features, boxes, ch.pooler_resolution)
        deltas2d, z_raw, dims_raw, pose_raw, uncert_raw = self.cube_head(pooled.flatten(0, 1), self.compute_dtype)

        cls = box_classes.reshape(-1).clamp(0, self.num_classes - 1)
        rows = torch.arange(b * n, device=cls.device)
        cube_2d_deltas = deltas2d[rows, cls]  # (BN, 2)
        cube_dims_norm = dims_raw[rows, cls]  # (BN, 3)
        cube_pose = pose_raw[rows, cls]  # (BN, 3, 3)
        cube_uncert = uncert_raw[rows, cls]
        cube_z = z_raw[rows, cls]

        src = boxes.reshape(-1, 4)
        src_w = src[:, 2] - src[:, 0]
        src_h = src[:, 3] - src[:, 1]
        cube_x = src[:, 0] + 0.5 * src_w + src_w * cube_2d_deltas[:, 0]
        cube_y = src[:, 1] + 0.5 * src_h + src_h * cube_2d_deltas[:, 1]

        prior_mean = self.priors_dims_per_cat.detach()[0][cls][:, 0]  # (BN, 3)
        cube_dims = torch.exp(cube_dims_norm.clamp(max=5.0)) * prior_mean

        Ks_per = Ks_scaled.repeat_interleave(n, dim=0)  # (BN, 3, 3)
        cube_pose = R_from_allocentric(Ks_per, cube_pose, cube_x.detach(), cube_y.detach())
        v2r_per = v2r.repeat_interleave(n, dim=0)
        cube_z = cube_z * v2r_per
        return {
            "xy": torch.stack([cube_x, cube_y], dim=1),
            "z": cube_z,
            "dims": cube_dims,
            "pose": cube_pose,
            "uncert": cube_uncert,
            "Ks_per": Ks_per,
        }

    def cube_losses(self, out, gt_boxes3d, gt_poses, mask):
        """Disentangled corner losses over (BN,) rows; ``mask`` marks the
        sampled foreground. Each term swaps one predicted quantity into the
        ground-truth box and compares corners."""
        ch = self.cfg.model.roi_cube_head
        Ks = out["Ks_per"]
        gt_2d, gt_z, gt_dims = gt_boxes3d[:, :2], gt_boxes3d[:, 2], gt_boxes3d[:, 3:6]
        gt_3d = backproject(Ks, gt_2d, gt_z)
        gt_box3d = torch.cat([gt_3d, gt_dims], dim=1)
        gt_corners = cuboid_verts(gt_box3d, gt_poses)
        n = gt_z.shape[0]

        def corner_l1(box3d, pose):
            return smooth_l1(cuboid_verts(box3d, pose), gt_corners).reshape(n, -1).mean(1)

        loss_z = corner_l1(torch.cat([backproject(Ks, gt_2d, out["z"]), gt_dims], dim=1), gt_poses)
        loss_xy = corner_l1(torch.cat([backproject(Ks, out["xy"], gt_z), gt_dims], dim=1), gt_poses)
        loss_pose = chamfer_corner_loss(cuboid_verts(gt_box3d, out["pose"]), gt_corners)
        loss_dims = corner_l1(torch.cat([gt_3d, out["dims"]], dim=1), gt_poses)
        loss_joint = None
        if ch.loss_w_joint > 0:
            joint = torch.cat([backproject(Ks, out["xy"], out["z"]), out["dims"]], dim=1)
            loss_joint = chamfer_corner_loss(cuboid_verts(joint, out["pose"]), gt_corners)

        total = (loss_dims * ch.loss_w_dims + loss_pose * ch.loss_w_pose
                 + loss_xy * ch.loss_w_xy + loss_z * ch.loss_w_z)
        metrics = {
            "Cube/z_error": safely_reduce_losses((out["z"] - gt_z).abs(), mask),
            "Cube/dims_error": safely_reduce_losses((out["dims"] - gt_dims).abs().mean(-1), mask),
            "Cube/xy_error": safely_reduce_losses((out["xy"] - gt_2d).abs().mean(-1), mask),
            "Cube/total_3D_loss": safely_reduce_losses(total.detach(), mask) * ch.loss_w_3d,
            "Cube/conf": safely_reduce_losses(torch.exp(-out["uncert"]), mask),
        }
        uncert_sf = SQRT_2_CONSTANT * torch.exp(-out["uncert"])
        w3d = ch.loss_w_3d
        losses = {"Cube/uncert": ch.use_confidence * safely_reduce_losses(out["uncert"], mask)}
        if ch.loss_w_dims > 0:
            losses["Cube/loss_dims"] = safely_reduce_losses(loss_dims * uncert_sf, mask) * ch.loss_w_dims * w3d
        losses["Cube/loss_xy"] = safely_reduce_losses(loss_xy * uncert_sf, mask) * ch.loss_w_xy * w3d
        losses["Cube/loss_z"] = safely_reduce_losses(loss_z * uncert_sf, mask) * ch.loss_w_z * w3d
        losses["Cube/loss_pose"] = safely_reduce_losses(loss_pose * uncert_sf, mask) * ch.loss_w_pose * w3d
        if loss_joint is not None:
            losses["Cube/loss_joint"] = safely_reduce_losses(loss_joint * uncert_sf, mask) * ch.loss_w_joint * w3d
        return losses, metrics

    def forward_train(self, features, proposals: Proposals, gt, Ks_scaled, v2r, noise):
        """-> (losses, metrics). One pool serves both branches: the cube
        branch takes the foreground prefix of the block the box branch pools."""
        cfg = self.cfg
        with torch.no_grad(), record_function("roi/label+sample"):
            sampled = self.label_and_sample(proposals, gt, noise)
        with record_function("roi/pool"):
            pooled = self._pool(features, sampled.boxes, cfg.model.roi_box_head.pooler_resolution)
        losses = self.box_branch_train(sampled, pooled)
        b = sampled.fg.shape[0]
        metrics = {
            "roi/num_fg": sampled.fg.sum() / b,
            "roi/num_bg": (sampled.valid & ~sampled.fg).sum() / b,
        }
        # foreground fills the leading prefix (subsample_fg_bg's contract)
        f = int(cfg.shapes.roi_batch * cfg.model.roi_heads.positive_fraction)
        out = self.cube_forward(features, sampled.boxes[:, :f], sampled.classes[:, :f], Ks_scaled, v2r,
                                pooled=pooled[:, :f])
        cube_losses, cube_metrics = self.cube_losses(
            out, sampled.gt_boxes3d[:, :f].reshape(-1, 9), sampled.gt_poses[:, :f].reshape(-1, 3, 3),
            (sampled.fg[:, :f] & sampled.valid[:, :f]).reshape(-1),
        )
        losses.update(cube_losses)
        metrics.update(cube_metrics)
        return losses, metrics

    def assemble_detections(self, boxes, scores_2d, classes, valid, out, im_scale_ratio) -> Detections:
        """3D fields + geometric-mean score fusion sqrt(s2d * exp(-uncert))."""
        b, d = classes.shape
        center = backproject(out["Ks_per"], out["xy"], out["z"]).reshape(b, d, 3)
        dims = out["dims"].reshape(b, d, 3)
        pose = out["pose"].reshape(b, d, 3, 3)
        conf = torch.exp(-out["uncert"]).reshape(b, d)
        scores = torch.sqrt((scores_2d * conf).clamp(min=0.0))
        return Detections(
            boxes=boxes,
            scores=torch.where(valid, scores, torch.zeros_like(scores)),
            scores_2d=scores_2d,
            classes=classes,
            valid=valid,
            center_cam=center,
            dimensions=dims,
            pose=pose,
            center_2d=out["xy"].reshape(b, d, 2) * im_scale_ratio[:, None, None],
            corners3d=cuboid_verts(torch.cat([center, dims], dim=-1), pose),
        )

    def forward(self, features, proposals: Proposals, K, im_scale_ratio, image_hw, gt=None, noise=None):
        """Eval: -> Detections. Training (``self.training``, with ``gt`` and
        ``noise``): -> (losses, metrics)."""
        ch = self.cfg.model.roi_cube_head
        Ks_scaled = scale_Ks(K, im_scale_ratio)
        im_h_net = image_hw[:, 0].float()
        v2r = compute_virtual_scale_from_focal_spaces(
            K[:, 1, 1], im_h_net * im_scale_ratio, ch.virtual_focal, im_h_net
        )
        if self.training:
            return self.forward_train(features, proposals, gt, Ks_scaled, v2r, noise)
        boxes, scores_2d, classes, valid = self.box_branch_inference(features, proposals, image_hw)
        out = self.cube_forward(features, boxes, classes, Ks_scaled, v2r)
        return self.assemble_detections(boxes, scores_2d, classes, valid, out, im_scale_ratio)
