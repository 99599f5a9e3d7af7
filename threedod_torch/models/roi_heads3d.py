"""ROIHeads3D: 2D box branch + 3D cube branch (counterpart of
``threedod/models/roi_heads3d.py``).

Inference. Box branch: pool the proposals, box head, class-wise NMS over the
top class-flattened candidates, keeping ``max_detections``. Cube branch: pool
the detections, cube head, per-class selection (and the depth bin nearest
the box's 2D scale), dimensions from the category priors (exp or scaled
sigmoid), allocentric or egocentric pose, depth (direct, sigmoid, log or
clusters, virtual or real), then 3D assembly and, with a confidence output,
geometric-mean score fusion sqrt(s2d * exp(-uncert)).

Training. Proposals (with the ground-truth boxes appended) are labelled and
subsampled into a fixed (B, roi_batch) block whose leading slots hold the
foreground; the block is pooled once for the box branch, and the cube
branch reads that pool's foreground prefix unless it pools its own boxes
(``scale_roi_boxes`` > 0, or a cube pooler resolution other than the box
head's). Box branch: CE and smooth-L1 normalised by the sampled count. Cube
branch, on the foreground prefix: disentangled corner losses (or direct
losses on each output), chamfer or smooth-L1 pose, joint loss, optionally
weighted by 1 / log(z), each scaled by the heteroscedastic uncertainty
sqrt(2) * exp(-u), and the ``uncert`` penalty.

With ``loss_w_3d`` 0 there is no cube branch (the 2D-only ablation): no
cube parameters, box losses only, and detections whose 3D fields are zero.
Every option of ``roi_cube_head`` is ported. With oracle 2D boxes
(``forward`` given ``gt`` at inference) the box branch is bypassed: the
detections are the valid ground-truth boxes with scores of 1 and their
classes (an ignore region's -1 clamped to 0, and not valid), and the cube
branch runs on them.

Under a process group every loss and metric is this rank's share of the
global batch's: its rows' sum over the global count (``ops.losses``,
``parallel.dist``), and the sampler's noise is this rank's rows of the
global batch's draw.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..geometry.boxes2d import Box2BoxTransform, clip_boxes
from ..geometry.cuboids import backproject, cuboid_verts
from ..geometry.misc import chamfer_corner_loss, compute_virtual_scale_from_focal_spaces, scaled_sigmoid, smooth_l1
from ..geometry.rotations import R_from_allocentric, R_to_allocentric, so3_relative_angle
from ..ops.losses import cross_entropy, safely_reduce_losses, smooth_l1_loss
from ..ops.matcher import gumbel_noise, match_and_ignore, subsample_fg_bg
from ..ops.nms import batched_nms
from ..ops.roi_align_cuda import multilevel_roi_align
from ..parallel import dist
from .heads import BoxPredictor, CubeHeadNet, FCStack
from .rpn import Proposals, top_k


E_CONSTANT = 2.71828183
SQRT_2_CONSTANT = 1.41421356


class SampledROIs(NamedTuple):
    boxes: torch.Tensor  # (B, S, 4) proposal boxes
    classes: torch.Tensor  # (B, S) gt class (background and empty slots = num_classes)
    fg: torch.Tensor  # (B, S) bool
    valid: torch.Tensor  # (B, S) bool: the slot holds a real candidate
    matched_gt_boxes: torch.Tensor  # (B, S, 4)
    gt_boxes3d: torch.Tensor  # (B, S, 9)
    gt_poses: torch.Tensor  # (B, S, 3, 3)
    gt_index: torch.Tensor  # (B, S) matched ground-truth slot (the weak losses' mask lookup)


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


def scale_Ks(K: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """K at network resolution: K / ratio with K[2, 2] pinned to 1."""
    Ks = K / ratio[:, None, None]
    Ks[:, 2, 2] = 1.0
    return Ks


class ROIHeads3D(nn.Module):
    def __init__(self, cfg, in_channels: int):
        super().__init__()
        self.cfg = cfg
        c = cfg.model.roi_heads.num_classes
        self.num_classes = c
        bh, ch = cfg.model.roi_box_head, cfg.model.roi_cube_head
        self.compute_dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32
        self.box_head = FCStack(in_channels * bh.pooler_resolution ** 2, bh.num_fc, bh.fc_dim)
        self.box_predictor = BoxPredictor(bh.fc_dim, c)
        self.transform = Box2BoxTransform(weights=(10.0, 10.0, 5.0, 5.0))
        self.has_cube = ch.loss_w_3d > 0
        if self.has_cube:
            self.cube_head = CubeHeadNet(in_channels * ch.pooler_resolution ** 2, c, ch.num_fc, ch.fc_dim,
                                         shared_fc=ch.shared_fc, pose_type=ch.pose_type,
                                         cluster_bins=ch.cluster_bins, use_confidence=ch.use_confidence)
            bins = max(ch.cluster_bins, 1)
            self.priors_dims_per_cat = nn.Parameter(torch.ones(1, c, 2, 3))
            self.priors_z_scales = nn.Parameter(torch.ones(c, bins))
            self.priors_z_stats = nn.Parameter(torch.ones(c, bins, 2))
        # the cube branch reads the box branch's pool of its boxes unless it pools its own
        self.reuse_pool = ch.scale_roi_boxes <= 0 and ch.pooler_resolution == bh.pooler_resolution

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
        if isinstance(noise, torch.Generator):  # the global batch's draw, this rank's rows
            noise = tuple(dist.local_rows(gumbel_noise(noise, (dist.global_batch(b), n_cand), proposals.boxes.device))
                          for _ in range(2))
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
                gt_index=midx,
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
        loss_reg = (reg * fg).sum() / dist.all_sum(valid.sum()).clamp(min=1.0)
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
        """The cube head on (B, N) boxes and their classes -> per-row (BN)
        outputs and the intermediates the losses read. ``pooled`` is the
        box branch's pool of ``boxes`` where the caller has one and the cube
        branch pools the same (``reuse_pool``); else the boxes (scaled by
        ``scale_roi_boxes`` when it is set) are pooled here."""
        ch = self.cfg.model.roi_cube_head
        b, n = box_classes.shape
        if pooled is None:
            boxes_scaled = boxes
            if ch.scale_roi_boxes > 0:
                ctr = (boxes[..., :2] + boxes[..., 2:]) * 0.5
                half = (boxes[..., 2:] - boxes[..., :2]) * 0.5 * ch.scale_roi_boxes
                boxes_scaled = torch.cat([ctr - half, ctr + half], dim=-1)
            pooled = self._pool(features, boxes_scaled, ch.pooler_resolution)
        deltas2d, z_raw, dims_raw, pose_raw, uncert_raw = self.cube_head(pooled.flatten(0, 1), self.compute_dtype)

        cls = box_classes.reshape(-1).clamp(0, self.num_classes - 1)
        rows = torch.arange(b * n, device=cls.device)
        cube_2d_deltas = deltas2d[rows, cls]  # (BN, 2)
        cube_dims_norm = dims_raw[rows, cls]  # (BN, 3)
        cube_pose = pose_raw[rows, cls]  # (BN, 3, 3)
        cube_uncert = None if uncert_raw is None else uncert_raw[rows, cls]

        src = boxes.reshape(-1, 4)
        src_w = src[:, 2] - src[:, 0]
        src_h = src[:, 3] - src[:, 1]
        src_cx = src[:, 0] + 0.5 * src_w
        src_cy = src[:, 1] + 0.5 * src_h
        cube_x = src_cx + src_w * cube_2d_deltas[:, 0]
        cube_y = src_cy + src_h * cube_2d_deltas[:, 1]

        aux = {}
        if ch.cluster_bins > 1:  # the depth of the bin whose 2D scale is nearest the box's (the first of equals)
            src_scales = torch.sqrt(src_w * src_w + src_h * src_h)
            assign = (self.priors_z_scales.detach()[cls] - src_scales[:, None]).abs().argmin(dim=1)
            cube_z = z_raw.reshape(b * n, -1, self.num_classes)[rows, assign, cls]
            z_stats = self.priors_z_stats.detach()[cls][rows, assign]  # (BN, 2)
            aux["z_means"], aux["z_stds"] = z_stats[:, 0], z_stats[:, 1]
        else:
            cube_z = z_raw[rows, cls]

        if ch.dims_priors_enabled:
            prior = self.priors_dims_per_cat.detach()[0][cls]  # (BN, 2, 3)
            prior_mean, prior_std = prior[:, 0], prior[:, 1]
            aux["prior_dims_mean"], aux["prior_dims_std"] = prior_mean, prior_std
            if ch.dims_priors_func == "sigmoid":
                cube_dims = scaled_sigmoid(cube_dims_norm, min=(prior_mean - 3 * prior_std).clamp(min=0.0),
                                           max=prior_mean + 3 * prior_std)
            else:
                cube_dims = torch.exp(cube_dims_norm.clamp(max=5.0)) * prior_mean
        else:
            cube_dims = torch.exp(cube_dims_norm.clamp(max=5.0))

        Ks_per = Ks_scaled.repeat_interleave(n, dim=0)  # (BN, 3, 3)
        if ch.allocentric_pose:
            aux["pose_allocentric"] = cube_pose
            cube_pose = R_from_allocentric(Ks_per, cube_pose, cube_x.detach(), cube_y.detach())

        z_norm = cube_z
        if ch.z_type == "sigmoid":
            z_norm = torch.sigmoid(cube_z)
            cube_z = z_norm * 100.0
        elif ch.z_type == "log":
            cube_z = torch.exp(cube_z)
        elif ch.z_type == "clusters":
            cube_z = scaled_sigmoid(cube_z, min=(aux["z_means"] - 3 * aux["z_stds"]).clamp(min=0.0),
                                    max=aux["z_means"] + 3 * aux["z_stds"])
        aux["z_norm"] = z_norm

        v2r_per = v2r.repeat_interleave(n, dim=0)
        if ch.virtual_depth:
            cube_z = cube_z * v2r_per
        return {
            "xy": torch.stack([cube_x, cube_y], dim=1),
            "z": cube_z,
            "dims": cube_dims,
            "dims_norm": cube_dims_norm,
            "deltas_2d": cube_2d_deltas,
            "pose": cube_pose,
            "uncert": cube_uncert,
            "Ks_per": Ks_per,
            "v2r": v2r_per,
            "src_cxcy": torch.stack([src_cx, src_cy], dim=1),
            "src_wh": torch.stack([src_w, src_h], dim=1),
            **aux,
        }

    def cube_losses(self, out, gt_boxes3d, gt_poses, mask):
        """The cube losses over (BN,) rows; ``mask`` marks the sampled
        foreground. Disentangled: each term swaps one predicted quantity into
        the ground-truth box and compares corners; otherwise each output is
        held to its own target."""
        ch = self.cfg.model.roi_cube_head
        Ks = out["Ks_per"]
        gt_2d, gt_z, gt_dims = gt_boxes3d[:, :2], gt_boxes3d[:, 2], gt_boxes3d[:, 3:6]
        gt_3d = backproject(Ks, gt_2d, gt_z)
        gt_box3d = torch.cat([gt_3d, gt_dims], dim=1)
        gt_corners = cuboid_verts(gt_box3d, gt_poses)
        n = gt_z.shape[0]

        def corner_l1(box3d, pose):
            return smooth_l1(cuboid_verts(box3d, pose), gt_corners).reshape(n, -1).mean(1)

        if ch.disentangled_loss:
            loss_z = corner_l1(torch.cat([backproject(Ks, gt_2d, out["z"]), gt_dims], dim=1), gt_poses)
            loss_xy = corner_l1(torch.cat([backproject(Ks, out["xy"], gt_z), gt_dims], dim=1), gt_poses)
            if ch.chamfer_pose:
                loss_pose = chamfer_corner_loss(cuboid_verts(gt_box3d, out["pose"]), gt_corners)
            else:
                loss_pose = corner_l1(gt_box3d, out["pose"])
            loss_dims = corner_l1(torch.cat([gt_3d, out["dims"]], dim=1), gt_poses)
        else:
            loss_xy = smooth_l1(out["deltas_2d"], (gt_2d - out["src_cxcy"]) / out["src_wh"]).mean(1)
            dims_ratio = gt_dims.clamp(min=1e-6)
            if ch.dims_priors_enabled:
                dims_ratio = dims_ratio / out["prior_dims_mean"].clamp(min=1e-6)
            loss_dims = smooth_l1(out["dims_norm"], torch.log(dims_ratio)).mean(1)
            if ch.allocentric_pose:
                x, y = out["xy"][:, 0].detach(), out["xy"][:, 1].detach()
                loss_pose = 1 - so3_relative_angle(out["pose_allocentric"], R_to_allocentric(Ks, gt_poses, x, y),
                                                   cos_angle=True)
            else:
                loss_pose = 1 - so3_relative_angle(out["pose"], gt_poses, cos_angle=True)
            gt_z_virtual = gt_z * (1.0 / out["v2r"])
            if ch.z_type == "direct":
                loss_z = smooth_l1(out["z"], gt_z)
            elif ch.z_type == "sigmoid":
                loss_z = smooth_l1(out["z_norm"], (gt_z_virtual / 100.0).clamp(0, 1))
            elif ch.z_type == "log":
                loss_z = smooth_l1(out["z_norm"], torch.log(gt_z_virtual.clamp(min=0.01)))
            else:  # clusters
                loss_z = smooth_l1(out["z_norm"], (gt_z_virtual - out["z_means"]) / out["z_stds"].clamp(min=1e-6))
        loss_joint = None
        if ch.loss_w_joint > 0:
            joint = torch.cat([backproject(Ks, out["xy"], out["z"]), out["dims"]], dim=1)
            if ch.chamfer_pose and ch.disentangled_loss:
                loss_joint = chamfer_corner_loss(cuboid_verts(joint, out["pose"]), gt_corners)
            else:
                loss_joint = corner_l1(joint, out["pose"])

        total = (loss_dims * ch.loss_w_dims + loss_pose * ch.loss_w_pose
                 + loss_xy * ch.loss_w_xy + loss_z * ch.loss_w_z)
        metrics = {
            "Cube/z_error": safely_reduce_losses((out["z"] - gt_z).abs(), mask),
            "Cube/dims_error": safely_reduce_losses((out["dims"] - gt_dims).abs().mean(-1), mask),
            "Cube/xy_error": safely_reduce_losses((out["xy"] - gt_2d).abs().mean(-1), mask),
            "Cube/total_3D_loss": safely_reduce_losses(total.detach(), mask) * ch.loss_w_3d,
        }
        factors = []  # applied in the JAX package's order: 1 / log(z), then the uncertainty
        if ch.inverse_z_weight:
            factors.append(1.0 / torch.log(gt_z.clamp(min=E_CONSTANT)))
        losses = {}
        if ch.use_confidence > 0 and out["uncert"] is not None:
            factors.append(SQRT_2_CONSTANT * torch.exp(-out["uncert"]))
            losses["Cube/uncert"] = ch.use_confidence * safely_reduce_losses(out["uncert"], mask)
            metrics["Cube/conf"] = safely_reduce_losses(torch.exp(-out["uncert"]), mask)

        def reduce(values, weight):
            for f in factors:
                values = values * f
            return safely_reduce_losses(values, mask) * weight * ch.loss_w_3d

        if ch.loss_w_dims > 0:
            losses["Cube/loss_dims"] = reduce(loss_dims, ch.loss_w_dims)
        losses["Cube/loss_xy"] = reduce(loss_xy, ch.loss_w_xy)
        losses["Cube/loss_z"] = reduce(loss_z, ch.loss_w_z)
        losses["Cube/loss_pose"] = reduce(loss_pose, ch.loss_w_pose)
        if loss_joint is not None:
            losses["Cube/loss_joint"] = reduce(loss_joint, ch.loss_w_joint)
        return losses, metrics

    def sample_and_box_branch(self, features, proposals: Proposals, gt, noise):
        """Label and sample the ROIs, pool them once and run the box branch.
        -> (the foreground prefix of the sampled block, the box branch's pool
        of it where the cube branch reads that pool (``reuse_pool``, else
        None: the cube branch pools its own boxes), the box losses, the
        sampling metrics)."""
        cfg = self.cfg
        with torch.no_grad(), record_function("roi/label+sample"):
            sampled = self.label_and_sample(proposals, gt, noise)
        with record_function("roi/pool"):
            pooled = self._pool(features, sampled.boxes, cfg.model.roi_box_head.pooler_resolution)
        losses = self.box_branch_train(sampled, pooled)
        b = dist.global_batch(sampled.fg.shape[0])
        metrics = {
            "roi/num_fg": sampled.fg.sum() / b,
            "roi/num_bg": (sampled.valid & ~sampled.fg).sum() / b,
        }
        # foreground fills the leading prefix (subsample_fg_bg's contract)
        f = int(cfg.shapes.roi_batch * cfg.model.roi_heads.positive_fraction)
        prefix_pool = pooled[:, :f] if self.reuse_pool else None
        return SampledROIs(*(t[:, :f] for t in sampled)), prefix_pool, losses, metrics

    def forward_train(self, features, proposals: Proposals, gt, Ks_scaled, v2r, noise):
        """-> (losses, metrics)."""
        prefix, pooled, losses, metrics = self.sample_and_box_branch(features, proposals, gt, noise)
        if self.has_cube:
            out = self.cube_forward(features, prefix.boxes, prefix.classes, Ks_scaled, v2r, pooled=pooled)
            cube_losses, cube_metrics = self.cube_losses(
                out, prefix.gt_boxes3d.reshape(-1, 9), prefix.gt_poses.reshape(-1, 3, 3),
                (prefix.fg & prefix.valid).reshape(-1),
            )
            losses.update(cube_losses)
            metrics.update(cube_metrics)
        return losses, metrics

    @staticmethod
    def box_detections(boxes, scores_2d, classes, valid) -> Detections:
        """The box branch's detections with zero 3D fields and identity poses
        (the 2D-only head's, and those the cube branch fills in)."""
        b, d = classes.shape
        zeros = boxes.new_zeros((b, d, 3))
        return Detections(
            boxes=boxes, scores=scores_2d, scores_2d=scores_2d, classes=classes, valid=valid,
            center_cam=zeros, dimensions=zeros,
            pose=torch.eye(3, dtype=boxes.dtype, device=boxes.device).expand(b, d, 3, 3),
            center_2d=boxes.new_zeros((b, d, 2)), corners3d=boxes.new_zeros((b, d, 8, 3)),
        )

    def oracle_detections(self, gt) -> Detections:
        """The ground-truth boxes as detections (oracle 2D boxes): score and
        2D score 1 on a valid non-ignore slot, classes clamped at 0."""
        valid = gt.valid & (gt.classes >= 0)
        ones = valid.to(gt.boxes2d.dtype)
        return self.box_detections(gt.boxes2d, ones, gt.classes.clamp(min=0).long(), valid)

    def assemble_detections(self, det: Detections, out, im_scale_ratio) -> Detections:
        """3D fields, and with a confidence output the geometric-mean score
        fusion sqrt(s2d * exp(-uncert))."""
        b, d = det.classes.shape
        center = backproject(out["Ks_per"], out["xy"], out["z"]).reshape(b, d, 3)
        dims = out["dims"].reshape(b, d, 3)
        pose = out["pose"].reshape(b, d, 3, 3)
        scores = det.scores_2d
        if out["uncert"] is not None:
            scores = torch.sqrt((scores * torch.exp(-out["uncert"]).reshape(b, d)).clamp(min=0.0))
        return det._replace(
            scores=torch.where(det.valid, scores, torch.zeros_like(scores)),
            center_cam=center,
            dimensions=dims,
            pose=pose,
            center_2d=out["xy"].reshape(b, d, 2) * im_scale_ratio[:, None, None],
            corners3d=cuboid_verts(torch.cat([center, dims], dim=-1), pose),
        )

    def camera(self, K, im_scale_ratio, image_hw):
        """(K at network resolution (B, 3, 3), the virtual-depth scale (B,),
        1 without virtual depth)."""
        ch = self.cfg.model.roi_cube_head
        if not ch.virtual_depth:
            return scale_Ks(K, im_scale_ratio), torch.ones_like(im_scale_ratio)
        im_h_net = image_hw[:, 0].float()
        v2r = compute_virtual_scale_from_focal_spaces(K[:, 1, 1], im_h_net * im_scale_ratio, ch.virtual_focal,
                                                      im_h_net)
        return scale_Ks(K, im_scale_ratio), v2r

    def forward(self, features, proposals: Proposals, K, im_scale_ratio, image_hw, gt=None, noise=None):
        """Eval: -> Detections, on ``gt``'s boxes where it is given (oracle
        2D boxes; ``proposals`` are then not read). Training
        (``self.training``, with ``gt`` and ``noise``): -> (losses, metrics)."""
        Ks_scaled, v2r = self.camera(K, im_scale_ratio, image_hw)
        if self.training:
            return self.forward_train(features, proposals, gt, Ks_scaled, v2r, noise)
        if gt is not None:
            det = self.oracle_detections(gt)
        else:
            det = self.box_detections(*self.box_branch_inference(features, proposals, image_hw))
        if not self.has_cube:
            return det
        out = self.cube_forward(features, det.boxes, det.classes, Ks_scaled, v2r)
        return self.assemble_detections(det, out, im_scale_ratio)
