"""Region Proposal Network (counterpart of ``threedod/models/rpn.py``).

Proposals, per (image, level): pre-NMS top-k of the objectness logits,
deltas applied to offset-0 anchors, clipping, NMS; then a global post-NMS
top-k. Every top-k is a stable descending sort, so equal scores keep index
order as JAX's ``lax.top_k`` does (``torch.topk`` promises no tie order).

Training: anchors are labelled against the ground truth with ignore regions,
subsampled with IoU weights, the best anchor of every ground-truth box is
kept as foreground, and the losses are the IoUness objectness (BCE against
the matched IoU, weighted by it) and the IoU-weighted smooth-L1 on the
deltas. Proposals are constants for the ROI heads.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..geometry.boxes2d import Box2BoxTransform, clip_boxes
from ..ops.losses import binary_cross_entropy_with_logits, smooth_l1_loss
from ..ops.matcher import gumbel_noise, match_and_ignore, subsample_fg_bg
from ..ops.nms import nms_sorted
from ..ops import fused_conv
from ..ops.roi_align import STRIDES
from .backbones.layers import conv


def generate_anchors(
    feature_shapes: Dict[str, Tuple[int, int]],
    strides: Dict[str, int],
    sizes: Dict[str, Tuple[int, ...]],
    aspect_ratios: Tuple[float, ...],
) -> Dict[str, np.ndarray]:
    """Dense anchors per level, (H*W*A, 4) XYXY in (h, w, a) order, centred
    at stride * i (detectron2's DefaultAnchorGenerator with offset 0)."""
    out = {}
    for name, (h, w) in feature_shapes.items():
        stride = strides[name]
        cell = []
        for size in sizes[name]:
            area = float(size) ** 2
            for ar in aspect_ratios:
                cw = np.sqrt(area / ar)
                ch = ar * cw
                cell.append([-cw / 2.0, -ch / 2.0, cw / 2.0, ch / 2.0])
        cell = np.asarray(cell, np.float32)  # (A, 4)
        xs = np.arange(w, dtype=np.float32) * stride
        ys = np.arange(h, dtype=np.float32) * stride
        gx, gy = np.meshgrid(xs, ys)
        shifts = np.stack([gx, gy, gx, gy], axis=-1).reshape(-1, 1, 4)
        out[name] = (shifts + cell[None]).reshape(-1, 4)
    return out


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last dim, ties in index order (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness and anchor-delta predictors
    (detectron2 StandardRPNHead names)."""

    def __init__(self, in_channels: int, num_anchors: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, features: Dict[str, torch.Tensor]):
        """-> logits {name: (B, H*W*A)}, deltas {name: (B, H*W*A, 4)}, at the
        features' dtype, in (h, w, a) order."""
        logits, regs = {}, {}
        if not self.training and fused_conv.fused_conv_available():
            # kernel K7 on every level: the two 1x1 predictors packed into
            # one matrix, objectness channels first
            a = self.num_anchors
            wh = torch.cat([self.objectness_logits.weight, self.anchor_deltas.weight], dim=0)
            bh = torch.cat([self.objectness_logits.bias, self.anchor_deltas.bias])
            for name, f in features.items():
                out = fused_conv.fused_conv_relu_head(f, self.conv.weight, self.conv.bias, wh, bh)
                out = out.permute(0, 2, 3, 1)  # (B, H, W, A * 5), the kernel's own layout
                b = out.shape[0]
                logits[name] = out[..., :a].reshape(b, -1)
                regs[name] = out[..., a:].reshape(b, -1, 4)
            return logits, regs
        for name, f in features.items():
            t = F.relu(conv(f, self.conv))
            b = t.shape[0]
            logits[name] = conv(t, self.objectness_logits).permute(0, 2, 3, 1).reshape(b, -1)
            regs[name] = conv(t, self.anchor_deltas).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return logits, regs


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (B, K, 4)
    scores: torch.Tensor  # (B, K) objectness logits
    valid: torch.Tensor  # (B, K) bool


class RPN(nn.Module):
    """Holds ``rpn_head`` (d2 ``proposal_generator``) and selects proposals."""

    def __init__(self, cfg, in_channels: int):
        super().__init__()
        r = cfg.model.rpn
        self.cfg_rpn = r
        self.in_features: List[str] = list(r.in_features)
        self.num_anchors = len(r.aspect_ratios) * len(r.anchor_sizes[0])
        self.rpn_head = RPNHead(in_channels, self.num_anchors)
        self.transform = Box2BoxTransform()

    def anchors(self, feature_shapes: Dict[str, Tuple[int, int]], device) -> Dict[str, torch.Tensor]:
        r = self.cfg_rpn
        sizes = {f: r.anchor_sizes[i] for i, f in enumerate(self.in_features)}
        anchors = generate_anchors(feature_shapes, STRIDES, sizes, r.aspect_ratios)
        return {f: torch.from_numpy(a).to(device) for f, a in anchors.items()}

    def predict_proposals(self, logits, regs, image_hw: torch.Tensor, anchors, train: bool = False) -> Proposals:
        r = self.cfg_rpn
        pre_k = r.pre_nms_topk_train if train else r.pre_nms_topk_test
        post_k = r.post_nms_topk_train if train else r.post_nms_topk_test
        k_max = max(min(pre_k, logits[f].shape[1]) for f in self.in_features)
        hw = image_hw.float()
        all_boxes, all_scores, all_valid = [], [], []
        for f in self.in_features:
            lg, rg = logits[f], regs[f]
            b = lg.shape[0]
            k = min(pre_k, lg.shape[1])
            scores, idx = top_k(lg, k)
            scores = scores.float()
            deltas = torch.gather(rg, 1, idx[..., None].expand(b, k, 4)).float()
            boxes = self.transform.apply_deltas(deltas, anchors[f][idx])
            boxes = clip_boxes(boxes, hw[:, 0, None], hw[:, 1, None])
            valid = (
                (boxes[..., 2] - boxes[..., 0] > r.min_box_size)
                & (boxes[..., 3] - boxes[..., 1] > r.min_box_size)
                & torch.isfinite(boxes).all(-1)
                & torch.isfinite(scores)
            )
            if k < k_max:  # pad short levels with rows that can neither keep nor suppress
                boxes = F.pad(boxes, (0, 0, 0, k_max - k))
                scores = F.pad(scores, (0, k_max - k), value=float("-inf"))
                valid = F.pad(valid, (0, k_max - k), value=False)
            all_boxes.append(boxes)
            all_scores.append(scores)
            all_valid.append(valid)
        boxes = torch.stack(all_boxes, 1)  # (B, L, K, 4)
        scores = torch.stack(all_scores, 1)
        valid = torch.stack(all_valid, 1)
        b = boxes.shape[0]
        # per-(image, level) NMS in score-sorted space; the stable sort and
        # the level-ordered concat make the global top-k's index tie-break
        # pick what the original-order formulation picks
        sboxes, skey, keep = nms_sorted(boxes, scores, r.nms_thresh, valid=valid)
        sboxes = sboxes.reshape(b, -1, 4)
        masked = torch.where(keep, skey, torch.full_like(skey, float("-inf"))).reshape(b, -1)
        top_scores, top_idx = top_k(masked, post_k)
        top_boxes = torch.gather(sboxes, 1, top_idx[..., None].expand(b, post_k, 4))
        return Proposals(boxes=top_boxes, scores=top_scores, valid=torch.isfinite(top_scores))

    def losses_and_proposals(self, logits, regs, gt, image_hw, anchors, noise):
        """Training: -> (proposals, losses, metrics).

        ``gt`` is the batch's GroundTruth. ``noise`` is a ``torch.Generator``
        or the Gumbel noise itself, (foreground, background), each (B, R)
        over the concatenated anchors."""
        r = self.cfg_rpn
        logits_cat = torch.cat([logits[f] for f in self.in_features], dim=1).float()
        regs_cat = torch.cat([regs[f] for f in self.in_features], dim=1).float()
        anchors_cat = torch.cat([anchors[f] for f in self.in_features], dim=0)
        b, n_anchors = logits_cat.shape
        if isinstance(noise, torch.Generator):
            noise = tuple(gumbel_noise(noise, (b, n_anchors), logits_cat.device) for _ in range(2))

        labels, matched_gt, matched_ious = [], [], []
        with torch.no_grad(), record_function("rpn/label+sample"):
            for i in range(b):
                gtb, gtc, gtv = gt.boxes2d[i], gt.classes[i], gt.valid[i]
                m, in_ignore = match_and_ignore(
                    gtb, gtv & (gtc >= 0), gtv & (gtc < 0), anchors_cat,
                    bg_thresh=r.iou_thresholds[0], fg_thresh=r.iou_thresholds[1],
                    ignore_thresh=r.ignore_threshold, allow_low_quality=True,
                )
                idx, _, sel_valid = subsample_fg_bg(
                    (noise[0][i], noise[1][i]), m.matched_labels, m.matched_ious,
                    r.batch_size_per_image, r.positive_fraction,
                )
                sampled = sel_valid.new_zeros(n_anchors).index_put_((idx,), sel_valid)
                lab = torch.where(sampled, m.matched_labels, torch.full_like(m.matched_labels, -1))
                # each gt's best anchors stay foreground even if the sampler dropped them
                lab = torch.where(m.forced, torch.ones_like(lab), lab)
                # ignore regions apply after sampling
                lab = torch.where(in_ignore & (lab == 0), torch.full_like(lab, -1), lab)
                labels.append(lab)
                matched_gt.append(gtb[m.matched_idxs])
                matched_ious.append(m.matched_ious)
            labels = torch.stack(labels)
            matched_ious = torch.stack(matched_ious)
            gt_deltas = self.transform.get_deltas(anchors_cat.expand(b, -1, -1), torch.stack(matched_gt))

        fg = labels == 1
        normalizer = r.batch_size_per_image * b
        if r.objectness_uncertainty.lower() != "none":
            # IoUness: BCE against the matched IoU, weighted by it, foreground only
            conf = binary_cross_entropy_with_logits(logits_cat, matched_ious)
            objectness_loss = (conf * matched_ious * fg).sum()
            reg = smooth_l1_loss(regs_cat, gt_deltas).sum(-1)
            localization_loss = (reg * matched_ious * fg).sum()
        else:
            objectness_loss = (
                binary_cross_entropy_with_logits(logits_cat, fg.float()) * (labels >= 0)
            ).sum()
            localization_loss = (smooth_l1_loss(regs_cat, gt_deltas).sum(-1) * fg).sum()
        losses = {
            "rpn/cls": objectness_loss / normalizer * r.loss_weight_cls,
            "rpn/loc": localization_loss / normalizer * r.loss_weight_loc,
        }
        metrics = {
            "rpn/num_pos_anchors": fg.sum() / b,
            "rpn/num_neg_anchors": (labels == 0).sum() / b,
        }
        with torch.no_grad(), record_function("rpn/proposals"):  # constants for the ROI heads
            proposals = self.predict_proposals(
                {f: t.detach() for f, t in logits.items()}, {f: t.detach() for f, t in regs.items()},
                image_hw, anchors, train=True,
            )
        return proposals, losses, metrics

    def forward(self, features: Dict[str, torch.Tensor], image_hw: torch.Tensor, gt=None, noise=None):
        """Eval: -> Proposals. Training (``self.training``, with ``gt`` and
        ``noise``): -> (Proposals, losses, metrics)."""
        feats = {f: features[f] for f in self.in_features}
        logits, regs = self.rpn_head(feats)
        shapes = {f: (t.shape[2], t.shape[3]) for f, t in feats.items()}
        anchors = self.anchors(shapes, image_hw.device)
        if self.training:
            return self.losses_and_proposals(logits, regs, gt, image_hw, anchors, noise)
        return self.predict_proposals(logits, regs, image_hw, anchors)
