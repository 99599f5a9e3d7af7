"""BoxNet: a 2D detector and the propose-and-score 3D stage (counterpart of
``threedod/models/boxnet.py``, after cubercnn's rcnn3d.py:594-892).

The reference boxes are the ground truth's 2D boxes (GT mode), or the 2D
detector's (PRED mode: trunk + FPN, RPN, the ROI heads' box branch, whose
pooling is kernel K1 on the card, then a class-agnostic NMS at 0.5 and the
top 20 by a stable sort). Each box then gets ``number_of_proposals`` cubes
from a sampler and the best by the combined score (``boxer.propose_and_score``).
The parameters carry ``RCNN3D``'s names (``backbone``,
``proposal_generator.rpn_head``, ``roi_heads``), so the JAX BoxNet's variables
load through ``utils.convert_weights.from_jax_variables`` and a Cube R-CNN
state dict loads as it is; GT mode reads none of them.

The reference's PRED path calls the RPN head with an undefined ``train``
(``threedod/models/boxnet.py:61``); the head runs in inference mode here, as
the rest of that path does.
"""
from __future__ import annotations

from typing import Union

import torch

from ..data.batch import Batch, normalize_image
from ..ops.nms import batched_nms
from ..structures.cubes import Cubes
from .boxer import BoxerDraws, BoxerOutput, box_fill_masks, propose_and_score
from .meta_arch import RCNN3D
from .roi_heads3d import Detections, scale_Ks
from .rpn import top_k

MAX_PRED_BOXES = 20  # reference boxes an image in PRED mode
PRED_NMS_THRESH = 0.5  # the class-agnostic NMS over the detector's boxes


class BoxNet(RCNN3D):
    def __init__(self, cfg):
        super().__init__(cfg)
        c = cfg.model.roi_heads.num_classes
        # (C, 2, 3): each category's dimension means and deviations; set_prior_dims fills it
        self.register_buffer("prior_dims", torch.ones(c, 2, 3), persistent=False)

    @torch.no_grad()
    def set_prior_dims(self, priors: dict) -> None:
        """``prior_dims`` from ``data.priors.compute_priors``'s dict."""
        self.prior_dims.copy_(torch.tensor(priors["priors_dims_per_cat"], dtype=torch.float32))

    def predict_2d_boxes(self, batch: Batch):
        """Backbone -> RPN -> box branch -> class-agnostic NMS -> top
        ``MAX_PRED_BOXES``: (boxes (B, K, 4) at network resolution, scores
        (B, K), classes (B, K), valid (B, K))."""
        c = self.cfg.model
        x = normalize_image(batch.image, c, batch.image_hw).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        feats = self.backbone(x)
        proposals = self.proposal_generator(feats, batch.image_hw)
        roi_feats = {f: feats[f] for f in c.roi_heads.in_features}
        boxes, scores, classes, valid = self.roi_heads.box_branch_inference(roi_feats, proposals, batch.image_hw)
        keep = batched_nms(boxes, scores, torch.zeros_like(classes), PRED_NMS_THRESH, valid=valid)
        top_s, idx = top_k(torch.where(keep, scores, torch.full_like(scores, float("-inf"))), MAX_PRED_BOXES)
        ok = torch.isfinite(top_s)
        return (torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4)),
                torch.where(ok, top_s, torch.zeros_like(top_s)), torch.gather(classes, 1, idx), ok)

    def score_inputs(self, batch: Batch, use_pred_boxes: bool = False, with_iou3d: bool = True, masks=None):
        """-> (the keyword arguments ``propose_and_score`` takes for ``batch``
        besides the draws and the sampler, boxes (B, K, 4), classes (B, K),
        valid (B, K)); see ``forward``."""
        Ks = scale_Ks(batch.K.float(), batch.im_scale_ratio)
        h, w = batch.image.shape[1:3]
        if use_pred_boxes:
            boxes, _, classes, valid = self.predict_2d_boxes(batch)
            gt_cubes = None
        else:
            g = batch.gt
            boxes = g.boxes2d
            classes = g.classes.long().clamp(min=0)
            valid = g.valid & (g.classes >= 0)
            gt_cubes = torch.cat([g.boxes3d[..., 6:9], g.boxes3d[..., 3:6], g.poses.flatten(-2)], dim=-1)
        prior = self.prior_dims[classes]  # (B, K, 2, 3)
        depth = batch.depth_map.float() if batch.depth_map is not None else torch.full(
            (batch.image.shape[0], h, w), 3.0, device=batch.image.device)
        kwargs = dict(
            boxes=boxes, masks=box_fill_masks(boxes, h, w) if masks is None else masks.float(),
            prior_means=prior[..., 0, :], prior_stds=prior[..., 1, :], depth_maps=depth, K_scaled=Ks,
            im_shape=(w, h), number_of_proposals=self.cfg.model.roi_cube_head.number_of_proposals,
            ground_maps=None if batch.ground_map is None else batch.ground_map.float(),
            gt_cubes=gt_cubes if with_iou3d else None, valid_hw=batch.image_hw)
        return kwargs, boxes, classes, valid

    def forward(self, batch: Batch, proposal_function: str = "propose", use_pred_boxes: bool = False,
                with_iou3d: bool = True, masks=None, *, draws: Union[torch.Generator, BoxerDraws]):
        """Propose and score every image of ``batch`` -> (BoxerOutput, boxes
        (B, K, 4), classes (B, K), valid (B, K)). GT mode reads
        ``batch.gt``, and scores IoU3D against its cubes when
        ``with_iou3d``; ``masks`` (B, K, H, W) at network resolution, one a
        reference box (SAM's; the loader's uint8 is cast to f32), else the
        filled boxes; the depth map defaults to 3 m everywhere. ``draws`` is
        a generator or the variates (``boxer.BoxerDraws``)."""
        kwargs, boxes, classes, valid = self.score_inputs(batch, use_pred_boxes, with_iou3d, masks)
        return propose_and_score(draws, proposal_function, **kwargs), boxes, classes, valid

    @staticmethod
    def to_detections(out: BoxerOutput, boxes, classes, valid, im_scale_ratio) -> Detections:
        """The best cube of each reference box as detections (reference
        :643-660): 2D boxes and centres at the original resolution, the
        combined score as both scores."""
        best = out.best_cubes
        b, n = classes.shape
        ratio = im_scale_ratio[:, None, None]
        scores = torch.where(valid, out.best_scores, torch.zeros_like(out.best_scores))
        return Detections(
            boxes=boxes * ratio, scores=scores, scores_2d=scores, classes=classes, valid=valid,
            center_cam=best[..., :3], dimensions=best[..., 3:6], pose=best[..., 6:].reshape(b, n, 3, 3),
            center_2d=(boxes[..., :2] + boxes[..., 2:]) * 0.5 * ratio, corners3d=Cubes(best).get_all_corners(),
        )
