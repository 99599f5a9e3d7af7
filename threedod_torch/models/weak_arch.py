"""RCNN3DCombined: weak Cube R-CNN (counterpart of
``threedod/models/weak_arch.py``, after cubercnn's RCNN3D_combined_features).

The skeleton and the parameters of ``RCNN3D``; in training the batch's depth
and ground maps go to the weak ROI heads (``ROIHeads3DScore``), and at
inference the model is ``RCNN3D``. A batch without a depth map is given a
depth of 3 everywhere. The reference's depth-feature concatenation onto the
FPN levels is dead code there and is not ported.
"""
from __future__ import annotations

import torch

from ..data.batch import Batch
from .meta_arch import RCNN3D
from .weak_heads import ROIHeads3DScore


class RCNN3DCombined(RCNN3D):
    # the ROI sampler's noise and the RANSAC fit's hypotheses each have a key;
    # a generator feeds all three
    NOISE_KEYS = ("rpn", "roi", "ransac")
    ROI_HEADS = ROIHeads3DScore

    def roi_heads_train(self, roi_feats, proposals, batch: Batch, noise):
        if batch.depth_map is None:
            h, w = batch.image.shape[1:3]
            depth = torch.full((batch.image.shape[0], h, w), 3.0, device=batch.image.device)
        else:
            depth = batch.depth_map.float()
        ground = None if batch.ground_map is None else batch.ground_map.float()
        return self.roi_heads(roi_feats, proposals, batch.K, batch.im_scale_ratio, batch.image_hw, batch.gt,
                              noise["roi"], depth_maps=depth, ground_maps=ground, hypotheses=noise["ransac"])
