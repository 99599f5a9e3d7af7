"""RCNN3D (supervised Cube R-CNN), inference and training forward
(counterpart of ``threedod/models/meta_arch.py``).

normalize -> trunk (``cfg.model.backbone``) + FPN -> RPN proposals -> ROIHeads3D, with detectron2's
``GeneralizedRCNN`` module names (``backbone``, ``proposal_generator``,
``roi_heads``), so a d2-layout state dict loads as it is.

On a CUDA device the trunk runs in ``torch.channels_last``: the FPN levels
then sit in memory as (B, H, W, C), which is the layout the ROIAlign kernel
reads, with no copy. The training forward marks its three stages with
``record_function`` (a no-op outside a profiler), which
``threedod_torch/train/profile.py`` reads.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..data.batch import Batch, normalize_image
from .backbones.fpn import build_backbone
from .backbones.layers import BatchNorm2d
from .roi_heads3d import ROIHeads3D
from .rpn import RPN


class RCNN3D(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg.model
        self.cfg = cfg
        self.backbone = build_backbone(c.backbone, c.fpn_out_channels)
        self.proposal_generator = RPN(cfg, c.fpn_out_channels)
        self.roi_heads = ROIHeads3D(cfg, c.fpn_out_channels)

    def forward(self, batch: Batch, noise=None):
        """Eval: -> Detections (callers run it under ``torch.inference_mode``).

        Training (``self.training``): -> (losses, metrics), two dicts of
        scalars; ``batch.gt`` must be set. ``noise`` feeds the two
        subsamplers: a ``torch.Generator``, or the Gumbel noise itself as
        ``{"rpn": (fg, bg), "roi": (fg, bg)}``, each (B, candidates)."""
        c = self.cfg.model
        x = normalize_image(batch.image, c, batch.image_hw).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        with record_function("trunk+fpn"):
            feats = self.backbone(x)
        roi_feats = {f: feats[f] for f in c.roi_heads.in_features}
        if self.training:
            if isinstance(noise, torch.Generator):
                noise = {"rpn": noise, "roi": noise}
            with record_function("rpn"):
                proposals, rpn_losses, rpn_metrics = self.proposal_generator(
                    feats, batch.image_hw, batch.gt, noise["rpn"])
            with record_function("roi_heads"):
                losses, metrics = self.roi_heads(
                    roi_feats, proposals, batch.K, batch.im_scale_ratio, batch.image_hw, batch.gt, noise["roi"],
                )
            losses.update(rpn_losses)
            metrics.update(rpn_metrics)
            return losses, metrics
        proposals = self.proposal_generator(feats, batch.image_hw)
        det = self.roi_heads(roi_feats, proposals, batch.K, batch.im_scale_ratio, batch.image_hw)
        # rescale 2D boxes to the original image resolution (GeneralizedRCNN
        # _postprocess)
        return det._replace(boxes=det.boxes * batch.im_scale_ratio[:, None, None])


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX package's initialisers: lecun
    normal convs (zero bias), identity BatchNorm, xavier-uniform fc layers,
    normal(0.01) class scores, normal(0.001) box and cube outputs with the
    cube head's reference bias constants (depth 1, uncertainty 5), unit
    priors. Draws are made on the CPU, so a seed gives the same weights on
    every device."""
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.Linear):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "cls_score":
                w = torch.randn(m.weight.shape, generator=generator) * 0.01
            elif leaf == "bbox_pred" or leaf.startswith("bbox_3D"):
                w = torch.randn(m.weight.shape, generator=generator) * 0.001
            else:
                bound = math.sqrt(6.0 / (m.in_features + m.out_features))
                w = (torch.rand(m.weight.shape, generator=generator) * 2 - 1) * bound
            m.weight.copy_(w)
            m.bias.fill_({"bbox_3D_center_depth": 1.0, "bbox_3D_uncertainty": 5.0}.get(leaf, 0.0))
    for p in ("priors_dims_per_cat", "priors_z_scales", "priors_z_stats"):
        getattr(model.roi_heads, p).fill_(1.0)


def build_model(cfg, seed: int | None = None) -> RCNN3D:
    """Registry-style constructor of the model over ``cfg.model.backbone``
    (any trunk family ``backbones.fpn.build_backbone`` knows); ``seed`` gives
    the seeded initialisation."""
    if cfg.model.meta_architecture != "RCNN3D":
        raise NotImplementedError(f"meta architecture '{cfg.model.meta_architecture}' is not ported yet")
    model = RCNN3D(cfg)
    init_weights(model, torch.Generator().manual_seed(cfg.seed if seed is None else seed))
    return model.eval()
