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
    ROI_HEADS = ROIHeads3D
    NOISE_KEYS = ("rpn", "roi")  # the training forward's sources of randomness

    def __init__(self, cfg):
        super().__init__()
        c = cfg.model
        self.cfg = cfg
        self.backbone = build_backbone(c.backbone, c.fpn_out_channels)
        self.proposal_generator = RPN(cfg, c.fpn_out_channels)
        self.roi_heads = self.ROI_HEADS(cfg, c.fpn_out_channels)

    def roi_heads_train(self, roi_feats, proposals, batch: Batch, noise):
        return self.roi_heads(roi_feats, proposals, batch.K, batch.im_scale_ratio, batch.image_hw, batch.gt,
                              noise["roi"])

    def forward(self, batch: Batch, noise=None, oracle: bool = False):
        """Eval: -> Detections (callers run it under ``torch.inference_mode``).
        With ``oracle`` the cube head runs on ``batch.gt``'s 2D boxes and the
        RPN and the box branch are bypassed (their outputs would not be read).

        Training (``self.training``): -> (losses, metrics), two dicts of
        scalars; ``batch.gt`` must be set. ``noise`` feeds the two
        subsamplers: a ``torch.Generator``, or the Gumbel noise itself as
        ``{"rpn": (fg, bg), "roi": (fg, bg)}``, each (B, candidates) (a
        model with more sources, ``NOISE_KEYS``, takes more keys)."""
        c = self.cfg.model
        x = normalize_image(batch.image, c, batch.image_hw).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        with record_function("trunk+fpn"):
            feats = self.backbone(x)
        roi_feats = {f: feats[f] for f in c.roi_heads.in_features}
        if self.training:
            if isinstance(noise, torch.Generator):
                noise = dict.fromkeys(self.NOISE_KEYS, noise)
            with record_function("rpn"):
                proposals, rpn_losses, rpn_metrics = self.proposal_generator(
                    feats, batch.image_hw, batch.gt, noise["rpn"])
            with record_function("roi_heads"):
                losses, metrics = self.roi_heads_train(roi_feats, proposals, batch, noise)
            losses.update(rpn_losses)
            metrics.update(rpn_metrics)
            return losses, metrics
        if oracle:
            det = self.roi_heads(roi_feats, None, batch.K, batch.im_scale_ratio, batch.image_hw, batch.gt)
        else:
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
    priors (``build_model`` sets computed ones). Draws are made on the CPU,
    so a seed gives the same weights on every device."""
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
    if model.roi_heads.has_cube:
        for p in ("priors_dims_per_cat", "priors_z_scales", "priors_z_stats"):
            getattr(model.roi_heads, p).fill_(1.0)


@torch.no_grad()
def set_priors(model: RCNN3D, priors: dict) -> None:
    """The cube head's priors from ``data.priors.compute_priors``'s dict, as
    the JAX ``ROIHeads3D(priors=...)`` builds them: the dimension priors
    (1, C, 2, 3) where ``dims_priors_enabled``, the depth bins' 2D scales
    (C, bins) and depth statistics (C, bins, 2) where there is more than one
    bin; the others stay 1. A head without a cube branch has none."""
    heads, ch = model.roi_heads, model.cfg.model.roi_cube_head
    if not heads.has_cube:
        return
    if ch.dims_priors_enabled:
        heads.priors_dims_per_cat.copy_(torch.tensor(priors["priors_dims_per_cat"], dtype=torch.float32)[None])
    if ch.cluster_bins > 1 and priors["priors_bins"]:
        heads.priors_z_scales.copy_(torch.tensor([p[1] for p in priors["priors_bins"]], dtype=torch.float32))
        heads.priors_z_stats.copy_(torch.tensor([p[2] for p in priors["priors_bins"]], dtype=torch.float32))


def build_model(cfg, seed: int | None = None, priors: dict | None = None) -> RCNN3D:
    """Registry-style constructor of the model ``cfg.model.meta_architecture``
    names (``RCNN3D``, weak Cube R-CNN's ``RCNN3DCombined`` or the
    propose-and-score ``BoxNet``, which have the same parameters) over
    ``cfg.model.backbone`` (any trunk family
    ``backbones.fpn.build_backbone`` knows); ``seed`` gives the seeded
    initialisation, ``priors`` (``data.priors.compute_priors``) the ROI heads'
    priors."""
    arch = cfg.model.meta_architecture
    if arch == "RCNN3D":
        model = RCNN3D(cfg)
    elif arch == "RCNN3DCombined":
        from .weak_arch import RCNN3DCombined

        model = RCNN3DCombined(cfg)
    elif arch == "BoxNet":
        from .boxnet import BoxNet

        model = BoxNet(cfg)
    else:
        raise NotImplementedError(f"meta architecture '{arch}' is not ported yet")
    init_weights(model, torch.Generator().manual_seed(cfg.seed if seed is None else seed))
    if priors is not None:
        set_priors(model, priors)
        if arch == "BoxNet":
            model.set_prior_dims(priors)
    return model.eval()
