"""Static-shape batch contract as torch tensors (counterpart of
``threedod/data/batch.py``).

Every image is padded to one (canvas_h, canvas_w) canvas; ``image_hw`` holds
each image's valid extent inside it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class GroundTruth(NamedTuple):
    """Padded per-image ground truth. ``boxes2d`` are XYXY at network
    resolution; ``boxes3d`` rows are [u, v, z, w3d, h3d, l3d, x3d, y3d, z3d]
    (u, v at network resolution); ``classes`` is the contiguous category id,
    or -1 for an ignore region; ``valid`` marks slots that hold a real
    annotation (ignores included), padding is False."""

    boxes2d: torch.Tensor  # (B, M, 4)
    classes: torch.Tensor  # (B, M) int32
    boxes3d: torch.Tensor  # (B, M, 9)
    poses: torch.Tensor  # (B, M, 3, 3)
    valid: torch.Tensor  # (B, M) bool
    masks: Optional[torch.Tensor] = None  # (B, M, H/4, W/4) uint8 instance masks (the weak path's)

    def to(self, device) -> "GroundTruth":
        return GroundTruth(*(None if t is None else t.to(device) for t in self))


class Batch(NamedTuple):
    image: torch.Tensor  # (B, H, W, 3): uint8 raw, or float already normalised
    image_hw: torch.Tensor  # (B, 2) int32 valid extent inside the canvas
    K: torch.Tensor  # (B, 3, 3) original intrinsics
    im_scale_ratio: torch.Tensor  # (B,) original_height / network_height
    image_id: torch.Tensor  # (B,) int32
    gt: Optional[GroundTruth] = None
    # the weak path's maps on the canvas: depth in metres stored as float16
    # (the JAX package's wire format; the model casts it back to f32), ground
    # 0/1 as uint8
    depth_map: Optional[torch.Tensor] = None  # (B, H, W) float16
    ground_map: Optional[torch.Tensor] = None  # (B, H, W) uint8

    def to(self, device) -> "Batch":
        return Batch(*(None if t is None else t.to(device) for t in self))


def collate(samples: list, max_gt: int, device=None) -> Batch:
    """Mapper samples -> one padded Batch (counterpart of the JAX ``collate``):
    ground truth in ``max_gt`` slots, padding with class -1, identity poses
    and ``valid`` False; annotations past ``max_gt`` are dropped. The images
    are stacked where the mapper left them; everything lands on ``device``
    (default: the images' device). Samples with ``gt_masks`` give uint8
    masks (> 0.5) in the same slots, and samples with depth and ground maps
    give them stacked, as float16 and uint8 (the weak path's)."""
    b = len(samples)
    image = torch.stack([s["image"] for s in samples])
    device = image.device if device is None else torch.device(device)
    image_hw = np.stack([s["image_hw"] for s in samples]).astype(np.int32)
    K = np.stack([s["K"] for s in samples]).astype(np.float32)
    ratio = np.asarray([s["im_scale_ratio"] for s in samples], np.float32)
    image_id = np.asarray([s.get("image_id", -1) for s in samples], np.int32)

    gt = None
    if "gt_boxes2d" in samples[0]:
        boxes2d = np.zeros((b, max_gt, 4), np.float32)
        classes = np.full((b, max_gt), -1, np.int32)
        boxes3d = np.zeros((b, max_gt, 9), np.float32)
        poses = np.tile(np.eye(3, dtype=np.float32), (b, max_gt, 1, 1))
        valid = np.zeros((b, max_gt), bool)
        for i, s in enumerate(samples):
            n = min(len(s["gt_boxes2d"]), max_gt)
            if n:
                boxes2d[i, :n] = s["gt_boxes2d"][:n]
                classes[i, :n] = s["gt_classes"][:n]
                boxes3d[i, :n] = s["gt_boxes3d"][:n]
                poses[i, :n] = s["gt_poses"][:n]
                valid[i, :n] = True
        masks = None
        if samples[0].get("gt_masks") is not None:
            hm, wm = samples[0]["gt_masks"].shape[1:]
            masks = np.zeros((b, max_gt, hm, wm), np.uint8)
            for i, s in enumerate(samples):
                n = min(len(s["gt_masks"]), max_gt)
                if n:
                    masks[i, :n] = np.asarray(s["gt_masks"][:n]) > 0.5
            masks = torch.from_numpy(masks)
        gt = GroundTruth(*(torch.from_numpy(a) for a in (boxes2d, classes, boxes3d, poses, valid)), masks).to(device)
    maps = {}
    for key, dtype in (("depth_map", torch.float16), ("ground_map", torch.uint8)):
        if samples[0].get(key) is not None:
            maps[key] = torch.stack([torch.as_tensor(s[key]).to(device) for s in samples]).to(dtype)
    return Batch(
        image=image.to(device),
        image_hw=torch.from_numpy(image_hw).to(device),
        K=torch.from_numpy(K).to(device),
        im_scale_ratio=torch.from_numpy(ratio).to(device),
        image_id=torch.from_numpy(image_id).to(device),
        gt=gt,
        **maps,
    )


def synthetic_train_batch(cfg, batch_size: int, seed: int = 3, num_valid: int = 6) -> Batch:
    """A seeded training batch on the CPU, made with numpy: normalised noise
    images filling the canvas, a 530 px focal length, and ``max_gt`` ground
    truth slots per image of which the first ``num_valid`` are valid (boxes
    of 40..160 px in the left upper half, depths 2..6, dimensions 0.3..1.3,
    identity poses). The layout the JAX package's training benchmark uses."""
    rng = np.random.RandomState(seed)
    b, h, w = batch_size, cfg.shapes.canvas_height, cfg.shapes.canvas_width
    m, nc = cfg.shapes.max_gt, cfg.model.roi_heads.num_classes
    image = rng.randn(b, h, w, 3).astype(np.float32)
    K = np.tile(np.array([[[530.0, 0, w / 2], [0, 530.0, h / 2], [0, 0, 1]]], np.float32), (b, 1, 1))
    xy = rng.uniform(10, w // 2, (b, m, 2)).astype(np.float32)
    wh = rng.uniform(40, 160, (b, m, 2)).astype(np.float32)
    classes = rng.randint(0, nc, (b, m)).astype(np.int32)
    boxes3d = np.concatenate(
        [xy + wh / 2, 2 + rng.rand(b, m, 1) * 4, 0.3 + rng.rand(b, m, 3), rng.randn(b, m, 3)], -1
    ).astype(np.float32)
    n = min(num_valid, m)
    gt = GroundTruth(
        boxes2d=torch.from_numpy(np.concatenate([xy, xy + wh], -1)),
        classes=torch.from_numpy(classes),
        boxes3d=torch.from_numpy(boxes3d),
        poses=torch.eye(3).expand(b, m, 3, 3).contiguous(),
        valid=torch.from_numpy(np.tile([True] * n + [False] * (m - n), (b, 1))),
    )
    return Batch(
        image=torch.from_numpy(image),
        image_hw=torch.tensor([[h, w]] * b, dtype=torch.int32),
        K=torch.from_numpy(K),
        im_scale_ratio=torch.full((b,), 730.0 / h),
        image_id=torch.zeros(b, dtype=torch.int32),
        gt=gt,
    )


def _compute_dtype(model_cfg) -> torch.dtype:
    return torch.bfloat16 if model_cfg.dtype == "bfloat16" else torch.float32


def normalize_image(image: torch.Tensor, model_cfg, image_hw=None) -> torch.Tensor:
    """(x - pixel_mean) / pixel_std for uint8 batches, (B, H, W, 3) in and out.

    Float inputs are taken as already normalised. When ``image_hw`` is given,
    the canvas beyond each image's valid extent is zeroed after
    normalisation (detectron2's normalize-then-pad order). The arithmetic is
    f32; the result is stored at the trunk's compute dtype, for both wire
    formats.
    """
    dtype = _compute_dtype(model_cfg)
    if image.dtype == torch.uint8:
        mean = torch.tensor(model_cfg.pixel_mean, dtype=torch.float32, device=image.device)
        std = torch.tensor(model_cfg.pixel_std, dtype=torch.float32, device=image.device)
        out = (image.float() - mean) / std
        if image_hw is not None:
            h, w = image.shape[1], image.shape[2]
            rows = torch.arange(h, device=image.device)[None, :, None] < image_hw[:, 0, None, None]
            cols = torch.arange(w, device=image.device)[None, None, :] < image_hw[:, 1, None, None]
            out = out * (rows & cols)[..., None]
        return out.to(dtype)
    return image.to(dtype)
