"""Typed configuration for the PyTorch port.

Holds the fields the supervised Cube R-CNN inference and training paths
read, with the defaults of ``threedod/config/config.py`` (pinned equal by
``tests/test_torch_port_hygiene.py``). Plain dataclasses: no YAML loader is
needed on these paths, so none is imported here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class SolverConfig:
    type: str = "sgd"  # sgd | adam | adamw (+ "+amsgrad")
    ims_per_batch: int = 32
    base_lr: float = 0.02
    steps: Tuple[int, ...] = (19200, 25600)
    max_iter: int = 32000
    weight_decay: float = 1e-4
    momentum: float = 0.9
    nesterov: bool = False
    gamma: float = 0.1
    warmup_iters: int = 1000
    warmup_factor: float = 1.0 / 1000
    clip_gradients: float = 0.0  # 0 = off; else the global-norm bound
    checkpoint_period: int = 4000


@dataclass
class RPNConfig:
    in_features: Tuple[str, ...] = ("p2", "p3", "p4", "p5", "p6")
    anchor_sizes: Tuple[Tuple[int, ...], ...] = ((32,), (64,), (128,), (256,), (512,))
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    iou_thresholds: Tuple[float, float] = (0.05, 0.05)  # bg, fg thresholds
    batch_size_per_image: int = 256
    positive_fraction: float = 1.0
    pre_nms_topk_train: int = 2000  # per level
    pre_nms_topk_test: int = 1000
    post_nms_topk_train: int = 1000
    post_nms_topk_test: int = 1000
    nms_thresh: float = 0.7
    min_box_size: float = 0.0
    ignore_threshold: float = 0.5
    objectness_uncertainty: str = "IoUness"  # 'none' | 'IoUness'
    loss_weight_cls: float = 1.0
    loss_weight_loc: float = 1.0


@dataclass
class ROIHeadsConfig:
    in_features: Tuple[str, ...] = ("p2", "p3", "p4", "p5", "p6")
    num_classes: int = 38
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    iou_thresholds: Tuple[float, float] = (0.5, 0.5)
    score_thresh_test: float = 0.01
    nms_thresh_test: float = 0.5
    proposal_append_gt: bool = True


@dataclass
class ROIBoxHeadConfig:
    num_fc: int = 2
    fc_dim: int = 1024
    pooler_resolution: int = 7
    pooler_sampling_ratio: int = 0
    smooth_l1_beta: float = 0.0
    box_reg_loss_type: str = "smooth_l1"


@dataclass
class CubeHeadConfig:
    num_fc: int = 2
    fc_dim: int = 1024
    shared_fc: bool = True
    pooler_resolution: int = 7
    z_type: str = "direct"
    pose_type: str = "6d"
    cluster_bins: int = 1
    use_confidence: float = 1.0
    inverse_z_weight: bool = False
    virtual_depth: bool = True
    virtual_focal: float = 512.0
    disentangled_loss: bool = True
    chamfer_pose: bool = True
    allocentric_pose: bool = True
    dims_priors_enabled: bool = True
    dims_priors_func: str = "exp"
    scale_roi_boxes: float = 0.0
    loss_w_3d: float = 1.0
    loss_w_xy: float = 1.0
    loss_w_z: float = 1.0
    loss_w_dims: float = 1.0
    loss_w_pose: float = 1.0
    loss_w_joint: float = 1.0


@dataclass
class ModelConfig:
    meta_architecture: str = "RCNN3D"
    backbone: str = "dla34"
    fpn_out_channels: int = 256
    pixel_mean: Tuple[float, ...] = (103.530, 116.280, 123.675)
    pixel_std: Tuple[float, ...] = (57.375, 57.120, 58.395)
    use_bn: bool = True
    freeze_bn: bool = False
    stabilize: float = 0.02  # divergence-retry threshold; 0 = off
    dtype: str = "bfloat16"  # compute dtype of trunk and heads ('float32' to disable)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    roi_heads: ROIHeadsConfig = field(default_factory=ROIHeadsConfig)
    roi_box_head: ROIBoxHeadConfig = field(default_factory=ROIBoxHeadConfig)
    roi_cube_head: CubeHeadConfig = field(default_factory=CubeHeadConfig)


@dataclass
class ShapesConfig:
    canvas_height: int = 512
    canvas_width: int = 672
    max_gt: int = 64  # ground-truth slots per image (padded, masked)
    max_detections: int = 100
    roi_batch: int = 512  # sampled ROIs per image (train)
    nms_candidates: int = 1024  # class-flattened candidates entering final NMS


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    shapes: ShapesConfig = field(default_factory=ShapesConfig)
    output_dir: str = "output"
    seed: int = 12
    max_training_attempts: int = 10
