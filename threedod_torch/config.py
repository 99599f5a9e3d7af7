"""Typed configuration for the PyTorch port.

Every field of ``threedod/config/config.py``, with its default (the field
sets and defaults are pinned equal by ``tests/test_torch_port_hygiene.py``),
so every shipped config file loads. Plain dataclasses; ``config_yaml.py``
reads the YAML files onto them.

Some fields are held with no effect, in both packages: ``version``,
``model.depth_on``, ``model.rpn.boundary_thresh``, the two ``name`` fields,
``shapes.ransac_hypotheses`` (the RANSAC fit draws 1000 hypotheses) and
``model.roi_cube_head.pooler_sampling_ratio`` (both pools take the box
head's ratio). ``log`` asks for wandb mirroring of the scalar log, which
turns itself off where wandb is not installed. ``vis_period`` makes
``train_net``'s and ``eval_boxes``' evaluations draw (``vis/``).
``model.weights_pretrain`` is loaded by ``train_net`` on every fresh
attempt (``train_net.fresh_model``).
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
    # read and ignored: the JAX trainer chains this many steps in one
    # dispatch; one step at a time computes the same thing
    steps_per_dispatch: int = 1


@dataclass
class InputConfig:
    min_size_train: Tuple[int, ...] = tuple(range(256, 641, 16))  # train scales, drawn per image
    min_size_test: int = 512
    max_size_train: int = 4096
    max_size_test: int = 4096
    random_flip: bool = True
    format: str = "BGR"  # channel order the pixel mean and std are given in


@dataclass
class DatasetsConfig:
    train: Tuple[str, ...] = ("SUNRGBD_train_mini",)
    test: Tuple[str, ...] = ("SUNRGBD_test_mini",)
    category_names: Tuple[str, ...] = ()
    ignore_names: Tuple[str, ...] = ("dontcare", "ignore", "void")
    truncation_thres: float = 0.99
    visibility_thres: float = 0.01
    min_height_thres: float = 0.00
    max_height_thres: float = 1.50
    max_depth: float = 1e8
    modal_2d_boxes: bool = False
    trunc_2d_boxes: bool = True
    root: str = "datasets"


@dataclass
class TestConfig:
    __test__ = False  # not a pytest class
    eval_period: int = 16000
    visibility_thres: float = 1 / 3.0
    truncation_thres: float = 1 / 3.0
    detections_per_image: int = 100
    batch_size: int = 1


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
    boundary_thresh: float = -1.0


@dataclass
class ROIHeadsConfig:
    name: str = "ROIHeads3D"
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
    name: str = "CubeHead"
    num_fc: int = 2
    fc_dim: int = 1024
    shared_fc: bool = True
    pooler_resolution: int = 7
    pooler_sampling_ratio: int = 0
    z_type: str = "direct"  # direct | sigmoid | log | clusters
    pose_type: str = "6d"  # 6d | quaternion | euler
    cluster_bins: int = 1
    use_confidence: float = 1.0
    inverse_z_weight: bool = False
    virtual_depth: bool = True
    virtual_focal: float = 512.0
    disentangled_loss: bool = True
    chamfer_pose: bool = True
    allocentric_pose: bool = True
    dims_priors_enabled: bool = True
    dims_priors_func: str = "exp"  # exp | sigmoid
    scale_roi_boxes: float = 0.0
    number_of_proposals: int = 1000  # BoxNet's proposals per reference box
    loss_w_3d: float = 1.0
    loss_w_xy: float = 1.0
    loss_w_z: float = 1.0
    loss_w_dims: float = 1.0
    loss_w_pose: float = 1.0
    loss_w_joint: float = 1.0
    # the weak losses' weights (weak Cube R-CNN)
    loss_w_normal_vec: float = 20.0
    loss_w_iou: float = 1.0
    loss_w_seg: float = 2.5
    loss_w_depth: float = 1.0


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
    depth_on: bool = False
    dtype: str = "bfloat16"  # compute dtype of trunk and heads ('float32' to disable)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    roi_heads: ROIHeadsConfig = field(default_factory=ROIHeadsConfig)
    roi_box_head: ROIBoxHeadConfig = field(default_factory=ROIBoxHeadConfig)
    roi_cube_head: CubeHeadConfig = field(default_factory=CubeHeadConfig)
    weights: str = ""  # a model state dict to start from (``utils/model_zoo.py``)
    weights_pretrain: str = ""


@dataclass
class ShapesConfig:
    canvas_height: int = 512
    canvas_width: int = 672
    max_gt: int = 64  # ground-truth slots per image (padded, masked)
    max_detections: int = 100
    roi_batch: int = 512  # sampled ROIs per image (train)
    nms_candidates: int = 1024  # class-flattened candidates entering final NMS
    ransac_hypotheses: int = 1000


@dataclass
class PlotConfig:
    """The propose-and-score tool's routing (``eval_boxes.py``). The configs
    set ``output_dir``, ``scoring_func`` and ``number_of_proposals`` too, and
    nothing reads them: the model takes ``model.roi_cube_head.number_of_proposals``."""

    output_dir: str = ""
    eval: str = ""  # 'MABO' | 'AP' | 'IoU3D' ('' is MABO)
    mode2d: str = ""  # 'GT' | 'PRED': the reference boxes, ground truth or predicted
    scoring_func: str = ""
    proposal_func: str = "propose"  # a sampler of ``proposals.PROPOSAL_FUNCS``
    number_of_proposals: int = 1000


@dataclass
class TrainBlockConfig:
    pseudo_gt: str = "learn"  # 'learn' | 'pseudo' (``eval_boxes.py`` writes pseudo ground truth)


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    input: InputConfig = field(default_factory=InputConfig)
    datasets: DatasetsConfig = field(default_factory=DatasetsConfig)
    shapes: ShapesConfig = field(default_factory=ShapesConfig)
    test: TestConfig = field(default_factory=TestConfig)
    plot: PlotConfig = field(default_factory=PlotConfig)
    train: TrainBlockConfig = field(default_factory=TrainBlockConfig)
    # weak Cube R-CNN's loss menu (``models/weak_heads.py``)
    loss_functions: Tuple[str, ...] = (
        "dims", "pose_alignment", "pose_ground", "iou", "z", "z_pseudo_gt_patch", "depth",
    )
    output_dir: str = "output"
    seed: int = 12
    vis_period: int = 0
    log: bool = False  # mirror the scalar log to wandb, where it is installed
    version: int = 2
    max_training_attempts: int = 10
