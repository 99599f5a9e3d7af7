"""Batched Cube R-CNN inference on a CUDA device: the port's entry point
(counterpart of ``tools/demo.py``'s build -> weights -> predict, without the
drawing).

    python -m threedod_torch.infer [--backbone dla34] [--weights model.pt]
        [--images batch.npy] [--batch-size 8] [--device cuda] [--fused-forward]

``--backbone`` names the trunk under the FPN: dla34, dla46_c, dla46x_c,
dla60x_c, dla60, dla60x, dla102, dla102x, dla169, resnet18/34/50/101,
densenet121, mnasnet or shufflenet (the backbone swaps of
``configs/cubercnn_*_FPN.yaml``).

``--weights`` is a state dict saved with ``torch.save`` under detectron2's
names: a Cube R-CNN zoo checkpoint (``{"model": ...}``, BatchNorm counters
dropped) or a port one (``utils/model_zoo.py``; ``utils/convert_weights.py``
makes one from JAX variables); the number of classes is read from it. Without it the weights are a seeded random
initialisation with 38 classes. ``--images`` is a uint8 (B, H, W, 3) BGR
array at the canvas size; without it ``--batch-size`` images of seeded
noise are used. The model runs in bf16. Intrinsics default to the demo's
guess: f = 2 * height, principal point at the centre. ``--fused-forward``
runs DLA34's tree heads and tails or the ResNet trunks' basic blocks,
the FPN levels and the RPN head through the fused kernels K4 to K8
(``ops/fused_conv.py``) instead of the cuDNN chain; it is off by default. Prints one JSON line with the detections'
summary.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .config import Config
from .data.batch import Batch
from .models.meta_arch import RCNN3D, build_model
from .models.roi_heads3d import Detections
from .ops import fused_conv
from .utils import model_zoo


def bench_config(num_classes: int = 38, dtype: str = "bfloat16", backbone: str = "dla34") -> Config:
    """The serving configuration of one backbone under the FPN: 512x672
    canvas, 100 detections."""
    cfg = Config()
    cfg.model.backbone = backbone
    cfg.model.dtype = dtype
    cfg.model.roi_heads.num_classes = num_classes
    cfg.shapes.canvas_height = 512
    cfg.shapes.canvas_width = 672
    cfg.shapes.max_detections = 100
    return cfg


def load_model(cfg: Config, device: torch.device, state_dict=None, seed: int = 0) -> RCNN3D:
    """The seeded model, or ``state_dict`` loaded through
    ``model_zoo.load_model_weights``, on ``device``."""
    model = build_model(cfg, seed=seed)
    if state_dict is not None:
        model_zoo.load_model_weights(state_dict, model)
    return model.to(device)


def make_batch(cfg: Config, images: np.ndarray, device: torch.device) -> Batch:
    """uint8 (B, H, W, 3) canvas images -> a Batch with the default K."""
    b, h, w, _ = images.shape
    if (h, w) != (cfg.shapes.canvas_height, cfg.shapes.canvas_width):
        raise ValueError(f"images are {h}x{w}, the canvas is {cfg.shapes.canvas_height}x{cfg.shapes.canvas_width}")
    f = 2.0 * h
    K = np.tile(np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32), (b, 1, 1))
    batch = Batch(
        image=torch.from_numpy(np.ascontiguousarray(images, dtype=np.uint8)),
        image_hw=torch.tensor([[h, w]] * b, dtype=torch.int32),
        K=torch.from_numpy(K),
        im_scale_ratio=torch.ones(b),
        image_id=torch.arange(b, dtype=torch.int32),
    )
    return batch.to(device)


def random_images(cfg: Config, batch_size: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    shape = (batch_size, cfg.shapes.canvas_height, cfg.shapes.canvas_width, 3)
    return rng.randint(0, 256, shape).astype(np.uint8)


def predict(model: RCNN3D, batch: Batch) -> Detections:
    with torch.inference_mode():
        return model(batch)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backbone", default="dla34")
    ap.add_argument("--weights", default="")
    ap.add_argument("--images", default="", help="uint8 (B, H, W, 3) .npy at the canvas size")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fused-forward", action="store_true", help="run the forward through kernels K4 to K8")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.infer runs on a CUDA device; '{args.device}' is not available")
    sd = model_zoo.state_dict(args.weights) if args.weights else None
    cfg = bench_config(38 if sd is None else model_zoo.num_classes(sd), backbone=args.backbone)
    images = np.load(args.images) if args.images else random_images(cfg, args.batch_size)
    model = load_model(cfg, device, sd)
    with fused_conv.fused_forward(args.fused_forward):
        det = predict(model, make_batch(cfg, images, device))
    valid = det.valid.cpu()
    print(json.dumps({
        "device": torch.cuda.get_device_name(device),
        "backbone": args.backbone,
        "fused_forward": args.fused_forward,
        "images": int(valid.shape[0]),
        "detections_per_image": valid.sum(1).tolist(),
        "top_score": float(det.scores.max()),
        "finite": bool(torch.isfinite(det.corners3d).all()),
    }))


if __name__ == "__main__":
    main()
