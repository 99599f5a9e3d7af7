"""``python -m threedod_torch.train``: supervised training steps of RCNN3D
(``--backbone`` under the FPN, dla34 by default) on seeded synthetic batches (the counterpart of ``infer.py`` for
the training path).

``--weights`` is a state dict saved with ``torch.save`` under detectron2's
names, a zoo checkpoint or a port one (``utils/model_zoo.py``; the number of
classes is read from it); without it the weights are a seeded random
initialisation with 38 classes. Batches are made from ``--seed``: normalised
noise images at the 512x672 canvas with 6 valid ground-truth boxes of 64
slots each. The model computes in bf16 unless ``--dtype float32``. Prints
one JSON line per step with every loss, and a last line with the summary.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import Config
from ..data.batch import synthetic_train_batch
from ..infer import bench_config, load_model
from ..utils import model_zoo
from .trainer import Trainer


def train_config(num_classes: int = 38, dtype: str = "bfloat16", batch_size: int = 8,
                 backbone: str = "dla34") -> Config:
    """The training configuration of one backbone: 512x672 canvas, 512
    sampled ROIs per image, SGD with the default schedule."""
    cfg = bench_config(num_classes, dtype, backbone)
    cfg.solver.ims_per_batch = batch_size
    cfg.shapes.roi_batch = 512
    return cfg


def build_trainer(cfg: Config, device: torch.device, state_dict=None, seed: int = 0) -> Trainer:
    """A Trainer over the seeded model (or ``state_dict``, through
    ``model_zoo.load_model_weights``) on ``device``."""
    return Trainer(cfg, load_model(cfg, device, state_dict, seed=seed), device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Supervised Cube R-CNN training steps on seeded synthetic batches")
    ap.add_argument("--backbone", default="dla34")
    ap.add_argument("--weights", default="")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.train runs on a CUDA device; '{args.device}' is not available")
    sd = model_zoo.state_dict(args.weights) if args.weights else None
    num_classes = 38 if sd is None else model_zoo.num_classes(sd)
    cfg = train_config(num_classes, args.dtype, args.batch_size, args.backbone)
    trainer = build_trainer(cfg, device, sd)
    batch = synthetic_train_batch(cfg, args.batch_size, seed=args.seed).to(device)
    torch.cuda.reset_peak_memory_stats(device)
    skipped = 0
    t0 = time.perf_counter()
    for step in range(args.steps):
        out = trainer.train_step(batch)
        skipped += out.diverging
        print(json.dumps({"step": step, "total_loss": out.total, "skipped": out.diverging, **out.losses}), flush=True)
    torch.cuda.synchronize(device)
    print(json.dumps({
        "device": torch.cuda.get_device_name(device),
        "steps": args.steps,
        "skipped": skipped,
        "seconds": time.perf_counter() - t0,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
    }))


if __name__ == "__main__":
    main()
