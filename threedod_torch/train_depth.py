"""Metric-depth fine-tuning of Depth-Anything-V2 on a CUDA device (counterpart
of ``tools/train_depth.py``).

    python -m threedod_torch.train_depth --save-path out/ [--synthetic]
        [--train-root DIR] [--val-root DIR] [--encoder vitl] [--img-size 518]
        [--min-depth 0.001] [--max-depth 20] [--epochs 40] [--bs 2]
        [--lr 5e-6] [--pretrained-from model.pth] [--seed 0] [--device cuda]
        [--num-gpus N]

SiLog loss, AdamW with the encoder at ``--lr`` and the DPT head at 10x, poly
decay, a random horizontal flip, masked depth metrics after every epoch and
one overwritten ``latest.pt`` (``train/depth.py``). The model is f32, as the
JAX tool builds it. A dataset is a folder of ``.npz`` samples (``image``
(H, W, 3) uint8 RGB, ``depth`` (H, W), optional ``valid_mask`` (H, W)), each
resized nearest to ``--img-size`` square; ``--synthetic`` makes seeded ramp
depths instead. ``--pretrained-from`` reads the ``pretrained.*`` entries of a
port state dict or an official Depth-Anything-V2 ``.pth`` (the port uses its
names): every encoder weight must be there, and nothing else is read. Without
it the weights are a seeded random initialisation.

The ViT runs kernel K9 (forward and backward) only at 2048 tokens and more:
the default ``--img-size 518`` gives 37 * 37 + 1 = 1370 tokens and the plain
attention; 644 (46 * 46 + 1 = 2117) is the smallest square size that reaches
the kernels. Prints one JSON line at the end.

``--num-gpus N`` (by default every visible card) runs N ranks, one card
each, or the tool joins a ``python -m torch.distributed.run`` launch; the
world is the largest count up to N that divides ``--bs``, and each rank
takes its rows of every batch (``train/depth.py``). Rank 0 writes
``latest.pt`` and prints the line.
"""
from __future__ import annotations

import argparse
import glob
import json
import logging
import os

import numpy as np
import torch

from .models.depth.dpt import IMAGENET_MEAN, IMAGENET_STD, DepthAnythingV2, init_weights
from .ops import attention
from .parallel import dist
from .train.depth import DepthTrainer
from .utils.checkpoints import read_state_dict, select

logger = logging.getLogger("train_depth")


def _normalize(img_u8: np.ndarray) -> np.ndarray:
    x = img_u8.astype(np.float32) / 255.0
    return (x - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)


def _resize_nearest(x: np.ndarray, size: int) -> np.ndarray:
    ys = (np.arange(size) * x.shape[0] / size).astype(np.int64)
    xs = (np.arange(size) * x.shape[1] / size).astype(np.int64)
    return x[ys][:, xs]


class NpzFolderDataset:
    """Fixed-size batches from a folder of .npz samples, in a fresh seeded
    order every epoch when ``train``."""

    def __init__(self, root: str, img_size: int, batch_size: int, seed: int = 0, train: bool = True):
        self.files = sorted(glob.glob(os.path.join(root, "*.npz")))
        if not self.files:
            raise FileNotFoundError(f"no .npz samples under {root}")
        self.img_size = img_size
        self.batch_size = batch_size
        self.train = train
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return max(len(self.files) // self.batch_size, 1)

    def __iter__(self):
        order = self.rng.permutation(len(self.files)) if self.train else np.arange(len(self.files))
        s = self.img_size
        for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
            imgs, depths, masks = [], [], []
            for i in order[start:start + self.batch_size]:
                with np.load(self.files[i]) as z:
                    img = z["image"]
                    depth = z["depth"].astype(np.float32)
                    mask = z["valid_mask"].astype(bool) if "valid_mask" in z else depth > 0
                imgs.append(_normalize(_resize_nearest(img, s)))
                depths.append(_resize_nearest(depth, s))
                masks.append(_resize_nearest(mask.astype(np.uint8), s).astype(bool))
            yield {"image": np.stack(imgs), "depth": np.stack(depths), "valid_mask": np.stack(masks)}


class SyntheticDepthDataset:
    """Seeded smooth-ramp depths under random images (no data needed)."""

    def __init__(self, img_size: int, batch_size: int, n_batches: int = 4, max_depth: float = 20.0, seed: int = 0):
        self.img_size, self.batch_size = img_size, batch_size
        self.n_batches = n_batches
        self.max_depth = max_depth
        self.seed = seed

    def __len__(self):
        return self.n_batches

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        s, b = self.img_size, self.batch_size
        for _ in range(self.n_batches):
            img = rng.randint(0, 255, (b, s, s, 3), np.uint8)
            ramp = np.linspace(1.0, self.max_depth * 0.5, s, dtype=np.float32)
            depth = np.tile(ramp[None, :, None], (b, 1, s))
            depth *= rng.uniform(0.8, 1.2, (b, 1, 1)).astype(np.float32)
            mask = rng.rand(b, s, s) > 0.1
            yield {"image": np.stack([_normalize(im) for im in img]), "depth": depth, "valid_mask": mask}


def load_pretrained(model: DepthAnythingV2, path: str) -> int:
    """Copy the encoder weights (``pretrained.*``) of a checkpoint (official
    or the port's, read by ``utils/checkpoints.read_state_dict``) into
    ``model``; the head keeps its own. Every encoder weight must be present
    with its shape; other entries (the head, an official checkpoint's
    ``pretrained.mask_token``) are not read. Returns the number of tensors
    copied."""
    encoder = {f"pretrained.{k}": v for k, v in model.pretrained.state_dict().items()}
    sd = select(read_state_dict(path), encoder, path, "encoder weights")
    with torch.no_grad():
        for k, dst in encoder.items():
            dst.copy_(sd[k])
    return len(encoder)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Depth Anything V2 metric-depth fine-tuning (CUDA)")
    ap.add_argument("--encoder", default="vitl", choices=["vits", "vitb", "vitl"])
    ap.add_argument("--train-root", default="", help="folder of train .npz samples")
    ap.add_argument("--val-root", default="", help="folder of val .npz samples")
    ap.add_argument("--synthetic", action="store_true", help="seeded ramp depths, no data needed")
    ap.add_argument("--img-size", default=518, type=int)
    ap.add_argument("--min-depth", default=0.001, type=float)
    ap.add_argument("--max-depth", default=20, type=float)
    ap.add_argument("--epochs", default=40, type=int)
    ap.add_argument("--bs", default=2, type=int, help="batch size")
    ap.add_argument("--lr", default=0.000005, type=float)
    ap.add_argument("--pretrained-from", type=str, default="",
                    help="state dict (.pth/.pt) whose pretrained.* entries initialise the encoder")
    ap.add_argument("--save-path", type=str, required=True)
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-gpus", type=int, default=None,
                    help="ranks to run, one card each (every visible card by default)")
    args = ap.parse_args(argv)

    if args.img_size % 14:
        ap.error("--img-size must be a multiple of 14 (ViT patch size)")
    if not args.synthetic and not args.train_root:
        ap.error("--train-root required without --synthetic")
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.train_depth runs on a CUDA device; '{args.device}' is not available")
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s][%(levelname)8s] %(message)s")
    result = dist.run_ranks(run, args, device, dist.world_for_batch(args.bs, device, args.num_gpus))
    if result is not None:
        print(json.dumps(result), flush=True)
    return result


def run(args, device: torch.device) -> dict:
    """The fine-tuning on ``device`` (this rank's, under a process group:
    each rank takes its rows of every batch of ``--bs``); returns the
    printed line's object."""
    dist.check_divides(args.bs)
    if args.synthetic:
        train_ds = SyntheticDepthDataset(args.img_size, args.bs, max_depth=args.max_depth, seed=args.seed)
        val_ds = SyntheticDepthDataset(args.img_size, args.bs, n_batches=2, max_depth=args.max_depth,
                                       seed=args.seed + 1)
    else:
        train_ds = NpzFolderDataset(args.train_root, args.img_size, args.bs, args.seed)
        val_ds = NpzFolderDataset(args.val_root, args.img_size, args.bs, train=False) if args.val_root else None

    model = DepthAnythingV2(args.encoder, max_depth=args.max_depth, dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    if args.pretrained_from:
        n = load_pretrained(model, args.pretrained_from)
        logger.info("loaded %d encoder tensors from %s", n, args.pretrained_from)
    total_iters = args.epochs * len(train_ds)
    trainer = DepthTrainer(model, device, base_lr=args.lr, total_iters=total_iters,
                           min_depth=args.min_depth, max_depth=args.max_depth)
    tokens = (args.img_size // 14) ** 2 + 1
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.info("device=%s encoder=%s bs=%d ranks=%d tokens=%d iters/epoch=%d total_iters=%d",
                name, args.encoder, args.bs, dist.world_size(), tokens, len(train_ds), total_iters)
    fwd0, bwd0 = attention.LAUNCHES, attention.LAUNCHES_BWD
    best = trainer.fit(train_ds, epochs=args.epochs, val_loader=val_ds, save_path=args.save_path, seed=args.seed)
    return {
        "device": name, "world_size": dist.world_size(),
        "encoder": args.encoder,
        "img_size": args.img_size,
        "tokens": tokens,
        "steps": trainer.step,
        "last_loss": None if trainer.last_loss is None else float(trainer.last_loss),
        "best": best,
        "flash_attention_launches": attention.LAUNCHES - fwd0,
        "flash_attention_bwd_launches": attention.LAUNCHES_BWD - bwd0,
        "checkpoint": os.path.join(os.path.abspath(args.save_path), "latest.pt"),
    }


if __name__ == "__main__":
    main()
