"""Depth-Anything-V2 metric-depth inference on a CUDA device (the model that
``tools/generate_depth_maps.py`` of the JAX package runs over a dataset).

    python -m threedod_torch.depth_infer [--encoder vitl] [--weights model.pt]
        [--images batch.npy] [--height 518 --width 924] [--device cuda]

``--weights`` is an official DA-V2 checkpoint or a port state dict saved with
``torch.save`` (``utils/convert_weights.py::depth_from_jax_variables`` makes
one from JAX params), read by ``utils/checkpoints.load_official``; without it
the weights are a seeded random initialisation.
``--images`` is a float32 (B, H, W, 3) array of RGB images already resized to
multiples of 14 and normalised with the ImageNet mean and std; without it one
seeded normal image of ``--height`` x ``--width`` is used (518x924 is a
900x1600 frame through the model's resize rule). The model runs in bf16 with
``max_depth`` 20. At 2048 tokens and more (518x924 gives 2443) every block's
attention is the flash-attention kernel K9. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .models.depth.dpt import DepthAnythingV2, build_depth_model
from .ops import attention
from .utils.checkpoints import load_official


def load_model(encoder: str, device: torch.device, state_dict=None, seed: int = 0,
               dtype: torch.dtype = torch.bfloat16) -> DepthAnythingV2:
    """The seeded model, or the checkpoint ``state_dict`` (a path or a dict,
    official or the port's; ``load_official``), on ``device``."""
    model = build_depth_model(encoder, dtype=dtype, seed=seed)
    if state_dict is not None:
        load_official(model, state_dict, "the DA-V2 checkpoint")
    return model.to(device)


def random_images(batch: int, height: int, width: int, seed: int = 0) -> np.ndarray:
    """Seeded stand-ins for normalised images, float32 (B, H, W, 3)."""
    if height % 14 or width % 14:
        raise ValueError(f"height and width must be multiples of 14, got {height}x{width}")
    return np.random.RandomState(seed).randn(batch, height, width, 3).astype(np.float32)


def predict(model: DepthAnythingV2, images: np.ndarray, device: torch.device) -> torch.Tensor:
    """float32 (B, H, W, 3) normalised images -> metric depth (B, H, W) on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).to(device).permute(0, 3, 1, 2)
    with torch.inference_mode():
        return model(x)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--encoder", default="vitl", choices=("vits", "vitb", "vitl"))
    ap.add_argument("--weights", default="")
    ap.add_argument("--images", default="", help="float32 (B, H, W, 3) .npy, normalised, sides multiples of 14")
    ap.add_argument("--height", type=int, default=518)
    ap.add_argument("--width", type=int, default=924)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.depth_infer runs on a CUDA device; '{args.device}' is not available")
    images = np.load(args.images) if args.images else random_images(1, args.height, args.width)
    model = load_model(args.encoder, device, args.weights or None)
    before = attention.LAUNCHES
    depth = predict(model, images, device)
    print(json.dumps({
        "device": torch.cuda.get_device_name(device),
        "encoder": args.encoder,
        "shape": list(depth.shape),
        "min": float(depth.min()),
        "max": float(depth.max()),
        "finite": bool(torch.isfinite(depth).all()),
        "flash_attention_launches": attention.LAUNCHES - before,
    }))


if __name__ == "__main__":
    main()
