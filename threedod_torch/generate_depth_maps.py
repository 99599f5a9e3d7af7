"""Per-image metric depth maps by Depth-Anything-V2, on a CUDA device
(counterpart of ``tools/generate_depth_maps.py``).

    python -m threedod_torch.generate_depth_maps --dataset-json J
        [--image-root datasets] [--out-dir datasets/depth_maps]
        [--encoder vitl] (--checkpoint dav2.pth | --random-weights)
        [--max-depth 20] [--input-size 518] [--device cuda]

Every image is decoded on the card, resized ("cubic", as ``jax.image.resize``)
so its shorter side is about ``--input-size`` with both sides multiples of 14,
normalised, run through the model in bf16 and resized back to the image
(bilinear, corners aligned). Writes ``<out-dir>/<image_id>.npz`` with key
``depth`` (H, W) float32. ``--checkpoint`` is an official DA-V2 checkpoint
or a port state dict (``utils/checkpoints.load_official``);
``--random-weights`` seeds the weights. A 640x480 image gives
a 518x686 input, 37 x 49 = 1813 tokens: below 2048, so every block's
attention is the plain one, not kernel K9. Prints one JSON line: the card,
the images, the seconds of the pass.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .data.image_io import imread_rgb
from .depth_infer import load_model
from .models.depth.dpt import preprocess_image, resize_align_corners
from .train_net import card_name_and_power_limit


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset-json", required=True, help="Omni3D json")
    ap.add_argument("--image-root", default="datasets")
    ap.add_argument("--out-dir", default="datasets/depth_maps")
    ap.add_argument("--encoder", default="vitl", choices=["vits", "vitb", "vitl"])
    ap.add_argument("--checkpoint", default="", help="DA-V2 state dict (.pth)")
    ap.add_argument("--max-depth", type=float, default=20.0)
    ap.add_argument("--input-size", type=int, default=518)
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args, device: torch.device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The pass over the dataset; ``dtype`` is the model's compute type (the
    tool's bf16; the tests run f32)."""
    if not args.checkpoint and not args.random_weights:
        raise SystemExit("provide --checkpoint or --random-weights")
    with open(args.dataset_json) as f:
        data = json.load(f)
    model = load_model(args.encoder, device, args.checkpoint or None, dtype=dtype)
    model.max_depth = args.max_depth
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    for im in data["images"]:
        image = imread_rgb(os.path.join(args.image_root, im["file_path"]), device)
        x = preprocess_image(image.float() / 255.0, args.input_size)
        with torch.inference_mode():
            depth = model(x)
            depth = resize_align_corners(depth[:, None].float(), im["height"], im["width"])[0, 0]
        np.savez_compressed(os.path.join(args.out_dir, f"{im['id']}.npz"),
                            depth=depth.cpu().numpy().astype(np.float32))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"images": len(data["images"]), "encoder": args.encoder, "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.generate_depth_maps runs on a CUDA device; '{args.device}' is not "
                           f"available")
    out = run(args, device)
    print(json.dumps({"device": card_name_and_power_limit(device), **out}), flush=True)


if __name__ == "__main__":
    main()
