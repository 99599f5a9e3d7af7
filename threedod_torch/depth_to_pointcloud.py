"""Depth to a coloured point cloud (.ply) with Depth-Anything-V2, on a CUDA
device: the port's counterpart of ``tools/depth_to_pointcloud.py``
(depth/metric_depth/depth_to_pointcloud.py:34-111 of the reference).

    python -m threedod_torch.depth_to_pointcloud --img-path imgs/ [--outdir ./vis_pointcloud]
        [--encoder vitl] (--checkpoint dav2.pth | --random-weights) [--max-depth 20]
        [--input-size 518] [--focal-length-x 470.4] [--focal-length-y 470.4] [--device cuda]

``--img-path`` is an image, a folder (every file under it, sorted) or a
``.txt`` list. Each image is decoded on the card (``data/image_io.imread_rgb``:
JPEG or PNG), resized ("cubic") so its shorter side is about ``--input-size``
with both sides multiples of 14, normalised, run through the model in bf16
(``--checkpoint`` an official DA-V2 file or a port state dict,
``utils/checkpoints.load_official``; ``--random-weights`` seeded) and resized
back to the image (bilinear, corners aligned). Every pixel is unprojected by a
pinhole camera (fx, fy, the principal point at the image's centre) and
written to ``<outdir>/<stem>.ply``: binary little-endian, x, y, z float32 and
r, g, b uchar a vertex, as the JAX tool writes it. A KITTI image (1242x375)
at ``--input-size 518`` is a 518x1722 input, 37 x 123 patches and the class
token = 4552 tokens, so every block's attention is the flash-attention kernel
K9. One line is printed an image and a last JSON line with the card, the
files, K9's launches and the seconds. ``run(args, device, dtype)`` is the tool's work on a device (the
tests call it on the CPU in f32); ``main`` refuses all but a CUDA card.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from .data.image_io import imread_rgb
from .depth_infer import load_model
from .models.depth.dpt import preprocess_image, resize_align_corners
from .ops import attention
from .train_net import card_name_and_power_limit


def write_ply(path: str, points: np.ndarray, colors: np.ndarray) -> None:
    """Binary little-endian PLY: N x (x y z float32, r g b uchar)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    colors = np.asarray(colors).reshape(-1, 3)
    if colors.dtype != np.uint8:
        colors = np.clip(colors * 255.0 + 0.5, 0, 255).astype(np.uint8)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(points)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "end_header\n")
    rec = np.zeros(len(points), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rec["xyz"] = points
    rec["rgb"] = colors
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str):
    """(points (N, 3) float32, colors (N, 3) uint8) of a file ``write_ply`` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    rec = np.frombuffer(data[end:], dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    return rec["xyz"].copy(), rec["rgb"].copy()


def unproject(depth: torch.Tensor, fx: float, fy: float) -> torch.Tensor:
    """(H, W) depth -> (H W, 3) float32 points: the pinhole camera with the
    image's centre as principal point (reference depth_to_pointcloud.py:
    100-104), in float64 as the JAX tool's numpy computes it."""
    h, w = depth.shape
    d = depth.to(torch.float64)
    x = (torch.arange(w, dtype=torch.float64, device=depth.device) - w / 2) / fx
    y = (torch.arange(h, dtype=torch.float64, device=depth.device) - h / 2) / fy
    return torch.stack((x[None, :] * d, y[:, None] * d, d), dim=-1).reshape(-1, 3).to(torch.float32)


def image_files(img_path: str) -> list:
    """An image, every file under a folder (sorted), or a ``.txt`` list."""
    if os.path.isfile(img_path):
        if img_path.endswith("txt"):
            with open(img_path) as f:
                return [line for line in f.read().splitlines() if line]
        return [img_path]
    return sorted(p for p in glob.glob(os.path.join(img_path, "**/*"), recursive=True) if os.path.isfile(p))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--img-path", required=True, help="image, dir, or .txt list")
    ap.add_argument("--outdir", default="./vis_pointcloud")
    ap.add_argument("--encoder", default="vitl", choices=["vits", "vitb", "vitl"])
    ap.add_argument("--checkpoint", default="", help="DA-V2 .pth (official or the port's)")
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--max-depth", type=float, default=20.0)
    ap.add_argument("--input-size", type=int, default=518)
    ap.add_argument("--focal-length-x", type=float, default=470.4)
    ap.add_argument("--focal-length-y", type=float, default=470.4)
    ap.add_argument("--device", default="cuda")
    return ap


def run(args, device: torch.device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The tool's work; ``dtype`` is the model's compute type (the tool's
    bf16; the tests run f32)."""
    if not args.checkpoint and not args.random_weights:
        raise SystemExit("provide --checkpoint or --random-weights")
    device = torch.device(device)
    model = load_model(args.encoder, device, args.checkpoint or None, dtype=dtype)
    model.max_depth = args.max_depth
    filenames = image_files(args.img_path)
    os.makedirs(args.outdir, exist_ok=True)
    k9_before, files, t0 = attention.LAUNCHES, [], time.perf_counter()
    for k, filename in enumerate(filenames):
        print(f"Processing {k + 1}/{len(filenames)}: {filename}", flush=True)
        image = imread_rgb(filename, device)
        h, w = image.shape[:2]
        x = preprocess_image(image.float() / 255.0, args.input_size)
        with torch.inference_mode():
            depth = resize_align_corners(model(x)[:, None].float(), h, w)[0, 0]
            points = unproject(depth, args.focal_length_x, args.focal_length_y)
        out = os.path.join(args.outdir, os.path.splitext(os.path.basename(filename))[0] + ".ply")
        write_ply(out, points.cpu().numpy(), image.cpu().numpy())
        files.append(out)
        print(f"wrote {out}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"files": files, "encoder": args.encoder, "flash_attention_launches": attention.LAUNCHES - k9_before,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.depth_to_pointcloud runs on a CUDA device; '{args.device}' is not "
                           f"available")
    out = run(args, device)
    print(json.dumps({"device": card_name_and_power_limit(device), **out}), flush=True)
    return out


if __name__ == "__main__":
    main()
