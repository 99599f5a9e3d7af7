"""Cube R-CNN over a folder of images, with drawings: the port's counterpart
of ``tools/demo.py`` (demo/demo.py in the reference).

    python -m threedod_torch.demo --config-file configs/Base_Synth.yaml
        --input-folder datasets/synth/images --output-dir output/demo
        [--checkpoint output/synth_rcnn3d/model_final.pt] [--focal-scale 2.0]
        [--score-thresh 0.3] [--device cuda] [KEY VALUE ...]

The model is built from the config (``KEY VALUE`` pairs override it) with
the config's seed, then, where ``--checkpoint`` is given, loads it through
``utils/model_zoo.load_model_weights``: a port checkpoint (``model_final.pt``
of ``train_net``) or a Cube R-CNN zoo ``.pth`` (``cubercnn://`` paths
resolve in the zoo cache). Each image's intrinsics are the demo's guess, f =
``--focal-scale`` times the image's height with the principal point at the
centre; the image is mapped at the config's test size and run through the
model on the card. Detections valid and above ``--score-thresh`` are drawn
(``vis/vis.py``): ``<stem>_boxes.png`` (the rendered front view, boxes
blended at 0.5 and the overlay at 0.85), ``<stem>_novel.png`` (the novel
view) and ``<stem>.png`` (front | novel | bird's-eye view). The JAX tool
writes the same stems as JPEG through Pillow; the port writes PNG with
``zlib`` (``vis/png.py``).

Images are JPEG or PNG files (``.jpg``, ``.jpeg``, ``.png``; KITTI's
``image_2`` is PNG), decoded by the card's decoders (``data/image_io.py``);
a file the decoders do not take raises with its path. One line is
printed an image, and a last JSON line with the files, detections and
seconds. ``run(args, device)`` is the tool's work on a device (the tests
call it on the CPU); ``main`` refuses all but a CUDA card.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from .config_yaml import load_config
from .data.batch import collate
from .data.image_io import image_hw, imread_rgb
from .data.mapper import DatasetMapper3D
from .infer import predict
from .models.meta_arch import build_model
from .utils.model_zoo import load_model_weights
from .vis import draw_bev, get_color, render_scene_views, side_by_side, write_png

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png")


def image_paths(folder: str) -> list:
    """The folder's image files, sorted (the JAX tool's glob)."""
    paths = sorted(p for p in glob.glob(os.path.join(folder, "*")) if p.lower().endswith(IMAGE_EXTENSIONS))
    if not paths:
        raise FileNotFoundError(f"no images in {folder}")
    return paths


def demo_batch(cfg, mapper: DatasetMapper3D, path: str, focal_scale: float):
    """One image as a batch, with f = focal_scale * height and the principal
    point at the centre (demo.py:67-80)."""
    h0, w0 = image_hw(path)
    f = focal_scale * h0
    K = np.array([[f, 0, w0 / 2], [0, f, h0 / 2], [0, 0, 1]], np.float32)
    record = {"file_name": path, "K": K, "image_id": 0, "height": h0, "width": w0}
    return collate([mapper(record)], cfg.shapes.max_gt)


def draw_detections(image: np.ndarray, K: np.ndarray, det: dict, score_thresh: float):
    """(front, novel, panel) drawings of one image's detections above the
    threshold (demo.py:135-142), and how many were drawn."""
    keep = det["valid"] & (det["scores"] > score_thresh)
    corners, labels, scores = det["corners3d"][keep], det["classes"][keep], det["scores"][keep]
    text = [f"{int(c)} {s:.2f}" for c, s in zip(labels, scores)]
    colors = [get_color(int(c)) for c in labels]
    front, novel = render_scene_views(image, K, corners, text=text, colors=colors, mode="front_and_novel",
                                      blend_weight=0.5, blend_weight_overlay=0.85)
    bev = draw_bev([np.asarray(c) for c in corners], colors=colors, size=front.shape[0])
    return front, novel, side_by_side([front, novel, bev]), int(keep.sum())


def run(args, device) -> dict:
    """The tool's work on ``device``; returns the last line's object."""
    device = torch.device(device)
    t0 = time.perf_counter()
    cfg = load_config(args.config_file, list(args.opts))
    os.makedirs(args.output_dir, exist_ok=True)
    model = build_model(cfg)
    if args.checkpoint:
        load_model_weights(args.checkpoint, model)
        print(f"loaded {args.checkpoint}", flush=True)
    model = model.to(device)
    mapper = DatasetMapper3D(cfg, is_train=False, device=device)
    files, detections = [], []
    for path in image_paths(args.input_folder):
        batch = demo_batch(cfg, mapper, path, args.focal_scale)
        det = {k: v[0].float().cpu().numpy() if v.is_floating_point() else v[0].cpu().numpy()
               for k, v in predict(model, batch)._asdict().items()}
        image = imread_rgb(path, device).cpu().numpy()
        front, novel, panel, n = draw_detections(image, batch.K[0].cpu().numpy(), det, args.score_thresh)
        stem = os.path.splitext(os.path.basename(path))[0]
        for name, img in ((f"{stem}_boxes.png", front), (f"{stem}_novel.png", novel), (f"{stem}.png", panel)):
            write_png(os.path.join(args.output_dir, name), img)
            files.append(name)
        detections.append(n)
        print(f"{os.path.basename(path)}: {n} detections -> {os.path.join(args.output_dir, stem + '.png')}",
              flush=True)
    return {"images": len(detections), "detections": detections, "files": files,
            "seconds": time.perf_counter() - t0}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Cube R-CNN over a folder of images, with drawings")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--input-folder", required=True)
    ap.add_argument("--output-dir", default="output/demo")
    ap.add_argument("--checkpoint", default="", help="a port checkpoint or a Cube R-CNN zoo .pth")
    ap.add_argument("--focal-scale", type=float, default=2.0, help="f = scale * image height")
    ap.add_argument("--score-thresh", type=float, default=0.3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE pairs overriding the config")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.demo runs on a CUDA device; '{args.device}' is not available")
    out = run(args, device)
    print(json.dumps({"device": torch.cuda.get_device_name(device), **out}), flush=True)


if __name__ == "__main__":
    main()
