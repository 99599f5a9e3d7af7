"""Per-image ground masks, on a CUDA device (counterpart of
``tools/generate_ground_segmentations.py``): a "ground" box, then SAM.

    python -m threedod_torch.generate_ground_segmentations --dataset-json J
        [--image-root datasets] [--out-dir datasets/ground_maps]
        [--no-ground-csv datasets/no_ground_idx.csv] [--checkpoint sam.pth]
        [--ground-boxes boxes.json | --gdino-checkpoint gdino.pth | --heuristic]
        [--gdino-image-size 800] [--prompt-token-ids 101,2598,1012,102]
        [--box-threshold 0.35] [--img-size 1024] [--device cuda]

An image's box comes from ``--ground-boxes`` ({image_id: [x1, y1, x2, y2]})
when it is listed there, else from GroundingDINO when ``--gdino-checkpoint``
is given (the port's model in bf16 at ``--gdino-image-size`` squared, an
official checkpoint or a port state dict, read as ``gdino_infer --weights``;
the image resized ("linear") and normalised, the prompt's token ids with a
full mask, ``best_box_for_prompt``; an image whose score is below ``--box-threshold``
has no ground; every deformable attention is kernel K3, 12 launches a
forward), else from ``--heuristic`` (the bottom third of the image); an
image with none has no ground. SAM (as ``generate_object_masks`` loads it,
bf16) segments the box; a mask covering less than 1 % of the image counts
as no ground. Writes ``<out-dir>/<image_id>.npz`` with key ``mask`` (H, W)
uint8 and the ids without ground to ``--no-ground-csv`` (header ``img_id``).
Prints one JSON line: the card, masks written, images without ground, K3's
launches, the seconds of the pass.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time

import numpy as np
import torch

from .data.image_io import imread_rgb
from .data.resize import resize_linear
from .gdino_infer import PROMPT_TOKEN_IDS
from .models.sam import SAM_MEAN, SAM_STD, load_sam, masks_for_boxes
from .ops import ms_deform
from .train_net import card_name_and_power_limit


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset-json", required=True)
    ap.add_argument("--image-root", default="datasets")
    ap.add_argument("--out-dir", default="datasets/ground_maps")
    ap.add_argument("--no-ground-csv", default="datasets/no_ground_idx.csv")
    ap.add_argument("--checkpoint", default="", help="SAM / SAM-HQ state dict (.pth)")
    ap.add_argument("--ground-boxes", default="", help="precomputed ground boxes json")
    ap.add_argument("--gdino-checkpoint", default="", help="GroundingDINO state dict (.pth, official names)")
    ap.add_argument("--gdino-image-size", type=int, default=800)
    ap.add_argument("--prompt-token-ids", default=PROMPT_TOKEN_IDS,
                    help="comma-separated bert-base-uncased token ids for the prompt")
    ap.add_argument("--box-threshold", type=float, default=0.35)
    ap.add_argument("--heuristic", action="store_true")
    ap.add_argument("--img-size", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    return ap


def gdino_input(image: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (1, size, size, 3) f32: "linear" resize and the
    mean and std of 0..255 pixels, as the JAX tool feeds GroundingDINO."""
    x = resize_linear(image.float(), (size, size, 3))
    mean = torch.tensor(SAM_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(SAM_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std)[None]


def gdino_box(model, image: torch.Tensor, ids, size: int):
    """The best box for the prompt in image pixels [x1, y1, x2, y2] and its score."""
    from .models.gdino.model import best_box_for_prompt

    h, w = image.shape[:2]
    tok = torch.tensor([ids], dtype=torch.long, device=image.device)
    with torch.inference_mode():
        logits, boxes, _ = model(gdino_input(image, size), tok, torch.ones_like(tok, dtype=torch.bool))
    xyxy, score = best_box_for_prompt(logits.float(), boxes.float(),
                                      torch.tensor([[h, w]], dtype=torch.float32, device=image.device))
    return [float(c) for c in xyxy[0].tolist()], float(score[0])


def run(args, device: torch.device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The pass over the dataset; ``dtype`` is the models' compute type (the
    tool's bf16; the tests run f32)."""
    with open(args.dataset_json) as f:
        data = json.load(f)
    ground_boxes = {}
    if args.ground_boxes:
        with open(args.ground_boxes) as f:
            ground_boxes = {int(k): v for k, v in json.load(f).items()}
    gmodel = None
    if args.gdino_checkpoint:
        from .gdino_infer import load_model

        gmodel = load_model(device, args.gdino_checkpoint, dtype=dtype)
    ids = [int(t) for t in args.prompt_token_ids.split(",")]
    model = load_sam(args.checkpoint, args.img_size, device, dtype)
    os.makedirs(args.out_dir, exist_ok=True)
    os.makedirs(os.path.dirname(args.no_ground_csv) or ".", exist_ok=True)
    failures, written, k3_before, t0 = [], 0, ms_deform.LAUNCHES, time.perf_counter()
    for im in data["images"]:
        h, w = im["height"], im["width"]
        image = None
        if im["id"] in ground_boxes:
            box = ground_boxes[im["id"]]
        elif gmodel is not None:
            image = imread_rgb(os.path.join(args.image_root, im["file_path"]), device)
            box, score = gdino_box(gmodel, image, ids, args.gdino_image_size)
            if score < args.box_threshold:
                failures.append(im["id"])
                continue
        elif args.heuristic:
            box = [0.0, h * 2 / 3, w - 1.0, h - 1.0]
        else:
            failures.append(im["id"])
            continue
        if image is None:
            image = imread_rgb(os.path.join(args.image_root, im["file_path"]), device)
        mask = masks_for_boxes(model, image, [box], args.img_size)[0].cpu().numpy()
        if mask.sum() < 0.01 * h * w:  # near-empty (filter_ground's rule)
            failures.append(im["id"])
            continue
        np.savez_compressed(os.path.join(args.out_dir, f"{im['id']}.npz"), mask=mask)
        written += 1
    with open(args.no_ground_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["img_id"])
        for i in failures:
            writer.writerow([i])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"images": len(data["images"]), "masks": written, "no_ground": failures,
            "k3_launches": ms_deform.LAUNCHES - k3_before, "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.generate_ground_segmentations runs on a CUDA device; '{args.device}' "
                           f"is not available")
    out = run(args, device)
    print(json.dumps({"device": card_name_and_power_limit(device), **out}), flush=True)


if __name__ == "__main__":
    main()
