"""Per-annotation instance masks by box-prompted SAM, on a CUDA device
(counterpart of ``tools/generate_object_masks.py``).

    python -m threedod_torch.generate_object_masks --dataset-json J
        [--image-root datasets] [--out-dir datasets/object_masks]
        [--checkpoint sam.pth] [--img-size 1024] [--box-fill] [--device cuda]

Writes ``<out-dir>/<image_id>.npz`` for every image of the Omni3D json:
``masks`` (N, H, W) uint8, one a annotation at the image's size, and
``ann_ids`` (N,) int64, the annotations' ids (what ``data/mapper.py`` reads).
``--checkpoint`` is a SAM or SAM-HQ state dict under the official names
(SAM-HQ when it holds ``mask_decoder.hf_token.weight``); without it plain SAM
runs on seeded weights (a pipeline check only). SAM runs in bf16 at
``--img-size``: each image is decoded on the card, encoded once and all its
boxes decoded in one call. ``--box-fill`` writes the filled 2D boxes instead
and runs no model. Prints one JSON line: the card, the images, the masks and
the seconds of the pass (model building not included).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .data.image_io import imread_rgb
from .models.sam import load_sam, masks_for_boxes
from .train_net import card_name_and_power_limit


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset-json", required=True, help="Omni3D json")
    ap.add_argument("--image-root", default="datasets")
    ap.add_argument("--out-dir", default="datasets/object_masks")
    ap.add_argument("--checkpoint", default="", help="SAM / SAM-HQ state dict (.pth)")
    ap.add_argument("--img-size", type=int, default=1024)
    ap.add_argument("--box-fill", action="store_true", help="rasterise the 2D boxes instead of running SAM")
    ap.add_argument("--device", default="cuda")
    return ap


def box_fill(box, h: int, w: int) -> np.ndarray:
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    return (ys >= box[1]) & (ys < box[3]) & (xs >= box[0]) & (xs < box[2])


def run(args, device: torch.device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The pass over the dataset; ``dtype`` is the models' compute type (the
    tool's bf16; the tests run f32)."""
    with open(args.dataset_json) as f:
        data = json.load(f)
    anns_by_img = {}
    for a in data["annotations"]:
        anns_by_img.setdefault(a["image_id"], []).append(a)
    model = None if args.box_fill else load_sam(args.checkpoint, args.img_size, device, dtype)
    os.makedirs(args.out_dir, exist_ok=True)
    t0, n_masks = time.perf_counter(), 0
    for im in data["images"]:
        anns = anns_by_img.get(im["id"], [])
        h, w = im["height"], im["width"]
        boxes = [[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]] for a in anns]
        if not anns:
            masks = np.zeros((0, h, w), np.uint8)
        elif args.box_fill:
            masks = np.stack([box_fill(b, h, w) for b in boxes]).astype(np.uint8)
        else:
            image = imread_rgb(os.path.join(args.image_root, im["file_path"]), device)
            masks = masks_for_boxes(model, image, boxes, args.img_size).cpu().numpy()
        np.savez_compressed(os.path.join(args.out_dir, f"{im['id']}.npz"), masks=masks,
                            ann_ids=np.asarray([a["id"] for a in anns], np.int64))
        n_masks += len(anns)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"images": len(data["images"]), "masks": n_masks, "hq": bool(model is not None and model.hq),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.generate_object_masks runs on a CUDA device; '{args.device}' is not "
                           f"available")
    out = run(args, device)
    print(json.dumps({"device": card_name_and_power_limit(device), **out}), flush=True)


if __name__ == "__main__":
    main()
