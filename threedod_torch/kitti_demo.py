"""Cube R-CNN over a registered Omni3D-schema split, with each image's own
intrinsics: the port's counterpart of ``tools/kitti_demo.py``
(demo/kitti_demo.py in the reference, do_test:36-226).

    python -m threedod_torch.kitti_demo --config-file configs/Base_Synth.yaml
        [--dataset KITTI_test] [--checkpoint model_final.pt] [--threshold 0.25]
        [--display] [--output-dir DIR] [--device cuda] [KEY VALUE ...]

``train_net.setup`` reads the config, fixes the categories and registers the
datasets and priors; the model is built with them from the config's seed and
loads ``--checkpoint`` (a port checkpoint or a zoo ``.pth``,
``utils/model_zoo.load_model_weights``). The split's images go through the
model on the card in ``test.batch_size`` batches; every detection valid and
scoring at least ``--threshold`` is written to
``<output dir>/<dataset>_predictions.json`` in the JAX tool's layout (per
image: image_id, file_path, K, width, height and the predictions' category,
score, bbox, center_cam, dimensions, pose, center_2D, corners3D). With
``--display`` an image with detections is drawn as front | novel view into
``<stem>_boxes.png`` (the JAX tool writes JPEG). The output directory
defaults to ``output_dir``/kitti_demo. ``run(args, device)`` is the tool's
work on a device (the tests call it on the CPU); ``main`` refuses all but a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from .data.build import TestLoader, get_dataset_dicts
from .data.image_io import imread_rgb
from .infer import predict
from .models.meta_arch import build_model
from .train_net import setup
from .utils.model_zoo import load_model_weights
from .vis import draw_scene_view, write_png

logger = logging.getLogger("threedod_torch.kitti_demo")


def image_predictions(det: dict, j: int, idx, cats) -> list:
    """Image j's detections ``idx`` as the JSON's records."""
    return [{
        "category": cats[int(det["classes"][j, i])],
        "score": float(det["scores"][j, i]),
        "bbox": [float(v) for v in det["boxes"][j, i]],
        "center_cam": [float(v) for v in det["center_cam"][j, i]],
        "dimensions": [float(v) for v in det["dimensions"][j, i]],
        "pose": np.asarray(det["pose"][j, i]).tolist(),
        "center_2D": [float(v) for v in det["center_2d"][j, i]],
        "corners3D": np.asarray(det["corners3d"][j, i]).tolist(),
    } for i in idx]


def run(args, device) -> dict:
    """The tool's work on ``device``; returns the last line's object."""
    device = torch.device(device)
    t0 = time.perf_counter()
    cfg, meta, priors = setup(args.config_file, args.opts)
    out_dir = args.output_dir or os.path.join(cfg.output_dir, "kitti_demo")
    os.makedirs(out_dir, exist_ok=True)
    model = build_model(cfg, priors=priors)
    if args.checkpoint:
        load_model_weights(args.checkpoint, model)
        logger.info("loaded %s", args.checkpoint)
    model = model.to(device)
    records = get_dataset_dicts([args.dataset])
    by_id = {r["image_id"]: r for r in records}
    cats = list(meta.thing_classes)
    inference_json, drawn = [], []
    for batch, n_real in TestLoader(records, cfg, device=device):
        det = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
               for k, v in predict(model, batch)._asdict().items()}
        for j, img_id in enumerate(batch.image_id[:n_real].tolist()):
            rec = by_id[int(img_id)]
            K = np.asarray(rec["K"], np.float64)
            idx = np.where(det["valid"][j] & (det["scores"][j] >= args.threshold))[0]
            preds = image_predictions(det, j, idx, cats)
            inference_json.append({"image_id": int(img_id), "file_path": rec.get("file_name", ""), "K": K.tolist(),
                                   "width": rec.get("width"), "height": rec.get("height"), "predictions": preds})
            if args.display and preds:
                image = imread_rgb(rec["file_name"], device).cpu().numpy()
                scene = draw_scene_view(image, K, [np.asarray(p["corners3D"]) for p in preds],
                                        labels=[int(det["classes"][j, i]) for i in idx],
                                        scores=[p["score"] for p in preds])
                stem = os.path.splitext(os.path.basename(rec["file_name"]))[0]
                write_png(os.path.join(out_dir, f"{stem}_boxes.png"), scene)
                drawn.append(f"{stem}_boxes.png")
    out_path = os.path.join(out_dir, f"{args.dataset}_predictions.json")
    with open(out_path, "w") as f:
        json.dump(inference_json, f)
    logger.info("wrote %d image predictions to %s", len(inference_json), out_path)
    return {"predictions_json": out_path, "images": len(inference_json),
            "detections": sum(len(e["predictions"]) for e in inference_json), "drawn": drawn,
            "seconds": time.perf_counter() - t0}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Cube R-CNN over a registered Omni3D-schema split")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--dataset", default="KITTI_test", help="registered Omni3D split")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--threshold", type=float, default=0.25, help="score threshold of the written detections")
    ap.add_argument("--display", action="store_true", help="write <stem>_boxes.png scene views")
    ap.add_argument("--output-dir", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE pairs overriding the config")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.kitti_demo runs on a CUDA device; '{args.device}' is not available")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s", force=True)
    out = run(args, device)
    print(json.dumps({"device": torch.cuda.get_device_name(device), **out}), flush=True)


if __name__ == "__main__":
    main()
