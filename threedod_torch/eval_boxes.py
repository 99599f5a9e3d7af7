"""The propose-and-score method (BoxNet) on a CUDA device: MABO, IoU3D
detection rates, AP, and pseudo ground truth (counterpart of
``tools/eval_boxes.py``).

    python -m threedod_torch.eval_boxes --config-file configs/BoxNet_Synth.yaml
        [--pseudo-gt-out NAME] [--device cuda] [KEY VALUE ...]

``KEY VALUE`` pairs override the config and route as the tool does:

* ``train.pseudo_gt pseudo``: the best cube of every ground-truth box of the
  training datasets, written as the Omni3D annotations of
  ``<datasets.root>/Omni3D/<NAME>.json`` (the first training dataset's images
  and categories; NAME is ``pseudo_gt_train`` by default). Standard Cube
  R-CNN then trains on it: ``python -m threedod_torch.train_net
  --config-file configs/Base_Synth.yaml datasets.train "[NAME]"``;
* otherwise ``plot.eval`` over the test datasets: ``MABO`` (the default;
  the mean best IoU3D of the top-ranked proposal by each score, the best any
  proposal reaches, and the 26 score combinations), ``IoU3D`` (the share of
  ground-truth cubes whose best proposal reaches IoU3D 0.25 and 0.5) or
  ``AP`` (the best cube of each reference box as a detection, evaluated as
  ``train_net`` evaluates; ``results.json`` in ``output_dir``);
* ``plot.mode2d``: the reference boxes are the ground truth's (``GT``, the
  default) or the 2D detector's (``PRED``: the seeded model's backbone, RPN
  and box branch, whose pooling is kernel K1); MABO and IoU3D need GT;
* ``plot.proposal_func``: one of the seven samplers of
  ``proposals.PROPOSAL_FUNCS``.

The model is BoxNet seeded with ``cfg.seed`` (the tool initialises its
weights from a seed too; it loads no ``model.weights``). Images come one at
a time (``test.batch_size``) with their depth and ground maps; the masks are
the filled 2D boxes. The samplers draw from one generator on the device,
seeded with ``cfg.seed``. With ``vis_period`` set, the AP path also draws
every ``vis_period``-th image's detections and logs the error line
(``train_net.draw_evaluation``).

Prints one JSON line: the card, the routing, the results, the images, the
seconds of the pass over them (loading and the host's statistics included,
building the model not) and the launches of the ROIAlign kernel K1.
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
from .evaluation.inference import Omni3DEvaluationHelper, detections_to_coco_json, gts_from_records
from .geometry.cuboids import cuboid_verts
from .models.boxer import SCORE_NAMES, mabo_statistics
from .models.meta_arch import build_model
from .ops import roi_align_cuda
from .train_net import card_name_and_power_limit, draw_evaluation, setup

logger = logging.getLogger("threedod_torch.eval_boxes")


def _loader(cfg, names, device):
    return TestLoader(get_dataset_dicts(names), cfg, device=device, load_maps=True)


def _seconds_since(t0: float, device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def run_proposal_eval(cfg, meta, priors, mode: str, proposal_function: str, use_pred_boxes: bool,
                      device) -> tuple:
    """MABO, IoU3D or AP over ``cfg.datasets.test`` -> (results, images,
    seconds of the pass over them, loading included)."""
    if mode not in ("MABO", "IoU3D", "AP"):
        raise ValueError(f"plot.eval must be MABO, IoU3D or AP, not {mode!r}")
    scored = mode != "AP"
    if scored and use_pred_boxes:
        raise ValueError(f"plot.eval {mode} scores proposals against the ground truth: it needs plot.mode2d GT")
    model = build_model(cfg, priors=priors).to(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    id_map_inv = {v: k for k, v in meta.thing_dataset_id_to_contiguous_id.items()}
    curves = {name: [] for name in SCORE_NAMES}
    combos, predictions, images = [], [], 0
    t0 = time.perf_counter()
    for batch, n_real in _loader(cfg, cfg.datasets.test, device):
        images += n_real
        with torch.inference_mode():
            out, boxes, classes, valid = model(batch, proposal_function, use_pred_boxes=use_pred_boxes,
                                               with_iou3d=scored, draws=gen)
            if not scored:
                det = model.to_detections(out, boxes, classes, valid, batch.im_scale_ratio)
        if scored:
            scores = {k: v.cpu().numpy() for k, v in out.scores.items()}
            iou3d, valid_np = out.iou3d.cpu().numpy(), valid.cpu().numpy()
            for i in range(n_real):
                c, k = mabo_statistics({name: s[i] for name, s in scores.items()}, iou3d[i], valid_np[i])
                for name, curve in c.items():
                    curves[name].append(curve)
                combos.append(k)
        else:
            det = type(det)(*(x[:n_real] for x in det))
            predictions.extend(detections_to_coco_json(det, batch.image_id[:n_real].cpu().numpy(), None, id_map_inv))
    seconds = _seconds_since(t0, device)

    results = {}
    if mode == "MABO":
        for name in SCORE_NAMES:
            if curves[name]:
                c = np.concatenate(curves[name], axis=0)
                results[f"MABO_{name}"] = float(c[:, 0].mean())
                results[f"ABO_best_possible_{name}"] = float(c[:, -1].mean())
        k = np.concatenate(combos, axis=0) if combos else np.zeros((0, 26))
        results["combinations_mean"] = k.mean(axis=0).tolist()
    elif mode == "IoU3D":
        c = np.concatenate(curves["combined"], axis=0)
        for thr in (0.25, 0.5):
            results[f"detection_rate@{thr}"] = float((c[:, -1] >= thr).mean())
    else:
        helper = Omni3DEvaluationHelper(list(cfg.datasets.test), meta.thing_classes,
                                        meta.thing_dataset_id_to_contiguous_id, device=device)
        for name in cfg.datasets.test:
            records = get_dataset_dicts([name])
            results[name] = helper.evaluate(name, gts_from_records(records, id_map_inv), predictions)
            if cfg.vis_period:
                draw_evaluation(cfg, meta, name, records, predictions, device)
        with open(os.path.join(cfg.output_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=1, default=float)
    return results, images, seconds


def generate_pseudo_gt(cfg, meta, priors, proposal_function: str, out_name: str, device) -> tuple:
    """The best cube of every ground-truth box of ``cfg.datasets.train`` as
    Omni3D annotations, written with the first training dataset's images and
    categories to ``<datasets.root>/Omni3D/<out_name>.json`` -> (path,
    annotations, images, seconds of the pass over them)."""
    model = build_model(cfg, priors=priors).to(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    records = get_dataset_dicts(cfg.datasets.train)
    with open(os.path.join(cfg.datasets.root, "Omni3D", f"{cfg.datasets.train[0]}.json")) as f:
        data = json.load(f)
    id_map_inv = {v: k for k, v in meta.thing_dataset_id_to_contiguous_id.items()}
    annotations = []
    rec_iter = iter(records)
    t0 = time.perf_counter()
    for batch, n_real in _loader(cfg, cfg.datasets.train, device):
        with torch.inference_mode():
            out, boxes, classes, valid = model(batch, proposal_function, with_iou3d=False, draws=gen)
        cubes = out.best_cubes.cpu().numpy()
        scores = out.best_scores.cpu().numpy()
        bxs = (boxes * batch.im_scale_ratio[:, None, None]).cpu().numpy()
        classes, valid = classes.cpu().numpy(), valid.cpu().numpy()
        corners = cuboid_verts(torch.from_numpy(cubes[..., :6]),
                               torch.from_numpy(cubes[..., 6:]).reshape(*cubes.shape[:-1], 3, 3)).numpy()
        for i in range(n_real):
            rec = next(rec_iter)
            for j in np.flatnonzero(valid[i]):
                bx, cls, R = bxs[i, j], int(classes[i, j]), cubes[i, j, 6:].reshape(3, 3)
                box = [float(x) for x in bx]
                annotations.append({
                    "id": len(annotations) + 1,
                    "image_id": rec["image_id"],
                    "dataset_id": rec.get("dataset_id", 0),
                    "category_id": id_map_inv.get(cls, cls),
                    "category_name": meta.thing_classes[cls],
                    "valid3D": True,
                    "behind_camera": False,
                    "bbox2D_proj": box,
                    "bbox2D_trunc": list(box),
                    "bbox2D_tight": list(box),
                    "bbox": [float(bx[0]), float(bx[1]), float(bx[2] - bx[0]), float(bx[3] - bx[1])],
                    "center_cam": cubes[i, j, :3].tolist(),
                    "dimensions": cubes[i, j, 3:6].tolist(),
                    "R_cam": R.tolist(),
                    "pose": R.tolist(),
                    "bbox3D_cam": corners[i, j].tolist(),
                    "truncation": 0.0,
                    "visibility": 1.0,
                    "lidar_pts": 100,
                    "segmentation_pts": 100,
                    "depth_error": 0.0,
                    "score": float(scores[i, j]),
                })
    seconds = _seconds_since(t0, device)
    data["annotations"] = annotations
    path = os.path.join(cfg.datasets.root, "Omni3D", f"{out_name}.json")
    with open(path, "w") as f:
        json.dump(data, f)
    logger.info("wrote %d pseudo ground-truth annotations to %s", len(annotations), path)
    return path, len(annotations), len(records), seconds


def run(args, device: torch.device) -> dict:
    """The tool's work on ``device`` (``main`` refuses all but a CUDA card;
    tests call this on the CPU). Returns the printed line's object."""
    cfg, meta, priors = setup(args.config_file, args.opts)
    k1 = roi_align_cuda.LAUNCHES
    if cfg.train.pseudo_gt == "pseudo":
        path, n_ann, images, seconds = generate_pseudo_gt(cfg, meta, priors, cfg.plot.proposal_func, args.pseudo_gt_out,
                                                 device)
        out = {"pseudo_gt": path, "annotations": n_ann}
    else:
        mode = cfg.plot.eval or "MABO"
        mode2d = cfg.plot.mode2d or "GT"
        if mode2d not in ("GT", "PRED"):
            raise ValueError(f"plot.mode2d must be GT or PRED, not {mode2d!r}")
        results, images, seconds = run_proposal_eval(cfg, meta, priors, mode, cfg.plot.proposal_func, mode2d == "PRED",
                                            device)
        out = {"eval": mode, "mode2d": mode2d, "results": results}
    return {**out, "proposal_function": cfg.plot.proposal_func, "images": images, "seconds": seconds,
            "k1_launches": roi_align_cuda.LAUNCHES - k1}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="BoxNet: MABO, IoU3D, AP or pseudo ground truth from a config file")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--pseudo-gt-out", default="pseudo_gt_train")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE pairs overriding the config")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.eval_boxes runs on a CUDA device; '{args.device}' is not available")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s", force=True)
    out = run(args, device)
    print(json.dumps({"device": card_name_and_power_limit(device), **out}, default=float), flush=True)


if __name__ == "__main__":
    main()
