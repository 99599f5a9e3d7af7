"""Inference over a test set and the evaluation helper (the port's copy of
``threedod/evaluation/inference.py``, after
cubercnn/evaluation/omni3d_evaluation.py: ``inference_on_dataset``'s timing
:523-641, ``instances_to_coco_json`` :966-1014, ``Omni3DEvaluationHelper``
:168-520, per-dataset 2D and 3D AP with proximity evaluation for
non-exhaustive datasets, and the union of the datasets re-accumulated).

Under a process group each rank infers its share of the test set (the
``TestLoader`` gives it a contiguous run of batches) and
``gather_predictions`` collects the shares on every rank, in rank order, so
the predictions are in the dataset's order and tied scores meet the order of
one process. The caller evaluates on rank 0.
"""
from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from ..parallel import dist
from .omni3d_eval import Omni3DEval

logger = logging.getLogger(__name__)

def gather_predictions(predictions: List[dict]) -> List[dict]:
    """Every rank's prediction records, concatenated in rank order, on every
    rank (host objects, which gloo gathers too); the list itself without a
    process group. Counterpart of the reference's ``comm.gather``
    (omni3d_evaluation.py:636-641)."""
    if not dist.active():
        return predictions
    return [p for part in dist.all_gather_objects(predictions) for p in part]


# datasets annotated non-exhaustively -> proximity evaluation
# (reference omni3d_evaluation.py:675 & dataset docs)
PROX_DATASETS = {"Objectron", "nuScenes"}


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def detections_to_coco_json(det, image_ids, ratios, id_map_inv=None, score_thresh: float = 0.0) -> List[dict]:
    """Convert a batched Detections struct to COCO-style record dicts.

    Boxes come back at original resolution already; the 3D fields are in
    camera space (meters). id_map_inv maps contiguous -> dataset category id.
    """
    det = {k: _numpy(v) for k, v in det._asdict().items()}
    out = []
    b, d = det["valid"].shape
    for i in range(b):
        for j in range(d):
            if not det["valid"][i, j] or det["scores"][i, j] <= score_thresh:
                continue
            x1, y1, x2, y2 = det["boxes"][i, j].tolist()
            cat = int(det["classes"][i, j])
            if id_map_inv is not None:
                cat = id_map_inv.get(cat, cat)
            out.append(
                {
                    "image_id": int(image_ids[i]),
                    "category_id": cat,
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "score": float(det["scores"][i, j]),
                    "depth": float(det["center_cam"][i, j, 2]),
                    "area": float(max(x2 - x1, 0) * max(y2 - y1, 0)),
                    "bbox3D": det["corners3d"][i, j].tolist(),
                    "center_cam": det["center_cam"][i, j].tolist(),
                    "center_2D": det["center_2d"][i, j].tolist(),
                    "dimensions": det["dimensions"][i, j].tolist(),
                    "pose": det["pose"][i, j].tolist(),
                }
            )
    return out


def group_predictions_by_image(predictions: List[dict], records: List[dict]) -> List[dict]:
    """Group flat prediction records into the per-image instance-dump format
    the reference stores as instances_predictions.pth and feeds to
    vis.visualize_from_instances (omni3d_evaluation.py:966-1014: each entry
    carries image_id, K, width, height and an 'instances' list)."""
    by_img = defaultdict(list)
    for p in predictions:
        by_img[p["image_id"]].append(p)
    out = []
    for rec in records:
        out.append(
            {
                "image_id": rec["image_id"],
                "K": np.asarray(rec["K"]).tolist(),
                "width": rec["width"],
                "height": rec["height"],
                "instances": by_img.get(rec["image_id"], []),
            }
        )
    return out


def gts_from_records(records: List[dict], id_map_inv=None) -> List[dict]:
    """Eval-ready GT dicts from loader records (original resolution).

    Loader records carry CONTIGUOUS category ids (load_omni3d_json); pass
    the same contiguous->dataset `id_map_inv` given to inference_on_dataset
    so GTs land in the same id space as the predictions — with only one
    side mapped every match fails and AP silently reads 0.
    """
    gts = []
    gid = 0
    for rec in records:
        for anno in rec.get("annotations", []):
            gid += 1
            x, y, w, h = anno["bbox"]
            cat = anno["category_id"]
            if id_map_inv is not None and cat >= 0:
                cat = id_map_inv.get(cat, cat)
            gts.append(
                {
                    "id": gid,
                    "image_id": rec["image_id"],
                    "category_id": cat,
                    "bbox": [x, y, w, h],
                    "area": w * h,
                    "depth": float(anno["center_cam"][2]),
                    "ignore": bool(anno.get("ignore", False)) or cat < 0,
                    "ignore2D": bool(anno.get("ignore", False)) or cat < 0,
                    "ignore3D": bool(anno.get("ignore", False)) or cat < 0,
                    "bbox3D": anno["bbox3D_cam"],
                }
            )
    return gts


def inference_on_dataset(infer_fn, loader, id_map_inv=None, warmup: int = 5) -> tuple:
    """Run inference over a TestLoader; returns (predictions, timing dict).
    ``infer_fn(batch)`` -> Detections; the step's time ends when they are
    on the host. Times the data and compute phases after ``warmup`` steps
    (omni3d_evaluation.py:548-631). Under a process group the loader holds
    this rank's share: the timing is this rank's, and the predictions are
    every rank's (``gather_predictions``)."""
    predictions = []
    n_images = 0
    n_timed = 0
    t_data = t_compute = 0.0
    steps = 0
    t0 = time.perf_counter()
    t_last = t0
    for batch, n_real in loader:
        t_in = time.perf_counter()
        det = infer_fn(batch)
        det = type(det)(*[_numpy(x) for x in det])  # waits for the device
        t_out = time.perf_counter()
        if steps >= warmup:
            t_data += t_in - t_last
            t_compute += t_out - t_in
            n_timed += n_real
        image_ids = _numpy(batch.image_id)[:n_real]
        det_trim = type(det)(*[x[:n_real] for x in det])
        predictions.extend(
            detections_to_coco_json(det_trim, image_ids, _numpy(batch.im_scale_ratio), id_map_inv)
        )
        n_images += n_real
        steps += 1
        t_last = time.perf_counter()
    total = time.perf_counter() - t0
    predictions = gather_predictions(predictions)
    timed_steps = max(steps - warmup, 1)
    timing = {
        "total_s": total,
        "images": n_images,
        "s_per_iter_data": t_data / timed_steps,
        "s_per_iter_compute": t_compute / timed_steps,
        # rate over the steps after the warm-up (omni3d_evaluation.py:556)
        "images_per_s": (
            n_timed / (t_data + t_compute)
            if n_timed and (t_data + t_compute) > 0
            else (n_images / total if total > 0 else 0.0)
        ),
    }
    return predictions, timing


class Omni3DEvaluationHelper:
    """Per-dataset 2D/3D AP + cross-dataset union accumulation."""

    def __init__(self, dataset_names: List[str], category_names: List[str], id_map: Dict[int, int],
                 device="cpu"):
        self.device = device  # where the 3D IoUs are computed
        self.dataset_names = dataset_names
        self.category_names = category_names
        self.id_map = id_map  # dataset cat id -> contiguous
        self.id_map_inv = {v: k for k, v in id_map.items()}
        self.results: Dict[str, dict] = {}
        self._union_evals = {"2D": [], "3D": []}

    def _cat_name(self, dataset_id) -> str:
        ci = self.id_map.get(dataset_id)
        if ci is not None and 0 <= ci < len(self.category_names):
            return self.category_names[ci]
        return str(dataset_id)

    def evaluate(self, dataset_name: str, gts: List[dict], dts: List[dict]) -> dict:
        eval_prox = any(dataset_name.startswith(p) for p in PROX_DATASETS)
        res = {}
        for mode in ("2D", "3D"):
            ev = Omni3DEval(gts, dts, mode=mode, eval_prox=eval_prox, device=self.device)
            ev.evaluate()
            ev.accumulate()
            stats = ev.summarize()
            res[f"AP{mode}"] = stats[0] * 100
            if mode == "3D":
                res["AP3D@15"] = stats[1] * 100
                res["AP3D@25"] = stats[2] * 100
                res["AP3D@50"] = stats[3] * 100
                res["AP3D_near"] = stats[4] * 100
                res["AP3D_med"] = stats[5] * 100
                res["AP3D_far"] = stats[6] * 100
            # category ids are dataset ids on both sides; key the table by
            # category NAME (the reference's logperf tables and the
            # VisualiseGT result plots both consume names)
            res[f"percat{mode}"] = {
                self._cat_name(c): ap * 100 for c, ap in ev.per_category_ap().items()
            }
            self._union_evals[mode].append(ev)
        self.results[dataset_name] = res
        return res

    def summarize_all(self) -> dict:
        """Concatenated re-accumulation across datasets (ref :378-520)."""
        out = dict(self.results)
        if len(self._union_evals["2D"]) > 1:
            union = {}
            for mode in ("2D", "3D"):
                gts, dts = [], []
                for ev in self._union_evals[mode]:
                    gts.extend(ev._raw_gts)
                    dts.extend(ev._raw_dts)
                ev_all = Omni3DEval(gts, dts, mode=mode, eval_prox=False, device=self.device)
                ev_all.evaluate()
                ev_all.accumulate()
                union[f"AP{mode}"] = ev_all.summarize()[0] * 100
            out["<Union>"] = union
        return out
