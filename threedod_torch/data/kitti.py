"""KITTI interop: Omni3D <-> KITTI txt formats (counterpart of
``threedod/data/kitti.py``, numpy only).

After cubercnn/data/Omni_to_kitti.py (:20-166 incl. the
`calculate_alpha` observation-angle math and its golden test rows),
kitti_gt.py (GT export), make_dummy_dataset.py (annotation-free test json).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

KITTI_CLASS_MAP = {
    "pedestrian": "Pedestrian",
    "car": "Car",
    "cyclist": "Cyclist",
    "van": "Van",
    "truck": "Truck",
}


def perp_vector(x, z):
    """2D vector perpendicular to (x, z) (Omni_to_kitti.py:10-11)."""
    return np.array([z, -x])


def calculate_alpha(location, ry):
    """Observation angle alpha from location + yaw (Omni_to_kitti.py:20-47)."""
    ry = -ry
    x, _, z = location
    perpendicular = perp_vector(x, z)
    ry_vector = np.array([np.cos(ry), np.sin(ry)])
    dot = perpendicular[0] * ry_vector[0] + perpendicular[1] * ry_vector[1]
    det = perpendicular[0] * ry_vector[1] - perpendicular[1] * ry_vector[0]
    alpha = -np.arctan2(det, dot)
    if alpha > np.pi:
        alpha -= 2 * np.pi
    if alpha < -np.pi:
        alpha += 2 * np.pi
    return alpha


def pose_to_ry(R: np.ndarray) -> float:
    """KITTI rotation_y from a camera-frame rotation matrix.

    KITTI's ry is the yaw about the camera Y axis; recovered from the
    orientation of the box's local X axis in the XZ plane.
    """
    # local +X axis in camera coords is the first column
    x_axis = np.asarray(R)[:, 0]
    return float(-np.arctan2(x_axis[2], x_axis[0]))


def detection_to_kitti_line(category: str, bbox_xyxy, dims_whl, center_cam, R, score: Optional[float] = None, truncated=0.0, occluded=0) -> str:
    """One KITTI label line.

    KITTI dims order is (h, w, l); location is the BOTTOM center of the box;
    Omni3D center_cam is the geometric center -> shift y by +h/2.
    """
    w3d, h3d, l3d = dims_whl
    x, y, z = center_cam
    ry = pose_to_ry(R)
    alpha = calculate_alpha(center_cam, ry)
    fields = [
        KITTI_CLASS_MAP.get(category, category.capitalize()),
        f"{truncated:.2f}",
        str(occluded),
        f"{alpha:.2f}",
        f"{bbox_xyxy[0]:.2f}", f"{bbox_xyxy[1]:.2f}", f"{bbox_xyxy[2]:.2f}", f"{bbox_xyxy[3]:.2f}",
        f"{h3d:.2f}", f"{w3d:.2f}", f"{l3d:.2f}",
        f"{x:.2f}", f"{y + h3d / 2:.2f}", f"{z:.2f}",
        f"{ry:.2f}",
    ]
    if score is not None:
        fields.append(f"{score:.4f}")
    return " ".join(fields)


def export_predictions_to_kitti(predictions: List[dict], categories: Dict[int, str], out_dir: str, image_id_to_name=None):
    """COCO-style prediction records -> per-image KITTI txt files."""
    os.makedirs(out_dir, exist_ok=True)
    per_image: Dict[int, list] = {}
    for p in predictions:
        per_image.setdefault(p["image_id"], []).append(p)
    for image_id, preds in per_image.items():
        name = (
            image_id_to_name[image_id]
            if image_id_to_name
            else f"{image_id:06d}"
        )
        lines = []
        for p in preds:
            x, y, w, h = p["bbox"]
            lines.append(
                detection_to_kitti_line(
                    categories.get(p["category_id"], str(p["category_id"])),
                    [x, y, x + w, y + h],
                    p["dimensions"],
                    p["center_cam"],
                    np.asarray(p["pose"]),
                    score=p.get("score"),
                )
            )
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
    return out_dir


def export_gt_to_kitti(records: List[dict], categories: Dict[int, str], out_dir: str):
    """Dataset records -> KITTI GT label files (kitti_gt.py parity)."""
    os.makedirs(out_dir, exist_ok=True)
    for rec in records:
        lines = []
        for anno in rec.get("annotations", []):
            if anno["category_id"] < 0:
                continue
            x, y, w, h = anno["bbox"]
            lines.append(
                detection_to_kitti_line(
                    categories.get(anno["category_id"], "unknown"),
                    [x, y, x + w, y + h],
                    anno["dimensions"],
                    anno["center_cam"],
                    np.asarray(anno["pose"]),
                )
            )
        with open(os.path.join(out_dir, f"{rec['image_id']:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
    return out_dir


def make_dummy_dataset(src_json: str, out_json: str):
    """Annotation-free copy of a dataset json (make_dummy_dataset.py)."""
    with open(src_json) as f:
        data = json.load(f)
    data["annotations"] = []
    with open(out_json, "w") as f:
        json.dump(data, f)
    return out_json


def copy_val_split(val_file: str, src_folder: str, dest_folder: str, ext: str = ".png"):
    """Copy the validation-split images listed in `val_file` (one stem per
    line) from `src_folder` to `dest_folder` (cubercnn/data/kitti_split.py).
    Returns the list of copied file names; silently skips missing files
    like the reference does."""
    os.makedirs(dest_folder, exist_ok=True)
    copied = []
    with open(val_file) as f:
        for line in f:
            name = line.strip()
            if not name:
                continue
            file_name = name + ext
            src = os.path.join(src_folder, file_name)
            if os.path.exists(src):
                shutil.copy(src, dest_folder)
                copied.append(file_name)
    return copied


# gt categories the z-overwrite matcher ignores (kitti_pred_overwrite_z.py:33)
_OVERWRITE_SKIP = {"DontCare", "Misc", "Tram", "Person_sitting"}


def _iou_matrix_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) XYXY IoU (reference util.iou, math_util.py:1001)."""
    ax1, ay1, ax2, ay2 = a[:, 0, None], a[:, 1, None], a[:, 2, None], a[:, 3, None]
    bx1, by1, bx2, by2 = b[None, :, 0], b[None, :, 1], b[None, :, 2], b[None, :, 3]
    iw = np.clip(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0, None)
    ih = np.clip(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0, None)
    inter = iw * ih
    area_a = np.clip(ax2 - ax1, 0, None) * np.clip(ay2 - ay1, 0, None)
    area_b = np.clip(bx2 - bx1, 0, None) * np.clip(by2 - by1, 0, None)
    return inter / np.clip(area_a + area_b - inter, 1e-9, None)


def overwrite_pred_z(dt_lines: List[str], gt_lines: List[str], iou_thresh: float = 0.7) -> List[str]:
    """Overwrite each prediction's z (KITTI txt field 13) with the z of any
    GT whose 2D box overlaps it at IoU >= `iou_thresh`
    (cubercnn/data/kitti_pred_overwrite_z.py).

    GTs with category DontCare/Misc/Tram/Person_sitting or truncation ==
    1.00 are excluded from matching. NOTE a deliberate fix vs the
    reference: it builds the IoU matrix over the FILTERED gt boxes but then
    reads `gt[j][13]` from the UNFILTERED list, mis-assigning z whenever a
    skipped gt precedes a match; here the kept-gt indices are mapped back
    to the original rows."""
    dt = [d.split() for d in dt_lines]
    gt = [g.split() for g in gt_lines]
    if not dt:
        return list(dt_lines)
    kept = [
        j for j, g in enumerate(gt)
        if g[0] not in _OVERWRITE_SKIP and float(g[1]) != 1.00
    ]
    if kept:
        dt_boxes = np.array([[float(v) for v in d[4:8]] for d in dt])
        gt_boxes = np.array([[float(v) for v in gt[j][4:8]] for j in kept])
        valid = _iou_matrix_xyxy(dt_boxes, gt_boxes) >= iou_thresh
        for i in range(valid.shape[0]):
            for jj in range(valid.shape[1]):
                if valid[i, jj]:
                    dt[i][13] = gt[kept[jj]][13]
    return [" ".join(d) + "\n" for d in dt]


def overwrite_pred_z_dir(pred_dir: str, gt_dir: str, iou_thresh: float = 0.7) -> int:
    """Apply `overwrite_pred_z` in place to every file in `pred_dir`
    against the same-named GT file in `gt_dir`; returns #files rewritten."""
    n = 0
    for path in sorted(os.listdir(pred_dir)):
        full = os.path.join(pred_dir, path)
        gt_path = os.path.join(gt_dir, path)
        if not os.path.isfile(full) or not os.path.exists(gt_path):
            continue
        with open(gt_path) as f:
            gt_lines = f.readlines()
        with open(full) as f:
            dt_lines = f.readlines()
        out = overwrite_pred_z(dt_lines, gt_lines, iou_thresh)
        # compare whitespace-normalized: overwrite_pred_z rebuilds every
        # line with split/join, so raw-string comparison would count files
        # whose formatting merely differs as "rewritten"
        if [l.split() for l in out] != [l.split() for l in dt_lines]:
            with open(full, "w") as f:
                f.writelines(out)
            n += 1
    return n
