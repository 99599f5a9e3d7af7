"""Overwrite predicted z with matched ground truth's z in KITTI-format
prediction files: the port's counterpart of ``tools/kitti_pred_overwrite_z.py``
(cubercnn/data/kitti_pred_overwrite_z.py, the depth-oracle ablation, its
fixed paths made flags).

    python -m threedod_torch.kitti_pred_overwrite_z
        [--pred-dir output/kitti_val_ours_K/KITTI_formatted_predictions]
        [--gt-dir datasets/label_2_omni] [--iou-thresh 0.7]

Every ground-truth 2D box overlapping a detection at IoU >= ``--iou-thresh``
gives the detection its z (field 13); ``data/kitti.overwrite_pred_z`` says
which ground truth is skipped and how its rows are indexed.
"""
from __future__ import annotations

import argparse

from .data.kitti import overwrite_pred_z_dir


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Overwrite predicted z with matched ground truth's z")
    ap.add_argument("--pred-dir", default="output/kitti_val_ours_K/KITTI_formatted_predictions")
    ap.add_argument("--gt-dir", default="datasets/label_2_omni")
    ap.add_argument("--iou-thresh", type=float, default=0.7)
    args = ap.parse_args(argv)
    n = overwrite_pred_z_dir(args.pred_dir, args.gt_dir, args.iou_thresh)
    print(f"rewrote {n} prediction files")


if __name__ == "__main__":
    main()
