"""Copy the KITTI validation-split images into their own folder: the port's
counterpart of ``tools/kitti_split.py`` (cubercnn/data/kitti_split.py, its
fixed paths made flags).

    python -m threedod_torch.kitti_split [--val-file datasets/val.txt]
        [--src-folder datasets/KITTI_object/training/image_2]
        [--dest-folder datasets/KITTI_object/val/image_2] [--ext .png]
"""
from __future__ import annotations

import argparse

from .data.kitti import copy_val_split


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Copy the KITTI validation-split images into their own folder")
    ap.add_argument("--val-file", default="datasets/val.txt")
    ap.add_argument("--src-folder", default="datasets/KITTI_object/training/image_2")
    ap.add_argument("--dest-folder", default="datasets/KITTI_object/val/image_2")
    ap.add_argument("--ext", default=".png")
    args = ap.parse_args(argv)
    copied = copy_val_split(args.val_file, args.src_folder, args.dest_folder, args.ext)
    print(f"copied {len(copied)} images to {args.dest_folder}")


if __name__ == "__main__":
    main()
