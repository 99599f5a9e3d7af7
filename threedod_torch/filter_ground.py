"""Remove near-empty ground masks and rebuild the list of images without
ground (counterpart of ``tools/filter_ground.py``).

    python -m threedod_torch.filter_ground [--ground-dir datasets/ground_maps]
        [--no-ground-csv datasets/no_ground_idx.csv] [--min-fraction 0.01]

A mask (``<id>.npz``, key ``mask``) that covers less than ``--min-fraction``
of its image is deleted and its id added to the CSV, merged with the ids the
CSV already holds, sorted, under the header ``img_id``. Host work on numpy
arrays only: it runs on no device. Prints one line a removed mask and a
summary, as the JAX tool does.
"""
from __future__ import annotations

import argparse
import csv
import os


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ground-dir", default="datasets/ground_maps")
    ap.add_argument("--no-ground-csv", default="datasets/no_ground_idx.csv")
    ap.add_argument("--min-fraction", type=float, default=0.01)
    return ap


def run(args) -> dict:
    import numpy as np

    removed = []
    for fname in sorted(os.listdir(args.ground_dir)):
        if not fname.endswith(".npz"):
            continue
        path = os.path.join(args.ground_dir, fname)
        with np.load(path) as z:
            frac = float(z["mask"].astype(bool).mean())
        if frac < args.min_fraction:
            os.remove(path)
            try:
                removed.append(int(fname.split(".")[0]))
            except ValueError:
                pass
            print(f"removed {fname} (fraction {frac:.4f})")
    existing = []
    if os.path.exists(args.no_ground_csv):
        with open(args.no_ground_csv) as f:
            existing = [int(r["img_id"]) for r in csv.DictReader(f)]
    all_ids = sorted(set(existing) | set(removed))
    os.makedirs(os.path.dirname(args.no_ground_csv) or ".", exist_ok=True)
    with open(args.no_ground_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["img_id"])
        for i in all_ids:
            w.writerow([i])
    print(f"{len(removed)} masks removed; {len(all_ids)} ids in {args.no_ground_csv}")
    return {"removed": removed, "ids": all_ids}


def main(argv=None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
