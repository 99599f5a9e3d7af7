"""Per-category priors of the 3D dimensions and depths, pickled for the
proposal method: the port's counterpart of ``tools/priors.py`` (priors.py of
the reference repository's root, :1-101).

    python -m threedod_torch.priors --config-file configs/Base_Synth.yaml
        [--out tools/priors.pkl] [--typical-sizes-csv sizes.csv] [KEY VALUE ...]

The config's training datasets are read and filtered as the config says,
``data/priors.compute_priors`` computes the priors over the config's
categories (or every category of the datasets, sorted), and a category left
at the unit size takes its width, height and depth from the typical-sizes
table where it has a row (its spread 0.3 of each). Writes
``{"categories": [...], **priors}`` with ``pickle``; host work only, in
numpy. ``run(args)`` returns what the last line prints.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import pickle
import time

from .config_yaml import load_config
from .data.omni3d import Omni3D, get_filter_settings_from_cfg
from .data.priors import compute_priors


def load_typical_sizes_csv(path: str) -> dict:
    """The 38-category width / height / depth fallback table (priors.py:95):
    lower-case name -> [width, height, depth]."""
    out = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            name = row.get("category", row.get("name", "")).strip().lower()
            try:
                out[name] = [float(row.get("width", 1.0)), float(row.get("height", 1.0)),
                             float(row.get("depth", row.get("length", 1.0)))]
            except (TypeError, ValueError):
                continue
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--out", default="tools/priors.pkl")
    ap.add_argument("--typical-sizes-csv", default="")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return ap


def run(args) -> dict:
    t0 = time.perf_counter()
    cfg = load_config(args.config_file, args.opts)
    fs = get_filter_settings_from_cfg(cfg)
    datasets = Omni3D([os.path.join(cfg.datasets.root, "Omni3D", f"{n}.json") for n in cfg.datasets.train],
                      filter_settings=fs)
    categories = sorted(fs["category_names"]) if fs["category_names"] else sorted(
        {c["name"] for c in datasets.dataset["categories"]})
    priors = compute_priors(cfg, datasets, categories)
    if args.typical_sizes_csv and os.path.exists(args.typical_sizes_csv):
        typical = load_typical_sizes_csv(args.typical_sizes_csv)
        for i, cat in enumerate(categories):
            if priors["priors_dims_per_cat"][i][0] == [1.0, 1.0, 1.0] and cat in typical:
                priors["priors_dims_per_cat"][i][0] = typical[cat]
                priors["priors_dims_per_cat"][i][1] = [0.3 * d for d in typical[cat]]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump({"categories": categories, **priors}, f)
    print(f"wrote priors for {len(categories)} categories -> {args.out}", flush=True)
    return {"categories": len(categories), "out": args.out, "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    print(json.dumps(run(parser().parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
