"""The ``propose`` sampler's linear centre coefficients, fitted anew: the
port's counterpart of ``tools/fit_proposal_coefs.py``
(ProposalNetwork/proposals/find_conditions.py of the reference).

    python -m threedod_torch.fit_proposal_coefs --config-file configs/BoxNet_Synth.yaml
        [--grid-points 16] [--plot-dir output/coef_fit] [--device cuda] [KEY VALUE ...]

``train_net.setup`` reads the config and registers its datasets. For every
training image with a depth map, each ground-truth box (a category id of 0
or more) takes the sampler's grid of ``--grid-points`` points across the box
shrunk by a quarter, unprojected through the depth map
(``proposals._depth_grid_centers``, one call an image for all its boxes, on
``--device``), and gives three (median, ground truth) pairs: x, y, and z
with half the box's length added to the median. ``gt = a median + b`` is
fitted to each axis by least squares in float64 and printed with the
residuals' spread, as the JAX tool prints it (the sampler hard-codes x 1.15
x, y 1.1 y, z 0.85 z + 0.35). ``--plot-dir`` draws each axis's pairs and
line with ``vis/plot.py`` into ``<axis>_values_to_find.png``, the pairs
beside it in ``<axis>_values_to_find.csv`` and the fits in
``coefficients.json``. ``run(args, device)`` returns the pairs and fits (the
tests call it on the CPU); ``main`` refuses all but a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .data.build import get_dataset_dicts
from .proposals.proposals import _depth_grid_centers, _median
from .train_net import setup
from .vis.plot import Plot

AXES = ("x", "y", "z")


def collect_pairs(dicts, grid_points: int, device) -> dict:
    """{axis: float64 (N, 2) of (median unprojection, ground-truth centre)}."""
    pairs = {a: [] for a in AXES}
    for d in dicts:
        dp = d.get("depth_image_path")
        if not dp or not os.path.exists(dp):
            continue
        annos = [a for a in d["annotations"] if a.get("category_id", -1) >= 0]
        if not annos:
            continue
        with np.load(dp) as z:
            depth = np.asarray(z["depth"] if "depth" in z else z[z.files[0]], np.float32)
        boxes = np.asarray([a["bbox"] for a in annos], np.float32)
        boxes = np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 0] + boxes[:, 2], boxes[:, 1] + boxes[:, 3]], -1)
        x, y, zt = _depth_grid_centers(torch.from_numpy(boxes)[None].to(device), torch.from_numpy(depth)[None].to(device),
                                       torch.as_tensor(np.asarray(d["K"], np.float32))[None].to(device), grid_points)
        medians = torch.stack([_median(v)[0] for v in (x, y, zt)], -1).cpu().numpy()
        for (mx, my, mz), a in zip(medians.tolist(), annos):
            cx, cy, cz = a["center_cam"]
            dims = a.get("dimensions", [0.0, 0.0, 0.0])
            pairs["x"].append((mx, cx))
            pairs["y"].append((my, cy))
            pairs["z"].append((mz + float(dims[2]) / 2.0, cz))
    return {a: np.asarray(v, np.float64).reshape(-1, 2) for a, v in pairs.items()}


def fit(arr: np.ndarray):
    """(a, b, the residuals' standard deviation) of gt = a median + b."""
    A = np.stack([arr[:, 0], np.ones(len(arr))], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, arr[:, 1], rcond=None)
    resid = arr[:, 1] - (a * arr[:, 0] + b)
    return float(a), float(b), float(resid.std())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--grid-points", type=int, default=16)
    ap.add_argument("--plot-dir", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return ap


def run(args, device) -> dict:
    t0 = time.perf_counter()
    cfg, _, _ = setup(args.config_file, args.opts)
    pairs = collect_pairs(get_dataset_dicts(cfg.datasets.train), args.grid_points, torch.device(device))
    if not len(pairs["x"]):
        print("no (median, gt) pairs collected — dataset has no depth maps?")
        return {"pairs": pairs, "fits": {}, "seconds": time.perf_counter() - t0}
    print(f"{len(pairs['x'])} GT boxes")
    fits = {}
    for axis in AXES:
        arr = pairs[axis]
        a, b, rms = fits[axis] = fit(arr)
        print(f"{axis}: gt = {a:+.4f} * median {b:+.4f}   (rms {rms:.3f} m)")
        if args.plot_dir:
            os.makedirs(args.plot_dir, exist_ok=True)
            p = Plot(600, 450, xlabel=f"median unprojected {axis}", ylabel=f"gt center {axis}")
            p.scatter(arr[:, 0], arr[:, 1], 4.0)
            xs = np.linspace(arr[:, 0].min(), arr[:, 0].max(), 50)
            p.line(xs, a * xs + b)
            stem = os.path.join(args.plot_dir, f"{axis}_values_to_find")
            p.save(stem + ".png")
            np.savetxt(stem + ".csv", arr, delimiter=",", fmt="%.17g", header="median,gt", comments="")
    if args.plot_dir:
        with open(os.path.join(args.plot_dir, "coefficients.json"), "w") as f:
            json.dump({axis: dict(zip(("a", "b", "rms"), v)) for axis, v in fits.items()}, f, indent=1)
    return {"pairs": pairs, "fits": fits, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.fit_proposal_coefs runs on a CUDA device; '{args.device}' is not "
                           f"available")
    return 0 if run(args, device)["fits"] else 1


if __name__ == "__main__":
    sys.exit(main())
