"""Dataset statistics, result plots and ground-truth drawings: the port's
counterpart of ``tools/visualise_gt.py`` (VisualiseGT.py of the reference).

    python -m threedod_torch.visualise_gt --dataset-json datasets/Omni3D/synth_train.json
        [--image-root datasets] [--out-dir output/gt_vis] [--max-images 8] [--stats-only]
        [--run-dirs output/run_a output/run_b --run-names base weak] [--device cuda]

The same statistics as the JAX functions of the same names, each drawn by
``vis/plot.py`` into a PNG of the JAX tool's stem and written as JSON (CSV
for the 2D histogram) beside it, and returned:

* ``category_distribution``: annotations a category, most first;
* ``spatial_statistics``: the 2D box centres on a 120 x 160 grid over the
  image, normalised twice as the reference does, and the outliers;
* ``gt_stats``: the histograms (20 bins, density) of the centres' x, y, z
  and the dimensions' w, h, l with their normal fits (mean, standard
  deviation, the density over mean +- 3 sigma, the +- 1 sigma marks);
* ``vol_over_cat``: each category's mean volume and its 5 to 95 % normal
  interval;
* ``ap_vs_category_count`` and ``ap3d_vs_ap2d``: the per-category AP pairs of
  finished runs (their ``results.json``), with the linear fits and R.

Unless ``--stats-only``, the first ``--max-images`` images with annotations
are decoded on ``--device`` (``data/image_io.imread_rgb``) and their ground
truth cubes drawn as the scene view (``vis/vis.draw_scene_view``) into
``gt_<id>.png`` (the JAX tool writes JPEG). ``run(args, device)`` is the
tool's work (the tests call it on the CPU); ``main`` refuses all but a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import Counter, defaultdict

import numpy as np
import torch

from .data.image_io import imread_rgb
from .vis import draw_scene_view, write_png
from .vis.plot import BLUE, GRAY, ORANGE, Plot, row

Z95 = 1.6448536269514722  # norm.ppf(0.95)
SEC_PER_INSTANCE = (114.0, 10.15)  # full 3D annotation (the first run), weak 2D (the others)


def _dump(out_dir: str, name: str, data) -> None:
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(data, f, indent=1)


def _name(a: dict) -> str:
    return a.get("category_name", str(a["category_id"]))


# ---------------------------------------------------------------- statistics


def category_distribution(annotations, out_dir, thing_classes=None) -> dict:
    """Category counts, sorted descending (VisualiseGT.py:144-179)."""
    names = [_name(a) for a in annotations]
    if thing_classes:
        counts = {c: 0 for c in thing_classes}
        for n in names:
            if n in counts:
                counts[n] += 1
    else:
        counts = dict(Counter(names))
    counts = dict(sorted(counts.items(), key=lambda x: x[1], reverse=True))
    p = Plot(960, 420, title="Category Distribution")
    p.bar(list(counts), list(counts.values()), BLUE)
    p.save(os.path.join(out_dir, "category_distribution.png"))
    _dump(out_dir, "category_distribution.json", counts)
    return counts


def spatial_statistics(images, annotations, out_dir, std_size=(120, 160)):
    """The 2D box-centre histogram over standardised image coordinates and
    the outliers (VisualiseGT.py:180-257) -> (grid, outliers)."""
    dims_by_img = {im["id"]: (im["width"], im["height"]) for im in images}
    grid = np.zeros(std_size)
    outliers = 0
    for a in annotations:
        if a.get("ignore"):
            continue
        w0, h0 = dims_by_img.get(a["image_id"], (None, None))
        if w0 is None:
            continue
        x, y, bw, bh = a["bbox"] if "bbox" in a else a["bbox2D_tight"]
        xm = int((x + bw / 2) * std_size[1] / w0)
        ym = int((y + bh / 2) * std_size[0] / h0)
        if 0 <= xm < std_size[1] and 0 <= ym < std_size[0]:
            grid[ym, xm] += 1
        else:
            outliers += 1
    if grid.max() > 0:
        grid = grid / grid.max()
        grid[0, 0] = 0.0
        if grid.max() > 0:
            grid = grid / grid.max()
    p = Plot(480, 400, title="Histogram of 2D box centre points")
    p.heatmap(grid)
    p.save(os.path.join(out_dir, "2d_histogram.png"))
    np.savetxt(os.path.join(out_dir, "2d_histogram.csv"), grid, delimiter=",", fmt="%.17g",
               header=f"outliers {outliers}")
    return grid, outliers


def gt_stats(annotations, out_dir, sigma_overlay=True) -> dict:
    """The centres' x, y, z and the dimensions' w, h, l histograms with
    their normal fits (VisualiseGT.py:540-748): {figure stem: {axis: ...}}."""
    centers = np.asarray([a["center_cam"] for a in annotations], np.float64)
    dims = np.asarray([a["dimensions"] for a in annotations], np.float64)
    if len(centers):
        centers = centers[centers[:, 0] != -1].T
        dims = dims[dims[:, 0] != -1].T
    out = {}
    for arr, labels, stem, title in ((centers, "xyz", "center", "Center Distribution in Meters"),
                                     (dims, "whl", "dimensions", "Dimensions Distribution in Meters")):
        if arr.size == 0:
            continue
        panels, data = [], {}
        for i, label in enumerate(labels):
            p = Plot(420, 360, title=title if i == 1 else "", xlabel=label,
                     ylabel="Density" if sigma_overlay else "Count")
            heights, edges = p.hist(arr[i], bins=20, density=sigma_overlay, color=BLUE)
            entry = {"heights": heights.tolist(), "edges": edges.tolist()}
            if sigma_overlay and arr[i].std() > 0:
                mu, sigma = arr[i].mean(), arr[i].std()
                x = np.linspace(mu - 3 * sigma, mu + 3 * sigma, 100)
                pdf = np.exp(-0.5 * ((x - mu) / sigma) ** 2) / (sigma * np.sqrt(2 * np.pi))
                p.line(x, pdf, ORANGE)
                p.vlines([mu - sigma, mu + sigma], 0.0, max(heights.max(), pdf.max()), GRAY, dashed=True)
                entry.update(mu=float(mu), sigma=float(sigma), fit_x=x.tolist(), fit_pdf=pdf.tolist())
            panels.append(p.render())
            data[label] = entry
        write_png(os.path.join(out_dir, f"{stem}.png"), row(panels))
        _dump(out_dir, f"{stem}.json", data)
        out[stem] = data
    return out


def vol_over_cat(annotations, out_dir) -> dict:
    """Each category's mean volume and its 5 to 95 % normal interval
    (VisualiseGT.py:484-539), in the order the categories first occur."""
    vols = defaultdict(list)
    for a in annotations:
        v = float(np.prod(a["dimensions"]))
        if v > 0:
            vols[_name(a)].append(v)
    if not vols:
        return {}
    keys = list(vols)
    means = np.array([np.mean(vols[k]) for k in keys])
    stds = np.array([np.std(vols[k]) for k in keys])
    low, high = np.maximum(0.0, means - Z95 * stds), means + Z95 * stds
    p = Plot(960, 420, title="Category Volume Distribution", xlabel="Category", ylabel="Volume")
    p.categories(keys)
    p.vlines(np.arange(len(keys)), low, high, GRAY)
    p.scatter(np.arange(len(keys)), means, 16.0, BLUE)
    p.save(os.path.join(out_dir, "volume_distribution.png"))
    data = {"categories": keys, "mean": means.tolist(), "low": low.tolist(), "high": high.tolist()}
    _dump(out_dir, "volume_distribution.json", data)
    return data


# ---------------------------------------------------------------- result plots


def _load_percat(run_dir):
    """The per-category APs of a finished run's results.json (train_net's
    ``do_test``, eval_boxes): (AP2D by category, AP3D by category)."""
    path = os.path.join(run_dir, "results.json")
    with open(path) as f:
        results = json.load(f)
    for res in results.values():
        if isinstance(res, dict) and "percat3D" in res:
            return res.get("percat2D", {}), res["percat3D"]
    raise ValueError(f"no percat APs in {path}")


def ap_vs_category_count(run_dirs, run_names, counts, out_dir, sec_per_instance=SEC_PER_INSTANCE) -> dict:
    """AP3D against class-wise annotation time (VisualiseGT.py:258-317): x =
    the category's instances times the seconds an instance (full 3D for the
    first run, weak 2D for the others), the size from AP2D, linear fits with
    their R."""
    p = Plot(960, 640, title="AP3D vs class-wise annotation time", xlabel="Annotation time (h)", ylabel="AP3D",
             xlog=True)
    out = {}
    for ri, (rd, rn) in enumerate(zip(run_dirs, run_names)):
        percat2d, percat3d = _load_percat(rd)
        cats = [c for c in percat3d if c in counts]
        if not cats:
            continue
        scale = sec_per_instance[0] if ri == 0 else sec_per_instance[1]
        time_h = np.array([counts[c] * scale / 3600.0 for c in cats])
        ap3 = np.array([percat3d[c] for c in cats])
        ap2 = np.array([percat2d.get(c, 0.0) for c in cats])
        sizes = np.maximum(ap2 * 2, 4)
        color = BLUE if ri == 0 else ORANGE if ri == 1 else GRAY
        p.scatter(time_h, ap3, sizes, color, labels=cats)
        entry = {"categories": cats, "time_h": time_h.tolist(), "ap3d": ap3.tolist(), "ap2d": ap2.tolist(),
                 "sizes": sizes.tolist()}
        if len(cats) > 1 and time_h.std() > 0:
            r = np.corrcoef(time_h, ap3)[0, 1]
            fit = np.polyfit(time_h, ap3, 1)
            order = np.argsort(time_h)
            p.line(time_h[order], np.poly1d(fit)(time_h[order]), color, dashed=True)
            entry.update(r=float(r), fit=fit.tolist())
        out[rn] = entry
    p.save(os.path.join(out_dir, "AP_vs_no_of_classes_all.png"))
    _dump(out_dir, "AP_vs_no_of_classes_all.json", out)
    return out


def ap3d_vs_ap2d(run_dirs, run_names, out_dir, mode="standard") -> dict:
    """Per-category AP3D against AP2D across runs (VisualiseGT.py:318-381),
    both plus 0.001; ``mode`` "log" draws both axes on a log scale."""
    log = mode == "log"
    p = Plot(960, 640, title="AP in 3D vs AP in 2D", xlabel="AP2D", ylabel="AP3D", xlog=log, ylog=log)
    out = {}
    for ri, (rd, rn) in enumerate(zip(run_dirs, run_names)):
        percat2d, percat3d = _load_percat(rd)
        cats = list(percat3d)
        ap2 = np.array([percat2d.get(c, 0.0) for c in cats]) + 0.001
        ap3 = np.array([percat3d[c] for c in cats]) + 0.001
        sizes = np.maximum(ap2 * 2, 4) if mode == "standard" else None
        p.scatter(ap2, ap3, sizes, BLUE if ri == 0 else ORANGE if ri == 1 else GRAY, labels=cats)
        out[rn] = {"categories": cats, "ap2d": ap2.tolist(), "ap3d": ap3.tolist(),
                   "sizes": sizes.tolist() if sizes is not None else None}
    lo = 0.001 if log else 0.0  # the JAX tool's (0, 70) diagonal; a log axis starts it at the offset
    p.line((lo, 70), (lo, 70), BLUE, dashed=True)
    p.save(os.path.join(out_dir, f"AP3D_vs_AP2D_all_{mode}.png"))
    _dump(out_dir, f"AP3D_vs_AP2D_all_{mode}.json", out)
    return out


# ---------------------------------------------------------------------- main


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset-json", required=True)
    ap.add_argument("--image-root", default="datasets")
    ap.add_argument("--out-dir", default="output/gt_vis")
    ap.add_argument("--max-images", type=int, default=8)
    ap.add_argument("--stats-only", action="store_true")
    ap.add_argument("--run-dirs", nargs="*", default=[], help="finished run dirs containing results.json")
    ap.add_argument("--run-names", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    return ap


def run(args, device) -> dict:
    """The tool's work; returns every statistic it drew and the drawings' files."""
    t0 = time.perf_counter()
    with open(args.dataset_json) as f:
        data = json.load(f)
    os.makedirs(args.out_dir, exist_ok=True)
    annotations = data["annotations"]
    counts = Counter(_name(a) for a in annotations)
    depths = np.asarray([a["center_cam"][2] for a in annotations])
    dims = np.asarray([a["dimensions"] for a in annotations])
    print(f"images: {len(data['images'])}  annotations: {len(annotations)}")
    print("category counts:", dict(counts.most_common()))
    if len(depths):
        print(f"depth: mean {depths.mean():.2f} m, p10 {np.percentile(depths, 10):.2f}, "
              f"p90 {np.percentile(depths, 90):.2f}")
        print(f"dims (whl) mean: {dims.mean(0).round(2).tolist()}")
    out = {"category_distribution": category_distribution(annotations, args.out_dir)}
    out["grid"], out["outliers"] = spatial_statistics(data["images"], annotations, args.out_dir)
    out["gt_stats"] = gt_stats(annotations, args.out_dir)
    out["vol_over_cat"] = vol_over_cat(annotations, args.out_dir)
    print(f"dataset-stat figures -> {args.out_dir}")
    if args.run_dirs:
        names = args.run_names or [os.path.basename(d.rstrip("/")) for d in args.run_dirs]
        out["ap_vs_category_count"] = ap_vs_category_count(args.run_dirs, names, counts, args.out_dir)
        out["ap3d_vs_ap2d"] = {mode: ap3d_vs_ap2d(args.run_dirs, names, args.out_dir, mode)
                               for mode in ("standard", "log")}
        print(f"result plots for {len(args.run_dirs)} runs -> {args.out_dir}")
    out["drawn"] = []
    if not args.stats_only:
        per_image = {}
        for a in annotations:
            per_image.setdefault(a["image_id"], []).append(a)
        for im in data["images"][:args.max_images]:
            annos = per_image.get(im["id"], [])
            if not annos:
                continue
            img = imread_rgb(os.path.join(args.image_root, im["file_path"]), device).cpu().numpy()
            corners = np.asarray([a["bbox3D_cam"] for a in annos])
            drawing = draw_scene_view(img, np.asarray(im["K"]), corners, labels=[a["category_name"] for a in annos])
            path = os.path.join(args.out_dir, f"gt_{im['id']:06d}.png")
            write_png(path, drawing)
            out["drawn"].append(path)
            print(f"wrote {path}")
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.visualise_gt runs on a CUDA device; '{args.device}' is not available")
    out = run(args, device)
    print(json.dumps({"device": torch.cuda.get_device_name(device), "drawn": len(out["drawn"]),
                      "outliers": out["outliers"], "seconds": out["seconds"]}), flush=True)
    return out


if __name__ == "__main__":
    main()
