"""The port's remaining user tools (``python -m threedod_torch.
{depth_to_pointcloud, fit_proposal_coefs, priors, datasetminify,
grid_effect, visualise_gt, results, mabo_plots}``) against the JAX tools in
``tools/`` (imported by file path) on the CPU.

* ``depth_to_pointcloud``: vits at a 56 px input on a fixture JPEG and a PNG,
  the weights a port state dict that the JAX side converts; the PLY's header
  and colours equal, its points within 1e-4 of the largest coordinate;
* ``fit_proposal_coefs`` on ``configs/BoxNet_Synth.yaml``: every (median,
  ground truth) pair within 1e-5 of the JAX tool's loop (its jitted
  ``_depth_grid_centers`` and ``jnp.median``), the coefficients within 1e-5,
  the printed lines equal to the JAX tool's; the plot's CSV holds the pairs;
* the priors pickle, the minified JSON (three ways) and the printed IoU
  losses equal to the JAX tools';
* ``visualise_gt``, ``results`` and ``mabo_plots``: every number the JAX
  functions plot, read from the matplotlib figures they save (bar heights,
  histogram densities, normal fits, the heatmap, the volume intervals, the AP
  scatters and fits, the metric series, the MABO bars), equal to what the
  port's functions return and write beside their figures; the printed lines
  equal; every PNG re-read by ``vis/png``.
"""
from __future__ import annotations

import csv
import importlib.util
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from threedod.models.depth import dpt as jdpt
from threedod.utils.convert_weights import convert_depth_anything_v2
from threedod_torch import (datasetminify, depth_to_pointcloud, fit_proposal_coefs, grid_effect, mabo_plots, priors,
                            results, visualise_gt)
from threedod_torch.data.image_io import imread_rgb
from threedod_torch.models.depth.dpt import build_depth_model
from threedod_torch.ops import png
from threedod_torch.vis import draw_scene_view, read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "datasets", "synth", "images")
TRAIN_JSON = os.path.join(ROOT, "datasets", "Omni3D", "synth_train.json")


def _tool(name: str):
    """``tools/<name>.py`` as a module (the tools are scripts, not a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    return module.main()


@pytest.fixture
def figures(monkeypatch):
    """What each figure the JAX tools save holds, by file name: per axes,
    the bars, the lines' points, the images, the collections' offsets,
    sizes and segments, and the tick labels."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    saved = {}

    def savefig(path, *args, **kwargs):
        fig = plt.gcf()
        fig.canvas.draw()
        saved[os.path.basename(path)] = [dict(
            bars=[(p.get_x() + p.get_width() / 2, p.get_y() + p.get_height() / 2, p.get_width(), p.get_height())
                  for p in ax.patches],
            lines=[np.asarray(line.get_xydata(), np.float64) for line in ax.lines],
            images=[np.asarray(im.get_array()) for im in ax.images],
            collections=[(np.asarray(c.get_offsets(), np.float64),
                          np.asarray(c.get_sizes(), np.float64) if hasattr(c, "get_sizes") else None,
                          [np.asarray(s) for s in c.get_segments()] if hasattr(c, "get_segments") else None)
                         for c in ax.collections],
            xticks=[t.get_text() for t in ax.get_xticklabels()],
            yticks=[t.get_text() for t in ax.get_yticklabels()]) for ax in fig.axes]

    monkeypatch.setattr(plt, "savefig", savefig)
    return saved


def _pngs_reread(folder: str) -> int:
    names = [n for n in os.listdir(folder) if n.endswith(".png")]
    for n in names:
        assert read_png(os.path.join(folder, n)).ndim == 3, n
    return len(names)


# ---------------------------------------------------------------- depth_to_pointcloud


def test_depth_to_pointcloud_matches_the_jax_tool(tmp_path):
    jtool = _tool("depth_to_pointcloud")
    sd = build_depth_model("vits", dtype=torch.float32, seed=2).state_dict()
    ckpt = str(tmp_path / "dav2.pt")
    torch.save(sd, ckpt)
    src = tmp_path / "in"
    src.mkdir()
    with Image.open(os.path.join(FIXTURE, "000004.jpg")) as im:
        im.save(src / "a.jpg", quality=95)
        arr = np.asarray(im.convert("RGB"))[:200, :300]
    (src / "b.png").write_bytes(png.encode_png(arr, 2, np.random.RandomState(0).randint(0, 5, 200)))
    args = depth_to_pointcloud.parser().parse_args(
        ["--img-path", str(src), "--outdir", str(tmp_path / "port"), "--encoder", "vits", "--checkpoint", ckpt,
         "--input-size", "56"])
    out = depth_to_pointcloud.run(args, torch.device("cpu"), torch.float32)
    assert [os.path.basename(f) for f in out["files"]] == ["a.ply", "b.ply"]
    assert out["flash_attention_launches"] == 0  # the CPU runs the plain attention
    model = jdpt.DepthAnythingV2(encoder="vits", max_depth=20.0, dtype=jnp.float32)
    params = convert_depth_anything_v2({k: v.numpy() for k, v in sd.items()}, "vits")
    infer = jax.jit(lambda p, x: model.apply({"params": p}, x))
    for name in ("a", "b"):
        path = next(p for p in depth_to_pointcloud.image_files(str(src)) if os.path.basename(p).startswith(name))
        img = Image.open(path).convert("RGB")
        w, h = img.size
        x = jdpt.preprocess_image(jnp.asarray(np.asarray(img, np.float32) / 255.0), 56)
        depth = jdpt.resize_align_corners(infer(params, x)[..., None], h, w)[0, ..., 0]
        want = str(tmp_path / f"{name}_jax.ply")
        jtool.write_ply(want, jtool.unproject(np.asarray(depth, np.float32), 470.4, 470.4), np.asarray(img))
        got = str(tmp_path / "port" / f"{name}.ply")
        with open(got, "rb") as f, open(want, "rb") as g:
            a, b = f.read(), g.read()
        end = a.index(b"end_header\n")
        assert a[:end] == b[:end] and len(a) == len(b)
        gp, gc = depth_to_pointcloud.read_ply(got)
        wp, wc = depth_to_pointcloud.read_ply(want)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gp, wp, atol=1e-4 * np.abs(wp).max(), rtol=0)
    listing = tmp_path / "list.txt"
    listing.write_text(f"{src / 'b.png'}\n\n{src / 'a.jpg'}\n")
    assert depth_to_pointcloud.image_files(str(listing)) == [str(src / "b.png"), str(src / "a.jpg")]


# ---------------------------------------------------------------- fit_proposal_coefs


def test_fit_proposal_coefs_matches_the_jax_tool(tmp_path, capsys, monkeypatch):
    from threedod.proposals.proposals import _depth_grid_centers

    args = fit_proposal_coefs.parser().parse_args(
        ["--config-file", os.path.join(ROOT, "configs", "BoxNet_Synth.yaml"), "--plot-dir", str(tmp_path / "plots"),
         "output_dir", str(tmp_path / "port")])
    got = fit_proposal_coefs.run(args, torch.device("cpu"))
    port_lines = capsys.readouterr().out.strip().splitlines()[-4:]
    # the JAX tool's loop over the same records, with its jitted grid and jnp.median
    from threedod_torch.data.build import get_dataset_dicts

    grid = jax.jit(_depth_grid_centers, static_argnums=(3,))
    want = {"x": [], "y": [], "z": []}
    for d in get_dataset_dicts(["synth_train"]):
        with np.load(d["depth_image_path"]) as z:
            depth = jnp.asarray(z["depth"], jnp.float32)
        for ann in d["annotations"]:
            if ann.get("category_id", -1) < 0:
                continue
            box = np.asarray(ann["bbox"], np.float32)
            box = np.array([box[0], box[1], box[0] + box[2], box[1] + box[3]], np.float32)
            x, y, zt = grid(jnp.asarray(box), depth, jnp.asarray(d["K"], jnp.float32), 16)
            want["x"].append((float(jnp.median(x)), ann["center_cam"][0]))
            want["y"].append((float(jnp.median(y)), ann["center_cam"][1]))
            want["z"].append((float(jnp.median(zt)) + float(ann["dimensions"][2]) / 2.0, ann["center_cam"][2]))
    for axis in ("x", "y", "z"):
        w = np.asarray(want[axis], np.float64)
        assert got["pairs"][axis].shape == w.shape == (297, 2)
        np.testing.assert_allclose(got["pairs"][axis], w, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["fits"][axis], fit_proposal_coefs.fit(w), atol=1e-5, rtol=0)
        saved = np.loadtxt(tmp_path / "plots" / f"{axis}_values_to_find.csv", delimiter=",", skiprows=1)
        np.testing.assert_array_equal(saved, got["pairs"][axis])
    assert _pngs_reread(str(tmp_path / "plots")) == 3
    jtool = _tool("fit_proposal_coefs")
    _main(monkeypatch, jtool, ["--config-file", os.path.join(ROOT, "configs", "BoxNet_Synth.yaml"), "output_dir",
                               str(tmp_path / "jax")])
    assert capsys.readouterr().out.strip().splitlines()[-4:] == port_lines


# ---------------------------------------------------------------- priors, datasetminify, grid_effect


def test_priors_pickle_matches_the_jax_tool(tmp_path, monkeypatch):
    config = os.path.join(ROOT, "configs", "Base_Synth.yaml")
    sizes = tmp_path / "sizes.csv"
    sizes.write_text("category,width,height,depth\nChair,0.5,0.9,0.5\nlamp,x,1,1\nsofa,2.0,0.8,0.9\n")
    priors.run(priors.parser().parse_args(["--config-file", config, "--out", str(tmp_path / "port.pkl"),
                                           "--typical-sizes-csv", str(sizes)]))
    jtool = _tool("priors")
    _main(monkeypatch, jtool, ["--config-file", config, "--out", str(tmp_path / "jax.pkl"), "--typical-sizes-csv",
                               str(sizes)])
    assert priors.load_typical_sizes_csv(str(sizes)) == jtool.load_typical_sizes_csv(str(sizes))
    with open(tmp_path / "port.pkl", "rb") as f, open(tmp_path / "jax.pkl", "rb") as g:
        got, want = pickle.load(f), pickle.load(g)
    assert got.keys() == want.keys() and got["categories"] == want["categories"]
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], dtype=object if k == "categories" else None),
                                      np.asarray(want[k], dtype=object if k == "categories" else None), err_msg=k)


@pytest.mark.parametrize("how", [dict(count=7), dict(count=3, category="lamp"), dict(image_ids=[5, 9, 12])],
                         ids=["count", "category", "image_ids"])
def test_datasetminify_matches_the_jax_tool(how, tmp_path):
    jtool = _tool("datasetminify")
    datasetminify.minify_dataset(TRAIN_JSON, str(tmp_path / "port.json"), **how)
    jtool.minify_dataset(TRAIN_JSON, str(tmp_path / "jax.json"), **how)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    with open(tmp_path / "port.json") as f:
        assert json.load(f)["images"]
    out = datasetminify.main(["--src", str(tmp_path / "port.json"), "--count", "2"])
    assert out == str(tmp_path / "port_mini.json") and os.path.exists(out)


def test_grid_effect_prints_the_jax_tools_losses(capsys):
    got = grid_effect.run(torch.device("cpu"))
    port = capsys.readouterr().out.strip().splitlines()
    _tool("grid_effect").main()
    assert capsys.readouterr().out.strip().splitlines() == port
    assert list(got) == [1.25, 2.5, 5.0] and 0 < got[1.25] < got[2.5] < got[5.0] < 0.1
    with pytest.raises(RuntimeError, match="CUDA"):
        grid_effect.main(["--device", "cpu"])


# ---------------------------------------------------------------- visualise_gt


def test_dataset_statistics_match_the_jax_functions(figures, tmp_path):
    jvis = _tool("visualise_gt")
    with open(TRAIN_JSON) as f:
        data = json.load(f)
    annos = data["annotations"]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    os.makedirs(pdir)

    counts = jvis.category_distribution(annos, jdir)
    got = visualise_gt.category_distribution(annos, pdir)
    assert list(got.items()) == list(counts.items())
    ax = figures["category_distribution.png"][0]
    assert [b[3] for b in ax["bars"]] == list(got.values()) and ax["xticks"] == list(got)

    outliers = jvis.spatial_statistics(data["images"], annos, jdir)
    grid, got_outliers = visualise_gt.spatial_statistics(data["images"], annos, pdir)
    assert got_outliers == outliers
    np.testing.assert_array_equal(grid, figures["2d_histogram.png"][0]["images"][0])
    np.testing.assert_array_equal(np.loadtxt(os.path.join(pdir, "2d_histogram.csv"), delimiter=","), grid)

    jvis.gt_stats(annos, jdir)
    stats = visualise_gt.gt_stats(annos, pdir)
    for stem, labels in (("center", "xyz"), ("dimensions", "whl")):
        with open(os.path.join(pdir, f"{stem}.json")) as f:
            assert json.load(f) == stats[stem]
        for ax, label in zip(figures[f"{stem}.png"], labels):
            entry = stats[stem][label]
            np.testing.assert_allclose([b[3] for b in ax["bars"]], entry["heights"], rtol=1e-12, atol=0)
            np.testing.assert_allclose(ax["lines"][0], np.stack([entry["fit_x"], entry["fit_pdf"]], -1), rtol=1e-12)
            marks = [s[0][0] for s in ax["collections"][0][2]]
            np.testing.assert_allclose(marks, [entry["mu"] - entry["sigma"], entry["mu"] + entry["sigma"]], rtol=1e-12)

    jvis.vol_over_cat(annos, jdir)
    vol = visualise_gt.vol_over_cat(annos, pdir)
    ax = figures["volume_distribution.png"][0]
    assert ax["xticks"] == vol["categories"]
    segments = [c[2][0] for c in ax["collections"]]
    np.testing.assert_allclose([s[:, 1] for s in segments], np.stack([vol["low"], vol["high"]], -1), rtol=1e-12)
    np.testing.assert_allclose([line[0] for line in ax["lines"]],
                               np.stack([np.arange(len(vol["mean"])), vol["mean"]], -1), rtol=1e-12)
    assert _pngs_reread(pdir) == 5


def _run_dir(path, seed: int, cats):
    rng = np.random.RandomState(seed)
    os.makedirs(path)
    res = {"synth_test": {"AP2D": 1.0, "AP3D": 2.0, "percat2D": {c: float(rng.uniform(0, 60)) for c in cats},
                          "percat3D": {c: float(rng.uniform(0, 40)) for c in cats}}}
    with open(os.path.join(path, "results.json"), "w") as f:
        json.dump(res, f)
    return str(path)


def test_result_plots_match_the_jax_functions(figures, tmp_path):
    jvis = _tool("visualise_gt")
    with open(TRAIN_JSON) as f:
        annos = json.load(f)["annotations"]
    from collections import Counter

    counts = Counter(a["category_name"] for a in annos)
    cats = sorted(counts)[:7] + ["unseen"]
    dirs = [_run_dir(tmp_path / "base", 1, cats), _run_dir(tmp_path / "weak", 2, cats)]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    os.makedirs(pdir)
    jvis.ap_vs_category_count(dirs, ["base", "weak"], counts, jdir)
    got = visualise_gt.ap_vs_category_count(dirs, ["base", "weak"], counts, pdir)
    ax = figures["AP_vs_no_of_classes_all.png"][0]
    for (offsets, sizes, _), line, run in zip(ax["collections"], ax["lines"], got.values()):
        np.testing.assert_allclose(offsets, np.stack([run["time_h"], run["ap3d"]], -1), rtol=1e-12)
        np.testing.assert_allclose(sizes, run["sizes"], rtol=1e-12)
        order = np.argsort(run["time_h"])
        np.testing.assert_allclose(line, np.stack([np.asarray(run["time_h"])[order],
                                                   np.poly1d(run["fit"])(np.asarray(run["time_h"])[order])], -1),
                                   rtol=1e-10)
    for mode in ("standard", "log"):
        jvis.ap3d_vs_ap2d(dirs, ["base", "weak"], jdir, mode)
        got = visualise_gt.ap3d_vs_ap2d(dirs, ["base", "weak"], pdir, mode)
        ax = figures[f"AP3D_vs_AP2D_all_{mode}.png"][0]
        for (offsets, sizes, _), run in zip(ax["collections"], got.values()):
            np.testing.assert_allclose(offsets, np.stack([run["ap2d"], run["ap3d"]], -1), rtol=1e-12)
            if mode == "standard":
                np.testing.assert_allclose(sizes, run["sizes"], rtol=1e-12)
    assert _pngs_reread(pdir) == 3


def test_visualise_gt_prints_as_the_jax_tool_and_draws_the_ground_truth(figures, tmp_path, capsys, monkeypatch):
    jvis = _tool("visualise_gt")
    _main(monkeypatch, jvis, ["--dataset-json", TRAIN_JSON, "--out-dir", str(tmp_path / "jax"), "--stats-only"])
    want = capsys.readouterr().out.strip().splitlines()[:4]
    args = visualise_gt.parser().parse_args(["--dataset-json", TRAIN_JSON, "--image-root",
                                             os.path.join(ROOT, "datasets"), "--out-dir", str(tmp_path / "port"),
                                             "--max-images", "2"])
    out = visualise_gt.run(args, torch.device("cpu"))
    assert capsys.readouterr().out.strip().splitlines()[:4] == want
    with open(TRAIN_JSON) as f:
        data = json.load(f)
    assert len(out["drawn"]) == 2
    for path, im in zip(out["drawn"], data["images"]):
        annos = [a for a in data["annotations"] if a["image_id"] == im["id"]]
        img = imread_rgb(os.path.join(ROOT, "datasets", im["file_path"]), "cpu").numpy()
        drawn = draw_scene_view(img, np.asarray(im["K"]), np.asarray([a["bbox3D_cam"] for a in annos]),
                                labels=[a["category_name"] for a in annos])
        np.testing.assert_array_equal(read_png(path), drawn)
    with pytest.raises(RuntimeError, match="CUDA"):
        visualise_gt.main(["--dataset-json", TRAIN_JSON, "--device", "cpu"])


# ---------------------------------------------------------------- results, mabo_plots


def test_results_series_and_csv_match_the_jax_tool(figures, tmp_path, monkeypatch):
    rng = np.random.RandomState(3)
    metrics = tmp_path / "metrics.json"
    with open(metrics, "w") as f:
        for it in range(19, 400, 20):
            row = {"iteration": it, "total_loss": float(rng.rand()), "lr": 0.02 * (1 - it / 400)}
            if it % 100 == 99:
                row.update({"synth_test/AP2D": float(rng.rand() * 50), "synth_test/AP3D": float(rng.rand() * 30)})
            f.write(json.dumps(row) + "\n")
    jtool = _tool("results")
    _main(monkeypatch, jtool, ["--metrics", str(metrics), "--out-dir", str(tmp_path / "jax")])
    series = results.run(results.parser().parse_args(["--metrics", str(metrics), "--out-dir", str(tmp_path / "port")]))
    keys = ["total_loss", "lr", "synth_test/AP2D", "synth_test/AP3D"]
    assert list(series) == keys
    for key in keys:
        np.testing.assert_array_equal(figures[key.replace("/", "_") + ".png"][0]["lines"][0], np.stack(series[key], -1))
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # the JAX tool's CSV, written where matplotlib is missing
    _main(monkeypatch, jtool, ["--metrics", str(metrics), "--out-dir", str(tmp_path / "jax_csv")])
    assert (tmp_path / "port" / "metrics.csv").read_text() == (tmp_path / "jax_csv" / "metrics.csv").read_text()
    with open(tmp_path / "port" / "metrics.csv") as f:
        assert len(list(csv.reader(f))) == 21
    assert _pngs_reread(str(tmp_path / "port")) == 4


def test_mabo_plots_match_the_jax_tool(figures, tmp_path, capsys, monkeypatch):
    from threedod_torch.models.boxer import COMBINATION_DEFS

    rng = np.random.RandomState(4)
    res = {f"MABO_{n}": float(rng.rand()) for n in ("combined", "random", "IoU2D", "seg_mod", "dim")}
    res.update(ABO_best_possible_combined=0.9, combinations_mean=rng.rand(len(COMBINATION_DEFS)).tolist())
    path = tmp_path / "mabo.json"
    path.write_text(json.dumps(res))
    _main(monkeypatch, _tool("mabo_plots"), ["--results", str(path), "--out-dir", str(tmp_path / "jax")])
    want = capsys.readouterr().out.replace(str(tmp_path / "jax"), "DIR")
    got = mabo_plots.run(mabo_plots.parser().parse_args(["--results", str(path), "--out-dir", str(tmp_path / "port")]))
    assert capsys.readouterr().out.replace(str(tmp_path / "port"), "DIR") == want
    ax = figures["mabo_scores.png"][0]
    assert ax["yticks"] == list(got["mabo"]) and [b[2] for b in ax["bars"]] == list(got["mabo"].values())
    assert len(got["combinations"]) == 26 and got["combinations"][0][1] == max(res["combinations_mean"])
    with open(tmp_path / "port" / "mabo_scores.json") as f:
        assert json.load(f) == got
    assert _pngs_reread(str(tmp_path / "port")) == 1


# ---------------------------------------------------------------- the card's machine


def test_tools_import_and_read_png_without_pillow_or_matplotlib(tmp_path):
    """In a fresh interpreter where ``PIL`` and ``matplotlib`` cannot be
    imported (the card's machine does not promise them), every tool of this
    slice imports, draws a figure and reads a PNG back."""
    import subprocess

    path = tmp_path / "x.png"
    path.write_bytes(png.encode_png(np.arange(60, dtype=np.uint8).reshape(4, 5, 3), 2, [0, 1, 2, 4]))
    code = ("import sys; sys.modules['PIL'] = None; sys.modules['matplotlib'] = None\n"
            "import importlib\n"
            "for m in ('depth_to_pointcloud', 'fit_proposal_coefs', 'priors', 'datasetminify', 'grid_effect',\n"
            "          'visualise_gt', 'results', 'mabo_plots'):\n"
            "    importlib.import_module('threedod_torch.' + m)\n"
            "from threedod_torch.vis import read_png\n"
            "from threedod_torch.vis.plot import Plot\n"
            "p = Plot(); p.hist([1.0, 2.0, 2.5]); assert p.render().shape == (400, 640, 3)\n"
            f"print(read_png({str(path)!r}).sum())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == str(np.arange(60).sum())


@pytest.mark.parametrize("tool", ["depth_to_pointcloud", "fit_proposal_coefs"])
def test_card_tools_refuse_without_cuda(tool, tmp_path):
    module = {"depth_to_pointcloud": depth_to_pointcloud, "fit_proposal_coefs": fit_proposal_coefs}[tool]
    argv = (["--img-path", FIXTURE, "--outdir", str(tmp_path / "out"), "--random-weights"] if tool ==
            "depth_to_pointcloud" else ["--config-file", os.path.join(ROOT, "configs", "BoxNet_Synth.yaml")])
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([*argv, "--device", "cpu"])
    assert not (tmp_path / "out").exists()
