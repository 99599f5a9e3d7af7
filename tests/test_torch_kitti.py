"""The KITTI tools, the demos and the evaluation drawings of the port vs the
JAX package, on the CPU.

* ``data/kitti.py`` against ``threedod/data/kitti.py``: the observation
  angle and yaw, the KITTI line of a detection and of a ground truth, the
  per-image exports, the annotation-free copy, the split copy and the z
  overwrite (files and lines equal as text), also through
  ``python -m threedod_torch.kitti_split`` and ``kitti_pred_overwrite_z``.
* ``demo.run`` and ``kitti_demo.run`` on the CPU over 3 fixture images at a
  64x96 canvas (Base_Synth, f32), with the JAX model's numpy-made weights
  converted into a port checkpoint: the detections equal the JAX
  ``RCNN3D``'s on the same batches (matched sets; boxes, scores and 3D
  fields within 2e-4 relative and 1e-3 absolute: the trunk's sums run in
  another order), the predictions JSON has the JAX tool's layout and the
  JAX model's values, and the drawings (the demo's three images, the
  ``--display`` scene views) are the JAX ``vis``'s drawings of the JAX
  model's detections within ``test_torch_vis.py``'s drawing tolerance, the
  glyphs of text drawn as nothing on both sides.
* ``vis_period``: ``train_net.do_test`` and ``eval_boxes``' AP path draw
  every test image and log the error line.
"""
from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import _torch_port as tp

import jax

from threedod.data import kitti as jk
from threedod_torch.data import kitti as pk

from test_torch_vis import assert_drawings_close

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "Base_Synth.yaml")
SMALL = ["model.dtype", "float32", "shapes.canvas_height", "64", "shapes.canvas_width", "96",
         "input.min_size_test", "64", "input.max_size_test", "96", "test.batch_size", "1",
         "model.rpn.post_nms_topk_test", "64", "shapes.nms_candidates", "128", "shapes.max_detections", "16",
         "datasets.test", "[synth_test3]"]
THRESH = 0.05


# ---- data/kitti.py ------------------------------------------------------------


def _rotation(t):
    return np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]])


def test_angles_and_lines_equal_jax():
    rng = np.random.RandomState(0)
    for _ in range(50):
        loc, ry = rng.uniform([-10, -2, 1], [10, 2, 40]), rng.uniform(-np.pi, np.pi)
        assert pk.calculate_alpha(loc, ry) == jk.calculate_alpha(loc, ry)
        R = _rotation(rng.uniform(-3, 3))
        assert pk.pose_to_ry(R) == jk.pose_to_ry(R)
        args = ("car" if rng.rand() < 0.5 else "chair", rng.uniform(0, 500, 4), rng.uniform(0.5, 4, 3), loc, R)
        score = float(rng.rand()) if rng.rand() < 0.5 else None
        assert pk.detection_to_kitti_line(*args, score=score) == jk.detection_to_kitti_line(*args, score=score)


def _predictions_and_records():
    data = json.loads((ROOT / "datasets" / "Omni3D" / "synth_test.json").read_text())
    records = []
    for im in data["images"][:3]:
        annos = [a for a in data["annotations"] if a["image_id"] == im["id"]]
        annos[0] = dict(annos[0], category_id=-1)  # an ignore region is not exported
        records.append({"image_id": im["id"], "annotations": annos})
    rng = np.random.RandomState(1)
    preds = [{"image_id": a["image_id"], "category_id": a["category_id"], "bbox": a["bbox"],
              "dimensions": a["dimensions"], "center_cam": list(np.array(a["center_cam"]) + rng.normal(0, 0.3, 3)),
              "pose": a["pose"], "score": float(rng.rand())} for r in records for a in r["annotations"]]
    return preds, records, {c["id"]: c["name"] for c in data["categories"]}


def _tree(path: pathlib.Path) -> dict:
    return {p.name: p.read_text() for p in sorted(path.iterdir())}


def test_exports_and_z_overwrite_equal_jax(tmp_path):
    preds, records, cats = _predictions_and_records()
    for mod, side in ((pk, "port"), (jk, "jax")):
        mod.export_predictions_to_kitti(preds, cats, str(tmp_path / side / "pred"))
        mod.export_gt_to_kitti(records, cats, str(tmp_path / side / "gt"))
        mod.make_dummy_dataset(str(ROOT / "datasets" / "Omni3D" / "synth_test.json"), str(tmp_path / side / "d.json"))
    for sub in ("pred", "gt"):
        assert _tree(tmp_path / "port" / sub) == _tree(tmp_path / "jax" / sub)
    assert (tmp_path / "port" / "d.json").read_text() == (tmp_path / "jax" / "d.json").read_text()
    gt = (tmp_path / "port" / "gt" / f"{records[0]['image_id']:06d}.txt").read_text().splitlines()
    dt = (tmp_path / "port" / "pred" / f"{records[0]['image_id']:06d}.txt").read_text().splitlines()
    gt = gt + ["DontCare 0.00 0 0.00 0.00 0.00 900.00 900.00 1.00 1.00 1.00 0.00 0.00 99.00 0.00"]
    assert pk.overwrite_pred_z(dt, gt) == jk.overwrite_pred_z(dt, gt)
    assert pk.overwrite_pred_z(dt, gt) != [d + "\n" for d in dt]  # some z was overwritten

    from threedod_torch import kitti_pred_overwrite_z

    want = jk.overwrite_pred_z_dir(str(tmp_path / "jax" / "pred"), str(tmp_path / "jax" / "gt"), 0.5)
    kitti_pred_overwrite_z.main(["--pred-dir", str(tmp_path / "port" / "pred"), "--gt-dir",
                                 str(tmp_path / "port" / "gt"), "--iou-thresh", "0.5"])
    assert want > 0 and _tree(tmp_path / "port" / "pred") == _tree(tmp_path / "jax" / "pred")
    assert pk.overwrite_pred_z_dir(str(tmp_path / "port" / "pred"), str(tmp_path / "port" / "gt"), 0.5) == 0


def test_kitti_split_copies_as_jax(tmp_path):
    from threedod_torch import kitti_split

    src = tmp_path / "src"
    src.mkdir()
    for stem in ("000001", "000002", "000007"):
        (src / f"{stem}.png").write_bytes(stem.encode())
    (tmp_path / "val.txt").write_text("000001\n\n000007\n000009\n")
    want = jk.copy_val_split(str(tmp_path / "val.txt"), str(src), str(tmp_path / "jax"))
    assert pk.copy_val_split(str(tmp_path / "val.txt"), str(src), str(tmp_path / "port")) == want
    kitti_split.main(["--val-file", str(tmp_path / "val.txt"), "--src-folder", str(src), "--dest-folder",
                      str(tmp_path / "tool")])
    assert want == ["000001.png", "000007.png"]
    assert _tree(tmp_path / "tool") == _tree(tmp_path / "jax") == _tree(tmp_path / "port")


# ---- the demos ----------------------------------------------------------------


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    """A datasets root with a 3-image test split, a folder of those 3 JPEGs,
    the JAX model's numpy-made variables as a port checkpoint, and the JAX
    model's forward (one jit)."""
    from threedod.config import load_config as jax_load
    from threedod.models import build_model as jax_build

    from threedod_torch.config_yaml import load_config
    from threedod_torch.utils.convert_weights import from_jax_variables

    tmp = tmp_path_factory.mktemp("kitti")
    root, images = tmp / "datasets", tmp / "images"
    (root / "Omni3D").mkdir(parents=True)
    images.mkdir()
    src = ROOT / "datasets" / "Omni3D"
    (root / "Omni3D" / "synth_train.json").write_text((src / "synth_train.json").read_text())
    test = json.loads((src / "synth_test.json").read_text())
    test["images"] = test["images"][:3]
    keep = {im["id"] for im in test["images"]}
    test["annotations"] = [a for a in test["annotations"] if a["image_id"] in keep]
    (root / "Omni3D" / "synth_test3.json").write_text(json.dumps(test))
    for name in ("synth", "depth_maps", "ground_maps"):
        os.symlink(ROOT / "datasets" / name, root / name)
    for im in test["images"]:
        os.symlink(ROOT / "datasets" / im["file_path"], images / os.path.basename(im["file_path"]))
    opts = SMALL + ["datasets.root", str(root)]
    jcfg = jax_load(CONFIG, opts)
    variables = tp.init_like_variables(jcfg, predictor_scale=50.0)
    ckpt = tmp / "weights.pth"
    torch.save(from_jax_variables(variables, load_config(CONFIG, opts)), ckpt)
    jmodel = jax_build(jcfg)
    forward = jax.jit(lambda b: jmodel.apply(variables, b, train=False))
    return dict(root=root, images=images, ckpt=str(ckpt), opts=opts, forward=forward, test=test)


def _jax_detections(forward, batch) -> dict:
    """The JAX model on a port batch (its images, sizes, K, ratios)."""
    b = {k: v.numpy() for k, v in batch._asdict().items() if k in ("image", "image_hw", "K", "im_scale_ratio")}
    det = forward(tp.jax_batch(b["image"], b["image_hw"], b["K"], b["im_scale_ratio"]))
    return {k: np.asarray(v) for k, v in det._asdict().items()}


def _port_detections(model, batch) -> dict:
    from threedod_torch.infer import predict

    return {k: v.numpy() for k, v in predict(model, batch)._asdict().items()}


def _assert_same_detections(port: dict, ref: dict, j: int, keep_p, keep_r):
    """Matched sets of image j's kept detections, field by field."""
    from test_torch_rcnn3d import _match

    assert len(keep_p) == len(keep_r) > 0
    idx = _match(ref["boxes"][j, keep_r], port["boxes"][j, keep_p])
    for field in ("boxes", "scores", "classes", "center_cam", "dimensions", "pose", "corners3d", "center_2d"):
        np.testing.assert_allclose(port[field][j, keep_p][idx], ref[field][j, keep_r], rtol=2e-4, atol=1e-3,
                                   err_msg=field)
    return idx


@pytest.fixture
def no_glyphs(monkeypatch):
    from threedod_torch.vis import draw as pdraw

    monkeypatch.setattr(ImageDraw.ImageDraw, "text", lambda self, *a, **k: None)
    monkeypatch.setattr(pdraw, "text", lambda *a, **k: None)


def test_demo_matches_jax(setting, tmp_path, no_glyphs):
    import threedod.vis.vis as jvis

    from threedod_torch import demo
    from threedod_torch.config_yaml import load_config
    from threedod_torch.data.mapper import DatasetMapper3D
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils.model_zoo import load_model_weights
    from threedod_torch.vis import read_png

    args = demo.parser().parse_args(["--config-file", CONFIG, "--input-folder", str(setting["images"]),
                                     "--output-dir", str(tmp_path), "--checkpoint", setting["ckpt"],
                                     "--score-thresh", str(THRESH), *setting["opts"]])
    out = demo.run(args, "cpu")
    assert out["images"] == 3 and len(out["files"]) == 9 and sum(out["detections"]) > 0

    cfg = load_config(CONFIG, setting["opts"])
    model = load_model_weights(setting["ckpt"], build_model(cfg)).eval()
    mapper = DatasetMapper3D(cfg, is_train=False)
    for path, n in zip(demo.image_paths(str(setting["images"])), out["detections"]):
        batch = demo.demo_batch(cfg, mapper, path, 2.0)
        port, ref = _port_detections(model, batch), _jax_detections(setting["forward"], batch)
        keep_p = np.where(port["valid"][0] & (port["scores"][0] > THRESH))[0]
        keep_r = np.where(ref["valid"][0] & (ref["scores"][0] > THRESH))[0]
        assert len(keep_p) == n
        _assert_same_detections(port, ref, 0, keep_p, keep_r)
        # the JAX tool's drawings (tools/demo.py:113-133) of the JAX model's detections
        img = np.asarray(Image.open(path).convert("RGB"))
        labels, scores, corners = ref["classes"][0, keep_r], ref["scores"][0, keep_r], ref["corners3d"][0, keep_r]
        colors = [jvis.get_color(int(c)) for c in labels]
        front, novel = jvis.render_scene_views(
            img, batch.K[0].numpy(), corners, text=[f"{int(c)} {s:.2f}" for c, s in zip(labels, scores)],
            colors=colors, mode="front_and_novel", blend_weight=0.5, blend_weight_overlay=0.85)
        bev = np.asarray(jvis.draw_bev(list(corners), colors=colors, size=front.shape[0]))
        stem = pathlib.Path(path).stem
        assert_drawings_close(read_png(str(tmp_path / f"{stem}_boxes.png")), front, img)
        assert_drawings_close(read_png(str(tmp_path / f"{stem}_novel.png")), novel, np.uint8([225, 225, 225]))
        assert_drawings_close(read_png(str(tmp_path / f"{stem}.png")), np.concatenate([front, novel, bev], 1),
                              np.concatenate([img, np.full((img.shape[0], img.shape[0], 3), 225, np.uint8),
                                              np.full((img.shape[0], img.shape[0], 3), 245, np.uint8)], 1))


def test_kitti_demo_matches_jax(setting, tmp_path, no_glyphs):
    import threedod.vis.vis as jvis

    from threedod_torch import kitti_demo
    from threedod_torch.data.build import TestLoader, get_dataset_dicts
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.train_net import setup
    from threedod_torch.utils.model_zoo import load_model_weights
    from threedod_torch.vis import read_png

    args = kitti_demo.parser().parse_args([
        "--config-file", CONFIG, "--dataset", "synth_test3", "--checkpoint", setting["ckpt"], "--threshold",
        str(THRESH), "--display", "--output-dir", str(tmp_path), *setting["opts"], "output_dir", str(tmp_path / "o")])
    out = kitti_demo.run(args, "cpu")
    data = json.loads((tmp_path / "synth_test3_predictions.json").read_text())
    assert out["images"] == len(data) == 3 and out["detections"] > 0

    cfg, meta, priors = setup(CONFIG, setting["opts"] + ["output_dir", str(tmp_path / "o")])
    model = load_model_weights(setting["ckpt"], build_model(cfg, priors=priors)).eval()
    records = get_dataset_dicts(["synth_test3"])
    cats = list(meta.thing_classes)
    for entry, (batch, n_real), rec in zip(data, TestLoader(records, cfg), records):
        assert n_real == 1 and entry["image_id"] == rec["image_id"] == int(batch.image_id[0])
        assert set(entry) == {"image_id", "file_path", "K", "width", "height", "predictions"}
        assert (entry["file_path"], entry["K"], entry["width"], entry["height"]) == (
            rec["file_name"], np.asarray(rec["K"], np.float64).tolist(), rec["width"], rec["height"])
        port, ref = _port_detections(model, batch), _jax_detections(setting["forward"], batch)
        keep_r = np.where(ref["valid"][0] & (ref["scores"][0] >= THRESH))[0]
        keep_p = np.where(port["valid"][0] & (port["scores"][0] >= THRESH))[0]
        assert len(entry["predictions"]) == len(keep_p)
        idx = _assert_same_detections(port, ref, 0, keep_p, keep_r)
        # the JSON holds the port model's detections in the JAX tool's fields (tools/kitti_demo.py:108-118)
        for p, i in zip(np.asarray(entry["predictions"], object)[idx], keep_r):
            assert set(p) == {"category", "score", "bbox", "center_cam", "dimensions", "pose", "center_2D",
                              "corners3D"}
            assert p["category"] == cats[int(ref["classes"][0, i])]
            for key, field in (("score", "scores"), ("bbox", "boxes"), ("center_cam", "center_cam"),
                               ("dimensions", "dimensions"), ("pose", "pose"), ("center_2D", "center_2d"),
                               ("corners3D", "corners3d")):
                np.testing.assert_allclose(np.asarray(p[key]), ref[field][0, i], rtol=2e-4, atol=1e-3, err_msg=key)
        # --display: the JAX tool's scene view of the JAX model's detections
        img = np.asarray(Image.open(rec["file_name"]).convert("RGB"))
        want = np.asarray(jvis.draw_scene_view(img, np.asarray(rec["K"], np.float64), list(ref["corners3d"][0, keep_r]),
                                               labels=[int(c) for c in ref["classes"][0, keep_r]],
                                               scores=[float(s) for s in ref["scores"][0, keep_r]]))
        got = read_png(str(tmp_path / f"{pathlib.Path(rec['file_name']).stem}_boxes.png"))
        assert_drawings_close(got, want, np.concatenate([img, np.full((img.shape[0], img.shape[0], 3), 225,
                                                                      np.uint8)], 1))


# ---- vis_period ---------------------------------------------------------------


def test_evaluations_draw_with_vis_period(setting, tmp_path, caplog):
    import logging

    from threedod_torch import eval_boxes, train_net
    from threedod_torch.models.meta_arch import build_model

    caplog.set_level(logging.INFO)
    opts = setting["opts"] + ["output_dir", str(tmp_path / "train"), "vis_period", "1"]
    cfg, meta, priors = train_net.setup(CONFIG, opts)
    train_net.do_test(cfg, build_model(cfg, priors=priors), meta, torch.device("cpu"), iteration=5)
    drawn = sorted((tmp_path / "train" / "synth_test3" / "vis").iterdir())
    assert [p.name for p in drawn] == ["000000.png", "000001.png", "000002.png"]
    assert "synth_test3iter=5, xy(" in caplog.text

    caplog.clear()
    args = eval_boxes.parser().parse_args([
        "--config-file", str(ROOT / "configs" / "BoxNet_Synth.yaml"), *SMALL[:-2], "datasets.test", "[synth_test3]",
        "datasets.root", str(setting["root"]), "output_dir", str(tmp_path / "boxes"), "plot.eval", "AP",
        "model.roi_cube_head.number_of_proposals", "64", "vis_period", "2"])
    res = eval_boxes.run(args, torch.device("cpu"))
    assert np.isfinite(res["results"]["synth_test3"]["AP2D"])
    drawn = sorted((tmp_path / "boxes" / "synth_test3" / "vis").iterdir())
    assert [p.name for p in drawn] == ["000000.png", "000002.png"]
    assert "synth_test3iter=, xy(" in caplog.text
