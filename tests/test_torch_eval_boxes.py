"""BoxNet's PRED path and ``python -m threedod_torch.eval_boxes``, f32 on the CPU.

* ``BoxNet.predict_2d_boxes`` against the JAX RCNN3D's modules composed as
  ``threedod/models/boxnet.py:52-76`` writes them (backbone, RPN head with
  ``train=False``, proposal selection, box branch, class-agnostic NMS at
  0.5, top 20), one numpy set of variables carried into the port by
  ``from_jax_variables``: boxes to 1e-3 px, scores to 1e-4 relative, classes
  and validity equal. The JAX BoxNet itself cannot run this path: its
  ``predict_2d_boxes`` reads an undefined ``train``.
* ``eval_boxes.run`` on two fixture images a dataset at 96x128 with 64
  proposals a box: MABO, IoU3D and AP in GT mode, AP in PRED mode, each
  with the tool's output keys and finite values; MABO or IoU3D with PRED
  boxes, an unknown ``plot.eval`` and an unknown ``plot.mode2d`` raise.
* ``train.pseudo_gt pseudo``: every annotation field the tool writes is
  there, with the values ``tools/eval_boxes.py:189-213`` writes from the same
  best cubes (``bbox3D_cam`` from the JAX ``cuboid_verts``, to 1e-5), and the
  file registers and loads through ``train_net.setup`` as a training dataset.
"""
from __future__ import annotations

import json
import math
import os
import pathlib

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax
import jax.numpy as jnp

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "BoxNet_Synth.yaml")
SMALL = ["model.dtype", "float32", "shapes.canvas_height", "96", "shapes.canvas_width", "128",
         "input.min_size_test", "96", "model.roi_cube_head.number_of_proposals", "64",
         "datasets.train", "[synth_train2]", "datasets.test", "[synth_test2]"]
# the JSON fields ``tools/eval_boxes.py`` writes for each pseudo ground-truth box
PSEUDO_FIELDS = {"id", "image_id", "dataset_id", "category_id", "category_name", "valid3D", "behind_camera",
                 "bbox2D_proj", "bbox2D_trunc", "bbox2D_tight", "bbox", "center_cam", "dimensions", "R_cam", "pose",
                 "bbox3D_cam", "truncation", "visibility", "lidar_pts", "segmentation_pts", "depth_error", "score"}


# ---- the PRED path's 2D boxes -------------------------------------------------------------


def test_predict_2d_boxes_matches_jax_modules():
    from threedod.data.batch import normalize_image as jnorm
    from threedod.models.rpn import RPN
    from threedod.ops.nms import batched_nms as jnms

    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils.convert_weights import from_jax_variables

    jcfg, pcfg = tp.configs(**{"shapes.max_detections": 32})
    pcfg.model.meta_architecture = "BoxNet"
    jmodel, variables = tp.jax_model(jcfg, predictor_scale=50.0)
    img, image_hw, K, ratio = tp.inputs()

    def composed(m, batch):  # boxnet.py:52-76 with train=False
        c = m.cfg
        feats = m.backbone(jnorm(batch.image, c.model, batch.image_hw), train=False)
        rpn_feats = {f: feats[f] for f in c.model.rpn.in_features}
        rpn = RPN(c, {f: (rpn_feats[f].shape[1], rpn_feats[f].shape[2]) for f in rpn_feats})
        logits, regs = m.rpn_head(rpn_feats, train=False)
        proposals = rpn.predict_proposals(logits, regs, batch.image_hw, train=False)
        det = m.roi_heads.box_branch_inference({f: feats[f] for f in c.model.roi_heads.in_features}, proposals,
                                               batch.image_hw)

        def per_image(b, s, v, cls):
            keep = jnms(b, s, jnp.zeros_like(s, jnp.int32), 0.5, valid=v)
            top_s, idx = jax.lax.top_k(jnp.where(keep, s, -jnp.inf), 20)
            ok = jnp.isfinite(top_s)
            return b[idx], jnp.where(ok, top_s, 0.0), cls[idx], ok

        return jax.vmap(per_image)(det.boxes, det.scores, det.valid, det.classes)

    ref = jax.jit(lambda v, b: jmodel.apply(v, b, method=composed))(variables, tp.jax_batch(img, image_hw, K, ratio))
    ref = [np.asarray(r) for r in ref]
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(variables, pcfg), strict=True)
    with torch.no_grad():
        got = model.predict_2d_boxes(tp.torch_batch(img, image_hw, K, ratio))
    boxes, scores, classes, valid = (g.numpy() for g in got)
    np.testing.assert_array_equal(valid, ref[3])
    assert valid.sum() >= 10
    np.testing.assert_array_equal(classes[valid], ref[2][valid])
    np.testing.assert_allclose(scores, ref[1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(boxes[valid], ref[0][valid], rtol=1e-4, atol=1e-3)


# ---- the tool --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A datasets root: two-image training and test JSONs, the images and
    the depth and ground maps linked."""
    out = tmp_path_factory.mktemp("datasets")
    (out / "Omni3D").mkdir()
    for split in ("train", "test"):
        data = json.loads((ROOT / "datasets" / "Omni3D" / f"synth_{split}.json").read_text())
        keep = {im["id"] for im in data["images"][:2]}
        data["images"] = data["images"][:2]
        data["annotations"] = [a for a in data["annotations"] if a["image_id"] in keep]
        (out / "Omni3D" / f"synth_{split}2.json").write_text(json.dumps(data))
    for name in ("synth", "depth_maps", "ground_maps"):
        os.symlink(ROOT / "datasets" / name, out / name)
    return out


def _run(root, out, *opts, pseudo_out=None):
    from threedod_torch import eval_boxes

    args = ["--config-file", CONFIG] + (["--pseudo-gt-out", pseudo_out] if pseudo_out else []) + SMALL + [
        "datasets.root", str(root), "output_dir", str(out), *opts]
    return eval_boxes.run(eval_boxes.parser().parse_args(args), torch.device("cpu"))


ROUTES = [("MABO", "GT", "propose"), ("IoU3D", "GT", "dim"), ("AP", "GT", "xy"), ("AP", "PRED", "propose")]


@pytest.mark.parametrize("mode,mode2d,sampler", ROUTES, ids=["-".join(r) for r in ROUTES])
def test_eval_boxes_routes(root, tmp_path, mode, mode2d, sampler):
    from threedod_torch.models.boxer import SCORE_NAMES

    out = _run(root, tmp_path, "plot.eval", mode, "plot.mode2d", mode2d, "plot.proposal_func", sampler)
    assert (out["eval"], out["mode2d"], out["proposal_function"], out["images"]) == (mode, mode2d, sampler, 2)
    assert out["k1_launches"] == 0  # the CPU pools with the plain version
    res = out["results"]
    if mode == "MABO":
        want = {f"{k}_{n}" for n in SCORE_NAMES for k in ("MABO", "ABO_best_possible")} | {"combinations_mean"}
        assert set(res) == want and len(res["combinations_mean"]) == 26
        assert all(math.isfinite(v) for k, v in res.items() if k != "combinations_mean")
        assert all(math.isfinite(v) for v in res["combinations_mean"])
        assert 0 < res["MABO_combined"] <= res["ABO_best_possible_combined"] <= 1
    elif mode == "IoU3D":
        assert set(res) == {"detection_rate@0.25", "detection_rate@0.5"}
        assert 0 <= res["detection_rate@0.5"] <= res["detection_rate@0.25"] <= 1
    else:
        assert set(res) == {"synth_test2"} and math.isfinite(res["synth_test2"]["AP2D"])
        assert json.loads((tmp_path / "results.json").read_text())["synth_test2"]["AP2D"] == res["synth_test2"]["AP2D"]
        if mode2d == "GT":  # the reference boxes are the ground truth's, so AP2D is perfect
            assert res["synth_test2"]["AP2D"] > 99.0


REFUSED = [(("plot.eval", "MABO", "plot.mode2d", "PRED"), "mode2d GT"),
           (("plot.eval", "IoU3D", "plot.mode2d", "PRED"), "mode2d GT"),
           (("plot.eval", "mAP"), "MABO, IoU3D or AP"),
           (("plot.mode2d", "BOTH"), "GT or PRED")]


@pytest.mark.parametrize("opts,match", REFUSED, ids=["mabo", "iou3d", "eval", "mode2d"])
def test_eval_boxes_refuses_unknown_routes(root, tmp_path, opts, match):
    with pytest.raises(ValueError, match=match):
        _run(root, tmp_path, *opts)


def test_pseudo_gt_json(root, tmp_path):
    """The pseudo ground truth of two training images: the tool's fields and
    values from the same best cubes, and a dataset ``train_net`` trains on."""
    from threedod.geometry.cuboids import cuboid_verts as jverts

    from threedod_torch import train_net
    from threedod_torch.data.build import TestLoader, get_dataset_dicts
    from threedod_torch.models.meta_arch import build_model

    out = _run(root, tmp_path, "train.pseudo_gt", "pseudo", pseudo_out="pseudo2")
    path = root / "Omni3D" / "pseudo2.json"
    assert out["pseudo_gt"] == str(path) and out["images"] == 2
    data = json.loads(path.read_text())
    src = json.loads((root / "Omni3D" / "synth_train2.json").read_text())
    assert data["images"] == src["images"] and data["categories"] == src["categories"]
    anns = data["annotations"]
    assert len(anns) == out["annotations"] == len(src["annotations"]) and anns
    for a in anns:
        assert set(a) == PSEUDO_FIELDS, set(a) ^ PSEUDO_FIELDS

    # what tools/eval_boxes.py:189-213 writes from the same cubes
    cfg, meta, priors = train_net.setup(CONFIG, SMALL + ["datasets.root", str(root), "output_dir", str(tmp_path)])
    model = build_model(cfg, priors=priors)
    gen = torch.Generator().manual_seed(cfg.seed)
    id_map_inv = {v: k for k, v in meta.thing_dataset_id_to_contiguous_id.items()}
    records = get_dataset_dicts(cfg.datasets.train)
    want, ann_id = [], 0
    for rec, (batch, _) in zip(records, TestLoader(records, cfg, load_maps=True)):
        # the maps load, and no instance masks are built: BoxNet fills its boxes
        assert batch.depth_map is not None and batch.ground_map is not None and batch.gt.masks is None
        with torch.no_grad():
            o, boxes, classes, valid = model(batch, "propose", with_iou3d=False, draws=gen)
        ratio = float(batch.im_scale_ratio[0])
        v, cubes, scores = valid.numpy()[0], o.best_cubes.numpy()[0], o.best_scores.numpy()[0]
        bx, cls = boxes.numpy()[0] * ratio, classes.numpy()[0]
        for j in range(len(v)):
            if not v[j]:
                continue
            ann_id += 1
            R = cubes[j, 6:].reshape(3, 3)
            want.append({
                "id": ann_id, "image_id": rec["image_id"], "dataset_id": rec.get("dataset_id", 0),
                "category_id": id_map_inv.get(int(cls[j]), int(cls[j])),
                "category_name": meta.thing_classes[int(cls[j])], "valid3D": True, "behind_camera": False,
                "bbox2D_proj": [float(x) for x in bx[j]], "bbox2D_trunc": [float(x) for x in bx[j]],
                "bbox2D_tight": [float(x) for x in bx[j]],
                "bbox": [float(bx[j][0]), float(bx[j][1]), float(bx[j][2] - bx[j][0]), float(bx[j][3] - bx[j][1])],
                "center_cam": cubes[j, :3].tolist(), "dimensions": cubes[j, 3:6].tolist(), "R_cam": R.tolist(),
                "pose": R.tolist(),
                "bbox3D_cam": np.asarray(jverts(jnp.asarray(cubes[j, :6]), jnp.asarray(R))).tolist(),
                "truncation": 0.0, "visibility": 1.0, "lidar_pts": 100, "segmentation_pts": 100, "depth_error": 0.0,
                "score": float(scores[j]),
            })
    assert len(want) == len(anns)
    for a, w in zip(anns, want):
        np.testing.assert_allclose(a.pop("bbox3D_cam"), w.pop("bbox3D_cam"), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.pop("bbox"), w.pop("bbox"), rtol=1e-6, atol=1e-4)  # the width as a difference
        assert a == w

    # the method's end: standard Cube R-CNN's setup registers and loads the file as a training dataset
    cfg2, _, _ = train_net.setup(str(ROOT / "configs" / "Base_Synth.yaml"),
                                 ["datasets.root", str(root), "datasets.train", "[pseudo2]", "datasets.test",
                                  "[synth_test2]", "output_dir", str(tmp_path / "train")])
    loaded = get_dataset_dicts(["pseudo2"])
    assert cfg2.datasets.train == ("pseudo2",) and len(loaded) == 2
    assert sum(len(r["annotations"]) for r in loaded) == len(anns)
