"""The port's evaluation vs the JAX package's, on the CPU:

* ``box3d_overlap`` against the JAX one within 1e-5: seeded rotated boxes,
  identical and disjoint pairs, boxes touching face to face, reflected
  corners, and zero-volume and non-finite boxes (those score 0);
* ``Omni3DEval`` in 2D and 3D on prediction sets written here: ground truth
  jittered, false positives, tied scores, ignore flags, boxes over the 2D area
  ranges and the 3D depth ranges; AP, the per-category AP and the summary
  within 1e-6 of the JAX evaluator's on the same inputs, and so is the
  precision table. The jitter is drawn again until no IoU of a prediction with
  a ground truth of its image and category lies within 1e-3 of a threshold
  (2D .5:.05:.95, 3D .05:.05:.5), and no depth or area within 1e-3 of a range
  boundary, so that float32 rounding cannot flip a match;
* ``detections_to_coco_json`` and ``gts_from_records`` give equal records.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread a worker)

import jax

ATOL_IOU = 1e-5
SIGNS = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64)


def corners(center, dims, yaw):
    """8 corners (the layout of ``cuboids.cuboid_verts``) of a box rotated about y."""
    w, h, l = dims
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return (SIGNS * np.array([l, h, w]) / 2) @ R.T + np.asarray(center)


def _jax_iou(a, b):
    from threedod.geometry.iou3d import box3d_overlap

    return np.asarray(jax.jit(lambda x, y: box3d_overlap(x, y)[1])(a, b))


def _port_iou(a, b):
    from threedod_torch.geometry.iou3d import box3d_overlap

    return box3d_overlap(torch.from_numpy(a), torch.from_numpy(b))[1].numpy()


# ---- IoU3D -------------------------------------------------------------------------------


def _boxes(rng, n, spread=1.5):
    return np.stack([corners(rng.uniform(-spread, spread, 3), rng.uniform(0.3, 2.0, 3), rng.uniform(-np.pi, np.pi))
                     for _ in range(n)]).astype(np.float32)


def test_iou3d_seeded_rotated_boxes():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 24), _boxes(rng, 20)
    got, want = _port_iou(a, b), _jax_iou(a, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_IOU)
    assert (want > 0.05).sum() > 40 and (want == 0).sum() > 40  # overlapping and disjoint pairs both


def test_iou3d_special_pairs():
    unit = corners([0, 0, 5], [1, 1, 1], 0.0)
    cases = [
        (unit, unit, 1.0),  # identical
        (unit, corners([3, 0, 5], [1, 1, 1], 0.0), 0.0),  # disjoint
        (unit, corners([1, 0, 5], [1, 1, 1], 0.0), 0.0),  # touching face to face
        (unit, corners([0.5, 0, 5], [1, 1, 1], 0.0), 1 / 3),  # half overlap
        (unit, corners([0, 0, 5], [2, 2, 2], 0.0), 1 / 8),  # nested
        (corners([0, 0, 5], [1, 2, 1], 0.3), corners([0, 0, 5], [1, 2, 1], 0.3 + np.pi / 2), None),  # rotated
        (unit, unit[[1, 0, 3, 2, 5, 4, 7, 6]], 1.0),  # reflected corner order
        (unit, corners([0, 0, 5], [1, 0, 1], 0.0), 0.0),  # zero volume
        (unit, np.full((8, 3), np.nan), 0.0),  # non-finite
        (unit, unit + np.array([np.inf, 0, 0]), 0.0),
    ]
    a = np.stack([c[0] for c in cases]).astype(np.float32)
    b = np.stack([c[1] for c in cases]).astype(np.float32)
    from threedod_torch.geometry.iou3d import iou3d_pairs

    got = iou3d_pairs(torch.from_numpy(a), torch.from_numpy(b))[1].numpy()
    for i, (_, _, want) in enumerate(cases):
        if want is not None:
            assert abs(got[i] - want) < ATOL_IOU, (i, got[i], want)
    finite = np.isfinite(b).all(axis=(1, 2))
    ref = np.array([_jax_iou(a[i:i + 1], b[i:i + 1])[0, 0] for i in np.flatnonzero(finite)])
    np.testing.assert_allclose(got[finite], ref, rtol=0, atol=ATOL_IOU)
    assert got[~finite].tolist() == [0.0, 0.0]


def test_iou3d_cross_matrix_and_chunks(monkeypatch):
    from threedod_torch.geometry import iou3d

    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 9), _boxes(rng, 7)
    whole = _port_iou(a, b)
    monkeypatch.setattr(iou3d, "CHUNK", 5)  # 63 pairs in 13 chunks
    np.testing.assert_array_equal(_port_iou(a, b), whole)
    assert iou3d.box3d_overlap(torch.zeros(0, 8, 3), torch.from_numpy(b))[1].shape == (0, 7)


# ---- Omni3DEval ---------------------------------------------------------------------------


TH2D = np.linspace(0.5, 0.95, 10)
TH3D = np.linspace(0.05, 0.5, 10)


def _iou2d(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[0] + a[2], b[0] + b[2]), min(a[1] + a[3], b[1] + b[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def _clear(v, thresholds, margin=1e-3):
    return np.all(np.abs(np.asarray(thresholds) - v) > margin)


def _dataset(seed=3):
    """(gts, dts) over 8 images and 3 categories (ids 11, 12, 14)."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for img in range(8):
        for k in range(rng.randint(3, 7)):
            cat = int(rng.choice([11, 12, 14]))
            while True:  # depths clear of the near/medium/far bounds, areas clear of 32^2 and 96^2
                z, side = rng.uniform(4, 60), np.exp(rng.uniform(np.log(12), np.log(220)))
                if _clear(z, (10, 35), 0.05) and _clear(side * side, (32 ** 2, 96 ** 2), 5.0):
                    break
            x, y, w = rng.uniform(0, 400), rng.uniform(0, 300), side * rng.uniform(0.7, 1.3)
            center, dims, yaw = [rng.uniform(-3, 3), rng.uniform(-1, 1), z], rng.uniform(0.4, 2.0, 3), rng.uniform(-3, 3)
            ignore = bool(rng.rand() < 0.12)
            g = dict(id=len(gts) + 1, image_id=img, category_id=cat, bbox=[x, y, w, side], area=w * side, depth=z,
                     ignore=ignore, ignore2D=ignore, ignore3D=ignore,
                     bbox3D=corners(center, dims, yaw).astype(np.float32).tolist())
            gts.append(g)
            if rng.rand() < 0.8:  # a detection of this box, jittered
                while True:
                    bb = [x + rng.normal(0, 0.08 * w), y + rng.normal(0, 0.08 * side),
                          w * rng.uniform(0.85, 1.15), side * rng.uniform(0.85, 1.15)]
                    c3 = np.add(center, rng.normal(0, [0.1, 0.1, 0.02 * z]))
                    d3 = dims * rng.uniform(0.8, 1.2, 3)
                    corners3 = corners(c3, d3, yaw + rng.normal(0, 0.2)).astype(np.float32)
                    iou3 = _port_iou(corners3[None], np.asarray(g["bbox3D"], np.float32)[None])[0, 0]
                    if (_clear(_iou2d(bb, g["bbox"]), TH2D) and _clear(iou3, TH3D)
                            and _clear(c3[2], (10, 35)) and _clear(bb[2] * bb[3], (32 ** 2, 96 ** 2))):
                        break
                score = round(float(rng.uniform(0.05, 1.0)), 2)  # two decimals: ties happen
                dts.append(dict(image_id=img, category_id=cat, bbox=bb, score=score, depth=float(c3[2]),
                                bbox3D=corners3.tolist()))
        for _ in range(rng.randint(1, 4)):  # false positives
            z = rng.uniform(4, 60)
            bb = [rng.uniform(0, 400), rng.uniform(0, 300), rng.uniform(10, 200), rng.uniform(10, 200)]
            dts.append(dict(image_id=img, category_id=int(rng.choice([11, 12, 14])), bbox=bb,
                            score=round(float(rng.uniform(0.05, 1.0)), 2), depth=z,
                            bbox3D=corners([rng.uniform(-3, 3), 0, z], rng.uniform(0.4, 2.0, 3), 0.0)
                            .astype(np.float32).tolist()))
    return gts, dts


def _check_clear(gts, dts):
    """No IoU of a detection with a ground truth of its image and category
    lies within 1e-3 of a threshold."""
    by = {}
    for g in gts:
        by.setdefault((g["image_id"], g["category_id"]), []).append(g)
    pairs2, pairs3 = [], []
    for d in dts:
        for g in by.get((d["image_id"], d["category_id"]), []):
            pairs2.append(_iou2d(d["bbox"], g["bbox"]))
            pairs3.append((d["bbox3D"], g["bbox3D"]))
    a = np.asarray([p[0] for p in pairs3], np.float32)
    b = np.asarray([p[1] for p in pairs3], np.float32)
    from threedod_torch.geometry.iou3d import iou3d_pairs

    iou3 = iou3d_pairs(torch.from_numpy(a), torch.from_numpy(b))[1].numpy()
    assert all(_clear(v, TH2D) for v in pairs2) and all(_clear(v, TH3D) for v in iou3)
    return np.asarray(pairs2), iou3


@pytest.fixture(scope="module")
def dataset():
    gts, dts = _dataset()
    iou2, iou3 = _check_clear(gts, dts)
    assert (iou2 > 0.5).sum() > 20 and (iou3 > 0.05).sum() > 20 and len(set(d["score"] for d in dts)) < len(dts)
    return gts, dts


@pytest.mark.parametrize("mode", ["2D", "3D"])
def test_omni3d_eval_matches_jax(dataset, mode):
    from threedod.evaluation.omni3d_eval import Omni3DEval as JaxEval

    from threedod_torch.evaluation.omni3d_eval import Omni3DEval

    gts, dts = dataset
    evs = []
    for cls in (Omni3DEval, JaxEval):
        ev = cls(copy.deepcopy(gts), copy.deepcopy(dts), mode=mode)
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        evs.append(ev)
    port, ref = evs
    np.testing.assert_allclose(port.stats, ref.stats, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.eval["precision"], ref.eval["precision"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.eval["recall"], ref.eval["recall"], rtol=0, atol=1e-6)
    pc, rc = port.per_category_ap(), ref.per_category_ap()
    assert pc.keys() == rc.keys() == {11, 12, 14}
    for k in pc:
        assert abs(pc[k] - rc[k]) <= 1e-6, k
    assert 0.05 < port.stats[0] < 0.95  # neither empty nor perfect
    if mode == "3D":
        assert all(port.stats[i] > -1 for i in (4, 5, 6))  # near, medium and far all populated


def test_evaluation_helper_matches_jax(dataset):
    from threedod.evaluation.inference import Omni3DEvaluationHelper as JaxHelper

    from threedod_torch.evaluation.inference import Omni3DEvaluationHelper

    gts, dts = dataset
    id_map = {11: 0, 12: 1, 14: 2}
    names = ["synth_a", "synth_b"]
    port, ref = Omni3DEvaluationHelper(names, ["a", "b", "c"], id_map), JaxHelper(names, ["a", "b", "c"], id_map)
    half = [d for d in dts if d["image_id"] < 4], [g for g in gts if g["image_id"] < 4]
    for h in (port, ref):
        h.evaluate("synth_a", copy.deepcopy(half[1]), copy.deepcopy(half[0]))
        h.evaluate("synth_b", copy.deepcopy(gts), copy.deepcopy(dts))
    p, r = port.summarize_all(), ref.summarize_all()
    assert p.keys() == r.keys() and "<Union>" in p
    for name in names:
        for key, val in r[name].items():
            if isinstance(val, dict):
                assert val.keys() == p[name][key].keys()
                np.testing.assert_allclose(list(p[name][key].values()), list(val.values()), rtol=0, atol=1e-4)
            else:
                assert abs(p[name][key] - val) <= 1e-4, (name, key)  # AP in percent: 1e-6 of a unit
    for key in ("AP2D", "AP3D"):
        assert abs(p["<Union>"][key] - r["<Union>"][key]) <= 1e-4


# ---- predictions and ground truth as records ---------------------------------------------


def test_detections_to_coco_json_matches_jax():
    from threedod.evaluation.inference import detections_to_coco_json as jax_json

    from threedod_torch.evaluation.inference import detections_to_coco_json
    from threedod_torch.models.roi_heads3d import Detections

    rng = np.random.RandomState(4)
    b, d = 3, 6
    xy = rng.uniform(0, 300, (b, d, 2))
    arrays = dict(
        boxes=np.concatenate([xy, xy + rng.uniform(1, 80, (b, d, 2))], -1).astype(np.float32),
        scores=rng.uniform(0, 1, (b, d)).astype(np.float32), scores_2d=rng.uniform(0, 1, (b, d)).astype(np.float32),
        classes=rng.randint(0, 3, (b, d)), valid=rng.rand(b, d) < 0.7,
        center_cam=rng.randn(b, d, 3).astype(np.float32), dimensions=rng.uniform(0.3, 2, (b, d, 3)).astype(np.float32),
        pose=rng.randn(b, d, 3, 3).astype(np.float32), center_2d=rng.randn(b, d, 2).astype(np.float32),
        corners3d=rng.randn(b, d, 8, 3).astype(np.float32))
    arrays["scores"][0, 0] = 0.0  # at the threshold: dropped
    ids, ratios, id_map_inv = np.array([7, 8, 9]), np.ones(3, np.float32), {0: 11, 1: 12, 2: 14}
    port = detections_to_coco_json(Detections(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}),
                                   torch.from_numpy(ids), ratios, id_map_inv)
    ref = jax_json(Detections(**arrays), ids, ratios, id_map_inv)
    assert port == ref and len(port) > 5


def test_gts_from_records_matches_jax():
    import os
    import pathlib

    from threedod.evaluation.inference import gts_from_records as jax_gts

    from threedod_torch.config import Config
    from threedod_torch.data import omni3d
    from threedod_torch.evaluation.inference import gts_from_records

    root = pathlib.Path(__file__).resolve().parents[1] / "datasets"
    fs = omni3d.get_filter_settings_from_cfg(Config())
    fs["category_names"] = ["chair", "table", "sofa", "bed", "cabinet"]
    omni3d.CATALOG.metadata("omni3d_model").thing_dataset_id_to_contiguous_id = {1: 0, 2: 1, 3: 2, 4: 3, 5: 4}
    records = omni3d.load_omni3d_json(str(root / "Omni3D" / "synth_test.json"), str(root), "synth_test", fs)
    assert os.path.exists(records[0]["file_name"])
    id_map_inv = {0: 1, 1: 2, 2: 3, 3: 4, 4: 5}
    port, ref = gts_from_records(records, id_map_inv), jax_gts(records, id_map_inv)
    assert port == ref and len(port) > 20
    assert {g["category_id"] for g in port} <= {1, 2, 3, 4, 5, -1}  # dataset ids, -1 for ignores
