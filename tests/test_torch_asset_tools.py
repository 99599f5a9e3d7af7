"""The port's weak-method asset tools (``python -m threedod_torch.
generate_object_masks``, ``generate_ground_segmentations``,
``generate_depth_maps``, ``generate_normal_vectors``, ``filter_ground``)
against compositions of the JAX package's functions, as ``tools/*.py`` compose
them, on the same weights, on the CPU in f32.

Each tool's ``run(args, "cpu")`` works on three images of the fixture's
synth_val (11 annotations) and writes into ``tmp_path``; nothing is written
under ``datasets/``. SAM is SAM-HQ reduced (256 px, width 96, depth 4, global
blocks 1 and 3), saved as a state dict and loaded by the tool as a checkpoint
(its size read from the shapes); the JAX side runs ``Sam`` on the same
variables one box a call, as the JAX tools do. Masks must be equal wherever
the JAX logits, resized to the image, have |x| > 1e-3. DA-V2 is vits at a
70 px input (5 x 7 tokens), depth within 1e-4 of the largest value. The
normals replay the JAX tool's key tree (one split an image) and must be
within 1e-5. Also: the file formats, the CSV and the 1 % rule, the JAX and the
port's mappers reading the tool's object masks to equal arrays, and every
entry point refusing to run without a CUDA card.
"""
from __future__ import annotations

import argparse
import copy
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from threedod.models import sam as jsam
from threedod_torch import (filter_ground, generate_depth_maps, generate_ground_segmentations,
                            generate_normal_vectors, generate_object_masks)
from threedod_torch.utils.convert_weights import sam_from_jax_variables

from _torch_port import close, random_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_ROOT = os.path.join(ROOT, "datasets")
IMG = 256
SAM_CFG = dict(encoder_dim=96, encoder_depth=4, encoder_heads=2, global_attn_indexes=(1, 3), img_size=IMG)
IMAGE_IDS = (61, 63, 68)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A three-image dataset json, a SAM-HQ checkpoint, the JAX SAM jitted."""
    tmp = tmp_path_factory.mktemp("assets")
    with open(os.path.join(IMAGE_ROOT, "Omni3D", "synth_val.json")) as f:
        data = json.load(f)
    data["images"] = [im for im in data["images"] if im["id"] in IMAGE_IDS]
    data["annotations"] = [a for a in data["annotations"] if a["image_id"] in IMAGE_IDS]
    ds = str(tmp / "three.json")
    with open(ds, "w") as f:
        json.dump(data, f)
    model = jsam.Sam(hq=True, **SAM_CFG)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                                               jnp.zeros((1, 4))))["params"]
    params = random_like(shapes, seed=13)
    ckpt = str(tmp / "sam_hq.pth")
    torch.save(sam_from_jax_variables(params, True), ckpt)
    infer = jax.jit(lambda p, x, b: model.apply({"params": p}, x, b))
    return dict(tmp=tmp, data=data, json=ds, ckpt=ckpt, sam=lambda x, b: infer(params, x, b))


def _image(im):
    return np.asarray(Image.open(os.path.join(IMAGE_ROOT, im["file_path"])).convert("RGB"), np.float32)


def jax_mask_logits(setup, im, box):
    """The JAX tools' composition for one box: the image's logits resized to
    the image (the tools threshold these at 0)."""
    h, w = im["height"], im["width"]
    x, scale = jsam.preprocess_sam_image(jnp.asarray(_image(im)), IMG)
    logits = setup["sam"](x, jnp.asarray([[c * scale for c in box]], jnp.float32))
    up = jax.image.resize(logits[0], (IMG, IMG), method="linear")
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return np.asarray(jax.image.resize(up[:nh, :nw], (h, w), method="linear"))


def agree(mask, logits):
    """The port's mask equals the JAX one wherever |logit| > 1e-3, and that
    is most of the image."""
    firm = np.abs(logits) > 1e-3
    assert firm.mean() > 0.9
    assert np.array_equal(mask[firm], (logits > 0)[firm].astype(np.uint8))


def test_object_masks(setup, tmp_path):
    out = str(tmp_path / "object_masks")
    args = generate_object_masks.parser().parse_args(
        ["--dataset-json", setup["json"], "--image-root", IMAGE_ROOT, "--out-dir", out, "--checkpoint",
         setup["ckpt"], "--img-size", str(IMG), "--device", "cpu"])
    res = generate_object_masks.run(args, torch.device("cpu"), torch.float32)
    assert res["hq"] and res["masks"] == 11 and sorted(os.listdir(out)) == [f"{i}.npz" for i in IMAGE_IDS]
    anns = {}
    for a in setup["data"]["annotations"]:
        anns.setdefault(a["image_id"], []).append(a)
    for im in setup["data"]["images"]:
        with np.load(os.path.join(out, f"{im['id']}.npz")) as z:
            masks, ids = z["masks"], z["ann_ids"]
        assert masks.dtype == np.uint8 and masks.shape == (len(anns[im["id"]]), 480, 640)
        assert ids.dtype == np.int64 and ids.tolist() == [a["id"] for a in anns[im["id"]]]
        for m, a in zip(masks, anns[im["id"]]):
            bx, by, bw, bh = a["bbox"]
            agree(m, jax_mask_logits(setup, im, [bx, by, bx + bw, by + bh]))
    # the box fill: no model, the filled 2D boxes
    fill = str(tmp_path / "fill")
    generate_object_masks.run(generate_object_masks.parser().parse_args(
        ["--dataset-json", setup["json"], "--image-root", IMAGE_ROOT, "--out-dir", fill, "--box-fill"]),
        torch.device("cpu"))
    with np.load(os.path.join(fill, "61.npz")) as z:
        bx, by, bw, bh = anns[61][0]["bbox"]
        assert z["masks"][0].sum() == ((np.arange(480)[:, None] >= by) & (np.arange(480)[:, None] < by + bh)).sum() \
            * ((np.arange(640) >= bx) & (np.arange(640) < bx + bw)).sum()
    _mappers_read_the_masks(out, tmp_path)


def _mappers_read_the_masks(out, tmp):
    """The JAX mapper and the port's read the tool's files to equal arrays,
    and what they read is the stored masks, not the filled boxes."""
    from threedod.config import load_config as jax_load
    from threedod.data.mapper import DatasetMapper3D as JaxMapper

    from threedod_torch.config_yaml import load_config
    from threedod_torch.data import omni3d
    from threedod_torch.data.mapper import DatasetMapper3D

    cfg_path = os.path.join(ROOT, "configs", "Omni_combined_Synth.yaml")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        jcfg, pcfg = jax_load(cfg_path), load_config(cfg_path)
        fs = omni3d.get_filter_settings_from_cfg(pcfg)
        json_path = os.path.join(pcfg.datasets.root, "Omni3D", "synth_val.json")
        omni3d.CATALOG.clear()
        omni3d.register_and_store_model_metadata(omni3d.Omni3D([json_path], filter_settings=fs), str(tmp), fs)
        records = omni3d.load_omni3d_json(json_path, pcfg.datasets.root, "synth_val", fs)
        records = [copy.deepcopy(r) for r in records if r["image_id"] in IMAGE_IDS]
        assert len(records) == 3
        jm = JaxMapper(jcfg, is_train=True, load_maps=True, rng=np.random.RandomState(5))
        pm = DatasetMapper3D(pcfg, is_train=True, load_maps=True, rng=np.random.RandomState(5))
        boxes = DatasetMapper3D(pcfg, is_train=True, load_maps=True, rng=np.random.RandomState(5))
        read = 0
        for r in records:
            fill = boxes(r)["gt_masks"]  # no stored masks: the filled boxes
            r["object_masks_path"] = os.path.join(out, f"{r['image_id']}.npz")
            j, p = jm(r), pm(r)
            assert p["gt_masks"].shape[0] == len(r["annotations"]) > 0
            np.testing.assert_array_equal(p["gt_masks"], j["gt_masks"])
            read += sum(not np.array_equal(a, b) for a, b in zip(p["gt_masks"], fill))
        assert read > 0
    finally:
        os.chdir(cwd)


def test_ground_masks_and_filter(setup, tmp_path):
    out, csv_path = str(tmp_path / "ground"), str(tmp_path / "no_ground_idx.csv")
    boxes = str(tmp_path / "boxes.json")
    with open(boxes, "w") as f:
        json.dump({"63": [5.0, 300.0, 630.0, 470.0]}, f)
    args = generate_ground_segmentations.parser().parse_args(
        ["--dataset-json", setup["json"], "--image-root", IMAGE_ROOT, "--out-dir", out, "--no-ground-csv",
         csv_path, "--checkpoint", setup["ckpt"], "--ground-boxes", boxes, "--heuristic", "--img-size", str(IMG)])
    res = generate_ground_segmentations.run(args, torch.device("cpu"), torch.float32)
    assert res["k3_launches"] == 0
    failures = []
    for im in setup["data"]["images"]:
        h, w = im["height"], im["width"]
        box = [5.0, 300.0, 630.0, 470.0] if im["id"] == 63 else [0.0, h * 2 / 3, w - 1.0, h - 1.0]
        logits = jax_mask_logits(setup, im, box)
        if (logits > 0).sum() < 0.01 * h * w:
            failures.append(im["id"])
            assert not os.path.exists(os.path.join(out, f"{im['id']}.npz"))
            continue
        with np.load(os.path.join(out, f"{im['id']}.npz")) as z:
            assert list(z.keys()) == ["mask"] and z["mask"].dtype == np.uint8 and z["mask"].shape == (h, w)
            agree(z["mask"], logits)
    with open(csv_path) as f:
        assert [int(r["img_id"]) for r in csv.DictReader(f)] == failures == res["no_ground"]
    # filter_ground: a mask under 1 % goes, its id merges into the CSV
    np.savez_compressed(os.path.join(out, "999.npz"), mask=np.zeros((480, 640), np.uint8))
    tiny = np.zeros((480, 640), np.uint8)
    tiny[:10, :30] = 1  # 0.1 %
    np.savez_compressed(os.path.join(out, "998.npz"), mask=tiny)
    with open(csv_path, "a") as f:
        f.write("7\n")
    kept = sorted(os.listdir(out))
    got = filter_ground.run(argparse.Namespace(ground_dir=out, no_ground_csv=csv_path, min_fraction=0.01))
    assert sorted(got["removed"]) == [998, 999]
    assert sorted(os.listdir(out)) == [k for k in kept if k not in ("998.npz", "999.npz")]
    with open(csv_path) as f:
        assert [int(r["img_id"]) for r in csv.DictReader(f)] == sorted(set(failures) | {7, 998, 999})


def test_gdino_input_matches_the_jax_tool():
    """GroundingDINO's input as the JAX tool makes it (the model is held
    against JAX in ``test_torch_gdino.py``)."""
    im = {"file_path": "synth/images/000061.jpg"}
    arr = _image(im)
    mean, std = jnp.asarray([123.675, 116.28, 103.53]), jnp.asarray([58.395, 57.12, 57.375])
    want = ((jax.image.resize(jnp.asarray(arr), (96, 96, 3), method="linear") - mean) / std)[None]
    got = generate_ground_segmentations.gdino_input(torch.from_numpy(arr.astype(np.uint8)), 96)
    close(got, want, tol=1e-5)


def test_depth_maps(setup, tmp_path):
    from threedod.models.depth import DepthAnythingV2, preprocess_image
    from threedod.models.depth.dpt import resize_align_corners
    from threedod.utils.convert_weights import convert_depth_anything_v2

    from threedod_torch.models.depth.dpt import build_depth_model

    out = str(tmp_path / "depth")
    args = generate_depth_maps.parser().parse_args(
        ["--dataset-json", setup["json"], "--image-root", IMAGE_ROOT, "--out-dir", out, "--encoder", "vits",
         "--random-weights", "--input-size", "70"])
    generate_depth_maps.run(args, torch.device("cpu"), torch.float32)
    sd = {k: v.numpy() for k, v in build_depth_model("vits", dtype=torch.float32, seed=0).state_dict().items()}
    model = DepthAnythingV2(encoder="vits", max_depth=20.0)
    infer = jax.jit(lambda p, x: model.apply({"params": p}, x))
    params = convert_depth_anything_v2(sd, "vits")
    for im in setup["data"]["images"]:
        x = preprocess_image(jnp.asarray(_image(im) / 255.0), 70)
        assert x.shape == (1, 70, 98, 3)
        want = resize_align_corners(infer(params, x)[..., None], im["height"], im["width"])[0, ..., 0]
        with np.load(os.path.join(out, f"{im['id']}.npz")) as z:
            assert list(z.keys()) == ["depth"] and z["depth"].dtype == np.float32
            close(z["depth"], want)


def test_normal_vectors(setup, tmp_path):
    from threedod.models.boxer import ground_plane_from_depth

    data = dict(setup["data"], images=setup["data"]["images"] + [dict(setup["data"]["images"][0], id=12345)])
    ds = str(tmp_path / "with_missing.json")  # an image with no depth map is skipped, draws nothing
    with open(ds, "w") as f:
        json.dump(data, f)
    depth_dir, ground_dir = os.path.join(IMAGE_ROOT, "depth_maps"), os.path.join(IMAGE_ROOT, "ground_maps")
    key, keys = jax.random.PRNGKey(0), []
    for _ in IMAGE_IDS:
        key, k = jax.random.split(key)
        keys.append(k)
    fit = jax.jit(lambda k, d, K, g: ground_plane_from_depth(k, d, K, g)[0])
    idx = [np.asarray(jax.random.randint(k, (1000, 3), 0, 96 * 128)) for k in keys]
    out = str(tmp_path / "normals.json")
    args = generate_normal_vectors.parser().parse_args(
        ["--dataset-json", ds, "--depth-dir", depth_dir, "--ground-dir", ground_dir, "--out", out])
    res = generate_normal_vectors.run(args, torch.device("cpu"), hypotheses=lambda i, n: torch.from_numpy(idx[i]))
    assert res["normals"] == 3
    with open(out) as f:
        got = json.load(f)
    assert sorted(got) == sorted(str(i) for i in IMAGE_IDS)
    for k, im in zip(keys, setup["data"]["images"]):
        depth = np.load(os.path.join(depth_dir, f"{im['id']}.npz"))["depth"]
        ground = np.load(os.path.join(ground_dir, f"{im['id']}.npz"))["mask"]
        want = np.asarray(fit(k, depth, jnp.asarray(im["K"], jnp.float32), ground), np.float64)
        assert np.abs(np.asarray(got[str(im["id"])]) - want).max() <= 1e-5
        assert got[str(im["id"])] == np.asarray(got[str(im["id"])]).round(6).tolist()
        assert abs(np.linalg.norm(got[str(im["id"])]) - 1.0) < 1e-5
    # the card's own draws: a generator seeded with --seed
    generate_normal_vectors.run(args, torch.device("cpu"))
    with open(out) as f:
        assert sorted(json.load(f)) == sorted(str(i) for i in IMAGE_IDS)


@pytest.mark.parametrize("tool", [generate_object_masks, generate_ground_segmentations, generate_depth_maps,
                                  generate_normal_vectors], ids=lambda m: m.__name__.split(".")[-1])
def test_entry_points_refuse_without_cuda(tool, tmp_path):
    argv = ["--dataset-json", os.path.join(IMAGE_ROOT, "Omni3D", "synth_val.json"), "--device", "cpu"]
    argv += ["--out", str(tmp_path / "n.json")] if tool is generate_normal_vectors else \
        ["--out-dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(argv)
    assert not any(tmp_path.iterdir())  # refused before anything was written
