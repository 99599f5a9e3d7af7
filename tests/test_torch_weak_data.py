"""The weak path's data, the port vs Pillow and the JAX package, on the CPU,
on the repository's fixture (``datasets/{depth,ground}_maps``, 88 of each):

* ``resize_nearest`` bit-equal to Pillow's ``NEAREST`` on every depth map
  (mode ``F``) and every ground map (as ``F``, the mappers' form, and as a
  0/255 ``L`` mask at the mask grid's sizes), at the three training sizes
  and the test size of ``Omni_combined_Synth.yaml`` (the test size is the
  largest training size);
* ``DatasetMapper3D(load_maps=True)`` against the JAX mapper on all 60
  training records, each side given ``RandomState(5)``: depth and ground
  canvases and instance masks equal, the box fill and a stored-masks
  ``.npz`` (written by the test for a third of the records, for some of
  their annotations) included;
* ``collate``: the float16 depth, the uint8 ground map and the uint8 masks
  equal to the JAX ``collate(with_maps=True)``'s; samples without them give
  none.
"""
from __future__ import annotations

import copy
import os
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_port as tp  # noqa: F401  (one torch thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WEAK_CFG = str(ROOT / "configs" / "Omni_combined_Synth.yaml")
# 480x640 at min_size_train 320, 352, 384 on the 384x512 canvas (384 is also min_size_test)
SIZES = [(320, 427), (352, 469), (384, 512)]


def _maps(kind):
    key = {"depth_maps": "depth", "ground_maps": "mask"}[kind]
    out = []
    for path in sorted((ROOT / "datasets" / kind).glob("*.npz")):
        with np.load(path) as z:
            out.append(z[key])
    return out


@pytest.mark.parametrize("kind", ["depth_maps", "ground_maps"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_nearest_is_pillows(kind, size):
    from threedod_torch.data.resize import resize_nearest

    maps = _maps(kind)
    assert len(maps) == 88
    nh, nw = size
    for m in maps:
        f = np.asarray(m, np.float32)
        ref = np.asarray(Image.fromarray(f).resize((nw, nh), Image.NEAREST))
        np.testing.assert_array_equal(resize_nearest(torch.from_numpy(f), nh, nw).numpy(), ref)
        if kind == "ground_maps":  # a uint8 mask at the mask grid's size
            u = (np.asarray(m) > 0).astype(np.uint8) * 255
            mh, mw = max(round(nh / 4), 1), max(round(nw / 4), 1)
            ref = np.asarray(Image.fromarray(u).resize((mw, mh), Image.NEAREST))
            np.testing.assert_array_equal(resize_nearest(torch.from_numpy(u), mh, mw).numpy(), ref)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """Both mappers with ``load_maps`` over the 60 training records, a third
    of them with a stored-masks file."""
    from threedod.config import load_config as jax_load
    from threedod.data.mapper import DatasetMapper3D as JaxMapper

    from threedod_torch.config_yaml import load_config
    from threedod_torch.data import omni3d
    from threedod_torch.data.mapper import DatasetMapper3D

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        jcfg, pcfg = jax_load(WEAK_CFG), load_config(WEAK_CFG)
        fs = omni3d.get_filter_settings_from_cfg(pcfg)
        omni3d.CATALOG.clear()
        ds = omni3d.Omni3D([os.path.join(pcfg.datasets.root, "Omni3D", "synth_train.json")], filter_settings=fs)
        omni3d.register_and_store_model_metadata(ds, str(tmp_path_factory.mktemp("meta")), fs)
        records = omni3d.load_omni3d_json(os.path.join(pcfg.datasets.root, "Omni3D", "synth_train.json"),
                                          pcfg.datasets.root, "synth_train", fs)
        assert all("depth_image_path" in r and "ground_image_path" in r for r in records)
        records = copy.deepcopy(records)
        masks_dir = tmp_path_factory.mktemp("object_masks")
        rng = np.random.RandomState(0)
        stored = 0
        for r in records[::3]:
            ids = [a["ann_id"] for a in r["annotations"]][::2]
            masks = rng.rand(len(ids), r["height"], r["width"]) > 0.7
            path = str(masks_dir / f"{r['image_id']}.npz")
            np.savez(path, masks=masks, ann_ids=np.asarray(ids, np.int64))
            r["object_masks_path"] = path
            stored += len(ids)
        assert stored > 0
        jm = JaxMapper(jcfg, is_train=True, load_maps=True, rng=np.random.RandomState(5))
        pm = DatasetMapper3D(pcfg, is_train=True, load_maps=True, rng=np.random.RandomState(5))
        return records, [jm(r) for r in records], [pm(r) for r in records], pcfg
    finally:
        os.chdir(cwd)


def test_mapper_maps_and_masks_match(mapped):
    records, jout, pout, pcfg = mapped
    assert len(records) == 60
    flips = 0
    for r, j, p in zip(records, jout, pout):
        for key in ("depth_map", "ground_map"):
            assert p[key].dtype == torch.float32 and p[key].shape == (384, 512), key
            np.testing.assert_array_equal(p[key].numpy(), j[key], err_msg=f"{key} {r['file_name']}")
        assert p["gt_masks"].dtype == np.float32 and p["gt_masks"].shape == (len(r["annotations"]), 96, 128)
        np.testing.assert_array_equal(p["gt_masks"], j["gt_masks"], err_msg=r["file_name"])
        np.testing.assert_array_equal(p["image_hw"], j["image_hw"])
        nh, nw = p["image_hw"]
        depth = np.load(os.path.join(ROOT, r["depth_image_path"]))["depth"]
        flips += bool((p["depth_map"][:nh, :nw].numpy()
                       != np.asarray(Image.fromarray(depth).resize((nw, nh), Image.NEAREST))).any())
    assert flips > 0  # some maps are mirrored with their image
    # the stored masks were read: the first annotation of every third record
    # holds a random mask, which no box fill gives
    for r, p in zip(records[::3], pout[::3]):
        x1, y1, x2, y2 = p["gt_boxes2d"][0] / 4.0
        ys, xs = np.arange(96)[:, None], np.arange(128)[None, :]
        assert (p["gt_masks"][0] != ((ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2))).any(), r["file_name"]
    assert len({tuple(p["image_hw"]) for p in pout}) == 3
    assert any(p["ground_map"].sum() > 0 for p in pout)


def test_collate_maps_and_masks(mapped):
    from threedod.data.batch import collate as jax_collate

    from threedod_torch.data.batch import collate

    _, jout, pout, pcfg = mapped
    max_gt = pcfg.shapes.max_gt
    for s in range(0, len(pout), 8):
        jb = jax_collate(jout[s:s + 8], max_gt, with_maps=True)
        pb = collate(pout[s:s + 8], max_gt)
        assert pb.depth_map.dtype == torch.float16 and pb.ground_map.dtype == torch.uint8
        assert pb.gt.masks.dtype == torch.uint8 and pb.gt.masks.shape == (len(pout[s:s + 8]), max_gt, 96, 128)
        np.testing.assert_array_equal(pb.depth_map.numpy(), np.asarray(jb.depth_map))
        np.testing.assert_array_equal(pb.ground_map.numpy(), np.asarray(jb.ground_map))
        np.testing.assert_array_equal(pb.gt.masks.numpy(), np.asarray(jb.gt.masks))
    plain = collate([{k: v for k, v in p.items() if k not in ("depth_map", "ground_map", "gt_masks")}
                     for p in pout[:8]], max_gt)
    assert plain.depth_map is None and plain.ground_map is None and plain.gt.masks is None
