"""The port's data path vs the JAX package's, on the CPU, on the repository's
synthetic fixture (``datasets/Omni3D/synth_*.json``, ``datasets/synth/images``):

* the config reader: ``parse_yaml`` equals ``yaml.safe_load`` on every
  ``configs/*.yaml``; ``load_config`` equals the JAX ``load_config`` on every
  field the port's ``Config`` has, for each config whose keys the port knows,
  and raises ``KeyError`` naming the first unknown key for the others; command
  line overrides give the same result in both;
* metadata and priors under Base_Synth: ``thing_classes``, the id maps and the
  filtered records exactly, every ``compute_priors`` array within 1e-12
  relative, and the port model's ``priors_*`` equal to the JAX model's through
  ``from_jax_variables``;
* the resize: bit-equal to Pillow's ``BILINEAR`` on seeded images at 40
  sizes, up and down, odd sizes included, and on the fixture at every
  Base_Synth size;
* the mapper on all 60 training records (train mode) and all 20 test records
  (test mode), each side given ``RandomState(5)``: bit-equal uint8 canvases,
  equal ``image_hw``, and K, ratios, boxes and poses within 1e-6; ``collate``
  gives equal Batch fields;
* the sampler: repeat factors within 1e-12, and the loader's stream of indices,
  scales and flips is the one ``RandomState(seed)`` gives when drawn in order.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import pathlib

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import _torch_port as tp

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
BASE_SYNTH = str(ROOT / "configs" / "Base_Synth.yaml")


def _fields(cfg, prefix=""):
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            yield from _fields(val, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", val


def _get(cfg, path):
    for p in path.split("."):
        cfg = getattr(cfg, p)
    return cfg


def _first_unknown(data, cfg, path=""):
    """The first key of the merged YAML mapping that ``cfg`` lacks, in file order."""
    for key, value in data.items():
        if not hasattr(cfg, key.lower()):
            return f"{path}{key}"
        sub = getattr(cfg, key.lower())
        if dataclasses.is_dataclass(sub) and isinstance(value, dict):
            found = _first_unknown(value, sub, f"{path}{key}.")
            if found:
                return found
    return None


def _merged(path):
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    base = data.pop("_BASE_", None)
    if base:
        from threedod.config.yaml_loader import _deep_merge

        return _deep_merge(_merged(os.path.join(os.path.dirname(path), base)), data)
    return data


# ---- the config reader ----------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reader_equals_safe_load(path):
    from threedod_torch.config_yaml import parse_yaml

    text = path.read_text()
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 1e8\nb: 1.5e+3\nc: .5\nd: -.inf\ne: 12_000\nf: +5", "a: [1, 'x, y', \"q\\\"\", {k: v, n: null}]",
    "a:\n- 1\n- two\nb: ~", "a:\n  b:\n    - [3, 4]\n  c: 'it''s' # comment", "a: yes\nb: Off\nc: NULL\nd: x:y",
    "a: [1,\n  2, [3,\n  4]]\nb: {p: 1}",
])
def test_yaml_reader_scalars_and_flows(text):
    from threedod_torch.config_yaml import parse_yaml

    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: 0755", "a: 0x1f", "a: &x 1", "a: !!str 1", "a: |\n  x", "---\na: 1",
                                  "a:\n- b: 1", "a:\n\t b: 1", "a: [1, 2"])
def test_yaml_reader_refuses_outside_its_subset(text):
    from threedod_torch.config_yaml import parse_yaml

    with pytest.raises(ValueError):
        parse_yaml(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_matches_jax(path):
    from threedod.config import load_config as jax_load

    from threedod_torch.config import Config
    from threedod_torch.config_yaml import load_config

    unknown = _first_unknown(_merged(str(path)), Config())
    if unknown:
        with pytest.raises(KeyError, match=f"'{unknown}'"):
            load_config(str(path))
        return
    port, ref = load_config(str(path)), jax_load(str(path))
    for name, val in _fields(port):
        assert val == _get(ref, name), f"{name}: port {val!r} vs JAX {_get(ref, name)!r}"


def test_base_synth_is_known_and_opts_match():
    from threedod.config import load_config as jax_load

    from threedod_torch.config_yaml import load_config

    opts = ["solver.max_iter", "60", "input.min_size_train", "[96, 112]", "shapes.canvas_height=96",
            "model.roi_heads.num_classes", "7", "datasets.test", "[synth_val]", "model.dtype", "float32",
            "solver.clip_gradients", "3", "input.random_flip", "false"]
    port, ref = load_config(BASE_SYNTH, opts), jax_load(BASE_SYNTH, opts)
    assert (port.solver.max_iter, port.input.min_size_train, port.shapes.canvas_height) == (60, (96, 112), 96)
    assert port.solver.steps_per_dispatch == 2 and port.input.random_flip is False
    for name, val in _fields(port):
        assert val == _get(ref, name), name
    with pytest.raises(KeyError):
        load_config(BASE_SYNTH, ["solver.no_such_key", "1"])


# ---- metadata, records, priors ------------------------------------------------


def _setup(mod, cfg, out):
    fs = mod.get_filter_settings_from_cfg(cfg)
    json_path = lambda n: os.path.join(cfg.datasets.root, "Omni3D", f"{n}.json")  # noqa: E731
    mod.CATALOG.clear()
    ds = mod.Omni3D([json_path(n) for n in cfg.datasets.train], filter_settings=fs)
    meta = mod.register_and_store_model_metadata(ds, out, fs)
    records = {n: mod.load_omni3d_json(json_path(n), cfg.datasets.root, n, fs) for n in ("synth_train", "synth_test")}
    return ds, meta, records


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Both packages' Base_Synth set-up, from the repository root."""
    import threedod.data as jd
    from threedod.config import load_config as jax_load
    from threedod.data.priors import compute_priors as jax_priors

    from threedod_torch.config_yaml import load_config
    from threedod_torch.data import omni3d
    from threedod_torch.data.priors import compute_priors

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        jcfg, pcfg = jax_load(BASE_SYNTH), load_config(BASE_SYNTH)
        jds, jmeta, jrec = _setup(jd, jcfg, str(tmp_path_factory.mktemp("jax")))
        pds, pmeta, prec = _setup(omni3d, pcfg, str(tmp_path_factory.mktemp("port")))
        return dict(jcfg=jcfg, pcfg=pcfg, jmeta=jmeta, pmeta=pmeta, jrec=jrec, prec=prec,
                    jpriors=jax_priors(jcfg, jds, jmeta.thing_classes),
                    ppriors=compute_priors(pcfg, pds, pmeta.thing_classes))
    finally:
        os.chdir(cwd)


def test_metadata_and_records_equal(synth):
    assert synth["pmeta"].thing_classes == synth["jmeta"].thing_classes
    assert len(synth["pmeta"].thing_classes) == 10
    assert synth["pmeta"].thing_dataset_id_to_contiguous_id == synth["jmeta"].thing_dataset_id_to_contiguous_id
    for name, n in (("synth_train", 60), ("synth_test", 20)):
        assert len(synth["prec"][name]) == n
        assert synth["prec"][name] == synth["jrec"][name], name


def test_priors_equal(synth):
    j, p = synth["jpriors"], synth["ppriors"]
    assert set(p) == set(j)
    for key in j:
        if key == "priors_bins":
            assert p[key] == j[key] == []
            continue
        np.testing.assert_allclose(np.asarray(p[key], np.float64), np.asarray(j[key], np.float64),
                                   rtol=1e-12, atol=0, err_msg=key)
    assert np.asarray(p["priors_dims_per_cat"]).shape == (10, 2, 3)


def test_model_priors_equal_jax_model(synth):
    import jax

    from threedod.models.roi_heads3d import ROIHeads3D as JaxROIHeads3D

    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils.convert_weights import from_jax_variables

    jcfg, pcfg = synth["jcfg"], synth["pcfg"]
    # the JAX heads' own initialisation of their priors (setup alone, no forward)
    jpri = JaxROIHeads3D(cfg=jcfg, priors=synth["jpriors"]).init(
        jax.random.PRNGKey(0), method=lambda m: (m.priors_dims_per_cat, m.priors_z_scales, m.priors_z_stats))
    port = build_model(pcfg, seed=0, priors=synth["ppriors"]).state_dict()
    names = ("priors_dims_per_cat", "priors_z_scales", "priors_z_stats")
    variables = tp.seeded_variables(jcfg)
    variables["params"]["roi_heads"].update({n: np.asarray(jpri["params"][n]) for n in names})
    bridged = from_jax_variables(variables, pcfg)
    for n in names:
        np.testing.assert_array_equal(port[f"roi_heads.{n}"].numpy(), bridged[f"roi_heads.{n}"].numpy(), err_msg=n)
    assert not np.all(port["roi_heads.priors_dims_per_cat"].numpy() == 1.0)


# ---- the resize ----------------------------------------------------------------------


RESIZE_CASES = [tuple(int(v) for v in np.random.RandomState(s).randint(1, 260, 4)) for s in range(32)] + [
    (480, 640, 384, 512), (480, 640, 320, 427), (480, 640, 352, 469), (7, 5, 96, 128), (97, 129, 31, 47),
    (1, 1, 3, 2), (33, 65, 33, 7), (250, 3, 2, 250)]


@pytest.mark.parametrize("h,w,nh,nw", RESIZE_CASES)
def test_resize_is_pillows_bilinear(h, w, nh, nw):
    from threedod_torch.data.resize import resize_bilinear

    img = np.random.RandomState(h * 1000 + w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(torch.from_numpy(img), nh, nw).numpy(), ref)


def test_resize_on_the_fixture_at_base_synth_sizes():
    from threedod_torch.data.resize import resize_bilinear

    paths = sorted((ROOT / "datasets" / "synth" / "images").glob("*.jpg"))[:6]
    for path in paths:
        img = np.asarray(Image.open(path).convert("RGB"))
        for size in (320, 352, 384):  # min_size_train, min_size_test 384
            scale = min(size / 480, 384 / 480, 512 / 640)
            nh, nw = int(round(480 * scale)), int(round(640 * scale))
            ref = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
            np.testing.assert_array_equal(resize_bilinear(torch.from_numpy(img.copy()), nh, nw).numpy(), ref)


# ---- the mapper, collate, the sampler --------------------------------------------------


@pytest.mark.parametrize("train,name", [(True, "synth_train"), (False, "synth_test")])
def test_mapper_and_collate_match(synth, train, name):
    from threedod.data.batch import collate as jax_collate
    from threedod.data.mapper import DatasetMapper3D as JaxMapper

    from threedod_torch.data.batch import collate
    from threedod_torch.data.mapper import DatasetMapper3D

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        jm = JaxMapper(synth["jcfg"], is_train=train, rng=np.random.RandomState(5))
        pm = DatasetMapper3D(synth["pcfg"], is_train=train, rng=np.random.RandomState(5))
        records = synth["prec"][name]
        jout, pout = [jm(r) for r in records], [pm(r) for r in records]
    finally:
        os.chdir(cwd)
    flips = 0
    for r, j, p in zip(records, jout, pout):
        assert p["image"].dtype == torch.uint8
        np.testing.assert_array_equal(p["image"].numpy(), j["image"], err_msg=r["file_name"])
        np.testing.assert_array_equal(p["image_hw"], j["image_hw"])
        for key in ("K", "im_scale_ratio", "gt_boxes2d", "gt_boxes3d", "gt_poses"):
            np.testing.assert_allclose(p[key], j[key], rtol=0, atol=1e-6, err_msg=key)
        np.testing.assert_array_equal(p["gt_classes"], j["gt_classes"])
        assert (p["image_id"], p["height"], p["width"]) == (j["image_id"], j["height"], j["width"])
        x1 = np.asarray([a["bbox"][0] for a in r["annotations"]]) * p["image_hw"][0] / r["height"]
        flips += not np.allclose(p["gt_boxes2d"][:, 0], x1, atol=1e-3)
    assert len(records) == (60 if train else 20)
    if train:
        assert len({tuple(p["image_hw"]) for p in pout}) == 3 and flips > 0  # three scales, some flips

    max_gt = synth["pcfg"].shapes.max_gt
    for s in range(0, len(records), 8):
        jb, pb = jax_collate(jout[s:s + 8], max_gt), collate(pout[s:s + 8], max_gt)
        for field in ("image", "image_hw", "K", "im_scale_ratio", "image_id"):
            np.testing.assert_array_equal(getattr(pb, field).numpy(), np.asarray(getattr(jb, field)), err_msg=field)
        for field in ("boxes2d", "classes", "boxes3d", "poses", "valid"):
            np.testing.assert_array_equal(getattr(pb.gt, field).numpy(), np.asarray(getattr(jb.gt, field)),
                                          err_msg=field)


def test_repeat_factors_and_index_stream(synth):
    from threedod.data.build import repeat_factors_from_category_frequency as jax_factors

    from threedod_torch.data.build import TrainLoader, repeat_factors_from_category_frequency

    records = synth["prec"]["synth_train"]
    for thresh in (0.1, 0.5, 1.0):
        np.testing.assert_allclose(repeat_factors_from_category_frequency(records, thresh),
                                   jax_factors(records, thresh), rtol=1e-12, atol=0)
    pcfg = copy.deepcopy(synth["pcfg"])
    pcfg.solver.ims_per_batch = 3
    # the fixture's categories are balanced (every factor is 1 at 0.1): keep
    # one category in the first image that holds it only, so that image's
    # factor is above 1 and the probabilities differ
    rare = records[0]["annotations"][0]["category_id"]
    records = [dict(r, annotations=[a for a in r["annotations"] if a["category_id"] != rare]) if i else r
               for i, r in enumerate(records)]
    loader = TrainLoader(records, pcfg, seed=4)
    jax_rep = jax_factors(records, 0.1)
    np.testing.assert_allclose(loader.probs, jax_rep / jax_rep.sum(), rtol=1e-12, atol=0)
    drawn = []

    def mapper(record):  # the loader's mapper draws a scale then a flip
        drawn.append((record["image_id"], int(loader.rng.choice(pcfg.input.min_size_train)), loader.rng.rand() < 0.5))
        return {"image": torch.zeros(1, 1, 3, dtype=torch.uint8), "image_hw": np.zeros(2, np.int32),
                "K": np.eye(3, dtype=np.float32), "im_scale_ratio": 1.0}

    loader.mapper = mapper
    for _ in range(4):
        loader.next_batch()
    rng, probs, want = np.random.RandomState(4), loader.probs, []
    for _ in range(4):
        idx = rng.choice(len(records), size=3, p=probs)
        want += [(records[i]["image_id"], int(rng.choice(pcfg.input.min_size_train)), rng.rand() < 0.5) for i in idx]
    assert drawn == want
    assert np.isclose(probs.sum(), 1.0) and probs.max() > probs.min()
