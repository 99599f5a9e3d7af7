"""Official Depth-Anything-V2 and GroundingDINO checkpoint files in the
port's tools (``threedod_torch/utils/checkpoints.py``), against the JAX
package's ``load_torch_checkpoint`` and converters, on the CPU in f32.

The keys ``convert_depth_anything_v2`` and ``convert_groundingdino`` read are
recorded by running them on a key-recording mapping over a seeded port state
dict: they are the port's state-dict keys, which the loader requires. The
tests then write the dict as the official files are: ``{"model": ...}``,
every key under ``module.``, and the entries neither converter reads
(DA-V2's ``pretrained.mask_token`` and refinenet4's ``resConfUnit1``;
GroundingDINO's Swin ``relative_position_index`` buffers, the
``transformer.decoder.bbox_embed.*`` copies, BERT's ``position_ids`` and
pooler). The port's tools load that file to exactly the tensors the JAX
converter reads, the models give the JAX model's outputs on the converted
weights within 1e-5 of the largest entry, the tools run on exactly those
tensors, and a file missing one read tensor, or holding one
of another shape, raises. The GroundingDINO tool builds its fixed model, as
the JAX tool does, so a file without its last decoder layer is refused. DA-V2 is vits at a 56x84 input; GroundingDINO is
reduced (a Swin block a stage, one enhancer, decoder and BERT layer, 10
queries) at 64x96.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedod.models.depth import dpt as jdpt
from threedod.models.gdino import model as jgd
from threedod.utils.convert_weights import convert_depth_anything_v2, convert_groundingdino, load_torch_checkpoint
from threedod_torch import depth_infer, gdino_infer, generate_depth_maps, generate_ground_segmentations, train_depth
from threedod_torch.models.depth.dpt import build_depth_model
from threedod_torch.models.gdino.model import build_groundingdino
from threedod_torch.models.sam import build_sam
from threedod_torch.utils import checkpoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_queries=10, enc_layers=1, dec_layers=1, swin_depths=(1, 1, 1, 1), bert_layers=1)
GDINO_KW = dict(depths=CFG["swin_depths"], enc_layers=1, dec_layers=1, bert_layers=1)
IDS = np.array([[101, 2598, 1012, 102]], np.int32)
IMAGE_IDS = (61, 63)  # one synth_val image for each tool


class _Recorded:
    """A state dict's value that notes its key when a converter turns it
    into an array (the converters copy the dict, so the values record)."""

    def __init__(self, key, value, read: set):
        self.key, self.value, self.read = key, value, read

    def __array__(self, dtype=None, copy=None):
        self.read.add(self.key)
        return self.value if dtype is None else self.value.astype(dtype)


def recording(sd):
    """(a key-recording mapping over ``sd``'s tensors as numpy, the set of
    keys read)."""
    read = set()
    return {k: _Recorded(k, v.numpy(), read) for k, v in sd.items()}, read


def _official(sd: dict, extras: dict, wrapped: bool) -> dict:
    """The official layout: DA-V2's files are the bare state dict,
    GroundingDINO's hold it under "model" with ``module.`` keys."""
    sd = {**sd, **extras}
    return {"model": {f"module.{k}": v for k, v in sd.items()}} if wrapped else sd


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), f"{what}: {err} against {np.abs(want).max()}"


def _assert_same_state(model, sd):
    own = model.state_dict()
    assert set(own) == set(sd)
    for k, v in sd.items():
        assert torch.equal(own[k], v), k


@pytest.fixture(scope="module")
def dav2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dav2")
    sd = build_depth_model("vits", dtype=torch.float32, seed=3).state_dict()
    rec, read = recording(sd)
    convert_depth_anything_v2(rec, "vits")
    extras = {"pretrained.mask_token": torch.zeros(1, 384)}
    for conv in ("conv1", "conv2"):
        extras[f"depth_head.scratch.refinenet4.resConfUnit1.{conv}.weight"] = torch.randn(64, 64, 3, 3)
        extras[f"depth_head.scratch.refinenet4.resConfUnit1.{conv}.bias"] = torch.randn(64)
    official, own = str(tmp / "depth_anything_v2_metric_vits.pth"), str(tmp / "port.pt")
    torch.save(_official(sd, extras, False), official)
    torch.save(sd, own)
    return dict(tmp=tmp, sd=sd, read=read, extras=extras, official=official, own=own, wrapped=False)


@pytest.fixture(scope="module")
def gdino(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gdino")
    sd = build_groundingdino(dtype=torch.float32, seed=4, **CFG).state_dict()
    rec, read = recording(sd)
    convert_groundingdino(rec, **GDINO_KW)
    extras = {"bert.embeddings.position_ids": torch.arange(512)[None],
              "bert.pooler.dense.weight": torch.randn(768, 768), "bert.pooler.dense.bias": torch.randn(768)}
    for s, depth in enumerate(CFG["swin_depths"]):
        for b in range(depth):
            extras[f"backbone.0.layers.{s}.blocks.{b}.attn.relative_position_index"] = torch.randint(0, 169, (49, 49))
    for k, v in sd.items():
        if k.startswith("bbox_embed."):
            extras["transformer.decoder." + k] = v.clone()
    official, own = str(tmp / "groundingdino_swint_ogc.pth"), str(tmp / "port.pt")
    torch.save(_official(sd, extras, True), official)
    torch.save(sd, own)
    return dict(tmp=tmp, sd=sd, read=read, extras=extras, official=official, own=own, wrapped=True)


def test_the_converters_read_exactly_the_port_state_dicts(dav2, gdino):
    for case in (dav2, gdino):
        assert case["read"] == set(case["sd"])
        assert not set(case["extras"]) & case["read"]


def test_dav2_official_file_loads_and_matches_the_jax_converter(dav2):
    model = depth_infer.load_model("vits", torch.device("cpu"), dav2["official"], dtype=torch.float32)
    _assert_same_state(model, dav2["sd"])
    assert checkpoints.load_official(model, dav2["official"]) == 5  # the extras are skipped and counted
    assert checkpoints.load_official(model, dav2["own"]) == 0
    params = convert_depth_anything_v2(load_torch_checkpoint(dav2["official"]), "vits")
    x = np.random.RandomState(0).randn(1, 56, 84, 3).astype(np.float32)
    jmodel = jdpt.DepthAnythingV2(encoder="vits", dtype=jnp.float32)
    want = jax.jit(lambda p, a: jmodel.apply({"params": p}, a))(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.numpy(), want, "DA-V2 depth")


def _capture(monkeypatch, module, **config):
    """The models ``module.load_model`` makes, kept as they are made;
    ``config`` is passed on to it (the reduced GroundingDINO)."""
    made, real = [], module.load_model

    def load_model(*a, **kw):
        made.append(real(*a, **config, **kw))
        return made[-1]

    monkeypatch.setattr(module, "load_model", load_model)
    return made


def _one_image_json(tmp_path, image_id: int) -> str:
    with open(os.path.join(ROOT, "datasets", "Omni3D", "synth_val.json")) as f:
        data = json.load(f)
    data["images"] = [im for im in data["images"] if im["id"] == image_id]
    path = str(tmp_path / "one.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def test_dav2_tools_read_the_official_file(dav2, tmp_path, monkeypatch):
    made = _capture(monkeypatch, generate_depth_maps)
    out = str(tmp_path / "depth")
    args = generate_depth_maps.parser().parse_args(
        ["--dataset-json", _one_image_json(tmp_path, IMAGE_IDS[0]), "--image-root", os.path.join(ROOT, "datasets"),
         "--out-dir", out, "--encoder", "vits", "--checkpoint", dav2["official"], "--input-size", "56"])
    generate_depth_maps.run(args, torch.device("cpu"), torch.float32)
    _assert_same_state(made[0], dav2["sd"])
    with np.load(os.path.join(out, f"{IMAGE_IDS[0]}.npz")) as z:
        assert z["depth"].shape == (480, 640) and np.isfinite(z["depth"]).all()
    model = build_depth_model("vits", dtype=torch.float32, seed=9)
    head = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("depth_head.")}
    assert train_depth.load_pretrained(model, dav2["official"]) == len(model.pretrained.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(v, dav2["sd"][k] if k.startswith("pretrained.") else head[k]), k


def test_gdino_official_file_loads_and_matches_the_jax_converter(gdino):
    model = gdino_infer.load_model(torch.device("cpu"), gdino["official"], dtype=torch.float32, **CFG)
    _assert_same_state(model, gdino["sd"])
    assert checkpoints.load_official(model, gdino["own"]) == 0
    assert checkpoints.load_official(model, gdino["official"]) == len(gdino["extras"])
    params = convert_groundingdino(load_torch_checkpoint(gdino["official"]), **GDINO_KW)["params"]
    x = np.random.RandomState(1).randn(1, 64, 96, 3).astype(np.float32)
    mask = np.ones_like(IDS, bool)
    jmodel = jgd.GroundingDINO(**CFG)
    logits, boxes = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))(params, x, IDS, mask)
    got_logits, got_boxes, _ = gdino_infer.predict(model, x, IDS[0].tolist(), torch.device("cpu"))
    _close(got_logits.numpy(), logits, "GroundingDINO logits")
    _close(got_boxes.numpy(), boxes, "GroundingDINO boxes")


def test_gdino_tool_reads_the_official_file(gdino, tmp_path, monkeypatch):
    import threedod_torch.gdino_infer as tool_module

    made = _capture(monkeypatch, tool_module, **CFG)
    sam = build_sam(hq=True, img_size=128, dtype=torch.float32, seed=5, encoder_dim=48, encoder_depth=2,
                    encoder_heads=2, global_attn_indexes=(1,))
    sam_path = str(tmp_path / "sam_hq.pth")
    torch.save(sam.state_dict(), sam_path)
    out = str(tmp_path / "ground")
    args = generate_ground_segmentations.parser().parse_args(
        ["--dataset-json", _one_image_json(tmp_path, IMAGE_IDS[1]), "--image-root", os.path.join(ROOT, "datasets"),
         "--out-dir", out, "--no-ground-csv", str(tmp_path / "no_ground.csv"), "--checkpoint", sam_path,
         "--gdino-checkpoint", gdino["official"], "--gdino-image-size", "64", "--box-threshold", "0",
         "--img-size", "128"])
    generate_ground_segmentations.run(args, torch.device("cpu"), torch.float32)
    _assert_same_state(made[0], gdino["sd"])
    assert os.listdir(out) == [f"{IMAGE_IDS[1]}.npz"]


@pytest.mark.parametrize("model", ["dav2", "gdino"])
def test_a_missing_or_misshapen_read_tensor_raises(model, dav2, gdino, tmp_path):
    """Every 97th read tensor left out in turn (as a loaded dict), one made
    wider, and one left out of a file a tool reads."""
    case = {"dav2": dav2, "gdino": gdino}[model]
    target = build_depth_model("vits", dtype=torch.float32) if model == "dav2" else build_groundingdino(**CFG)
    before = {k: v.clone() for k, v in target.state_dict().items()}
    for key in sorted(case["read"])[::97]:
        sd = dict(case["sd"])
        del sd[key]
        with pytest.raises(KeyError, match="lacks 1 of the"):
            checkpoints.load_official(target, _official(sd, case["extras"], case["wrapped"]))
    sd = dict(case["sd"])
    key = sorted(case["read"])[1]
    sd[key] = torch.zeros(*sd[key].shape[:-1], sd[key].shape[-1] + 1)
    with pytest.raises(ValueError, match="in the file"):
        checkpoints.load_official(target, _official(sd, case["extras"], case["wrapped"]))
    _assert_same_state(target, before)  # a refused file changes nothing
    sd = dict(case["sd"])
    del sd[sorted(case["read"])[-1]]
    path = str(tmp_path / "short.pth")
    torch.save(_official(sd, case["extras"], case["wrapped"]), path)
    with pytest.raises(KeyError, match="short.pth lacks 1"):
        checkpoints.load_official(target, path)


def test_gdino_tool_builds_its_fixed_model_and_refuses_a_short_file(gdino, tmp_path, monkeypatch):
    """The tool builds the fixed swinT_OGC model whatever the file holds (as
    the JAX tool does), so a file without its last decoder layer is refused
    instead of loading as a shallower model. The reduced model stands in for
    the fixed one here; the tool passes no size of its own."""
    import threedod_torch.gdino_infer as tool_module

    asked, real = [], tool_module.build_groundingdino

    def build(**kw):
        asked.append(kw)
        return real(**kw, **CFG)

    monkeypatch.setattr(tool_module, "build_groundingdino", build)
    last = f"transformer.decoder.layers.{CFG['dec_layers'] - 1}."
    sd = {k: v for k, v in gdino["sd"].items() if not k.startswith(last)}
    assert len(sd) < len(gdino["sd"])
    path = str(tmp_path / "no_last_decoder_layer.pth")
    torch.save(_official(sd, gdino["extras"], True), path)
    args = generate_ground_segmentations.parser().parse_args(
        ["--dataset-json", _one_image_json(tmp_path, IMAGE_IDS[1]), "--image-root", os.path.join(ROOT, "datasets"),
         "--out-dir", str(tmp_path / "ground"), "--no-ground-csv", str(tmp_path / "no_ground.csv"), "--checkpoint",
         str(tmp_path / "unused_sam.pth"), "--gdino-checkpoint", path, "--img-size", "128"])
    with pytest.raises(KeyError, match=f"no_last_decoder_layer.pth lacks {len(gdino['sd']) - len(sd)} of the"):
        generate_ground_segmentations.run(args, torch.device("cpu"), torch.float32)
    assert asked == [dict(dtype=torch.float32, seed=0)]
