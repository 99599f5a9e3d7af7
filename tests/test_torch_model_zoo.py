"""The port's loader of zoo-layout weights (``utils/model_zoo.py``) vs the JAX
package's zoo converter, on the CPU, at the parity tests' small size
(``_torch_port.OVERRIDES``):

* the port's seeded state dict, wrapped as a detectron2 checkpoint
  (``{"model": ...}``) with BatchNorm's ``num_batches_tracked`` added and
  saved with ``torch.save``, gives the same detections loaded by the port and
  loaded by the JAX ``load_torch_checkpoint`` + ``convert_cubercnn_rcnn3d``
  from the same file (``test_torch_rcnn3d.py``'s matching and tolerances; the
  class scores are scaled by 50, as there, so that they are not near-tied);
* a dict without ``roi_heads.priors_*`` keeps the model's own priors; a
  missing or an unknown key raises;
* ``infer`` and ``train`` read the number of classes after the unwrap;
* an ImageNet trunk file in the reference DLA's and in torchvision's layout
  (DLA34, ResNet18), written from seeded numpy with a classifier and
  BatchNorm counters the trunk does not read: the port's
  ``load_trunk_weights`` and the JAX one give the same trunk, entry for
  entry through the exact weight bridge, and the same trunk forward in eval
  within 1e-4 of each level's largest entry (``test_torch_trunks.py``'s);
  a trunk entry missing or at another shape raises;
* ``train_net.fresh_model`` is ``tools/train_net.py``'s ``fresh_state``: the
  cached trunk file where neither ``model.weights`` nor
  ``model.weights_pretrain`` is set, ``model.weights_pretrain`` (the JAX
  ``load_model_weights``'s weights, from any seed, so on every fresh
  attempt) otherwise, the fresh BatchNorm statistics kept where the file
  has none;
* a ``cubercnn://`` file that is not under ``$THREEDOD_ZOO_DIR`` raises the
  not-cached error, from the loaders and from ``train_net.setup``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import pathlib

import _torch_port as tp
from test_torch_rcnn3d import _match

import jax

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def zoo_file(tmp_path_factory):
    from threedod_torch.models.meta_arch import build_model

    _, pcfg = tp.configs()
    sd = build_model(pcfg, seed=3).state_dict()
    sd["roi_heads.box_predictor.cls_score.weight"] = sd["roi_heads.box_predictor.cls_score.weight"] * 50.0
    wrapped = {"model": dict(sd), "iteration": 12}
    for key in list(sd):
        if key.endswith("running_var"):
            wrapped["model"][key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    path = tmp_path_factory.mktemp("zoo") / "model_final.pth"
    torch.save(wrapped, path)
    return str(path), sd


def test_zoo_checkpoint_gives_the_jax_converters_detections(zoo_file):
    from threedod.utils.convert_weights import convert_cubercnn_rcnn3d, load_torch_checkpoint

    from threedod_torch.infer import predict
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils.model_zoo import load_model_weights

    path, sd = zoo_file
    jcfg, pcfg = tp.configs()
    port = load_model_weights(path, build_model(pcfg, seed=0))
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k]), k

    jmodel, template = tp.jax_model(jcfg)
    variables = convert_cubercnn_rcnn3d(load_torch_checkpoint(path), template)
    img, image_hw, K, ratio = tp.inputs()
    jd = jax.tree_util.tree_map(np.asarray, jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, tp.jax_batch(img, image_hw, K, ratio)))
    pd = predict(port, tp.torch_batch(img, image_hw, K, ratio))
    for i in range(2):
        jv, pv = jd.valid[i], pd.valid[i].numpy()
        assert jv.sum() == pv.sum() > 0
        key_j = np.concatenate([jd.boxes[i][jv], jd.classes[i][jv, None] * 1e4], 1)
        key_p = np.concatenate([pd.boxes[i].numpy()[pv], pd.classes[i].numpy()[pv, None] * 1e4], 1)
        idx = _match(key_j, key_p)
        np.testing.assert_array_equal(pd.classes[i].numpy()[pv][idx], jd.classes[i][jv])
        np.testing.assert_allclose(pd.boxes[i].numpy()[pv][idx], jd.boxes[i][jv], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(pd.scores[i].numpy()[pv][idx], jd.scores[i][jv], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(pd.center_cam[i].numpy()[pv][idx], jd.center_cam[i][jv], rtol=2e-4, atol=2e-4)


def test_missing_priors_keep_the_models_and_other_keys_are_strict(zoo_file):
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils import model_zoo

    _, sd = zoo_file
    _, pcfg = tp.configs()
    model = build_model(pcfg, seed=0)
    with torch.no_grad():
        model.roi_heads.priors_dims_per_cat.mul_(3.0)
    own = model.roi_heads.priors_dims_per_cat.detach().clone()
    no_priors = {k: v for k, v in sd.items() if not k.startswith("roi_heads.priors_")}
    model_zoo.load_model_weights({"model": no_priors}, model)
    assert torch.equal(model.roi_heads.priors_dims_per_cat, own)
    assert torch.equal(model.roi_heads.box_predictor.cls_score.weight, sd["roi_heads.box_predictor.cls_score.weight"])

    with pytest.raises(RuntimeError, match="Unexpected"):
        model_zoo.load_model_weights({**sd, "roi_heads.no_such_layer.weight": torch.zeros(1)}, model)
    with pytest.raises(RuntimeError, match="Missing"):
        model_zoo.load_model_weights({k: v for k, v in sd.items() if k != "backbone.fpn_lateral3.weight"}, model)


def test_entries_read_the_classes_after_the_unwrap(zoo_file):
    from threedod_torch.utils import model_zoo

    path, _ = zoo_file
    sd = model_zoo.state_dict(path)
    assert model_zoo.num_classes(sd) == 5
    assert not any(k.endswith("num_batches_tracked") for k in sd) and "iteration" not in sd


def _trunk_file(path, backbone: str, seed: int = 4):
    """A trunk checkpoint in the ImageNet layout (the port's trunk names),
    seeded numpy, with a classifier and BatchNorm counters; -> the trunk's
    entries as written."""
    from threedod_torch.models.meta_arch import build_model

    _, pcfg = tp.configs(**{"model.backbone": backbone})
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in build_model(pcfg).backbone.bottom_up.state_dict().items():
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(100)
        else:
            sd[k] = torch.from_numpy((rng.randn(*v.shape) * 0.1).astype(np.float32))
    trunk = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    sd.update({"fc.weight": torch.zeros(1000, 8), "fc.bias": torch.zeros(1000)})
    torch.save(sd, path)
    return trunk


@pytest.mark.parametrize("backbone", ["dla34", "resnet18"])
def test_trunk_file_loads_as_the_jax_loader_loads_it(backbone, tmp_path):
    from threedod.models.backbones import build_backbone
    from threedod.utils.model_zoo import load_trunk_weights as jax_load_trunk

    import jax.numpy as jnp

    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils.convert_weights import from_jax_variables
    from threedod_torch.utils.model_zoo import load_trunk_weights

    path = str(tmp_path / f"{backbone}.pth")
    written = _trunk_file(path, backbone)
    jcfg, pcfg = tp.configs(**{"model.backbone": backbone})
    template = tp.seeded_variables(jcfg)
    jvars = jax_load_trunk(path, backbone, template)
    port = load_trunk_weights(path, backbone, build_model(pcfg, seed=1))
    bridged = from_jax_variables(jax.tree_util.tree_map(np.asarray, jvars), pcfg)
    own = port.state_dict()
    for k, v in written.items():
        assert torch.equal(own[f"backbone.bottom_up.{k}"], v), k
        assert torch.equal(bridged[f"backbone.bottom_up.{k}"], v), k

    trunk = build_backbone(backbone, dtype=jnp.float32).trunk
    tvars = {c: jvars[c]["backbone"]["trunk"] for c in ("params", "batch_stats")}
    image = np.random.RandomState(3).randn(1, 64, 96, 3).astype(np.float32)
    ref = jax.device_get(jax.jit(lambda v, x: trunk.apply(v, x, train=False))(tvars, jnp.asarray(image)))
    with torch.no_grad():
        got = port.backbone.bottom_up.eval()(torch.from_numpy(image).permute(0, 3, 1, 2))
    for lvl, want in ref.items():
        tp.close(got[lvl].permute(0, 2, 3, 1).numpy(), np.asarray(want), 1e-4)


def test_trunk_structural_mismatch_raises(tmp_path):
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils.model_zoo import load_trunk_weights

    _, pcfg = tp.configs(**{"model.backbone": "resnet18"})
    written = _trunk_file(str(tmp_path / "ok.pth"), "resnet18")
    torch.save({k: v for k, v in written.items() if k != "layer2.0.conv1.weight"}, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="layer2.0.conv1.weight"):
        load_trunk_weights(str(tmp_path / "short.pth"), "resnet18", build_model(pcfg))
    torch.save({**written, "bn1.weight": torch.ones(3)}, tmp_path / "wide.pth")
    with pytest.raises(ValueError, match="bn1.weight"):
        load_trunk_weights(str(tmp_path / "wide.pth"), "resnet18", build_model(pcfg))


def test_fresh_model_loads_trunk_then_pretrain(zoo_file, tmp_path, monkeypatch):
    from threedod.utils.model_zoo import load_model_weights as jax_load_model

    from threedod_torch import train_net
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils.convert_weights import from_jax_variables
    from threedod_torch.utils.model_zoo import load_model_weights

    path, sd = zoo_file
    jcfg, pcfg = tp.configs()
    monkeypatch.setenv("THREEDOD_ZOO_DIR", str(tmp_path))
    (tmp_path / "imagenet").mkdir()
    trunk = _trunk_file(str(tmp_path / "imagenet" / "dla34.pth"), "dla34")

    plain = build_model(pcfg, seed=2).state_dict()
    fresh = train_net.fresh_model(pcfg, None, seed=2).state_dict()  # the cached trunk, the rest from the seed
    for k, v in fresh.items():
        want = trunk.get(k[len("backbone.bottom_up."):]) if k.startswith("backbone.bottom_up.") else plain[k]
        assert torch.equal(v, want), k
    pcfg.model.weights = "model_final.pth"  # set: no trunk load, as the reference
    assert all(torch.equal(v, plain[k]) for k, v in train_net.fresh_model(pcfg, None, seed=2).state_dict().items())
    pcfg.model.weights = ""

    pcfg.model.weights_pretrain = path
    jax_loaded = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, jax_load_model(path, tp.seeded_variables(jcfg))), pcfg)
    for seed in (2, 9):  # every fresh attempt: whatever its seed, the pretrain weights
        got = train_net.fresh_model(pcfg, None, seed=seed).state_dict()
        for k, v in got.items():
            assert torch.equal(v, sd[k]) and torch.equal(v, jax_loaded[k]), k

    no_stats = tmp_path / "no_stats.pth"
    torch.save({k: v for k, v in sd.items() if not k.endswith(("running_mean", "running_var"))}, no_stats)
    pcfg.model.weights_pretrain = str(no_stats)
    got = train_net.fresh_model(pcfg, None, seed=2).state_dict()
    for k, v in got.items():
        assert torch.equal(v, plain[k] if k.endswith(("running_mean", "running_var")) else sd[k]), k
    with pytest.raises(RuntimeError, match="running_mean"):  # only the pretrain load keeps them: model.weights,
        load_model_weights(str(no_stats), build_model(pcfg, seed=2))  # a checkpoint or --eval-only stays strict


def test_missing_zoo_file_raises_not_cached(tmp_path, monkeypatch):
    from threedod_torch import train_net
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils import model_zoo

    monkeypatch.setenv("THREEDOD_ZOO_DIR", str(tmp_path / "zoo"))
    _, pcfg = tp.configs()
    for call in (lambda: model_zoo.resolve("cubercnn://omni3d/cubercnn_DLA34_FPN.pth"),
                 lambda: model_zoo.load_model_weights("cubercnn://omni3d/cubercnn_DLA34_FPN.pth", build_model(pcfg)),
                 lambda: model_zoo.load_trunk_weights("cubercnn://imagenet/dla34.pth", "dla34", build_model(pcfg)),
                 lambda: train_net.setup(str(ROOT / "configs" / "Base_Synth.yaml"), [
                     "model.weights_pretrain", "cubercnn://omni3d/cubercnn_DLA34_FPN.pth",
                     "output_dir", str(tmp_path / "out")])):
        with pytest.raises(FileNotFoundError, match="not cached"):
            call()
    assert not (tmp_path / "out").exists()
    assert model_zoo.imagenet_trunk_path("dla34") is None
