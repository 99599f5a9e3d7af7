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
* ``infer`` and ``train`` read the number of classes after the unwrap.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port as tp
from test_torch_rcnn3d import _match

import jax


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
