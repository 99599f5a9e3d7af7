"""The port's torchvision-family trunks (ResNet, DenseNet, MNASNet,
ShuffleNet) vs the JAX package's, f32 on the CPU at a 64x96 canvas, batch 2.

For each of resnet18, resnet50, densenet121, mnasnet and shufflenet one set
of variables is made with numpy from a seed in the shape of the JAX
``RCNN3D`` built on that trunk (``jax.eval_shape`` of its init: nothing is
compiled), with BatchNorm scales, shifts and running statistics off the
identity. ``from_jax_variables`` turns them into the port's state dict, which
loads strictly, so every JAX leaf has a port parameter and the reverse.

* eval: p2 to p6 within 1e-4 of each level's largest entry (f32 sums in
  another order through up to 120 convolutions);
* training mode: the levels within 2e-3 of each level's largest entry, and
  the running statistics after one step within 1e-4 + 5e-4 relative. Batch statistics
  of the deepest levels are taken over 12 values (2 images of 2x3), and a
  variance near zero magnifies the last digit of a sum, so the features are
  held more loosely than in eval;
* the port trunk's ``state_dict()`` through the JAX package's ``convert_*``
  gives back the JAX trunk variables exactly;
* a JAX leaf without a port counterpart raises.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax
import jax.numpy as jnp

from threedod.utils import convert_weights as jcw
from threedod_torch.models.backbones.layers import update_running_stats
from threedod_torch.utils.convert_weights import from_jax_variables

TRUNKS = ["resnet18", "resnet50", "densenet121", "mnasnet", "shufflenet"]
CONVERT = {
    "resnet18": lambda sd: jcw.convert_resnet(sd, "resnet18"),
    "resnet50": lambda sd: jcw.convert_resnet(sd, "resnet50"),
    "densenet121": jcw.convert_densenet,
    "mnasnet": jcw.convert_mnasnet,
    "shufflenet": jcw.convert_shufflenet,
}


@pytest.fixture(scope="module", params=TRUNKS)
def trunk(request):
    """(name, the JAX trunk's eval and training outputs under one jit, its
    variables, the port trunk loaded from them, (all variables, port config))."""
    from threedod.models.backbones import build_backbone
    from threedod_torch.models.meta_arch import build_model

    name = request.param
    jcfg, pcfg = tp.configs(**{"model.backbone": name})
    variables = tp.seeded_variables(jcfg)
    port = build_model(pcfg)
    port.load_state_dict(from_jax_variables(variables, pcfg), strict=True)
    jtrunk = build_backbone(name, dtype=jnp.float32).trunk
    tvars = {"params": variables["params"]["backbone"]["trunk"],
             "batch_stats": variables["batch_stats"]["backbone"]["trunk"]}

    def both(v, x):
        return jtrunk.apply(v, x, train=False), jtrunk.apply(v, x, train=True, mutable=["batch_stats"])

    jax_out = jax.device_get(jax.jit(both)(tvars, jnp.asarray(IMAGE)))
    return name, jax_out, tvars, port.backbone.bottom_up, (variables, pcfg)


IMAGE = np.random.RandomState(3).randn(2, 64, 96, 3).astype(np.float32)


def _levels_close(port_out, jax_out, tol, what):
    assert sorted(port_out) == sorted(jax_out) == ["p2", "p3", "p4", "p5", "p6"]
    for lvl in port_out:
        a = np.asarray(jax_out[lvl])
        b = port_out[lvl].permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape, (what, lvl, a.shape, b.shape)
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= tol, (what, lvl, err)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_eval_levels_match_jax(trunk):
    name, (ref, _), _, ptrunk, _ = trunk
    with torch.no_grad():
        got = ptrunk.eval()(torch.from_numpy(IMAGE).permute(0, 3, 1, 2))
    assert {k: v.shape[1] for k, v in got.items()} == ptrunk.out_channels
    _levels_close(got, ref, 1e-4, name)


def test_train_levels_and_running_stats_match_jax(trunk):
    name, (_, (ref, new)), _, ptrunk, _ = trunk
    ptrunk = copy.deepcopy(ptrunk).train()
    with torch.no_grad():
        got = ptrunk(torch.from_numpy(IMAGE).permute(0, 3, 1, 2))
    _levels_close(got, ref, 2e-3, name)
    before = {k: v.clone() for k, v in ptrunk.state_dict().items() if "running" in k}
    update_running_stats(ptrunk)
    after = ptrunk.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in before.items())
    stats = CONVERT[name]({k: v.numpy() for k, v in after.items()})["batch_stats"]
    want = dict(_flat(new["batch_stats"]))
    have = dict(_flat(stats))
    assert set(have) == set(want)
    for path in want:
        np.testing.assert_allclose(have[path], want[path], atol=1e-4, rtol=5e-4, err_msg=f"{name} {'/'.join(path)}")


def test_state_dict_through_the_jax_converter_is_exact(trunk):
    name, _, tvars, ptrunk, _ = trunk
    back = CONVERT[name]({k: v.numpy() for k, v in ptrunk.state_dict().items()})
    want, have = dict(_flat(tvars)), dict(_flat(back))
    assert set(have) == set(want)
    for path in want:
        np.testing.assert_array_equal(have[path], want[path], err_msg=f"{name} {'/'.join(path)}")


def test_every_leaf_is_consumed_and_a_leftover_raises(trunk):
    name, _, _, ptrunk, (variables, pcfg) = trunk
    sd = from_jax_variables(variables, pcfg)
    n_trunk = sum(1 for _ in _flat(variables["params"]["backbone"]["trunk"])) + \
        sum(1 for _ in _flat(variables["batch_stats"]["backbone"]["trunk"]))
    assert sum(k.startswith("backbone.bottom_up.") for k in sd) == n_trunk == len(ptrunk.state_dict())
    extra = copy.deepcopy(variables)
    extra["params"]["backbone"]["trunk"]["stray"] = {"gamma": np.zeros(3, np.float32)}
    with pytest.raises(KeyError):
        from_jax_variables(extra, pcfg)


def test_unknown_backbone_raises():
    from threedod_torch.models.backbones.fpn import build_backbone

    with pytest.raises(ValueError, match="unknown backbone"):
        build_backbone("vgg16")
    with pytest.raises(ValueError, match="unknown ResNet"):
        build_backbone("resnet77")
