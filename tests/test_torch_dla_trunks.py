"""The port's DLA trunks beyond dla34 (Bottleneck, BottleneckX, residual
roots) vs the JAX package's, f32 on the CPU.

* dla46_c, dla46x_c and dla102x at a 64x64 input, batch 2, on numpy-made
  variables in the shape of the JAX trunk's (``jax.eval_shape``; BatchNorm
  scales, shifts and running statistics off the identity), converted with
  ``from_jax_variables``: p2 to p6 in eval within 1e-4 of each level's
  largest entry (f32 sums in another order through up to 107 convolutions);
  in training mode within 2e-3 (batch statistics of the deepest levels are
  taken over 2 images of 2x2 or 1x1 values, where a variance near zero
  magnifies the last digit of a sum; dla102x's p5 measured 1.4e-3), and the
  running statistics after one step within 1e-3 of each leaf's largest entry
  (they carry that difference of the deepest levels: 2.8e-4 measured at
  dla102x's ``level5/project``). One ``jax.jit`` a trunk runs both modes.
* All nine trunks (``jax.eval_shape`` of the JAX trunk's init: nothing is
  compiled): the port trunk's state-dict names are exactly those the JAX
  package's ``convert_dla`` reads for that template, the reference
  checkpoint layout (with its classifier) loads through
  ``utils/model_zoo.load_trunk_weights``, and JAX variables -> port ->
  ``convert_dla`` gives the variables back bit for bit.
* Under ``fused_forward()`` a Bottleneck trunk runs stock (K5 and K6 take
  BasicBlock trees only, as in JAX), and on the CPU the fused switch leaves
  its output unchanged.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from threedod.utils import convert_weights as jcw
from threedod_torch.models.backbones.dla import _DLA_SPECS, build_dla
from threedod_torch.models.backbones.layers import update_running_stats
from threedod_torch.utils.convert_weights import from_jax_variables

PARITY = ["dla46_c", "dla46x_c", "dla102x"]
ALL = list(_DLA_SPECS)
IMAGE = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
TOP = "backbone.bottom_up."


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _fill(template, seed):
    """numpy leaves in the template's shapes, as ``_torch_port.seeded_variables`` draws them."""
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                out[key] = fill(val)
            elif key == "kernel":
                out[key] = (rng.randn(*val.shape) / np.sqrt(np.prod(val.shape[:-1]))).astype(np.float32)
            elif key == "scale":
                out[key] = rng.uniform(0.8, 1.2, val.shape).astype(np.float32)
            elif key in ("bias", "mean"):
                out[key] = rng.normal(0, 0.05, val.shape).astype(np.float32)
            elif key == "var":
                out[key] = rng.uniform(0.8, 1.25, val.shape).astype(np.float32)
            else:
                raise KeyError(key)
        return out

    return {"params": fill(template["params"]), "batch_stats": fill(template["batch_stats"])}


def _port_trunk(name, variables, pcfg):
    """The port trunk loaded strictly from JAX trunk variables."""
    sd = from_jax_variables({"params": {"backbone": {"trunk": variables["params"], "fpn": {}}, "roi_heads": {}},
                             "batch_stats": {"backbone": {"trunk": variables["batch_stats"]}}}, pcfg)
    trunk = build_dla(name)
    trunk.load_state_dict({k[len(TOP):]: v for k, v in sd.items()}, strict=True)
    return trunk


@pytest.fixture(scope="module", params=ALL)
def template(request):
    """(name, the JAX trunk's variable shapes from ``jax.eval_shape``)."""
    from threedod.models.backbones.dla import build_dla as jax_build_dla

    name = request.param
    jtrunk = jax_build_dla(name)
    return name, jax.eval_shape(lambda x: jtrunk.init(jax.random.PRNGKey(0), x), jnp.zeros((1, 64, 64, 3)))


def test_published_widths():
    for name, spec in _DLA_SPECS.items():
        trunk = build_dla(name)
        assert trunk.out_channels == {f"p{i}": spec["channels"][min(i, 5)] for i in range(2, 7)}, name
    with pytest.raises(ValueError, match="unknown DLA"):
        build_dla("dla47")


def test_names_match_the_jax_converter_template(template, tmp_path):
    """Every entry of the port trunk's state dict is read by ``convert_dla``
    for the JAX template, and nothing else is; the layout loads as a
    reference ImageNet checkpoint (classifier entries ignored)."""
    from threedod_torch.utils import model_zoo

    name, shapes = template
    own = {k: v.numpy() for k, v in build_dla(name).state_dict().items()}

    class Reads(dict):
        seen = set()

        def __getitem__(self, key):
            Reads.seen.add(key)
            return dict.__getitem__(self, key)

    out = jcw.convert_dla(Reads(own), jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert Reads.seen == set(own)
    for path, leaf in _flat(shapes):
        got = dict(_flat(out))[path]
        assert got.shape == leaf.shape, (name, path)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = torch.nn.Module()
            self.backbone.bottom_up = build_dla(name)

    path = str(tmp_path / f"{name}.pth")
    torch.save({**{k: torch.from_numpy(v) for k, v in own.items()}, "fc.weight": torch.zeros(1000, 8),
                "fc.bias": torch.zeros(1000)}, path)
    holder = model_zoo.load_trunk_weights(path, name, Holder())
    for k, v in holder.backbone.bottom_up.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), own[k], err_msg=k)


def test_converter_round_trip_is_exact(template):
    from threedod_torch.config import Config

    name, shapes = template
    variables = _fill(shapes, seed=ALL.index(name))
    trunk = _port_trunk(name, variables, Config())
    back = jcw.convert_dla({k: v.numpy() for k, v in trunk.state_dict().items()}, variables)
    want, have = dict(_flat(variables)), dict(_flat(back))
    assert set(have) == set(want)
    for path in want:
        np.testing.assert_array_equal(np.asarray(have[path]), want[path], err_msg=f"{name} {'/'.join(path)}")


@pytest.fixture(scope="module", params=PARITY)
def trunk(request):
    """(name, the JAX trunk's eval and training outputs under one jit, its
    numpy-made variables, the port trunk loaded from them)."""
    from threedod.models.backbones.dla import build_dla as jax_build_dla

    from threedod_torch.config import Config

    name = request.param
    jtrunk = jax_build_dla(name)
    x = jnp.asarray(IMAGE)
    tvars = _fill(jax.eval_shape(lambda x: jtrunk.init(jax.random.PRNGKey(0), x), x), seed=11)

    def both(v, x):
        return jtrunk.apply(v, x, train=False), jtrunk.apply(v, x, train=True, mutable=["batch_stats"])

    jax_out = jax.device_get(jax.jit(both)(tvars, x))
    return name, jax_out, tvars, _port_trunk(name, tvars, Config())


def _levels_close(port_out, jax_out, tol, what):
    assert sorted(port_out) == sorted(jax_out) == ["p2", "p3", "p4", "p5", "p6"]
    for lvl in port_out:
        a = np.asarray(jax_out[lvl])
        b = port_out[lvl].permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape, (what, lvl, a.shape, b.shape)
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= tol, (what, lvl, err)


def test_eval_levels_match_jax(trunk):
    name, (ref, _), _, ptrunk = trunk
    with torch.no_grad():
        got = ptrunk.eval()(torch.from_numpy(IMAGE).permute(0, 3, 1, 2))
    _levels_close(got, ref, 1e-4, name)


def test_train_levels_and_running_stats_match_jax(trunk):
    name, (_, (ref, new)), _, ptrunk = trunk
    ptrunk = copy.deepcopy(ptrunk).train()
    with torch.no_grad():
        got = ptrunk(torch.from_numpy(IMAGE).permute(0, 3, 1, 2))
    _levels_close(got, ref, 2e-3, name)
    before = {k: v.clone() for k, v in ptrunk.state_dict().items() if "running" in k}
    update_running_stats(ptrunk)
    after = ptrunk.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in before.items())
    stats = jcw.convert_dla({k: v.numpy() for k, v in after.items()}, {"params": {}, "batch_stats": new["batch_stats"]})
    want, have = dict(_flat(new["batch_stats"])), dict(_flat(stats["batch_stats"]))
    assert set(have) == set(want)
    for path in want:
        err = np.abs(have[path] - want[path]).max() / np.abs(want[path]).max()
        assert err <= 1e-3, (name, "/".join(path), err)


def test_fused_switch_leaves_a_bottleneck_trunk_stock(trunk, monkeypatch):
    """``fused_forward()`` on the CPU: no Bottleneck tree calls K5's or K6's
    functions, and the output is the stock forward's."""
    from threedod_torch.ops import fused_conv

    name, _, _, ptrunk = trunk
    called = []
    for fn in ("fused_tree_tail", "fused_block_down"):
        monkeypatch.setattr(fused_conv, fn, lambda *a, _fn=fn, **k: called.append(_fn))
    x = torch.from_numpy(IMAGE).permute(0, 3, 1, 2)
    with torch.no_grad():
        stock = ptrunk.eval()(x)
        with fused_conv.fused_forward():
            fused = ptrunk(x)
    assert not called
    for lvl in stock:
        torch.testing.assert_close(fused[lvl], stock[lvl], rtol=0, atol=0)
