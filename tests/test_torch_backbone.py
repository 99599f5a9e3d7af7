"""The port's DLA34 + FPN (p2..p6) vs JAX ``BackboneWithFPN``, f32 on the CPU.

Weights: numpy-made variables in the shape of the JAX model's
(``_torch_port.seeded_variables``: nothing is compiled), converted into the
port. The JAX trunk runs
its space-to-depth stem, the port the plain 7x7 stem, so sums run in
another order; levels agree to ~1e-6 of their largest value and are held to
a relative error of 1e-4. Two canvases, both with the non-integer nearest
step from p6 to p5: the 64x96 test canvas (p5 2x3 -> p6 1x2) and 96x160
(p5 3x5 -> p6 2x3).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax
import jax.numpy as jnp


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = tp.configs()
    variables = tp.seeded_variables(jcfg)
    from threedod.models.backbones import build_backbone

    bb = build_backbone(jcfg.model.backbone, jcfg.model.fpn_out_channels, dtype=jnp.float32)
    bvars = {"params": variables["params"]["backbone"], "batch_stats": variables["batch_stats"]["backbone"]}
    return bb, bvars, tp.port_model(pcfg, variables).backbone


@pytest.mark.parametrize("hw", [(64, 96), (96, 160)])
def test_fpn_levels_match_jax(models, hw):
    bb, bvars, port_bb = models
    rng = np.random.RandomState(hw[0])
    x = rng.randn(2, *hw, 3).astype(np.float32)
    jf = jax.jit(lambda v, a: bb.apply(v, a, train=False))(bvars, jnp.asarray(x))
    with torch.no_grad():
        pf = port_bb(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(pf) == ["p2", "p3", "p4", "p5", "p6"]
    for lvl in pf:
        a = np.asarray(jf[lvl])
        b = pf[lvl].permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape, (lvl, a.shape, b.shape)
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= 1e-4, (lvl, err)


def test_nearest_exact_is_the_jax_resize():
    """jax.image.resize(nearest) == F.interpolate(nearest-exact) on the
    non-integer steps the FPN takes (11 -> 21 columns at 512x672), and
    plain "nearest" differs there."""
    x = np.arange(2 * 8 * 11, dtype=np.float32).reshape(1, 8, 11, 2)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 16, 21, 2), method="nearest"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    exact = torch.nn.functional.interpolate(t, size=(16, 21), mode="nearest-exact")
    plain = torch.nn.functional.interpolate(t, size=(16, 21), mode="nearest")
    np.testing.assert_array_equal(exact.permute(0, 2, 3, 1).numpy(), ref)
    assert not np.array_equal(plain.permute(0, 2, 3, 1).numpy(), ref)
