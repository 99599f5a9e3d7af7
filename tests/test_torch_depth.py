"""The port's Depth-Anything-V2 (``threedod_torch/models/depth``) vs the JAX
package's, on the CPU. Inputs and weights are made with numpy from a seed:
the ``vits`` params in the shape of the JAX model's (``jax.eval_shape`` of its
init), turned into the port's state dict by ``depth_from_jax_variables`` and
loaded strictly.

* ``bicubic_resize`` / ``_interp_pos`` on a 4x6 grid (non-square, so the
  bicubic path with the 0.1 offset runs): atol 1e-6 in f32;
* ``resize_align_corners`` up, down and to the same size: atol 1e-6 (both
  write the same four-corner sum; a coordinate that lands a last digit to
  either side of an integer changes which corners are read, not the value);
* ``DPTHead`` on seeded tokens of a 4x6 grid: atol 1e-5 on a sigmoid output;
* ``DepthAnythingV2("vits")`` at 56x84 in f32, whole: atol 2e-4 on depths of
  up to 20 (f32 sums in another order through 12 blocks and the head);
* in bf16 the residual stream is f32 after a block in both packages, and the
  blocks agree to 2^-6 of the largest entry (bf16 projections round at other
  places);
* the state dict through the JAX package's ``convert_depth_anything_v2``
  gives back the params exactly; a leftover leaf raises;
* ``depth_infer`` refuses a device that is not CUDA.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)

import jax
import jax.numpy as jnp

from threedod.models.depth import dinov2 as jdino
from threedod.models.depth import dpt as jdpt
from threedod.utils.convert_weights import convert_depth_anything_v2
from threedod_torch.models.depth import dinov2 as pdino
from threedod_torch.models.depth import dpt as pdpt
from threedod_torch.utils.convert_weights import depth_from_jax_variables

H, W = 56, 84  # a 4x6 patch grid


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def models():
    """(JAX vits model, its numpy params, the port model loaded from them)."""
    jmodel = jdpt.DepthAnythingV2(encoder="vits", dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x), jnp.zeros((1, H, W, 3)))["params"]
    rng = np.random.RandomState(0)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if hasattr(val, "items"):
                out[key] = fill(val)
            elif key == "kernel":
                out[key] = (rng.randn(*val.shape) / np.sqrt(np.prod(val.shape[:-1]))).astype(np.float32)
            elif key in ("scale", "ls1_gamma", "ls2_gamma"):
                out[key] = rng.uniform(0.7, 1.3, val.shape).astype(np.float32)
            elif key == "bias":
                out[key] = rng.normal(0, 0.05, val.shape).astype(np.float32)
            else:  # cls_token, pos_embed
                out[key] = rng.normal(0, 0.2, val.shape).astype(np.float32)
        return out

    params = fill(shapes)
    port = pdpt.DepthAnythingV2("vits", dtype=torch.float32).eval()
    port.load_state_dict(depth_from_jax_variables(params), strict=True)
    return jmodel, params, port


def test_interp_pos_matches_jax(models):
    _, params, port = models
    ref = jdino.build_dinov2("vits").apply({"params": params["pretrained"]}, 4, 6, method="_interp_pos")
    with torch.no_grad():
        got = port.pretrained._interp_pos(4, 6)
    assert got.shape == (1, 25, 384)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # the square native grid hands the parameter back untouched
    assert port.pretrained._interp_pos(37, 37) is port.pretrained.pos_embed


@pytest.mark.parametrize("out_hw,scale", [((4, 6), (4.1 / 5, 6.1 / 5)), ((9, 7), (9.1 / 5, 7.1 / 5))])
def test_bicubic_resize_matches_jax(out_hw, scale):
    x = np.random.RandomState(2).randn(1, 5, 5, 8).astype(np.float32)
    ref = jdino._bicubic_resize_torch(jnp.asarray(x), *out_hw, *scale)
    got = pdino.bicubic_resize(torch.from_numpy(x), *out_hw, *scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("out_hw", [(7, 11), (2, 3), (8, 12), (3, 5)])
def test_resize_align_corners_matches_jax(out_hw):
    x = np.random.RandomState(3).randn(2, 3, 5, 4).astype(np.float32)  # NHWC, 3x5
    ref = jax.jit(lambda a: jdpt.resize_align_corners(a, *out_hw))(x)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = pdpt.resize_align_corners(t, *out_hw)
    if out_hw == (3, 5):
        assert got is t
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-6)


def test_dpt_head_matches_jax(models):
    _, params, port = models
    rng = np.random.RandomState(4)
    tokens = [rng.randn(2, 24, 384).astype(np.float32) for _ in range(4)]
    cfg = jdpt.DEPTH_MODEL_CONFIGS["vits"]
    head = jdpt.DPTHead(features=cfg["features"], out_channels=cfg["out_channels"], dtype=jnp.float32)
    ref = jax.jit(lambda p, t: head.apply({"params": p}, t, 4, 6))(params["depth_head"], [jnp.asarray(t) for t in tokens])
    with torch.no_grad():
        got = port.depth_head([torch.from_numpy(t) for t in tokens], 4, 6)
    assert got.shape == (2, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_whole_model_matches_jax(models):
    jmodel, params, port = models
    x = np.random.RandomState(5).randn(2, H, W, 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, a: jmodel.apply({"params": p}, a))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, H, W) and got.dtype == torch.float32
    assert 0.0 < got.min() and got.max() < 20.0 and ref.std() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


def test_bf16_block_keeps_an_f32_stream_as_jax_does(models):
    _, params, port = models
    x = np.random.RandomState(6).randn(1, 25, 384).astype(np.float32)
    jblock = jdino.Block(384, 6, dtype=jnp.bfloat16)
    ref = jax.jit(lambda p, a: jblock.apply({"params": p}, a))(params["pretrained"]["block0"], jnp.asarray(x, jnp.bfloat16))
    block = copy.deepcopy(port.pretrained.blocks[0])
    for m in block.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.bfloat16
    with torch.no_grad():
        got = block(torch.from_numpy(x).bfloat16())
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 2.0 ** -6 * np.abs(ref).max()
    # and the model's tokens enter the first block in the compute dtype
    vit = pdino.DinoVisionTransformer(embed_dim=128, depth=1, num_heads=2, img_size=70, dtype=torch.bfloat16)
    with torch.no_grad():
        t, hp, wp = vit.prepare_tokens(torch.zeros(1, 3, 28, 42))
        assert t.dtype == torch.bfloat16 and (hp, wp) == (2, 3)
        (patches, cls), = vit.get_intermediate_layers(torch.zeros(1, 3, 28, 42), (0,))[0]
    assert patches.dtype == cls.dtype == torch.float32 and patches.shape == (1, 6, 128)


def test_converter_round_trip_is_exact_and_a_leftover_raises(models):
    _, params, port = models
    back = convert_depth_anything_v2({k: v.numpy() for k, v in port.state_dict().items()}, "vits")
    want, have = dict(_flat(params)), dict(_flat(back))
    assert set(have) == set(want) and len(want) == len(port.state_dict())
    for path in want:
        np.testing.assert_array_equal(have[path], want[path], err_msg="/".join(path))
    extra = copy.deepcopy(params)
    extra["depth_head"]["refinenet4"]["resConfUnit1"] = {"conv1": {"kernel": np.zeros((3, 3, 64, 64), np.float32)}}
    port_sd = depth_from_jax_variables(extra)  # a unit the JAX tree may carry is named, not dropped
    assert "depth_head.scratch.refinenet4.resConfUnit1.conv1.weight" in port_sd
    extra = copy.deepcopy(params)
    extra["pretrained"]["mask_token"] = np.zeros((1, 384), np.float32)
    with pytest.raises(KeyError):
        depth_from_jax_variables(extra)


def test_specs_are_the_jax_packages():
    assert pdino.VIT_SPECS == jdino.VIT_SPECS
    assert pdino.INTERMEDIATE_LAYER_IDX == jdino.INTERMEDIATE_LAYER_IDX
    assert pdpt.DEPTH_MODEL_CONFIGS == jdpt.DEPTH_MODEL_CONFIGS
    with pytest.raises(ValueError, match="unknown encoder"):
        pdpt.DepthAnythingV2("vitg")


def test_depth_infer_refuses_the_cpu_and_odd_sizes():
    from threedod_torch import depth_infer

    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        depth_infer.main(["--device", "cpu"])
    with pytest.raises(ValueError, match="multiples of 14"):
        depth_infer.random_images(1, 518, 920)
    assert depth_infer.random_images(1, 28, 42).shape == (1, 28, 42, 3)
