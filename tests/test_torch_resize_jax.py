"""``jax.image.resize`` written out (``threedod_torch/data/resize.py``:
``resize_linear`` and ``resize_cubic``) against jax on the CPU.

The shapes are those the asset tools resize: the 480x640 image up to
768x1024 for SAM and to 800x800 for GroundingDINO, SAM's logits up to
1024x1024 and down (antialiased) to 480x640, DA-V2's input to 518x686, a
position embedding (1, 16, 16, C) to 14x14, a relative-position table; plus
odd sizes both ways. f32 within 1e-5 of the largest |value|; bf16 in 98 %
of the values equal to jax's bits (a product a dimension, in the order jax's
einsum picks, each rounded to bf16).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedod_torch.data.resize import resize_cubic, resize_linear

CASES = [((48, 64, 3), (77, 103, 3)), ((48, 64, 3), (20, 30, 3)), ((120, 160, 3), (192, 256, 3)),
         ((120, 160, 3), (200, 200, 3)), ((64, 64), (256, 256)), ((192, 256), (120, 160)),
         ((120, 160, 3), (129, 172, 3)), ((1, 16, 16, 8), (1, 14, 14, 8)), ((27, 12), (31, 12)),
         ((40, 12), (31, 12)), ((3, 64, 48), (3, 64, 100))]
METHODS = {"linear": resize_linear, "cubic": resize_cubic}


@pytest.mark.parametrize("method", sorted(METHODS))
def test_f32_and_bf16_match_jax(method):
    rng = np.random.RandomState(0)
    fn = METHODS[method]
    for src, dst in CASES:
        x = rng.randn(*src).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), dst, method))
        got = fn(torch.from_numpy(x), dst).numpy()
        assert got.shape == dst and got.dtype == np.float32
        err = np.abs(got - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (src, dst, err)
        want16 = np.asarray(jax.image.resize(jnp.asarray(x).astype(jnp.bfloat16), dst, method).astype(jnp.float32))
        got16 = fn(torch.from_numpy(x).bfloat16(), dst)
        assert got16.dtype == torch.bfloat16
        # XLA makes the f32 weights with fused multiply-adds and its own sum
        # order, so up to 15 % of them sit an ulp from these; after the cast
        # to bf16 a few products round to the neighbouring bf16 number: 98 %
        # of the values are jax's bits, all within one bf16 step of the
        # largest value
        diff = np.abs(got16.float().numpy() - want16)
        assert diff.max() <= 2.0 ** -7 * np.abs(want16).max(), (src, dst, diff.max())
        assert (diff == 0).mean() >= 0.98, (src, dst, (diff == 0).mean())


def test_integer_input_and_unchanged_size():
    x = (np.random.RandomState(1).rand(30, 40, 3) * 255).astype(np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (45, 60, 3), "linear"))
    got = resize_linear(torch.from_numpy(x), (45, 60, 3)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    same = torch.from_numpy(x.astype(np.float32))
    assert torch.equal(resize_cubic(same, tuple(same.shape)), same)
