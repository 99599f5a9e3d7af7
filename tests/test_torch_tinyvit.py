"""TinyViT-5M of the port (``threedod_torch/models/tinyvit.py``) against the
JAX package's (``threedod/models/tinyvit.py``) on the CPU, f32, at 128 px
(the full widths, heads and windows: every stage, both merge strides, the
window padding at 7 and 14, the bias tables, the neck).

Numpy-made variables in the JAX model's shape go through
``sam_from_jax_variables`` (a folded convolution becomes ``c`` and a
BatchNorm of scale 1) into the port. Held to 1e-4 of the largest |value|:
the encoder and its 160-channel stage-2 tap, and ``Sam(encoder_type=
"vit_tiny")`` end to end with the HQ decoder. ``convert_tinyvit`` reads every
key of the port's encoder and folds it back to the JAX variables exactly.
One ``jax.jit`` a JAX part.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import threedod.utils.convert_weights as jcw
from threedod.models.sam import Sam as JSam
from threedod.models.tinyvit import TinyViT as JTinyViT
from threedod_torch.models import sam as psam
from threedod_torch.models.tinyvit import TinyViT, bias_idxs
from threedod_torch.utils.convert_weights import sam_from_jax_variables

from _torch_port import close, random_like

IMG = 128


@pytest.fixture(scope="module")
def hq_tiny():
    model = JSam(img_size=IMG, encoder_type="vit_tiny", hq=True)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                                               jnp.zeros((1, 4))))["params"]
    params = random_like(shapes, seed=21)
    port = psam.Sam(img_size=IMG, encoder_type="vit_tiny", hq=True)
    port.load_state_dict(sam_from_jax_variables(params, True, "vit_tiny"), strict=True)
    image = np.random.RandomState(4).randn(1, IMG, IMG, 3).astype(np.float32)
    return model, params, port.eval(), image


def test_converter_reads_every_key_and_folds_back(hq_tiny, monkeypatch):
    _, params, port, _ = hq_tiny
    sd = {k: v.numpy() for k, v in port.state_dict().items() if k.startswith("image_encoder.")}
    read = set()
    t = jcw._t
    monkeypatch.setattr(jcw, "_t", lambda x: read.add(id(x)) or t(x))
    back = jcw.convert_tinyvit(sd)
    unread = [k for k, v in sd.items() if id(v) not in read]
    assert not unread, unread
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat = dict(jax.tree_util.tree_leaves_with_path(params["image_encoder"]))
    assert flat_back.keys() == flat.keys()
    for k, v in flat.items():
        assert np.array_equal(np.asarray(flat_back[k]), v), k


def test_encoder_and_stage2_tap(hq_tiny):
    _, params, port, image = hq_tiny
    enc = JTinyViT(img_size=IMG)
    want, want_interm = jax.jit(lambda p, x: enc.apply({"params": p}, x, return_interm=True))(
        params["image_encoder"], image)
    with torch.no_grad():
        got, interm = port.image_encoder(torch.from_numpy(image), return_interm=True)
    assert got.shape == (1, IMG // 16, IMG // 16, 256) and interm.shape == (1, IMG // 16, IMG // 16, 160)
    close(interm, want_interm)
    close(got, want)


def test_sam_vit_tiny_end_to_end(hq_tiny):
    model, params, port, image = hq_tiny
    boxes = np.asarray([[10.0, 10.0, 100.0, 100.0], [40.0, 5.0, 127.0, 90.0]], np.float32)
    want = jax.jit(lambda p, x, b: model.apply({"params": p}, x, b))(params, image, boxes)
    with torch.no_grad():
        got = port(torch.from_numpy(image), torch.from_numpy(boxes))
    assert got.shape == (2, IMG // 4, IMG // 4)
    close(got, want)


def test_bias_index_table():
    from threedod.models.tinyvit import _bias_idxs

    for ws in (7, 14):
        assert np.array_equal(bias_idxs(ws), _bias_idxs(ws))
    assert isinstance(TinyViT().layers[2].blocks[0].attn.attention_bias_idxs, torch.Tensor)
