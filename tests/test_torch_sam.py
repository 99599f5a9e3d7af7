"""SAM and SAM-HQ of the port (``threedod_torch/models/sam.py``) against the
JAX package's (``threedod/models/sam.py``) on the CPU, f32.

A reduced SAM (256 px, encoder width 96, 2 heads, depth 4 with global
attention in blocks 1 and 3, window 14 over a 16x16 grid, so every windowed
block pads) with numpy-made variables in the JAX model's shape (every leaf
random, the position embedding and relative positions too) goes through
``sam_from_jax_variables`` into the port. Held to 1e-4 of the largest
|value|: the encoder and its HQ tap, the prompt encoder, ``decode_boxes``
with ``multimask_output`` and ``hq_token_only``, plain and HQ. Also: the
converter round trip (``convert_sam(port.state_dict())`` gives the JAX
variables back exactly), the relative-position table's interpolation, the
bicubic position embedding of an input smaller than ``img_size``, several
boxes in one call against one box a call, and ``preprocess_sam_image``.
One ``jax.jit`` a JAX part.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedod.models import sam as jsam
from threedod.utils.convert_weights import convert_sam
from threedod_torch.models import sam as psam
from threedod_torch.utils.convert_weights import sam_from_jax_variables

from _torch_port import close, random_like

IMG = 256
CFG = dict(encoder_dim=96, encoder_depth=4, encoder_heads=2, global_attn_indexes=(1, 3), img_size=IMG)
BOXES = np.asarray([[10.0, 20.0, 120.0, 200.0], [50.0, 40.0, 230.0, 250.0], [0.0, 0.0, 255.0, 128.0]], np.float32)
TOL = 1e-4


@pytest.fixture(scope="module", params=[False, True], ids=["sam", "sam_hq"])
def pair(request):
    hq = request.param
    model = jsam.Sam(hq=hq, **CFG)
    x = jnp.zeros((1, IMG, IMG, 3))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, jnp.zeros((1, 4))))["params"]
    params = random_like(shapes, seed=3 + hq)
    port = psam.Sam(hq=hq, **CFG)
    port.load_state_dict(sam_from_jax_variables(params, hq), strict=True)
    image = np.random.RandomState(5).randn(1, IMG, IMG, 3).astype(np.float32)
    emb = jax.jit(lambda p, t: model.apply({"params": p}, t, method=lambda m, u: m.encode_image(u)))(params, image)
    return dict(hq=hq, model=model, params=params, port=port.eval(), image=image, emb=emb)


def test_converter_round_trip_is_exact(pair):
    back = convert_sam({k: v.numpy() for k, v in pair["port"].state_dict().items()}, depth=CFG["encoder_depth"],
                       hq=pair["hq"])
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat = dict(jax.tree_util.tree_leaves_with_path(pair["params"]))
    assert flat_back.keys() == flat.keys()
    for k, v in flat.items():
        assert np.array_equal(np.asarray(flat_back[k]), v), k


def test_encoder_and_hq_tap(pair):
    with torch.no_grad():
        got = pair["port"].encode_image(torch.from_numpy(pair["image"]))
    if pair["hq"]:
        (emb, interm), (want_emb, want_interm) = got, pair["emb"]
        assert interm.shape == (1, 16, 16, CFG["encoder_dim"])
        close(interm, want_interm)
        close(emb, want_emb)
    else:
        close(got, pair["emb"])


FLAGS = {"single": (False, False), "multimask": (True, False), "hq_token_only": (False, True)}


@pytest.fixture(scope="module")
def jax_decoded(pair):
    """The JAX ``decode_boxes`` of the three flag settings, one jit."""
    model = pair["model"]

    def decode(p, e, b):
        return {name: model.apply({"params": p}, e, b, multimask_output=mm, hq_token_only=hq,
                                  method=lambda m, e_, b_, **kw: m.decode_boxes(e_, b_, **kw))
                for name, (mm, hq) in FLAGS.items()}

    return jax.jit(decode)(pair["params"], pair["emb"], BOXES)


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_decode_boxes(pair, jax_decoded, flags):
    """(``hq_token_only`` changes nothing in the plain model, in both packages.)"""
    multimask, hq_only = FLAGS[flags]
    emb = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pair["emb"])
    with torch.no_grad():
        got = pair["port"].decode_boxes(emb, torch.from_numpy(BOXES), multimask_output=multimask,
                                        hq_token_only=hq_only)
        one_by_one = torch.cat([pair["port"].decode_boxes(emb, torch.from_numpy(BOXES[i:i + 1]),
                                                          multimask_output=multimask, hq_token_only=hq_only)
                                for i in range(len(BOXES))])
    assert got.shape == (len(BOXES), IMG // 4, IMG // 4)
    close(got, jax_decoded[flags])
    close(got, one_by_one, tol=1e-5)  # the same sums; products of other batch shapes round apart


def test_prompt_encoder(pair):
    pe = jsam.PromptEncoder(image_embedding_size=(16, 16), input_image_size=(IMG, IMG))
    p = {"params": pair["params"]["prompt_encoder"]}
    sparse, dense = jax.jit(lambda v, b: (pe.apply(v, b, method=pe.encode_boxes), pe.apply(v, method=pe.dense_pe)))(
        p, BOXES)
    port = pair["port"].prompt_encoder
    with torch.no_grad():
        close(port.encode_boxes(torch.from_numpy(BOXES)), sparse)
        close(port.dense_pe(), dense)


def test_rel_pos_interpolation_and_bias():
    rng = np.random.RandomState(7)
    for q, k, length in ((14, 14, 27), (16, 16, 27), (8, 16, 13), (16, 8, 40)):
        table = rng.randn(length, 12).astype(np.float32)
        want = jax.jit(jsam._get_rel_pos, static_argnums=(0, 1))(q, k, table)
        close(psam.get_rel_pos(q, k, torch.from_numpy(table)), want, tol=1e-5)
    attn = rng.randn(3, 6 * 5, 6 * 5).astype(np.float32)
    qv = rng.randn(3, 6 * 5, 12).astype(np.float32)
    rh, rw = rng.randn(11, 12).astype(np.float32), rng.randn(9, 12).astype(np.float32)
    want = jax.jit(lambda *a: jsam._add_decomposed_rel_pos(*a, (6, 5), (6, 5)))(attn, qv, rh, rw)
    got = psam.add_decomposed_rel_pos(*(torch.from_numpy(a) for a in (attn, qv, rh, rw)), (6, 5), (6, 5))
    close(got, want, tol=1e-5)


def test_bicubic_pos_embed_of_a_smaller_input():
    """A 224 px input to a model made for 256 px: the 16x16 position
    embedding is resized ("bicubic") to 14x14 (windowed blocks only, so the
    relative positions keep their size)."""
    cfg = dict(CFG, encoder_depth=2, global_attn_indexes=())
    model = jsam.Sam(**cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                                               jnp.zeros((1, 4))))["params"]
    params = random_like(shapes, seed=11)
    x = np.random.RandomState(9).randn(1, 224, 224, 3).astype(np.float32)
    want = jax.jit(lambda p, t: model.apply({"params": p}, t, method=lambda m, u: m.encode_image(u)))(params, x)
    port = psam.Sam(**cfg)
    port.load_state_dict(sam_from_jax_variables(params, False), strict=True)
    with torch.no_grad():
        got = port.encode_image(torch.from_numpy(x))
    assert got.shape == (1, 14, 14, 256)
    close(got, want)


def test_preprocess_sam_image():
    img = (np.random.RandomState(2).rand(300, 400, 3) * 255).astype(np.float32)
    want, want_scale = jsam.preprocess_sam_image(jnp.asarray(img), IMG)
    got, scale = psam.preprocess_sam_image(torch.from_numpy(img), IMG)
    assert scale == want_scale
    close(got, want, tol=1e-5)
    assert float(got[0, 192:].abs().max()) == 0.0  # 300 * 256 / 400 = 192 rows, zero padding below
