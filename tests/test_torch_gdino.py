"""The port's GroundingDINO (``threedod_torch/models/gdino``) vs the JAX
package's, f32 on the CPU.

One reduced model for the file: Swin depths (2, 2, 2, 2) at Swin-T's widths,
2 BERT-base layers, 2 enhancer and 2 decoder layers, 20 queries. Its params
are made with numpy from a seed in the tree the JAX converter makes of the
port's parameter shapes (flax checks every shape when it applies them),
turned into the port's state dict by ``gdino_from_jax_variables`` and loaded
strictly. Each part gets the same subtree of params in both packages, and its
seeded numpy inputs. The JAX side runs under one ``jax.jit`` a part (the
Swin taps at 64x96 and BERT with the padding mask are captured inside the
whole model's); its deformable sampling is the matmul backend, as on any CPU.
Tolerances (f32 sums in other orders; outputs of order 1 to 5, logits up to
about 30):

* ``SwinT`` taps at 64x96, and at 66x90 (not a multiple of 4, so the patch
  embedding pads as flax "SAME" does; a 17x23 grid, so every stage pads to
  the window and the odd grids go through ``PatchMerging``'s padding): 2e-5;
* ``BertEncoder`` with a padding mask and with the per-phrase pairwise mask
  and position ids of ``generate_text_masks``: 2e-5 on unmasked tokens;
* ``BiAttentionBlock``, one enhancer layer (with the per-phrase text mask and
  the text position embedding) and ``DecoderLayer``: 2e-5;
* the sine embeddings: 1e-5; ``generate_text_masks`` on three prompts, the
  patch embedding's "SAME" padding, the relative-position index and the
  shifted window's mask: exactly;
* the whole model at 64x96 on the tool's prompt plus one padded token, stage
  by stage (the intermediates the JAX model sows): 5e-5; the selected query
  indices exactly; logits 2e-4 on the unmasked tokens (-inf on the padded one
  in both); boxes 1e-5; ``best_box_for_prompt``: 1e-3 px;
* the port's state dict through the JAX package's ``convert_groundingdino``
  gives back the params exactly, and a leftover leaf raises.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)

import jax
import jax.numpy as jnp

from threedod.models.gdino import model as jm
from threedod.models.gdino import swin as jswin
from threedod.models.gdino.bert import BertEncoder as JBert
from threedod.models.gdino.swin import SwinT as JSwin
from threedod.utils.convert_weights import convert_groundingdino
from threedod_torch.models.gdino import model as pm
from threedod_torch.models.gdino import swin as pswin
from threedod_torch.utils.convert_weights import gdino_from_jax_variables

H, W = 64, 96
CFG = dict(num_queries=20, enc_layers=2, dec_layers=2, swin_depths=(2, 2, 2, 2), bert_layers=2)
IDS = np.array([[101, 2598, 1012, 102, 0]], np.int32)  # "ground." and one padded slot
MASK = np.array([[True, True, True, True, False]])
LEVELS = [(8, 12), (4, 6), (2, 3), (1, 2)]  # the four levels of a 64x96 image
S = sum(h * w for h, w in LEVELS)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def gdino():
    """(JAX model, numpy params, port model loaded from them)."""
    jmodel = jm.GroundingDINO(**CFG)
    port = pm.GroundingDINO(**CFG).eval()
    shapes = convert_groundingdino({k: np.zeros(v.shape, np.float32) for k, v in port.state_dict().items()},
                                   depths=CFG["swin_depths"], enc_layers=CFG["enc_layers"],
                                   dec_layers=CFG["dec_layers"], bert_layers=CFG["bert_layers"])["params"]
    rng = np.random.default_rng(0)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if hasattr(val, "items"):
                out[key] = fill(val)
            elif key == "kernel":
                out[key] = normal(val.shape, 1.0 / np.sqrt(np.prod(val.shape[:-1])))
            elif key == "scale":
                out[key] = rng.uniform(0.8, 1.2, val.shape).astype(np.float32)
            elif key in ("gamma_v", "gamma_l"):
                out[key] = rng.uniform(0.5, 1.0, val.shape).astype(np.float32)
            elif key in ("bias", "relative_position_bias_table"):
                out[key] = normal(val.shape, 0.05 if key == "bias" else 0.5)
            else:  # embeddings, level and query embeddings
                out[key] = normal(val.shape, 1.0)
        return out

    params = fill(shapes)
    port.load_state_dict(gdino_from_jax_variables(params), strict=True)
    return jmodel, params, port


def _img(h, w, seed=0):
    return np.random.RandomState(seed).randn(1, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("hw", [(H, W), (66, 90)], ids=["64x96", "66x90"])
def test_swin_taps_match_jax(gdino, whole, hw):
    _, params, port = gdino
    if hw == (H, W):
        x, ref = whole[2], whole[1]["swin"]
    else:
        x = _img(*hw, seed=hw[0])
        swin = JSwin(depths=CFG["swin_depths"])
        ref = jax.jit(lambda p, a: swin.apply({"params": p}, a))(params["backbone"], x)
    with torch.no_grad():
        got = port.backbone[0](torch.from_numpy(x))
    grid = (-(-hw[0] // 4), -(-hw[1] // 4))
    for i, k in enumerate(("p3", "p4", "p5")):
        s = 2 ** (i + 1)
        assert got[k].shape == (1, -(-grid[0] // s), -(-grid[1] // s), 192 * 2 ** i), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=2e-5, err_msg=k)


@pytest.mark.parametrize("pairwise", [False, True], ids=["padding_mask", "pairwise_mask"])
def test_bert_matches_jax(gdino, whole, pairwise):
    _, params, port = gdino
    if pairwise:  # two phrases and two padded slots, which attend to themselves only
        ids = np.array([[101, 2598, 1012, 2723, 1029, 102, 0, 0]], np.int32)
        mask, pos = pm.generate_text_masks(ids)
        bert = JBert(layers=CFG["bert_layers"])
        ref = jax.jit(lambda p, i, m, q: bert.apply({"params": p}, i, m, position_ids=q))(
            params["bert"], ids, mask, pos.astype(np.int32))
        pos, n = torch.from_numpy(pos), 6
    else:  # inside the whole model: the tool's prompt and one padded slot
        ids, mask, pos, ref, n = IDS, MASK, None, whole[1]["bert"], 4
    with torch.no_grad():
        got = port.bert(torch.from_numpy(ids).long(), torch.from_numpy(mask), position_ids=pos)
    assert got.shape == ids.shape + (768,)
    np.testing.assert_allclose(got.numpy()[:, :n], np.asarray(ref)[:, :n], atol=2e-5)


def _layer_inputs(seed):
    rng = np.random.RandomState(seed)
    vis = rng.randn(1, S, 256).astype(np.float32)
    txt = rng.randn(1, 5, 256).astype(np.float32)
    return rng, vis, txt


def test_bi_attention_block_matches_jax(gdino):
    _, params, port = gdino
    _, vis, txt = _layer_inputs(1)
    block = jm.BiAttentionBlock()
    rv, rt = jax.jit(lambda p, v, t, m: block.apply({"params": p}, v, t, m))(params["enc0"]["fusion"], vis, txt, MASK)
    with torch.no_grad():
        gv, gt = port.transformer.encoder.fusion_layers[0](*(torch.from_numpy(a) for a in (vis, txt, MASK)))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=2e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(rt), atol=2e-5)


def test_enhancer_layer_matches_jax(gdino):
    _, params, port = gdino
    rng, vis, txt = _layer_inputs(2)
    vis_pos = rng.randn(1, S, 256).astype(np.float32)
    txt_pos = rng.randn(1, 5, 256).astype(np.float32)
    refs = np.broadcast_to(pm.reference_points(LEVELS).numpy()[None, :, None], (1, S, 4, 2)).copy()
    self_mask, _ = pm.generate_text_masks(IDS)
    layer = jm.EnhancerLayer(256, 4)
    rv, rt = jax.jit(lambda p, *a: layer.apply({"params": p}, *a[:5], LEVELS, txt_pos=a[5], txt_self_mask=a[6]))(
        params["enc0"], vis, txt, MASK, vis_pos, refs, txt_pos, self_mask)
    with torch.no_grad():
        gv, gt = port.transformer.encoder.enhancer_layer(
            0, *(torch.from_numpy(a) for a in (vis, txt, MASK, vis_pos, refs)), LEVELS,
            txt_pos=torch.from_numpy(txt_pos), txt_self_mask=torch.from_numpy(self_mask))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=2e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(rt), atol=2e-5)


def test_decoder_layer_matches_jax(gdino):
    _, params, port = gdino
    rng, vis, txt = _layer_inputs(3)
    q, qpos = (rng.randn(1, 20, 256).astype(np.float32) for _ in range(2))
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (1, 20, 2)), rng.uniform(0.05, 0.5, (1, 20, 2))], -1).astype(np.float32)
    layer = jm.DecoderLayer(256, 4)
    ref = jax.jit(lambda p, *a: layer.apply({"params": p}, *a, LEVELS))(params["dec0"], q, qpos, txt, MASK, vis, boxes)
    with torch.no_grad():
        got = port.transformer.decoder.layers[0](*(torch.from_numpy(a) for a in (q, qpos, txt, MASK, vis, boxes)), LEVELS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("n", [64, 66, 67, 800])
def test_patch_embedding_pads_as_flax_same(n):
    assert pswin._same_pad(n, 4, 4) == tuple(jax.lax.padtype_to_pads((n,), (4,), (4,), "SAME")[0])


@pytest.mark.parametrize("ws", [7, 3])
def test_relative_position_index_matches_jax(ws):
    np.testing.assert_array_equal(pswin._rel_pos_index(ws), jswin._rel_pos_index(ws))
    np.testing.assert_array_equal(pswin._rel_pos_index(ws), np.asarray(jswin._rel_pos_index_jnp(ws)))


def test_shift_mask_is_the_classic_slice_construction():
    """The region labels of the shifted window, against the original Swin's
    slice loop, on a padded 14x21 grid."""
    hp, wp, ws, shift = 14, 21, 7, 3
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    want = np.where(win[:, :, None] != win[:, None, :], -100.0, 0.0)
    np.testing.assert_array_equal(pswin._shift_mask(hp, wp, ws, shift), want)


@pytest.mark.parametrize("ids", [
    [101, 2598, 1012, 102],                      # the tool's prompt
    [101, 2598, 1012, 2723, 1029, 102, 0, 0],    # two phrases and padding
    [101, 3899, 4937, 102],                      # no separator inside
], ids=["ground", "two_phrases", "one_phrase"])
def test_generate_text_masks_matches_jax(ids):
    ids = np.array([ids, ids[::-1]])
    for a, b in zip(pm.generate_text_masks(ids), jm.generate_text_masks(ids)):
        np.testing.assert_array_equal(a, b)


def test_sine_embeddings_and_text_masks_match_jax():
    boxes = np.random.RandomState(4).uniform(0, 1, (2, 5, 4)).astype(np.float32)
    pos = np.array([[0, 1, 2, 0, 1, 0]], np.float32) * np.float32(2 * np.pi)
    ref = jax.jit(lambda b, p: (jm.sine_pos_embed_2d(7, 11), jm.sine_pos_embed_boxes(b),
                                jm._interleaved_sincos(p, 256, 10000.0), jm.inverse_sigmoid(b)))(boxes, pos)
    got = (pm.sine_pos_embed_2d(7, 11), pm.sine_pos_embed_boxes(torch.from_numpy(boxes)),
           pm._interleaved_sincos(torch.from_numpy(pos), 256, 10000.0), pm.inverse_sigmoid(torch.from_numpy(boxes)))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
    ids = np.array([[101, 2598, 1012, 2723, 1029, 102], [101, 2598, 2723, 1012, 102, 0]])
    for a, b in zip(pm.generate_text_masks(ids), jm.generate_text_masks(ids)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def whole(gdino):
    """The whole reduced model on one 64x96 image, both packages."""
    jmodel, params, port = gdino
    x = _img(H, W, seed=5)
    trunks = lambda mdl, method: mdl.name in ("backbone", "bert") and method == "__call__"  # noqa: E731
    (logits, boxes), state = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, mutable=["intermediates"], capture_intermediates=trunks))(params, x, IDS, MASK)
    inter = dict(state["intermediates"])
    ref = {"swin": inter.pop("backbone")["__call__"][0], "bert": inter.pop("bert")["__call__"][0]}
    ref.update({k: np.asarray(v[0]) for k, v in inter.items()}, logits=np.asarray(logits), boxes=np.asarray(boxes))
    with torch.no_grad():
        pl, pb, inter = port(torch.from_numpy(x), torch.from_numpy(IDS).long(), torch.from_numpy(MASK))
    got = {k: v.numpy() for k, v in inter.items()}
    got.update(logits=pl.numpy(), boxes=pb.numpy())
    return got, ref, x


def test_whole_model_matches_jax_stage_by_stage(whole):
    got, ref, _ = whole
    for k in ("vis_in", "txt_in", "vis_enc", "txt_enc"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], atol=5e-5, err_msg=k)
    assert got["vis_in"].shape == (1, S, 256)


def test_query_selection_matches_jax(gdino, whole):
    """The JAX model's selection, recomputed in numpy from its sown encoder
    outputs: enc_output, its LayerNorm, logits against the text, masked, the
    largest per token, stable descending order."""
    params, (got, ref, _) = gdino[1], whole
    mem = ref["vis_enc"] @ params["enc_output"]["kernel"] + params["enc_output"]["bias"]
    mu, var = mem.mean(-1, keepdims=True), mem.var(-1, keepdims=True)
    n = params["enc_output_norm"]
    mem = (mem - mu) / np.sqrt(var + 1e-6) * n["scale"] + n["bias"]
    score = np.where(MASK[:, None], mem @ ref["txt_enc"].transpose(0, 2, 1), -1e9).max(-1)
    want = np.argsort(-score, axis=1, kind="stable")[:, :CFG["num_queries"]]
    np.testing.assert_array_equal(got["top_idx"], want)


def test_logits_boxes_and_best_box_match_jax(whole):
    got, ref, _ = whole
    assert got["logits"].shape == (1, 20, 5) and got["boxes"].shape == (1, 20, 4)
    assert np.isneginf(got["logits"][..., 4]).all() and np.isneginf(ref["logits"][..., 4]).all()
    np.testing.assert_allclose(got["logits"][..., :4], ref["logits"][..., :4], atol=2e-4)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-5)
    assert ((got["boxes"] >= 0) & (got["boxes"] <= 1)).all()
    hw = np.array([[480, 640]], np.int32)
    rx, rs = jm.best_box_for_prompt(jnp.asarray(ref["logits"]), jnp.asarray(ref["boxes"]), jnp.asarray(hw))
    gx, gs = pm.best_box_for_prompt(torch.from_numpy(got["logits"]), torch.from_numpy(got["boxes"]), torch.from_numpy(hw))
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), atol=1e-3)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), atol=1e-5)


def test_converter_round_trip_is_exact_and_a_leftover_raises(gdino):
    _, params, port = gdino
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_groundingdino(sd, depths=CFG["swin_depths"], enc_layers=CFG["enc_layers"],
                                 dec_layers=CFG["dec_layers"], bert_layers=CFG["bert_layers"])["params"]
    want, have = dict(_flat(params)), dict(_flat(back))
    assert set(have) == set(want)
    for path in want:
        assert have[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(have[path], want[path], err_msg="/".join(path))
    assert "transformer.encoder.text_layers.1.self_attn.in_proj_weight" in sd
    np.testing.assert_array_equal(sd["transformer.decoder.layers.0.norm2.weight"], params["dec0"]["norm1"]["scale"])
    extra = copy.deepcopy(params)
    extra["enc1"]["fusion"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no port counterpart"):
        gdino_from_jax_variables(extra)
