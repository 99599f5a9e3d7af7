"""The port's NMS and RPN proposal selection vs JAX, on the same inputs.

* ``nms_sorted`` and ``batched_nms``: keep sets identical to JAX's,
  including tied scores (scores are drawn from a few levels, so many tie and
  the index-ordered tie-break decides), invalid entries and the -inf key;
  the batched call (leading dims) equals per-instance JAX calls.
* ``RPN.predict_proposals``: on the same logits and deltas, the proposals
  are the same, in the same order; scores bit-equal (they are the input
  logits), boxes to 1e-5 relative (exp() of the deltas in two libraries).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax
import jax.numpy as jnp

from threedod.ops.nms import batched_nms as jax_batched_nms
from threedod.ops.nms import nms_sorted as jax_nms_sorted

from threedod_torch.ops.nms import batched_nms, nms_sorted


def _nms_inputs(seed, n=160, g=3):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 100, (g, n, 2))
    wh = rng.uniform(5, 40, (g, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]  # an exact duplicate
    scores = rng.randint(0, 6, (g, n)).astype(np.float32) / 5.0  # many ties
    valid = rng.rand(g, n) > 0.1
    classes = rng.randint(0, 4, (g, n))
    return boxes, scores, valid, classes


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("seed", [0, 1])
def test_nms_sorted_matches_jax(seed, thresh):
    boxes, scores, valid, _ = _nms_inputs(seed)
    sb, sk, keep = nms_sorted(torch.from_numpy(boxes), torch.from_numpy(scores), thresh,
                              valid=torch.from_numpy(valid))
    for i in range(boxes.shape[0]):
        jb, jk, jkeep = jax_nms_sorted(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thresh,
                                       valid=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(sk[i].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(sb[i].numpy(), np.asarray(jb))


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("seed", [2, 3])
def test_batched_nms_matches_jax(seed, thresh):
    boxes, scores, valid, classes = _nms_inputs(seed)
    keep = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes),
                       thresh, valid=torch.from_numpy(valid))
    for i in range(boxes.shape[0]):
        jkeep = jax_batched_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(classes[i]),
                                thresh, valid=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jkeep))
    assert keep.any() and not keep.all()


@pytest.mark.parametrize("tied", [False, True])
def test_predict_proposals_matches_jax(tied):
    from threedod.models.rpn import RPN as JaxRPN

    from threedod_torch.models.rpn import RPN

    jcfg, pcfg = tp.configs()
    h, w = pcfg.shapes.canvas_height, pcfg.shapes.canvas_width
    shapes = {f"p{l}": (-(-h // 2 ** l), -(-w // 2 ** l)) for l in range(2, 7)}
    rng = np.random.RandomState(11)
    logits = {f: rng.randn(2, hh * ww * 3).astype(np.float32) for f, (hh, ww) in shapes.items()}
    if tied:  # coarse logits: many exact ties at every top-k
        logits = {f: np.round(v, 1) for f, v in logits.items()}
    regs = {f: (0.5 * rng.randn(2, hh * ww * 3, 4)).astype(np.float32) for f, (hh, ww) in shapes.items()}
    image_hw = np.array([[h, w], [56, 80]], np.int32)

    jp = jax.jit(lambda lg, rg, hw: JaxRPN(jcfg, shapes).predict_proposals(lg, rg, hw, train=False))(
        logits, regs, image_hw)
    rpn = RPN(pcfg, 256)
    pp = rpn.predict_proposals(
        {f: torch.from_numpy(v) for f, v in logits.items()}, {f: torch.from_numpy(v) for f, v in regs.items()},
        torch.from_numpy(image_hw), rpn.anchors(shapes, torch.device("cpu")),
    )
    np.testing.assert_array_equal(pp.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_array_equal(pp.scores.numpy(), np.asarray(jp.scores))
    v = np.asarray(jp.valid)
    assert v.sum() > 0
    np.testing.assert_allclose(pp.boxes.numpy()[v], np.asarray(jp.boxes)[v], rtol=1e-5, atol=1e-4)


def test_anchors_match_jax():
    from threedod.models.rpn import generate_anchors as jax_anchors

    from threedod_torch.models.rpn import generate_anchors

    shapes = {"p2": (4, 6), "p6": (1, 2)}
    strides = {"p2": 4, "p6": 64}
    sizes = {"p2": (32,), "p6": (512,)}
    a, b = generate_anchors(shapes, strides, sizes, (0.5, 1.0, 2.0)), jax_anchors(shapes, strides, sizes, (0.5, 1.0, 2.0))
    for k in shapes:
        np.testing.assert_array_equal(a[k], b[k])
