"""The port's training heads (RPN losses and proposals, ROI sampling, box and
cube losses) vs the JAX package, on identical FPN features.

Both sides get the same five feature maps (numpy, from a seed) and the same
ground truth, so every discrete choice (anchor labels, NMS, top-k, the two
subsamplers) sees the same numbers; the real NMS threshold and unsaturated
samplers of 32 are used. Sampling noise is shared (route one): the JAX side
runs with an explicit flax ``sampling`` key, the two keys flax derives from
it are read back with ``model.apply(..., method=...)``, and the Gumbel noise
of both subsamplers is rebuilt with the same ``split`` and ``gumbel`` calls
and handed to the port. Compared: every loss and metric, and the gradient of
the summed losses with respect to the features and to every head parameter.

Tolerances: f32 sums in another order, 1e-5 relative on losses. Gradients to
1e-4 of each leaf's largest entry, but 1e-2 for what passes through the cube
pose: at initialisation the 6d pose output is ~1e-3 in size and its
Gram-Schmidt normalisation magnifies rounding by its inverse. Inputs keep
clear of the clamp bounds (deltas far below SCALE_CLAMP, dims logits far
below 5, uncertainty above 0.01), where ``jnp.clip`` and ``torch.clamp``
define different gradients.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax
import jax.numpy as jnp

HEAD_OVERRIDES = {
    "model.rpn.pre_nms_topk_train": 200,
    "model.rpn.post_nms_topk_train": 60,
    "model.rpn.batch_size_per_image": 32,
    "shapes.roi_batch": 32,
    "shapes.max_gt": 4,
}
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}


def _jax_heads(m, feats, batch):
    """What ``RCNN3D.__call__(train=True)`` does after its backbone."""
    from threedod.models.rpn import RPN

    c = m.cfg
    rpn = RPN(c, {f: (v.shape[1], v.shape[2]) for f, v in feats.items()})
    logits, regs = m.rpn_head(feats, train=True)
    proposals, rpn_losses, rpn_metrics = rpn.losses_and_proposals(
        m.make_rng("sampling"), logits, regs, batch.gt.boxes2d, batch.gt.classes, batch.gt.valid,
        batch.image_hw, train=True)
    losses, metrics = m.roi_heads(feats, proposals, batch.K, batch.im_scale_ratio, batch.image_hw,
                                  gt=batch.gt, train=True)
    return {**losses, **rpn_losses}, {**metrics, **rpn_metrics}


@pytest.fixture(scope="module")
def run():
    from threedod_torch.utils.convert_weights import from_jax_variables

    jcfg, pcfg = tp.configs(**HEAD_OVERRIDES)
    img, image_hw, K, ratio = tp.inputs()
    gt = tp.ground_truth()
    jb = tp.jax_train_batch(img, image_hw, K, ratio, gt)
    tb = tp.torch_train_batch(img, image_hw, K, ratio, gt)
    jmodel, variables = tp.jax_model(jcfg)
    h, w = img.shape[1:3]
    rng = np.random.RandomState(21)
    feats = {f: rng.randn(2, -(-h // s), -(-w // s), 256).astype(np.float32) for f, s in STRIDES.items()}
    key = jax.random.PRNGKey(5)

    def total(params, feats):
        losses, metrics = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            feats, jb, rngs={"sampling": key}, method=_jax_heads)
        return sum(jax.tree.leaves(losses)), (losses, metrics)

    jfeats = {f: jnp.asarray(v) for f, v in feats.items()}
    (_, (jlosses, jmetrics)), (gparams, gfeats) = jax.device_get(
        jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True))(variables["params"], jfeats))

    k_rpn = jmodel.apply(variables, rngs={"sampling": key}, method=lambda m: m.make_rng("sampling"))
    k_roi = jmodel.apply(variables, rngs={"sampling": key}, method=lambda m: m.roi_heads.make_rng("sampling"))
    n_anchors = sum(v.shape[1] * v.shape[2] * 3 for v in feats.values())
    n_cand = HEAD_OVERRIDES["model.rpn.post_nms_topk_train"] + HEAD_OVERRIDES["shapes.max_gt"]
    noise = {"rpn": tp.sampler_noise(k_rpn, 2, n_anchors), "roi": tp.sampler_noise(k_roi, 2, n_cand)}

    pmodel = tp.port_model(pcfg, variables).train()
    pfeats = {f: torch.from_numpy(v).permute(0, 3, 1, 2).requires_grad_() for f, v in feats.items()}
    proposals, rpn_losses, rpn_metrics = pmodel.proposal_generator(pfeats, tb.image_hw, tb.gt, noise["rpn"])
    losses, metrics = pmodel.roi_heads(pfeats, proposals, tb.K, tb.im_scale_ratio, tb.image_hw, tb.gt, noise["roi"])
    losses.update(rpn_losses)
    metrics.update(rpn_metrics)
    sum(losses.values()).backward()

    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), variables["params"])
    as_np = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)  # noqa: E731
    jg = from_jax_variables({"params": {**zeros, "rpn_head": as_np(gparams["rpn_head"]),
                                        "roi_heads": as_np(gparams["roi_heads"])}}, pcfg)
    return dict(
        jlosses=jlosses, jmetrics=jmetrics, gfeats=gfeats, jg=jg,
        losses={k: v.item() for k, v in losses.items()}, metrics={k: float(v) for k, v in metrics.items()},
        pfeats=pfeats, pmodel=pmodel,
    )


def test_losses_and_metrics(run):
    assert set(run["losses"]) == set(run["jlosses"]) and len(run["losses"]) == 10
    for k, ref in run["jlosses"].items():
        np.testing.assert_allclose(run["losses"][k], ref, rtol=1e-5, atol=1e-7, err_msg=k)
    assert set(run["metrics"]) == set(run["jmetrics"]) and len(run["metrics"]) == 9
    for k, ref in run["jmetrics"].items():
        np.testing.assert_allclose(run["metrics"][k], ref, rtol=1e-5, atol=1e-7, err_msg=k)
    m = run["metrics"]
    # the samplers had to choose: more candidates than slots
    assert m["rpn/num_pos_anchors"] > 32 and 0 < m["roi/num_fg"] <= 8 and m["roi/num_bg"] > 0


def _rel_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("level", sorted(STRIDES))
def test_feature_gradients(run, level):
    ref = run["gfeats"][level]
    got = run["pfeats"][level].grad.permute(0, 2, 3, 1).numpy()
    if level in ("p5", "p6"):  # no gt is large enough to match an anchor or pool there
        assert np.abs(ref).max() == 0 and np.abs(got).max() == 0
        return
    assert np.abs(ref).max() > 0
    assert _rel_err(got, ref) <= 1e-2, level  # carries the cube pose's share


def test_head_parameter_gradients(run):
    checked = 0
    for name, p in run["pmodel"].named_parameters():
        if name.startswith("backbone.") or "priors" in name:
            continue
        ref = run["jg"][name].numpy()
        assert np.abs(ref).max() > 0, name
        through_pose = "cube_head" in name
        assert _rel_err(p.grad.numpy(), ref) <= (1e-2 if through_pose else 1e-4), name
        checked += 1
    assert checked == 28
