"""Oracle 2D boxes: the port's ``RCNN3D.forward(batch, oracle=True)`` vs the
JAX ``RCNN3D.apply(..., train=False, oracle=True)``, f32 on the CPU.

One set of numpy-made variables in the shape of the JAX DLA34 model's (its
ROI heads drawn as the JAX init draws them) goes into both models; one numpy
batch with ground truth (``_torch_port.ground_truth``: an ignore region and
a padding slot among the 8) flows through both. The detections are the
ground-truth slots in order, so they are compared slot by slot: valid,
classes and the 2D scores exactly, boxes (rescaled by ``im_scale_ratio``) to
1e-6 relative, and the cube head's fields on them (centre, dimensions, pose,
corners, 2D centre, fused score) within 2e-4 relative and 1e-5 absolute, the
slice test's tolerance for 3D fields (the trunk's sums run in another
order). The port bypasses the RPN and the box branch in oracle mode, and
weak Cube R-CNN (``RCNN3DCombined``) inherits the mode.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax


@pytest.fixture(scope="module")
def oracle_run():
    jcfg, pcfg = tp.configs()
    img, image_hw, K, ratio = tp.inputs()
    gt = tp.ground_truth()
    jmodel, variables = tp.jax_model(jcfg, predictor_scale=50.0)
    jdet = jax.jit(lambda v, b: jmodel.apply(v, b, train=False, oracle=True))(
        variables, tp.jax_train_batch(img, image_hw, K, ratio, gt))
    pmodel = tp.port_model(pcfg, variables).eval()
    batch = tp.torch_train_batch(img, image_hw, K, ratio, gt)
    with torch.no_grad():
        pdet = pmodel(batch, oracle=True)
    return jax.tree_util.tree_map(np.asarray, jdet), pdet, (pcfg, variables, batch, gt)


def test_oracle_detections_match_jax(oracle_run):
    jdet, pdet, (_, _, _, gt) = oracle_run
    valid = gt["valid"] & (gt["classes"] >= 0)
    np.testing.assert_array_equal(pdet.valid.numpy(), valid)
    np.testing.assert_array_equal(jdet.valid, valid)
    np.testing.assert_array_equal(pdet.classes.numpy(), np.maximum(gt["classes"], 0))
    np.testing.assert_array_equal(pdet.classes.numpy(), jdet.classes)
    np.testing.assert_array_equal(pdet.scores_2d.numpy(), valid.astype(np.float32))
    np.testing.assert_array_equal(pdet.scores_2d.numpy(), jdet.scores_2d)
    np.testing.assert_allclose(pdet.boxes.numpy(), jdet.boxes, rtol=1e-6)
    for field in ("scores", "center_cam", "dimensions", "pose", "corners3d", "center_2d"):
        got, want = getattr(pdet, field).numpy(), getattr(jdet, field)
        np.testing.assert_allclose(got[valid], want[valid], rtol=2e-4, atol=1e-5, err_msg=field)


def test_oracle_bypasses_rpn_and_box_branch(oracle_run, monkeypatch):
    """The port's oracle forward reads neither the RPN nor the box branch,
    and weak Cube R-CNN gives the same detections."""
    from threedod_torch.models.meta_arch import build_model

    _, pdet, (pcfg, variables, batch, _) = oracle_run
    model = tp.port_model(pcfg, variables).eval()

    def refuse(*a, **k):
        raise AssertionError("read in oracle mode")

    monkeypatch.setattr(model.proposal_generator, "forward", refuse)
    monkeypatch.setattr(model.roi_heads, "box_branch_inference", refuse)
    with torch.no_grad():
        again = model(batch, oracle=True)
    for a, b in zip(again, pdet):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    pcfg.model.meta_architecture = "RCNN3DCombined"
    try:
        weak = build_model(pcfg)
    finally:
        pcfg.model.meta_architecture = "RCNN3D"
    weak.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        got = weak.eval()(batch, oracle=True)
    for a, b in zip(got, pdet):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
