"""The port's whole inference slice vs JAX ``RCNN3D.apply(train=False)``.

One set of numpy-made variables in the shape of the JAX model's, its ROI
heads drawn as the JAX init draws them (``_torch_port.init_like_variables``:
nothing is compiled for them), goes into the JAX model and through the port's
converter into the port (strict load). One numpy batch flows through both, and the stages
are compared in order: FPN features, RPN proposals, 2D detections, 3D
cubes. f32 on the CPU both sides; the JAX side pools with
``multilevel_roi_align_windowed(window=WINDOW_Y)``, the port with its plain
ROIAlign.

Tolerances: the trunk's sums run in another order (JAX's space-to-depth
stem, XLA vs oneDNN convolutions), so features agree to ~1e-6 relative and
are held to 1e-4; boxes that come out of exp() of deltas to 1e-4 relative /
1e-3 px; 3D fields to 2e-4 relative. Sets (proposals, detections) are
compared as matched sets, so an order swap between two near-equal scores is
not a failure, but every member must have its counterpart.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax
import jax.numpy as jnp


def _match(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One-to-one index into b of each row of a: greedily the nearest unused
    row by max-abs difference (rows may repeat, e.g. boxes clipped alike)."""
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    used = np.zeros(len(b), bool)
    idx = np.zeros(len(a), int)
    for i in range(len(a)):
        j = next(j for j in np.argsort(d[i], kind="stable") if not used[j])
        used[j] = True
        idx[i] = j
    return idx


def run_slice(backbone: str = "dla34", predictor_scale: float = 50.0):
    """Both packages' stage outputs on the numpy batch, for one backbone.
    ``predictor_scale`` spreads the random-init class scores (see
    ``_torch_port.init_like_variables``) without saturating them into
    background. The JAX side runs two jits: the whole model (its FPN levels
    captured on the way), and the RPN head with proposal selection."""
    jcfg, pcfg = tp.configs(**{"model.backbone": backbone})
    img, image_hw, K, ratio = tp.inputs()
    jb = tp.jax_batch(img, image_hw, K, ratio)
    jmodel, variables = tp.jax_model(jcfg, predictor_scale=predictor_scale)
    pmodel = tp.port_model(pcfg, variables)
    tb = tp.torch_batch(img, image_hw, K, ratio)

    from threedod.models.rpn import RPN, RPNHead

    # the FPN levels are the whole model's own, captured where its backbone returns them
    trunk = lambda mdl, method: mdl.name == "backbone" and method == "__call__"  # noqa: E731
    jdet, state = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, capture_intermediates=trunk, mutable=["intermediates"]))(variables, jb)
    jfeats = state["intermediates"]["backbone"]["__call__"][0]
    head = RPNHead(num_anchors=3, dtype=jnp.float32)
    rpn = RPN(jcfg, {f: (v.shape[1], v.shape[2]) for f, v in jfeats.items()})
    jprops = jax.jit(lambda v, f, hw: rpn.predict_proposals(*head.apply(v, f), hw, train=False))(
        {"params": variables["params"]["rpn_head"]}, jfeats, jb.image_hw)

    from threedod_torch.data.batch import normalize_image

    with torch.no_grad():
        x = normalize_image(tb.image, pcfg.model, tb.image_hw).permute(0, 3, 1, 2)
        pfeats = pmodel.backbone(x)
        pprops = pmodel.proposal_generator(pfeats, tb.image_hw)
        pdet = pmodel(tb)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(
        jfeats=as_np(dict(jfeats)), pfeats=pfeats, jprops=as_np(jprops), pprops=pprops,
        jdet=as_np(jdet), pdet=pdet,
    )


@pytest.fixture(scope="module")
def slice_run():
    return run_slice()


def test_features(slice_run):
    for lvl in ("p2", "p3", "p4", "p5", "p6"):
        a = slice_run["jfeats"][lvl]
        b = slice_run["pfeats"][lvl].permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape, lvl
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= 1e-4, (lvl, err)


def test_proposals(slice_run):
    jp, pp = slice_run["jprops"], slice_run["pprops"]
    for i in range(2):
        jv, pv = jp.valid[i], pp.valid[i].numpy()
        assert jv.sum() == pv.sum() > 0
        jb, pb = jp.boxes[i][jv], pp.boxes[i].numpy()[pv]
        idx = _match(jb, pb)
        np.testing.assert_allclose(pb[idx], jb, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(pp.scores[i].numpy()[pv][idx], jp.scores[i][jv], rtol=1e-4, atol=1e-5)


def _matched_detections(slice_run, i):
    jd, pd = slice_run["jdet"], slice_run["pdet"]
    jv, pv = jd.valid[i], pd.valid[i].numpy()
    assert jv.sum() == pv.sum() > 0, (jv.sum(), pv.sum())
    key_j = np.concatenate([jd.boxes[i][jv], jd.classes[i][jv, None] * 1e4], 1)
    key_p = np.concatenate([pd.boxes[i].numpy()[pv], pd.classes[i].numpy()[pv, None] * 1e4], 1)
    idx = _match(key_j, key_p)
    return jd, pd, jv, pv, idx


def test_detections(slice_run):
    for i in range(2):
        jd, pd, jv, pv, idx = _matched_detections(slice_run, i)
        np.testing.assert_array_equal(pd.classes[i].numpy()[pv][idx], jd.classes[i][jv])
        np.testing.assert_allclose(pd.boxes[i].numpy()[pv][idx], jd.boxes[i][jv], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(pd.scores_2d[i].numpy()[pv][idx], jd.scores_2d[i][jv], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "field,atol",
    [("center_cam", 2e-4), ("dimensions", 2e-5), ("pose", 2e-4), ("corners3d", 5e-4),
     ("center_2d", 1e-3), ("scores", 1e-5)],
)
def test_cubes(slice_run, field, atol):
    for i in range(2):
        jd, pd, jv, pv, idx = _matched_detections(slice_run, i)
        a = getattr(jd, field)[i][jv]
        b = getattr(pd, field)[i].numpy()[pv][idx]
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=atol, err_msg=f"{field} image {i}")
