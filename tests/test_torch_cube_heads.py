"""Every cube-head option of Cube R-CNN, the port vs the JAX package, f32 on
the CPU.

The cube branch alone (``ROIHeads3D.cube_forward`` then ``cube_losses``) on
the same numpy inputs (seeded): five FPN levels of 16 channels at the 64x96
canvas, 2 x 6 ROIs, 5 classes, fc width 32. Each side pools the ROIs itself
(the plain ROIAlign on both), so the feature gradient passes through the
pool's backward. The JAX side is one ``jax.jit`` of ``value_and_grad`` an
option set; its parameters are numpy-made in the shapes ``jax.eval_shape``
gives and go to the port through ``from_jax_variables``. Four option sets
cover every flag of ``roi_cube_head`` (the defaults are held by the other
files):

  =====  ===========================================================
  A      separate fc stacks, quaternion pose, sigmoid depth, egocentric
         pose, real depth, sigmoid dimension priors, ROI boxes scaled
         by 1.25 (a second pool), direct losses, 1 / log(z) weights
  B      Euler 'XYZ' pose, clustered depth in 3 bins, a 5x5 cube pool
         beside the box head's 7x7 (a second pool), direct losses, no
         confidence, no dimension priors
  C      log depth, smooth-L1 pose and joint losses, 1 / log(z) weights
  D      separate fc stacks without a confidence stack, direct depth in
         2 bins, direct losses
  =====  ===========================================================

Compared: every output of ``cube_forward`` to 1e-5 of its largest entry,
every loss and metric to 1e-5 relative, the gradient of the summed losses
to every cube-head parameter and to the features to 1e-4 of the leaf's
largest entry. The 6d pose is not among the sets' outputs near zero: the
pose outputs are drawn with a spread of 0.05 so that the pose's
normalisation does not magnify rounding (``test_torch_train_heads.py``).

Also here: the priors of a head with depth bins built from a priors dict
as the JAX head builds them; the weight round trip through the JAX zoo
converter with separate fc stacks; the 2D-only head (``loss_w_3d`` 0,
``configs/Base_Omni3D_2D_only.yaml``) on given proposals, training losses,
metrics and gradients against the JAX head's and its detections, with no
cube parameter in either package.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax

NARROW = {"model.fpn_out_channels": 16, "model.roi_cube_head.fc_dim": 32, "model.roi_box_head.fc_dim": 32}
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
OPTION_SETS = {
    "A": dict(shared_fc=False, pose_type="quaternion", z_type="sigmoid", allocentric_pose=False,
              virtual_depth=False, dims_priors_func="sigmoid", scale_roi_boxes=1.25, disentangled_loss=False,
              inverse_z_weight=True),
    "B": dict(pose_type="euler", z_type="clusters", cluster_bins=3, pooler_resolution=5, disentangled_loss=False,
              use_confidence=0.0, dims_priors_enabled=False),
    "C": dict(z_type="log", chamfer_pose=False, inverse_z_weight=True),
    "D": dict(shared_fc=False, cluster_bins=2, disentangled_loss=False, use_confidence=0.0),
}


def _configs(options):
    return tp.configs(**NARROW, **{f"model.roi_cube_head.{k}": v for k, v in options.items()})


def _inputs(seed=0, b=2, n=6):
    """Levels (NHWC), boxes (B, N, 4), classes, the ground truth's (BN, 9)
    boxes and poses, the foreground mask."""
    rng = np.random.RandomState(seed)
    h, w = tp.OVERRIDES["shapes.canvas_height"], tp.OVERRIDES["shapes.canvas_width"]
    feats = {f: rng.randn(b, -(-h // s), -(-w // s), 16).astype(np.float32) for f, s in STRIDES.items()}
    xy = np.stack([rng.uniform(2, w - 42, (b, n)), rng.uniform(2, h - 42, (b, n))], -1)
    boxes = np.concatenate([xy, xy + rng.uniform(8, 40, (b, n, 2))], -1).astype(np.float32)
    classes = rng.randint(0, 5, (b, n)).astype(np.int64)
    centre = (boxes[..., :2] + boxes[..., 2:]) / 2 + rng.uniform(-3, 3, (b, n, 2))
    gt3d = np.concatenate([centre, rng.uniform(2, 6, (b, n, 1)), rng.uniform(0.3, 1.5, (b, n, 3)),
                           rng.randn(b, n, 3)], -1).reshape(b * n, 9).astype(np.float32)
    q = rng.randn(b * n, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qw, x, y, z = q.T
    poses = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * qw), 2 * (x * z + y * qw)], -1),
        np.stack([2 * (x * y + z * qw), 1 - 2 * (x * x + z * z), 2 * (y * z - x * qw)], -1),
        np.stack([2 * (x * z - y * qw), 2 * (y * z + x * qw), 1 - 2 * (x * x + y * y)], -1)], -2).astype(np.float32)
    mask = rng.rand(b * n) > 0.25
    return feats, boxes, classes, gt3d, poses, mask


def _fill(shapes, seed=1):
    """Numpy cube-head parameters: xavier fc stacks with small biases, 3D
    outputs of spread 0.05 (depth bias 1, uncertainty bias 1), dimension
    priors of means 0.5 to 2, depth bins' 2D scales 12 to 90 px with means
    12, 6, 3 m."""
    rng = np.random.RandomState(seed)
    out = {"cube_head": {}}
    for name, layer in shapes["cube_head"].items():
        k = layer["kernel"].shape
        if name.startswith("bbox_3D"):
            kernel = rng.randn(*k) * 0.05
            bias = {"bbox_3D_center_depth": 1.0, "bbox_3D_uncertainty": 1.0}.get(name, 0.0) + rng.randn(
                *layer["bias"].shape) * 0.05
        else:
            lim = np.sqrt(6.0 / (k[0] + k[1]))
            kernel, bias = rng.uniform(-lim, lim, k), rng.randn(*layer["bias"].shape) * 0.05
        out["cube_head"][name] = {"kernel": kernel.astype(np.float32), "bias": bias.astype(np.float32)}
    c, bins = shapes["priors_z_scales"].shape
    mean = rng.uniform(0.5, 2.0, (1, c, 1, 3))
    out["priors_dims_per_cat"] = np.concatenate([mean, mean * rng.uniform(0.1, 0.3, (1, c, 1, 3))], 2).astype(
        np.float32)
    out["priors_z_scales"] = np.sort(rng.uniform(12, 90, (c, bins)), axis=1).astype(np.float32)
    stats_mean = np.array([12.0, 6.0, 3.0][:bins])[None].repeat(c, 0) * rng.uniform(0.8, 1.2, (c, bins))
    out["priors_z_stats"] = np.stack([stats_mean, stats_mean * 0.25], -1).astype(np.float32)
    return out


def _to_port_heads(pcfg, params):
    from threedod_torch.models.roi_heads3d import ROIHeads3D
    from threedod_torch.utils.convert_weights import from_jax_variables

    heads = ROIHeads3D(pcfg, 16)
    sd = {k[len("roi_heads."):]: v for k, v in from_jax_variables({"params": {"roi_heads": params}}, pcfg).items()}
    missing, unexpected = heads.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.startswith(("box_head.", "box_predictor.")) for k in missing), missing
    return heads


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_cube_branch_options(name):
    from threedod.models.roi_heads3d import ROIHeads3D as JaxHeads

    from threedod_torch.models.roi_heads3d import ROIHeads3D
    from threedod_torch.utils.convert_weights import from_jax_variables

    jcfg, pcfg = _configs(OPTION_SETS[name])
    feats, boxes, classes, gt3d, poses, mask = _inputs()
    img, image_hw, K, ratio = tp.inputs()
    camera = ROIHeads3D.camera(type("Heads", (), {"cfg": pcfg})(), torch.from_numpy(K), torch.from_numpy(ratio),
                               torch.from_numpy(image_hw))
    Ks, v2r = (t.numpy() for t in camera)
    jheads = JaxHeads(cfg=jcfg)

    def branch(m, feats):
        out = m.cube_forward(feats, boxes, classes, Ks, v2r)
        losses, metrics = m.cube_losses(out, gt3d, poses, mask.astype(np.float32))
        return out, losses, metrics

    shapes = jax.eval_shape(lambda: jheads.init(jax.random.PRNGKey(0), feats, method=branch))["params"]
    params = _fill(shapes)

    def total(params, feats):
        out, losses, metrics = jheads.apply({"params": params}, feats, method=branch)
        return sum(jax.tree.leaves(losses)), (out, losses, metrics)

    (_, (jout, jlosses, jmetrics)), (gparams, gfeats) = jax.device_get(
        jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True))(params, feats))

    heads = _to_port_heads(pcfg, params)
    pfeats = {f: torch.from_numpy(v).permute(0, 3, 1, 2).requires_grad_() for f, v in feats.items()}
    out = heads.cube_forward(pfeats, torch.from_numpy(boxes), torch.from_numpy(classes), camera[0], camera[1])
    losses, metrics = heads.cube_losses(out, torch.from_numpy(gt3d), torch.from_numpy(poses), torch.from_numpy(mask))
    sum(losses.values()).backward()

    ch = pcfg.model.roi_cube_head
    assert heads.reuse_pool == (name in ("C", "D"))
    assert (out["uncert"] is None) == (ch.use_confidence == 0) and (jout["uncert"] is None) == (out["uncert"] is None)
    for key in ("xy", "z", "dims", "dims_norm", "deltas_2d", "pose", "uncert", "v2r", "z_norm", "pose_allocentric",
                "z_means", "z_stds", "prior_dims_mean", "prior_dims_std"):
        assert (key in out) == (key in jout), key
        if key in out and out[key] is not None:
            tp.close(out[key].detach().numpy(), jout[key], tol=1e-5)
    assert set(losses) == set(jlosses) and set(metrics) == set(jmetrics)
    for k, ref in {**jlosses, **jmetrics}.items():
        got = {**losses, **metrics}[k].item()
        assert np.isfinite(ref) and ref != 0.0, k
        np.testing.assert_allclose(got, float(ref), rtol=1e-5, atol=1e-7, err_msg=k)

    as_np = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)  # noqa: E731
    jg = from_jax_variables({"params": {"roi_heads": as_np(gparams)}}, pcfg)
    checked = 0
    for pname, p in heads.named_parameters():
        if pname.startswith(("box_head.", "box_predictor.")):
            continue
        ref = jg[f"roi_heads.{pname}"].numpy()
        if pname.startswith("priors"):  # read through stop_gradient / detach
            assert np.abs(ref).max() == 0 and p.grad is None, pname
            continue
        assert np.abs(ref).max() > 0, pname
        tp.close(p.grad.numpy(), ref, tol=1e-4)
        checked += 1
    stacks = 1 if ch.shared_fc else 4 + (ch.use_confidence > 0)
    assert checked == 2 * 2 * stacks + 2 * (4 + (ch.use_confidence > 0))
    assert np.abs(gfeats["p2"]).max() > 0  # the ROIs are small: most pool from p2
    for f, ref in gfeats.items():
        got = pfeats[f].grad.permute(0, 2, 3, 1).numpy()
        if np.abs(ref).max() == 0:
            assert np.abs(got).max() == 0, f
        else:
            tp.close(got, ref, tol=1e-4)


def test_priors_with_depth_bins():
    """``set_priors`` fills the bins' 2D scales and depth statistics from a
    priors dict as the JAX head's ``setup`` does, and leaves the dimension
    priors at 1 where they are off."""
    from threedod.models.roi_heads3d import ROIHeads3D as JaxHeads

    from threedod_torch.models.meta_arch import build_model

    jcfg, pcfg = _configs(dict(cluster_bins=3, dims_priors_enabled=False))
    rng = np.random.RandomState(2)
    priors = {"priors_dims_per_cat": rng.uniform(0.5, 2, (5, 2, 3)).tolist(),
              "priors_bins": [(f"c{i}", list(np.sort(rng.uniform(10, 90, 3))), rng.uniform(1, 9, (3, 2)).tolist())
                              for i in range(5)]}
    names = ("priors_dims_per_cat", "priors_z_scales", "priors_z_stats")
    ref = JaxHeads(cfg=jcfg, priors=priors).init(
        jax.random.PRNGKey(0), method=lambda m: tuple(getattr(m, n) for n in names))["params"]
    port = build_model(pcfg, seed=0, priors=priors).roi_heads
    for n in names:
        np.testing.assert_array_equal(getattr(port, n).detach().numpy(), np.asarray(ref[n]), err_msg=n)
    assert port.priors_z_scales.shape == (5, 3) and (port.priors_dims_per_cat == 1).all()


@pytest.mark.parametrize("options", [dict(shared_fc=False), dict(loss_w_3d=0.0)], ids=["separate_fc", "2d_only"])
def test_weight_round_trip(options):
    """JAX RCNN3D variables -> ``from_jax_variables`` -> the port (strict) ->
    ``state_dict()`` -> ``convert_cubercnn_rcnn3d`` gives them back bit for
    bit; the 2D-only model has no cube parameter in either package."""
    from threedod.utils.convert_weights import convert_cubercnn_rcnn3d

    jcfg, pcfg = tp.configs(**{f"model.roi_cube_head.{k}": v for k, v in options.items()})
    variables = tp.seeded_variables(jcfg)
    port = tp.port_model(pcfg, variables)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    cube = [k for k in sd if k.startswith(("roi_heads.cube_head", "roi_heads.priors"))]
    if options.get("loss_w_3d") == 0.0:
        assert not cube and "cube_head" not in variables["params"]["roi_heads"]
    else:
        assert {k.split(".")[2] for k in cube if "feature_generator" in k} == {
            f"feature_generator_{b}" for b in ("XY", "dims", "pose", "Z", "conf")}
    back = convert_cubercnn_rcnn3d(sd, variables)
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=jax.tree_util.keystr(path))


def test_2d_only_heads():
    """The 2D-only head on given features and proposals: the training losses,
    metrics and gradients of the JAX ``ROIHeads3D(train=True)`` with the same
    sampling noise, and its detections (3D fields zero, scores the 2D ones)."""
    from threedod.models.roi_heads3d import ROIHeads3D as JaxHeads
    from threedod.models.rpn import Proposals as JaxProposals

    from threedod_torch.models.rpn import Proposals
    from threedod_torch.utils.convert_weights import from_jax_variables

    over = {"shapes.roi_batch": 32, "shapes.max_gt": 4, "model.roi_cube_head.loss_w_3d": 0.0}
    jcfg, pcfg = tp.configs(**NARROW, **over)
    feats = _inputs(seed=3)[0]
    img, image_hw, K, ratio = tp.inputs()
    gt = tp.ground_truth()
    jb = tp.jax_train_batch(img, image_hw, K, ratio, gt)
    tb = tp.torch_train_batch(img, image_hw, K, ratio, gt)
    rng = np.random.RandomState(4)
    xy = np.stack([rng.uniform(0, 80, (2, 40)), rng.uniform(0, 50, (2, 40))], -1)
    pboxes = np.concatenate([xy, xy + rng.uniform(6, 40, (2, 40, 2))], -1).astype(np.float32)
    pboxes[:, :6] = gt["boxes2d"][:, :3].repeat(2, 1) + rng.uniform(-2, 2, (2, 6, 4))  # some foreground
    pscores = rng.randn(2, 40).astype(np.float32)
    pvalid = np.ones((2, 40), bool)
    pvalid[1, -5:] = False
    jheads = JaxHeads(cfg=jcfg)
    jprop = JaxProposals(boxes=pboxes, scores=pscores, valid=pvalid)
    key = jax.random.PRNGKey(6)

    def train(m, feats):
        return m(feats, jprop, jb.K, jb.im_scale_ratio, jb.image_hw, gt=jb.gt, train=True)

    shapes = jax.eval_shape(lambda: jheads.init({"params": key, "sampling": key}, feats, method=train))["params"]
    assert set(shapes) == {"box_head", "box_predictor"}
    variables = tp.init_like_variables(jcfg)
    params = {k: variables["params"]["roi_heads"][k] for k in shapes}
    params["box_predictor"]["cls_score"]["kernel"] = params["box_predictor"]["cls_score"]["kernel"] * 300.0

    def run(params, feats):
        (losses, metrics) = jheads.apply({"params": params}, feats, method=train, rngs={"sampling": key})
        det, _ = jheads.apply({"params": params}, feats, jprop, jb.K, jb.im_scale_ratio, jb.image_hw)
        return sum(jax.tree.leaves(losses)), (losses, metrics, det)

    (_, (jlosses, jmetrics, jdet)), gparams = jax.device_get(
        jax.jit(jax.value_and_grad(run, has_aux=True))(params, feats))
    k_roi = jheads.apply({"params": params}, rngs={"sampling": key}, method=lambda m: m.make_rng("sampling"))
    noise = tp.sampler_noise(k_roi, 2, 40 + 4)

    heads = _to_port_heads(pcfg, params)
    assert not heads.has_cube and not any(k.startswith(("cube_head", "priors")) for k in heads.state_dict())
    pfeats = {f: torch.from_numpy(v).permute(0, 3, 1, 2) for f, v in feats.items()}
    prop = Proposals(torch.from_numpy(pboxes), torch.from_numpy(pscores), torch.from_numpy(pvalid))
    losses, metrics = heads.train()(pfeats, prop, tb.K, tb.im_scale_ratio, tb.image_hw, tb.gt, noise)
    sum(losses.values()).backward()
    assert set(losses) == set(jlosses) == {"BoxHead/loss_cls", "BoxHead/loss_box_reg"}
    assert set(metrics) == set(jmetrics) == {"roi/num_fg", "roi/num_bg"}
    for k, ref in {**jlosses, **jmetrics}.items():
        np.testing.assert_allclose({**losses, **metrics}[k].item(), float(ref), rtol=1e-5, atol=1e-7, err_msg=k)
    assert metrics["roi/num_fg"] > 0
    jg = from_jax_variables({"params": {"roi_heads": jax.tree_util.tree_map(np.asarray, gparams)}}, pcfg)
    for pname, p in heads.named_parameters():
        tp.close(p.grad.numpy(), jg[f"roi_heads.{pname}"].numpy(), tol=1e-4)

    with torch.no_grad():
        det = heads.eval()(pfeats, prop, tb.K, tb.im_scale_ratio, tb.image_hw)
    assert det.valid.any()
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jdet.valid))
    np.testing.assert_array_equal(det.classes.numpy(), np.asarray(jdet.classes))
    for field in ("boxes", "scores", "scores_2d", "center_cam", "dimensions", "pose", "center_2d", "corners3d"):
        np.testing.assert_allclose(getattr(det, field).numpy(), np.asarray(getattr(jdet, field)), rtol=1e-5,
                                   atol=1e-6, err_msg=field)
    assert (det.center_cam == 0).all() and torch.equal(det.scores, det.scores_2d)
