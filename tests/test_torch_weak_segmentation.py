"""Weak Cube R-CNN's ROI heads with the 8-loss menu (Omni_combined_Synth's
seven and ``segmentation``), the port vs the JAX package, f32 on the CPU.

One training step of ``ROIHeads3DScore`` on the same numpy FPN levels (16
channels at the 64x96 canvas), proposals and ground truth, with instance
masks written here as the ellipses inside the boxes (as SAM's would be, not
the filled boxes the loader makes without stored masks), fronto-parallel
depth maps and ground maps. The sampling noise and the RANSAC hypotheses are
the ones the JAX key draws (``_torch_port.sampler_noise``, the indices of
``test_torch_weak.py``). The JAX side is one ``jax.jit`` of
``value_and_grad`` of the summed losses; its parameters are numpy-made in
the shapes ``jax.eval_shape`` gives and go to the port through
``from_jax_variables``.

Compared: every loss (``Cube/loss_seg`` among them) and the total to 1e-5
relative, every metric likewise, and the gradient of the total to every
head parameter to 1e-4 of the leaf's largest entry. The 3D outputs' weights
have a spread of 0.05, so that the 6d pose's normalisation does not magnify
rounding (``test_torch_train_heads.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax
import jax.numpy as jnp

MENU8 = ("dims", "pose_alignment", "pose_ground", "iou", "z", "z_pseudo_gt_patch", "depth", "segmentation")
OVER = {"model.meta_architecture": "RCNN3DCombined", "model.fpn_out_channels": 16, "model.roi_cube_head.fc_dim": 32,
        "model.roi_box_head.fc_dim": 32, "shapes.roi_batch": 32, "shapes.max_gt": 4,
        "model.roi_cube_head.loss_w_pose": 7.0, "model.roi_cube_head.loss_w_dims": 20.0}
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
N_PROPOSALS = 40
BIASES = {"bbox_3D_center_depth": 12.0, "bbox_3D_uncertainty": 1.0}


def _fill(shapes, seed=1):
    """Numpy head parameters: xavier fc layers, class scores of spread 0.3,
    box deltas 0.001, 3D outputs 0.05 (uncertainty bias 1; depth bias 12,
    which the virtual depth's scale of these cameras, 0.07 and 0.16, puts
    at 1 to 2 m, so that the cubes' projections cover part of the canvas),
    dimension priors of means 0.3 to 0.8."""
    rng = np.random.RandomState(seed)

    def walk(tree, name=""):
        if "kernel" in tree:
            k = tree["kernel"].shape
            std = 0.3 if name == "cls_score" else 0.001 if name == "bbox_pred" else 0.05 if name.startswith(
                "bbox_3D") else None
            if std is None:
                lim = np.sqrt(6.0 / (k[0] + k[1]))
                kernel = rng.uniform(-lim, lim, k)
            else:
                kernel = rng.randn(*k) * std
            bias = np.full(tree["bias"].shape, BIASES.get(name, 0.0))
            return {"kernel": kernel.astype(np.float32), "bias": bias.astype(np.float32)}
        return {k: walk(v, k) if hasattr(v, "items") else None for k, v in tree.items()}

    out = walk(shapes)
    c = shapes["priors_dims_per_cat"].shape[1]
    mean = rng.uniform(0.3, 0.8, (1, c, 1, 3))
    out["priors_dims_per_cat"] = np.concatenate([mean, mean * 0.2], 2).astype(np.float32)
    out["priors_z_scales"] = np.ones(shapes["priors_z_scales"].shape, np.float32)
    out["priors_z_stats"] = np.ones(shapes["priors_z_stats"].shape, np.float32)
    return out


def _ellipse_masks(gt, hm, wm):
    """The ellipse inscribed in each ground-truth box, on the quarter grid."""
    ys, xs = np.arange(hm)[:, None] + 0.5, np.arange(wm)[None, :] + 0.5
    masks = np.zeros(gt["boxes2d"].shape[:2] + (hm, wm), np.uint8)
    for i, j in zip(*np.nonzero(gt["valid"])):
        x1, y1, x2, y2 = gt["boxes2d"][i, j] / 4.0
        masks[i, j] = ((xs - (x1 + x2) / 2) / ((x2 - x1) / 2)) ** 2 + ((ys - (y1 + y2) / 2) / ((y2 - y1) / 2)) ** 2 <= 1
    return masks


@pytest.fixture(scope="module")
def run():
    from threedod.models.rpn import Proposals as JaxProposals
    from threedod.models.weak_heads import ROIHeads3DScore as JaxHeads

    from threedod_torch.geometry.plane import cloud_pixels
    from threedod_torch.models.rpn import Proposals
    from threedod_torch.models.weak_heads import ROIHeads3DScore
    from threedod_torch.utils.convert_weights import from_jax_variables

    jcfg, pcfg = tp.configs(**OVER)
    jcfg.loss_functions = pcfg.loss_functions = MENU8
    img, image_hw, K, ratio = tp.inputs()
    h, w = img.shape[1:3]
    gt = tp.ground_truth()
    masks = _ellipse_masks(gt, h // 4, w // 4)
    depth = np.stack([np.full((h, w), 2.5), np.full((h, w), 4.0)]).astype(np.float16)
    ground = np.zeros((2, h, w), np.uint8)
    ground[0, h // 2:] = 1
    rng = np.random.RandomState(21)
    feats = {f: rng.randn(2, -(-h // s), -(-w // s), 16).astype(np.float32) for f, s in STRIDES.items()}
    xy = np.stack([rng.uniform(0, 80, (2, N_PROPOSALS)), rng.uniform(0, 50, (2, N_PROPOSALS))], -1)
    pboxes = np.concatenate([xy, xy + rng.uniform(6, 40, (2, N_PROPOSALS, 2))], -1).astype(np.float32)
    pboxes[:, :6] = gt["boxes2d"][:, :3].repeat(2, 1) + rng.uniform(-2, 2, (2, 6, 4))  # foreground candidates
    pscores = rng.randn(2, N_PROPOSALS).astype(np.float32)
    pvalid = np.ones((2, N_PROPOSALS), bool)

    jb = tp.jax_train_batch(img, image_hw, K, ratio, gt)
    jgt = jb.gt.replace(masks=jnp.asarray(masks))
    jprop = JaxProposals(boxes=pboxes, scores=pscores, valid=pvalid)
    jheads = JaxHeads(cfg=jcfg)
    key = jax.random.PRNGKey(8)

    def train(m, feats):
        return m(feats, jprop, jb.K, jb.im_scale_ratio, jb.image_hw, gt=jgt, train=True,
                 depth_maps=jnp.asarray(depth, jnp.float32), ground_maps=jnp.asarray(ground, jnp.float32))

    shapes = jax.eval_shape(lambda: jheads.init({"params": key, "sampling": key}, feats, method=train))["params"]
    params = _fill(shapes)

    def total(params):
        losses, metrics = jheads.apply({"params": params}, feats, method=train, rngs={"sampling": key})
        return sum(jax.tree.leaves(losses)), (losses, metrics)

    (jtotal, (jlosses, jmetrics)), gparams = jax.device_get(jax.jit(jax.value_and_grad(total, has_aux=True))(params))

    # the keys the JAX heads drew from: the sampler's, and the RANSAC's
    k_sample, k_weak = jax.random.split(
        jheads.apply({"params": params}, rngs={"sampling": key}, method=lambda m: m.make_rng("sampling")))
    ys, xs = cloud_pixels(h, w, "cpu")
    n_points = len(ys) * len(xs)
    hypotheses = np.stack([np.asarray(jax.random.randint(k, (1000, 3), 0, n_points))
                           for k in jax.random.split(k_weak, 2)])

    heads = ROIHeads3DScore(pcfg, 16)
    heads.load_state_dict({k[len("roi_heads."):]: v for k, v in from_jax_variables(
        {"params": {"roi_heads": params}}, pcfg).items()}, strict=True)
    tb = tp.torch_train_batch(img, image_hw, K, ratio, gt)
    pgt = tb.gt._replace(masks=torch.from_numpy(masks))
    pfeats = {f: torch.from_numpy(v).permute(0, 3, 1, 2) for f, v in feats.items()}
    prop = Proposals(torch.from_numpy(pboxes), torch.from_numpy(pscores), torch.from_numpy(pvalid))
    losses, metrics = heads.train()(
        pfeats, prop, tb.K, tb.im_scale_ratio, tb.image_hw, pgt, tp.sampler_noise(k_sample, 2, N_PROPOSALS + 4),
        depth_maps=torch.from_numpy(depth).float(), ground_maps=torch.from_numpy(ground).float(),
        hypotheses=torch.from_numpy(hypotheses))
    ptotal = sum(losses.values())
    ptotal.backward()
    jg = from_jax_variables({"params": {"roi_heads": jax.tree_util.tree_map(np.asarray, gparams)}}, pcfg)
    return dict(jtotal=float(jtotal), jlosses=jlosses, jmetrics=jmetrics, jg=jg, total=ptotal.item(),
                losses={k: v.item() for k, v in losses.items()}, metrics={k: float(v) for k, v in metrics.items()},
                heads=heads, masks=masks, gt=gt)


def test_masks_are_not_box_fills(run):
    hm, wm = run["masks"].shape[2:]
    ys, xs = np.arange(hm)[:, None], np.arange(wm)[None, :]
    for i, j in zip(*np.nonzero(run["gt"]["valid"])):
        x1, y1, x2, y2 = run["gt"]["boxes2d"][i, j] / 4.0
        fill = (ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2)
        assert run["masks"][i, j].sum() < fill.sum()


def test_losses_and_total(run):
    keys = set(run["jlosses"])
    assert set(run["losses"]) == keys and "Cube/loss_seg" in keys and len(keys) == 13
    for k, ref in run["jlosses"].items():
        assert np.isfinite(ref), k
        np.testing.assert_allclose(run["losses"][k], float(ref), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(run["total"], run["jtotal"], rtol=1e-5)
    assert run["losses"]["Cube/loss_seg"] > 0


def test_metrics(run):
    assert set(run["metrics"]) == set(run["jmetrics"])
    for k, ref in run["jmetrics"].items():
        np.testing.assert_allclose(run["metrics"][k], float(ref), rtol=1e-5, atol=1e-7, err_msg=k)
    assert run["metrics"]["roi/num_fg"] > 0


def test_head_gradients(run):
    checked = 0
    for name, p in run["heads"].named_parameters():
        ref = run["jg"][f"roi_heads.{name}"].numpy()
        if name.startswith("priors"):
            assert np.abs(ref).max() == 0 and p.grad is None, name
            continue
        assert np.abs(ref).max() > 0, name
        tp.close(p.grad.numpy(), ref, tol=1e-4)
        checked += 1
    assert checked == 22  # box head 2 x 2, predictor 2 x 2, cube head's stack 2 x 2 and 5 outputs x 2
